// B2 base_relu: relu's monolithic baseline.  Each (8, 128) block of x is
// replaced by max(0, block), dtype kept (f32, bf16, int32).
//
// Replaces the TPU kernel repro/kernels/frontend.py:MonolithicKernel._build
// with the body repro/kernels/relu.py:_baseline_body: one grid step whose
// body walks the blocks with a fori_loop, loading block i by an explicit
// dynamic slice and storing fn(block) in its place.
//
// Bound on H100: bytes -- one read and one write per element, the same
// bound as K2 (map_relu.cu).
//
// Design: B2 runs on exactly K2's CTAs, each walking its blocks in order.
// The address of block i comes from the loop index at the point of use;
// every thread loads its four elements with plain scalar loads and stores
// their relu at once.  The block loop is not unrolled, so nothing of block
// i + 1 is in flight while block i is written.  The value is selected,
// never computed (ssr_relu, shared with K2), so B2 is bit-exact: -0.0 gives
// +0.0, NaN payloads pass, int32 above 2^24 stays exact.
#include "ssr_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlock = 8 * 128;                  // elements of one block
constexpr int kPerThread = kBlock / kThreads;    // 4

template <typename T>
__global__ void __launch_bounds__(kThreads)
    base_relu_kernel(const T* __restrict__ x, T* __restrict__ out,
                     int64_t nblk, int64_t blocks_per_cta) {
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * blocks_per_cta;
  const int64_t b1 = b0 + blocks_per_cta < nblk ? b0 + blocks_per_cta : nblk;
#pragma unroll 1
  for (int64_t i = b0; i < b1; ++i) {
    const T* px = x + i * kBlock;   // the explicit load's address, from i
    T* po = out + i * kBlock;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int e = threadIdx.x + j * kThreads;
      po[e] = ssr_relu(px[e]);
    }
  }
}

template <typename T>
void launch(const void* x, void* out, int64_t nblk, int64_t num_ctas,
            int64_t blocks_per_cta, cudaStream_t st) {
  base_relu_kernel<T><<<static_cast<unsigned>(num_ctas), kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<T*>(out), nblk, blocks_per_cta);
}

}  // namespace

// x and out are (nblk * 8, 128) row-major; `num_ctas` CTAs take
// `blocks_per_cta` consecutive blocks each.
extern "C" int ssr_base_relu(const void* x, void* out, int dtype,
                             int64_t nblk, int64_t num_ctas,
                             int64_t blocks_per_cta, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == SSR_F32)
    launch<float>(x, out, nblk, num_ctas, blocks_per_cta, st);
  else if (dtype == SSR_BF16)
    launch<__nv_bfloat16>(x, out, nblk, num_ctas, blocks_per_cta, st);
  else if (dtype == SSR_I32)
    launch<int32_t>(x, out, nblk, num_ctas, blocks_per_cta, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int64_t ssr_base_relu_smem_bytes() { return 0; }
