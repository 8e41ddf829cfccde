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
// Design: B2 runs on K2's split (core/hopper.py MAP_PER_SM: runs of
// consecutive blocks, 4 on the relu cells) and K2's CTAs: 128 threads for
// a 16-bit type in 16-byte packs, else 256.  Each CTA walks its run's
// blocks in order.
//
// The baseline's rule, which K2's stream walk breaks and B2 keeps: an
// explicit load before every use.  Each thread issues its load of block i
// from the loop index, at the point of use, and stores its relu at once;
// the block loop is rolled (#pragma unroll 1), so nothing of block i + 1
// is in flight in a thread before block i's values are stored.  No
// read-ahead batch (ssr_for), no run walk, no ring, no bulk copy, no
// prefetch.  A 16-byte access is still one explicit load: where the
// wrapper found x aligned for it, a thread loads one 16-byte pack a block
// and stores one (four f32 or int32 elements, eight bf16), else one element
// an access (a view off a 16-byte boundary).  The card hides the loads'
// latency by its resident warps, and K2 shares that.
//
// The packs move as raw words and the value is selected on its bits
// (ssr_run.cuh's ssr_relu_pack, shared with K2), never computed, so B2 is
// bit-exact: -0.0 gives +0.0, NaN payloads pass, int32 above 2^24 stays
// exact.
#include "ssr_run.cuh"

namespace {

constexpr int kBlock = 8 * 128;   // elements of one block

// Threads of a CTA, K2's: 128 for a 16-bit type in 16-byte packs, else 256.
template <typename T, int V>
constexpr int threads_for() {
  return sizeof(T) == 2 && V == 8 ? 128 : 256;
}

template <typename T, int V, int kThreads>
__global__ void __launch_bounds__(kThreads)
    base_relu_kernel(const T* __restrict__ x, T* __restrict__ out,
                     int64_t nblk, int64_t blocks_per_cta) {
  using Words = SsrWords<T, V>;
  constexpr int kPacks = kBlock / V;
  constexpr int kCells = (kPacks + kThreads - 1) / kThreads;
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * blocks_per_cta;
  const int64_t b1 = b0 + blocks_per_cta < nblk ? b0 + blocks_per_cta : nblk;
#pragma unroll 1
  for (int64_t i = b0; i < b1; ++i) {
    // the explicit load's address, from i
    const Words* px = reinterpret_cast<const Words*>(x + i * kBlock);
    Words* po = reinterpret_cast<Words*>(out + i * kBlock);
#pragma unroll
    for (int c = 0; c < kCells; ++c) {
      const int k = threadIdx.x + c * kThreads;
      if (kPacks % kThreads == 0 || k < kPacks)
        po[k] = ssr_relu_pack<T, V>(px[k]);
    }
  }
}

template <typename T, int V>
void launch(const void* x, void* out, int64_t nblk, int64_t num_ctas,
            int64_t blocks_per_cta, cudaStream_t st) {
  constexpr int kThreads = threads_for<T, V>();
  base_relu_kernel<T, V, kThreads>
      <<<static_cast<unsigned>(num_ctas), kThreads, 0, st>>>(
          static_cast<const T*>(x), static_cast<T*>(out), nblk,
          blocks_per_cta);
}

}  // namespace

// x and out are (nblk * 8, 128) row-major; `num_ctas` CTAs take
// `blocks_per_cta` consecutive blocks each.  `vec` is 16 / sizeof(element)
// where x's base pointer allows 16-byte accesses (out is a new tensor),
// else 1.
extern "C" int ssr_base_relu(const void* x, void* out, int dtype, int vec,
                             int64_t nblk, int64_t num_ctas,
                             int64_t blocks_per_cta, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t n = nblk, c = num_ctas, per = blocks_per_cta;
  if (dtype == SSR_F32 && vec == 4)
    launch<float, 4>(x, out, n, c, per, st);
  else if (dtype == SSR_F32 && vec == 1)
    launch<float, 1>(x, out, n, c, per, st);
  else if (dtype == SSR_BF16 && vec == 8)
    launch<__nv_bfloat16, 8>(x, out, n, c, per, st);
  else if (dtype == SSR_BF16 && vec == 1)
    launch<__nv_bfloat16, 1>(x, out, n, c, per, st);
  else if (dtype == SSR_I32 && vec == 4)
    launch<int32_t, 4>(x, out, n, c, per, st);
  else if (dtype == SSR_I32 && vec == 1)
    launch<int32_t, 1>(x, out, n, c, per, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int64_t ssr_base_relu_smem_bytes() { return 0; }

// Registers a thread and local (spill) bytes, the most over every
// instantiation, as cudaFuncGetAttributes reads them, and the CTAs an SM
// of the main path's (f32, 16-byte packs; occupancy API): out[0] numRegs,
// out[1] localSizeBytes, out[2] CTAs an SM.
extern "C" int ssr_base_relu_attributes(int64_t* out) {
  const void* const kernels[] = {
      reinterpret_cast<const void*>(
          base_relu_kernel<float, 4, threads_for<float, 4>()>),
      reinterpret_cast<const void*>(
          base_relu_kernel<float, 1, threads_for<float, 1>()>),
      reinterpret_cast<const void*>(
          base_relu_kernel<__nv_bfloat16, 8,
                           threads_for<__nv_bfloat16, 8>()>),
      reinterpret_cast<const void*>(
          base_relu_kernel<__nv_bfloat16, 1,
                           threads_for<__nv_bfloat16, 1>()>),
      reinterpret_cast<const void*>(
          base_relu_kernel<int32_t, 4, threads_for<int32_t, 4>()>),
      reinterpret_cast<const void*>(
          base_relu_kernel<int32_t, 1, threads_for<int32_t, 1>()>)};
  out[0] = out[1] = out[2] = 0;
  for (const void* k : kernels) {
    cudaFuncAttributes fa;
    cudaError_t err = cudaFuncGetAttributes(&fa, k);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (fa.numRegs > out[0]) out[0] = fa.numRegs;
    if (static_cast<int64_t>(fa.localSizeBytes) > out[1])
      out[1] = static_cast<int64_t>(fa.localSizeBytes);
  }
  int ctas = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &ctas, base_relu_kernel<float, 4, threads_for<float, 4>()>,
      threads_for<float, 4>(), 0);
  out[2] = ctas;
  return static_cast<int>(err);
}
