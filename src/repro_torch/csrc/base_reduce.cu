// B1 base_reduce: the dot product's monolithic baseline.  Sum over the
// (8, 128) blocks of promote(x_blk) * promote(y_blk), in an f32 accumulator.
//
// Replaces the TPU kernel repro/kernels/frontend.py:MonolithicKernel._build
// with the body repro/kernels/reduction.py:_baseline_body: one grid step
// whose body walks the blocks with a fori_loop, each block fetched by an
// explicit dynamic-slice load at i * 8 rows and summed at once -- the paper's
// baseline core, issuing a load pair before every multiply-add.
//
// Bound on H100: bytes.  Each input element is read once for one multiply-
// add, the same bound as K1 (reduce_mul.cu).
//
// Design: the meaning of the baseline, not its single grid step.  One CTA
// would measure the SM count, not how operands are delivered, so B1 splits
// the blocks over exactly K1's CTAs (the wrapper passes K1's split).  Each
// CTA walks its blocks in order; the address of block i is computed from the
// loop index at the point of use, every thread loads its four elements of
// the block as plain scalar loads, and the multiply-adds wait on those loads
// at once: the block loop is not unrolled, so no load of block i + 1 is in
// flight while block i computes.  That run-ahead is what K1's stream walk
// adds.  Partials fold as in K1: a fixed-order CTA sum, then a one-CTA second
// launch over the partials.  No atomics: the same result every run.
#include "ssr_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kFoldThreads = 1024;
constexpr int kBlock = 8 * 128;                  // elements of one block
constexpr int kPerThread = kBlock / kThreads;    // 4

template <typename T>
__global__ void __launch_bounds__(kThreads)
    base_reduce_partials(const T* __restrict__ x, const T* __restrict__ y,
                         int64_t nblk, int64_t blocks_per_cta,
                         float* __restrict__ partials) {
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * blocks_per_cta;
  const int64_t b1 = b0 + blocks_per_cta < nblk ? b0 + blocks_per_cta : nblk;
  float acc = 0.f;
#pragma unroll 1
  for (int64_t i = b0; i < b1; ++i) {
    const T* px = x + i * kBlock;   // the explicit load's address, from i
    const T* py = y + i * kBlock;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int e = threadIdx.x + j * kThreads;
      acc += ssr_f32(px[e]) * ssr_f32(py[e]);
    }
  }
  acc = ssr_cta_sum<kThreads>(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

__global__ void __launch_bounds__(kFoldThreads)
    fold_partials(const float* __restrict__ partials, int64_t n,
                  float* __restrict__ out) {
  float acc = 0.f;
  for (int64_t i = threadIdx.x; i < n; i += kFoldThreads) acc += partials[i];
  acc = ssr_cta_sum<kFoldThreads>(acc);
  if (threadIdx.x == 0) out[0] = acc;
}

}  // namespace

// x and y are (nblk * 8, 128) row-major; `num_ctas` CTAs take
// `blocks_per_cta` consecutive blocks each.
extern "C" int ssr_base_reduce(const void* x, const void* y, int dtype,
                               int64_t nblk, void* partials, int64_t num_ctas,
                               int64_t blocks_per_cta, void* out,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partials);
  const unsigned n = static_cast<unsigned>(num_ctas);
  if (dtype == SSR_F32)
    base_reduce_partials<float><<<n, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(y), nblk,
        blocks_per_cta, part);
  else if (dtype == SSR_BF16)
    base_reduce_partials<__nv_bfloat16><<<n, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(y), nblk, blocks_per_cta, part);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fold_partials<<<1, kFoldThreads, 0, st>>>(part, num_ctas,
                                            static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int64_t ssr_base_reduce_smem_bytes() {
  return static_cast<int64_t>(sizeof(float)) * (kFoldThreads / 32);
}
