// B4 base_gemv: gemv's monolithic baseline.  y (m8, 1) = A (m8, n) . x^T,
// one 8-row panel at a time, in f32, with x re-read from device memory for
// every panel.  m8 is a multiple of 8 (the wrapper's layouts are the
// reference's: A's rows zero-padded to it, x as (1, n)).
//
// Replaces the TPU kernel repro/kernels/frontend.py:MonolithicKernel._build
// with the body repro/kernels/gemv.py:_baseline_body: one grid step whose
// body walks the panels with a fori_loop, loading panel i by an explicit
// dynamic slice, reading x whole again, and storing the panel's 8 sums.
//
// Bound on H100: bytes.  Each element of A is read once for one multiply-
// add, the same bound as K4 (contract_gemv.cu).
//
// Design: B4 runs on exactly K4's CTAs -- 16 rows, here two panels, per
// CTA -- and walks its panels in order.  Panel i's address comes from the
// loop index at the point of use.  For each panel the CTA's threads span
// the columns: every thread loads its pack of x from device memory (no
// shared-memory staging: that one staging of the repeat stream per k step is
// what K4 has and this baseline lacks), then its pack of each of the 8 rows,
// and multiplies at once; the column loop is not unrolled, so no load of the
// next pack is in flight while the current one computes.  The 8 sums fold
// across warps and then the CTA in a fixed order.  Loads are 16 bytes where
// the wrapper found A and x aligned for it.
#include "ssr_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;              // one panel
constexpr int kPanelsPerCta = 2;      // 16 rows per CTA, as K4's CTAs

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    base_gemv_kernel(const T* __restrict__ a, const T* __restrict__ x,
                     float* __restrict__ y, int64_t npanels, int64_t n) {
  using Pack = SsrPack<T, V>;
  __shared__ float sums[kThreads / 32][kRows];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t packs = n / V;
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * kPanelsPerCta;
  const int64_t p1 = p0 + kPanelsPerCta < npanels ? p0 + kPanelsPerCta
                                                  : npanels;
#pragma unroll 1
  for (int64_t p = p0; p < p1; ++p) {
    const T* panel = a + p * kRows * n;   // the explicit load's address, from p
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
#pragma unroll 1
    for (int64_t c = threadIdx.x; c < packs; c += kThreads) {
      const Pack xv = reinterpret_cast<const Pack*>(x)[c];   // x, read again
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const Pack av = reinterpret_cast<const Pack*>(panel + r * n)[c];
#pragma unroll
        for (int j = 0; j < V; ++j)
          acc[r] = fmaf(ssr_f32(av.v[j]), ssr_f32(xv.v[j]), acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float v = acc[r];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0) sums[warp][r] = v;
    }
    __syncthreads();
    if (threadIdx.x < kRows) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) v += sums[w][threadIdx.x];
      y[p * kRows + threadIdx.x] = v;
    }
    __syncthreads();   // sums is refilled by the next panel
  }
}

template <typename T, int V>
int launch(const void* a, const void* x, void* y, int64_t npanels, int64_t n,
           cudaStream_t st) {
  const int64_t ctas = (npanels + kPanelsPerCta - 1) / kPanelsPerCta;
  base_gemv_kernel<T, V><<<static_cast<unsigned>(ctas), kThreads, 0, st>>>(
      static_cast<const T*>(a), static_cast<const T*>(x),
      static_cast<float*>(y), npanels, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// A (npanels * 8, n) and x (1, n) are row-major; y is (npanels * 8, 1) f32.
// `vec` is 16 / sizeof(element) when A's and x's base pointers and n allow
// 16-byte accesses, else 1.
extern "C" int ssr_base_gemv(const void* a, const void* x, void* y,
                             int dtype, int vec, int64_t npanels, int64_t n,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == SSR_F32 && vec == 4)
    return launch<float, 4>(a, x, y, npanels, n, st);
  if (dtype == SSR_F32 && vec == 1)
    return launch<float, 1>(a, x, y, npanels, n, st);
  if (dtype == SSR_BF16 && vec == 8)
    return launch<__nv_bfloat16, 8>(a, x, y, npanels, n, st);
  if (dtype == SSR_BF16 && vec == 1)
    return launch<__nv_bfloat16, 1>(a, x, y, npanels, n, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int64_t ssr_base_gemv_smem_bytes() {
  return static_cast<int64_t>(sizeof(float)) * (kThreads / 32) * kRows;
}
