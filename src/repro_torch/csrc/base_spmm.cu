// B7 base_spmm: spmm's monolithic baseline.  out (m, c) = sum_j vals[i, j] *
// X[clip(cidx[i, j]), :] over the unpadded ELL planes vals (f32) and cidx
// (int32), both (m, k), and X (n, c) unpadded -- the layouts the reference's
// baseline MonolithicKernel prepares.
//
// Replaces the TPU kernel repro/kernels/frontend.py:MonolithicKernel._build
// with the body repro/kernels/sparse.py:_base_body_spmm: one grid step whose
// body gathers X's rows with an explicit clipped take by the index block and
// contracts them with vals.
//
// Bound on H100: bytes, as K13 (gather_spmm.cu): the ELL planes, X and the
// output once each.
//
// Design: B7 runs on K13's CTAs -- a warp per row, eight rows a CTA, 128
// columns a CTA (grid y) -- and walks each row's entries in order.  Per
// element every lane loads the index itself (no broadcast by shuffles),
// computes the row address from it (clipped into X, as take's mode="clip"),
// then loads vals and its four columns of that X row (lane, lane + 32, ...:
// c need not be a multiple of 4, so no 16-byte loads) and multiplies at
// once; the loop is not unrolled, so one element's loads complete before
// the next element's index is loaded.  Every column of the planes is read,
// pads included.
#include "ssr_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerCta = kThreads / 32;   // a warp per row, as K13
constexpr int kCols = 128;                   // K13's columns per CTA

__global__ void __launch_bounds__(kThreads)
    base_spmm_kernel(const float* __restrict__ vals,
                     const int32_t* __restrict__ cidx,
                     const float* __restrict__ x, float* __restrict__ out,
                     int64_t m, int64_t k, int64_t n, int64_t c) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowsPerCta + warp;
  const int64_t col0 = static_cast<int64_t>(blockIdx.y) * kCols + lane;
  if (row >= m) return;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  const float* pv = vals + row * k;
  const int32_t* pc = cidx + row * k;
#pragma unroll 1
  for (int64_t j = 0; j < k; ++j) {
    const int64_t i = pc[j];                               // the index
    const float* px = x + (i < 0 ? 0 : (i >= n ? n - 1 : i)) * c;  // address
    const float v = pv[j];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int64_t col = col0 + 32 * q;
      if (col < c) acc[q] = fmaf(v, px[col], acc[q]);       // load, use
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int64_t col = col0 + 32 * q;
    if (col < c) out[row * c + col] = acc[q];
  }
}

}  // namespace

extern "C" int ssr_base_spmm(const void* vals, const void* cidx, const void* x,
                             void* out, int64_t m, int64_t k, int64_t n,
                             int64_t c, void* stream) {
  const int64_t ctas = (m + kRowsPerCta - 1) / kRowsPerCta;
  const int64_t chunks = (c + kCols - 1) / kCols;
  if (m < 1 || k < 1 || n < 1 || c < 1 || ctas > 0x7fffffffLL ||
      chunks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(ctas), static_cast<unsigned>(chunks));
  base_spmm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int32_t*>(cidx),
      static_cast<const float*>(x), static_cast<float*>(out), m, k, n, c);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int64_t ssr_base_spmm_smem_bytes() { return 0; }
