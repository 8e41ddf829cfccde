// B6 base_spmv: spmv's monolithic baseline.  out (m, 1) = sum_j vals[i, j] *
// x[0, clip(cidx[i, j])] over the unpadded ELL planes vals (f32) and cidx
// (int32), both (m, k), and x as (1, n) -- the layouts the reference's
// baseline MonolithicKernel prepares.
//
// Replaces the TPU kernel repro/kernels/frontend.py:MonolithicKernel._build
// with the body repro/kernels/sparse.py:_base_body_spmv: one grid step whose
// body loads the index block, computes each address and gathers x with an
// explicit clipped take, then sums vals * gathered along each row.
//
// Bound on H100: bytes, as K12 (gather_spmv.cu): the ELL planes, x and the
// output once each.
//
// Design: B6 runs on K12's CTAs -- 256 threads, a group of 4 threads per row,
// 64 rows per CTA -- and walks each row's entries in order.  Per element a
// thread loads the index, computes the address from it (clipped into x, as
// take's mode="clip"), then loads vals and the table element and multiplies
// at once: the loop is not unrolled, so no element's loads are in flight
// while another computes -- the explicit index handling the indirection
// papers charge against a scalar core.  Every column of the planes is read,
// pads included (0 * x[0]).  The group folds its sums by shuffles.
#include "ssr_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 4;                        // K12's threads per row
constexpr int kRowsPerCta = kThreads / kGroup;   // 64, as K12

__global__ void __launch_bounds__(kThreads)
    base_spmv_kernel(const float* __restrict__ vals,
                     const int32_t* __restrict__ cidx,
                     const float* __restrict__ x, float* __restrict__ out,
                     int64_t m, int64_t k, int64_t n) {
  const int t = threadIdx.x % kGroup;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kRowsPerCta + threadIdx.x / kGroup;
  float acc = 0.f;
  if (row < m) {
    const float* pv = vals + row * k;
    const int32_t* pc = cidx + row * k;
#pragma unroll 1
    for (int64_t j = t; j < k; j += kGroup) {
      const int64_t c = pc[j];                              // the index
      const int64_t a = c < 0 ? 0 : (c >= n ? n - 1 : c);   // its address
      acc = fmaf(pv[j], x[a], acc);                         // load, use
    }
  }
#pragma unroll
  for (int o = kGroup / 2; o > 0; o >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, o, kGroup);
  if (row < m && t == 0) out[row] = acc;
}

}  // namespace

extern "C" int ssr_base_spmv(const void* vals, const void* cidx, const void* x,
                             void* out, int64_t m, int64_t k, int64_t n,
                             void* stream) {
  const int64_t ctas = (m + kRowsPerCta - 1) / kRowsPerCta;
  if (m < 1 || k < 1 || n < 1 || ctas > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  base_spmv_kernel<<<static_cast<unsigned>(ctas), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int32_t*>(cidx),
      static_cast<const float*>(x), static_cast<float*>(out), m, k, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int64_t ssr_base_spmv_smem_bytes() { return 0; }
