// B5 base_stencil1d: the monolithic baseline of the 11-tap stencil,
// y[i] = sum_j w[j] * x[i + j], f32 out.
//
// Replaces the TPU kernel repro/kernels/frontend.py:MonolithicKernel._build
// with the baseline body repro/kernels/stencil.py:_baseline_body_1d: one
// grid step whose body loops over the taps, each tap one explicit
// dynamic-slice load of x, accumulated in f32.
//
// Bound on H100: bytes, as K9: each input element read once, each output
// written once.
//
// Design: the baseline runs on K9's CTAs and K9's default tile (512 outputs
// a grid step, `per_cta` steps a CTA, 128 threads of four outputs), so the
// pair's times compare the delivery and nothing else.  Nothing is staged in
// shared memory: each output's 11 taps are 11 separate global loads, issued
// when the sum needs them -- the baseline's serialised load-compute issue.
// The neighbouring outputs' loads of one thread hit L1 or L2, not device
// memory.
#include "ssr_common.cuh"

namespace {

constexpr int kTaps = 11;
constexpr int kThreads = 128;
constexpr int kPer = 4;
constexpr int kTile = kThreads * kPer;   // K9's default tile: 512 outputs

template <typename T>
__global__ void __launch_bounds__(kThreads)
    base_stencil1d_kernel(const T* __restrict__ x, const float* __restrict__ w,
                          float* __restrict__ y, int64_t n, int64_t steps,
                          int64_t per_cta) {
  const int64_t first = blockIdx.x * per_cta;
  const int64_t last = first + per_cta < steps ? first + per_cta : steps;
  float wr[kTaps];
#pragma unroll
  for (int j = 0; j < kTaps; ++j) wr[j] = w[j];
  for (int64_t step = first; step < last; ++step) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int64_t i = step * kTile + k * kThreads + threadIdx.x;
      if (i >= n) continue;
      float acc = wr[0] * ssr_f32(x[i]);
#pragma unroll
      for (int j = 1; j < kTaps; ++j) acc = acc + wr[j] * ssr_f32(x[i + j]);
      y[i] = acc;
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, void* y, int64_t n, int64_t steps,
           int64_t ctas, int64_t per_cta, cudaStream_t st) {
  base_stencil1d_kernel<T><<<static_cast<unsigned>(ctas), kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<float*>(y), n, steps, per_cta);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x holds n + 10 elements (f32 or bf16), w the 11 f32 taps, y n f32 outputs;
// `ctas` CTAs walk `per_cta` tiles of 512 outputs each.
extern "C" int ssr_base_stencil1d(const void* x, const void* w, void* y,
                                  int dtype, int64_t n, int64_t ctas,
                                  int64_t per_cta, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t steps = (n + kTile - 1) / kTile;
  if (dtype == SSR_F32) return launch<float>(x, w, y, n, steps, ctas, per_cta, st);
  if (dtype == SSR_BF16)
    return launch<__nv_bfloat16>(x, w, y, n, steps, ctas, per_cta, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int64_t ssr_base_stencil1d_smem_bytes() { return 0; }
