// The arithmetic of the 2-D halo stencil (the 11-point star), shared by
// K10 halo_stencil2d and R11 ring_halo_stencil2d: the windows a CTA walks,
// the taps, and a window's outputs from its staged input.  Both kernels run
// compute_window on the same staged values in the same order, so R11 gives
// K10's bits at every depth.
#pragma once

#include "ssr_common.cuh"

namespace stencil2d {

constexpr int kTaps = 11;
constexpr int kR = kTaps / 2;
constexpr int kRows = 32;                     // CTA output tile
constexpr int kCols = 128;
constexpr int kThreads = 128;                 // 4 row groups x 32 columns of 4
constexpr int kRowsPer = kRows / (kThreads / 32);   // rows a thread owns
constexpr int kWideRows = kRows + kTaps - 1;  // 42
constexpr int kWideCols = kCols + kTaps - 1;  // 138
// A staged row: 140 f32 or 144 bf16 elements, a 16-byte multiple either way.
template <typename S>
struct Pitch {
  static constexpr int value = 16 / sizeof(S) * ((kWideCols * sizeof(S) + 15) / 16);
};
constexpr int kPitch = Pitch<float>::value;   // 140

// A window: one 32 x 128 output sub-tile of a grid step's block, its
// widened input at `src` (rows x cols outputs, + 10 each way) and its
// output at `dst`.
template <typename T>
struct Window {
  const T* src;
  float* dst;
  int rows, cols;
};

template <typename T>
__device__ __forceinline__ Window<T> window_of(int64_t w, const T* x, float* y,
                                               const SsrGrid& g,
                                               const SsrStream& sx,
                                               const SsrStream& sy,
                                               int64_t subr, int64_t subc) {
  const int64_t per_step = subr * subc;
  const int64_t step = w / per_step, rem = w % per_step;
  const int64_t r0 = (rem / subc) * kRows, c0 = (rem % subc) * kCols;
  const SsrOdometer odo(g, step);
  Window<T> win;
  win.rows = static_cast<int>(sx.block[0] - r0 < kRows ? sx.block[0] - r0 : kRows);
  win.cols = static_cast<int>(sx.block[1] - c0 < kCols ? sx.block[1] - c0 : kCols);
  win.src = x + odo.origin(sx) + r0 * sx.pitch + c0;
  win.dst = y + odo.origin(sy) + r0 * sy.pitch + c0;
  return win;
}

// Four consecutive staged values as floats: a 16-byte read of f32, an
// 8-byte read of bf16 (converted exactly).
__device__ __forceinline__ float4 staged4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 staged4(const __nv_bfloat16* p) {
  return ssr_load4_f32<__nv_bfloat16>(p);
}

// Columns 5 + c .. 8 + c of staged row `row`: the wy arm's four values for
// a thread's columns c .. c + 3, from two aligned reads.
template <typename S>
__device__ __forceinline__ float4 wy_cols(const S* xs, int row, int c) {
  const S* r = xs + row * Pitch<S>::value + c;
  const float4 a = staged4(r + 4), b = staged4(r + 8);
  return make_float4(a.y, a.z, a.w, b.x);
}

__device__ __forceinline__ float lane_of(const float4& v, int m) {
  return m == 0 ? v.x : m == 1 ? v.y : m == 2 ? v.z : v.w;
}

// The taps of one window from its staged input (S: the staged type, f32 or
// bf16).  A thread owns eight rows and four consecutive columns; it walks
// its rows keeping the wy arm's eleven rows in a register ring (one new
// row a step) and reads the wx arm's fourteen values of each row as four
// reads: 68 reads for its 32 outputs.  Each output sums per j the wx arm,
// then the wy arm, from zero.
template <typename S>
__device__ __forceinline__ void compute_window(const S* xs, const float* wxs,
                                               const float* wys, float* dst,
                                               int64_t pitch, int rows, int cols) {
  constexpr int kP = Pitch<S>::value;
  const int r0 = kRowsPer * (threadIdx.x >> 5), c = 4 * (threadIdx.x & 31);
  float wx[kTaps], wy[kTaps];
#pragma unroll
  for (int j = 0; j < kTaps; ++j) {
    wx[j] = wxs[j];
    wy[j] = wys[j];
  }
  float4 ycols[kTaps];
#pragma unroll
  for (int q = 0; q < kTaps - 1; ++q) ycols[q] = wy_cols(xs, r0 + q, c);
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    if (r0 + i >= rows) break;
    ycols[(i + kTaps - 1) % kTaps] = wy_cols(xs, r0 + i + kTaps - 1, c);
    float xr[16];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 v = staged4(xs + (r0 + i + kR) * kP + c + 4 * q);
      xr[4 * q] = v.x; xr[4 * q + 1] = v.y; xr[4 * q + 2] = v.z; xr[4 * q + 3] = v.w;
    }
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kTaps; ++j)
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        acc[m] = acc[m] + wx[j] * xr[m + j];
        acc[m] = acc[m] + wy[j] * lane_of(ycols[(i + j) % kTaps], m);
      }
    float* out = dst + (r0 + i) * pitch + c;
    if (c + 3 < cols && (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
      *reinterpret_cast<float4*>(out) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
#pragma unroll
      for (int m = 0; m < 4; ++m)
        if (c + m < cols) out[m] = acc[m];
    }
  }
}

// The taps, read once a CTA into shared memory.
template <typename T>
__device__ __forceinline__ void load_taps(const T* wx, const T* wy,
                                          const SsrStream& swx,
                                          const SsrStream& swy,
                                          const SsrGrid& g, float* wxs,
                                          float* wys) {
  if (threadIdx.x < kTaps) {
    const SsrOdometer odo(g, 0);
    wxs[threadIdx.x] = ssr_f32(wx[odo.origin(swx) + threadIdx.x]);
    wys[threadIdx.x] = ssr_f32(wy[odo.origin(swy) + threadIdx.x]);
  }
}

}  // namespace stencil2d
