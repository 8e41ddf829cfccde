// The arithmetic of the 1-D halo stencil, shared by K9 halo_stencil1d and
// R10 ring_halo_stencil1d: the work items a CTA walks, the taps, and the
// four outputs a thread computes from a staged item.  Both kernels run
// compute_item on the same staged values in the same order, so R10 gives
// K9's bits at every depth.
#pragma once

#include "ssr_common.cuh"

namespace stencil1d {

constexpr int kTaps = 11;
constexpr int kThreads = 128;
constexpr int kPer = 4;                       // outputs per thread
constexpr int kChunk = kThreads * kPer;       // outputs per work item
constexpr int kStaged = kChunk + 16;          // the chunk, its halo, slack

// One work item: kChunk outputs of one grid step's block (a block wider
// than kChunk is several items), its widened input and its output.
template <typename T>
struct Item {
  const T* src;
  float* dst;
  int len;      // outputs; 0: no item (past the CTA's last step)
  __device__ __forceinline__ int wide() const { return len > 0 ? len + kTaps - 1 : 0; }
};

// The CTA's work items in grid order: `per_cta` consecutive steps, each
// block cut into kChunk-wide items.
template <typename T>
struct Cursor {
  SsrOdometer odo;
  int64_t step, last, c0 = 0, tile;
  __device__ __forceinline__ Cursor(const SsrGrid& g, int64_t first, int64_t last_,
                                    int64_t tile_)
      : odo(g, first), step(first), last(last_), tile(tile_) {}
  __device__ __forceinline__ Item<T> next(const SsrGrid& g, const T* x, float* y,
                                          const SsrStream& sx, const SsrStream& sy) {
    Item<T> it{nullptr, nullptr, 0};
    if (step >= last) return it;
    it.src = x + odo.origin(sx) + c0;
    it.dst = y + odo.origin(sy) + c0;
    it.len = static_cast<int>(tile - c0 < kChunk ? tile - c0 : kChunk);
    c0 += kChunk;
    if (c0 >= tile) {
      c0 = 0;
      ++step;
      odo.advance(g);
    }
    return it;
  }
};

// Four consecutive staged values as floats: one 16-byte read of f32, one
// 8-byte read of bf16 (converted exactly).
__device__ __forceinline__ float4 staged4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 staged4(const __nv_bfloat16* p) {
  return ssr_load4_f32<__nv_bfloat16>(p);
}

// Four consecutive outputs of one staged item (S: the staged type, f32 or
// bf16): taps in the reference's order (j = 0 first, acc = acc + w[j] *
// x[i + j], contracted to FMA by nvcc), the relu drain if asked, one
// 16-byte store where `V` is 4 (the wrapper found y aligned).
template <int V, typename S>
__device__ __forceinline__ void compute_item(const S* xs, int len,
                                             const float* wr, int relu,
                                             float* dst) {
  const int i0 = threadIdx.x * kPer;
  if (i0 >= len) return;
  float v[16];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 p = staged4(xs + i0 + 4 * q);
    v[4 * q] = p.x; v[4 * q + 1] = p.y; v[4 * q + 2] = p.z; v[4 * q + 3] = p.w;
  }
  float acc[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) acc[k] = wr[0] * v[k];
#pragma unroll
  for (int j = 1; j < kTaps; ++j)
#pragma unroll
    for (int k = 0; k < kPer; ++k) acc[k] = acc[k] + wr[j] * v[k + j];
  if (relu) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) acc[k] = ssr_relu(acc[k]);
  }
  float* out = dst + i0;
  if (V == 4 && len - i0 >= kPer) {
    *reinterpret_cast<float4*>(out) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      if (i0 + k < len) out[k] = acc[k];
  }
}

// The taps, read once a CTA into shared memory (`ws`) and registers (`wr`).
template <typename T>
__device__ __forceinline__ void load_taps(const T* w, const SsrStream& sw,
                                          const SsrGrid& g, int64_t first,
                                          float* ws, float* wr) {
  if (threadIdx.x < kTaps) ws[threadIdx.x] = ssr_f32(w[SsrOdometer(g, first).origin(sw) + threadIdx.x]);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kTaps; ++j) wr[j] = ws[j];
}

}  // namespace stencil1d
