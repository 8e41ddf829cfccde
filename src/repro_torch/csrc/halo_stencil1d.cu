// K9 halo_stencil1d: y[i] = sum_j w[j] * x[i + j] over each lowered block
// (11 taps, f32 accumulator), with an optional relu drain.
//
// Replaces the TPU kernel repro/core/ssr.py:ssr_pallas (sync emitter) with
// the plain branch of repro/core/lowering.py:_build_nest_kernel, its halo
// widening _halo_widen (the +1-shifted twin stream) and the body
// repro/kernels/stencil.py:stencil1d_block; with `relu` set, the fused body
// repro/kernels/chained.py:_stencil_relu_body.  At n = 2^26 the default
// lowering gives grid (131072,), blocks x (1, 512) twice (the second walk
// shifted one block), w (1, 128) and y (1, 512).
//
// Bound on H100: bytes.  Each input element is read once and each output
// written once; 11 FMAs per output are far below the FP32 rate.
//
// Design: on the TPU the twin stream exists because a DMA moves whole
// blocks.  Here a CTA reads the widened block -- tile + taps - 1 elements --
// straight from the first slot's walk (the layout's extra padded tile keeps
// the read in range) into shared memory, in work items of kChunk outputs,
// so each input element is read once per CTA, plus taps - 1 elements of
// overlap per item.  The twin's walk is never read.  A CTA walks `per_cta`
// consecutive grid steps.  For f32 the items go through a ring of eight
// shared-memory stages filled by cp.async, so seven items are in flight
// while one is computed (the data mover running ahead of the FMAs, as the
// SSR's FIFO does); bf16 items go through registers, four per barrier.
// Each thread computes four consecutive outputs from 16 staged values, taps
// in the reference's order (j = 0 first, acc = acc + w[j] * x[i + j],
// contracted to FMA by nvcc), and stores them as one 16-byte pack where the
// wrapper found the layouts aligned.
#include "ssr_common.cuh"

namespace {

constexpr int kTaps = 11;
constexpr int kThreads = 128;
constexpr int kPer = 4;                       // outputs per thread
constexpr int kChunk = kThreads * kPer;       // outputs per work item
constexpr int kStaged = kChunk + 16;          // the chunk, its halo, slack
constexpr int kStages = 4;                    // bf16 items per round
constexpr int kRing = 8;                      // f32 items in the ring

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

// Four consecutive outputs of one staged item: taps in the reference's
// order (j = 0 first, acc = acc + w[j] * x[i + j], contracted to FMA by
// nvcc), the relu drain if asked, one 16-byte store where aligned.
template <int V>
__device__ __forceinline__ void compute_item(const float* xs, int len,
                                             const float* wr, int relu,
                                             float* dst) {
  const int i0 = threadIdx.x * kPer;
  if (i0 >= len) return;
  float v[16];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 p = reinterpret_cast<const float4*>(xs + i0)[q];
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

template <typename T>
__device__ __forceinline__ void load_taps(const T* w, const SsrStream& sw,
                                          const SsrGrid& g, int64_t first,
                                          float* ws, float* wr) {
  if (threadIdx.x < kTaps) ws[threadIdx.x] = ssr_f32(w[SsrOdometer(g, first).origin(sw) + threadIdx.x]);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kTaps; ++j) wr[j] = ws[j];
}

// f32: a ring of kRing items in shared memory filled by cp.async, kRing - 1
// items in flight while one is computed.  V = 4: 16-byte copies (the
// wrapper found the layouts aligned), else 4-byte copies.  The ring's item
// records live in shared memory, written by thread 0 when the item is
// issued and read after the barrier that follows its arrival.
template <int V>
__global__ void __launch_bounds__(kThreads)
    halo_stencil1d_ring(const float* __restrict__ x, const float* __restrict__ w,
                        float* __restrict__ y, SsrGrid g, SsrStream sx,
                        SsrStream sw, SsrStream sy, int64_t steps,
                        int64_t per_cta, int relu) {
  __shared__ __align__(16) float xs[kRing][kStaged];
  __shared__ float* dst[kRing];
  __shared__ int len[kRing];
  __shared__ float ws[kTaps];
  const int64_t first = blockIdx.x * per_cta;
  if (first >= steps) return;
  const int64_t last = first + per_cta < steps ? first + per_cta : steps;
  float wr[kTaps];
  load_taps(w, sw, g, first, ws, wr);
  Cursor<float> cur(g, first, last, sx.block[1]);

  auto issue = [&](int s) {
    const Item<float> it = cur.next(g, x, y, sx, sy);
    if (threadIdx.x == 0) {
      dst[s] = it.dst;
      len[s] = it.len;
    }
    const int wide = it.wide();
    if constexpr (V == 4) {
      const int packs = wide / 4;
      for (int p = threadIdx.x; p < packs; p += kThreads)
        ssr_cp_async16(xs[s] + 4 * p, it.src + 4 * p);
      for (int i = packs * 4 + threadIdx.x; i < wide; i += kThreads)
        ssr_cp_async4(xs[s] + i, it.src + i);
    } else {
      for (int i = threadIdx.x; i < wide; i += kThreads)
        ssr_cp_async4(xs[s] + i, it.src + i);
    }
    ssr_cp_async_commit();
  };

#pragma unroll
  for (int s = 0; s < kRing - 1; ++s) issue(s);
  __syncthreads();
  for (int it = 0;; ++it) {
    const int s = it % kRing;
    if (len[s] == 0) break;
    issue((it + kRing - 1) % kRing);       // the stage computed last round
    ssr_cp_async_wait<kRing - 1>();        // item `it` has landed
    __syncthreads();
    compute_item<V>(xs[s], len[s], wr, relu, dst[s]);
    __syncthreads();                       // before its stage is refilled
  }
}

// bf16: kStages items per round through registers -- every load of a
// thread issued before any of its stores -- then computed.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    halo_stencil1d_batch(const T* __restrict__ x, const T* __restrict__ w,
                         float* __restrict__ y, SsrGrid g, SsrStream sx,
                         SsrStream sw, SsrStream sy, int64_t steps,
                         int64_t per_cta, int relu) {
  __shared__ __align__(16) float xs[kStages][kStaged];
  __shared__ float ws[kTaps];
  const int64_t first = blockIdx.x * per_cta;
  if (first >= steps) return;
  const int64_t last = first + per_cta < steps ? first + per_cta : steps;
  float wr[kTaps];
  load_taps(w, sw, g, first, ws, wr);
  Cursor<T> cur(g, first, last, sx.block[1]);
  for (;;) {
    Item<T> it[kStages];
#pragma unroll
    for (int b = 0; b < kStages; ++b) it[b] = cur.next(g, x, y, sx, sy);
    if (it[0].len == 0) break;
    __syncthreads();   // the previous round's readers are done
#pragma unroll
    for (int b = 0; b < kStages; ++b) {
      const int wide = it[b].wide();
      constexpr int kRegs = (kStaged + kThreads - 1) / kThreads;
      float r[kRegs];
#pragma unroll
      for (int k = 0; k < kRegs; ++k) {
        const int i = threadIdx.x + k * kThreads;
        if (i < wide) r[k] = ssr_f32(it[b].src[i]);
      }
#pragma unroll
      for (int k = 0; k < kRegs; ++k) {
        const int i = threadIdx.x + k * kThreads;
        if (i < wide) xs[b][i] = r[k];
      }
    }
    __syncthreads();
#pragma unroll
    for (int b = 0; b < kStages; ++b)
      compute_item<1>(xs[b], it[b].len, wr, relu, it[b].dst);
  }
}

int launch(int dtype, int vec, const void* x, const void* w, void* y,
           const SsrGrid* g, const SsrStream* sx, const SsrStream* sw,
           const SsrStream* sy, int64_t steps, int64_t ctas, int64_t per_cta,
           int relu, cudaStream_t st) {
  const unsigned n = static_cast<unsigned>(ctas);
  float* out = static_cast<float*>(y);
  if (dtype == SSR_F32 && vec == 4)
    halo_stencil1d_ring<4><<<n, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), out, *g, *sx,
        *sw, *sy, steps, per_cta, relu);
  else if (dtype == SSR_F32 && vec == 1)
    halo_stencil1d_ring<1><<<n, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), out, *g, *sx,
        *sw, *sy, steps, per_cta, relu);
  else if (dtype == SSR_BF16 && vec == 1)
    halo_stencil1d_batch<__nv_bfloat16><<<n, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        out, *g, *sx, *sw, *sy, steps, per_cta, relu);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `sx` is the first slot's walk of x (its block is the unwidened tile);
// `vec` is 4 when x and y are f32 with 16-byte aligned rows and blocks,
// else 1; `relu` (0 or 1) selects the relu drain.  y is f32.
extern "C" int ssr_halo_stencil1d(const void* x, const void* w, void* y,
                                  int dtype, int vec, const SsrGrid* g,
                                  const SsrStream* sx, const SsrStream* sw,
                                  const SsrStream* sy, int64_t ctas,
                                  int64_t per_cta, int relu, void* stream) {
  int64_t steps = 1;
  for (int k = 0; k < g->ndim; ++k) steps *= g->dims[k];
  return launch(dtype, vec, x, w, y, g, sx, sw, sy, steps, ctas, per_cta, relu,
                static_cast<cudaStream_t>(stream));
}

// Shared memory of one CTA for a window of `taps` (the kernel takes 11).
extern "C" int64_t ssr_halo_stencil1d_smem_bytes(int64_t taps) {
  (void)taps;
  return static_cast<int64_t>(sizeof(float)) * (kRing * kStaged + kTaps) +
         static_cast<int64_t>(sizeof(float*) + sizeof(int)) * kRing;
}
