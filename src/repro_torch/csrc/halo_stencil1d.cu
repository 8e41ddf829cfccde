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
// The items, the taps and compute_item are ssr_stencil1d.cuh, which R10
// ring_halo_stencil1d runs too.
#include "ssr_stencil1d.cuh"

namespace {

using namespace stencil1d;

constexpr int kStages = 4;                    // bf16 items per round
constexpr int kRing = 8;                      // f32 items in the ring

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
