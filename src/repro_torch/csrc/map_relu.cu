// K2 map_relu: out_blk = max(0, x_blk) for every grid step, dtype kept.
//
// Replaces the TPU kernel repro/core/ssr.py:ssr_pallas (sync emitter) with
// the map epilogue of repro/core/lowering.py:_assemble_kernel and the body
// repro/kernels/relu.py:relu_block: one read stream in, one dense row-major
// write stream out, every grid axis `parallel`.
//
// Bound on H100: bytes -- one read and one write per element, no reuse.
//
// Design: each CTA takes a run of consecutive grid steps (row blocks; the
// wrapper's split, core/hopper.py MAP_PER_SM: 128 CTAs an SM asked for,
// runs of 4 steps on the relu cells, in waves), and its threads take their
// packs of each step's block in turn, 16 bytes per access where the
// wrapper found the layouts aligned for it: on a flat walk (ssr_run.cuh's
// ssr_run_is_flat: every vector's relu) one pack a step, by pointers a
// constant stride apart; on any other through the input stream's AGU
// programming and the output stream's (the dense out_map; SsrRunWalk).
// Against the bound, the walk reads ahead: a thread issues the loads of
// its next kAhead packs (kAhead steps of an (8, 128) block) before its
// first store, 64 bytes a thread, at least 64 KiB in flight an SM at the
// CTAs an SM it is built for, where the parent's step loop held 16 bytes;
// then it stores them in order, the packs kept as raw words in registers.
// A 16-bit type in 16-byte packs has 128 packs to an (8, 128) block, so
// those builds run 128-thread CTAs and every thread has a pack of each
// step.  The result is bit-exact with the reference for every dtype: the
// value is selected on its bits, never computed, so int32 above 2^24 stays
// exact; NaN passes through and -0.0 becomes +0.0, as jnp.maximum(x, 0)
// does.  R2 (ring_map_relu.cu) selects the same bits on a split of its own.
#include "ssr_run.cuh"

namespace {

// CTAs of 256 threads an SM K2 is built for, at most 64 registers a
// thread; 6 and 8 on a flat walk measured no faster (PERF.md)
constexpr int kMinCtas = 4;
// packs a thread has in flight before its first store (plain loads and
// stores: evict-first loads and streaming stores measured no faster,
// PERF.md)
constexpr int kAhead = 4;

// Threads of a CTA: 128 for a 16-bit type in 16-byte packs, else 256.
template <typename T, int V>
constexpr int threads_for() {
  return sizeof(T) == 2 && V == 8 ? 128 : 256;
}

template <typename T, int V, int kThreads, bool kFlat>
__global__ void __launch_bounds__(kThreads, kMinCtas * 256 / kThreads)
    map_relu_kernel(const T* __restrict__ x, T* __restrict__ out, SsrGrid g,
                    SsrStream sx, SsrStream so, SsrRunSteps rs, int64_t steps,
                    int64_t steps_per_cta) {
  using Words = SsrWords<T, V>;
  const int rows = static_cast<int>(sx.block[0]);
  const int64_t s0 = static_cast<int64_t>(blockIdx.x) * steps_per_cta;
  const int64_t s1 = s0 + steps_per_cta < steps ? s0 + steps_per_cta : steps;
  const int packs = static_cast<int>(sx.block[1]) / V;
  if constexpr (kFlat) {
    // one pack of each step's block a thread, a stride apart: the loads of
    // the next kAhead steps' packs, then their stores in order
    const SsrFlatCell cell(threadIdx.x, packs);
    if (cell.r >= rows) return;
    const T* px = x + cell.at(sx, g, s0, V);
    T* po = out + cell.at(so, g, s0, V);
    const int64_t dx = rs.step[0][0], dout = rs.step[0][1];
    for (int64_t left = s1 - s0; left > 0; left -= kAhead) {
      Words p[kAhead];
      ssr_for<kAhead>([&](auto ahead) {
        constexpr int u = decltype(ahead)::value;
        if (u < left) p[u] = *reinterpret_cast<const Words*>(px + u * dx);
      });
      ssr_for<kAhead>([&](auto ahead) {
        constexpr int u = decltype(ahead)::value;
        if (u < left)
          *reinterpret_cast<Words*>(po + u * dout) = ssr_relu_pack<T, V>(p[u]);
      });
      px += kAhead * dx;
      po += kAhead * dout;
    }
  } else {
    SsrRunWalk at(g, sx, so, s0, threadIdx.x, kThreads, packs);
    if (!at.has_cells(rows)) return;
    while (at.s < s1) {
      // the loads of the next kAhead packs, then their stores in order
      // (the walk moves on past the run's end; what it reads there is
      // never loaded)
      Words p[kAhead];
      int64_t dst[kAhead];
      int n = 0;
      ssr_for<kAhead>([&](auto ahead) {
        constexpr int u = decltype(ahead)::value;
        const int64_t r_ = at.w.r, c_ = at.w.c * V;
        if (at.s < s1) {
          p[u] = *reinterpret_cast<const Words*>(x + at.o0 + r_ * sx.pitch +
                                                 c_);
          ++n;
        }
        dst[u] = at.o1 + r_ * so.pitch + c_;
        at.next(g, rs, rows);
      });
      ssr_for<kAhead>([&](auto ahead) {
        constexpr int u = decltype(ahead)::value;
        if (u < n)
          *reinterpret_cast<Words*>(out + dst[u]) = ssr_relu_pack<T, V>(p[u]);
      });
    }
  }
}

template <typename T, int V>
void launch(const void* x, void* out, const SsrGrid* g, const SsrStream* sx,
            const SsrStream* so, int64_t steps, int64_t num_ctas,
            int64_t steps_per_cta, cudaStream_t st) {
  constexpr int kThreads = threads_for<T, V>();
  const SsrRunSteps rs = ssr_run_steps(*g, *sx, *so);
  const unsigned grid = static_cast<unsigned>(num_ctas);
  if (ssr_run_is_flat(*g, *sx, V, kThreads))
    map_relu_kernel<T, V, kThreads, true><<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<T*>(out), *g, *sx, *so, rs,
        steps, steps_per_cta);
  else
    map_relu_kernel<T, V, kThreads, false><<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<T*>(out), *g, *sx, *so, rs,
        steps, steps_per_cta);
}

}  // namespace

// `vec` is 16 / sizeof(element) when both streams' pitch, block width and
// base pointer allow 16-byte accesses, else 1.
extern "C" int ssr_map_relu(const void* x, void* out, int dtype, int vec,
                            const SsrGrid* g, const SsrStream* sx,
                            const SsrStream* so, int64_t num_ctas,
                            int64_t steps_per_cta, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int64_t steps = 1;
  for (int k = 0; k < g->ndim; ++k) steps *= g->dims[k];
  const int64_t n = num_ctas, per = steps_per_cta;
  if (dtype == SSR_F32 && vec == 4)
    launch<float, 4>(x, out, g, sx, so, steps, n, per, st);
  else if (dtype == SSR_F32 && vec == 1)
    launch<float, 1>(x, out, g, sx, so, steps, n, per, st);
  else if (dtype == SSR_BF16 && vec == 8)
    launch<__nv_bfloat16, 8>(x, out, g, sx, so, steps, n, per, st);
  else if (dtype == SSR_BF16 && vec == 1)
    launch<__nv_bfloat16, 1>(x, out, g, sx, so, steps, n, per, st);
  else if (dtype == SSR_I32 && vec == 4)
    launch<int32_t, 4>(x, out, g, sx, so, steps, n, per, st);
  else if (dtype == SSR_I32 && vec == 1)
    launch<int32_t, 1>(x, out, g, sx, so, steps, n, per, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int64_t ssr_map_relu_smem_bytes() { return 0; }

// Registers a thread and local (spill) bytes, the most over every
// instantiation, as cudaFuncGetAttributes reads them, and the CTAs an SM
// of the main path's (f32, 16-byte packs, a flat walk; occupancy API):
// out[0] numRegs, out[1] localSizeBytes, out[2] CTAs an SM.
extern "C" int ssr_map_relu_attributes(int64_t* out) {
  const void* const kernels[] = {
      reinterpret_cast<const void*>(map_relu_kernel<float, 4, 256, true>),
      reinterpret_cast<const void*>(map_relu_kernel<float, 4, 256, false>),
      reinterpret_cast<const void*>(map_relu_kernel<float, 1, 256, true>),
      reinterpret_cast<const void*>(map_relu_kernel<float, 1, 256, false>),
      reinterpret_cast<const void*>(map_relu_kernel<__nv_bfloat16, 8, 128, true>),
      reinterpret_cast<const void*>(map_relu_kernel<__nv_bfloat16, 8, 128, false>),
      reinterpret_cast<const void*>(map_relu_kernel<__nv_bfloat16, 1, 256, true>),
      reinterpret_cast<const void*>(map_relu_kernel<__nv_bfloat16, 1, 256, false>),
      reinterpret_cast<const void*>(map_relu_kernel<int32_t, 4, 256, true>),
      reinterpret_cast<const void*>(map_relu_kernel<int32_t, 4, 256, false>),
      reinterpret_cast<const void*>(map_relu_kernel<int32_t, 1, 256, true>),
      reinterpret_cast<const void*>(map_relu_kernel<int32_t, 1, 256, false>)};
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
      &ctas, map_relu_kernel<float, 4, 256, true>, 256, 0);
  out[2] = ctas;
  return static_cast<int>(err);
}
