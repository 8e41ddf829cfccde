// The run walk of K1 reduce_mul and K2 map_relu, K1's streaming loads, and
// K1's fold replayed in its own launch.
//
// A CTA of K1 or K2 walks a run of consecutive grid steps.  A thread takes
// its cells of each step's block in SsrBlockWalk's order (cell t, t + T,
// ... of the block's packs, T threads), then those of the next step's
// block: the order the parents' step loops took them in.  SsrRunWalk holds
// where the thread is in that walk, so that a kernel can issue the loads
// of several cells, from several steps, before it uses the first one.
#pragma once

#include <type_traits>
#include <utility>

#include "ssr_common.cuh"

// How two streams' block origins move along the grid: when axis k steps
// by one (step[k]) and when it wraps from its last index to 0 (wrap[k]),
// each for stream 0 and stream 1.  Computed once a launch, on the host, so
// that a walk adds them from the kernel's parameters.
struct SsrRunSteps {
  int64_t step[SSR_MAX_AXES][2];
  int64_t wrap[SSR_MAX_AXES][2];
};

inline SsrRunSteps ssr_run_steps(const SsrGrid& g, const SsrStream& a,
                                 const SsrStream& b) {
  SsrRunSteps rs{};
  const SsrStream* s[2] = {&a, &b};
  for (int k = 0; k < g.ndim; ++k)
    for (int i = 0; i < 2; ++i) {
      rs.step[k][i] = s[i]->coeff[k][0] * s[i]->block[0] * s[i]->pitch +
                      s[i]->coeff[k][1] * s[i]->block[1];
      rs.wrap[k][i] = (g.dims[k] - 1) * rs.step[k][i];
    }
  return rs;
}

// Whether a walk of `threads` threads over blocks of stream a is flat: a
// grid of one axis (every flat vector's), each thread at most one pack of
// V elements a block.  Then a thread's packs are one cell of each step's
// block, a constant stride apart in each stream (SsrRunSteps' step[0]),
// and a kernel walks them by pointers alone.
inline bool ssr_run_is_flat(const SsrGrid& g, const SsrStream& a, int V,
                            int threads) {
  return g.ndim == 1 && a.block[0] * (a.block[1] / V) <= threads;
}

// A thread's cell of a flat walk's blocks (thread t of the block's packs,
// row-major), and whether it has one.
struct SsrFlatCell {
  int r, c;
  __device__ __forceinline__ SsrFlatCell(int t, int packs) : r(t / packs), c(t % packs) {}
  // The element offset of the cell's first element in the block of stream
  // s at `step`.
  __device__ __forceinline__ int64_t at(const SsrStream& s, const SsrGrid& g,
                                        int64_t step, int V) const {
    return ssr_block_origin(s, g, step) + static_cast<int64_t>(r) * s.pitch +
           c * V;
  }
};

// Where a thread is in its walk of a run over two streams (K1: a and b;
// K2: x and the output): the step, its grid index, the origins of the
// step's blocks in both streams, and the thread's cell of the block.  The
// origins advance with the grid index, axis by axis (no division a step).
struct SsrRunWalk {
  int64_t s;                // the step
  int64_t o0, o1;           // the origins of its blocks in stream 0 and 1
  int gi[SSR_MAX_AXES];     // its grid index (the grid's dims are int32)
  SsrBlockWalk w;           // the thread's cell of the block
  int first_r, first_c;

  __device__ __forceinline__ SsrRunWalk(const SsrGrid& g, const SsrStream& a,
                                        const SsrStream& b, int64_t step,
                                        int thread, int threads, int packs)
      : s(step), w(thread, threads, packs), first_r(w.r), first_c(w.c) {
    const SsrOdometer odo(g, step);
    o0 = odo.origin(a);
    o1 = odo.origin(b);
#pragma unroll
    for (int k = 0; k < SSR_MAX_AXES; ++k) gi[k] = static_cast<int>(odo.g[k]);
  }

  // Whether the thread has a cell in a block of `rows` rows at all (a
  // block of fewer packs than threads leaves the rest idle).
  __device__ __forceinline__ bool has_cells(int rows) const {
    return first_r < rows;
  }

  // The thread's next cell: its next one in this block of `rows` rows,
  // else its first in the next step's.  Past the grid's last step the walk
  // wraps to its first.  (The axis loop has one exit, so it unrolls and
  // reads `rs` at constant offsets.)
  __device__ __forceinline__ void next(const SsrGrid& g,
                                       const SsrRunSteps& rs, int rows) {
    w.next();
    if (w.r < rows) return;
    w.r = first_r;
    w.c = first_c;
    ++s;
    bool carry = true;
#pragma unroll
    for (int k = SSR_MAX_AXES - 1; k >= 0; --k) {
      if (carry && k < g.ndim) {
        if (++gi[k] < g.dims[k]) {
          o0 += rs.step[k][0];
          o1 += rs.step[k][1];
          carry = false;
        } else {
          o0 -= rs.wrap[k][0];
          o1 -= rs.wrap[k][1];
          gi[k] = 0;
        }
      }
    }
  }
};

// f(u) for u = 0, ..., N - 1 in order, each u a std::integral_constant
// (its value decltype(u)::value): the loop is written out, so arrays
// indexed by it stay in registers where a rolled loop would put them in
// local memory.
template <typename F, int... U>
__device__ __forceinline__ void ssr_for_each(F&& f,
                                             std::integer_sequence<int, U...>) {
  (f(std::integral_constant<int, U>()), ...);
}
template <int N, typename F>
__device__ __forceinline__ void ssr_for(F&& f) {
  ssr_for_each(f, std::make_integer_sequence<int, N>());
}

// The bits of one pack of V elements of T, as the kernels move them: 16
// bytes (the wrapper checked the alignment) as a uint4, or one 4- or
// 2-byte element.  The kernels keep their packs as these words, so the
// packs read ahead stay in registers.
template <typename T, int V>
using SsrWords = std::conditional_t<
    sizeof(T) * V == 16, uint4,
    std::conditional_t<sizeof(T) * V == 4, unsigned, unsigned short>>;

// One pack at p, read once: ld.global.cs (evict-first in L1 and L2).
template <typename W>
__device__ __forceinline__ W ssr_load_once(const W* p) {
  return __ldcs(p);
}

// Word k (0 to 3) of a 16-byte pack; k is a constant where it is used.
__device__ __forceinline__ unsigned ssr_word(const uint4& u, int k) {
  return k == 0 ? u.x : k == 1 ? u.y : k == 2 ? u.z : u.w;
}
__device__ __forceinline__ unsigned& ssr_word(uint4& u, int k) {
  return k == 0 ? u.x : k == 1 ? u.y : k == 2 ? u.z : u.w;
}

// Element j of a pack of V elements of T as f32 (ssr_f32's value: a bf16
// is the high half of its f32).
template <typename T, int V, typename W>
__device__ __forceinline__ float ssr_element_f32(const W& w, int j) {
  if constexpr (sizeof(T) == 4 && V == 4) {
    return __uint_as_float(ssr_word(w, j));
  } else if constexpr (sizeof(T) == 2 && V == 8) {
    const unsigned u = ssr_word(w, j >> 1);
    return __uint_as_float((j & 1) ? (u & 0xffff0000u) : (u << 16));
  } else if constexpr (sizeof(T) == 4) {
    return __uint_as_float(w);
  } else {
    return __uint_as_float(static_cast<unsigned>(w) << 16);
  }
}

// ssr_relu (ssr_common.cuh) on the bits of one element: f32 and bf16 keep
// a positive value or a NaN, int32 a positive value; anything else is +0.
template <typename T>
__device__ __forceinline__ unsigned ssr_relu_bits(unsigned u) {
  if constexpr (std::is_same_v<T, float>)
    return (static_cast<int32_t>(u) > 0 || (u & 0x7fffffffu) > 0x7f800000u)
               ? u : 0u;
  else if constexpr (std::is_same_v<T, int32_t>)
    return static_cast<int32_t>(u) > 0 ? u : 0u;
  else   // one bf16 in the low half
    return (static_cast<int16_t>(u) > 0 || (u & 0x7fffu) > 0x7f80u) ? u : 0u;
}

// ssr_relu on every element of a pack of V elements of T.
template <typename T, int V, typename W>
__device__ __forceinline__ W ssr_relu_pack(W w) {
  if constexpr (sizeof(T) * V == 16) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      unsigned& u = ssr_word(w, k);
      if constexpr (sizeof(T) == 4)
        u = ssr_relu_bits<T>(u);
      else
        u = ssr_relu_bits<T>(u & 0xffffu) |
            (ssr_relu_bits<T>(u >> 16) << 16);
    }
    return w;
  } else {
    return static_cast<W>(ssr_relu_bits<T>(w));
  }
}

// Takes the next ticket of the counter at t: adds 1 and returns the value
// before, with acquire-release semantics at the GPU's scope, so this
// thread's earlier writes are visible to whoever takes a later ticket and
// the writes of those that took earlier ones are visible to this thread.
__device__ __forceinline__ unsigned ssr_take_ticket(unsigned* t) {
  unsigned old;
  asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], 1;\n"
               : "=r"(old)
               : "l"(t)
               : "memory");
  return old;
}

// The lanes of the one-CTA fold of a reduce's partials (ssr_rows.cuh's
// ssr_fold_partials, kFoldThreads there).
constexpr int kFoldLanes = 1024;

// The sum ssr_fold_partials gives over `n` partials -- kFoldLanes lanes
// strided over them, each summing its partials in order, then
// ssr_cta_sum<kFoldLanes> -- by a CTA of THREADS threads.  Thread t carries
// the lanes t, t + THREADS, ...: each lane keeps its position in its warp,
// so each of its warp's butterflies is replayed per carried lane, and
// warp 0 then sums the kFoldLanes / 32 warp sums by the same butterfly.
// The same bits as the second launch it replaces.  The partials were
// written by other CTAs of this launch: they are read from L2.  Every
// thread of the CTA calls it; the sum is valid in thread 0.
template <int THREADS>
__device__ __forceinline__ float ssr_fold_in_cta(const float* partials,
                                                 int64_t n) {
  static_assert(kFoldLanes % THREADS == 0 && THREADS % 32 == 0,
                "a thread carries whole lanes");
  __shared__ float warp_sums[kFoldLanes / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kFoldLanes / THREADS; ++k) {
    float acc = 0.f;
    for (int64_t i = threadIdx.x + k * THREADS; i < n; i += kFoldLanes)
      acc += __ldcg(partials + i);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) warp_sums[warp + k * (THREADS / 32)] = acc;
  }
  __syncthreads();
  float v = 0.f;
  if (warp == 0) {
    v = warp_sums[lane];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  }
  return v;
}
