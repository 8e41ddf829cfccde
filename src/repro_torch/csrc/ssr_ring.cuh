// The N-deep stage ring of the pipelined Hopper kernels (R1-R12).
//
// Replaces the rotation of repro/core/ssr.py:_pipelined_call, which a
// schedule with buffer_depth > 2 (or per-stream stream_depths) emits on the
// TPU: read stream i gets depth_i VMEM slots filled by async copies, and at
// grid step s the kernel starts the fetch of step s + depth_i - 1 into slot
// (s + depth_i - 1) % depth_i, waits on slot s % depth_i and hands the body
// that slot.  Step 0 primes min(depth_i - 1, steps) fetches; a stream whose
// block never moves (the repeat register) is fetched once into slot 0.
//
// On Hopper the single-core grid becomes each CTA's run of consecutive
// steps, and the slots live in dynamic shared memory, filled by cp.async.
// cp.async groups are per thread, so each stream is fetched by its own
// range of the CTA's threads: a thread's groups then hold its stream's
// fetches only.  The CTA first primes (virtual steps u = 1 - max_depth ..
// -1: stream i fetches its steps 0 .. depth_i - 2), then at each step s
// of its run every thread waits until its stream's fetch of step s has
// landed (cp.async.wait_group, depth_i - 2 newer groups left pending), the
// CTA meets at one __syncthreads() -- which shows every stream's slot of
// step s to all threads and tells them that step s - 1's slots are read --
// and only then does each stream start its fetch of step s + depth_i - 1,
// into slot (s + depth_i - 1) % depth_i: the slot step s - 1 held.  So one
// barrier a step both publishes and frees a slot, and depth_i - 1 fetches
// are in flight while step s computes; the fetches, steps and slots are
// the reference's, the start of step s's fetch falling after its wait
// instead of before it.  Every thread commits one group per virtual step,
// empty or not, which keeps each stream's pending count exact.
//
// wait_group takes an immediate, so the depth stays a runtime argument and
// ssr_ring_wait switches over the counts (depth <= 8).  A copy moves 16
// bytes where the wrapper found the layout aligned for it (a row's last
// pack partial where its width asks), else 4 bytes (f32, int32), else one
// 2-byte element through a load and st.shared: still issued depth - 1
// steps ahead, into the same slot.
#pragma once

#include "ssr_common.cuh"

// Depth of each read stream (2..8; one slot for a stream whose block never
// moves, where the kernel allocates one) and whether its block never moves.
// R10 and R11 use the first entry, R1-R4 and R12 the first two, R6 all
// three.
struct SsrRing {
  int64_t depth[3];
  int64_t invariant[3];
};

// cp.async of 16 or 4 bytes that zero-fills the destination when `in` is
// false (and then reads nothing: `gmem` need only be a valid address).
__device__ __forceinline__ void ssr_ring_cp16(void* smem, const void* gmem,
                                              bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void ssr_ring_cp4(void* smem, const void* gmem,
                                             bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(in ? 4 : 0)
               : "memory");
}

// cp.async of the first `bytes` (0..16) of a 16-byte pack; the rest of the
// destination pack is zero-filled and nothing past `bytes` is read.  Both
// addresses are 16-byte aligned.
__device__ __forceinline__ void ssr_ring_cp16_part(void* smem, const void* gmem,
                                                   int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes)
               : "memory");
}

// Wait until at most `pending` of this thread's cp.async groups are in
// flight (0 <= pending <= 7).
__device__ __forceinline__ void ssr_ring_wait(int pending) {
  switch (pending) {
    case 0: ssr_cp_async_wait<0>(); break;
    case 1: ssr_cp_async_wait<1>(); break;
    case 2: ssr_cp_async_wait<2>(); break;
    case 3: ssr_cp_async_wait<3>(); break;
    case 4: ssr_cp_async_wait<4>(); break;
    case 5: ssr_cp_async_wait<5>(); break;
    case 6: ssr_cp_async_wait<6>(); break;
    default: ssr_cp_async_wait<7>(); break;
  }
}

// Copy a rows x cols tile of T (row pitch `pitch` elements in device
// memory) to shared memory (row stride `ld` elements), by thread `lane` of
// the `nthreads` that fetch this stream.  `vec16`: every row start allows
// 16-byte copies (the wrapper checked), and `ld` is a multiple of 16
// bytes; a row whose width is no multiple of 16 bytes ends in a partial
// copy (the rest of its last pack zero-filled, nothing past the row read).
template <typename T>
__device__ __forceinline__ void ssr_ring_copy(T* dst, int ld, const T* src,
                                              int64_t pitch, int rows,
                                              int cols, bool vec16, int lane,
                                              int nthreads) {
  if (vec16) {
    constexpr int V = 16 / sizeof(T);
    for (SsrBlockWalk w(lane, nthreads, (cols + V - 1) / V); w.r < rows;
         w.next()) {
      const int left = cols - w.c * V;
      ssr_ring_cp16_part(dst + w.r * ld + w.c * V,
                         src + static_cast<int64_t>(w.r) * pitch + w.c * V,
                         static_cast<int>(sizeof(T)) * (left < V ? left : V));
    }
  } else {
    for (SsrBlockWalk w(lane, nthreads, cols); w.r < rows; w.next()) {
      T* d = dst + w.r * ld + w.c;
      const T* s = src + static_cast<int64_t>(w.r) * pitch + w.c;
      if constexpr (sizeof(T) == 4)
        ssr_ring_cp4(d, s, true);
      else
        *d = *s;
    }
  }
}

// Copy a run of `n` consecutive elements of T to shared memory, by thread
// `lane` of the `nthreads` that fetch it: as ssr_ring_copy's one row, but
// with no row walk to set up, whose divisions cost more than the one or
// two copies a thread makes of a short run (R10's item).
template <typename T>
__device__ __forceinline__ void ssr_ring_copy_run(T* dst, const T* src, int n,
                                                  bool vec16, int lane,
                                                  int nthreads) {
  if (!vec16) {
    ssr_ring_copy<T>(dst, n, src, 0, 1, n, false, lane, nthreads);
    return;
  }
  constexpr int V = 16 / sizeof(T);
  for (int p = lane; p * V < n; p += nthreads) {
    const int left = n - p * V;
    ssr_ring_cp16_part(dst + p * V, src + p * V,
                       static_cast<int>(sizeof(T)) * (left < V ? left : V));
  }
}

// One read stream's side of the ring in a CTA's run of `run` steps: its
// depth, whether it is invariant, the slot its next fetch fills and the
// slot the current step reads (counted with wraps, not divisions: the
// kernels' steps are short).  A thread holds the side of the stream it
// fetches, and one side per stream to read from; `Fetch` copies one step's
// tile into a slot.
struct SsrRingSide {
  int depth;
  bool invariant;
  int put = 0;  // slot of this thread's next fetch
  int get = 0;  // slot the current step reads

  // (selects, not r.depth[i]: a runtime index into a kernel parameter
  // would copy the struct to local memory)
  __device__ __forceinline__ SsrRingSide(const SsrRing& r, int i)
      : depth(static_cast<int>(i == 2 ? r.depth[2] : i ? r.depth[1] : r.depth[0])),
        invariant((i == 2 ? r.invariant[2] : i ? r.invariant[1] : r.invariant[0]) != 0) {}

  // At virtual step u: fetch run step u + depth - 1 if it lies in the run
  // (an invariant stream fetches step 0 once, at the first u), then commit
  // this thread's group for u.
  template <typename Fetch>
  __device__ __forceinline__ void issue(int64_t u, int64_t first_u,
                                        int64_t run, Fetch&& fetch) {
    if (invariant) {
      if (u == first_u) fetch(0);
    } else if (u + depth - 1 >= 0 && u + depth - 1 < run) {
      fetch(put);
      put = put + 1 == depth ? 0 : put + 1;
    }
    ssr_cp_async_commit();
  }

  // Wait until this thread's fetch of the current step has landed: before
  // the step's own fetch, depth - 2 newer groups may be pending.
  __device__ __forceinline__ void wait() const {
    ssr_ring_wait(invariant ? 0 : depth - 2);
  }

  // The slot the current step reads; step() moves to the next step's.
  __device__ __forceinline__ int slot() const { return get; }
  __device__ __forceinline__ void step() {
    if (!invariant) get = get + 1 == depth ? 0 : get + 1;
  }
};

// The fetching group of this thread when the CTA's warps are split among
// `streams` streams (1..3), whole warps each: group g holds warps
// [g * warps / streams, (g + 1) * warps / streams).  `stream` is the group,
// `lane` the thread's rank in it and `size` its threads.
struct SsrRingGroup {
  int stream, lane, size;

  __device__ __forceinline__ explicit SsrRingGroup(int streams) {
    const int warps = static_cast<int>(blockDim.x) / 32;
    const int warp = static_cast<int>(threadIdx.x) / 32;
    int g = 0;
    while (g + 1 < streams && (g + 1) * warps / streams <= warp) ++g;
    const int lo = g * warps / streams * 32;
    stream = g;
    lane = static_cast<int>(threadIdx.x) - lo;
    size = (g + 1) * warps / streams * 32 - lo;
  }
};

// Sum of `v` over a CTA of THREADS threads, in ssr_cta_sum's fixed order
// (the same bits), with its warp sums in the caller's shared memory (the
// ring's, once the run is done) instead of a static array.  Valid in
// thread 0.
template <int THREADS>
__device__ __forceinline__ float ssr_ring_cta_sum(float v, float* warp_sums) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < THREADS / 32 ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  }
  return v;
}

// Let a kernel use `bytes` of dynamic shared memory (above 48 KiB it must
// opt in).
template <typename K>
__host__ inline cudaError_t ssr_ring_smem(K kernel, int64_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}
