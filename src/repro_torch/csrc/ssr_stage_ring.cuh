// The stage rings of R1 ring_reduce_mul, R2 ring_map_relu and R4
// ring_contract_gemv: a filling warp on mbarriers, and computing warps
// that meet no CTA barrier in the step loop.
//
// Replaces, for the main path's dot and relu, the CTA-wide rotation of
// ssr_ring.cuh, where every thread copies its share of each block with
// cp.async, waits on its own copies and meets one __syncthreads() a step.
// Measured on an H100 (tools/stage_ring_ablation.py, PERF.md), that
// delivery alone took 0.90-0.97 of R1's and R2's time, which trailed K1
// and K2 1.3x in f32 and 1.7x in bf16 whatever the CTA split, and taking
// the barrier out gained at most 2 %.
//
// A CTA is 8 computing warps -- K1's and K2's 256 threads, each taking the
// same packs of a block as there -- and one filling warp.  The filling
// warp walks the CTA's consecutive steps and fills each stream's slots as
// far ahead as the depths let it (fill_ring), on one of two routes:
//
// * bulk (16-byte packs: every row start on 16 bytes and whole 16-byte
//   rows): lane 0 arms the slot's `full` mbarrier with the block's bytes
//   (arrive.expect_tx) and copies the block with one cp.async.bulk where
//   its rows are one contiguous run (pitch == width, as on R1's and R2's
//   cells), else one a row -- all by lane 0 (R1, R2) or lane r copying
//   row r (R4's rows of A, fill_ring's kLaneRows) -- all completing on
//   `full` (mbarrier::complete_tx::bytes);
// * elements (any other layout): the 32 lanes copy the block element by
//   element -- cp.async of 4 bytes (f32, int32), each lane's copies then
//   completing on `full` (cp.async.mbarrier.arrive.noinc), or loads and
//   stores of 2 bytes (bf16), four in flight a lane, then an arrive.
//
// The computing warps wait on a slot's `full` barrier and read it; once a
// warp is past the step, its lanes fence their reads against the bulk
// copies' proxy and its lane 0 arrives on the slot's `empty` barrier; the
// filling warp waits on `empty` before it refills the slot.  A slot is
// one lowered block of its stream, so the slots, steps and fetch order are
// the reference's rotation (repro/core/ssr.py:_pipelined_call): stream i
// fetches step q into slot q % depth_i once step q - depth_i is read, the
// barriers of a slot completing one phase a fill.  A stream whose block
// never moves is fetched once, into slot 0.
//
// Shared memory: the barriers (full and empty for 8 slots of each of two
// streams, mbar::kBarrierBytes), R1's warp sums (kSumBytes), then the
// slots of stream 0 and of stream 1; the wrappers count it all.
#pragma once

#include "ssr_gather_ring.cuh"
#include "ssr_mbarrier.cuh"
#include "ssr_ring.cuh"

namespace stage {

using mbar::bar_arrive;
using mbar::bar_arrive_expect;
using mbar::bar_arrive_on_copies;
using mbar::bar_init;
using mbar::bar_wait;
using mbar::bulk_copy;
using mbar::kBarrierBytes;
using mbar::Slots;
using mbar::smem_u32;

constexpr int kComputeWarps = 8;
constexpr int kComputeThreads = 32 * kComputeWarps;
constexpr int kThreads = kComputeThreads + 32;   // and the filling warp
// R1's warp sums: two sets of eight, a run's and the next one's
constexpr int kSumBytes = 2 * kComputeWarps * 4;

// Set the barriers of streams of depths `da` and `db` (0: no second
// stream), one thread: `full` completes on the fill (lane 0's arrival and
// the bulk bytes, or the 32 lanes' arrivals), `empty` on one arrival of
// each computing warp.
__device__ __forceinline__ void init_ring(uint64_t* bars, int da, int db,
                                          bool bulk) {
  const unsigned fills = bulk ? 1 : 32;
  for (int i = 0; i < da; ++i) {
    bar_init(bars + i, fills);
    bar_init(bars + 16 + i, kComputeWarps);
  }
  for (int i = 0; i < db; ++i) {
    bar_init(bars + 8 + i, fills);
    bar_init(bars + 24 + i, kComputeWarps);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One block (rows x cols of T, row pitch `pitch` in device memory) into
// the slot `dst` (row stride cols), completing on `full`.  On the bulk
// route, lane 0 alone arms the barrier and copies the block (one copy, or
// one a row); with kLaneRows every lane calls it, lane 0 arms and copies
// a block that is one run, and otherwise lane r copies rows r, r + 32, ...
// (a row may land before lane 0 arms: the phase waits for lane 0's
// arrival, and the transaction count may run below zero meanwhile).  On
// the elements route every lane copies its share.
template <typename T, bool kBulk, bool kLaneRows>
__device__ __forceinline__ void fill_block(T* dst, const T* src,
                                           int64_t pitch, int rows, int cols,
                                           uint64_t* full, int lane) {
  if constexpr (kBulk && !kLaneRows) {
    const unsigned row = static_cast<unsigned>(cols * sizeof(T));
    bar_arrive_expect(full, rows * row);
    if (pitch == cols) {
      bulk_copy(dst, src, rows * row, full);
    } else {
      for (int r = 0; r < rows; ++r)
        bulk_copy(dst + r * cols, src + r * pitch, row, full);
    }
  } else if constexpr (kBulk) {
    const unsigned row = static_cast<unsigned>(cols * sizeof(T));
    if (lane == 0) bar_arrive_expect(full, rows * row);
    if (pitch == cols) {
      if (lane == 0) bulk_copy(dst, src, rows * row, full);
    } else {
#pragma unroll 1
      for (int r = lane; r < rows; r += 32)
        bulk_copy(dst + r * cols, src + r * pitch, row, full);
    }
  } else if constexpr (sizeof(T) == 4) {
    for (int r = 0; r < rows; ++r, dst += cols, src += pitch)
      for (int c = lane; c < cols; c += 32) ssr_ring_cp4(dst + c, src + c, true);
    bar_arrive_on_copies(full);
  } else {
    // no 2-byte cp.async: a row's loads in flight, four a lane, then
    // their stores
    constexpr int kBatch = 4;
    for (int r = 0; r < rows; ++r, dst += cols, src += pitch) {
      for (int c0 = lane; c0 < cols; c0 += 32 * kBatch) {
        T v[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j)
          if (c0 + 32 * j < cols) v[j] = src[c0 + 32 * j];
#pragma unroll
        for (int j = 0; j < kBatch; ++j)
          if (c0 + 32 * j < cols) dst[c0 + 32 * j] = v[j];
      }
    }
    bar_arrive(full);
  }
}

// Where the filling warp puts one read stream: the first `rows` rows of
// each of the stream's blocks, from `src` (the walk's origins added to
// it), into slots `tile` elements apart.
template <typename T>
struct Fill {
  const T* src;
  T* slots;
  int tile;
  int rows;
};

// One stream's step q of fill_ring: wait until its readers released the
// slot (from the stream's second round of slots on), fill it and move on
// (an invariant stream fills step 0 into slot 0, once).
template <typename T, bool kBulk, bool kLaneRows>
__device__ __forceinline__ void fill_step(Fill<T> f, int cols,
                                          const SsrStream& s,
                                          const SsrGrid& g, gring::Walk& w,
                                          Slots& p, bool invariant, int q,
                                          uint64_t* full, uint64_t* empty,
                                          int lane) {
  if (invariant) {
    if (q == 0)
      fill_block<T, kBulk, kLaneRows>(f.slots, f.src + w.origin(s), s.pitch, f.rows,
                           cols, full, lane);
    return;
  }
  if (q >= p.depth) bar_wait(empty + p.at, p.parity ^ 1u);
  fill_block<T, kBulk, kLaneRows>(f.slots + p.at * f.tile, f.src + w.origin(s),
                       s.pitch, f.rows, cols, full + p.at, lane);
  p.next();
  w.advance(g);
}

// Whether lane `lane` of the filling warp copies any of a stream's blocks
// (`rows` rows each): every lane on the elements route; on the bulk route
// lane 0 and, with kLaneRows where the rows are not one run, a lane a row.
template <bool kBulk, bool kLaneRows>
__device__ __forceinline__ bool fills(const SsrStream& s, int rows,
                                      int lane) {
  return !kBulk || lane == 0 ||
         (kLaneRows && s.pitch != s.block[1] && lane < rows);
}

// The filling warp's loop over a CTA's `run` consecutive steps from step
// s0, for kStreams (1 or 2) read streams a and b walked by sa and sb: at
// virtual step u stream i fills its step u + depth_i - 1 into the slot its
// readers released at step u - 1 (an invariant stream its first step,
// once, into slot 0).  All 32 lanes call it; a lane with nothing to copy
// leaves at once.  kLaneRows (R4's 8 rows of A a step, each its own copy)
// spreads a block's row copies over the lanes: one lane issuing them all
// made R4 11 % slower at depth 8.  R1 and R2 (a block one copy) keep lane
// 0 alone: their short steps ran 6-9 % slower on the lanes' code path.
template <typename T, bool kBulk, int kStreams, bool kLaneRows = false>
__device__ __forceinline__ void fill_ring(
    Fill<T> fa, Fill<T> fb, const SsrGrid& g, const SsrStream& sa,
    const SsrStream& sb, int64_t s0, int run, const SsrRing& ring,
    uint64_t* bars, int lane) {
  if (!fills<kBulk, kLaneRows>(sa, fa.rows, lane) &&
      (kStreams < 2 || !fills<kBulk, kLaneRows>(sb, fb.rows, lane)))
    return;
  const int da = static_cast<int>(ring.depth[0]);
  const int db = kStreams > 1 ? static_cast<int>(ring.depth[1]) : 0;
  gring::Walk wa(g, s0), wb(g, s0);
  Slots pa(da), pb(db > 0 ? db : 1);
  const bool ia = ring.invariant[0] != 0;
  const bool ib = kStreams > 1 && ring.invariant[1] != 0;
  const int dmax = da > db ? da : db;
  const int ca = static_cast<int>(sa.block[1]);
  const int cb = static_cast<int>(sb.block[1]);
  for (int u = 1 - dmax; u < run; ++u) {
    const int qa = u + da - 1, qb = u + db - 1;
    if (qa >= 0 && qa < run)
      fill_step<T, kBulk, kLaneRows>(fa, ca, sa, g, wa, pa, ia, qa, bars, bars + 16,
                          lane);
    if constexpr (kStreams > 1)
      if (qb >= 0 && qb < run)
        fill_step<T, kBulk, kLaneRows>(fb, cb, sb, g, wb, pb, ib, qb, bars + 8,
                            bars + 24, lane);
  }
  if constexpr (!kBulk) asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A computing warp's side of read stream i: the slot of the current step
// and its parity (slot 0 for good where the stream is invariant).
struct Reader {
  uint64_t* full;
  uint64_t* empty;
  Slots s;
  bool invariant;

  __device__ __forceinline__ Reader(uint64_t* bars, const SsrRing& r, int i)
      : full(bars + 8 * i), empty(bars + 16 + 8 * i),
        s(i ? r.depth[1] : r.depth[0]),
        invariant((i ? r.invariant[1] : r.invariant[0]) != 0) {}

  // Wait until the current step's block has landed in its slot.
  __device__ __forceinline__ void wait() const {
    bar_wait(full + s.at, s.parity);
  }
  __device__ __forceinline__ int slot() const { return s.at; }
  // Lane 0, once its warp is past the step: free the slot.
  __device__ __forceinline__ void release() const {
    if (!invariant) bar_arrive(empty + s.at);
  }
  __device__ __forceinline__ void next() {
    if (!invariant) s.next();
  }
};

// A computing warp is past a step: each lane's reads of the step's slots
// are ordered before the bulk copies that refill them (another proxy's
// writes), and the warp's lanes before lane 0's release of the slots.
__device__ __forceinline__ void done_reading() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncwarp();
}

// Sum of `v` over the computing threads, in ssr_cta_sum<256>'s order (the
// same bits), its warp sums in `sums` (8 floats) and a named barrier that
// the filling warp does not join.  Valid in thread 0.
__device__ __forceinline__ float compute_sum(float v, float* sums) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) sums[warp] = v;
  asm volatile("bar.sync 1, %0;\n" ::"n"(kComputeThreads) : "memory");
  if (warp == 0) {
    v = lane < kComputeWarps ? sums[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  }
  return v;
}

// Registers a thread and local bytes (the most over `kernels`) and the
// CTAs an SM of `main` at `smem` bytes of dynamic shared memory: out[0],
// out[1], out[2].
template <int N>
__host__ inline int attributes(const void* const (&kernels)[N],
                               const void* main, int64_t smem, int64_t* out) {
  out[0] = out[1] = out[2] = 0;
  for (const void* k : kernels) {
    cudaFuncAttributes fa;
    cudaError_t err = cudaFuncGetAttributes(&fa, k);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (fa.numRegs > out[0]) out[0] = fa.numRegs;
    if (static_cast<int64_t>(fa.localSizeBytes) > out[1])
      out[1] = static_cast<int64_t>(fa.localSizeBytes);
  }
  cudaError_t err = cudaFuncSetAttribute(
      main, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  int ctas = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, main, kThreads,
                                                        smem);
  out[2] = ctas;
  return static_cast<int>(err);
}

}  // namespace stage
