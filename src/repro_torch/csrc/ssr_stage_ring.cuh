// The stage rings of R1 ring_reduce_mul and R2 ring_map_relu: a filling
// warp on mbarriers, and computing warps that meet no CTA barrier in the
// step loop.
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
//   rows): lane 0 copies a block with one cp.async.bulk where its rows are
//   one contiguous run (pitch == width, as on the main path's cells), else
//   one a row, all completing on the slot's `full` mbarrier
//   (mbarrier::complete_tx::bytes after arrive.expect_tx);
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
using mbar::kBarrierBytes;
using mbar::Slots;
using mbar::smem_u32;

constexpr int kComputeWarps = 8;
constexpr int kComputeThreads = 32 * kComputeWarps;
constexpr int kThreads = kComputeThreads + 32;   // and the filling warp
// R1's warp sums: two sets of eight, a run's and the next one's
constexpr int kSumBytes = 2 * kComputeWarps * 4;

// Copy `bytes` (a multiple of 16; both addresses 16-byte aligned) from
// device memory to shared memory as one bulk copy that completes on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

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
// the slot `dst` (row stride cols), completing on `full`: by lane 0 on the
// bulk route, by every lane of the filling warp on the elements route.
template <typename T, bool kBulk>
__device__ __forceinline__ void fill_block(T* dst, const T* src,
                                           int64_t pitch, int rows, int cols,
                                           uint64_t* full, int lane) {
  if constexpr (kBulk) {
    const unsigned row = static_cast<unsigned>(cols * sizeof(T));
    bar_arrive_expect(full, rows * row);
    if (pitch == cols) {
      bulk_copy(dst, src, rows * row, full);
    } else {
      for (int r = 0; r < rows; ++r)
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

// The filling warp's loop over a CTA's `run` consecutive steps from step
// s0, for kStreams (1 or 2) read streams a and b: at virtual step u
// stream i fills its step u + depth_i - 1 into the slot its readers
// released at step u - 1 (an invariant stream its first step, once, into
// slot 0).  On the bulk route only lane 0 calls it.
template <typename T, bool kBulk, int kStreams>
__device__ __forceinline__ void fill_ring(
    const T* __restrict__ a, const T* __restrict__ b, T* a_slots, T* b_slots,
    int tile, const SsrGrid& g, const SsrStream& sa, const SsrStream& sb,
    int64_t s0, int run, const SsrRing& ring, uint64_t* bars, int lane) {
  const int rows = static_cast<int>(sa.block[0]);
  const int cols = static_cast<int>(sa.block[1]);
  const int da = static_cast<int>(ring.depth[0]);
  const int db = kStreams > 1 ? static_cast<int>(ring.depth[1]) : 0;
  auto fill = [&](const T* src, const SsrStream& s, T* slots,
                  gring::Walk& w, Slots& p, bool invariant, int q,
                  uint64_t* full, uint64_t* empty) {
    if (invariant) {
      if (q == 0)
        fill_block<T, kBulk>(slots, src + w.origin(s), s.pitch, rows, cols,
                             full, lane);
      return;
    }
    if (q >= p.depth) bar_wait(empty + p.at, p.parity ^ 1u);
    fill_block<T, kBulk>(slots + p.at * tile, src + w.origin(s), s.pitch,
                         rows, cols, full + p.at, lane);
    p.next();
    w.advance(g);
  };
  gring::Walk wa(g, s0), wb(g, s0);
  Slots pa(da), pb(db > 0 ? db : 1);
  const bool ia = ring.invariant[0] != 0;
  const bool ib = kStreams > 1 && ring.invariant[1] != 0;
  const int dmax = da > db ? da : db;
  for (int u = 1 - dmax; u < run; ++u) {
    const int qa = u + da - 1, qb = u + db - 1;
    if (qa >= 0 && qa < run)
      fill(a, sa, a_slots, wa, pa, ia, qa, bars, bars + 16);
    if constexpr (kStreams > 1)
      if (qb >= 0 && qb < run)
        fill(b, sb, b_slots, wb, pb, ib, qb, bars + 8, bars + 24);
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
