// R15 ring_stream_scan: K14's inclusive prefix sum of a padded vector, in
// f32, in one pass over x, its tiles delivered through an N-deep
// shared-memory ring.
//
// Replaces the TPU kernel repro/core/ssr.py:_pipelined_call (the N-deep
// rotation that ssr_pallas emits at buffer_depth > 2 on a grid of more than
// one step, repro/core/ssr.py:422-424) as built by
// repro/kernels/frontend.py:StreamKernel._build with the body
// repro/kernels/scan.py:_ssr_body: grid n/1024 over the (8, 128) blocks of
// the padded vector, the carry in a VMEM scratch register.
//
// Bound on H100: bytes -- x read once and y written once (8 bytes an
// element in f32) against one add an element.  R15 reads x once.
//
// Design.  K14's one pass (ssr_scan.cuh: the tile's sums, the look-back
// to the second pass's offsets, the staged store), its tiles
// delivered through a deeper ring than K14's two slots, so that more tiles
// are summed ahead of the one whose offset is awaited.
//
// A CTA is 8 computing warps (K14's 256 threads) and a filling warp.  The
// filling warp's lane 0 takes the next tile by a ticket from one counter
// (so tiles start in increasing order, and no tile ever waits on a tile
// whose CTA has not started) and bulk-copies it (cp.async.bulk, 16 or 8
// KiB, unpadded) into the next of `depth` ring slots, on a full and an
// empty mbarrier a slot (ssr_stage_ring.cuh); the tile's number rides in
// a word beside the slots, -1 once the tickets run out.  The computing
// warps, for each tile:
//
//   1. read the thread's 16 consecutive elements from the slot into
//      registers -- 16-byte loads in a rotated order, so that a quarter
//      warp's loads hit 32 distinct banks (the slot has no pads);
//   2. sum them and scan the thread sums, and publish the tile's total;
//   3. close a group or a chunk where the tile closes one (Words::close);
//   4. find the tile's offset (Words::offset, on a named barrier that the
//      filling warp does not join);
//   5. read the tile again and write its prefix sums from registers,
//      staged in the tile's slot and stored by bulk copies, up to n, then
//      free the slot.
//
// Steps 1-3 run on each tile as soon as it lands, up to depth - 2 tiles
// ahead of the oldest tile not yet written (one slot stays free for the
// filling warp), and steps 4-5 on the oldest, whose loads are issued
// before the summing: what step 4 reads was published while the CTA, and
// every CTA (tickets hand out the tiles in order), summed ahead, and no
// step waits on a step 4.

// Every sum runs in K14's order on K14's values, so every run gives K14's
// bits at every depth.
#include "ssr_scan.cuh"
#include "ssr_stage_ring.cuh"

namespace {

using scan::kItems;
using scan::kTile;
using mbar::Slots;

constexpr int kCompute = scan::kThreads;           // 256 computing threads
// The shared memory before the slots: the full and empty barriers (8
// slots, mbar::kBarrierBytes), each slot's tile number, a group's totals,
// the carry and the offset (and the carry a closing tile uses).
constexpr int kSlotTileAt = mbar::kBarrierBytes;
constexpr int kGroupAt = kSlotTileAt + 8 * 4;
constexpr int kCarryAt = kGroupAt + scan::kGroup * 4;
constexpr int kHeaderBytes = 512;
static_assert(kCarryAt + 16 <= kHeaderBytes, "R15's header");
// Then the slots.
constexpr int kStagedBytes = kHeaderBytes;

template <typename T>
__global__ void __launch_bounds__(stage::kThreads)
    ring_scan_tiles(const T* __restrict__ x, int64_t n, float* __restrict__ out,
                    uint64_t* __restrict__ words, int64_t tiles, int depth) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* const bars = reinterpret_cast<uint64_t*>(smem);
  int* const slot_tile = reinterpret_cast<int*>(smem + kSlotTileAt);
  float* const gv = reinterpret_cast<float*>(smem + kGroupAt);
  float* const sh = reinterpret_cast<float*>(smem + kCarryAt);
  T* const slots = reinterpret_cast<T*>(smem + kStagedBytes);
  const scan::Words w(words, tiles);
  unsigned long long* const counter = w.counter(tiles);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) stage::init_ring(bars, depth, 0, true);
  __syncthreads();

  if (warp == stage::kComputeWarps) {        // the filling warp
    if (lane != 0) return;
    Slots p(depth);
    for (int k = 0;; ++k) {
      if (k >= depth) mbar::bar_wait(bars + 16 + p.at, p.parity ^ 1u);
      uint64_t* const full = bars + p.at;
      const unsigned long long tile = atomicAdd(counter, 1ull);
      if (tile >= static_cast<unsigned long long>(tiles)) {
        slot_tile[p.at] = -1;
        mbar::bar_arrive(full);
        return;
      }
      slot_tile[p.at] = static_cast<int>(tile);
      const int64_t base = static_cast<int64_t>(tile) * kTile;
      const int64_t elems = n - base < kTile ? n - base : kTile;
      const unsigned bytes = static_cast<unsigned>(elems * sizeof(T));
      mbar::bar_arrive_expect(full, bytes);
      stage::bulk_copy(slots + p.at * kTile, x + base, bytes, full);
      p.next();
    }
  }

  // The computing warps take the tiles in ticket order and sum each as
  // soon as it lands (steps 2 and 3), up to `ahead_max` tiles beyond the
  // oldest unwritten one, which keeps one slot free for the filling warp;
  // then the oldest finds its offset (step 4, its loads issued before the
  // summing) and is written (step 5), read from its slot again and its
  // slot freed.  So a tile's total never waits on another tile's offset,
  // and the offsets lag the totals by up to `ahead_max` tiles a CTA.
  const int t = threadIdx.x;
  const int ahead_max = depth > 2 ? depth - 2 : 1;
  Slots ss(depth), sw(depth);      // the next slot to sum, to write
  int ahead = 0;                   // tiles summed, not written
  bool more = true;
  for (;;) {
    int oldest = -1;
    scan::Pending pend{};
    if (ahead > 0) {
      oldest = *reinterpret_cast<volatile int*>(slot_tile + sw.at);
      pend = w.issue(oldest);
    }
    while (more && ahead <= ahead_max) {
      mbar::bar_wait(bars + ss.at, ss.parity);
      const int tile = *reinterpret_cast<volatile int*>(slot_tile + ss.at);
      if (tile < 0) {
        more = false;
        break;
      }
      float v[kItems], total;
      scan::load_items(slots + ss.at * kTile, t, v);
      scan::scan_tile(v, tile, n, &total);
      if (t == 0) scan::publish(w.tile + tile, total);
      w.close(tile, total, gv, sh);
      ss.next();
      ++ahead;
    }
    if (ahead == 0) break;
    if (oldest < 0) {
      oldest = *reinterpret_cast<volatile int*>(slot_tile + sw.at);
      pend = w.issue(oldest);
    }
    const float off = w.offset(pend, oldest, gv, sh);
    float v[kItems], total;
    scan::load_items(slots + sw.at * kTile, t, v);
    const float run = scan::scan_tile(v, oldest, n, &total);
    scan::write_tile(v, run, off, oldest, n, slots + sw.at * kTile, out);
    if (lane == 0) mbar::bar_arrive(bars + 16 + sw.at);   // free the slot
    sw.next();
    --ahead;
  }
  if (lane == 0) scan::stores_done();
}

template <typename T>
int64_t ring_bytes(int depth) {
  return kStagedBytes + int64_t{depth} * kTile * static_cast<int64_t>(sizeof(T));
}

template <typename T>
int launch(const void* x, float* out, void* words, int64_t n, int64_t tiles,
           int64_t nwords, int depth, int64_t smem, cudaStream_t st) {
  if (!scan::fits<T>(n, tiles) || depth < 2 || depth > 8 ||
      smem != ring_bytes<T>(depth) || nwords != scan::state_words(tiles))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = ssr_ring_smem(ring_scan_tiles<T>, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ring_scan_tiles<T>, stage::kThreads, smem);
  if (err == cudaSuccess && per_sm < 1) err = cudaErrorInvalidConfiguration;
  if (err == cudaSuccess)
    err = cudaMemsetAsync(words, 0, nwords * sizeof(uint64_t), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  // as many CTAs as fit the card at once (tickets hand out the tiles)
  const int64_t fit = int64_t{per_sm} * sms;
  const unsigned grid = static_cast<unsigned>(tiles < fit ? tiles : fit);
  ring_scan_tiles<T><<<grid, stage::kThreads, smem, st>>>(
      static_cast<const T*>(x), n, out, static_cast<uint64_t*>(words), tiles,
      depth);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x holds n elements (the padded (rows, 128) layout), 16-byte aligned; out
// the n f32 prefix sums; `words` the call's state, `nwords` 64-bit words
// (ssr_ring_stream_scan_state_words), zeroed here.  The ring:
// `ring->depth[0]` slots, each one unpadded tile of x, and `smem_bytes`,
// the shared memory as the wrapper counted it (512 bytes of barriers,
// slot numbers and sums, then the slots), checked here.  One memset and
// one launch.
extern "C" int ssr_ring_stream_scan(const void* x, int dtype, void* out,
                                    void* words, int64_t n, int64_t tiles,
                                    int64_t nwords, const SsrRing* ring,
                                    int64_t smem_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  const int depth = static_cast<int>(ring->depth[0]);
  if (dtype == SSR_F32)
    return launch<float>(x, o, words, n, tiles, nwords, depth, smem_bytes, st);
  if (dtype == SSR_BF16)
    return launch<__nv_bfloat16>(x, o, words, n, tiles, nwords, depth,
                                 smem_bytes, st);
  if (dtype == SSR_I32)
    return launch<int32_t>(x, o, words, n, tiles, nwords, depth, smem_bytes,
                           st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int64_t ssr_ring_stream_scan_smem_bytes() { return 0; }

extern "C" int64_t ssr_ring_stream_scan_state_words(int64_t tiles) {
  return scan::state_words(tiles);
}

// Registers a thread and local bytes (the most over the three dtypes'
// instantiations) and the f32 kernel's CTAs an SM at `smem` bytes:
// out[0], out[1], out[2].
extern "C" int ssr_ring_stream_scan_attributes(int64_t* out, int64_t smem) {
  const void* const kernels[] = {
      reinterpret_cast<const void*>(ring_scan_tiles<float>),
      reinterpret_cast<const void*>(ring_scan_tiles<__nv_bfloat16>),
      reinterpret_cast<const void*>(ring_scan_tiles<int32_t>)};
  return stage::attributes(kernels,
                           reinterpret_cast<const void*>(ring_scan_tiles<float>),
                           smem, out);
}
