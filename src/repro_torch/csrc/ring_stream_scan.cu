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
// Design.  K14 fixes its tiles' offsets by ssr_exclusive_offsets
// (ssr_common.cuh): chunks of 4096 totals in order with a running carry;
// in a chunk, thread t sums its 16 totals (a group) in order from 0.f, a
// fixed CTA scan of the 256 group sums, and each offset is carry + the
// group's exclusive sum + its earlier totals in order.  Tile i's offset
// there depends only on the totals of the tiles before i, so one pass can
// give K14's bits: each tile computes its own offset, operation for
// operation, from its predecessors' published values -- a decoupled
// look-back, which adds whichever predecessors are ready, could not.
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
//   2. sum them and scan the thread sums (ssr_scan.cuh's order: K14's),
//      and publish the tile's total;
//   3. if the tile closes a group of 16, wait for its group mates'
//      totals and publish the group's sum (in order from 0.f); if it
//      closes a chunk of 4096, wait for the chunk's group sums and carry,
//      scan them as ssr_exclusive_offsets does and publish the next
//      carry -- steps 2 and 3 wait on earlier tiles' steps 2 and 3 alone;
//   4. read the tile's earlier group mates' totals, the chunk's earlier
//      group sums and its carry, scan the sums as ssr_exclusive_offsets
//      does (the same ssr_cta_exclusive_scan, on a named barrier that the
//      filling warp does not join) and add the carry and the mates;
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

// A value and its ready flag share one 64-bit word (the float's bits, 1
// above them), so a reader never sees a value before it is whole; the
// words and the ticket counter are zeroed for every call by the entry
// (one memset before the launch).  Nothing is atomic but the ticket, and
// every sum runs in K14's order on K14's values, so every run gives K14's
// bits whatever order the tiles finish in: at every depth, -0 and NaN and
// int32's rounding (__int2float_rn) as there.
#include "ssr_scan.cuh"
#include "ssr_stage_ring.cuh"

namespace {

using scan::kItems;
using scan::kTile;
using mbar::Slots;

constexpr int kCompute = scan::kThreads;           // 256 computing threads
constexpr int kGroup = 16;                         // totals a group
constexpr int kChunk = kCompute * kGroup;          // 4096 totals a chunk
constexpr int kBar = 1;                            // the computing warps' barrier
// The shared memory before the slots: the full and empty barriers (8
// slots, mbar::kBarrierBytes), each slot's tile number, a group's totals,
// the carry and the offset (and the carry a closing tile uses).
constexpr int kSlotTileAt = mbar::kBarrierBytes;
constexpr int kGroupAt = kSlotTileAt + 8 * 4;
constexpr int kCarryAt = kGroupAt + kGroup * 4;
constexpr int kHeaderBytes = 512;
static_assert(kCarryAt + 16 <= kHeaderBytes, "R15's header");
// Then the slots.
constexpr int kWarpOut = 32 * kItems;           // a warp's elements of a tile
constexpr int kStagedBytes = kHeaderBytes;

__device__ __forceinline__ void sync_compute() { ssr_bar<kBar, kCompute>(); }

// A value with its ready flag, as one 64-bit word.
__device__ __forceinline__ void publish(uint64_t* w, float v) {
  const unsigned long long word = (1ull << 32) | __float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(w), "l"(word)
               : "memory");
}

__device__ __forceinline__ uint4 pick(bool on, uint4 a, uint4 b) {
  return make_uint4(on ? a.x : b.x, on ? a.y : b.y, on ? a.z : b.z,
                    on ? a.w : b.w);
}

__device__ __forceinline__ void widen(float* v, uint4 u, float) {
  v[0] = __uint_as_float(u.x);
  v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z);
  v[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void widen(float* v, uint4 u, int32_t) {
  v[0] = __int2float_rn(static_cast<int>(u.x));
  v[1] = __int2float_rn(static_cast<int>(u.y));
  v[2] = __int2float_rn(static_cast<int>(u.z));
  v[3] = __int2float_rn(static_cast<int>(u.w));
}
__device__ __forceinline__ void widen2(float* v, unsigned w) {
  v[0] = __uint_as_float(w << 16);            // element 2i in the low half
  v[1] = __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ void widen(float* v, uint4 u, __nv_bfloat16) {
  widen2(v, u.x);
  widen2(v + 2, u.y);
  widen2(v + 4, u.z);
  widen2(v + 6, u.w);
}

// u[c] = u[c - B] (indices mod kVec) where `on`: one bit B of a rotation
// (B negative: u[c] = u[c + |B|]).
template <int kVec, int B>
__device__ __forceinline__ void rotate_bit(uint4 (&u)[kVec], bool on) {
  const uint4 w0 = u[0], w1 = u[1 % kVec], w2 = u[2 % kVec], w3 = u[3 % kVec];
  const uint4 w[4] = {w0, w1, w2, w3};
#pragma unroll
  for (int c = 0; c < kVec; ++c)
    u[c] = pick(on, w[(c - B + 2 * kVec) % kVec], w[c]);
}

// Thread t's 16 consecutive elements of the slot as floats, as K14 stages
// them.  The thread's kVec 16-byte words are read starting at word r =
// (t / (8 / kVec)) % kVec, so that the 8 threads of a quarter warp read 8
// distinct 16-byte bank groups; selects on r's bits put them back in order.
template <typename T>
__device__ __forceinline__ void load_items(const T* slot, int t,
                                           float (&v)[kItems]) {
  constexpr int kVec = kItems * static_cast<int>(sizeof(T)) / 16;   // 4 or 2
  static_assert(kVec == 2 || kVec == 4, "16 elements of 2 or 4 bytes");
  const uint4* src = reinterpret_cast<const uint4*>(slot) + kVec * t;
  const int r = (t / (8 / kVec)) % kVec;
  uint4 u[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) u[k] = src[(k + r) & (kVec - 1)];
  // u[k] holds word (k + r) % kVec: rotate it back by r
  rotate_bit<kVec, 1>(u, (r & 1) != 0);
  if constexpr (kVec == 4) rotate_bit<kVec, 2>(u, (r & 2) != 0);
  constexpr int kPer = kItems / kVec;
#pragma unroll
  for (int c = 0; c < kVec; ++c) widen(v + kPer * c, u[c], T());
}

// The words a tile's offset reads, loaded as soon as the tile is taken
// (the loads in flight while the next tile is summed): thread t < j the
// total of group mate t, t < q the chunk's group sum t, the last thread
// the chunk's carry.  A word not yet published is read again when needed.
struct Pending {
  unsigned long long mate, group, carry;
};

__device__ __forceinline__ unsigned long long load_word(const uint64_t* w) {
  unsigned long long word;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n"
               : "=l"(word)
               : "l"(w)
               : "memory");
  return word;
}

// The value of a word loaded earlier, once it is published (polled
// without a pause: a 20 ns __nanosleep between polls measured 2 % slower).
__device__ __forceinline__ float ready(unsigned long long word,
                                       const uint64_t* w) {
  while (!(word >> 32)) word = load_word(w);
  return __uint_as_float(static_cast<unsigned>(word));
}

struct Words {
  uint64_t* tile;      // each tile's total
  uint64_t* group;     // each group's sum
  uint64_t* carry;     // each chunk's carry (index c: chunk c's)

  __device__ __forceinline__ Pending issue(int tile) const {
    const int t = threadIdx.x;
    const int c = tile / kChunk, pos = tile % kChunk;
    const int q = pos / kGroup, j = pos % kGroup;
    Pending p{1ull << 32, 1ull << 32, 1ull << 32};
    if (t < j) p.mate = load_word(this->tile + tile - j + t);
    if (t < q) p.group = load_word(group + int64_t{c} * kCompute + t);
    if (t == kCompute - 1 && c > 0) p.carry = load_word(carry + c);
    return p;
  }

  // Tile `tile`'s exclusive offset, ssr_exclusive_offsets' value for it,
  // from its predecessors' totals, group sums and carry (step 4), all
  // published in their tiles' sum steps.  Every computing thread calls it;
  // the offset in all of them.
  __device__ __forceinline__ float offset(Pending p, int tile, float* gv,
                                          float* sh) const {
    const int t = threadIdx.x;
    const int c = tile / kChunk, pos = tile % kChunk;
    const int q = pos / kGroup, j = pos % kGroup;
    if (t < j) gv[t] = ready(p.mate, this->tile + tile - j + t);
    float g = 0.f;
    if (t < q) g = ready(p.group, group + int64_t{c} * kCompute + t);
    if (t == kCompute - 1 && c > 0) sh[0] = ready(p.carry, carry + c);
    float chunk;      // the scan's barriers order gv and sh[0] too
    const float excl = ssr_cta_exclusive_scan<kCompute, kBar>(g, &chunk);
    if (t == q) {
      const float cy = c > 0 ? sh[0] : 0.f;
      float run = excl;
#pragma unroll 1
      for (int k = 0; k < j; ++k) run += gv[k];
      sh[1] = cy + run;
    }
    sync_compute();
    return sh[1];
  }

  // Step 3, where tile `tile` closes its group: wait for its group mates'
  // totals and publish the group's sum, in order from 0.f as
  // ssr_exclusive_offsets sums a thread's 16 totals; where it closes its
  // chunk too, wait for the chunk's group sums and carry and publish the
  // next carry (the CTA scan's total over the 256 group sums, added).  It
  // waits on sum steps of earlier tiles alone.
  __device__ __forceinline__ void close(int tile, float total, float* gv,
                                        float* sh) const {
    const int t = threadIdx.x;
    const int c = tile / kChunk, pos = tile % kChunk;
    if (pos % kGroup != kGroup - 1) return;   // the same in every thread
    if (t < kGroup - 1)
      gv[t] = ready(load_word(this->tile + tile - (kGroup - 1) + t),
                    this->tile + tile - (kGroup - 1) + t);
    sync_compute();
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kGroup - 1; ++k) s += gv[k];
    s += total;
    if (t == 0) publish(group + tile / kGroup, s);
    if (pos == kChunk - 1) {
      const uint64_t* const gw = group + int64_t{c} * kCompute + t;
      const float g = t < kCompute - 1 ? ready(load_word(gw), gw) : s;
      if (t == 0 && c > 0) sh[2] = ready(load_word(carry + c), carry + c);
      float chunk;
      ssr_cta_exclusive_scan<kCompute, kBar>(g, &chunk);
      if (t == 0) publish(carry + c + 1, (c > 0 ? sh[2] : 0.f) + chunk);
    }
    sync_compute();   // gv read by all before the offset step writes it
  }
};

// A tile in registers: 0 past n, the thread's sum of its 16 elements in
// order, the CTA scan (ssr_scan.cuh's order: K14's); the tile's total in
// `total`, the thread's exclusive value in the tile returned.
__device__ __forceinline__ float scan_tile(float (&v)[kItems], int tile,
                                           int64_t n, float* total) {
  const int64_t base = static_cast<int64_t>(tile) * kTile;
  if (base + kTile > n) {                    // the last tile: 0 past n
    const int64_t e0 = base + kItems * threadIdx.x;
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      if (e0 + k >= n) v[k] = 0.f;
  }
  float sum = v[0];
#pragma unroll
  for (int k = 1; k < kItems; ++k) sum += v[k];
  return ssr_cta_exclusive_scan<kCompute, kBar>(sum, total);
}

// Step 5: the tile's prefix sums, each thread's 16 from its exclusive
// value in the tile plus the tile's offset, up to n, staged in the warp's
// own part of the tile's slot (its elements already in registers) and
// stored by bulk copies: whole lines leave the SM, where a thread's own
// 16-byte stores 64 bytes apart would not.  The sums are f32: in f32 and
// int32 the warp's 512 of them fill its part in one round; in bf16 its
// part holds 256, so half the lanes' sums go in each of two rounds.
// Sums are stored in 16-byte words in the rotated order of load_items (a
// quarter warp hits distinct banks).  Once the warp's copies have read
// its part, lane 0 frees the slot for the warp.
template <typename T>
__device__ __forceinline__ void write_tile(const float (&v)[kItems], float run,
                                           float off, int tile, int64_t n,
                                           T* slot, uint64_t* empty,
                                           float* __restrict__ out) {
  constexpr int kRounds = static_cast<int>(sizeof(float) / sizeof(T));
  constexpr int kLanes = 32 / kRounds;          // lanes whose sums fit a round
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint4 o[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float4 f;
    run += v[4 * k];
    f.x = off + run;
    run += v[4 * k + 1];
    f.y = off + run;
    run += v[4 * k + 2];
    f.z = off + run;
    run += v[4 * k + 3];
    f.w = off + run;
    o[k] = make_uint4(__float_as_uint(f.x), __float_as_uint(f.y),
                      __float_as_uint(f.z), __float_as_uint(f.w));
  }
  // o[k] goes to word (k + r) & 3: rotate the words by -r
  const int r = (lane >> 1) & 3;
  rotate_bit<4, -1>(o, (r & 1) != 0);
  rotate_bit<4, -2>(o, (r & 2) != 0);
  float* const part = reinterpret_cast<float*>(slot + kWarpOut * warp);
  uint4* const dst = reinterpret_cast<uint4*>(part) + 4 * (lane % kLanes);
  const int64_t first = static_cast<int64_t>(tile) * kTile + kWarpOut * warp;
  __syncwarp();                           // every lane has read its elements
#pragma unroll
  for (int round = 0; round < kRounds; ++round) {
    if (round > 0) {                      // the last round's copy read it
      if (lane == 0)
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      __syncwarp();
    }
    if (lane / kLanes == round) {
#pragma unroll
      for (int k = 0; k < 4; ++k) dst[(k + r) & 3] = o[k];
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    const int64_t at = first + round * kLanes * kItems;
    if (lane == 0 && at < n) {
      const int64_t left = n - at;
      const unsigned bytes = static_cast<unsigned>(
          4 * (left < kLanes * kItems ? left : kLanes * kItems));
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
          "cp.async.bulk.commit_group;\n" ::"l"(out + at),
          "r"(mbar::smem_u32(part)), "r"(bytes)
          : "memory");
    }
  }
  if (lane == 0) {                        // the slot's part is read: free it
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    mbar::bar_arrive(empty);
  }
}

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
  const int64_t groups = (tiles + kGroup - 1) / kGroup;
  const int64_t chunks = (tiles + kChunk - 1) / kChunk;
  const Words w{words, words + tiles, words + tiles + groups};
  unsigned long long* const counter =
      reinterpret_cast<unsigned long long*>(w.carry + chunks + 1);
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
    Pending pend{};
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
      load_items(slots + ss.at * kTile, t, v);
      scan_tile(v, tile, n, &total);
      if (t == 0) publish(w.tile + tile, total);
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
    load_items(slots + sw.at * kTile, t, v);
    const float run = scan_tile(v, oldest, n, &total);
    write_tile(v, run, off, oldest, n, slots + sw.at * kTile,
               bars + 16 + sw.at, out);
    sw.next();
    --ahead;
  }
  if (lane == 0)        // the bulk stores complete before the CTA leaves
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// The words a call's state takes: the tiles' totals, the groups' sums,
// the chunks' carries (one more than the chunks) and the ticket counter.
__host__ __device__ inline int64_t state_words(int64_t tiles) {
  return tiles + (tiles + kGroup - 1) / kGroup + (tiles + kChunk - 1) / kChunk +
         2;
}

template <typename T>
int64_t ring_bytes(int depth) {
  return kStagedBytes + int64_t{depth} * kTile * static_cast<int64_t>(sizeof(T));
}

template <typename T>
int launch(const void* x, float* out, void* words, int64_t n, int64_t tiles,
           int64_t nwords, int depth, int64_t smem, cudaStream_t st) {
  if (tiles <= 0 || tiles >= (int64_t{1} << 31) || n > tiles * kTile ||
      n <= (tiles - 1) * kTile || (n * static_cast<int64_t>(sizeof(T))) % 16 ||
      depth < 2 || depth > 8 || smem != ring_bytes<T>(depth) ||
      nwords != state_words(tiles))
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
  return state_words(tiles);
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
