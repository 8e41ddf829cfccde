// K14's scan in one pass over x, shared by K14 stream_scan and its ring
// kernel R15 ring_stream_scan: a tile's arithmetic and the look-back that
// gives each tile its offset, so that both kernels run one copy of every
// sum, in one order, on the same values, whoever delivers the tiles.
//
// A CTA's 256 computing threads own a tile of kTile = 4096 elements; thread
// t holds the 16 consecutive elements from 16 t.  A tile lands unpadded in
// shared memory (a slot: 16 KiB of f32 or int32, 8 KiB of bf16); a thread
// reads its 16 elements into registers as 16-byte words in a rotated
// order, so that a quarter warp's loads hit 32 distinct banks, and converts
// each as it goes (bf16 exactly, int32 rounded to nearest).  Its sum of
// the 16 in order and the CTA scan of the thread sums
// (ssr_cta_exclusive_scan) give the tile's total and each element's prefix.
//
// The offsets are those of the fixed second pass over the tiles' totals
// that K14's and B8's three-launch designs ran in one CTA
// (hopper.scan_offsets_model): chunks of 4096 totals in order with a
// running carry; in a chunk, thread t sums its 16 totals (a group) in
// order from 0.f, a fixed CTA scan of the 256 group sums, and
// each offset is carry + the group's exclusive sum + its earlier totals in
// order.  Tile i's offset there depends only on the totals of the tiles
// before i, so one pass can give the same bits: each tile publishes its
// total; the tile that closes a group waits for its group mates' totals
// and publishes the group's sum; the tile that closes a chunk waits for the
// chunk's group sums and carry and publishes the next carry; and each tile
// computes its own offset, operation for operation, from its predecessors'
// published values (Words) -- a decoupled look-back, which adds whichever
// predecessors are ready, could not.  Tiles are taken by ticket, in
// increasing order, by CTAs that are all resident at once, and every wait
// is on an earlier tile's sum step, so no tile waits on a CTA that has not
// started and every tile finishes (hopper.scan_schedule_model).
//
// A value and its ready flag share one 64-bit word (the float's bits, 1
// above them), so a reader never sees a value before it is whole; the
// words and the ticket counter are zeroed for every call by the entry (one
// memset before the launch).  Nothing is atomic but the ticket, so every
// run gives the same bits whatever order the tiles finish in: -0 and NaN
// and int32's rounding (__int2float_rn) included.
#pragma once

#include "ssr_common.cuh"
#include "ssr_mbarrier.cuh"

namespace scan {

constexpr int kThreads = 256;               // the computing threads
constexpr int kItems = 16;                  // consecutive elements a thread
constexpr int kTile = kThreads * kItems;    // 4096 elements a tile
constexpr int kGroup = 16;                  // totals a group
constexpr int kChunk = kThreads * kGroup;   // 4096 totals a chunk
constexpr int kBar = 1;                     // the computing threads' barrier
constexpr int kWarpOut = 32 * kItems;       // a warp's elements of a tile

__device__ __forceinline__ void sync_compute() { ssr_bar<kBar, kThreads>(); }

// The words a call's state takes: the tiles' totals, the groups' sums, the
// chunks' carries (one more than the chunks) and the ticket counter.
__host__ __device__ inline int64_t state_words(int64_t tiles) {
  return tiles + (tiles + kGroup - 1) / kGroup + (tiles + kChunk - 1) / kChunk +
         2;
}

// A value with its ready flag, as one 64-bit word.
__device__ __forceinline__ void publish(uint64_t* w, float v) {
  const unsigned long long word = (1ull << 32) | __float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(w), "l"(word)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_word(const uint64_t* w) {
  unsigned long long word;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n"
               : "=l"(word)
               : "l"(w)
               : "memory");
  return word;
}

// The value of a word loaded earlier, once it is published, polled every
// kPauseNs nanoseconds (K14 and R15 poll without a pause: a 20 ns
// __nanosleep between polls measured 2 % slower there; B8, whose CTAs wait
// more, pauses).
template <int kPauseNs = 0>
__device__ __forceinline__ float ready(unsigned long long word,
                                       const uint64_t* w) {
  while (!(word >> 32)) {
    if constexpr (kPauseNs > 0) __nanosleep(kPauseNs);
    word = load_word(w);
  }
  return __uint_as_float(static_cast<unsigned>(word));
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

// Thread t's 16 consecutive elements of a slot as floats.  The thread's
// kVec 16-byte words are read starting at word r = (t / (8 / kVec)) %
// kVec, so that the 8 threads of a quarter warp read 8 distinct 16-byte
// bank groups; selects on r's bits put them back in order.
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

// A tile in registers: 0 past n, the thread's sum of its 16 elements in
// order, the CTA scan; the tile's total in `total`, the thread's exclusive
// value in the tile returned.
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
  return ssr_cta_exclusive_scan<kThreads, kBar>(sum, total);
}

// The words a tile's offset reads, loaded as soon as the tile is taken
// (the loads in flight while the next tile is summed): thread t < j the
// total of group mate t, t < q the chunk's group sum t, the last thread
// the chunk's carry.  A word not yet published is read again when needed.
struct Pending {
  unsigned long long mate, group, carry;
};

template <int kPauseNs = 0>
struct WordsPolled {
  uint64_t* tile;      // each tile's total
  uint64_t* group;     // each group's sum
  uint64_t* carry;     // each chunk's carry (index c: chunk c's)

  // The state of a call of `tiles` tiles at `words`; its ticket counter
  // follows the carries.
  __device__ __forceinline__ WordsPolled(uint64_t* words, int64_t tiles)
      : tile(words), group(words + tiles),
        carry(words + tiles + (tiles + kGroup - 1) / kGroup) {}
  __device__ __forceinline__ unsigned long long* counter(int64_t tiles) const {
    return reinterpret_cast<unsigned long long*>(
        carry + (tiles + kChunk - 1) / kChunk + 1);
  }

  __device__ __forceinline__ Pending issue(int tile) const {
    const int t = threadIdx.x;
    const int c = tile / kChunk, pos = tile % kChunk;
    const int q = pos / kGroup, j = pos % kGroup;
    Pending p{1ull << 32, 1ull << 32, 1ull << 32};
    if (t < j) p.mate = load_word(this->tile + tile - j + t);
    if (t < q) p.group = load_word(group + int64_t{c} * kThreads + t);
    if (t == kThreads - 1 && c > 0) p.carry = load_word(carry + c);
    return p;
  }

  // Tile `tile`'s exclusive offset, the second pass's value for it,
  // from its predecessors' totals, group sums and carry, all published in
  // their tiles' sum steps.  Every computing thread calls it; the offset
  // in all of them.  `gv` holds kGroup floats, `sh` 3.
  __device__ __forceinline__ float offset(Pending p, int tile, float* gv,
                                          float* sh) const {
    const int t = threadIdx.x;
    const int c = tile / kChunk, pos = tile % kChunk;
    const int q = pos / kGroup, j = pos % kGroup;
    if (t < j) gv[t] = ready<kPauseNs>(p.mate, this->tile + tile - j + t);
    float g = 0.f;
    if (t < q)
      g = ready<kPauseNs>(p.group, group + int64_t{c} * kThreads + t);
    if (t == kThreads - 1 && c > 0)
      sh[0] = ready<kPauseNs>(p.carry, carry + c);
    float chunk;      // the scan's barriers order gv and sh[0] too
    const float excl = ssr_cta_exclusive_scan<kThreads, kBar>(g, &chunk);
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

  // The sum step after a tile's total is published: where tile `tile`
  // closes its group, wait for its group mates' totals and publish the
  // group's sum, in order from 0.f as the second pass sums a
  // thread's 16 totals; where it closes its chunk too, wait for the
  // chunk's group sums and carry and publish the next carry (the CTA
  // scan's total over the 256 group sums, added).  It waits on sum steps
  // of earlier tiles alone.
  __device__ __forceinline__ void close(int tile, float total, float* gv,
                                        float* sh) const {
    const int t = threadIdx.x;
    const int c = tile / kChunk, pos = tile % kChunk;
    if (pos % kGroup != kGroup - 1) return;   // the same in every thread
    if (t < kGroup - 1)
      gv[t] = ready<kPauseNs>(load_word(this->tile + tile - (kGroup - 1) + t),
                              this->tile + tile - (kGroup - 1) + t);
    sync_compute();
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kGroup - 1; ++k) s += gv[k];
    s += total;
    if (t == 0) publish(group + tile / kGroup, s);
    if (pos == kChunk - 1) {
      const uint64_t* const gw = group + int64_t{c} * kThreads + t;
      const float g =
          t < kThreads - 1 ? ready<kPauseNs>(load_word(gw), gw) : s;
      if (t == 0 && c > 0)
        sh[2] = ready<kPauseNs>(load_word(carry + c), carry + c);
      float chunk;
      ssr_cta_exclusive_scan<kThreads, kBar>(g, &chunk);
      if (t == 0) publish(carry + c + 1, (c > 0 ? sh[2] : 0.f) + chunk);
    }
    sync_compute();   // gv read by all before the offset step writes it
  }
};

// K14's and R15's look-back, polled without a pause.
using Words = WordsPolled<>;

// A tile's prefix sums, each thread's 16 from its exclusive value in the
// tile plus the tile's offset, up to n, staged in the warp's own part of
// the tile's slot (its elements already in registers) and stored by bulk
// copies: whole lines leave the SM, where a thread's own 16-byte stores 64
// bytes apart would not.  The sums are f32: in f32 and int32 the warp's
// 512 of them fill its part in one round; in bf16 its part holds 256, so
// half the lanes' sums go in each of two rounds.  Sums are stored in
// 16-byte words in the rotated order of load_items (a quarter warp hits
// distinct banks).  On return lane 0's copies have read the warp's part:
// the slot may be refilled once every warp is past this.
template <typename T>
__device__ __forceinline__ void write_tile(const float (&v)[kItems], float run,
                                           float off, int tile, int64_t n,
                                           T* slot, float* __restrict__ out) {
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
  if (lane == 0)                          // the slot's part is read
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// The bulk stores of this thread complete before the CTA leaves.
__device__ __forceinline__ void stores_done() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// The launch checks of both kernels: x holds n elements of T in `tiles`
// tiles, the last one not empty, in whole 16-byte words.
template <typename T>
__host__ inline bool fits(int64_t n, int64_t tiles) {
  return tiles > 0 && tiles < (int64_t{1} << 31) && n <= tiles * kTile &&
         n > (tiles - 1) * kTile && (n * static_cast<int64_t>(sizeof(T))) % 16 == 0;
}

}  // namespace scan
