// K14 stream_scan: the inclusive prefix sum of a padded vector, in f32.
//
// Replaces the TPU kernel repro/core/ssr.py:ssr_pallas (sync emitter) as
// built by repro/kernels/frontend.py:StreamKernel._build with the body
// repro/kernels/scan.py:_ssr_body: grid n/1024 over the (8, 128) blocks of
// the padded vector, the axis `arbitrary`, out = cumsum(block) + carry with
// the running total carried from step to step in a VMEM scratch register.
//
// Bound on H100: bytes.  x read once and y written once (8 bytes an element
// for f32 in and out) against one add an element.  K14 reads x once.
//
// Design: CTAs run concurrently, so no carry passes from one CTA to the
// next (ROADMAP, "Grid semantics"); each tile of kTile = 4096 elements
// finds its offset instead from what the tiles before it published, by
// the operations of a fixed-order second pass over the tiles' totals
// (ssr_scan.cuh: the look-back, Words), so every run gives the same bits,
// those of a three-launch scan (the tiles' totals, a one-CTA second pass
// over them, each tile's scan from its offset).  One memset of the call's
// state, then one launch:
// persistent CTAs, as many as fit the card at once, take tiles by ticket
// in increasing order.  What the Pallas sync emission has is double
// buffering, and that is what a CTA keeps: two slots of a tile each, on a
// full mbarrier a slot, filled by one bulk copy (cp.async.bulk, issued by
// thread 0).  With tile A summed (its total published) in one slot, a CTA
//   1. takes the next ticket B and issues its copy into the other slot,
//      and issues the loads of A's look-back words;
//   2. waits for B, sums it, publishes B's total at once and closes B's
//      group or chunk where B closes one -- waiting only on earlier tiles'
//      sums;
//   3. waits for A's offset (the tiles before A were all summed while this
//      CTA, and every CTA, summed one tile ahead);
//   4. reads A again, writes its prefix sums, staged in A's slot and
//      stored by bulk copies, and keeps B as A.
// A tile's total is published before its CTA waits on anything, and a
// tile waits on earlier tiles alone, so every tile finishes
// (hopper.scan_schedule_model).  The association differs from the
// reference's (1024-element cumsums plus a sequential carry): both are f32
// prefix sums within rounding of the exact one.
#include "ssr_scan.cuh"

namespace {

using scan::kItems;
using scan::kThreads;
using scan::kTile;

constexpr int kMinCtas = 4;          // CTAs an SM the registers allow
// The shared memory before the two slots: their full barriers, their
// tiles' numbers, a group's totals and the offset's scratch.
constexpr int kTileAt = 16;
constexpr int kGroupAt = kTileAt + 16;
constexpr int kShAt = kGroupAt + scan::kGroup * 4;
constexpr int kHeaderBytes = 128;
static_assert(kShAt + 16 <= kHeaderBytes, "K14's header");

template <typename T>
__host__ __device__ constexpr int smem_bytes() {
  return kHeaderBytes + 2 * kTile * static_cast<int>(sizeof(T));
}

// Thread 0: the next ticket into slot s (its number in `slot_tile`, -1
// once the tickets run out), its tile copied in by one bulk copy.
template <typename T>
__device__ __forceinline__ void take(int s, const T* __restrict__ x, int64_t n,
                                     int64_t tiles, unsigned long long* counter,
                                     int* slot_tile, uint64_t* full, T* slots) {
  const unsigned long long tile = atomicAdd(counter, 1ull);
  if (tile >= static_cast<unsigned long long>(tiles)) {
    slot_tile[s] = -1;
    return;
  }
  slot_tile[s] = static_cast<int>(tile);
  const int64_t base = static_cast<int64_t>(tile) * kTile;
  const int64_t elems = n - base < kTile ? n - base : kTile;
  const unsigned bytes = static_cast<unsigned>(elems * sizeof(T));
  mbar::bar_arrive_expect(full + s, bytes);
  mbar::bulk_copy(slots + s * kTile, x + base, bytes, full + s);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinCtas)
    scan_tiles(const T* __restrict__ x, int64_t n, float* __restrict__ out,
               uint64_t* __restrict__ words, int64_t tiles) {
  __shared__ __align__(128) unsigned char smem[smem_bytes<T>()];
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem);
  int* const slot_tile = reinterpret_cast<int*>(smem + kTileAt);
  float* const gv = reinterpret_cast<float*>(smem + kGroupAt);
  float* const sh = reinterpret_cast<float*>(smem + kShAt);
  T* const slots = reinterpret_cast<T*>(smem + kHeaderBytes);
  const scan::Words w(words, tiles);
  unsigned long long* const counter = w.counter(tiles);
  const int t = threadIdx.x;
  if (t == 0) {
    mbar::bar_init(full, 1);
    mbar::bar_init(full + 1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    take(0, x, n, tiles, counter, slot_tile, full, slots);
  }
  __syncthreads();
  int a = slot_tile[0];
  if (a < 0) return;                 // the same in every thread
  unsigned parity = 0;               // bit s: the phase of slot s's next fill
  float v[kItems], total;
  mbar::bar_wait(full, 0);
  parity ^= 1u;
  scan::load_items(slots, t, v);
  float run_a = scan::scan_tile(v, a, n, &total);
  if (t == 0) scan::publish(w.tile + a, total);
  w.close(a, total, gv, sh);
  for (int sa = 0;; sa ^= 1) {
    const int sb = sa ^ 1;
    scan::sync_compute();            // slot sb's last tile is stored
    if (t == 0) take(sb, x, n, tiles, counter, slot_tile, full, slots);
    const scan::Pending pend = w.issue(a);
    scan::sync_compute();            // slot_tile[sb]
    const int b = slot_tile[sb];
    float run_b = 0.f;
    if (b >= 0) {
      mbar::bar_wait(full + sb, (parity >> sb) & 1u);
      parity ^= 1u << sb;
      scan::load_items(slots + sb * kTile, t, v);
      run_b = scan::scan_tile(v, b, n, &total);
      if (t == 0) scan::publish(w.tile + b, total);
      w.close(b, total, gv, sh);
    }
    const float off = w.offset(pend, a, gv, sh);
    // the elements past n are not stored, nor summed before one that is
    scan::load_items(slots + sa * kTile, t, v);
    scan::write_tile(v, run_a, off, a, n, slots + sa * kTile, out);
    if (b < 0) break;
    a = b;
    run_a = run_b;
  }
  if ((t & 31) == 0) scan::stores_done();
}

template <typename T>
int launch(const void* x, float* out, void* words, int64_t n, int64_t tiles,
           int64_t nwords, cudaStream_t st) {
  if (!scan::fits<T>(n, tiles) || nwords != scan::state_words(tiles))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, scan_tiles<T>,
                                                        kThreads, 0);
  if (err == cudaSuccess && per_sm < 1) err = cudaErrorInvalidConfiguration;
  if (err == cudaSuccess)
    err = cudaMemsetAsync(words, 0, nwords * sizeof(uint64_t), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  // as many CTAs as fit the card at once (tickets hand out the tiles)
  const int64_t fit = int64_t{per_sm} * sms;
  const unsigned grid = static_cast<unsigned>(tiles < fit ? tiles : fit);
  scan_tiles<T><<<grid, kThreads, 0, st>>>(static_cast<const T*>(x), n, out,
                                           static_cast<uint64_t*>(words), tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x holds n elements (the padded (rows, 128) layout, n a multiple of 1024),
// 16-byte aligned; out the n f32 prefix sums; `words` the call's state,
// `nwords` 64-bit words (ssr_stream_scan_state_words), zeroed here.  One
// memset and one launch.
extern "C" int ssr_stream_scan(const void* x, int dtype, void* out, void* words,
                               int64_t n, int64_t tiles, int64_t nwords,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (dtype == SSR_F32) return launch<float>(x, o, words, n, tiles, nwords, st);
  if (dtype == SSR_BF16)
    return launch<__nv_bfloat16>(x, o, words, n, tiles, nwords, st);
  if (dtype == SSR_I32) return launch<int32_t>(x, o, words, n, tiles, nwords, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The f32 kernel's static shared memory: its header and two f32 slots.
extern "C" int64_t ssr_stream_scan_smem_bytes() { return smem_bytes<float>(); }

extern "C" int64_t ssr_stream_scan_state_words(int64_t tiles) {
  return scan::state_words(tiles);
}

// Registers a thread and local bytes (the most over the three dtypes'
// instantiations) and the f32 kernel's CTAs an SM: out[0], out[1], out[2].
extern "C" int ssr_stream_scan_attributes(int64_t* out) {
  const void* const kernels[] = {
      reinterpret_cast<const void*>(scan_tiles<float>),
      reinterpret_cast<const void*>(scan_tiles<__nv_bfloat16>),
      reinterpret_cast<const void*>(scan_tiles<int32_t>)};
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
      &ctas, scan_tiles<float>, kThreads, 0);
  out[2] = ctas;
  return static_cast<int>(err);
}
