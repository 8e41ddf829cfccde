// R15 ring_stream_scan: K14's inclusive prefix sum of a padded vector, in
// f32, its tiles delivered through an N-deep shared-memory ring.
//
// Replaces the TPU kernel repro/core/ssr.py:_pipelined_call (the N-deep
// rotation that ssr_pallas emits at buffer_depth > 2 on a grid of more than
// one step, repro/core/ssr.py:422-424) as built by
// repro/kernels/frontend.py:StreamKernel._build with the body
// repro/kernels/scan.py:_ssr_body: grid n/1024 over the (8, 128) blocks of
// the padded vector, the carry in a VMEM scratch register.
//
// Bound on H100: bytes, as K14 -- x read once and y written once against
// one add an element.  R15 reads x twice, as K14 does.
//
// Design: K14's three passes and its determinism -- tile totals, one CTA's
// scan of the totals in order (ssr_exclusive_offsets, unchanged), tile
// scans from their offsets; no look-back and no atomics -- with passes 1
// and 3 on persistent CTAs, each walking a run of `per_cta` consecutive
// 4096-element tiles through a ring of `depth` tile slots: depth - 1 tiles
// in flight while one is summed.  A slot holds the input's own words on
// K14's padded layout (ssr_scan.cuh: one pad word every 32, so a thread's
// reads at a stride of 16 words spread over all banks), filled by 4-byte
// cp.async -- a 16-byte copy would land off its alignment on that layout
// -- with the words past n zero-filled: 16,896 bytes in f32 or int32,
// 8,448 for bf16.  At tile i every thread waits on its own copies of tile
// i, the CTA meets at one barrier, which publishes slot i and frees the
// slot of tile i - 1, and then the fetch of tile i + depth - 1 goes into
// that slot (ssr_ring.cuh's discipline).  Pass 3 writes a tile's sums to
// one float tile beside the ring and stores it as K14 does.  The arithmetic
// is ssr_scan.cuh's, K14's on the same values in the same order, so R15
// gives K14's bits at every depth.  The ring's unit is K14's tile, four of
// the Launch's (8, 128) blocks.
#include "ssr_ring.cuh"
#include "ssr_scan.cuh"

namespace {

using namespace scan;

// Copy tile `tile`'s words of x into a slot on padded words, 0 past n.
template <typename T>
__device__ __forceinline__ void copy_tile(T* slot, const T* __restrict__ x,
                                          int64_t tile, int64_t n) {
  constexpr int kPer = 4 / static_cast<int>(sizeof(T));   // elements a word
  constexpr int kTileWords = kTile / kPer;
  uint32_t* dst = reinterpret_cast<uint32_t*>(slot);
  const uint32_t* src = reinterpret_cast<const uint32_t*>(x);
  const int64_t w0 = tile * kTileWords;
#pragma unroll
  for (int k = 0; k < kTileWords / kThreads; ++k) {
    const int w = threadIdx.x + k * kThreads;
    const bool in = (w0 + w) * kPer < n;
    ssr_ring_cp4(dst + padded(w), in ? src + w0 + w : src, in);
  }
}

// The CTA's run of tiles [first, last) through the ring: each tile's slot
// handed to `use(slot, tile)` once it has landed, in order.
template <typename T, typename Use>
__device__ __forceinline__ void walk(T* slots, const T* __restrict__ x,
                                     int64_t n, int64_t first, int64_t last,
                                     int depth, Use&& use) {
  constexpr int kSlot = slot_words<T>() * 4 / static_cast<int>(sizeof(T));
  int64_t next = first;
  int put = 0, get = 0;
  auto issue = [&]() {
    if (next < last) copy_tile(slots + put * kSlot, x, next, n);
    ++next;
    put = put + 1 == depth ? 0 : put + 1;
    ssr_cp_async_commit();
  };
  for (int s = 0; s < depth - 1; ++s) issue();
  for (int64_t tile = first; tile < last; ++tile) {
    ssr_ring_wait(depth - 2);      // this thread's copies of the tile landed
    __syncthreads();               // every thread's; the last slot is free
    issue();                       // the tile depth - 1 ahead
    use(slots + get * kSlot, tile);
    get = get + 1 == depth ? 0 : get + 1;
  }
  ssr_cp_async_wait<0>();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ring_tile_totals(const T* __restrict__ x, int64_t n,
                     float* __restrict__ totals, int64_t tiles,
                     int64_t per_cta, int depth) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t first = blockIdx.x * per_cta;
  const int64_t last = first + per_cta < tiles ? first + per_cta : tiles;
  walk(reinterpret_cast<T*>(smem), x, n, first, last, depth,
       [&](const T* slot, int64_t tile) {
         const float total = tile_total(slot);
         if (threadIdx.x == 0) totals[tile] = total;
       });
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ring_tile_scan(const T* __restrict__ x, int64_t n,
                   const float* __restrict__ offsets, float* __restrict__ out,
                   int64_t tiles, int64_t per_cta, int depth) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* const sums = reinterpret_cast<float*>(smem) + depth * slot_words<T>();
  const int64_t first = blockIdx.x * per_cta;
  const int64_t last = first + per_cta < tiles ? first + per_cta : tiles;
  walk(reinterpret_cast<T*>(smem), x, n, first, last, depth,
       [&](const T* slot, int64_t tile) {
         tile_scan(slot, offsets[tile], sums);
         __syncthreads();          // the tile's sums are all written
         store_tile(sums, out, tile * kTile, n);
       });
}

template <typename T>
int launch(const void* x, float* out, float* totals, int64_t n, int64_t tiles,
           int64_t per_cta, int depth, int64_t smem, cudaStream_t st) {
  if (tiles <= 0 || tiles >= (int64_t{1} << 31) || n > tiles * kTile || n % 4 ||
      per_cta < 1 || depth < 2 || depth > 8 ||
      smem != int64_t{4} * depth * slot_words<T>())
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t scan_smem = smem + int64_t{4} * kWords;   // the sums tile
  cudaError_t err = ssr_ring_smem(ring_tile_totals<T>, smem);
  if (err == cudaSuccess) err = ssr_ring_smem(ring_tile_scan<T>, scan_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* xp = static_cast<const T*>(x);
  const unsigned grid = static_cast<unsigned>((tiles + per_cta - 1) / per_cta);
  ring_tile_totals<T><<<grid, kThreads, smem, st>>>(xp, n, totals, tiles,
                                                    per_cta, depth);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssr_exclusive_offsets<kThreads><<<1, kThreads, 0, st>>>(totals, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ring_tile_scan<T><<<grid, kThreads, scan_smem, st>>>(xp, n, totals, out,
                                                       tiles, per_cta, depth);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// As ssr_stream_scan, plus the ring: `ring->depth[0]` tile slots, each CTA
// of passes 1 and 3 walking `per_cta` consecutive tiles, and `smem_bytes`,
// the ring's dynamic shared memory as the wrapper counted it (depth slots
// of the input's words on the padded layout), checked here; pass 3 takes
// one float tile more.  x is 16-byte aligned.  Three launches.
extern "C" int ssr_ring_stream_scan(const void* x, int dtype, void* out,
                                    void* totals, int64_t n, int64_t tiles,
                                    int64_t per_cta, const SsrRing* ring,
                                    int64_t smem_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  float* t = static_cast<float*>(totals);
  const int depth = static_cast<int>(ring->depth[0]);
  if (dtype == SSR_F32)
    return launch<float>(x, o, t, n, tiles, per_cta, depth, smem_bytes, st);
  if (dtype == SSR_BF16)
    return launch<__nv_bfloat16>(x, o, t, n, tiles, per_cta, depth, smem_bytes, st);
  if (dtype == SSR_I32)
    return launch<int32_t>(x, o, t, n, tiles, per_cta, depth, smem_bytes, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int64_t ssr_ring_stream_scan_smem_bytes() { return 0; }
