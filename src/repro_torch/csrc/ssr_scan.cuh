// K14's per-tile arithmetic, shared by K14 stream_scan and its ring kernel
// R15 ring_stream_scan, so that a tile's sums run in the same order on the
// same values whichever kernel staged it.
//
// A CTA of kThreads threads owns a tile of kTile = 4096 elements; thread t
// holds the 16 consecutive elements from 16 t.  K14 stages the tile in
// shared memory as floats on padded 4-byte words, one pad word every 32
// (padded()): a thread reads its elements at a stride of 16 words, and the
// pads spread a warp's reads over all 32 banks; each element is converted
// as it loads (int32 rounded to nearest, bf16 exactly).  R15 keeps the
// tile unpadded and reads a thread's elements into registers, converted
// the same way, and takes the thread's sum in the same order and the CTA
// scan (ssr_cta_exclusive_scan) that give the tile's total and each
// element's prefix; nothing is atomic, so every run gives the same bits.
#pragma once

#include "ssr_common.cuh"

namespace scan {

constexpr int kThreads = 256;
constexpr int kItems = 16;                  // consecutive elements a thread
constexpr int kTile = kThreads * kItems;    // 4096 elements a CTA
constexpr int kPacks = kItems / 4;          // 16-byte loads a thread (K14)
constexpr int kWords = kTile + kTile / 32;  // a float tile on padded words

__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

// Element e of a tile staged on padded words.
__device__ __forceinline__ float staged(const float* sm, int e) {
  return sm[padded(e)];
}

// K14's staging: x[base, base + kTile) into shared memory as floats, 0
// past n (a multiple of 4): every load of the thread issued before its
// stores.
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ x, int64_t base,
                                      int64_t n, float* sm) {
  float4 v[kPacks];
#pragma unroll
  for (int k = 0; k < kPacks; ++k) {
    const int64_t e = base + 4 * (threadIdx.x + k * kThreads);
    v[k] = e < n ? ssr_load4_f32(x + e) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int k = 0; k < kPacks; ++k) {
    const int e = 4 * (threadIdx.x + k * kThreads);
    sm[padded(e)] = v[k].x;
    sm[padded(e + 1)] = v[k].y;
    sm[padded(e + 2)] = v[k].z;
    sm[padded(e + 3)] = v[k].w;
  }
  __syncthreads();
}

// The sum of the thread's 16 staged elements, in order.
template <typename T>
__device__ __forceinline__ float thread_sum(const T* sm) {
  const int e0 = threadIdx.x * kItems;
  float s = staged(sm, e0);
#pragma unroll
  for (int j = 1; j < kItems; ++j) s += staged(sm, e0 + j);
  return s;
}

// The staged tile's total (in every thread).
template <typename T>
__device__ __forceinline__ float tile_total(const T* sm) {
  float total;
  ssr_cta_exclusive_scan<kThreads>(thread_sum(sm), &total);
  return total;
}

// The staged tile's inclusive prefix sums plus `off` onto the float tile
// `out` (padded words; it may be `sm` itself, a float tile), each thread
// adding its 16 elements in order from its exclusive offset in the tile.
template <typename T>
__device__ __forceinline__ void tile_scan(const T* sm, float off, float* out) {
  float total;
  float run = ssr_cta_exclusive_scan<kThreads>(thread_sum(sm), &total);
  const int e0 = threadIdx.x * kItems;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    run += staged(sm, e0 + j);
    out[padded(e0 + j)] = off + run;
  }
}

// The float tile `sm` to out[base, base + kTile), as 16-byte stores, up to
// n; the caller met at a barrier after the tile was written.
__device__ __forceinline__ void store_tile(const float* sm, float* __restrict__ out,
                                          int64_t base, int64_t n) {
#pragma unroll
  for (int k = 0; k < kPacks; ++k) {
    const int e = 4 * (threadIdx.x + k * kThreads);
    if (base + e < n)
      *reinterpret_cast<float4*>(out + base + e) =
          make_float4(sm[padded(e)], sm[padded(e + 1)], sm[padded(e + 2)], sm[padded(e + 3)]);
  }
}

}  // namespace scan
