// The arithmetic of the online-softmax accumulator, shared by K11
// rescale_attention and R12 ring_rescale_attention: the tiles of a lanes
// tile D, the mask, the skip test of a 64-key sub-tile and the walk of the
// sub-tiles, the rescale of m, l and acc by a sub-tile's scores, the p v
// products and the drain.  Both kernels hand these the same raw scores (q
// . k summed over d in order, in FP32 FMA) and the same p and v, so R12
// gives K11's bits at every depth.  The rescale's thread mapping (rows 8
// tr .., keys tc + kCG k) fixes the order of each row's sum of p: a thread
// sums its kSC keys in order, then a butterfly over the kCG column groups;
// acc holds NA lanes a thread (8, or fewer where K11 computes only the
// live lanes of a head dim), which the rescale and p v leave in place.
#pragma once

#include "ssr_common.cuh"

namespace attention {

constexpr int kBK = 64;        // keys per sub-tile (one rescale of m, l, acc)
constexpr int kThreads = 256;  // kBQ / 8 row groups x kD / 8 column groups
constexpr int kChunk = 8;      // 16-byte packs of K and of V a thread holds
constexpr float kFill = -1e30f;

// The CTA's tiles for a lanes tile of D: kBQ query rows.
template <int D, int BQ>
struct Tiles {
  static constexpr int kD = D;
  static constexpr int kBQ = BQ;
  static constexpr int kRowGroups = BQ / 8;
  static constexpr int kColGroups = kThreads / kRowGroups;
  static constexpr int kSC = kBK / kColGroups;       // scores a thread
  static constexpr int kQPitch = BQ + 4;
  static constexpr int kKPitch = kBK + 1;
  static constexpr int kPPitch = BQ + 4;
  static constexpr int kSmemFloats = D * kQPitch + D * kKPitch + kBK * D + kBK * kPPitch;
  static constexpr int kQPacks = BQ * D / 4 / kThreads;   // 16-byte packs a
  static constexpr int kKPacks = kBK * D / 4 / kThreads;  // thread stages
  static_assert(kColGroups * 8 == D, "a thread holds 8 lanes of acc");
  static_assert(kColGroups <= 32 && kSC >= 1, "a row group within a warp");
  static_assert(kKPacks % kChunk == 0, "whole chunks of K and V");
};
using Tiles128 = Tiles<128, 128>;
using Tiles256 = Tiles<256, 64>;

__device__ __forceinline__ int64_t block_row(const SsrOdometer& o,
                                             const SsrStream& s) {
  int64_t i0 = s.offset[0];
#pragma unroll
  for (int k = 0; k < SSR_MAX_AXES; ++k) i0 += o.g[k] * s.coeff[k][0];
  return i0 * s.block[0];
}

// Four consecutive elements of a row as floats: one 16-byte (f32) or
// 8-byte (bf16) load; the wrapper checked the alignment.
template <typename T>
__device__ __forceinline__ float4 load4(const T* p);
template <>
__device__ __forceinline__ float4 load4<float>(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
template <>
__device__ __forceinline__ float4 load4<__nv_bfloat16>(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// The sub-tiles of one CTA's kv walk in grid order, masked ones skipped.
struct KvWalk {
  SsrOdometer odo;
  int64_t z = 0, zsteps, j0 = 0, blk;
  __device__ __forceinline__ KvWalk(const SsrGrid& g, int64_t step0,
                                    int64_t zsteps_, int64_t blk_)
      : odo(g, step0), zsteps(zsteps_), blk(blk_) {}
  __device__ __forceinline__ bool done() const { return z >= zsteps; }
  __device__ __forceinline__ int kvalid() const {
    return static_cast<int>(blk - j0 < kBK ? blk - j0 : kBK);
  }
  __device__ __forceinline__ int64_t kv0(const SsrStream& sk) const {
    return block_row(odo, sk) + j0;
  }
  __device__ __forceinline__ void next(const SsrGrid& g) {
    j0 += kBK;
    if (j0 >= blk) {
      j0 = 0;
      ++z;
      odo.advance(g);
    }
  }
};

struct Mask {
  float scale;
  int causal;
  int64_t window;   // < 0: none
  int64_t off_rc;   // sk - sq: query rows align to the keys' end
  int64_t sk;       // keys past sk are padding
};

// Whether the sub-tile of `kvalid` keys from key kv0 is masked for every
// query row row_min .. row_max (past the causal diagonal, before the
// window, or padding): the kernels skip it, in the prefetch walk too.
__device__ __forceinline__ bool masked_out(int64_t kv0, int kvalid,
                                           int64_t row_min, int64_t row_max,
                                           const Mask& mk) {
  return kv0 >= mk.sk || (mk.causal && kv0 > row_max) ||
         (mk.window >= 0 && kv0 + kvalid - 1 <= row_min - mk.window);
}

// Move `w` to the first sub-tile from here that some row of row_min ..
// row_max sees.
__device__ __forceinline__ void seek(KvWalk& w, const SsrGrid& g,
                                     const SsrStream& sk, const Mask& mk,
                                     int64_t row_min, int64_t row_max) {
  while (!w.done() && masked_out(w.kv0(sk), w.kvalid(), row_min, row_max, mk))
    w.next(g);
}

// One sub-tile's rescale: the raw scores s (rows 8 tr + i, keys tc + kCG k
// of the sub-tile from key kv0) scaled and masked (-1e30, never -inf), the
// row maxima and sums over the column group by shuffles, m and l updated,
// acc rescaled by alpha = exp(m - m'), and p = exp(s - m') written to pt
// (transposed: key-major, kPPitch apart) for the p v products.  expf is the
// accurate one.
template <typename L, int NA>
__device__ __forceinline__ void rescale(float (&s)[8][L::kSC], float (&m)[8],
                                        float (&l)[8], float (&acc)[8][NA],
                                        float* pt, int64_t row0, int tr,
                                        int tc, int64_t kv0, int kvalid,
                                        const Mask& mk) {
  constexpr int kCG = L::kColGroups, kSC = L::kSC;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t row = row0 + 8 * tr + i;
    float mx = kFill;
#pragma unroll
    for (int k = 0; k < kSC; ++k) {
      const int c = tc + kCG * k;
      const int64_t col = kv0 + c;
      const bool keep = c < kvalid && col < mk.sk &&
                        (!mk.causal || col <= row) &&
                        (mk.window < 0 || col > row - mk.window);
      s[i][k] = keep ? s[i][k] * mk.scale : kFill;
      mx = fmaxf(mx, s[i][k]);
    }
#pragma unroll
    for (int o = 1; o < kCG; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_new = fmaxf(m[i], mx);
    const float alpha = expf(m[i] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < kSC; ++k) {
      s[i][k] = expf(s[i][k] - m_new);
      sum += s[i][k];
    }
#pragma unroll
    for (int o = 1; o < kCG; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    l[i] = l[i] * alpha + sum;
    m[i] = m_new;
#pragma unroll
    for (int j = 0; j < NA; ++j) acc[i][j] *= alpha;
  }
#pragma unroll
  for (int k = 0; k < kSC; ++k) {
    float4* dst = reinterpret_cast<float4*>(pt + (tc + kCG * k) * L::kPPitch + 8 * tr);
    dst[0] = make_float4(s[0][k], s[1][k], s[2][k], s[3][k]);
    dst[1] = make_float4(s[4][k], s[5][k], s[6][k], s[7][k]);
  }
}

// Eight consecutive elements of a staged V row as floats (16 bytes of f32
// twice, or 16 bytes of bf16 converted exactly).
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.z));
  const float2 d = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.w));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  v[4] = c.x; v[5] = c.y; v[6] = d.x; v[7] = d.y;
}

// Six consecutive elements of a staged V row as floats (8 bytes of f32
// three times, or 4 bytes of bf16 three times, converted exactly).
__device__ __forceinline__ void load6(const float* p, float (&v)[6]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float2 a = reinterpret_cast<const float2*>(p)[k];
    v[2 * k] = a.x;
    v[2 * k + 1] = a.y;
  }
}
__device__ __forceinline__ void load6(const __nv_bfloat16* p, float (&v)[6]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float2 a = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(p)[k]);
    v[2 * k] = a.x;
    v[2 * k + 1] = a.y;
  }
}
template <typename V>
__device__ __forceinline__ void load_lanes(const V* p, float (&v)[8]) { load8(p, v); }
template <typename V>
__device__ __forceinline__ void load_lanes(const V* p, float (&v)[6]) { load6(p, v); }

// acc += p v over N consecutive keys in order: p from pt (key-major, the
// first key's row at pt), v from staged rows `ld` elements apart (the
// first key's row at vs), the thread's NA lanes from NA tc.
template <typename L, int N, typename V, int NA>
__device__ __forceinline__ void accumulate_pv(float (&acc)[8][NA], const float* pt,
                                              const V* vs, int ld, int tr, int tc) {
#pragma unroll 4
  for (int c = 0; c < N; ++c) {
    const float4 pa = reinterpret_cast<const float4*>(pt + c * L::kPPitch)[2 * tr];
    const float4 pb = reinterpret_cast<const float4*>(pt + c * L::kPPitch)[2 * tr + 1];
    const float pv[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
    float vv[NA];
    load_lanes(vs + c * ld + NA * tc, vv);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < NA; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
  }
}

// The drain: acc / max(l, 1e-30), cast to the output dtype, for the
// thread's rows below `nrows` and its NA lanes from NA tc.
template <typename O, int NA>
__device__ __forceinline__ void drain(const float (&acc)[8][NA], const float (&l)[8],
                                      O* out, int64_t pitch, int nrows, int tr,
                                      int tc) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = 8 * tr + i;
    if (r >= nrows) break;
    const float lmax = fmaxf(l[i], 1e-30f);
    O* dst = out + r * pitch + NA * tc;
#pragma unroll
    for (int j = 0; j < NA; ++j) dst[j] = ssr_cast<O>(acc[i][j] / lmax);
  }
}

}  // namespace attention
