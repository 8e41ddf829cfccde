// The arithmetic of the online-softmax accumulator, shared by K11
// rescale_attention and R12 ring_rescale_attention: the tiles of a lanes
// tile D, the mask, the skip test of a 64-key sub-tile and the walk of the
// sub-tiles, the copies of K, V and Q into shared memory, the two score
// micro-tiles, the rescale of m, l and acc by a sub-tile's scores, the p v
// products and the drain.  Both kernels hand these the same raw scores (q
// . k summed over d in order, in FP32 FMA from 0.f) and the same p and v,
// so R12 gives K11's bits at every depth.  The rescale's thread mapping
// (rows 8 tr .., keys tc + kCG k) fixes the order of each row's sum of p:
// a thread sums its kSC keys in order, then a butterfly over the kCG
// column groups; acc holds NA lanes a thread (8, or 6 where a kernel
// computes only the live lanes of a head dim), which the rescale and p v
// leave in place.  Which thread computes a raw score, and which lanes of
// acc a thread holds, changes no bit: each acc lane sums p v over the keys
// in order, and skipping trailing zero lanes of a score's FMA chain
// changes at most the sign of a zero score, which no output sees.
#pragma once

#include "ssr_common.cuh"
#include "ssr_ring.cuh"

namespace attention {

constexpr int kBK = 64;        // keys per sub-tile (one rescale of m, l, acc)
constexpr int kThreads = 256;  // kBQ / 8 row groups x kD / 8 column groups
constexpr float kFill = -1e30f;

// The CTA's tiles for a lanes tile of D: kBQ query rows.
template <int D, int BQ>
struct Tiles {
  static constexpr int kD = D;
  static constexpr int kBQ = BQ;
  static constexpr int kRowGroups = BQ / 8;
  static constexpr int kColGroups = kThreads / kRowGroups;
  static constexpr int kSC = kBK / kColGroups;       // scores a thread
  static constexpr int kPPitch = BQ + 4;
  static_assert(kColGroups * 8 == D, "a thread holds 8 lanes of acc");
  static_assert(kColGroups <= 32 && kSC >= 1, "a row group within a warp");
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

// Rows [0, kRows) of kLanes elements from `src` (row pitch `spitch`) to
// `dst` (row pitch `dpitch`) by 16-byte cp.async, by thread `lane` of the
// `nthreads` that copy; rows from `valid` on zero-filled (reading nothing
// past the block).
template <int kRows, int kLanes, typename T>
__device__ __forceinline__ void copy_rows(T* dst, int dpitch, const T* src,
                                          int64_t spitch, int valid,
                                          int lane = threadIdx.x,
                                          int nthreads = kThreads) {
  constexpr int kElems = 16 / static_cast<int>(sizeof(T));
  constexpr int kPacks = kLanes / kElems;             // a row's
  for (int i = lane; i < kRows * kPacks; i += nthreads) {
    const int r = i / kPacks, c = (i - r * kPacks) * kElems;
    const bool in = r < valid;
    ssr_ring_cp16(dst + r * dpitch + c, in ? src + r * spitch + c : src, in);
  }
}

// Q^T of the CTA's rows in f32: DL lanes (rows of qt) of kBQ query rows
// (qt's pitch), rows past `nrows` zero.  Rows run fastest over the
// threads, so a warp's stores hit 32 banks; every load is issued before
// any store.
template <int DL, int kBQ, typename T>
__device__ __forceinline__ void stage_qt(float* qt, const T* q, int64_t pitch,
                                         int nrows) {
  constexpr int kPacks = kBQ * DL / 4 / kThreads;     // a thread's
  static_assert(kPacks * 4 * kThreads == kBQ * DL, "whole packs a thread");
  const int tid = threadIdx.x;
  float4 r4[kPacks];
#pragma unroll
  for (int k = 0; k < kPacks; ++k) {
    const int i = tid + k * kThreads, r = i % kBQ, d4 = i / kBQ;
    r4[k] = r < nrows ? load4(q + r * pitch + 4 * d4) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int k = 0; k < kPacks; ++k) {
    const int i = tid + k * kThreads, r = i % kBQ, d4 = i / kBQ;
    qt[(4 * d4) * kBQ + r] = r4[k].x;
    qt[(4 * d4 + 1) * kBQ + r] = r4[k].y;
    qt[(4 * d4 + 2) * kBQ + r] = r4[k].z;
    qt[(4 * d4 + 3) * kBQ + r] = r4[k].w;
  }
}

// The 128-lane tile's score micro-tile, in the rescale's own mapping:
// s[i][k] = q_(8 tr + i) . k_(tc + kCG k), summed over d < DL in order by
// fmaf from 0.f.  `qt` is Q^T (f32, pitch kBQ) from row 8 tr, kr[k] the
// staged K row of key tc + kCG k.  Per 4 lanes of d a thread makes 8
// 16-byte loads of Q^T (the warp's two row groups: one bank wavefront
// each) and kSC of K (16 keys on a pitch of 16 bytes over a multiple of
// 128: two wavefronts, the least for 256 bytes) for 8 kSC x 4 FMAs: 12
// loads for 128 FMAs at kSC = 4.  The scores stay in registers: no trip
// through the p tile.
template <typename L, int DL, typename T>
__device__ __forceinline__ void tile_scores(float (&s)[8][L::kSC], const float* qt,
                                            const T* (&kr)[L::kSC]) {
  constexpr int kSC = L::kSC, kBQ = L::kBQ;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int k = 0; k < kSC; ++k) s[i][k] = 0.f;
#pragma unroll 8
  for (int d = 0; d < DL; d += 4) {
    float4 kv[kSC];
#pragma unroll
    for (int k = 0; k < kSC; ++k) kv[k] = load4(kr[k] + d);
#pragma unroll
    for (int dd = 0; dd < 4; ++dd) {
      const float4 qa = reinterpret_cast<const float4*>(qt + (d + dd) * kBQ)[0];
      const float4 qb = reinterpret_cast<const float4*>(qt + (d + dd) * kBQ)[1];
      const float qv[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
#pragma unroll
      for (int k = 0; k < kSC; ++k) {
        const float kd = dd == 0 ? kv[k].x : dd == 1 ? kv[k].y : dd == 2 ? kv[k].z : kv[k].w;
#pragma unroll
        for (int i = 0; i < 8; ++i) s[i][k] = fmaf(qv[i], kd, s[i][k]);
      }
    }
  }
}

// The wide tile's score micro-tile: s[i][k] += q_(rq + 16 i) . k_(kq + 16 k)
// over the NL lanes from qr[i] and kr[k] (staged rows of Q and K), in
// order by fmaf (a warp 8 row sets x 4 key sets: per 4 lanes of d, 8
// 16-byte loads for 64 FMAs, each load one bank wavefront).
template <int NL, typename T>
__device__ __forceinline__ void wide_scores(float (&s)[4][4], const T* (&qr)[4],
                                            const T* (&kr)[4]) {
#pragma unroll 2
  for (int d = 0; d < NL; d += 4) {
    float4 qv[4], kv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) qv[i] = load4(qr[i] + d);
#pragma unroll
    for (int k = 0; k < 4; ++k) kv[k] = load4(kr[k] + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        s[i][k] = fmaf(qv[i].x, kv[k].x, s[i][k]);
        s[i][k] = fmaf(qv[i].y, kv[k].y, s[i][k]);
        s[i][k] = fmaf(qv[i].z, kv[k].z, s[i][k]);
        s[i][k] = fmaf(qv[i].w, kv[k].w, s[i][k]);
      }
  }
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

// Whether every query row row_min .. row_max sees every one of the 64 keys
// from key kv0 (none past the causal diagonal, before the window, or
// padding): the rescale then needs no mask, and gives the masked path's
// bits (its keep is true for every score).
__device__ __forceinline__ bool unmasked(int64_t kv0, int kvalid, int64_t row_min,
                                         int64_t row_max, const Mask& mk) {
  return kvalid == kBK && kv0 + kBK <= mk.sk &&
         (!mk.causal || kv0 + kBK - 1 <= row_min) &&
         (mk.window < 0 || kv0 > row_max - mk.window);
}

// Move `w` to the first sub-tile from here that some row of row_min ..
// row_max sees.
__device__ __forceinline__ void seek(KvWalk& w, const SsrGrid& g,
                                     const SsrStream& sk, const Mask& mk,
                                     int64_t row_min, int64_t row_max) {
  while (!w.done() && masked_out(w.kv0(sk), w.kvalid(), row_min, row_max, mk))
    w.next(g);
}

// A kv walk kept lean: the grid step z of the CTA's run and the key offset
// j0 in its block.  Where the run moves one grid axis (the host checks
// it: kv_walk_is_linear), a block's first row and origin are linear in z.
struct LeanWalk {
  int z = 0, j0 = 0;
};

// The CTA's run of zsteps kv steps from step0 as a line: the K stream's
// block row and the K and V blocks' origins at z = 0 and their steps.
struct KvLine {
  int64_t row, drow, ok, dok, ov, dov;
  __device__ __forceinline__ KvLine(const SsrGrid& g, int64_t step0, int64_t zsteps,
                                    const SsrStream& sk, const SsrStream& sv) {
    const SsrOdometer o0(g, step0), o1(g, step0 + (zsteps > 1 ? 1 : 0));
    row = block_row(o0, sk);
    drow = block_row(o1, sk) - row;
    ok = o0.origin(sk);
    dok = o1.origin(sk) - ok;
    ov = o0.origin(sv);
    dov = o1.origin(sv) - ov;
  }
  __device__ __forceinline__ int64_t kv0(const LeanWalk& w) const {
    return row + w.z * drow + w.j0;
  }
};

// Whether a run of zsteps kv steps from any multiple of zsteps moves one
// grid axis at most (the trailing axes it covers, all of size 1 but one):
// true of every geometry the wrapper takes (one contraction axis, which a
// StreamGeometry puts last); the launches refuse any other.
__host__ inline bool kv_walk_is_linear(const SsrGrid* g, int64_t zsteps) {
  int64_t prod = 1;
  int moving = 0;
  for (int a = g->ndim - 1; a >= 0 && prod < zsteps; --a) {
    prod *= g->dims[a];
    moving += g->dims[a] > 1;
  }
  return prod == zsteps && moving <= 1;
}

__device__ __forceinline__ int lean_kvalid(const LeanWalk& w, int64_t blk) {
  return static_cast<int>(blk - w.j0 < kBK ? blk - w.j0 : kBK);
}

// Move `w` to the first sub-tile from here that some row of row_min ..
// row_max sees (lean_next: one sub-tile on first).
__device__ __forceinline__ void lean_seek(LeanWalk& w, const KvLine& line,
                                          int64_t zsteps, int64_t blk, const Mask& mk,
                                          int64_t row_min, int64_t row_max) {
  while (w.z < zsteps &&
         masked_out(line.kv0(w), lean_kvalid(w, blk), row_min, row_max, mk)) {
    w.j0 += kBK;
    if (w.j0 >= blk) {
      w.j0 = 0;
      ++w.z;
    }
  }
}
__device__ __forceinline__ void lean_next(LeanWalk& w, const KvLine& line,
                                          int64_t zsteps, int64_t blk, const Mask& mk,
                                          int64_t row_min, int64_t row_max) {
  w.j0 += kBK;
  if (w.j0 >= blk) {
    w.j0 = 0;
    ++w.z;
  }
  lean_seek(w, line, zsteps, blk, mk, row_min, row_max);
}

// One sub-tile's rescale: the raw scores s (rows 8 tr + i, keys tc + kCG k
// of the sub-tile from key kv0) scaled and masked (-1e30, never -inf), the
// row maxima and sums over the column group by shuffles, m and l updated,
// acc rescaled by alpha = exp(m - m'), and p = exp(s - m') written to pt
// (transposed: key-major, kPPitch apart) for the p v products.  expf is the
// accurate one.  kMasked = false skips the mask where `unmasked` holds.
template <typename L, int NA, bool kMasked = true>
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
      const bool keep = !kMasked || (c < kvalid && col < mk.sk &&
                                     (!mk.causal || col <= row) &&
                                     (mk.window < 0 || col > row - mk.window));
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

// Lane j of a thread's NA acc lanes: NA consecutive from NA tc, or (kSplit
// > 0, NA = 8) four from 4 tc and four from kSplit + 4 tc, so that a
// warp's 16-byte loads of a V row cover 256 contiguous bytes (two bank
// wavefronts) instead of 16 runs of 32 bytes (four).
template <int NA, int kSplit>
__device__ __forceinline__ int acc_lane(int tc, int j) {
  static_assert(kSplit == 0 || NA == 8, "a split of two runs of 4");
  return kSplit == 0 ? NA * tc + j : j < 4 ? 4 * tc + j : kSplit + 4 * tc + j - 4;
}

// acc += p v over N consecutive keys in order: p from pt (key-major, the
// first key's row at pt), v from staged rows `ld` elements apart (the
// first key's row at vs), the thread's NA lanes (acc_lane); the key loop
// unrolled kUnroll times.
template <typename L, int N, int kSplit = 0, int kUnroll = 4, typename V, int NA>
__device__ __forceinline__ void accumulate_pv(float (&acc)[8][NA], const float* pt,
                                              const V* vs, int ld, int tr, int tc) {
#pragma unroll (kUnroll)
  for (int c = 0; c < N; ++c) {
    const float4 pa = reinterpret_cast<const float4*>(pt + c * L::kPPitch)[2 * tr];
    const float4 pb = reinterpret_cast<const float4*>(pt + c * L::kPPitch)[2 * tr + 1];
    const float pv[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
    float vv[NA];
    if constexpr (kSplit == 0) {
      load_lanes(vs + c * ld + NA * tc, vv);
    } else {
      const float4 a = load4(vs + c * ld + 4 * tc);
      const float4 b = load4(vs + c * ld + kSplit + 4 * tc);
      vv[0] = a.x; vv[1] = a.y; vv[2] = a.z; vv[3] = a.w;
      vv[4] = b.x; vv[5] = b.y; vv[6] = b.z; vv[7] = b.w;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < NA; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
  }
}

// The drain: acc / max(l, 1e-30), cast to the output dtype, for the
// thread's rows below `nrows` and its NA lanes (acc_lane).
template <int kSplit = 0, typename O, int NA>
__device__ __forceinline__ void drain(const float (&acc)[8][NA], const float (&l)[8],
                                      O* out, int64_t pitch, int nrows, int tr,
                                      int tc) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = 8 * tr + i;
    if (r >= nrows) break;
    const float lmax = fmaxf(l[i], 1e-30f);
    O* dst = out + r * pitch;
#pragma unroll
    for (int j = 0; j < NA; ++j)
      dst[acc_lane<NA, kSplit>(tc, j)] = ssr_cast<O>(acc[i][j] / lmax);
  }
}

// The lanes of O from DL to `lanes` (a head dim's padding): 0.
template <typename O>
__device__ __forceinline__ void zero_lanes(O* out, int64_t pitch, int nrows,
                                           int DL, int lanes) {
  const int pad = lanes - DL;
  for (int i = threadIdx.x; i < nrows * pad; i += kThreads)
    out[(i / pad) * pitch + DL + i % pad] = ssr_cast<O>(0.f);
}

// The 128-lane tile's CTA, K11's and R12's: kBQ = 128 query rows of one
// lowered Q block of one head on the live lanes DL, the kv walk in 64-key
// sub-tiles, heavy CTAs first.  Q^T is staged once in f32 (rows fastest
// over the threads); K's and V's sub-tiles arrive by cp.async, every
// thread copying, into kd and vd buffers of 64 keys (K rows on a pitch of
// KP elements, V rows of VP): K11 keeps one of each, R12 pairs of its
// 32-key ring units.  K sub-tile s + kd is copied once sub-tile s's scores
// are done, V sub-tile s + vd - 1 once sub-tile s - 1's p v is; the copies
// before the loop follow the same pattern for sub-tiles -P .. -1 (P =
// max(kd, vd - 1)), so every sub-tile finds its K 2 kd - 2 groups and its
// V 2 vd - 2 groups before the newest.  Two barriers a sub-tile: the
// first shows its K (and, the first time, Q^T) and frees V's oldest
// buffer and the p tile; the second shows its V and every p and frees its
// K buffer.  Each thread computes its 8 x 4 raw scores in the rescale's
// mapping (tile_scores), the rescale skips the mask where every row sees
// every key, and acc adds p v over its DL / 16 lanes.
template <int DL, int KP, int VP, typename T, typename O>
__device__ __forceinline__ void narrow_cta(
    const T* __restrict__ kp, const T* __restrict__ vp, const T* __restrict__ qp,
    O* __restrict__ op, const SsrGrid& g, const SsrStream& sk, const SsrStream& sv,
    const SsrStream& sq, const SsrStream& so, int64_t zsteps, int64_t qsub,
    int64_t nblocks, int64_t hk, int64_t hv, int64_t hq, int64_t ho, const Mask& mk,
    float* qt, float* pt, T* kbuf, T* vbuf, int kd, int vd) {
  using L = Tiles<128, 128>;
  constexpr int kBQ = L::kBQ, kCG = L::kColGroups, kSC = L::kSC;
  constexpr int kNA = DL / kCG;                      // acc lanes a thread
  constexpr int kSplit = kNA == 8 ? DL / 2 : 0;      // acc_lane's runs
  constexpr int kPvUnroll = 8;                       // p v's key loop
  static_assert(kNA == 6 || kNA == 8, "96 or 128 live lanes");

  const int64_t p = nblocks - 1 - static_cast<int64_t>(blockIdx.x) / qsub;
  const int64_t qsb = static_cast<int64_t>(blockIdx.x) % qsub;
  const int64_t head = blockIdx.y;
  kp += head * hk;
  vp += head * hv;
  qp += head * hq;
  op += head * ho;

  const int tid = threadIdx.x;
  const int tr = tid / kCG;    // rows 8 tr .. 8 tr + 7
  const int tc = tid % kCG;    // keys tc + kCG k; acc lanes acc_lane(tc, ..)
  const int64_t step0 = p * zsteps, blk = sk.block[0];
  const int64_t qr0 = qsb * kBQ;
  const int nrows = static_cast<int>(sq.block[0] - qr0 < kBQ ? sq.block[0] - qr0 : kBQ);
  const SsrOdometer odo(g, step0);
  const int64_t row0 = block_row(odo, sq) + qr0 + mk.off_rc;  // row 0's index
  const int64_t row_min = row0, row_max = row0 + nrows - 1;
  const T* const q = qp + odo.origin(sq) + qr0 * sq.pitch;
  O* const out = op + odo.origin(so) + qr0 * so.pitch;
  const KvLine line(g, step0, zsteps, sk, sv);

  LeanWalk w;                  // the sub-tile computed
  lean_seek(w, line, zsteps, blk, mk, row_min, row_max);
  LeanWalk wk = w, wv = w;     // the next K and V sub-tiles to copy
  int kput = 0, vput = 0, kget = 0, vget = 0;
  auto copy_k = [&]() {
    if (wk.z < zsteps) {
      copy_rows<kBK, DL>(kbuf + kput * kBK * KP, KP,
                         kp + line.ok + wk.z * line.dok + wk.j0 * sk.pitch, sk.pitch,
                         lean_kvalid(wk, blk));
      kput = kput + 1 == kd ? 0 : kput + 1;
      lean_next(wk, line, zsteps, blk, mk, row_min, row_max);
    }
    ssr_cp_async_commit();
  };
  auto copy_v = [&]() {
    if (wv.z < zsteps) {
      copy_rows<kBK, DL>(vbuf + vput * kBK * VP, VP,
                         vp + line.ov + wv.z * line.dov + wv.j0 * sv.pitch, sv.pitch,
                         lean_kvalid(wv, blk));
      vput = vput + 1 == vd ? 0 : vput + 1;
      lean_next(wv, line, zsteps, blk, mk, row_min, row_max);
    }
    ssr_cp_async_commit();
  };
  const int prime = kd > vd - 1 ? kd : vd - 1;
  for (int v = -prime; v < 0; ++v) {
    if (v >= 1 - vd)
      copy_v();
    else
      ssr_cp_async_commit();
    if (v >= -kd)
      copy_k();
    else
      ssr_cp_async_commit();
  }
  stage_qt<DL, kBQ>(qt, q, sq.pitch, nrows);

  float m[8], l[8], acc[8][kNA];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = kFill;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kNA; ++j) acc[i][j] = 0.f;
  }

  while (w.z < zsteps) {
    const int64_t kv0 = line.kv0(w);
    const int kvalid = lean_kvalid(w, blk);
    ssr_ring_wait(2 * kd - 2);         // this sub-tile's K landed
    __syncthreads();                   // and is seen; V's oldest and p are free
    copy_v();
    const T* const kb = kbuf + kget * kBK * KP;
    const T* kr[kSC];
#pragma unroll
    for (int k = 0; k < kSC; ++k) kr[k] = kb + (tc + kCG * k) * KP;
    float s[8][kSC];
    tile_scores<L, DL>(s, qt + 8 * tr, kr);
    if (unmasked(kv0, kvalid, row_min, row_max, mk))
      rescale<L, kNA, false>(s, m, l, acc, pt, row0, tr, tc, kv0, kvalid, mk);
    else
      rescale<L>(s, m, l, acc, pt, row0, tr, tc, kv0, kvalid, mk);
    ssr_ring_wait(2 * vd - 2);         // this sub-tile's V landed
    __syncthreads();                   // V and every p are seen; K's is free
    copy_k();
    accumulate_pv<L, kBK, kSplit, kPvUnroll>(acc, pt, vbuf + vget * kBK * VP, VP, tr, tc);
    kget = kget + 1 == kd ? 0 : kget + 1;
    vget = vget + 1 == vd ? 0 : vget + 1;
    lean_next(w, line, zsteps, blk, mk, row_min, row_max);
  }
  ssr_cp_async_wait<0>();

  drain<kSplit>(acc, l, out, so.pitch, nrows, tr, tc);
  zero_lanes(out, so.pitch, nrows, DL, static_cast<int>(so.block[1]));
}

}  // namespace attention
