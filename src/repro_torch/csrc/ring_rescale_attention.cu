// R12 ring_rescale_attention: K11's online-softmax accumulator over a head
// batch, its K/V walk delivered through an N-deep shared-memory ring.
//
// Replaces the TPU kernel repro/core/ssr.py:_pipelined_call (the N-deep
// rotation that ssr_pallas emits at buffer_depth > 2) around the
// online-softmax branch of repro/core/lowering.py:_build_nest_kernel (the
// m/l/acc recurrence, :1457-1509) and the score body
// repro/kernels/attention.py:_body.
//
// Bound on H100: operations, as K11.
//
// Design: K11's CTAs (kBQ query rows of one lowered Q block of one head,
// heavy CTAs first), its walk of the kv axis in 64-key sub-tiles, its skip
// of sub-tiles masked for every row, and its arithmetic (ssr_attention.cuh):
// per sub-tile the raw scores, one rescale of m, l and acc, then p v.  What
// changes is delivery.  A lowered kv block (256 x 128 f32, 128 KiB a
// stream) cannot be a slot, nor can K11's 64-key sub-tile: Q (64 KiB) and
// p (33 KiB) leave room for one K+V level of 64 keys, not two.  So the
// ring's unit is a part of a sub-tile: KU = 32 keys at D = 128, 16 at
// D = 256 (kBQ 64), a K slot KU rows on a pitch of D + 16 bytes, a V slot
// KU rows of D, K and V each a ring of its own depth (the schedule's
// depths of the K and V streams; Q is staged once a CTA, as in K11).  The
// walk of units is the walk of sub-tiles, masked ones skipped, in the
// prefetch as in the compute; warps 0-3 fetch K, warps 4-7 V, each
// depth - 1 units ahead (ssr_ring.cuh's discipline: wait on this thread's
// copy of the unit, one barrier, which publishes it and frees the unit
// before it, then the fetch into the freed slot).  Per sub-tile:
//   * each K unit in turn: every thread computes a 8 x 2 (D = 128) or
//     4 x 1 (D = 256) block of the unit's raw scores, q . k summed over d
//     in order in FP32 FMA from zero -- K11's sums, by another thread --
//     and writes them to the p tile;
//   * one barrier, then K11's rescale on its own rows and keys of the
//     tile, the score read back and p written in its place;
//   * each V unit in turn: acc += p v over the unit's keys, in key order.
// So a sub-tile's rescale covers K11's 64 keys, its sums run in K11's
// order, and R12 gives K11's bits at every depth.  Shared memory: Q^T on a
// pitch of kBQ (its staging writes conflict-free), p on kBQ + 4, the two
// rings; at D = 128 f32 depth 4 is 232,448 bytes, all a CTA may opt into,
// and deeper is refused (at D = 256, depth 5 and above).
#include "ssr_attention.cuh"
#include "ssr_ring.cuh"

namespace {

using namespace attention;

// The ring's tiles for a lanes tile: K11's Tiles<D, BQ> (its rescale's
// mapping), KU keys a unit, a thread's block of scores RS rows x KS keys.
template <int D, int BQ, int KU, int RS, int KS>
struct RingTiles {
  using L = Tiles<D, BQ>;
  static constexpr int kKU = KU;
  static constexpr int kUnits = kBK / KU;        // units a sub-tile
  static constexpr int kRS = RS, kKS = KS;
  static constexpr int kKG = KU / KS;            // key groups of the scores
  static constexpr int kRG = BQ / RS;            // row groups of the scores
  static_assert(kKG * kRG == kThreads, "a score block a thread");
  static_assert(RS % 4 == 0 && kBK % KU == 0, "whole packs and units");
};
using Ring128 = RingTiles<128, 128, 32, 8, 2>;
using Ring256 = RingTiles<256, 64, 16, 4, 1>;

// A staged K row's pitch: D elements and 16 bytes.
template <typename T, int D>
struct KPitch {
  static constexpr int value = D + 16 / static_cast<int>(sizeof(T));
};

// One unit's raw scores into the p tile: rows RS rg .., keys kg + kKG k of
// the unit, each q . k over d in order, fmaf from zero.
template <typename R, typename T>
__device__ __forceinline__ void unit_scores(const float* qt, const T* ks,
                                            float* pt, int kg, int rg) {
  using L = typename R::L;
  constexpr int kD = L::kD, kBQ = L::kBQ, RS = R::kRS, KS = R::kKS;
  constexpr int KP = KPitch<T, kD>::value;
  float sc[RS][KS];
#pragma unroll
  for (int i = 0; i < RS; ++i)
#pragma unroll
    for (int k = 0; k < KS; ++k) sc[i][k] = 0.f;
#pragma unroll 2
  for (int d4 = 0; d4 < kD / 4; ++d4) {
    float4 kk[KS];
#pragma unroll
    for (int k = 0; k < KS; ++k) kk[k] = load4(ks + (kg + R::kKG * k) * KP + 4 * d4);
#pragma unroll
    for (int dd = 0; dd < 4; ++dd) {
      const float4* qrow = reinterpret_cast<const float4*>(qt + (4 * d4 + dd) * kBQ + RS * rg);
      float qv[RS];
#pragma unroll
      for (int h = 0; h < RS / 4; ++h) {
        const float4 q4 = qrow[h];
        qv[4 * h] = q4.x; qv[4 * h + 1] = q4.y; qv[4 * h + 2] = q4.z; qv[4 * h + 3] = q4.w;
      }
#pragma unroll
      for (int k = 0; k < KS; ++k) {
        const float kd = dd == 0 ? kk[k].x : dd == 1 ? kk[k].y : dd == 2 ? kk[k].z : kk[k].w;
#pragma unroll
        for (int i = 0; i < RS; ++i) sc[i][k] = fmaf(qv[i], kd, sc[i][k]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    float4* dst = reinterpret_cast<float4*>(pt + (kg + R::kKG * k) * L::kPPitch + RS * rg);
#pragma unroll
    for (int h = 0; h < RS / 4; ++h)
      dst[h] = make_float4(sc[4 * h][k], sc[4 * h + 1][k], sc[4 * h + 2][k], sc[4 * h + 3][k]);
  }
}

template <typename R, typename T, typename O>
__global__ void __launch_bounds__(kThreads, 1)
    ring_rescale_attention_kernel(const T* __restrict__ kp, const T* __restrict__ vp,
                                  const T* __restrict__ qp, O* __restrict__ op,
                                  SsrGrid g, SsrStream sk, SsrStream sv,
                                  SsrStream sq, SsrStream so, int64_t zsteps,
                                  int64_t qsub, int64_t nblocks, int64_t hk,
                                  int64_t hv, int64_t hq, int64_t ho, Mask mk,
                                  int dk, int dv) {
  using L = typename R::L;
  constexpr int kD = L::kD, kBQ = L::kBQ, kCG = L::kColGroups, kSC = L::kSC;
  constexpr int kPP = L::kPPitch, KU = R::kKU, kU = R::kUnits;
  constexpr int KP = KPitch<T, kD>::value;
  constexpr int kPacks = kD * static_cast<int>(sizeof(T)) / 16;   // a row's
  constexpr int kElems = 16 / static_cast<int>(sizeof(T));        // a pack's
  constexpr int kHalf = kThreads / 2;
  extern __shared__ __align__(16) float smem[];
  float* const qt = smem;                        // [kD][kBQ]: Q transposed
  float* const pt = qt + kD * kBQ;               // [kBK][kPP]: scores, then p
  T* const kring = reinterpret_cast<T*>(pt + kBK * kPP);   // dk x [KU][KP]
  T* const vring = kring + dk * KU * KP;                    // dv x [KU][kD]

  const int64_t p = nblocks - 1 - static_cast<int64_t>(blockIdx.x) / qsub;
  const int64_t qs = static_cast<int64_t>(blockIdx.x) % qsub;
  const int64_t head = blockIdx.y;
  kp += head * hk;
  vp += head * hv;
  qp += head * hq;
  op += head * ho;

  const int tid = threadIdx.x;
  const int tr = tid / kCG, tc = tid % kCG;          // the rescale's mapping
  const int kg = tid % R::kKG, rg = tid / R::kKG;    // the scores' mapping
  const SsrOdometer odo(g, p * zsteps);
  const int64_t qr0 = qs * kBQ;
  const int nrows = static_cast<int>(sq.block[0] - qr0 < kBQ ? sq.block[0] - qr0 : kBQ);
  const int64_t row0 = block_row(odo, sq) + qr0 + mk.off_rc;  // row 0's index
  const int64_t row_min = row0, row_max = row0 + nrows - 1;
  const T* q = qp + odo.origin(sq) + qr0 * sq.pitch;
  O* out = op + odo.origin(so) + qr0 * so.pitch;

  // the fetching half of the CTA: warps 0-3 fetch K, warps 4-7 V, each a
  // unit at a time into its ring, walking the sub-tiles as the compute does
  const bool fetch_k = tid < kHalf;
  const int lane = fetch_k ? tid : tid - kHalf;
  const int depth = fetch_k ? dk : dv;
  const T* const fbase = fetch_k ? kp : vp;
  const int64_t fpitch = fetch_k ? sk.pitch : sv.pitch;
  T* const fring = fetch_k ? kring : vring;
  const int fld = fetch_k ? KP : kD;
  KvWalk fw(g, p * zsteps, zsteps, sk.block[0]);
  seek(fw, g, sk, mk, row_min, row_max);
  int fu = 0, put = 0;
  auto issue = [&]() {
    if (!fw.done()) {
      const int valid0 = fw.kvalid() - fu * KU;
      const int valid = valid0 < 0 ? 0 : valid0 < KU ? valid0 : KU;
      // (each stream's walk read whole: a select between the two structs
      // would copy both to local memory)
      const T* block = fbase + (fetch_k ? fw.odo.origin(sk) : fw.odo.origin(sv));
      const T* src = block + (fw.j0 + fu * KU) * fpitch;
      T* dst = fring + put * KU * fld;
      for (int i = lane; i < KU * kPacks; i += kHalf) {
        const int r = i / kPacks, c = (i - r * kPacks) * kElems;
        const bool in = r < valid;     // rows past the block's keys: zeros
        ssr_ring_cp16(dst + r * fld + c, in ? src + r * fpitch + c : block, in);
      }
      if (++fu == kU) {
        fu = 0;
        fw.next(g);
        seek(fw, g, sk, mk, row_min, row_max);
      }
    }
    put = put + 1 == depth ? 0 : put + 1;
    ssr_cp_async_commit();
  };
  for (int s = 0; s < depth - 1; ++s) issue();

  // stage Q transposed, rows fastest over the threads: every load issued
  // before any store
  {
    float4 r4[L::kQPacks];
#pragma unroll
    for (int k = 0; k < L::kQPacks; ++k) {
      const int i = tid + k * kThreads, r = i % kBQ, d4 = i / kBQ;
      r4[k] = r < nrows ? load4(q + r * sq.pitch + 4 * d4) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int k = 0; k < L::kQPacks; ++k) {
      const int i = tid + k * kThreads, r = i % kBQ, d4 = i / kBQ;
      qt[(4 * d4) * kBQ + r] = r4[k].x;
      qt[(4 * d4 + 1) * kBQ + r] = r4[k].y;
      qt[(4 * d4 + 2) * kBQ + r] = r4[k].z;
      qt[(4 * d4 + 3) * kBQ + r] = r4[k].w;
    }
  }

  float m[8], l[8], acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = kFill;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  KvWalk w(g, p * zsteps, zsteps, sk.block[0]);
  seek(w, g, sk, mk, row_min, row_max);
  int kget = 0, vget = 0;
  while (!w.done()) {
#pragma unroll 1
    for (int u = 0; u < kU; ++u) {       // the sub-tile's K units
      if (fetch_k) ssr_ring_wait(dk - 2);
      __syncthreads();                   // K unit u is in; the last is free
      if (fetch_k) issue();
      unit_scores<R>(qt, kring + kget * KU * KP, pt + u * KU * kPP, kg, rg);
      kget = kget + 1 == dk ? 0 : kget + 1;
    }
    __syncthreads();                     // every score of the sub-tile
    float s[8][kSC];
#pragma unroll
    for (int k = 0; k < kSC; ++k) {
      const float4* src = reinterpret_cast<const float4*>(pt + (tc + kCG * k) * kPP + 8 * tr);
      const float4 a = src[0], b = src[1];
      s[0][k] = a.x; s[1][k] = a.y; s[2][k] = a.z; s[3][k] = a.w;
      s[4][k] = b.x; s[5][k] = b.y; s[6][k] = b.z; s[7][k] = b.w;
    }
    rescale<L>(s, m, l, acc, pt, row0, tr, tc, w.kv0(sk), w.kvalid(), mk);
#pragma unroll 1
    for (int u = 0; u < kU; ++u) {       // the sub-tile's V units
      if (!fetch_k) ssr_ring_wait(dv - 2);
      __syncthreads();                   // V unit u (and every p) is in
      if (!fetch_k) issue();
      accumulate_pv<L, KU>(acc, pt + u * KU * kPP, vring + vget * KU * kD, kD, tr, tc);
      vget = vget + 1 == dv ? 0 : vget + 1;
    }
    w.next(g);
    seek(w, g, sk, mk, row_min, row_max);
  }

  drain(acc, l, out, so.pitch, nrows, tr, tc);
  ssr_cp_async_wait<0>();
}

// Dynamic shared memory of R for input T at K and V depths dk, dv.
template <typename R, typename T>
int64_t layout_bytes(int64_t dk, int64_t dv) {
  using L = typename R::L;
  constexpr int64_t kD = L::kD;
  return static_cast<int64_t>(sizeof(float)) * (kD * L::kBQ + kBK * L::kPPitch) +
         static_cast<int64_t>(sizeof(T)) * R::kKU *
             (dk * KPitch<T, L::kD>::value + dv * kD);
}

template <typename R, typename T, typename O>
int launch_tiles(const void* k, const void* v, const void* q, void* o,
                 const SsrGrid* g, const SsrStream* sk, const SsrStream* sv,
                 const SsrStream* sq, const SsrStream* so, int64_t zsteps,
                 int64_t heads, const int64_t* strides, const Mask& mk,
                 const SsrRing* ring, int64_t smem, cudaStream_t st) {
  using L = typename R::L;
  const int64_t dk = ring->depth[0], dv = ring->depth[1];
  if (dk < 2 || dk > 8 || dv < 2 || dv > 8 ||
      smem != layout_bytes<R, T>(dk, dv))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = ring_rescale_attention_kernel<R, T, O>;
  cudaError_t err = ssr_ring_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int64_t steps = 1;
  for (int a = 0; a < g->ndim; ++a) steps *= g->dims[a];
  const int64_t nblocks = steps / zsteps;
  const int64_t qsub = (sq->block[0] + L::kBQ - 1) / L::kBQ;
  if (nblocks * qsub >= (int64_t{1} << 31) || heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(nblocks * qsub), static_cast<unsigned>(heads));
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(q),
      static_cast<O*>(o), *g, *sk, *sv, *sq, *so, zsteps, qsub, nblocks,
      strides[0], strides[1], strides[2], strides[3], mk, static_cast<int>(dk),
      static_cast<int>(dv));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename O>
int launch(const void* k, const void* v, const void* q, void* o,
           const SsrGrid* g, const SsrStream* sk, const SsrStream* sv,
           const SsrStream* sq, const SsrStream* so, int64_t zsteps,
           int64_t heads, const int64_t* strides, const Mask& mk,
           const SsrRing* ring, int64_t smem, cudaStream_t st) {
  if (sq->block[1] == Ring128::L::kD)
    return launch_tiles<Ring128, T, O>(k, v, q, o, g, sk, sv, sq, so, zsteps, heads,
                                       strides, mk, ring, smem, st);
  if (sq->block[1] == Ring256::L::kD)
    return launch_tiles<Ring256, T, O>(k, v, q, o, g, sk, sv, sq, so, zsteps, heads,
                                       strides, mk, ring, smem, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// As ssr_rescale_attention, plus the ring: K at `ring->depth[0]` and V at
// `ring->depth[1]` units (Q's entry is not read: Q is staged once a CTA)
// and `smem_bytes`, the dynamic shared memory as the wrapper counted it
// (Q^T, the p tile and the two rings), checked here.  Every K and V row
// and block must allow 16-byte copies (the wrapper checked).
extern "C" int ssr_ring_rescale_attention(const void* k, const void* v,
                                          const void* q, void* o, int in_dtype,
                                          int out_dtype, const SsrGrid* g,
                                          const SsrStream* sk,
                                          const SsrStream* sv,
                                          const SsrStream* sq,
                                          const SsrStream* so, int64_t zsteps,
                                          int64_t heads, const int64_t* strides,
                                          float scale, int causal,
                                          int64_t window, int64_t off_rc,
                                          int64_t sk_len, const SsrRing* ring,
                                          int64_t smem_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Mask mk{scale, causal, window, off_rc, sk_len};
  if (in_dtype == SSR_F32 && out_dtype == SSR_F32)
    return launch<float, float>(k, v, q, o, g, sk, sv, sq, so, zsteps, heads, strides,
                                mk, ring, smem_bytes, st);
  if (in_dtype == SSR_BF16 && out_dtype == SSR_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(k, v, q, o, g, sk, sv, sq, so, zsteps,
                                                 heads, strides, mk, ring, smem_bytes, st);
  if (in_dtype == SSR_BF16 && out_dtype == SSR_F32)
    return launch<__nv_bfloat16, float>(k, v, q, o, g, sk, sv, sq, so, zsteps, heads,
                                        strides, mk, ring, smem_bytes, st);
  if (in_dtype == SSR_F32 && out_dtype == SSR_BF16)
    return launch<float, __nv_bfloat16>(k, v, q, o, g, sk, sv, sq, so, zsteps, heads,
                                        strides, mk, ring, smem_bytes, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int64_t ssr_ring_rescale_attention_smem_bytes() { return 0; }
