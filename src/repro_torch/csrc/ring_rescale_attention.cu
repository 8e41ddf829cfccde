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
// of sub-tiles masked for every row, its live lanes DL (96 or 128 on the
// 128-lane tile, 192 or 256 on the 256-lane one; the lanes past DL neither
// copied nor summed, the drain writing 0 there) and its arithmetic
// (ssr_attention.cuh): per sub-tile the raw scores by K11's micro-tile,
// one rescale of m, l and acc, then p v.  What changes is delivery.  A
// lowered kv block (256 x 128 f32, 128 KiB a stream) cannot be a slot, nor
// can K11's 64-key sub-tile beside Q and p at depth 4.  So K and V each
// get a ring of their own depth (the schedule's depths of the K and V
// streams; Q is staged once a CTA, as in K11) in units of a part of a
// sub-tile, copied by cp.async, walking the sub-tiles as the compute
// does, masked ones skipped.
//   * 128 lanes (kBQ 128): a unit is 32 keys, a K slot on a pitch of 128
//     + 16 bytes, a V slot of 128.  Two neighbouring slots are one of
//     K11's 64-key buffers, so R12 runs K11's CTA itself (narrow_cta in
//     ssr_attention.cuh) on depth / 2 K buffers and depth / 2 V buffers
//     (an odd depth's last slot stays unused): every thread copies, K
//     sub-tile s + kd once sub-tile s's scores are done, V sub-tile s +
//     vd - 1 once sub-tile s - 1's p v is, two barriers a sub-tile, K11's
//     8 x 4 scores in the rescale's mapping.  Q^T in f32 on a pitch of
//     kBQ.  At depth 4 in f32: Q^T 65,536 bytes, p 33,792, K 67,584, V
//     65,536: 232,448, all a CTA may opt into (bf16 takes half the ring's
//     bytes); deeper is refused in f32.
//   * 256 lanes (kBQ 64): a K unit is the sub-tile's 64 keys on lanes 64 u
//     .. 64 u + 63 (a slot on a pitch of 64 + 16 bytes), DL / 64 units a
//     sub-tile; a V unit 16 keys of every lane.  Each unit is consumed
//     alone under ssr_ring.cuh's discipline (wait on this thread's copy of
//     the unit, one barrier, which publishes it and frees the unit before
//     it, then the copy into the freed slot; depth - 1 units primed),
//     warps 0-3 copying K, warps 4-7 V.  The
//     K units carry the wide tile's 4 x 4 scores (wide_scores) over their
//     lanes in order, so each score sums d in K11's order; the scores pass
//     through the p tile into the rescale's mapping, as in K11.  Q's rows
//     on a pitch of 256 + 16 bytes, copied by the K half before its first
//     unit.  At depth 4 in f32: 219,136 bytes; depth 5 and above refused.
// So a sub-tile's rescale covers K11's 64 keys, its sums run in K11's
// order, and R12 gives K11's bits at every depth.
#include "ssr_attention.cuh"

namespace {

using namespace attention;

// R12's tiles for a lanes tile D: K11's Tiles<D, BQ> (its rescale's
// mapping), a K unit of KK keys x KL lanes, a V unit of VK keys x D lanes.
template <int D, int BQ, int KK, int KL, int VK>
struct RingTiles {
  using L = Tiles<D, BQ>;
  static constexpr bool kWide = D == 256;
  static constexpr int kKK = KK, kKL = KL, kVK = VK;
  static constexpr int kUV = kBK / VK;              // V units a sub-tile
  static_assert(kBK % KK == 0 && kBK % VK == 0, "whole units a sub-tile");
  static_assert(kWide || (KK == VK && KL == D && 2 * KK == kBK),
                "128 lanes: K and V units alike, two a 64-key buffer");
};
using Ring128 = RingTiles<128, 128, 32, 128, 32>;
using Ring256 = RingTiles<256, 64, 64, 64, 16>;

// R's dynamic shared memory for input T: Q (Q^T in f32 on 128 lanes; rows
// on a pitch of D + 16 bytes of T on 256), the p tile, and at depths dk,
// dv the K slots (KK rows on a pitch of KL + 16 bytes) and V slots (VK
// rows of D).
template <typename R, typename T>
struct RingLayout {
  using L = typename R::L;
  static constexpr int kElems = 16 / static_cast<int>(sizeof(T));
  static constexpr int kQP = L::kD + kElems;        // Q's pitch (256 lanes)
  static constexpr int kKP = R::kKL + kElems;       // a K slot's pitch
  static constexpr int64_t kQ = R::kWide
      ? int64_t{L::kBQ} * kQP * static_cast<int64_t>(sizeof(T))
      : int64_t{L::kD} * L::kBQ * 4;
  static constexpr int64_t kP = 4 * int64_t{kBK} * L::kPPitch;
  static constexpr int64_t kKSlot = int64_t{R::kKK} * kKP * static_cast<int64_t>(sizeof(T));
  static constexpr int64_t kVSlot = int64_t{R::kVK} * L::kD * static_cast<int64_t>(sizeof(T));
  static int64_t bytes(int64_t dk, int64_t dv) {
    return kQ + kP + dk * kKSlot + dv * kVSlot;
  }
};

// The 256-lane tile's CTA through the ring: each unit consumed alone, K's
// lane quarters carrying the wide tile's 4 x 4 scores, V's 16-key units
// p v; warps 0-3 copy K (and Q, first), warps 4-7 V.
template <typename R, int DL, typename T, typename O>
__device__ __forceinline__ void wide_ring_cta(
    const T* __restrict__ kp, const T* __restrict__ vp, const T* __restrict__ qp,
    O* __restrict__ op, const SsrGrid& g, const SsrStream& sk, const SsrStream& sv,
    const SsrStream& sq, const SsrStream& so, int64_t zsteps, int64_t qsub,
    int64_t nblocks, int64_t hk, int64_t hv, int64_t hq, int64_t ho, const Mask& mk,
    T* qs, float* pt, T* kring, T* vring, int dk, int dv) {
  using L = typename R::L;
  using Y = RingLayout<R, T>;
  constexpr int kD = L::kD, kBQ = L::kBQ, kCG = L::kColGroups, kSC = L::kSC;
  constexpr int kPP = L::kPPitch, KK = R::kKK, KL = R::kKL, VK = R::kVK;
  constexpr int KP = Y::kKP, QP = Y::kQP;
  constexpr int kNA = DL / kCG;                     // acc lanes a thread
  constexpr int kUK = DL / KL;                      // K units a sub-tile
  constexpr int kUV = R::kUV;                       // V units a sub-tile
  constexpr int kHalf = kThreads / 2;
  static_assert(kNA == 6 || kNA == 8, "a thread's acc lanes");

  const int64_t p = nblocks - 1 - static_cast<int64_t>(blockIdx.x) / qsub;
  const int64_t qsb = static_cast<int64_t>(blockIdx.x) % qsub;
  const int64_t head = blockIdx.y;
  kp += head * hk;
  vp += head * hv;
  qp += head * hq;
  op += head * ho;

  const int tid = threadIdx.x, warp = tid >> 5;
  const int tr = tid / kCG, tc = tid % kCG;            // the rescale's mapping
  const int rq = (warp >> 2) * 8 + (tid & 7);          // the scores' rows rq
  const int kq = (warp & 3) * 4 + ((tid & 31) >> 3);   // + 16 i, keys kq + 16 k
  const SsrOdometer odo(g, p * zsteps);
  const int64_t qr0 = qsb * kBQ;
  const int nrows = static_cast<int>(sq.block[0] - qr0 < kBQ ? sq.block[0] - qr0 : kBQ);
  const int64_t row0 = block_row(odo, sq) + qr0 + mk.off_rc;  // row 0's index
  const int64_t row_min = row0, row_max = row0 + nrows - 1;
  O* const out = op + odo.origin(so) + qr0 * so.pitch;

  // the fetching halves: warps 0-3 copy K units, warps 4-7 V units, each
  // into its ring, walking the sub-tiles as the compute does
  const bool fetch_k = tid < kHalf;
  const int lane = fetch_k ? tid : tid - kHalf;
  const int depth = fetch_k ? dk : dv;
  const T* const fbase = fetch_k ? kp : vp;
  const int64_t fpitch = fetch_k ? sk.pitch : sv.pitch;
  KvWalk fw(g, p * zsteps, zsteps, sk.block[0]);
  seek(fw, g, sk, mk, row_min, row_max);
  int fu = 0, put = 0;
  auto issue = [&]() {
    if (!fw.done()) {
      // (each stream's walk read whole: a select between the two structs
      // would copy both to local memory)
      const T* block = fbase + (fetch_k ? fw.odo.origin(sk) : fw.odo.origin(sv));
      if (fetch_k) {                   // the sub-tile's keys, lanes KL fu ..
        copy_rows<KK, KL>(kring + put * KK * KP, KP, block + fw.j0 * fpitch + KL * fu,
                          fpitch, fw.kvalid(), lane, kHalf);
      } else {                         // VK keys from VK fu, every live lane
        const int valid0 = fw.kvalid() - fu * VK;
        const int valid = valid0 < 0 ? 0 : valid0 < VK ? valid0 : VK;
        copy_rows<VK, DL>(vring + put * VK * kD, kD, block + (fw.j0 + fu * VK) * fpitch,
                          fpitch, valid, lane, kHalf);
      }
      if (++fu == (fetch_k ? kUK : kUV)) {
        fu = 0;
        fw.next(g);
        seek(fw, g, sk, mk, row_min, row_max);
      }
    }
    put = put + 1 == depth ? 0 : put + 1;
    ssr_cp_async_commit();
  };
  // Q by the K half, older than its every unit; depth - 1 units primed
  if (fetch_k)
    copy_rows<kBQ, DL>(qs, QP, qp + odo.origin(sq) + qr0 * sq.pitch, sq.pitch, nrows,
                       lane, kHalf);
  ssr_cp_async_commit();
  for (int s = 1; s < depth; ++s) issue();

  float m[8], l[8], acc[8][kNA];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = kFill;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kNA; ++j) acc[i][j] = 0.f;
  }

  KvWalk w(g, p * zsteps, zsteps, sk.block[0]);
  seek(w, g, sk, mk, row_min, row_max);
  int kget = 0, vget = 0;
  while (!w.done()) {
    float s4[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) s4[i][k] = 0.f;
#pragma unroll 1
    for (int u = 0; u < kUK; ++u) {    // the K units: lanes KL u .. in order
      if (fetch_k) ssr_ring_wait(dk - 2);
      __syncthreads();                 // K unit u is in; the last is free
      if (fetch_k) issue();
      const T* const slot = kring + kget * KK * KP;
      const T* qr[4];
      const T* kr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qr[i] = qs + (rq + 16 * i) * QP + KL * u;
        kr[i] = slot + (kq + 16 * i) * KP;
      }
      wide_scores<KL>(s4, qr, kr);
      kget = kget + 1 == dk ? 0 : kget + 1;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int i = 0; i < 4; ++i) pt[(kq + 16 * k) * kPP + rq + 16 * i] = s4[i][k];
    __syncthreads();                   // every score of the sub-tile
    float s[8][kSC];
#pragma unroll
    for (int k = 0; k < kSC; ++k) {
      const float4* src = reinterpret_cast<const float4*>(pt + (tc + kCG * k) * kPP + 8 * tr);
      const float4 a = src[0], b = src[1];
      s[0][k] = a.x; s[1][k] = a.y; s[2][k] = a.z; s[3][k] = a.w;
      s[4][k] = b.x; s[5][k] = b.y; s[6][k] = b.z; s[7][k] = b.w;
    }
    const int64_t kv0 = w.kv0(sk);
    const int kvalid = w.kvalid();
    if (unmasked(kv0, kvalid, row_min, row_max, mk))
      rescale<L, kNA, false>(s, m, l, acc, pt, row0, tr, tc, kv0, kvalid, mk);
    else
      rescale<L>(s, m, l, acc, pt, row0, tr, tc, kv0, kvalid, mk);
#pragma unroll 1
    for (int u = 0; u < kUV; ++u) {    // the V units
      if (!fetch_k) ssr_ring_wait(dv - 2);
      __syncthreads();                 // V unit u (and every p) is in
      if (!fetch_k) issue();
      accumulate_pv<L, VK, 0, 8>(acc, pt + u * VK * kPP, vring + vget * VK * kD, kD, tr, tc);
      vget = vget + 1 == dv ? 0 : vget + 1;
    }
    w.next(g);
    seek(w, g, sk, mk, row_min, row_max);
  }
  ssr_cp_async_wait<0>();

  drain(acc, l, out, so.pitch, nrows, tr, tc);
  zero_lanes(out, so.pitch, nrows, DL, kD);
}

template <typename R, int DL, typename T, typename O>
__global__ void __launch_bounds__(kThreads, 1)
    ring_rescale_attention_kernel(const T* __restrict__ kp, const T* __restrict__ vp,
                                  const T* __restrict__ qp, O* __restrict__ op,
                                  SsrGrid g, SsrStream sk, SsrStream sv,
                                  SsrStream sq, SsrStream so, int64_t zsteps,
                                  int64_t qsub, int64_t nblocks, int64_t hk,
                                  int64_t hv, int64_t hq, int64_t ho, Mask mk,
                                  int dk, int dv) {
  using L = typename R::L;
  using Y = RingLayout<R, T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* const pt = reinterpret_cast<float*>(smem_raw + Y::kQ);   // [kBK][kPPitch]
  T* const kring = reinterpret_cast<T*>(pt + kBK * L::kPPitch);   // dk x [KK][KP]
  T* const vring = kring + dk * R::kKK * Y::kKP;                   // dv x [VK][kD]
  if constexpr (R::kWide)
    wide_ring_cta<R, DL>(kp, vp, qp, op, g, sk, sv, sq, so, zsteps, qsub, nblocks, hk,
                         hv, hq, ho, mk, reinterpret_cast<T*>(smem_raw), pt, kring,
                         vring, dk, dv);
  else   // K11's CTA, a buffer a pair of units: Q^T [kD][kBQ] first
    narrow_cta<DL, Y::kKP, L::kD>(kp, vp, qp, op, g, sk, sv, sq, so, zsteps, qsub,
                                  nblocks, hk, hv, hq, ho, mk,
                                  reinterpret_cast<float*>(smem_raw), pt, kring, vring,
                                  dk / 2, dv / 2);
}

template <typename R, int DL, typename T, typename O>
int launch_tiles(const void* k, const void* v, const void* q, void* o,
                 const SsrGrid* g, const SsrStream* sk, const SsrStream* sv,
                 const SsrStream* sq, const SsrStream* so, int64_t zsteps,
                 int64_t heads, const int64_t* strides, const Mask& mk,
                 const SsrRing* ring, int64_t smem, cudaStream_t st) {
  using L = typename R::L;
  const int64_t dk = ring->depth[0], dv = ring->depth[1];
  if (dk < 2 || dk > 8 || dv < 2 || dv > 8 ||
      smem != RingLayout<R, T>::bytes(dk, dv) ||
      (!R::kWide && !kv_walk_is_linear(g, zsteps)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = ring_rescale_attention_kernel<R, DL, T, O>;
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

// The lanes tile (128 or 256) and K11's live lanes of the head dim `dim`.
template <typename T, typename O>
int launch(const void* k, const void* v, const void* q, void* o,
           const SsrGrid* g, const SsrStream* sk, const SsrStream* sv,
           const SsrStream* sq, const SsrStream* so, int64_t zsteps,
           int64_t heads, const int64_t* strides, const Mask& mk,
           const SsrRing* ring, int64_t smem, int64_t dim, cudaStream_t st) {
  const int64_t lanes = sq->block[1];
  if (dim < 1 || dim > lanes) return static_cast<int>(cudaErrorInvalidValue);
  if (lanes == Ring128::L::kD && dim <= 96)
    return launch_tiles<Ring128, 96, T, O>(k, v, q, o, g, sk, sv, sq, so, zsteps, heads,
                                           strides, mk, ring, smem, st);
  if (lanes == Ring128::L::kD)
    return launch_tiles<Ring128, 128, T, O>(k, v, q, o, g, sk, sv, sq, so, zsteps, heads,
                                            strides, mk, ring, smem, st);
  if (lanes == Ring256::L::kD && dim <= 192)
    return launch_tiles<Ring256, 192, T, O>(k, v, q, o, g, sk, sv, sq, so, zsteps, heads,
                                            strides, mk, ring, smem, st);
  if (lanes == Ring256::L::kD)
    return launch_tiles<Ring256, 256, T, O>(k, v, q, o, g, sk, sv, sq, so, zsteps, heads,
                                            strides, mk, ring, smem, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// As ssr_rescale_attention, plus the ring: K at `ring->depth[0]` and V at
// `ring->depth[1]` units (Q's entry is not read: Q is staged once a CTA)
// and `smem_bytes`, the dynamic shared memory as the wrapper counted it
// (Q, the p tile and the two rings), checked here; `dim` the head dim,
// whose live lanes R12 copies and sums.  Every K and V row and block must
// allow 16-byte copies (the wrapper checked).
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
                                          int64_t smem_bytes, int64_t dim,
                                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Mask mk{scale, causal, window, off_rc, sk_len};
  if (in_dtype == SSR_F32 && out_dtype == SSR_F32)
    return launch<float, float>(k, v, q, o, g, sk, sv, sq, so, zsteps, heads, strides,
                                mk, ring, smem_bytes, dim, st);
  if (in_dtype == SSR_BF16 && out_dtype == SSR_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(k, v, q, o, g, sk, sv, sq, so, zsteps,
                                                 heads, strides, mk, ring, smem_bytes, dim, st);
  if (in_dtype == SSR_BF16 && out_dtype == SSR_F32)
    return launch<__nv_bfloat16, float>(k, v, q, o, g, sk, sv, sq, so, zsteps, heads,
                                        strides, mk, ring, smem_bytes, dim, st);
  if (in_dtype == SSR_F32 && out_dtype == SSR_BF16)
    return launch<float, __nv_bfloat16>(k, v, q, o, g, sk, sv, sq, so, zsteps, heads,
                                        strides, mk, ring, smem_bytes, dim, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int64_t ssr_ring_rescale_attention_smem_bytes() { return 0; }

#define SSR_K(...) reinterpret_cast<const void*>(__VA_ARGS__)

// Registers a thread and local bytes, the most over every instantiation
// (the two lanes tiles on their two live widths, the four dtype pairs):
// out[0], out[1]; out[2] is 0.
extern "C" int ssr_ring_rescale_attention_attributes(int64_t* out) {
  using BF = __nv_bfloat16;
  const void* const ks[] = {
      SSR_K(ring_rescale_attention_kernel<Ring128, 96, float, float>),
      SSR_K(ring_rescale_attention_kernel<Ring128, 96, BF, BF>),
      SSR_K(ring_rescale_attention_kernel<Ring128, 96, BF, float>),
      SSR_K(ring_rescale_attention_kernel<Ring128, 96, float, BF>),
      SSR_K(ring_rescale_attention_kernel<Ring128, 128, float, float>),
      SSR_K(ring_rescale_attention_kernel<Ring128, 128, BF, BF>),
      SSR_K(ring_rescale_attention_kernel<Ring128, 128, BF, float>),
      SSR_K(ring_rescale_attention_kernel<Ring128, 128, float, BF>),
      SSR_K(ring_rescale_attention_kernel<Ring256, 192, float, float>),
      SSR_K(ring_rescale_attention_kernel<Ring256, 192, BF, BF>),
      SSR_K(ring_rescale_attention_kernel<Ring256, 192, BF, float>),
      SSR_K(ring_rescale_attention_kernel<Ring256, 192, float, BF>),
      SSR_K(ring_rescale_attention_kernel<Ring256, 256, float, float>),
      SSR_K(ring_rescale_attention_kernel<Ring256, 256, BF, BF>),
      SSR_K(ring_rescale_attention_kernel<Ring256, 256, BF, float>),
      SSR_K(ring_rescale_attention_kernel<Ring256, 256, float, BF>)};
  out[0] = out[1] = out[2] = 0;
  for (const void* k : ks) {
    cudaFuncAttributes fa;
    cudaError_t err = cudaFuncGetAttributes(&fa, k);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (fa.numRegs > out[0]) out[0] = fa.numRegs;
    if (static_cast<int64_t>(fa.localSizeBytes) > out[1])
      out[1] = static_cast<int64_t>(fa.localSizeBytes);
  }
  return 0;
}
