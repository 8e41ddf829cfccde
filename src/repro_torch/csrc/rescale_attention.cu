// K11 rescale_attention: the online-softmax (flash) accumulator of one
// attention layer, out = softmax(q k^T scale + mask) v, for a batch of heads.
//
// Replaces the TPU kernel repro/core/ssr.py:ssr_pallas (sync emitter) with
// the online-softmax branch of repro/core/lowering.py:_build_nest_kernel
// (the m/l/acc recurrence) and the score body repro/kernels/attention.py:
// _body (scale, then the causal, sliding-window and padded-column masks
// filled with -1e30).  For Sq = Sk = 4096, D = 128 the default lowering
// gives grid (16, 1, 16) over (q, d, kv), kv `arbitrary`, blocks Q, K, V
// and O (256, 128).
//
// Bound on H100: operations.  Each unmasked (query, key) pair costs 2 D FMAs
// (the score and its share of p v); Q, K, V and O move once.
//
// Design: the TPU walks the kv axis as sequential grid steps and carries
// (m, l, acc) in VMEM scratch.  Here the kv axis is a loop inside the CTA:
// a CTA owns kBQ query rows of one lowered Q block (grid.x) of one head
// (grid.y), keeps m and l in registers (replicated over the column group of
// a row) and acc in registers, and walks the lowered kv blocks in grid
// order in sub-tiles of 64 keys.  Per sub-tile each thread computes raw
// scores in FP32 FMA (no TF32: the reference asks for f32), then the
// rescale masks them, updates m and l with warp shuffles over its row
// group, rescales acc by alpha = exp(m - m') and writes p to the p tile,
// and acc adds p v.  expf is the accurate one (no fast math).  m starts at
// -1e30 and masked scores are -1e30, never -inf: a row whose first keys are
// all masked adds p = 1 garbage that alpha = exp(-1e30 - m) = 0 removes
// exactly once it meets a visible key, where -inf would give NaN.  A
// sub-tile masked for every row of the CTA (past the causal diagonal,
// before the window, or padding) is skipped, in the copies too: the result
// is the same to float error.  Heavy CTAs (late query blocks under the
// causal mask) are launched first.  K and V arrive by cp.async ahead of
// their use; the lanes past the live lanes DL are neither staged nor
// summed, and the drain writes 0 there.
//
// Tiles by head dim.  The lowered lanes tile kD pads the head dim D to a
// multiple of 128; the wrapper passes D itself too:
//   * D <= 128 (80 arrives zero-padded to 128): kBQ = 128 query rows on
//     the live lanes DL = 96 (D <= 96) or 128, the CTA narrow_cta
//     (ssr_attention.cuh), which R12 runs on its ring.  Q^T is staged once
//     a CTA in f32 (rows fastest over the threads), K row-major on a pitch
//     of DL + 16 bytes (a warp's 16 keys: two bank wavefronts a 16-byte
//     load), V on DL, in two buffers each: K sub-tile s + 2 is copied in
//     once sub-tile s's scores are done, V sub-tile s + 1 once sub-tile s
//     - 1's p v is.  Each thread computes its 8 x 4 raw scores in the
//     rescale's own mapping (rows 8 tr + i, keys tc + 16 k; tile_scores:
//     per 4 lanes of d, 12 16-byte loads for 128 FMAs), so no score passes
//     through the p tile, and the rescale skips the mask on a sub-tile
//     every row sees whole.  acc holds DL / 16 lanes a thread: 6
//     consecutive at DL = 96 (load6, one wavefront a load), 8 at 128 in
//     two runs of 4 (acc_lane: a warp's V loads cover 256 contiguous
//     bytes).  Two barriers a sub-tile: the first shows this sub-tile's K
//     (and, the first time, Q^T) and frees V's older buffer and the p
//     tile; the second shows V and every p and frees K's buffer.  Shared
//     memory in f32: 232,448 bytes at DL = 128 (all a CTA may opt into),
//     183,296 at 96; one CTA of 8 warps an SM;
//   * 128 < D <= 256 (192 arrives zero-padded to 256): the wide kernel on
//     the live lanes DL = 192 (D <= 192) or 256, kBQ = 64.  Q, K and V
//     arrive by cp.async, Q's and K's rows on a pitch of DL + 16 bytes
//     (rows 4 apart hit distinct banks), V's of DL.  Each thread computes
//     4 x 4 raw scores (wide_scores: rows rq + 16 i, keys kq + 16 k, a
//     warp 8 row sets x 4 key sets: per 4 lanes of d, 8 16-byte loads for
//     64 FMAs), q . k over d in order from 0.f, into the p tile; then the
//     rescale reads them back in the 256-lane mapping (8 rows x 2 keys a
//     thread, 32 column groups), so each row's sum of p runs in its order,
//     and acc holds DL / 32 lanes a thread (6 or 8).  K for the next
//     sub-tile is copied in while this one is rescaled and summed into
//     acc, V while the next one's scores are computed.  Shared memory at
//     DL = 192 in f32: 166,912 bytes; at 256: 216,064, within the 227 KiB
//     a CTA can opt into; one CTA of 8 warps an SM.
// Other lanes tiles are refused.  The copies, the score micro-tiles, the
// mask, the rescale, the p v products and the drain are ssr_attention.cuh,
// which R12 ring_rescale_attention runs too: K11's bits.
#include "ssr_attention.cuh"

namespace {

using namespace attention;

// The 128-lane tile on its live lanes DL, with Tiles128's rescale.
template <int DL>
struct Narrow {
  using L = Tiles128;
  static constexpr int kBQ = L::kBQ;
  static constexpr int kBuffers = 2;                 // of K and of V
  // f32 staging (bf16 takes less of the same layout): Q^T, p, K, V
  static constexpr int64_t kSmemBytes =
      4 * (int64_t{DL} * kBQ + int64_t{kBK} * L::kPPitch +
           kBuffers * (int64_t{kBK} * (DL + 4) + int64_t{kBK} * DL));
};

template <int DL, typename T, typename O>
__global__ void __launch_bounds__(kThreads, 1)
    rescale_attention_kernel(const T* __restrict__ kp, const T* __restrict__ vp,
                             const T* __restrict__ qp, O* __restrict__ op,
                             SsrGrid g, SsrStream sk, SsrStream sv,
                             SsrStream sq, SsrStream so, int64_t zsteps,
                             int64_t qsub, int64_t nblocks, int64_t hk,
                             int64_t hv, int64_t hq, int64_t ho, Mask mk) {
  using N = Narrow<DL>;
  constexpr int KP = DL + 16 / static_cast<int>(sizeof(T));   // K's pitch
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* const qt = reinterpret_cast<float*>(smem_raw);      // [DL][kBQ]
  float* const pt = qt + DL * N::kBQ;                        // [kBK][kPPitch]
  T* const ks = reinterpret_cast<T*>(pt + kBK * N::L::kPPitch);   // 2 x [kBK][KP]
  T* const vs = ks + N::kBuffers * kBK * KP;                 // 2 x [kBK][DL]
  narrow_cta<DL, KP, DL>(kp, vp, qp, op, g, sk, sv, sq, so, zsteps, qsub, nblocks,
                         hk, hv, hq, ho, mk, qt, pt, ks, vs, N::kBuffers, N::kBuffers);
}

// The wide tiles: kBQ = 64 query rows on the live lanes DL of a 256-lane
// layout, with Tiles256's rescale (its mapping fixes the sums' order).
template <int DL>
struct Wide {
  using L = Tiles256;
  static constexpr int kBQ = L::kBQ;
  static constexpr int kNA = DL / L::kColGroups;      // acc lanes a thread
  static_assert(kNA == 6 || kNA == 8, "192 or 256 live lanes");
  // f32 staging (bf16 takes less of the same layout): Q, K, V, p
  static constexpr int64_t kSmemBytes =
      4 * (int64_t{kBQ} * (DL + 4) + int64_t{kBK} * (DL + 4) + int64_t{kBK} * DL +
           int64_t{kBK} * L::kPPitch);
};

template <int DL, typename T, typename O>
__global__ void __launch_bounds__(kThreads, 1)
    wide_attention_kernel(const T* __restrict__ kp, const T* __restrict__ vp,
                          const T* __restrict__ qp, O* __restrict__ op,
                          SsrGrid g, SsrStream sk, SsrStream sv, SsrStream sq,
                          SsrStream so, int64_t zsteps, int64_t qsub,
                          int64_t nblocks, int64_t hk, int64_t hv, int64_t hq,
                          int64_t ho, Mask mk) {
  using W = Wide<DL>;
  using L = typename W::L;
  constexpr int kBQ = W::kBQ, kNA = W::kNA, kPP = L::kPPitch;
  constexpr int P = DL + 16 / static_cast<int>(sizeof(T));   // Q's, K's pitch
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const qs = reinterpret_cast<T*>(smem_raw);     // [kBQ][P]
  T* const ks = qs + kBQ * P;                       // [kBK][P]
  T* const vs = ks + kBK * P;                       // [kBK][DL]
  float* const pt = reinterpret_cast<float*>(vs + kBK * DL);   // [kBK][kPP]

  const int64_t p = nblocks - 1 - static_cast<int64_t>(blockIdx.x) / qsub;
  const int64_t qsb = static_cast<int64_t>(blockIdx.x) % qsub;
  const int64_t head = blockIdx.y;
  kp += head * hk;
  vp += head * hv;
  qp += head * hq;
  op += head * ho;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tr = tid / L::kColGroups, tc = tid % L::kColGroups;   // rescale
  const int rq = (warp >> 2) * 8 + (lane & 7);    // score rows rq + 16 i
  const int kq = (warp & 3) * 4 + (lane >> 3);    // score keys kq + 16 k
  const SsrOdometer odo(g, p * zsteps);
  const int64_t qr0 = qsb * kBQ;
  const int nrows = static_cast<int>(sq.block[0] - qr0 < kBQ ? sq.block[0] - qr0 : kBQ);
  const int64_t row0 = block_row(odo, sq) + qr0 + mk.off_rc;  // row 0's index
  const int64_t row_min = row0, row_max = row0 + nrows - 1;
  O* const out = op + odo.origin(so) + qr0 * so.pitch;

  KvWalk w(g, p * zsteps, zsteps, sk.block[0]);
  seek(w, g, sk, mk, row_min, row_max);
  // group 1: Q and the first K; group 2: the first V
  copy_rows<kBQ, DL>(qs, P, qp + odo.origin(sq) + qr0 * sq.pitch, sq.pitch, nrows);
  if (!w.done())
    copy_rows<kBK, DL>(ks, P, kp + w.odo.origin(sk) + w.j0 * sk.pitch, sk.pitch,
                       w.kvalid());
  ssr_cp_async_commit();
  if (!w.done())
    copy_rows<kBK, DL>(vs, DL, vp + w.odo.origin(sv) + w.j0 * sv.pitch, sv.pitch,
                       w.kvalid());
  ssr_cp_async_commit();

  float m[8], l[8], acc[8][kNA];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = kFill;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kNA; ++j) acc[i][j] = 0.f;
  }
  const T* qr[4];
  const T* kr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    qr[i] = qs + (rq + 16 * i) * P;
    kr[i] = ks + (kq + 16 * i) * P;
  }

  while (!w.done()) {
    const int64_t kv0 = w.kv0(sk);
    const int kvalid = w.kvalid();
    ssr_cp_async_wait<1>();            // this sub-tile's K (and Q) landed
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) s[i][k] = 0.f;
    wide_scores<DL>(s, qr, kr);
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int i = 0; i < 4; ++i) pt[(kq + 16 * k) * kPP + rq + 16 * i] = s[i][k];
    __syncthreads();                   // the scores are in; K is free
    KvWalk wn = w;
    wn.next(g);
    seek(wn, g, sk, mk, row_min, row_max);
    if (!wn.done())
      copy_rows<kBK, DL>(ks, P, kp + wn.odo.origin(sk) + wn.j0 * sk.pitch,
                         sk.pitch, wn.kvalid());
    ssr_cp_async_commit();
    float sc[8][L::kSC];
#pragma unroll
    for (int k = 0; k < L::kSC; ++k) {
      const float4* src = reinterpret_cast<const float4*>(
          pt + (tc + L::kColGroups * k) * kPP + 8 * tr);
      const float4 a = src[0], b = src[1];
      sc[0][k] = a.x; sc[1][k] = a.y; sc[2][k] = a.z; sc[3][k] = a.w;
      sc[4][k] = b.x; sc[5][k] = b.y; sc[6][k] = b.z; sc[7][k] = b.w;
    }
    rescale<L>(sc, m, l, acc, pt, row0, tr, tc, kv0, kvalid, mk);
    ssr_cp_async_wait<1>();            // this sub-tile's V landed
    __syncthreads();                   // and every p
    accumulate_pv<L, kBK>(acc, pt, vs, DL, tr, tc);
    __syncthreads();                   // V and p are free
    if (!wn.done())
      copy_rows<kBK, DL>(vs, DL, vp + wn.odo.origin(sv) + wn.j0 * sv.pitch,
                         sv.pitch, wn.kvalid());
    ssr_cp_async_commit();
    w = wn;
  }
  ssr_cp_async_wait<0>();

  drain(acc, l, out, so.pitch, nrows, tr, tc);
  zero_lanes(out, so.pitch, nrows, DL, static_cast<int>(so.block[1]));
}

template <int DL, typename T, typename O>
int launch_wide(const void* k, const void* v, const void* q, void* o,
                const SsrGrid* g, const SsrStream* sk, const SsrStream* sv,
                const SsrStream* sq, const SsrStream* so, int64_t zsteps,
                int64_t heads, const int64_t* strides, const Mask& mk,
                cudaStream_t st) {
  const size_t smem = static_cast<size_t>(Wide<DL>::kSmemBytes);
  auto kernel = wide_attention_kernel<DL, T, O>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int64_t steps = 1;
  for (int a = 0; a < g->ndim; ++a) steps *= g->dims[a];
  const int64_t nblocks = steps / zsteps;
  const int64_t qsub = (sq->block[0] + Wide<DL>::kBQ - 1) / Wide<DL>::kBQ;
  if (nblocks * qsub >= (int64_t{1} << 31) || heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(nblocks * qsub), static_cast<unsigned>(heads));
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(q),
      static_cast<O*>(o), *g, *sk, *sv, *sq, *so, zsteps, qsub, nblocks,
      strides[0], strides[1], strides[2], strides[3], mk);
  return static_cast<int>(cudaGetLastError());
}

template <int DL, typename T, typename O>
int launch_tiles(const void* k, const void* v, const void* q, void* o,
                 const SsrGrid* g, const SsrStream* sk, const SsrStream* sv,
                 const SsrStream* sq, const SsrStream* so, int64_t zsteps,
                 int64_t heads, const int64_t* strides, const Mask& mk,
                 cudaStream_t st) {
  const size_t smem = static_cast<size_t>(Narrow<DL>::kSmemBytes);
  if (!kv_walk_is_linear(g, zsteps)) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = rescale_attention_kernel<DL, T, O>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int64_t steps = 1;
  for (int a = 0; a < g->ndim; ++a) steps *= g->dims[a];
  const int64_t nblocks = steps / zsteps;
  const int64_t qsub = (sq->block[0] + Narrow<DL>::kBQ - 1) / Narrow<DL>::kBQ;
  if (nblocks * qsub >= (int64_t{1} << 31) || heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(nblocks * qsub), static_cast<unsigned>(heads));
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(q),
      static_cast<O*>(o), *g, *sk, *sv, *sq, *so, zsteps, qsub, nblocks,
      strides[0], strides[1], strides[2], strides[3], mk);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation of the lanes tile (the blocks' width, 128 or 256) and
// the head dim D: the 128-lane tile on 96 or 128 live lanes, or the wide
// kernel on 192 or 256.
template <typename T, typename O>
int launch(const void* k, const void* v, const void* q, void* o,
           const SsrGrid* g, const SsrStream* sk, const SsrStream* sv,
           const SsrStream* sq, const SsrStream* so, int64_t zsteps,
           int64_t heads, const int64_t* strides, const Mask& mk, int64_t dim,
           cudaStream_t st) {
  const int64_t lanes = sq->block[1];
  if (dim < 1 || dim > lanes) return static_cast<int>(cudaErrorInvalidValue);
  if (lanes == Tiles128::kD && dim <= 96)
    return launch_tiles<96, T, O>(k, v, q, o, g, sk, sv, sq, so, zsteps, heads,
                                  strides, mk, st);
  if (lanes == Tiles128::kD)
    return launch_tiles<128, T, O>(k, v, q, o, g, sk, sv, sq, so, zsteps, heads,
                                   strides, mk, st);
  if (lanes == Tiles256::kD && dim <= 192)
    return launch_wide<192, T, O>(k, v, q, o, g, sk, sv, sq, so, zsteps, heads,
                                  strides, mk, st);
  if (lanes == Tiles256::kD)
    return launch_wide<256, T, O>(k, v, q, o, g, sk, sv, sq, so, zsteps, heads,
                                  strides, mk, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// K, V (Sk_pad, lanes), Q (Sq_pad, lanes) and O, 128 or 256 lanes holding
// a head dim of `dim` (the lanes past it zero), each `heads` times at the
// element strides in `strides` (K, V, Q, O); the walks `sk`, `sv`, `sq`,
// `so` of one head; `zsteps` the kv grid steps (the trailing axis).
// `window` < 0 means no sliding window.
extern "C" int ssr_rescale_attention(const void* k, const void* v,
                                     const void* q, void* o, int in_dtype,
                                     int out_dtype, const SsrGrid* g,
                                     const SsrStream* sk, const SsrStream* sv,
                                     const SsrStream* sq, const SsrStream* so,
                                     int64_t zsteps, int64_t heads,
                                     const int64_t* strides, float scale,
                                     int causal, int64_t window,
                                     int64_t off_rc, int64_t sk_len,
                                     int64_t dim, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Mask mk{scale, causal, window, off_rc, sk_len};
  if (in_dtype == SSR_F32 && out_dtype == SSR_F32)
    return launch<float, float>(k, v, q, o, g, sk, sv, sq, so, zsteps, heads, strides, mk, dim, st);
  if (in_dtype == SSR_BF16 && out_dtype == SSR_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(k, v, q, o, g, sk, sv, sq, so, zsteps, heads,
                                                 strides, mk, dim, st);
  if (in_dtype == SSR_BF16 && out_dtype == SSR_F32)
    return launch<__nv_bfloat16, float>(k, v, q, o, g, sk, sv, sq, so, zsteps, heads, strides,
                                        mk, dim, st);
  if (in_dtype == SSR_F32 && out_dtype == SSR_BF16)
    return launch<float, __nv_bfloat16>(k, v, q, o, g, sk, sv, sq, so, zsteps, heads, strides,
                                        mk, dim, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Shared memory of one CTA for a lanes tile of `lanes` (the head dim padded
// to a multiple of 128) holding a head dim of `dim`: the 128-row tile's on
// 96 live lanes (dim <= 96) or 128, up to 128 lanes; above, the wide
// kernel's on 192 live lanes (dim <= 192) or 256; counted in f32.
extern "C" int64_t ssr_rescale_attention_smem_bytes(int64_t lanes, int64_t dim) {
  if (lanes <= Tiles128::kD)
    return dim <= 96 ? Narrow<96>::kSmemBytes : Narrow<128>::kSmemBytes;
  return dim <= 192 ? Wide<192>::kSmemBytes : Wide<256>::kSmemBytes;
}

// Registers a thread and local bytes (the most over the four dtype pairs'
// instantiations) of the tile that `lanes` and `dim` take, and the f32
// kernel's CTAs an SM at its shared memory: out[0], out[1], out[2].
static int tile_attributes(const void* const (&kernels)[4], int64_t smem,
                           int64_t* out) {
  out[0] = out[1] = out[2] = 0;
  for (const void* k : kernels) {
    cudaFuncAttributes fa;
    cudaError_t err = cudaFuncGetAttributes(&fa, k);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (fa.numRegs > out[0]) out[0] = fa.numRegs;
    if (static_cast<int64_t>(fa.localSizeBytes) > out[1])
      out[1] = static_cast<int64_t>(fa.localSizeBytes);
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernels[0], cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  int ctas = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernels[0], kThreads,
                                                        smem);
  out[2] = ctas;
  return static_cast<int>(err);
}

#define SSR_K(...) reinterpret_cast<const void*>(__VA_ARGS__)

extern "C" int ssr_rescale_attention_attributes(int64_t* out, int64_t lanes,
                                                int64_t dim) {
  const int64_t smem = ssr_rescale_attention_smem_bytes(lanes, dim);
  using BF = __nv_bfloat16;
  if (lanes <= Tiles128::kD && dim <= 96) {
    const void* const ks[4] = {SSR_K(rescale_attention_kernel<96, float, float>),
                               SSR_K(rescale_attention_kernel<96, BF, BF>),
                               SSR_K(rescale_attention_kernel<96, BF, float>),
                               SSR_K(rescale_attention_kernel<96, float, BF>)};
    return tile_attributes(ks, smem, out);
  }
  if (lanes <= Tiles128::kD) {
    const void* const ks[4] = {SSR_K(rescale_attention_kernel<128, float, float>),
                               SSR_K(rescale_attention_kernel<128, BF, BF>),
                               SSR_K(rescale_attention_kernel<128, BF, float>),
                               SSR_K(rescale_attention_kernel<128, float, BF>)};
    return tile_attributes(ks, smem, out);
  }
  if (dim <= 192) {
    const void* const ks[4] = {SSR_K(wide_attention_kernel<192, float, float>),
                               SSR_K(wide_attention_kernel<192, BF, BF>),
                               SSR_K(wide_attention_kernel<192, BF, float>),
                               SSR_K(wide_attention_kernel<192, float, BF>)};
    return tile_attributes(ks, smem, out);
  }
  const void* const ks[4] = {SSR_K(wide_attention_kernel<256, float, float>),
                             SSR_K(wide_attention_kernel<256, BF, BF>),
                             SSR_K(wide_attention_kernel<256, BF, float>),
                             SSR_K(wide_attention_kernel<256, float, BF>)};
  return tile_attributes(ks, smem, out);
}
