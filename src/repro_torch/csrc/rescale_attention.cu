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
// a row) and acc -- 8 rows x 8 lanes a thread -- in registers, and walks
// the lowered kv blocks in grid order in sub-tiles of 64 keys.  Per
// sub-tile: K (transposed) and V are staged in shared memory, a thread's
// loads of a chunk of 8 packs issued before the stores of the chunk (the
// first chunk's before the barrier that precedes them); each thread
// computes an 8-row score micro-tile in FP32 FMA (no TF32: the reference
// asks for f32), masks it, updates m and l with warp shuffles over its row
// group, rescales acc by alpha = exp(m - m') and adds p v, with p passed
// through shared memory.  expf is the accurate one (no fast math).  m starts
// at -1e30 and masked scores are -1e30, never -inf: a row whose first keys
// are all masked adds p = 1 garbage that alpha = exp(-1e30 - m) = 0 removes
// exactly once it meets a visible key, where -inf would give NaN.  A
// sub-tile masked for every row of the CTA (past the causal diagonal,
// before the window, or padding) is skipped: the result is the same to
// float error.  Heavy CTAs (late query blocks under the causal mask) are
// launched first.
//
// Tiles by head dim.  The head dim is the lowered lanes tile kD, which the
// layout pads to a multiple of 128:
//   * D <= 128 (80 arrives zero-padded to 128): kD = 128, kBQ = 128 query
//     rows, 16 row groups x 16 column groups, 4 scores a thread a sub-tile;
//     shared memory 41,856 floats (163.5 KiB);
//   * 128 < D <= 256 (192 arrives zero-padded to 256): kD = 256, kBQ = 64,
//     8 row groups x 32 column groups (a warp a row group), 2 scores a
//     thread a sub-tile; shared memory 54,784 floats (214 KiB), within the
//     227 KiB a CTA can opt into.  kBQ = 128 at D = 256 would need 294 KiB.
// Either way a thread holds 64 accumulator floats.  The padded lanes add 0
// to every score and leave 0 in acc.  Other lanes tiles are refused.  The
// mask, the rescale, the p v products and the drain are ssr_attention.cuh,
// which R12 ring_rescale_attention runs too.
#include "ssr_attention.cuh"

namespace {

using namespace attention;

template <typename L, typename T, typename O>
__global__ void __launch_bounds__(kThreads, 1)
    rescale_attention_kernel(const T* __restrict__ kp, const T* __restrict__ vp,
                             const T* __restrict__ qp, O* __restrict__ op,
                             SsrGrid g, SsrStream sk, SsrStream sv,
                             SsrStream sq, SsrStream so, int64_t zsteps,
                             int64_t qsub, int64_t nblocks, int64_t hk,
                             int64_t hv, int64_t hq, int64_t ho, Mask mk) {
  constexpr int kD = L::kD, kBQ = L::kBQ, kCG = L::kColGroups, kSC = L::kSC;
  constexpr int kQPitch = L::kQPitch, kKPitch = L::kKPitch;
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                    // [kD][kQPitch]: Q transposed
  float* kt = qt + kD * kQPitch;       // [kD][kKPitch]: K transposed
  float* vs = kt + kD * kKPitch;       // [kBK][kD]
  float* pt = vs + kBK * kD;           // [kBK][kPPitch]: p transposed

  const int64_t p = nblocks - 1 - static_cast<int64_t>(blockIdx.x) / qsub;
  const int64_t qs = static_cast<int64_t>(blockIdx.x) % qsub;
  const int64_t head = blockIdx.y;
  kp += head * hk;
  vp += head * hv;
  qp += head * hq;
  op += head * ho;

  const int tid = threadIdx.x;
  const int tr = tid / kCG;    // rows 8 tr .. 8 tr + 7
  const int tc = tid % kCG;    // score columns tc + kCG k; acc lanes 8 tc ..
  SsrOdometer odo(g, p * zsteps);
  const int64_t qr0 = qs * kBQ;
  const int nrows = static_cast<int>(sq.block[0] - qr0 < kBQ ? sq.block[0] - qr0 : kBQ);
  const int64_t row0 = block_row(odo, sq) + qr0 + mk.off_rc;  // row 0's index
  const T* q = qp + odo.origin(sq) + qr0 * sq.pitch;
  O* out = op + odo.origin(so) + qr0 * so.pitch;

  {  // stage Q transposed: every load issued before any store
    float4 r4[L::kQPacks];
#pragma unroll
    for (int k = 0; k < L::kQPacks; ++k) {
      const int i = tid + k * kThreads, r = i / (kD / 4), d4 = i % (kD / 4);
      r4[k] = r < nrows ? load4(q + r * sq.pitch + 4 * d4) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int k = 0; k < L::kQPacks; ++k) {
      const int i = tid + k * kThreads, r = i / (kD / 4), d4 = i % (kD / 4);
      qt[(4 * d4) * kQPitch + r] = r4[k].x;
      qt[(4 * d4 + 1) * kQPitch + r] = r4[k].y;
      qt[(4 * d4 + 2) * kQPitch + r] = r4[k].z;
      qt[(4 * d4 + 3) * kQPitch + r] = r4[k].w;
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
  const int64_t row_min = row0, row_max = row0 + nrows - 1;

  for (int64_t z = 0; z < zsteps; ++z, odo.advance(g)) {
    const T* kb = kp + odo.origin(sk);
    const T* vb = vp + odo.origin(sv);
    const int64_t kv_block = block_row(odo, sk);
    for (int64_t j0 = 0; j0 < sk.block[0]; j0 += kBK) {
      const int kvalid = static_cast<int>(sk.block[0] - j0 < kBK ? sk.block[0] - j0 : kBK);
      const int64_t kv0 = kv_block + j0;
      if (masked_out(kv0, kvalid, row_min, row_max, mk)) continue;
      // K (transposed) and V of the sub-tile, a chunk of packs at a time:
      // a chunk's loads all issued before its stores, the first chunk's
      // before the barrier, so the sub-tile costs one or two trips to memory
#pragma unroll
      for (int c0 = 0; c0 < L::kKPacks; c0 += kChunk) {
        float4 k4[kChunk], v4[kChunk];
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
          const int i = tid + (c0 + k) * kThreads, c = i / (kD / 4), d4 = i % (kD / 4);
          const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
          k4[k] = c < kvalid ? load4(kb + (j0 + c) * sk.pitch + 4 * d4) : zero;
          v4[k] = c < kvalid ? load4(vb + (j0 + c) * sv.pitch + 4 * d4) : zero;
        }
        if (c0 == 0) __syncthreads();   // the previous sub-tile's readers are done
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
          const int i = tid + (c0 + k) * kThreads, c = i / (kD / 4), d4 = i % (kD / 4);
          kt[(4 * d4) * kKPitch + c] = k4[k].x;
          kt[(4 * d4 + 1) * kKPitch + c] = k4[k].y;
          kt[(4 * d4 + 2) * kKPitch + c] = k4[k].z;
          kt[(4 * d4 + 3) * kKPitch + c] = k4[k].w;
          reinterpret_cast<float4*>(vs + c * kD)[d4] = v4[k];
        }
      }
      __syncthreads();

      float s[8][kSC];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int k = 0; k < kSC; ++k) s[i][k] = 0.f;
#pragma unroll 4
      for (int d = 0; d < kD; ++d) {
        const float4 qa = reinterpret_cast<const float4*>(qt + d * kQPitch)[2 * tr];
        const float4 qb = reinterpret_cast<const float4*>(qt + d * kQPitch)[2 * tr + 1];
        const float qv[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
        float kk[kSC];
#pragma unroll
        for (int k = 0; k < kSC; ++k) kk[k] = kt[d * kKPitch + tc + kCG * k];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int k = 0; k < kSC; ++k) s[i][k] = fmaf(qv[i], kk[k], s[i][k]);
      }

      rescale<L>(s, m, l, acc, pt, row0, tr, tc, kv0, kvalid, mk);
      __syncthreads();

      accumulate_pv<L, kBK>(acc, pt, vs, kD, tr, tc);
    }
  }

  drain(acc, l, out, so.pitch, nrows, tr, tc);
}

template <typename L, typename T, typename O>
int launch_tiles(const void* k, const void* v, const void* q, void* o,
                 const SsrGrid* g, const SsrStream* sk, const SsrStream* sv,
                 const SsrStream* sq, const SsrStream* so, int64_t zsteps,
                 int64_t heads, const int64_t* strides, const Mask& mk,
                 cudaStream_t st) {
  const size_t smem = sizeof(float) * L::kSmemFloats;
  auto kernel = rescale_attention_kernel<L, T, O>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
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
      strides[0], strides[1], strides[2], strides[3], mk);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation of the lanes tile (the blocks' width): 128 or 256.
template <typename T, typename O>
int launch(const void* k, const void* v, const void* q, void* o,
           const SsrGrid* g, const SsrStream* sk, const SsrStream* sv,
           const SsrStream* sq, const SsrStream* so, int64_t zsteps,
           int64_t heads, const int64_t* strides, const Mask& mk,
           cudaStream_t st) {
  if (sq->block[1] == Tiles128::kD)
    return launch_tiles<Tiles128, T, O>(k, v, q, o, g, sk, sv, sq, so, zsteps, heads,
                                        strides, mk, st);
  if (sq->block[1] == Tiles256::kD)
    return launch_tiles<Tiles256, T, O>(k, v, q, o, g, sk, sv, sq, so, zsteps, heads,
                                        strides, mk, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// K, V (Sk_pad, D), Q (Sq_pad, D) and O, D = 128 or 256 lanes,, each `heads` times at the
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
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Mask mk{scale, causal, window, off_rc, sk_len};
  if (in_dtype == SSR_F32 && out_dtype == SSR_F32)
    return launch<float, float>(k, v, q, o, g, sk, sv, sq, so, zsteps, heads, strides, mk, st);
  if (in_dtype == SSR_BF16 && out_dtype == SSR_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(k, v, q, o, g, sk, sv, sq, so, zsteps, heads,
                                                 strides, mk, st);
  if (in_dtype == SSR_BF16 && out_dtype == SSR_F32)
    return launch<__nv_bfloat16, float>(k, v, q, o, g, sk, sv, sq, so, zsteps, heads, strides,
                                        mk, st);
  if (in_dtype == SSR_F32 && out_dtype == SSR_BF16)
    return launch<float, __nv_bfloat16>(k, v, q, o, g, sk, sv, sq, so, zsteps, heads, strides,
                                        mk, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Shared memory of one CTA for a lanes tile of `lanes` (the head dim padded
// to a multiple of 128): the 128-row tiles up to 128 lanes, the 64-row tiles
// above (the kernel takes 128 and 256).
extern "C" int64_t ssr_rescale_attention_smem_bytes(int64_t lanes) {
  const int64_t bq = lanes <= Tiles128::kD ? Tiles128::kBQ : Tiles256::kBQ;
  return static_cast<int64_t>(sizeof(float)) *
         (lanes * (bq + 4) + lanes * (kBK + 1) + kBK * lanes + kBK * (bq + 4));
}
