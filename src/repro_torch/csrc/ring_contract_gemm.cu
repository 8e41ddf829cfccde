// R3 ring_contract_gemm: K3's C_blk += A_blk . B_blk over the trailing
// contraction axes, in an f32 accumulator, its A and B chunks delivered
// through an N-deep shared-memory ring.
//
// Replaces the TPU kernel repro/core/ssr.py:_pipelined_call (the N-deep
// rotation a schedule with buffer_depth > 2 emits) around the contraction
// branch of repro/core/lowering.py:_build_nest_kernel and the body
// repro/kernels/gemm.py:_body (an f32 dot_general).
//
// Bound on H100: operations, as K3 -- 2mnk FP32 multiply-adds outside the
// tensor cores (no TF32), about 67 TFLOP/s.
//
// Design: K3's CTAs (one 128x128 sub-tile of a lowered output block each)
// and K3's walk: the contraction steps in grid order and, inside each
// lowered k block, 16-wide k chunks.  A lowered step's tiles (128 x tk of
// A, tk x 128 of B) exceed shared memory, so the ring's unit is the chunk:
// the CTA's run is its zsteps x ceil(tk / 16) chunks, and each stream keeps
// depth - 1 chunks in flight (K3 keeps one, in registers).  Threads 0-127
// fetch A, 128-255 B, with zero-filling cp.async for the rows, columns and
// k past the lowered block (K3 masks them to 0).  cp.async cannot
// transpose, so A lands as it is, 128 rows of 16 k, each row padded to 20
// floats (24 bf16) so the two rows a warp reads at once fall in other
// banks; B lands as it is, 16 rows of 128.  A thread (tx, ty) reads each
// of its 8 A rows as four consecutive k (one 16-byte load) and each B row
// as K3 does, and chains fmaf(a[row][k], b[k][col], acc) over k in K3's
// order, inputs converted to f32 as K3 stages them: the same bits as K3 at
// every depth.
#include "ssr_ring.cuh"

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 16;
constexpr int kThreads = 256;
constexpr int kHalf = kThreads / 2;

// Row stride of an A slot: 16 k plus 16 bytes of padding.
template <typename T>
constexpr int kALd = kBK + 16 / static_cast<int>(sizeof(T));

template <typename T, typename O>
__global__ void __launch_bounds__(kThreads)
    ring_contract_gemm_kernel(const T* __restrict__ a, const T* __restrict__ b,
                              O* __restrict__ c, SsrGrid g, SsrStream sa,
                              SsrStream sb, SsrStream sc, int64_t zsteps,
                              int64_t tiles_n, int64_t tiles_per_block,
                              int cvec, SsrRing ring) {
  constexpr int kLd = kALd<T>;
  constexpr int kATile = kBM * kLd, kBTile = kBK * kBN;
  constexpr int kV = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  T* a_slots = reinterpret_cast<T*>(smem);
  T* b_slots = a_slots + ring.depth[0] * kATile;
  const int64_t p = blockIdx.x / tiles_per_block;
  const int64_t t = blockIdx.x % tiles_per_block;
  const int64_t m0 = (t / tiles_n) * kBM;
  const int64_t n0 = (t % tiles_n) * kBN;
  const int64_t tm = sc.block[0], tn = sc.block[1], tk = sa.block[1];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int64_t kchunks = (tk + kBK - 1) / kBK;
  const int64_t run = zsteps * kchunks;
  const int mine = threadIdx.x < kHalf ? 0 : 1;
  const int lane = threadIdx.x - mine * kHalf;
  SsrRingSide side(ring, mine);
  SsrRingSide ra(ring, 0), rb(ring, 1);
  const int64_t dmax = ring.depth[0] > ring.depth[1] ? ring.depth[0] : ring.depth[1];
  SsrOdometer fetch_at(g, p * zsteps);
  int64_t fetch_kc = 0;
  auto fetch = [&](int slot) {
    const int64_t k0 = fetch_kc * kBK;
    if (mine == 0) {  // A: rows m0.., k k0..
      const T* pa = a + fetch_at.origin(sa);
      T* dst = a_slots + slot * kATile;
      if (cvec) {
        for (int i = lane; i < kBM * (kBK / kV); i += kHalf) {
          const int r = i / (kBK / kV), kk = (i % (kBK / kV)) * kV;
          const bool in = m0 + r < tm && k0 + kk < tk;
          ssr_ring_cp16(dst + r * kLd + kk,
                        in ? pa + (m0 + r) * sa.pitch + k0 + kk : pa, in);
        }
      } else {
        for (int i = lane; i < kBM * kBK; i += kHalf) {
          const int r = i / kBK, kk = i % kBK;
          const bool in = m0 + r < tm && k0 + kk < tk;
          const T* src = in ? pa + (m0 + r) * sa.pitch + k0 + kk : pa;
          if constexpr (sizeof(T) == 4)
            ssr_ring_cp4(dst + r * kLd + kk, src, in);
          else
            dst[r * kLd + kk] = in ? *src : ssr_cast<T>(0.f);
        }
      }
    } else {  // B: k k0.., cols n0..
      const T* pb = b + fetch_at.origin(sb);
      T* dst = b_slots + slot * kBTile;
      if (cvec) {
        for (int i = lane; i < kBK * (kBN / kV); i += kHalf) {
          const int kr = i / (kBN / kV), col = (i % (kBN / kV)) * kV;
          const bool in = k0 + kr < tk && n0 + col < tn;
          ssr_ring_cp16(dst + kr * kBN + col,
                        in ? pb + (k0 + kr) * sb.pitch + n0 + col : pb, in);
        }
      } else {
        for (int i = lane; i < kBK * kBN; i += kHalf) {
          const int kr = i / kBN, col = i % kBN;
          const bool in = k0 + kr < tk && n0 + col < tn;
          const T* src = in ? pb + (k0 + kr) * sb.pitch + n0 + col : pb;
          if constexpr (sizeof(T) == 4)
            ssr_ring_cp4(dst + kr * kBN + col, src, in);
          else
            dst[kr * kBN + col] = in ? *src : ssr_cast<T>(0.f);
        }
      }
    }
    if (++fetch_kc == kchunks) {
      fetch_kc = 0;
      fetch_at.advance(g);
    }
  };

  for (int64_t u = 1 - dmax; u < 0; ++u) side.issue(u, 1 - dmax, run, fetch);
  for (int64_t u = 0; u < run; ++u) {
    side.wait();
    __syncthreads();
    side.issue(u, 1 - dmax, run, fetch);
    const T* As = a_slots + ra.slot() * kATile;
    const T* Bs = b_slots + rb.slot() * kBTile;
#pragma unroll
    for (int kq = 0; kq < kBK / 4; ++kq) {
      float4 a4[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4;
        a4[i] = ssr_load4_f32<T>(As + row * kLd + kq * 4);
      }
#pragma unroll
      for (int k4 = 0; k4 < 4; ++k4) {
        const int kk = kq * 4 + k4;
        float bn[8];
        const float4 b0 = ssr_load4_f32<T>(Bs + kk * kBN + tx * 4);
        const float4 b1 = ssr_load4_f32<T>(Bs + kk * kBN + 64 + tx * 4);
        bn[0] = b0.x; bn[1] = b0.y; bn[2] = b0.z; bn[3] = b0.w;
        bn[4] = b1.x; bn[5] = b1.y; bn[6] = b1.z; bn[7] = b1.w;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float am = k4 == 0 ? a4[i].x : k4 == 1 ? a4[i].y
                         : k4 == 2 ? a4[i].z : a4[i].w;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(am, bn[j], acc[i][j]);
        }
      }
    }
    ra.step();
    rb.step();
  }

  // drain: the output block is the same for every contraction step of p
  O* pc = c + ssr_block_origin(sc, g, p * zsteps);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t r = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int64_t n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (r < tm && n < tn) pc[r * sc.pitch + n] = ssr_cast<O>(acc[i][j]);
    }
  }
}

template <typename T, typename O>
int launch(int cvec, const void* a, const void* b, void* c, const SsrGrid* g,
           const SsrStream* sa, const SsrStream* sb, const SsrStream* sc,
           int64_t zsteps, int64_t ctas, int64_t tiles_n,
           int64_t tiles_per_block, const SsrRing* ring, int64_t smem,
           cudaStream_t st) {
  constexpr int64_t kSlots = static_cast<int64_t>(sizeof(T)) * kBM * kALd<T>;
  if (smem < ring->depth[0] * kSlots +
                 ring->depth[1] * static_cast<int64_t>(sizeof(T)) * kBK * kBN)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = ring_contract_gemm_kernel<T, O>;
  cudaError_t err = ssr_ring_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(ctas), kThreads, smem, st>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<O*>(c),
      *g, *sa, *sb, *sc, zsteps, tiles_n, tiles_per_block, cvec, *ring);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `cvec` is 1 when A and B allow 16-byte copies (pitches, block widths and
// base pointers multiples of 16 bytes), else 0; `smem_bytes` the ring's
// bytes as the wrapper counted them, checked here.
extern "C" int ssr_ring_contract_gemm(const void* a, const void* b, void* c,
                                      int in_dtype, int out_dtype, int cvec,
                                      const SsrGrid* g, const SsrStream* sa,
                                      const SsrStream* sb, const SsrStream* sc,
                                      int64_t zsteps, const SsrRing* ring,
                                      int64_t smem_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int64_t steps = 1;
  for (int k = 0; k < g->ndim; ++k) steps *= g->dims[k];
  const int64_t tiles_m = (sc->block[0] + kBM - 1) / kBM;
  const int64_t tiles_n = (sc->block[1] + kBN - 1) / kBN;
  const int64_t per_block = tiles_m * tiles_n;
  const int64_t ctas = (steps / zsteps) * per_block;
  if (in_dtype == SSR_F32 && out_dtype == SSR_F32)
    return launch<float, float>(cvec, a, b, c, g, sa, sb, sc, zsteps, ctas,
                                tiles_n, per_block, ring, smem_bytes, st);
  if (in_dtype == SSR_F32 && out_dtype == SSR_BF16)
    return launch<float, __nv_bfloat16>(cvec, a, b, c, g, sa, sb, sc, zsteps,
                                        ctas, tiles_n, per_block, ring,
                                        smem_bytes, st);
  if (in_dtype == SSR_BF16 && out_dtype == SSR_F32)
    return launch<__nv_bfloat16, float>(cvec, a, b, c, g, sa, sb, sc, zsteps,
                                        ctas, tiles_n, per_block, ring,
                                        smem_bytes, st);
  if (in_dtype == SSR_BF16 && out_dtype == SSR_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(cvec, a, b, c, g, sa, sb, sc,
                                                zsteps, ctas, tiles_n,
                                                per_block, ring, smem_bytes,
                                                st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int64_t ssr_ring_contract_gemm_smem_bytes() { return 0; }
