// K3 contract_gemm: C_blk += A_blk . B_blk over the trailing contraction
// axes, in an f32 accumulator, cast to the output dtype on the drain.
//
// Replaces the TPU kernel repro/core/ssr.py:ssr_pallas (sync emitter) with
// the contraction branch of repro/core/lowering.py:_build_nest_kernel and the
// body repro/kernels/gemm.py:_body (an f32 dot_general).  At 4096^3 the
// default lowering gives grid (16, 8, 8) with blocks A 256x512, B 512x512 and
// C 256x512 held in VMEM.
//
// Bound on H100: operations.  2mnk multiply-adds at FP32 outside the tensor
// cores (no TF32: the reference asks dot_general for f32), about 67 TFLOP/s.
//
// Design: the lowered C block (512 KiB in f32) and B block (1 MiB) fit
// neither one CTA's 227 KB of shared memory nor its registers, so each
// lowered output block is covered by several CTAs, each owning a 128x128
// sub-tile with its accumulator in registers (8x8 per thread, read from
// shared memory as 16-byte vectors).  Each CTA walks the contraction steps
// in grid order and, inside each lowered k block, 16-wide k chunks of A and
// B: the next chunk's global loads (16 bytes each where the wrapper found
// the layouts aligned) are in flight in registers while the current chunk,
// staged in one of two shared-memory buffers, feeds the f32 FMAs.  Every
// address comes from the streams' AGU programming; rows, columns and k past
// the lowered block are masked.
#include "ssr_common.cuh"

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 16;
constexpr int kThreads = 256;          // 16 x 16 threads, 8 x 8 outputs each
constexpr int kPadM = kBM + 4;         // staggers the transposed A stores
constexpr int kPerThread = kBM * kBK / kThreads;  // 8 staged values each

// Loads one k chunk of A (rows m0.., k k0..) and B (k k0.., cols n0..) into
// registers.  V = 4: two 16-byte loads each; V = 1: eight scalar loads.
template <typename T, int V>
__device__ __forceinline__ void load_chunk(const T* pa, const T* pb,
                                           const SsrStream& sa,
                                           const SsrStream& sb, int64_t m0,
                                           int64_t n0, int64_t k0, int64_t tm,
                                           int64_t tn, int64_t tk, float* ra,
                                           float* rb) {
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < kPerThread / V; ++i) {
    // A: V consecutive k of one row
    const int row = t / (kBK / V) + i * (kThreads * V / kBK);
    const int kq = (t % (kBK / V)) * V;
    const int64_t gr = m0 + row, gk = k0 + kq;
    const bool in_a = gr < tm && gk < tk;
    // B: V consecutive columns of one k row
    const int krow = t / (kBN / V) + i * (kThreads * V / kBN);
    const int col = (t % (kBN / V)) * V;
    const int64_t gkb = k0 + krow, gn = n0 + col;
    const bool in_b = gkb < tk && gn < tn;
    if constexpr (V == 4) {
      float4 va = make_float4(0.f, 0.f, 0.f, 0.f), vb = va;
      if (in_a) va = *reinterpret_cast<const float4*>(pa + gr * sa.pitch + gk);
      if (in_b) vb = *reinterpret_cast<const float4*>(pb + gkb * sb.pitch + gn);
      ra[i * 4 + 0] = va.x; ra[i * 4 + 1] = va.y;
      ra[i * 4 + 2] = va.z; ra[i * 4 + 3] = va.w;
      rb[i * 4 + 0] = vb.x; rb[i * 4 + 1] = vb.y;
      rb[i * 4 + 2] = vb.z; rb[i * 4 + 3] = vb.w;
    } else {
      ra[i] = in_a ? ssr_f32(pa[gr * sa.pitch + gk]) : 0.f;
      rb[i] = in_b ? ssr_f32(pb[gkb * sb.pitch + gn]) : 0.f;
    }
  }
}

// Stores the staged chunk: A transposed to k-major, B as it is.
template <int V>
__device__ __forceinline__ void store_chunk(float (*As)[kPadM],
                                            float (*Bs)[kBN], const float* ra,
                                            const float* rb) {
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < kPerThread / V; ++i) {
    const int row = t / (kBK / V) + i * (kThreads * V / kBK);
    const int kq = (t % (kBK / V)) * V;
    const int krow = t / (kBN / V) + i * (kThreads * V / kBN);
    const int col = (t % (kBN / V)) * V;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      As[kq + j][row] = ra[i * V + j];
      Bs[krow][col + j] = rb[i * V + j];
    }
  }
}

template <typename T, typename O, int V>
__global__ void __launch_bounds__(kThreads)
    contract_gemm_kernel(const T* __restrict__ a, const T* __restrict__ b,
                         O* __restrict__ c, SsrGrid g, SsrStream sa,
                         SsrStream sb, SsrStream sc, int64_t zsteps,
                         int64_t tiles_n, int64_t tiles_per_block) {
  __shared__ __align__(16) float As[2][kBK][kPadM];
  __shared__ __align__(16) float Bs[2][kBK][kBN];
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
  const int64_t total = zsteps * kchunks;
  SsrOdometer odo(g, p * zsteps);
  const T* pa = a + odo.origin(sa);
  const T* pb = b + odo.origin(sb);
  int64_t kc = 0;
  float ra[kPerThread], rb[kPerThread];
  load_chunk<T, V>(pa, pb, sa, sb, m0, n0, 0, tm, tn, tk, ra, rb);
  store_chunk<V>(As[0], Bs[0], ra, rb);
  __syncthreads();

  for (int64_t ch = 0; ch < total; ++ch) {
    const int cur = static_cast<int>(ch & 1);
    const bool more = ch + 1 < total;
    if (more) {  // the next chunk's loads fly while this one computes
      if (++kc == kchunks) {
        kc = 0;
        odo.advance(g);
        pa = a + odo.origin(sa);
        pb = b + odo.origin(sb);
      }
      load_chunk<T, V>(pa, pb, sa, sb, m0, n0, kc * kBK, tm, tn, tk, ra, rb);
    }
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float am[8], bn[8];
      *reinterpret_cast<float4*>(&am[0]) =
          *reinterpret_cast<const float4*>(&As[cur][kk][ty * 4]);
      *reinterpret_cast<float4*>(&am[4]) =
          *reinterpret_cast<const float4*>(&As[cur][kk][64 + ty * 4]);
      *reinterpret_cast<float4*>(&bn[0]) =
          *reinterpret_cast<const float4*>(&Bs[cur][kk][tx * 4]);
      *reinterpret_cast<float4*>(&bn[4]) =
          *reinterpret_cast<const float4*>(&Bs[cur][kk][64 + tx * 4]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(am[i], bn[j], acc[i][j]);
    }
    if (more) store_chunk<V>(As[cur ^ 1], Bs[cur ^ 1], ra, rb);
    __syncthreads();
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
int launch(int vec, const void* a, const void* b, void* c, const SsrGrid* g,
           const SsrStream* sa, const SsrStream* sb, const SsrStream* sc,
           int64_t zsteps, int64_t ctas, int64_t tiles_n,
           int64_t tiles_per_block, cudaStream_t st) {
  const unsigned n = static_cast<unsigned>(ctas);
  if constexpr (sizeof(T) == 4) {  // 16-byte loads: f32 operands only
    if (vec == 4) {
      contract_gemm_kernel<T, O, 4><<<n, kThreads, 0, st>>>(
          static_cast<const T*>(a), static_cast<const T*>(b),
          static_cast<O*>(c), *g, *sa, *sb, *sc, zsteps, tiles_n,
          tiles_per_block);
      return static_cast<int>(cudaGetLastError());
    }
  }
  if (vec != 1) return static_cast<int>(cudaErrorInvalidValue);
  contract_gemm_kernel<T, O, 1><<<n, kThreads, 0, st>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<O*>(c),
      *g, *sa, *sb, *sc, zsteps, tiles_n, tiles_per_block);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `vec` is 4 when A and B are f32 and their pitches, block widths and base
// pointers allow 16-byte loads, else 1.
extern "C" int ssr_contract_gemm(const void* a, const void* b, void* c,
                                 int in_dtype, int out_dtype, int vec,
                                 const SsrGrid* g, const SsrStream* sa,
                                 const SsrStream* sb, const SsrStream* sc,
                                 int64_t zsteps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int64_t steps = 1;
  for (int k = 0; k < g->ndim; ++k) steps *= g->dims[k];
  const int64_t tiles_m = (sc->block[0] + kBM - 1) / kBM;
  const int64_t tiles_n = (sc->block[1] + kBN - 1) / kBN;
  const int64_t per_block = tiles_m * tiles_n;
  const int64_t ctas = (steps / zsteps) * per_block;
  if (in_dtype == SSR_F32 && out_dtype == SSR_F32)
    return launch<float, float>(vec, a, b, c, g, sa, sb, sc, zsteps, ctas,
                                tiles_n, per_block, st);
  if (in_dtype == SSR_F32 && out_dtype == SSR_BF16)
    return launch<float, __nv_bfloat16>(vec, a, b, c, g, sa, sb, sc, zsteps,
                                        ctas, tiles_n, per_block, st);
  if (in_dtype == SSR_BF16 && out_dtype == SSR_F32)
    return launch<__nv_bfloat16, float>(vec, a, b, c, g, sa, sb, sc, zsteps,
                                        ctas, tiles_n, per_block, st);
  if (in_dtype == SSR_BF16 && out_dtype == SSR_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(vec, a, b, c, g, sa, sb, sc,
                                                zsteps, ctas, tiles_n,
                                                per_block, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int64_t ssr_contract_gemm_smem_bytes() {
  return static_cast<int64_t>(sizeof(float)) * 2 * kBK * (kPadM + kBN);
}
