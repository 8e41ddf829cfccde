// K4 contract_gemv: y_blk += A_blk . x_blk^T over the trailing contraction
// axes, in an f32 accumulator, cast to the output dtype on the drain.
//
// Replaces the TPU kernel repro/core/ssr.py:ssr_pallas (sync emitter) with
// the contraction branch of repro/core/lowering.py:_build_nest_kernel and the
// body repro/kernels/gemv.py:matvec_block.  x is a repeat stream: its block
// index ignores the row axis, so every row block re-reads the same x blocks.
// At 8192^2 the default lowering gives grid (16, 16), (parallel, arbitrary),
// with blocks A 512x512, x (1, 512) and y (1, 512).
//
// Bound on H100: bytes.  Each element of A is read once for one multiply-add.
//
// Design: one CTA per lowered output block would put only 16 CTAs on 132 SMs
// for a kernel bound by bandwidth.  So each lowered row block is split over
// CTAs of 16 rows (two per warp).  Each CTA walks the contraction steps in
// grid order; per step it stages the x block in shared memory once (in 2048
// element chunks) and reuses it for all its rows, as the repeat register
// does.  Lanes read consecutive 16-byte packs of a row (where the wrapper
// found A aligned for it), so each warp's loads are coalesced; the per-row
// sums are folded across the warp on the drain.
//
// With `relu` set (body op matvec_relu, the fused gemv_relu of
// repro/kernels/chained.py:63-72, whose relu rides the reference's finish)
// the drain writes max(0, y), selected as K2 selects it (ssr_relu), once per
// output element after the whole contraction: never to a partial.
#include "ssr_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerWarp = 2;
constexpr int kRowsPerCta = (kThreads / 32) * kRowsPerWarp;  // 16
constexpr int kChunk = 2048;

template <typename T, typename O, int V>
__global__ void __launch_bounds__(kThreads)
    contract_gemv_kernel(const T* __restrict__ a, const T* __restrict__ x,
                         O* __restrict__ y, SsrGrid g, SsrStream sa,
                         SsrStream sx, SsrStream sy, int64_t zsteps,
                         int64_t groups, int relu) {
  using Pack = SsrPack<T, V>;
  using XPack = SsrPack<float, V>;
  __shared__ __align__(32) float xs[kChunk];
  const int64_t p = blockIdx.x / groups;
  const int64_t grp = blockIdx.x % groups;
  const int64_t tm = sa.block[0], tn = sa.block[1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t r0 = grp * kRowsPerCta + warp * kRowsPerWarp;
  const bool live0 = r0 < tm, live1 = r0 + 1 < tm;
  float part0 = 0.f, part1 = 0.f;

  SsrOdometer odo(g, p * zsteps);
  for (int64_t z = 0; z < zsteps; ++z, odo.advance(g)) {
    const T* pa = a + odo.origin(sa);
    const T* px = x + odo.origin(sx);
    for (int64_t c0 = 0; c0 < tn; c0 += kChunk) {
      const int len = static_cast<int>(tn - c0 < kChunk ? tn - c0 : kChunk);
      __syncthreads();
      for (int i = threadIdx.x; i < len; i += kThreads) xs[i] = ssr_f32(px[c0 + i]);
      __syncthreads();
      const T* row0 = pa + r0 * sa.pitch + c0;
      const T* row1 = row0 + sa.pitch;
      const XPack* xp = reinterpret_cast<const XPack*>(xs);
#pragma unroll 4
      for (int c = lane; c < len / V; c += 32) {
        const XPack xv = xp[c];
        if (live0) {
          const Pack av = *reinterpret_cast<const Pack*>(row0 + c * V);
#pragma unroll
          for (int j = 0; j < V; ++j) part0 = fmaf(ssr_f32(av.v[j]), xv.v[j], part0);
        }
        if (live1) {
          const Pack av = *reinterpret_cast<const Pack*>(row1 + c * V);
#pragma unroll
          for (int j = 0; j < V; ++j) part1 = fmaf(ssr_f32(av.v[j]), xv.v[j], part1);
        }
      }
    }
  }

#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    part0 += __shfl_xor_sync(0xffffffffu, part0, o);
    part1 += __shfl_xor_sync(0xffffffffu, part1, o);
  }
  if (relu) {
    part0 = ssr_relu(part0);
    part1 = ssr_relu(part1);
  }
  // drain: y's block is (1, tm); its element (0, r) sits at origin + r
  O* py = y + ssr_block_origin(sy, g, p * zsteps);
  if (lane == 0) {
    if (live0) py[r0] = ssr_cast<O>(part0);
    if (live1) py[r0 + 1] = ssr_cast<O>(part1);
  }
}

template <typename T, typename O>
int launch(int vec, const void* a, const void* x, void* y, const SsrGrid* g,
           const SsrStream* sa, const SsrStream* sx, const SsrStream* sy,
           int64_t zsteps, int64_t ctas, int64_t groups, int relu,
           cudaStream_t st) {
  constexpr int kV = 16 / sizeof(T);
  const unsigned n = static_cast<unsigned>(ctas);
  if (vec == kV)
    contract_gemv_kernel<T, O, kV><<<n, kThreads, 0, st>>>(
        static_cast<const T*>(a), static_cast<const T*>(x), static_cast<O*>(y),
        *g, *sa, *sx, *sy, zsteps, groups, relu);
  else if (vec == 1)
    contract_gemv_kernel<T, O, 1><<<n, kThreads, 0, st>>>(
        static_cast<const T*>(a), static_cast<const T*>(x), static_cast<O*>(y),
        *g, *sa, *sx, *sy, zsteps, groups, relu);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `vec` is 16 / sizeof(element) when A's pitch, block width and base pointer
// allow 16-byte accesses, else 1; `relu` (0 or 1) selects the relu drain.
extern "C" int ssr_contract_gemv(const void* a, const void* x, void* y,
                                 int in_dtype, int out_dtype, int vec,
                                 const SsrGrid* g, const SsrStream* sa,
                                 const SsrStream* sx, const SsrStream* sy,
                                 int64_t zsteps, int relu, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int64_t steps = 1;
  for (int k = 0; k < g->ndim; ++k) steps *= g->dims[k];
  const int64_t groups = (sa->block[0] + kRowsPerCta - 1) / kRowsPerCta;
  const int64_t ctas = (steps / zsteps) * groups;
  if (in_dtype == SSR_F32 && out_dtype == SSR_F32)
    return launch<float, float>(vec, a, x, y, g, sa, sx, sy, zsteps, ctas, groups, relu, st);
  if (in_dtype == SSR_F32 && out_dtype == SSR_BF16)
    return launch<float, __nv_bfloat16>(vec, a, x, y, g, sa, sx, sy, zsteps, ctas, groups, relu, st);
  if (in_dtype == SSR_BF16 && out_dtype == SSR_F32)
    return launch<__nv_bfloat16, float>(vec, a, x, y, g, sa, sx, sy, zsteps, ctas, groups, relu, st);
  if (in_dtype == SSR_BF16 && out_dtype == SSR_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(vec, a, x, y, g, sa, sx, sy, zsteps, ctas, groups, relu, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int64_t ssr_contract_gemv_smem_bytes() {
  return static_cast<int64_t>(sizeof(float)) * kChunk;
}
