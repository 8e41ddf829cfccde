// K1 reduce_mul: sum over every grid step of promote(a_blk) * promote(b_blk).
//
// Replaces the TPU kernel repro/core/ssr.py:ssr_pallas (sync emitter) with
// the reduce epilogue of repro/core/lowering.py:_assemble_kernel and the
// body repro/kernels/reduction.py:_mul_body -- the paper's Fig. 4 dot
// product.  There, one (rows, lanes) f32 accumulator is carried across the
// whole `arbitrary` grid and folded to a scalar on the last step.
//
// Bound on H100: bytes.  Each input element is read once and used for one
// multiply-add, so the kernel can go no faster than both operands over the
// card's memory rate.
//
// Design: CTAs cannot carry state from one to the next, so the carried
// accumulator becomes per-CTA partials.  Each CTA takes a contiguous range of
// flat grid steps, walks those blocks through the streams' AGU programming
// (an odometer over the grid: no division per step) and accumulates in f32
// registers, reading 16 bytes per access where the wrapper found the layout
// aligned for it.  It then reduces its threads in a fixed order to one
// partial.  A second launch with one CTA sums the partials in a fixed order.
// No atomics: the result is the same from run to run.
#include "ssr_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kFoldThreads = 1024;

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    reduce_mul_partials(const T* __restrict__ a, const T* __restrict__ b,
                        SsrGrid g, SsrStream sa, SsrStream sb, int64_t steps,
                        int64_t steps_per_cta, float* __restrict__ partials) {
  using Pack = SsrPack<T, V>;
  const int64_t s0 = static_cast<int64_t>(blockIdx.x) * steps_per_cta;
  const int64_t s1 = s0 + steps_per_cta < steps ? s0 + steps_per_cta : steps;
  const int rows = static_cast<int>(sa.block[0]);
  const int packs = static_cast<int>(sa.block[1]) / V;
  float acc = 0.f;
  SsrOdometer odo(g, s0);
  for (int64_t s = s0; s < s1; ++s, odo.advance(g)) {
    const T* pa = a + odo.origin(sa);
    const T* pb = b + odo.origin(sb);
    for (SsrBlockWalk w(threadIdx.x, kThreads, packs); w.r < rows; w.next()) {
      const Pack xa = *reinterpret_cast<const Pack*>(
          pa + static_cast<int64_t>(w.r) * sa.pitch + w.c * V);
      const Pack xb = *reinterpret_cast<const Pack*>(
          pb + static_cast<int64_t>(w.r) * sb.pitch + w.c * V);
#pragma unroll
      for (int j = 0; j < V; ++j) acc += ssr_f32(xa.v[j]) * ssr_f32(xb.v[j]);
    }
  }
  acc = ssr_cta_sum<kThreads>(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

__global__ void __launch_bounds__(kFoldThreads)
    fold_partials(const float* __restrict__ partials, int64_t n,
                  float* __restrict__ out) {
  float acc = 0.f;
  for (int64_t i = threadIdx.x; i < n; i += kFoldThreads) acc += partials[i];
  acc = ssr_cta_sum<kFoldThreads>(acc);
  if (threadIdx.x == 0) out[0] = acc;
}

template <typename T, int V>
void launch(const void* a, const void* b, const SsrGrid* g,
            const SsrStream* sa, const SsrStream* sb, int64_t steps,
            int64_t num_ctas, int64_t steps_per_cta, float* part,
            cudaStream_t st) {
  reduce_mul_partials<T, V><<<static_cast<unsigned>(num_ctas), kThreads, 0,
                              st>>>(static_cast<const T*>(a),
                                    static_cast<const T*>(b), *g, *sa, *sb,
                                    steps, steps_per_cta, part);
}

}  // namespace

// `vec` is 16 / sizeof(element) when every stream's pitch, block width and
// base pointer allow 16-byte accesses, else 1.
extern "C" int ssr_reduce_mul(const void* a, const void* b, int dtype,
                              int vec, const SsrGrid* g, const SsrStream* sa,
                              const SsrStream* sb, void* partials,
                              int64_t num_ctas, int64_t steps_per_cta,
                              void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int64_t steps = 1;
  for (int k = 0; k < g->ndim; ++k) steps *= g->dims[k];
  float* part = static_cast<float*>(partials);
  const int64_t n = num_ctas, per = steps_per_cta;
  if (dtype == SSR_F32 && vec == 4)
    launch<float, 4>(a, b, g, sa, sb, steps, n, per, part, st);
  else if (dtype == SSR_F32 && vec == 1)
    launch<float, 1>(a, b, g, sa, sb, steps, n, per, part, st);
  else if (dtype == SSR_BF16 && vec == 8)
    launch<__nv_bfloat16, 8>(a, b, g, sa, sb, steps, n, per, part, st);
  else if (dtype == SSR_BF16 && vec == 1)
    launch<__nv_bfloat16, 1>(a, b, g, sa, sb, steps, n, per, part, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fold_partials<<<1, kFoldThreads, 0, st>>>(part, num_ctas,
                                            static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int64_t ssr_reduce_mul_smem_bytes() {
  return static_cast<int64_t>(sizeof(float)) * (kFoldThreads / 32);
}
