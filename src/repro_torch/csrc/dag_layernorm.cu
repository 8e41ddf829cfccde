// K6 dag_layernorm: layernorm's diamond x -> {C = x - mean, V = C^2} ->
// C * rsqrt(mean V + eps), per 128-wide row, any subset of its three stages.
//
// Replaces the TPU kernel repro/core/lowering.py:_build_dag_kernel (slots
// from _dag_slots, through _assemble_kernel and repro/core/ssr.py:
// ssr_pallas) with the bodies of repro/kernels/dag.py:88-102 (_ln_centre,
// _ln_square, _ln_normalise).  There a (rows, 128) block is `rows` data rows;
// C goes to one VMEM scratch slot, V to a second, and the normalise stage
// reads both the same grid step (the map epilogue, every axis parallel).
//
// Bound on H100: bytes.  Fused, x is read once and y written once (8 bytes
// per element); the unfused composition reads x, writes C, reads C, writes
// V, reads C and V, writes y (28 bytes per element).
//
// Design: one template per stage subset (`MASK`: 1 centre, 2 square,
// 4 normalise; instantiated for {0,1,2}, {0}, {1}, {2} and {1,2}, every
// component a legal cut of the diamond can produce).  A value whose producer
// is in the subset stays in registers: one warp owns one row, four elements
// a lane, so the diamond's two consumers of C read it twice for free and
// the row's mean and variance are warp shuffles.  A value whose producer is
// not in the subset is read from its stream; the subset's last stage writes
// its value through the dense output stream.  Map-mode steps are
// independent: each CTA takes a run of steps (hopper._ctas, as K1) and
// walks them with an odometer over the lowered grid.  rsqrtf, and no fast
// math: the mean is sum / 128, exactly the reference's.  The row's
// arithmetic (ssr_dag.cuh::ln_row) is R7's too.
#include "ssr_dag.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <int MASK, int V>
__global__ void __launch_bounds__(kThreads)
    dag_layernorm_kernel(const float* __restrict__ x,
                         const float* __restrict__ c_in,
                         const float* __restrict__ v_in,
                         float* __restrict__ out, SsrGrid g, SsrStream sx,
                         SsrStream sc, SsrStream sv, SsrStream so,
                         int64_t steps, int64_t steps_per_cta) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t s0 = static_cast<int64_t>(blockIdx.x) * steps_per_cta;
  const int64_t s1 = s0 + steps_per_cta < steps ? s0 + steps_per_cta : steps;
  const int rows = static_cast<int>(so.block[0]);
  using R = LnReads<MASK>;
  SsrOdometer odo(g, s0);
  for (int64_t s = s0; s < s1; ++s, odo.advance(g)) {
    for (int r = warp; r < rows; r += kWarps)
      ln_row<MASK, V>(R::x ? x + ssr_row_origin(odo, sx, r) : nullptr,
                      R::x ? nullptr : c_in + ssr_row_origin(odo, sc, r),
                      R::v ? v_in + ssr_row_origin(odo, sv, r) : nullptr,
                      out + ssr_row_origin(odo, so, r), lane);
  }
}

template <int MASK>
int launch(int vec, const float* x, const float* c, const float* v,
           float* out, const SsrGrid* g, const SsrStream* sx,
           const SsrStream* sc, const SsrStream* sv, const SsrStream* so,
           int64_t steps, int64_t ctas, int64_t per_cta, cudaStream_t st) {
  const unsigned n = static_cast<unsigned>(ctas);
  if (vec == 4)
    dag_layernorm_kernel<MASK, 4><<<n, kThreads, 0, st>>>(
        x, c, v, out, *g, *sx, *sc, *sv, *so, steps, per_cta);
  else if (vec == 1)
    dag_layernorm_kernel<MASK, 1><<<n, kThreads, 0, st>>>(
        x, c, v, out, *g, *sx, *sc, *sv, *so, steps, per_cta);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `mask`: the stages run (1 centre, 2 square, 4 normalise).  x, c, v are the
// streams of the values read from device memory (null where a value stays
// on chip or is not read); `out` receives the last stage's value.  `vec` is
// 4 when every used stream and the output allow 16-byte row accesses.
extern "C" int ssr_dag_layernorm(int mask, const void* x, const void* c,
                                 const void* v, void* out, int vec,
                                 const SsrGrid* g, const SsrStream* sx,
                                 const SsrStream* sc, const SsrStream* sv,
                                 const SsrStream* so, int64_t num_ctas,
                                 int64_t steps_per_cta, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int64_t steps = 1;
  for (int k = 0; k < g->ndim; ++k) steps *= g->dims[k];
  const float* px = static_cast<const float*>(x);
  const float* pc = static_cast<const float*>(c);
  const float* pv = static_cast<const float*>(v);
  float* po = static_cast<float*>(out);
  switch (mask) {
    case 7: return launch<7>(vec, px, pc, pv, po, g, sx, sc, sv, so, steps, num_ctas, steps_per_cta, st);
    case 1: return launch<1>(vec, px, pc, pv, po, g, sx, sc, sv, so, steps, num_ctas, steps_per_cta, st);
    case 2: return launch<2>(vec, px, pc, pv, po, g, sx, sc, sv, so, steps, num_ctas, steps_per_cta, st);
    case 4: return launch<4>(vec, px, pc, pv, po, g, sx, sc, sv, so, steps, num_ctas, steps_per_cta, st);
    case 6: return launch<6>(vec, px, pc, pv, po, g, sx, sc, sv, so, steps, num_ctas, steps_per_cta, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int64_t ssr_dag_layernorm_smem_bytes() { return 0; }
