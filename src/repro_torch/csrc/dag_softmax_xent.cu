// K7 dag_softmax_xent: softmax cross-entropy's diamond z -> {C = z - max,
// E = exp C} -> sum over rows of mask * (logsumexp - p . C), per 128-wide
// row, any subset of its three stages.
//
// Replaces the TPU kernel repro/core/lowering.py:_build_dag_kernel (slots
// from _dag_slots, through _assemble_kernel and repro/core/ssr.py:
// ssr_pallas) with the bodies of repro/kernels/dag.py:145-167 (_sx_shift,
// _sx_exp, _sx_loss).  There C and E sit in two VMEM slots, the loss stage
// broadcasts each row's loss / 128 over its block row, and the reduce
// epilogue carries a (rows, 128) accumulator over the `arbitrary` grid.
//
// Bound on H100: bytes.  Fused, z and p are read once (8 bytes per
// element); unfused, C and E are written and read back (28 bytes).
//
// Design: as K6, one template per stage subset (`MASK`: 1 shift, 2 exp,
// 4 loss; instantiated for {0,1,2}, {0}, {1}, {2} and {1,2}), one warp per
// row with the row max and the sums by shuffles, C and E in registers when
// their producer runs here, from their streams otherwise.  expf and logf
// (no fast math).  The loss keeps the reference's max(sum E, 1e-30) clamp:
// on the unfused path a zero padding row reaches it with E = 0, and the
// clamp keeps log finite there, where mask = sum p = 0 then zeroes it.  A row
// adds mask * (lse - p . C) once (the 128 copies of that / 128 the
// reference sums are the same number); each CTA folds its rows in a fixed
// order to one partial, and a second one-CTA launch folds the partials in a
// fixed order.  No atomics: the same bits from run to run.  The row's
// arithmetic (ssr_dag.cuh::sx_row) is R8's too.
#include "ssr_dag.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <int MASK, int V>
__global__ void __launch_bounds__(kThreads)
    dag_softmax_xent_kernel(const float* __restrict__ z,
                            const float* __restrict__ c_in,
                            const float* __restrict__ e_in,
                            const float* __restrict__ p,
                            float* __restrict__ out,
                            float* __restrict__ partials, SsrGrid g,
                            SsrStream sz, SsrStream sc, SsrStream se,
                            SsrStream sp, SsrStream so, int64_t steps,
                            int64_t steps_per_cta) {
  using R = SxReads<MASK>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t s0 = static_cast<int64_t>(blockIdx.x) * steps_per_cta;
  const int64_t s1 = s0 + steps_per_cta < steps ? s0 + steps_per_cta : steps;
  // a reduce writes one (1, 1) block: the rows come from the read streams
  const int rows = static_cast<int>((R::z ? sz : sc).block[0]);
  float acc = 0.f;
  SsrOdometer odo(g, s0);
  for (int64_t s = s0; s < s1; ++s, odo.advance(g)) {
    for (int r = warp; r < rows; r += kWarps)
      sx_row<MASK, V>(R::z ? z + ssr_row_origin(odo, sz, r) : nullptr,
                      R::z ? nullptr : c_in + ssr_row_origin(odo, sc, r),
                      R::e ? e_in + ssr_row_origin(odo, se, r) : nullptr,
                      R::p ? p + ssr_row_origin(odo, sp, r) : nullptr,
                      R::p ? nullptr : out + ssr_row_origin(odo, so, r),
                      lane, acc);
  }
  if constexpr ((MASK & kSxLoss) != 0) {
    acc = ssr_cta_sum<kThreads>(acc);
    if (threadIdx.x == 0) partials[blockIdx.x] = acc;
  }
}

struct Args {
  const float *z, *c, *e, *p;
  float *out, *partials;
  SsrGrid g;
  SsrStream sz, sc, se, sp, so;
  int64_t steps, ctas, per_cta;
  cudaStream_t st;
};

template <int MASK, int V>
void run(const Args& a) {
  dag_softmax_xent_kernel<MASK, V>
      <<<static_cast<unsigned>(a.ctas), kThreads, 0, a.st>>>(
          a.z, a.c, a.e, a.p, a.out, a.partials, a.g, a.sz, a.sc, a.se, a.sp,
          a.so, a.steps, a.per_cta);
}

template <int MASK>
int launch(int vec, const Args& a) {
  if (vec == 4)
    run<MASK, 4>(a);
  else if (vec == 1)
    run<MASK, 1>(a);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || (MASK & kSxLoss) == 0) return static_cast<int>(err);
  ssr_fold_partials<<<1, kFoldThreads, 0, a.st>>>(a.partials, a.ctas, a.out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `mask`: the stages run (1 shift, 2 exp, 4 loss).  z, c, e, p are the
// streams of the values read from device memory (null where a value stays
// on chip or is not read).  Without the loss stage `out` receives the last
// stage's value through the dense output stream; with it, `partials` the
// per-CTA sums and out[0] their fold.  `vec` is 4 when every used stream
// (and a map's output) allows 16-byte row accesses.
extern "C" int ssr_dag_softmax_xent(int mask, const void* z, const void* c,
                                    const void* e, const void* p, void* out,
                                    void* partials, int vec,
                                    const SsrGrid* g, const SsrStream* sz,
                                    const SsrStream* sc, const SsrStream* se,
                                    const SsrStream* sp, const SsrStream* so,
                                    int64_t num_ctas, int64_t steps_per_cta,
                                    void* stream) {
  Args a{static_cast<const float*>(z), static_cast<const float*>(c),
         static_cast<const float*>(e), static_cast<const float*>(p),
         static_cast<float*>(out), static_cast<float*>(partials), *g, *sz,
         *sc, *se, *sp, *so, 1, num_ctas, steps_per_cta,
         static_cast<cudaStream_t>(stream)};
  for (int k = 0; k < g->ndim; ++k) a.steps *= g->dims[k];
  switch (mask) {
    case 7: return launch<7>(vec, a);
    case 1: return launch<1>(vec, a);
    case 2: return launch<2>(vec, a);
    case 4: return launch<4>(vec, a);
    case 6: return launch<6>(vec, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int64_t ssr_dag_softmax_xent_smem_bytes() {
  return static_cast<int64_t>(sizeof(float)) * (kFoldThreads / 32);
}
