// K5 chain_elem: the elementwise stream chains of repro/kernels/chained.py,
// fused and as their unfused stages.
//
// Replaces the TPU kernel repro/core/lowering.py:_build_chain_kernel (through
// _assemble_kernel and repro/core/ssr.py:ssr_pallas) with the bodies of
// repro/kernels/chained.py: sum_sq_diff's _sq_diff_block -> _identity_block
// (:155, :160) and axpy_dot's _axpy_block -> _dot_block (:216, :222).  On the
// TPU one grid walks the streams; the producer's block goes to a VMEM scratch
// block, the consumer reads it back the same step, and the reduce epilogue
// carries a (rows, lanes) accumulator over the `arbitrary` grid.
//
// Programs (`prog`), one template each: the five of ssr_chain.cuh.  The
// unfused consumer of axpy_dot, sum t * w, is K1 reduce_mul.
//
// Bound on H100: bytes.  Each input element is read once for one or two
// operations; a map writes each output once.  Fused, the intermediate never
// reaches device memory: 8 bytes per element for sum_sq_diff against 16
// unfused (read x, y; write t; read t), 12 against 20 for axpy_dot.
//
// Design: K1's walk.  The same CTA split (hopper._ctas), an odometer over the
// lowered grid (no division per step), 16-byte packs where the wrapper found
// every stream aligned for them.  The intermediate lives in registers; each
// product is rounded as the reference rounds it (__fmul_rn, __fadd_rn: no
// contraction into an FMA), so the map programs equal the plain version to
// the bit.  A reduce leaves per-CTA partials, folded in a fixed order by a
// second one-CTA launch: no atomics, the same bits from run to run.
#include "ssr_chain.cuh"
#include "ssr_rows.cuh"

namespace {

constexpr int kThreads = 256;

template <int PROG, int V>
__global__ void __launch_bounds__(kThreads)
    chain_reduce(const float* __restrict__ a, const float* __restrict__ b,
                 const float* __restrict__ c, float alpha, SsrGrid g,
                 SsrStream sa, SsrStream sb, SsrStream sc, int64_t steps,
                 int64_t steps_per_cta, float* __restrict__ partials) {
  using Pack = SsrPack<float, V>;
  constexpr bool kB = PROG != 4, kC = PROG == 1;
  const int64_t s0 = static_cast<int64_t>(blockIdx.x) * steps_per_cta;
  const int64_t s1 = s0 + steps_per_cta < steps ? s0 + steps_per_cta : steps;
  const int rows = static_cast<int>(sa.block[0]);
  const int packs = static_cast<int>(sa.block[1]) / V;
  float acc = 0.f;
  SsrOdometer odo(g, s0);
  for (int64_t s = s0; s < s1; ++s, odo.advance(g)) {
    const float* pa = a + odo.origin(sa);
    const float* pb = kB ? b + odo.origin(sb) : nullptr;
    const float* pc = kC ? c + odo.origin(sc) : nullptr;
    for (SsrBlockWalk w(threadIdx.x, kThreads, packs); w.r < rows; w.next()) {
      const int64_t col = static_cast<int64_t>(w.c) * V;
      const Pack xa = *reinterpret_cast<const Pack*>(pa + w.r * sa.pitch + col);
      Pack xb{}, xc{};
      if constexpr (kB) xb = *reinterpret_cast<const Pack*>(pb + w.r * sb.pitch + col);
      if constexpr (kC) xc = *reinterpret_cast<const Pack*>(pc + w.r * sc.pitch + col);
#pragma unroll
      for (int j = 0; j < V; ++j)
        acc += chain_value<PROG>(xa.v[j], xb.v[j], xc.v[j], alpha);
    }
  }
  acc = ssr_cta_sum<kThreads>(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

template <int PROG, int V>
__global__ void __launch_bounds__(kThreads)
    chain_map(const float* __restrict__ a, const float* __restrict__ b,
              float* __restrict__ out, float alpha, SsrGrid g, SsrStream sa,
              SsrStream sb, SsrStream so, int64_t steps,
              int64_t steps_per_cta) {
  using Pack = SsrPack<float, V>;
  const int64_t s0 = static_cast<int64_t>(blockIdx.x) * steps_per_cta;
  const int64_t s1 = s0 + steps_per_cta < steps ? s0 + steps_per_cta : steps;
  const int rows = static_cast<int>(sa.block[0]);
  const int packs = static_cast<int>(sa.block[1]) / V;
  SsrOdometer odo(g, s0);
  for (int64_t s = s0; s < s1; ++s, odo.advance(g)) {
    const float* pa = a + odo.origin(sa);
    const float* pb = b + odo.origin(sb);
    float* po = out + odo.origin(so);
    for (SsrBlockWalk w(threadIdx.x, kThreads, packs); w.r < rows; w.next()) {
      const int64_t col = static_cast<int64_t>(w.c) * V;
      const Pack xa = *reinterpret_cast<const Pack*>(pa + w.r * sa.pitch + col);
      const Pack xb = *reinterpret_cast<const Pack*>(pb + w.r * sb.pitch + col);
      Pack y;
#pragma unroll
      for (int j = 0; j < V; ++j)
        y.v[j] = chain_value<PROG>(xa.v[j], xb.v[j], 0.f, alpha);
      *reinterpret_cast<Pack*>(po + w.r * so.pitch + col) = y;
    }
  }
}

struct Args {
  const float *a, *b, *c;
  float* out;
  float alpha;
  SsrGrid g;
  SsrStream sa, sb, sc, so;
  int64_t steps, ctas, per_cta;
  float* partials;
  cudaStream_t st;
};

template <int PROG, int V>
void launch(const Args& x) {
  const unsigned n = static_cast<unsigned>(x.ctas);
  if constexpr (PROG == 2 || PROG == 3)
    chain_map<PROG, V><<<n, kThreads, 0, x.st>>>(x.a, x.b, x.out, x.alpha, x.g,
                                                 x.sa, x.sb, x.so, x.steps,
                                                 x.per_cta);
  else
    chain_reduce<PROG, V><<<n, kThreads, 0, x.st>>>(
        x.a, x.b, x.c, x.alpha, x.g, x.sa, x.sb, x.sc, x.steps, x.per_cta,
        x.partials);
}

template <int PROG>
int launch_vec(int vec, const Args& x) {
  if (vec == 4)
    launch<PROG, 4>(x);
  else if (vec == 1)
    launch<PROG, 1>(x);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `prog` as listed above.  Streams a, b, c carry the program's operands in
// its order (x, y, w; t alone for prog 4); an unused one is null.  `vec` is
// 4 when every used stream's pitch, block width and base pointer (and a
// map's output) allow 16-byte accesses, else 1.  A reduce writes its
// per-CTA sums to `partials` and their fold to out[0].
extern "C" int ssr_chain_elem(int prog, const void* a, const void* b,
                              const void* c, void* out, float alpha, int vec,
                              const SsrGrid* g, const SsrStream* sa,
                              const SsrStream* sb, const SsrStream* sc,
                              const SsrStream* so, void* partials,
                              int64_t num_ctas, int64_t steps_per_cta,
                              void* stream) {
  Args x{static_cast<const float*>(a), static_cast<const float*>(b),
         static_cast<const float*>(c), static_cast<float*>(out), alpha, *g,
         *sa, *sb, *sc, *so, 1, num_ctas, steps_per_cta,
         static_cast<float*>(partials), static_cast<cudaStream_t>(stream)};
  for (int k = 0; k < g->ndim; ++k) x.steps *= g->dims[k];
  int rc;
  switch (prog) {
    case 0: rc = launch_vec<0>(vec, x); break;
    case 1: rc = launch_vec<1>(vec, x); break;
    case 2: rc = launch_vec<2>(vec, x); break;
    case 3: rc = launch_vec<3>(vec, x); break;
    case 4: rc = launch_vec<4>(vec, x); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0 || prog == 2 || prog == 3) return rc;
  ssr_fold_partials<<<1, kFoldThreads, 0, x.st>>>(x.partials, num_ctas,
                                                  x.out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int64_t ssr_chain_elem_smem_bytes() {
  return static_cast<int64_t>(sizeof(float)) * (kFoldThreads / 32);
}
