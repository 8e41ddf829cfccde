// R7 ring_dag_layernorm: K6's layernorm diamond, fused and as every
// component a legal cut leaves, its read streams delivered through an
// N-deep shared-memory ring.
//
// Replaces the TPU kernel repro/core/ssr.py:_pipelined_call (the N-deep
// rotation that ssr_pallas emits at buffer_depth > 2) around the DAG
// assembler repro/core/lowering.py:_build_dag_kernel (:1720-1769, the depths
// handed to _assemble_kernel at :1316) and the bodies of
// repro/kernels/dag.py:88-102 (_ln_centre, _ln_square, _ln_normalise).
//
// Bound on H100: bytes, as K6.
//
// Design: K6's partition and arithmetic, with the delivery of
// ssr_ring.cuh.  The wrapper splits the steps over CTAs exactly as for K6
// (contiguous runs, 8 CTAs an SM), whatever the depths.  The ring holds the
// values the subset reads, in LnReads' order: x (or C), then V where the
// normalise stage reads it from its stream -- one or two streams, each at
// its own depth, each fetched by its own group of the CTA's eight warps
// (cp.async groups are per thread, so a thread waits on its own stream's
// fetch alone).  A slot is one (rows, 128) block, the rows one after
// another.  Each warp then runs ssr_dag.cuh::ln_row -- K6's arithmetic,
// with the lane mapping of K6's vector width -- on its rows of the step's
// slots, and writes the output row to device memory as K6 does: the same
// bits as K6 at every depth.
#include "ssr_dag.cuh"
#include "ssr_ring.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <int MASK, int V>
__global__ void __launch_bounds__(kThreads)
    ring_dag_layernorm_kernel(const float* __restrict__ x,
                              const float* __restrict__ c_in,
                              const float* __restrict__ v_in,
                              float* __restrict__ out, SsrGrid g,
                              SsrStream sx, SsrStream sc, SsrStream sv,
                              SsrStream so, int64_t steps,
                              int64_t steps_per_cta, SsrRing ring) {
  using R = LnReads<MASK>;
  constexpr int kStreams = R::streams;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t s0 = static_cast<int64_t>(blockIdx.x) * steps_per_cta;
  const int64_t run = (s0 + steps_per_cta < steps ? s0 + steps_per_cta : steps) - s0;
  const int rows = static_cast<int>(so.block[0]);
  const int tile = rows * kRowLanes;
  const float* first = R::x ? x : c_in;
  const SsrStream& sfirst = R::x ? sx : sc;
  float* const slots0 = smem;
  float* const slots1 = slots0 + ring.depth[0] * tile;

  const SsrRingGroup grp(kStreams);
  const int mine = grp.stream;
  SsrRingSide side(ring, mine);
  SsrRingSide r0(ring, 0), r1(ring, kStreams > 1 ? 1 : 0);
  int64_t dmax = r0.depth > 2 ? r0.depth : 2;
  if (r1.depth > dmax) dmax = r1.depth;
  SsrOdometer fetch_at(g, s0), odo(g, s0);
  auto fetch = [&](int slot) {
    const float* src = mine == 0 ? first + fetch_at.origin(sfirst)
                                 : v_in + fetch_at.origin(sv);
    const int64_t pitch = mine == 0 ? sfirst.pitch : sv.pitch;
    ssr_ring_copy<float>((mine == 0 ? slots0 : slots1) + slot * tile,
                         kRowLanes, src, pitch, rows, kRowLanes, V > 1,
                         grp.lane, grp.size);
    fetch_at.advance(g);
  };

  for (int64_t u = 1 - dmax; u < 0; ++u) side.issue(u, 1 - dmax, run, fetch);
  for (int64_t u = 0; u < run; ++u) {
    side.wait();
    __syncthreads();
    side.issue(u, 1 - dmax, run, fetch);
    const float* b0 = slots0 + r0.slot() * tile;
    const float* b1 = slots1 + r1.slot() * tile;
    for (int r = warp; r < rows; r += kWarps)
      ln_row<MASK, V>(b0 + r * kRowLanes, b0 + r * kRowLanes,
                      b1 + r * kRowLanes, out + ssr_row_origin(odo, so, r),
                      lane);
    odo.advance(g);
    r0.step();
    if (kStreams > 1) r1.step();
  }
}

struct Args {
  const float *x, *c, *v;
  float* out;
  SsrGrid g;
  SsrStream sx, sc, sv, so;
  SsrRing ring;
  int64_t smem, steps, ctas, per_cta;
  cudaStream_t st;
};

template <int MASK, int V>
int launch(const Args& a) {
  auto kernel = ring_dag_layernorm_kernel<MASK, V>;
  cudaError_t err = ssr_ring_smem(kernel, a.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(a.ctas), kThreads, a.smem, a.st>>>(
      a.x, a.c, a.v, a.out, a.g, a.sx, a.sc, a.sv, a.so, a.steps, a.per_cta,
      a.ring);
  return static_cast<int>(cudaGetLastError());
}

template <int MASK>
int launch_vec(int vec, const Args& a) {
  int64_t need = 0;
  for (int i = 0; i < LnReads<MASK>::streams; ++i) need += a.ring.depth[i];
  need *= a.so.block[0] * kRowLanes * static_cast<int64_t>(sizeof(float));
  if (a.smem < need || a.so.block[1] != kRowLanes)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec == 4) return launch<MASK, 4>(a);
  if (vec == 1) return launch<MASK, 1>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// As ssr_dag_layernorm, plus the ring of the values the subset reads in
// LnReads' order (x or c, then v; an invariant stream one slot) and
// `smem_bytes`, the ring's bytes as the wrapper counted them, checked here
// against the layout the kernel uses.
extern "C" int ssr_ring_dag_layernorm(int mask, const void* x, const void* c,
                                      const void* v, void* out, int vec,
                                      const SsrGrid* g, const SsrStream* sx,
                                      const SsrStream* sc,
                                      const SsrStream* sv,
                                      const SsrStream* so,
                                      const SsrRing* ring, int64_t smem_bytes,
                                      int64_t num_ctas, int64_t steps_per_cta,
                                      void* stream) {
  Args a{static_cast<const float*>(x), static_cast<const float*>(c),
         static_cast<const float*>(v), static_cast<float*>(out), *g, *sx,
         *sc, *sv, *so, *ring, smem_bytes, 1, num_ctas, steps_per_cta,
         static_cast<cudaStream_t>(stream)};
  for (int k = 0; k < g->ndim; ++k) a.steps *= g->dims[k];
  switch (mask) {
    case 7: return launch_vec<7>(vec, a);
    case 1: return launch_vec<1>(vec, a);
    case 2: return launch_vec<2>(vec, a);
    case 4: return launch_vec<4>(vec, a);
    case 6: return launch_vec<6>(vec, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int64_t ssr_ring_dag_layernorm_smem_bytes() { return 0; }
