// R8 ring_dag_softmax_xent: K7's softmax cross-entropy diamond, fused and
// as every component a legal cut leaves, its read streams delivered through
// an N-deep shared-memory ring.
//
// Replaces the TPU kernel repro/core/ssr.py:_pipelined_call (the N-deep
// rotation that ssr_pallas emits at buffer_depth > 2) around the DAG
// assembler repro/core/lowering.py:_build_dag_kernel (:1720-1769, the depths
// handed to _assemble_kernel at :1316) and the bodies of
// repro/kernels/dag.py:145-167 (_sx_shift, _sx_exp, _sx_loss).
//
// Bound on H100: bytes, as K7.
//
// Design: K7's partition and arithmetic, with the delivery of
// ssr_ring.cuh.  The wrapper splits the steps over CTAs exactly as for K7
// (contiguous runs, 8 CTAs an SM), whatever the depths.  The ring holds the
// values the subset reads, in SxReads' order: z (or C), then E where the
// loss stage reads it from its stream, then P -- one to three streams (the
// loss alone reads C, E and P), each at its own depth, each fetched by its
// own group of the CTA's eight warps (8; 4 + 4; 2 + 3 + 3).  A slot is one
// (rows, 128) block.  Each warp runs ssr_dag.cuh::sx_row -- K7's
// arithmetic, with the lane mapping of K7's vector width -- on its rows of
// the step's slots, in K7's order: a map subset writes its rows as K7
// does; with the loss, lane 0 of each warp adds its rows' losses in the
// same order, the CTA sums them in ssr_cta_sum's fixed order into the same
// per-CTA partial (its warp sums in the ring's memory, once the run is
// done), and the same one-CTA launch folds the partials: the same bits as
// K7 at every depth.
#include "ssr_dag.cuh"
#include "ssr_ring.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <int MASK, int V>
__global__ void __launch_bounds__(kThreads)
    ring_dag_softmax_xent_kernel(const float* __restrict__ z,
                                 const float* __restrict__ c_in,
                                 const float* __restrict__ e_in,
                                 const float* __restrict__ p,
                                 float* __restrict__ out,
                                 float* __restrict__ partials, SsrGrid g,
                                 SsrStream sz, SsrStream sc, SsrStream se,
                                 SsrStream sp, SsrStream so, int64_t steps,
                                 int64_t steps_per_cta, SsrRing ring) {
  using R = SxReads<MASK>;
  constexpr int kStreams = R::streams;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t s0 = static_cast<int64_t>(blockIdx.x) * steps_per_cta;
  const int64_t run = (s0 + steps_per_cta < steps ? s0 + steps_per_cta : steps) - s0;
  const float* first = R::z ? z : c_in;
  const SsrStream& sfirst = R::z ? sz : sc;
  // a reduce writes one (1, 1) block: the rows come from the read streams
  const int rows = static_cast<int>(sfirst.block[0]);
  const int tile = rows * kRowLanes;
  float* const slots0 = smem;
  float* const slots1 = slots0 + ring.depth[0] * tile;
  float* const slots2 = slots1 + (kStreams > 1 ? ring.depth[1] : 0) * tile;

  const SsrRingGroup grp(kStreams);
  const int mine = grp.stream;
  SsrRingSide side(ring, mine);
  SsrRingSide r0(ring, 0), r1(ring, kStreams > 1 ? 1 : 0),
      r2(ring, kStreams > 2 ? 2 : 0);
  int64_t dmax = r0.depth > 2 ? r0.depth : 2;
  if (r1.depth > dmax) dmax = r1.depth;
  if (r2.depth > dmax) dmax = r2.depth;
  // ring stream 1 is E where the subset reads it, else P; stream 2 is P
  const float* second = R::e ? e_in : p;
  const SsrStream& ssecond = R::e ? se : sp;
  SsrOdometer fetch_at(g, s0), odo(g, s0);
  auto fetch = [&](int slot) {
    const float* src = mine == 0   ? first + fetch_at.origin(sfirst)
                       : mine == 1 ? second + fetch_at.origin(ssecond)
                                   : p + fetch_at.origin(sp);
    const int64_t pitch = mine == 0   ? sfirst.pitch
                          : mine == 1 ? ssecond.pitch
                                      : sp.pitch;
    float* dst = mine == 0 ? slots0 : mine == 1 ? slots1 : slots2;
    ssr_ring_copy<float>(dst + slot * tile, kRowLanes, src, pitch, rows,
                         kRowLanes, V > 1, grp.lane, grp.size);
    fetch_at.advance(g);
  };

  float acc = 0.f;
  for (int64_t u = 1 - dmax; u < 0; ++u) side.issue(u, 1 - dmax, run, fetch);
  for (int64_t u = 0; u < run; ++u) {
    side.wait();
    __syncthreads();
    side.issue(u, 1 - dmax, run, fetch);
    const float* b0 = slots0 + r0.slot() * tile;
    const float* b1 = slots1 + r1.slot() * tile;
    const float* b2 = slots2 + r2.slot() * tile;
    const float* be = b1;
    const float* bp = R::ip == 1 ? b1 : b2;
    for (int r = warp; r < rows; r += kWarps) {
      const int at = r * kRowLanes;
      sx_row<MASK, V>(b0 + at, b0 + at, be + at, bp + at,
                      R::p ? nullptr : out + ssr_row_origin(odo, so, r),
                      lane, acc);
    }
    odo.advance(g);
    r0.step();
    if (kStreams > 1) r1.step();
    if (kStreams > 2) r2.step();
  }
  if constexpr ((MASK & kSxLoss) != 0) {
    __syncthreads();  // the last step's slots are read: the warp sums reuse them
    acc = ssr_ring_cta_sum<kThreads>(acc, smem);
    if (threadIdx.x == 0) partials[blockIdx.x] = acc;
  }
}

struct Args {
  const float *z, *c, *e, *p;
  float *out, *partials;
  SsrGrid g;
  SsrStream sz, sc, se, sp, so;
  SsrRing ring;
  int64_t smem, steps, ctas, per_cta;
  cudaStream_t st;
};

template <int MASK, int V>
int run(const Args& a) {
  auto kernel = ring_dag_softmax_xent_kernel<MASK, V>;
  cudaError_t err = ssr_ring_smem(kernel, a.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(a.ctas), kThreads, a.smem, a.st>>>(
      a.z, a.c, a.e, a.p, a.out, a.partials, a.g, a.sz, a.sc, a.se, a.sp,
      a.so, a.steps, a.per_cta, a.ring);
  return static_cast<int>(cudaGetLastError());
}

template <int MASK>
int launch(int vec, const Args& a) {
  using R = SxReads<MASK>;
  int64_t need = 0;
  for (int i = 0; i < R::streams; ++i) need += a.ring.depth[i];
  need *= (R::z ? a.sz : a.sc).block[0] * kRowLanes *
          static_cast<int64_t>(sizeof(float));
  if (a.smem < need ||
      a.smem < static_cast<int64_t>(sizeof(float)) * (kThreads / 32))
    return static_cast<int>(cudaErrorInvalidValue);
  int rc;
  if (vec == 4)
    rc = run<MASK, 4>(a);
  else if (vec == 1)
    rc = run<MASK, 1>(a);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (rc != 0 || (MASK & kSxLoss) == 0) return rc;
  ssr_fold_partials<<<1, kFoldThreads, 0, a.st>>>(a.partials, a.ctas, a.out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// As ssr_dag_softmax_xent, plus the ring of the values the subset reads in
// SxReads' order (z or c, then e, then p; an invariant stream one slot) and
// `smem_bytes`, the ring's bytes as the wrapper counted them, checked here
// against the layout the kernel uses.
extern "C" int ssr_ring_dag_softmax_xent(
    int mask, const void* z, const void* c, const void* e, const void* p,
    void* out, void* partials, int vec, const SsrGrid* g, const SsrStream* sz,
    const SsrStream* sc, const SsrStream* se, const SsrStream* sp,
    const SsrStream* so, const SsrRing* ring, int64_t smem_bytes,
    int64_t num_ctas, int64_t steps_per_cta, void* stream) {
  Args a{static_cast<const float*>(z), static_cast<const float*>(c),
         static_cast<const float*>(e), static_cast<const float*>(p),
         static_cast<float*>(out), static_cast<float*>(partials), *g, *sz,
         *sc, *se, *sp, *so, *ring, smem_bytes, 1, num_ctas, steps_per_cta,
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

// Static shared memory: the fold's warp sums (the ring is dynamic).
extern "C" int64_t ssr_ring_dag_softmax_xent_smem_bytes() {
  return static_cast<int64_t>(sizeof(float)) * (kFoldThreads / 32);
}
