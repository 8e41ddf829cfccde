// R6 ring_chain_elem: K5's elementwise chain programs (ssr_chain.cuh), fused
// and as their unfused stages, the read streams delivered through an N-deep
// shared-memory ring.
//
// Replaces the TPU kernel repro/core/ssr.py:_pipelined_call (the N-deep
// rotation that ssr_pallas emits at buffer_depth > 2) around the chain
// assembler repro/core/lowering.py:_assemble_kernel (:1218-1322, the
// depths passed at :1316) and the bodies of repro/kernels/chained.py
// (:155-222): sum_sq_diff and axpy_dot fused, and their map and reduce
// stages alone.
//
// Bound on H100: bytes, as K5.
//
// Design: K5's partition and arithmetic, with the delivery of ssr_ring.cuh.
// The wrapper splits the steps over CTAs exactly as for K5 (contiguous runs,
// 8 CTAs an SM for a reduce, 64 for a map), whatever the depths, and hands
// the ring in the program's stream order (x, y, w; t alone): one or two or
// three read streams, each at its own depth.  The CTA's eight warps split
// into one fetching group a stream (8; 4 + 4; 2 + 3 + 3): cp.async groups
// are per thread, so a thread waits on its own stream's fetch of the step
// alone.  Every thread then reads the same packs of each block, in the same
// order, from the slots as K5 reads them from device memory, and computes
// chain_value as K5 does; a reduce sums in K5's order into per-CTA
// partials and the same one-CTA fixed-order fold: the same bits as K5 at
// every depth.  A stream whose block never moves is fetched once into one
// slot.
#include "ssr_chain.cuh"
#include "ssr_ring.cuh"
#include "ssr_rows.cuh"

namespace {

constexpr int kThreads = 256;

template <int PROG>
__host__ __device__ constexpr int chain_streams() {
  return PROG == 4 ? 1 : PROG == 1 ? 3 : 2;
}

template <int PROG, int V>
__global__ void __launch_bounds__(kThreads)
    ring_chain_kernel(const float* __restrict__ a, const float* __restrict__ b,
                      const float* __restrict__ c, float* __restrict__ out,
                      float alpha, SsrGrid g, SsrStream sa, SsrStream sb,
                      SsrStream sc, SsrStream so, int64_t steps,
                      int64_t steps_per_cta, SsrRing ring,
                      float* __restrict__ partials) {
  using Pack = SsrPack<float, V>;
  constexpr int kStreams = chain_streams<PROG>();
  constexpr bool kMap = PROG == 2 || PROG == 3;
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t s0 = static_cast<int64_t>(blockIdx.x) * steps_per_cta;
  const int64_t run = (s0 + steps_per_cta < steps ? s0 + steps_per_cta : steps) - s0;
  const int rows = static_cast<int>(sa.block[0]);
  const int cols = static_cast<int>(sa.block[1]);
  const int packs = cols / V;
  const int tile = rows * cols;
  float* const slots0 = reinterpret_cast<float*>(smem);
  float* const slots1 = slots0 + ring.depth[0] * tile;
  float* const slots2 = slots1 + (kStreams > 1 ? ring.depth[1] : 0) * tile;

  const SsrRingGroup grp(kStreams);
  const int mine = grp.stream;
  SsrRingSide side(ring, mine);
  SsrRingSide r0(ring, 0), r1(ring, kStreams > 1 ? 1 : 0), r2(ring, kStreams > 2 ? 2 : 0);
  int64_t dmax = r0.depth > 2 ? r0.depth : 2;
  if (r1.depth > dmax) dmax = r1.depth;
  if (r2.depth > dmax) dmax = r2.depth;
  SsrOdometer fetch_at(g, s0), odo(g, s0);
  auto fetch = [&](int slot) {
    const float* src = mine == 0   ? a + fetch_at.origin(sa)
                       : mine == 1 ? b + fetch_at.origin(sb)
                                   : c + fetch_at.origin(sc);
    float* dst = mine == 0 ? slots0 : mine == 1 ? slots1 : slots2;
    const int64_t pitch = mine == 0 ? sa.pitch : mine == 1 ? sb.pitch : sc.pitch;
    ssr_ring_copy<float>(dst + slot * tile, cols, src, pitch, rows, cols, V > 1,
                         grp.lane, grp.size);
    fetch_at.advance(g);
  };

  float acc = 0.f;
  for (int64_t u = 1 - dmax; u < 0; ++u) side.issue(u, 1 - dmax, run, fetch);
  for (int64_t u = 0; u < run; ++u) {
    side.wait();
    __syncthreads();
    side.issue(u, 1 - dmax, run, fetch);
    const float* pa = slots0 + r0.slot() * tile;
    const float* pb = slots1 + r1.slot() * tile;
    const float* pc = slots2 + r2.slot() * tile;
    float* po = kMap ? out + odo.origin(so) : nullptr;
    for (SsrBlockWalk w(threadIdx.x, kThreads, packs); w.r < rows; w.next()) {
      const int off = w.r * cols + w.c * V;
      const Pack xa = *reinterpret_cast<const Pack*>(pa + off);
      Pack xb{}, xc{};
      if constexpr (kStreams > 1) xb = *reinterpret_cast<const Pack*>(pb + off);
      if constexpr (kStreams > 2) xc = *reinterpret_cast<const Pack*>(pc + off);
      if constexpr (kMap) {
        Pack y;
#pragma unroll
        for (int j = 0; j < V; ++j)
          y.v[j] = chain_value<PROG>(xa.v[j], xb.v[j], 0.f, alpha);
        *reinterpret_cast<Pack*>(po + static_cast<int64_t>(w.r) * so.pitch +
                                 w.c * V) = y;
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j)
          acc += chain_value<PROG>(xa.v[j], xb.v[j], xc.v[j], alpha);
      }
    }
    if (kMap) odo.advance(g);
    r0.step();
    if (kStreams > 1) r1.step();
    if (kStreams > 2) r2.step();
  }
  if constexpr (!kMap) {
    __syncthreads();  // the last step's slots are read: the warp sums reuse them
    acc = ssr_ring_cta_sum<kThreads>(acc, reinterpret_cast<float*>(smem));
    if (threadIdx.x == 0) partials[blockIdx.x] = acc;
  }
}

struct Args {
  const float *a, *b, *c;
  float* out;
  float alpha;
  SsrGrid g;
  SsrStream sa, sb, sc, so;
  SsrRing ring;
  int64_t smem, steps, ctas, per_cta;
  float* partials;
  cudaStream_t st;
};

template <int PROG, int V>
int launch(const Args& x) {
  auto kernel = ring_chain_kernel<PROG, V>;
  cudaError_t err = ssr_ring_smem(kernel, x.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(x.ctas), kThreads, x.smem, x.st>>>(
      x.a, x.b, x.c, x.out, x.alpha, x.g, x.sa, x.sb, x.sc, x.so, x.steps,
      x.per_cta, x.ring, x.partials);
  return static_cast<int>(cudaGetLastError());
}

template <int PROG>
int launch_vec(int vec, const Args& x) {
  int64_t need = 0;
  for (int i = 0; i < chain_streams<PROG>(); ++i) need += x.ring.depth[i];
  need *= x.sa.block[0] * x.sa.block[1] * static_cast<int64_t>(sizeof(float));
  if (x.smem < need || x.smem < static_cast<int64_t>(sizeof(float)) * (kThreads / 32))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec == 4) return launch<PROG, 4>(x);
  if (vec == 1) return launch<PROG, 1>(x);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// As ssr_chain_elem, plus the ring in the program's stream order (depth and
// invariance of a, b, c; an invariant stream one slot) and `smem_bytes`,
// the ring's bytes as the wrapper counted them, checked here against the
// layout the kernel uses.
extern "C" int ssr_ring_chain_elem(int prog, const void* a, const void* b,
                                   const void* c, void* out, float alpha,
                                   int vec, const SsrGrid* g,
                                   const SsrStream* sa, const SsrStream* sb,
                                   const SsrStream* sc, const SsrStream* so,
                                   const SsrRing* ring, int64_t smem_bytes,
                                   void* partials, int64_t num_ctas,
                                   int64_t steps_per_cta, void* stream) {
  Args x{static_cast<const float*>(a), static_cast<const float*>(b),
         static_cast<const float*>(c), static_cast<float*>(out), alpha, *g,
         *sa, *sb, *sc, *so, *ring, smem_bytes, 1, num_ctas, steps_per_cta,
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
  ssr_fold_partials<<<1, kFoldThreads, 0, x.st>>>(x.partials, num_ctas, x.out);
  return static_cast<int>(cudaGetLastError());
}

// Static shared memory: the fold's warp sums (the ring is dynamic).
extern "C" int64_t ssr_ring_chain_elem_smem_bytes() {
  return static_cast<int64_t>(sizeof(float)) * (kFoldThreads / 32);
}
