// R5 ring_chained_map: K17's out_blk = consumer(producer(*in_blks)) for
// every grid step of a ChainedKernel's Launch, the read streams delivered
// through an N-deep shared-memory ring.
//
// Replaces the TPU kernel repro/core/ssr.py:_pipelined_call (the N-deep
// rotation that repro/kernels/frontend.py:ChainedKernel._build emits through
// ssr_pallas at a uniform buffer_depth > 2) around the ChainedKernel body:
// producer block -> VMEM scratch -> consumer block in one grid step.
//
// Bound on H100: bytes, as K17.
//
// Design: K17's partition (contiguous runs of steps, 64 CTAs an SM) and its
// arithmetic (ssr_chained_map.cuh), with the delivery of ssr_ring.cuh.  The
// depth is uniform and a runtime argument.  The CTA's warps split into one
// fetching group per read stream (all eight for a one-stream producer, four
// and four for two): cp.async groups are per thread, so a thread's pending
// groups are its own stream's fetches.  A stream whose block never moves is
// fetched once into slot 0 and given that one slot.  Every thread then reads
// the same packs of each block from the slots that K17 reads from device
// memory, computes the same value and writes it through the output stream's
// AGU programming: the same bits as K17 at every depth.
#include "ssr_chained_map.cuh"
#include "ssr_ring.cuh"

namespace {

constexpr int kThreads = 256;

template <int P, int C, typename T, int V>
__global__ void __launch_bounds__(kThreads)
    ring_chained_map_kernel(const T* __restrict__ a, const T* __restrict__ b,
                            T* __restrict__ out, float alpha, SsrGrid g,
                            SsrStream sa, SsrStream sb, SsrStream so,
                            int64_t steps, int64_t steps_per_cta, SsrRing ring) {
  using Pack = SsrPack<T, V>;
  constexpr int kStreams = ssr_producer_streams<P>();
  extern __shared__ __align__(16) unsigned char smem[];
  const T al = ssr_cast<T>(alpha);
  const int64_t s0 = static_cast<int64_t>(blockIdx.x) * steps_per_cta;
  const int64_t run = (s0 + steps_per_cta < steps ? s0 + steps_per_cta : steps) - s0;
  const int rows = static_cast<int>(so.block[0]);
  const int cols = static_cast<int>(so.block[1]);
  const int packs = cols / V;
  const int tile = rows * cols;
  T* const a_slots = reinterpret_cast<T*>(smem);
  T* const b_slots = a_slots + ring.depth[0] * tile;

  const SsrRingGroup grp(kStreams);
  const int mine = grp.stream;
  SsrRingSide side(ring, mine);
  SsrRingSide ra(ring, 0), rb(ring, kStreams - 1);
  int64_t dmax = ra.depth > 2 ? ra.depth : 2;
  if (rb.depth > dmax) dmax = rb.depth;
  SsrOdometer fetch_at(g, s0), odo(g, s0);
  auto fetch = [&](int slot) {
    const T* src = mine ? b + fetch_at.origin(sb) : a + fetch_at.origin(sa);
    ssr_ring_copy<T>((mine ? b_slots : a_slots) + slot * tile, cols, src,
                     mine ? sb.pitch : sa.pitch, rows, cols, V > 1, grp.lane,
                     grp.size);
    fetch_at.advance(g);
  };

  for (int64_t u = 1 - dmax; u < 0; ++u) side.issue(u, 1 - dmax, run, fetch);
  for (int64_t u = 0; u < run; ++u) {
    side.wait();
    __syncthreads();
    side.issue(u, 1 - dmax, run, fetch);
    const T* pa = a_slots + ra.slot() * tile;
    const T* pb = b_slots + rb.slot() * tile;
    T* po = out + odo.origin(so);
    for (SsrBlockWalk w(threadIdx.x, kThreads, packs); w.r < rows; w.next()) {
      const int off = w.r * cols + w.c * V;
      const Pack xa = *reinterpret_cast<const Pack*>(pa + off);
      Pack xb{};
      if constexpr (kStreams == 2) xb = *reinterpret_cast<const Pack*>(pb + off);
      Pack y;
#pragma unroll
      for (int j = 0; j < V; ++j) y.v[j] = ssr_chained_value<P, C, T>(xa.v[j], xb.v[j], al);
      *reinterpret_cast<Pack*>(po + static_cast<int64_t>(w.r) * so.pitch + w.c * V) = y;
    }
    odo.advance(g);
    ra.step();
    if (kStreams == 2) rb.step();
  }
}

struct Args {
  const void *a, *b;
  void* out;
  float alpha;
  SsrGrid g;
  SsrStream sa, sb, so;
  SsrRing ring;
  int64_t smem, steps, ctas, per_cta;
  cudaStream_t st;
};

template <int P, int C, typename T, int V>
int launch(const Args& x) {
  auto kernel = ring_chained_map_kernel<P, C, T, V>;
  cudaError_t err = ssr_ring_smem(kernel, x.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(x.ctas), kThreads, x.smem, x.st>>>(
      static_cast<const T*>(x.a), static_cast<const T*>(x.b), static_cast<T*>(x.out),
      x.alpha, x.g, x.sa, x.sb, x.so, x.steps, x.per_cta, x.ring);
  return static_cast<int>(cudaGetLastError());
}

template <int P, int C>
struct Program {
  static int run(int dtype, int vec, const Args& x) {
    const int64_t size = dtype == SSR_BF16 ? 2 : 4;
    int64_t need = x.ring.depth[0];
    if (ssr_producer_streams<P>() == 2) need += x.ring.depth[1];
    if (x.smem < need * x.so.block[0] * x.so.block[1] * size)
      return static_cast<int>(cudaErrorInvalidValue);
    if (dtype == SSR_F32 && vec == 4) return launch<P, C, float, 4>(x);
    if (dtype == SSR_F32 && vec == 1) return launch<P, C, float, 1>(x);
    if (dtype == SSR_BF16 && vec == 8) return launch<P, C, __nv_bfloat16, 8>(x);
    if (dtype == SSR_BF16 && vec == 1) return launch<P, C, __nv_bfloat16, 1>(x);
    return static_cast<int>(cudaErrorInvalidValue);
  }
};

}  // namespace

// As ssr_chained_map, plus the ring (a's and b's depth and invariance; an
// invariant stream one slot) and `smem_bytes`, the ring's bytes as the
// wrapper counted them, checked here against the layout the kernel uses.
extern "C" int ssr_ring_chained_map(int prog, const void* a, const void* b,
                                    void* out, int dtype, int vec, float alpha,
                                    const SsrGrid* g, const SsrStream* sa,
                                    const SsrStream* sb, const SsrStream* so,
                                    const SsrRing* ring, int64_t smem_bytes,
                                    int64_t num_ctas, int64_t steps_per_cta,
                                    void* stream) {
  Args x{a, b, out, alpha, *g, *sa, *sb, *so, *ring, smem_bytes, 1, num_ctas,
         steps_per_cta, static_cast<cudaStream_t>(stream)};
  for (int k = 0; k < g->ndim; ++k) x.steps *= g->dims[k];
  return ssr_chained_dispatch<Program>(prog, dtype, vec, x);
}

extern "C" int64_t ssr_ring_chained_map_smem_bytes() { return 0; }
