// R1 ring_reduce_mul: K1's sum of promote(a_blk) * promote(b_blk) over every
// grid step, its blocks delivered through an N-deep shared-memory ring.
//
// Replaces the TPU kernel repro/core/ssr.py:_pipelined_call (the N-deep
// rotation a schedule with buffer_depth > 2 emits) around the reduce
// epilogue of repro/core/lowering.py:_assemble_kernel and the body
// repro/kernels/reduction.py:_mul_body.
//
// Bound on H100: bytes, as K1 -- each element is read once for one
// multiply-add.
//
// Design: K1's partition and arithmetic, with the delivery of
// ssr_ring.cuh.  The wrapper splits the steps over CTAs exactly as for K1
// (contiguous runs, 8 CTAs an SM), whatever the depth: a deeper ring only
// lowers how many CTAs fit on an SM.  Threads 0-127 fetch stream a and
// 128-255 stream b, each block whole into its stream's next slot (16-byte
// copies where K1 would read 16-byte packs).  Every thread then reads the
// same packs of each block, in the same order, from the slot as K1 reads
// them from device memory, and accumulates them the same way, so the
// partials -- and the fold, the one-CTA second launch shared with the DAG
// kernels -- give the same bits as K1 at every depth.
#include "ssr_ring.cuh"
#include "ssr_rows.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kHalf = kThreads / 2;

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    ring_reduce_mul_partials(const T* __restrict__ a, const T* __restrict__ b,
                             SsrGrid g, SsrStream sa, SsrStream sb,
                             int64_t steps, int64_t steps_per_cta,
                             SsrRing ring, float* __restrict__ partials) {
  using Pack = SsrPack<T, V>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t s0 = static_cast<int64_t>(blockIdx.x) * steps_per_cta;
  const int64_t run = (s0 + steps_per_cta < steps ? s0 + steps_per_cta : steps) - s0;
  const int rows = static_cast<int>(sa.block[0]);
  const int cols = static_cast<int>(sa.block[1]);
  const int packs = cols / V;
  const int tile = rows * cols;
  T* const a_slots = reinterpret_cast<T*>(smem);
  T* const b_slots = a_slots + ring.depth[0] * tile;

  // this thread's stream: a on the first half of the CTA, b on the second
  const int mine = threadIdx.x < kHalf ? 0 : 1;
  T* const my_slots = mine ? b_slots : a_slots;
  const int64_t pitch = mine ? sb.pitch : sa.pitch;
  SsrRingSide side(ring, mine);
  SsrRingSide ra(ring, 0), rb(ring, 1);
  const int64_t dmax = ring.depth[0] > ring.depth[1] ? ring.depth[0] : ring.depth[1];
  SsrOdometer fetch_at(g, s0);
  auto fetch = [&](int slot) {
    const T* src = mine ? b + fetch_at.origin(sb) : a + fetch_at.origin(sa);
    ssr_ring_copy<T>(my_slots + slot * tile, cols, src, pitch, rows, cols,
                     V > 1, threadIdx.x - mine * kHalf, kHalf);
    fetch_at.advance(g);
  };

  float acc = 0.f;
  for (int64_t u = 1 - dmax; u < 0; ++u) side.issue(u, 1 - dmax, run, fetch);
  for (int64_t u = 0; u < run; ++u) {
    side.wait();
    __syncthreads();
    side.issue(u, 1 - dmax, run, fetch);
    const T* pa = a_slots + ra.slot() * tile;
    const T* pb = b_slots + rb.slot() * tile;
    for (SsrBlockWalk w(threadIdx.x, kThreads, packs); w.r < rows; w.next()) {
      const Pack xa = *reinterpret_cast<const Pack*>(pa + w.r * cols + w.c * V);
      const Pack xb = *reinterpret_cast<const Pack*>(pb + w.r * cols + w.c * V);
#pragma unroll
      for (int j = 0; j < V; ++j) acc += ssr_f32(xa.v[j]) * ssr_f32(xb.v[j]);
    }
    ra.step();
    rb.step();
  }
  __syncthreads();  // the last step's slots are read: the warp sums reuse them
  acc = ssr_ring_cta_sum<kThreads>(acc, reinterpret_cast<float*>(smem));
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

template <typename T, int V>
int launch(const void* a, const void* b, const SsrGrid* g, const SsrStream* sa,
           const SsrStream* sb, const SsrRing* ring, int64_t smem,
           int64_t steps, int64_t num_ctas, int64_t steps_per_cta, float* part,
           cudaStream_t st) {
  auto kernel = ring_reduce_mul_partials<T, V>;
  cudaError_t err = ssr_ring_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(num_ctas), kThreads, smem, st>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), *g, *sa, *sb, steps,
      steps_per_cta, *ring, part);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `vec` as for K1 (16 / sizeof(element) when every stream allows 16-byte
// accesses, else 1); `smem_bytes` the ring's bytes as the wrapper counted
// them, checked here against the layout the kernel uses.
extern "C" int ssr_ring_reduce_mul(const void* a, const void* b, int dtype,
                                   int vec, const SsrGrid* g,
                                   const SsrStream* sa, const SsrStream* sb,
                                   const SsrRing* ring, int64_t smem_bytes,
                                   void* partials, int64_t num_ctas,
                                   int64_t steps_per_cta, void* out,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int64_t steps = 1;
  for (int k = 0; k < g->ndim; ++k) steps *= g->dims[k];
  const int64_t size = dtype == SSR_BF16 ? 2 : 4;
  const int64_t need = (ring->depth[0] + ring->depth[1]) * sa->block[0] *
                       sa->block[1] * size;
  if (smem_bytes < need || smem_bytes < 4 * (kThreads / 32))
    return static_cast<int>(cudaErrorInvalidValue);
  float* part = static_cast<float*>(partials);
  const int64_t n = num_ctas, per = steps_per_cta;
  int rc;
  if (dtype == SSR_F32 && vec == 4)
    rc = launch<float, 4>(a, b, g, sa, sb, ring, smem_bytes, steps, n, per, part, st);
  else if (dtype == SSR_F32 && vec == 1)
    rc = launch<float, 1>(a, b, g, sa, sb, ring, smem_bytes, steps, n, per, part, st);
  else if (dtype == SSR_BF16 && vec == 8)
    rc = launch<__nv_bfloat16, 8>(a, b, g, sa, sb, ring, smem_bytes, steps, n, per, part, st);
  else if (dtype == SSR_BF16 && vec == 1)
    rc = launch<__nv_bfloat16, 1>(a, b, g, sa, sb, ring, smem_bytes, steps, n, per, part, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (rc != 0) return rc;
  ssr_fold_partials<<<1, kFoldThreads, 0, st>>>(part, num_ctas,
                                                static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Static shared memory of the ring kernel: none (the ring and the warp sums
// are dynamic).
extern "C" int64_t ssr_ring_reduce_mul_smem_bytes() { return 0; }
