// R2 ring_map_relu: K2's out_blk = max(0, x_blk) for every grid step, the
// x blocks delivered through an N-deep shared-memory ring.
//
// Replaces the TPU kernel repro/core/ssr.py:_pipelined_call (the N-deep
// rotation a schedule with buffer_depth > 2 emits) around the map epilogue
// of repro/core/lowering.py:_assemble_kernel and the body
// repro/kernels/relu.py:relu_block.
//
// Bound on H100: bytes, as K2 -- one read and one write per element.
//
// Design: K2's partition (contiguous runs of steps, 64 CTAs an SM) with the
// delivery of ssr_ring.cuh: every thread fetches x's blocks into the ring,
// depth - 1 steps ahead (16-byte copies where K2 reads 16-byte packs), then
// reads its packs of the current block from the slot, selects max(0, v) as
// K2 does and writes them through the output stream's AGU programming.  The
// value is selected, never computed: the same bits as K2 in every dtype.
#include "ssr_ring.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    ring_map_relu_kernel(const T* __restrict__ x, T* __restrict__ out,
                         SsrGrid g, SsrStream sx, SsrStream so, int64_t steps,
                         int64_t steps_per_cta, SsrRing ring) {
  using Pack = SsrPack<T, V>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t s0 = static_cast<int64_t>(blockIdx.x) * steps_per_cta;
  const int64_t run = (s0 + steps_per_cta < steps ? s0 + steps_per_cta : steps) - s0;
  const int rows = static_cast<int>(sx.block[0]);
  const int cols = static_cast<int>(sx.block[1]);
  const int packs = cols / V;
  const int tile = rows * cols;
  T* slots = reinterpret_cast<T*>(smem);
  SsrRingSide side(ring, 0);
  SsrOdometer fetch_at(g, s0), odo(g, s0);
  auto fetch = [&](int slot) {
    ssr_ring_copy<T>(slots + slot * tile, cols, x + fetch_at.origin(sx),
                     sx.pitch, rows, cols, V > 1, threadIdx.x, kThreads);
    fetch_at.advance(g);
  };

  for (int64_t u = 1 - side.depth; u < 0; ++u)
    side.issue(u, 1 - side.depth, run, fetch);
  for (int64_t u = 0; u < run; ++u) {
    side.wait();
    __syncthreads();
    side.issue(u, 1 - side.depth, run, fetch);
    const T* px = slots + side.slot() * tile;
    T* po = out + odo.origin(so);
    for (SsrBlockWalk w(threadIdx.x, kThreads, packs); w.r < rows; w.next()) {
      Pack p = *reinterpret_cast<const Pack*>(px + w.r * cols + w.c * V);
#pragma unroll
      for (int j = 0; j < V; ++j) p.v[j] = ssr_relu(p.v[j]);
      *reinterpret_cast<Pack*>(po + static_cast<int64_t>(w.r) * so.pitch +
                               w.c * V) = p;
    }
    odo.advance(g);
    side.step();
  }
}

template <typename T, int V>
int launch(const void* x, void* out, const SsrGrid* g, const SsrStream* sx,
           const SsrStream* so, const SsrRing* ring, int64_t smem,
           int64_t steps, int64_t num_ctas, int64_t steps_per_cta,
           cudaStream_t st) {
  auto kernel = ring_map_relu_kernel<T, V>;
  cudaError_t err = ssr_ring_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(num_ctas), kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<T*>(out), *g, *sx, *so, steps,
      steps_per_cta, *ring);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `vec` as for K2; `smem_bytes` the ring's bytes as the wrapper counted
// them, checked here against the layout the kernel uses.
extern "C" int ssr_ring_map_relu(const void* x, void* out, int dtype, int vec,
                                 const SsrGrid* g, const SsrStream* sx,
                                 const SsrStream* so, const SsrRing* ring,
                                 int64_t smem_bytes, int64_t num_ctas,
                                 int64_t steps_per_cta, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int64_t steps = 1;
  for (int k = 0; k < g->ndim; ++k) steps *= g->dims[k];
  const int64_t size = dtype == SSR_BF16 ? 2 : 4;
  if (smem_bytes < ring->depth[0] * sx->block[0] * sx->block[1] * size)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n = num_ctas, per = steps_per_cta;
  if (dtype == SSR_F32 && vec == 4)
    return launch<float, 4>(x, out, g, sx, so, ring, smem_bytes, steps, n, per, st);
  if (dtype == SSR_F32 && vec == 1)
    return launch<float, 1>(x, out, g, sx, so, ring, smem_bytes, steps, n, per, st);
  if (dtype == SSR_BF16 && vec == 8)
    return launch<__nv_bfloat16, 8>(x, out, g, sx, so, ring, smem_bytes, steps, n, per, st);
  if (dtype == SSR_BF16 && vec == 1)
    return launch<__nv_bfloat16, 1>(x, out, g, sx, so, ring, smem_bytes, steps, n, per, st);
  if (dtype == SSR_I32 && vec == 4)
    return launch<int32_t, 4>(x, out, g, sx, so, ring, smem_bytes, steps, n, per, st);
  if (dtype == SSR_I32 && vec == 1)
    return launch<int32_t, 1>(x, out, g, sx, so, ring, smem_bytes, steps, n, per, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int64_t ssr_ring_map_relu_smem_bytes() { return 0; }
