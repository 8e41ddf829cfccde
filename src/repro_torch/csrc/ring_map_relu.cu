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
// Design: runs of consecutive steps, 64 CTAs an SM asked for (the split K2
// ran before it read ahead; core/hopper.py RING_MAP_PER_SM), four
// resident, each CTA a filling warp that fills its ring
// on mbarriers and 8 computing warps that meet no CTA barrier in the step
// loop (ssr_stage_ring.cuh).  Measured on an H100 (PERF.md), persistent
// CTAs in one wave took 13-15 % longer on the relu cells than this split:
// the stores, not the ring's delivery, set the pace there (without them
// the ring delivers 2**26 f32 in 0.089 ms).  Each computing thread takes
// K2's packs of the current block from the slot, selects max(0, v) as K2
// does and writes them from registers through the output stream's AGU
// programming.  The value is selected, never computed: the same bits as K2
// in every dtype.
#include "ssr_stage_ring.cuh"

namespace {

using namespace stage;

// CTAs an SM R2 is built for: 4, at 56 registers a thread.  At 5 (40
// registers) its bulk route spilled, and f32 ran 2 % slower on an H100
// (PERF.md), though bf16 ran 5 % faster.
constexpr int kMinCtas = 4;

template <typename T, int V>
__global__ void __launch_bounds__(kThreads, kMinCtas)
    ring_map_relu_kernel(const T* __restrict__ x, T* __restrict__ out,
                         SsrGrid g, SsrStream sx, SsrStream so, int64_t steps,
                         int64_t steps_per_cta, SsrRing ring) {
  using Pack = SsrPack<T, V>;
  constexpr bool kBulk = V > 1;   // the wrapper's 16-byte packs
  extern __shared__ __align__(128) unsigned char smem[];
  const int64_t s0 = static_cast<int64_t>(blockIdx.x) * steps_per_cta;
  const int run = static_cast<int>(
      (s0 + steps_per_cta < steps ? s0 + steps_per_cta : steps) - s0);
  const int rows = static_cast<int>(sx.block[0]);
  const int cols = static_cast<int>(sx.block[1]);
  const int tile = rows * cols;
  uint64_t* const bars = reinterpret_cast<uint64_t*>(smem);
  T* const slots = reinterpret_cast<T*>(smem + kBarrierBytes);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) init_ring(bars, static_cast<int>(ring.depth[0]), 0, kBulk);
  __syncthreads();   // the barriers are set: the steps begin
  if (warp == kComputeWarps) {   // the filling warp
    fill_ring<T, kBulk, 1>({x, slots, tile, rows}, {}, g, sx, sx, s0, run,
                           ring, bars, lane);
    return;
  }
  Reader rx(bars, ring, 0);
  gring::Walk at(g, s0);
  const SsrBlockWalk first(threadIdx.x, kComputeThreads, cols / V);
  for (int u = 0; u < run; ++u) {
    rx.wait();
    const T* px = slots + rx.slot() * tile;
    T* po = out + at.origin(so);
#pragma unroll 1
    for (SsrBlockWalk w = first; w.r < rows; w.next()) {
      Pack p = *reinterpret_cast<const Pack*>(px + w.r * cols + w.c * V);
#pragma unroll
      for (int j = 0; j < V; ++j) p.v[j] = ssr_relu(p.v[j]);
      *reinterpret_cast<Pack*>(po + static_cast<int64_t>(w.r) * so.pitch +
                               w.c * V) = p;
    }
    done_reading();
    if (lane == 0) rx.release();
    rx.next();
    at.advance(g);
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

// `vec` as for K2 (16 / sizeof(element), the bulk route, where both
// streams' base pointers, row pitches and block widths allow 16-byte
// accesses, else 1); `num_ctas` CTAs of `steps_per_cta` consecutive steps
// (the last one's run shorter), all resident at once; `smem_bytes` the
// barriers and the ring as the wrapper counted them, checked here.
extern "C" int ssr_ring_map_relu(const void* x, void* out, int dtype, int vec,
                                 const SsrGrid* g, const SsrStream* sx,
                                 const SsrStream* so, const SsrRing* ring,
                                 int64_t smem_bytes, int64_t num_ctas,
                                 int64_t steps_per_cta, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int64_t steps = 1;
  for (int k = 0; k < g->ndim; ++k) steps *= g->dims[k];
  const int64_t size = dtype == SSR_BF16 ? 2 : 4;
  const int64_t depth = ring->depth[0];
  if (depth < 2 || depth > 8 || steps_per_cta < 1 ||
      steps_per_cta > 0x7fffffffLL ||
      num_ctas != (steps + steps_per_cta - 1) / steps_per_cta ||
      smem_bytes != kBarrierBytes + depth * sx->block[0] * sx->block[1] * size)
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

// Registers a thread and local (spill) bytes, the most over every
// instantiation, as cudaFuncGetAttributes reads them, and the CTAs an SM
// of the main path's (f32, bulk) at `smem` bytes of dynamic shared memory
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor): out[0] numRegs, out[1]
// localSizeBytes, out[2] CTAs an SM.
extern "C" int ssr_ring_map_relu_attributes(int64_t* out, int64_t smem) {
  const void* const kernels[] = {
      reinterpret_cast<const void*>(ring_map_relu_kernel<float, 4>),
      reinterpret_cast<const void*>(ring_map_relu_kernel<float, 1>),
      reinterpret_cast<const void*>(ring_map_relu_kernel<__nv_bfloat16, 8>),
      reinterpret_cast<const void*>(ring_map_relu_kernel<__nv_bfloat16, 1>),
      reinterpret_cast<const void*>(ring_map_relu_kernel<int32_t, 4>),
      reinterpret_cast<const void*>(ring_map_relu_kernel<int32_t, 1>)};
  return attributes(kernels, kernels[0], smem, out);
}
