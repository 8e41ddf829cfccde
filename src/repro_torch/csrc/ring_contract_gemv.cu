// R4 ring_contract_gemv: K4's y_blk += A_blk . x_blk^T over the trailing
// contraction axes (with K4's relu drain when asked), the A rows and x
// blocks delivered through an N-deep shared-memory ring.
//
// Replaces the TPU kernel repro/core/ssr.py:_pipelined_call (the N-deep
// rotation a schedule with buffer_depth > 2 emits) around the contraction
// branch of repro/core/lowering.py:_build_nest_kernel and the bodies
// repro/kernels/gemv.py:matvec_block and, with the drain,
// repro/kernels/chained.py:63-72 (matvec_relu).
//
// Bound on H100: bytes, as K4 -- each element of A is read once for one
// multiply-add.
//
// Design: the delivery of ssr_stage_ring.cuh.  A CTA is 8 computing warps,
// one row of the lowered row block each, and a filling warp that walks the
// CTA's steps ahead of them (fill_ring, as for R1 and R2) on full and
// empty mbarriers: the computing warps meet no CTA barrier in the step
// loop.  Where A's rows allow 16-byte packs (A's pitch is not the block's
// width, so one cp.async.bulk a row) lane r of the filling warp copies row
// r of a step and lane 0 the x block (the wrapper aligns x); other layouts
// take fill_block's element route, x too.  An x block that never moves (a
// contraction of one step) is fetched once.  The CTAs are persistent: each
// walks a run of whole, consecutive output blocks of its row group, the
// ring running on across each block's end, so its prologue is paid once a
// CTA.  Measured on an H100 (tools/gemv_spmv_ablation.py, PERF.md), a CTA
// moves about one step a microsecond whatever its ring's depth -- depth
// buys nothing past 2, CTAs an SM do -- so core/hopper.py ring_run_steps
// weighs each one-wave split's busiest SM, its bytes at the card's rate
// against its longest run's steps, and bf16, whose steps are half f32's,
// is built for 4 CTAs an SM.
//
// Each lane reads the packs K4's lane reads (columns c = lane, lane + 32,
// ... in packs of V, V from A's alignment as for K4), converts x to f32 as
// K4 stages it, and chains the same fmaf in the same order; the row sum
// folds across the warp as in K4 and the drain (relu selected as K2 does)
// writes once per output block.  So every output has K4's bits at every
// depth.  Eight rows a CTA keep a depth-8 ring of a 512-wide f32 block at
// 144 KiB.
#include "ssr_stage_ring.cuh"

namespace {

using namespace stage;

constexpr int kRowsPerCta = kComputeWarps;   // one row a computing warp
// CTAs an SM R4 is built for, the wrapper's most (core/hopper.py
// GEMV_RING_PER_SM): 4 in bf16 on the bulk route (at most 56 registers a
// thread), 3 in f32 and on the element routes (72: f32's takes 68)
template <typename T, int V>
constexpr int kMinCtas = sizeof(T) == 2 && V > 1 ? 4 : 3;

template <typename T, typename O, int V>
__global__ void __launch_bounds__(kThreads, (kMinCtas<T, V>))
    ring_contract_gemv_kernel(const T* __restrict__ a, const T* __restrict__ x,
                              O* __restrict__ y, SsrGrid g, SsrStream sa,
                              SsrStream sx, SsrStream sy, int64_t steps,
                              int64_t zsteps, int64_t groups,
                              int64_t blocks_per_run, int relu,
                              SsrRing ring) {
  using Pack = SsrPack<T, V>;
  constexpr bool kBulk = V > 1;   // the wrapper's 16-byte packs
  extern __shared__ __align__(128) unsigned char smem[];
  const int64_t runi = blockIdx.x / groups, grp = blockIdx.x % groups;
  const int64_t s0 = runi * blocks_per_run * zsteps;
  const int64_t s1 = s0 + blocks_per_run * zsteps < steps
                         ? s0 + blocks_per_run * zsteps : steps;
  const int run = static_cast<int>(s1 - s0);
  const int64_t tm = sa.block[0];
  const int tn = static_cast<int>(sa.block[1]);
  const int64_t r0 = grp * kRowsPerCta;
  const int rows = static_cast<int>(tm - r0 < kRowsPerCta ? tm - r0 : kRowsPerCta);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int a_tile = kRowsPerCta * tn;
  uint64_t* const bars = reinterpret_cast<uint64_t*>(smem);
  T* const a_slots = reinterpret_cast<T*>(smem + kBarrierBytes);
  T* const x_slots = a_slots + ring.depth[0] * a_tile;
  if (threadIdx.x == 0)
    init_ring(bars, static_cast<int>(ring.depth[0]),
              static_cast<int>(ring.depth[1]), kBulk);
  __syncthreads();   // the barriers are set: the steps begin
  if (warp == kComputeWarps) {   // the filling warp
    fill_ring<T, kBulk, 2, true>({a + r0 * sa.pitch, a_slots, a_tile, rows},
                           {x, x_slots, tn, 1}, g, sa, sx, s0, run, ring,
                           bars, lane);
    return;
  }
  Reader ra(bars, ring, 0), rx(bars, ring, 1);
  const bool live = warp < rows;
  float part = 0.f;
  int64_t z = 0;
  for (int u = 0; u < run; ++u) {
    ra.wait();
    rx.wait();
    if (live) {
      const T* row = a_slots + ra.slot() * a_tile + warp * tn;
      const T* xs = x_slots + rx.slot() * tn;
#pragma unroll 4
      for (int c = lane; c < tn / V; c += 32) {
        const Pack av = *reinterpret_cast<const Pack*>(row + c * V);
        const Pack xv = *reinterpret_cast<const Pack*>(xs + c * V);
#pragma unroll
        for (int j = 0; j < V; ++j)
          part = fmaf(ssr_f32(av.v[j]), ssr_f32(xv.v[j]), part);
      }
    }
    done_reading();
    if (lane == 0) {
      ra.release();
      rx.release();
    }
    ra.next();
    rx.next();
    if (++z == zsteps) {  // the output block's last step: drain
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      if (relu) part = ssr_relu(part);
      if (live && lane == 0)
        y[ssr_block_origin(sy, g, s0 + u) + r0 + warp] = ssr_cast<O>(part);
      part = 0.f;
      z = 0;
    }
  }
}

template <typename T, typename O>
int launch(int vec, const void* a, const void* x, void* y,
           const SsrGrid* g, const SsrStream* sa, const SsrStream* sx,
           const SsrStream* sy, int64_t steps, int64_t zsteps, int64_t ctas,
           int64_t groups, int64_t bpr, int relu, const SsrRing* ring,
           int64_t smem, cudaStream_t st) {
  constexpr int kV = 16 / sizeof(T);
  if (vec != kV && vec != 1) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = vec == kV ? ring_contract_gemv_kernel<T, O, kV>
                          : ring_contract_gemv_kernel<T, O, 1>;
  cudaError_t err = ssr_ring_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(ctas), kThreads, smem, st>>>(
      static_cast<const T*>(a), static_cast<const T*>(x), static_cast<O*>(y),
      *g, *sa, *sx, *sy, steps, zsteps, groups, bpr, relu, *ring);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `vec` as for K4 (from A's alignment: 16 / sizeof(element), the bulk
// route, else 1); `xvec` 1 when x's block rows allow 16-byte copies, which
// the bulk route needs (the wrapper aligns x; vec 1 takes x's elements
// whatever xvec); each CTA's run covers `blocks_per_run` output blocks
// of `zsteps` steps of its row group, all CTAs resident at once
// (core/hopper.py ring_run_steps); `relu` (0 or 1) selects the relu drain;
// `smem_bytes` the barriers and the ring as the wrapper counted them,
// checked here.
extern "C" int ssr_ring_contract_gemv(const void* a, const void* x, void* y,
                                      int in_dtype, int out_dtype, int vec,
                                      int xvec, const SsrGrid* g,
                                      const SsrStream* sa, const SsrStream* sx,
                                      const SsrStream* sy, int64_t zsteps,
                                      int64_t blocks_per_run, int relu,
                                      const SsrRing* ring, int64_t smem_bytes,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int64_t steps = 1;
  for (int k = 0; k < g->ndim; ++k) steps *= g->dims[k];
  const int64_t size = in_dtype == SSR_BF16 ? 2 : 4;
  const int64_t tn = sa->block[1];
  const int64_t da = ring->depth[0], dx = ring->depth[1];
  if (da < 2 || da > 8 || dx < 2 || dx > 8 || blocks_per_run < 1 ||
      (vec > 1 && xvec == 0) ||
      blocks_per_run * zsteps > 0x7fffffffLL ||
      smem_bytes != kBarrierBytes + (da * kRowsPerCta + dx) * tn * size)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t groups = (sa->block[0] + kRowsPerCta - 1) / kRowsPerCta;
  const int64_t blocks = steps / zsteps;
  const int64_t ctas = ((blocks + blocks_per_run - 1) / blocks_per_run) * groups;
  if (ctas > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (in_dtype == SSR_F32 && out_dtype == SSR_F32)
    return launch<float, float>(vec, a, x, y, g, sa, sx, sy, steps, zsteps, ctas, groups, blocks_per_run, relu, ring, smem_bytes, st);
  if (in_dtype == SSR_F32 && out_dtype == SSR_BF16)
    return launch<float, __nv_bfloat16>(vec, a, x, y, g, sa, sx, sy, steps, zsteps, ctas, groups, blocks_per_run, relu, ring, smem_bytes, st);
  if (in_dtype == SSR_BF16 && out_dtype == SSR_F32)
    return launch<__nv_bfloat16, float>(vec, a, x, y, g, sa, sx, sy, steps, zsteps, ctas, groups, blocks_per_run, relu, ring, smem_bytes, st);
  if (in_dtype == SSR_BF16 && out_dtype == SSR_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(vec, a, x, y, g, sa, sx, sy, steps, zsteps, ctas, groups, blocks_per_run, relu, ring, smem_bytes, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Static shared memory of the ring kernel: none (the barriers and the ring
// are dynamic).
extern "C" int64_t ssr_ring_contract_gemv_smem_bytes() { return 0; }

// Registers a thread and local (spill) bytes, the most over every
// instantiation (f32 and bf16 in and out, both routes of A), as
// cudaFuncGetAttributes reads them, and the CTAs an SM of the main path's
// (f32, bulk) at `smem` bytes of dynamic shared memory
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor): out[0] numRegs, out[1]
// localSizeBytes, out[2] CTAs an SM.
extern "C" int ssr_ring_contract_gemv_attributes(int64_t* out, int64_t smem) {
  const void* const kernels[] = {
      reinterpret_cast<const void*>(ring_contract_gemv_kernel<float, float, 4>),
      reinterpret_cast<const void*>(ring_contract_gemv_kernel<float, float, 1>),
      reinterpret_cast<const void*>(ring_contract_gemv_kernel<float, __nv_bfloat16, 4>),
      reinterpret_cast<const void*>(ring_contract_gemv_kernel<float, __nv_bfloat16, 1>),
      reinterpret_cast<const void*>(ring_contract_gemv_kernel<__nv_bfloat16, float, 8>),
      reinterpret_cast<const void*>(ring_contract_gemv_kernel<__nv_bfloat16, float, 1>),
      reinterpret_cast<const void*>(ring_contract_gemv_kernel<__nv_bfloat16, __nv_bfloat16, 8>),
      reinterpret_cast<const void*>(ring_contract_gemv_kernel<__nv_bfloat16, __nv_bfloat16, 1>)};
  return attributes(kernels, kernels[0], smem, out);
}
