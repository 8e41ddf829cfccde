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
// Design: a CTA owns 8 rows of the lowered row block (one a warp) and runs
// a contiguous range of grid steps made of whole output blocks: one output
// block when its contraction takes several steps (K4's split), several
// when it takes one, so the ring has steps to run ahead over.  Warps 0-6
// fetch the CTA's 8 x tn tile of A and warp 7 the x block, each depth - 1
// steps ahead into its stream's ring; an x block that never moves (a
// contraction of one step) is fetched once.  Each lane reads the packs
// K4's lane reads (columns c = lane, lane + 32, ... in packs of V, V from
// A's alignment as for K4), converts x to f32 as K4 stages it, and chains
// the same fmaf in the same order; the row sum folds across the warp as in
// K4 and the drain (relu selected as K2 does) writes once per output block.
// So every output has K4's bits at every depth.  Eight rows a CTA (K4 has
// sixteen) keep a depth-8 ring of a 512-wide f32 block at 144 KiB.
#include "ssr_ring.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerCta = kThreads / 32;   // one row a warp
constexpr int kAThreads = kThreads - 32;     // warps 0-6 fetch A, warp 7 x

template <typename T, typename O, int V>
__global__ void __launch_bounds__(kThreads)
    ring_contract_gemv_kernel(const T* __restrict__ a, const T* __restrict__ x,
                              O* __restrict__ y, SsrGrid g, SsrStream sa,
                              SsrStream sx, SsrStream sy, int64_t steps,
                              int64_t zsteps, int64_t groups,
                              int64_t blocks_per_run, int xvec, int relu,
                              SsrRing ring) {
  using Pack = SsrPack<T, V>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t runi = blockIdx.x / groups, grp = blockIdx.x % groups;
  const int64_t s0 = runi * blocks_per_run * zsteps;
  const int64_t s1 = s0 + blocks_per_run * zsteps < steps
                         ? s0 + blocks_per_run * zsteps : steps;
  const int64_t run = s1 - s0;
  const int64_t tm = sa.block[0];
  const int tn = static_cast<int>(sa.block[1]);
  const int64_t r0 = grp * kRowsPerCta;
  const int rows_here = static_cast<int>(tm - r0 < kRowsPerCta ? tm - r0 : kRowsPerCta);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int a_tile = kRowsPerCta * tn;
  T* a_slots = reinterpret_cast<T*>(smem);
  T* x_slots = a_slots + ring.depth[0] * a_tile;

  const int mine = threadIdx.x < kAThreads ? 0 : 1;
  SsrRingSide side(ring, mine);
  SsrRingSide ra(ring, 0), rx(ring, 1);
  const int64_t dmax = ring.depth[0] > ring.depth[1] ? ring.depth[0] : ring.depth[1];
  SsrOdometer fetch_at(g, s0);
  auto fetch = [&](int slot) {
    if (mine == 0)
      ssr_ring_copy<T>(a_slots + slot * a_tile, tn,
                       a + fetch_at.origin(sa) + r0 * sa.pitch, sa.pitch,
                       rows_here, tn, V > 1, threadIdx.x, kAThreads);
    else
      ssr_ring_copy<T>(x_slots + slot * tn, tn, x + fetch_at.origin(sx),
                       sx.pitch, 1, tn, xvec != 0, threadIdx.x - kAThreads, 32);
    fetch_at.advance(g);
  };

  const bool live = warp < rows_here;
  float part = 0.f;
  int64_t z = 0;
  for (int64_t u = 1 - dmax; u < 0; ++u) side.issue(u, 1 - dmax, run, fetch);
  for (int64_t u = 0; u < run; ++u) {
    side.wait();
    __syncthreads();
    side.issue(u, 1 - dmax, run, fetch);
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
    ra.step();
    rx.step();
  }
}

template <typename T, typename O>
int launch(int vec, int xvec, const void* a, const void* x, void* y,
           const SsrGrid* g, const SsrStream* sa, const SsrStream* sx,
           const SsrStream* sy, int64_t steps, int64_t zsteps, int64_t ctas,
           int64_t groups, int64_t bpr, int relu, const SsrRing* ring,
           int64_t smem, cudaStream_t st) {
  constexpr int kV = 16 / sizeof(T);
  auto kernel = vec == kV ? ring_contract_gemv_kernel<T, O, kV>
                          : ring_contract_gemv_kernel<T, O, 1>;
  if (vec != kV && vec != 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = ssr_ring_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(ctas), kThreads, smem, st>>>(
      static_cast<const T*>(a), static_cast<const T*>(x), static_cast<O*>(y),
      *g, *sa, *sx, *sy, steps, zsteps, groups, bpr, xvec, relu, *ring);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `vec` as for K4 (from A's alignment); `xvec` 1 when x's block rows allow
// 16-byte copies; each run covers `blocks_per_run` output blocks of
// `zsteps` steps; `relu` (0 or 1) selects the relu drain; `smem_bytes` the
// ring's bytes as the wrapper counted them, checked here.
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
  if (smem_bytes < (ring->depth[0] * kRowsPerCta + ring->depth[1]) * tn * size)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t groups = (sa->block[0] + kRowsPerCta - 1) / kRowsPerCta;
  const int64_t blocks = steps / zsteps;
  const int64_t ctas = ((blocks + blocks_per_run - 1) / blocks_per_run) * groups;
  if (in_dtype == SSR_F32 && out_dtype == SSR_F32)
    return launch<float, float>(vec, xvec, a, x, y, g, sa, sx, sy, steps, zsteps, ctas, groups, blocks_per_run, relu, ring, smem_bytes, st);
  if (in_dtype == SSR_F32 && out_dtype == SSR_BF16)
    return launch<float, __nv_bfloat16>(vec, xvec, a, x, y, g, sa, sx, sy, steps, zsteps, ctas, groups, blocks_per_run, relu, ring, smem_bytes, st);
  if (in_dtype == SSR_BF16 && out_dtype == SSR_F32)
    return launch<__nv_bfloat16, float>(vec, xvec, a, x, y, g, sa, sx, sy, steps, zsteps, ctas, groups, blocks_per_run, relu, ring, smem_bytes, st);
  if (in_dtype == SSR_BF16 && out_dtype == SSR_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(vec, xvec, a, x, y, g, sa, sx, sy, steps, zsteps, ctas, groups, blocks_per_run, relu, ring, smem_bytes, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int64_t ssr_ring_contract_gemv_smem_bytes() { return 0; }
