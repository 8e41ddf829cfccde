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
// Design: K1's runs and arithmetic on persistent CTAs in one wave, with the
// delivery of ssr_stage_ring.cuh (a filling warp on mbarriers; the 8
// computing warps meet no CTA barrier in the step loop).  K1 splits the
// steps into runs of `steps_per_run`, one partial each; here a CTA walks
// `runs_per_cta` of those runs one after another (the wrapper sizes them,
// core/hopper.py ring_run_steps), its ring running on across each run's
// end.  Every computing thread reads the same packs of each block, in the
// same order, from the slot as K1 reads them from device memory and
// accumulates them the same way; at a run's end the computing warps sum
// it in ssr_cta_sum's order (behind a barrier of their own, the filling
// warp not in it) and write the run's partial.  The fold -- the one-CTA
// second launch shared with the DAG kernels, which K1 replays in its own
// launch -- then sums K1's partials in K1's order, so R1 gives K1's bits
// at every depth.
#include "ssr_rows.cuh"
#include "ssr_stage_ring.cuh"

namespace {

using namespace stage;

// CTAs an SM R1 is built for, the wrapper's most (core/hopper.py
// _RING_PER_SM): 5, at 40 registers a thread; the 7 that an SM's threads
// hold leave 32, and R1 spilled there
constexpr int kMinCtas = 5;

template <typename T, int V>
__global__ void __launch_bounds__(kThreads, kMinCtas)
    ring_reduce_mul_partials(const T* __restrict__ a, const T* __restrict__ b,
                             SsrGrid g, SsrStream sa, SsrStream sb,
                             int64_t steps, int64_t num_runs,
                             int64_t steps_per_run, int64_t runs_per_cta,
                             SsrRing ring, float* __restrict__ partials) {
  using Pack = SsrPack<T, V>;
  constexpr bool kBulk = V > 1;   // the wrapper's 16-byte packs
  extern __shared__ __align__(128) unsigned char smem[];
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * runs_per_cta;
  const int64_t r1 = r0 + runs_per_cta < num_runs ? r0 + runs_per_cta : num_runs;
  const int64_t s0 = r0 * steps_per_run;
  const int run = static_cast<int>(
      (r1 * steps_per_run < steps ? r1 * steps_per_run : steps) - s0);
  const int rows = static_cast<int>(sa.block[0]);
  const int cols = static_cast<int>(sa.block[1]);
  const int tile = rows * cols;
  uint64_t* const bars = reinterpret_cast<uint64_t*>(smem);
  float* const sums = reinterpret_cast<float*>(smem + kBarrierBytes);
  T* const a_slots = reinterpret_cast<T*>(smem + kBarrierBytes + kSumBytes);
  T* const b_slots = a_slots + ring.depth[0] * tile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0)
    init_ring(bars, static_cast<int>(ring.depth[0]),
              static_cast<int>(ring.depth[1]), kBulk);
  __syncthreads();   // the barriers are set: the steps begin
  if (warp == kComputeWarps) {   // the filling warp
    fill_ring<T, kBulk, 2>({a, a_slots, tile, rows}, {b, b_slots, tile, rows},
                           g, sa, sb, s0, run, ring, bars, lane);
    return;
  }
  Reader ra(bars, ring, 0), rb(bars, ring, 1);
  const SsrBlockWalk first(threadIdx.x, kComputeThreads, cols / V);
  const int per = static_cast<int>(steps_per_run);
  float acc = 0.f;
  int64_t r = r0;   // the K1 run
  int z = 0;        // and its steps so far
  for (int u = 0; u < run; ++u) {
    ra.wait();
    rb.wait();
    const T* pa = a_slots + ra.slot() * tile;
    const T* pb = b_slots + rb.slot() * tile;
    for (SsrBlockWalk w = first; w.r < rows; w.next()) {
      const Pack xa = *reinterpret_cast<const Pack*>(pa + w.r * cols + w.c * V);
      const Pack xb = *reinterpret_cast<const Pack*>(pb + w.r * cols + w.c * V);
#pragma unroll
      for (int j = 0; j < V; ++j) acc += ssr_f32(xa.v[j]) * ssr_f32(xb.v[j]);
    }
    done_reading();
    if (lane == 0) {
      ra.release();
      rb.release();
    }
    ra.next();
    rb.next();
    if (++z == per || u + 1 == run) {   // the end of a K1 run
      acc = compute_sum(acc, sums + (r & 1) * kComputeWarps);
      if (threadIdx.x == 0) partials[r] = acc;
      acc = 0.f;
      z = 0;
      ++r;
    }
  }
}

template <typename T, int V>
int launch(const void* a, const void* b, const SsrGrid* g, const SsrStream* sa,
           const SsrStream* sb, const SsrRing* ring, int64_t smem,
           int64_t steps, int64_t num_runs, int64_t steps_per_run,
           int64_t runs_per_cta, float* part, cudaStream_t st) {
  auto kernel = ring_reduce_mul_partials<T, V>;
  cudaError_t err = ssr_ring_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t ctas = (num_runs + runs_per_cta - 1) / runs_per_cta;
  kernel<<<static_cast<unsigned>(ctas), kThreads, smem, st>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), *g, *sa, *sb, steps,
      num_runs, steps_per_run, runs_per_cta, *ring, part);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `vec` as for K1 (16 / sizeof(element), the bulk route, when every stream
// allows 16-byte accesses, else 1); `num_runs` K1's runs (one partial
// each, in `work` after its first word, K1's ticket, which R1 leaves
// alone) of `steps_per_run` steps, `runs_per_cta` of them a CTA, all CTAs
// resident at once; `smem_bytes` the barriers, the warp sums and the ring
// as the wrapper counted them, checked here.
extern "C" int ssr_ring_reduce_mul(const void* a, const void* b, void* out,
                                   void* work, int dtype, int vec,
                                   const SsrGrid* g, const SsrStream* sa,
                                   const SsrStream* sb, const SsrRing* ring,
                                   int64_t smem_bytes, int64_t num_runs,
                                   int64_t steps_per_run, int64_t runs_per_cta,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int64_t steps = 1;
  for (int k = 0; k < g->ndim; ++k) steps *= g->dims[k];
  const int64_t size = dtype == SSR_BF16 ? 2 : 4;
  const int64_t da = ring->depth[0], db = ring->depth[1];
  if (da < 2 || da > 8 || db < 2 || db > 8 || steps_per_run < 1 ||
      runs_per_cta < 1 || steps_per_run * runs_per_cta > 0x7fffffffLL ||
      num_runs != (steps + steps_per_run - 1) / steps_per_run ||
      smem_bytes != kBarrierBytes + kSumBytes +
                        (da + db) * sa->block[0] * sa->block[1] * size)
    return static_cast<int>(cudaErrorInvalidValue);
  float* part = static_cast<float*>(work) + 1;
  const int64_t n = num_runs, per = steps_per_run, k = runs_per_cta;
  int rc;
  if (dtype == SSR_F32 && vec == 4)
    rc = launch<float, 4>(a, b, g, sa, sb, ring, smem_bytes, steps, n, per, k, part, st);
  else if (dtype == SSR_F32 && vec == 1)
    rc = launch<float, 1>(a, b, g, sa, sb, ring, smem_bytes, steps, n, per, k, part, st);
  else if (dtype == SSR_BF16 && vec == 8)
    rc = launch<__nv_bfloat16, 8>(a, b, g, sa, sb, ring, smem_bytes, steps, n, per, k, part, st);
  else if (dtype == SSR_BF16 && vec == 1)
    rc = launch<__nv_bfloat16, 1>(a, b, g, sa, sb, ring, smem_bytes, steps, n, per, k, part, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (rc != 0) return rc;
  ssr_fold_partials<<<1, kFoldThreads, 0, st>>>(part, num_runs,
                                                static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Static shared memory of the ring kernel: none (the barriers, the warp sums
// and the ring are dynamic).
extern "C" int64_t ssr_ring_reduce_mul_smem_bytes() { return 0; }

// Registers a thread and local (spill) bytes, the most over every
// instantiation, as cudaFuncGetAttributes reads them, and the CTAs an SM
// of the main path's (f32, bulk) at `smem` bytes of dynamic shared memory
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor): out[0] numRegs, out[1]
// localSizeBytes, out[2] CTAs an SM.
extern "C" int ssr_ring_reduce_mul_attributes(int64_t* out, int64_t smem) {
  const void* const kernels[] = {
      reinterpret_cast<const void*>(ring_reduce_mul_partials<float, 4>),
      reinterpret_cast<const void*>(ring_reduce_mul_partials<float, 1>),
      reinterpret_cast<const void*>(ring_reduce_mul_partials<__nv_bfloat16, 8>),
      reinterpret_cast<const void*>(ring_reduce_mul_partials<__nv_bfloat16, 1>)};
  return attributes(kernels, kernels[0], smem, out);
}
