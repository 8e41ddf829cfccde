// B1 base_reduce: the dot product's monolithic baseline.  Sum over the
// (8, 128) blocks of promote(x_blk) * promote(y_blk), in an f32 accumulator.
//
// Replaces the TPU kernel repro/kernels/frontend.py:MonolithicKernel._build
// with the body repro/kernels/reduction.py:_baseline_body: one grid step
// whose body walks the blocks with a fori_loop, each block fetched by an
// explicit dynamic-slice load at i * 8 rows and summed at once -- the paper's
// baseline core, issuing a load pair before every multiply-add.
//
// Bound on H100: bytes.  Each input element is read once for one multiply-
// add, the same bound as K1 (reduce_mul.cu).
//
// Design: the meaning of the baseline, not its single grid step.  One CTA
// would measure the SM count, not how operands are delivered, so B1 runs on
// K1's runs (core/hopper.py reduce_split: REDUCE_PER_SM runs an SM, one
// partial each), one CTA a run, all in one wave at kMinCtas CTAs an SM.
//
// The baseline's rule, which K1's stream walk breaks and B1 keeps: an
// explicit load before every use.  Each thread issues its loads of block i
// from the loop index, at the point of use, and the multiply-adds that use
// them follow at once; the block loop is rolled (#pragma unroll 1), so
// nothing of block i + 1 is in flight in a thread before block i's values
// are used.  No read-ahead batch (ssr_for), no run walk, no ring, no bulk
// copy, no prefetch.  A 16-byte access is still one explicit load: where
// the wrapper found both layouts aligned for it, a thread loads one 16-byte
// pack of each stream a block (four f32 or eight bf16 elements), else one
// element an access (a view off a 16-byte boundary), read once with an
// evict-first hint (ssr_run.cuh's ssr_load_once, as K1 reads: 0.6 % faster
// than plain loads in f32 and 1.1 % in bf16 on the dot cell, PERF.md).
// The card hides the loads' latency by its resident warps, and K1 shares
// that.
//
// The association is K1's (core/hopper.py reduce_mul_model at B1's packs):
// thread t takes the packs t, t + T, ... of each block of its run in block
// order, element by element, one FMA each; ssr_cta_sum gives the run's
// partial.  A 16-bit type in 16-byte packs has 128 packs to a block, so on
// 256-thread CTAs half of the threads idle, as K1's do.  On 16-byte packs
// B1 gives K1's bits.
//
// One launch: the last CTA to publish its partial (an acquire-release
// ticket in the stream's scratch, hopper._work) folds the partials in the
// order of ssr_rows.cuh's ssr_fold_partials (ssr_run.cuh's
// ssr_fold_in_cta) and sets the ticket back to zero for the next launch --
// K1's protocol.  No atomics on the values: the same result every run.
#include "ssr_run.cuh"

namespace {

constexpr int kBlock = 8 * 128;   // elements of one block
// CTAs an SM B1 is built for (at most 32 registers a thread): K1's eight
// runs an SM, one CTA each, in one wave
constexpr int kMinCtas = 8;

// Threads of a CTA: 256 in every build, as K1's (bf16 on 128-thread CTAs,
// every thread busy, measured no faster, PERF.md).
template <typename T, int V>
constexpr int threads_for() {
  return 256;
}

template <typename T, int V, int kThreads>
__global__ void __launch_bounds__(kThreads, kMinCtas * 256 / kThreads)
    base_reduce_kernel(const T* __restrict__ x, const T* __restrict__ y,
                       float* __restrict__ out, float* __restrict__ partials,
                       unsigned* __restrict__ ticket, int64_t nblk,
                       int64_t blocks_per_run, int64_t num_runs) {
  using Words = SsrWords<T, V>;
  constexpr int kPacks = kBlock / V;
  constexpr int kCells = (kPacks + kThreads - 1) / kThreads;
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * blocks_per_run;
  const int64_t b1 = b0 + blocks_per_run < nblk ? b0 + blocks_per_run : nblk;
  float acc = 0.f;
#pragma unroll 1
  for (int64_t i = b0; i < b1; ++i) {
    // the explicit loads' addresses, from i
    const Words* px = reinterpret_cast<const Words*>(x + i * kBlock);
    const Words* py = reinterpret_cast<const Words*>(y + i * kBlock);
#pragma unroll
    for (int c = 0; c < kCells; ++c) {
      const int k = threadIdx.x + c * kThreads;
      if (kPacks % kThreads == 0 || k < kPacks) {
        const Words wx = ssr_load_once(px + k), wy = ssr_load_once(py + k);
#pragma unroll
        for (int j = 0; j < V; ++j)
          acc += ssr_element_f32<T, V>(wx, j) * ssr_element_f32<T, V>(wy, j);
      }
    }
  }
  acc = ssr_cta_sum<kThreads>(acc);
  // the last CTA to publish its partial folds them all: thread 0 writes
  // this run's partial and takes its ticket (acquire-release), and the
  // barrier orders the last CTA's reads after its ticket
  __shared__ bool last;
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = acc;
    last = ssr_take_ticket(ticket) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  const float total = ssr_fold_in_cta<kThreads>(partials, num_runs);
  if (threadIdx.x == 0) {
    out[0] = total;
    *ticket = 0u;      // ready for the next launch on this stream
  }
}

template <typename T, int V>
int launch(const void* x, const void* y, float* out, float* part,
           unsigned* ticket, int64_t nblk, int64_t per, int64_t runs,
           cudaStream_t st) {
  constexpr int kThreads = threads_for<T, V>();
  base_reduce_kernel<T, V, kThreads>
      <<<static_cast<unsigned>(runs), kThreads, 0, st>>>(
          static_cast<const T*>(x), static_cast<const T*>(y), out, part,
          ticket, nblk, per, runs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x and y are (nblk * 8, 128) row-major.  `vec` is 16 / sizeof(element)
// where both base pointers allow 16-byte accesses, else 1.  `work` is the
// stream's scratch: a 4-byte ticket, zero between launches (each launch
// leaves it so), then `num_runs` f32 partials; K1's runs are
// `blocks_per_run` blocks, one CTA each.  One launch.
extern "C" int ssr_base_reduce(const void* x, const void* y, void* out,
                               void* work, int dtype, int vec, int64_t nblk,
                               int64_t num_runs, int64_t blocks_per_run,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (blocks_per_run < 1 ||
      num_runs != (nblk + blocks_per_run - 1) / blocks_per_run)
    return static_cast<int>(cudaErrorInvalidValue);
  float* o = static_cast<float*>(out);
  unsigned* ticket = static_cast<unsigned*>(work);
  float* part = static_cast<float*>(work) + 1;
  const int64_t n = nblk, per = blocks_per_run, runs = num_runs;
  if (dtype == SSR_F32 && vec == 4)
    return launch<float, 4>(x, y, o, part, ticket, n, per, runs, st);
  if (dtype == SSR_F32 && vec == 1)
    return launch<float, 1>(x, y, o, part, ticket, n, per, runs, st);
  if (dtype == SSR_BF16 && vec == 8)
    return launch<__nv_bfloat16, 8>(x, y, o, part, ticket, n, per, runs, st);
  if (dtype == SSR_BF16 && vec == 1)
    return launch<__nv_bfloat16, 1>(x, y, o, part, ticket, n, per, runs, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Static shared memory: ssr_cta_sum's warp sums, the fold's and the flag.
extern "C" int64_t ssr_base_reduce_smem_bytes() {
  return static_cast<int64_t>(sizeof(float)) * (256 / 32 + kFoldLanes / 32) +
         sizeof(bool);
}

// Registers a thread and local (spill) bytes, the most over every
// instantiation, as cudaFuncGetAttributes reads them, and the CTAs an SM
// of the main path's (f32, 16-byte packs; occupancy API): out[0] numRegs,
// out[1] localSizeBytes, out[2] CTAs an SM.
extern "C" int ssr_base_reduce_attributes(int64_t* out) {
  const void* const kernels[] = {
      reinterpret_cast<const void*>(
          base_reduce_kernel<float, 4, threads_for<float, 4>()>),
      reinterpret_cast<const void*>(
          base_reduce_kernel<float, 1, threads_for<float, 1>()>),
      reinterpret_cast<const void*>(
          base_reduce_kernel<__nv_bfloat16, 8,
                             threads_for<__nv_bfloat16, 8>()>),
      reinterpret_cast<const void*>(
          base_reduce_kernel<__nv_bfloat16, 1,
                             threads_for<__nv_bfloat16, 1>()>)};
  out[0] = out[1] = out[2] = 0;
  for (const void* k : kernels) {
    cudaFuncAttributes fa;
    cudaError_t err = cudaFuncGetAttributes(&fa, k);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (fa.numRegs > out[0]) out[0] = fa.numRegs;
    if (static_cast<int64_t>(fa.localSizeBytes) > out[1])
      out[1] = static_cast<int64_t>(fa.localSizeBytes);
  }
  int ctas = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &ctas, base_reduce_kernel<float, 4, threads_for<float, 4>()>,
      threads_for<float, 4>(), 0);
  out[2] = ctas;
  return static_cast<int>(err);
}
