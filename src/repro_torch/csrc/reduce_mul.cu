// K1 reduce_mul: sum over every grid step of promote(a_blk) * promote(b_blk).
//
// Replaces the TPU kernel repro/core/ssr.py:ssr_pallas (sync emitter) with
// the reduce epilogue of repro/core/lowering.py:_assemble_kernel and the
// body repro/kernels/reduction.py:_mul_body -- the paper's Fig. 4 dot
// product.  There, one (rows, lanes) f32 accumulator is carried across the
// whole `arbitrary` grid and folded to a scalar on the last step.
//
// Bound on H100: bytes.  Each input element is read once and used for one
// multiply-add, so the kernel can go no faster than both operands over the
// card's memory rate.
//
// Design: CTAs cannot carry state from one to the next, so the carried
// accumulator becomes partials, one a run of consecutive grid steps: the
// wrapper splits the steps into K1's runs (core/hopper.py reduce_split, 8
// runs an SM) and gives each CTA `runs_per_cta` of them, one after another,
// at kMinCtas CTAs an SM, all in one wave.  A thread takes its packs of
// each step's block in turn, 16 bytes per access where the wrapper found
// the layout aligned for it: on a flat walk (ssr_run.cuh's ssr_run_is_flat:
// every vector's dot) one pack a step, by pointers a constant stride
// apart; on any other through the streams' AGU programming (SsrRunWalk).
// Against the bound, the walk reads ahead: a thread issues the loads of
// its next kAhead packs of each stream (kAhead steps of an (8, 128) f32
// block) before it adds the first, 32 bytes a pack pair -- 128 KiB in
// flight an SM at four CTAs of 256 threads -- each read once with an
// evict-first hint, and keeps them as raw words in registers.  It adds
// them into its f32 accumulator as the parent did: step by step, element
// by element within a pack, one FMA each, so the bits stay the parent's
// (core/hopper.py reduce_mul_model), and R1 (ring_reduce_mul.cu), which
// walks the same runs through a ring and sums each run in the same order,
// keeps giving K1's bits.  At a run's end the CTA sums its threads
// (ssr_cta_sum<256>) into the run's partial.  bf16 keeps the parent's
// mapping of packs to threads, which R1 shares: an (8, 128) block is 128
// packs, so half the threads idle.
//
// The fold is in the same launch: the last CTA to publish its partials (a
// ticket taken with acquire-release semantics) sums them in the order of
// the one-CTA second launch it replaces, ssr_rows.cuh's ssr_fold_partials
// (1,024 lanes strided over the partials, then ssr_cta_sum<1024>), its 256
// threads carrying four lanes each with every warp butterfly replayed
// (ssr_run.cuh's ssr_fold_in_cta), and sets the ticket back to zero for
// the next launch on the stream.  No atomics on the values: the same
// result from run to run.
#include "ssr_run.cuh"

namespace {

constexpr int kThreads = 256;
// CTAs an SM K1 is built for (at most 64 registers a thread), the
// wrapper's REDUCE_CTAS_PER_SM
constexpr int kMinCtas = 4;
// packs of each stream a thread has in flight before it adds the first
// (a and b are read with ld.global.cs, evict-first: 0.5-1 % faster on the
// dot cell than plain loads, PERF.md)
constexpr int kAhead = 4;

// acc plus the products of one pack of each stream, element by element:
// the parent's order and roundings.
template <typename T, int V, typename W>
__device__ __forceinline__ float pack_products(float acc, const W& xa,
                                               const W& xb) {
#pragma unroll
  for (int j = 0; j < V; ++j)
    acc += ssr_element_f32<T, V>(xa, j) * ssr_element_f32<T, V>(xb, j);
  return acc;
}

template <typename T, int V, bool kFlat>
__global__ void __launch_bounds__(kThreads, kMinCtas)
    reduce_mul_kernel(const T* __restrict__ a, const T* __restrict__ b,
                      float* __restrict__ out, float* __restrict__ partials,
                      unsigned* __restrict__ ticket, SsrGrid g, SsrStream sa,
                      SsrStream sb, SsrRunSteps rs, int64_t steps,
                      int64_t steps_per_run, int64_t num_runs,
                      int64_t runs_per_cta) {
  using Words = SsrWords<T, V>;
  const int rows = static_cast<int>(sa.block[0]);
  const int packs = static_cast<int>(sa.block[1]) / V;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * runs_per_cta;
  const int64_t r1 = r0 + runs_per_cta < num_runs ? r0 + runs_per_cta : num_runs;
  const SsrFlatCell cell(threadIdx.x, packs);
  for (int64_t r = r0; r < r1; ++r) {
    const int64_t s0 = r * steps_per_run;
    const int64_t s1 = s0 + steps_per_run < steps ? s0 + steps_per_run : steps;
    float acc = 0.f;
    if constexpr (kFlat) {
      // one pack of each step's block a thread, a stride apart: the loads
      // of the next kAhead steps' packs of each stream, then their
      // products in order
      if (cell.r < rows) {
        const T* pa = a + cell.at(sa, g, s0, V);
        const T* pb = b + cell.at(sb, g, s0, V);
        const int64_t da = rs.step[0][0], db = rs.step[0][1];
        for (int64_t left = s1 - s0; left > 0; left -= kAhead) {
          Words xa[kAhead], xb[kAhead];
          ssr_for<kAhead>([&](auto ahead) {
            constexpr int u = decltype(ahead)::value;
            if (u < left) {
              xa[u] = ssr_load_once(
                  reinterpret_cast<const Words*>(pa + u * da));
              xb[u] = ssr_load_once(
                  reinterpret_cast<const Words*>(pb + u * db));
            }
          });
          ssr_for<kAhead>([&](auto ahead) {
            constexpr int u = decltype(ahead)::value;
            if (u < left) acc = pack_products<T, V>(acc, xa[u], xb[u]);
          });
          pa += kAhead * da;
          pb += kAhead * db;
        }
      }
    } else {
      SsrRunWalk at(g, sa, sb, s0, threadIdx.x, kThreads, packs);
      while (at.has_cells(rows) && at.s < s1) {
        // the loads of the next kAhead packs of each stream, then their
        // products in order (the walk moves on past the run's end; what
        // it reads there is never loaded)
        Words xa[kAhead], xb[kAhead];
        int n = 0;
        ssr_for<kAhead>([&](auto ahead) {
          constexpr int u = decltype(ahead)::value;
          if (at.s < s1) {
            const int64_t r_ = at.w.r, c_ = at.w.c * V;
            xa[u] = ssr_load_once(reinterpret_cast<const Words*>(
                a + at.o0 + r_ * sa.pitch + c_));
            xb[u] = ssr_load_once(reinterpret_cast<const Words*>(
                b + at.o1 + r_ * sb.pitch + c_));
            ++n;
          }
          at.next(g, rs, rows);
        });
        ssr_for<kAhead>([&](auto ahead) {
          constexpr int u = decltype(ahead)::value;
          if (u < n) acc = pack_products<T, V>(acc, xa[u], xb[u]);
        });
      }
    }
    acc = ssr_cta_sum<kThreads>(acc);
    if (threadIdx.x == 0) partials[r] = acc;
    __syncthreads();   // warp 0 has read the warp sums the next run writes
  }
  // the last CTA to publish its partials folds them all: thread 0 wrote
  // this CTA's partials and takes its ticket (acquire-release), and the
  // barrier orders the last CTA's reads after its ticket
  __shared__ bool last;
  if (threadIdx.x == 0)
    last = ssr_take_ticket(ticket) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  const float total = ssr_fold_in_cta<kThreads>(partials, num_runs);
  if (threadIdx.x == 0) {
    out[0] = total;
    *ticket = 0u;      // ready for the next launch on this stream
  }
}

template <typename T, int V>
int launch(const void* a, const void* b, float* out, float* part,
           unsigned* ticket, const SsrGrid* g, const SsrStream* sa,
           const SsrStream* sb, int64_t steps, int64_t per, int64_t runs,
           int64_t runs_per_cta, cudaStream_t st) {
  const int64_t ctas = (runs + runs_per_cta - 1) / runs_per_cta;
  const SsrRunSteps rs = ssr_run_steps(*g, *sa, *sb);
  const unsigned grid = static_cast<unsigned>(ctas);
  if (ssr_run_is_flat(*g, *sa, V, kThreads))
    reduce_mul_kernel<T, V, true><<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(a), static_cast<const T*>(b), out, part, ticket,
        *g, *sa, *sb, rs, steps, per, runs, runs_per_cta);
  else
    reduce_mul_kernel<T, V, false><<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(a), static_cast<const T*>(b), out, part, ticket,
        *g, *sa, *sb, rs, steps, per, runs, runs_per_cta);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `vec` is 16 / sizeof(element) when every stream's pitch, block width and
// base pointer allow 16-byte accesses, else 1.  `work` is the stream's
// scratch: a 4-byte ticket, zero between launches (each launch leaves it
// so), then `num_runs` f32 partials; K1's runs are `steps_per_run` steps,
// `runs_per_cta` of them a CTA.  One launch.
extern "C" int ssr_reduce_mul(const void* a, const void* b, void* out,
                              void* work, int dtype, int vec,
                              const SsrGrid* g, const SsrStream* sa,
                              const SsrStream* sb, int64_t num_runs,
                              int64_t steps_per_run, int64_t runs_per_cta,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int64_t steps = 1;
  for (int k = 0; k < g->ndim; ++k) steps *= g->dims[k];
  if (steps_per_run < 1 || runs_per_cta < 1 ||
      num_runs != (steps + steps_per_run - 1) / steps_per_run)
    return static_cast<int>(cudaErrorInvalidValue);
  float* o = static_cast<float*>(out);
  unsigned* ticket = static_cast<unsigned*>(work);
  float* part = static_cast<float*>(work) + 1;
  const int64_t per = steps_per_run, n = num_runs, k = runs_per_cta;
  if (dtype == SSR_F32 && vec == 4)
    return launch<float, 4>(a, b, o, part, ticket, g, sa, sb, steps, per, n, k, st);
  if (dtype == SSR_F32 && vec == 1)
    return launch<float, 1>(a, b, o, part, ticket, g, sa, sb, steps, per, n, k, st);
  if (dtype == SSR_BF16 && vec == 8)
    return launch<__nv_bfloat16, 8>(a, b, o, part, ticket, g, sa, sb, steps, per, n, k, st);
  if (dtype == SSR_BF16 && vec == 1)
    return launch<__nv_bfloat16, 1>(a, b, o, part, ticket, g, sa, sb, steps, per, n, k, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Static shared memory: ssr_cta_sum's warp sums, the fold's and the flag.
extern "C" int64_t ssr_reduce_mul_smem_bytes() {
  return static_cast<int64_t>(sizeof(float)) * (kThreads / 32 + kFoldLanes / 32) +
         sizeof(bool);
}

// Registers a thread and local (spill) bytes, the most over every
// instantiation, as cudaFuncGetAttributes reads them, and the CTAs an SM
// of the main path's (f32, 16-byte packs, a flat walk; occupancy API):
// out[0] numRegs, out[1] localSizeBytes, out[2] CTAs an SM.
extern "C" int ssr_reduce_mul_attributes(int64_t* out) {
  const void* const kernels[] = {
      reinterpret_cast<const void*>(reduce_mul_kernel<float, 4, true>),
      reinterpret_cast<const void*>(reduce_mul_kernel<float, 4, false>),
      reinterpret_cast<const void*>(reduce_mul_kernel<float, 1, true>),
      reinterpret_cast<const void*>(reduce_mul_kernel<float, 1, false>),
      reinterpret_cast<const void*>(reduce_mul_kernel<__nv_bfloat16, 8, true>),
      reinterpret_cast<const void*>(reduce_mul_kernel<__nv_bfloat16, 8, false>),
      reinterpret_cast<const void*>(reduce_mul_kernel<__nv_bfloat16, 1, true>),
      reinterpret_cast<const void*>(reduce_mul_kernel<__nv_bfloat16, 1, false>)};
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
      &ctas, reduce_mul_kernel<float, 4, true>, kThreads, 0);
  out[2] = ctas;
  return static_cast<int>(err);
}
