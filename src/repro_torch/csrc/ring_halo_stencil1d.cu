// R10 ring_halo_stencil1d: K9's 11-tap stencil (with its relu drain), its
// widened input delivered through an N-deep shared-memory ring.
//
// Replaces the TPU kernel repro/core/ssr.py:_pipelined_call (the N-deep
// rotation that ssr_pallas emits at buffer_depth > 2) around the halo
// branch of repro/core/lowering.py:_build_nest_kernel and the bodies
// repro/kernels/stencil.py:stencil1d_block and repro/kernels/chained.py:
// _stencil_relu_body.
//
// Bound on H100: bytes, as K9.
//
// Design: K9's work items -- kChunk outputs of a grid step's block, staged
// as the widened read of kChunk + 10 elements from the first slot's walk --
// on K9's split of the steps over CTAs, each CTA walking its items in grid
// order.  The ring has the schedule's depth for x's first slot (the
// shifted twin is never read, so its own depth is not): `depth` slots of
// one item each, `depth - 1` items in flight while one is computed.  At
// item n every thread waits on its own copies of item n (cp.async groups
// are per thread, and every thread copies a share of every item), the CTA
// meets at one barrier -- which publishes slot n and frees the slot of
// item n - 1 -- and then the fetch of item n + depth - 1 goes into that
// freed slot (ssr_ring.cuh's discipline).  Thread 0 records each slot's
// item (output, length) in shared memory when it is issued, so a thread
// walks one cursor, not two: with a handful of FMAs a thread an item, the
// address arithmetic is what an item costs.  bf16 items travel as 16-bit
// copies and are converted where they are read.  The taps (w, invariant)
// are read once a CTA.  ssr_stencil1d.cuh::compute_item, K9's arithmetic on
// the same values in the same order, makes the outputs: K9's bits at every
// depth.
#include "ssr_ring.cuh"
#include "ssr_stencil1d.cuh"

namespace {

using namespace stencil1d;

// V = 4: x copied in 16-byte packs and y stored as 16-byte packs (the
// wrapper found both aligned); else x copied 4 bytes (f32) or one element
// (bf16) at a time.  Eight CTAs an SM, as K9 (the wrapper's split is one
// wave of eight): at most 64 registers a thread.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 8)
    ring_halo_stencil1d_kernel(const T* __restrict__ x, const T* __restrict__ w,
                               float* __restrict__ y, SsrGrid g, SsrStream sx,
                               SsrStream sw, SsrStream sy, int64_t steps,
                               int64_t per_cta, int relu, int depth) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const slots = reinterpret_cast<T*>(smem_raw);
  __shared__ float ws[kTaps];
  // each slot's item record (output, length; 0: past the CTA's last step),
  // written by thread 0 when the item is issued, read after the barrier
  // that publishes it
  __shared__ float* dsts[8];
  __shared__ int lens[8];
  const int64_t first = blockIdx.x * per_cta;
  if (first >= steps) return;
  const int64_t last = first + per_cta < steps ? first + per_cta : steps;
  float wr[kTaps];
  load_taps(w, sw, g, first, ws, wr);
  Cursor<T> fetch_at(g, first, last, sx.block[1]);
  int put = 0, get = 0;

  auto issue = [&]() {
    const Item<T> it = fetch_at.next(g, x, y, sx, sy);
    if (threadIdx.x == 0) {
      dsts[put] = it.dst;
      lens[put] = it.len;
    }
    if (it.len > 0)
      ssr_ring_copy_run<T>(slots + put * kStaged, it.src, it.wide(), V == 4,
                           threadIdx.x, kThreads);
    put = put + 1 == depth ? 0 : put + 1;
    ssr_cp_async_commit();
  };

  for (int s = 0; s < depth - 1; ++s) issue();
  for (;;) {
    ssr_ring_wait(depth - 2);      // this thread's copies of the item landed
    __syncthreads();               // every thread's; the last slot is free
    const int len = lens[get];
    float* const dst = dsts[get];
    if (len == 0) break;
    issue();                       // the item depth - 1 ahead
    compute_item<V>(slots + get * kStaged, len, wr, relu, dst);
    get = get + 1 == depth ? 0 : get + 1;
  }
  ssr_cp_async_wait<0>();
}

template <typename T, int V>
int launch(const void* x, const void* w, void* y, const SsrGrid& g,
           const SsrStream& sx, const SsrStream& sw, const SsrStream& sy,
           int64_t steps, int64_t ctas, int64_t per_cta, int relu, int depth,
           int64_t smem, cudaStream_t st) {
  auto kernel = ring_halo_stencil1d_kernel<T, V>;
  cudaError_t err = ssr_ring_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(ctas), kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<float*>(y),
      g, sx, sw, sy, steps, per_cta, relu, depth);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// As ssr_halo_stencil1d, plus the ring: `ring->depth[0]` slots of x's
// first slot (the twin's entry and w's, one slot, are not read here) and
// `smem_bytes`, the ring's dynamic shared memory as the wrapper counted it
// (depth x kStaged elements), checked here.  `vec` is 4 when x allows
// 16-byte copies and y 16-byte stores, else 1.
extern "C" int ssr_ring_halo_stencil1d(const void* x, const void* w, void* y,
                                       int dtype, int vec, const SsrGrid* g,
                                       const SsrStream* sx,
                                       const SsrStream* sw,
                                       const SsrStream* sy, int64_t ctas,
                                       int64_t per_cta, int relu,
                                       const SsrRing* ring, int64_t smem_bytes,
                                       void* stream) {
  int64_t steps = 1;
  for (int k = 0; k < g->ndim; ++k) steps *= g->dims[k];
  const int depth = static_cast<int>(ring->depth[0]);
  const int64_t item = dtype == SSR_BF16 ? 2 : 4;
  if (depth < 2 || depth > 8 || smem_bytes != depth * kStaged * item)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == SSR_F32 && vec == 4)
    return launch<float, 4>(x, w, y, *g, *sx, *sw, *sy, steps, ctas, per_cta,
                            relu, depth, smem_bytes, st);
  if (dtype == SSR_F32 && vec == 1)
    return launch<float, 1>(x, w, y, *g, *sx, *sw, *sy, steps, ctas, per_cta,
                            relu, depth, smem_bytes, st);
  if (dtype == SSR_BF16 && vec == 4)
    return launch<__nv_bfloat16, 4>(x, w, y, *g, *sx, *sw, *sy, steps, ctas,
                                    per_cta, relu, depth, smem_bytes, st);
  if (dtype == SSR_BF16 && vec == 1)
    return launch<__nv_bfloat16, 1>(x, w, y, *g, *sx, *sw, *sy, steps, ctas,
                                    per_cta, relu, depth, smem_bytes, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int64_t ssr_ring_halo_stencil1d_smem_bytes() { return 0; }
