// R11 ring_halo_stencil2d: K10's 11-point star stencil, its widened
// windows delivered through an N-deep shared-memory ring.
//
// Replaces the TPU kernel repro/core/ssr.py:_pipelined_call (the N-deep
// rotation that ssr_pallas emits at buffer_depth > 2) around the halo
// branch of repro/core/lowering.py:_build_nest_kernel (its _halo_widen over
// both levels) and the body repro/kernels/stencil.py:_body_2d.
//
// Bound on H100: bytes, as K10.
//
// Design: a lowered block plus its halo (266 x 522 floats, 555 KiB) cannot
// fit a CTA, so the ring's unit is K10's window: a 32 x 128 output sub-tile
// staged as 42 rows of 138 elements from the first slot's walk (the three
// shifted twins are never read), on a 140-float (f32) or 144-element (bf16)
// pitch -- 23,520 or 12,096 bytes a slot.  Persistent CTAs walk the windows
// grid-stride, as K10's do; a CTA's ring has the schedule's depth for x's
// first slot, `depth - 1` windows in flight while one is computed, with
// ssr_ring.cuh's discipline: wait on this thread's copies of window n, one
// barrier (publishing slot n, freeing window n - 1's), the fetch of window
// n + depth - 1 into the freed slot, then the taps.  As many CTAs are
// launched as fit the card at this ring's shared memory: at depth 8 one an
// SM, where K10 keeps four.  bf16 windows travel as 16-bit copies and are
// converted where they are read.  wx and wy (invariant) are read once a
// CTA.  ssr_stencil2d.cuh::compute_window, K10's arithmetic on the same
// values in the same order, makes the outputs: K10's bits at every depth.
#include "ssr_ring.cuh"
#include "ssr_stencil2d.cuh"

namespace {

using namespace stencil2d;

// V = 4: x copied in 16-byte packs (the wrapper found its rows and blocks
// aligned), else 4 bytes (f32) or one element (bf16) at a time.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    ring_halo_stencil2d_kernel(const T* __restrict__ x, const T* __restrict__ wx,
                               const T* __restrict__ wy, float* __restrict__ y,
                               SsrGrid g, SsrStream sx, SsrStream swx,
                               SsrStream swy, SsrStream sy, int64_t subr,
                               int64_t subc, int64_t windows, int depth) {
  constexpr int kP = Pitch<T>::value;
  constexpr int kSlot = kWideRows * kP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const slots = reinterpret_cast<T*>(smem_raw);
  __shared__ float wxs[kTaps], wys[kTaps];
  load_taps(wx, wy, swx, swy, g, wxs, wys);
  const int64_t stride = gridDim.x;
  int64_t fetch_w = blockIdx.x;
  int put = 0, get = 0;

  auto issue = [&]() {
    if (fetch_w < windows) {
      const Window<T> win = window_of(fetch_w, x, y, g, sx, sy, subr, subc);
      ssr_ring_copy<T>(slots + put * kSlot, kP, win.src, sx.pitch,
                       win.rows + kTaps - 1, win.cols + kTaps - 1, V == 4,
                       threadIdx.x, kThreads);
    }
    fetch_w += stride;
    put = put + 1 == depth ? 0 : put + 1;
    ssr_cp_async_commit();
  };

  for (int s = 0; s < depth - 1; ++s) issue();
  for (int64_t w = blockIdx.x; w < windows; w += stride) {
    ssr_ring_wait(depth - 2);      // this thread's copies of window w landed
    __syncthreads();               // every thread's; the last slot is free
    issue();                       // the window depth - 1 ahead
    const Window<T> win = window_of(w, x, y, g, sx, sy, subr, subc);
    compute_window(slots + get * kSlot, wxs, wys, win.dst, sy.pitch, win.rows,
                   win.cols);
    get = get + 1 == depth ? 0 : get + 1;
  }
  ssr_cp_async_wait<0>();
}

template <typename T, int V>
int launch(const void* x, const void* wx, const void* wy, void* y,
           const SsrGrid& g, const SsrStream& sx, const SsrStream& swx,
           const SsrStream& swy, const SsrStream& sy, int64_t subr,
           int64_t subc, int64_t windows, int depth, int64_t smem,
           cudaStream_t st) {
  auto kernel = ring_halo_stencil2d_kernel<T, V>;
  cudaError_t err = ssr_ring_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // persistent: as many CTAs as are resident at this ring's shared memory
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                      static_cast<size_t>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t ctas = static_cast<int64_t>(per_sm) * sms;
  const int64_t n = ctas < windows ? ctas : windows;
  kernel<<<static_cast<unsigned>(n), kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(wx),
      static_cast<const T*>(wy), static_cast<float*>(y), g, sx, swx, swy, sy,
      subr, subc, windows, depth);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// As ssr_halo_stencil2d, plus the ring: `ring->depth[0]` slots of x's first
// slot (the twins' entries and the taps' are not read here) and
// `smem_bytes`, the ring's dynamic shared memory as the wrapper counted it
// (depth x 42 staged rows), checked here.  The CTAs are persistent, as many
// as the card holds at that shared memory.
extern "C" int ssr_ring_halo_stencil2d(const void* x, const void* wx,
                                       const void* wy, void* y, int dtype,
                                       int vec, const SsrGrid* g,
                                       const SsrStream* sx,
                                       const SsrStream* swx,
                                       const SsrStream* swy,
                                       const SsrStream* sy,
                                       const SsrRing* ring, int64_t smem_bytes,
                                       void* stream) {
  int64_t steps = 1;
  for (int k = 0; k < g->ndim; ++k) steps *= g->dims[k];
  const int64_t subr = (sx->block[0] + kRows - 1) / kRows;
  const int64_t subc = (sx->block[1] + kCols - 1) / kCols;
  const int64_t windows = steps * subr * subc;
  const int depth = static_cast<int>(ring->depth[0]);
  const int64_t slot = dtype == SSR_BF16
                           ? kWideRows * Pitch<__nv_bfloat16>::value * 2
                           : kWideRows * Pitch<float>::value * 4;
  if (depth < 2 || depth > 8 || smem_bytes != depth * slot)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == SSR_F32 && vec == 4)
    return launch<float, 4>(x, wx, wy, y, *g, *sx, *swx, *swy, *sy, subr, subc,
                            windows, depth, smem_bytes, st);
  if (dtype == SSR_F32 && vec == 1)
    return launch<float, 1>(x, wx, wy, y, *g, *sx, *swx, *swy, *sy, subr, subc,
                            windows, depth, smem_bytes, st);
  if (dtype == SSR_BF16 && vec == 4)
    return launch<__nv_bfloat16, 4>(x, wx, wy, y, *g, *sx, *swx, *swy, *sy, subr,
                                    subc, windows, depth, smem_bytes, st);
  if (dtype == SSR_BF16 && vec == 1)
    return launch<__nv_bfloat16, 1>(x, wx, wy, y, *g, *sx, *swx, *swy, *sy, subr,
                                    subc, windows, depth, smem_bytes, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int64_t ssr_ring_halo_stencil2d_smem_bytes() { return 0; }
