// K10 halo_stencil2d: the 11-point star stencil over a padded grid,
// y[i, c] = sum_j wx[j] * x[r + i, j + c] + wy[j] * x[j + i, r + c]
// (r = 5, f32 accumulator).
//
// Replaces the TPU kernel repro/core/ssr.py:ssr_pallas (sync emitter) with
// the plain branch of repro/core/lowering.py:_build_nest_kernel, its halo
// widening _halo_widen over both levels (four shifted streams) and the body
// repro/kernels/stencil.py:_body_2d.  At 8192 x 8192 outputs the default
// lowering gives grid (32, 16), x blocks (256, 512) four times (shifted one
// block down, right, and both), wx and wy (1, 128), y (256, 512); x's layout
// is (8448, 8704): the 8202 x 8202 operand padded by one extra tile on each
// level.
//
// Bound on H100: bytes.  Each input element is read once and each output
// written once; 22 FMAs per output are far below the FP32 rate.
//
// Design: a lowered block plus its halo (266 x 522 floats) would not fit in
// a CTA's shared memory, so the work is cut into windows: 32 x 128 output
// sub-tiles of the lowered blocks, each staged with its widened 42 x 138
// input straight from the first slot's walk (row pitch: the layout's, i.e.
// the lowered row coefficient) -- the three shifted walks are never read.
// A window's input elements are read once; the halo rows and columns
// overlap the neighbouring windows' (about 1.4 reads per element, the rest
// from L2).  For f32, persistent CTAs (four per SM) walk the windows
// through two shared-memory stages filled by cp.async, so the next window
// is in flight while this one is computed; bf16 windows go one a CTA
// through registers.  A thread owns eight rows and four consecutive
// columns, and keeps the wy arm's rows in a register ring: a warp's
// shared-memory reads take 0.27 wavefronts an output, where a thread of
// four rows and four strided columns reading 4 bytes a tap took 0.45.
// Taps run in the reference's order: per j the wx arm, then the wy arm.
// The windows, the taps and compute_window are ssr_stencil2d.cuh, which
// R11 ring_halo_stencil2d runs too.
#include "ssr_stencil2d.cuh"

namespace {

using namespace stencil2d;

constexpr int kWinStages = 2;                 // f32 windows in the ring

// f32: persistent CTAs walk the windows grid-stride (the CTAs of one wave
// take neighbouring windows, whose halos meet in L2) through two
// shared-memory stages filled by cp.async: the next window is in flight
// while this one is computed.  V = 4: 16-byte copies where the wrapper
// found x aligned, else 4-byte copies.
template <int V>
__global__ void __launch_bounds__(kThreads)
    halo_stencil2d_ring(const float* __restrict__ x, const float* __restrict__ wx,
                        const float* __restrict__ wy, float* __restrict__ y,
                        SsrGrid g, SsrStream sx, SsrStream swx, SsrStream swy,
                        SsrStream sy, int64_t subr, int64_t subc, int64_t windows) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float wxs[kTaps], wys[kTaps];
  load_taps(wx, wy, swx, swy, g, wxs, wys);
  Window<float> ring[kWinStages];
  auto issue = [&](int s, int64_t w) {
    float* xs = smem + s * kWideRows * kPitch;
    if (w < windows) {
      ring[s] = window_of(w, x, y, g, sx, sy, subr, subc);
      const int wrows = ring[s].rows + kTaps - 1, wcols = ring[s].cols + kTaps - 1;
      const int packs = V == 4 ? wcols / 4 : 0;
      for (int i = threadIdx.x; i < wrows * packs; i += kThreads) {
        const int row = i / packs, p = i - row * packs;
        ssr_cp_async16(xs + row * kPitch + 4 * p, ring[s].src + row * sx.pitch + 4 * p);
      }
      const int tail = wcols - packs * 4;
      for (int i = threadIdx.x; i < wrows * tail; i += kThreads) {
        const int row = i / tail, c = packs * 4 + i - row * tail;
        ssr_cp_async4(xs + row * kPitch + c, ring[s].src + row * sx.pitch + c);
      }
    } else {
      ring[s].rows = 0;
    }
    ssr_cp_async_commit();
  };
  const int64_t stride = gridDim.x;
#pragma unroll
  for (int s = 0; s < kWinStages - 1; ++s) issue(s, blockIdx.x + s * stride);
  for (int64_t w = blockIdx.x, it = 0; w < windows; w += stride, ++it) {
    const int s = static_cast<int>(it % kWinStages);
    // the stage computed last round takes the window kWinStages - 1 ahead
    issue(static_cast<int>((it + kWinStages - 1) % kWinStages),
          w + (kWinStages - 1) * stride);
    ssr_cp_async_wait<kWinStages - 1>();   // window w has landed
    __syncthreads();
    compute_window(smem + s * kWideRows * kPitch, wxs, wys, ring[s].dst,
                   sy.pitch, ring[s].rows, ring[s].cols);
    __syncthreads();                       // before its stage is refilled
  }
}

// bf16: one window a CTA, staged through registers -- every load of a
// thread issued before any of its stores.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    halo_stencil2d_once(const T* __restrict__ x, const T* __restrict__ wx,
                        const T* __restrict__ wy, float* __restrict__ y,
                        SsrGrid g, SsrStream sx, SsrStream swx, SsrStream swy,
                        SsrStream sy, int64_t subr, int64_t subc) {
  __shared__ __align__(16) float xs[kWideRows * kPitch];
  __shared__ float wxs[kTaps], wys[kTaps];
  load_taps(wx, wy, swx, swy, g, wxs, wys);
  const Window<T> win = window_of(static_cast<int64_t>(blockIdx.x), x, y, g, sx,
                                  sy, subr, subc);
  const int wrows = win.rows + kTaps - 1, wcols = win.cols + kTaps - 1;
  const int total = wrows * wcols;
  for (int base = 0; base < total; base += 8 * kThreads) {
    float r[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int i = base + threadIdx.x + k * kThreads;
      if (i < total) r[k] = ssr_f32(win.src[(i / wcols) * sx.pitch + i % wcols]);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int i = base + threadIdx.x + k * kThreads;
      if (i < total) xs[(i / wcols) * kPitch + i % wcols] = r[k];
    }
  }
  __syncthreads();
  compute_window(xs, wxs, wys, win.dst, sy.pitch, win.rows, win.cols);
}

constexpr size_t kRingBytes = kWinStages * sizeof(float) * kWideRows * kPitch;

int launch(int dtype, int vec, const void* x, const void* wx, const void* wy,
           void* y, const SsrGrid* g, const SsrStream* sx, const SsrStream* swx,
           const SsrStream* swy, const SsrStream* sy, int64_t windows,
           int64_t subr, int64_t subc, int64_t ctas, cudaStream_t st) {
  float* out = static_cast<float*>(y);
  if (dtype == SSR_F32 && (vec == 4 || vec == 1)) {
    auto kernel = vec == 4 ? halo_stencil2d_ring<4> : halo_stencil2d_ring<1>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kRingBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t n = ctas < windows ? ctas : windows;
    kernel<<<static_cast<unsigned>(n), kThreads, kRingBytes, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(wx),
        static_cast<const float*>(wy), out, *g, *sx, *swx, *swy, *sy, subr, subc,
        windows);
  } else if (dtype == SSR_BF16 && vec == 1) {
    if (windows >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidValue);
    halo_stencil2d_once<__nv_bfloat16><<<static_cast<unsigned>(windows), kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wx),
        static_cast<const __nv_bfloat16*>(wy), out, *g, *sx, *swx, *swy, *sy, subr,
        subc);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `sx` is the first slot's walk of x (its block is the unwidened tile);
// `vec` is 4 when x is f32 with 16-byte aligned rows and blocks, else 1.
// One CTA per 32 x 128 sub-tile of each grid step's block; y is f32.
// `ctas` persistent CTAs (f32) walk the windows; a bf16 call launches one
// CTA a window.
extern "C" int ssr_halo_stencil2d(const void* x, const void* wx,
                                  const void* wy, void* y, int dtype, int vec,
                                  const SsrGrid* g, const SsrStream* sx,
                                  const SsrStream* swx, const SsrStream* swy,
                                  const SsrStream* sy, int64_t ctas,
                                  void* stream) {
  int64_t steps = 1;
  for (int k = 0; k < g->ndim; ++k) steps *= g->dims[k];
  const int64_t subr = (sx->block[0] + kRows - 1) / kRows;
  const int64_t subc = (sx->block[1] + kCols - 1) / kCols;
  return launch(dtype, vec, x, wx, wy, y, g, sx, swx, swy, sy, steps * subr * subc,
                subr, subc, ctas, static_cast<cudaStream_t>(stream));
}

// Shared memory of one CTA for a window of `taps` (the kernel takes 11).
extern "C" int64_t ssr_halo_stencil2d_smem_bytes(int64_t taps) {
  (void)taps;
  return static_cast<int64_t>(kRingBytes + sizeof(float) * 2 * kTaps);
}
