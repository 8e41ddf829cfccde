// B5 base_stencil1d: the monolithic baseline of the 11-tap stencil,
// y[i] = sum_j w[j] * x[i + j], f32 out.
//
// Replaces the TPU kernel repro/kernels/frontend.py:MonolithicKernel._build
// with the baseline body repro/kernels/stencil.py:_baseline_body_1d: one
// grid step with all of x in VMEM, whose body loops over the taps, each tap
// one explicit dynamic-slice load of x, accumulated in f32.
//
// Bound on H100: bytes, as K9: each input element read once, each output
// written once.
//
// The baseline's rule, which K9's stream walk breaks and B5 keeps: an
// explicit load before every use.  Each output's 11 taps are 11 explicit
// loads, in tap order, each used by its FMA; no tap value is carried from
// one output to another in a register (a thread's outputs lie kThreads
// apart, so no two share a tap), and nothing of a later step is loaded
// ahead: the step loop is rolled (#pragma unroll 1), with no read-ahead
// batch, ring, bulk copy or prefetch.
//
// Design: the counterpart of the TPU baseline's x in VMEM is the step's
// tile.  B5 walks K9's default tile (512 outputs a grid step) on K9's kind
// of split (core/hopper.py BASE_STENCIL_PER_SM CTAs an SM, runs of
// consecutive steps), 128 threads of four outputs.  Each step stages its
// 512 + 10 inputs in shared memory by plain loads, widened to f32 (16-byte
// loads where the wrapper found x's base on a 16-byte boundary, vec = 4
// in f32 and 8 in bf16, else one element a load), then one barrier, then
// each output's taps are read from the tile -- one conflict-free shared
// load a warp a tap, where the parent's eleven global loads straddled two
// 128-byte lines for ten taps of eleven -- and one barrier before the tile
// is filled again.
//
// The bits are the parent's, written out so that they no longer depend on
// the compiler: tap 1's product rounded, tap 0's fused onto it, then taps
// 2 .. 10 each by one fmaf in tap order (the parent's acc = w0*x0;
// acc = acc + w_j*x_j as nvcc contracted it; core/hopper.py
// base_stencil1d_model).
#include "ssr_common.cuh"

namespace {

constexpr int kTaps = 11;
constexpr int kThreads = 128;
constexpr int kPer = 4;
constexpr int kTile = kThreads * kPer;   // K9's default tile: 512 outputs
constexpr int kSpan = kTile + kTaps - 1; // the inputs a step reads
// CTAs an SM B5 is built for (at most 32 registers a thread: 64 warps
// an SM, the most bytes in flight a tile at a time allows)
constexpr int kMinCtas = 16;

// x[e .. e + V) (V = 1: x[e]) widened into dst[0 .. V), one plain load.
template <typename T, int V>
__device__ __forceinline__ void stage(const T* __restrict__ x, int64_t e,
                                      float* dst) {
  if constexpr (V == 1) {
    dst[0] = ssr_f32(x[e]);
  } else {
    const uint4 raw = *reinterpret_cast<const uint4*>(x + e);
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<uint4*>(dst) = raw;
    } else {                           // eight bf16: the high halves of f32
      *reinterpret_cast<float4*>(dst) = make_float4(
          __uint_as_float(raw.x << 16), __uint_as_float(raw.x & 0xffff0000u),
          __uint_as_float(raw.y << 16), __uint_as_float(raw.y & 0xffff0000u));
      *reinterpret_cast<float4*>(dst + 4) = make_float4(
          __uint_as_float(raw.z << 16), __uint_as_float(raw.z & 0xffff0000u),
          __uint_as_float(raw.w << 16), __uint_as_float(raw.w & 0xffff0000u));
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads, kMinCtas)
    base_stencil1d_kernel(const T* __restrict__ x, const float* __restrict__ w,
                          float* __restrict__ y, int64_t n, int64_t steps,
                          int64_t per_cta) {
  __shared__ __align__(16) float tile[kSpan + 2];
  const int64_t total = n + kTaps - 1;            // x's elements
  const int64_t first = blockIdx.x * per_cta;
  const int64_t last = first + per_cta < steps ? first + per_cta : steps;
  float wr[kTaps];
#pragma unroll
  for (int j = 0; j < kTaps; ++j) wr[j] = w[j];
#pragma unroll 1
  for (int64_t step = first; step < last; ++step) {
    const int64_t base = step * kTile;
    // the step's tile: its 512 inputs in packs of V, then the 10 after
#pragma unroll
    for (int p = threadIdx.x; p < kTile / V; p += kThreads) {
      const int64_t e = base + static_cast<int64_t>(p) * V;
      if (e + V <= total) {
        stage<T, V>(x, e, tile + p * V);
      } else {
#pragma unroll
        for (int q = 0; q < V; ++q)
          if (e + q < total) tile[p * V + q] = ssr_f32(x[e + q]);
      }
    }
    if (threadIdx.x < kTaps - 1 && base + kTile + threadIdx.x < total)
      tile[kTile + threadIdx.x] = ssr_f32(x[base + kTile + threadIdx.x]);
    __syncthreads();
#pragma unroll
    for (int o = 0; o < kPer; ++o) {
      const int t = o * kThreads + threadIdx.x;
      if (base + t >= n) continue;
      const float x0 = tile[t], x1 = tile[t + 1];     // taps 0 and 1
      float acc = fmaf(wr[0], x0, __fmul_rn(wr[1], x1));
#pragma unroll
      for (int j = 2; j < kTaps; ++j) acc = fmaf(wr[j], tile[t + j], acc);
      y[base + t] = acc;
    }
    __syncthreads();
  }
}

template <typename T, int V>
int launch(const void* x, const void* w, void* y, int64_t n, int64_t steps,
           int64_t ctas, int64_t per_cta, cudaStream_t st) {
  base_stencil1d_kernel<T, V><<<static_cast<unsigned>(ctas), kThreads, 0,
                                st>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<float*>(y), n, steps, per_cta);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x holds n + 10 elements (f32 or bf16), w the 11 f32 taps, y n f32 outputs;
// `ctas` CTAs walk `per_cta` tiles of 512 outputs each.  `vec` is
// 16 / sizeof(element) where x's base pointer is on a 16-byte boundary,
// else 1.
extern "C" int ssr_base_stencil1d(const void* x, const void* w, void* y,
                                  int dtype, int vec, int64_t n, int64_t ctas,
                                  int64_t per_cta, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t steps = (n + kTile - 1) / kTile;
  if (n < 1 || ctas < 1 || ctas > 0x7fffffffLL || per_cta < 1 ||
      ctas * per_cta < steps)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == SSR_F32 && vec == 4)
    return launch<float, 4>(x, w, y, n, steps, ctas, per_cta, st);
  if (dtype == SSR_F32 && vec == 1)
    return launch<float, 1>(x, w, y, n, steps, ctas, per_cta, st);
  if (dtype == SSR_BF16 && vec == 8)
    return launch<__nv_bfloat16, 8>(x, w, y, n, steps, ctas, per_cta, st);
  if (dtype == SSR_BF16 && vec == 1)
    return launch<__nv_bfloat16, 1>(x, w, y, n, steps, ctas, per_cta, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The static tile of a CTA, 16-byte aligned.
extern "C" int64_t ssr_base_stencil1d_smem_bytes() {
  return static_cast<int64_t>(sizeof(float)) * (kSpan + 2);
}

// Registers a thread and local (spill) bytes, the most over the four
// builds, as cudaFuncGetAttributes reads them, and the CTAs an SM of the
// main path's (f32 in 16-byte loads; occupancy API): out[0] numRegs,
// out[1] localSizeBytes, out[2] CTAs an SM.
extern "C" int ssr_base_stencil1d_attributes(int64_t* out) {
  const void* const kernels[] = {
      reinterpret_cast<const void*>(base_stencil1d_kernel<float, 4>),
      reinterpret_cast<const void*>(base_stencil1d_kernel<float, 1>),
      reinterpret_cast<const void*>(base_stencil1d_kernel<__nv_bfloat16, 8>),
      reinterpret_cast<const void*>(base_stencil1d_kernel<__nv_bfloat16, 1>)};
  out[0] = out[1] = out[2] = 0;
  for (const void* kn : kernels) {
    cudaFuncAttributes fa;
    cudaError_t err = cudaFuncGetAttributes(&fa, kn);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (fa.numRegs > out[0]) out[0] = fa.numRegs;
    if (static_cast<int64_t>(fa.localSizeBytes) > out[1])
      out[1] = static_cast<int64_t>(fa.localSizeBytes);
  }
  int ctas = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &ctas, base_stencil1d_kernel<float, 4>, kThreads, 0);
  out[2] = ctas;
  return static_cast<int>(err);
}
