// K4 contract_gemv: y_blk += A_blk . x_blk^T over the trailing contraction
// axes, in an f32 accumulator, cast to the output dtype on the drain.
//
// Replaces the TPU kernel repro/core/ssr.py:ssr_pallas (sync emitter) with
// the contraction branch of repro/core/lowering.py:_build_nest_kernel and the
// body repro/kernels/gemv.py:matvec_block.  x is a repeat stream: its block
// index ignores the row axis, so every row block re-reads the same x blocks.
// At 8192^2 the default lowering gives grid (16, 16), (parallel, arbitrary),
// with blocks A 512x512, x (1, 512) and y (1, 512).
//
// Bound on H100: bytes.  Each element of A is read once for one multiply-add.
//
// Design: one wave of CTAs, each walking whole units of work.  A unit is a
// row group (kRowsPerCta = 32 rows, four a warp) of one lowered output
// block; the units run output block by output block in grid order, row
// group by row group within one, and CTA c takes units [c * per, (c + 1) *
// per), `per` from the wrapper (core/hopper.py gemv_split: the fewest
// units a CTA that put every CTA in one wave at the CTAs an SM this kernel
// is built for).  For a unit the CTA stages the x blocks of many
// contraction steps at once -- up to kXFloats f32 (32 KiB: all 16 steps of
// the 8192^2 cell), in 16-byte packs where x's rows allow them -- between
// two CTA barriers, the first kAhead steps' rows of A prefetched to L2
// meanwhile, then walks those steps in grid order with no barrier between
// them, as the repeat register reuses x.  A lane reads
// consecutive 16-byte packs of its warp's four rows (where the wrapper
// found A aligned for it): with four packs a row unrolled, 16 packs of A
// in flight a lane, each read once with an evict-first hint (ld.global.cs)
// so that the staged x blocks stay in L2.
//
// Each output keeps the bits of K4's first design: a lane sums its packs c
// = lane, lane + 32, ... of each step in step order, the elements of a
// pack in order, by fmaf on x converted to f32; the row sum folds across
// the warp (xor 16, 8, 4, 2, 1).  R4 (ring_contract_gemv.cu) chains the
// same operations, so the two agree to the bit.
//
// With `relu` set (body op matvec_relu, the fused gemv_relu of
// repro/kernels/chained.py:63-72, whose relu rides the reference's finish)
// the drain writes max(0, y), selected as K2 selects it (ssr_relu), once per
// output element after the whole contraction: never to a partial.
#include <cstring>

#include "ssr_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerCta = kWarps * kRowsPerWarp;  // 32: a row group
constexpr int kXFloats = 8192;   // x staged at once: 32 KiB of f32
constexpr int kMaxSteps = 64;    // contraction steps staged at once, most
constexpr int kMinCtas = 2;      // CTAs an SM it is built for
constexpr int kAhead = 2;        // a chunk's first steps prefetched

// V elements of A at p, read once: ld.global.cs, evict-first in L1 and L2.
template <typename T, int V>
__device__ __forceinline__ SsrPack<T, V> load_first(const T* p) {
  using Pack = SsrPack<T, V>;
  Pack r;
  if constexpr (sizeof(Pack) == 16) {
    const uint4 u = __ldcs(reinterpret_cast<const uint4*>(p));
    memcpy(&r, &u, sizeof(Pack));
  } else if constexpr (sizeof(Pack) == 4) {
    const unsigned u = __ldcs(reinterpret_cast<const unsigned*>(p));
    memcpy(&r, &u, sizeof(Pack));
  } else {
    const unsigned short u = __ldcs(reinterpret_cast<const unsigned short*>(p));
    memcpy(&r, &u, sizeof(Pack));
  }
  return r;
}

// Four floats from 16 bytes of f32, or eight from 16 bytes of bf16.
__device__ __forceinline__ void widen16(float* d, uint4 u, float) {
  *reinterpret_cast<float4*>(d) = make_float4(
      __uint_as_float(u.x), __uint_as_float(u.y), __uint_as_float(u.z),
      __uint_as_float(u.w));
}
__device__ __forceinline__ void widen16(float* d, uint4 u, __nv_bfloat16) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 2; ++k)
    *reinterpret_cast<float4*>(d + 4 * k) = make_float4(
        __uint_as_float(w[2 * k] << 16), __uint_as_float(w[2 * k] & 0xffff0000u),
        __uint_as_float(w[2 * k + 1] << 16),
        __uint_as_float(w[2 * k + 1] & 0xffff0000u));
}

// The first `len` elements of the warp's live rows from `row` on (row i
// at row + i * pitch) on their way to L2, a 128-byte line a prefetch.
template <typename T>
__device__ __forceinline__ void prefetch_rows(const T* row, int64_t pitch,
                                              int len,
                                              const bool (&live)[kRowsPerWarp],
                                              int lane) {
  const int bytes = len * static_cast<int>(sizeof(T));
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
    if (live[i])
      for (int b = lane * 128; b < bytes; b += 32 * 128)
        asm volatile("prefetch.global.L2 [%0];" ::"l"(
            reinterpret_cast<const char*>(row + i * pitch) + b));
}

// Columns [c0, c0 + len) of the x blocks of `ns` steps (step s's block at
// x + xoff[s]) into xs as f32, step s at xs + s * len: 16-byte packs where
// x's rows allow them (`packs`), else one element a copy.
template <typename T>
__device__ __forceinline__ void stage_x(float* xs, const T* __restrict__ x,
                                        const int64_t* xoff, int ns,
                                        int64_t c0, int len, bool packs) {
  if (packs) {
    constexpr int kV = 16 / static_cast<int>(sizeof(T));
    const int per = len / kV;
    for (int i = threadIdx.x; i < ns * per; i += kThreads) {
      const int s = i / per, c = (i - s * per) * kV;
      const uint4 u = *reinterpret_cast<const uint4*>(x + xoff[s] + c0 + c);
      widen16(xs + s * len + c, u, T());
    }
  } else {
    for (int i = threadIdx.x; i < ns * len; i += kThreads) {
      const int s = i / len, c = i - s * len;
      xs[s * len + c] = ssr_f32(x[xoff[s] + c0 + c]);
    }
  }
}

template <typename T, typename O, int V>
__global__ void __launch_bounds__(kThreads, kMinCtas)
    contract_gemv_kernel(const T* __restrict__ a, const T* __restrict__ x,
                         O* __restrict__ y, SsrGrid g, SsrStream sa,
                         SsrStream sx, SsrStream sy, int64_t zsteps,
                         int64_t groups, int64_t units, int64_t per,
                         int xvec, int relu) {
  using Pack = SsrPack<T, V>;
  using XPack = SsrPack<float, V>;
  __shared__ __align__(32) float xs[kXFloats];
  __shared__ int64_t aoff[kMaxSteps], xoff[kMaxSteps];
  const int64_t tm = sa.block[0], tn = sa.block[1], pitch = sa.pitch;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // a chunk: whole steps where a step's block fits xs, else a piece of one
  const int chunk_steps = tn <= kXFloats
      ? static_cast<int>(kXFloats / tn < kMaxSteps ? kXFloats / tn : kMaxSteps)
      : 1;
  const int width = static_cast<int>(tn <= kXFloats ? tn : kXFloats);
  const int64_t u0 = static_cast<int64_t>(blockIdx.x) * per;
  const int64_t u1 = u0 + per < units ? u0 + per : units;
  for (int64_t u = u0; u < u1; ++u) {
    const int64_t p = u / groups;                 // the output block
    const int64_t r0 = (u % groups) * kRowsPerCta + warp * kRowsPerWarp;
    bool live[kRowsPerWarp];
    float part[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      live[i] = r0 + i < tm;
      part[i] = 0.f;
    }
    for (int64_t z0 = 0; z0 < zsteps; z0 += chunk_steps) {
      const int ns = static_cast<int>(
          zsteps - z0 < chunk_steps ? zsteps - z0 : chunk_steps);
      __syncthreads();              // the last chunk is read
      if (threadIdx.x < ns) {
        const SsrOdometer odo(g, p * zsteps + z0 + threadIdx.x);
        aoff[threadIdx.x] = odo.origin(sa);
        xoff[threadIdx.x] = odo.origin(sx);
      }
      __syncthreads();
      for (int64_t c0 = 0; c0 < tn; c0 += width) {
        const int len = static_cast<int>(tn - c0 < width ? tn - c0 : width);
        if (c0 > 0) __syncthreads();    // the step's last piece is read
        // the chunk's first steps of A come while x is staged
        for (int s = 0; s < kAhead && s < ns; ++s)
          prefetch_rows(a + aoff[s] + r0 * pitch + c0, pitch, len, live, lane);
        stage_x<T>(xs, x, xoff, ns, c0, len, xvec != 0);
        __syncthreads();
        for (int s = 0; s < ns; ++s) {
          const T* row = a + aoff[s] + r0 * pitch + c0;   // the warp's first row
          const XPack* xp = reinterpret_cast<const XPack*>(xs + s * len);
#pragma unroll 4
          for (int c = lane; c < len / V; c += 32) {
            const XPack xv = xp[c];
            Pack av[kRowsPerWarp];
#pragma unroll
            for (int i = 0; i < kRowsPerWarp; ++i)
              if (live[i]) av[i] = load_first<T, V>(row + i * pitch + c * V);
#pragma unroll
            for (int i = 0; i < kRowsPerWarp; ++i) {
              if (live[i]) {
#pragma unroll
                for (int j = 0; j < V; ++j)
                  part[i] = fmaf(ssr_f32(av[i].v[j]), xv.v[j], part[i]);
              }
            }
          }
        }
      }
    }
    // drain: y's block is (1, tm); its element (0, r) sits at origin + r
    O* py = y + ssr_block_origin(sy, g, p * zsteps);
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        part[i] += __shfl_xor_sync(0xffffffffu, part[i], o);
      if (relu) part[i] = ssr_relu(part[i]);
      if (lane == 0 && live[i]) py[r0 + i] = ssr_cast<O>(part[i]);
    }
  }
}

template <typename T, typename O>
int launch(int vec, const void* a, const void* x, void* y, const SsrGrid* g,
           const SsrStream* sa, const SsrStream* sx, const SsrStream* sy,
           int64_t zsteps, int64_t groups, int64_t units, int64_t per,
           int xvec, int relu, cudaStream_t st) {
  constexpr int kV = 16 / sizeof(T);
  const unsigned n = static_cast<unsigned>((units + per - 1) / per);
  if (vec == kV)
    contract_gemv_kernel<T, O, kV><<<n, kThreads, 0, st>>>(
        static_cast<const T*>(a), static_cast<const T*>(x), static_cast<O*>(y),
        *g, *sa, *sx, *sy, zsteps, groups, units, per, xvec, relu);
  else if (vec == 1)
    contract_gemv_kernel<T, O, 1><<<n, kThreads, 0, st>>>(
        static_cast<const T*>(a), static_cast<const T*>(x), static_cast<O*>(y),
        *g, *sa, *sx, *sy, zsteps, groups, units, per, xvec, relu);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `vec` is 16 / sizeof(element) when A's pitch, block width and base pointer
// allow 16-byte accesses, else 1; `xvec` 1 when x's do (its blocks are then
// staged in 16-byte packs); each CTA walks `units_per_cta` units (a row
// group of kRowsPerCta rows of one output block), consecutive
// (core/hopper.py gemv_split); `relu` (0 or 1) selects the relu drain.
extern "C" int ssr_contract_gemv(const void* a, const void* x, void* y,
                                 int in_dtype, int out_dtype, int vec,
                                 int xvec, const SsrGrid* g,
                                 const SsrStream* sa, const SsrStream* sx,
                                 const SsrStream* sy, int64_t zsteps,
                                 int64_t units_per_cta, int relu,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int64_t steps = 1;
  for (int k = 0; k < g->ndim; ++k) steps *= g->dims[k];
  const int64_t groups = (sa->block[0] + kRowsPerCta - 1) / kRowsPerCta;
  const int64_t units = (steps / zsteps) * groups;
  if (zsteps < 1 || steps % zsteps || units_per_cta < 1 ||
      (units + units_per_cta - 1) / units_per_cta > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t per = units_per_cta;
  if (in_dtype == SSR_F32 && out_dtype == SSR_F32)
    return launch<float, float>(vec, a, x, y, g, sa, sx, sy, zsteps, groups, units, per, xvec, relu, st);
  if (in_dtype == SSR_F32 && out_dtype == SSR_BF16)
    return launch<float, __nv_bfloat16>(vec, a, x, y, g, sa, sx, sy, zsteps, groups, units, per, xvec, relu, st);
  if (in_dtype == SSR_BF16 && out_dtype == SSR_F32)
    return launch<__nv_bfloat16, float>(vec, a, x, y, g, sa, sx, sy, zsteps, groups, units, per, xvec, relu, st);
  if (in_dtype == SSR_BF16 && out_dtype == SSR_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(vec, a, x, y, g, sa, sx, sy, zsteps, groups, units, per, xvec, relu, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Static shared memory: the staged x and the steps' offsets.
extern "C" int64_t ssr_contract_gemv_smem_bytes() {
  return static_cast<int64_t>(sizeof(float)) * kXFloats +
         2 * static_cast<int64_t>(sizeof(int64_t)) * kMaxSteps;
}

// Registers a thread, local (spilled) bytes a thread and CTAs an SM of one
// build (`build`: in f32 or bf16, out f32 or bf16, vec 16 / sizeof or 1,
// in the order of core/hopper.py GEMV_BUILDS): out[0], out[1], out[2].
extern "C" int ssr_contract_gemv_attributes(int64_t* out, int64_t build) {
  const void* const kernels[] = {
      reinterpret_cast<const void*>(contract_gemv_kernel<float, float, 4>),
      reinterpret_cast<const void*>(contract_gemv_kernel<float, float, 1>),
      reinterpret_cast<const void*>(contract_gemv_kernel<float, __nv_bfloat16, 4>),
      reinterpret_cast<const void*>(contract_gemv_kernel<float, __nv_bfloat16, 1>),
      reinterpret_cast<const void*>(contract_gemv_kernel<__nv_bfloat16, float, 8>),
      reinterpret_cast<const void*>(contract_gemv_kernel<__nv_bfloat16, float, 1>),
      reinterpret_cast<const void*>(contract_gemv_kernel<__nv_bfloat16, __nv_bfloat16, 8>),
      reinterpret_cast<const void*>(contract_gemv_kernel<__nv_bfloat16, __nv_bfloat16, 1>)};
  if (build < 0 || build >= 8) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernels[build]);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = fa.numRegs;
  out[1] = static_cast<int64_t>(fa.localSizeBytes);
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernels[build],
                                                      kThreads, 0);
  out[2] = ctas;
  return static_cast<int>(err);
}
