// Shared AGU programming for the streamed Hopper kernels of repro_torch.
//
// A lowered SSR kernel is a grid plus one affine block walk per stream
// (repro_torch/core/agu.py::BlockAGU).  The kernels receive that walk as
// arguments -- the AGU's bound/stride registers -- and compute every address
// from it; nothing here re-derives a layout from a problem size.
//
//   block index at grid step g = offset + sum_k g_k * coeff[k]
//   element (r, c) of the block = (index[0]*block[0] + r) * pitch
//                                 + index[1]*block[1] + c
//
// Grid steps are numbered row-major (last axis fastest), as the reference
// Pallas grid runs them; contraction axes are trailing.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define SSR_MAX_AXES 4

// Element types, numbered as repro_torch/core/hopper.py numbers them.
enum SsrDtype { SSR_F32 = 0, SSR_BF16 = 1, SSR_I32 = 2 };

struct SsrGrid {
  int64_t ndim;
  int64_t dims[SSR_MAX_AXES];
};

struct SsrStream {
  int64_t offset[2];
  int64_t coeff[SSR_MAX_AXES][2];
  int64_t block[2];
  int64_t pitch;  // elements per row of the 2-D layout
};

// The grid multi-index of a flat step.  Unflattening costs divisions, so a
// kernel that walks consecutive steps unflattens once and then advances.
struct SsrOdometer {
  int64_t g[SSR_MAX_AXES];

  __device__ __forceinline__ SsrOdometer(const SsrGrid& grid, int64_t step) {
#pragma unroll
    for (int k = SSR_MAX_AXES - 1; k >= 0; --k) {
      g[k] = 0;
      if (k < grid.ndim) {
        g[k] = step % grid.dims[k];
        step /= grid.dims[k];
      }
    }
  }

  __device__ __forceinline__ void advance(const SsrGrid& grid) {
#pragma unroll
    for (int k = SSR_MAX_AXES - 1; k >= 0; --k) {
      if (k < grid.ndim) {
        if (++g[k] < grid.dims[k]) return;
        g[k] = 0;
      }
    }
  }

  // Block index along dim `d` (0: rows, 1: columns) of the block `s`
  // delivers here.
  __device__ __forceinline__ int64_t index(const SsrStream& s, int d) const {
    int64_t i = s.offset[d];
#pragma unroll
    for (int k = 0; k < SSR_MAX_AXES; ++k) i += g[k] * s.coeff[k][d];
    return i;
  }

  // Flat position of the (0, 0) element of the block `s` delivers here.
  __device__ __forceinline__ int64_t origin(const SsrStream& s) const {
    int64_t i0 = s.offset[0], i1 = s.offset[1];
#pragma unroll
    for (int k = 0; k < SSR_MAX_AXES; ++k) {
      i0 += g[k] * s.coeff[k][0];
      i1 += g[k] * s.coeff[k][1];
    }
    return i0 * s.block[0] * s.pitch + i1 * s.block[1];
  }
};

// Flat position of the (0, 0) element of the block delivered at `step`.
__device__ __forceinline__ int64_t ssr_block_origin(const SsrStream& s,
                                                    const SsrGrid& g,
                                                    int64_t step) {
  return SsrOdometer(g, step).origin(s);
}

__device__ __forceinline__ float ssr_f32(float x) { return x; }
__device__ __forceinline__ float ssr_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T ssr_cast(float x);
template <>
__device__ __forceinline__ float ssr_cast<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 ssr_cast<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// max(0, v), dtype kept, bit-exact with jnp.maximum(v, 0): the value is
// selected, never computed, so int32 above 2^24 stays exact, NaN passes
// through with its payload and -0.0 becomes +0.0.  The float tests run on
// the bits: a float compare-and-select may be fused into max.NaN, which
// returns the canonical NaN instead of the input's.
__device__ __forceinline__ float ssr_relu(float v) {
  const uint32_t u = __float_as_uint(v);
  const bool keep = static_cast<int32_t>(u) > 0 || (u & 0x7fffffffu) > 0x7f800000u;
  return keep ? v : 0.f;
}
__device__ __forceinline__ __nv_bfloat16 ssr_relu(__nv_bfloat16 v) {
  const uint16_t u = __bfloat16_as_ushort(v);
  const bool keep = static_cast<int16_t>(u) > 0 || (u & 0x7fffu) > 0x7f80u;
  return keep ? v : __ushort_as_bfloat16(0);
}
__device__ __forceinline__ int32_t ssr_relu(int32_t v) { return v > 0 ? v : 0; }

// V consecutive elements moved as one access (16 bytes when the wrapper
// found every address aligned; V = 1 otherwise).
template <typename T, int V>
struct alignas(sizeof(T) * V) SsrPack {
  T v[V];
};

// Asynchronous copies from device memory to shared memory (cp.async): a
// 16-byte copy needs both addresses 16-byte aligned.  A thread's copies
// join a group at `ssr_cp_async_commit`; `ssr_cp_async_wait<N>` waits until
// at most N of its groups are pending.  A __syncthreads() after the wait
// makes every thread's copies visible to the CTA.
__device__ __forceinline__ void ssr_cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void ssr_cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void ssr_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void ssr_cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Message for a code that an entry point returned (cudaError_t).
extern "C" const char* ssr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Sum of `v` over the CTA, in a fixed order (same result every run).
// Valid in thread 0.  THREADS is a multiple of 32, at most 1024.
template <int THREADS>
__device__ __forceinline__ float ssr_cta_sum(float v) {
  __shared__ float warp_sums[THREADS / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < THREADS / 32 ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  }
  return v;
}

// The barrier of THREADS threads numbered BAR: the CTA's (__syncthreads)
// for BAR 0, else a named barrier that only those threads join (the first
// THREADS of the CTA, while other warps, a filling warp, run on).
template <int BAR, int THREADS>
__device__ __forceinline__ void ssr_bar() {
  if constexpr (BAR == 0)
    __syncthreads();
  else
    asm volatile("bar.sync %0, %1;\n" ::"n"(BAR), "n"(THREADS) : "memory");
}

// Exclusive scan of one value a thread over the CTA, in a fixed order (the
// same result every run): each warp scans with shuffles, warp 0 scans the
// warps' totals.  `*total` gets the CTA's total in every thread.  Every
// thread of the CTA must call it (with BAR > 0: the first THREADS threads,
// meeting at named barrier BAR).  THREADS is a multiple of 32, at most 1024.
template <int THREADS, int BAR = 0>
__device__ __forceinline__ float ssr_cta_exclusive_scan(float v, float* total) {
  constexpr int kWarps = THREADS / 32;
  __shared__ float warp_incl[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
  ssr_bar<BAR, THREADS>();  // a previous call's readers of warp_incl are done
  if (lane == 31) warp_incl[warp] = incl;
  ssr_bar<BAR, THREADS>();
  if (warp == 0) {
    float w = lane < kWarps ? warp_incl[lane] : 0.f;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += t;
    }
    if (lane < kWarps) warp_incl[lane] = w;
  }
  ssr_bar<BAR, THREADS>();
  *total = warp_incl[kWarps - 1];
  return warp > 0 ? warp_incl[warp - 1] + excl : excl;
}

// Four consecutive elements as floats, one 16-byte (f32, int32) or 8-byte
// (bf16) load; int32 rounds to nearest, as a cast to float32 does.  The
// caller checked the alignment.
template <typename T>
__device__ __forceinline__ float4 ssr_load4_f32(const T* p);
template <>
__device__ __forceinline__ float4 ssr_load4_f32<float>(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
template <>
__device__ __forceinline__ float4 ssr_load4_f32<__nv_bfloat16>(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
template <>
__device__ __forceinline__ float4 ssr_load4_f32<int32_t>(const int32_t* p) {
  const int4 v = *reinterpret_cast<const int4*>(p);
  return make_float4(__int2float_rn(v.x), __int2float_rn(v.y), __int2float_rn(v.z),
                     __int2float_rn(v.w));
}

// Walks the cells of a (rows, cols) block with a fixed thread stride,
// without a division per cell: (r, c) advance by (dr, dc) each step.
// A block holds fewer than 2^31 cells (the wrappers check).
struct SsrBlockWalk {
  int r, c, dr, dc, cols;
  __device__ __forceinline__ SsrBlockWalk(int first, int stride, int cols_)
      : r(first / cols_), c(first % cols_), dr(stride / cols_),
        dc(stride % cols_), cols(cols_) {}
  __device__ __forceinline__ void next() {
    r += dr;
    c += dc;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
};
