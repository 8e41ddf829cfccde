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

// V consecutive elements moved as one access (16 bytes when the wrapper
// found every address aligned; V = 1 otherwise).
template <typename T, int V>
struct alignas(sizeof(T) * V) SsrPack {
  T v[V];
};

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
