// Warp-per-row helpers of the DAG kernels (K6 dag_layernorm, K7
// dag_softmax_xent).
//
// The reference's DAG bodies (repro/kernels/dag.py) work on (rows, 128)
// blocks holding one 128-element data row per block row, and reduce along
// the row (mean, max, logsumexp).  On Hopper one warp owns one row: four
// elements a lane, the row's sum or max by __shfl_xor_sync, so a row's
// values never leave the warp's registers between the stages of a fused
// DAG.
#pragma once

#include "ssr_common.cuh"

constexpr int kRowLanes = 128;  // elements of one data row (the policy's lanes)

__device__ __forceinline__ float ssr_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// max(a, b) that keeps a NaN from either side, as jnp.max and torch.amax do
// (fmaxf would drop it).
__device__ __forceinline__ float ssr_nanmax(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ float ssr_warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = ssr_nanmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// A 128-wide row held by one warp, four elements a lane.  With V = 4 lane l
// holds elements 4l..4l+3 (one 16-byte access; the wrapper checked the
// alignment), with V = 1 elements l, l+32, l+64, l+96 (coalesced 4-byte
// accesses).  Loads and stores use the same mapping.
template <int V>
struct SsrRow {
  float v[4];

  __device__ __forceinline__ void load(const float* row, int lane) {
    if constexpr (V == 4) {
      const float4 p = reinterpret_cast<const float4*>(row)[lane];
      v[0] = p.x; v[1] = p.y; v[2] = p.z; v[3] = p.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = row[lane + 32 * j];
    }
  }

  __device__ __forceinline__ void store(float* row, int lane) const {
    if constexpr (V == 4) {
      reinterpret_cast<float4*>(row)[lane] = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) row[lane + 32 * j] = v[j];
    }
  }

  // Sum and max over the whole row; every lane gets the result.
  __device__ __forceinline__ float sum() const {
    return ssr_warp_sum((v[0] + v[1]) + (v[2] + v[3]));
  }
  __device__ __forceinline__ float max() const {
    return ssr_warp_max(ssr_nanmax(ssr_nanmax(v[0], v[1]),
                                   ssr_nanmax(v[2], v[3])));
  }
};

// Flat position of row `r` of the block stream `s` delivers at the
// odometer's step.
__device__ __forceinline__ int64_t ssr_row_origin(const SsrOdometer& o,
                                                  const SsrStream& s, int r) {
  return o.origin(s) + static_cast<int64_t>(r) * s.pitch;
}

// Sum the per-CTA partials in a fixed order with one CTA (the second launch
// of a reduce): the result is the same from run to run.
constexpr int kFoldThreads = 1024;

__global__ void __launch_bounds__(kFoldThreads)
    ssr_fold_partials(const float* __restrict__ partials, int64_t n,
                      float* __restrict__ out) {
  float acc = 0.f;
  for (int64_t i = threadIdx.x; i < n; i += kFoldThreads) acc += partials[i];
  acc = ssr_cta_sum<kFoldThreads>(acc);
  if (threadIdx.x == 0) out[0] = acc;
}
