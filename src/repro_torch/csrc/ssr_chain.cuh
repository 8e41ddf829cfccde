// The elementwise chain programs of K5 chain_elem and its ring kernel R6
// ring_chain_elem: one value per element of the streamed blocks, so the two
// kernels compute the same bits.
//
// Programs (`prog`):
//   0  reduce  sum (x - y)^2            (sq_diff -> identity, fused)
//   1  reduce  sum (alpha x + y) * w     (axpy -> mul, fused)
//   2  map     (x - y)^2                 (sq_diff, unfused producer)
//   3  map     alpha x + y               (axpy, unfused producer)
//   4  reduce  sum t                     (identity, unfused consumer)
// Each product is rounded as the reference rounds it (__fmul_rn, __fadd_rn:
// no contraction into an FMA).
#pragma once

#include "ssr_common.cuh"

template <int PROG>
__device__ __forceinline__ float chain_value(float a, float b, float c,
                                             float alpha) {
  if constexpr (PROG == 0 || PROG == 2) {
    const float d = a - b;
    return __fmul_rn(d, d);
  } else if constexpr (PROG == 1) {
    return __fmul_rn(__fadd_rn(__fmul_rn(alpha, a), b), c);
  } else if constexpr (PROG == 3) {
    return __fadd_rn(__fmul_rn(alpha, a), b);
  } else {
    return a;
  }
}
