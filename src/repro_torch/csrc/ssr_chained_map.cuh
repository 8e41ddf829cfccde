// The programs of K17 chained_map and its ring kernel R5 ring_chained_map:
// a ChainedKernel's producer body, then its consumer body, on one element,
// so the two kernels compute the same bits.
//
// A program is producer * 2 + consumer, numbered as
// repro_torch/core/hopper.py numbers them (CHAINED_PRODUCERS,
// CHAINED_CONSUMERS).  The producer works in the storage dtype T, as the
// reference hands its body the stored blocks: each operation is computed in
// float and rounded to T, as PyTorch (and the reference) round each one;
// products and sums are __fmul_rn / __fadd_rn (no contraction into an FMA)
// and alpha is rounded to T first.  The intermediate is then rounded to the
// output dtype (here T: the kernels take one dtype), and the consumer, relu
// or identity, selects on that value.
#pragma once

#include "ssr_common.cuh"

enum SsrProducer { kProdIdentity = 0, kProdRelu = 1, kProdSqDiff = 2, kProdAxpy = 3,
                   kProdMul = 4 };
enum SsrConsumer { kConsIdentity = 0, kConsRelu = 1 };

// Read streams a producer takes.
template <int P>
__host__ __device__ constexpr int ssr_producer_streams() {
  return P >= kProdSqDiff ? 2 : 1;
}

template <int P, typename T>
__device__ __forceinline__ T ssr_produce(T a, T b, T alpha) {
  if constexpr (P == kProdIdentity) {
    return a;
  } else if constexpr (P == kProdRelu) {
    return ssr_relu(a);
  } else if constexpr (P == kProdSqDiff) {
    const T d = ssr_cast<T>(__fsub_rn(ssr_f32(a), ssr_f32(b)));
    return ssr_cast<T>(__fmul_rn(ssr_f32(d), ssr_f32(d)));
  } else if constexpr (P == kProdAxpy) {
    const T p = ssr_cast<T>(__fmul_rn(ssr_f32(alpha), ssr_f32(a)));
    return ssr_cast<T>(__fadd_rn(ssr_f32(p), ssr_f32(b)));
  } else {
    return ssr_cast<T>(__fmul_rn(ssr_f32(a), ssr_f32(b)));
  }
}

template <int P, int C, typename T>
__device__ __forceinline__ T ssr_chained_value(T a, T b, T alpha) {
  const T t = ssr_produce<P, T>(a, b, alpha);
  if constexpr (C == kConsRelu) return ssr_relu(t);
  return t;
}

// Instantiate `Launch<P, C>` for program `prog` (producer * 2 + consumer);
// returns cudaErrorInvalidValue for a program that does not exist.
template <template <int, int> class Launch, typename... Ts>
int ssr_chained_dispatch(int prog, Ts&&... args) {
  switch (prog) {
    case 0: return Launch<0, 0>::run(args...);
    case 1: return Launch<0, 1>::run(args...);
    case 2: return Launch<1, 0>::run(args...);
    case 3: return Launch<1, 1>::run(args...);
    case 4: return Launch<2, 0>::run(args...);
    case 5: return Launch<2, 1>::run(args...);
    case 6: return Launch<3, 0>::run(args...);
    case 7: return Launch<3, 1>::run(args...);
    case 8: return Launch<4, 0>::run(args...);
    case 9: return Launch<4, 1>::run(args...);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
