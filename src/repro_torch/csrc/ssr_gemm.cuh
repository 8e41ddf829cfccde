// The FMA core that K3 contract_gemm, R3 ring_contract_gemm and B3
// base_gemm share: a 128 x 128 output tile on 256 computing threads,
// thread (tx, ty) = (t % 16, t / 16) owning 8 rows and 8 columns, each
// output an f32 accumulator that starts at +0 and chains fmaf(a[row][k],
// b[k][col], acc) over k in ascending order -- K3's chain, so the same
// bits as K3 whatever the thread-to-output map and however the operands
// arrive.
//
// A chunk of `KC` k sits in shared memory as B (KC rows of 128 columns,
// read as two 16-byte loads a k) and A in one of two layouts, each with
// its fragment read:
//
// * rows (R3's slots, what a TMA box lands as): 128 rows of KC k on a row
//   stride of LDA elements; a thread reads each of its 8 rows as four
//   consecutive k at once (16 bytes in f32, 8 in bf16, converted to f32 as
//   K3 stages it), 32 registers of A beside the 64 accumulators.
//   RowsAdjacent gives the warp's two ty neighbouring rows at each read,
//   64 bytes apart on R3's unpadded 16-k f32 rows (32 in bf16): other
//   banks.
// * k-major (K3's and B3's buffers, A converted to f32 as it is stored):
//   KC rows of the tile's 128 rows on a stride of LDM floats; a thread
//   reads its 8 values at each k as two 16-byte loads, so its rows are
//   K3's (RowsK3), 8 registers of A.
#pragma once

#include "ssr_common.cuh"

namespace sgemm {

constexpr int kBM = 128, kBN = 128;
constexpr int kThreads = 256;   // 16 x 16 computing threads, 8 x 8 outputs

// The 8 tile rows of thread row ty: i < 4 in the upper half, i >= 4 in the
// lower; the warp's two ty (2w, 2w + 1) on neighbouring rows.
struct RowsAdjacent {
  int base;
  __device__ __forceinline__ explicit RowsAdjacent(int ty)
      : base((ty >> 1) * 8 + (ty & 1)) {}
  __device__ __forceinline__ int operator()(int i) const {
    return (i < 4 ? 0 : 64) + base + 2 * (i & 3);
  }
};

// K3's map: rows ty * 4 + i (the warp's two ty four rows apart).
struct RowsK3 {
  int base;
  __device__ __forceinline__ explicit RowsK3(int ty) : base(ty * 4) {}
  __device__ __forceinline__ int operator()(int i) const {
    return (i < 4 ? 0 : 64) + base + (i & 3);
  }
};

// Column j of thread column tx.
__device__ __forceinline__ int col(int tx, int j) {
  return (j < 4 ? 0 : 64) + tx * 4 + (j & 3);
}

__device__ __forceinline__ void zero(float (&acc)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
}

// acc[i][j] = fmaf(am[i], bn[j], acc[i][j]): one k of the chain.
__device__ __forceinline__ void fma_step(float (&acc)[8][8],
                                         const float (&am)[8],
                                         const float (&bn)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(am[i], bn[j], acc[i][j]);
}

// B's 8 values of thread column tx at k kk of the chunk.
template <typename T>
__device__ __forceinline__ void load_b(float (&bn)[8], const T* Bs, int kk,
                                       int tx) {
  const float4 b0 = ssr_load4_f32<T>(Bs + kk * kBN + tx * 4);
  const float4 b1 = ssr_load4_f32<T>(Bs + kk * kBN + 64 + tx * 4);
  bn[0] = b0.x; bn[1] = b0.y; bn[2] = b0.z; bn[3] = b0.w;
  bn[4] = b1.x; bn[5] = b1.y; bn[6] = b1.z; bn[7] = b1.w;
}

// acc += the chunk's KC k of A (row layout, As) times B (Bs), in k order.
template <int KC, int LDA, typename T, typename Rows>
__device__ __forceinline__ void chunk(float (&acc)[8][8], const T* As,
                                      const T* Bs, const Rows& rows,
                                      int tx) {
#pragma unroll
  for (int kq = 0; kq < KC / 4; ++kq) {
    float4 a4[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      a4[i] = ssr_load4_f32<T>(As + rows(i) * LDA + kq * 4);
#pragma unroll
    for (int k4 = 0; k4 < 4; ++k4) {
      float am[8], bn[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        am[i] = k4 == 0 ? a4[i].x : k4 == 1 ? a4[i].y
              : k4 == 2 ? a4[i].z : a4[i].w;
      load_b(bn, Bs, kq * 4 + k4, tx);
      fma_step(acc, am, bn);
    }
  }
}

// acc += the chunk's KC k of A (k-major layout, As: k rows of the tile's
// 128 rows on a stride of LDM floats) times B (Bs, f32 or bf16), in k
// order; the thread's rows are RowsK3(ty)'s.
template <int KC, int LDM, typename T = float>
__device__ __forceinline__ void chunk_kmajor(float (&acc)[8][8],
                                             const float* As, const T* Bs,
                                             int ty, int tx) {
#pragma unroll 16
  for (int kk = 0; kk < KC; ++kk) {
    float am[8], bn[8];
    *reinterpret_cast<float4*>(&am[0]) =
        *reinterpret_cast<const float4*>(As + kk * LDM + ty * 4);
    *reinterpret_cast<float4*>(&am[4]) =
        *reinterpret_cast<const float4*>(As + kk * LDM + 64 + ty * 4);
    load_b(bn, Bs, kk, tx);
    fma_step(acc, am, bn);
  }
}

// Write the tile's outputs at (m0.., n0..) of C (row pitch `pitch`), cast
// to O; rows past tm and columns past tn are not written.
template <typename O, typename Rows>
__device__ __forceinline__ void drain(const float (&acc)[8][8], O* c,
                                      int64_t pitch, int64_t m0, int64_t n0,
                                      int64_t tm, int64_t tn,
                                      const Rows& rows, int tx) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t r = m0 + rows(i);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int64_t n = n0 + col(tx, j);
      if (r < tm && n < tn) c[r * pitch + n] = ssr_cast<O>(acc[i][j]);
    }
  }
}

}  // namespace sgemm
