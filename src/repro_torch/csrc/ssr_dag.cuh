// The arithmetic of the DAG kernels, shared by each sync kernel (K6
// dag_layernorm, K7 dag_softmax_xent, K8 dag_mlp) and its ring kernel (R7
// ring_dag_layernorm, R8 ring_dag_softmax_xent, R9 ring_dag_mlp): the two
// differ only in where a block comes from (device memory, or a slot of the
// shared-memory ring), so they compute the same bits.
//
// Each family runs a subset of its three stages (`MASK`, one bit a stage);
// a value whose producer is in the subset stays on chip, any other is read
// from its stream.  The reads of a subset, in the order the ring kernels
// number their streams, are given by LnReads, SxReads and MlpReads.
#pragma once

#include "ssr_rows.cuh"

// -- K6 / R7: layernorm's diamond x -> {C = x - mean, V = C^2} ->
// C * rsqrt(mean V + eps), per 128-wide row ---------------------------------

constexpr float kLnEps = 1e-5f;
constexpr int kLnCentre = 1, kLnSquare = 2, kLnNormalise = 4;

// The values a layernorm subset reads: x or C (stream 0), and V (stream 1).
template <int MASK>
struct LnReads {
  static constexpr bool x = (MASK & kLnCentre) != 0;
  static constexpr bool v = (MASK & kLnNormalise) != 0 && (MASK & kLnSquare) == 0;
  static constexpr int streams = 1 + (v ? 1 : 0);
};

// One row of the subset, by one warp: xr, cr, vr point at the row of the
// values read (the others are ignored), po at the output row.
template <int MASK, int V>
__device__ __forceinline__ void ln_row(const float* xr, const float* cr,
                                       const float* vr, float* po,
                                       int lane) {
  SsrRow<V> c, v;
  if constexpr ((MASK & kLnCentre) != 0) {
    SsrRow<V> xv;
    xv.load(xr, lane);
    const float mean = xv.sum() / static_cast<float>(kRowLanes);
#pragma unroll
    for (int j = 0; j < 4; ++j) c.v[j] = xv.v[j] - mean;
  } else {
    c.load(cr, lane);
  }
  if constexpr ((MASK & kLnSquare) != 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) v.v[j] = __fmul_rn(c.v[j], c.v[j]);
  } else if constexpr ((MASK & kLnNormalise) != 0) {
    v.load(vr, lane);
  }
  if constexpr ((MASK & kLnNormalise) != 0) {
    const float inv = rsqrtf(v.sum() / static_cast<float>(kRowLanes) + kLnEps);
    SsrRow<V> y;
#pragma unroll
    for (int j = 0; j < 4; ++j) y.v[j] = __fmul_rn(c.v[j], inv);
    y.store(po, lane);
  } else if constexpr ((MASK & kLnSquare) != 0) {
    v.store(po, lane);
  } else {
    c.store(po, lane);
  }
}

// -- K7 / R8: softmax cross-entropy's diamond z -> {C = z - max, E = exp C}
// -> sum over rows of mask * (logsumexp - p . C) ----------------------------

constexpr int kSxShift = 1, kSxExp = 2, kSxLoss = 4;

// The values a softmax_xent subset reads: z or C (stream 0), then E and P
// where read, in that order.
template <int MASK>
struct SxReads {
  static constexpr bool z = (MASK & kSxShift) != 0;
  static constexpr bool e = (MASK & kSxLoss) != 0 && (MASK & kSxExp) == 0;
  static constexpr bool p = (MASK & kSxLoss) != 0;
  static constexpr int ie = 1, ip = e ? 2 : 1;
  static constexpr int streams = 1 + (e ? 1 : 0) + (p ? 1 : 0);
};

// One row of the subset, by one warp.  Without the loss stage it writes the
// last stage's value to `po`; with it, lane 0 adds the row's
// mask * (lse - p . C) to `acc` (the 128 copies of that / 128 the
// reference sums are the same number).  expf and logf, no fast math; the
// loss keeps the reference's max(sum E, 1e-30) clamp (a zero padding row
// of the unfused path reaches it with E = 0, and mask = sum p = 0 then
// zeroes it).
template <int MASK, int V>
__device__ __forceinline__ void sx_row(const float* zr, const float* cr,
                                       const float* er, const float* pr,
                                       float* po, int lane, float& acc) {
  SsrRow<V> c, e;
  if constexpr ((MASK & kSxShift) != 0) {
    SsrRow<V> zv;
    zv.load(zr, lane);
    const float m = zv.max();
#pragma unroll
    for (int j = 0; j < 4; ++j) c.v[j] = zv.v[j] - m;
  } else {
    c.load(cr, lane);
  }
  if constexpr ((MASK & kSxExp) != 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) e.v[j] = expf(c.v[j]);
  } else if constexpr ((MASK & kSxLoss) != 0) {
    e.load(er, lane);
  }
  if constexpr ((MASK & kSxLoss) != 0) {
    SsrRow<V> pv, pc;
    pv.load(pr, lane);
#pragma unroll
    for (int j = 0; j < 4; ++j) pc.v[j] = __fmul_rn(pv.v[j], c.v[j]);
    const float mask = pv.sum();
    const float lse = logf(fmaxf(e.sum(), 1e-30f));
    const float dot = pc.sum();
    if (lane == 0) acc += mask * (lse - dot);
  } else if constexpr ((MASK & kSxExp) != 0) {
    e.store(po, lane);
  } else {
    c.store(po, lane);
  }
}

// -- K8 / R9: the MLP block's diamond x -> H = relu(x W1 + b1) ->
// {Y = H W2 + b2, Y + H} on tiles of 128 rows ------------------------------

constexpr int kMlpThreads = 256;
constexpr int kMlpN = 128;              // row width, and both weights' sides
constexpr int kMlpTile = 128;           // rows of a CTA tile
constexpr int kMlpPitch = kMlpN + 4;    // shared-memory row pitch of the tile
constexpr int kMlpHidden = 1, kMlpOut = 2, kMlpResidual = 4;
// W1, W2 and the tile (the residual alone stages none of them)
constexpr int64_t kMlpStagedBytes =
    static_cast<int64_t>(sizeof(float)) * (2 * kMlpN * kMlpN + kMlpTile * kMlpPitch);

// The values an MLP subset reads: x or H (stream 0), and Y (stream 1).
template <int MASK>
struct MlpReads {
  static constexpr bool x = (MASK & kMlpHidden) != 0;
  static constexpr bool y = (MASK & kMlpResidual) != 0 && (MASK & kMlpOut) == 0;
  static constexpr int streams = 1 + (y ? 1 : 0);
};

template <int V>
__device__ __forceinline__ float4 mlp_load4(const float* p) {
  if constexpr (V == 4) return *reinterpret_cast<const float4*>(p);
  return make_float4(p[0], p[1], p[2], p[3]);
}

template <int V>
__device__ __forceinline__ void mlp_store4(float* p, float4 v) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = v;
  } else {
    p[0] = v.x; p[1] = v.y; p[2] = v.z; p[3] = v.w;
  }
}

// acc[i][j] = sum_k T[ty + 16 i][k] * W[k][col j], col j = c0 + j (j < 4)
// or c1 + j - 4.  Sequential in k, one FMA per term.
__device__ __forceinline__ void mlp_tile_product(const float* T, const float* W,
                                                 int ty, int c0, int c1,
                                                 float acc[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 1
  for (int k = 0; k < kMlpN; k += 4) {
    float a[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 v =
          *reinterpret_cast<const float4*>(T + (ty + 16 * i) * kMlpPitch + k);
      a[i][0] = v.x; a[i][1] = v.y; a[i][2] = v.z; a[i][3] = v.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 w0 = *reinterpret_cast<const float4*>(W + (k + kk) * kMlpN + c0);
      const float4 w1 = *reinterpret_cast<const float4*>(W + (k + kk) * kMlpN + c1);
      const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i][kk], w[j], acc[i][j]);
    }
  }
}

template <int V>
__device__ __forceinline__ void mlp_stage_weight(float* dst, const float* src) {
  for (int i = threadIdx.x; i < kMlpN * kMlpN / 4; i += kMlpThreads)
    reinterpret_cast<float4*>(dst)[i] = mlp_load4<V>(src + 4 * i);
}

// The eight biases of this thread's columns c0..c0+3, c1..c1+3.
template <int V>
__device__ __forceinline__ void mlp_bias(const float* b, int c0, int c1,
                                         float bv[8]) {
  const float4 p0 = mlp_load4<V>(b + c0), p1 = mlp_load4<V>(b + c1);
  const float t[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
  for (int j = 0; j < 8; ++j) bv[j] = t[j];
}

// The subset's products on the tile T (the 128 rows of x or H, pitch
// kMlpPitch) with W1s and W2s staged: each thread's 8 x 8 outputs (rows
// ty + 16 i, columns c0.. and c1..) in `acc`.  `bv` are the biases of the
// last product, b1v those of the hidden stage when the out stage follows.
// H = relu(acc + b1) (selected, as K2 does) replaces x in the tile when
// the out stage follows, so the second product and the residual read it
// there.  Every thread of the CTA calls it.
template <int MASK>
__device__ __forceinline__ void mlp_tile(float* T, const float* W1s,
                                         const float* W2s, int ty, int c0,
                                         int c1, const float bv[8],
                                         const float b1v[8], float acc[8][8]) {
  constexpr bool kH = (MASK & kMlpHidden) != 0, kY = (MASK & kMlpOut) != 0,
                 kR = (MASK & kMlpResidual) != 0;
  if constexpr (kH) {
    mlp_tile_product(T, W1s, ty, c0, c1, acc);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc[i][j] = ssr_relu(acc[i][j] + (kY ? b1v[j] : bv[j]));
    if constexpr (kY) {
      __syncthreads();  // every thread has read x from the tile
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float* row = T + (ty + 16 * i) * kMlpPitch;
        *reinterpret_cast<float4*>(row + c0) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        *reinterpret_cast<float4*>(row + c1) =
            make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
      }
      __syncthreads();  // H is the tile now
    }
  }
  if constexpr (kY) {
    mlp_tile_product(T, W2s, ty, c0, c1, acc);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float* hrow = T + (ty + 16 * i) * kMlpPitch;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[i][j] += bv[j];
        if constexpr (kR) acc[i][j] += hrow[j < 4 ? c0 + j : c1 + j - 4];
      }
    }
  }
}

// Write this thread's outputs of row `ty + 16 i` to `po` (the row's start).
template <int V>
__device__ __forceinline__ void mlp_store_row(float* po, int c0, int c1,
                                              const float acc[8]) {
  mlp_store4<V>(po + c0, make_float4(acc[0], acc[1], acc[2], acc[3]));
  mlp_store4<V>(po + c1, make_float4(acc[4], acc[5], acc[6], acc[7]));
}
