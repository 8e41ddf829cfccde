// K8 dag_mlp: the MLP block's diamond x -> H = relu(x W1 + b1) ->
// {Y = H W2 + b2, Y + H}, per 128-wide row, any subset of its three stages.
//
// Replaces the TPU kernel repro/core/lowering.py:_build_dag_kernel (slots
// from _dag_slots, through _assemble_kernel and repro/core/ssr.py:
// ssr_pallas) with the bodies of repro/kernels/dag.py:215-231 (_mlp_hidden,
// _mlp_out, _mlp_residual).  There W1, b1, W2 and b2 are uniforms: whole
// arrays delivered as one loop-invariant block each, appended to every stage
// body's arguments; each (rows, 128) block of x goes through two MXU
// products with f32 results, H staying in a VMEM slot for both consumers.
//
// Bound on H100: operations.  Two 128 x 128 products per row are 65,536
// FP32 operations against 1 KiB moved: far above the card's FP32 ridge.
//
// Design: FP32 FMA, never TF32 (the reference asks for f32 results of f32
// inputs).  Each CTA stages W1 and W2 in shared memory once (2 x 64 KiB,
// dynamic shared memory above 48 KB; hopper._smem_refusal checks it against
// the card) and then walks row tiles of 128 rows, persistent over the card's
// SMs.  A tile is loaded into shared memory through the streams' AGU walk
// (each row's address from its grid step); each of the 256 threads computes
// an 8 x 8 piece of the 128 x 128 product (rows ty + 16 i, columns 4 tx..
// and 64 + 4 tx..), reading x in 16-byte k-chunks and W rows in 16-byte
// packs, with a row pitch of 132 floats so that a warp's reads hit distinct
// banks.  H = relu(acc + b1) (relu selected, as K2 does) replaces x in the
// tile, so the second product and the residual read it from shared memory:
// it never reaches device memory.  One template per stage subset (`MASK`:
// 1 hidden, 2 out, 4 residual; instantiated for {0,1,2}, {0}, {1}, {2} and
// {1,2}); a value whose producer is not in the subset comes from its stream.
// The residual alone ({2}) is an elementwise add, one warp per row.
#include "ssr_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kN = 128;              // row width, and both weights' sides
constexpr int kTile = 128;           // rows per CTA tile
constexpr int kPitch = kN + 4;       // shared-memory row pitch of the tile
constexpr int kHidden = 1, kOut = 2, kResidual = 4;
constexpr size_t kSmemBytes = sizeof(float) * (2 * kN * kN + kTile * kPitch);

__device__ __forceinline__ int64_t row_origin(const SsrStream& s,
                                              const SsrGrid& g, int64_t row,
                                              int64_t rows_per_step) {
  return ssr_block_origin(s, g, row / rows_per_step) +
         (row % rows_per_step) * s.pitch;
}

template <int V>
__device__ __forceinline__ float4 load4(const float* p) {
  if constexpr (V == 4) return *reinterpret_cast<const float4*>(p);
  return make_float4(p[0], p[1], p[2], p[3]);
}

template <int V>
__device__ __forceinline__ void store4(float* p, float4 v) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = v;
  } else {
    p[0] = v.x; p[1] = v.y; p[2] = v.z; p[3] = v.w;
  }
}

// acc[i][j] = sum_k T[ty + 16 i][k] * W[k][col j], col j = c0 + j (j < 4)
// or c1 + j - 4.  Sequential in k, one FMA per term.
__device__ __forceinline__ void tile_product(const float* T, const float* W,
                                             int ty, int c0, int c1,
                                             float acc[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 1
  for (int k = 0; k < kN; k += 4) {
    float a[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 v =
          *reinterpret_cast<const float4*>(T + (ty + 16 * i) * kPitch + k);
      a[i][0] = v.x; a[i][1] = v.y; a[i][2] = v.z; a[i][3] = v.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 w0 = *reinterpret_cast<const float4*>(W + (k + kk) * kN + c0);
      const float4 w1 = *reinterpret_cast<const float4*>(W + (k + kk) * kN + c1);
      const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i][kk], w[j], acc[i][j]);
    }
  }
}

template <int V>
__device__ __forceinline__ void stage_weight(float* dst, const float* src) {
  for (int i = threadIdx.x; i < kN * kN / 4; i += kThreads)
    reinterpret_cast<float4*>(dst)[i] = load4<V>(src + 4 * i);
}

template <int MASK, int V>
__global__ void __launch_bounds__(kThreads, 1)
    dag_mlp_kernel(const float* __restrict__ x, const float* __restrict__ h_in,
                   const float* __restrict__ w1, const float* __restrict__ b1,
                   const float* __restrict__ w2, const float* __restrict__ b2,
                   float* __restrict__ out, SsrGrid g, SsrStream sx,
                   SsrStream sh, SsrStream so, int64_t rows_total,
                   int64_t rows_per_step) {
  constexpr bool kH = (MASK & kHidden) != 0, kY = (MASK & kOut) != 0,
                 kR = (MASK & kResidual) != 0;
  extern __shared__ __align__(16) float smem[];
  float* W1s = smem;
  float* W2s = smem + kN * kN;
  float* T = smem + 2 * kN * kN;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int c0 = 4 * tx, c1 = 64 + 4 * tx;
  if constexpr (kH) stage_weight<V>(W1s, w1);
  if constexpr (kY) stage_weight<V>(W2s, w2);
  const float* bias = kY ? b2 : b1;
  float bv[8];
  {
    const float4 p0 = load4<V>(bias + c0), p1 = load4<V>(bias + c1);
    const float t[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) bv[j] = t[j];
  }
  float b1v[8];
  if constexpr (kH && kY) {
    const float4 p0 = load4<V>(b1 + c0), p1 = load4<V>(b1 + c1);
    const float t[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) b1v[j] = t[j];
  }
  const float* src = kH ? x : h_in;
  const SsrStream& ss = kH ? sx : sh;
  const int64_t tiles = (rows_total + kTile - 1) / kTile;
  float acc[8][8];
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t r0 = t * kTile;
    __syncthreads();  // the weights are staged; the last tile is read
    for (int i = tid; i < kTile * (kN / 4); i += kThreads) {
      const int r = i / (kN / 4), q = i % (kN / 4);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r0 + r < rows_total)
        v = load4<V>(src + row_origin(ss, g, r0 + r, rows_per_step) + 4 * q);
      *reinterpret_cast<float4*>(T + r * kPitch + 4 * q) = v;
    }
    __syncthreads();
    if constexpr (kH) {
      tile_product(T, W1s, ty, c0, c1, acc);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[i][j] = ssr_relu(acc[i][j] + (kY ? b1v[j] : bv[j]));
      if constexpr (kY) {
        __syncthreads();  // every thread has read x from the tile
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float* row = T + (ty + 16 * i) * kPitch;
          *reinterpret_cast<float4*>(row + c0) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
          *reinterpret_cast<float4*>(row + c1) =
              make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
        }
        __syncthreads();  // H is the tile now
      }
    }
    if constexpr (kY) {
      tile_product(T, W2s, ty, c0, c1, acc);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float* hrow = T + (ty + 16 * i) * kPitch;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[i][j] += bv[j];
          if constexpr (kR) acc[i][j] += hrow[j < 4 ? c0 + j : c1 + j - 4];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int64_t row = r0 + ty + 16 * i;
      if (row >= rows_total) continue;
      float* po = out + row_origin(so, g, row, rows_per_step);
      store4<V>(po + c0, make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
      store4<V>(po + c1, make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]));
    }
  }
}

// The residual alone: out = y + h, one warp per row, four elements a lane.
template <int V>
__global__ void __launch_bounds__(kThreads)
    dag_mlp_residual(const float* __restrict__ h, const float* __restrict__ y,
                     float* __restrict__ out, SsrGrid g, SsrStream sh,
                     SsrStream sy, SsrStream so, int64_t rows_total,
                     int64_t rows_per_step) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (kThreads / 32);
  for (int64_t row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
       row < rows_total; row += warps) {
    const float4 hv = load4<V>(h + row_origin(sh, g, row, rows_per_step) + 4 * lane);
    const float4 yv = load4<V>(y + row_origin(sy, g, row, rows_per_step) + 4 * lane);
    store4<V>(out + row_origin(so, g, row, rows_per_step) + 4 * lane,
              make_float4(yv.x + hv.x, yv.y + hv.y, yv.z + hv.z, yv.w + hv.w));
  }
}

struct Args {
  const float *x, *h, *y, *w1, *b1, *w2, *b2;
  float* out;
  SsrGrid g;
  SsrStream sx, sh, sy, so;
  int64_t rows_total, rows_per_step, ctas;
  cudaStream_t st;
};

template <int MASK, int V>
int run(const Args& a) {
  const unsigned n = static_cast<unsigned>(a.ctas);
  if constexpr (MASK == kResidual) {
    dag_mlp_residual<V><<<n, kThreads, 0, a.st>>>(
        a.h, a.y, a.out, a.g, a.sh, a.sy, a.so, a.rows_total, a.rows_per_step);
  } else {
    cudaError_t err = cudaFuncSetAttribute(
        dag_mlp_kernel<MASK, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    dag_mlp_kernel<MASK, V><<<n, kThreads, kSmemBytes, a.st>>>(
        a.x, a.h, a.w1, a.b1, a.w2, a.b2, a.out, a.g, a.sx, a.sh, a.so,
        a.rows_total, a.rows_per_step);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int MASK>
int launch(int vec, const Args& a) {
  if (vec == 4) return run<MASK, 4>(a);
  if (vec == 1) return run<MASK, 1>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// `mask`: the stages run (1 hidden, 2 out, 4 residual).  x, h, y are the
// streams of the values read from device memory (null where a value stays
// on chip or is not read); w1, b1, w2, b2 the uniforms ((128, 128), (1, 128)
// each, row-major); `out` receives the last stage's value through the dense
// output stream.  `rows_per_step` is the block's row count; `num_ctas` CTAs
// walk the (steps x rows_per_step) rows.  `vec` is 4 when every used stream,
// the uniforms and the output allow 16-byte accesses.
extern "C" int ssr_dag_mlp(int mask, const void* x, const void* h,
                           const void* y, const void* w1, const void* b1,
                           const void* w2, const void* b2, void* out, int vec,
                           const SsrGrid* g, const SsrStream* sx,
                           const SsrStream* sh, const SsrStream* sy,
                           const SsrStream* so, int64_t num_ctas,
                           void* stream) {
  Args a{static_cast<const float*>(x), static_cast<const float*>(h),
         static_cast<const float*>(y), static_cast<const float*>(w1),
         static_cast<const float*>(b1), static_cast<const float*>(w2),
         static_cast<const float*>(b2), static_cast<float*>(out), *g, *sx,
         *sh, *sy, *so, 1, so->block[0], num_ctas,
         static_cast<cudaStream_t>(stream)};
  for (int k = 0; k < g->ndim; ++k) a.rows_total *= g->dims[k];
  a.rows_total *= a.rows_per_step;
  switch (mask) {
    case 7: return launch<7>(vec, a);
    case 1: return launch<1>(vec, a);
    case 2: return launch<2>(vec, a);
    case 4: return launch<4>(vec, a);
    case 6: return launch<6>(vec, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int64_t ssr_dag_mlp_smem_bytes() {
  return static_cast<int64_t>(kSmemBytes);
}
