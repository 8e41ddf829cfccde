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
// The residual alone ({2}) is an elementwise add, one warp per row.  The
// tile's arithmetic (ssr_dag.cuh::mlp_tile) is R9's too.
#include "ssr_dag.cuh"

namespace {

constexpr int kThreads = kMlpThreads;
constexpr int kN = kMlpN, kTile = kMlpTile, kPitch = kMlpPitch;

__device__ __forceinline__ int64_t row_origin(const SsrStream& s,
                                              const SsrGrid& g, int64_t row,
                                              int64_t rows_per_step) {
  return ssr_block_origin(s, g, row / rows_per_step) +
         (row % rows_per_step) * s.pitch;
}

template <int MASK, int V>
__global__ void __launch_bounds__(kThreads, 1)
    dag_mlp_kernel(const float* __restrict__ x, const float* __restrict__ h_in,
                   const float* __restrict__ w1, const float* __restrict__ b1,
                   const float* __restrict__ w2, const float* __restrict__ b2,
                   float* __restrict__ out, SsrGrid g, SsrStream sx,
                   SsrStream sh, SsrStream so, int64_t rows_total,
                   int64_t rows_per_step) {
  constexpr bool kH = (MASK & kMlpHidden) != 0, kY = (MASK & kMlpOut) != 0;
  extern __shared__ __align__(16) float smem[];
  float* W1s = smem;
  float* W2s = smem + kN * kN;
  float* T = smem + 2 * kN * kN;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int c0 = 4 * tx, c1 = 64 + 4 * tx;
  if constexpr (kH) mlp_stage_weight<V>(W1s, w1);
  if constexpr (kY) mlp_stage_weight<V>(W2s, w2);
  float bv[8], b1v[8];
  mlp_bias<V>(kY ? b2 : b1, c0, c1, bv);
  if constexpr (kH && kY) mlp_bias<V>(b1, c0, c1, b1v);
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
        v = mlp_load4<V>(src + row_origin(ss, g, r0 + r, rows_per_step) + 4 * q);
      *reinterpret_cast<float4*>(T + r * kPitch + 4 * q) = v;
    }
    __syncthreads();
    mlp_tile<MASK>(T, W1s, W2s, ty, c0, c1, bv, b1v, acc);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int64_t row = r0 + ty + 16 * i;
      if (row >= rows_total) continue;
      mlp_store_row<V>(out + row_origin(so, g, row, rows_per_step), c0, c1,
                       acc[i]);
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
    const float4 hv = mlp_load4<V>(h + row_origin(sh, g, row, rows_per_step) + 4 * lane);
    const float4 yv = mlp_load4<V>(y + row_origin(sy, g, row, rows_per_step) + 4 * lane);
    mlp_store4<V>(out + row_origin(so, g, row, rows_per_step) + 4 * lane,
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
  if constexpr (MASK == kMlpResidual) {
    dag_mlp_residual<V><<<n, kThreads, 0, a.st>>>(
        a.h, a.y, a.out, a.g, a.sh, a.sy, a.so, a.rows_total, a.rows_per_step);
  } else {
    cudaError_t err = cudaFuncSetAttribute(
        dag_mlp_kernel<MASK, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kMlpStagedBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    dag_mlp_kernel<MASK, V><<<n, kThreads, kMlpStagedBytes, a.st>>>(
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
  return kMlpStagedBytes;
}
