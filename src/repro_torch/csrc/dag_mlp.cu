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
// Below that, the products' shared-memory reads: a thread's 4 x 8 outputs
// take 12 floats a k for 32 FMAs, and an SM delivers 32 floats a clock
// from shared memory against 128 FMAs, so 2/3 of the FP32 rate at most
// (0.60-0.63 a product measured by tools/dag_mlp_ablation.py on an H100).
// 8 x 8 outputs a thread would balance the two but need 128-row tiles,
// which do not fit twice beside W1 and W2.
//
// Design: FP32 FMA, never TF32 (the reference asks for f32 results of f32
// inputs).  Each CTA stages W1 and W2 in shared memory once (2 x 64 KiB,
// dynamic shared memory above 48 KB; hopper._smem_refusal checks it against
// the card) and then walks row tiles of 64 rows, persistent over the card's
// SMs, on two tile buffers: while it multiplies one tile, the next tile's
// rows land in the other buffer by cp.async (16 bytes, or 4 off 16-byte
// packs), so the tile's HBM read hides behind the FMAs and one CTA barrier
// a tile both shows the landed tile and frees the buffer the last tile
// used.  A row's address comes from the streams' AGU walk (its grid step's
// block, then the row in it): each warp finds its rows' addresses at once,
// one lane each, and shares them by shuffles; the stores likewise.  The
// products are ssr_dag.cuh::mlp_tile: each of the kMlpThreads threads
// computes a kMlpRows x 8 piece of the 64 x 128 product, reading the tile
// in 16-byte k-chunks and W rows in 16-byte packs, the next chunk's
// operands ahead of the FMAs, on a 132-float row pitch so that a warp's
// reads hit distinct banks.  H = relu(acc + b1) (relu selected, as K2
// does) replaces x in the tile, so the second product and the residual
// read it from shared memory: it never reaches device memory.  One template
// per stage subset (`MASK`: 1 hidden, 2 out, 4 residual; instantiated for
// {0,1,2}, {0}, {1}, {2} and {1,2}); a value whose producer is not in the
// subset comes from its stream.  The residual alone ({2}) is an
// elementwise add, bound by bytes: a warp takes 32 rows at a time, their
// addresses found one a lane, on MLP_RESIDUAL_PER_SM CTAs an SM.  The
// tile's arithmetic is R9's too.
#include "ssr_dag.cuh"

namespace {

constexpr int kThreads = kMlpThreads, kWarps = kThreads / 32;
constexpr int kN = kMlpN, kTile = kMlpTile, kPitch = kMlpPitch;

__device__ __forceinline__ int64_t row_origin(const SsrStream& s,
                                              const SsrGrid& g, int64_t row,
                                              int64_t rows_per_step) {
  return ssr_block_origin(s, g, row / rows_per_step) +
         (row % rows_per_step) * s.pitch;
}

// Issue this thread's copies of rows r0 .. r0 + 63 of the stream `s` into
// the tile T (none past rows_total: those rows' outputs are never stored):
// warp w of the kWarps copies rows w + kWarps j, lane j < kTile / kWarps
// finding row w + kWarps j's address for the warp.
template <int V>
__device__ __forceinline__ void fetch_tile(float* T, const float* base,
                                           const SsrStream& s,
                                           const SsrGrid& g, int64_t r0,
                                           int64_t rows_total,
                                           int64_t rows_per_step, int warp,
                                           int lane) {
  constexpr int kPerWarp = kTile / kWarps;
  const int64_t row = r0 + warp + kWarps * (lane % kPerWarp);
  const int64_t at =
      row < rows_total ? row_origin(s, g, row, rows_per_step) : -1;
#pragma unroll
  for (int j = 0; j < kPerWarp; ++j) {
    const int64_t o = __shfl_sync(0xffffffffu, at, j);
    if (o < 0) continue;
    float* d = T + (warp + kWarps * j) * kPitch;
    const float* p = base + o;
    if constexpr (V == 4) {
      ssr_cp_async16(d + 4 * lane, p + 4 * lane);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        ssr_cp_async4(d + lane + 32 * c, p + lane + 32 * c);
    }
  }
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
  float* const W1s = smem;
  float* const W2s = smem + kN * kN;
  float* const tiles = smem + 2 * kN * kN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int rt, ct;
  mlp_place(tid, rt, ct);
  const int c0 = 4 * ct, c1 = 64 + 4 * ct;
  const int64_t tiles_total = (rows_total + kTile - 1) / kTile;
  auto fetch = [&](float* T, int64_t t) {
    if constexpr (kH)
      fetch_tile<V>(T, x, sx, g, t * kTile, rows_total, rows_per_step, warp,
                    lane);
    else
      fetch_tile<V>(T, h_in, sh, g, t * kTile, rows_total, rows_per_step,
                    warp, lane);
  };
  int64_t t = blockIdx.x;
  if (t < tiles_total) fetch(tiles, t);
  ssr_cp_async_commit();
  if constexpr (kH) mlp_stage_weight<V>(W1s, w1);
  if constexpr (kY) mlp_stage_weight<V>(W2s, w2);
  float bv[8], b1v[8];
  mlp_bias<V>(kY ? b2 : b1, c0, c1, bv);
  if constexpr (kH && kY) mlp_bias<V>(b1, c0, c1, b1v);
  auto no_hook = [](int) {};
  float acc[kMlpRows][8];
  for (int b = 0; t < tiles_total; t += gridDim.x, b ^= 1) {
    ssr_cp_async_wait<0>();
    __syncthreads();  // the tile has landed, the weights are staged, and
                      // every thread is done with the other buffer
    if (t + gridDim.x < tiles_total)
      fetch(tiles + (b ^ 1) * kMlpTileFloats, t + gridDim.x);
    ssr_cp_async_commit();
    mlp_tile<MASK>(tiles + b * kMlpTileFloats, W1s, W2s, rt, ct, bv, b1v,
                   acc, no_hook);
    // a lane finds one of its warp's output rows' addresses
    // (mlp_store_row_of), the warp shares them
    const int64_t srow = t * kTile + mlp_store_row_of(warp, lane);
    const int64_t sat =
        srow < rows_total ? row_origin(so, g, srow, rows_per_step) : -1;
#pragma unroll
    for (int i = 0; i < kMlpRows; ++i) {
      const int64_t o = __shfl_sync(0xffffffffu, sat, (lane >> 3) + 4 * i);
      if (o >= 0) mlp_store_row<V>(out + o, c0, c1, acc[i]);
    }
  }
}

// The residual alone: out = y + h, four elements a lane.  A warp takes 32
// consecutive rows at a time: lane j finds row j's three addresses by the
// streams' block walks, and the warp shares them, a row after another.
template <int V>
__global__ void __launch_bounds__(kThreads)
    dag_mlp_residual(const float* __restrict__ h, const float* __restrict__ y,
                     float* __restrict__ out, SsrGrid g, SsrStream sh,
                     SsrStream sy, SsrStream so, int64_t rows_total,
                     int64_t rows_per_step) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t r0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * 32;
       r0 < rows_total; r0 += 32 * warps) {
    const int64_t row = r0 + lane;
    int64_t ah = -1, ay = 0, ao = 0;
    if (row < rows_total) {
      ah = row_origin(sh, g, row, rows_per_step);
      ay = row_origin(sy, g, row, rows_per_step);
      ao = row_origin(so, g, row, rows_per_step);
    }
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      const int64_t oh = __shfl_sync(0xffffffffu, ah, j);
      const int64_t oy = __shfl_sync(0xffffffffu, ay, j);
      const int64_t oo = __shfl_sync(0xffffffffu, ao, j);
      if (oh < 0) break;
      const float4 hv = mlp_load4<V>(h + oh + 4 * lane);
      const float4 yv = mlp_load4<V>(y + oy + 4 * lane);
      mlp_store4<V>(out + oo + 4 * lane, make_float4(yv.x + hv.x, yv.y + hv.y,
                                                     yv.z + hv.z, yv.w + hv.w));
    }
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

// x, h, y are the streams of the values read from device memory (ignored
// where a value stays on chip or is not read); w1, b1, w2, b2 the uniforms
// ((128, 128), (1, 128) each, row-major); `out` receives the last stage's
// value through the dense output stream.  `mask`: the stages run (1 hidden,
// 2 out, 4 residual).  `rows_per_step` is the block's row count; `num_ctas`
// CTAs walk the (steps x rows_per_step) rows.  `vec` is 4 when every used
// stream, the uniforms and the output allow 16-byte accesses.
extern "C" int ssr_dag_mlp(const void* x, const void* h, const void* y,
                           const void* w1, const void* b1, const void* w2,
                           const void* b2, void* out, int mask, int vec,
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

// Registers a thread and local bytes (the most over the ten
// instantiations), and the fused f32 kernel's CTAs an SM at its shared
// memory: out[0], out[1], out[2].
extern "C" int ssr_dag_mlp_attributes(int64_t* out) {
  const void* const kernels[] = {
      reinterpret_cast<const void*>(dag_mlp_kernel<7, 4>),
      reinterpret_cast<const void*>(dag_mlp_kernel<7, 1>),
      reinterpret_cast<const void*>(dag_mlp_kernel<1, 4>),
      reinterpret_cast<const void*>(dag_mlp_kernel<1, 1>),
      reinterpret_cast<const void*>(dag_mlp_kernel<2, 4>),
      reinterpret_cast<const void*>(dag_mlp_kernel<2, 1>),
      reinterpret_cast<const void*>(dag_mlp_kernel<6, 4>),
      reinterpret_cast<const void*>(dag_mlp_kernel<6, 1>),
      reinterpret_cast<const void*>(dag_mlp_residual<4>),
      reinterpret_cast<const void*>(dag_mlp_residual<1>)};
  out[0] = out[1] = out[2] = 0;
  for (const void* k : kernels) {
    cudaFuncAttributes fa;
    cudaError_t err = cudaFuncGetAttributes(&fa, k);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (fa.numRegs > out[0]) out[0] = fa.numRegs;
    if (static_cast<int64_t>(fa.localSizeBytes) > out[1])
      out[1] = static_cast<int64_t>(fa.localSizeBytes);
  }
  cudaError_t err = cudaFuncSetAttribute(
      dag_mlp_kernel<7, 4>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kMlpStagedBytes));
  int ctas = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &ctas, dag_mlp_kernel<7, 4>, kThreads, kMlpStagedBytes);
  out[2] = ctas;
  return static_cast<int>(err);
}
