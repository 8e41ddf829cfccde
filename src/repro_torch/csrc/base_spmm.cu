// B7 base_spmm: spmm's monolithic baseline.  out (m, c) = sum_j vals[i, j] *
// X[clip(cidx[i, j]), :] over the unpadded ELL planes vals (f32) and cidx
// (int32), both (m, k), and X (n, c) unpadded -- the layouts the reference's
// baseline MonolithicKernel prepares.
//
// Replaces the TPU kernel repro/kernels/frontend.py:MonolithicKernel._build
// with the body repro/kernels/sparse.py:_base_body_spmm: one grid step whose
// body gathers X's rows with an explicit clipped take by the index block and
// contracts them with vals.
//
// Bound on H100: bytes, as K13 (gather_spmm.cu): the ELL planes, X and the
// output once each.  What holds it is not HBM but the gathers: each entry
// gathers a whole X segment (512 bytes at c = 128), about 11x the bytes the
// bound counts, through L1 and L2, behind a chain of two dependent loads.
//
// The baseline's rule, which K13's stream walk breaks and B7 keeps: an
// explicit load before every use.  Within each row, in element order: the
// index is loaded, the address computed from it (clipped into X, as take's
// mode="clip"), the X segment and the value loaded, and both used by the
// FMAs -- all before that row's next index is loaded.  The element loop is
// rolled (#pragma unroll 1); no index, value or row of a later element is
// loaded ahead: no read-ahead batch, no ring, no bulk copy, no prefetch.
// Every column of the planes is read, pads included.
//
// Design, from the parent's split (tools/base_spmm_stencil_ablation.py):
//  * more gathers in flight: a warp carries kRows consecutive rows at once,
//    each row's chain in the order above, so a warp has kRows segments in
//    flight instead of one.  Lane r loads row r's index and value (one load
//    a warp for the kRows rows) and shuffles hand them to every lane;
//  * 16-byte loads: where the wrapper found c % 4 == 0 and X's base on a
//    16-byte boundary (vec = 4), each lane gathers its four columns of a
//    segment with one load (a 512-byte segment is one request a warp),
//    else four 4-byte loads (lane, lane + 32, ...: any c, any view);
//  * rows in bands: a CTA takes kBand consecutive rows, so the rows that
//    share X rows (i and i + 1 share most of their columns in a stencil
//    operator) gather at about the same time on one SM and meet in its L1;
//    the CTAs run in row order, so the card's window of rows stays narrow
//    and X's rows stay in L2 between the rows that reuse them.
//
// The bits are the parent's: each output is the fmaf chain
// acc = fmaf(v_j, X[clip(c_j), col], acc) over j = 0 .. k - 1 from 0.f
// (core/hopper.py base_spmm_model), the columns independent.
#include "ssr_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;                 // rows a warp carries at once
constexpr int kBand = kWarps * kRows;    // consecutive rows a CTA
constexpr int kCols = 128;               // columns a CTA (grid y), as K13
// CTAs an SM B7 is built for (at most 64 registers a thread)
constexpr int kMinCtas = 8;
constexpr unsigned kAll = 0xffffffffu;

// A lane's four columns of one X segment (col: its first; V = 4: col ..
// col + 3 in one 16-byte load, c a multiple of 4; V = 1: col, col + 32,
// col + 64, col + 96); 0 past c.
template <int V>
__device__ __forceinline__ float4 segment(const float* __restrict__ px,
                                          int64_t col, int64_t c) {
  float4 g = make_float4(0.f, 0.f, 0.f, 0.f);
  if (V == 4) {
    if (col < c) g = *reinterpret_cast<const float4*>(px + col);
  } else {
    if (col < c) g.x = px[col];
    if (col + 32 < c) g.y = px[col + 32];
    if (col + 64 < c) g.z = px[col + 64];
    if (col + 96 < c) g.w = px[col + 96];
  }
  return g;
}

template <int V>
__device__ __forceinline__ void store_cols(float* __restrict__ po,
                                           int64_t col, int64_t c,
                                           const float (&acc)[4]) {
  if (V == 4) {
    if (col < c)
      *reinterpret_cast<float4*>(po + col) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (col + 32 * q < c) po[col + 32 * q] = acc[q];
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads, kMinCtas)
    base_spmm_kernel(const float* __restrict__ vals,
                     const int32_t* __restrict__ cidx,
                     const float* __restrict__ x, float* __restrict__ out,
                     int64_t m, int64_t k, int64_t n, int64_t c) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kBand +
                       warp * kRows;
  if (row0 >= m) return;                               // the whole warp
  const int64_t col = static_cast<int64_t>(blockIdx.y) * kCols +
                      (V == 4 ? 4 * lane : lane);
  // lane r < kRows reads row row0 + r's planes (the last row past m; its
  // sums are never stored), the other lanes row row0's
  const int64_t mine = row0 + (lane < kRows ? lane : 0);
  const int64_t at = (mine < m ? mine : m - 1) * k;
  float acc[kRows][4];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
#pragma unroll 1
  for (int64_t j = 0; j < k; ++j) {
    const int32_t idx = cidx[at + j];                  // the indices
    int64_t xrow[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {                  // the addresses
      const int64_t i = __shfl_sync(kAll, idx, r);
      xrow[r] = (i < 0 ? 0 : (i >= n ? n - 1 : i)) * c;
    }
    const float val = vals[at + j];                    // the values
    float v[kRows];
    float4 g[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {                  // the segments
      v[r] = __shfl_sync(kAll, val, r);
      g[r] = segment<V>(x + xrow[r], col, c);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {                  // used
      acc[r][0] = fmaf(v[r], g[r].x, acc[r][0]);
      acc[r][1] = fmaf(v[r], g[r].y, acc[r][1]);
      acc[r][2] = fmaf(v[r], g[r].z, acc[r][2]);
      acc[r][3] = fmaf(v[r], g[r].w, acc[r][3]);
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    if (row0 + r < m) store_cols<V>(out + (row0 + r) * c, col, c, acc[r]);
}

}  // namespace

// vals and cidx (m, k), X (n, c) and out (m, c), all contiguous; `vec` is
// 4 where c % 4 == 0 and X's base pointer is on a 16-byte boundary (one
// 16-byte load a lane a segment), else 1.
extern "C" int ssr_base_spmm(const void* vals, const void* cidx, const void* x,
                             void* out, int64_t m, int64_t k, int64_t n,
                             int64_t c, int vec, void* stream) {
  const int64_t ctas = (m + kBand - 1) / kBand;
  const int64_t chunks = (c + kCols - 1) / kCols;
  if (m < 1 || k < 1 || n < 1 || c < 1 || ctas > 0x7fffffffLL ||
      chunks > 65535 || (vec == 4 && c % 4) || (vec != 4 && vec != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(ctas), static_cast<unsigned>(chunks));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(vals);
  const int32_t* ci = static_cast<const int32_t*>(cidx);
  const float* px = static_cast<const float*>(x);
  float* po = static_cast<float*>(out);
  if (vec == 4)
    base_spmm_kernel<4><<<grid, kThreads, 0, st>>>(v, ci, px, po, m, k, n, c);
  else
    base_spmm_kernel<1><<<grid, kThreads, 0, st>>>(v, ci, px, po, m, k, n, c);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int64_t ssr_base_spmm_smem_bytes() { return 0; }

// Registers a thread and local (spill) bytes, the most over both builds,
// as cudaFuncGetAttributes reads them, and the CTAs an SM of the main
// path's (16-byte loads; occupancy API): out[0] numRegs, out[1]
// localSizeBytes, out[2] CTAs an SM.
extern "C" int ssr_base_spmm_attributes(int64_t* out) {
  const void* const kernels[] = {
      reinterpret_cast<const void*>(base_spmm_kernel<4>),
      reinterpret_cast<const void*>(base_spmm_kernel<1>)};
  out[0] = out[1] = out[2] = 0;
  for (const void* kn : kernels) {
    cudaFuncAttributes fa;
    cudaError_t err = cudaFuncGetAttributes(&fa, kn);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (fa.numRegs > out[0]) out[0] = fa.numRegs;
    if (static_cast<int64_t>(fa.localSizeBytes) > out[1])
      out[1] = static_cast<int64_t>(fa.localSizeBytes);
  }
  int ctas = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &ctas, base_spmm_kernel<4>, kThreads, 0);
  out[2] = ctas;
  return static_cast<int>(err);
}
