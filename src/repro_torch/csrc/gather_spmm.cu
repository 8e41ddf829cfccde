// K13 gather_spmm: Y_blk += sum_j vals[i, j] * X[clip(scale * cidx[i, j] +
// c + offset)] over the trailing contraction axes, in f32: the indirection
// stream with one affine level (the dense column c) added to the address.
//
// Replaces the TPU kernel repro/core/ssr.py:ssr_pallas (sync emitter) with
// the contraction branch of repro/core/lowering.py:_build_nest_kernel, the
// gather repro/core/lowering.py:_gather_block (whose affine level prepends
// the c tile to the gathered block) and its table stream (lowering.py:
// 1546-1558), and the body repro/kernels/sparse.py:_body_spmm.  For HPCG's
// 27-point operator on a 64^3 grid times 128 right-hand sides the default
// lowering gives grid (1024, 1, 1), vals/cidx blocks (256, 128), Y (256,
// 128), the table X as (n, 128) (pitch 128 = scale); on the card the
// wrapper hands this kernel pack_ell's (m, 27) planes as they are, at pitch
// 27 (no layout copy).
//
// Bound on H100: bytes.  The ELL planes at width k, X and Y once each (310
// MiB for HPCG 64^3: 0.097 ms at 3.35 TB/s).  The gathers move 27 X rows of
// 512 bytes per output row (3.4 GiB), which stay in the 50 MB L2 only as far
// as neighbouring rows share them.
//
// Design.  A warp per output row, eight rows a CTA; each lane holds four
// consecutive columns of a 128-wide chunk of the c tile (grid y walks the
// chunks) in registers.  The warp loads 32 entries of its row's vals and
// cidx at once (coalesced), then for each entry broadcasts cidx by a
// shuffle and gathers the 512-byte X row segment as one 16-byte load a
// lane (scale, offset and the chunk keep every segment 16-byte aligned; the
// wrapper checks the table's base).  kPer entries' gathers are issued
// before their FMAs, in straight-line code (gather::spmm_row, the FMAs in
// the order of the entries whatever kPer: R14's order, so R14 keeps K13's
// bits); each segment's start is clipped into the table first, so the load
// needs no branch, and only a group with a segment past the table's ends
// re-reads it element by element, clipped as the reference clips.  Only
// the positions of the index block that hold data -- the extent of cidx's
// layout -- are read, on planes of any pitch: the unpadded (m, k) planes
// the card's wrapper hands it, or the lowering's padded (m, 128) layouts.
// A spilled register cost more than anything else here (measured on an
// H100, tools/scan_spmm_ablation.py, PERF.md: spills of 56-288 bytes a
// thread made the parent 1.1-5x slower), so what a warp keeps beside its
// gathers is cut: the CTA's place and the walk's odometer are unflattened
// in 32-bit arithmetic (as K12), the drain's address is taken before the
// row, and a grid of one contraction step (k within one lane tile, as
// HPCG's) runs an instantiation without the loop over steps, so no walk
// stays live across the row's gathers.  The contraction steps otherwise run as a
// loop inside the CTA; Y is written once per row.  Table addresses are
// 64-bit.
#include "ssr_gather.cuh"

namespace {

using namespace gather;

// Entries a lane gathers before their FMAs, and the CTAs an SM the kernel
// is built for: four CTAs of 256 threads (64 registers a thread) and four
// entries in flight a lane, the fastest build with no spill on spmm_hpcg
// (tools/scan_spmm_ablation.py, PERF.md: eight entries spilled at 64 and
// 80 registers, and every build for five to eight CTAs an SM spilled); a
// grid of several contraction steps, whose loop keeps more live, two.
constexpr int kPer = 4;
constexpr int kLoopPer = 2;
constexpr int kCtasPerSm = 4;

template <int kBatch, bool kLoop>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
    gather_spmm_kernel(const float* __restrict__ vals,
                       const int32_t* __restrict__ cidx,
                       const float* __restrict__ table, float* __restrict__ y,
                       SsrGrid g, SsrStream sv, SsrStream sc, SsrStream sy,
                       int64_t zsteps, int64_t groups, int64_t scale,
                       int64_t offset, int64_t table_elems, int64_t valid_rows,
                       int64_t valid_cols, int64_t gpos, int64_t gtile) {
  // groups: CTAs per row block
  const unsigned p = blockIdx.x / static_cast<unsigned>(groups);
  const unsigned grp = blockIdx.x - p * static_cast<unsigned>(groups);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t tm = sc.block[0];
  const int64_t r = static_cast<int64_t>(grp) * kSpmmRows + warp;  // row in block
  const int64_t col = static_cast<int64_t>(blockIdx.y) * kSpmmCols + lane * 4;
  if (r >= tm) return;                              // the same for the warp
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  // one contraction step's row: its planes' rows and the gather's base
  auto step = [&](const SsrOdometer& at) {
    const int64_t row = at.index(sc, 0) * tm + r;
    const int64_t ncols = valid_cols_at(at, sc, valid_cols);
    if (row < valid_rows && ncols > 0)
      spmm_row<true, kBatch>(vals + at.origin(sv) + r * sv.pitch,
                             cidx + at.origin(sc) + r * sc.pitch, ncols, lane,
                             table, scale,
                             offset + spmm_level(at, gpos, gtile) + col,
                             table_elems, acc);
  };
  // drain: Y's block is (tm, tile); row r, columns col .. col + 3, its
  // address taken before the row so that no walk outlives it
  float* py;
  {
    const SsrOdometer at = odometer32(g, p * static_cast<unsigned>(zsteps));
    py = y + at.origin(sy) + r * sy.pitch + col;
    if constexpr (!kLoop) step(at);   // one contraction step: no walk kept
  }
  if constexpr (kLoop) {   // each step's walk unflattened anew, not kept
    const unsigned first = p * static_cast<unsigned>(zsteps);
#pragma unroll 1
    for (unsigned z = 0; z < static_cast<unsigned>(zsteps); ++z)
      step(odometer32(g, first + z));
  }
  *reinterpret_cast<float4*>(py) = acc;
}

}  // namespace

// As ssr_gather_spmv, plus the gather's affine level: its grid axis `gpos`
// and tile `gtile` (a multiple of 128; coefficient 1, scale, offset and the
// table's size multiples of 4, the table at least one 128-column row, the
// table and Y 16-byte aligned -- the wrapper checks).
extern "C" int ssr_gather_spmm(const void* vals, const void* cidx,
                               const void* table, void* y, const SsrGrid* g,
                               const SsrStream* sv, const SsrStream* sc,
                               const SsrStream* sy, int64_t zsteps,
                               int64_t scale, int64_t offset,
                               int64_t table_elems, int64_t valid_rows,
                               int64_t valid_cols, int64_t gpos, int64_t gtile,
                               void* stream) {
  int64_t steps = 1;
  for (int k = 0; k < g->ndim; ++k) steps *= g->dims[k];
  const int64_t groups = (sc->block[0] + kSpmmRows - 1) / kSpmmRows;
  const int64_t ctas = (steps / zsteps) * groups;
  if (ctas < 1 || ctas > 0x7fffffffLL || steps > 0x7fffffffLL ||
      table_elems < kSpmmCols || table_elems % 4 || gtile % kSpmmCols ||
      gtile / kSpmmCols > 65535 || gpos < 0 || gpos >= g->ndim)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(ctas),
                  static_cast<unsigned>(gtile / kSpmmCols));
  auto kernel = gather_spmm_kernel<kLoopPer, true>;
  if (zsteps == 1) {   // one contraction step: no walk to keep live
    kernel = gather_spmm_kernel<kPer, false>;
  }
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int32_t*>(cidx),
      static_cast<const float*>(table), static_cast<float*>(y), *g, *sv, *sc,
      *sy, zsteps, groups, scale, offset, table_elems, valid_rows, valid_cols,
      gpos, gtile);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int64_t ssr_gather_spmm_smem_bytes() { return 0; }

// The kernel's registers a thread and local (spill) bytes, as
// cudaFuncGetAttributes reads them, the most over its two instantiations
// (one contraction step, several): out[0] numRegs, out[1] localSizeBytes.
extern "C" int ssr_gather_spmm_attributes(int64_t* out) {
  const void* const kernels[] = {
      reinterpret_cast<const void*>(gather_spmm_kernel<kPer, false>),
      reinterpret_cast<const void*>(gather_spmm_kernel<kLoopPer, true>)};
  out[0] = out[1] = 0;
  for (const void* k : kernels) {
    cudaFuncAttributes a;
    const cudaError_t err = cudaFuncGetAttributes(&a, k);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (a.numRegs > out[0]) out[0] = a.numRegs;
    if (static_cast<int64_t>(a.localSizeBytes) > out[1])
      out[1] = static_cast<int64_t>(a.localSizeBytes);
  }
  return static_cast<int>(cudaSuccess);
}
