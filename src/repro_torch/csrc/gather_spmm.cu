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
// lowering gives grid (1024, 1, 1), blocks vals/cidx (256, 128) of (m, 128)
// layouts, Y (256, 128), the table X as (n, 128) (pitch 128 = scale).
//
// Bound on H100: bytes.  The ELL planes at width k, X and Y once each (310
// MiB for HPCG 64^3: 0.097 ms at 3.35 TB/s).  The gathers move 27 X rows of
// 512 bytes per output row (3.4 GiB), which stay in the 50 MB L2 only as far
// as neighbouring rows share them.
//
// Design.  A warp per output row, eight rows a CTA; each lane holds four
// consecutive columns of a 128-wide chunk of the c tile (grid y walks the
// chunks) in registers.  The warp loads 32 entries of its row's vals and
// cidx at once (coalesced), then for each entry broadcasts vals and cidx by
// shuffles and gathers the 512-byte X row segment as one 16-byte load a
// lane (scale, offset and the chunk keep every segment 16-byte aligned; the
// wrapper checks the table's base).  Four entries' gathers are issued
// before their FMAs, in straight-line code: each segment's start is clipped
// into the table first, so the load needs no branch, and only a group with
// a segment past the table's ends (never for a valid CSR) re-reads it
// element by element, clipped as the reference clips.  As in K12 only the
// index block's positions that hold data are read; the contraction steps
// run as a loop inside the CTA; Y is written once per row.  Addresses are
// 64-bit.
#include "ssr_gather.cuh"

namespace {

using namespace gather;

// Four CTAs an SM: the walk registers and four 16-byte gathers in flight
// take about 80 registers a thread unbounded (three CTAs an SM); at 64 the
// few spills cost less than the fourth CTA gains on spmm_hpcg.
__global__ void __launch_bounds__(kThreads, 4)
    gather_spmm_kernel(const float* __restrict__ vals,
                       const int32_t* __restrict__ cidx,
                       const float* __restrict__ table, float* __restrict__ y,
                       SsrGrid g, SsrStream sv, SsrStream sc, SsrStream sy,
                       int64_t zsteps, int64_t groups, int64_t scale,
                       int64_t offset, int64_t table_elems, int64_t valid_rows,
                       int64_t valid_cols, int64_t gpos, int64_t gtile) {
  // groups: CTAs per row block
  const int64_t p = blockIdx.x / groups;
  const int64_t grp = blockIdx.x % groups;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t tm = sc.block[0];
  const int64_t r = grp * kSpmmRows + warp;         // row in the block
  const int64_t col = static_cast<int64_t>(blockIdx.y) * kSpmmCols + lane * 4;
  const bool live = r < tm;                         // the same for the warp
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);

  SsrOdometer odo(g, p * zsteps);
  for (int64_t z = 0; z < zsteps; ++z, odo.advance(g)) {
    const int64_t row = odo.index(sc, 0) * tm + r;
    const int64_t ncols = valid_cols_at(odo, sc, valid_cols);
    if (!live || row >= valid_rows || ncols <= 0) continue;
    spmm_row<true>(vals + odo.origin(sv) + r * sv.pitch,
                   cidx + odo.origin(sc) + r * sc.pitch, ncols, lane, table,
                   scale, offset + spmm_level(odo, gpos, gtile) + col,
                   table_elems, acc);
  }
  // drain: Y's block is (tm, tile); row r, columns col .. col + 3
  if (live)
    *reinterpret_cast<float4*>(y + ssr_block_origin(sy, g, p * zsteps) +
                               r * sy.pitch + col) = acc;
}

}  // namespace

// As ssr_gather_spmv, plus the gather's affine level: its grid axis `gpos`
// and tile `gtile` (a multiple of 128; coefficient 1, scale, offset and the
// table's size multiples of 4, the table and Y 16-byte aligned -- the
// wrapper checks).
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
  if (ctas < 1 || ctas > 0x7fffffffLL || table_elems < 4 || table_elems % 4 ||
      gtile % kSpmmCols ||
      gtile / kSpmmCols > 65535 || gpos < 0 || gpos >= g->ndim)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(ctas),
                  static_cast<unsigned>(gtile / kSpmmCols));
  gather_spmm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int32_t*>(cidx),
      static_cast<const float*>(table), static_cast<float*>(y), *g, *sv, *sc,
      *sy, zsteps, groups, scale, offset, table_elems, valid_rows, valid_cols,
      gpos, gtile);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int64_t ssr_gather_spmm_smem_bytes() { return 0; }

// The kernel's registers a thread and local (spill) bytes, as
// cudaFuncGetAttributes reads them: out[0] numRegs, out[1] localSizeBytes.
extern "C" int ssr_gather_spmm_attributes(int64_t* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, gather_spmm_kernel);
  out[0] = a.numRegs;
  out[1] = static_cast<int64_t>(a.localSizeBytes);
  return static_cast<int>(err);
}
