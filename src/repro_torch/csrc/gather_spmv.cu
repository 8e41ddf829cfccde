// K12 gather_spmv: y_blk += sum_j vals[i, j] * x[clip(scale * cidx[i, j] +
// offset)] over the trailing contraction axes, in f32 -- the indirection
// stream: cidx's block feeds the gather's addresses.
//
// Replaces the TPU kernel repro/core/ssr.py:ssr_pallas (sync emitter) with
// the contraction branch of repro/core/lowering.py:_build_nest_kernel, the
// gather repro/core/lowering.py:_gather_block and its table stream (the
// whole table as a revisited invariant block, lowering.py:1546-1558), and
// the body repro/kernels/sparse.py:_body_spmv.  For HPCG's 27-point operator
// on a 128^3 grid the default lowering gives grid (4096, 1), (parallel,
// arbitrary) and vals and cidx blocks (512, 128); on the card the wrapper
// hands this kernel pack_ell's (m, 27) planes as they are, at pitch 27 (no
// layout copy), and y (1, 512) blocks.
//
// Bound on H100: bytes.  vals and cidx at their logical width k, x and y
// once each (448 MiB for HPCG 128^3: 0.140 ms at 3.35 TB/s).  x (8 MiB) is
// gathered through the 50 MB L2 and the read-only path.
//
// Design.  The lowered block is 128 lanes wide and k = 27, so the kernel
// reads only the positions of the index block that hold data -- the
// extent (valid_rows, valid_cols) of cidx's layout, from the nest -- on
// planes of any pitch: the unpadded (m, k) planes the card's wrapper
// hands it (rows back to back, 108 bytes each: a warp's 8 rows are one
// run of 864 bytes) or the lowering's padded (m, 128) layouts (a row's 108
// bytes 512 apart).  The TPU's grid step is one CTA of 256 threads per 64
// rows of the lowered row block; a row of 27 entries would leave most of
// a warp idle, so a row gets a group of 4 threads (an eighth of a warp:
// eight rows under each warp load), entry j on thread j mod 4, each
// loading up to kRowPer of its entries (vals and cidx) before it issues
// their gathers (gather::spmv_row, in the order of j whatever kRowPer:
// R13's order too, so R13 keeps K12's bits).  A thread's whole share is
// about 7 entries, so what it does once counts (measured on an H100,
// tools/gemv_spmv_ablation.py, PERF.md): its CTA's place in the grid and
// the walk's odometer are unflattened once, in 32-bit arithmetic, the
// drain's block origin taken from the same odometer; and a grid of one
// column step (k within one lane tile, as HPCG's) skips the loop over
// steps, so no walk stays live in registers.  Staging a CTA's rows through
// shared memory by one bulk copy a plane, a CTA walking several 64-row
// groups, a rolled loop of one entry at a time and loads cached in L2
// only all measured slower.  The contraction steps (k beyond one lane
// tile) run as a loop inside the CTA, the sum carried in registers; the
// group folds its sums by shuffles and writes y once.  Addresses are
// 64-bit and clipped into the table, as the reference clips them, so
// nothing is read outside it.
#include "ssr_gather.cuh"

namespace {

using namespace gather;

// Entries a thread holds before their gathers (spmv_row's kPer): eight,
// so a row of 27 is one round of loads and gathers a thread.
constexpr int kRowPer = 8;

__global__ void __launch_bounds__(kThreads)
    gather_spmv_kernel(const float* __restrict__ vals,
                       const int32_t* __restrict__ cidx,
                       const float* __restrict__ table, float* __restrict__ y,
                       SsrGrid g, SsrStream sv, SsrStream sc, SsrStream sy,
                       int64_t zsteps, int64_t groups, int64_t scale,
                       int64_t offset, int64_t table_elems, int64_t valid_rows,
                       int64_t valid_cols) {  // groups: CTAs per row block
  const unsigned p = blockIdx.x / static_cast<unsigned>(groups);
  const unsigned grp = blockIdx.x - p * static_cast<unsigned>(groups);
  const int t = threadIdx.x % kSpmvGroup;
  const int64_t tm = sc.block[0];
  const int64_t r = static_cast<int64_t>(grp) * kSpmvRows +
                    threadIdx.x / kSpmvGroup;  // row in block
  const bool live = r < tm;
  float acc = 0.f;

  SsrOdometer odo = odometer32(g, p * static_cast<unsigned>(zsteps));
  // drain: y's block is (1, tm); its element (0, r) sits at origin + r
  float* const py = y + odo.origin(sy);
  auto step = [&](const SsrOdometer& at) {
    const int64_t row = at.index(sc, 0) * tm + r;
    const int64_t ncols = valid_cols_at(at, sc, valid_cols);
    if (live && row < valid_rows && ncols > 0)
      acc = spmv_row<true, kRowPer>(vals + at.origin(sv) + r * sv.pitch,
                                    cidx + at.origin(sc) + r * sc.pitch, ncols,
                                    t, table, scale, offset, table_elems, acc);
  };
  if (zsteps == 1) {   // one column step: no walk to keep live
    step(odo);
  } else {
    for (int64_t z = 0; z < zsteps; ++z, odo.advance(g)) step(odo);
  }
  acc = spmv_fold(acc);
  if (live && t == 0) py[r] = acc;
}

}  // namespace

// vals (f32) and cidx (int32) share one walk; the table is the whole x.
// `valid_rows`/`valid_cols` bound the positions of cidx's layout that hold
// data; `scale`, `offset` and `table_elems` are the gather's program.
extern "C" int ssr_gather_spmv(const void* vals, const void* cidx,
                               const void* table, void* y, const SsrGrid* g,
                               const SsrStream* sv, const SsrStream* sc,
                               const SsrStream* sy, int64_t zsteps,
                               int64_t scale, int64_t offset,
                               int64_t table_elems, int64_t valid_rows,
                               int64_t valid_cols, void* stream) {
  int64_t steps = 1;
  for (int k = 0; k < g->ndim; ++k) steps *= g->dims[k];
  const int64_t groups = (sc->block[0] + kSpmvRows - 1) / kSpmvRows;
  const int64_t ctas = (steps / zsteps) * groups;
  if (ctas < 1 || ctas > 0x7fffffffLL || steps > 0x7fffffffLL ||
      table_elems < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  gather_spmv_kernel<<<static_cast<unsigned>(ctas), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int32_t*>(cidx),
      static_cast<const float*>(table), static_cast<float*>(y), *g, *sv, *sc,
      *sy, zsteps, groups, scale, offset, table_elems, valid_rows, valid_cols);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int64_t ssr_gather_spmv_smem_bytes() { return 0; }

// The kernel's registers a thread and local (spill) bytes, as
// cudaFuncGetAttributes reads them: out[0] numRegs, out[1] localSizeBytes.
extern "C" int ssr_gather_spmv_attributes(int64_t* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, gather_spmv_kernel);
  out[0] = a.numRegs;
  out[1] = static_cast<int64_t>(a.localSizeBytes);
  return static_cast<int>(err);
}
