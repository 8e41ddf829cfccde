// R14 ring_gather_spmm: K13's Y_blk += sum_j vals[i, j] * X[clip(scale *
// cidx[i, j] + c + offset)] over the trailing contraction axes, in f32, its
// vals and cidx rows delivered through an N-deep shared-memory ring.
//
// Replaces the TPU kernel repro/core/ssr.py:_pipelined_call (the N-deep
// rotation that ssr_pallas emits at buffer_depth > 2) around the contraction
// branch of repro/core/lowering.py:_build_nest_kernel with the gather
// repro/core/lowering.py:_gather_block (its affine level prepends the c
// tile), its table stream (lowering.py:1546-1558) and the body
// repro/kernels/sparse.py:_body_spmm.
//
// Bound on H100: bytes, as K13 -- the ELL planes at width k, X and Y once
// each.
//
// Design: K13's CTA split -- a warp a row, 8 rows a CTA, grid y over the
// 128-column chunks of the c tile, each lane four consecutive columns in
// registers -- on persistent CTAs that each walk a run of `blocks_per_run`
// consecutive output blocks for their rows and chunk, with R13's ring:
// vals and cidx each through a ring of its own depth (warps 0-3 fetch vals,
// warps 4-7 cidx), a slot one step's rows on a pitch of the index block's
// valid width rounded up to 16 bytes, rows past the extent never copied.
// The table X is not ringed: its row segments are gathered from global
// memory as K13 gathers them, one 16-byte load a lane.  The row arithmetic
// is ssr_gather.cuh's spmm_row, K13's on the same values in the same order
// (4 entries gathered before their FMAs, the clipped re-read of a segment
// outside the table), so R14 gives K13's bits at every depth.
#include "ssr_ring.cuh"
#include "ssr_gather.cuh"

namespace {

using namespace gather;

// Four CTAs an SM, as K13.
__global__ void __launch_bounds__(kThreads, 4)
    ring_gather_spmm_kernel(const float* __restrict__ vals,
                            const int32_t* __restrict__ cidx,
                            const float* __restrict__ table,
                            float* __restrict__ y, SsrGrid g, SsrStream sv,
                            SsrStream sc, SsrStream sy, int64_t steps,
                            int64_t zsteps, int64_t groups,
                            int64_t blocks_per_run, int64_t scale,
                            int64_t offset, int64_t table_elems,
                            int64_t valid_rows, int64_t valid_cols,
                            int64_t gpos, int64_t gtile, int width, int vec16,
                            SsrRing ring) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t runi = blockIdx.x / groups, grp = blockIdx.x % groups;
  const int64_t s0 = runi * blocks_per_run * zsteps;
  const int64_t s1 = s0 + blocks_per_run * zsteps < steps
                         ? s0 + blocks_per_run * zsteps : steps;
  const int64_t run = s1 - s0;
  const int64_t tm = sc.block[0];
  const int64_t r0 = grp * kSpmmRows;
  const int64_t rows_cta = tm - r0 < kSpmmRows ? tm - r0 : kSpmmRows;
  const int tile = kSpmmRows * width;
  float* const v_slots = reinterpret_cast<float*>(smem);
  int32_t* const c_slots =
      reinterpret_cast<int32_t*>(v_slots + ring.depth[0] * tile);

  const SsrRingGroup fg(2);        // warps 0-3: vals, warps 4-7: cidx
  SsrRingSide side(ring, fg.stream);
  SsrRingSide rv(ring, 0), rc(ring, 1);
  const int64_t dmax = ring.depth[0] > ring.depth[1] ? ring.depth[0] : ring.depth[1];
  SsrOdometer fetch_at(g, s0);
  auto fetch = [&](int slot) {
    const int64_t row0 = fetch_at.index(sc, 0) * tm + r0;
    int64_t rows = valid_rows - row0;
    rows = rows < rows_cta ? rows : rows_cta;
    const int64_t ncols = valid_cols_at(fetch_at, sc, valid_cols);
    if (rows > 0 && ncols > 0) {
      if (fg.stream == 0)
        ssr_ring_copy<float>(v_slots + slot * tile, width,
                             vals + fetch_at.origin(sv) + r0 * sv.pitch,
                             sv.pitch, static_cast<int>(rows),
                             static_cast<int>(ncols), vec16 != 0, fg.lane,
                             fg.size);
      else
        ssr_ring_copy<int32_t>(c_slots + slot * tile, width,
                               cidx + fetch_at.origin(sc) + r0 * sc.pitch,
                               sc.pitch, static_cast<int>(rows),
                               static_cast<int>(ncols), vec16 != 0, fg.lane,
                               fg.size);
    }
    fetch_at.advance(g);
  };

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t col = static_cast<int64_t>(blockIdx.y) * kSpmmCols + lane * 4;
  const bool live = r0 + warp < tm;          // the same for the warp
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  int64_t z = 0;
  SsrOdometer at(g, s0);
  for (int64_t u = 1 - dmax; u < 0; ++u) side.issue(u, 1 - dmax, run, fetch);
  for (int64_t u = 0; u < run; ++u) {
    side.wait();
    __syncthreads();
    side.issue(u, 1 - dmax, run, fetch);
    const int64_t row = at.index(sc, 0) * tm + r0 + warp;
    const int64_t ncols = valid_cols_at(at, sc, valid_cols);
    if (live && row < valid_rows && ncols > 0)
      spmm_row<false>(v_slots + rv.slot() * tile + warp * width,
                      c_slots + rc.slot() * tile + warp * width, ncols, lane,
                      table, scale, offset + spmm_level(at, gpos, gtile) + col,
                      table_elems, acc);
    if (++z == zsteps) {  // the output block's last step: drain
      if (live)
        *reinterpret_cast<float4*>(y + at.origin(sy) + (r0 + warp) * sy.pitch +
                                   col) = acc;
      acc = make_float4(0.f, 0.f, 0.f, 0.f);
      z = 0;
    }
    at.advance(g);
    rv.step();
    rc.step();
  }
  ssr_cp_async_wait<0>();
}

}  // namespace

// As ssr_gather_spmm, plus R13's ring arguments: `blocks_per_run`, the
// slot pitch `width`, `vec16`, the ring of vals and cidx and `smem_bytes`,
// checked here.
extern "C" int ssr_ring_gather_spmm(const void* vals, const void* cidx,
                                    const void* table, void* y,
                                    const SsrGrid* g, const SsrStream* sv,
                                    const SsrStream* sc, const SsrStream* sy,
                                    int64_t zsteps, int64_t scale,
                                    int64_t offset, int64_t table_elems,
                                    int64_t valid_rows, int64_t valid_cols,
                                    int64_t gpos, int64_t gtile,
                                    int64_t blocks_per_run, int64_t width,
                                    int vec16, const SsrRing* ring,
                                    int64_t smem_bytes, void* stream) {
  int64_t steps = 1;
  for (int k = 0; k < g->ndim; ++k) steps *= g->dims[k];
  const int64_t groups = (sc->block[0] + kSpmmRows - 1) / kSpmmRows;
  const int64_t blocks = steps / zsteps;
  const int64_t ctas = ((blocks + blocks_per_run - 1) / blocks_per_run) * groups;
  const int64_t d0 = ring->depth[0], d1 = ring->depth[1];
  if (ctas < 1 || ctas > 0x7fffffffLL || table_elems < 4 || table_elems % 4 ||
      gtile % kSpmmCols || gtile / kSpmmCols > 65535 || gpos < 0 ||
      gpos >= g->ndim || blocks_per_run < 1 || width < 4 || width % 4 ||
      width > sc->block[1] || d0 < 2 || d0 > 8 || d1 < 2 || d1 > 8 ||
      smem_bytes != (d0 + d1) * kSpmmRows * width * 4)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = ring_gather_spmm_kernel;
  cudaError_t err = ssr_ring_smem(kernel, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(ctas),
                  static_cast<unsigned>(gtile / kSpmmCols));
  kernel<<<grid, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int32_t*>(cidx),
      static_cast<const float*>(table), static_cast<float*>(y), *g, *sv, *sc,
      *sy, steps, zsteps, groups, blocks_per_run, scale, offset, table_elems,
      valid_rows, valid_cols, gpos, gtile, static_cast<int>(width), vec16,
      *ring);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int64_t ssr_ring_gather_spmm_smem_bytes() { return 0; }
