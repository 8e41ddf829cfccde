// R14 ring_gather_spmm: K13's Y_blk += sum_j vals[i, j] * X[clip(scale *
// cidx[i, j] + c + offset)] over the trailing contraction axes, in f32, its
// vals and cidx rows delivered through an N-deep ring in shared memory, a
// ring a warp.
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
// Design.  K13's rows -- a warp a row, 8 rows a CTA, grid y over the
// 128-column chunks of the c tile, each lane four consecutive columns in
// registers -- on persistent CTAs that each walk a run of `blocks_per_run`
// consecutive output blocks for their rows and chunk (the same number of
// runs for every row group, all of them one wave).  Each warp is a ring of
// its own (ssr_gather_ring.cuh): its row of vals and of cidx arrives in a
// slot of the index block's valid width rounded up to 16 bytes, each
// stream at its own depth, its lanes copying the row's 16-byte packs; a
// row past the extent is never copied, and no barrier of the CTA is met in
// the step loop.  The table X is not ringed: its row segments are gathered
// from global memory as K13 gathers them, one 16-byte load a lane, four
// entries ahead of their FMAs; the ring takes the row's vals and cidx off
// the critical path, where K13 waits on them at each row's start.  The row
// arithmetic is ssr_gather.cuh's spmm_row, K13's on the same values in the
// same order (4 entries gathered before their FMAs, the clipped re-read of
// a segment outside the table), so R14 gives K13's bits at every depth.
#include "ssr_gather.cuh"
#include "ssr_gather_ring.cuh"

namespace {

using namespace gather;

// Three CTAs an SM (85 registers a thread, no spill): faster than K13's
// four at 64 registers and spills once the ring's walks join K13's
// registers (tools/gather_ring_ablation.py).
__global__ void __launch_bounds__(kThreads, 3)
    ring_gather_spmm_kernel(const float* __restrict__ vals,
                            const int32_t* __restrict__ cidx,
                            const float* __restrict__ table,
                            float* __restrict__ y, SsrGrid g, SsrStream sv,
                            SsrStream sc, SsrStream sy, int64_t steps,
                            int64_t zsteps, int64_t groups,
                            int64_t blocks_per_run, int64_t scale,
                            int64_t offset, int64_t table_elems,
                            int64_t valid_rows, int64_t valid_cols,
                            int64_t gpos, int64_t gtile, int width,
                            SsrRing ring) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t runi = blockIdx.x / groups, grp = blockIdx.x % groups;
  const int64_t s0 = runi * blocks_per_run * zsteps;
  const int64_t s1 = s0 + blocks_per_run * zsteps < steps
                         ? s0 + blocks_per_run * zsteps : steps;
  const int64_t run = s1 - s0;
  const int64_t tm = sc.block[0];
  const int64_t r = grp * kSpmmRows + warp;   // the warp's row in the block
  if (r >= tm) return;                        // no row: nothing to write

  const int dv = static_cast<int>(ring.depth[0]);
  const int dc = static_cast<int>(ring.depth[1]);
  float* const v_slots =
      reinterpret_cast<float*>(smem) + warp * (dv + dc) * width;
  int32_t* const c_slots = reinterpret_cast<int32_t*>(v_slots + dv * width);

  auto live_at = [&](const gring::Walk& w) {
    return w.index(sc, 0) * tm + r < valid_rows;
  };
  // the warp fills a slot of one stream with its row at step w
  auto fill = [&](auto* slots, const auto* src, const SsrStream& s,
                  const gring::Walk& w, int slot) {
    if (live_at(w))
      gring::warp_fill(slots + slot * width, src + w.origin(s) + r * s.pitch,
                       w.valid_cols(sc, valid_cols), lane);
  };

  // one group a step a thread, the fills of vals u + dv - 1 and cidx u +
  // dc - 1: before step u its fills of vals u and cidx u have landed
  const int pending = (dv < dc ? dv : dc) - 2;
  const int64_t col = static_cast<int64_t>(blockIdx.y) * kSpmmCols + lane * 4;
  gring::Walk fv(g, s0), fc(g, s0), at(g, s0);  // the next fills, this step
  gring::Slots pv(dv), pc(dc), cv(dv), cc(dc);  // their slots, this step's
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  int64_t z = 0;
  const int64_t dmax = dv > dc ? dv : dc;
  for (int64_t u = 1 - dmax; u < run; ++u) {
    gring::cp_wait(pending);
    // the warp's copies are shown to every lane, and every lane is past
    // step u - 1: its slots are free
    __syncwarp();
    if (u + dv - 1 >= 0 && u + dv - 1 < run) {
      fill(v_slots, vals, sv, fv, pv.at);
      pv.next();
      fv.advance(g);
    }
    if (u + dc - 1 >= 0 && u + dc - 1 < run) {
      fill(c_slots, cidx, sc, fc, pc.at);
      pc.next();
      fc.advance(g);
    }
    ssr_cp_async_commit();
    if (u < 0) continue;
    const int64_t ncols = at.valid_cols(sc, valid_cols);
    if (live_at(at) && ncols > 0)
      spmm_row<false>(v_slots + cv.at * width, c_slots + cc.at * width, ncols,
                      lane, table, scale,
                      offset + at.level(gpos, gtile) + col, table_elems, acc);
    if (++z == zsteps) {  // the output block's last step: drain
      *reinterpret_cast<float4*>(y + at.origin(sy) + r * sy.pitch + col) = acc;
      acc = make_float4(0.f, 0.f, 0.f, 0.f);
      z = 0;
    }
    cv.next();
    cc.next();
    at.advance(g);
  }
  ssr_cp_async_wait<0>();
}

}  // namespace

// As ssr_gather_spmm, plus R13's ring arguments: `blocks_per_run`, the
// slot pitch `width`, the ring of vals and cidx and `smem_bytes`, checked
// here; vals and cidx as R13 takes them.
extern "C" int ssr_ring_gather_spmm(const void* vals, const void* cidx,
                                    const void* table, void* y,
                                    const SsrGrid* g, const SsrStream* sv,
                                    const SsrStream* sc, const SsrStream* sy,
                                    int64_t zsteps, int64_t scale,
                                    int64_t offset, int64_t table_elems,
                                    int64_t valid_rows, int64_t valid_cols,
                                    int64_t gpos, int64_t gtile,
                                    int64_t blocks_per_run, int64_t width,
                                    const SsrRing* ring, int64_t smem_bytes,
                                    void* stream) {
  int64_t steps = 1;
  for (int k = 0; k < g->ndim; ++k) steps *= g->dims[k];
  const int64_t groups = (sc->block[0] + kSpmmRows - 1) / kSpmmRows;
  const int64_t blocks = steps / zsteps;
  const int64_t ctas = ((blocks + blocks_per_run - 1) / blocks_per_run) * groups;
  const int64_t d0 = ring->depth[0], d1 = ring->depth[1];
  const bool packs =
      reinterpret_cast<uintptr_t>(vals) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(cidx) % 16 == 0 && sv->pitch % 4 == 0 &&
      sc->pitch % 4 == 0 && sv->block[1] % 4 == 0 && sc->block[1] % 4 == 0;
  if (ctas < 1 || ctas > 0x7fffffffLL || table_elems < kSpmmCols ||
      table_elems % 4 ||
      gtile % kSpmmCols || gtile / kSpmmCols > 65535 || gpos < 0 ||
      gpos >= g->ndim || blocks_per_run < 1 || width < 4 || width % 4 ||
      width > sc->block[1] || !packs || d0 < 2 || d0 > 8 || d1 < 2 ||
      d1 > 8 ||
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
      valid_rows, valid_cols, gpos, gtile, static_cast<int>(width), *ring);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int64_t ssr_ring_gather_spmm_smem_bytes() { return 0; }

// The kernel's registers a thread and local (spill) bytes, as
// cudaFuncGetAttributes reads them: out[0] numRegs, out[1] localSizeBytes.
extern "C" int ssr_ring_gather_spmm_attributes(int64_t* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, ring_gather_spmm_kernel);
  out[0] = a.numRegs;
  out[1] = static_cast<int64_t>(a.localSizeBytes);
  return static_cast<int>(err);
}
