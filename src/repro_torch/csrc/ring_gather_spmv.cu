// R13 ring_gather_spmv: K12's y_blk += sum_j vals[i, j] * x[clip(scale *
// cidx[i, j] + offset)] over the trailing contraction axes, in f32, its vals
// and cidx rows delivered through an N-deep ring in shared memory and its
// gathers of x run ahead of the arithmetic.
//
// Replaces the TPU kernel repro/core/ssr.py:_pipelined_call (the N-deep
// rotation that ssr_pallas emits at buffer_depth > 2) around the contraction
// branch of repro/core/lowering.py:_build_nest_kernel with the gather
// repro/core/lowering.py:_gather_block, its table stream (the whole table,
// lowering.py:1546-1558) and the body repro/kernels/sparse.py:_body_spmv.
//
// Bound on H100: bytes, as K12 -- vals and cidx at their logical width k,
// x and y once each.
//
// Design.  K12's rows -- a group of 4 threads a row, 64 rows of the lowered
// row block a CTA, 8 a computing warp -- on persistent CTAs: each walks a
// run of `blocks_per_run` consecutive output blocks (of `zsteps` grid
// steps each) for its row group.  vals and cidx each have a ring of their
// own depth, a slot one step's 64 rows on a pitch of `width` elements (the
// index block's valid width rounded up to 16 bytes: 28 of the 128 lanes
// for k = 27); rows past the extent are never copied.  A ninth warp fills
// both rings, the CTA's rows at once as 16-byte packs (cp.async), as far
// ahead as the depths let it, and the eight computing warps meet no
// barrier of the CTA in the step loop: each waits on a slot's `full`
// mbarrier, and releases it on its `empty` one once it is past the step
// (ssr_gather_ring.cuh).  The computing warps gather x as K12 does, a
// thread's entries' loads through the read-only path before their FMAs --
// four of them, or eight where three CTAs an SM or fewer fit beside their
// rings (depth 4 and deeper on HPCG): copying the gathered values into
// shared memory ahead of the step (cp.async, steps ahead) measured slower
// on spmv_hpcg than these loads (PERF.md).  The contraction steps are
// carried in registers and folded at each output block's last step.  The
// row arithmetic is ssr_gather.cuh's spmv_row, K12's on the same values in
// the same order (entry j on thread j mod 4, fmaf in order, the
// xor-shuffle fold), so R13 gives K12's bits at every depth.
#include "ssr_gather.cuh"
#include "ssr_gather_ring.cuh"

namespace {

using namespace gather;

constexpr int kWarpRows = 32 / kSpmvGroup;   // rows a computing warp: 8
// Shared memory an SM holds for its CTAs, and what it keeps a CTA (H100,
// H200): how many CTAs fit beside their rings.
constexpr int64_t kSmemSm = 233472, kSmemCtaReserved = 1024;

constexpr int kCtaThreads = kThreads + 32;   // and the filling warp

// kPer entries a thread gathered before their FMAs: four where four CTAs
// fit an SM beside their rings (56 registers a thread), eight where three
// or fewer do (75 registers, the CTA that cannot fit not lost): more
// gathers in flight for the fewer warps.  The wrapper sizes the
// persistent grid for as many CTAs as fit, at most four.
template <int kPer>
__global__ void __launch_bounds__(kCtaThreads, kPer == 4 ? 4 : 3)
    ring_gather_spmv_kernel(const float* __restrict__ vals,
                            const int32_t* __restrict__ cidx,
                            const float* __restrict__ table,
                            float* __restrict__ y, SsrGrid g, SsrStream sv,
                            SsrStream sc, SsrStream sy, int64_t steps,
                            int64_t zsteps, int64_t groups,
                            int64_t blocks_per_run, int64_t scale,
                            int64_t offset, int64_t table_elems,
                            int64_t valid_rows, int64_t valid_cols, int width,
                            SsrRing ring) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t runi = blockIdx.x / groups, grp = blockIdx.x % groups;
  const int64_t s0 = runi * blocks_per_run * zsteps;
  const int64_t s1 = s0 + blocks_per_run * zsteps < steps
                         ? s0 + blocks_per_run * zsteps : steps;
  const int64_t run = s1 - s0;
  const int64_t tm = sc.block[0];
  const int64_t r0 = grp * kSpmvRows;
  const int rows_cta =
      static_cast<int>(tm - r0 < kSpmvRows ? tm - r0 : kSpmvRows);
  const int dv = static_cast<int>(ring.depth[0]);
  const int dc = static_cast<int>(ring.depth[1]);
  const int tile = kSpmvRows * width;   // a slot: the CTA's rows
  float* const v_slots = reinterpret_cast<float*>(smem);
  int32_t* const c_slots = reinterpret_cast<int32_t*>(v_slots + dv * tile);
  uint64_t* const bars =
      reinterpret_cast<uint64_t*>(smem + (dv + dc) * tile * sizeof(float));
  const int readers = (rows_cta + kWarpRows - 1) / kWarpRows;  // warps
  if (threadIdx.x == 0) gring::init_rings(bars, dv, dc, readers);
  __syncthreads();   // the barriers are set: the steps begin
  if (warp == kThreads / 32) {   // the filling warp
    gring::fill_rings(vals, cidx, v_slots, c_slots, tile, width, g, sv, sc,
                      s0, run, dv, dc, r0, rows_cta, valid_rows, valid_cols,
                      bars, lane);
    return;
  }
  if (warp >= readers) return;   // no row of the block

  const int64_t wr0 = r0 + warp * kWarpRows;   // the warp's rows
  const int wrows = static_cast<int>(tm - wr0 < kWarpRows ? tm - wr0
                                                          : kWarpRows);
  const int rr = lane / kSpmvGroup, t = lane % kSpmvGroup;
  const int row = warp * kWarpRows + rr;       // in a slot
  gring::Walk at(g, s0);
  gring::Slots cv(dv), cc(dc);
  float acc = 0.f;
  int64_t z = 0;
  for (int64_t u = 0; u < run; ++u) {
    gring::bar_wait(bars + cv.at, cv.parity);        // full: vals of step u
    gring::bar_wait(bars + 8 + cc.at, cc.parity);    // and its cidx
    const int64_t ncols = at.valid_cols(sc, valid_cols);
    if (rr < wrows && at.index(sc, 0) * tm + wr0 + rr < valid_rows &&
        ncols > 0)
      acc = spmv_row<false, kPer>(v_slots + cv.at * tile + row * width,
                            c_slots + cc.at * tile + row * width, ncols, t,
                            table, scale, offset, table_elems, acc);
    if (++z == zsteps) {  // the output block's last step: fold and drain
      acc = spmv_fold(acc);
      if (rr < wrows && t == 0) y[at.origin(sy) + wr0 + rr] = acc;
      acc = 0.f;
      z = 0;
    }
    gring::release(bars, cv, cc, lane);
    cv.next();
    cc.next();
    at.advance(g);
  }
}

}  // namespace

// As ssr_gather_spmv, plus the ring: each CTA walks `blocks_per_run`
// consecutive output blocks of `zsteps` steps for its group of 64 rows;
// `width` is a slot's row pitch (a multiple of 4, at least the valid
// columns of any step's index block); vals and cidx start 16-byte aligned,
// with row pitches and block widths of whole 16-byte packs (the wrapper
// checks); `ring->depth[0]`, `ring->depth[1]` the slots of vals and cidx
// (the table's entry is not read) and `smem_bytes` the dynamic shared
// memory as the wrapper counted it (the rings and the slots' barriers),
// checked here.
extern "C" int ssr_ring_gather_spmv(const void* vals, const void* cidx,
                                    const void* table, void* y,
                                    const SsrGrid* g, const SsrStream* sv,
                                    const SsrStream* sc, const SsrStream* sy,
                                    int64_t zsteps, int64_t scale,
                                    int64_t offset, int64_t table_elems,
                                    int64_t valid_rows, int64_t valid_cols,
                                    int64_t blocks_per_run, int64_t width,
                                    const SsrRing* ring, int64_t smem_bytes,
                                    void* stream) {
  int64_t steps = 1;
  for (int k = 0; k < g->ndim; ++k) steps *= g->dims[k];
  const int64_t groups = (sc->block[0] + kSpmvRows - 1) / kSpmvRows;
  const int64_t blocks = steps / zsteps;
  const int64_t ctas = ((blocks + blocks_per_run - 1) / blocks_per_run) * groups;
  const int64_t d0 = ring->depth[0], d1 = ring->depth[1];
  const bool packs =
      reinterpret_cast<uintptr_t>(vals) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(cidx) % 16 == 0 && sv->pitch % 4 == 0 &&
      sc->pitch % 4 == 0 && sv->block[1] % 4 == 0 && sc->block[1] % 4 == 0;
  if (ctas < 1 || ctas > 0x7fffffffLL || table_elems < 1 || blocks_per_run < 1 ||
      width < 4 || width % 4 || width > sc->block[1] || !packs || d0 < 2 ||
      d0 > 8 || d1 < 2 || d1 > 8 ||
      smem_bytes != (d0 + d1) * kSpmvRows * width * 4 + gring::kBarrierBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  // four CTAs an SM fit beside their rings: four entries a thread in
  // flight, else eight
  auto kernel = (kSmemSm / (smem_bytes + kSmemCtaReserved) >= 4)
                    ? ring_gather_spmv_kernel<4> : ring_gather_spmv_kernel<8>;
  cudaError_t err = ssr_ring_smem(kernel, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(ctas), kCtaThreads, smem_bytes,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int32_t*>(cidx),
      static_cast<const float*>(table), static_cast<float*>(y), *g, *sv, *sc,
      *sy, steps, zsteps, groups, blocks_per_run, scale, offset, table_elems,
      valid_rows, valid_cols, static_cast<int>(width), *ring);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int64_t ssr_ring_gather_spmv_smem_bytes() { return 0; }

// The kernel's registers a thread and local (spill) bytes, as
// cudaFuncGetAttributes reads them, the more of its two forms: out[0]
// numRegs, out[1] localSizeBytes.
extern "C" int ssr_ring_gather_spmv_attributes(int64_t* out) {
  cudaFuncAttributes a, b;
  cudaError_t err = cudaFuncGetAttributes(&a, ring_gather_spmv_kernel<4>);
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&b, ring_gather_spmv_kernel<8>);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs > b.numRegs ? a.numRegs : b.numRegs;
  out[1] = static_cast<int64_t>(a.localSizeBytes > b.localSizeBytes
                                    ? a.localSizeBytes : b.localSizeBytes);
  return 0;
}
