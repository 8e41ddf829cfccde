// R13 ring_gather_spmv: K12's y_blk += sum_j vals[i, j] * x[clip(scale *
// cidx[i, j] + offset)] over the trailing contraction axes, in f32, its vals
// and cidx rows delivered through an N-deep shared-memory ring.
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
// Design: K12's CTA split -- a group of 4 threads a row, 64 rows of the
// lowered row block a CTA -- on persistent CTAs: each walks a run of
// `blocks_per_run` consecutive output blocks (of `zsteps` grid steps each)
// for its row group, so that the ring has steps to run ahead over (at
// HPCG's default lowering a K12 CTA sees one step only).  vals and cidx
// each have a ring of their own depth, warps 0-3 fetching vals and warps
// 4-7 cidx (cp.async groups are per thread).  A slot holds one step's rows
// of the group on a pitch of `width` elements: the index block's valid
// width (its extent, at most the block's) rounded up to 16 bytes -- 28 of
// the 128 lanes for k = 27 -- so the padded lanes are never copied, and
// rows past the extent not at all.  The table x is not ringed: it is
// gathered from global memory through L2, as K12 gathers it (the reference
// keeps it whole, at depth 2).  At step s every thread waits on its
// stream's copies of step s, the CTA meets at one barrier (which publishes
// step s's slots and frees step s - 1's), and then each stream fetches step
// s + depth - 1 into the freed slot (ssr_ring.cuh).  The contraction steps
// are carried in registers and folded at each output block's last step.
// The row arithmetic is ssr_gather.cuh's spmv_row, K12's on the same values
// in the same order (entry j on thread j mod 4, fmaf in order, the
// xor-shuffle fold), so R13 gives K12's bits at every depth.
#include "ssr_ring.cuh"
#include "ssr_gather.cuh"

namespace {

using namespace gather;

// Four CTAs an SM at most (64 registers a thread): the wrapper sizes the
// persistent grid for as many as fit beside their rings, up to four, so the
// grid is one wave; at five an SM by shared memory (depth 3) the registers
// would still hold four, and a fifth of the CTAs would run as a second wave.
__global__ void __launch_bounds__(kThreads, 4)
    ring_gather_spmv_kernel(const float* __restrict__ vals,
                            const int32_t* __restrict__ cidx,
                            const float* __restrict__ table,
                            float* __restrict__ y, SsrGrid g, SsrStream sv,
                            SsrStream sc, SsrStream sy, int64_t steps,
                            int64_t zsteps, int64_t groups,
                            int64_t blocks_per_run, int64_t scale,
                            int64_t offset, int64_t table_elems,
                            int64_t valid_rows, int64_t valid_cols, int width,
                            int vec16, SsrRing ring) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t runi = blockIdx.x / groups, grp = blockIdx.x % groups;
  const int64_t s0 = runi * blocks_per_run * zsteps;
  const int64_t s1 = s0 + blocks_per_run * zsteps < steps
                         ? s0 + blocks_per_run * zsteps : steps;
  const int64_t run = s1 - s0;
  const int64_t tm = sc.block[0];
  const int64_t r0 = grp * kSpmvRows;
  const int64_t rows_cta = tm - r0 < kSpmvRows ? tm - r0 : kSpmvRows;
  const int tile = kSpmvRows * width;
  float* const v_slots = reinterpret_cast<float*>(smem);
  int32_t* const c_slots =
      reinterpret_cast<int32_t*>(v_slots + ring.depth[0] * tile);

  const SsrRingGroup fg(2);        // warps 0-3: vals, warps 4-7: cidx
  SsrRingSide side(ring, fg.stream);
  SsrRingSide rv(ring, 0), rc(ring, 1);
  const int64_t dmax = ring.depth[0] > ring.depth[1] ? ring.depth[0] : ring.depth[1];
  SsrOdometer fetch_at(g, s0);
  auto fetch = [&](int slot) {
    // the group's rows of the step's index block that hold data, and the
    // block's valid columns
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

  const int t = threadIdx.x % kSpmvGroup;
  const int rr = threadIdx.x / kSpmvGroup;   // row in the CTA
  const bool live = r0 + rr < tm;
  float acc = 0.f;
  int64_t z = 0;
  SsrOdometer at(g, s0);
  for (int64_t u = 1 - dmax; u < 0; ++u) side.issue(u, 1 - dmax, run, fetch);
  for (int64_t u = 0; u < run; ++u) {
    side.wait();
    __syncthreads();
    side.issue(u, 1 - dmax, run, fetch);
    const int64_t row = at.index(sc, 0) * tm + r0 + rr;
    const int64_t ncols = valid_cols_at(at, sc, valid_cols);
    if (live && row < valid_rows && ncols > 0)
      acc = spmv_row<false>(v_slots + rv.slot() * tile + rr * width,
                            c_slots + rc.slot() * tile + rr * width, ncols, t,
                            table, scale, offset, table_elems, acc);
    if (++z == zsteps) {  // the output block's last step: fold and drain
      acc = spmv_fold(acc);
      if (live && t == 0) y[at.origin(sy) + r0 + rr] = acc;
      acc = 0.f;
      z = 0;
    }
    at.advance(g);
    rv.step();
    rc.step();
  }
  ssr_cp_async_wait<0>();
}

}  // namespace

// As ssr_gather_spmv, plus the ring: each CTA walks `blocks_per_run`
// consecutive output blocks of `zsteps` steps for its group of 64 rows;
// `width` is a slot's row pitch (a multiple of 4, at least the valid
// columns of any step's index block); `vec16` 1 when vals' and cidx's block
// rows allow 16-byte copies; `ring->depth[0]`, `ring->depth[1]` the slots
// of vals and cidx (the table's entry is not read) and `smem_bytes` the
// ring's dynamic shared memory as the wrapper counted it, checked here.
extern "C" int ssr_ring_gather_spmv(const void* vals, const void* cidx,
                                    const void* table, void* y,
                                    const SsrGrid* g, const SsrStream* sv,
                                    const SsrStream* sc, const SsrStream* sy,
                                    int64_t zsteps, int64_t scale,
                                    int64_t offset, int64_t table_elems,
                                    int64_t valid_rows, int64_t valid_cols,
                                    int64_t blocks_per_run, int64_t width,
                                    int vec16, const SsrRing* ring,
                                    int64_t smem_bytes, void* stream) {
  int64_t steps = 1;
  for (int k = 0; k < g->ndim; ++k) steps *= g->dims[k];
  const int64_t groups = (sc->block[0] + kSpmvRows - 1) / kSpmvRows;
  const int64_t blocks = steps / zsteps;
  const int64_t ctas = ((blocks + blocks_per_run - 1) / blocks_per_run) * groups;
  const int64_t d0 = ring->depth[0], d1 = ring->depth[1];
  if (ctas < 1 || ctas > 0x7fffffffLL || table_elems < 1 || blocks_per_run < 1 ||
      width < 4 || width % 4 || width > sc->block[1] || d0 < 2 || d0 > 8 ||
      d1 < 2 || d1 > 8 || smem_bytes != (d0 + d1) * kSpmvRows * width * 4)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = ring_gather_spmv_kernel;
  cudaError_t err = ssr_ring_smem(kernel, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(ctas), kThreads, smem_bytes,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int32_t*>(cidx),
      static_cast<const float*>(table), static_cast<float*>(y), *g, *sv, *sc,
      *sy, steps, zsteps, groups, blocks_per_run, scale, offset, table_elems,
      valid_rows, valid_cols, static_cast<int>(width), vec16, *ring);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int64_t ssr_ring_gather_spmv_smem_bytes() { return 0; }
