// R9 ring_dag_mlp: K8's MLP diamond, fused and as every component a legal
// cut leaves, its read streams delivered through an N-deep shared-memory
// ring.
//
// Replaces the TPU kernel repro/core/ssr.py:_pipelined_call (the N-deep
// rotation that ssr_pallas emits at buffer_depth > 2) around the DAG
// assembler repro/core/lowering.py:_build_dag_kernel (:1720-1769, the depths
// handed to _assemble_kernel at :1316) and the bodies of
// repro/kernels/dag.py:215-231 (_mlp_hidden, _mlp_out, _mlp_residual), with
// W1, b1, W2 and b2 as uniforms.
//
// Bound on H100: operations, as K8.
//
// Design.  K8 takes W1 and W2 (2 x 64 KiB, staged once a CTA) and two
// 64-row tiles on a 132-float pitch (33,792 bytes each), multiplying one
// while the next lands.  R9's ring lands its step blocks (rows x 128 on
// that pitch) in such tiles, where the product reads them: no copy from a
// slot into a tile.
//
// * A tile is `steps_per_tile` = 64 / rows consecutive steps (fewer at the
//   grid's end); the wrapper gives the tiles to CTAs as K8 does (CTA b takes
//   tiles b, b + CTAs, ..., one CTA an SM).  A CTA's run is the sequence of
//   its tiles' steps, and the ring runs over that sequence: run step u
//   lands in row (u mod steps_per_tile) * rows of the tile its tile number
//   maps to, of mlp_ring_tiles(depth, rows) tiles in turn.
// * The product of a tile stands for the steps of the CTA's next tile: at
//   each of those steps, spread over the product's hook points (between its
//   k loops, every kMlpHookK values of k: mlp_tile's hook), the ring
//   fetches the step depth - 1 ahead, across tile ends, by cp.async (each
//   thread's part of one step a commit group).  The steps' addresses come
//   32 at a time, a lane each by the stream's block walk, shared in the
//   warp by shuffles.
//   Before a tile's product every thread waits for its copies of the
//   tile's steps (the later ones, at most depth - 1 groups, stay in
//   flight) and the CTA meets at one barrier, which also frees the tile
//   multiplied before: one barrier a tile, and two around H when the
//   hidden and out stages both run, as in K8.  So the tile being
//   multiplied, the next one and those the fetches reach are mlp_ring_tiles
//   tiles: three up to a depth of steps_per_tile + 1.
// * The product is ssr_dag.cuh::mlp_tile -- K8's, the same sequential-in-k
//   FMA chain for every output -- and the rows are written as K8 writes
//   them.  The weights (the uniforms: invariant streams, whose one slot is
//   this staging) and biases are read once a CTA while the ring primes.
//   The same bits as K8 at every depth.
// * The residual alone ({2}) stages nothing: it reads H and Y through two
//   rings of step slots (a fetching group of four warps each), one CTA
//   barrier a step, and adds them, one warp a row, on the same tiles.
//
// The wrapper counts the weights and tiles (hopper._staged_bytes) or the
// residual's slots against the opt-in budget and refuses a schedule over
// it, as accepts() does; the entry checks the count is this layout's.
#include "ssr_dag.cuh"
#include "ssr_ring.cuh"

namespace {

constexpr int kThreads = kMlpThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kN = kMlpN, kPitch = kMlpPitch;

template <int MASK, int V>
__global__ void __launch_bounds__(kThreads, 1)
    ring_dag_mlp_kernel(const float* __restrict__ x,
                        const float* __restrict__ h_in,
                        const float* __restrict__ w1,
                        const float* __restrict__ b1,
                        const float* __restrict__ w2,
                        const float* __restrict__ b2, float* __restrict__ out,
                        SsrGrid g, SsrStream sx, SsrStream sh, SsrStream so,
                        int64_t steps, int64_t steps_per_tile, int depth) {
  constexpr bool kH = (MASK & kMlpHidden) != 0, kY = (MASK & kMlpOut) != 0;
  extern __shared__ __align__(16) float smem[];
  float* const W1s = smem;
  float* const W2s = smem + kN * kN;
  float* const tiles = smem + 2 * kN * kN;
  const int rows = static_cast<int>(so.block[0]);
  const int spt = static_cast<int>(steps_per_tile);
  const int nb = mlp_ring_tiles(depth, rows);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int rt, ct;
  mlp_place(tid, rt, ct);
  const int c0 = 4 * ct, c1 = 64 + 4 * ct;

  // this CTA's run: its tiles' steps, one tile after another
  const int64_t tiles_total = (steps + spt - 1) / spt;
  const int64_t cta = blockIdx.x, ctas = gridDim.x;
  if (cta >= tiles_total) return;
  const int64_t mine = (tiles_total - 1 - cta) / ctas + 1;
  const int64_t last = cta + (mine - 1) * ctas;
  const int64_t run = (mine - 1) * spt + (steps - last * spt < spt
                                              ? steps - last * spt : spt);
  auto steps_of = [&](int64_t i) {   // steps of the CTA's i-th tile
    const int64_t left = steps - (cta + i * ctas) * spt;
    return static_cast<int>(left < spt ? left : spt);
  };

  // the fetch cursor: run step `issued` is step `fp` of a tile of the CTA,
  // which lands in tile buffer `fb`.  Its address comes from a window of
  // 32 run steps from `win`: lane j finds step win + j's by the stream's
  // block walk, the warp shares them.
  int64_t issued = 0, win = 0, at = 0;
  int fp = 0, fb = 0;
  const float* const src = kH ? x : h_in;
  auto fetch = [&]() {
    if (issued == 0 || issued - win == 32) {
      win = issued;
      const int64_t u = win + lane;
      if (u < run) {
        const int64_t step = (cta + u / spt * ctas) * spt + u % spt;
        if constexpr (kH)
          at = ssr_block_origin(sx, g, step);
        else
          at = ssr_block_origin(sh, g, step);
      }
    }
    const int64_t o =
        __shfl_sync(0xffffffffu, at, static_cast<int>(issued - win));
    float* dst = tiles + fb * kMlpTileFloats + fp * rows * kPitch;
    ssr_ring_copy<float>(dst, kPitch, src + o, kH ? sx.pitch : sh.pitch, rows,
                         kN, V > 1, tid, kThreads);
    ssr_cp_async_commit();
    ++issued;
    if (++fp == spt) {
      fp = 0;
      fb = fb + 1 == nb ? 0 : fb + 1;
    }
  };

  // prime: the first tile's steps and depth - 1 beyond them
  int64_t end = steps_of(0);   // run steps up to the current tile's end
  for (const int64_t want = end + depth - 1 < run ? end + depth - 1 : run;
       issued < want;)
    fetch();
  float bv[8], b1v[8];
  if constexpr (kH) mlp_stage_weight<V>(W1s, w1);
  if constexpr (kY) mlp_stage_weight<V>(W2s, w2);
  mlp_bias<V>(kY ? b2 : b1, c0, c1, bv);
  if constexpr (kH && kY) mlp_bias<V>(b1, c0, c1, b1v);

  // the next tile's steps, spread over this tile's hook steps: at step q,
  // the fetches of its first ceil((q + 1) * ahead / Q) steps
  constexpr int kQ = mlp_hook_steps<MASK>();
  int64_t base = 0;
  int ahead = 0;
  auto hook = [&](int q) {
    int64_t want = base + ((q + 1) * ahead + kQ - 1) / kQ;
    if (want > run) want = run;
    while (issued < want) fetch();
  };
  float acc[kMlpRows][8];
  int tb = 0;   // the tile buffer of the CTA's current tile
  for (int64_t i = 0; i < mine; ++i) {
    const int n = steps_of(i);
    ssr_ring_wait(static_cast<int>(issued - end));
    __syncthreads();  // the tile's steps have landed, the weights are
                      // staged, and every thread is done with the last tile
    base = issued;
    ahead = i + 1 < mine ? steps_of(i + 1) : 0;
    mlp_tile<MASK>(tiles + tb * kMlpTileFloats, W1s, W2s, rt, ct, bv, b1v,
                   acc, hook);
    // a lane finds one of its warp's output rows' addresses
    // (mlp_store_row_of: step row / rows of the tile), the warp shares them
    const int srow = mlp_store_row_of(warp, lane);
    const int64_t sat =
        srow < n * rows
            ? ssr_block_origin(so, g, (cta + i * ctas) * spt + srow / rows) +
                  static_cast<int64_t>(srow % rows) * so.pitch
            : -1;
#pragma unroll
    for (int r = 0; r < kMlpRows; ++r) {
      const int64_t o = __shfl_sync(0xffffffffu, sat, (lane >> 3) + 4 * r);
      if (o >= 0) mlp_store_row<V>(out + o, c0, c1, acc[r]);
    }
    end += ahead;
    tb = tb + 1 == nb ? 0 : tb + 1;
  }
}

// The residual alone: H and Y through two rings of step slots (rows x 128
// on the tile's pitch), one CTA barrier a step; out = y + h, one warp a row.
template <int V>
__global__ void __launch_bounds__(kThreads)
    ring_dag_mlp_residual(const float* __restrict__ h_in,
                          const float* __restrict__ y_in,
                          float* __restrict__ out, SsrGrid g, SsrStream sh,
                          SsrStream sy, SsrStream so, int64_t steps,
                          int64_t steps_per_tile, SsrRing ring) {
  extern __shared__ __align__(16) float smem[];
  const int rows = static_cast<int>(so.block[0]);
  const int slot_elems = rows * kPitch;
  float* const slots0 = smem;
  float* const slots1 = slots0 + ring.depth[0] * slot_elems;

  // this CTA's run: its tiles' steps, one tile after another
  const int64_t spt = steps_per_tile;
  const int64_t tiles = (steps + spt - 1) / spt;
  const int64_t cta = blockIdx.x, ctas = gridDim.x;
  const int64_t mine_tiles = cta < tiles ? (tiles - 1 - cta) / ctas + 1 : 0;
  const int64_t last = cta + (mine_tiles - 1) * ctas;
  const int64_t run =
      mine_tiles == 0 ? 0
                      : (mine_tiles - 1) * spt +
                            ((last + 1) * spt < steps ? (last + 1) * spt : steps) -
                            last * spt;
  auto step_of = [&](int64_t u) { return (cta + u / spt * ctas) * spt + u % spt; };

  const SsrRingGroup grp(2);
  const int mine = grp.stream;
  SsrRingSide side(ring, mine);
  SsrRingSide r0(ring, 0), r1(ring, 1);
  int64_t dmax = r0.depth > 2 ? r0.depth : 2;
  if (r1.depth > dmax) dmax = r1.depth;
  int64_t fetched = 0;  // run steps this thread's stream has fetched
  auto fetch = [&](int slot) {
    const int64_t step = step_of(fetched++);
    const float* src = mine == 0 ? h_in + ssr_block_origin(sh, g, step)
                                 : y_in + ssr_block_origin(sy, g, step);
    const int64_t pitch = mine == 0 ? sh.pitch : sy.pitch;
    ssr_ring_copy<float>((mine == 0 ? slots0 : slots1) + slot * slot_elems,
                         kPitch, src, pitch, rows, kN, V > 1, grp.lane,
                         grp.size);
  };

  for (int64_t u = 1 - dmax; u < 0; ++u) side.issue(u, 1 - dmax, run, fetch);
  const int tid = threadIdx.x, lane = tid & 31;
  for (int64_t u = 0; u < run; ++u) {
    side.wait();
    __syncthreads();  // the step's slots are visible
    side.issue(u, 1 - dmax, run, fetch);
    const float* hb = slots0 + r0.slot() * slot_elems;
    const float* yb = slots1 + r1.slot() * slot_elems;
    const int64_t origin = ssr_block_origin(so, g, step_of(u));
    for (int r = tid >> 5; r < rows; r += kWarps) {
      const float4 hv = *reinterpret_cast<const float4*>(hb + r * kPitch + 4 * lane);
      const float4 yv = *reinterpret_cast<const float4*>(yb + r * kPitch + 4 * lane);
      mlp_store4<V>(out + origin + static_cast<int64_t>(r) * so.pitch + 4 * lane,
                    make_float4(yv.x + hv.x, yv.y + hv.y, yv.z + hv.z,
                                yv.w + hv.w));
    }
    r0.step();
    r1.step();
  }
}

struct Args {
  const float *x, *h, *y, *w1, *b1, *w2, *b2;
  float* out;
  SsrGrid g;
  SsrStream sx, sh, sy, so;
  SsrRing ring;
  int64_t smem, steps, steps_per_tile, ctas;
  cudaStream_t st;
};

// The shared memory the instantiation takes at the ring's depths: the
// weights and mlp_ring_tiles tiles, or the residual's two rings of slots.
template <int MASK>
int64_t smem_bytes(const SsrRing& ring, int64_t rows) {
  if constexpr (MASK == kMlpResidual)
    return (ring.depth[0] + ring.depth[1]) * rows * kPitch *
           static_cast<int64_t>(sizeof(float));
  return kMlpWeightBytes + mlp_ring_tiles(ring.depth[0], rows) * kMlpTileBytes;
}

template <int MASK, int V>
int run(const Args& a) {
  const unsigned n = static_cast<unsigned>(a.ctas);
  if constexpr (MASK == kMlpResidual) {
    auto kernel = ring_dag_mlp_residual<V>;
    cudaError_t err = ssr_ring_smem(kernel, a.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<n, kThreads, a.smem, a.st>>>(a.h, a.y, a.out, a.g, a.sh, a.sy,
                                          a.so, a.steps, a.steps_per_tile,
                                          a.ring);
  } else {
    auto kernel = ring_dag_mlp_kernel<MASK, V>;
    cudaError_t err = ssr_ring_smem(kernel, a.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<n, kThreads, a.smem, a.st>>>(
        a.x, a.h, a.w1, a.b1, a.w2, a.b2, a.out, a.g, a.sx, a.sh, a.so,
        a.steps, a.steps_per_tile, static_cast<int>(a.ring.depth[0]));
  }
  return static_cast<int>(cudaGetLastError());
}

template <int MASK>
int launch(int vec, const Args& a) {
  const int64_t rows = a.so.block[0];
  for (int i = 0; i < MlpReads<MASK>::streams; ++i)
    if (a.ring.depth[i] < 2 || a.ring.depth[i] > 8)
      return static_cast<int>(cudaErrorInvalidValue);
  if (a.smem != smem_bytes<MASK>(a.ring, rows) || a.so.block[1] != kN ||
      a.steps_per_tile < 1 ||
      (MASK != kMlpResidual &&
       (rows > kMlpTile || a.steps_per_tile != kMlpTile / rows)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec == 4) return run<MASK, 4>(a);
  if (vec == 1) return run<MASK, 1>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// As ssr_dag_mlp, plus the ring of the values the subset reads in
// MlpReads' order (x or h, then y), `smem_bytes` (what the wrapper counted:
// the weights and the tiles the ring lands in, or the residual's slots;
// checked here against the layout the kernel uses) and `steps_per_tile`,
// the steps whose blocks make one tile (64 / rows but for the residual
// alone, which takes any).
extern "C" int ssr_ring_dag_mlp(const void* x, const void* h, const void* y,
                                const void* w1, const void* b1, const void* w2,
                                const void* b2, void* out, int mask, int vec,
                                const SsrGrid* g, const SsrStream* sx,
                                const SsrStream* sh, const SsrStream* sy,
                                const SsrStream* so, const SsrRing* ring,
                                int64_t smem_bytes, int64_t steps_per_tile,
                                int64_t num_ctas, void* stream) {
  Args a{static_cast<const float*>(x), static_cast<const float*>(h),
         static_cast<const float*>(y), static_cast<const float*>(w1),
         static_cast<const float*>(b1), static_cast<const float*>(w2),
         static_cast<const float*>(b2), static_cast<float*>(out), *g, *sx,
         *sh, *sy, *so, *ring, smem_bytes, 1, steps_per_tile, num_ctas,
         static_cast<cudaStream_t>(stream)};
  for (int k = 0; k < g->ndim; ++k) a.steps *= g->dims[k];
  switch (mask) {
    case 7: return launch<7>(vec, a);
    case 1: return launch<1>(vec, a);
    case 2: return launch<2>(vec, a);
    case 4: return launch<4>(vec, a);
    case 6: return launch<6>(vec, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The shared memory a CTA of the instantiation `mask` takes at the ring's
// depths `d0` (x or h) and `d1` (y, read by the residual alone) with
// step blocks of `rows` rows; -1 where the instantiation does not take them.
extern "C" int64_t ssr_ring_dag_mlp_smem_bytes(int64_t mask, int64_t d0,
                                                int64_t d1, int64_t rows) {
  const SsrRing ring{{d0, d1, 0}, {0, 0, 0}};
  if (mask == kMlpResidual) return smem_bytes<kMlpResidual>(ring, rows);
  if (mask != 7 && mask != 1 && mask != 2 && mask != 6) return -1;
  return rows > kMlpTile ? -1 : smem_bytes<7>(ring, rows);
}

// Registers a thread and local bytes (the most over the ten
// instantiations), and the fused f32 kernel's CTAs an SM at `smem` bytes
// of dynamic shared memory: out[0], out[1], out[2].
extern "C" int ssr_ring_dag_mlp_attributes(int64_t* out, int64_t smem) {
  const void* const kernels[] = {
      reinterpret_cast<const void*>(ring_dag_mlp_kernel<7, 4>),
      reinterpret_cast<const void*>(ring_dag_mlp_kernel<7, 1>),
      reinterpret_cast<const void*>(ring_dag_mlp_kernel<1, 4>),
      reinterpret_cast<const void*>(ring_dag_mlp_kernel<1, 1>),
      reinterpret_cast<const void*>(ring_dag_mlp_kernel<2, 4>),
      reinterpret_cast<const void*>(ring_dag_mlp_kernel<2, 1>),
      reinterpret_cast<const void*>(ring_dag_mlp_kernel<6, 4>),
      reinterpret_cast<const void*>(ring_dag_mlp_kernel<6, 1>),
      reinterpret_cast<const void*>(ring_dag_mlp_residual<4>),
      reinterpret_cast<const void*>(ring_dag_mlp_residual<1>)};
  out[0] = out[1] = out[2] = 0;
  for (const void* k : kernels) {
    cudaFuncAttributes fa;
    cudaError_t err = cudaFuncGetAttributes(&fa, k);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (fa.numRegs > out[0]) out[0] = fa.numRegs;
    if (static_cast<int64_t>(fa.localSizeBytes) > out[1])
      out[1] = static_cast<int64_t>(fa.localSizeBytes);
  }
  cudaError_t err = ssr_ring_smem(ring_dag_mlp_kernel<7, 4>, smem);
  int ctas = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &ctas, ring_dag_mlp_kernel<7, 4>, kThreads, smem);
  out[2] = ctas;
  return static_cast<int>(err);
}
