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
// Design.  K8 already takes 198,656 bytes of shared memory a CTA: W1 and W2
// staged once (2 x 64 KiB) and one 128-row tile on a 132-float pitch
// (67,584).  That leaves 33,792 bytes under the 232,448 a CTA may opt into
// -- no room for a ring of whole tiles at any depth.  So the ring's unit is
// the grid step's block (rows x 128, 4,224 bytes on the tile's pitch at the
// default 8 rows: eight slots fit exactly), and the ring feeds K8's tile:
//
// * A tile is `steps_per_tile` = 128 / rows consecutive steps (fewer at the
//   grid's end); the wrapper gives the tiles to CTAs as K8 does (CTA b takes
//   tiles b, b + CTAs, ..., one CTA an SM).  A CTA's run is the sequence of
//   its tiles' steps, and the ring runs over that sequence: each stream
//   fetches depth - 1 steps ahead, across the end of a tile, so the next
//   tile's first blocks land while the CTA multiplies.
// * At each step every thread copies its part of the step's slot into the
//   tile's rows (shared memory to shared memory: 4 KiB a step, against 4.2
//   MFMA a tile); at the tile's last step the CTA runs
//   ssr_dag.cuh::mlp_tile -- K8's products, the same sequential-in-k FMA
//   chain for every output -- and writes the tile's rows as K8 does.  The
//   weights (the uniforms: invariant streams, whose one slot is this
//   staging) and biases are read once a CTA while the ring primes.  The
//   same bits as K8 at every depth.
// * The residual alone ({2}) stages nothing: it reads H and Y through two
//   rings (a fetching group of four warps each) and adds them, one warp a
//   row, on the same tiles.
//
// The wrapper counts the ring plus the staged bytes against the opt-in
// budget (hopper.MLP_STAGED_BYTES) and refuses a schedule over it, as
// accepts() does.
#include "ssr_dag.cuh"
#include "ssr_ring.cuh"

namespace {

constexpr int kThreads = kMlpThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kN = kMlpN, kTile = kMlpTile, kPitch = kMlpPitch;

template <int MASK, int V>
__global__ void __launch_bounds__(kThreads, 1)
    ring_dag_mlp_kernel(const float* __restrict__ x,
                        const float* __restrict__ h_in,
                        const float* __restrict__ y_in,
                        const float* __restrict__ w1,
                        const float* __restrict__ b1,
                        const float* __restrict__ w2,
                        const float* __restrict__ b2, float* __restrict__ out,
                        SsrGrid g, SsrStream sx, SsrStream sh, SsrStream sy,
                        SsrStream so, int64_t steps, int64_t steps_per_tile,
                        SsrRing ring) {
  using R = MlpReads<MASK>;
  constexpr bool kH = (MASK & kMlpHidden) != 0, kY = (MASK & kMlpOut) != 0;
  constexpr bool kTiled = MASK != kMlpResidual;
  constexpr int kStreams = R::streams;
  extern __shared__ __align__(16) float smem[];
  float* const W1s = smem;
  float* const W2s = smem + kN * kN;
  float* const T = smem + 2 * kN * kN;
  const int rows = static_cast<int>(so.block[0]);
  const int slot_elems = rows * kPitch;
  float* const slots0 = kTiled ? T + kTile * kPitch : smem;
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

  const SsrRingGroup grp(kStreams);
  const int mine = grp.stream;
  SsrRingSide side(ring, mine);
  SsrRingSide r0(ring, 0), r1(ring, kStreams > 1 ? 1 : 0);
  int64_t dmax = r0.depth > 2 ? r0.depth : 2;
  if (r1.depth > dmax) dmax = r1.depth;
  const float* first = R::x ? x : h_in;
  const SsrStream& sfirst = R::x ? sx : sh;
  int64_t fetched = 0;  // run steps this thread's stream has fetched
  auto fetch = [&](int slot) {
    const int64_t step = step_of(fetched++);
    const float* src = mine == 0 ? first + ssr_block_origin(sfirst, g, step)
                                 : y_in + ssr_block_origin(sy, g, step);
    const int64_t pitch = mine == 0 ? sfirst.pitch : sy.pitch;
    ssr_ring_copy<float>((mine == 0 ? slots0 : slots1) + slot * slot_elems,
                         kPitch, src, pitch, rows, kN, V > 1, grp.lane,
                         grp.size);
  };

  for (int64_t u = 1 - dmax; u < 0; ++u) side.issue(u, 1 - dmax, run, fetch);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int c0 = 4 * tx, c1 = 64 + 4 * tx;
  float bv[8], b1v[8];
  if constexpr (kTiled) {   // the uniforms, while the ring primes
    if constexpr (kH) mlp_stage_weight<V>(W1s, w1);
    if constexpr (kY) mlp_stage_weight<V>(W2s, w2);
    mlp_bias<V>(kY ? b2 : b1, c0, c1, bv);
    if constexpr (kH && kY) mlp_bias<V>(b1, c0, c1, b1v);
  }
  float acc[8][8];
  for (int64_t u = 0; u < run; ++u) {
    side.wait();
    __syncthreads();  // the step's slots (and the weights) are visible
    side.issue(u, 1 - dmax, run, fetch);
    const int64_t within = u % spt, step = step_of(u);
    const float* b0 = slots0 + r0.slot() * slot_elems;
    if constexpr (kTiled) {
      float* dst = T + within * rows * kPitch;
      for (int i = tid; i < rows * (kN / 4); i += kThreads) {
        const int at = i / (kN / 4) * kPitch + i % (kN / 4) * 4;
        *reinterpret_cast<float4*>(dst + at) =
            *reinterpret_cast<const float4*>(b0 + at);
      }
      if (within == spt - 1 || step == steps - 1) {
        __syncthreads();  // the tile is whole
        mlp_tile<MASK>(T, W1s, W2s, ty, c0, c1, bv, b1v, acc);
        const int64_t t0 = step - within;   // the tile's first step
        const int valid = static_cast<int>(within + 1) * rows;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int row = ty + 16 * i;
          if (row >= valid) continue;
          mlp_store_row<V>(out + ssr_block_origin(so, g, t0 + row / rows) +
                               static_cast<int64_t>(row % rows) * so.pitch,
                           c0, c1, acc[i]);
        }
      }
    } else {
      const float* b1s = slots1 + r1.slot() * slot_elems;
      const int lane = tid & 31;
      const int64_t origin = ssr_block_origin(so, g, step);
      for (int r = tid >> 5; r < rows; r += kWarps) {
        const float4 hv = *reinterpret_cast<const float4*>(b0 + r * kPitch + 4 * lane);
        const float4 yv = *reinterpret_cast<const float4*>(b1s + r * kPitch + 4 * lane);
        mlp_store4<V>(out + origin + static_cast<int64_t>(r) * so.pitch + 4 * lane,
                      make_float4(yv.x + hv.x, yv.y + hv.y, yv.z + hv.z,
                                  yv.w + hv.w));
      }
    }
    r0.step();
    if (kStreams > 1) r1.step();
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

template <int MASK, int V>
int run(const Args& a) {
  auto kernel = ring_dag_mlp_kernel<MASK, V>;
  cudaError_t err = ssr_ring_smem(kernel, a.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(a.ctas), kThreads, a.smem, a.st>>>(
      a.x, a.h, a.y, a.w1, a.b1, a.w2, a.b2, a.out, a.g, a.sx, a.sh, a.sy,
      a.so, a.steps, a.steps_per_tile, a.ring);
  return static_cast<int>(cudaGetLastError());
}

template <int MASK>
int launch(int vec, const Args& a) {
  const int64_t rows = a.so.block[0];
  int64_t need = 0;
  for (int i = 0; i < MlpReads<MASK>::streams; ++i) need += a.ring.depth[i];
  need *= rows * kPitch * static_cast<int64_t>(sizeof(float));
  if (MASK != kMlpResidual) need += kMlpStagedBytes;
  if (a.smem < need || a.so.block[1] != kN || a.steps_per_tile < 1 ||
      (MASK != kMlpResidual && a.steps_per_tile * rows > kTile))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec == 4) return run<MASK, 4>(a);
  if (vec == 1) return run<MASK, 1>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// As ssr_dag_mlp, plus the ring of the values the subset reads in
// MlpReads' order (x or h, then y; a slot is one step's block on the
// tile's 132-float pitch), `smem_bytes` (the ring and, but for the
// residual alone, the staged weights and tile, as the wrapper counted
// them; checked here against the layout the kernel uses) and
// `steps_per_tile`, the steps whose blocks make one tile.
extern "C" int ssr_ring_dag_mlp(int mask, const void* x, const void* h,
                                const void* y, const void* w1, const void* b1,
                                const void* w2, const void* b2, void* out,
                                int vec, const SsrGrid* g,
                                const SsrStream* sx, const SsrStream* sh,
                                const SsrStream* sy, const SsrStream* so,
                                const SsrRing* ring, int64_t smem_bytes,
                                int64_t steps_per_tile, int64_t num_ctas,
                                void* stream) {
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

extern "C" int64_t ssr_ring_dag_mlp_smem_bytes() { return 0; }
