// R3 ring_contract_gemm: K3's C_blk += A_blk . B_blk over the trailing
// contraction axes, in an f32 accumulator, its A and B chunks delivered
// through N-deep shared-memory rings that a producer warp fills.
//
// Replaces the TPU kernel repro/core/ssr.py:_pipelined_call (the N-deep
// rotation a schedule with buffer_depth > 2 emits) around the contraction
// branch of repro/core/lowering.py:_build_nest_kernel and the body
// repro/kernels/gemm.py:_body (an f32 dot_general).
//
// Bound on H100: operations, as K3 -- 2mnk FP32 multiply-adds outside the
// tensor cores (no TF32), about 67 TFLOP/s.
//
// Design: K3's CTAs (one 128x128 sub-tile of a lowered output block each)
// and K3's walk: the contraction steps in grid order and, inside each
// lowered k block, 16-wide k chunks.  A lowered step's tiles (128 x tk of
// A, tk x 128 of B) exceed shared memory, so the ring's unit is the chunk:
// the CTA's run is its zsteps x ceil(tk / 16) chunks, A and B each with a
// ring of its own depth (the reference's per-stream depths).  The CTA is
// 8 computing warps and one producer warp.  The producer alone walks the
// grid and fills the slots, as far ahead as the depths let it: slot s of
// a stream is refilled once all 8 computing warps have arrived on its
// `empty` mbarrier, and its `full` mbarrier completes once the copies have
// landed (ssr_mbarrier.cuh).  The computing warps compute no address and
// issue no copy; they wait on `full`, run the chunk's FMAs (ssr_gemm.cuh,
// K3's 8 x 8 chain a thread) and release the slot -- no CTA barrier in the
// step loop.  Two routes fill a slot, chosen by the layout:
//
// * TMA (cvec == 2: f32, base pointers and pitches in 16-byte packs, and
//   tk a multiple of 16, so that no chunk crosses the lowered block's k
//   edge): lane 0 of the producer loads A's 128 x 16 and B's 16 x 128 box
//   with cp.async.bulk.tensor on tensor maps the entry encodes, each
//   completing its slot's `full` barrier by its bytes.  A box reaching
//   past the layout is zero-filled; rows and columns past tm / tn feed
//   only outputs that are never written.
// * cp.async (bf16, or f32 on any other layout): the producer's 32 lanes
//   copy 16-byte packs where the layout allows (cvec == 1), else 4-byte
//   elements (f32) or plain loads and stores (bf16), zero-filling rows,
//   columns and k past the lowered block as K3 masks them, each lane
//   arriving on `full` once its copies have landed.
//
// A slot of A is 128 rows of 16 k, unpadded (what a TMA box lands as); the
// computing warps read it with RowsAdjacent's rows, 64 bytes (bf16: 32)
// apart across a warp, so the reads fall in other banks.  One CTA an SM:
// a thread holds 64 accumulators and 32 values of A, and the kernel takes
// 168 registers a thread with none spilled; two CTAs of 9 warps would put
// 5 warps on one of the SM's four 16,384-register files, 96 registers a
// thread, and spill (measured slower: PERF.md).  Every output keeps K3's
// chain: the same bits as K3 at every depth and by either route.
#include <cuda.h>

#include "ssr_gemm.cuh"
#include "ssr_mbarrier.cuh"
#include "ssr_ring.cuh"

namespace {

using namespace mbar;

constexpr int kBK = 16;                       // k a slot
constexpr int kALd = kBK;                     // A slot row stride: unpadded
constexpr int kConsumers = sgemm::kThreads;   // 8 computing warps
constexpr int kThreads = kConsumers + 32;     // and the producer warp

constexpr int kASlot = sgemm::kBM * kBK;      // elements of a slot
constexpr int kBSlot = kBK * sgemm::kBN;

// The producer warp's walk of one stream: the grid step and the k chunk
// its next fill copies, and its slots.
struct Fill {
  SsrOdometer at;
  int64_t kc = 0;
  Slots slots;
  __device__ __forceinline__ Fill(const SsrGrid& g, int64_t s0, int depth)
      : at(g, s0), slots(depth) {}
  __device__ __forceinline__ void next(const SsrGrid& g, int64_t kchunks) {
    slots.next();
    if (++kc == kchunks) {
      kc = 0;
      at.advance(g);
    }
  }
};

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
      "r"(smem_u32(bar))
      : "memory");
}

// One lane's share of a cp.async fill: a rows x cols tile at `src` (row
// pitch `pitch`) into `dst` (row stride `ld`), the element at (r, c)
// copied where `in(r, c)`, else zero.
template <typename T, typename In>
__device__ __forceinline__ void copy_tile(T* dst, int ld, const T* src,
                                          int64_t pitch, int rows, int cols,
                                          bool vec16, int lane, In in) {
  if (vec16) {
    constexpr int V = 16 / sizeof(T);
    for (int i = lane; i < rows * (cols / V); i += 32) {
      const int r = i / (cols / V), c = (i % (cols / V)) * V;
      const bool ok = in(r, c);
      ssr_ring_cp16(dst + r * ld + c, ok ? src + r * pitch + c : src, ok);
    }
  } else {
    for (int i = lane; i < rows * cols; i += 32) {
      const int r = i / cols, c = i % cols;
      const bool ok = in(r, c);
      const T* s = ok ? src + r * pitch + c : src;
      if constexpr (sizeof(T) == 4)
        ssr_ring_cp4(dst + r * ld + c, s, ok);
      else
        dst[r * ld + c] = ok ? *s : ssr_cast<T>(0.f);
    }
  }
}

template <typename T, typename O, bool TMA>
__global__ void __launch_bounds__(kThreads, 1)
    ring_contract_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                              const __grid_constant__ CUtensorMap map_b,
                              const T* __restrict__ a, const T* __restrict__ b,
                              O* __restrict__ c, SsrGrid g, SsrStream sa,
                              SsrStream sb, SsrStream sc, int64_t zsteps,
                              int64_t tiles_n, int64_t tiles_per_block,
                              int cvec, SsrRing ring) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int da = static_cast<int>(ring.depth[0]);
  const int db = static_cast<int>(ring.depth[1]);
  T* const a_slots = reinterpret_cast<T*>(smem);
  T* const b_slots = a_slots + da * kASlot;
  uint64_t* const bars = reinterpret_cast<uint64_t*>(b_slots + db * kBSlot);
  uint64_t* const full_a = bars;
  uint64_t* const full_b = bars + 8;
  uint64_t* const empty_a = bars + 16;
  uint64_t* const empty_b = bars + 24;
  const int64_t p = blockIdx.x / tiles_per_block;
  const int64_t t = blockIdx.x % tiles_per_block;
  const int64_t m0 = (t / tiles_n) * sgemm::kBM;
  const int64_t n0 = (t % tiles_n) * sgemm::kBN;
  const int64_t tm = sc.block[0], tn = sc.block[1], tk = sa.block[1];
  const int64_t kchunks = (tk + kBK - 1) / kBK;
  const int64_t run = zsteps * kchunks;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < da; ++i) {
      bar_init(full_a + i, TMA ? 1 : 32);
      bar_init(empty_a + i, kConsumers / 32);
    }
    for (int i = 0; i < db; ++i) {
      bar_init(full_b + i, TMA ? 1 : 32);
      bar_init(empty_b + i, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();   // the barriers are set: the steps begin

  if (threadIdx.x >= kConsumers) {   // the producer warp
    if (TMA && lane != 0) return;
    // at virtual step u, stream i fills its chunk u + depth_i - 1 into the
    // slot its readers released at step u - 1
    Fill fa(g, p * zsteps, da), fb(g, p * zsteps, db);
    const int64_t dmax = da > db ? da : db;
    for (int64_t u = 1 - dmax; u < run; ++u) {
      const int64_t qa = u + da - 1, qb = u + db - 1;
      if (qa >= 0 && qa < run) {
        Slots& s = fa.slots;
        if (qa >= da) bar_wait(empty_a + s.at, s.parity ^ 1u);
        const int64_t k0 = fa.kc * kBK;
        T* dst = a_slots + s.at * kASlot;
        if constexpr (TMA) {
          bar_arrive_expect(full_a + s.at, kASlot * sizeof(T));
          tma_load_2d(dst, &map_a,
                      static_cast<int>(fa.at.index(sa, 1) * tk + k0),
                      static_cast<int>(fa.at.index(sa, 0) * sa.block[0] + m0),
                      full_a + s.at);
        } else {
          copy_tile(dst, kALd, a + fa.at.origin(sa) + m0 * sa.pitch + k0,
                    sa.pitch, sgemm::kBM, kBK, cvec != 0, lane,
                    [&](int r, int kk) { return m0 + r < tm && k0 + kk < tk; });
          if (sizeof(T) == 4 || cvec)
            bar_arrive_on_copies(full_a + s.at);
          else
            bar_arrive(full_a + s.at);
        }
        fa.next(g, kchunks);
      }
      if (qb >= 0 && qb < run) {
        Slots& s = fb.slots;
        if (qb >= db) bar_wait(empty_b + s.at, s.parity ^ 1u);
        const int64_t k0 = fb.kc * kBK;
        T* dst = b_slots + s.at * kBSlot;
        if constexpr (TMA) {
          bar_arrive_expect(full_b + s.at, kBSlot * sizeof(T));
          tma_load_2d(dst, &map_b,
                      static_cast<int>(fb.at.index(sb, 1) * sb.block[1] + n0),
                      static_cast<int>(fb.at.index(sb, 0) * sb.block[0] + k0),
                      full_b + s.at);
        } else {
          copy_tile(dst, sgemm::kBN, b + fb.at.origin(sb) + k0 * sb.pitch + n0,
                    sb.pitch, kBK, sgemm::kBN, cvec != 0, lane,
                    [&](int kr, int col) {
                      return k0 + kr < tk && n0 + col < tn;
                    });
          if (sizeof(T) == 4 || cvec)
            bar_arrive_on_copies(full_b + s.at);
          else
            bar_arrive(full_b + s.at);
        }
        fb.next(g, kchunks);
      }
    }
    if constexpr (!TMA) asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // the computing warps
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const sgemm::RowsAdjacent rows(ty);
  float acc[8][8];
  sgemm::zero(acc);
  Slots ra(da), rb(db);
  for (int64_t u = 0; u < run; ++u) {
    bar_wait(full_a + ra.at, ra.parity);
    bar_wait(full_b + rb.at, rb.parity);
    const T* As = a_slots + ra.at * kASlot;
    const T* Bs = b_slots + rb.at * kBSlot;
    sgemm::chunk<kBK, kALd>(acc, As, Bs, rows, tx);
    __syncwarp();
    if (lane == 0) {   // the warp is past the chunk: release its slots
      bar_arrive(empty_a + ra.at);
      bar_arrive(empty_b + rb.at);
    }
    ra.next();
    rb.next();
  }

  // drain: the output block is the same for every contraction step of p
  sgemm::drain(acc, c + ssr_block_origin(sc, g, p * zsteps), sc.pitch, m0,
               n0, tm, tn, rows, tx);
}

// cuTensorMapEncodeTiled, reached through the runtime (no -lcuda).
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The rows of stream `s`'s layout that any grid step's block reaches.
int64_t layout_rows(const SsrStream& s, const SsrGrid& g) {
  int64_t top = s.offset[0];
  for (int k = 0; k < g.ndim; ++k)
    if (s.coeff[k][0] > 0) top += (g.dims[k] - 1) * s.coeff[k][0];
  return (top + 1) * s.block[0];
}

// A tensor map of an f32 layout (row pitch s.pitch) in boxes of box_cols x
// box_rows, zero-filled past the layout.
int encode(CUtensorMap* map, const void* base, const SsrStream& s,
           const SsrGrid& g, cuuint32_t box_cols, cuuint32_t box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(s.pitch),
                              static_cast<cuuint64_t>(layout_rows(s, g))};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(s.pitch) * 4};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                        const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, typename O>
int launch(int cvec, const void* a, const void* b, void* c, const SsrGrid* g,
           const SsrStream* sa, const SsrStream* sb, const SsrStream* sc,
           int64_t zsteps, int64_t ctas, int64_t tiles_n,
           int64_t tiles_per_block, const SsrRing* ring, int64_t smem,
           cudaStream_t st) {
  const int64_t da = ring->depth[0], db = ring->depth[1];
  if (da < 2 || da > 8 || db < 2 || db > 8 ||
      smem != static_cast<int64_t>(sizeof(T)) *
                      (da * kASlot + db * kBSlot) + kBarrierBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_a{}, map_b{};
  auto kernel = ring_contract_gemm_kernel<T, O, false>;
  const bool tma = cvec == 2;
  if constexpr (sizeof(T) == 4) {   // TMA's route: f32 only (the entry checks)
    if (tma) {
      int err = encode(&map_a, a, *sa, *g, kBK, sgemm::kBM);
      if (err == 0) err = encode(&map_b, b, *sb, *g, sgemm::kBN, kBK);
      if (err != 0) return err;
      kernel = ring_contract_gemm_kernel<T, O, true>;
    }
  }
  cudaError_t err = ssr_ring_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(ctas), kThreads, smem, st>>>(
      map_a, map_b, static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<O*>(c), *g, *sa, *sb, *sc, zsteps, tiles_n,
      tiles_per_block, cvec, *ring);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `cvec` picks the route: 2 for TMA (f32; A and B with base pointers,
// pitches and block widths in 16-byte packs; A's block width tk a
// multiple of 16), 1 for 16-byte cp.async packs (the same alignment, in
// either dtype), 0 for element copies; `smem_bytes` the rings and their
// barriers as the wrapper counted them, checked here.
extern "C" int ssr_ring_contract_gemm(const void* a, const void* b, void* c,
                                      int in_dtype, int out_dtype, int cvec,
                                      const SsrGrid* g, const SsrStream* sa,
                                      const SsrStream* sb, const SsrStream* sc,
                                      int64_t zsteps, const SsrRing* ring,
                                      int64_t smem_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int64_t steps = 1;
  for (int k = 0; k < g->ndim; ++k) steps *= g->dims[k];
  const int64_t tiles_m = (sc->block[0] + sgemm::kBM - 1) / sgemm::kBM;
  const int64_t tiles_n = (sc->block[1] + sgemm::kBN - 1) / sgemm::kBN;
  const int64_t per_block = tiles_m * tiles_n;
  const int64_t ctas = (steps / zsteps) * per_block;
  if (cvec == 2 && (in_dtype != SSR_F32 || sa->block[1] % kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  if (in_dtype == SSR_F32 && out_dtype == SSR_F32)
    return launch<float, float>(cvec, a, b, c, g, sa, sb, sc, zsteps, ctas,
                                tiles_n, per_block, ring, smem_bytes, st);
  if (in_dtype == SSR_F32 && out_dtype == SSR_BF16)
    return launch<float, __nv_bfloat16>(cvec, a, b, c, g, sa, sb, sc, zsteps,
                                        ctas, tiles_n, per_block, ring,
                                        smem_bytes, st);
  if (in_dtype == SSR_BF16 && out_dtype == SSR_F32)
    return launch<__nv_bfloat16, float>(cvec, a, b, c, g, sa, sb, sc, zsteps,
                                        ctas, tiles_n, per_block, ring,
                                        smem_bytes, st);
  if (in_dtype == SSR_BF16 && out_dtype == SSR_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(cvec, a, b, c, g, sa, sb, sc,
                                                zsteps, ctas, tiles_n,
                                                per_block, ring, smem_bytes,
                                                st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int64_t ssr_ring_contract_gemm_smem_bytes() { return 0; }

// The kernel's registers a thread and local (spill) bytes, the most of its
// instantiations, as cudaFuncGetAttributes reads them, and the CTAs an SM
// of the main path's (f32, TMA) at `smem` bytes of dynamic shared memory
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor): out[0] numRegs, out[1]
// localSizeBytes, out[2] CTAs an SM.
extern "C" int ssr_ring_contract_gemm_attributes(int64_t* out, int64_t smem) {
  const void* kernels[] = {
      reinterpret_cast<const void*>(ring_contract_gemm_kernel<float, float, true>),
      reinterpret_cast<const void*>(ring_contract_gemm_kernel<float, float, false>),
      reinterpret_cast<const void*>(
          ring_contract_gemm_kernel<__nv_bfloat16, float, false>)};
  out[0] = out[1] = 0;
  for (const void* k : kernels) {
    cudaFuncAttributes fa;
    cudaError_t err = cudaFuncGetAttributes(&fa, k);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (fa.numRegs > out[0]) out[0] = fa.numRegs;
    if (static_cast<int64_t>(fa.localSizeBytes) > out[1])
      out[1] = static_cast<int64_t>(fa.localSizeBytes);
  }
  auto main_path = ring_contract_gemm_kernel<float, float, true>;
  cudaError_t err = ssr_ring_smem(main_path, smem);
  int ctas = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, main_path,
                                                        kThreads, smem);
  out[2] = ctas;
  return static_cast<int>(err);
}
