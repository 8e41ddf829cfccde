// K3 contract_gemm: C_blk += A_blk . B_blk over the trailing contraction
// axes, in an f32 accumulator, cast to the output dtype on the drain.
//
// Replaces the TPU kernel repro/core/ssr.py:ssr_pallas (sync emitter) with
// the contraction branch of repro/core/lowering.py:_build_nest_kernel and the
// body repro/kernels/gemm.py:_body (an f32 dot_general).  At 4096^3 the
// default lowering gives grid (16, 8, 8) with blocks A 256x512, B 512x512 and
// C 256x512 held in VMEM.
//
// Bound on H100: operations.  2mnk multiply-adds at FP32 outside the tensor
// cores (no TF32: the reference asks dot_general for f32), about 67 TFLOP/s.
//
// Design: the lowered C block (512 KiB in f32) and B block (1 MiB) fit
// neither one CTA's 227 KB of shared memory nor its registers, so each
// lowered output block is covered by several CTAs, each owning a 128x128
// sub-tile with its accumulator in registers (ssr_gemm.cuh's core, shared
// with R3 and B3: 8x8 outputs a thread, K3's fmaf chain over k in order).
// Each CTA walks the contraction steps in grid order and, inside each
// lowered k block, 32-wide k chunks through two shared-memory buffers:
// while one chunk feeds the FMAs, the next is delivered into the other
// buffer -- B by cp.async straight into shared memory, A through
// registers in two rounds of 16 k, each round's loads issued before the
// FMAs of one half of the current chunk and stored after them, transposed
// to k-major (a thread's 8 rows at one k are two 16-byte reads for the
// FMA core).  One CTA barrier a chunk shows the delivered chunk to every
// thread and frees the buffer read before it.  Copies move 16-byte packs
// where the wrapper found the layouts aligned (the route `packs`), else
// one element each: f32 by 4-byte cp.async (`words`), bf16 by plain loads
// and stores (`elements`).  Rows and columns past the lowered block read
// as zero and feed only outputs that are never written.  k past it reads
// as zero too, and chains fmaf(+0, +0, acc) up to the end of the chunk:
// that leaves every sum as it is but -0 (a sum whose products underflowed
// to -0), which it turns to +0.  R3's 16-wide chunks chain the same
// masked k, but where tk is an odd multiple of 16 K3's last chunk has 16
// that R3's does not: there, and only on a sum at -0, the two can differ
// in sign.  (Skipping such a round cost the main instantiation 8 bytes of
// spills.)
//
// What this changes from K3's first design (a 16-wide chunk of A and B
// staged in 16 registers, a barrier every 16 k, 128 registers with none to
// spare): a barrier every 32 k; B's copies hold no register; A's staged
// round takes 8; and with the step loop's two rounds unrolled (the
// prologue's kept rolled) the compiler schedules them within 128 registers,
// none spilled -- each of those choices measured against the others (PERF.md
// §6). Two buffers of 32 k (66,560 bytes in f32) leave room for two CTAs an
// SM, and __launch_bounds__(256, 2) holds a thread to 128 registers for them
// on the `packs` route. Every address comes from the streams' AGU
// programming.
#include "ssr_gemm.cuh"
#include "ssr_ring.cuh"

namespace {

using sgemm::kBM;
using sgemm::kBN;

constexpr int kBK = 32;                 // k a chunk
constexpr int kRound = 16;              // k a round of A's staged loads
constexpr int kThreads = sgemm::kThreads;
constexpr int kPadM = kBM + 4;          // a k row of A: staggers the stores

// How a chunk's copies move (the wrapper's `route`).
enum Route { kElements = 0, kWords = 1, kPacks = 2 };

// One buffer: A k-major as f32 (kBK rows of kPadM), then B as kBK rows of
// 128 elements.
template <typename T>
struct Buffer {
  static constexpr int a_bytes = kBK * kPadM * 4;
  static constexpr int bytes = a_bytes + kBK * kBN * sizeof(T);
};

// Elements a copy or load of `route`.
template <typename T, int ROUTE>
__host__ __device__ constexpr int vec() {
  return ROUTE == kPacks ? 16 / sizeof(T) : 1;
}

// Start the copies of B's chunk at `src` (row pitch `ld`; its rows from
// `krows` and columns from `cols` on zero-filled) into `Bs`: cp.async of
// V elements a copy, consecutive threads on consecutive copies, or plain
// loads and stores for `elements`.
template <typename T, int ROUTE>
__device__ __forceinline__ void fill_b(T* Bs, const T* src, int64_t ld,
                                       int krows, int cols) {
  constexpr int V = vec<T, ROUTE>();
  constexpr int kRow = kBN / V;
#pragma unroll
  for (int i = 0; i < kBK * kRow / kThreads; ++i) {
    const int q = threadIdx.x + i * kThreads;
    const int r = q / kRow, c = (q % kRow) * V;
    const bool in = r < krows && c < cols;
    const T* s = in ? src + r * ld + c : src;
    if constexpr (ROUTE == kPacks)
      ssr_ring_cp16(Bs + r * kBN + c, s, in);
    else if constexpr (ROUTE == kWords)
      ssr_ring_cp4(Bs + r * kBN + c, s, in);
    else
      Bs[r * kBN + c] = in ? *s : ssr_cast<T>(0.f);
  }
  if constexpr (ROUTE != kElements) ssr_cp_async_commit();
}

// A's staged round: rows 0..127, k k0 .. k0 + 15 of the tile, as f32, V
// elements a load (8 a thread).
template <typename T, int ROUTE>
__device__ __forceinline__ void load_round(float (&ra)[8], const T* pa,
                                           int64_t lda, int k0, int rows,
                                           int tk) {
  constexpr int V = vec<T, ROUTE>();
  constexpr int kRow = kRound / V;
#pragma unroll
  for (int i = 0; i < 8 / V; ++i) {
    const int q = threadIdx.x + i * kThreads;
    const int r = q / kRow, kq = (q % kRow) * V;
    const bool in = r < rows && k0 + kq < tk;
    const T* s = pa + r * lda + k0 + kq;
    if constexpr (V == 1) {
      ra[i] = in ? ssr_f32(*s) : 0.f;
    } else if constexpr (sizeof(T) == 4) {   // f32: one float4
      const float4 v = in ? *reinterpret_cast<const float4*>(s)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
      ra[i * 4 + 0] = v.x; ra[i * 4 + 1] = v.y;
      ra[i * 4 + 2] = v.z; ra[i * 4 + 3] = v.w;
    } else {                                  // bf16: four words
      const uint4 u = in ? *reinterpret_cast<const uint4*>(s)
                         : make_uint4(0u, 0u, 0u, 0u);
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ra[i * 8 + 2 * j] = __uint_as_float(w[j] << 16);
        ra[i * 8 + 2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
      }
    }
  }
}

// Store the staged round, transposed to k-major, at k rows r0.. of As.
template <typename T, int ROUTE>
__device__ __forceinline__ void store_round(float* As, const float (&ra)[8],
                                            int r0) {
  constexpr int V = vec<T, ROUTE>();
  constexpr int kRow = kRound / V;
#pragma unroll
  for (int i = 0; i < 8 / V; ++i) {
    const int q = threadIdx.x + i * kThreads;
    const int r = q / kRow, kq = (q % kRow) * V;
#pragma unroll
    for (int j = 0; j < V; ++j) As[(r0 + kq + j) * kPadM + r] = ra[i * V + j];
  }
}

// Two CTAs an SM on 16-byte packs; one on the other routes, whose scalar
// loads and copies would not fit 128 registers a thread without spilling.
template <typename T, typename O, int ROUTE>
__global__ void __launch_bounds__(kThreads, ROUTE == kPacks ? 2 : 1)
    contract_gemm_kernel(const T* __restrict__ a, const T* __restrict__ b,
                         O* __restrict__ c, SsrGrid g, SsrStream sa,
                         SsrStream sb, SsrStream sc, int64_t zsteps,
                         int64_t tiles_n, int64_t tiles_per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  using Buf = Buffer<T>;
  const int64_t p = blockIdx.x / tiles_per_block;
  const int64_t t = blockIdx.x % tiles_per_block;
  const int64_t m0 = (t / tiles_n) * kBM;
  const int64_t n0 = (t % tiles_n) * kBN;
  const int64_t tm = sc.block[0], tn = sc.block[1];
  // the wrapper holds every block under 2**31 elements: 32-bit bookkeeping
  const int tk = static_cast<int>(sa.block[1]);
  const int rows = static_cast<int>(tm - m0), cols = static_cast<int>(tn - n0);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float acc[8][8];
  sgemm::zero(acc);

  // the contraction steps of output block p, each walked in kchunks chunks;
  // a step's block origins are computed where the walk reaches it
  const int kchunks = (tk + kBK - 1) / kBK;
  const int total = static_cast<int>(zsteps) * kchunks;
  const int64_t step0 = p * zsteps;
  const T* pa = a + ssr_block_origin(sa, g, step0) + m0 * sa.pitch;
  const T* pb = b + ssr_block_origin(sb, g, step0) + n0;
  int z = 0, kc = 0;
  float ra[8];
#pragma unroll 1
  for (int r = 0; r < kBK / kRound; ++r) {
    load_round<T, ROUTE>(ra, pa, sa.pitch, r * kRound, rows, tk);
    store_round<T, ROUTE>(reinterpret_cast<float*>(smem), ra, r * kRound);
  }
  fill_b<T, ROUTE>(reinterpret_cast<T*>(smem + Buf::a_bytes), pb, sb.pitch,
                   tk, cols);
  for (int ch = 0; ch < total; ++ch) {
    unsigned char* const cur = smem + (ch & 1) * Buf::bytes;
    unsigned char* const nxt = smem + ((ch & 1) ^ 1) * Buf::bytes;
    const bool more = ch + 1 < total;
    ssr_cp_async_wait<0>();
    __syncthreads();   // chunk ch has landed; chunk ch - 1's buffer is free
    if (more) {        // B's next chunk flies while ch computes
      if (++kc == kchunks) {
        kc = 0;
        ++z;
        pa = a + ssr_block_origin(sa, g, step0 + z) + m0 * sa.pitch;
        pb = b + ssr_block_origin(sb, g, step0 + z) + n0;
      }
      fill_b<T, ROUTE>(reinterpret_cast<T*>(nxt + Buf::a_bytes),
                       pb + kc * kBK * sb.pitch, sb.pitch, tk - kc * kBK,
                       cols);
    }
    const float* const As = reinterpret_cast<const float*>(cur);
    const T* const Bs = reinterpret_cast<const T*>(cur + Buf::a_bytes);
#pragma unroll
    for (int r = 0; r < kBK / kRound; ++r) {   // and A's, a round a half
      if (more)
        load_round<T, ROUTE>(ra, pa, sa.pitch, kc * kBK + r * kRound, rows,
                             tk);
      sgemm::chunk_kmajor<kRound, kPadM>(acc, As + r * kRound * kPadM,
                                         Bs + r * kRound * kBN, ty, tx);
      if (more)
        store_round<T, ROUTE>(reinterpret_cast<float*>(nxt), ra,
                              r * kRound);
    }
  }

  // drain: the output block is the same for every contraction step of p
  sgemm::drain(acc, c + ssr_block_origin(sc, g, p * zsteps), sc.pitch, m0,
               n0, tm, tn, sgemm::RowsK3(ty), tx);
}

template <typename T, typename O, int ROUTE>
int launch_route(const void* a, const void* b, void* c, const SsrGrid* g,
                 const SsrStream* sa, const SsrStream* sb,
                 const SsrStream* sc, int64_t zsteps, int64_t ctas,
                 int64_t tiles_n, int64_t tiles_per_block, cudaStream_t st) {
  auto kernel = contract_gemm_kernel<T, O, ROUTE>;
  cudaError_t err = ssr_ring_smem(kernel, Buffer<T>::bytes * 2);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(ctas), kThreads, Buffer<T>::bytes * 2,
           st>>>(static_cast<const T*>(a), static_cast<const T*>(b),
                 static_cast<O*>(c), *g, *sa, *sb, *sc, zsteps, tiles_n,
                 tiles_per_block);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename O>
int launch(int route, const void* a, const void* b, void* c,
           const SsrGrid* g, const SsrStream* sa, const SsrStream* sb,
           const SsrStream* sc, int64_t zsteps, int64_t ctas,
           int64_t tiles_n, int64_t tiles_per_block, cudaStream_t st) {
  // off the packs, f32 moves by words and bf16 by elements
  constexpr int kOff = sizeof(T) == 4 ? kWords : kElements;
  if (route == kPacks)
    return launch_route<T, O, kPacks>(a, b, c, g, sa, sb, sc, zsteps, ctas,
                                      tiles_n, tiles_per_block, st);
  if (route == kOff)
    return launch_route<T, O, kOff>(a, b, c, g, sa, sb, sc, zsteps, ctas,
                                    tiles_n, tiles_per_block, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, typename O, int ROUTE>
const void* instance() {
  return reinterpret_cast<const void*>(contract_gemm_kernel<T, O, ROUTE>);
}

}  // namespace

// `route` is how a chunk reaches shared memory, as the wrapper found the
// layouts (hopper.contract_gemm_route): 2 (`packs`) where A and B have
// base pointers, pitches and block widths in 16-byte packs, else 1
// (`words`) in f32 and 0 (`elements`) in bf16.
extern "C" int ssr_contract_gemm(const void* a, const void* b, void* c,
                                 int in_dtype, int out_dtype, int route,
                                 const SsrGrid* g, const SsrStream* sa,
                                 const SsrStream* sb, const SsrStream* sc,
                                 int64_t zsteps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int64_t steps = 1;
  for (int k = 0; k < g->ndim; ++k) steps *= g->dims[k];
  const int64_t tiles_m = (sc->block[0] + kBM - 1) / kBM;
  const int64_t tiles_n = (sc->block[1] + kBN - 1) / kBN;
  const int64_t per_block = tiles_m * tiles_n;
  const int64_t ctas = (steps / zsteps) * per_block;
  if (in_dtype == SSR_F32 && out_dtype == SSR_F32)
    return launch<float, float>(route, a, b, c, g, sa, sb, sc, zsteps, ctas,
                                tiles_n, per_block, st);
  if (in_dtype == SSR_F32 && out_dtype == SSR_BF16)
    return launch<float, __nv_bfloat16>(route, a, b, c, g, sa, sb, sc,
                                        zsteps, ctas, tiles_n, per_block, st);
  if (in_dtype == SSR_BF16 && out_dtype == SSR_F32)
    return launch<__nv_bfloat16, float>(route, a, b, c, g, sa, sb, sc,
                                        zsteps, ctas, tiles_n, per_block, st);
  if (in_dtype == SSR_BF16 && out_dtype == SSR_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(route, a, b, c, g, sa, sb,
                                                sc, zsteps, ctas, tiles_n,
                                                per_block, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The dynamic shared memory a CTA takes at input dtype `in_dtype`: its two
// buffers.
extern "C" int64_t ssr_contract_gemm_smem_bytes(int in_dtype) {
  return 2 * static_cast<int64_t>(in_dtype == SSR_BF16
                                      ? Buffer<__nv_bfloat16>::bytes
                                      : Buffer<float>::bytes);
}

// The main path's instantiation (f32, 16-byte packs): its registers a
// thread (out[0], cudaFuncGetAttributes) and its CTAs an SM at its shared
// memory (out[2], cudaOccupancyMaxActiveBlocksPerMultiprocessor); out[1]
// the local (spill) bytes a thread, the most of all eight instantiations;
// `smem` is not read.
extern "C" int ssr_contract_gemm_attributes(int64_t* out, int64_t) {
  using bf16 = __nv_bfloat16;
  const void* kernels[] = {
      instance<float, float, kPacks>(), instance<float, float, kWords>(),
      instance<float, bf16, kPacks>(),  instance<float, bf16, kWords>(),
      instance<bf16, float, kPacks>(),  instance<bf16, float, kElements>(),
      instance<bf16, bf16, kPacks>(),   instance<bf16, bf16, kElements>()};
  out[1] = 0;
  for (const void* k : kernels) {
    cudaFuncAttributes fa;
    cudaError_t err = cudaFuncGetAttributes(&fa, k);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (k == kernels[0]) out[0] = fa.numRegs;
    if (static_cast<int64_t>(fa.localSizeBytes) > out[1])
      out[1] = static_cast<int64_t>(fa.localSizeBytes);
  }
  auto main_path = contract_gemm_kernel<float, float, kPacks>;
  const int64_t smem = 2 * Buffer<float>::bytes;
  cudaError_t err = ssr_ring_smem(main_path, smem);
  int ctas = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, main_path,
                                                        kThreads, smem);
  out[2] = ctas;
  return static_cast<int>(err);
}
