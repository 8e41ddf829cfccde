// B3 base_gemm: gemm's monolithic baseline.  C (m, n) = A (m, k) . B (k, n)
// over 64-wide k chunks, in an f32 accumulator cast to the output dtype
// once at the end.  k is a multiple of 128 (the wrapper's layouts are the
// reference's: k zero-padded to it).
//
// Replaces the TPU kernel repro/kernels/frontend.py:MonolithicKernel._build
// with the body repro/kernels/gemm.py:_baseline_body: one grid step whose
// body walks k with a fori_loop, each step an explicit dynamic-slice load of
// A[:, kc] and B[kc, :] and a dot_general that waits on them -- compute
// stalls behind each load, with no run-ahead.
//
// Bound on H100: operations.  2mnk multiply-adds in FP32 outside the tensor
// cores, never TF32, the same bound as K3 (contract_gemm.cu).
//
// Design: the baseline's contract, kept inside each CTA: the computing
// threads themselves load every element of a k chunk of A and B with plain
// loads into ONE shared-memory buffer (in rounds of 16 k, A stored k-major
// as K3 stages it), a barrier waits on all of them before any FMA of the
// chunk, and a second barrier after the chunk's last FMA comes before any
// load of the next -- no load in flight while the CTA's FMAs run, no second
// buffer, no producer.  The FMAs and the drain are ssr_gemm.cuh's core on
// the k-major buffer (K3's 128x128 tile and reads, 256 threads with an 8x8
// accumulator each, fmaf over k in order: K3's bits).  What changed is
// what the card penalised: the chunk is 64 k wide, not 128, so the buffer
// (66,560 bytes) leaves room for two CTAs an SM, and __launch_bounds__(256,
// 2) holds the registers to 128 for them; the SM then runs one CTA's FMAs
// while the other waits on its loads -- the card's own multithreading, as
// the paper runs the baseline on each core of its cluster, not run-ahead in
// the code.  (A 32-wide chunk and A stored row-major, read along k as R3
// reads its slots, measured slower: PERF.md.)  Global loads are 16 bytes
// where the wrapper found A and B f32 and aligned; rows and columns past m
// and n read as zero and are not written.
#include "ssr_gemm.cuh"

namespace {

using sgemm::kBM;
using sgemm::kBN;

constexpr int kBK = 64;                 // k a chunk
constexpr int kRound = 16;              // k rows loaded per round
constexpr int kThreads = sgemm::kThreads;
constexpr int kPadM = kBM + 4;          // staggers the transposed A stores
constexpr int kPerThread = kBM * kRound / kThreads;  // 8 values per round
constexpr int kSmemBytes =
    static_cast<int>(sizeof(float)) * kBK * (kPadM + kBN);

// Loads k rows kg .. kg + 15 of A's tile (rows m0..) and B's tile (cols
// n0..) straight into shared memory rows r0 .. r0 + 15 of the chunk: A
// transposed to k-major, B as it is.
template <typename T, int V>
__device__ __forceinline__ void load_round(const T* a, const T* b, int64_t m,
                                           int64_t n, int64_t k, int64_t m0,
                                           int64_t n0, int64_t kg, int r0,
                                           float* As, float* Bs) {
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < kPerThread / V; ++i) {
    // A: V consecutive k of one row, stored transposed
    const int row = t / (kRound / V) + i * (kThreads * V / kRound);
    const int kq = (t % (kRound / V)) * V;
    const int64_t gr = m0 + row;
    // B: V consecutive columns of one k row
    const int krow = t / (kBN / V) + i * (kThreads * V / kBN);
    const int col = (t % (kBN / V)) * V;
    const int64_t gn = n0 + col;
    if constexpr (V == 4) {
      float4 va = make_float4(0.f, 0.f, 0.f, 0.f), vb = va;
      if (gr < m) va = *reinterpret_cast<const float4*>(a + gr * k + kg + kq);
      if (gn < n)
        vb = *reinterpret_cast<const float4*>(b + (kg + krow) * n + gn);
      As[(r0 + kq + 0) * kPadM + row] = va.x;
      As[(r0 + kq + 1) * kPadM + row] = va.y;
      As[(r0 + kq + 2) * kPadM + row] = va.z;
      As[(r0 + kq + 3) * kPadM + row] = va.w;
      *reinterpret_cast<float4*>(Bs + (r0 + krow) * kBN + col) = vb;
    } else {
      As[(r0 + kq) * kPadM + row] = gr < m ? ssr_f32(a[gr * k + kg + kq]) : 0.f;
      Bs[(r0 + krow) * kBN + col] =
          gn < n ? ssr_f32(b[(kg + krow) * n + gn]) : 0.f;
    }
  }
}

template <typename T, typename O, int V>
__global__ void __launch_bounds__(kThreads, 2)
    base_gemm_kernel(const T* __restrict__ a, const T* __restrict__ b,
                     O* __restrict__ c, int64_t m, int64_t n, int64_t k,
                     int64_t tiles_n) {
  extern __shared__ __align__(16) float smem[];
  float* const As = smem;                  // kBK rows of the 128 tile rows
  float* const Bs = smem + kBK * kPadM;    // kBK rows of the 128 columns
  const int64_t m0 = (blockIdx.x / tiles_n) * kBM;
  const int64_t n0 = (blockIdx.x % tiles_n) * kBN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float acc[8][8];
  sgemm::zero(acc);
#pragma unroll 1
  for (int64_t k0 = 0; k0 < k; k0 += kBK) {
    // the explicit loads of chunk k0, waited on whole before any FMA
#pragma unroll 1
    for (int r = 0; r < kBK; r += kRound)
      load_round<T, V>(a, b, m, n, k, m0, n0, k0 + r, r, As, Bs);
    __syncthreads();
    sgemm::chunk_kmajor<kBK, kPadM>(acc, As, Bs, ty, tx);
    __syncthreads();   // the one buffer is refilled only after every FMA
  }
  sgemm::drain(acc, c, n, m0, n0, m, n, sgemm::RowsK3(ty), tx);
}

template <typename T, typename O, int V>
int launch_v(const void* a, const void* b, void* c, int64_t m, int64_t n,
             int64_t k, cudaStream_t st) {
  auto kernel = base_gemm_kernel<T, O, V>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tiles_n = (n + kBN - 1) / kBN;
  const int64_t ctas = ((m + kBM - 1) / kBM) * tiles_n;
  kernel<<<static_cast<unsigned>(ctas), kThreads, kSmemBytes, st>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<O*>(c),
      m, n, k, tiles_n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename O>
int launch(int vec, const void* a, const void* b, void* c, int64_t m,
           int64_t n, int64_t k, cudaStream_t st) {
  if constexpr (sizeof(T) == 4) {  // 16-byte loads: f32 operands only
    if (vec == 4) return launch_v<T, O, 4>(a, b, c, m, n, k, st);
  }
  if (vec != 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_v<T, O, 1>(a, b, c, m, n, k, st);
}

}  // namespace

// A (m, k), B (k, n) and C (m, n) are row-major; k is a multiple of 128.
// `vec` is 4 when A and B are f32 with 16-byte aligned rows, else 1.
extern "C" int ssr_base_gemm(const void* a, const void* b, void* c,
                             int in_dtype, int out_dtype, int vec, int64_t m,
                             int64_t n, int64_t k, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k % kBK) return static_cast<int>(cudaErrorInvalidValue);
  if (in_dtype == SSR_F32 && out_dtype == SSR_F32)
    return launch<float, float>(vec, a, b, c, m, n, k, st);
  if (in_dtype == SSR_F32 && out_dtype == SSR_BF16)
    return launch<float, __nv_bfloat16>(vec, a, b, c, m, n, k, st);
  if (in_dtype == SSR_BF16 && out_dtype == SSR_F32)
    return launch<__nv_bfloat16, float>(vec, a, b, c, m, n, k, st);
  if (in_dtype == SSR_BF16 && out_dtype == SSR_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(vec, a, b, c, m, n, k, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int64_t ssr_base_gemm_smem_bytes() { return kSmemBytes; }

// The main path's kernel (f32, 16-byte loads): out[0] its registers a
// thread, out[1] its local (spill) bytes (cudaFuncGetAttributes), out[2]
// its CTAs an SM at its shared memory
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor); `smem` is not read.
extern "C" int ssr_base_gemm_attributes(int64_t* out, int64_t) {
  auto kernel = base_gemm_kernel<float, float, 4>;
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  int ctas = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel,
                                                        kThreads, kSmemBytes);
  out[0] = fa.numRegs;
  out[1] = static_cast<int64_t>(fa.localSizeBytes);
  out[2] = ctas;
  return static_cast<int>(err);
}
