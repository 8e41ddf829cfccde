// B3 base_gemm: gemm's monolithic baseline.  C (m, n) = A (m, k) . B (k, n)
// over 128-wide k chunks, in an f32 accumulator cast to the output dtype
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
// Design: the same 128x128 output tile per CTA as K3, 256 threads with an
// 8x8 register accumulator each, the same shared-memory layout (A stored
// k-major and staggered, B as it is) and the same FMA loop.  What is taken
// away is what K3 added to deliver operands: B3 stages a whole 128-wide k
// chunk of A and B in ONE shared-memory buffer (130 KB, so one CTA per SM),
// then barrier, compute, barrier -- no register prefetch of the next chunk
// and no second buffer, so no load is in flight while the FMAs run.  The
// chunk's address comes from the k loop index at the point of use.  Global
// loads are 16 bytes where the wrapper found A and B f32 and aligned, as in
// K3; rows and columns past m and n read as zero and are not written.
#include "ssr_common.cuh"

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 128;
constexpr int kRound = 16;              // k rows loaded per round (K3's chunk)
constexpr int kThreads = 256;           // 16 x 16 threads, 8 x 8 outputs each
constexpr int kPadM = kBM + 4;          // staggers the transposed A stores
constexpr int kPerThread = kBM * kRound / kThreads;  // 8 values per round
constexpr int kSmemBytes =
    static_cast<int>(sizeof(float)) * kBK * (kPadM + kBN);

// Loads k rows kg .. kg + 15 of A's tile (rows m0..) and B's tile (cols
// n0..) straight into shared memory rows r0 .. r0 + 15 of the chunk.
template <typename T, int V>
__device__ __forceinline__ void load_round(const T* a, const T* b, int64_t m,
                                           int64_t n, int64_t k, int64_t m0,
                                           int64_t n0, int64_t kg, int r0,
                                           float (*As)[kPadM],
                                           float (*Bs)[kBN]) {
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
      As[r0 + kq + 0][row] = va.x;
      As[r0 + kq + 1][row] = va.y;
      As[r0 + kq + 2][row] = va.z;
      As[r0 + kq + 3][row] = va.w;
      *reinterpret_cast<float4*>(&Bs[r0 + krow][col]) = vb;
    } else {
      As[r0 + kq][row] = gr < m ? ssr_f32(a[gr * k + kg + kq]) : 0.f;
      Bs[r0 + krow][col] = gn < n ? ssr_f32(b[(kg + krow) * n + gn]) : 0.f;
    }
  }
}

template <typename T, typename O, int V>
__global__ void __launch_bounds__(kThreads)
    base_gemm_kernel(const T* __restrict__ a, const T* __restrict__ b,
                     O* __restrict__ c, int64_t m, int64_t n, int64_t k,
                     int64_t tiles_n) {
  extern __shared__ __align__(16) float smem[];
  float (*As)[kPadM] = reinterpret_cast<float (*)[kPadM]>(smem);
  float (*Bs)[kBN] = reinterpret_cast<float (*)[kBN]>(smem + kBK * kPadM);
  const int64_t m0 = (blockIdx.x / tiles_n) * kBM;
  const int64_t n0 = (blockIdx.x % tiles_n) * kBN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll 1
  for (int64_t k0 = 0; k0 < k; k0 += kBK) {
    // the explicit loads of chunk k0, waited on whole before any FMA
#pragma unroll 1
    for (int r = 0; r < kBK; r += kRound)
      load_round<T, V>(a, b, m, n, k, m0, n0, k0 + r, r, As, Bs);
    __syncthreads();
#pragma unroll 16
    for (int kk = 0; kk < kBK; ++kk) {
      float am[8], bn[8];
      *reinterpret_cast<float4*>(&am[0]) =
          *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      *reinterpret_cast<float4*>(&am[4]) =
          *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      *reinterpret_cast<float4*>(&bn[0]) =
          *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      *reinterpret_cast<float4*>(&bn[4]) =
          *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(am[i], bn[j], acc[i][j]);
    }
    __syncthreads();   // the one buffer is refilled only after every FMA
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t r = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int64_t col = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (r < m && col < n) c[r * n + col] = ssr_cast<O>(acc[i][j]);
    }
  }
}

template <typename T, typename O, int V>
int launch_v(const void* a, const void* b, void* c, int64_t m, int64_t n,
             int64_t k, cudaStream_t st) {
  auto kernel = base_gemm_kernel<T, O, V>;
  // above 48 KB a CTA's shared memory must be asked for
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
