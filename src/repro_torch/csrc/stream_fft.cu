// K15 stream_fft: the forward DFT of each row of split re/im planes, by the
// reference's radix-2 Stockham stages and twiddle tables.
//
// Replaces the TPU kernel repro/core/ssr.py:ssr_pallas (sync emitter) as
// built by repro/kernels/frontend.py:StreamKernel._build with the body
// repro/kernels/fft.py:_body: grid (1,), the (1, n) re and im blocks and the
// (log2 n, n/2) twiddle tables in VMEM, all log2 n stages unrolled.  Stage s
// (nc = n >> s, S = 2^s, m = nc / 2) takes a = x[p S + q] and
// b = x[(p + m) S + q] for p < m, q < S, and writes the even output a + b to
// y[2 p S + q] and the odd output (a - b) w_p to y[(2 p + 1) S + q].  A batch
// of rows is the reference's vmap: a grid axis over the rows.
//
// Bound on H100: bytes.  re and im read once and both outputs written once
// (16 bytes a point for f32), the twiddles once; the 5 n log2 n FP32
// operations of a transform take less time at every n here.
//
// Design: the reference's computation, not cuFFT's: the same stage order,
// pairs and twiddle tables, each product and sum rounded alone (__fmul_rn,
// __fadd_rn, __fsub_rn: no FMA contraction), so the result equals the plain
// PyTorch version to the bit.  As m S = n / 2, the butterfly b = p S + q
// reads x[b] and x[b + n/2]: contiguous reads.  A row of up to kSmemPoints =
// 8192 points runs in one CTA, every stage in shared memory between two
// ping-pong buffers (16 bytes a point, 128 KiB at 8192), a CTA a row, one
// launch for the batch.  A longer row runs each stage as a global pass, one
// launch a stage and a thread a butterfly, ping-ponging between a scratch
// pair and the output so that the last stage writes the output.
#include "ssr_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kSmemPoints = 8192;

// Even output a + b and odd output (a - b) w, every operation rounded alone.
__device__ __forceinline__ void butterfly(float ar, float ai, float br, float bi, float wr,
                                          float wi, float& er, float& ei, float& orr,
                                          float& oi) {
  er = __fadd_rn(ar, br);
  ei = __fadd_rn(ai, bi);
  const float dr = __fsub_rn(ar, br), di = __fsub_rn(ai, bi);
  orr = __fsub_rn(__fmul_rn(dr, wr), __fmul_rn(di, wi));
  oi = __fadd_rn(__fmul_rn(dr, wi), __fmul_rn(di, wr));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fft_rows(const T* __restrict__ xr, const T* __restrict__ xi, const float* __restrict__ wr,
             const float* __restrict__ wi, float* __restrict__ yr, float* __restrict__ yi,
             int n, int stages) {
  extern __shared__ __align__(16) float sm[];
  float* ar = sm;
  float* ai = sm + n;
  float* br = sm + 2 * n;
  float* bi = sm + 3 * n;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * n;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    ar[e] = ssr_f32(xr[row + e]);
    ai[e] = ssr_f32(xi[row + e]);
  }
  __syncthreads();
  const int half = n >> 1;
  for (int s = 0; s < stages; ++s) {
    const int S = 1 << s;
    const float* twr = wr + static_cast<int64_t>(s) * half;
    const float* twi = wi + static_cast<int64_t>(s) * half;
    for (int b = threadIdx.x; b < half; b += kThreads) {
      const int p = b >> s, q = b & (S - 1);
      float er, ei, orr, oi;
      butterfly(ar[b], ai[b], ar[b + half], ai[b + half], twr[p], twi[p], er, ei, orr, oi);
      const int o = (p << (s + 1)) | q;
      br[o] = er;
      bi[o] = ei;
      br[o + S] = orr;
      bi[o + S] = oi;
    }
    __syncthreads();
    float* t = ar;
    ar = br;
    br = t;
    t = ai;
    ai = bi;
    bi = t;
  }
  for (int e = threadIdx.x; e < n; e += kThreads) {
    yr[row + e] = ar[e];
    yi[row + e] = ai[e];
  }
}

// One stage over every row: a thread a butterfly.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    fft_stage(const T* __restrict__ sr, const T* __restrict__ si, const float* __restrict__ wr,
              const float* __restrict__ wi, float* __restrict__ dr, float* __restrict__ di,
              int64_t rows, int log2n, int s) {
  const int64_t half = int64_t{1} << (log2n - 1);
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= rows * half) return;
  const int64_t row = (idx >> (log2n - 1)) << log2n, b = idx & (half - 1);
  const int64_t S = int64_t{1} << s, p = b >> s, q = b & (S - 1);
  float er, ei, orr, oi;
  butterfly(ssr_f32(sr[row + b]), ssr_f32(si[row + b]), ssr_f32(sr[row + b + half]),
            ssr_f32(si[row + b + half]), wr[s * half + p], wi[s * half + p], er, ei, orr, oi);
  const int64_t o = row + ((p << (s + 1)) | q);
  dr[o] = er;
  di[o] = ei;
  dr[o + S] = orr;
  di[o + S] = oi;
}

template <typename T>
int launch(const void* xr, const void* xi, const float* wr, const float* wi, float* yr,
           float* yi, float* tr, float* ti, int64_t rows, int64_t n, int stages,
           cudaStream_t st) {
  const T* r = static_cast<const T*>(xr);
  const T* i = static_cast<const T*>(xi);
  if (rows <= 0 || n != (int64_t{1} << stages)) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= kSmemPoints) {
    if (rows >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidValue);
    const int smem = static_cast<int>(16 * n);
    cudaError_t err = cudaFuncSetAttribute(
        fft_rows<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    fft_rows<T><<<static_cast<unsigned>(rows), kThreads, smem, st>>>(
        r, i, wr, wi, yr, yi, static_cast<int>(n), stages);
    return static_cast<int>(cudaGetLastError());
  }
  if (tr == nullptr || ti == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t ctas = (rows * (n / 2) + kThreads - 1) / kThreads;
  if (ctas >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(ctas);
  for (int s = 0; s < stages; ++s) {
    // stage s writes the output when stages - 1 - s is even
    const bool to_out = (stages - 1 - s) % 2 == 0;
    float* dr = to_out ? yr : tr;
    float* di = to_out ? yi : ti;
    if (s == 0)
      fft_stage<T><<<grid, kThreads, 0, st>>>(r, i, wr, wi, dr, di, rows, stages, s);
    else
      fft_stage<float><<<grid, kThreads, 0, st>>>(to_out ? tr : yr, to_out ? ti : yi, wr, wi,
                                                  dr, di, rows, stages, s);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

// xr, xi (rows, n), n = 2^stages; wr, wi the (stages, n/2) twiddle tables;
// yr, yi (rows, n) f32; tr, ti a (rows, n) f32 scratch pair when n > 8192
// (null otherwise).  One launch, or one a stage above 8192 points.
extern "C" int ssr_stream_fft(const void* xr, const void* xi, int dtype, const void* wr,
                              const void* wi, void* yr, void* yi, void* tr, void* ti,
                              int64_t rows, int64_t n, int stages, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* w_r = static_cast<const float*>(wr);
  const float* w_i = static_cast<const float*>(wi);
  float* y_r = static_cast<float*>(yr);
  float* y_i = static_cast<float*>(yi);
  float* t_r = static_cast<float*>(tr);
  float* t_i = static_cast<float*>(ti);
  if (dtype == SSR_F32)
    return launch<float>(xr, xi, w_r, w_i, y_r, y_i, t_r, t_i, rows, n, stages, st);
  if (dtype == SSR_BF16)
    return launch<__nv_bfloat16>(xr, xi, w_r, w_i, y_r, y_i, t_r, t_i, rows, n, stages, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Shared memory of one CTA for rows of n points: the ping-pong pair in
// shared memory up to 8192 points, none for the global passes.
extern "C" int64_t ssr_stream_fft_smem_bytes(int64_t n) {
  return n <= kSmemPoints ? 16 * n : 0;
}
