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
// PyTorch version to the bit.  A row of up to kSmemPoints = 8192 points runs
// in one CTA of n / 8 threads, the stages in groups of kRadixLog2 = 3 in
// registers: a thread holds the 8 points t + c n/8 (c < 8), which differ in
// the index's top three bits.  Stage s pairs the points that differ in the
// top bit and writes them to points that differ in bit s, the bits from s
// up moving up by one, so the thread's set stays closed for three stages
// (kernels/fft.py::fft_group_outputs gives where it lands).  The row
// crosses shared memory once a group, XOR-swizzled so that the writes and
// the next group's reads hit 32 banks (kernels/fft.py::fft_exchange_word):
// at n = 2048, groups of 3 + 3 + 3 + 2 stages, 3 exchanges, the first group
// reading x and the last writing y directly.  The CTAs are persistent, as
// many as fit the card, each walking rows: a thread's loads of its next row
// are in flight while it transforms the current one, so HBM is kept busy
// through the stages and barriers.  The twiddles are read through the
// read-only cache; one buffer (8 bytes a point) leaves L1 room for the
// (log2 n, n/2) tables.  A longer row runs each stage as a global pass, one
// launch a stage and a thread a butterfly, ping-ponging between a scratch
// pair and the output so that the last stage writes the output.
#include "ssr_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kSmemPoints = 8192;
constexpr int kRadixLog2 = 3;
constexpr int kMaxDevices = 64;

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

// Shared-memory word of point pos: bits 5-7 XORed into the bank bits so
// that a warp's writes after a group starting at stage 0 or 3 and its
// reads at a group's start each hit 32 banks.
__device__ __forceinline__ int exchange_word(int pos) {
  return pos ^ ((pos >> 5) & 7) ^ ((pos >> 3) & 24);
}

__device__ __forceinline__ float load_point(const float* p) { return __ldcs(p); }
__device__ __forceinline__ float load_point(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldcs(reinterpret_cast<const unsigned short*>(p))));
}

// A row of 2^L points a CTA of 2^(L - R) threads (R = min(kRadixLog2,
// L)): thread t holds the points orig_c = t + (c << (L - R)), register c;
// after j stages of a group from s0, register c holds the point orig_c
// maps to.  L is a template parameter, so every shift and mask is a
// constant: a point's index is its thread's part OR its register's.
template <typename T, int L>
__global__ void __launch_bounds__(1024)
    fft_rows(const T* __restrict__ xr, const T* __restrict__ xi, const float* __restrict__ wr,
             const float* __restrict__ wi, float* __restrict__ yr, float* __restrict__ yi,
             int64_t rows) {
  constexpr int R = L < kRadixLog2 ? L : kRadixLog2;
  constexpr int kPts = 1 << R, kTop = L - R, kN = 1 << L, kHalf = kN >> 1;
  extern __shared__ __align__(16) float sm[];
  float* sr = sm;
  float* si = sm + kN;
  const int t = threadIdx.x;
  const int w_t = exchange_word(t);  // linear under XOR: t's part of a word
  float nr[kPts], ni[kPts];          // the next row's points, in flight
  auto fetch = [&](int64_t row) {
    if (row < rows) {
#pragma unroll
      for (int c = 0; c < kPts; ++c) {
        nr[c] = load_point(xr + row * kN + (t | (c << kTop)));
        ni[c] = load_point(xi + row * kN + (t | (c << kTop)));
      }
    }
  };
  fetch(blockIdx.x);
  for (int64_t row = blockIdx.x; row < rows; row += gridDim.x) {
    float vr[kPts], vi[kPts];
#pragma unroll
    for (int c = 0; c < kPts; ++c) vr[c] = nr[c], vi[c] = ni[c];
    fetch(row + gridDim.x);
    float* or_ = yr + row * kN;
    float* oi_ = yi + row * kN;
    if (L == 0) {
      or_[0] = vr[0];
      oi_[0] = vi[0];
      continue;
    }
#pragma unroll
    for (int s0 = 0; s0 < L; s0 += (R > 0 ? R : 1)) {
      const int g = L - s0 < R ? L - s0 : R;
      if (s0 > 0) {
#pragma unroll
        for (int c = 0; c < kPts; ++c) {
          const int w = w_t ^ exchange_word(c << kTop);
          vr[c] = sr[w];
          vi[c] = si[w];
        }
      }
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if (j >= g) break;
        const int s = s0 + j;
        const int pmask = (1 << (L - 1 - s)) - 1;
        const int p_t = (t >> s0) & pmask;
#pragma unroll
        for (int c = 0; c < kPts; ++c) {
          const int hb = 1 << (R - 1 - j);  // the register bit at the top bit
          if (c & hb) continue;
          const int p = p_t | (((c << kTop) >> s0) & pmask);
          float er, ei, orr, oi;
          butterfly(vr[c], vi[c], vr[c | hb], vi[c | hb], __ldg(wr + s * kHalf + p),
                    __ldg(wi + s * kHalf + p), er, ei, orr, oi);
          vr[c] = er;
          vi[c] = ei;
          vr[c | hb] = orr;
          vi[c | hb] = oi;
        }
      }
      // where each register's point lands: bits below s0 kept, the top g
      // bits reversed into s0 ... s0 + g - 1, bits s0 ... L - g - 1 moved
      // up by g (kernels/fft.py::fft_group_outputs)
      const bool last = s0 + g >= L;
      if (!last) __syncthreads();  // every read of the buffer done
      const int pos_t =
          (t & ((1 << s0) - 1)) | (((t >> s0) & ((1 << (L - g - s0)) - 1)) << (s0 + g));
      const int w_pos_t = exchange_word(pos_t);
#pragma unroll
      for (int c = 0; c < kPts; ++c) {
        const int oc = c << kTop;  // register c's part of orig_c
        int pos_c =
            (oc & ((1 << s0) - 1)) | (((oc >> s0) & ((1 << (L - g - s0)) - 1)) << (s0 + g));
#pragma unroll
        for (int i = 0; i < R; ++i)
          if (i < g) pos_c |= ((oc >> (L - 1 - i)) & 1) << (s0 + i);
        if (last) {
          __stcs(or_ + (pos_t | pos_c), vr[c]);
          __stcs(oi_ + (pos_t | pos_c), vi[c]);
        } else {
          const int w = w_pos_t ^ exchange_word(pos_c);
          sr[w] = vr[c];
          si[w] = vi[c];
        }
      }
      if (!last) __syncthreads();
    }
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

template <typename T, int L>
int launch_rows(const T* r, const T* i, const float* wr, const float* wi, float* yr, float* yi,
                int64_t rows, cudaStream_t st) {
  constexpr int kN = 1 << L, R = L < kRadixLog2 ? L : kRadixLog2, kCta = kN >> R;
  const int smem = 8 * kN;
  // the CTAs the device holds at once, found at a device's first launch
  static int64_t resident[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev >= kMaxDevices || resident[dev] == 0)) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(fft_rows<T, L>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fft_rows<T, L>, kCta, smem);
    if (err == cudaSuccess && dev < kMaxDevices)
      resident[dev] = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
    if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // persistent CTAs, each walking rows gridDim.x apart
  const int64_t most = resident[dev];
  const unsigned grid = static_cast<unsigned>(rows < most ? rows : most);
  fft_rows<T, L><<<grid, kCta, smem, st>>>(r, i, wr, wi, yr, yi, rows);
  return static_cast<int>(cudaGetLastError());
}

// A row of up to kSmemPoints points: one launch of fft_rows<T, stages>.
template <typename T, int L = 0>
int launch_rows_of(int stages, const T* r, const T* i, const float* wr, const float* wi,
                   float* yr, float* yi, int64_t rows, cudaStream_t st) {
  if constexpr ((int64_t{1} << L) > kSmemPoints) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (stages == L) return launch_rows<T, L>(r, i, wr, wi, yr, yi, rows, st);
    return launch_rows_of<T, L + 1>(stages, r, i, wr, wi, yr, yi, rows, st);
  }
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
    return launch_rows_of<T>(stages, r, i, wr, wi, yr, yi, rows, st);
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

// Shared memory of one CTA for rows of n points: one re/im buffer in
// shared memory up to 8192 points, none for the global passes.
extern "C" int64_t ssr_stream_fft_smem_bytes(int64_t n) {
  return n <= kSmemPoints ? 8 * n : 0;
}
