// K16 stream_bitonic: each row through the ascending bitonic sort network,
// dtype kept (f32, bf16, int32).
//
// Replaces the TPU kernel repro/core/ssr.py:ssr_pallas (sync emitter) as
// built by repro/kernels/frontend.py:StreamKernel._build with the body
// repro/kernels/bitonic.py:_body: grid (1,), the (1, n) block in VMEM, every
// stage unrolled: for k = 2, 4, ..., n and j = k/2, ..., 1 the pairs
// (i, i + j) with bit j of i clear are compare-exchanged, ascending where
// bit k of i is clear, by jnp.minimum and jnp.maximum.  A batch of rows is
// the reference's vmap: a grid axis over the rows.
//
// Bound on H100: operations, for the rows here.  The bytes are the row read
// once and written once; the network does n/2 compare-exchanges at each of
// log2 n (log2 n + 1) / 2 stages, a min and a max each (counted as two FP32
// operations).
//
// Design: compare-exchanges at a distance j below kTile = 8192 pair elements
// of one kTile-aligned chunk of the row, so they run in shared memory: one
// launch sorts every chunk through all stages with k <= kTile (the chunks
// alternate in direction, by the row position's bit k), and for each larger
// k one launch merges every chunk through j = kTile/2 ... 1.  A stage with
// j >= kTile is a global pass, a launch of a thread a pair.  A row of at
// most kTile elements is one launch, a CTA a row.  At n = 2^26: one chunk
// sort, 91 global passes and 13 chunk merges.
//
// Min and max are selects on the bits, never fminf/fmaxf or PTX min/max
// (which return the other operand of a NaN, and may return either zero of a
// pair): a NaN operand is both results (a's where both are NaN), so one NaN
// turns every output of the network to NaN, as the reference's does; other
// values order by a key of their bits under which -0 < +0, as jnp's
// minimum and maximum order them.
#include "ssr_common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kTileLog2 = 13;
constexpr int kTile = 1 << kTileLog2;

// The order of each element type, on its bits.
struct F32Order {
  using T = uint32_t;
  static __device__ __forceinline__ bool nan(T u) { return (u & 0x7fffffffu) > 0x7f800000u; }
  static __device__ __forceinline__ uint32_t key(T u) {
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  }
};
struct BF16Order {
  using T = uint16_t;
  static __device__ __forceinline__ bool nan(T u) { return (u & 0x7fffu) > 0x7f80u; }
  static __device__ __forceinline__ uint32_t key(T u) {
    return (u & 0x8000u) ? (~u & 0xffffu) : (u | 0x8000u);
  }
};
struct I32Order {
  using T = uint32_t;
  static __device__ __forceinline__ bool nan(T) { return false; }
  static __device__ __forceinline__ uint32_t key(T u) { return u ^ 0x80000000u; }
};

// (a, b) <- (min, max) where asc, else (max, min).
template <typename O>
__device__ __forceinline__ void exchange(typename O::T& a, typename O::T& b, bool asc) {
  using T = typename O::T;
  T lo, hi;
  if (O::nan(a)) {
    lo = hi = a;
  } else if (O::nan(b)) {
    lo = hi = b;
  } else {
    const bool lt = O::key(a) < O::key(b);
    lo = lt ? a : b;
    hi = lt ? b : a;
  }
  a = asc ? lo : hi;
  b = asc ? hi : lo;
}

// The first element of pair p at distance 2^js: p with a 0 inserted at bit js.
__device__ __forceinline__ int64_t pair_lo(int64_t p, int js) {
  return ((p >> js) << (js + 1)) | (p & ((int64_t{1} << js) - 1));
}

// One chunk of 2^len_log2 elements a CTA (the rows laid end to end, n a
// multiple of the chunk).  k == 0: every stage with k <= the chunk; else
// the stages of that k with j below the chunk.  x may be out.
template <typename O>
__global__ void __launch_bounds__(kThreads)
    sort_chunks(const typename O::T* x, typename O::T* out, int64_t n, int len_log2,
                int64_t k_fixed) {
  using T = typename O::T;
  __shared__ T sm[kTile];
  const int len = 1 << len_log2;
  const int64_t base = static_cast<int64_t>(blockIdx.x) << len_log2;
  const int64_t pos0 = base & (n - 1);     // the chunk's position in its row
  for (int e = threadIdx.x; e < len; e += kThreads) sm[e] = x[base + e];
  __syncthreads();
  auto stage = [&](int64_t k, int js) {
    for (int p = threadIdx.x; p < len / 2; p += kThreads) {
      const int lo = static_cast<int>(pair_lo(p, js));
      exchange<O>(sm[lo], sm[lo + (1 << js)], ((pos0 + lo) & k) == 0);
    }
    __syncthreads();
  };
  if (k_fixed == 0) {
    for (int ks = 1; ks <= len_log2; ++ks)
      for (int js = ks - 1; js >= 0; --js) stage(int64_t{1} << ks, js);
  } else {
    for (int js = len_log2 - 1; js >= 0; --js) stage(k_fixed, js);
  }
  for (int e = threadIdx.x; e < len; e += kThreads) out[base + e] = sm[e];
}

// One stage (k, j = 2^js) over every row in place: a thread a pair.
template <typename O>
__global__ void __launch_bounds__(kThreads)
    sort_pass(typename O::T* x, int64_t rows, int log2n, int64_t k, int js) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= rows << (log2n - 1)) return;
  const int64_t row = (idx >> (log2n - 1)) << log2n;
  const int64_t lo = pair_lo(idx & ((int64_t{1} << (log2n - 1)) - 1), js);
  typename O::T* r = x + row;
  auto a = r[lo], b = r[lo + (int64_t{1} << js)];
  exchange<O>(a, b, (lo & k) == 0);
  r[lo] = a;
  r[lo + (int64_t{1} << js)] = b;
}

template <typename O>
int launch(const void* x, void* out, int64_t rows, int64_t n, cudaStream_t st) {
  using T = typename O::T;
  int log2n = 0;
  while ((int64_t{1} << log2n) < n) ++log2n;
  if (rows <= 0 || n != (int64_t{1} << log2n)) return static_cast<int>(cudaErrorInvalidValue);
  const int len_log2 = log2n < kTileLog2 ? log2n : kTileLog2;
  const int64_t chunks = (rows * n) >> len_log2;
  const int64_t pairs = (rows * n) >> 1;
  if (chunks >= (int64_t{1} << 31) || pairs / kThreads >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  T* o = static_cast<T*>(out);
  sort_chunks<O><<<static_cast<unsigned>(chunks), kThreads, 0, st>>>(
      static_cast<const T*>(x), o, n, len_log2, 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>((pairs + kThreads - 1) / kThreads);
  for (int ks = kTileLog2 + 1; ks <= log2n; ++ks) {
    for (int js = ks - 1; js >= kTileLog2; --js) {
      sort_pass<O><<<grid, kThreads, 0, st>>>(o, rows, log2n, int64_t{1} << ks, js);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    sort_chunks<O><<<static_cast<unsigned>(chunks), kThreads, 0, st>>>(
        o, o, n, len_log2, int64_t{1} << ks);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

// x and out (rows, n), n a power of two, of one dtype (kept).  One launch
// for n <= 8192; else one chunk sort plus, for each k = 2^14 ... n, a global
// pass for each j >= 8192 and one chunk merge.
extern "C" int ssr_stream_bitonic(const void* x, void* out, int dtype, int64_t rows, int64_t n,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == SSR_F32) return launch<F32Order>(x, out, rows, n, st);
  if (dtype == SSR_BF16) return launch<BF16Order>(x, out, rows, n, st);
  if (dtype == SSR_I32) return launch<I32Order>(x, out, rows, n, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int64_t ssr_stream_bitonic_smem_bytes() {
  return static_cast<int64_t>(sizeof(uint32_t)) * kTile;
}
