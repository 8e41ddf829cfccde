// B8 base_scan: scan's monolithic baseline.  The inclusive prefix sum of a
// padded vector, in f32.
//
// Replaces the TPU kernel repro/kernels/frontend.py:MonolithicKernel._build
// with the body repro/kernels/scan.py:_baseline_body: one grid step whose
// body walks the (8, 128) blocks with a fori_loop, loading block i by an
// explicit dynamic slice, storing cumsum(block) + carry and adding the
// block's total to the carry, a register.
//
// Bound on H100: bytes, the same as K14 (stream_scan.cu).
//
// Design: the meaning of the baseline, not its single grid step.  B8 runs on
// K14's CTAs and tiles (4096 elements: four (8, 128) blocks a CTA) and with
// K14's second pass over the tiles' totals, so the pair's times compare how
// operands are delivered.  Inside its tile a CTA walks the blocks in order,
// the carry in a register: per block each thread makes one explicit 16-byte
// load of its four elements, from an address computed from the block index
// at the point of use, and uses it at once (its four prefix sums, a CTA scan
// of the thread sums, the carry).  The block loop is not unrolled, so no
// load of block i + 1 is in flight while block i computes.  The first launch
// walks the tile without writing to give its total, the second is
// ssr_exclusive_offsets (ssr_common.cuh), the third walks the tile again
// from its offset and writes.  Fixed orders, no atomics: the same result
// every run.
#include "ssr_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlock = 8 * 128;                 // elements of one block
constexpr int kPer = kBlock / kThreads;         // 4: one load a thread
constexpr int kTile = 4096;                     // K14's tile
constexpr int kBlocks = kTile / kBlock;         // 4

// One tile's block walk from `carry`; with WRITE the prefix sums go to out,
// without it the tile's total to totals.
template <typename T, bool WRITE>
__global__ void __launch_bounds__(kThreads)
    walk_tile(const T* __restrict__ x, int64_t n, float* __restrict__ totals,
              float* __restrict__ out) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  float carry = WRITE ? totals[blockIdx.x] : 0.f;
#pragma unroll 1
  for (int b = 0; b < kBlocks; ++b) {
    const int64_t blk = base + static_cast<int64_t>(b) * kBlock;
    if (blk >= n) break;                            // the same in every thread
    const int64_t e = blk + kPer * threadIdx.x;     // the explicit load's address
    const float4 v = ssr_load4_f32(x + e);
    const float s0 = v.x, s1 = s0 + v.y, s2 = s1 + v.z, s3 = s2 + v.w;
    float total;
    const float excl = ssr_cta_exclusive_scan<kThreads>(s3, &total);
    if (WRITE)
      *reinterpret_cast<float4*>(out + e) = make_float4(
          carry + (excl + s0), carry + (excl + s1), carry + (excl + s2), carry + (excl + s3));
    carry += total;
  }
  if (!WRITE && threadIdx.x == 0) totals[blockIdx.x] = carry;
}

template <typename T>
int launch(const void* x, float* out, float* totals, int64_t n, int64_t tiles,
           cudaStream_t st) {
  if (tiles <= 0 || tiles >= (int64_t{1} << 31) || n > tiles * kTile || n % kBlock)
    return static_cast<int>(cudaErrorInvalidValue);
  const T* xp = static_cast<const T*>(x);
  const unsigned grid = static_cast<unsigned>(tiles);
  walk_tile<T, false><<<grid, kThreads, 0, st>>>(xp, n, totals, nullptr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssr_exclusive_offsets<kThreads><<<1, kThreads, 0, st>>>(totals, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  walk_tile<T, true><<<grid, kThreads, 0, st>>>(xp, n, totals, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x holds n elements (the padded (rows, 128) layout, n a multiple of 1024),
// 16-byte aligned; out the n f32 prefix sums; totals `tiles` = ceil(n /
// 4096) floats of scratch.  Three launches.
extern "C" int ssr_base_scan(const void* x, int dtype, void* out, void* totals, int64_t n,
                             int64_t tiles, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  float* t = static_cast<float*>(totals);
  if (dtype == SSR_F32) return launch<float>(x, o, t, n, tiles, st);
  if (dtype == SSR_BF16) return launch<__nv_bfloat16>(x, o, t, n, tiles, st);
  if (dtype == SSR_I32) return launch<int32_t>(x, o, t, n, tiles, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int64_t ssr_base_scan_smem_bytes() {
  return static_cast<int64_t>(sizeof(float)) * (kThreads / 32);
}
