// B8 base_scan: scan's monolithic baseline.  The inclusive prefix sum of a
// padded vector, in f32.
//
// Replaces the TPU kernel repro/kernels/frontend.py:MonolithicKernel._build
// with the body repro/kernels/scan.py:_baseline_body: one grid step whose
// body walks the (8, 128) blocks with a fori_loop, loading block i by an
// explicit dynamic slice, storing cumsum(block) + carry and adding the
// block's total to the carry, a register.
//
// Bound on H100: bytes, the same as K14 (stream_scan.cu): x read once and
// y written once.  B8 reads x once.
//
// Design: the meaning of the baseline, not its single grid step.  B8 runs
// on K14's tiles (4096 elements: four (8, 128) blocks) and finds each
// tile's offset by K14's look-back (ssr_scan.cuh, WordsPolled), so the
// pair's times compare how operands are delivered: K14 lands a tile in
// shared memory by one bulk copy a tile ahead of its sums; B8's computing
// threads load each block themselves.  Per block each thread makes one
// explicit 16-byte load of its four elements (8 bytes in bf16), from an
// address computed from the block index at the point of use, and uses it
// at once: its four prefix sums, a CTA scan of the thread sums.  The block
// loop is not unrolled, so no load of block i + 1 is in flight while block
// i computes; no slot, no filling warp, no cp.async, TMA or bulk copy.  A
// thread keeps its four blocks' sums (excl + s_i) and the blocks' totals
// in registers (20 floats) until the tile's offset comes, then makes its
// own 16-byte stores.  x is read and the sums written with evict-first
// hints (ld/st.global.cs): each is touched once.  One memset of the call's
// state (scan::state_words), then one launch: persistent CTAs, as many as
// fit the card at once, take tiles by ticket in increasing order, one at a
// time; each publishes its tile's total before it waits on anything, and
// every wait is on an earlier tile, so every tile finishes
// (hopper.base_scan_schedule_model).
//
// With no tile summed ahead, a tile's offset waits for the slowest of the
// tiles in flight before it (it needs every earlier total), so occupancy
// hides the waits: measured on an H100 (tools/scan_gemv_ablation.py) the
// pass took 0.298 ms at 5 CTAs an SM, of which the waits 0.086, and 0.252
// at 8.  So the look-back's words are loaded only once the tile is summed
// (no registers held across the block walk: 32 a thread, 8 CTAs an SM),
// and a waiting thread pauses 128 ns between polls.
//
// The bits are those of the three-launch B8 this kernel replaces (a pass
// for the tiles' totals, the fixed second pass over them, the tiles'
// scans from their offsets; hopper.base_scan_model): a tile's total is
// 0.f plus its blocks' totals in order, its offset the second pass's,
// and each output carry + (excl + s_i), the carry plus each block's total
// after it.  Nothing is atomic but the ticket: the same bits every run.
#include "ssr_scan.cuh"

namespace {

constexpr int kThreads = scan::kThreads;        // 256
constexpr int kBlock = 8 * 128;                 // elements of one block
constexpr int kPer = kBlock / kThreads;         // 4: one load a thread
constexpr int kTile = scan::kTile;              // K14's tile
constexpr int kBlocks = kTile / kBlock;         // 4
constexpr int kMinCtas = 8;   // CTAs an SM: 32 registers a thread
constexpr int kPauseNs = 128; // between polls of a look-back word

// Four consecutive elements of x as floats by one explicit load of 16
// bytes (8 in bf16), read once: ld.global.cs, evict-first in L1 and L2;
// converted as ssr_load4_f32 converts them (bf16 exactly, int32 to
// nearest).
__device__ __forceinline__ float4 load4_first(const float* p) {
  return __ldcs(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4_first(const __nv_bfloat16* p) {
  const uint2 u = __ldcs(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ float4 load4_first(const int32_t* p) {
  const int4 v = __ldcs(reinterpret_cast<const int4*>(p));
  return make_float4(__int2float_rn(v.x), __int2float_rn(v.y),
                     __int2float_rn(v.z), __int2float_rn(v.w));
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinCtas)
    base_scan_tiles(const T* __restrict__ x, int64_t n, float* __restrict__ out,
                    uint64_t* __restrict__ words, int64_t tiles) {
  __shared__ float gv[scan::kGroup];
  __shared__ float sh[4];
  __shared__ int ticket;
  const scan::WordsPolled<kPauseNs> w(words, tiles);
  unsigned long long* const counter = w.counter(tiles);
  const int t = threadIdx.x;
  for (;;) {
    if (t == 0) {
      const unsigned long long next = atomicAdd(counter, 1ull);
      ticket = next < static_cast<unsigned long long>(tiles)
                   ? static_cast<int>(next) : -1;
    }
    scan::sync_compute();
    const int tile = ticket;          // read by all before the next barrier
    if (tile < 0) break;              // the same in every thread
    const int64_t base = static_cast<int64_t>(tile) * kTile;
    // the walked blocks' sums and totals, the latest last: each block
    // shifts the earlier ones down one (constant indices: registers)
    float4 sums[kBlocks];
    float totals[kBlocks];
    float run = 0.f;                  // the tile's total
    int walked = 0;
#pragma unroll 1
    for (int b = 0; b < kBlocks; ++b) {
      const int64_t blk = base + static_cast<int64_t>(b) * kBlock;
      if (blk >= n) break;                            // the same in every thread
      const float4 v = load4_first(x + blk + kPer * t);   // the explicit load
      const float s0 = v.x, s1 = s0 + v.y, s2 = s1 + v.z, s3 = s2 + v.w;
      float total;
      const float excl =
          ssr_cta_exclusive_scan<kThreads, scan::kBar>(s3, &total);
#pragma unroll
      for (int k = 0; k + 1 < kBlocks; ++k) {
        sums[k] = sums[k + 1];
        totals[k] = totals[k + 1];
      }
      sums[kBlocks - 1] = make_float4(excl + s0, excl + s1, excl + s2, excl + s3);
      totals[kBlocks - 1] = total;
      run += total;
      ++walked;
    }
    // a short last tile: on down until its first block sits in sums[0]
#pragma unroll 1
    for (int b = walked; b < kBlocks; ++b) {
#pragma unroll
      for (int k = 0; k + 1 < kBlocks; ++k) {
        sums[k] = sums[k + 1];
        totals[k] = totals[k + 1];
      }
    }
    if (t == 0) scan::publish(w.tile + tile, run);
    w.close(tile, run, gv, sh);
    // the offset's words loaded only now: no registers held for them
    float carry = w.offset(w.issue(tile), tile, gv, sh);
#pragma unroll
    for (int k = 0; k < kBlocks; ++k) {
      if (k >= walked) break;
      __stcs(reinterpret_cast<float4*>(out + base + k * kBlock + kPer * t),
             make_float4(carry + sums[k].x, carry + sums[k].y,
                         carry + sums[k].z, carry + sums[k].w));
      carry += totals[k];
    }
  }
}

template <typename T>
int launch(const void* x, float* out, void* words, int64_t n, int64_t tiles,
           int64_t nwords, cudaStream_t st) {
  if (tiles <= 0 || tiles >= (int64_t{1} << 31) || n > tiles * kTile ||
      n <= (tiles - 1) * kTile || n % kBlock || nwords != scan::state_words(tiles))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, base_scan_tiles<T>, kThreads, 0);
  if (err == cudaSuccess && per_sm < 1) err = cudaErrorInvalidConfiguration;
  if (err == cudaSuccess)
    err = cudaMemsetAsync(words, 0, nwords * sizeof(uint64_t), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  // as many CTAs as fit the card at once (tickets hand out the tiles)
  const int64_t fit = int64_t{per_sm} * sms;
  const unsigned grid = static_cast<unsigned>(tiles < fit ? tiles : fit);
  base_scan_tiles<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), n, out, static_cast<uint64_t*>(words), tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x holds n elements (the padded (rows, 128) layout, n a multiple of 1024),
// 16-byte aligned; out the n f32 prefix sums; `words` the call's state,
// `nwords` 64-bit words (ssr_base_scan_state_words), zeroed here.  One
// memset and one launch.
extern "C" int ssr_base_scan(const void* x, int dtype, void* out, void* words,
                             int64_t n, int64_t tiles, int64_t nwords,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (dtype == SSR_F32) return launch<float>(x, o, words, n, tiles, nwords, st);
  if (dtype == SSR_BF16)
    return launch<__nv_bfloat16>(x, o, words, n, tiles, nwords, st);
  if (dtype == SSR_I32) return launch<int32_t>(x, o, words, n, tiles, nwords, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The kernel's static shared memory: the CTA scan's warp sums, a group's
// totals, the offset's scratch and the ticket.
extern "C" int64_t ssr_base_scan_smem_bytes() {
  return static_cast<int64_t>(sizeof(float)) *
             (kThreads / 32 + scan::kGroup + 4) + sizeof(int);
}

extern "C" int64_t ssr_base_scan_state_words(int64_t tiles) {
  return scan::state_words(tiles);
}

// Registers a thread and local bytes (the most over the three dtypes'
// instantiations) and the f32 kernel's CTAs an SM: out[0], out[1], out[2].
extern "C" int ssr_base_scan_attributes(int64_t* out) {
  const void* const kernels[] = {
      reinterpret_cast<const void*>(base_scan_tiles<float>),
      reinterpret_cast<const void*>(base_scan_tiles<__nv_bfloat16>),
      reinterpret_cast<const void*>(base_scan_tiles<int32_t>)};
  out[0] = out[1] = out[2] = 0;
  for (const void* k : kernels) {
    cudaFuncAttributes fa;
    cudaError_t err = cudaFuncGetAttributes(&fa, k);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (fa.numRegs > out[0]) out[0] = fa.numRegs;
    if (static_cast<int64_t>(fa.localSizeBytes) > out[1])
      out[1] = static_cast<int64_t>(fa.localSizeBytes);
  }
  int ctas = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &ctas, base_scan_tiles<float>, kThreads, 0);
  out[2] = ctas;
  return static_cast<int>(err);
}
