// K14 stream_scan: the inclusive prefix sum of a padded vector, in f32.
//
// Replaces the TPU kernel repro/core/ssr.py:ssr_pallas (sync emitter) as
// built by repro/kernels/frontend.py:StreamKernel._build with the body
// repro/kernels/scan.py:_ssr_body: grid n/1024 over the (8, 128) blocks of
// the padded vector, the axis `arbitrary`, out = cumsum(block) + carry with
// the running total carried from step to step in a VMEM scratch register.
//
// Bound on H100: bytes.  x read once and y written once (8 bytes an element
// for f32 in and out) against one add an element.  This kernel reads x
// twice: 12 bytes an element for f32, 1.5x the bound's bytes.
//
// Design: CTAs run concurrently, so no carry passes from one CTA to the next
// (ROADMAP, "Grid semantics"); a deterministic second pass combines the
// tiles instead -- reduce, then scan, three launches:
//   1. tile_totals: each CTA stages a tile of kTile = 4096 elements in
//      shared memory (four 16-byte loads a thread, all issued before its
//      stores), each thread sums its 16 consecutive elements in order, and a
//      fixed-order CTA scan of the thread sums gives the tile's total;
//   2. ssr_exclusive_offsets (ssr_common.cuh): one CTA turns the totals into
//      the tiles' offsets, in order;
//   3. tile_scan: each CTA stages its tile again, each thread adds its 16
//      elements in order from its exclusive offset in the tile, plus the
//      tile's offset, and the tile leaves through shared memory as 16-byte
//      stores.
// Every sum is taken in a fixed order and nothing is atomic, so the result
// is the same every run; a decoupled look-back, which adds whichever
// predecessors' totals happen to be ready, would not be.  The association
// differs from the reference's (1024-element cumsums plus a sequential
// carry): both are f32 prefix sums within rounding of the exact one.
#include "ssr_scan.cuh"

namespace {

using namespace scan;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    tile_totals(const T* __restrict__ x, int64_t n, float* __restrict__ totals) {
  __shared__ float sm[kWords];
  stage(x, static_cast<int64_t>(blockIdx.x) * kTile, n, sm);
  const float total = tile_total(sm);
  if (threadIdx.x == 0) totals[blockIdx.x] = total;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    tile_scan_kernel(const T* __restrict__ x, int64_t n,
                     const float* __restrict__ offsets, float* __restrict__ out) {
  __shared__ float sm[kWords];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  stage(x, base, n, sm);
  tile_scan(sm, offsets[blockIdx.x], sm);
  __syncthreads();
  store_tile(sm, out, base, n);
}

template <typename T>
int launch(const void* x, float* out, float* totals, int64_t n, int64_t tiles,
           cudaStream_t st) {
  if (tiles <= 0 || tiles >= (int64_t{1} << 31) || n > tiles * kTile || n % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const T* xp = static_cast<const T*>(x);
  const unsigned grid = static_cast<unsigned>(tiles);
  tile_totals<T><<<grid, kThreads, 0, st>>>(xp, n, totals);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssr_exclusive_offsets<kThreads><<<1, kThreads, 0, st>>>(totals, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  tile_scan_kernel<T><<<grid, kThreads, 0, st>>>(xp, n, totals, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x holds n elements (the padded (rows, 128) layout, n a multiple of 1024),
// 16-byte aligned; out the n f32 prefix sums; totals `tiles` = ceil(n /
// 4096) floats of scratch.  Three launches.
extern "C" int ssr_stream_scan(const void* x, int dtype, void* out, void* totals, int64_t n,
                               int64_t tiles, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  float* t = static_cast<float*>(totals);
  if (dtype == SSR_F32) return launch<float>(x, o, t, n, tiles, st);
  if (dtype == SSR_BF16) return launch<__nv_bfloat16>(x, o, t, n, tiles, st);
  if (dtype == SSR_I32) return launch<int32_t>(x, o, t, n, tiles, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int64_t ssr_stream_scan_smem_bytes() {
  return static_cast<int64_t>(sizeof(float)) * (kWords + kThreads / 32);
}
