// K2 map_relu: out_blk = max(0, x_blk) for every grid step, dtype kept.
//
// Replaces the TPU kernel repro/core/ssr.py:ssr_pallas (sync emitter) with
// the map epilogue of repro/core/lowering.py:_assemble_kernel and the body
// repro/kernels/relu.py:relu_block: one read stream in, one dense row-major
// write stream out, every grid axis `parallel`.
//
// Bound on H100: bytes -- one read and one write per element, no reuse.
//
// Design: each CTA takes a run of consecutive grid steps (row blocks),
// advances an odometer over the grid (no division per step), reads each
// block through the input stream's AGU programming and writes it through
// the output stream's (the dense out_map), 16 bytes per access where the
// wrapper found the layouts aligned for it.  The result is bit-exact with
// the reference for every dtype: the value is selected, never computed, so
// int32 above 2^24 stays exact; NaN passes through and -0.0 becomes +0.0,
// as jnp.maximum(x, 0) does.
#include "ssr_common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    map_relu_kernel(const T* __restrict__ x, T* __restrict__ out, SsrGrid g,
                    SsrStream sx, SsrStream so, int64_t steps,
                    int64_t steps_per_cta) {
  using Pack = SsrPack<T, V>;
  const int64_t s0 = static_cast<int64_t>(blockIdx.x) * steps_per_cta;
  const int64_t s1 = s0 + steps_per_cta < steps ? s0 + steps_per_cta : steps;
  const int rows = static_cast<int>(sx.block[0]);
  const int packs = static_cast<int>(sx.block[1]) / V;
  SsrOdometer odo(g, s0);
  for (int64_t s = s0; s < s1; ++s, odo.advance(g)) {
    const T* px = x + odo.origin(sx);
    T* po = out + odo.origin(so);
    for (SsrBlockWalk w(threadIdx.x, kThreads, packs); w.r < rows; w.next()) {
      Pack p = *reinterpret_cast<const Pack*>(
          px + static_cast<int64_t>(w.r) * sx.pitch + w.c * V);
#pragma unroll
      for (int j = 0; j < V; ++j) p.v[j] = ssr_relu(p.v[j]);
      *reinterpret_cast<Pack*>(po + static_cast<int64_t>(w.r) * so.pitch +
                               w.c * V) = p;
    }
  }
}

template <typename T, int V>
void launch(const void* x, void* out, const SsrGrid* g, const SsrStream* sx,
            const SsrStream* so, int64_t steps, int64_t num_ctas,
            int64_t steps_per_cta, cudaStream_t st) {
  map_relu_kernel<T, V><<<static_cast<unsigned>(num_ctas), kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<T*>(out), *g, *sx, *so, steps,
      steps_per_cta);
}

}  // namespace

// `vec` is 16 / sizeof(element) when both streams' pitch, block width and
// base pointer allow 16-byte accesses, else 1.
extern "C" int ssr_map_relu(const void* x, void* out, int dtype, int vec,
                            const SsrGrid* g, const SsrStream* sx,
                            const SsrStream* so, int64_t num_ctas,
                            int64_t steps_per_cta, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int64_t steps = 1;
  for (int k = 0; k < g->ndim; ++k) steps *= g->dims[k];
  const int64_t n = num_ctas, per = steps_per_cta;
  if (dtype == SSR_F32 && vec == 4)
    launch<float, 4>(x, out, g, sx, so, steps, n, per, st);
  else if (dtype == SSR_F32 && vec == 1)
    launch<float, 1>(x, out, g, sx, so, steps, n, per, st);
  else if (dtype == SSR_BF16 && vec == 8)
    launch<__nv_bfloat16, 8>(x, out, g, sx, so, steps, n, per, st);
  else if (dtype == SSR_BF16 && vec == 1)
    launch<__nv_bfloat16, 1>(x, out, g, sx, so, steps, n, per, st);
  else if (dtype == SSR_I32 && vec == 4)
    launch<int32_t, 4>(x, out, g, sx, so, steps, n, per, st);
  else if (dtype == SSR_I32 && vec == 1)
    launch<int32_t, 1>(x, out, g, sx, so, steps, n, per, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int64_t ssr_map_relu_smem_bytes() { return 0; }
