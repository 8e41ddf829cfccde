// K17 chained_map: out_blk = consumer(producer(*in_blks)) for every grid step
// of a ChainedKernel's Launch.
//
// Replaces the TPU kernel repro/kernels/frontend.py:ChainedKernel._build
// (:465-524, through repro/core/ssr.py:ssr_pallas): per grid step the
// producer body's block is cast to the output dtype and written to a VMEM
// scratch block, and the consumer body (a unary block -> block post-op)
// reads it back the same step, so the intermediate never reaches HBM.  The
// programs are the tagged producer bodies of repro_torch (identity, relu,
// sq_diff, axpy, mul) under the consumers relu and identity
// (ssr_chained_map.cuh).
//
// Bound on H100: bytes.  Each input element is read once for at most three
// operations and each output written once: relu(alpha x + y) moves 12 bytes
// an f32 element against 20 for the unfused pair (read x, y; write t; read
// t; write out).
//
// Design: K2's walk over the Launch's streams.  Each CTA takes a run of
// consecutive grid steps (hopper._ctas, 64 CTAs an SM), advances an odometer
// over the grid (no division per step) and reads each stream's block through
// its own AGU programming -- an invariant stream (the repeat register) is
// the same block at every step, served by L1/L2 -- 16 bytes per access
// where the wrapper found every stream and the output aligned for it.  The
// intermediate lives in registers: the TPU kernel's scratch block exists
// only to hand the consumer a block, and every consumer either package can
// run is elementwise, so a shared-memory round trip would buy nothing.  It
// is rounded to the output dtype before the consumer; every operation is
// rounded as PyTorch rounds it (no FMA), so the output equals the plain
// version to the bit in f32 and bf16.
#include "ssr_chained_map.cuh"

namespace {

constexpr int kThreads = 256;

template <int P, int C, typename T, int V>
__global__ void __launch_bounds__(kThreads)
    chained_map_kernel(const T* __restrict__ a, const T* __restrict__ b,
                       T* __restrict__ out, float alpha, SsrGrid g,
                       SsrStream sa, SsrStream sb, SsrStream so, int64_t steps,
                       int64_t steps_per_cta) {
  using Pack = SsrPack<T, V>;
  constexpr bool kB = ssr_producer_streams<P>() == 2;
  const T al = ssr_cast<T>(alpha);
  const int64_t s0 = static_cast<int64_t>(blockIdx.x) * steps_per_cta;
  const int64_t s1 = s0 + steps_per_cta < steps ? s0 + steps_per_cta : steps;
  const int rows = static_cast<int>(so.block[0]);
  const int packs = static_cast<int>(so.block[1]) / V;
  SsrOdometer odo(g, s0);
  for (int64_t s = s0; s < s1; ++s, odo.advance(g)) {
    const T* pa = a + odo.origin(sa);
    const T* pb = kB ? b + odo.origin(sb) : nullptr;
    T* po = out + odo.origin(so);
    for (SsrBlockWalk w(threadIdx.x, kThreads, packs); w.r < rows; w.next()) {
      const int64_t col = static_cast<int64_t>(w.c) * V;
      const Pack xa = *reinterpret_cast<const Pack*>(pa + w.r * sa.pitch + col);
      Pack xb{};
      if constexpr (kB) xb = *reinterpret_cast<const Pack*>(pb + w.r * sb.pitch + col);
      Pack y;
#pragma unroll
      for (int j = 0; j < V; ++j) y.v[j] = ssr_chained_value<P, C, T>(xa.v[j], xb.v[j], al);
      *reinterpret_cast<Pack*>(po + w.r * so.pitch + col) = y;
    }
  }
}

struct Args {
  const void *a, *b;
  void* out;
  float alpha;
  SsrGrid g;
  SsrStream sa, sb, so;
  int64_t steps, ctas, per_cta;
  cudaStream_t st;
};

template <int P, int C, typename T, int V>
int launch(const Args& x) {
  chained_map_kernel<P, C, T, V><<<static_cast<unsigned>(x.ctas), kThreads, 0, x.st>>>(
      static_cast<const T*>(x.a), static_cast<const T*>(x.b), static_cast<T*>(x.out),
      x.alpha, x.g, x.sa, x.sb, x.so, x.steps, x.per_cta);
  return static_cast<int>(cudaGetLastError());
}

template <int P, int C>
struct Program {
  static int run(int dtype, int vec, const Args& x) {
    if (dtype == SSR_F32 && vec == 4) return launch<P, C, float, 4>(x);
    if (dtype == SSR_F32 && vec == 1) return launch<P, C, float, 1>(x);
    if (dtype == SSR_BF16 && vec == 8) return launch<P, C, __nv_bfloat16, 8>(x);
    if (dtype == SSR_BF16 && vec == 1) return launch<P, C, __nv_bfloat16, 1>(x);
    return static_cast<int>(cudaErrorInvalidValue);
  }
};

}  // namespace

// `prog` = producer * 2 + consumer (ssr_chained_map.cuh).  Streams a and b
// carry the producer's operands in its order (b null for a one-stream
// producer); every stream and the output hold `dtype`.  `vec` is
// 16 / sizeof(element) when every stream's and the output's pitch, block
// width and base pointer allow 16-byte accesses, else 1.
extern "C" int ssr_chained_map(int prog, const void* a, const void* b,
                               void* out, int dtype, int vec, float alpha,
                               const SsrGrid* g, const SsrStream* sa,
                               const SsrStream* sb, const SsrStream* so,
                               int64_t num_ctas, int64_t steps_per_cta,
                               void* stream) {
  Args x{a, b, out, alpha, *g, *sa, *sb, *so, 1, num_ctas, steps_per_cta,
         static_cast<cudaStream_t>(stream)};
  for (int k = 0; k < g->ndim; ++k) x.steps *= g->dims[k];
  return ssr_chained_dispatch<Program>(prog, dtype, vec, x);
}

extern "C" int64_t ssr_chained_map_smem_bytes() { return 0; }
