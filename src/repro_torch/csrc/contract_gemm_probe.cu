// K3's registers, local bytes and CTAs an SM as the runtime reads them, for
// the card's report beside R3's and B3's (chip_smoke.py phase 1): K3's own
// source, unchanged, built once more with one entry added.  Launches
// nothing.
#include "contract_gemm.cu"

// The main path's kernel (f32, 16-byte loads): out[0] its registers a
// thread, out[1] its local (spill) bytes (cudaFuncGetAttributes), out[2]
// its CTAs an SM at its static shared memory
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor); `smem` is not read.
extern "C" int ssr_contract_gemm_attributes(int64_t* out, int64_t) {
  auto kernel = contract_gemm_kernel<float, float, 4>;
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  int ctas = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel,
                                                        kThreads, 0);
  out[0] = fa.numRegs;
  out[1] = static_cast<int64_t>(fa.localSizeBytes);
  out[2] = ctas;
  return static_cast<int>(err);
}
