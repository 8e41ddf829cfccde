// The mbarriers of the rings whose step loops meet no CTA barrier: R3
// ring_contract_gemm's producer warp and R13 ring_gather_spmv's filling
// warp fill a slot and complete its `full` barrier; the computing warps
// wait on it, read the slot and arrive on its `empty` barrier, on which the
// filling side waits before it refills the slot.  A slot's barriers
// complete one phase a fill, so a reader of fill n waits on parity n & 1
// (Slots tracks both).
#pragma once

#include "ssr_common.cuh"

namespace mbar {

// The barriers a ring of two streams keeps: full and empty for up to 8
// slots of each, 8 bytes each, whatever the depths.
constexpr int kBarrierBytes = 4 * 8 * 8;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// An mbarrier whose phase completes after `count` arrivals.
__device__ __forceinline__ void bar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Arrive on `bar` once this thread's cp.async copies so far have landed.
__device__ __forceinline__ void bar_arrive_on_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Arrive on `bar` and make its phase wait for `bytes` more of bulk copies
// (the TMA loads that complete on it).
__device__ __forceinline__ void bar_arrive_expect(uint64_t* bar,
                                                  unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Copy `bytes` (a multiple of 16; both addresses 16-byte aligned) from
// device memory to shared memory as one bulk copy that completes on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Wait until the phase of `bar` with parity `parity` has completed.
__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n"
        " .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// A ring of `depth` slots as one side walks it: the slot of its next fill
// or read, and the parity of that fill's phase.
struct Slots {
  int depth, at = 0;
  unsigned parity = 0;
  __device__ __forceinline__ explicit Slots(int64_t d)
      : depth(static_cast<int>(d)) {}
  __device__ __forceinline__ void next() {
    if (++at == depth) {
      at = 0;
      parity ^= 1u;
    }
  }
};

}  // namespace mbar
