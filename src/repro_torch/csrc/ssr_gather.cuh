// The gathers' per-row arithmetic, shared by K12 gather_spmv and K13
// gather_spmm and their ring kernels R13 ring_gather_spmv and R14
// ring_gather_spmm, so that a row's sums run in the same order, on the same
// values, whichever kernel delivers its vals and cidx.
//
// A row's vals and cidx arrive through a pointer: global memory (the sync
// kernels: read through the read-only path) or a shared-memory ring slot
// (the rings), chosen by kGlobal.  The table is always gathered from global
// memory, through L2 and the read-only path, at 64-bit addresses clipped
// into it as the reference clips them.  Only the positions j < ncols of a
// row hold data; the lowering's pad lanes past them are never read.
#pragma once

#include "ssr_common.cuh"

namespace gather {

// K12's and R13's CTA: a group of kSpmvGroup threads a row, kSpmvRows rows.
constexpr int kThreads = 256;
constexpr int kSpmvGroup = 4;                          // threads per ELL row
constexpr int kSpmvRows = kThreads / kSpmvGroup;       // 64
constexpr int kSpmvPer = 4;                            // entries a thread holds
// K13's and R14's CTA: a warp a row, eight rows; a lane holds four
// consecutive columns of a kSpmmCols-wide chunk of the c tile.
constexpr int kSpmmRows = kThreads / 32;
constexpr int kSpmmCols = 128;
constexpr int kSpmmBatch = 4;     // entries gathered before FMAs (R14's)

template <bool kGlobal, typename T>
__device__ __forceinline__ T load(const T* p) {
  if constexpr (kGlobal)
    return __ldg(p);
  else
    return *p;
}

__device__ __forceinline__ int64_t clip(int64_t a, int64_t elems) {
  return a < 0 ? 0 : (a >= elems ? elems - 1 : a);
}

// K12's share of one step of a row for thread t (0 .. kSpmvGroup - 1) of
// its group: entry j on thread j mod 4, kPer of them (vals and addresses)
// loaded before their kPer gathers, then fmaf in order of j into acc --
// the same order, so the same bits, whatever kPer (R13 takes eight where
// its CTAs an SM are three or fewer).
template <bool kGlobal, int kPer = kSpmvPer>
__device__ __forceinline__ float spmv_row(const float* pv, const int32_t* pc,
                                          int64_t ncols, int t,
                                          const float* __restrict__ table,
                                          int64_t scale, int64_t offset,
                                          int64_t table_elems, float acc) {
  for (int64_t j0 = t; j0 < ncols; j0 += kSpmvGroup * kPer) {
    float v[kPer];
    int64_t a[kPer];
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int64_t j = j0 + q * kSpmvGroup;
      v[q] = 0.f;
      a[q] = 0;
      if (j < ncols) {
        v[q] = load<kGlobal>(pv + j);
        a[q] = clip(static_cast<int64_t>(load<kGlobal>(pc + j)) * scale + offset,
                    table_elems);
      }
    }
#pragma unroll
    for (int q = 0; q < kPer; ++q)
      if (j0 + q * kSpmvGroup < ncols) acc = fmaf(v[q], __ldg(table + a[q]), acc);
  }
  return acc;
}

// The group's fold of its four sums (every lane of the warp takes part).
__device__ __forceinline__ float spmv_fold(float acc) {
#pragma unroll
  for (int o = kSpmvGroup / 2; o > 0; o >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, o, kSpmvGroup);
  return acc;
}

// K13's one step of a row, for lane `lane` of the row's warp: the warp
// loads 32 entries of vals and cidx at once, then for each entry
// broadcasts cidx by a shuffle and gathers the lane's four columns of the
// table's segment at scale * cidx + base as one 16-byte load (base: the
// offset, the affine level's address and the lane's columns).  kBatch
// entries' gathers are issued before their FMAs, each entry's value
// broadcast as its FMAs take it, so a gather in flight holds only its four
// floats; the FMAs run in the order of the entries whatever kBatch (K13
// takes 8, R14 4: the same bits).  The warp's 32 lanes read 128
// consecutive columns, so whether an entry's segments all lie in the table
// is one test on lane 0's start, clipped into the table first so that the
// load needs no branch; only a group with an entry past the table's ends
// re-reads it element by element, clipped as the reference clips.  Every
// lane of the warp calls it with the same ncols.
template <bool kGlobal, int kBatch = kSpmmBatch>
__device__ __forceinline__ void spmm_row(const float* pv, const int32_t* pc,
                                         int64_t ncols, int lane,
                                         const float* __restrict__ table,
                                         int64_t scale, int64_t base,
                                         int64_t table_elems, float4& acc) {
  const int64_t base0 = base - 4 * lane;          // lane 0's columns
  const int64_t last0 = table_elems - 4 * 32;     // lane 0's last start inside
  const float* const lane_table = table + 4 * lane;
  const int nc = static_cast<int>(ncols);  // a row's positions: under 2**31
  // rolled loops: one batch's gathers in registers at a time
#pragma unroll 1
  for (int j0 = 0; j0 < nc; j0 += 32) {
    float v = 0.f;
    int c = 0;
    if (j0 + lane < nc) {
      v = load<kGlobal>(pv + j0 + lane);
      c = load<kGlobal>(pc + j0 + lane);
    }
    const int cnt = nc - j0 < 32 ? nc - j0 : 32;
#pragma unroll 1
    for (int q0 = 0; q0 < cnt; q0 += kBatch) {
      float4 xv[kBatch];
      bool outside = false;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {   // past cnt: entry q0, not used
        const int q = q0 + u < cnt ? q0 + u : q0;
        const int64_t a0 =
            static_cast<int64_t>(__shfl_sync(0xffffffffu, c, q)) * scale + base0;
        const int64_t s0 = a0 < 0 ? 0 : (a0 > last0 ? last0 : a0);
        outside |= s0 != a0;
        xv[u] = __ldg(reinterpret_cast<const float4*>(lane_table + s0));
      }
      if (outside) {                       // the same on every lane
        int cc = c;
        asm volatile("" : "+r"(cc));       // shuffled anew, not kept live
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int q = q0 + u < cnt ? q0 + u : q0;
          const int64_t a =
              static_cast<int64_t>(__shfl_sync(0xffffffffu, cc, q)) * scale +
              base;
          xv[u] = make_float4(__ldg(table + clip(a, table_elems)),
                              __ldg(table + clip(a + 1, table_elems)),
                              __ldg(table + clip(a + 2, table_elems)),
                              __ldg(table + clip(a + 3, table_elems)));
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (q0 + u < cnt) {
          const float vq = __shfl_sync(0xffffffffu, v, q0 + u);
          acc.x = fmaf(vq, xv[u].x, acc.x);
          acc.y = fmaf(vq, xv[u].y, acc.y);
          acc.z = fmaf(vq, xv[u].z, acc.z);
          acc.w = fmaf(vq, xv[u].w, acc.w);
        }
      }
    }
  }
}

// The odometer at `step`, unflattened in 32-bit arithmetic (K12's and
// K13's entries hold the grid under 2**31 steps).
__device__ __forceinline__ SsrOdometer odometer32(const SsrGrid& grid,
                                                  unsigned step) {
  SsrOdometer odo(grid, 0);
#pragma unroll
  for (int k = SSR_MAX_AXES - 1; k >= 0; --k) {
    if (k < grid.ndim) {
      const unsigned d = static_cast<unsigned>(grid.dims[k]);
      odo.g[k] = step % d;
      step /= d;
    }
  }
  return odo;
}

// The address of K13's affine level at the odometer's step: coefficient 1
// on grid axis gpos, tile gtile.
__device__ __forceinline__ int64_t spmm_level(const SsrOdometer& odo,
                                              int64_t gpos, int64_t gtile) {
  int64_t level = 0;
#pragma unroll
  for (int k = 0; k < SSR_MAX_AXES; ++k)
    if (k == gpos) level = odo.g[k];
  return level * gtile;
}

// The valid columns of the index block at the odometer's step: its
// columns past col0 up to the block's width tk and the extent's valid_cols.
__device__ __forceinline__ int64_t valid_cols_at(const SsrOdometer& odo,
                                                 const SsrStream& sc,
                                                 int64_t valid_cols) {
  const int64_t tk = sc.block[1];
  const int64_t col0 = odo.index(sc, 1) * tk;
  return valid_cols - col0 < tk ? valid_cols - col0 : tk;
}

}  // namespace gather
