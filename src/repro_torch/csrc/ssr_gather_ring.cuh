// The rings of R13 ring_gather_spmv and R14 ring_gather_spmm: vals and cidx
// delivered with no CTA barrier in the step loop.
//
// Replaces, for the gathers, the CTA-wide rotation of ssr_ring.cuh, where
// one __syncthreads() a step publishes and frees every slot and holds
// every row to the slowest.  Two shapes:
//
// * R13, a filling warp (fill_rings): one extra warp of the CTA fills the
//   CTA's slots of both streams, its lanes copying 16-byte packs of all
//   the CTA's rows at once (cp.async), and each lane's copies of a slot
//   complete on that slot's `full` mbarrier (cp.async.mbarrier.arrive
//   .noinc, 32 arrivals a phase).  The computing warps wait on `full`
//   before they read a slot and arrive on its `empty` mbarrier (one
//   arrival a warp) once they are past it; the filling warp waits on
//   `empty` before it refills the slot.  A computing warp waits on no
//   other warp, only on data; the filling warp runs as far ahead as the
//   depths let it.
// * R14, a ring a warp (warp_fill): each warp owns the slots of its own
//   row, its lanes copy the row's packs, wait on their own copies
//   (cp.async.wait_group), and a __syncwarp() shows the warp's copies to
//   all its lanes and tells them that the warp is past the step whose
//   slots it refills next.  R14's slots are a row each; a filling warp's
//   handshakes a step cost it more than the copies.
//
// Either way the slots, steps and fetch order are the reference's
// rotation (repro/core/ssr.py:_pipelined_call), stream by stream: at
// virtual step u stream i fetches step u + depth_i - 1 into slot (u +
// depth_i - 1) % depth_i, and step s reads slot s % depth_i; the barriers
// of a slot complete one phase a fill, a reader of fill n waiting on
// parity n & 1.
#pragma once

#include "ssr_mbarrier.cuh"
#include "ssr_ring.cuh"

namespace gring {

using mbar::bar_arrive;
using mbar::bar_arrive_on_copies;
using mbar::bar_init;
using mbar::bar_wait;
using mbar::kBarrierBytes;   // R13's
using mbar::Slots;
using mbar::smem_u32;

// Wait until at most `pending` of this thread's cp.async groups are in
// flight (0 <= pending <= 7).
__device__ __forceinline__ void cp_wait(int pending) {
  switch (pending) {
    case 0: ssr_cp_async_wait<0>(); break;
    case 1: ssr_cp_async_wait<1>(); break;
    case 2: ssr_cp_async_wait<2>(); break;
    case 3: ssr_cp_async_wait<3>(); break;
    case 4: ssr_cp_async_wait<4>(); break;
    case 5: ssr_cp_async_wait<5>(); break;
    case 6: ssr_cp_async_wait<6>(); break;
    default: ssr_cp_async_wait<7>(); break;
  }
}

// The grid multi-index of a step, as SsrOdometer, in 32-bit registers (a
// grid axis holds fewer than 2^31 steps).
struct Walk {
  int g[SSR_MAX_AXES];

  __device__ __forceinline__ Walk(const SsrGrid& grid, int64_t step) {
#pragma unroll
    for (int k = SSR_MAX_AXES - 1; k >= 0; --k) {
      g[k] = 0;
      if (k < grid.ndim) {
        g[k] = static_cast<int>(step % grid.dims[k]);
        step /= grid.dims[k];
      }
    }
  }

  __device__ __forceinline__ void advance(const SsrGrid& grid) {
#pragma unroll
    for (int k = SSR_MAX_AXES - 1; k >= 0; --k) {
      if (k < grid.ndim) {
        if (++g[k] < grid.dims[k]) return;
        g[k] = 0;
      }
    }
  }

  __device__ __forceinline__ int64_t index(const SsrStream& s, int d) const {
    int64_t i = s.offset[d];
#pragma unroll
    for (int k = 0; k < SSR_MAX_AXES; ++k) i += g[k] * s.coeff[k][d];
    return i;
  }

  __device__ __forceinline__ int64_t origin(const SsrStream& s) const {
    return index(s, 0) * s.block[0] * s.pitch + index(s, 1) * s.block[1];
  }

  // The valid columns of the index block here: its columns past its first
  // up to the block's width and the extent's valid_cols.
  __device__ __forceinline__ int64_t valid_cols(const SsrStream& sc,
                                                int64_t extent) const {
    const int64_t tk = sc.block[1];
    const int64_t left = extent - index(sc, 1) * tk;
    return left < tk ? left : tk;
  }

  // The address of K13's affine level here: coefficient 1 on grid axis
  // gpos, tile gtile.
  __device__ __forceinline__ int64_t level(int64_t gpos, int64_t gtile) const {
    int64_t l = 0;
#pragma unroll
    for (int k = 0; k < SSR_MAX_AXES; ++k)
      if (k == gpos) l = g[k];
    return l * gtile;
  }
};

// The filling warp's loop over a CTA's run of `run` steps from step s0:
// at virtual step u it fills vals' step u + dv - 1 and cidx's step u + dc
// - 1, each into the slot its readers released at step u - 1 (waiting on
// its `empty` barrier), the CTA's `rows_cta` rows from row r0 of the
// step's index block as 16-byte packs on a pitch of `width`, rows past
// the extent not at all, and has each lane arrive on the slot's `full`
// barrier once its copies have landed.  Barriers: full_v, full_c, empty_v,
// empty_c, eight of each.
__device__ __forceinline__ void fill_rings(
    const float* __restrict__ vals, const int32_t* __restrict__ cidx,
    float* v_slots, int32_t* c_slots, int tile, int width, const SsrGrid& g,
    const SsrStream& sv, const SsrStream& sc, int64_t s0, int64_t run,
    int dv, int dc, int64_t r0, int rows_cta, int64_t valid_rows,
    int64_t valid_cols, uint64_t* bars, int lane) {
  auto fill = [&](auto* slots, const auto* src, const SsrStream& s,
                  const Walk& w, Slots& side, int64_t step, uint64_t* full,
                  uint64_t* empty) {
    if (step >= side.depth) bar_wait(empty + side.at, side.parity ^ 1u);
    const int64_t ncols = w.valid_cols(sc, valid_cols);
    const int64_t left = valid_rows - (w.index(sc, 0) * sc.block[0] + r0);
    const int rows = ncols <= 0 || left <= 0
                         ? 0 : (left < rows_cta ? static_cast<int>(left)
                                                : rows_cta);
    if (rows > 0)
      ssr_ring_copy(slots + side.at * tile, width,
                    src + w.origin(s) + r0 * s.pitch, s.pitch, rows,
                    static_cast<int>(ncols), true, lane, 32);
    bar_arrive_on_copies(full + side.at);
    side.next();
  };
  Walk fv(g, s0), fc(g, s0);
  Slots pv(dv), pc(dc);
  const int64_t dmax = dv > dc ? dv : dc;
  for (int64_t u = 1 - dmax; u < run; ++u) {
    if (u + dv - 1 >= 0 && u + dv - 1 < run) {
      fill(v_slots, vals, sv, fv, pv, u + dv - 1, bars, bars + 16);
      fv.advance(g);
    }
    if (u + dc - 1 >= 0 && u + dc - 1 < run) {
      fill(c_slots, cidx, sc, fc, pc, u + dc - 1, bars + 8, bars + 24);
      fc.advance(g);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Set a CTA's ring barriers (one thread): full ones complete on the
// filling warp's 32 arrivals, empty ones on one arrival of each of the
// `readers` computing warps.
__device__ __forceinline__ void init_rings(uint64_t* bars, int dv, int dc,
                                           unsigned readers) {
  for (int i = 0; i < dv; ++i) {
    bar_init(bars + i, 32);
    bar_init(bars + 16 + i, readers);
  }
  for (int i = 0; i < dc; ++i) {
    bar_init(bars + 8 + i, 32);
    bar_init(bars + 24 + i, readers);
  }
}

// A computing warp is past a step: once all its lanes are, release the
// step's slots of both streams.
__device__ __forceinline__ void release(uint64_t* bars, const Slots& v,
                                        const Slots& c, int lane) {
  __syncwarp();
  if (lane == 0) {
    bar_arrive(bars + 16 + v.at);
    bar_arrive(bars + 24 + c.at);
  }
}

// R14's copy of a warp's slot: one row of `ncols` valid elements of T, the
// lanes taking its 16-byte packs in turn (the last pack partial where
// ncols asks, the rest zero-filled, nothing past it read).  The row
// starts 16-byte aligned (the wrapper checks).
template <typename T>
__device__ __forceinline__ void warp_fill(T* dst, const T* src, int64_t ncols,
                                          int lane) {
  constexpr int V = 16 / sizeof(T);
  for (int64_t c = lane * V; c < ncols; c += 32 * V) {
    const int64_t left = ncols - c;
    ssr_ring_cp16_part(dst + c, src + c,
                       static_cast<int>(sizeof(T)) * (left < V ? left : V));
  }
}

}  // namespace gring
