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
// operations).  A row longer than the tile is walked once a pass, so what
// bounds the kernel there is the number of passes over the row.
//
// Design: passes over the row, each loading tiles of kTile = 16384
// elements into shared memory, running the pass's stages on each and
// writing it back; the passes are the ones kernels/bitonic.py::sort_passes
// lists.  The CTAs of a pass are persistent (one an SM: the tile's keys and
// the next tile's staging take 128 KiB), each staging its next tile by
// cp.async while the current one's stages run, so HBM stays busy through
// the compare-exchanges.
//   * tile sort: every stage with k <= the tile (one launch: a row of at
//     most kTile elements, or a batch of them, needs nothing else);
//   * group pass, for each k above the tile: up to kGroup = 9 adjacent
//     stages j = 2^jhi ... 2^jlo with j >= kTile, on a tile of the elements
//     whose indices differ only in those stage bits and in the low
//     14 - kGroup bits (runs of at least 32 contiguous elements, a 128-byte
//     line of f32 for every warp load);
//   * tile merge, for each such k: the stages j = kTile/2 ... 1.
// At n = 2^26: 1 tile sort, 15 group passes and 12 tile merges, 28 launches
// (105 as one global pass a stage; tools/sort_tile_sweep.py times the
// 8192-element tile, 32 launches, beside it).  Inside a tile a thread holds 32
// elements in registers, on a set of kRegLog2 = 5 bits of the tile index:
// each run of stages whose bits fit one such set runs in registers, and
// the tile crosses shared memory (XOR-swizzled against bank conflicts) once
// a run.  The host plans each pass's runs and every stage's slot bit and
// direction rule into the launch's parameters, so a thread spends its
// instructions on compare-exchanges, not on the plan.  Elements travel
// as order keys (the bits remapped so that unsigned order is the element
// order, -0 < +0), so a compare-exchange is an unsigned min and max; a
// tile holding a NaN runs the selects that propagate it instead.
//
// Min and max are selects on the bits, never fminf/fmaxf or PTX min/max on
// floats (which return the other operand of a NaN, and may return either
// zero of a pair): a NaN operand is both results (a's where both are NaN),
// so one NaN turns every output of the network to NaN, as the reference's
// does; other values order by a key of their bits under which -0 < +0, as
// jnp's minimum and maximum order them.  Each compare-exchange takes the
// operands and direction of the plain version, so the result equals it to
// the bit.
#include "ssr_common.cuh"

namespace {

constexpr int kTileLog2 = 14;
constexpr int kTile = 1 << kTileLog2;
constexpr int kGroup = 9;
constexpr int kRegLog2 = 5;
constexpr int kRegs = 1 << kRegLog2;
constexpr int kThreads = kTile >> kRegLog2;
// CTAs an SM the register budget is cut for (one: a CTA's 128 KiB of
// shared memory leaves room for no second)
constexpr int kMinCtas = 1;
constexpr int kMaxDevices = 64;

// Each element type's order key (a bijection on its bits), and whether a
// key is a NaN's.
struct F32Order {
  using T = uint32_t;
  static constexpr bool kNan = true;
  static __device__ __forceinline__ uint32_t key(uint32_t u) {
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  }
  static __device__ __forceinline__ uint32_t bits(uint32_t k) {
    return (k & 0x80000000u) ? (k & 0x7fffffffu) : ~k;
  }
  // above +inf's key or below -inf's
  static __device__ __forceinline__ bool nan(uint32_t k) {
    return k > 0xff800000u || k < 0x007fffffu;
  }
};
struct BF16Order {
  using T = uint16_t;
  static constexpr bool kNan = true;
  static __device__ __forceinline__ uint32_t key(uint32_t u) {
    return (u & 0x8000u) ? (~u & 0xffffu) : (u | 0x8000u);
  }
  static __device__ __forceinline__ uint32_t bits(uint32_t k) {
    return (k & 0x8000u) ? (k & 0x7fffu) : (~k & 0xffffu);
  }
  static __device__ __forceinline__ bool nan(uint32_t k) { return k > 0xff80u || k < 0x007fu; }
};
struct I32Order {
  using T = uint32_t;
  static constexpr bool kNan = false;
  static __device__ __forceinline__ uint32_t key(uint32_t u) { return u ^ 0x80000000u; }
  static __device__ __forceinline__ uint32_t bits(uint32_t k) { return k ^ 0x80000000u; }
  static __device__ __forceinline__ bool nan(uint32_t) { return false; }
};

// (a, b) <- (min, max), or (max, min) where desc, on keys.  Exact: a NaN
// operand is both results, a's where both are NaN.
template <typename O, bool Exact>
__device__ __forceinline__ void exchange(uint32_t& a, uint32_t& b, bool desc) {
  uint32_t lo = min(a, b), hi = max(a, b);
  if (Exact) {
    const bool na = O::nan(a), either = na || O::nan(b);
    const uint32_t p = na ? a : b;
    lo = either ? p : lo;
    hi = either ? p : hi;
  }
  a = desc ? hi : lo;
  b = desc ? lo : hi;
}

// Shared-memory word of tile index l: bits 5-9 XORed into the bank bits.
// Linear under XOR, so a slot's word is the XOR of its bits' words.
__device__ __forceinline__ int swz(int l) { return l ^ ((l >> 5) & 31); }

// One stage in registers: the pairs of slots differing in slot bit Q.
// Dir 0: every pair ascends, 1: every pair descends, 2: a pair descends
// where its slot has a bit of dmask.
template <typename O, bool Exact, int Q, int Dir>
__device__ __forceinline__ void reg_stage(uint32_t (&v)[kRegs], uint32_t dmask) {
#pragma unroll
  for (int s = 0; s < kRegs; ++s)
    if (!(s & (1 << Q)))
      exchange<O, Exact>(v[s], v[s | (1 << Q)], Dir == 2 ? (s & dmask) != 0 : Dir == 1);
}

// The stage on slot bit q (q < kRegLog2), its direction as above.
template <typename O, bool Exact, int Q = 0>
__device__ __forceinline__ void reg_stage(uint32_t (&v)[kRegs], int q, bool dflag,
                                          uint32_t dmask) {
  if constexpr (Q < kRegLog2) {
    if (q != Q)
      reg_stage<O, Exact, Q + 1>(v, q, dflag, dmask);
    else if (dmask != 0)
      reg_stage<O, Exact, Q, 2>(v, dmask);
    else if (dflag)
      reg_stage<O, Exact, Q, 1>(v, 0);
    else
      reg_stage<O, Exact, Q, 0>(v, 0);
  }
}

// The stages (k = 2^ks, j = 2^js) of a pass in network order: every
// ks <= ks_last with js = ks - 1 ... 0 (all_k), else one ks with
// js = js ... js_stop.
struct Stages {
  int ks, js, ks_last, js_stop, all_k;
  bool done() const { return ks > ks_last; }
  void next() {
    if (js > js_stop) {
      --js;
    } else if (all_k && ks < ks_last) {
      ++ks;
      js = ks - 1;
    } else {
      ks = ks_last + 1;
    }
  }
};

// A CTA's tile: 2^len_log2 elements, tile index l.  Bits [0, lo) of l are
// the row's bits [0, lo), bits [lo, len_log2) its bits [jlo, ...); base
// holds the CTA's other bits (the row's, then the rows').
struct Tile {
  int len_log2, lo, jlo;
  int64_t base;
  __device__ __forceinline__ int64_t global(int l) const {
    return base | (l & ((1 << lo) - 1)) | (static_cast<int64_t>(l >> lo) << jlo);
  }
  // the tile bit of the row's bit gb, or -1
  __host__ __device__ __forceinline__ int local_of(int gb) const {
    if (gb < lo) return gb;
    const int d = gb - jlo;
    return (d >= 0 && d < len_log2 - lo) ? lo + d : -1;
  }
};

constexpr int kMaxStages = kTileLog2 * (kTileLog2 + 1) / 2;

// One launch: the tile's layout and the pass's stages, planned on the host
// into runs (kernels/bitonic.py::register_runs mirrors the planning).  Run
// r holds run_len[r] stages on the kRegLog2 tile bits of run_mask[r]; the
// code of a stage is its slot bit q (bits 0-2), how its direction is found
// (bits 3-4: 0 ascending, 1 the CTA's index bit, 2 the slot's bit, 3 the
// thread's tile bit) and that bit (bits 5-10).
struct Pass {
  int log2n, len_log2, lo, jlo, nruns;
  uint16_t run_mask[kMaxStages];
  uint8_t run_len[kMaxStages];
  uint16_t code[kMaxStages];
};

// Four consecutive elements of one row, as bits, and back.
template <typename T>
__device__ __forceinline__ void load4(const T* p, uint32_t (&e)[4]);
template <>
__device__ __forceinline__ void load4<uint32_t>(const uint32_t* p, uint32_t (&e)[4]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  e[0] = q.x, e[1] = q.y, e[2] = q.z, e[3] = q.w;
}
template <>
__device__ __forceinline__ void load4<uint16_t>(const uint16_t* p, uint32_t (&e)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  e[0] = q.x & 0xffffu, e[1] = q.x >> 16, e[2] = q.y & 0xffffu, e[3] = q.y >> 16;
}
template <typename T>
__device__ __forceinline__ void store4(T* p, const uint32_t (&e)[4]);
template <>
__device__ __forceinline__ void store4<uint32_t>(uint32_t* p, const uint32_t (&e)[4]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(e[0], e[1], e[2], e[3]);
}
template <>
__device__ __forceinline__ void store4<uint16_t>(uint16_t* p, const uint32_t (&e)[4]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(e[0] | (e[1] << 16), e[2] | (e[3] << 16));
}

// The shared-memory word of slot s: the thread's word w0 XOR its bits'.
__device__ __forceinline__ int slot_word(int w0, const int (&wb)[kRegLog2], int s) {
#pragma unroll
  for (int q = 0; q < kRegLog2; ++q)
    if (s & (1 << q)) w0 ^= wb[q];
  return w0;
}

// The pass's stages on the tile's keys in shared memory, run by run, each
// run's stages in registers: a thread holds 32 slots, the tile bits of the
// run's mask, while the tile's other bits number the threads.
template <typename O, bool Exact>
__device__ void run_stages(uint32_t* sm, const Tile& tile, const Pass& pass) {
  for (int r = 0, i = 0; r < pass.nruns; ++r) {
    const uint32_t mask = pass.run_mask[r];
    int wb[kRegLog2];  // the word of slot bit q's tile bit
    int tbase = threadIdx.x;  // the thread's tile index, slot bits 0
    {
      uint32_t m = mask;
#pragma unroll
      for (int q = 0; q < kRegLog2; ++q) {
        const int bit = static_cast<int>(m & (~m + 1));
        wb[q] = swz(bit);
        tbase = ((tbase & ~(bit - 1)) << 1) | (tbase & (bit - 1));
        m &= m - 1;
      }
    }
    const int w0 = swz(tbase);
    uint32_t v[kRegs];
#pragma unroll
    for (int s = 0; s < kRegs; ++s) v[s] = sm[slot_word(w0, wb, s)];
    for (const int e = i + pass.run_len[r]; i < e; ++i) {
      const int code = pass.code[i], kind = (code >> 3) & 3, bit = code >> 5;
      const bool dflag = kind == 1 ? ((tile.base >> bit) & 1) != 0
                                   : kind == 3 && ((tbase >> bit) & 1) != 0;
      reg_stage<O, Exact>(v, code & 7, dflag, kind == 2 ? 1u << bit : 0u);
    }
#pragma unroll
    for (int s = 0; s < kRegs; ++s) sm[slot_word(w0, wb, s)] = v[s];
    __syncthreads();
  }
}

// The flat index of tile t's element 0: t's bits fill the flat index's
// bits outside the tile's (those between lo and jlo, then those above).
__device__ __forceinline__ int64_t tile_base(const Pass& pass, int64_t t) {
  const int a_bits = pass.jlo - pass.lo;
  return ((t & ((int64_t{1} << a_bits) - 1)) << pass.lo) |
         ((t >> a_bits) << (pass.jlo + pass.len_log2 - pass.lo));
}

// One pass over `tiles` tiles of at least 32 elements, 2^(len_log2 - 5)
// threads a CTA.  The CTAs are persistent, each taking the tiles gridDim.x
// apart: the next tile's elements come into a staging buffer by cp.async
// while the current tile's stages run.  x may be out.
template <typename O>
__global__ void __launch_bounds__(kThreads, kMinCtas)
    sort_pass(const typename O::T* x, typename O::T* out, const __grid_constant__ Pass pass,
              int64_t tiles) {
  using T = typename O::T;
  constexpr int kChunk = 16 / sizeof(T);  // elements a 16-byte copy moves
  extern __shared__ __align__(16) uint32_t sm[];  // the tile's keys
  const int len = 1 << pass.len_log2, step = blockDim.x * 4;
  T* staged = reinterpret_cast<T*>(sm + len);  // the next tile's elements
  Tile tile{pass.len_log2, pass.lo, pass.jlo, 0};
  auto fetch = [&](int64_t t) {
    Tile next = tile;
    next.base = tile_base(pass, t);
    for (int l = threadIdx.x * kChunk; l < len; l += blockDim.x * kChunk)
      ssr_cp_async16(reinterpret_cast<float*>(staged + l),
                     reinterpret_cast<const float*>(x + next.global(l)));
    ssr_cp_async_commit();
  };
  if (blockIdx.x < tiles) fetch(blockIdx.x);
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    tile.base = tile_base(pass, t);
    ssr_cp_async_wait<0>();
    __syncthreads();  // the staged tile landed; the last tile's keys are stored
    bool any_nan = false;
    for (int l = threadIdx.x * 4; l < len; l += step) {
      uint32_t e[4];
      load4(staged + l, e);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t k = O::key(e[i]);
        any_nan |= O::nan(k);
        sm[swz(l + i)] = k;
      }
    }
    const bool exact = __syncthreads_or(any_nan) != 0;  // the staging is free
    if (t + gridDim.x < tiles) fetch(t + gridDim.x);
    if (exact)
      run_stages<O, O::kNan>(sm, tile, pass);
    else
      run_stages<O, false>(sm, tile, pass);
    for (int l = threadIdx.x * 4; l < len; l += step) {
      uint32_t e[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) e[i] = O::bits(sm[swz(l + i)]);
      store4(out + tile.global(l), e);
    }
  }
}

// Rows shorter than 32 in tiles of fewer than 32 elements (an odd number
// of such rows): the whole network in shared memory, a thread a pair, a
// barrier a stage.
template <typename O>
__global__ void sort_small(const typename O::T* x, typename O::T* out, int log2n, int len_log2) {
  __shared__ uint32_t sm[kRegs];
  const int len = 1 << len_log2;
  const int64_t base = static_cast<int64_t>(blockIdx.x) << len_log2;
  for (int l = threadIdx.x; l < len; l += blockDim.x) sm[l] = O::key(x[base + l]);
  __syncthreads();
  for (int ks = 1; ks <= log2n; ++ks) {
    for (int js = ks - 1; js >= 0; --js) {
      for (int p = threadIdx.x; p < len / 2; p += blockDim.x) {
        const int lo = ((p >> js) << (js + 1)) | (p & ((1 << js) - 1));
        exchange<O, O::kNan>(sm[lo], sm[lo + (1 << js)], ks < log2n && ((lo >> ks) & 1));
      }
      __syncthreads();
    }
  }
  for (int l = threadIdx.x; l < len; l += blockDim.x) out[base + l] = O::bits(sm[l]);
}

// Plans a pass on a tile (len_log2, lo, jlo) of rows of 2^log2n: its
// stages split into runs, each the longest stretch whose bits fit
// kRegLog2 tile bits, padded with the bits above its highest, then below
// its lowest; false if the stages do not fit a Pass.
bool plan(Pass& p, Stages it) {
  const Tile tile{p.len_log2, p.lo, p.jlo, 0};
  int ks[kMaxStages], js[kMaxStages], ns = 0;
  for (; !it.done(); it.next()) {
    if (ns == kMaxStages) return false;
    ks[ns] = it.ks, js[ns] = it.js, ++ns;
  }
  p.nruns = 0;
  for (int i = 0; i < ns;) {
    uint32_t mask = 0;
    int cnt = 0, e = i;
    for (; e < ns; ++e) {
      const int b = tile.local_of(js[e]);
      if (!((mask >> b) & 1)) {
        if (cnt == kRegLog2) break;
        mask |= 1u << b, ++cnt;
      }
    }
    for (int b = 32 - __builtin_clz(mask); cnt < kRegLog2 && b < p.len_log2; ++b, ++cnt)
      mask |= 1u << b;
    for (int b = __builtin_ctz(mask) - 1; cnt < kRegLog2; --b, ++cnt) mask |= 1u << b;
    p.run_mask[p.nruns] = static_cast<uint16_t>(mask);
    p.run_len[p.nruns] = static_cast<uint8_t>(e - i);
    ++p.nruns;
    for (; i < e; ++i) {
      const int q = __builtin_popcount(mask & ((1u << tile.local_of(js[i])) - 1));
      int kind = 0, bit = 0;
      if (ks[i] < p.log2n) {  // bit ks of the position in the row: 0 ascends
        const int lk = tile.local_of(ks[i]);
        if (lk < 0)
          kind = 1, bit = ks[i];
        else if ((mask >> lk) & 1)
          kind = 2, bit = __builtin_popcount(mask & ((1u << lk) - 1));
        else
          kind = 3, bit = lk;
      }
      p.code[i] = static_cast<uint16_t>(q | (kind << 3) | (bit << 5));
    }
  }
  return true;
}

template <typename O>
int launch(const void* x, void* out, int64_t rows, int64_t n, cudaStream_t st) {
  using T = typename O::T;
  int log2n = 0;
  while ((int64_t{1} << log2n) < n) ++log2n;
  if (rows <= 0 || n != (int64_t{1} << log2n)) return static_cast<int>(cudaErrorInvalidValue);
  // a tile: the largest power of two up to kTile dividing rows * n
  int len_log2 = log2n;
  for (int64_t r = rows; len_log2 < kTileLog2 && (r & 1) == 0; r >>= 1) ++len_log2;
  if (len_log2 > kTileLog2) len_log2 = kTileLog2;
  const int64_t ctas = (rows * n) >> len_log2;
  if (ctas >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const T* src = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  const unsigned grid = static_cast<unsigned>(ctas);
  if (len_log2 < kRegLog2) {
    const int threads = len_log2 > 0 ? 1 << (len_log2 - 1) : 1;
    sort_small<O><<<grid, threads, 0, st>>>(src, o, log2n, len_log2);
    return static_cast<int>(cudaGetLastError());
  }
  const int threads = 1 << (len_log2 - kRegLog2);
  const int smem = static_cast<int>(sizeof(uint32_t) + sizeof(T)) << len_log2;
  // the CTAs of this tile size a device holds at once, found at the first
  // launch of that size on it
  static int64_t resident[kMaxDevices][kTileLog2 + 1] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev >= kMaxDevices) err = cudaErrorInvalidDevice;
  if (err == cudaSuccess && resident[dev][len_log2] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(sort_pass<O>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(sizeof(uint32_t) + sizeof(T)) << kTileLog2);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sort_pass<O>, threads, smem);
    if (err == cudaSuccess)
      resident[dev][len_log2] = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t most = resident[dev][len_log2];
  const unsigned persistent = static_cast<unsigned>(ctas < most ? ctas : most);
  Pass pass;
  auto run = [&](const T* in, int lo, int jlo, Stages stages) {
    pass.log2n = log2n, pass.len_log2 = len_log2, pass.lo = lo, pass.jlo = jlo;
    if (!plan(pass, stages)) return cudaErrorInvalidValue;
    sort_pass<O><<<persistent, threads, smem, st>>>(in, o, pass, ctas);
    return cudaGetLastError();
  };
  const int kmax = log2n < len_log2 ? log2n : len_log2;
  err = run(src, len_log2, len_log2, Stages{1, 0, kmax, 0, 1});
  for (int ks = len_log2 + 1; err == cudaSuccess && ks <= log2n; ++ks) {
    for (int jhi = ks - 1; err == cudaSuccess && jhi >= len_log2; jhi -= kGroup) {
      const int g = jhi - len_log2 + 1 < kGroup ? jhi - len_log2 + 1 : kGroup;
      err = run(o, len_log2 - g, jhi - g + 1, Stages{ks, jhi, ks, jhi - g + 1, 0});
    }
    if (err == cudaSuccess) err = run(o, len_log2, len_log2, Stages{ks, len_log2 - 1, ks, 0, 0});
  }
  return static_cast<int>(err);
}

}  // namespace

// x and out (rows, n), n a power of two, of one dtype (kept); x 16-byte
// aligned.  One launch for a row of at most 16384 elements (or a batch of
// them); else one tile sort plus, for each k = 2^15 ... n, a group pass for
// each 9 stages (or fewer) with j >= 16384 and one tile merge.
extern "C" int ssr_stream_bitonic(const void* x, void* out, int dtype, int64_t rows, int64_t n,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == SSR_F32) return launch<F32Order>(x, out, rows, n, st);
  if (dtype == SSR_BF16) return launch<BF16Order>(x, out, rows, n, st);
  if (dtype == SSR_I32) return launch<I32Order>(x, out, rows, n, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// A CTA's shared memory at most: the tile's keys and the next tile's
// staged elements (4 + 4 bytes an element in f32 and int32).
extern "C" int64_t ssr_stream_bitonic_smem_bytes() {
  return static_cast<int64_t>(2 * sizeof(uint32_t)) * kTile;
}
