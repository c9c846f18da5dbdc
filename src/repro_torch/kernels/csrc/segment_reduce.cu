// Sum / min / max of int32, uint32 or float32 values over sorted segment
// ids, for Hopper (sm_90a): out[s] = op(v_i ...) over the rows with id s,
// ids outside [0, S) (including -1) dropped, and the op's identity (0,
// +-inf, the int32 bounds, or 0 / 0xFFFFFFFF for uint32 max / min) in every
// slot no row hits. uint32 values (the variant hashes) compare unsigned:
// about half of them are >= 2^31, where a signed max would lose to the
// identity.
//
// Contract: the ids are sorted (non-decreasing), so each id's rows are one
// contiguous run, as the JAX kernel requires. Every caller passes such ids
// (the cumsum ids of engine.global_segments, ops.segment_ids_sorted). With
// unsorted ids the result is undefined: a slot may be written by two runs,
// or not at all.
//
// Replaces: src/repro/kernels/segment_ops/segment_reduce.py,
// segment_reduce_pallas (a VMEM-resident output carried across a
// sequential grid, each block_e-row tile reduced through a one-hot window).
//
// Bound on an H100 SXM: device-memory bytes. Each row reads its id and
// value once (8 bytes) and each of the S slots is written once (4 bytes):
// a 524,288-row chunk into S = 10^6 segments needs (4.2 + 4.0) MB / 3.35
// TB/s = 2.45 us.
//
// Design: one pass, one kernel node, each output slot written exactly once
// by a plain store (no fill beforehand, no atomics). Row i is a run head
// when i == 0 or id[i] != id[i - 1]; a head owns its run's value, stored
// into out[id] when 0 <= id < S, and (for i > 0) the identity in the slots
// skipped between the previous id and its own. The slots below id[0] and
// above id[n - 1] (at a later chunk of the L1 log ~925,000 of the 10^6)
// are shared out over all blocks of the grid, 16 bytes a store. A block
// stages a 1,024-row tile plus a 64-row halo into shared memory in one
// round trip (16 bytes a load when aligned), each row as an (id, value)
// pair. Its heads are found 4 rows a thread and compacted in row order (a
// warp scan of the counts, then the warps' totals), so thread j takes head
// j (and j + 256, ...) and the lanes of a warp do like work; each head
// folds its run left to right from shared memory, 8 rows a step, starting
// from the identity, so a float32 sum is the row-order fold ((0 + v_a) +
// v_b) + ..., bitwise the plain row-order scatter. Rows of a tile before its
// first head belong to the run of an earlier tile, whose owner reads them:
// the halo covers the longest case of the L1 log (64 rows). At 64
// registers four blocks fit an SM, so a chunk's 512 tiles run in one wave.
// A run that outlasts the halo is continued by the whole block: it stages
// 1,088-row windows in turn, finds where the run ends in each, and one
// thread folds the rows in row order (a run over a whole chunk is still
// one serial fold, but from shared memory and without a test per row).
#include <cuda_runtime.h>
#include <stdint.h>

#include <limits>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;                       // rows a thread checks for heads
constexpr int kTileRows = kThreads * kItems;    // 1,024 rows a tile
constexpr int kHalo = 64;                       // rows staged past the tile
constexpr int kWindow = kTileRows + kHalo;      // 1,088 rows staged at once
constexpr int kStep = 8;                        // rows a fold step reads at once
constexpr int kFillSlots = 4096;                // output slots a block fills, at least

enum Op { kSum = 0, kMin = 1, kMax = 2 };

template <int OP, typename T>
__device__ __forceinline__ T combine(T acc, T v) {
  if (OP == kSum) return acc + v;
  if (OP == kMin) return (v < acc || v != v) ? v : acc;  // NaN propagates
  return (v > acc || v != v) ? v : acc;
}

template <typename T>
struct alignas(16) Quad {
  T v[4];
};

__device__ __forceinline__ uint32_t bits(uint32_t v) { return v; }
__device__ __forceinline__ uint32_t bits(int32_t v) { return (uint32_t)v; }
__device__ __forceinline__ uint32_t bits(float v) { return __float_as_uint(v); }
template <typename T>
__device__ __forceinline__ T from_bits(uint32_t b) {
  if constexpr (std::is_floating_point<T>::value) return __uint_as_float(b);
  else return (T)b;
}

// A window of rows [pos, pos + lim) of seg and val, staged into shared
// memory as (id, value bits) pairs. When the inputs are 16-byte aligned,
// pos is a multiple of 4 and the window is full, load() issues 16-byte
// loads into registers and put() stores them, so other work can go on
// while the loads are in flight; otherwise put() loads and stores a row
// at a time (the last tile, misaligned views).
template <typename T>
struct Window {
  static constexpr int kQuads = kWindow / 4;
  static constexpr int kVecLoads = (kQuads + kThreads - 1) / kThreads;
  int4 ids4[kVecLoads];
  Quad<T> vals4[kVecLoads];
  const int32_t* seg;
  const T* val;
  int64_t pos;
  int lim;
  bool whole;

  __device__ __forceinline__ void load(const int32_t* __restrict__ seg_, const T* __restrict__ val_,
                                       int64_t pos_, int rows, bool vec) {
    seg = seg_, val = val_, pos = pos_, lim = rows;
    whole = vec && rows == kWindow;
    if (!whole) return;
#pragma unroll
    for (int m = 0; m < kVecLoads; ++m) {
      const int q = threadIdx.x + m * kThreads;
      if (q < kQuads) {
        ids4[m] = reinterpret_cast<const int4*>(seg + pos)[q];
        vals4[m] = reinterpret_cast<const Quad<T>*>(val + pos)[q];
      }
    }
  }

  __device__ __forceinline__ void put(uint2* s_rows) const {
    if (whole) {
#pragma unroll
      for (int m = 0; m < kVecLoads; ++m) {
        const int q = threadIdx.x + m * kThreads;
        if (q < kQuads) {
          uint4* dst = reinterpret_cast<uint4*>(s_rows + 4 * q);
          dst[0] = make_uint4(ids4[m].x, bits(vals4[m].v[0]), ids4[m].y, bits(vals4[m].v[1]));
          dst[1] = make_uint4(ids4[m].z, bits(vals4[m].v[2]), ids4[m].w, bits(vals4[m].v[3]));
        }
      }
      return;
    }
    for (int r = threadIdx.x; r < lim; r += kThreads)
      s_rows[r] = make_uint2((uint32_t)seg[pos + r], bits(val[pos + r]));
  }
};

// Folds the rows of id s from staged row j on into acc, left to right, 8
// rows a step; returns the first staged row past the run (lim if the run
// reaches the end of the staged rows). The staged rows are kStep longer
// than any window, so a step's reads stay inside them.
template <int OP, typename T>
__device__ __forceinline__ int fold_run(const uint2* s_rows, int j, int lim, int32_t s,
                                        T& acc) {
  while (true) {
    uint2 rr[kStep];
#pragma unroll
    for (int k = 0; k < kStep; ++k) rr[k] = s_rows[j + k];
#pragma unroll
    for (int k = 0; k < kStep; ++k) {
      if (j + k >= lim || (int32_t)rr[k].x != s) return j + k;
      acc = combine<OP>(acc, from_bits<T>(rr[k].y));
    }
    j += kStep;
  }
}

// Block b takes the 1,024-row tile b (if b < tiles) and writes the
// identity into its share of the slots below seg[0] and above seg[n - 1]
// (fill slots each, a multiple of 4, 16 bytes a store when out is
// aligned). aligned: bit 0, seg and val are 16-byte aligned; bit 1, out is.
template <int OP, typename T>
__global__ void __launch_bounds__(kThreads, 4)
segment_reduce_tiles(const int32_t* __restrict__ seg, const T* __restrict__ val,
                     int64_t n, int32_t num_segments, T ident, int aligned,
                     int64_t tiles, int64_t fill, T* __restrict__ out) {
  __shared__ __align__(16) uint2 s_rows[kWindow + kStep];
  __shared__ int s_head[kTileRows];
  __shared__ int s_warp[kThreads / 32];
  __shared__ int32_t s_before;  // the id of the row before the tile
  __shared__ int64_t s_pos;  // where the crossing run goes on, or -1
  __shared__ int32_t s_id;
  __shared__ int s_end;
  __shared__ T s_acc;
  const int tid = threadIdx.x;
  const int64_t S = num_segments;
  const int64_t row0 = (int64_t)blockIdx.x * kTileRows;
  const bool vec = (aligned & 1) != 0;
  const bool has_tile = (int64_t)blockIdx.x < tiles;
  const int64_t left = n - row0;
  const int lim = !has_tile ? 0 : left < kWindow ? (int)left : kWindow;   // staged rows
  const int own = !has_tile ? 0 : left < kTileRows ? (int)left : kTileRows;  // rows whose heads it owns
  int32_t before = 0;  // thread 0: the id of the row before the tile
  if (tid == 0) {
    s_pos = -1;
    if (has_tile && row0 > 0) before = seg[row0 - 1];
  }
  // the tile's loads go out first; the fill's stores are made while they
  // are in flight
  Window<T> rows;
  if (has_tile) rows.load(seg, val, row0, lim, vec);

  // this block's share of the fill stripes: [0, lo) and [hi, S)
  {
    const int32_t first = seg[0], last = seg[n - 1];
    const int64_t lo = first < S ? (int64_t)first : S;
    const int64_t hi = (int64_t)last + 1 > 0 ? (int64_t)last + 1 : 0;
    const int64_t f0 = (int64_t)blockIdx.x * fill;
    const int64_t f1 = f0 + fill < S ? f0 + fill : S;
    for (int64_t s0 = f0 + 4 * tid; s0 < f1; s0 += 4 * kThreads) {
      if ((aligned & 2) && s0 + 4 <= f1 && (s0 + 4 <= lo || s0 >= hi)) {
        *reinterpret_cast<Quad<T>*>(out + s0) = Quad<T>{{ident, ident, ident, ident}};
      } else {
        for (int e = 0; e < 4; ++e) {
          const int64_t g = s0 + e;
          if (g < f1 && (g < lo || g >= hi)) out[g] = ident;
        }
      }
    }
  }
  if (!has_tile) return;
  rows.put(s_rows);
  if (tid == 0) s_before = before;
  __syncthreads();

  // the heads among this thread's rows, compacted in row order into
  // s_head (a warp scan of the counts, then the warps' totals), so that
  // thread j takes heads j, j + 256, ...
  int32_t ids[kItems];  // this thread's rows, two pairs a 16-byte read
#pragma unroll
  for (int h = 0; h < kItems / 2; ++h) {
    const uint4 q = reinterpret_cast<const uint4*>(s_rows)[kItems / 2 * tid + h];
    ids[2 * h] = (int32_t)q.x;
    ids[2 * h + 1] = (int32_t)q.z;
  }
  int32_t p = tid > 0 ? (int32_t)s_rows[kItems * tid - 1].x : s_before;
  unsigned mine = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int r = kItems * tid + k;
    if (r < own && (row0 + r == 0 || ids[k] != p)) mine |= 1u << k;
    p = ids[k];
  }
  const int lane = tid & 31, wp = tid >> 5;
  const int count = __popc(mine);
  int inc = count;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) s_warp[wp] = inc;
  __syncthreads();
  int heads = 0, at = inc - count;
#pragma unroll
  for (int i = 0; i < kThreads / 32; ++i) {
    at += i < wp ? s_warp[i] : 0;
    heads += s_warp[i];
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k)
    if (mine >> k & 1u) s_head[at++] = kItems * tid + k;
  __syncthreads();

  for (int j = tid; j < heads; j += kThreads) {
    const int r = s_head[j];
    const int32_t s = (int32_t)s_rows[r].x;
    if (row0 + r > 0) {  // the ids skipped since the previous run
      const int32_t prev = r > 0 ? (int32_t)s_rows[r - 1].x : s_before;
      const int64_t g1 = (int64_t)s < S ? (int64_t)s : S;
      for (int64_t g = (int64_t)prev + 1 > 0 ? (int64_t)prev + 1 : 0; g < g1; ++g) out[g] = ident;
    }
    if (s < 0 || s >= num_segments) continue;  // a dropped run
    T acc = ident;
    const int end = fold_run<OP>(s_rows, r, lim, s, acc);
    if (end == lim && row0 + lim < n) {  // the run outlasts the staged rows
      s_pos = row0 + lim;
      s_id = s;
      s_acc = acc;
    } else {
      out[s] = acc;
    }
  }
  __syncthreads();

  // the block continues the crossing run, one window at a time: all
  // threads stage the window and find where the run ends in it, then one
  // thread folds it in row order
  int64_t pos = s_pos;
  if (pos < 0) return;
  const int32_t s = s_id;
  T acc = s_acc;
  while (true) {
    __syncthreads();  // every read of s_pos and of the staged rows is done
    const int64_t rest = n - pos;
    const int lim2 = rest < kWindow ? (int)rest : kWindow;
    rows.load(seg, val, pos, lim2, vec);
    rows.put(s_rows);
    if (tid == 0) s_end = lim2;
    __syncthreads();
    for (int r = tid; r < lim2; r += kThreads)
      if ((int32_t)s_rows[r].x != s) atomicMin(&s_end, r);
    __syncthreads();
    const int end = s_end;
    if (tid == 0) {
      int r = 0;
      for (; r + kStep <= end; r += kStep) {
        uint2 rr[kStep];
#pragma unroll
        for (int k = 0; k < kStep; ++k) rr[k] = s_rows[r + k];
#pragma unroll
        for (int k = 0; k < kStep; ++k) acc = combine<OP>(acc, from_bits<T>(rr[k].y));
      }
      for (; r < end; ++r) acc = combine<OP>(acc, from_bits<T>(s_rows[r].y));
      if (end < lim2 || pos + lim2 == n) out[s] = acc;
    }
    if (end < lim2 || pos + lim2 == n) return;
    pos += lim2;
  }
}

template <int OP, typename T>
cudaError_t launch(const void* seg, const void* val, int64_t n, int64_t s,
                   T ident, void* out, cudaStream_t stream) {
  // a block a tile, and at least one a kFillSlots slots of the output;
  // each block fills an equal share (a multiple of 4 slots)
  const int64_t tiles = (n + kTileRows - 1) / kTileRows;
  const int64_t fills = (s + kFillSlots - 1) / kFillSlots;
  const int64_t blocks = tiles > fills ? tiles : fills;
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  const int64_t fill = ((s + blocks - 1) / blocks + 3) / 4 * 4;
  const auto a16 = [](const void* p) { return ((uintptr_t)p & 15u) == 0u; };
  const int aligned = (a16(seg) && a16(val) ? 1 : 0) | (a16(out) ? 2 : 0);
  segment_reduce_tiles<OP, T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const int32_t*)seg, (const T*)val, n, (int32_t)s, ident, aligned, tiles, fill,
      (T*)out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int op, const void* seg, const void* val, int64_t n,
                     int64_t s, T ident, void* out, cudaStream_t stream) {
  switch (op) {
    case kSum: return launch<kSum, T>(seg, val, n, s, ident, out, stream);
    case kMin: return launch<kMin, T>(seg, val, n, s, ident, out, stream);
    case kMax: return launch<kMax, T>(seg, val, n, s, ident, out, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// seg: (n,) int32 sorted segment ids; val: (n,) int32 (kind == 0), float32
// (kind == 1) or uint32 (kind == 2); out: (num_segments,) of val's type,
// every slot written here (op 0 sum, 1 min, 2 max). n and num_segments
// must be positive, num_segments must fit int32. Returns the launch's
// cudaError_t (0 on success); never synchronizes.
extern "C" int repro_segment_reduce(const void* seg, const void* val,
                                    int64_t n, int64_t num_segments, int op,
                                    int kind, void* out, void* stream) {
  if (n <= 0 || num_segments <= 0 || num_segments > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (kind == 1) {
    const float inf = std::numeric_limits<float>::infinity();
    const float ident = op == kSum ? 0.0f : (op == kMin ? inf : -inf);
    return (int)dispatch<float>(op, seg, val, n, num_segments, ident, out, st);
  }
  if (kind == 2) {
    const uint32_t ident = op == kMin ? UINT32_MAX : 0u;
    return (int)dispatch<uint32_t>(op, seg, val, n, num_segments, ident, out,
                                   st);
  }
  if (kind != 0) return (int)cudaErrorInvalidValue;
  const int32_t ident = op == kSum ? 0 : (op == kMin ? INT32_MAX : INT32_MIN);
  return (int)dispatch<int32_t>(op, seg, val, n, num_segments, ident, out, st);
}
