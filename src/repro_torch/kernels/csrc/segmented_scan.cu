// Case-local (segmented) inclusive scans over a (case, time)-sorted chunk,
// for Hopper (sm_90a). A row whose start flag is set begins a new segment;
// an unflagged row 0 continues the segment left open by the previous chunk,
// whose running value comes in through a pointer (the carry, a device
// tensor: reading it never syncs the host).
//
//   affine:   h <- h * mul[i] + add[i]  (mod 2^32), h = 0 at a flagged row
//   polyhash: the same with mul[i] == base, add[i] == value[i]
//   sum:      h <- h + x[i, k] over (N, K) rows, per column k, h = 0 at a
//             flagged row
//
// Replaces: src/repro/kernels/segment_ops/segmented_scan.py,
// segmented_polyhash_pallas, segmented_affine_pallas and
// segmented_sum_scan_pallas (block_e-row tiles in order on one core, each a
// Hillis-Steele doubling scan of (flag, mul, add) with the open segment's
// state carried across the sequential grid in VMEM).
//
// Bound on an H100 SXM: device-memory bytes. Each row reads its flag (1
// byte) and its operands once and writes its result once: 9 bytes a row
// for polyhash, 13 for affine, 8K + 1 for the sum. At 3.35 TB/s a
// 524,288-row chunk needs 1.4 us (polyhash), 2.0 us (affine) and, at K =
// 26 float32 columns, 32.7 us (sum). One multiply-add a row (one add a
// cell) is far below the 67 T op/s of the scalar units.
//
// Design of the affine scan (polyhash is the affine scan with mul = base):
// each row is an affine map (m, a) on uint32, (0, add) at a flagged row and
// (mul, add) elsewhere; the map of f then g is (m_f m_g, a_f m_g + a_g) mod
// 2^32. Composition is associative and exact, so any bracketing gives the
// bits of the sequential fold, and no flag travels with the state. The
// carry is the constant map (0, carry) in front of row 0, and ys[i] is the
// state after the inclusive prefix. One pass over tiles of 4,096 rows (256
// threads x 16): the tile is loaded coalesced (16 bytes a load when the
// columns are 16-byte aligned) and transposed through shared memory so
// each thread holds 16 consecutive rows; each thread
// composes its rows, warps scan their threads' maps with __shfl_up_sync,
// and the block composes the warps'. Across tiles, a decoupled look-back:
// tile ids come from an atomic ticket (so every tile a block waits on was
// drawn by a running block), a tile publishes its aggregate at once and,
// once it knows the state entering it, its inclusive state; warp 0 reads
// 128 predecessors' 16-byte status words (one 128-byte line each) at a
// time, with back-off between reads, and composes back to the nearest
// inclusive one. The status words are scratch the wrapper
// allocates and the launcher zeroes on the stream before each launch. Run
// length no longer matters: one run over a chunk costs what short runs do.
// The block of the last tile writes carry_out (ys[n - 1]).
//
// Design of the sum scan: float32 sums must keep row order, so no tree
// scan is open to it, and the blocks of the card run in no order, so no
// carry can flow from tile to tile as on the TPU. Instead each run is
// folded left to right by the tile that holds its head. A tile owns 256
// rows (fewer for rows wider than 30 columns: a staged window holds at
// most 8,192 words, and rows wider than 256 columns are cut into column
// slices, one grid row each); it stages them and a 16-row halo into shared
// memory with cp.async (16 bytes a copy when the rows' base is 16-byte
// aligned, 4 otherwise: chunk slices at odd row offsets of 104-byte rows
// are not), finds its heads (row 0, unflagged from the carry and flagged
// from 0, or a flagged row) by a warp ballot and a block prefix, and
// spreads the (head, column) items over its threads, neighbouring threads
// on neighbouring columns. Each item adds its run's rows in row order in
// shared memory, h = h + x, writing each inclusive value in place, and the
// tile stores rows [first head, end of its last run) coalesced, 16 bytes a
// store where aligned. Rows before a tile's first head belong to an
// earlier tile's run, which writes them, so no row is written twice: the
// halo holds most of the L1 log's crossing runs (7 rows a case on average,
// at most 64); a run that outlasts it is continued by the whole block,
// which stages window after window while one thread a column folds them
// (a run over a whole chunk stays one serial chain of adds a column, the
// order the float sum needs, but fed from shared memory). The thread that
// writes row n - 1 writes carry_out.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kScanThreads = 256;
constexpr int kScanItems = 16;                         // rows a thread
constexpr int kTileRows = kScanThreads * kScanItems;   // 4,096 rows a tile
constexpr int kScanWarps = kScanThreads / 32;
constexpr uint32_t kAggregate = 1;  // status kinds; 0: nothing published yet
constexpr uint32_t kInclusive = 2;
constexpr int kLookBackLane = 4;    // predecessors a lane reads per round trip
constexpr int kLookBack = 32 * kLookBackLane;
constexpr int kStatusStride = 8;    // 16-byte words a status: its own 128-byte line

// h -> h * m + a (mod 2^32)
struct Map {
  uint32_t m, a;
};
__device__ __forceinline__ Map compose(Map f, Map g) {  // f, then g
  return {f.m * g.m, f.a * g.m + g.a};
}
__device__ __forceinline__ Map shfl_up(Map f, int d) {
  return {__shfl_up_sync(0xffffffffu, f.m, d), __shfl_up_sync(0xffffffffu, f.a, d)};
}
__device__ __forceinline__ Map shfl_down(Map f, int d) {
  return {__shfl_down_sync(0xffffffffu, f.m, d), __shfl_down_sync(0xffffffffu, f.a, d)};
}

// A tile's status is one 16-byte word {kind, m, a, 0}, written and read
// whole (one 16-byte access, bypassing L1), so a reader never sees a kind
// without its map.
__device__ __forceinline__ void publish(uint4* s, uint32_t kind, Map f) {
  asm volatile("st.volatile.global.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"l"(s), "r"(kind),
               "r"(f.m), "r"(f.a), "r"(0u)
               : "memory");
}
__device__ __forceinline__ uint4 peek(const uint4* s) {
  uint4 r;
  asm volatile("ld.volatile.global.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "l"(s)
               : "memory");
  return r;
}

// shared-memory index of tile row i, one pad word per 32 so that both the
// coalesced (row i by thread i % 256) and the blocked (16 rows a thread)
// passes are free of bank conflicts
__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

// The state entering tile `tile` (whose aggregate is `agg`), found by
// looking back over the predecessors' status words; publishes the tile's
// aggregate first and its inclusive state last. Called by one whole warp,
// which reads kLookBack predecessors at once (lane l the kLookBackLane
// tiles just before tile hi - kLookBackLane l), so at a chunk's 128 tiles
// one round trip reaches tile 0. The window is used as far as the nearest
// inclusive state once no tile before it is still unpublished; between
// reads the warp backs off, so the polls of many tiles do not crowd the
// status words' cache lines.
__device__ uint32_t look_back(uint4* status, int64_t tile, Map agg, uint32_t carry) {
  const int lane = threadIdx.x & 31;
  if (tile == 0) {
    if (lane == 0) publish(status, kInclusive, {0u, carry * agg.m + agg.a});
    return carry;
  }
  if (lane == 0) publish(status + kStatusStride * tile, kAggregate, agg);
  Map acc = {1u, 0u};            // the tiles between the window and this one
  for (int64_t hi = tile - 1;; hi -= kLookBack) {
    uint4 w[kLookBackLane];      // w[i] is tile hi - kLookBackLane lane - i
    unsigned inclusive, first;
    for (unsigned ns = 32;; ns = ns < 512 ? 2 * ns : ns) {
      bool pending = false, found = false;  // in this lane's tiles, nearest first
#pragma unroll
      for (int i = 0; i < kLookBackLane; ++i) {
        const int64_t j = hi - kLookBackLane * lane - i;
        // before tile 0: an inclusive state no lane reaches (tile 0 is one)
        w[i] = j >= 0 ? peek(status + kStatusStride * j)
                      : make_uint4(kInclusive, 0u, 0u, 0u);
      }
#pragma unroll
      for (int i = 0; i < kLookBackLane; ++i) {
        if (!pending && !found) {
          pending = w[i].x == 0u;
          found = w[i].x == kInclusive;
        }
      }
      inclusive = __ballot_sync(0xffffffffu, found);
      first = inclusive ? __ffs(inclusive) - 1 : 32;  // the nearest lane with one
      const unsigned before = first == 32 ? 0xffffffffu : (1u << first) - 1u;
      if ((__ballot_sync(0xffffffffu, pending) & before) == 0u) break;
      __nanosleep(ns);
    }
    // this lane's tiles in row order, up to its inclusive state if any
    Map f = {1u, 0u};
    if (lane <= (int)first) {
      bool done = false;
#pragma unroll
      for (int i = 0; i < kLookBackLane; ++i) {
        if (!done) {
          f = compose({w[i].y, w[i].z}, f);
          done = w[i].x == kInclusive;
        }
      }
    }
    // compose the window in row order (a higher lane holds earlier tiles)
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const Map g = shfl_down(f, d);
      if (lane + d < 32) f = compose(g, f);
    }
    f = {__shfl_sync(0xffffffffu, f.m, 0), __shfl_sync(0xffffffffu, f.a, 0)};
    acc = compose(f, acc);
    if (inclusive) break;
  }
  // acc starts with an inclusive state (m = 0), so acc.a is the state
  const uint32_t in = acc.a;
  if (lane == 0) publish(status + kStatusStride * tile, kInclusive, {0u, in * agg.m + agg.a});
  return in;
}

// Tile `tile`'s rows, coalesced, all loads issued before any is used.
// vec: a whole tile of 16-byte-aligned columns, read 16 bytes a load:
// slot 4 k + e holds row 4 (256 k + threadIdx.x) + e, and fw the thread's
// own 16 flags (rows 16 threadIdx.x ..). Otherwise one row a load, slot k
// holding row 256 k + threadIdx.x (and lf its flag); rows past n are the
// identity map.
template <bool kPerRowMul>
__device__ __forceinline__ void load_rows(const uint32_t* __restrict__ mul, uint32_t base,
                                          const uint32_t* __restrict__ add,
                                          const uint8_t* __restrict__ start, int64_t n,
                                          int64_t tile, bool vec, uint32_t (&lm)[kScanItems],
                                          uint32_t (&la)[kScanItems],
                                          uint8_t (&lf)[kScanItems], uint4& fw) {
  const int64_t row0 = tile * kTileRows;
  if (vec) {
    fw = reinterpret_cast<const uint4*>(start + row0)[threadIdx.x];
#pragma unroll
    for (int k = 0; k < kScanItems / 4; ++k) {
      const int64_t c = row0 / 4 + k * kScanThreads + threadIdx.x;
      const uint4 av = reinterpret_cast<const uint4*>(add)[c];
      const uint4 mv = kPerRowMul ? reinterpret_cast<const uint4*>(mul)[c]
                                  : make_uint4(base, base, base, base);
      la[4 * k] = av.x, la[4 * k + 1] = av.y, la[4 * k + 2] = av.z, la[4 * k + 3] = av.w;
      lm[4 * k] = mv.x, lm[4 * k + 1] = mv.y, lm[4 * k + 2] = mv.z, lm[4 * k + 3] = mv.w;
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    const int64_t r = row0 + k * kScanThreads + threadIdx.x;
    const bool ok = r < n;
    lf[k] = ok ? start[r] : 0;
    la[k] = ok ? add[r] : 0u;
    lm[k] = ok ? (kPerRowMul ? mul[r] : base) : 1u;
  }
}

// the tile row held in load slot k (see load_rows)
__device__ __forceinline__ int slot_row(bool vec, int k) {
  return vec ? 4 * ((k >> 2) * kScanThreads + (int)threadIdx.x) + (k & 3)
             : k * kScanThreads + (int)threadIdx.x;
}

// the affine scan; kPerRowMul == false is polyhash (mul == base everywhere).
// scratch: a 128-byte line whose first word is the ticket, then one line
// a tile holding its 16-byte status word, all zero at launch. aligned:
// mul (per-row maps only), add, start and ys are 16-byte aligned, so whole
// tiles move 16 bytes a load and a store.
template <bool kPerRowMul>
__global__ void __launch_bounds__(kScanThreads)
affine_scan(const uint32_t* __restrict__ mul, uint32_t base,
            const uint32_t* __restrict__ add, const uint8_t* __restrict__ start,
            const uint32_t* __restrict__ carry, int64_t n, int aligned,
            uint32_t* __restrict__ ys, uint32_t* __restrict__ carry_out,
            uint4* __restrict__ scratch) {
  constexpr int kPadded = kTileRows + kTileRows / 32;
  __shared__ uint32_t s_mul[kPadded];  // then the results
  __shared__ uint32_t s_add[kPadded];
  __shared__ __align__(16) uint8_t s_flag[kTileRows];
  __shared__ Map s_warp[kScanWarps];
  __shared__ uint32_t s_tile, s_in;
  const auto whole = [&](int64_t t) { return aligned && (t + 1) * kTileRows <= n; };

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  if (tid == 0) s_tile = atomicAdd(reinterpret_cast<unsigned int*>(scratch), 1u);
  // the ticket is most often blockIdx.x: that tile's loads go out while
  // the ticket is in flight, and are made again in the rare other case
  uint32_t lm[kScanItems], la[kScanItems];
  uint8_t lf[kScanItems];
  uint4 fw;
  load_rows<kPerRowMul>(mul, base, add, start, n, blockIdx.x, whole(blockIdx.x), lm, la,
                        lf, fw);
  __syncthreads();
  const int64_t tile = s_tile;
  const bool vec = whole(tile);
  if (tile != blockIdx.x)
    load_rows<kPerRowMul>(mul, base, add, start, n, tile, vec, lm, la, lf, fw);
  const int64_t row0 = tile * kTileRows;
  const int64_t left = n - row0;
  const int valid = left < kTileRows ? (int)left : kTileRows;
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    const int i = slot_row(vec, k);
    s_mul[pad(i)] = lm[k];
    s_add[pad(i)] = la[k];
    if (!vec) s_flag[i] = lf[k];
  }
  __syncthreads();

  // this thread's 16 consecutive rows, and their composed map
  uint32_t m[kScanItems], a[kScanItems];
  if (!vec) fw = *reinterpret_cast<const uint4*>(s_flag + tid * kScanItems);
  const uint32_t fwords[4] = {fw.x, fw.y, fw.z, fw.w};
  Map agg = {1u, 0u};
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    const int i = tid * kScanItems + k;
    const bool flagged = ((fwords[k >> 2] >> (8 * (k & 3))) & 0xFFu) != 0u;
    m[k] = flagged ? 0u : s_mul[pad(i)];
    a[k] = s_add[pad(i)];
    agg = compose(agg, {m[k], a[k]});
  }

  // warp scan of the threads' maps: inclusive, then shifted to exclusive
  Map inc = agg;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Map g = shfl_up(inc, d);
    if (lane >= d) inc = compose(g, inc);
  }
  Map excl = shfl_up(inc, 1);
  if (lane == 0) excl = {1u, 0u};
  if (lane == 31) s_warp[w] = inc;
  __syncthreads();

  if (w == 0) {
    Map tile_agg = {1u, 0u};
#pragma unroll
    for (int i = 0; i < kScanWarps; ++i) tile_agg = compose(tile_agg, s_warp[i]);
    const uint32_t in = look_back(scratch + kStatusStride, tile, tile_agg, *carry);
    if (lane == 0) s_in = in;
  }
  __syncthreads();

  // the state entering this thread's rows, then its 16 results (a
  // flagged row has m = 0, so it restarts from its add)
  uint32_t h = s_in;
  for (int i = 0; i < w; ++i) h = h * s_warp[i].m + s_warp[i].a;
  h = h * excl.m + excl.a;
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    h = h * m[k] + a[k];
    s_mul[pad(tid * kScanItems + k)] = h;
    if (tid * kScanItems + k == valid - 1 && row0 + valid == n) *carry_out = h;
  }
  __syncthreads();
  if (vec) {
#pragma unroll
    for (int k = 0; k < kScanItems / 4; ++k) {
      const int c = k * kScanThreads + tid;
      reinterpret_cast<uint4*>(ys + row0)[c] =
          make_uint4(s_mul[pad(4 * c)], s_mul[pad(4 * c + 1)], s_mul[pad(4 * c + 2)],
                     s_mul[pad(4 * c + 3)]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      const int i = k * kScanThreads + tid;
      if (i < valid) ys[row0 + i] = s_mul[pad(i)];
    }
  }
}

constexpr int kSumThreads = 256;  // a tile's rows are checked one a thread
constexpr int kSumMaxRows = kSumThreads;
constexpr int kSumHalo = 16;      // rows staged past the tile
constexpr int kSumMaxCols = 256;  // columns a block takes
constexpr int kSumWords = 8192;   // words a staged window holds, at most

// rows a tile owns for a slice of kc columns: 256 up to 30 columns, then
// as many as the window's words allow (16 at 256 columns)
__host__ __device__ inline int sum_tile_rows(int kc) {
  const int r = kSumWords / kc - kSumHalo;
  return r < kSumMaxRows ? r : kSumMaxRows;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Columns [c0, c0 + cols) of rows [pos, pos + rows) into s_x (row-major,
// cols words a row), by cp.async: issued here, waited for by the caller.
template <typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ x, int64_t k, int c0,
                                           int cols, int64_t pos, int rows, T* s_x) {
  const int tid = threadIdx.x;
  const int words = rows * cols;
  if (cols == k) {  // one contiguous range
    const T* src = x + pos * k;
    int vecs = 0;
    if ((reinterpret_cast<uintptr_t>(src) & 15u) == 0u) {
      vecs = words / 4;
      for (int v = tid; v < vecs; v += kSumThreads) cp_async16(s_x + 4 * v, src + 4 * v);
    }
    for (int w = 4 * vecs + tid; w < words; w += kSumThreads) cp_async4(s_x + w, src + w);
    return;
  }
  for (int w = tid; w < words; w += kSumThreads) {
    const int r = w / cols;
    cp_async4(s_x + w, x + (pos + r) * k + c0 + (w - r * cols));
  }
}

// Staged rows [r0, r1) of s_x to rows pos + r0 .. of ys, coalesced; 16
// bytes a store where both sides are aligned.
template <typename T>
__device__ __forceinline__ void store_rows(T* __restrict__ ys, int64_t k, int c0, int cols,
                                           int64_t pos, int r0, int r1, const T* s_x) {
  const int tid = threadIdx.x;
  const int w0 = r0 * cols, w1 = r1 * cols;
  if (cols == k) {
    T* dst = ys + pos * k;
    int a0 = w0, a1 = w0;  // [a0, a1) moves 16 bytes a store
    if ((reinterpret_cast<uintptr_t>(dst) & 15u) == 0u) {
      a0 = min((w0 + 3) & ~3, w1);
      a1 = max(w1 & ~3, a0);
    }
    for (int w = w0 + tid; w < a0; w += kSumThreads) dst[w] = s_x[w];
    for (int v = a0 / 4 + tid; v < a1 / 4; v += kSumThreads)
      reinterpret_cast<uint4*>(dst)[v] = reinterpret_cast<const uint4*>(s_x)[v];
    for (int w = a1 + tid; w < w1; w += kSumThreads) dst[w] = s_x[w];
    return;
  }
  for (int w = w0 + tid; w < w1; w += kSumThreads) {
    const int r = w / cols;
    ys[(pos + r) * k + c0 + (w - r * cols)] = s_x[w];
  }
}

// Column c of staged rows [r0, r1) summed in row order onto acc, each
// inclusive value written back in place; 8 rows a step, their loads
// issued before the adds.
template <typename T>
__device__ __forceinline__ T fold_rows(T* s_x, int cols, int c, int r0, int r1, T acc) {
  constexpr int kFold = 8;
  for (int r = r0; r < r1; r += kFold) {
    T v[kFold];
#pragma unroll
    for (int q = 0; q < kFold; ++q) v[q] = r + q < r1 ? s_x[(r + q) * cols + c] : T(0);
#pragma unroll
    for (int q = 0; q < kFold; ++q) {
      if (r + q < r1) {
        acc = acc + v[q];
        s_x[(r + q) * cols + c] = acc;
      }
    }
  }
  return acc;
}

// The sum scan over (n, k) rows: block (t, y) takes the runs headed in
// rows [t rows, (t + 1) rows) and the columns [y kc, (y + 1) kc). Dynamic
// shared memory: the staged window ((rows + kSumHalo) x kc) and the
// crossing run's sums (kc).
template <typename T>
__global__ void __launch_bounds__(kSumThreads)
sum_scan(const T* __restrict__ x, const uint8_t* __restrict__ start,
         const T* __restrict__ carry, int64_t n, int64_t k, int rows, int kc,
         T* __restrict__ ys, T* __restrict__ carry_out) {
  extern __shared__ __align__(16) unsigned char s_raw[];
  __shared__ int s_head[kSumMaxRows];
  __shared__ int s_count[kSumThreads / 32];
  __shared__ int s_stop;
  const int win = rows + kSumHalo;
  T* s_x = reinterpret_cast<T*>(s_raw);
  T* s_run = s_x + win * kc;
  const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5;
  const int64_t row0 = (int64_t)blockIdx.x * rows;
  const int c0 = blockIdx.y * kc;
  const int cols = k - c0 < kc ? (int)(k - c0) : kc;
  const int64_t left = n - row0;
  const int lim = left < win ? (int)left : win;    // staged rows
  const int own = left < rows ? (int)left : rows;  // rows whose heads it owns

  stage_rows<T>(x, k, c0, cols, row0, lim, s_x);
  const bool head = tid < own && (row0 + tid == 0 || start[row0 + tid] != 0);
  // the first flagged halo row ends the tile's last run
  const bool halo_head = tid < lim - own && start[row0 + own + tid] != 0;
  const unsigned mask = __ballot_sync(0xffffffffu, head);
  if (lane == 0) s_count[wp] = __popc(mask);
  if (tid == 0) s_stop = lim;
  __syncthreads();
  if (halo_head) atomicMin(&s_stop, own + tid);
  int heads = 0, before = 0;
#pragma unroll
  for (int i = 0; i < kSumThreads / 32; ++i) {
    before += i < wp ? s_count[i] : 0;
    heads += s_count[i];
  }
  if (head) s_head[before + __popc(mask & ((1u << lane) - 1u))] = tid;
  cp_async_wait_all();
  __syncthreads();
  if (heads == 0) return;  // every row belongs to an earlier tile's run
  const int stop = s_stop;
  const bool more = stop == lim && row0 + lim < n;  // the last run goes on

  for (int j = tid; j < heads * cols; j += kSumThreads) {
    const int h = j / cols, c = j - h * cols;
    const int r0 = s_head[h];
    const int r1 = h + 1 < heads ? s_head[h + 1] : stop;
    T acc = row0 + r0 == 0 && start[0] == 0 ? carry[c0 + c] : T(0);
    acc = fold_rows(s_x, cols, c, r0, r1, acc);
    if (more && h + 1 == heads) s_run[c] = acc;
  }
  __syncthreads();
  store_rows<T>(ys, k, c0, cols, row0, s_head[0], stop, s_x);
  if (row0 + stop == n)
    for (int c = tid; c < cols; c += kSumThreads) carry_out[c0 + c] = s_x[(stop - 1) * cols + c];
  if (!more) return;

  // the block continues its last run, one window at a time
  for (int64_t pos = row0 + lim;;) {
    __syncthreads();  // the staged rows are stored and s_stop is read
    const int64_t rest = n - pos;
    const int lim2 = rest < win ? (int)rest : win;
    stage_rows<T>(x, k, c0, cols, pos, lim2, s_x);
    const bool f0 = tid < lim2 && start[pos + tid] != 0;
    const bool f1 = kSumThreads + tid < lim2 && start[pos + kSumThreads + tid] != 0;
    if (tid == 0) s_stop = lim2;
    __syncthreads();
    if (f0) atomicMin(&s_stop, tid);
    if (f1) atomicMin(&s_stop, kSumThreads + tid);
    cp_async_wait_all();
    __syncthreads();
    const int end = s_stop;
    for (int c = tid; c < cols; c += kSumThreads) {
      const T acc = fold_rows(s_x, cols, c, 0, end, s_run[c]);
      s_run[c] = acc;
      if (pos + end == n) carry_out[c0 + c] = acc;
    }
    __syncthreads();
    store_rows<T>(ys, k, c0, cols, pos, 0, end, s_x);
    if (end < lim2 || pos + lim2 == n) return;
    pos += lim2;
  }
}

template <typename T>
int launch_sum(const void* x, const void* start, const void* carry, int64_t n, int64_t k,
               void* ys, void* carry_out, cudaStream_t st) {
  const int kc = k < kSumMaxCols ? (int)k : kSumMaxCols;
  const int rows = sum_tile_rows(kc);
  const int64_t tiles = (n + rows - 1) / rows;
  const int64_t slices = (k + kc - 1) / kc;
  if (tiles > INT32_MAX || slices > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)((rows + kSumHalo) * kc + kc) * sizeof(T);
  sum_scan<T><<<dim3((unsigned)tiles, (unsigned)slices), kSumThreads, smem, st>>>(
      (const T*)x, (const uint8_t*)start, (const T*)carry, n, k, rows, kc, (T*)ys,
      (T*)carry_out);
  return (int)cudaGetLastError();
}

template <bool kPerRowMul>
int launch_affine(const void* mul, uint32_t base, const void* add, const void* start,
                  const void* carry, int64_t n, void* ys, void* carry_out,
                  void* scratch, cudaStream_t st) {
  const int64_t tiles = (n + kTileRows - 1) / kTileRows;
  const cudaError_t err = cudaMemsetAsync(scratch, 0, (size_t)(tiles + 1) * 16 * kStatusStride, st);
  if (err != cudaSuccess) return (int)err;
  const auto a16 = [](const void* p) { return ((uintptr_t)p & 15u) == 0u; };
  const int aligned = (!kPerRowMul || a16(mul)) && a16(add) && a16(start) && a16(ys);
  affine_scan<kPerRowMul><<<(unsigned)tiles, kScanThreads, 0, st>>>(
      (const uint32_t*)mul, base, (const uint32_t*)add, (const uint8_t*)start,
      (const uint32_t*)carry, n, aligned, (uint32_t*)ys, (uint32_t*)carry_out,
      (uint4*)scratch);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Rows a tile of the affine scan: the wrapper's scratch is 128 bytes a
// tile plus 128 (the ticket), 16-byte aligned.
extern "C" int repro_scan_tile_rows() { return kTileRows; }

// mul, add: (n,) uint32 (int32 storage); start: (n,) bool; carry: one
// uint32 on the device; ys: (n,) uint32 out; carry_out: one uint32 out,
// ys[n - 1]; scratch: see repro_scan_tile_rows, zeroed here on the stream. Returns the launch's
// cudaError_t (0 on success); never synchronizes.
extern "C" int repro_segmented_affine(const void* mul, const void* add,
                                      const void* start, const void* carry,
                                      int64_t n, void* ys, void* carry_out,
                                      void* scratch, void* stream) {
  if (n <= 0) return 0;
  return launch_affine<true>(mul, 0u, add, start, carry, n, ys, carry_out, scratch,
                             (cudaStream_t)stream);
}

// values: (n,) uint32 (int32 storage); base: taken mod 2^32; the rest as
// for repro_segmented_affine.
extern "C" int repro_segmented_polyhash(const void* values, int64_t base,
                                        const void* start, const void* carry,
                                        int64_t n, void* ys, void* carry_out,
                                        void* scratch, void* stream) {
  if (n <= 0) return 0;
  return launch_affine<false>(nullptr, (uint32_t)base, values, start, carry, n, ys,
                              carry_out, scratch, (cudaStream_t)stream);
}

// Rows a tile of the sum scan owns at k columns (the wrapper's
// sum_tile_rows).
extern "C" int repro_sum_tile_rows(int64_t k) {
  return sum_tile_rows(k < kSumMaxCols ? (int)k : kSumMaxCols);
}

// x, ys: (n, k) row-major, float32 (is_float == 1) or int32 (is_float ==
// 0); start: (n,) bool; carry, carry_out: (k,) of x's type on the device
// (carry_out is ys[n - 1]). Returns the launch's cudaError_t (0 on
// success; cudaErrorInvalidValue past the grid's limits); never
// synchronizes.
extern "C" int repro_segmented_sum_scan(const void* x, const void* start,
                                        const void* carry, int64_t n,
                                        int64_t k, int is_float, void* ys,
                                        void* carry_out, void* stream) {
  if (n <= 0 || k <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (is_float) return launch_sum<float>(x, start, carry, n, k, ys, carry_out, st);
  // int32 wraps like the plain version's add; computed as uint32 so the
  // wrap is defined behaviour
  return launch_sum<uint32_t>(x, start, carry, n, k, ys, carry_out, st);
}
