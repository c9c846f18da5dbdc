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
// Design of the sum scan: the blocks of the card run in no order, so no
// carry can flow from tile to tile as on the TPU, and float32 sums must
// keep row order. Instead each segment's run is given to the thread at
// its head (row 0, or a flagged row), which walks the run left to right
// and writes every inclusive value; the other threads exit after reading
// one flag. Runs never meet, so there is no shared state, no atomic and no
// second pass; a float sum is the row-order fold (0 + x_a) + x_b + ...,
// bitwise the sequential fold of the plain version. K neighbouring threads
// take the K columns of one row, so a run's loads and stores are
// contiguous. A run is walked 16 rows per step with the loads issued
// together; a run over a whole chunk is correct but serial in one thread
// (the event logs' cases are short: ~7 rows on average at L1, at most 64).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStep = 16;

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

// the sum scan over (n, k) rows: thread t takes row t / k, column t % k
template <typename T>
__global__ void sum_runs(const T* __restrict__ x,
                         const uint8_t* __restrict__ start,
                         const T* __restrict__ carry, int64_t n, int64_t k,
                         T* __restrict__ ys) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * k) return;
  const int64_t i = t / k;
  const int64_t c = t - i * k;
  const bool flagged = start[i] != 0;
  if (i > 0 && !flagged) return;                  // not a run head
  T h = (i == 0 && !flagged) ? carry[c] : T(0);
  h = h + x[t];
  ys[t] = h;
  int64_t j = i + 1;
  bool in_run = true;
  while (in_run && j + kStep <= n) {
    uint8_t ff[kStep];
    T xx[kStep];
#pragma unroll
    for (int r = 0; r < kStep; ++r) {
      ff[r] = start[j + r];
      xx[r] = x[(j + r) * k + c];
    }
#pragma unroll
    for (int r = 0; r < kStep; ++r) {
      if (in_run && !ff[r]) {
        h = h + xx[r];
        ys[(j + r) * k + c] = h;
      } else {
        in_run = false;
      }
    }
    j += kStep;
  }
  for (; in_run && j < n; ++j) {
    if (start[j]) break;
    h = h + x[j * k + c];
    ys[j * k + c] = h;
  }
}

unsigned blocks_for(int64_t threads) {
  return (unsigned)((threads + kThreads - 1) / kThreads);
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

// x, ys: (n, k) row-major, float32 (is_float == 1) or int32 (is_float ==
// 0); start: (n,) bool; carry: (k,) of x's type on the device.
extern "C" int repro_segmented_sum_scan(const void* x, const void* start,
                                        const void* carry, int64_t n,
                                        int64_t k, int is_float, void* ys,
                                        void* stream) {
  if (n <= 0 || k <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (is_float) {
    sum_runs<float><<<blocks_for(n * k), kThreads, 0, st>>>(
        (const float*)x, (const uint8_t*)start, (const float*)carry, n, k,
        (float*)ys);
  } else {
    // int32 wraps like the plain version's add; computed as uint32 so the
    // wrap is defined behaviour
    sum_runs<uint32_t><<<blocks_for(n * k), kThreads, 0, st>>>(
        (const uint32_t*)x, (const uint8_t*)start, (const uint32_t*)carry, n,
        k, (uint32_t*)ys);
  }
  return (int)cudaGetLastError();
}
