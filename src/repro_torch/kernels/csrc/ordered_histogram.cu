// Row-order float32 weighted bincount onto a running state, for Hopper
// (sm_90a): out[b] = into[b] (or 0) + w_i + w_j + ... over the rows i < j <
// ... whose value is b, added one at a time in row order, in float32. Values
// outside [0, B) (including -1) are dropped; zero weights are not skipped
// (adding +0.0 turns a -0.0 bin into +0.0, as the row-order scatter does).
//
// Replaces: no Pallas kernel. The JAX package leaves this fold to XLA's
// row-order scatter (src/repro/kernels/segment_ops/ref.py, histogram_ref
// and pair_count_ref with float weights and into=), which is what keeps a
// streamed float sum bitwise equal to the whole-log one: summing a chunk
// first and adding that to the state would regroup the additions.
//
// Bound on an H100 SXM: the longest chain of dependent float adds. Each
// row's value and weight are read once (8 bytes: 1.3 us for a 524,288-row
// chunk at 3.35 TB/s), but the fold of bin b is a chain of count(b)
// dependent adds that no parallel schedule may shorten without changing
// the result: the largest bin's count x 4 cycles at the SM clock. On an L1
// chunk the largest of 26 sojourn bins holds ~74,000 rows (0.150 ms at
// 1,980 MHz) and the largest of 676 pair bins ~17,000 (0.034 ms).
//
// Design: a stable counting sort by bin, then one chain per bin. One call
// launches five passes on the stream, with scratch the wrapper allocates:
//   1. count: each tile (1,024 rows up to 3,072 bins, 4,096 above) counts
//      its rows per bin into a (B, tiles) int32 array: in shared memory up
//      to 3,072 bins, else with one integer atomic per warp and bin (equal
//      values combined with __match_any_sync) into zeroed counts;
//   2. column: a block per bin, an exclusive scan over its tiles (in
//      place), the bin's total into bin_start[b];
//   3. scan: one block turns the totals into exclusive bin starts, so the
//      (bin, tile) offsets are in bin-major, tile-minor order;
//   4. scatter: one warp per tile walks its rows in order, 32 at a time
//      (8 steps loaded ahead), and writes each weight to bin_start[b] +
//      offset[b][t] + its rank (earlier equal values in the tile, from
//      __match_any_sync), keeping row order within each bin: the sort is
//      stable, which is the point;
//   5. fold: one warp per bin stages its contiguous segment through shared
//      memory, 512 weights at a time with the next stage's loads in
//      flight, while lane 0 adds them onto into[b] (or 0) left to right,
//      reading each group of 8 vectors while the one before is added.
// The passes before the fold take ~15-30 us at a chunk; the fold runs at
// ~1.2 x its chain. Reads are O(N + tiles x B) where the one-block-per-bin
// design this replaced read O(B x N) and folded on one thread of 1,024 per
// block; no float is added out of row order and no float atomic is used,
// so the result stays bitwise equal to the CPU index_add_.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Up to kSmallBins bins the count and the scatter's cursors live in shared
// memory (4 warps x 3,072 x 4 B = 48 KB) and tiles are small (more warps in
// the scatter); above, they live in global memory and tiles are large (a
// smaller count array).
constexpr int kSmallBins = 3072;
constexpr int kTileSmall = 1024;        // rows per tile up to kSmallBins bins
constexpr int kTileLarge = 4096;        // rows per tile above
constexpr int kCountThreads = 512;      // pass 1: a block per tile
constexpr int kWarpsPerBlock = 4;       // passes 4 and 5: a warp per item
constexpr int kScanThreads = 512;       // passes 2 and 3: block scans
constexpr int kStage = 512;             // pass 5: weights staged per round
constexpr int kAhead = 8;               // pass 4: 32-row steps loaded ahead

__device__ __forceinline__ bool in_range(int32_t v, int32_t num_bins) {
  return (uint32_t)v < (uint32_t)num_bins;
}

// pass 1: counts[b][t] = rows of tile t with value b. Up to kSmallBins bins
// a block counts its tile in shared memory and writes its whole column;
// above, warps add into the zeroed counts with one integer atomic per run
// of equal values (__match_any_sync).
template <bool kSmall>
__global__ void __launch_bounds__(kCountThreads)
fold_count(const int32_t* __restrict__ values, int64_t n, int tile,
           int64_t tiles, int32_t num_bins, int32_t* __restrict__ counts) {
  extern __shared__ int32_t hist[];
  const int64_t t = blockIdx.x;
  const int64_t base = t * tile;
  if (kSmall) {
    for (int32_t b = threadIdx.x; b < num_bins; b += kCountThreads) hist[b] = 0;
    __syncthreads();
  }
  const unsigned lane = threadIdx.x & 31;
  for (int r = threadIdx.x; r < tile; r += kCountThreads) {
    const int64_t i = base + r;
    int32_t v = i < n ? values[i] : -1;
    if (!in_range(v, num_bins)) v = -1;
    if (kSmall) {
      if (v >= 0) atomicAdd(&hist[v], 1);
    } else {
      const unsigned peers = __match_any_sync(0xffffffffu, v);
      if (v >= 0 && lane == (unsigned)(__ffs(peers) - 1))
        atomicAdd(&counts[v * tiles + t], __popc(peers));
    }
  }
  if (kSmall) {
    __syncthreads();
    for (int32_t b = threadIdx.x; b < num_bins; b += kCountThreads)
      counts[b * tiles + t] = hist[b];
  }
}

// An exclusive prefix of x over the block's kScanThreads threads, in
// thread order; *total gets the block's sum. Every thread calls it.
__device__ __forceinline__ int32_t block_exclusive_scan(int32_t x, int32_t* total) {
  __shared__ int32_t warp_sums[kScanThreads / 32];
  __shared__ int32_t total_s;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t incl = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t up = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += up;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int32_t s = lane < kScanThreads / 32 ? warp_sums[lane] : 0;
    int32_t ws = s;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t up = __shfl_up_sync(0xffffffffu, ws, d);
      if (lane >= d) ws += up;
    }
    if (lane < kScanThreads / 32) warp_sums[lane] = ws - s;   // over the warps
    if (lane == 31) total_s = ws;
  }
  __syncthreads();
  const int32_t out = warp_sums[warp] + incl - x;
  *total = total_s;
  __syncthreads();                              // warp_sums, total_s reused
  return out;
}

// pass 2: a block per bin, the exclusive prefix of its counts over the
// tiles (in place); the bin's total into totals[b]
__global__ void __launch_bounds__(kScanThreads)
fold_column(int32_t* __restrict__ counts, int64_t tiles, int32_t num_bins,
            int32_t* __restrict__ totals) {
  const int32_t b = blockIdx.x;
  int32_t carry = 0;
  int32_t* row = counts + (int64_t)b * tiles;
  for (int64_t t0 = 0; t0 < tiles; t0 += kScanThreads) {
    const int64_t t = t0 + threadIdx.x;
    const int32_t x = t < tiles ? row[t] : 0;
    int32_t sum;
    const int32_t ex = block_exclusive_scan(x, &sum);
    if (t < tiles) row[t] = carry + ex;
    carry += sum;
  }
  if (threadIdx.x == 0) totals[b] = carry;
}

// pass 3: bin_start[0..B) totals -> exclusive starts, bin_start[B] = total
__global__ void __launch_bounds__(kScanThreads)
fold_scan(int32_t* __restrict__ bin_start, int32_t num_bins) {
  int32_t carry = 0;
  for (int32_t base = 0; base < num_bins; base += kScanThreads) {
    const int32_t b = base + threadIdx.x;
    const int32_t x = b < num_bins ? bin_start[b] : 0;
    int32_t sum;
    const int32_t ex = block_exclusive_scan(x, &sum);
    if (b < num_bins) bin_start[b] = carry + ex;
    carry += sum;
  }
  if (threadIdx.x == 0) bin_start[num_bins] = carry;
}

// pass 4: a warp per tile scatters its weights to their sorted places,
// keeping row order within each bin. The tile's cursors live in shared
// memory up to kSmallBins bins, else in the tile's column of counts.
template <bool kSmall>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
fold_scatter(const int32_t* __restrict__ values, const float* __restrict__ w,
             int64_t n, int tile, int64_t tiles, int32_t num_bins,
             int32_t* __restrict__ counts, const int32_t* __restrict__ bin_start,
             float* __restrict__ sorted) {
  extern __shared__ int32_t cursor_s[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t t = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (t >= tiles) return;                       // whole warps leave
  // bin b's cursor: cur[b * stride]
  int32_t* cur = kSmall ? cursor_s + warp * num_bins : counts + t;
  const int64_t stride = kSmall ? 1 : tiles;
#pragma unroll 4
  for (int32_t b = lane; b < num_bins; b += 32)
    cur[b * stride] = bin_start[b] + counts[b * tiles + t];
  __syncwarp();
  const unsigned lower = (1u << lane) - 1u;
  const int64_t base = t * tile;
  const int64_t end = base + tile < n ? base + tile : n;
  // row base + 32 s + lane is step s; kAhead steps are in registers while
  // the next kAhead load
  int32_t v_cur[kAhead];
  float w_cur[kAhead];
#pragma unroll
  for (int u = 0; u < kAhead; ++u) {
    const int64_t i = base + 32 * u + lane;
    v_cur[u] = i < end ? values[i] : -1;
    w_cur[u] = i < end ? w[i] : 0.0f;
  }
  for (int64_t g0 = base; g0 < end; g0 += 32 * kAhead) {
    int32_t v_next[kAhead];
    float w_next[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int64_t i = g0 + 32 * (kAhead + u) + lane;
      v_next[u] = i < end ? values[i] : -1;
      w_next[u] = i < end ? w[i] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int32_t v = in_range(v_cur[u], num_bins) ? v_cur[u] : -1;
      const unsigned peers = __match_any_sync(0xffffffffu, v);
      int32_t pos = 0;
      if (v >= 0) {
        pos = cur[v * stride];
        sorted[pos + __popc(peers & lower)] = w_cur[u];
      }
      __syncwarp();                             // every lane read cur[v]
      if (v >= 0 && lane == __ffs(peers) - 1) cur[v * stride] = pos + __popc(peers);
      __syncwarp();                             // before the next read
      v_cur[u] = v_next[u];
      w_cur[u] = w_next[u];
    }
  }
}

// pass 5: a warp per bin folds its segment left to right onto into[b]
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
fold_bins(const float* __restrict__ sorted, const int32_t* __restrict__ bin_start,
          int32_t num_bins, const float* __restrict__ into,
          float* __restrict__ out) {
  __shared__ __align__(16) float stage[kWarpsPerBlock][kStage];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int32_t b = blockIdx.x * kWarpsPerBlock + warp;
  if (b >= num_bins) return;
  const int32_t lo = bin_start[b], hi = bin_start[b + 1];
  float* buf = stage[warp];
  float acc = into != nullptr ? into[b] : 0.0f;
  constexpr int kPer = kStage / 32;
  float next[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int32_t i = lo + j * 32 + lane;
    next[j] = i < hi ? sorted[i] : 0.0f;
  }
  for (int32_t c = lo; c < hi; c += kStage) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) buf[j * 32 + lane] = next[j];
    __syncwarp();
    // the next batch's loads are in flight while lane 0 adds this one
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int32_t i = c + kStage + j * 32 + lane;
      next[j] = i < hi ? sorted[i] : 0.0f;
    }
    if (lane == 0) {
      const float4* v4 = reinterpret_cast<const float4*>(buf);
      if (hi - c >= kStage) {
        // a full stage: each group of 8 vectors is read while the group
        // before it is added, so only the adds are serial
        float4 x[8], y[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) x[u] = v4[u];
#pragma unroll
        for (int g = 0; g < kStage / 32; ++g) {
          if (g + 1 < kStage / 32) {
#pragma unroll
            for (int u = 0; u < 8; ++u) y[u] = v4[8 * (g + 1) + u];
          }
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            acc += x[u].x;
            acc += x[u].y;
            acc += x[u].z;
            acc += x[u].w;
          }
#pragma unroll
          for (int u = 0; u < 8; ++u) x[u] = y[u];
        }
      } else {
        for (int k = 0; k < hi - c; ++k) acc += buf[k];
      }
    }
    __syncwarp();                               // buf is rewritten next
  }
  if (lane == 0) out[b] = acc;
}

}  // namespace

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// values: (n,) int32; w: (n,) float32; into: (num_bins,) float32 or null
// (start from 0); out: (num_bins,) float32, every bin written. Scratch from
// the caller: counts (num_bins, tiles) int32 with tiles = ceil(n / tile), the
// tile 1,024 rows up to 3,072 bins and 4,096 rows above,
// bin_start (num_bins + 1,) int32, sorted (n,) float32. n < 2^31. Launches
// five kernels (and a memset above 3,072 bins) on the stream; returns the
// first cudaError_t
// (0 on success); never synchronizes.
extern "C" int repro_ordered_histogram(const void* values, const void* w,
                                       int64_t n, int64_t num_bins,
                                       const void* into, void* out,
                                       void* counts, void* bin_start,
                                       void* sorted, void* stream) {
  if (num_bins <= 0) return 0;
  if (num_bins > INT32_MAX || n < 0 || n > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int32_t bins = (int32_t)num_bins;
  const int tile = num_bins <= kSmallBins ? kTileSmall : kTileLarge;
  const int64_t tiles = (n + tile - 1) / tile;
  int32_t* cnt = static_cast<int32_t*>(counts);
  int32_t* start = static_cast<int32_t*>(bin_start);
  const int32_t* v = static_cast<const int32_t*>(values);
  const float* wf = static_cast<const float*>(w);
  float* srt = static_cast<float*>(sorted);
  cudaError_t err;
  if (tiles > 0) {
    if (num_bins <= kSmallBins) {
      fold_count<true><<<(unsigned)tiles, kCountThreads, num_bins * sizeof(int32_t), s>>>(
          v, n, tile, tiles, bins, cnt);
    } else {
      err = cudaMemsetAsync(cnt, 0, (size_t)tiles * num_bins * sizeof(int32_t), s);
      if (err != cudaSuccess) return (int)err;
      fold_count<false><<<(unsigned)tiles, kCountThreads, 0, s>>>(v, n, tile, tiles,
                                                                 bins, cnt);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  fold_column<<<(unsigned)num_bins, kScanThreads, 0, s>>>(cnt, tiles, bins, start);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  fold_scan<<<1, kScanThreads, 0, s>>>(start, bins);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (tiles > 0) {
    const unsigned grid = (unsigned)((tiles + kWarpsPerBlock - 1) / kWarpsPerBlock);
    if (num_bins <= kSmallBins) {
      const size_t smem = (size_t)kWarpsPerBlock * num_bins * sizeof(int32_t);
      fold_scatter<true><<<grid, kWarpsPerBlock * 32, smem, s>>>(
          v, wf, n, tile, tiles, bins, cnt, start, srt);
    } else {
      fold_scatter<false><<<grid, kWarpsPerBlock * 32, 0, s>>>(
          v, wf, n, tile, tiles, bins, cnt, start, srt);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  fold_bins<<<(unsigned)((num_bins + kWarpsPerBlock - 1) / kWarpsPerBlock),
              kWarpsPerBlock * 32, 0, s>>>(srt, start, bins,
                                           static_cast<const float*>(into),
                                           static_cast<float*>(out));
  return (int)cudaGetLastError();
}
