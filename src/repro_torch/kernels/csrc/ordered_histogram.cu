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
// Bound on an H100 SXM: device-memory bytes. Each row reads its value and
// weight once (8 bytes); the bins are read and written once. At 3.35 TB/s
// a 524,288-row chunk needs 1.3 us. The fold itself is a chain of dependent
// float adds per bin (about N / B of them), which no parallel schedule may
// shorten without changing the result.
//
// Design: one block per bin. The block walks the rows in tiles of 8,192;
// every thread classifies 8 rows of the tile, warps compact the matching
// weights into shared memory in row order (ballot, popc and a prefix over
// the warps' counts), and thread 0 folds the compacted weights onto the
// bin's accumulator, which starts at into[b]. Every block reads every row,
// so the reads are O(B x N) (from L2 after the first block): cheap at 26
// bins, measured at 676. A stable counting sort by bin followed by one
// fold per bin would scale with B; it is not written yet.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 8;
constexpr int kTile = kThreads * kRounds;

__global__ void __launch_bounds__(kThreads)
ordered_histogram_bins(const int32_t* __restrict__ values,
                       const float* __restrict__ w, int64_t n,
                       const float* __restrict__ into,
                       float* __restrict__ out) {
  __shared__ float buf[kTile];
  __shared__ int counts[kRounds][kWarps];   // matches per (round, warp)
  __shared__ int offsets[kRounds][kWarps];  // their exclusive prefix per round
  __shared__ int round_total[kRounds];
  const int32_t bin = (int32_t)blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  float acc = 0.0f;
  if (threadIdx.x == 0 && into != nullptr) acc = into[bin];

  for (int64_t base = 0; base < n; base += kTile) {
    // 1. classify: row base + r * kThreads + threadIdx.x is the r-th round;
    //    row order inside the tile is (round, warp, lane)
    unsigned masks[kRounds];
    float wv[kRounds];
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int64_t row = base + (int64_t)r * kThreads + threadIdx.x;
      const bool hit = row < n && values[row] == bin;
      wv[r] = hit ? w[row] : 0.0f;
      masks[r] = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) counts[r][warp] = __popc(masks[r]);
    }
    __syncthreads();
    // 2. exclusive prefix over the tile's (round, warp) counts: warp r scans
    //    round r, then every round adds the totals of the rounds before it
    if (warp < kRounds) {
      const int c = counts[warp][lane];
      int incl = c;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += up;
      }
      offsets[warp][lane] = incl - c;
      if (lane == 31) round_total[warp] = incl;
    }
    __syncthreads();
    int round_base[kRounds];
    int running = 0;
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      round_base[r] = running;
      running += round_total[r];
    }
    // 3. compact the matching weights into buf, in row order
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      if (masks[r] & (1u << lane)) {
        buf[round_base[r] + offsets[r][warp] + __popc(masks[r] & below)] = wv[r];
      }
    }
    __syncthreads();
    // 4. one thread folds them onto the accumulator, left to right
    if (threadIdx.x == 0) {
#pragma unroll 8
      for (int k = 0; k < running; ++k) acc += buf[k];
    }
    __syncthreads();  // buf and counts are rewritten by the next tile
  }
  if (threadIdx.x == 0) out[bin] = acc;
}

}  // namespace

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// values: (n,) int32; w: (n,) float32; into: (num_bins,) float32 or null
// (start from 0); out: (num_bins,) float32, every bin written. May be
// launched with n == 0 (out = into or 0). Returns the launch's cudaError_t
// (0 on success); never synchronizes.
extern "C" int repro_ordered_histogram(const void* values, const void* w,
                                       int64_t n, int64_t num_bins,
                                       const void* into, void* out,
                                       void* stream) {
  if (num_bins <= 0) return 0;
  if (num_bins > INT32_MAX) return (int)cudaErrorInvalidValue;
  ordered_histogram_bins<<<(unsigned)num_bins, kThreads, 0,
                           (cudaStream_t)stream>>>(
      (const int32_t*)values, (const float*)w, n, (const float*)into,
      (float*)out);
  return (int)cudaGetLastError();
}
