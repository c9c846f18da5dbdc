// Semiring matrix product C = A (x) B of a float32 (M, K) A and (K, N) B,
// for Hopper (sm_90a), in three semirings:
//
//   plus_times  C[i, j] = sum_k A[i, k] * B[k, j]        (path counting and
//                                                       the 0/1 closures)
//   min_plus    C[i, j] = min_k A[i, k] + B[k, j]        (shortest paths)
//   max_min     C[i, j] = max_k min(A[i, k], B[k, j])    (widest paths)
//
// Replaces: src/repro/kernels/graph_ops/semiring.py, semiring_matmul_pallas
// (the TPU kernel pads both operands with the semiring's identity, tiles the
// output on the grid's i, j axes and carries each output tile in VMEM
// across a sequential k axis; plus_times rides the MXU, the tropical
// semirings are VPU broadcast reductions).
//
// Bound on an H100 SXM: the larger of the bytes (M*K + K*N + M*N floats at
// 3.35 TB/s) and the operations (2*M*N*K at the 67 T op/s of float32
// outside the tensor cores). At the process graphs' N = 28 every launch
// is far below both (about 10 ns each): the launch itself is the cost, and
// a closure is about 5 dependent squarings. At N = 384 the operations
// bound it at 1.7 us.
//
// Design: one tiled SIMT kernel template over the semiring's two
// operations, instantiated three times. A block of 16 x 16 threads owns a
// 32 x 32 output tile, 2 x 2 outputs a thread, kept in registers from the
// identity on. The block walks k in ascending order in steps of 32: it
// stages the A and B tiles in shared memory (A transposed, rows padded by
// one word against bank conflicts), then each thread folds the 32 k of its
// four outputs in order. Blocks are independent: the loop inside the block
// takes the place of the TPU's sequential k grid axis. Ragged edges are
// masked in the load: an element outside A or B reads as the identity, and
// a padded k has the identity on both sides, which changes no output
// (0 * 0 + acc, inf + inf, min(-inf, -inf)). Nothing is padded in memory.
//
// Exactness: plus_times is one fmaf per k, in k order, in full float32 (no
// TF32, no tensor cores): exact, and so bitwise equal to any other order,
// while the operands and every partial sum are integers below 2^24, which
// covers the 0/1 closures that threshold "> 0"; other floats agree with
// another order of the same sum within rounding. Each tropical candidate is
// one operation and min / max do not depend on order, so those results are
// bitwise the plain version's for any tiling. min and max propagate NaN as
// torch.minimum / torch.amin do (fminf / fmaxf would drop it); the graph
// queries feed no NaN (min_plus operands are finite or +inf).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;    // output tile edge
constexpr int kTileK = 32;   // k step
constexpr int kHalf = 16;    // threads per tile edge: 2 outputs each way
constexpr int kThreads = kHalf * kHalf;

struct PlusTimes {
  static __device__ __forceinline__ float identity() { return 0.0f; }
  static __device__ __forceinline__ float step(float acc, float a, float b) {
    return fmaf(a, b, acc);
  }
};

struct MinPlus {
  static __device__ __forceinline__ float identity() { return INFINITY; }
  static __device__ __forceinline__ float step(float acc, float a, float b) {
    const float c = a + b;
    return (c < acc || isnan(c)) ? c : acc;
  }
};

struct MaxMin {
  static __device__ __forceinline__ float identity() { return -INFINITY; }
  static __device__ __forceinline__ float step(float acc, float a, float b) {
    const float c = (isnan(a) || isnan(b)) ? NAN : fminf(a, b);
    return (c > acc || isnan(c)) ? c : acc;
  }
};

template <class S>
__global__ void __launch_bounds__(kThreads)
semiring_tile(const float* __restrict__ a, const float* __restrict__ b,
              float* __restrict__ c, int64_t m, int64_t k, int64_t n) {
  __shared__ float as[kTileK][kTile + 1];   // as[kk][r] = A[row0 + r, k0 + kk]
  __shared__ float bs[kTileK][kTile + 1];   // bs[kk][q] = B[k0 + kk, col0 + q]
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kHalf + tx;
  const int64_t row0 = (int64_t)blockIdx.y * kTile;
  const int64_t col0 = (int64_t)blockIdx.x * kTile;
  const float ident = S::identity();
  float acc00 = ident, acc01 = ident, acc10 = ident, acc11 = ident;

  for (int64_t k0 = 0; k0 < k; k0 += kTileK) {
    // A tile: neighbouring threads read neighbouring k of one row
    for (int t = tid; t < kTile * kTileK; t += kThreads) {
      const int r = t / kTileK, kk = t % kTileK;
      const int64_t gi = row0 + r, gk = k0 + kk;
      as[kk][r] = (gi < m && gk < k) ? a[gi * k + gk] : ident;
    }
    // B tile: neighbouring threads read neighbouring columns of one row
    for (int t = tid; t < kTile * kTileK; t += kThreads) {
      const int kk = t / kTile, q = t % kTile;
      const int64_t gk = k0 + kk, gj = col0 + q;
      bs[kk][q] = (gk < k && gj < n) ? b[gk * n + gj] : ident;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kTileK; ++kk) {
      const float a0 = as[kk][ty], a1 = as[kk][ty + kHalf];
      const float b0 = bs[kk][tx], b1 = bs[kk][tx + kHalf];
      acc00 = S::step(acc00, a0, b0);
      acc01 = S::step(acc01, a0, b1);
      acc10 = S::step(acc10, a1, b0);
      acc11 = S::step(acc11, a1, b1);
    }
    __syncthreads();
  }
  const int64_t i0 = row0 + ty, i1 = i0 + kHalf;
  const int64_t j0 = col0 + tx, j1 = j0 + kHalf;
  if (i0 < m) {
    if (j0 < n) c[i0 * n + j0] = acc00;
    if (j1 < n) c[i0 * n + j1] = acc01;
  }
  if (i1 < m) {
    if (j0 < n) c[i1 * n + j0] = acc10;
    if (j1 < n) c[i1 * n + j1] = acc11;
  }
}

}  // namespace

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// semiring: 0 plus_times, 1 min_plus, 2 max_min. a (m, k), b (k, n) and c
// (m, n) are contiguous row-major float32 on the current device; every
// element of c is written. Returns the launch's cudaError_t (0 on success);
// never synchronizes.
extern "C" int repro_semiring_matmul(const void* a, const void* b, void* c,
                                     int64_t m, int64_t k, int64_t n,
                                     int semiring, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  const int64_t gy = (m + kTile - 1) / kTile;
  const int64_t gx = (n + kTile - 1) / kTile;
  if (gy > 65535 || gx > 2147483647LL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)gx, (unsigned)gy);
  const dim3 block(kHalf, kHalf);
  const cudaStream_t s = (cudaStream_t)stream;
  const float* pa = (const float*)a;
  const float* pb = (const float*)b;
  float* pc = (float*)c;
  switch (semiring) {
    case 0: semiring_tile<PlusTimes><<<grid, block, 0, s>>>(pa, pb, pc, m, k, n); break;
    case 1: semiring_tile<MinPlus><<<grid, block, 0, s>>>(pa, pb, pc, m, k, n); break;
    case 2: semiring_tile<MaxMin><<<grid, block, 0, s>>>(pa, pb, pc, m, k, n); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
