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
// Design: the blocks of the card run in no order, so no carry can flow
// from tile to tile as on the TPU. Instead each segment's run is given to
// the thread at its head (row 0, or a flagged row), which walks the run
// left to right and writes every inclusive value; the other threads exit
// after reading one flag. Runs never meet, so there is no shared state, no
// atomic and no second pass; uint32 wraps natively, and a float sum is
// the row-order fold (0 + x_a) + x_b + ..., bitwise the sequential fold of
// the plain version. For the (N, K) sum, K neighbouring threads take the K
// columns of one row, so a run's loads and stores are contiguous. A run is
// walked 16 rows per step with the loads issued together; a run over a
// whole chunk is correct but serial in one thread (the event logs' cases
// are short: ~7 rows on average at L1, at most 64).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStep = 16;

// the affine scan; kPerRowMul == false is polyhash (mul == base everywhere)
template <bool kPerRowMul>
__global__ void affine_runs(const uint32_t* __restrict__ mul, uint32_t base,
                            const uint32_t* __restrict__ add,
                            const uint8_t* __restrict__ start,
                            const uint32_t* __restrict__ carry, int64_t n,
                            uint32_t* __restrict__ ys) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const bool flagged = start[i] != 0;
  if (i > 0 && !flagged) return;                  // not a run head
  uint32_t h = (i == 0 && !flagged) ? *carry : 0u;
  h = h * (kPerRowMul ? mul[i] : base) + add[i];
  ys[i] = h;
  int64_t j = i + 1;
  bool in_run = true;
  while (in_run && j + kStep <= n) {              // 16 rows, loads together
    uint8_t ff[kStep];
    uint32_t mm[kStep], bb[kStep];
#pragma unroll
    for (int k = 0; k < kStep; ++k) {
      ff[k] = start[j + k];
      bb[k] = add[j + k];
      mm[k] = kPerRowMul ? mul[j + k] : base;
    }
#pragma unroll
    for (int k = 0; k < kStep; ++k) {
      if (in_run && !ff[k]) {
        h = h * mm[k] + bb[k];
        ys[j + k] = h;
      } else {
        in_run = false;
      }
    }
    j += kStep;
  }
  for (; in_run && j < n; ++j) {                  // the ragged tail
    if (start[j]) break;
    h = h * (kPerRowMul ? mul[j] : base) + add[j];
    ys[j] = h;
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

}  // namespace

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// mul, add: (n,) uint32 (int32 storage); start: (n,) bool; carry: one
// uint32 on the device; ys: (n,) uint32 out. Returns the launch's
// cudaError_t (0 on success); never synchronizes.
extern "C" int repro_segmented_affine(const void* mul, const void* add,
                                      const void* start, const void* carry,
                                      int64_t n, void* ys, void* stream) {
  if (n <= 0) return 0;
  affine_runs<true><<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)mul, 0u, (const uint32_t*)add, (const uint8_t*)start,
      (const uint32_t*)carry, n, (uint32_t*)ys);
  return (int)cudaGetLastError();
}

// values: (n,) uint32 (int32 storage); base: taken mod 2^32; the rest as
// for repro_segmented_affine.
extern "C" int repro_segmented_polyhash(const void* values, int64_t base,
                                        const void* start, const void* carry,
                                        int64_t n, void* ys, void* stream) {
  if (n <= 0) return 0;
  affine_runs<false><<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      nullptr, (uint32_t)base, (const uint32_t*)values, (const uint8_t*)start,
      (const uint32_t*)carry, n, (uint32_t*)ys);
  return (int)cudaGetLastError();
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
