// Weighted bincount of unsorted int32 ids into int32 bins, for Hopper
// (sm_90a): out[v_i] += w_i, with ids outside [0, B) (including -1) or
// zero weights dropped. Weights may be negative.
//
// Replaces: src/repro/kernels/segment_ops/histogram.py, histogram_pallas
// (the TPU's VPU masked reduction of a (block_e, block_b) one-hot tile).
//
// Bound on an H100 SXM: device-memory bytes. Each event reads its id and
// weight once (8 bytes) and does one integer add; the (B,) output is
// written once. At 3.35 TB/s a 524,288-event chunk needs 1.3 us and a
// 7e6-event log 17 us.
//
// Design: a privatized histogram. When the B int32 bins fit one block's
// shared memory (227 KB: up to 58,112 bins, which covers the A^2 = 676
// bins of the literal shift-and-count DFG), every block keeps its own
// bins in shared memory, walks the events with a grid-stride loop
// (coalesced loads, each input byte read once), adds with shared-memory
// atomics, and flushes each non-zero bin with one global atomic; the grid
// is a small multiple of the SM count so the flush stays small. Larger
// bin counts add straight into global memory with atomics. Integer atomics
// are exact in any order (mod 2^32), so the result is bitwise equal to the
// plain index_add_.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int64_t kSharedLimit = 232448;       // opt-in shared memory per block
constexpr int64_t kDefaultShared = 48 * 1024;  // above this, opt in first

__global__ void histogram_shared(const int32_t* __restrict__ values,
                                 const int32_t* __restrict__ w, int64_t n,
                                 int32_t num_bins, int32_t* __restrict__ out) {
  extern __shared__ int32_t bins[];
  for (int32_t i = threadIdx.x; i < num_bins; i += blockDim.x) bins[i] = 0;
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += stride) {
    const int32_t we = w[e];
    const int32_t v = values[e];
    if (we != 0 && (uint32_t)v < (uint32_t)num_bins) atomicAdd(&bins[v], we);
  }
  __syncthreads();
  for (int32_t i = threadIdx.x; i < num_bins; i += blockDim.x) {
    const int32_t c = bins[i];
    if (c != 0) atomicAdd(&out[i], c);
  }
}

__global__ void histogram_global(const int32_t* __restrict__ values,
                                 const int32_t* __restrict__ w, int64_t n,
                                 int64_t num_bins, int32_t* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += stride) {
    const int32_t we = w[e];
    const int64_t v = values[e];
    if (we != 0 && v >= 0 && v < num_bins) atomicAdd(&out[v], we);
  }
}

}  // namespace

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// out must be a zeroed (num_bins,) int32 buffer on the current device.
// Returns the launch's cudaError_t (0 on success); never synchronizes.
extern "C" int repro_histogram(const void* values, const void* w, int64_t n,
                               int64_t num_bins, void* out, void* stream) {
  if (n <= 0 || num_bins <= 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  const int64_t need = (n + kThreads - 1) / kThreads;
  const int64_t bytes = num_bins * (int64_t)sizeof(int32_t);
  if (bytes <= kSharedLimit) {
    if (bytes > kDefaultShared) {
      err = cudaFuncSetAttribute(histogram_shared,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)bytes);
      if (err != cudaSuccess) return (int)err;
    }
    // two resident blocks per SM while two copies fit the SM's 228 KB
    const int64_t per_sm = bytes <= kSharedLimit / 2 - 1024 ? 2 : 1;
    const int grid = (int)(need < per_sm * sms ? need : per_sm * sms);
    histogram_shared<<<grid, kThreads, (size_t)bytes, s>>>(
        (const int32_t*)values, (const int32_t*)w, n, (int32_t)num_bins,
        (int32_t*)out);
  } else {
    const int grid = (int)(need < 8LL * sms ? need : 8LL * sms);
    histogram_global<<<grid, kThreads, 0, s>>>(
        (const int32_t*)values, (const int32_t*)w, n, num_bins,
        (int32_t*)out);
  }
  return (int)cudaGetLastError();
}
