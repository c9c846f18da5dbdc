// Weighted (src, dst) pair counts into a dense (S, D) int32 matrix, for
// Hopper (sm_90a): out[src_i, dst_i] += w_i, with events whose ids fall
// outside [0, S) x [0, D) (including the -1 padding id) or whose weight is
// 0 dropped.
//
// Replaces: src/repro/kernels/segment_ops/pair_count.py, pair_count_pallas
// (the TPU's one-hot MXU matmul, (onehot(src) * w)^T @ onehot(dst)), and
// through it kernels/dfg_count/dfg_count.py, dfg_count_pallas.
//
// Bound on an H100 SXM: device-memory bytes. Each event reads src, dst and
// w once (12 bytes) and does one integer add; the (S, D) output is written
// once. At 3.35 TB/s a 524,288-event chunk needs 1.9 us and a 7e6-event log
// 25 us. The integer adds (one per event) are far below any compute peak.
//
// Design: a privatized histogram. When the S*D int32 cells fit one block's
// shared memory (227 KB: up to 241 x 241), every block keeps its own copy
// of the matrix in shared memory, walks the events with a grid-stride loop
// (coalesced 4-byte loads, each input byte read once) and adds into the
// copy with shared-memory atomics; then it flushes each non-zero cell with
// one global atomic. The grid is a small multiple of the SM count, so the
// flush (grid x non-zero cells) stays small beside the event stream. When
// the matrix does not fit, events add straight into global memory with
// atomics. Integer atomics are exact in any order (mod 2^32, as the plain
// index_add_ is), so the result is bitwise equal to the plain version.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int64_t kSharedLimit = 232448;       // opt-in shared memory per block
constexpr int64_t kDefaultShared = 48 * 1024;  // above this, opt in first

__global__ void pair_count_shared(const int32_t* __restrict__ src,
                                  const int32_t* __restrict__ dst,
                                  const int32_t* __restrict__ w, int64_t n,
                                  int32_t num_src, int32_t num_dst,
                                  int32_t* __restrict__ out) {
  extern __shared__ int32_t cells[];
  const int32_t total = num_src * num_dst;
  for (int32_t i = threadIdx.x; i < total; i += blockDim.x) cells[i] = 0;
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += stride) {
    const int32_t we = w[e];
    const int32_t s = src[e];
    const int32_t d = dst[e];
    if (we != 0 && (uint32_t)s < (uint32_t)num_src &&
        (uint32_t)d < (uint32_t)num_dst) {
      atomicAdd(&cells[s * num_dst + d], we);
    }
  }
  __syncthreads();
  for (int32_t i = threadIdx.x; i < total; i += blockDim.x) {
    const int32_t v = cells[i];
    if (v != 0) atomicAdd(&out[i], v);
  }
}

__global__ void pair_count_global(const int32_t* __restrict__ src,
                                  const int32_t* __restrict__ dst,
                                  const int32_t* __restrict__ w, int64_t n,
                                  int64_t num_src, int64_t num_dst,
                                  int32_t* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += stride) {
    const int32_t we = w[e];
    const int64_t s = src[e];
    const int64_t d = dst[e];
    if (we != 0 && s >= 0 && s < num_src && d >= 0 && d < num_dst) {
      atomicAdd(&out[s * num_dst + d], we);
    }
  }
}

}  // namespace

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// out must be a zeroed (num_src, num_dst) int32 buffer on the current device.
// Returns the launch's cudaError_t (0 on success); never synchronizes.
extern "C" int repro_pair_count(const void* src, const void* dst,
                                const void* w, int64_t n, int64_t num_src,
                                int64_t num_dst, void* out, void* stream) {
  if (n <= 0 || num_src <= 0 || num_dst <= 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  const int64_t need = (n + kThreads - 1) / kThreads;
  const int64_t bytes = num_src * num_dst * (int64_t)sizeof(int32_t);
  if (bytes <= kSharedLimit) {
    if (bytes > kDefaultShared) {
      err = cudaFuncSetAttribute(pair_count_shared,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)bytes);
      if (err != cudaSuccess) return (int)err;
    }
    // two resident blocks per SM while two copies fit the SM's 228 KB
    const int64_t per_sm = bytes <= kSharedLimit / 2 - 1024 ? 2 : 1;
    const int grid = (int)(need < per_sm * sms ? need : per_sm * sms);
    pair_count_shared<<<grid, kThreads, (size_t)bytes, s>>>(
        (const int32_t*)src, (const int32_t*)dst, (const int32_t*)w, n,
        (int32_t)num_src, (int32_t)num_dst, (int32_t*)out);
  } else {
    const int grid = (int)(need < 8LL * sms ? need : 8LL * sms);
    pair_count_global<<<grid, kThreads, 0, s>>>(
        (const int32_t*)src, (const int32_t*)dst, (const int32_t*)w, n,
        num_src, num_dst, (int32_t*)out);
  }
  return (int)cudaGetLastError();
}
