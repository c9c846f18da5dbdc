// The counting pass shared by histogram.cu and pair_count.cu, for Hopper
// (sm_90a): out[k_i] = into[k_i] (or 0) + sum of w_i over the rows whose
// key k_i lies in [0, B) and whose weight is not 0, in int32 (mod 2^32, as
// index_add_ is). The key is the id (histogram) or src * D + dst
// (pair_count); weights are int32 (negative ones included) or 1-byte bools.
//
// Shared-memory route (B int32 bins fit a block, B <= 58,112): two kernels.
//
// count_rows: block g of a grid of G (at most two an SM) walks a contiguous
// share of the rows in 4-row groups, one group a thread a step: the ids
// are one 16-byte load a column and the weights one 16-byte (int32) or
// 4-byte (bool) load. The rows before the first 16-byte boundary (a slice
// t[lo:hi] with lo % 4 != 0) and after the last whole group, six at most,
// are added by block 0 one at a time; when the inputs' offsets from a
// 16-byte boundary differ, every group is read as four scalar loads
// instead. The block adds into one copy of the bins in shared memory
// (per-warp copies were slower at the main path's 26 and 676 bins: zeroing
// and summing them cost more than the same-address atomics they spare)
// and stores them as row g of partials (G, B) with plain coalesced stores.
//
// count_finish: a block of 32 warps takes 32 bins; lane j sums bin j's
// partials over every 32nd row from its warp's (one 128-byte line a warp a
// row), the warps' sums meet in shared memory and warp 0 stores out[b] =
// into[b] + sum once. No bin is zero-filled beforehand, no global atomic
// is issued and nothing persists from one call to the next.
//
// Both kernels are launched with programmatic dependent launch: each lets
// the next kernel of the stream be scheduled as soon as it starts
// (griddepcontrol.launch_dependents) and waits (griddepcontrol.wait) for
// every earlier kernel to finish, its stores visible, before it reads or
// writes device memory. So count_finish is resident while count_rows
// runs, and the next call's count_rows while count_finish runs; a launch
// no longer waits for the previous kernel to drain.
//
// Global route (more bins): the caller passes out already holding into (or
// zeros) and no partials; each row adds straight into out with a global
// atomic. No path of the port counts into that many bins.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace counting {

constexpr int kThreads = 512;         // count_rows' block
constexpr int kFinishWarps = 32;      // count_finish: 32 bins a block, rows split over its warps
constexpr int kMaxDevices = 64;
constexpr int64_t kSharedLimit = 232448;       // opt-in shared memory per block
constexpr int64_t kDefaultShared = 48 * 1024;  // above this, opt in first

struct IntWeights {
  const int32_t* p;
  __device__ __forceinline__ void load4(int64_t row, int32_t (&w)[4]) const {
    const int4 x = __ldg(reinterpret_cast<const int4*>(p + row));
    w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
  }
  __device__ __forceinline__ int32_t load1(int64_t row) const {
    return __ldg(p + row);
  }
};

struct BoolWeights {  // torch.bool: one byte a row, 0 or 1
  const uint8_t* p;
  __device__ __forceinline__ void load4(int64_t row, int32_t (&w)[4]) const {
    const uint32_t x = __ldg(reinterpret_cast<const unsigned int*>(p + row));
    w[0] = x & 0xff; w[1] = (x >> 8) & 0xff;
    w[2] = (x >> 16) & 0xff; w[3] = x >> 24;
  }
  __device__ __forceinline__ int32_t load1(int64_t row) const {
    return __ldg(p + row);
  }
};

struct IdKey {  // histogram: the id itself, -1 when outside [0, B)
  const int32_t* v;
  uint32_t bins;
  __device__ __forceinline__ int32_t key(int32_t x) const {
    return (uint32_t)x < bins ? x : -1;
  }
  __device__ __forceinline__ void load4(int64_t row, int32_t (&k)[4]) const {
    const int4 x = __ldg(reinterpret_cast<const int4*>(v + row));
    k[0] = key(x.x); k[1] = key(x.y); k[2] = key(x.z); k[3] = key(x.w);
  }
  __device__ __forceinline__ int32_t load1(int64_t row) const {
    return key(__ldg(v + row));
  }
};

struct PairKey {  // pair_count: src * D + dst, -1 when either is out of range
  const int32_t* src;
  const int32_t* dst;
  uint32_t num_src, num_dst;
  __device__ __forceinline__ int32_t key(int32_t s, int32_t d) const {
    return (uint32_t)s < num_src && (uint32_t)d < num_dst
               ? s * (int32_t)num_dst + d : -1;
  }
  __device__ __forceinline__ void load4(int64_t row, int32_t (&k)[4]) const {
    const int4 s = __ldg(reinterpret_cast<const int4*>(src + row));
    const int4 d = __ldg(reinterpret_cast<const int4*>(dst + row));
    k[0] = key(s.x, d.x); k[1] = key(s.y, d.y);
    k[2] = key(s.z, d.z); k[3] = key(s.w, d.w);
  }
  __device__ __forceinline__ int32_t load1(int64_t row) const {
    return key(__ldg(src + row), __ldg(dst + row));
  }
};

__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;");
}

__device__ __forceinline__ void wait_for_earlier_kernels() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

template <bool kVec, class Key, class W>
__global__ void __launch_bounds__(kThreads, 2)
count_rows(Key key, W w, int64_t n, int32_t head, int32_t num_bins,
           int32_t* __restrict__ partials) {
  extern __shared__ int32_t bins[];
  for (int32_t i = threadIdx.x; i < num_bins; i += kThreads) bins[i] = 0;
  launch_dependents();
  wait_for_earlier_kernels();
  __syncthreads();
  const int64_t groups = (n - head) / 4;
  const int64_t per_block = (groups + gridDim.x - 1) / gridDim.x;
  const int64_t g0 = (int64_t)blockIdx.x * per_block;
  const int64_t g1 = g0 + per_block < groups ? g0 + per_block : groups;
  for (int64_t g = g0 + threadIdx.x; g < g1; g += kThreads) {
    const int64_t row = head + 4 * g;
    int32_t k[4], x[4];
    if constexpr (kVec) {
      key.load4(row, k);
      w.load4(row, x);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) k[j] = key.load1(row + j), x[j] = w.load1(row + j);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (k[j] >= 0 && x[j] != 0) atomicAdd(&bins[k[j]], x[j]);
    }
  }
  // the rows outside the whole groups: head rows before the first, at most
  // 3 after the last
  const int64_t tail = n - head - 4 * groups;
  if (blockIdx.x == 0 && threadIdx.x < head + tail) {
    const int64_t row = threadIdx.x < head
                            ? (int64_t)threadIdx.x
                            : head + 4 * groups + (threadIdx.x - head);
    const int32_t kr = key.load1(row), xr = w.load1(row);
    if (kr >= 0 && xr != 0) atomicAdd(&bins[kr], xr);
  }
  __syncthreads();
  int32_t* mine = partials + (int64_t)blockIdx.x * num_bins;
  for (int32_t b = threadIdx.x; b < num_bins; b += kThreads) mine[b] = bins[b];
}

__global__ void __launch_bounds__(kFinishWarps * 32)
count_finish(const int32_t* partials, int32_t grid, int32_t num_bins,
             const int32_t* __restrict__ into, int32_t* __restrict__ out) {
  __shared__ uint32_t sums[kFinishWarps][33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const int32_t b = blockIdx.x * 32 + lane;
  launch_dependents();
  wait_for_earlier_kernels();
  uint32_t s = 0;
  if (b < num_bins) {
#pragma unroll 8
    for (int32_t g = warp; g < grid; g += kFinishWarps) {
      s += (uint32_t)partials[(int64_t)g * num_bins + b];
    }
  }
  sums[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && b < num_bins) {
    uint32_t t = into != nullptr ? (uint32_t)into[b] : 0u;
#pragma unroll
    for (int i = 0; i < kFinishWarps; ++i) t += sums[i][lane];
    out[b] = (int32_t)t;
  }
}

// the global route: out already holds into (or zeros)
template <class W>
__global__ void count_global(const int32_t* __restrict__ src,
                             const int32_t* __restrict__ dst, W w, int64_t n,
                             int64_t num_src, int64_t num_dst,
                             int32_t* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += stride) {
    const int32_t we = w.load1(e);
    const int64_t s = src[e];
    const int64_t d = dst == nullptr ? 0 : dst[e];
    if (we != 0 && s >= 0 && s < num_src && d >= 0 && d < num_dst) {
      atomicAdd(&out[s * num_dst + d], we);
    }
  }
}

// A launch that may begin before the stream's previous kernel has drained
// (the kernel itself waits for it, see wait_for_earlier_kernels).
template <class... Params, class... Args>
cudaError_t launch_chained(void (*kernel)(Params...), int grid, int threads,
                           int64_t bytes, cudaStream_t s, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <bool kVec, class Key, class W>
cudaError_t launch_rows(const Key& key, const W& w, int64_t n, int32_t head,
                        int32_t num_bins, int grid, int device,
                        int32_t* partials, cudaStream_t s) {
  // one opt-in per device and kernel, not one a call
  static bool opted_in[kMaxDevices] = {};
  auto kernel = count_rows<kVec, Key, W>;
  const int64_t bytes = (int64_t)num_bins * (int64_t)sizeof(int32_t);
  if (bytes > kSharedLimit) return cudaErrorInvalidValue;
  if (bytes > kDefaultShared) {
    if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
    if (!opted_in[device]) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSharedLimit);
      if (err != cudaSuccess) return err;
      opted_in[device] = true;
    }
  }
  return launch_chained(kernel, grid, kThreads, bytes, s, key, w, n, head,
                        num_bins, partials);
}

// partials != nullptr: count_rows over `grid` blocks into partials, then
// count_finish; nullptr: the global route (out already holds into or
// zeros). head >= 0: the inputs are read 16 bytes a load after `head` rows;
// -1: four scalar loads a group. Returns the launches' cudaError_t (0 on
// success); never synchronizes.
template <class Key, class W>
cudaError_t count(const Key& key, const W& w, const int32_t* src,
                  const int32_t* dst, int64_t n, int64_t num_src,
                  int64_t num_dst, const void* into, void* out, void* partials,
                  int grid, int head, int device, cudaStream_t s) {
  const int64_t num_bins = num_src * num_dst;
  if (n <= 0 || num_bins <= 0 || grid <= 0) return cudaErrorInvalidValue;
  if (partials == nullptr) {
    count_global<<<grid, kThreads, 0, s>>>(src, dst, w, n, num_src, num_dst,
                                           (int32_t*)out);
    return cudaGetLastError();
  }
  if (head > 3) return cudaErrorInvalidValue;
  cudaError_t err =
      head >= 0
          ? launch_rows<true>(key, w, n, head, (int32_t)num_bins, grid, device,
                              (int32_t*)partials, s)
          : launch_rows<false>(key, w, n, 0, (int32_t)num_bins, grid, device,
                               (int32_t*)partials, s);
  if (err != cudaSuccess) return err;
  err = launch_chained(count_finish, (int)((num_bins + 31) / 32),
                       kFinishWarps * 32, 0, s, (const int32_t*)partials,
                       (int32_t)grid, (int32_t)num_bins, (const int32_t*)into,
                       (int32_t*)out);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <class Key>
int count_weighted(const Key& key, const void* w, int w_bool,
                   const int32_t* src, const int32_t* dst, int64_t n,
                   int64_t num_src, int64_t num_dst, const void* into,
                   void* out, void* partials, int grid, int head, int device,
                   void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (w_bool) {
    return (int)count(key, BoolWeights{(const uint8_t*)w}, src, dst, n, num_src,
                      num_dst, into, out, partials, grid, head, device, s);
  }
  return (int)count(key, IntWeights{(const int32_t*)w}, src, dst, n, num_src,
                    num_dst, into, out, partials, grid, head, device, s);
}

}  // namespace counting
