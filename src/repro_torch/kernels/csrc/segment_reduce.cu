// Sum / min / max of int32, uint32 or float32 values over sorted segment
// ids, for Hopper (sm_90a): out[s] = op(out[s], v_i ...) over the rows with
// id s, ids outside [0, S) (including -1) dropped. The caller fills out
// with the op's identity first (0, +-inf, the int32 bounds, or 0 /
// 0xFFFFFFFF for uint32 max / min), so empty segments keep it. uint32
// values (the variant hashes) compare unsigned: about half of them are
// >= 2^31, where a signed max would lose to the identity.
//
// Replaces: src/repro/kernels/segment_ops/segment_reduce.py,
// segment_reduce_pallas (a VMEM-resident output carried across a
// sequential grid, each block_e-row tile reduced through a one-hot window).
//
// Bound on an H100 SXM: device-memory bytes. Each row reads its id and
// value once (8 bytes) and does one add or compare; the (S,) output is
// written once by the identity fill. At 3.35 TB/s a 524,288-row chunk
// into S = 10^6 segments needs (4.2 + 4.0) MB / 3.35 TB/s = 2.4 us.
//
// Design: the ids are sorted, so each segment is one contiguous run. The
// thread at row i is a run head when i == 0 or id[i] != id[i-1]; it folds
// its run left to right, starting from the identity, and combines the
// result into out[id] once. No shared state and no ordering between
// threads is needed, and the float results are deterministic: a float32
// sum is the row-order fold ((0 + v_a) + v_b) + ..., bitwise what the
// row-order scatter of the plain version gives (the fold never produces
// -0.0 from a +0.0 start, so adding it onto the 0.0 identity changes no
// bit). The combine is atomic (integer atomics; a compare-and-swap loop for
// floats), so an id that appears in two runs (unsorted ids) still gives
// the exact integer and min/max results; only a float32 sum needs the ids
// sorted to stay in row order. A long run is walked by one
// thread, 16 rows per step with the loads issued together: a run over a
// whole chunk is correct but serial.
#include <cuda_runtime.h>
#include <stdint.h>

#include <limits>

namespace {

constexpr int kThreads = 256;
constexpr int kStep = 16;

enum Op { kSum = 0, kMin = 1, kMax = 2 };

template <int OP, typename T>
__device__ __forceinline__ T combine(T acc, T v) {
  if (OP == kSum) return acc + v;
  if (OP == kMin) return (v < acc || v != v) ? v : acc;  // NaN propagates
  return (v > acc || v != v) ? v : acc;
}

template <int OP>
__device__ __forceinline__ void store(int32_t* out, int32_t v) {
  if (OP == kSum) atomicAdd(out, v);
  else if (OP == kMin) atomicMin(out, v);
  else atomicMax(out, v);
}

template <int OP>
__device__ __forceinline__ void store(uint32_t* out, uint32_t v) {
  if (OP == kSum) atomicAdd(out, v);
  else if (OP == kMin) atomicMin(out, v);
  else atomicMax(out, v);
}

// float combine as a compare-and-swap loop in ordinary float arithmetic,
// the same addition the fold and the plain version do; with sorted ids each
// segment is written once, so the loop runs once
template <int OP>
__device__ __forceinline__ void store(float* out, float v) {
  int* p = reinterpret_cast<int*>(out);
  int old = *p;
  while (true) {
    const int next = __float_as_int(combine<OP>(__int_as_float(old), v));
    if (next == old) return;
    const int seen = atomicCAS(p, old, next);
    if (seen == old) return;
    old = seen;
  }
}

template <int OP, typename T>
__global__ void segment_reduce_runs(const int32_t* __restrict__ seg,
                                    const T* __restrict__ val, int64_t n,
                                    int32_t num_segments, T ident,
                                    T* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t s = seg[i];
  if (i > 0 && seg[i - 1] == s) return;            // not a run head
  if (s < 0 || s >= num_segments) return;          // dropped run
  T acc = ident;
  int64_t j = i;
  bool in_run = true;
  while (in_run && j + kStep <= n) {              // 16 rows, loads together
    int32_t ss[kStep];
    T vv[kStep];
#pragma unroll
    for (int k = 0; k < kStep; ++k) {
      ss[k] = seg[j + k];
      vv[k] = val[j + k];
    }
#pragma unroll
    for (int k = 0; k < kStep; ++k) {
      if (in_run && ss[k] == s) acc = combine<OP>(acc, vv[k]);
      else in_run = false;
    }
    j += kStep;
  }
  for (; in_run && j < n; ++j) {                  // the ragged tail
    if (seg[j] != s) break;
    acc = combine<OP>(acc, val[j]);
  }
  store<OP>(out + s, acc);
}

template <int OP, typename T>
cudaError_t launch(const void* seg, const void* val, int64_t n, int64_t s,
                   T ident, void* out, cudaStream_t stream) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  segment_reduce_runs<OP, T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const int32_t*)seg, (const T*)val, n, (int32_t)s, ident, (T*)out);
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
// filled with the identity of op (0 sum, 1 min, 2 max) by the caller.
// num_segments must fit int32. Returns the launch's cudaError_t (0 on
// success); never synchronizes.
extern "C" int repro_segment_reduce(const void* seg, const void* val,
                                    int64_t n, int64_t num_segments, int op,
                                    int kind, void* out, void* stream) {
  if (n <= 0 || num_segments <= 0) return 0;
  if (num_segments > INT32_MAX) return (int)cudaErrorInvalidValue;
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
