// Weighted (src, dst) pair counts into a dense (S, D) int32 matrix, for
// Hopper (sm_90a): out[src_i, dst_i] = into[src_i, dst_i] (or 0) + sum of
// w_i, with rows whose ids fall outside [0, S) x [0, D) (including the -1
// padding id) or whose weight is 0 dropped. Weights are int32 or 1-byte
// bools, read where the caller holds them; counts wrap mod 2^32, as
// index_add_ does.
//
// Replaces: src/repro/kernels/segment_ops/pair_count.py, pair_count_pallas
// (the TPU's one-hot MXU matmul, (onehot(src) * w)^T @ onehot(dst)), and
// through it kernels/dfg_count/dfg_count.py, dfg_count_pallas.
//
// Bound on an H100 SXM: device-memory bytes. Each row reads src, dst and
// its weight once and does one integer add; the (S, D) output is written
// once and into read once. At 3.35 TB/s a 524,288-row chunk needs 12 * E +
// 4 * S * D bytes with int32 weights (1.88 us at 26 x 26) and 9 * E + 8 *
// S * D with a bool mask and into, as the DFG update calls it (1.41 us).
// The integer adds (one per row) are far below any compute peak.
//
// Design (counting.cuh): the histogram of the flat key src * D + dst, one
// pass of privatized shared-memory bins, 16-byte loads of src, dst and the
// weights, and a partials-plus-finish combine in which every cell of out
// is stored once: two kernel nodes a call (the second launched with
// programmatic dependent launch) where there were four (mask cast, zero
// fill, kernel, add of into). The earlier design flushed every block's
// cells with global atomics (264 blocks a cell) and loaded 4 bytes a
// thread.
#include "counting.cuh"

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// src, dst: (n,) int32; w: (n,) int32 or bool (w_bool = 1); into: (S, D)
// int32 or NULL; out: (S, D) int32, every cell written here, or, when
// partials is NULL (the global route), already holding into or zeros;
// partials: (grid, S * D) int32 scratch. grid and head come from
// segment_ops.counting.count_plan; device is the current ordinal. Returns
// the launches' cudaError_t (0 on success); never synchronizes.
extern "C" int repro_pair_count(const void* src, const void* dst,
                                const void* w, int w_bool, int64_t n,
                                int64_t num_src, int64_t num_dst,
                                const void* into, void* out, void* partials,
                                int grid, int head, int device, void* stream) {
  const int32_t* s = (const int32_t*)src;
  const int32_t* d = (const int32_t*)dst;
  return counting::count_weighted(
      counting::PairKey{s, d, (uint32_t)num_src, (uint32_t)num_dst}, w, w_bool,
      s, d, n, num_src, num_dst, into, out, partials, grid, head, device,
      stream);
}
