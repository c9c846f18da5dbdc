// Weighted bincount of unsorted int32 ids into int32 bins, for Hopper
// (sm_90a): out[v_i] = into[v_i] (or 0) + sum of w_i, with ids outside
// [0, B) (including -1) or zero weights dropped. Weights are int32
// (negative ones included) or 1-byte bools, read where the caller holds
// them; counts wrap mod 2^32, as index_add_ does.
//
// Replaces: src/repro/kernels/segment_ops/histogram.py, histogram_pallas
// (the TPU's VPU masked reduction of a (block_e, block_b) one-hot tile).
//
// Bound on an H100 SXM: device-memory bytes. Each row reads its id and its
// weight once and does one integer add; the (B,) output is written once
// and into read once. At 3.35 TB/s a 524,288-row chunk needs 8 * E + 4 * B
// bytes with int32 weights (1.25 us at 26 bins) and 5 * E + 8 * B with a
// bool mask and into, as the DFG update calls it (0.78 us).
//
// Design (counting.cuh): one pass of privatized shared-memory bins, 16-byte
// loads, and a partials-plus-finish combine in which every bin of out is
// stored once, so a call is two kernel nodes (the second launched with
// programmatic dependent launch) where it was four: no cast of a bool mask
// to int32, no zero fill of out, no add of into after the kernel. The
// earlier design flushed every block's bins with global atomics onto the
// same B addresses (264 blocks a bin) and loaded 4 bytes a thread.
#include "counting.cuh"

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// values: (n,) int32; w: (n,) int32 or bool (w_bool = 1); into: (num_bins,)
// int32 or NULL; out: (num_bins,) int32, every bin written here, or, when
// partials is NULL (the global route), already holding into or zeros;
// partials: (grid, num_bins) int32 scratch. grid and head come
// from segment_ops.counting.count_plan; device is the current ordinal.
// Returns the launches' cudaError_t (0 on success); never synchronizes.
extern "C" int repro_histogram(const void* values, const void* w, int w_bool,
                               int64_t n, int64_t num_bins, const void* into,
                               void* out, void* partials, int grid, int head,
                               int device, void* stream) {
  const int32_t* v = (const int32_t*)values;
  return counting::count_weighted(counting::IdKey{v, (uint32_t)num_bins}, w,
                                  w_bool, v, nullptr, n, num_bins, 1, into, out,
                                  partials, grid, head, device, stream);
}
