// Semiring matrix product C = A (x) B of a float32 (M, K) A and (K, N) B,
// for Hopper (sm_90a), in three semirings:
//
//   plus_times  C[i, j] = sum_k A[i, k] * B[k, j]        (path counting)
//   min_plus    C[i, j] = min_k A[i, k] + B[k, j]        (shortest paths)
//   max_min     C[i, j] = max_k min(A[i, k], B[k, j])    (widest paths)
//
// and, for graphs that fit in one SM's shared memory, a whole closure of
// such products in one launch.
//
// Replaces: src/repro/kernels/graph_ops/semiring.py, semiring_matmul_pallas
// (the TPU kernel pads both operands with the semiring's identity, tiles the
// output on the grid's i, j axes and carries each output tile in VMEM
// across a sequential k axis; plus_times rides the MXU, the tropical
// semirings are VPU broadcast reductions), and the closure loops over it in
// src/repro/kernels/graph_ops/ops.py (bool_closure, minplus_closure,
// maxmin_closure), which the JAX package runs as one product a launch.
//
// Bound on an H100 SXM: the larger of the bytes (M*K + K*N + M*N floats at
// 3.35 TB/s) and the issue of the candidates. The CUDA C++ Programming
// Guide's throughput table for compute capability 9.0 gives 128 results a
// clock an SM for a float32 add / multiply / multiply-add and 64 for
// compare / minimum / maximum, so a plus_times candidate (FFMA) takes one
// slot of 1/128 clock, a min_plus one (FADD + FMNMX) three and a max_min
// one (two FMNMX) four: at 384^3 and 1.98 GHz, 1.7 us, 5.1 us and 6.8 us.
// At the process graphs' N = 28 every launch is far below both: the launch
// is the cost, and a closure was 3-8 dependent launches.
//
// Design of the product (semiring_tile): a block of 64 threads owns a
// 32 x 32 output tile, each thread a 4 x 4 register block (rows ty + 8r,
// columns 4tx..4tx+3), so every word read from shared memory feeds four
// candidates. A and B k-tiles (32 deep, A row-major with rows 4 mod 32
// banks apart) go through a 2-stage cp.async ring, 16-byte copies where
// the rows allow, so tile t + 1's loads overlap tile t's folds; one
// barrier a tile. A k group of 4 is four 16-byte A loads (the warp's four
// row groups hit distinct banks; a phase of 8 lanes reads one address)
// and four 16-byte B loads (a phase reads 128 contiguous bytes), free of
// bank conflicts; two fragment sets alternate, each loaded a group ahead
// of its folds with no branch between (a load behind a branch would be
// scheduled after the candidates it should overlap). An element outside A
// or B is stored as the identity instead, so a padded k has the identity
// on both sides and changes no output (0 * 0 + acc, inf + inf,
// min(-inf, -inf)); nothing is padded in memory. 32 x 32 tiles give 144
// blocks at 384^2, one wave of the 132 SMs; plus_times stays there, its 288
// warps each a chain of 384 k. The tropical semirings also split K across
// the blocks of a thread block cluster (up to 8, about a thousand blocks in
// all): each block leaves its partial tile in shared memory and, after a
// cluster barrier, merges its share of the rows from every block of the
// cluster through distributed shared memory, every remote word requested
// before any is folded: one launch, no scratch, no float atomics.
//
// Exactness: plus_times is one fmaf per k, in ascending k, from 0.0, never
// split and never on the tensor cores, so it is bitwise the k-order fmaf
// chain for any float operands (and exact while operands and partial sums
// are integers below 2^24, which covers the 0/1 closures). Each tropical
// candidate is one IEEE operation and min / max do not depend on order, so
// those results are bitwise the plain version's for any tiling and split.
// min.NaN / max.NaN propagate NaN as torch.minimum / torch.amin do (fminf
// and fmaxf would drop it) in one instruction each.
//
// Design of the closure (semiring_closure_*): one block holds the (N, N)
// matrix in dynamic shared memory and runs the closure loop's whole
// schedule there, a __syncthreads between products, writing the result
// once. Tropical: two float32 buffers (rows padded to a multiple of 4
// words for 16-byte loads), the diagonal forced on load (0 for min_plus,
// +inf for max_min), a thread 1, 2 or 4 rows x 4 columns of a squaring
// (the fewest rows for which one pass of the block covers it), k in groups
// of 4 with two fragment sets as above; N <= 168 fits 227 KB. One SM's
// issue rate bounds it, so it pays up to the N where the loop of products
// over the whole card overtakes it (CLOSURE_MAX_N in the wrapper).
// Boolean: rows held as bit masks (acc, sq and a spare, at most 12 KB),
// built by warp ballots; each product word ORs the words of the rows set
// in the left operand's row, up to a warp of lanes sharing a word and
// combining by shuffles: exactly the 0/1 plus_times product thresholded
// "> 0". The wrapper hands the kernel the loop's schedule
// (semiring.closure_plan): every step squares acc, multiplies acc by sq,
// or squares sq, 2 bits a step.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 32;        // output tile edge
constexpr int kTileK = 32;       // k step
constexpr int kStages = 2;       // cp.async ring depth
constexpr int kThreads = 64;     // 8 x 8 threads, 4 x 4 outputs each
constexpr int kLdA = kTileK + 4;  // A tile rows: 16-byte aligned, 4 mod 32 banks
constexpr int kLdB = kTile;
constexpr int kMaxSplit = 8;     // blocks of a portable cluster
constexpr int64_t kWaveBlocks = 1024;  // tropical split target: ~8 blocks an SM
constexpr int kClosureThreads = 1024;
constexpr int kMaxDevices = 64;
constexpr int64_t kSharedLimit = 232448;       // opt-in shared memory per block
constexpr int64_t kDefaultShared = 48 * 1024;  // above this, opt in first

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

struct PlusTimes {
  static __device__ __forceinline__ float identity() { return 0.0f; }
  static __device__ __forceinline__ float step(float acc, float a, float b) {
    return fmaf(a, b, acc);
  }
};

struct MinPlus {
  static __device__ __forceinline__ float identity() { return INFINITY; }
  static __device__ __forceinline__ float step(float acc, float a, float b) {
    return min_nan(acc, __fadd_rn(a, b));
  }
  static __device__ __forceinline__ float merge(float x, float y) { return min_nan(x, y); }
};

struct MaxMin {
  static __device__ __forceinline__ float identity() { return -INFINITY; }
  static __device__ __forceinline__ float step(float acc, float a, float b) {
    return max_nan(acc, min_nan(a, b));
  }
  static __device__ __forceinline__ float merge(float x, float y) { return max_nan(x, y); }
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One k-tile of A (as[r][kk] = A[row0 + r, k0 + kk], rows kLdA words
// apart) and of B (bs[kk][q] = B[k0 + kk, col0 + q]) into a stage; elements
// outside A or B are stored as the identity. With vec_a (K % 4 == 0, A
// 16-byte aligned) and vec_b (N % 4 == 0, B aligned) every copy is 16 bytes
// and a warp reads whole 128-byte rows; otherwise 4-byte copies.
template <class S>
__device__ __forceinline__ void stage_tiles(float* as, float* bs, const float* __restrict__ a,
                                            const float* __restrict__ b, int64_t m, int64_t k,
                                            int64_t n, int64_t row0, int64_t col0, int64_t k0,
                                            bool vec_a, bool vec_b, int tid) {
  const float ident = S::identity();
  if (vec_a) {
#pragma unroll
    for (int i = 0; i < kTile * kTileK / (4 * kThreads); ++i) {
      const int e = tid + i * kThreads;
      const int r = e / (kTileK / 4), kk = 4 * (e % (kTileK / 4));
      const int64_t gi = row0 + r, gk = k0 + kk;
      float* dst = as + r * kLdA + kk;
      if (gi < m && gk < k) {
        cp_async16(dst, a + gi * k + gk);
      } else {
        dst[0] = dst[1] = dst[2] = dst[3] = ident;
      }
    }
  } else {
#pragma unroll 8
    for (int i = 0; i < kTile * kTileK / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / kTileK, kk = e % kTileK;
      const int64_t gi = row0 + r, gk = k0 + kk;
      float* dst = as + r * kLdA + kk;
      if (gi < m && gk < k) {
        cp_async4(dst, a + gi * k + gk);
      } else {
        *dst = ident;
      }
    }
  }
  if (vec_b) {
#pragma unroll
    for (int i = 0; i < kTile * kTileK / (4 * kThreads); ++i) {
      const int e = tid + i * kThreads;
      const int kk = e / (kTile / 4), q = 4 * (e % (kTile / 4));
      const int64_t gk = k0 + kk, gj = col0 + q;
      float* dst = bs + kk * kLdB + q;
      if (gk < k && gj < n) {
        cp_async16(dst, b + gk * n + gj);
      } else {
        dst[0] = dst[1] = dst[2] = dst[3] = ident;
      }
    }
  } else {
#pragma unroll 8
    for (int i = 0; i < kTile * kTileK / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int kk = e / kTile, q = e % kTile;
      const int64_t gk = k0 + kk, gj = col0 + q;
      float* dst = bs + kk * kLdB + q;
      if (gk < k && gj < n) {
        cp_async4(dst, b + gk * n + gj);
      } else {
        *dst = ident;
      }
    }
  }
}

__device__ __forceinline__ float lane(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// The candidates of 4 consecutive k (ascending) onto a 4 x 4 block: a[r]
// holds row r's 4 values of k, b[j] the 4 columns' values of k j.
template <class S>
__device__ __forceinline__ void fold4(float (&acc)[4][4], const float4 (&a)[4],
                                      const float4 (&b)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float ar = lane(a[r], j);
      acc[r][0] = S::step(acc[r][0], ar, b[j].x);
      acc[r][1] = S::step(acc[r][1], ar, b[j].y);
      acc[r][2] = S::step(acc[r][2], ar, b[j].z);
      acc[r][3] = S::step(acc[r][3], ar, b[j].w);
    }
  }
}

constexpr int kGroups = kTileK / 4;
static_assert(kGroups % 2 == 0, "fragment sets alternate by group");

// Group g's fragments: rows ty + 8r of A at k 4g..4g+3, and columns
// 4tx..4tx+3 of B at those k (at / bt already offset by the thread).
__device__ __forceinline__ void load_group(const float* at, const float* bt, int g,
                                           float4 (&fa)[4], float4 (&fb)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) fa[r] = *reinterpret_cast<const float4*>(at + 8 * r * kLdA + 4 * g);
#pragma unroll
  for (int j = 0; j < 4; ++j) fb[j] = *reinterpret_cast<const float4*>(bt + (4 * g + j) * kLdB);
}

__device__ __forceinline__ void copy4(float4 (&dst)[4], const float4 (&src)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) dst[i] = src[i];
}

// grid (column tiles, row tiles, K splits). A thread owns rows ty + 8r
// (r < 4: a warp's four row groups read four distinct 16-byte words of a
// k group, on distinct banks) and columns 4tx..4tx+3. kSplit: the z
// blocks of a tile form one cluster, each folding tiles_per_split k-tiles,
// then merging. At most 128 registers a thread (8 blocks an SM).
template <class S, bool kSplit>
__global__ void __launch_bounds__(kThreads, 8)
semiring_tile(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ c,
              int64_t m, int64_t k, int64_t n, int64_t tiles_per_split, bool vec_a,
              bool vec_b, bool vec_c) {
  __shared__ __align__(16) float as[kStages][kTile * kLdA];
  __shared__ __align__(16) float bs[kStages][kTileK * kLdB];
  const int tid = threadIdx.x;
  const int tx = tid & 7, ty = tid >> 3;
  const int64_t row0 = (int64_t)blockIdx.y * kTile;
  const int64_t col0 = (int64_t)blockIdx.x * kTile;
  const int64_t ktiles = (k + kTileK - 1) / kTileK;
  const int64_t t_begin = kSplit ? (int64_t)blockIdx.z * tiles_per_split : 0;
  const int64_t t_last = t_begin + tiles_per_split;
  const int64_t t_end = kSplit && t_last < ktiles ? t_last : ktiles;
  const float ident = S::identity();
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = ident;
  }

  // the ring: tiles t .. t + kStages - 2 are in flight while tile t folds;
  // one commit group a tile (empty past the end), so "all but the newest
  // kStages - 2 groups have landed" means tile t has
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (t_begin + st < t_end) {
      stage_tiles<S>(as[st], bs[st], a, b, m, k, n, row0, col0, (t_begin + st) * kTileK,
                     vec_a, vec_b, tid);
    }
    cp_async_commit();
  }
  for (int64_t t = t_begin; t < t_end; ++t) {
    const int cur = (int)((t - t_begin) % kStages);
    cp_async_wait<kStages - 2>();
    // tile t is visible to every thread, and every thread is done with
    // tile t - 1, whose stage the next copy refills
    __syncthreads();
    const int64_t ahead = t + kStages - 1;
    if (ahead < t_end) {
      const int st = (int)((ahead - t_begin) % kStages);
      stage_tiles<S>(as[st], bs[st], a, b, m, k, n, row0, col0, ahead * kTileK, vec_a, vec_b,
                     tid);
    }
    cp_async_commit();
    // groups of 4 k holding at least one k < K (a padded k is the identity
    // on both sides); group g + 1's fragments are loaded, with no branch
    // between, before group g folds, so their latency hides behind its
    // candidates (a load behind a branch would be scheduled after them)
    const int64_t left = k - t * kTileK;
    const float* at = as[cur] + ty * kLdA;
    const float* bt = bs[cur] + 4 * tx;
    float4 fa[4], fb[4];
    load_group(at, bt, 0, fa, fb);
    if (left >= kTileK) {
      // two fragment sets in turn (a copy between them would cost a move
      // for every loaded word)
      float4 ga[4], gb[4];
#pragma unroll
      for (int g = 0; g < kGroups; g += 2) {
        load_group(at, bt, g + 1, ga, gb);
        fold4<S>(acc, fa, fb);
        load_group(at, bt, (g + 2) % kGroups, fa, fb);  // the last wraps, unused
        fold4<S>(acc, ga, gb);
      }
    } else {
      const int groups = (int)((left + 3) / 4);
      for (int g = 0; g < groups; ++g) {
        float4 na[4], nb[4];
        load_group(at, bt, g + 1 < groups ? g + 1 : g, na, nb);
        fold4<S>(acc, fa, fb);
        copy4(fa, na);
        copy4(fb, nb);
      }
    }
  }

  if constexpr (!kSplit) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int64_t i = row0 + ty + 8 * r;
      const int64_t j = col0 + 4 * tx;
      if (i >= m) continue;
      float* dst = c + i * n + j;
      if (vec_c && j < n) {
        *reinterpret_cast<float4*>(dst) = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (j + q < n) dst[q] = acc[r][q];
        }
      }
    }
  } else {
    // the partial tile, row-major, into this block's first stage once
    // every thread is done with the last tile
    __syncthreads();
    float* part = as[0];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      *reinterpret_cast<float4*>(part + (ty + 8 * r) * kTile + 4 * tx) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const int rank = (int)cluster.block_rank();
    const int size = (int)cluster.num_blocks();
    const int lo = rank * kTile / size, hi = (rank + 1) * kTile / size;
    // 16-byte words of the rows this block merges: every rank's word is
    // requested before any is folded, so one remote round trip is paid
    for (int e = tid; e < (hi - lo) * (kTile / 4); e += kThreads) {
      const int rr = lo + e / (kTile / 4), q = 4 * (e % (kTile / 4));
      float4 w[kMaxSplit];
#pragma unroll
      for (int s = 0; s < kMaxSplit; ++s) {
        if (s < size) {
          w[s] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, s) +
                                                  rr * kTile + q);
        }
      }
      float v[4] = {ident, ident, ident, ident};
#pragma unroll
      for (int s = 0; s < kMaxSplit; ++s) {
        if (s < size) {
          v[0] = S::merge(v[0], w[s].x);
          v[1] = S::merge(v[1], w[s].y);
          v[2] = S::merge(v[2], w[s].z);
          v[3] = S::merge(v[3], w[s].w);
        }
      }
      const int64_t i = row0 + rr, j = col0 + q;
      if (i >= m) continue;
      float* dst = c + i * n + j;
      if (vec_c && j < n) {
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          if (j + t < n) dst[t] = v[t];
        }
      }
    }
    cluster.sync();  // no block leaves while another reads its tile
  }
}

template <class S, bool kTropical>
cudaError_t launch_tile(const float* a, const float* b, float* c, int64_t m, int64_t k,
                        int64_t n, cudaStream_t s) {
  const int64_t gy = (m + kTile - 1) / kTile;
  const int64_t gx = (n + kTile - 1) / kTile;
  if (gy > 65535 || gx > 2147483647LL) return cudaErrorInvalidValue;
  const bool vec_a = k % 4 == 0 && ((uintptr_t)a & 15) == 0;
  const bool vec_b = n % 4 == 0 && ((uintptr_t)b & 15) == 0;
  const bool vec_c = n % 4 == 0 && ((uintptr_t)c & 15) == 0;
  const int64_t ktiles = (k + kTileK - 1) / kTileK;
  int64_t splits = 1;
  if (kTropical && ktiles > 1) {
    // about kWaveBlocks blocks, at least one k-tile each, at most a cluster
    splits = (kWaveBlocks + gx * gy - 1) / (gx * gy);
    splits = splits < kMaxSplit ? splits : kMaxSplit;
    splits = splits < ktiles ? splits : ktiles;
  }
  const int64_t per = (ktiles + splits - 1) / splits;
  splits = per > 0 ? (ktiles + per - 1) / per : 1;
  if constexpr (kTropical) {
    if (splits > 1) {
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3((unsigned)gx, (unsigned)gy, (unsigned)splits);
      cfg.blockDim = dim3(kThreads);
      cfg.dynamicSmemBytes = 0;
      cfg.stream = s;
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = 1;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = (unsigned)splits;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      return cudaLaunchKernelEx(&cfg, semiring_tile<S, true>, a, b, c, m, k, n, per, vec_a,
                                vec_b, vec_c);
    }
  }
  semiring_tile<S, false><<<dim3((unsigned)gx, (unsigned)gy), kThreads, 0, s>>>(
      a, b, c, m, k, n, per, vec_a, vec_b, vec_c);
  return cudaGetLastError();
}

// ------------------------------------------------------------ closures

template <int kRows>
__device__ __forceinline__ void closure_group(const float* const (&rows)[kRows],
                                              const float* col, int ld, int g,
                                              float4 (&fa)[kRows], float4 (&fb)[4]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) fa[r] = *reinterpret_cast<const float4*>(rows[r] + 4 * g);
#pragma unroll
  for (int j = 0; j < 4; ++j) fb[j] = *reinterpret_cast<const float4*>(col + (4 * g + j) * ld);
}

template <class S, int kRows>
__device__ __forceinline__ void closure_fold(float (&acc)[kRows][4], const float4 (&fa)[kRows],
                                             const float4 (&fb)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float ar = lane(fa[r], j);
      acc[r][0] = S::step(acc[r][0], ar, fb[j].x);
      acc[r][1] = S::step(acc[r][1], ar, fb[j].y);
      acc[r][2] = S::step(acc[r][2], ar, fb[j].z);
      acc[r][3] = S::step(acc[r][3], ar, fb[j].w);
    }
  }
}

// threads of a block of the closure kernel with kRows rows a thread: four
// rows (two fragment sets of 4 x 4) need more than 64 registers a thread
template <int kRows>
constexpr int closure_threads() { return kRows == 4 ? kClosureThreads / 2 : kClosureThreads; }

// `squarings` products x <- x (x) x of the (n, n) matrix `in` with its
// diagonal forced to `diag`, rows `ld` (a multiple of 4) words apart. A
// thread owns kRows rows x 4 columns of a product: 1 row while one pass of
// the block covers the matrix (more threads, less serial work a thread),
// 2 or 4 above. The pad columns (n <= j < ld) hold the identity
// throughout.
template <class S, int kRows>
__global__ void __launch_bounds__(closure_threads<kRows>())
semiring_closure_tropical(const float* __restrict__ in, float* __restrict__ out, int n, int ld,
                          int squarings, float diag) {
  extern __shared__ __align__(16) float smem[];
  float* x = smem;
  float* y = smem + n * ld;
  const float ident = S::identity();
  const int nt = blockDim.x;
#pragma unroll 4
  for (int e = threadIdx.x; e < n * ld; e += nt) {
    const int i = e / ld, j = e - i * ld;
    x[e] = j >= n ? ident : (i == j ? diag : in[(int64_t)i * n + j]);
  }
  __syncthreads();
  const int tc = ld / 4, tiles = (n + kRows - 1) / kRows * tc;
  const int full = n / 4;  // groups of 4 k all below n
  const float4 ident4 = make_float4(ident, ident, ident, ident);
  for (int sq = 0; sq < squarings; ++sq) {
    for (int t = threadIdx.x; t < tiles; t += nt) {
      const int i0 = kRows * (t / tc), j0 = 4 * (t % tc);
      const float* rows[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) rows[r] = x + min(i0 + r, n - 1) * ld;
      const float* const(&crows)[kRows] = rows;
      const float* col = x + j0;
      float acc[kRows][4];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = ident;
      }
      // groups of 4 k below n, two fragment sets in turn, each loaded a
      // group ahead; then the k past the last full group, if any (the A
      // side reads pad columns, the identity; the B side is the identity)
      float4 fa[kRows], fb[4];
      if (full > 0) {
        float4 ga[kRows], gb[4];
        closure_group<kRows>(crows, col, ld, 0, fa, fb);
        int g = 0;
        for (; g + 1 < full; g += 2) {
          closure_group<kRows>(crows, col, ld, g + 1, ga, gb);
          closure_fold<S, kRows>(acc, fa, fb);
          closure_group<kRows>(crows, col, ld, g + 2 < full ? g + 2 : g + 1, fa, fb);
          closure_fold<S, kRows>(acc, ga, gb);
        }
        if (g < full) closure_fold<S, kRows>(acc, fa, fb);
      }
      if (4 * full < n) {
        const int kk = 4 * full;
#pragma unroll
        for (int r = 0; r < kRows; ++r) fa[r] = *reinterpret_cast<const float4*>(rows[r] + kk);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          fb[j] = kk + j < n ? *reinterpret_cast<const float4*>(col + (kk + j) * ld) : ident4;
        }
        closure_fold<S, kRows>(acc, fa, fb);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (i0 + r < n) {
          *reinterpret_cast<float4*>(y + (i0 + r) * ld + j0) =
              make_float4(j0 < n ? acc[r][0] : ident, j0 + 1 < n ? acc[r][1] : ident,
                          j0 + 2 < n ? acc[r][2] : ident, j0 + 3 < n ? acc[r][3] : ident);
        }
      }
    }
    __syncthreads();
    float* t = x;
    x = y;
    y = t;
  }
  for (int e = threadIdx.x; e < n * n; e += nt) {
    const int i = e / n;
    out[e] = x[i * ld + (e - i * n)];
  }
}

// The boolean closure over rows of w = ceil(n / 32) bit words: acc starts
// as the seed I | A (acc_from_seed) or I, sq as the seed; step s of
// `steps` (2 bits) is 0: acc <- acc acc, 1: acc <- acc sq, 2: sq <- sq sq.
// A product word (i, q) ORs the q-th words of the rows k set in row i of
// the left operand; kLanes lanes share an item, each taking every
// kLanes-th k, and combine by shuffles.
template <int kLanes>
__global__ void __launch_bounds__(kClosureThreads)
semiring_closure_bool(const uint8_t* __restrict__ in, uint8_t* __restrict__ out, int n,
                      int acc_from_seed, uint32_t steps, int nsteps) {
  extern __shared__ __align__(16) uint32_t bits[];
  const int w = (n + 31) / 32, words = n * w;
  const int nt = blockDim.x;
  // a warp builds one word a pass: lane l reads byte 32q + l of row i
  const int lane_id = threadIdx.x % 32;
  for (int e = threadIdx.x / 32; e < words; e += nt / 32) {
    const int i = e / w, q = e - i * w, j = 32 * q + lane_id;
    const bool set = j < n && (i == j || in[(int64_t)i * n + j] != 0);
    const uint32_t word = __ballot_sync(0xffffffffu, set);
    if (lane_id == 0) {
      bits[words + e] = word;
      bits[e] = acc_from_seed ? word : (i / 32 == q ? 1u << (i % 32) : 0u);
    }
  }
  __syncthreads();
  const int sub = threadIdx.x % kLanes;
  const int per_pass = nt / kLanes;
  int acc = 0, sq = 1, spare = 2;
  for (int s = 0; s < nsteps; ++s) {
    const int op = (int)((steps >> (2 * s)) & 3u);
    const uint32_t* lhs = bits + (op == 2 ? sq : acc) * words;
    const uint32_t* rhs = bits + (op == 0 ? acc : sq) * words;
    uint32_t* dst = bits + spare * words;
    // every lane of a warp runs the same passes, so the shuffles line up
    for (int base = 0; base < words; base += per_pass) {
      const int e = base + threadIdx.x / kLanes;
      uint32_t r = 0;
      if (e < words) {
        const int i = e / w, q = e - i * w;
#pragma unroll 4
        for (int kk = sub; kk < n; kk += kLanes) {
          const uint32_t set = (lhs[i * w + kk / 32] >> (kk % 32)) & 1u;
          r |= rhs[kk * w + q] & (0u - set);
        }
      }
#pragma unroll
      for (int off = kLanes / 2; off > 0; off /= 2) r |= __shfl_xor_sync(0xffffffffu, r, off);
      if (e < words && sub == 0) dst[e] = r;
    }
    __syncthreads();
    const int t = spare;
    if (op == 2) {
      spare = sq;
      sq = t;
    } else {
      spare = acc;
      acc = t;
    }
  }
  const uint32_t* res = bits + acc * words;
  for (int e = threadIdx.x; e < n * n; e += nt) {
    const int i = e / n, j = e - i * n;
    out[e] = (uint8_t)((res[i * w + j / 32] >> (j % 32)) & 1u);
  }
}

template <class K>
cudaError_t opt_in(K kernel, int64_t bytes, bool* done) {
  if (bytes <= kDefaultShared) return cudaSuccess;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[device]) {  // once per device and kernel, not once a call
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSharedLimit);
    if (err != cudaSuccess) return err;
    done[device] = true;
  }
  return cudaSuccess;
}

template <class S, int kRows>
cudaError_t launch_closure_rows(const float* in, float* out, int n, int ld, int squarings,
                               float diag, int64_t bytes, cudaStream_t s) {
  static bool opted_in[kMaxDevices] = {};
  const cudaError_t err = opt_in(semiring_closure_tropical<S, kRows>, bytes, opted_in);
  if (err != cudaSuccess) return err;
  const int tiles = (n + kRows - 1) / kRows * (ld / 4);
  constexpr int kMaxThreads = closure_threads<kRows>();
  int threads = (tiles + 31) / 32 * 32;
  threads = threads < kMaxThreads ? threads : kMaxThreads;
  semiring_closure_tropical<S, kRows><<<1, threads, (size_t)bytes, s>>>(
      in, out, n, ld, squarings, diag);
  return cudaGetLastError();
}

template <class S>
cudaError_t launch_closure_tropical(const float* in, float* out, int n, int squarings,
                                    float diag, cudaStream_t s) {
  const int ld = (n + 3) / 4 * 4;
  const int64_t bytes = 2 * (int64_t)n * ld * (int64_t)sizeof(float);
  if (bytes > kSharedLimit) return cudaErrorInvalidValue;
  // the fewest rows a thread for which one pass of the block covers a product
  const int tc = ld / 4;
  if (n * tc <= kClosureThreads) {
    return launch_closure_rows<S, 1>(in, out, n, ld, squarings, diag, bytes, s);
  }
  if ((n + 1) / 2 * tc <= kClosureThreads) {
    return launch_closure_rows<S, 2>(in, out, n, ld, squarings, diag, bytes, s);
  }
  return launch_closure_rows<S, 4>(in, out, n, ld, squarings, diag, bytes, s);
}

template <int kLanes>
cudaError_t launch_closure_bool(const uint8_t* in, uint8_t* out, int n, int acc_from_seed,
                                uint32_t steps, int nsteps, int64_t bytes, cudaStream_t s) {
  static bool opted_in[kMaxDevices] = {};
  const cudaError_t err = opt_in(semiring_closure_bool<kLanes>, bytes, opted_in);
  if (err != cudaSuccess) return err;
  const int64_t lanes = (int64_t)n * ((n + 31) / 32) * kLanes;
  int threads = (int)((lanes + 31) / 32 * 32);
  threads = threads < kClosureThreads ? threads : kClosureThreads;
  semiring_closure_bool<kLanes><<<1, threads, (size_t)bytes, s>>>(in, out, n, acc_from_seed,
                                                                  steps, nsteps);
  return cudaGetLastError();
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
  const cudaStream_t s = (cudaStream_t)stream;
  const float* pa = (const float*)a;
  const float* pb = (const float*)b;
  float* pc = (float*)c;
  switch (semiring) {
    case 0: return (int)launch_tile<PlusTimes, false>(pa, pb, pc, m, k, n, s);
    case 1: return (int)launch_tile<MinPlus, true>(pa, pb, pc, m, k, n, s);
    case 2: return (int)launch_tile<MaxMin, true>(pa, pb, pc, m, k, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The closure of an (n, n) matrix in one block. kind 0: boolean (in: any
// 1-byte 0/1 matrix, out: 1-byte 0/1), schedule `steps` / `nsteps` as in
// semiring_closure_bool; kind 1 min_plus, 2 max_min (float32 in and out,
// diagonal forced to 0 / +inf), `nsteps` squarings, acc_from_seed 1 and
// steps 0. in and out are contiguous on the current device; every element
// of out is written. Returns the launch's cudaError_t; never synchronizes.
extern "C" int repro_semiring_closure(const void* in, void* out, int64_t n, int kind,
                                      int acc_from_seed, uint32_t steps, int nsteps,
                                      void* stream) {
  if (n <= 0) return 0;
  if (nsteps < 0 || nsteps > 16 || n > 46340) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int nn = (int)n;
  if (kind == 0) {
    const int64_t words = n * ((n + 31) / 32);
    const int64_t bytes = 3 * words * (int64_t)sizeof(uint32_t);
    if (bytes > kSharedLimit) return (int)cudaErrorInvalidValue;
    const uint8_t* pin = (const uint8_t*)in;
    uint8_t* pout = (uint8_t*)out;
    // the most lanes an item (up to a warp) that one pass still covers
    if (words * 32 <= kClosureThreads) {
      return (int)launch_closure_bool<32>(pin, pout, nn, acc_from_seed, steps, nsteps, bytes, s);
    }
    if (words * 8 <= kClosureThreads) {
      return (int)launch_closure_bool<8>(pin, pout, nn, acc_from_seed, steps, nsteps, bytes, s);
    }
    return (int)launch_closure_bool<2>(pin, pout, nn, acc_from_seed, steps, nsteps, bytes, s);
  }
  if (acc_from_seed != 1 || steps != 0) return (int)cudaErrorInvalidValue;
  const float* pin = (const float*)in;
  float* pout = (float*)out;
  switch (kind) {
    case 1: return (int)launch_closure_tropical<MinPlus>(pin, pout, nn, nsteps, 0.0f, s);
    case 2: return (int)launch_closure_tropical<MaxMin>(pin, pout, nn, nsteps, INFINITY, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
