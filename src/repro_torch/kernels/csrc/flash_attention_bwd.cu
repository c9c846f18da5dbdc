// Flash attention backward for Hopper (sm_90a): dQ, dK and dV of the causal
// GQA attention of flash_attention.cu, with its masks (causal rows counted
// from 0, an optional sliding window, a ragged kv length read on the device).
//
//   P   = exp(s - lse),  s = q.k D^-1/2 over the valid columns, else 0
//   D_i = sum_d dO_i O_i                           (attn_bwd_delta)
//   dV  = P^T dO,  dP = dO V^T,  dS = P o (dP - D)
//   dK  = dS^T Q D^-1/2                             (attn_bwd_dkdv)
//   dQ  = dS K D^-1/2                               (attn_bwd_dq)
//
// lse is the forward's log-sum-exp ((b, h, sq) float32); a row with no valid
// column has lse = -inf and gets P = 0, so 0 gradients (exp(-inf - -inf) is
// never taken). bf16 or float32 q, k, v, o, dO in any strides with a unit
// last stride; all arithmetic in float32; dq, dk, dv written in the input
// type through their own strides.
//
// Replaces: nothing in Pallas. The JAX package trains through
// attention_chunked (src/repro/models/attention.py:53-114, a lax.scan) and
// XLA differentiates that scan; this kernel stands where XLA's generated VJP
// stands, beside the forward kernel that replaces flash_attention_pallas
// (src/repro/kernels/flash_attention/flash_attention.py:121).
//
// Design: FlashAttention-2's backward split so that nothing needs atomics
// and the result is deterministic. attn_bwd_delta takes one warp a row.
// attn_bwd_dkdv gives each (64-key tile, KV head, batch) to a block that
// keeps K and V in shared memory, loops over the H / KVH query heads of its
// group and the 64-row query tiles that can see it, recomputes S and P from
// lse, and accumulates dK and dV in registers: the GQA sum with no repeated
// K / V and no atomics, each of dK and dV written once. attn_bwd_dq gives
// each (64-row query tile, head, batch) to a block that walks the key tiles
// the forward's key_tiles selects and accumulates dQ. Both recompute S and
// dP, so a step does seven 64 x 64 x D products a tile pair where five are
// the least. Every product is a SIMT float32 fmaf loop over shared memory
// (256 threads, each owning a 4 x 4 block of S or a 4 x D/16 block of a
// gradient; rows padded to D + 1 / 65 floats so no read conflicts on a
// bank); no mma.sync, wgmma or TMA yet.
//
// Bound on an H100 SXM at (8, 12, 1,024, 64) causal: the five products of
// the causal half, 32.2 GFLOP, take 0.033 ms at 989 TFLOP/s bf16, and the
// bytes (q, k, v, o, dO read, dq, dk, dv written: 100.7 MB bf16) 0.030 ms;
// the operations bound it. In float32 the bytes double (0.060 ms) and the
// operations on the SIMT cores (67 TFLOP/s) take 0.48 ms, 0.195 ms as
// 3xTF32. This kernel runs every product on the SIMT cores, two loads from
// shared memory to eight fmaf, so it is far off the bf16 bound; PERF.md
// gives its time.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;      // query rows per tile
constexpr int kKeys = 64;      // keys per tile
constexpr int kThreads = 256;  // 16 x 16: thread (ty, tx) owns rows ty + 16 a
constexpr int kLdS = kKeys + 1;  // row stride of a 64 x 64 tile in shared memory

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;          // (b, h, sq), contiguous
  float* delta;              // (b, h, sq), contiguous scratch
  void* dq;
  void* dk;
  void* dv;
  int64_t q_sb, q_sh, q_ss;  // strides in elements: batch, head, row
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;
  int64_t do_sb, do_sh, do_ss;
  int64_t dq_sb, dq_sh, dq_ss;
  int64_t dk_sb, dk_sh, dk_ss;
  int64_t dv_sb, dv_sh, dv_ss;
  int h, sq, sk, group;      // group = q heads per kv head
  const int* kv_len;         // device scalar, or null: kv_len_value
  int kv_len_value;
  int causal;
  int window;                // < 0: no window
  float scale;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ int read_kv_len(const Params& p) {
  const int kvl = p.kv_len != nullptr ? *p.kv_len : p.kv_len_value;
  return min(max(kvl, 0), p.sk);
}

// The key tiles [begin, end) that rows [q0, q0 + kRows) can see: the
// forward's key_tiles.
__device__ __forceinline__ void key_tiles(const Params& p, int q0, int kvl,
                                          int& begin, int& end) {
  const int row_last = min(q0 + kRows, p.sq) - 1;
  end = (kvl + kKeys - 1) / kKeys;
  if (p.causal) end = min(end, row_last / kKeys + 1);
  begin = p.window >= 0 ? max(0, q0 - p.window + 1) / kKeys : 0;
}

__device__ __forceinline__ bool valid(const Params& p, int row, int col, int kvl) {
  return row < p.sq && col < kvl && (!p.causal || col <= row) &&
         (p.window < 0 || col > row - p.window);
}

// rows [r0, r0 + 64) of a (rows, D) matrix with row stride ss, as float,
// into a [64][D + 1] tile; rows at or past n are 0
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int64_t ss, int r0,
                                          int n) {
  for (int e = threadIdx.x; e < kRows * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int row = r0 + r;
    dst[r * (D + 1) + c] = row < n ? to_float(src[(int64_t)row * ss + c]) : 0.f;
  }
}

// c[a][b] = sum_d x[ty + 16 a][d] y[tx + 16 b][d]: a 64 x 64 tile of X Y^T
// from two [64][D + 1] tiles
template <int D>
__device__ __forceinline__ void product_nt(float (&c)[4][4], const float* x, const float* y,
                                           int ty, int tx) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) c[a][b] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float xv[4], yv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) xv[a] = x[(ty + 16 * a) * (D + 1) + d];
#pragma unroll
    for (int b = 0; b < 4; ++b) yv[b] = y[(tx + 16 * b) * (D + 1) + d];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) c[a][b] = fmaf(xv[a], yv[b], c[a][b]);
  }
}

// c[a][b] += sum_i x[i][ty + 16 a] y[i][tx + 16 b]: rows ty + 16 a of X^T Y,
// X a [64][65] tile (P or dS), Y a [64][D + 1] tile
template <int D>
__device__ __forceinline__ void product_tn(float (&c)[4][D / 16], const float* x,
                                           const float* y, int ty, int tx) {
#pragma unroll 4
  for (int i = 0; i < kRows; ++i) {
    float xv[4], yv[D / 16];
#pragma unroll
    for (int a = 0; a < 4; ++a) xv[a] = x[i * kLdS + ty + 16 * a];
#pragma unroll
    for (int b = 0; b < D / 16; ++b) yv[b] = y[i * (D + 1) + tx + 16 * b];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < D / 16; ++b) c[a][b] = fmaf(xv[a], yv[b], c[a][b]);
  }
}

// c[a][b] += sum_j x[ty + 16 a][j] y[j][tx + 16 b]: rows ty + 16 a of X Y,
// X a [64][65] tile (dS), Y a [64][D + 1] tile (K)
template <int D>
__device__ __forceinline__ void product_nn(float (&c)[4][D / 16], const float* x,
                                           const float* y, int ty, int tx) {
#pragma unroll 4
  for (int j = 0; j < kKeys; ++j) {
    float xv[4], yv[D / 16];
#pragma unroll
    for (int a = 0; a < 4; ++a) xv[a] = x[(ty + 16 * a) * kLdS + j];
#pragma unroll
    for (int b = 0; b < D / 16; ++b) yv[b] = y[j * (D + 1) + tx + 16 * b];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < D / 16; ++b) c[a][b] = fmaf(xv[a], yv[b], c[a][b]);
  }
}

// P and dS of the 64 x 64 tile (rows q0.., keys k0..) from the S and dP
// fragments: p = exp(s D^-1/2 - lse) where valid, else 0; ds = p (dp - D).
__device__ __forceinline__ void softmax_grad(const Params& p, float (&s)[4][4],
                                             float (&dp)[4][4], const float* s_lse,
                                             const float* s_delta, int q0, int k0,
                                             int kvl, int ty, int tx) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = ty + 16 * a;
    const float lse = s_lse[i];
    const float dlt = s_delta[i];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = tx + 16 * b;
      const bool ok = lse != -INFINITY && valid(p, q0 + i, k0 + j, kvl);
      const float pr = ok ? expf(s[a][b] * p.scale - lse) : 0.f;
      s[a][b] = pr;
      dp[a][b] = pr * (dp[a][b] - dlt);
    }
  }
}

// lse and D of rows [q0, q0 + 64) into shared memory (-inf and 0 past sq)
__device__ __forceinline__ void load_rows(const Params& p, float* s_lse, float* s_delta,
                                          int64_t row0, int q0) {
  const int t = threadIdx.x;
  if (t < kRows) {
    const int row = q0 + t;
    s_lse[t] = row < p.sq ? p.lse[row0 + row] : -INFINITY;
    s_delta[t] = row < p.sq ? p.delta[row0 + row] : 0.f;
  }
}

// D_i = sum_d dO_i O_i, one warp a row of (b, h, sq), lanes over d; the
// warp's sum order is fixed, so the result is deterministic
template <typename T>
__global__ void __launch_bounds__(kThreads) attn_bwd_delta(const Params p, int d,
                                                           int64_t rows) {
  const int64_t r = (int64_t)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (r >= rows) return;
  const int lane = threadIdx.x & 31;
  const int64_t bh = r / p.sq;
  const int i = (int)(r % p.sq);
  const int b = (int)(bh / p.h), hq = (int)(bh % p.h);
  const T* o = static_cast<const T*>(p.o) + b * p.o_sb + hq * p.o_sh + i * p.o_ss;
  const T* g = static_cast<const T*>(p.dout) + b * p.do_sb + hq * p.do_sh + i * p.do_ss;
  float acc = 0.f;
  for (int c = lane; c < d; c += 32) acc = fmaf(to_float(g[c]), to_float(o[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.delta[r] = acc;
}

template <int D>
struct Smem {
  static constexpr int kTile = kRows * (D + 1);                       // floats
  static constexpr int kDkDv = (4 * kTile + 2 * kRows * kLdS + 2 * kRows) * 4;
  static constexpr int kDq = (4 * kTile + kRows * kLdS + 2 * kRows) * 4;
};

// dK and dV of one 64-key tile of one KV head, summed over its query heads
template <int D, typename T>
__global__ void __launch_bounds__(kThreads) attn_bwd_dkdv(const Params p) {
  using S = Smem<D>;
  extern __shared__ float smem[];
  float* s_k = smem;
  float* s_v = s_k + S::kTile;
  float* s_q = s_v + S::kTile;
  float* s_do = s_q + S::kTile;
  float* s_p = s_do + S::kTile;           // [64][65]
  float* s_ds = s_p + kRows * kLdS;       // [64][65]
  float* s_lse = s_ds + kRows * kLdS;     // [64]
  float* s_delta = s_lse + kRows;         // [64]

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int k0 = blockIdx.x * kKeys, hk = blockIdx.y, b = blockIdx.z;
  const int kvl = read_kv_len(p);
  load_tile<D>(s_k, static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh, p.k_ss, k0, p.sk);
  load_tile<D>(s_v, static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh, p.v_ss, k0, p.sk);

  // the query tiles whose rows can see a key of [k0, k0 + 64)
  int qt_begin = p.causal ? k0 / kRows : 0;
  int qt_end = k0 < kvl ? (p.sq + kRows - 1) / kRows : 0;
  if (p.window >= 0) {
    const int64_t last_row = (int64_t)k0 + kKeys - 2 + p.window;  // col > row - window
    if (last_row / kRows + 1 < qt_end) qt_end = (int)(last_row / kRows + 1);
  }

  float dk[4][D / 16], dv[4][D / 16];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dk[a][c] = dv[a][c] = 0.f;

  for (int g = 0; g < p.group; ++g) {
    const int hq = hk * p.group + g;
    const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + hq * p.q_sh;
    const T* gp = static_cast<const T*>(p.dout) + b * p.do_sb + hq * p.do_sh;
    const int64_t row0 = ((int64_t)b * p.h + hq) * p.sq;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * kRows;
      __syncthreads();  // the last tile's reads of s_q, s_do, s_p, s_ds are done
      load_tile<D>(s_q, qp, p.q_ss, q0, p.sq);
      load_tile<D>(s_do, gp, p.do_ss, q0, p.sq);
      load_rows(p, s_lse, s_delta, row0, q0);
      __syncthreads();
      float s[4][4], dp[4][4];
      product_nt<D>(s, s_q, s_k, ty, tx);
      product_nt<D>(dp, s_do, s_v, ty, tx);
      softmax_grad(p, s, dp, s_lse, s_delta, q0, k0, kvl, ty, tx);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s_p[(ty + 16 * a) * kLdS + tx + 16 * c] = s[a][c];
          s_ds[(ty + 16 * a) * kLdS + tx + 16 * c] = dp[a][c];
        }
      __syncthreads();
      product_tn<D>(dv, s_p, s_do, ty, tx);
      product_tn<D>(dk, s_ds, s_q, ty, tx);
    }
  }

  T* dkp = static_cast<T*>(p.dk) + b * p.dk_sb + hk * p.dk_sh;
  T* dvp = static_cast<T*>(p.dv) + b * p.dv_sb + hk * p.dv_sh;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int key = k0 + ty + 16 * a;
    if (key >= p.sk) continue;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      store(dkp + (int64_t)key * p.dk_ss + tx + 16 * c, dk[a][c] * p.scale);
      store(dvp + (int64_t)key * p.dv_ss + tx + 16 * c, dv[a][c]);
    }
  }
}

// dQ of one 64-row query tile of one head
template <int D, typename T>
__global__ void __launch_bounds__(kThreads) attn_bwd_dq(const Params p) {
  using S = Smem<D>;
  extern __shared__ float smem[];
  float* s_q = smem;
  float* s_do = s_q + S::kTile;
  float* s_k = s_do + S::kTile;
  float* s_v = s_k + S::kTile;
  float* s_ds = s_v + S::kTile;           // [64][65]
  float* s_lse = s_ds + kRows * kLdS;
  float* s_delta = s_lse + kRows;

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  // the heaviest causal tiles (the last rows) start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / p.group;
  const int kvl = read_kv_len(p);
  load_tile<D>(s_q, static_cast<const T*>(p.q) + b * p.q_sb + hq * p.q_sh, p.q_ss, q0, p.sq);
  load_tile<D>(s_do, static_cast<const T*>(p.dout) + b * p.do_sb + hq * p.do_sh, p.do_ss,
               q0, p.sq);
  load_rows(p, s_lse, s_delta, ((int64_t)b * p.h + hq) * p.sq, q0);
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  int kt_begin, kt_end;
  key_tiles(p, q0, kvl, kt_begin, kt_end);
  float dq[4][D / 16];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dq[a][c] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kKeys;
    __syncthreads();  // the last tile's reads of s_k, s_ds are done
    load_tile<D>(s_k, kp, p.k_ss, k0, p.sk);
    load_tile<D>(s_v, vp, p.v_ss, k0, p.sk);
    __syncthreads();
    float s[4][4], dp[4][4];
    product_nt<D>(s, s_q, s_k, ty, tx);
    product_nt<D>(dp, s_do, s_v, ty, tx);
    softmax_grad(p, s, dp, s_lse, s_delta, q0, k0, kvl, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s_ds[(ty + 16 * a) * kLdS + tx + 16 * c] = dp[a][c];
    __syncthreads();
    product_nn<D>(dq, s_ds, s_k, ty, tx);
  }

  T* dqp = static_cast<T*>(p.dq) + b * p.dq_sb + hq * p.dq_sh;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + ty + 16 * a;
    if (row >= p.sq) continue;
#pragma unroll
    for (int c = 0; c < D / 16; ++c)
      store(dqp + (int64_t)row * p.dq_ss + tx + 16 * c, dq[a][c] * p.scale);
  }
}

// --------------------------------------------------------------- host
template <int D, typename T>
int launch(const Params& p, int64_t b, int64_t kvh, cudaStream_t stream) {
  using S = Smem<D>;
  // the opt-in above 48 KB, once per instantiation (so never inside a CUDA
  // graph capture that follows a first call)
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(attn_bwd_dkdv<D, T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           S::kDkDv);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(attn_bwd_dq<D, T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, S::kDq);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int64_t rows = b * p.h * (int64_t)p.sq;
  if (rows > 0) {
    const int64_t blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
    attn_bwd_delta<T><<<(unsigned)blocks, kThreads, 0, stream>>>(p, D, rows);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (p.sk > 0) {
    const dim3 grid((unsigned)((p.sk + kKeys - 1) / kKeys), (unsigned)kvh, (unsigned)b);
    attn_bwd_dkdv<D, T><<<grid, kThreads, S::kDkDv, stream>>>(p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (p.sq > 0) {
    const dim3 grid((unsigned)((p.sq + kRows - 1) / kRows), (unsigned)p.h, (unsigned)b);
    attn_bwd_dq<D, T><<<grid, kThreads, S::kDq, stream>>>(p);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Params& p, int64_t d, int64_t b, int64_t kvh, cudaStream_t s) {
  switch (d) {
    case 16: return launch<16, T>(p, b, kvh, s);
    case 32: return launch<32, T>(p, b, kvh, s);
    case 64: return launch<64, T>(p, b, kvh, s);
    case 128: return launch<128, T>(p, b, kvh, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// q, o, dout, dq (b, h, sq, d), k, v, dk, dv (b, kvh, sk, d), each given by
// its base pointer and its batch, head and row strides in elements (the
// last stride is 1); lse and delta (b, h, sq) float32, contiguous (delta is
// scratch the call overwrites). dtype: 0 float32, 1 bf16 (q, k, v, o, dout
// and the outputs alike). d: 16, 32, 64 or 128. kv_len: a device pointer to
// an int32, or null to use kv_len_value. window < 0: none. Every element of
// dq, dk and dv is written. Three kernels on `stream`; returns the first
// launch error (0 on success); never synchronizes.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* delta, void* dq, void* dk, void* dv,
    int64_t b, int64_t h, int64_t kvh, int64_t sq, int64_t sk, int64_t d,
    int64_t q_sb, int64_t q_sh, int64_t q_ss,
    int64_t k_sb, int64_t k_sh, int64_t k_ss,
    int64_t v_sb, int64_t v_sh, int64_t v_ss,
    int64_t o_sb, int64_t o_sh, int64_t o_ss,
    int64_t do_sb, int64_t do_sh, int64_t do_ss,
    int64_t dq_sb, int64_t dq_sh, int64_t dq_ss,
    int64_t dk_sb, int64_t dk_sh, int64_t dk_ss,
    int64_t dv_sb, int64_t dv_sh, int64_t dv_ss,
    const void* kv_len, int64_t kv_len_value, int causal, int64_t window,
    float scale, int dtype, void* stream) {
  if (b <= 0 || h <= 0) return 0;
  if (kvh <= 0 || h % kvh != 0 || sq > 2147483647LL || sk > 2147483647LL ||
      h > 65535 || b > 65535 || window > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.do_sb = do_sb; p.do_sh = do_sh; p.do_ss = do_ss;
  p.dq_sb = dq_sb; p.dq_sh = dq_sh; p.dq_ss = dq_ss;
  p.dk_sb = dk_sb; p.dk_sh = dk_sh; p.dk_ss = dk_ss;
  p.dv_sb = dv_sb; p.dv_sh = dv_sh; p.dv_ss = dv_ss;
  p.h = (int)h;
  p.sq = (int)sq;
  p.sk = (int)sk;
  p.group = (int)(h / kvh);
  p.kv_len = static_cast<const int*>(kv_len);
  p.kv_len_value = (int)(kv_len_value > sk ? sk : kv_len_value);  // the kernel clamps at 0
  p.causal = causal;
  p.window = window < 0 ? -1 : (int)window;
  p.scale = scale;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return dispatch<float>(p, d, b, kvh, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(p, d, b, kvh, s);
  return (int)cudaErrorInvalidValue;
}
