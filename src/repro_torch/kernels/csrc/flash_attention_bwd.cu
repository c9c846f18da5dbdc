// Flash attention backward for Hopper (sm_90a): dQ, dK and dV of the causal
// GQA attention of flash_attention.cu, with its masks (causal rows counted
// from 0, an optional sliding window, a ragged kv length read on the device).
//
//   P   = exp(s - lse),  s = q.k D^-1/2 over the valid columns, else 0
//   D_i = sum_d dO_i O_i                           (attn_bwd_delta)
//   dV  = P^T dO,  dP = dO V^T,  dS = P o (dP - D)
//   dK  = dS^T Q D^-1/2                             (attn_bwd_dkdv_*)
//   dQ  = dS K D^-1/2                               (attn_bwd_dq_*)
//
// lse is the forward's log-sum-exp ((b, h, sq) float32); a row with no valid
// column has lse = -inf and gets P = 0, so 0 gradients (every column of it
// is masked, and a masked P is 0 by selection). bf16 or float32 q, k, v, o,
// dO with a unit last stride; bf16 bases and strides in multiples of 16
// bytes, float32 rows on 16-byte boundaries; dq, dk, dv written in the input
// type through their own strides.
//
// Head dims: any d with 8 <= d <= 256 and d % 8 == 0, on instantiations D =
// 16, 32, 64, 128 and 256, d on the smallest D >= d, as in the forward:
// columns d..D-1 of q, k, v, o and dO read as zeros (TMA's fill on the bf16
// route; masked cp.async and Delta loads on the float32 route) and never
// stored to dq, dk or dv; the scale stays d^-1/2. At D = 256 each output
// tile is split over two blocks that own 128 columns each (Cols<D>) and
// recompute the tile pair's scores (dK and dV of all 256 columns would be
// 256 accumulators a thread): on the bf16 route with all tiles in shared
// memory (194 KB); on the float32 route by 128-column panels (see
// attn_bwd_dkdv_f32_wide).
//
// attn_p_dtype (Params::p_round): the float32 route rounds the recomputed
// P to bf16 or float16 for dV = P^T dO, as the forward rounded it before
// P.V; dS keeps P unrounded, as JAX's gradient of the cast does. The bf16
// route rounds P to bf16 in any case.
//
// Replaces: nothing in Pallas. The JAX package trains through
// attention_chunked (src/repro/models/attention.py:53-114, a lax.scan) and
// XLA differentiates that scan; this kernel stands where XLA's generated VJP
// stands, beside the forward kernel that replaces flash_attention_pallas
// (src/repro/kernels/flash_attention/flash_attention.py:121). It replaces
// a first version that ran every product as a SIMT float32 fmaf loop over
// shared memory (2.42 ms at the shape below, in either type).
//
// Bound on an H100 SXM at (8, 12, 1,024, 64) causal: the five products of
// the causal half, 32.2 GFLOP, take 0.033 ms at 989 TFLOP/s bf16, and the
// bytes (q, k, v, o, dO read, dq, dk, dv written: 100.7 MB bf16) 0.030 ms;
// the operations bound it. In float32 the bytes double (0.060 ms) and the
// products run as three TF32 products each: 0.195 ms at 495 TFLOP/s. This
// version takes about 0.29 ms in bf16 (8.9 x the bound; SDPA's backward
// 0.16) and 1.52 ms in float32 there (PERF.md section 6, row 9b): one
// warpgroup runs its products and the softmax gradient one after the other,
// and seven products do the work of five.
//
// Split: FlashAttention-2's backward in three kernels so that nothing needs
// atomics and two calls on the same inputs give the same bits.
// attn_bwd_delta takes D x sizeof(T) / 16 lanes a row, one 16-byte load of
// dO and of o each. attn_bwd_dkdv gives each (64-key
// tile, KV head, batch) to a block that keeps K and V in shared memory,
// walks every (query head of its group, query tile that can see the key
// tile) pair, recomputes S^T and P^T from lse, and accumulates dK and dV in
// registers: the GQA sum with no repeated K / V, each of dK and dV written
// once. attn_bwd_dq gives each (64-row query tile, head, batch) to a block
// that walks the key tiles the forward's key_tiles selects and accumulates
// dQ. Both recompute S and dP, so a tile pair costs seven 64 x 64 x D
// products where five are the least (1.4 x the operations); atomics on dQ
// would save two and give up bitwise-repeatable gradients. Heaviest causal
// tiles start first. Tiles with every (row, key) valid skip the masks.
//
// bf16 route (attn_bwd_*_tc): every product on wgmma, float32 accumulators,
// tiles fed by TMA from 4-D tensor maps built on the host (any (B, S, H, D)
// or (B, H, S, D) view, read in place, rows past the end zero-filled). A
// block is one consumer warpgroup and a producer warp, as in the forward.
//   dK/dV: the producer loads K and V once and streams the (Q, dO) 64-row
//   tiles, with their rows' lse and Delta (stored by its 32 lanes), through
//   a 2-stage ring behind full and empty mbarriers. The consumer computes
//   S^T = K.Q^T and dP^T = V.dO^T (m64n64k16, both operands K-major from
//   shared memory), forms P^T = exp2(s scale log2e - lse log2e) and dS^T =
//   P^T o (dP^T - Delta) on the accumulator fragment (lse and Delta read per
//   column from shared memory), packs both to bf16 (an m64 accumulator
//   fragment is the A operand as it lies) and accumulates dV += P^T.dO and
//   dK += dS^T.Q with register-A wgmma at N = D, dO and Q as MN-major B
//   operands (the transpose bit): one load of each tile feeds both uses.
//   dQ: Q and dO load once, K and V tiles stream through the ring; S = Q.K^T
//   and dP = dO.V^T shared x shared, dS in registers, dQ += dS.K register-A
//   with K as an MN-major B operand.
// P and dS are rounded to bf16 before the three gradient products, rounding
// points the plain backward (float32 P and dS) does not have. bf16 keeps 8
// significant bits, so each moves by at most 2^-8 of itself, and a gradient
// moves by at most 2^-8 A, A the float32 magnitude product of its terms
// (|P|^T |dO| for dv, D^-1/2 |dS|^T |Q| for dk, D^-1/2 |dS| |K| for dq;
// ref.py's flash_attention_bwd_magnitudes). With the tensor cores'
// float32 sums and the outputs' own bf16 rounding, the stated gate against
// the plain backward is |got - want| <= 2^-7 (1 + |want|) + 2 2^-8 A.
//
// float32 route (attn_bwd_*_f32): every product 3xTF32 on mma.sync
// m16n8k8 (wgmma takes tf32 only K-major, and four of the seven products
// read a tile MN-major). The same two kernels and tiles: 4 warps, each
// owning 16 keys (dK/dV) or 16 query rows (dQ), the streamed tiles through
// a 2-stage cp.async ring (lse and Delta by 4-byte copies beside them). Each
// operand is split into big = tf32(x) and small = tf32(x - big) and a
// product is big.big + big.small + small.big, small terms first. Tiles are
// [64][D + 4] floats, so both read patterns a tile meets (a row's 8
// consecutive dims, and 2 consecutive rows of one dim, for the transposed
// products P^T.dO, dS^T.Q, dS.K) hit 32 banks once. S^T / S accumulators
// are the A fragment of the next product as they lie (the k index of each
// 8-step permuted: k = t holds row 2t, k = t + 4 row 2t + 1). Each
// gradient product goes to fresh accumulators of 4 x 8 columns and is
// added to the running sum in float32 (the tensor cores' sums do not round
// to nearest). Each product is within 2^-20 of its magnitude product, so a
// gradient's own product within 2^-20 A; S and dP carry the same relative
// error into P and dS, and dS = P (dP - Delta) cancels, so dP's error
// (2^-20 of |dO| |V|^T) reaches dQ and dK through P |dO| |V|^T, not |dS|.
// The stated gate: |got - want| <= 1e-5 (1 + |want|) + 2^-19 A, A with
// that term (flash_attention_bwd_magnitudes(..., dp_error=True)).
//
// Both routes read kv_len on the device, take no host sync, build their
// tensor maps per call and set the shared-memory opt-in once per
// instantiation, so a call can be captured in a CUDA graph.
#include <math.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kRows = 64;                    // query rows per tile
constexpr int kKeys = 64;                    // keys per tile
constexpr int kDeltaThreads = 256;           // attn_bwd_delta's block
constexpr int kThreadsF32 = 128;             // f32: 4 warps
constexpr int kConsumers = 128;              // bf16: one warpgroup
constexpr int kThreadsTc = kConsumers + 32;  // bf16: plus the producer warp
constexpr int kStages = 2;                   // ring depth, both routes
constexpr float kLog2e = 1.4426950408889634f;

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
  int d;                     // head dim read and written, 8 <= d <= D, d % 8 == 0
  int p_round;               // P of dV = P^T dO: 0 float32, 1 bf16, 2 float16 (round_p)
};

// Output columns a block owns: all D up to 128; at D = 256 a block owns one
// half (its accumulators would otherwise take 256 registers a thread) and
// recomputes the tile pair's scores for it.
template <int D>
struct Cols {
  static constexpr int kOwn = D <= 128 ? D : 128;
  static constexpr int kSplit = D / kOwn;   // blocks a tile, one per column range
};

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

// The query tiles [begin, end) whose rows can see a key of [k0, k0 + kKeys).
__device__ __forceinline__ void query_tiles(const Params& p, int k0, int kvl,
                                            int& begin, int& end) {
  begin = p.causal ? k0 / kRows : 0;
  end = k0 < kvl ? (p.sq + kRows - 1) / kRows : 0;
  if (p.window >= 0) {
    const int64_t last_row = (int64_t)k0 + kKeys - 2 + p.window;  // col > row - window
    if (last_row / kRows + 1 < end) end = (int)(last_row / kRows + 1);
  }
  if (end < begin) end = begin;
}

__device__ __forceinline__ bool valid(const Params& p, int row, int col, int kvl) {
  return row < p.sq && col < kvl && (!p.causal || col <= row) &&
         (p.window < 0 || col > row - p.window);
}

// Every (row, key) of the tile pair is valid but for rows past sq, whose
// zero-filled q, dO, lse and Delta give P = 1 and dS = 0 and so add nothing.
__device__ __forceinline__ bool full_tile(const Params& p, int q0, int k0, int kvl) {
  return k0 + kKeys <= kvl && (!p.causal || k0 + kKeys - 1 <= q0) &&
         (p.window < 0 || k0 > q0 + kRows - 1 - p.window);
}

// P and dS of one score from s, dP and the row's lse (log2 units) and Delta
__device__ __forceinline__ void softmax_grad(float& s, float& dp, bool ok, float scale_log2,
                                             float lse2, float dlt) {
  const float pr = ok ? exp2f(fmaf(s, scale_log2, -lse2)) : 0.f;
  s = pr;
  dp = pr * (dp - dlt);
}

// sum of x . y over one 16-byte chunk of each
__device__ __forceinline__ float dot_chunk(const float* x, const float* y) {
  const float4 a = *reinterpret_cast<const float4*>(x);
  const float4 b = *reinterpret_cast<const float4*>(y);
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, a.x * b.x)));
}
__device__ __forceinline__ float dot_chunk(const __nv_bfloat16* x, const __nv_bfloat16* y) {
  const uint4 a = *reinterpret_cast<const uint4*>(x);
  const uint4 b = *reinterpret_cast<const uint4*>(y);
  const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(a2[i]), v = __bfloat1622float2(b2[i]);
    acc = fmaf(u.y, v.y, fmaf(u.x, v.x, acc));
  }
  return acc;
}

// D_i = sum_d dO_i O_i over the rows of (b, h, sq): L = min(D x sizeof(T)
// / 16, 32) lanes a row, each one or two 16-byte loads of dO and of o
// (chunks past d add 0), the row's sum over its lanes by shuffles in a
// fixed order, so the result is deterministic. Bound by its bytes.
template <typename T, int D>
__global__ void __launch_bounds__(kDeltaThreads) attn_bwd_delta(const Params p,
                                                                int64_t rows) {
  constexpr int kVec = 16 / (int)sizeof(T);  // elements a load
  constexpr int L = D / kVec < 32 ? D / kVec : 32;  // lanes a row
  constexpr int kChunks = D / kVec / L;      // loads a lane
  const int64_t r = (int64_t)blockIdx.x * (kDeltaThreads / L) + threadIdx.x / L;
  const int lane_c = (int)(threadIdx.x % L) * kVec;
  float acc = 0.f;
  if (r < rows) {
    const int64_t bh = r / p.sq;
    const int i = (int)(r % p.sq);
    const int b = (int)(bh / p.h), hq = (int)(bh % p.h);
    const T* o = static_cast<const T*>(p.o) + b * p.o_sb + hq * p.o_sh + i * p.o_ss;
    const T* g = static_cast<const T*>(p.dout) + b * p.do_sb + hq * p.do_sh + i * p.do_ss;
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch) {
      const int c = lane_c + ch * L * kVec;
      if (c < p.d) acc += dot_chunk(g + c, o + c);
    }
  }
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (r < rows && lane_c == 0) p.delta[r] = acc;
}

// ---------------------------------------------------------- bf16 route
// A tensor map's dimensions 1-3 hold (row, head, batch) in the order of
// their strides; axes[i] is the map dimension of row (0), head (1), batch (2).
struct MapAxes {
  int q[3], k[3], v[3], dout[3];
};

// Shared memory of both bf16 kernels (194 KB at D = 256): two resident
// tiles, kStages pairs of streamed tiles, (dK/dV only) kStages rows of lse
// and Delta, the barriers, and 1 KB of slack to round the base up to the
// swizzle's 1,024-byte repeat.
template <int D>
struct SmemTc {
  static constexpr int kTiles = (2 + 2 * kStages) * Tile<D>::kBytes;
  static constexpr int kRowsBytes = kStages * 2 * kRows * (int)sizeof(float);
  static constexpr int kDkDv = kTiles + kRowsBytes + 64 + 1024;
  static constexpr int kDq = kTiles + 64 + 1024;
};

// bf16 stores of an m64nD accumulator fragment, rows [r0, r0 + 64) of a
// (rows, D) matrix at `out` with row stride ss, scaled; rows at or past n
// and columns at or past ncols are not written
template <int D>
__device__ __forceinline__ void store_fragment(__nv_bfloat16* out, int64_t ss, int r0, int n,
                                               int ncols, const float (&acc)[D / 2],
                                               float scale) {
  const int lane = threadIdx.x & 31;
  const int row = r0 + 16 * (threadIdx.x >> 5) + (lane >> 2);
  const int col = 2 * (lane & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row + 8 * h >= n) continue;
    __nv_bfloat16* dst = out + (int64_t)(row + 8 * h) * ss + col;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      if (8 * j < ncols)
        *reinterpret_cast<uint32_t*>(dst + 8 * j) =
            pack_bf16(acc[4 * j + 2 * h] * scale, acc[4 * j + 2 * h + 1] * scale);
  }
}

// the m64n16 A fragments of the 16-column steps of a 64 x 64 fragment
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = pack_bf16(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
}

// dK and dV of one 64-key tile of one KV head, summed over its query heads,
// in the block's Cols<D> columns (155 registers at D = 64, 2 blocks an SM;
// capped for 3 it spilled and was 1.2 x slower)
template <int D>
__global__ void __launch_bounds__(kThreadsTc)
attn_bwd_dkdv_tc(const __grid_constant__ Params p,
                 const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v,
                 const __grid_constant__ CUtensorMap map_do,
                 const __grid_constant__ MapAxes axes) {
  using G = Tile<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t s_k = base;
  const uint32_t s_v = base + G::kBytes;
  const uint32_t s_q = base + 2 * G::kBytes;                // stage s: + 2 s kBytes
  const uint32_t s_do = s_q + G::kBytes;
  // [stage][lse (log2 units) 64 | Delta 64]
  float* const s_rows = reinterpret_cast<float*>(smem_raw + (base - raw) + SmemTc<D>::kTiles);
  const uint32_t bars = base + SmemTc<D>::kTiles + SmemTc<D>::kRowsBytes;
  const uint32_t bar_kv = bars;                             // 8 bytes each
  const uint32_t bar_full = bars + 8;                       // [kStages]
  const uint32_t bar_empty = bars + 8 + 8 * kStages;        // [kStages]

  using C = Cols<D>;
  const int k0 = blockIdx.x / C::kSplit * kKeys, hk = blockIdx.y, b = blockIdx.z;
  const int c0 = blockIdx.x % C::kSplit * C::kOwn;   // the block's first output column
  // the output products' B operands start at column c0's panel
  const uint32_t own = (uint32_t)(c0 / G::kPanelCols * G::kPanelBytes);
  const int kvl = read_kv_len(p);
  int qt_begin, qt_end;
  query_tiles(p, k0, kvl, qt_begin, qt_end);
  const int nq = qt_end - qt_begin;
  const int steps = p.group * nq;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 32);        // every producer lane arrives
      mbar_init(bar_empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ------------------------------------------------ producer warp
    const int lane = threadIdx.x - kConsumers;
    if (lane == 0 && steps > 0) {
      mbar_expect_tx(bar_kv, 2 * G::kBytes);
      tma_tile<D>(s_k, &map_k, axes.k, bar_kv, k0, hk, b);
      tma_tile<D>(s_v, &map_v, axes.v, bar_kv, k0, hk, b);
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int s = 0; s < steps; ++s) {
      const int hq = hk * p.group + s / nq, q0 = (qt_begin + s % nq) * kRows;
      mbar_wait(bar_empty + 8 * stage, phase ^ 1);
      // the tile's rows' lse and Delta; 0 past sq, like the zero-filled tiles
      float* rows = s_rows + stage * 2 * kRows;
      const int64_t row0 = ((int64_t)b * p.h + hq) * p.sq;
#pragma unroll
      for (int i = lane; i < kRows; i += 32) {
        const int row = q0 + i;
        const bool in = row < p.sq;
        rows[i] = in ? p.lse[row0 + row] * kLog2e : 0.f;
        rows[kRows + i] = in ? p.delta[row0 + row] : 0.f;
      }
      const uint32_t full = bar_full + 8 * stage;
      if (lane == 0) {
        mbar_expect_tx(full, 2 * G::kBytes);   // lane 0's arrival
        tma_tile<D>(s_q + 2 * stage * G::kBytes, &map_q, axes.q, full, q0, hq, b);
        tma_tile<D>(s_do + 2 * stage * G::kBytes, &map_do, axes.dout, full, q0, hq, b);
      } else {
        mbar_arrive(full);                     // after this lane's rows
      }
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // ------------------------------------------------ consumer warpgroup
  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  const int key0 = k0 + w * 16 + (lane >> 2);  // this thread's keys: key0, key0 + 8
  const int c_lane = 2 * (lane & 3);           // its first query row in each 8
  const float scale_log2 = p.scale * kLog2e;
  float dk[C::kOwn / 2], dv[C::kOwn / 2];
#pragma unroll
  for (int i = 0; i < C::kOwn / 2; ++i) dk[i] = dv[i] = 0.f;

  if (steps > 0) mbar_wait(bar_kv, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int s = 0; s < steps; ++s) {
    const int q0 = (qt_begin + s % nq) * kRows;
    mbar_wait(bar_full + 8 * stage, phase);
    const uint32_t q_tile = s_q + 2 * stage * G::kBytes;
    const uint32_t do_tile = s_do + 2 * stage * G::kBytes;
    const float* rows = s_rows + stage * 2 * kRows;

    // S^T = K . Q^T and dP^T = V . dO^T on the tensor cores
    float st[32], dpt[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
    fence_regs(st);
    fence_regs(dpt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(st, desc_k_major<D>(s_k, kk), desc_k_major<D>(q_tile, kk), 1);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dpt, desc_k_major<D>(s_v, kk), desc_k_major<D>(do_tile, kk), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(st);
    fence_regs(dpt);

    // P^T and dS^T: st[4 j + e] is key key0 + 8 (e >> 1), query row q0 + 8 j
    // + c_lane + (e & 1)
    const bool full = full_tile(p, q0, k0, kvl);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(rows + 8 * j + c_lane);
      const float2 dl = *reinterpret_cast<const float2*>(rows + kRows + 8 * j + c_lane);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + 8 * (e >> 1);
        const int row = q0 + 8 * j + c_lane + (e & 1);
        const bool ok = full || valid(p, row, key, kvl);
        softmax_grad(st[4 * j + e], dpt[4 * j + e], ok, scale_log2, (e & 1) ? l2.y : l2.x,
                     (e & 1) ? dl.y : dl.x);
      }
    }
    uint32_t a_p[4][4], a_ds[4][4];
    pack_a(a_p, st);
    pack_a(a_ds, dpt);

    // dV += P^T . dO and dK += dS^T . Q, dO and Q as MN-major B operands
    fence_regs(dv);
    fence_regs(dk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(dv, a_p[kk], desc_mn_major<D>(do_tile + own, kk), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(dk, a_ds[kk], desc_mn_major<D>(q_tile + own, kk), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dv);
    fence_regs(dk);
    mbar_arrive(bar_empty + 8 * stage);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }

  store_fragment<C::kOwn>(static_cast<__nv_bfloat16*>(p.dk) + b * p.dk_sb + hk * p.dk_sh + c0,
                          p.dk_ss, k0, p.sk, p.d - c0, dk, p.scale);
  store_fragment<C::kOwn>(static_cast<__nv_bfloat16*>(p.dv) + b * p.dv_sb + hk * p.dv_sh + c0,
                          p.dv_ss, k0, p.sk, p.d - c0, dv, 1.f);
}

// dQ of one 64-row query tile of one head
template <int D>
__global__ void __launch_bounds__(kThreadsTc)
attn_bwd_dq_tc(const __grid_constant__ Params p,
               const __grid_constant__ CUtensorMap map_q,
               const __grid_constant__ CUtensorMap map_k,
               const __grid_constant__ CUtensorMap map_v,
               const __grid_constant__ CUtensorMap map_do,
               const __grid_constant__ MapAxes axes) {
  using G = Tile<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t s_q = base;
  const uint32_t s_do = base + G::kBytes;
  const uint32_t s_k = base + 2 * G::kBytes;                // stage s: + 2 s kBytes
  const uint32_t s_v = s_k + G::kBytes;
  const uint32_t bars = base + SmemTc<D>::kTiles;
  const uint32_t bar_q = bars;                              // 8 bytes each
  const uint32_t bar_full = bars + 8;                       // [kStages]
  const uint32_t bar_empty = bars + 8 + 8 * kStages;        // [kStages]

  // the heaviest causal tiles (the last rows) start first
  using C = Cols<D>;
  const int q0 = (gridDim.x / C::kSplit - 1 - blockIdx.x / C::kSplit) * kRows;
  const int c0 = blockIdx.x % C::kSplit * C::kOwn;   // the block's first output column
  const uint32_t own = (uint32_t)(c0 / G::kPanelCols * G::kPanelBytes);
  const int hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / p.group;
  const int kvl = read_kv_len(p);
  int kt_begin, kt_end;
  key_tiles(p, q0, kvl, kt_begin, kt_end);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ------------------------------------------------ producer warp
    if (threadIdx.x == kConsumers && kt_begin < kt_end) {
      mbar_expect_tx(bar_q, 2 * G::kBytes);
      tma_tile<D>(s_q, &map_q, axes.q, bar_q, q0, hq, b);
      tma_tile<D>(s_do, &map_do, axes.dout, bar_q, q0, hq, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = kt_begin; kt < kt_end; ++kt) {
        mbar_wait(bar_empty + 8 * stage, phase ^ 1);
        const uint32_t full = bar_full + 8 * stage;
        mbar_expect_tx(full, 2 * G::kBytes);
        tma_tile<D>(s_k + 2 * stage * G::kBytes, &map_k, axes.k, full, kt * kKeys, hk, b);
        tma_tile<D>(s_v + 2 * stage * G::kBytes, &map_v, axes.v, full, kt * kKeys, hk, b);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ------------------------------------------------ consumer warpgroup
  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  const int r0 = q0 + w * 16 + (lane >> 2);  // this thread's rows: r0, r0 + 8
  const int c_lane = 2 * (lane & 3);         // its first key in each 8
  const float scale_log2 = p.scale * kLog2e;
  const int64_t row0 = ((int64_t)b * p.h + hq) * p.sq;
  float lse2[2], dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    lse2[h] = row < p.sq ? p.lse[row0 + row] * kLog2e : 0.f;
    dlt[h] = row < p.sq ? p.delta[row0 + row] : 0.f;
  }
  float dq[C::kOwn / 2];
#pragma unroll
  for (int i = 0; i < C::kOwn / 2; ++i) dq[i] = 0.f;

  if (kt_begin < kt_end) mbar_wait(bar_q, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kKeys;
    mbar_wait(bar_full + 8 * stage, phase);
    const uint32_t k_tile = s_k + 2 * stage * G::kBytes;
    const uint32_t v_tile = s_v + 2 * stage * G::kBytes;

    // S = Q . K^T and dP = dO . V^T on the tensor cores
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, desc_k_major<D>(s_q, kk), desc_k_major<D>(k_tile, kk), 1);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dp, desc_k_major<D>(s_do, kk), desc_k_major<D>(v_tile, kk), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // dS: s[4 j + e] is row r0 + 8 (e >> 1), key k0 + 8 j + c_lane + (e & 1)
    const bool full = full_tile(p, q0, k0, kvl);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + 8 * (e >> 1);
        const int col = k0 + 8 * j + c_lane + (e & 1);
        const bool ok = full || valid(p, row, col, kvl);
        softmax_grad(s[4 * j + e], dp[4 * j + e], ok, scale_log2, lse2[e >> 1], dlt[e >> 1]);
      }
    uint32_t a[4][4];
    pack_a(a, dp);

    // dQ += dS . K, K as an MN-major B operand
    fence_regs(dq);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(dq, a[kk], desc_mn_major<D>(k_tile + own, kk), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dq);
    mbar_arrive(bar_empty + 8 * stage);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }

  store_fragment<C::kOwn>(static_cast<__nv_bfloat16*>(p.dq) + b * p.dq_sb + hq * p.dq_sh + c0,
                          p.dq_ss, q0, p.sq, p.d - c0, dq, p.scale);
}

// ------------------------------------------------------- float32 route
// Shared memory of both float32 kernels: two resident [64][D + 4] tiles,
// kStages pairs of streamed ones and (dK/dV only) kStages rows of lse and
// Delta. A stride of D + 4 floats (4 mod 32, 20 at D = 16) puts a row's 8
// consecutive dims (fragment reads g ld + t) and 2 consecutive rows of one
// dim (2 t ld + g) on 32 distinct banks.
template <int D>
struct SmemF32 {
  static constexpr int kLd = D + 4;
  static constexpr int kTile = kRows * kLd;                      // floats
  static constexpr int kRowFloats = 2 * kRows;                   // lse | Delta
  static constexpr int kDkDv = ((2 + 2 * kStages) * kTile + kStages * kRowFloats) * 4;
  static constexpr int kDq = (2 + 2 * kStages) * kTile * 4;
};

// rows [r0, r0 + 64) of a (rows, D) float32 matrix with row stride ss into a
// [64][D + 4] tile at dst, 16 bytes a copy; rows at or past n and columns
// at or past ncols zero-filled
template <int D>
__device__ __forceinline__ void load_tile_f32(uint32_t dst, const float* src, int64_t ss,
                                              int r0, int n, int ncols) {
  constexpr int C = D / 4;  // 16-byte chunks a row
  for (int e = threadIdx.x; e < kRows * C; e += kThreadsF32) {
    const int r = e / C, c = e % C;
    const int row = r0 + r;
    const bool ok = row < n && 4 * c < ncols;
    cp_async16(dst + (uint32_t)((r * SmemF32<D>::kLd + 4 * c) * sizeof(float)),
               ok ? src + (int64_t)row * ss + 4 * c : src, ok);
  }
}

// P of a (16 x 64) fragment rounded as attn_p_dtype asks (mode 0: kept),
// one uniform branch for the whole fragment
__device__ __forceinline__ void round_all(float (&x)[8][4], int mode) {
  if (mode == 0) return;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = round_p(x[j][e], mode);
}

// A (16 rows from `x`, row stride ld, dims 8 kk ..) of the m16n8k8 fragment, split
__device__ __forceinline__ void a_frag(const float* x, int ld, int kk, int g, int t,
                                       uint32_t (&ab)[4], uint32_t (&as)[4]) {
  const float* r = x + g * ld + 8 * kk + t;
  split_tf32(r[0], ab[0], as[0]);
  split_tf32(r[8 * ld], ab[1], as[1]);
  split_tf32(r[4], ab[2], as[2]);
  split_tf32(r[8 * ld + 4], ab[3], as[3]);
}

// acc (16 x 64, 8 groups of 8 columns) = X . Y^T over D for the 16 rows of
// X at x and the 64 rows of Y at y, both tiles of row stride LD
template <int D, int LD = SmemF32<D>::kLd>
__device__ __forceinline__ void product_nt(float (&acc)[8][4], const float* x, const float* y,
                                           int g, int t) {
  constexpr int ld = LD;
  constexpr int NJ = 4;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    uint32_t ab[4], as[4];
    a_frag(x, ld, kk, g, t, ab, as);
#pragma unroll
    for (int jg = 0; jg < 8; jg += NJ) {
      uint32_t bb[NJ][2], bs[NJ][2];
#pragma unroll
      for (int i = 0; i < NJ; ++i) {
        const float* r = y + (8 * (jg + i) + g) * ld + 8 * kk + t;
        split_tf32(r[0], bb[i][0], bs[i][0]);
        split_tf32(r[4], bb[i][1], bs[i][1]);
      }
      mma_3xtf32<NJ>(acc, jg, ab, as, bb, bs);
    }
  }
}

// out (16 x D) += A . Y, A (16 x 64) the accumulators of a product_nt as
// they lie (k = t of step j holds column 8 j + 2 t, k = t + 4 column 8 j +
// 2 t + 1) and Y the 64 rows of a [.][D + 4] tile at y; NO groups of 8
// output columns at a time into fresh accumulators, each added to out in
// float32
template <int D>
__device__ __forceinline__ void product_an(float (&out)[D / 8][4], const float (&a)[8][4],
                                           const float* y, int g, int t) {
  constexpr int ld = SmemF32<D>::kLd;
  constexpr int NO = D / 8 < 4 ? D / 8 : 4;
#pragma unroll
  for (int ng = 0; ng < D / 8; ng += NO) {
    float acc[NO][4];
#pragma unroll
    for (int i = 0; i < NO; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t ab[4], as[4];
      split_tf32(a[j][0], ab[0], as[0]);   // row g,     column 2 t
      split_tf32(a[j][2], ab[1], as[1]);   // row g + 8, column 2 t
      split_tf32(a[j][1], ab[2], as[2]);   // row g,     column 2 t + 1
      split_tf32(a[j][3], ab[3], as[3]);   // row g + 8, column 2 t + 1
      const float* r = y + (8 * j + 2 * t) * ld + g;
      uint32_t bb[NO][2], bs[NO][2];
#pragma unroll
      for (int i = 0; i < NO; ++i) {
        split_tf32(r[8 * (ng + i)], bb[i][0], bs[i][0]);
        split_tf32(r[ld + 8 * (ng + i)], bb[i][1], bs[i][1]);
      }
      mma_3xtf32<NO>(acc, 0, ab, as, bb, bs);
    }
#pragma unroll
    for (int i = 0; i < NO; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) out[ng + i][e] += acc[i][e];
  }
}

// float32 stores of a warp's (16 x D) fragment, rows r0 + g and r0 + g + 8
// of a (rows, D) matrix at `out`, scaled; rows at or past n and columns at
// or past ncols are not written
template <int D>
__device__ __forceinline__ void store_f32(float* out, int64_t ss, int r0, int n, int ncols,
                                          const float (&acc)[D / 8][4], float scale, int g,
                                          int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + g + 8 * h;
    if (row >= n) continue;
    float* dst = out + (int64_t)row * ss + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      if (8 * j < ncols)
        *reinterpret_cast<float2*>(dst + 8 * j) =
            make_float2(acc[j][2 * h] * scale, acc[j][2 * h + 1] * scale);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreadsF32)
attn_bwd_dkdv_f32(const Params p) {
  using S = SmemF32<D>;
  extern __shared__ float4 smem_f4[];
  float* const smem = reinterpret_cast<float*>(smem_f4);
  const uint32_t smem_base = smem_u32(smem);
  // K, V, then kStages (Q, dO) pairs, then kStages (lse, Delta) rows
  const float* const s_k = smem;
  const float* const s_v = smem + S::kTile;
  const float* const s_rows = smem + (2 + 2 * kStages) * S::kTile;

  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // the mma fragments' group / thread
  const int k0 = blockIdx.x * kKeys, hk = blockIdx.y, b = blockIdx.z;
  const int kvl = read_kv_len(p);
  int qt_begin, qt_end;
  query_tiles(p, k0, kvl, qt_begin, qt_end);
  const int nq = qt_end - qt_begin;
  const int steps = p.group * nq;
  const int key0 = k0 + 16 * w + g;          // this thread's keys: key0, key0 + 8

  // (Q, dO, lse, Delta) of step s into stage st
  auto load_step = [&](int s, int st) {
    const int hq = hk * p.group + s / nq, q0 = (qt_begin + s % nq) * kRows;
    const uint32_t qs = smem_base + (uint32_t)((2 + 2 * st) * S::kTile * sizeof(float));
    load_tile_f32<D>(qs, static_cast<const float*>(p.q) + b * p.q_sb + hq * p.q_sh, p.q_ss,
                     q0, p.sq, p.d);
    load_tile_f32<D>(qs + (uint32_t)(S::kTile * sizeof(float)),
                     static_cast<const float*>(p.dout) + b * p.do_sb + hq * p.do_sh, p.do_ss,
                     q0, p.sq, p.d);
    if (tid < 2 * kRows) {
      const int i = tid % kRows, row = q0 + i;
      const bool ok = row < p.sq;
      const float* src = (tid < kRows ? p.lse : p.delta) + ((int64_t)b * p.h + hq) * p.sq;
      cp_async4(smem_base + (uint32_t)(((2 + 2 * kStages) * S::kTile + st * S::kRowFloats +
                                        tid) * sizeof(float)),
                ok ? src + row : src, ok);
    }
  };
  if (steps > 0) {
    load_tile_f32<D>(smem_base, static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh,
                     p.k_ss, k0, p.sk, p.d);
    load_tile_f32<D>(smem_base + (uint32_t)(S::kTile * sizeof(float)),
                     static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh, p.v_ss, k0,
                     p.sk, p.d);
    load_step(0, 0);
  }
  cp_async_commit();

  const float scale_log2 = p.scale * kLog2e;
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  for (int s = 0; s < steps; ++s) {
    const int st = s & 1;
    if (s + 1 < steps) load_step(s + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait_prev();  // step s has landed
    __syncthreads();
    const int q0 = (qt_begin + s % nq) * kRows;
    const float* qs = smem + (2 + 2 * st) * S::kTile;
    const float* dos = qs + S::kTile;
    const float* rows = s_rows + st * S::kRowFloats;

    // S^T = K . Q^T and dP^T = V . dO^T for this warp's 16 keys: [j][e] is
    // key key0 + 8 (e >> 1), query row q0 + 8 j + 2 t + (e & 1)
    float sp[8][4], dp[8][4];
    product_nt<D>(sp, s_k + 16 * w * S::kLd, qs, g, t);
    product_nt<D>(dp, s_v + 16 * w * S::kLd, dos, g, t);
    const bool full = full_tile(p, q0, k0, kvl);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(rows + 8 * j + 2 * t);
      const float2 dl = *reinterpret_cast<const float2*>(rows + kRows + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + 8 * (e >> 1);
        const int row = q0 + 8 * j + 2 * t + (e & 1);
        const bool ok = full || valid(p, row, key, kvl);
        softmax_grad(sp[j][e], dp[j][e], ok, scale_log2, ((e & 1) ? l2.y : l2.x) * kLog2e,
                     (e & 1) ? dl.y : dl.x);
      }
    }
    round_all(sp, p.p_round);          // dV's P as the forward rounded it; dS did not
    product_an<D>(dv, sp, dos, g, t);  // dV += P^T . dO
    product_an<D>(dk, dp, qs, g, t);   // dK += dS^T . Q
    __syncthreads();  // stage st is read; the next prefetch may overwrite it
  }

  store_f32<D>(static_cast<float*>(p.dk) + b * p.dk_sb + hk * p.dk_sh, p.dk_ss, k0 + 16 * w,
               p.sk, p.d, dk, p.scale, g, t);
  store_f32<D>(static_cast<float*>(p.dv) + b * p.dv_sb + hk * p.dv_sh, p.dv_ss, k0 + 16 * w,
               p.sk, p.d, dv, 1.f, g, t);
}

template <int D>
__global__ void __launch_bounds__(kThreadsF32)
attn_bwd_dq_f32(const Params p) {
  using S = SmemF32<D>;
  extern __shared__ float4 smem_f4[];
  float* const smem = reinterpret_cast<float*>(smem_f4);
  const uint32_t smem_base = smem_u32(smem);
  // Q, dO, then kStages (K, V) pairs
  const float* const s_q = smem;
  const float* const s_do = smem + S::kTile;

  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // the heaviest causal tiles (the last rows) start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / p.group;
  const int kvl = read_kv_len(p);
  int kt_begin, kt_end;
  key_tiles(p, q0, kvl, kt_begin, kt_end);
  const int r0 = q0 + 16 * w + g;           // this thread's rows: r0, r0 + 8

  const float* kp = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vp = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  auto load_keys = [&](int kt, int st) {
    const uint32_t ks = smem_base + (uint32_t)((2 + 2 * st) * S::kTile * sizeof(float));
    load_tile_f32<D>(ks, kp, p.k_ss, kt * kKeys, p.sk, p.d);
    load_tile_f32<D>(ks + (uint32_t)(S::kTile * sizeof(float)), vp, p.v_ss, kt * kKeys, p.sk,
                     p.d);
  };
  if (kt_begin < kt_end) {
    load_tile_f32<D>(smem_base, static_cast<const float*>(p.q) + b * p.q_sb + hq * p.q_sh,
                     p.q_ss, q0, p.sq, p.d);
    load_tile_f32<D>(smem_base + (uint32_t)(S::kTile * sizeof(float)),
                     static_cast<const float*>(p.dout) + b * p.do_sb + hq * p.do_sh, p.do_ss,
                     q0, p.sq, p.d);
    load_keys(kt_begin, 0);
  }
  cp_async_commit();

  const float scale_log2 = p.scale * kLog2e;
  const int64_t row0 = ((int64_t)b * p.h + hq) * p.sq;
  float lse2[2], dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    lse2[h] = row < p.sq ? p.lse[row0 + row] * kLog2e : 0.f;
    dlt[h] = row < p.sq ? p.delta[row0 + row] : 0.f;
  }
  float dq[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int st = (kt - kt_begin) & 1;
    if (kt + 1 < kt_end) load_keys(kt + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait_prev();  // tile kt has landed
    __syncthreads();
    const int k0 = kt * kKeys;
    const float* ks = smem + (2 + 2 * st) * S::kTile;
    const float* vs = ks + S::kTile;

    // S = Q . K^T and dP = dO . V^T for this warp's 16 rows: [j][e] is row
    // r0 + 8 (e >> 1), key k0 + 8 j + 2 t + (e & 1)
    float sp[8][4], dp[8][4];
    product_nt<D>(sp, s_q + 16 * w * S::kLd, ks, g, t);
    product_nt<D>(dp, s_do + 16 * w * S::kLd, vs, g, t);
    const bool full = full_tile(p, q0, k0, kvl);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + 8 * (e >> 1);
        const int col = k0 + 8 * j + 2 * t + (e & 1);
        const bool ok = full || valid(p, row, col, kvl);
        softmax_grad(sp[j][e], dp[j][e], ok, scale_log2, lse2[e >> 1], dlt[e >> 1]);
      }
    product_an<D>(dq, dp, ks, g, t);   // dQ += dS . K
    __syncthreads();  // stage st is read; the next prefetch may overwrite it
  }

  store_f32<D>(static_cast<float*>(p.dq) + b * p.dq_sb + hq * p.dq_sh, p.dq_ss, q0 + 16 * w,
               p.sq, p.d, dq, p.scale, g, t);
}

// ------------------------------------------- float32 route at D = 256
// Four [64][D + 4] float32 tiles take 266 KB, more than a block has, and
// dK and dV of all 256 columns would take 256 registers a thread. So a
// block owns one 128-column half of its outputs (Cols<D>), and each tile
// pair is streamed as 128-column panels of K, V, Q and dO, one panel of
// each in shared memory (133 KB), loaded and then read: S^T and dP^T sum
// over the panels (the block's own panel last, so that its Q and dO are in
// place for the two gradient products). Every 64 dims of S^T and dP^T go
// to fresh accumulators added in float32, as P.V's tiles are in the
// forward: the tensor cores' float32 sums do not round to nearest, so a
// chain's error grows faster than its length, and one chain over all 256
// dims came to 1.3 x the stated bound on the card. Slow (nothing overlaps,
// K and V are read again for every step) but right; PERF.md records its
// time.
constexpr int kPanel = 128;   // dims a panel

using SmemWide = SmemF32<kPanel>;
constexpr int kWideSmem = 4 * SmemWide::kTile * 4 + SmemWide::kRowFloats * 4;

// acc += X . Y^T over one panel (rows of X at x, of Y at y), 64 dims at a
// time into fresh accumulators added in float32
__device__ __forceinline__ void panel_nt(float (&acc)[8][4], const float* x, const float* y,
                                         int g, int t) {
#pragma unroll
  for (int c = 0; c < kPanel; c += 64) {
    float part[8][4];
    product_nt<64, SmemWide::kLd>(part, x + c, y + c, g, t);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
  }
}

// the panel `panel` of rows [r0, r0 + 64) of a (rows, d) matrix into a tile
__device__ __forceinline__ void load_panel(uint32_t dst, const float* src, int64_t ss, int r0,
                                           int n, int panel, int d) {
  load_tile_f32<kPanel>(dst, src + panel * kPanel, ss, r0, n, d - panel * kPanel);
}

template <int D>
__global__ void __launch_bounds__(kThreadsF32)
attn_bwd_dkdv_f32_wide(const Params p) {
  using C = Cols<D>;
  constexpr int ld = SmemWide::kLd;
  extern __shared__ float4 smem_f4[];
  float* const smem = reinterpret_cast<float*>(smem_f4);
  const uint32_t smem_base = smem_u32(smem);
  // K, V, Q, dO panels, then the step's (lse, Delta) rows
  const float* const s_k = smem;
  const float* const s_v = smem + SmemWide::kTile;
  const float* const s_q = smem + 2 * SmemWide::kTile;
  const float* const s_do = smem + 3 * SmemWide::kTile;
  const float* const s_rows = smem + 4 * SmemWide::kTile;
  const uint32_t at = (uint32_t)(SmemWide::kTile * sizeof(float));

  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x / C::kSplit * kKeys, hk = blockIdx.y, b = blockIdx.z;
  const int half = blockIdx.x % C::kSplit;
  const int kvl = read_kv_len(p);
  int qt_begin, qt_end;
  query_tiles(p, k0, kvl, qt_begin, qt_end);
  const int nq = qt_end - qt_begin;
  const int steps = p.group * nq;
  const int key0 = k0 + 16 * w + g;          // this thread's keys: key0, key0 + 8
  const float* kp = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vp = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;

  const float scale_log2 = p.scale * kLog2e;
  float dk[kPanel / 8][4], dv[kPanel / 8][4];
#pragma unroll
  for (int j = 0; j < kPanel / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  for (int s = 0; s < steps; ++s) {
    const int hq = hk * p.group + s / nq, q0 = (qt_begin + s % nq) * kRows;
    const float* qp = static_cast<const float*>(p.q) + b * p.q_sb + hq * p.q_sh;
    const float* dop = static_cast<const float*>(p.dout) + b * p.do_sb + hq * p.do_sh;
    float sp[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sp[j][e] = dp[j][e] = 0.f;
    for (int pi = 0; pi < C::kSplit; ++pi) {
      const int panel = (half + 1 + pi) % C::kSplit;   // the own half last
      __syncthreads();   // the previous panel is read
      load_panel(smem_base, kp, p.k_ss, k0, p.sk, panel, p.d);
      load_panel(smem_base + at, vp, p.v_ss, k0, p.sk, panel, p.d);
      load_panel(smem_base + 2 * at, qp, p.q_ss, q0, p.sq, panel, p.d);
      load_panel(smem_base + 3 * at, dop, p.do_ss, q0, p.sq, panel, p.d);
      if (pi == 0 && tid < 2 * kRows) {
        const int i = tid % kRows, row = q0 + i;
        const bool ok = row < p.sq;
        const float* src = (tid < kRows ? p.lse : p.delta) + ((int64_t)b * p.h + hq) * p.sq;
        cp_async4(smem_base + 4 * at + (uint32_t)(tid * sizeof(float)), ok ? src + row : src,
                  ok);
      }
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
      panel_nt(sp, s_k + 16 * w * ld, s_q, g, t);
      panel_nt(dp, s_v + 16 * w * ld, s_do, g, t);
    }
    const bool full = full_tile(p, q0, k0, kvl);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(s_rows + 8 * j + 2 * t);
      const float2 dl = *reinterpret_cast<const float2*>(s_rows + kRows + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + 8 * (e >> 1);
        const int row = q0 + 8 * j + 2 * t + (e & 1);
        const bool ok = full || valid(p, row, key, kvl);
        softmax_grad(sp[j][e], dp[j][e], ok, scale_log2, ((e & 1) ? l2.y : l2.x) * kLog2e,
                     (e & 1) ? dl.y : dl.x);
      }
    }
    round_all(sp, p.p_round);
    product_an<kPanel>(dv, sp, s_do, g, t);  // dV += P^T . dO, own columns
    product_an<kPanel>(dk, dp, s_q, g, t);   // dK += dS^T . Q
  }

  const int c0 = half * kPanel;
  store_f32<kPanel>(static_cast<float*>(p.dk) + b * p.dk_sb + hk * p.dk_sh + c0, p.dk_ss,
                    k0 + 16 * w, p.sk, p.d - c0, dk, p.scale, g, t);
  store_f32<kPanel>(static_cast<float*>(p.dv) + b * p.dv_sb + hk * p.dv_sh + c0, p.dv_ss,
                    k0 + 16 * w, p.sk, p.d - c0, dv, 1.f, g, t);
}

template <int D>
__global__ void __launch_bounds__(kThreadsF32)
attn_bwd_dq_f32_wide(const Params p) {
  using C = Cols<D>;
  constexpr int ld = SmemWide::kLd;
  extern __shared__ float4 smem_f4[];
  float* const smem = reinterpret_cast<float*>(smem_f4);
  const uint32_t smem_base = smem_u32(smem);
  // Q, dO, K, V panels
  const float* const s_q = smem;
  const float* const s_do = smem + SmemWide::kTile;
  const float* const s_k = smem + 2 * SmemWide::kTile;
  const float* const s_v = smem + 3 * SmemWide::kTile;
  const uint32_t at = (uint32_t)(SmemWide::kTile * sizeof(float));

  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // the heaviest causal tiles (the last rows) start first
  const int q0 = (gridDim.x / C::kSplit - 1 - blockIdx.x / C::kSplit) * kRows;
  const int half = blockIdx.x % C::kSplit;
  const int hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / p.group;
  const int kvl = read_kv_len(p);
  int kt_begin, kt_end;
  key_tiles(p, q0, kvl, kt_begin, kt_end);
  const int r0 = q0 + 16 * w + g;           // this thread's rows: r0, r0 + 8
  const float* qp = static_cast<const float*>(p.q) + b * p.q_sb + hq * p.q_sh;
  const float* dop = static_cast<const float*>(p.dout) + b * p.do_sb + hq * p.do_sh;
  const float* kp = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vp = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;

  const float scale_log2 = p.scale * kLog2e;
  const int64_t row0 = ((int64_t)b * p.h + hq) * p.sq;
  float lse2[2], dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    lse2[h] = row < p.sq ? p.lse[row0 + row] * kLog2e : 0.f;
    dlt[h] = row < p.sq ? p.delta[row0 + row] : 0.f;
  }
  float dq[kPanel / 8][4];
#pragma unroll
  for (int j = 0; j < kPanel / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kKeys;
    float sp[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sp[j][e] = dp[j][e] = 0.f;
    for (int pi = 0; pi < C::kSplit; ++pi) {
      const int panel = (half + 1 + pi) % C::kSplit;   // the own half last
      __syncthreads();   // the previous panel is read
      load_panel(smem_base, qp, p.q_ss, q0, p.sq, panel, p.d);
      load_panel(smem_base + at, dop, p.do_ss, q0, p.sq, panel, p.d);
      load_panel(smem_base + 2 * at, kp, p.k_ss, k0, p.sk, panel, p.d);
      load_panel(smem_base + 3 * at, vp, p.v_ss, k0, p.sk, panel, p.d);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
      panel_nt(sp, s_q + 16 * w * ld, s_k, g, t);
      panel_nt(dp, s_do + 16 * w * ld, s_v, g, t);
    }
    const bool full = full_tile(p, q0, k0, kvl);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + 8 * (e >> 1);
        const int col = k0 + 8 * j + 2 * t + (e & 1);
        const bool ok = full || valid(p, row, col, kvl);
        softmax_grad(sp[j][e], dp[j][e], ok, scale_log2, lse2[e >> 1], dlt[e >> 1]);
      }
    product_an<kPanel>(dq, dp, s_k, g, t);   // dQ += dS . K, own columns
  }

  const int c0 = half * kPanel;
  store_f32<kPanel>(static_cast<float*>(p.dq) + b * p.dq_sb + hq * p.dq_sh + c0, p.dq_ss,
                    q0 + 16 * w, p.sq, p.d - c0, dq, p.scale, g, t);
}

// --------------------------------------------------------------- host
template <typename T, int D>
int launch_delta(const Params& p, int64_t b, cudaStream_t stream) {
  constexpr int kLanes = D * (int)sizeof(T) / 16 < 32 ? D * (int)sizeof(T) / 16 : 32;
  constexpr int kRowsPerBlock = kDeltaThreads / kLanes;
  const int64_t rows = b * p.h * (int64_t)p.sq;
  const int64_t blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  attn_bwd_delta<T, D><<<(unsigned)blocks, kDeltaThreads, 0, stream>>>(p, rows);
  return (int)cudaGetLastError();
}

// D = 256: the panel-streaming kernels, two blocks (column halves) a tile
int launch_f32_wide(const Params& p, int64_t b, int64_t kvh, cudaStream_t stream) {
  constexpr int D = 256;
  using C = Cols<D>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(attn_bwd_dkdv_f32_wide<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           kWideSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(attn_bwd_dq_f32_wide<D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kWideSmem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  int err = launch_delta<float, D>(p, b, stream);
  if (err != 0) return err;
  const dim3 kv_grid((unsigned)((p.sk + kKeys - 1) / kKeys * C::kSplit), (unsigned)kvh,
                     (unsigned)b);
  attn_bwd_dkdv_f32_wide<D><<<kv_grid, kThreadsF32, kWideSmem, stream>>>(p);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  const dim3 q_grid((unsigned)((p.sq + kRows - 1) / kRows * C::kSplit), (unsigned)p.h,
                    (unsigned)b);
  attn_bwd_dq_f32_wide<D><<<q_grid, kThreadsF32, kWideSmem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const Params& p, int64_t b, int64_t kvh, cudaStream_t stream) {
  using S = SmemF32<D>;
  // the opt-in above 48 KB, once per instantiation (so never inside a CUDA
  // graph capture that follows a first call)
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(attn_bwd_dkdv_f32<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           S::kDkDv);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(attn_bwd_dq_f32<D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, S::kDq);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  int err = launch_delta<float, D>(p, b, stream);
  if (err != 0) return err;
  const dim3 kv_grid((unsigned)((p.sk + kKeys - 1) / kKeys), (unsigned)kvh, (unsigned)b);
  attn_bwd_dkdv_f32<D><<<kv_grid, kThreadsF32, S::kDkDv, stream>>>(p);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  const dim3 q_grid((unsigned)((p.sq + kRows - 1) / kRows), (unsigned)p.h, (unsigned)b);
  attn_bwd_dq_f32<D><<<q_grid, kThreadsF32, S::kDq, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_tc(const Params& p, int64_t b, int64_t kvh, cudaStream_t stream) {
  using S = SmemTc<D>;
  using C = Cols<D>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(attn_bwd_dkdv_tc<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           S::kDkDv);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(attn_bwd_dq_tc<D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, S::kDq);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  alignas(64) CUtensorMap mq, mk, mv, mdo;
  MapAxes axes;
  cudaError_t e;
  const int64_t h = p.h;
  if ((e = make_map<D>(&mq, axes.q, p.q, b, h, p.sq, p.q_sb, p.q_sh, p.q_ss, p.d)) !=
          cudaSuccess ||
      (e = make_map<D>(&mk, axes.k, p.k, b, kvh, p.sk, p.k_sb, p.k_sh, p.k_ss, p.d)) !=
          cudaSuccess ||
      (e = make_map<D>(&mv, axes.v, p.v, b, kvh, p.sk, p.v_sb, p.v_sh, p.v_ss, p.d)) !=
          cudaSuccess ||
      (e = make_map<D>(&mdo, axes.dout, p.dout, b, h, p.sq, p.do_sb, p.do_sh, p.do_ss, p.d)) !=
          cudaSuccess)
    return (int)e;
  int err = launch_delta<__nv_bfloat16, D>(p, b, stream);
  if (err != 0) return err;
  const dim3 kv_grid((unsigned)((p.sk + kKeys - 1) / kKeys * C::kSplit), (unsigned)kvh,
                     (unsigned)b);
  attn_bwd_dkdv_tc<D><<<kv_grid, kThreadsTc, S::kDkDv, stream>>>(p, mq, mk, mv, mdo, axes);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  const dim3 q_grid((unsigned)((p.sq + kRows - 1) / kRows * C::kSplit), (unsigned)p.h,
                    (unsigned)b);
  attn_bwd_dq_tc<D><<<q_grid, kThreadsTc, S::kDq, stream>>>(p, mq, mk, mv, mdo, axes);
  return (int)cudaGetLastError();
}

// d runs on the smallest instantiation D >= d (16, 32, 64, 128, 256)
int dispatch(const Params& p, int dtype, int64_t b, int64_t kvh, cudaStream_t s) {
  const int d = p.d;
  if (dtype == 0) {
    if (d <= 16) return launch_f32<16>(p, b, kvh, s);
    if (d <= 32) return launch_f32<32>(p, b, kvh, s);
    if (d <= 64) return launch_f32<64>(p, b, kvh, s);
    if (d <= 128) return launch_f32<128>(p, b, kvh, s);
    return launch_f32_wide(p, b, kvh, s);
  }
  if (d <= 16) return launch_tc<16>(p, b, kvh, s);
  if (d <= 32) return launch_tc<32>(p, b, kvh, s);
  if (d <= 64) return launch_tc<64>(p, b, kvh, s);
  if (d <= 128) return launch_tc<128>(p, b, kvh, s);
  return launch_tc<256>(p, b, kvh, s);
}

}  // namespace

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// q, o, dout, dq (b, h, sq, d), k, v, dk, dv (b, kvh, sk, d), each given by
// its base pointer and its batch, head and row strides in elements (the
// last stride is 1; float32 rows start on 16-byte boundaries; bf16 base
// pointers and strides are multiples of 16 bytes, strides of dimensions
// longer than 1 nonzero, as TMA reads them); lse and delta (b, h, sq)
// float32, contiguous (delta is scratch the call overwrites). dtype: 0
// float32, 1 bf16 (q, k, v, o, dout and the outputs alike). d: a multiple
// of 8 from 8 to 256. p_round: P of dV = P^T dO in float32 (0), bf16 (1)
// or float16 (2), as the forward rounded it. sq and sk > 0. kv_len: a
// device pointer to an int32, or null to use kv_len_value. window < 0: none. Every element of dq, dk and dv is
// written. Three kernels on `stream`; returns the first launch error (0 on
// success); never synchronizes.
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
    float scale, int p_round, int dtype, void* stream) {
  if (b <= 0 || h <= 0) return 0;
  if (kvh <= 0 || h % kvh != 0 || sq <= 0 || sk <= 0 || sq > 2147483647LL ||
      sk > 2147483647LL || h > 65535 || b > 65535 || window > 2147483647LL || d < 8 ||
      d > 256 || d % 8 != 0 || p_round < 0 || p_round > 2 || dtype < 0 || dtype > 1)
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
  p.d = (int)d;
  p.p_round = p_round;
  return dispatch(p, dtype, b, kvh, (cudaStream_t)stream);
}
