// Flash attention forward for Hopper (sm_90a): causal GQA online-softmax
// attention with an optional sliding window and a ragged kv length.
//
//   o[b, h, i] = sum_j softmax_j(q[b, h, i] . k[b, h / g, j] * D^-1/2) v[b, h / g, j]
//
// over the columns j that are valid for row i: j < kv_len, j <= i when
// causal (rows counted from 0), j > i - window when a window is given. A
// row with no valid column is 0. bf16 or float32 in, out in the input type.
//
// Head dims: any d with 8 <= d <= 256 and d % 8 == 0. The kernels are
// instantiated at D = 16, 32, 64, 128 and 256, and d runs on the smallest
// D >= d: columns d..D-1 of q, k and v read as zeros (TMA's out-of-bounds
// fill on the bf16 route, whose maps have inner extent d; a masked
// cp.async / load on the float32 route) and are never stored; the score
// scale stays d^-1/2 (Params::scale). d = 96 therefore does the work of 128
// (4/3 the operations, the bytes of d). At D = 256 the bf16 route keeps
// 128 accumulators a thread and 160 KB of tiles (Q and two K / V stages);
// the float32 route reads Q's fragments from device memory where they are
// used, runs one K / V stage (two would need 272 KB) and sums P.V output
// group by output group.
//
// attn_p_dtype (Params::p_round): the float32 route rounds P to bf16 or
// float16 before P.V, as the JAX package's chunked attention casts it, while
// the row sum keeps P unrounded (one uniform branch a tile, skipped for
// float32). The bf16 route rounds P to bf16 whatever p_round says: float16
// keeps 11 bits, so bf16's 8 bound it (2^-8 of each weight).
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py,
// flash_attention_pallas (def at :90, pallas_call at :121). The TPU kernel
// pads q, k and v to 128-row blocks in memory and walks a (b, h, q-block,
// kv-block) grid whose innermost kv axis carries the running (max, sum,
// accumulator) in VMEM scratch, scores and P.V on the MXU.
//
// Bound on an H100 SXM: at the serving path's prefill (8 x 12 heads x 1,024
// rows x 64, bf16, causal) the bytes (q, k, v read once, o written once:
// 50.3 MB at 3.35 TB/s, 0.015 ms) and the tensor-core operations (12.9
// GFLOP at 989 TFLOP/s bf16, 0.013 ms) are close; the bytes bound it. The
// bf16 kernel takes 0.097 ms there (6.4 x the bound;
// scaled_dot_product_attention 0.051 ms). In float32 the bytes double
// (100.6 MB, 0.030 ms) and the products run as three TF32 products each:
// 3 x 12.9 GFLOP at 495 TFLOP/s is 0.078 ms, the float32 route's bound
// (on the SIMT cores, at 67 TFLOP/s, the operations alone took 0.19 ms).
//
// bf16 route (flash_attention_bf16): the products on wgmma. One CTA of 160
// threads per (64-row query tile, q head, batch), the heaviest causal tiles
// first. Warp 4 is the producer: one lane loads the Q tile once and streams
// 64-key K and V tiles with TMA into a ring of kStages stages in shared
// memory, each stage behind a "full" and an "empty" mbarrier. TMA reads
// the (B, S, H, D) strides of any view in place through a 4-D tensor map
// and zero-fills rows past S, so ragged tails need no masked loads.
// Warps 0-3 are one consumer warpgroup:
//   S = Q.K^T   wgmma m64n64k16, A and B from shared memory (K-major),
//               float32 accumulators in registers;
//   softmax     on the accumulator fragment: each thread owns 2 rows and
//               16 columns of S, so a row's max and sum take two shuffles
//               (xor 1, 2); masked scores are -inf, and the -inf guard of
//               the float32 route keeps a row with no valid column at 0;
//   O += P.V    wgmma m64nDk16 with P from registers (the S fragment packed
//               to bf16 is the A fragment) and V's (keys, D) tile as an
//               MN-major B operand (the transpose bit, 16-bit types only).
// Tiles are stored with the TMA swizzle that matches the wgmma
// descriptors' (128 B rows at D = 64, 128 and 256, 64 B at 32, 32 B at 16;
// D = 128 is two 64-column panels, D = 256 four). P is rounded to bf16
// before P.V, a rounding point the JAX kernel does not have: bf16 keeps 8
// significant bits, so rounding to nearest moves each weight by at most
// 2^-8 of itself and an output by at most 2^-8 max|v| (2e-2 is the gate).
// Tiles above the diagonal, outside the window or past kv_len are skipped.
// Within one warpgroup the two products and the softmax run one after the
// other; 4 CTAs an SM (94 registers, 41 KB of shared memory at D = 64)
// overlap them. Two consumer warpgroups that ping-pong are left to later.
//
// float32 route (flash_attention_f32): the products on mma.sync as 3xTF32.
// Each float32 operand x is split into big = tf32(x) and small = tf32(x -
// big), both rounded to nearest with ties away (cvt.rna's rounding, done
// with two integer operations), and a product is big.big + big.small +
// small.big (small terms first, float32 accumulators); only small.small
// (2^-22 of the product) and the rounding of small are dropped, so each
// product is within 2^-20 of itself and an output within ~2^-20 sum_j p_j
// |v_j| of the float32 result (PERF.md section 2). One CTA of 4 warps per
// (64-row query tile, q head, batch), the heaviest causal tiles first;
// each warp owns 16 query rows. Q's A fragments are loaded once into
// registers and split there (split again per use at D = 128, for
// registers). 64-key K and V tiles come through a 2-stage cp.async ring in
// shared memory, with row strides that keep the B fragments' reads on 32
// banks; K and V are split as their fragments are read, K 16 bytes a read
// (the dims of S's k-steps are permuted so a thread's K fragment for two
// steps is 4 consecutive floats). S = Q.K^T on m16n8k8 tiles; the softmax
// runs on the S accumulators, each thread holding 2 rows x 16 keys, a
// row's max and sum over a quad by two shuffles, each exp2 taken once. The
// S accumulators are P.V's A fragment as they lie: the k index of each
// 8-key step is permuted (k = t holds key 2t, k = t + 4 key 2t + 1) and
// V's B fragment reads the same keys, so P needs no shuffle and no
// shared-memory pass; P is split like any operand. Each tile's P.V goes to
// fresh accumulators and is added to the running O in float32, since the
// tensor cores' accumulation does not round to nearest. The three products
// of a group share their A operand and run as three passes over the group
// so that consecutive mma.sync are independent. wgmma takes tf32 only
// K-major, and V's (keys, D) tile is MN-major for P.V, so this route stays
// on mma.sync.
//
// Both routes read kv_len on the device (a 0-d tensor or a value), never on
// the host, so a CUDA-graph capture holds.
//
// Training asks for the log-sum-exp of every row as well (lse non-null):
// each route's epilogue stores lse = m + log(l), in natural-log units of the
// scaled score s = q.k D^-1/2 (the routes keep m in log2 units and convert),
// -inf for a row with no valid column. The backward
// (kernels/csrc/flash_attention_bwd.cu) recomputes P = exp(s - lse) from it.
// With lse null (serving) the kernels store nothing more.
//
// The wgmma / TMA / mbarrier / 3xTF32 building blocks live in hopper.cuh,
// shared with the backward.
#include <math.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kRows = 64;                 // query rows per block
constexpr int kKeys = 64;                 // key rows per staged tile
constexpr int kThreadsF32 = 128;          // f32: 4 warps, 16 query rows each
constexpr int kF32Stages = 2;             // f32: K / V ring depth
constexpr int kConsumers = 128;           // bf16: one warpgroup
constexpr int kThreadsTc = kConsumers + 32;  // bf16: plus the producer warp
constexpr int kStages = 2;                // bf16: K / V ring depth

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;                // (b, h, sq) float32, contiguous; null: not stored
  int64_t q_sb, q_sh, q_ss;  // strides in elements: batch, head, row
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;
  int sq, sk, group;         // group = q heads per kv head
  const int* kv_len;         // device scalar, or null: kv_len_value
  int kv_len_value;
  int causal;
  int window;                // < 0: no window
  float scale;
  int d;                     // head dim read and written, 8 <= d <= D, d % 8 == 0
  int p_round;               // P before P.V: 0 float32, 1 bf16, 2 float16 (round_p)
};

// The key tiles [begin, end) that rows [q0, q0 + kRows) can see.
__device__ __forceinline__ void key_tiles(const Params& p, int q0, int kvl,
                                          int& begin, int& end) {
  const int row_last = min(q0 + kRows, p.sq) - 1;
  end = (kvl + kKeys - 1) / kKeys;
  if (p.causal) end = min(end, row_last / kKeys + 1);
  begin = p.window >= 0 ? max(0, q0 - p.window + 1) / kKeys : 0;
}

__device__ __forceinline__ int read_kv_len(const Params& p) {
  const int kvl = p.kv_len != nullptr ? *p.kv_len : p.kv_len_value;
  return min(max(kvl, 0), p.sk);
}

// Row `row` of (batch b, q head hq)'s log-sum-exp from the row's running
// max m (log2 units of the scaled score) and its sum l.
__device__ __forceinline__ void store_lse(const Params& p, int b, int hq, int row,
                                          float m, float l) {
  if (p.lse == nullptr) return;
  p.lse[((int64_t)b * gridDim.y + hq) * p.sq + row] =
      l > 0.f ? (m + log2f(l)) * 0.6931471805599453f : -INFINITY;
}

// ------------------------------------------------------- float32 route
// Q's A-fragment element e of k-step kk from the thread's float4s (see
// the permuted dims in flash_attention_f32); kk and e are constants once
// unrolled
template <int P>
__device__ __forceinline__ float q_elem(const float4 (&qr)[P][2], int kk, int e) {
  const float4 v = qr[kk >> 1][e & 1];
  const int c = 2 * (kk & 1) + (e >> 1);
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// Shared-memory geometry of the float32 route: kF32Stages (K, V) pairs of
// 64 keys. A K row is read 16 bytes at a time (4 dims a thread, 8 threads
// a phase over 2 keys), so its stride is 16 mod 32 floats; a V row is read
// one float at a time (8 columns x 4 key pairs a warp), so its stride is 4
// mod 32. Either way the B fragments' reads hit every bank once.
// At D = 256 two stages (272 KB) exceed a block's shared memory: one
// stage, loaded and then read.
template <int D>
struct TileF32 {
  static constexpr int kLdK = D % 32 == 16 ? D : D + 16;
  static constexpr int kLdV = D + 4;
  static constexpr int kStages = D <= 128 ? kF32Stages : 1;
  static constexpr int kStage = kKeys * (kLdK + kLdV);   // floats
  static constexpr int kSmem = kStages * kStage * (int)sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(kThreadsF32, D <= 64 ? 2 : 1)
flash_attention_f32(const Params p) {
  using G = TileF32<D>;
  constexpr int KS = D / 8;               // k-steps of S = Q.K^T
  constexpr int C = D / 4;                // 16-byte chunks a row
  constexpr bool kQSplit = D <= 64;       // Q held split (else split per use)
  constexpr bool kQRegs = D <= 128;       // Q held in registers (else read per use)
  constexpr int NJ = 4;                   // key groups (of 8) a pass of S
  constexpr int NO = D / 8 < 4 ? D / 8 : 4;  // output groups (of 8) a pass of P.V
  extern __shared__ float4 smem_f4[];
  float* const smem = reinterpret_cast<float*>(smem_f4);  // [stage][K | V]
  const uint32_t smem_base = smem_u32(smem);

  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;  // the mma fragments' group / thread
  // the heaviest causal tiles (the last rows) start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / p.group;
  const int r0 = q0 + 16 * w + gq;          // this thread's rows: r0, r0 + 8

  const float* qp = static_cast<const float*>(p.q) + b * p.q_sb + hq * p.q_sh;
  const float* kp = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vp = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  float* op = static_cast<float*>(p.o) + b * p.o_sb + hq * p.o_sh;

  const int kvl = read_kv_len(p);
  int kt_begin, kt_end;
  key_tiles(p, q0, kvl, kt_begin, kt_end);

  // one 64-key K and V tile into stage st, 16 bytes a copy
  auto load_tile = [&](int kt, int st) {
    const int k0 = kt * kKeys;
    const uint32_t ks = smem_base + (uint32_t)(st * G::kStage * sizeof(float));
    const uint32_t vs = ks + (uint32_t)(kKeys * G::kLdK * sizeof(float));
    for (int e = tid; e < kKeys * C; e += kThreadsF32) {
      const int j = e / C, c = e % C;
      const int key = k0 + j;
      const bool ok = key < p.sk && 4 * c < p.d;  // columns d..D-1 read as 0
      cp_async16(ks + (uint32_t)((j * G::kLdK + 4 * c) * sizeof(float)),
                 ok ? kp + (int64_t)key * p.k_ss + 4 * c : kp, ok);
      cp_async16(vs + (uint32_t)((j * G::kLdV + 4 * c) * sizeof(float)),
                 ok ? vp + (int64_t)key * p.v_ss + 4 * c : vp, ok);
    }
  };
  if (G::kStages > 1 && kt_begin < kt_end) load_tile(kt_begin, 0);
  cp_async_commit();

  // The dims of S's k-steps are permuted so that a thread's K fragment for
  // two k-steps is 4 consecutive floats: in each 16 dims 16 pp .. +15, k =
  // tq (+ 4) of step 2 pp + h holds dim 16 pp + 4 tq + 2 h (+ 1). Q's A
  // fragment follows: [kk][0] row r0, [1] row r0 + 8 at k = tq, [2] and
  // [3] the same rows at k = tq + 4. Rows past sq and columns past d are
  // 0. At D = 256 the 128 registers of Q would spill: its 16 dims of a
  // pass are read from device memory (through L1) where they are used.
  auto q_chunk = [&](int pp, int h) {
    const int row = r0 + 8 * h, col = 16 * pp + 4 * tq;
    return row < p.sq && col < p.d
               ? *reinterpret_cast<const float4*>(qp + (int64_t)row * p.q_ss + col)
               : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  float4 qr[kQRegs ? D / 16 : 1][2];
  if constexpr (kQRegs) {
#pragma unroll
    for (int pp = 0; pp < D / 16; ++pp)
#pragma unroll
      for (int h = 0; h < 2; ++h) qr[pp][h] = q_chunk(pp, h);
  }
  uint32_t qb[kQSplit ? KS : 1][4], qs[kQSplit ? KS : 1][4];
  if constexpr (kQSplit) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(q_elem(qr, kk, e), qb[kk][e], qs[kk][e]);
  }

  const float scale_log2 = p.scale * 1.4426950408889634f;
  float o[D / 8][4];
#pragma unroll
  for (int jn = 0; jn < D / 8; ++jn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[jn][e] = 0.f;
  float m_row[2] = {-INFINITY, -INFINITY}, l_row[2] = {0.f, 0.f};

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    int st = 0;
    if constexpr (G::kStages > 1) {
      st = (kt - kt_begin) & 1;
      if (kt + 1 < kt_end) load_tile(kt + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait_prev();  // tile kt has landed
    } else {
      load_tile(kt, 0);
      cp_async_commit();
      cp_async_wait_all();
    }
    __syncthreads();
    const float* ks = smem + st * G::kStage;
    const float* vs = ks + kKeys * G::kLdK;
    const int k0 = kt * kKeys;

    // S = Q . K^T: s[j] is keys k0 + 8 j .. + 7; s[j][e] is row r0 + 8 (e >> 1),
    // key k0 + 8 j + 2 tq + (e & 1)
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int jg = 0; jg < 8; jg += NJ) {
#pragma unroll
      for (int pp = 0; pp < D / 16; ++pp) {
        float4 qv[2];   // rows r0, r0 + 8 of dims 16 pp + 4 tq .. + 3 (D = 256)
        if constexpr (!kQRegs) {
          qv[0] = q_chunk(pp, 0);
          qv[1] = q_chunk(pp, 1);
        }
        float4 kv[NJ];  // K[key 8 j + gq][16 pp + 4 tq .. + 3]
#pragma unroll
        for (int i = 0; i < NJ; ++i)
          kv[i] = *reinterpret_cast<const float4*>(ks + (8 * (jg + i) + gq) * G::kLdK +
                                                   16 * pp + 4 * tq);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int kk = 2 * pp + h;
          uint32_t ab[4], as[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if constexpr (kQSplit) {
              ab[e] = qb[kk][e];
              as[e] = qs[kk][e];
            } else if constexpr (kQRegs) {
              split_tf32(q_elem(qr, kk, e), ab[e], as[e]);
            } else {
              const float4 v = qv[e & 1];
              const int c = 2 * h + (e >> 1);
              split_tf32(c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w, ab[e], as[e]);
            }
          }
          uint32_t bb[NJ][2], bs[NJ][2];
#pragma unroll
          for (int i = 0; i < NJ; ++i) {
            split_tf32(h ? kv[i].z : kv[i].x, bb[i][0], bs[i][0]);
            split_tf32(h ? kv[i].w : kv[i].y, bb[i][1], bs[i][1]);
          }
          mma_3xtf32<NJ>(s, jg, ab, as, bb, bs);
        }
      }
    }

    // mask, in log2 units
    const bool full_tile = k0 + kKeys <= kvl &&
                           (!p.causal || k0 + kKeys - 1 <= q0) &&
                           (p.window < 0 || k0 > q0 + kRows - 1 - p.window);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + 8 * (e >> 1);
        const int col = k0 + 8 * j + 2 * tq + (e & 1);
        bool ok = full_tile || col < kvl;
        if (!full_tile && p.causal) ok = ok && col <= row;
        if (!full_tile && p.window >= 0) ok = ok && col > row - p.window;
        s[j][e] = ok ? s[j][e] * scale_log2 : -INFINITY;
      }
    }

    // online softmax on the fragment: a row's 64 scores lie on the 4
    // threads of a quad, 16 each; each exp2 is taken once
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_row[h], mx);
      // no valid key yet: every p below is exp2(-inf) = 0 and alpha = 0
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      alpha[h] = exp2f(m_row[h] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pj = exp2f(s[j][2 * h + e] - m_use);
          s[j][2 * h + e] = pj;
          sum += pj;
        }
      }
      l_row[h] = l_row[h] * alpha[h] + sum;  // this thread's columns only
      m_row[h] = m_new;
    }
    if (p.p_round != 0) {   // attn_p_dtype: P.V takes P rounded, the sum did not
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = round_p(s[j][e], p.p_round);
    }

    // P . V of this tile, 8 keys a k-step, into accumulators of its own:
    // the tensor cores' float32 sums are not rounded to nearest, and in one
    // accumulator across all tiles their error grows with the tile count,
    // so the running O takes each tile's sum by an ordinary add. The k index of
    // the A fragment is permuted so that the S accumulators are the A
    // fragment as they lie:
    // k = tq holds key 2 tq, k = tq + 4 holds key 2 tq + 1, and V's B
    // fragment reads the same keys (b[0] = V[key 2 tq][n], b[1] = V[2 tq + 1][n]).
    // At D = 256 a tile's whole sum would take another 128 registers: the
    // output groups go outermost, each summed over the 8 key steps into 16
    // registers (the same products in the same order, so the same bits).
    if constexpr (D > 128) {
#pragma unroll
      for (int ng = 0; ng < D / 8; ng += NO) {
        float ot[NO][4];
#pragma unroll
        for (int i = 0; i < NO; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) ot[i][e] = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          uint32_t ab[4], as[4];
          split_tf32(s[j][0], ab[0], as[0]);
          split_tf32(s[j][2], ab[1], as[1]);
          split_tf32(s[j][1], ab[2], as[2]);
          split_tf32(s[j][3], ab[3], as[3]);
          const float* vr = vs + (8 * j + 2 * tq) * G::kLdV + gq;
          uint32_t bb[NO][2], bs[NO][2];
#pragma unroll
          for (int i = 0; i < NO; ++i) {
            split_tf32(vr[8 * (ng + i)], bb[i][0], bs[i][0]);
            split_tf32(vr[G::kLdV + 8 * (ng + i)], bb[i][1], bs[i][1]);
          }
          mma_3xtf32<NO>(ot, 0, ab, as, bb, bs);
        }
#pragma unroll
        for (int i = 0; i < NO; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o[ng + i][e] = o[ng + i][e] * alpha[e >> 1] + ot[i][e];
      }
    } else {
      float ot[D / 8][4];
#pragma unroll
      for (int jn = 0; jn < D / 8; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) ot[jn][e] = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t ab[4], as[4];
        split_tf32(s[j][0], ab[0], as[0]);   // row r0,     key 2 tq
        split_tf32(s[j][2], ab[1], as[1]);   // row r0 + 8, key 2 tq
        split_tf32(s[j][1], ab[2], as[2]);   // row r0,     key 2 tq + 1
        split_tf32(s[j][3], ab[3], as[3]);   // row r0 + 8, key 2 tq + 1
        const float* vr = vs + (8 * j + 2 * tq) * G::kLdV + gq;
#pragma unroll
        for (int ng = 0; ng < D / 8; ng += NO) {
          uint32_t bb[NO][2], bs[NO][2];
#pragma unroll
          for (int i = 0; i < NO; ++i) {
            split_tf32(vr[8 * (ng + i)], bb[i][0], bs[i][0]);
            split_tf32(vr[G::kLdV + 8 * (ng + i)], bb[i][1], bs[i][1]);
          }
          mma_3xtf32<NO>(ot, ng, ab, as, bb, bs);
        }
      }
#pragma unroll
      for (int jn = 0; jn < D / 8; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[jn][e] = o[jn][e] * alpha[e >> 1] + ot[jn][e];
    }
    __syncthreads();  // stage st is read; the next prefetch may overwrite it
  }

  // normalize and store: o[jn][e] is row r0 + 8 (e >> 1), column 8 jn +
  // 2 tq + (e & 1); rows past sq and columns past d are not written
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_row[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = r0 + 8 * h;
    if (row >= p.sq) continue;
    if (tq == 0) store_lse(p, b, hq, row, m_row[h], l);
    float* orow = op + (int64_t)row * p.o_ss;
#pragma unroll
    for (int jn = 0; jn < D / 8; ++jn) {
      float2 out = make_float2(0.f, 0.f);
      if (l > 0.f) out = make_float2(o[jn][2 * h] / l, o[jn][2 * h + 1] / l);
      if (8 * jn < p.d) *reinterpret_cast<float2*>(orow + 8 * jn + 2 * tq) = out;
    }
  }
}

// ---------------------------------------------------------- bf16 route
// Q, then kStages (K, V) pairs, then the barriers; 1 KB of slack lets the
// base be rounded up to the swizzle's 1,024-byte repeat
template <int D>
constexpr int kSmemTc = (1 + 2 * kStages) * Tile<D>::kBytes + 64 + 1024;

// A tensor map's dimensions 1-3 hold (row, head, batch) in the order of
// their strides; axes[i] is the map dimension of row (0), head (1), batch (2).
struct MapAxes {
  int q[3], k[3], v[3];
};

template <int D>
__global__ void __launch_bounds__(kThreadsTc)
flash_attention_bf16(const __grid_constant__ Params p,
                     const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const __grid_constant__ MapAxes axes) {
  using G = Tile<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t s_q = base;
  const uint32_t s_k = base + G::kBytes;                    // stage s: + 2 s kBytes
  const uint32_t s_v = s_k + G::kBytes;
  const uint32_t bars = base + (1 + 2 * kStages) * G::kBytes;
  const uint32_t bar_q = bars;                              // 8 bytes each
  const uint32_t bar_full = bars + 8;                       // [kStages]
  const uint32_t bar_empty = bars + 8 + 8 * kStages;        // [kStages]

  // the heaviest causal tiles (the last rows) start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
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
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(bar_q, G::kBytes);
      tma_tile<D>(s_q, &map_q, axes.q, bar_q, q0, hq, b);
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
  const int c_lane = 2 * (lane & 3);         // its first column in each 8
  const float scale_log2 = p.scale * 1.4426950408889634f;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_row[2] = {-INFINITY, -INFINITY}, l_row[2] = {0.f, 0.f};

  mbar_wait(bar_q, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kKeys;
    mbar_wait(bar_full + 8 * stage, phase);
    const uint32_t k_tile = s_k + 2 * stage * G::kBytes;
    const uint32_t v_tile = s_v + 2 * stage * G::kBytes;

    // S = Q . K^T on the tensor cores
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, desc_k_major<D>(s_q, kk), desc_k_major<D>(k_tile, kk), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // mask: s[4 j + e] is row r0 + 8 (e >> 1), column k0 + 8 j + c_lane + (e & 1)
    const bool full_tile = k0 + kKeys <= kvl &&
                           (!p.causal || k0 + kKeys - 1 <= q0) &&
                           (p.window < 0 || k0 > q0 + kRows - 1 - p.window);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + 8 * (e >> 1);
        const int col = k0 + 8 * j + c_lane + (e & 1);
        bool ok = full_tile || col < kvl;
        if (!full_tile && p.causal) ok = ok && col <= row;
        if (!full_tile && p.window >= 0) ok = ok && col > row - p.window;
        s[4 * j + e] = ok ? s[4 * j + e] * scale_log2 : -INFINITY;
      }
    }

    // online softmax on the fragment, in log2 units
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_row[h], mx);
      // no valid key yet: every p below is exp2(-inf) = 0 and alpha = 0
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      alpha[h] = exp2f(m_row[h] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pj = exp2f(s[4 * j + 2 * h + e] - m_use);
          s[4 * j + 2 * h + e] = pj;
          sum += pj;
        }
      }
      l_row[h] = l_row[h] * alpha[h] + sum;   // this thread's columns only
      m_row[h] = m_new;
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j + 0] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }

    // O += P . V: the S fragment of keys 16 kk .. 16 kk + 15, packed to
    // bf16, is the A fragment of the 16-key step kk
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      a[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      a[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      a[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      a[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(o, a[kk], desc_mn_major<D>(v_tile, kk), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    mbar_arrive(bar_empty + 8 * stage);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }

  // normalize and store: rows past sq and columns past d are not written
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + hq * p.o_sh;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_row[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = r0 + 8 * h;
    if (row >= p.sq) continue;
    if ((lane & 3) == 0) store_lse(p, b, hq, row, m_row[h], l);
    const float inv = l > 0.f ? 1.f / l : 0.f;
    __nv_bfloat16* orow = op + row * p.o_ss;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const uint32_t v = pack_bf16(o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
      if (8 * j < p.d) *reinterpret_cast<uint32_t*>(orow + 8 * j + c_lane) = v;
    }
  }
}

// --------------------------------------------------------------- host
template <int D>
int launch_f32(const Params& p, int64_t b, int64_t h, cudaStream_t stream) {
  using G = TileF32<D>;
  // the opt-in above 48 KB, once per instantiation (so never inside a CUDA
  // graph capture that follows a first call)
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((unsigned)((p.sq + kRows - 1) / kRows), (unsigned)h, (unsigned)b);
  flash_attention_f32<D><<<grid, kThreadsF32, G::kSmem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bf16(const Params& p, int64_t b, int64_t h, int64_t kvh,
                cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemTc<D>);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  alignas(64) CUtensorMap mq, mk, mv;
  MapAxes axes;
  cudaError_t err;
  if ((err = make_map<D>(&mq, axes.q, p.q, b, h, p.sq, p.q_sb, p.q_sh, p.q_ss, p.d)) !=
          cudaSuccess ||
      (err = make_map<D>(&mk, axes.k, p.k, b, kvh, p.sk, p.k_sb, p.k_sh, p.k_ss, p.d)) !=
          cudaSuccess ||
      (err = make_map<D>(&mv, axes.v, p.v, b, kvh, p.sk, p.v_sb, p.v_sh, p.v_ss, p.d)) !=
          cudaSuccess)
    return (int)err;
  const dim3 grid((unsigned)((p.sq + kRows - 1) / kRows), (unsigned)h, (unsigned)b);
  flash_attention_bf16<D><<<grid, kThreadsTc, kSmemTc<D>, stream>>>(p, mq, mk, mv, axes);
  return (int)cudaGetLastError();
}

// d runs on the smallest instantiation D >= d (16, 32, 64, 128, 256)
int dispatch(const Params& p, int dtype, int64_t b, int64_t h, int64_t kvh, cudaStream_t s) {
  const int d = p.d;
  if (dtype == 0) {
    if (d <= 16) return launch_f32<16>(p, b, h, s);
    if (d <= 32) return launch_f32<32>(p, b, h, s);
    if (d <= 64) return launch_f32<64>(p, b, h, s);
    if (d <= 128) return launch_f32<128>(p, b, h, s);
    return launch_f32<256>(p, b, h, s);
  }
  if (d <= 16) return launch_bf16<16>(p, b, h, kvh, s);
  if (d <= 32) return launch_bf16<32>(p, b, h, kvh, s);
  if (d <= 64) return launch_bf16<64>(p, b, h, kvh, s);
  if (d <= 128) return launch_bf16<128>(p, b, h, kvh, s);
  return launch_bf16<256>(p, b, h, kvh, s);
}

}  // namespace

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// q (b, h, sq, d), k and v (b, kvh, sk, d), o (b, h, sq, d), each given by
// its base pointer and its batch, head and row strides in elements (the
// last stride is 1; float32 rows start on 16-byte boundaries; bf16 base
// pointers and strides are multiples of 16 bytes, strides of dimensions
// longer than 1 nonzero, as TMA reads them). dtype: 0 float32, 1 bf16. d:
// a multiple of 8 from 8 to 256. p_round: P before P.V in float32 (0), bf16
// (1) or float16 (2). kv_len: a device pointer to an int32, or null to use
// kv_len_value. window < 0: none. Every element of o is written, and of lse
// ((b, h, sq) float32, contiguous) when it is not null. Returns
// the launch's cudaError_t (0 on success); never synchronizes.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int64_t b, int64_t h, int64_t kvh, int64_t sq, int64_t sk, int64_t d,
    int64_t q_sb, int64_t q_sh, int64_t q_ss,
    int64_t k_sb, int64_t k_sh, int64_t k_ss,
    int64_t v_sb, int64_t v_sh, int64_t v_ss,
    int64_t o_sb, int64_t o_sh, int64_t o_ss,
    const void* kv_len, int64_t kv_len_value, int causal, int64_t window,
    float scale, int p_round, int dtype, void* stream) {
  if (b <= 0 || h <= 0 || sq <= 0) return 0;
  if (kvh <= 0 || h % kvh != 0 || sq > 2147483647LL || sk > 2147483647LL ||
      h > 65535 || b > 65535 || window > 2147483647LL || d < 8 || d > 256 || d % 8 != 0 ||
      p_round < 0 || p_round > 2 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.lse = static_cast<float*>(lse);
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
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
  return dispatch(p, dtype, b, h, kvh, (cudaStream_t)stream);
}
