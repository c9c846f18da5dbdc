// Flash attention forward for Hopper (sm_90a): causal GQA online-softmax
// attention with an optional sliding window and a ragged kv length.
//
//   o[b, h, i] = sum_j softmax_j(q[b, h, i] . k[b, h / g, j] * D^-1/2) v[b, h / g, j]
//
// over the columns j that are valid for row i: j < kv_len, j <= i when
// causal (rows counted from 0), j > i - window when a window is given. A
// row with no valid column is 0. bf16 or float32 in, out in the input type.
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
// products must run on the tensor cores to come near: on the SIMT cores
// (67 TFLOP/s in float32) the operations alone take 0.19 ms, and the
// float32 kernel below takes 1.11 ms; the bf16 kernel takes 0.097 ms there
// (6.4 x the bound; scaled_dot_product_attention 0.051 ms).
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
// descriptors' (128 B rows at D = 64 and 128, 64 B at 32, 32 B at 16; D =
// 128 is two 64-column panels). P is rounded to bf16 before P.V, a rounding
// point the JAX kernel does not have: each weight moves by at most 2^-9 of
// itself, so an output moves by at most 2^-9 max|v| (2e-2 is the gate).
// Tiles above the diagonal, outside the window or past kv_len are skipped.
// Within one warpgroup the two products and the softmax run one after the
// other; 4 CTAs an SM (94 registers, 41 KB of shared memory at D = 64)
// overlap them. Two consumer warpgroups that ping-pong are left to later.
//
// float32 route (flash_attention_f32): the SIMT kernel, kept because the
// tensor cores would round float32 inputs to TF32 and this route is exact
// to float32 rounding. One block of 256 threads per (64-row query tile, q
// head, batch); four threads share a query row, each holding a quarter of
// its q and output in registers (float4 chunks c = lane + 4 i); 64-key K
// and V tiles are staged in shared memory (512 * D bytes, dynamic) with
// keys past the end of k read as 0 and masked; per 16 keys two shuffles
// complete each score and the online-softmax update folds them.
//
// Both routes read kv_len on the device (a 0-d tensor or a value), never on
// the host, so a CUDA-graph capture holds.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;                 // query rows per block
constexpr int kKeys = 64;                 // key rows per staged tile
constexpr int kSub = 16;                  // f32: keys per online-softmax step
constexpr int kLanes = 4;                 // f32: threads per query row
constexpr int kThreads = kRows * kLanes;  // f32: 256
constexpr int kConsumers = 128;           // bf16: one warpgroup
constexpr int kThreadsTc = kConsumers + 32;  // bf16: plus the producer warp
constexpr int kStages = 2;                // bf16: K / V ring depth

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
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

// ------------------------------------------------------- float32 route
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_f32(const Params p) {
  constexpr int C = D / 4;        // float4 chunks per row
  constexpr int CT = C / kLanes;  // chunks per thread
  extern __shared__ float4 smem[];
  float4* ks = smem;              // [kKeys][C]
  float4* vs = smem + kKeys * C;  // [kKeys][C]

  const int tid = threadIdx.x;
  const int r = tid / kLanes, lane = tid % kLanes;
  // the heaviest causal tiles (the last rows) start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / p.group;
  const int row = q0 + r;

  const float* qp = static_cast<const float*>(p.q) + b * p.q_sb + hq * p.q_sh;
  const float* kp = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vp = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  float* op = static_cast<float*>(p.o) + b * p.o_sb + hq * p.o_sh;

  const int kvl = read_kv_len(p);

  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 q[CT], acc[CT];
#pragma unroll
  for (int i = 0; i < CT; ++i) {
    q[i] = row < p.sq ? load4(qp + row * p.q_ss + 4 * (lane + kLanes * i))
                      : zero;
    acc[i] = zero;
  }
  float m = -INFINITY, l = 0.f;

  int kt_begin, kt_end;
  key_tiles(p, q0, kvl, kt_begin, kt_end);

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kKeys;
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < kKeys * C; e += kThreads) {
      const int j = e / C, c = e % C;
      const int key = k0 + j;
      float4 kx = zero, vx = zero;
      if (key < p.sk) {
        kx = load4(kp + key * p.k_ss + 4 * c);
        vx = load4(vp + key * p.v_ss + 4 * c);
      }
      ks[e] = kx;
      vs[e] = vx;
    }
    __syncthreads();

#pragma unroll 1
    for (int j0 = 0; j0 < kKeys; j0 += kSub) {
      float s[kSub];
      float m_cur = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj) {
        const float4* kr = ks + (j0 + jj) * C + lane;
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < CT; ++i) {
          const float4 kk = kr[kLanes * i];
          dot = fmaf(q[i].x, kk.x, dot);
          dot = fmaf(q[i].y, kk.y, dot);
          dot = fmaf(q[i].z, kk.z, dot);
          dot = fmaf(q[i].w, kk.w, dot);
        }
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        const int col = k0 + j0 + jj;
        bool ok = col < kvl;
        if (p.causal) ok = ok && col <= row;
        if (p.window >= 0) ok = ok && col > row - p.window;
        s[jj] = ok ? dot * p.scale : -INFINITY;
        m_cur = fmaxf(m_cur, s[jj]);
      }
      const float m_new = fmaxf(m, m_cur);
      // no valid key yet: every p below is exp(-inf) = 0 and alpha = 0
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m - m_use);
#pragma unroll
      for (int i = 0; i < CT; ++i) {
        acc[i].x *= alpha;
        acc[i].y *= alpha;
        acc[i].z *= alpha;
        acc[i].w *= alpha;
      }
      float psum = 0.f;
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj) {
        const float pj = expf(s[jj] - m_use);
        psum += pj;
        const float4* vr = vs + (j0 + jj) * C + lane;
#pragma unroll
        for (int i = 0; i < CT; ++i) {
          const float4 vv = vr[kLanes * i];
          acc[i].x = fmaf(pj, vv.x, acc[i].x);
          acc[i].y = fmaf(pj, vv.y, acc[i].y);
          acc[i].z = fmaf(pj, vv.z, acc[i].z);
          acc[i].w = fmaf(pj, vv.w, acc[i].w);
        }
      }
      l = l * alpha + psum;
      m = m_new;
    }
  }

  if (row < p.sq) {
#pragma unroll
    for (int i = 0; i < CT; ++i) {
      float4 out = zero;
      if (l > 0.f) {
        out = make_float4(acc[i].x / l, acc[i].y / l, acc[i].z / l, acc[i].w / l);
      }
      store4(op + row * p.o_ss + 4 * (lane + kLanes * i), out);
    }
  }
}

// ---------------------------------------------------------- bf16 route
// Shared-memory geometry of one 64-row bf16 tile of D columns, as TMA
// writes it with the swizzle whose span is the tile's row (D <= 64), or as
// two 64-column panels of 128-byte rows (D = 128).
template <int D>
struct Tile {
  static constexpr int kPanelCols = D < 64 ? D : 64;
  static constexpr int kRowBytes = kPanelCols * 2;              // 32, 64, 128
  static constexpr int kPanels = D / kPanelCols;                // 1 or 2
  static constexpr int kPanelBytes = kRows * kRowBytes;
  static constexpr int kBytes = kPanels * kPanelBytes;          // 64 x D x 2
  // wgmma descriptor layout type: 1 = 128 B swizzle, 2 = 64 B, 3 = 32 B
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  // Q, then kStages (K, V) pairs, then the barriers; 1 KB of slack lets
  // the base be rounded up to the swizzle's 1,024-byte repeat
  static constexpr int kSmem = (1 + 2 * kStages) * kBytes + 64 + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (each >> 4), swizzle layout in bits 62-63
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (layout << 62);
}

// A K-major operand (Q, or K as B of Q.K^T) at the 16-column step kk: LBO
// unused under a swizzle, SBO = 8 rows.
template <int D>
__device__ __forceinline__ uint64_t desc_k_major(uint32_t base, int kk) {
  using G = Tile<D>;
  const int col = kk * 16;
  const uint32_t addr = base + (col / G::kPanelCols) * G::kPanelBytes +
                        (col % G::kPanelCols) * 2;
  return gmma_desc(addr, 16, 8 * G::kRowBytes, G::kLayout);
}

// V as the MN-major B operand of P.V at the 16-key step kk: LBO = the next
// 64-column panel (D = 128), SBO = 8 keys.
template <int D>
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t base, int kk) {
  using G = Tile<D>;
  return gmma_desc(base + kk * 16 * G::kRowBytes, G::kPanelBytes,
                   8 * G::kRowBytes, G::kLayout);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA box of a 4-D tensor map into shared memory, completing on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// A tensor map's dimensions 1-3 hold (row, head, batch) in the order of
// their strides; axes[i] is the map dimension of row (0), head (1), batch (2).
struct MapAxes {
  int q[3], k[3], v[3];
};

template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         const int (&axes)[3], uint32_t bar,
                                         int row, int head, int batch) {
  using G = Tile<D>;
  int c[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    c[i] = axes[0] == i ? row : axes[1] == i ? head : batch;
#pragma unroll
  for (int panel = 0; panel < G::kPanels; ++panel)
    tma_load(dst + panel * G::kPanelBytes, map, bar, panel * G::kPanelCols, c[0],
             c[1], c[2]);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accumulator reads across the async product
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// S (64 x 64) += Q (64 x 16, shared, K-major) . K^T (16 x 64, shared, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// O (64 x 16) += P (64 x 16, registers) . V (16 x 16, shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4],
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// O (64 x 32) += P (64 x 16, registers) . V (16 x 32, shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4],
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// O (64 x 64) += P (64 x 16, registers) . V (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// O (64 x 128) += P (64 x 16, registers) . V (16 x 128, shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

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

  // normalize and store: rows past sq are not written
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + hq * p.o_sh;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_row[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = r0 + 8 * h;
    if (row >= p.sq) continue;
    const float inv = l > 0.f ? 1.f / l : 0.f;
    __nv_bfloat16* orow = op + row * p.o_ss;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const uint32_t v = pack_bf16(o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
      *reinterpret_cast<uint32_t*>(orow + 8 * j + c_lane) = v;
    }
  }
}

// --------------------------------------------------------------- host
template <int D>
int launch_f32(const Params& p, int64_t b, int64_t h, cudaStream_t stream) {
  const int smem = 2 * kKeys * D * (int)sizeof(float);
  // the opt-in above 48 KB, once per instantiation (so never inside a CUDA
  // graph capture that follows a first call)
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((unsigned)((p.sq + kRows - 1) / kRows), (unsigned)h, (unsigned)b);
  flash_attention_f32<D><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so the
// library links no driver library of its own
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* sym = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &sym, cudaEnableDefault,
                                &status) == cudaSuccess &&
        status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(sym);
  }
  return fn;
}

// The tensor map of a (b, h, s, D) bf16 view with element strides (sb, sh,
// ss) and a unit last stride: dimension 0 is D, dimensions 1-3 are row,
// head and batch sorted by stride (a dimension of size 1 last), boxes of
// (64 or D) columns x 64 rows, zero fill past the edges.
template <int D>
cudaError_t make_map(CUtensorMap* map, int axes[3], const void* ptr, int64_t b,
                     int64_t h, int64_t s, int64_t sb, int64_t sh, int64_t ss) {
  using G = Tile<D>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const int64_t size[3] = {s, h, b}, stride[3] = {ss, sh, sb};
  int order[3] = {0, 1, 2};
  auto key = [&](int i) { return size[i] == 1 ? INT64_MAX : stride[i]; };
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && key(order[j]) < key(order[j - 1]); --j) {
      const int tmp = order[j];
      order[j] = order[j - 1];
      order[j - 1] = tmp;
    }
  cuuint64_t dims[4] = {(cuuint64_t)D, 0, 0, 0};
  cuuint64_t strides[3];
  uint64_t extent = 2 * D;  // bytes spanned so far
  for (int i = 0; i < 3; ++i) {
    const int a = order[i];
    axes[a] = i;
    dims[i + 1] = (cuuint64_t)size[a];
    strides[i] = size[a] == 1 ? extent : (cuuint64_t)stride[a] * 2;
    if (strides[i] % 16 != 0) return cudaErrorInvalidValue;
    const uint64_t span = (uint64_t)strides[i] * (uint64_t)size[a];
    if (span > extent) extent = span;
  }
  cuuint32_t box[4] = {(cuuint32_t)G::kPanelCols, 1, 1, 1};
  box[1 + axes[0]] = (cuuint32_t)kRows;  // 64 rows, one head, one batch
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = G::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                   : G::kRowBytes == 64  ? CU_TENSOR_MAP_SWIZZLE_64B
                                                         : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
int launch_bf16(const Params& p, int64_t b, int64_t h, int64_t kvh,
                cudaStream_t stream) {
  using G = Tile<D>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  alignas(64) CUtensorMap mq, mk, mv;
  MapAxes axes;
  cudaError_t err;
  if ((err = make_map<D>(&mq, axes.q, p.q, b, h, p.sq, p.q_sb, p.q_sh, p.q_ss)) != cudaSuccess ||
      (err = make_map<D>(&mk, axes.k, p.k, b, kvh, p.sk, p.k_sb, p.k_sh, p.k_ss)) != cudaSuccess ||
      (err = make_map<D>(&mv, axes.v, p.v, b, kvh, p.sk, p.v_sb, p.v_sh, p.v_ss)) != cudaSuccess)
    return (int)err;
  const dim3 grid((unsigned)((p.sq + kRows - 1) / kRows), (unsigned)h, (unsigned)b);
  flash_attention_bf16<D><<<grid, kThreadsTc, G::kSmem, stream>>>(p, mq, mk, mv, axes);
  return (int)cudaGetLastError();
}

int dispatch(const Params& p, int dtype, int64_t d, int64_t b, int64_t h, int64_t kvh,
             cudaStream_t s) {
  if (dtype == 0) {
    switch (d) {
      case 16: return launch_f32<16>(p, b, h, s);
      case 32: return launch_f32<32>(p, b, h, s);
      case 64: return launch_f32<64>(p, b, h, s);
      case 128: return launch_f32<128>(p, b, h, s);
    }
  } else if (dtype == 1) {
    switch (d) {
      case 16: return launch_bf16<16>(p, b, h, kvh, s);
      case 32: return launch_bf16<32>(p, b, h, kvh, s);
      case 64: return launch_bf16<64>(p, b, h, kvh, s);
      case 128: return launch_bf16<128>(p, b, h, kvh, s);
    }
  }
  return (int)cudaErrorInvalidValue;
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
// 16, 32, 64 or 128. kv_len: a device pointer to an int32, or null to use
// kv_len_value. window < 0: none. Every element of o is written. Returns
// the launch's cudaError_t (0 on success); never synchronizes.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o,
    int64_t b, int64_t h, int64_t kvh, int64_t sq, int64_t sk, int64_t d,
    int64_t q_sb, int64_t q_sh, int64_t q_ss,
    int64_t k_sb, int64_t k_sh, int64_t k_ss,
    int64_t v_sb, int64_t v_sh, int64_t v_ss,
    int64_t o_sb, int64_t o_sh, int64_t o_ss,
    const void* kv_len, int64_t kv_len_value, int causal, int64_t window,
    float scale, int dtype, void* stream) {
  if (b <= 0 || h <= 0 || sq <= 0) return 0;
  if (kvh <= 0 || h % kvh != 0 || sq > 2147483647LL || sk > 2147483647LL ||
      h > 65535 || b > 65535 || window > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
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
  return dispatch(p, dtype, d, b, h, kvh, (cudaStream_t)stream);
}
