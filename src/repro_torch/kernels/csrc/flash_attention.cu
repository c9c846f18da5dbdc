// Flash attention forward for Hopper (sm_90a): causal GQA online-softmax
// attention with an optional sliding window and a ragged kv length.
//
//   o[b, h, i] = sum_j softmax_j(q[b, h, i] . k[b, h / g, j] * D^-1/2) v[b, h / g, j]
//
// over the columns j that are valid for row i: j < kv_len, j <= i when
// causal (rows counted from 0), j > i - window when a window is given. A
// row with no valid column is 0. bf16 or float32 in, all arithmetic in
// float32, out in the input type.
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
// GFLOP at 989 TFLOP/s bf16, 0.013 ms) are close; the bytes bound it.
// This kernel runs on the SIMT cores in float32 (67 TFLOP/s), so it sits
// far above that bound: it is the simple, exact first version. Tensor
// cores (wgmma), TMA-fed K/V tiles in a shared-memory ring and P in bf16
// are left to a later change.
//
// Design: one block of 256 threads per (64-row query tile, q head, batch).
// Four threads share a query row; each holds a quarter of its q and of its
// output accumulator in registers (float4 chunks c = lane + 4 i, so the
// four lanes read neighbouring 16-byte words of shared memory), and the
// row's running max and sum. The block walks the key tiles its rows need
// -- tiles above the causal diagonal, outside the window or at or past
// kv_len are skipped -- staging each 64-key K and V tile in shared memory
// as float32 (512 * D bytes, dynamic, 64 KB at D = 128). Keys past the end
// of k read as 0 in the load and are masked, so nothing is padded in
// memory. Per 16 keys, each lane forms partial dot products, two
// shuffles give the full scores, and the online-softmax update folds them:
// masked scores are -inf and a step with no valid key changes nothing, so
// a row with no valid column ends with sum 0 and is written as 0.
// Inputs take any strides with a unit last stride, so the model's
// (B, S, H, D) projections are read in place. kv_len is read on the
// device (a 0-d tensor or a value), never on the host.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;                 // query rows per block
constexpr int kKeys = 64;                 // key rows per staged tile
constexpr int kSub = 16;                  // keys per online-softmax step
constexpr int kLanes = 4;                 // threads per query row
constexpr int kThreads = kRows * kLanes;  // 256

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

template <class T>
struct Vec4;

template <>
struct Vec4<float> {
  static __device__ __forceinline__ float4 load(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ void store(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
  }
};

template <>
struct Vec4<__nv_bfloat16> {
  static __device__ __forceinline__ float4 load(const __nv_bfloat16* p) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    __nv_bfloat162 lo, hi;
    *reinterpret_cast<uint32_t*>(&lo) = raw.x;
    *reinterpret_cast<uint32_t*>(&hi) = raw.y;
    const float2 a = __bfloat1622float2(lo);
    const float2 b = __bfloat1622float2(hi);
    return make_float4(a.x, a.y, b.x, b.y);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float4 v) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 raw;
    raw.x = *reinterpret_cast<const uint32_t*>(&lo);
    raw.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = raw;
  }
};

template <class T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_fwd(const Params p) {
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

  const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + hq * p.q_sh;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  T* op = static_cast<T*>(p.o) + b * p.o_sb + hq * p.o_sh;

  int kvl = p.kv_len != nullptr ? *p.kv_len : p.kv_len_value;
  kvl = min(max(kvl, 0), p.sk);

  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 q[CT], acc[CT];
#pragma unroll
  for (int i = 0; i < CT; ++i) {
    q[i] = row < p.sq ? Vec4<T>::load(qp + row * p.q_ss + 4 * (lane + kLanes * i))
                      : zero;
    acc[i] = zero;
  }
  float m = -INFINITY, l = 0.f;

  // key tiles this block's rows can see
  const int row_last = min(q0 + kRows, p.sq) - 1;
  int kt_end = (kvl + kKeys - 1) / kKeys;
  if (p.causal) kt_end = min(kt_end, row_last / kKeys + 1);
  const int kt_begin = p.window >= 0 ? max(0, q0 - p.window + 1) / kKeys : 0;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kKeys;
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < kKeys * C; e += kThreads) {
      const int j = e / C, c = e % C;
      const int key = k0 + j;
      float4 kx = zero, vx = zero;
      if (key < p.sk) {
        kx = Vec4<T>::load(kp + key * p.k_ss + 4 * c);
        vx = Vec4<T>::load(vp + key * p.v_ss + 4 * c);
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
      Vec4<T>::store(op + row * p.o_ss + 4 * (lane + kLanes * i), out);
    }
  }
}

template <class T, int D>
int launch(const Params& p, int64_t b, int64_t h, cudaStream_t stream) {
  const int smem = 2 * kKeys * D * (int)sizeof(float);
  // the opt-in above 48 KB, once per instantiation (so never inside a CUDA
  // graph capture that follows a first call)
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((unsigned)((p.sq + kRows - 1) / kRows), (unsigned)h, (unsigned)b);
  flash_attention_fwd<T, D><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <class T>
int dispatch(const Params& p, int64_t d, int64_t b, int64_t h, cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16>(p, b, h, s);
    case 32: return launch<T, 32>(p, b, h, s);
    case 64: return launch<T, 64>(p, b, h, s);
    case 128: return launch<T, 128>(p, b, h, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// q (b, h, sq, d), k and v (b, kvh, sk, d), o (b, h, sq, d), each given by
// its base pointer and its batch, head and row strides in elements (the
// last stride is 1; rows start on 16-byte boundaries for float32, 8 for
// bf16). dtype: 0 float32, 1 bf16. d: 16, 32, 64 or 128. kv_len: a device
// pointer to an int32, or null to use kv_len_value. window < 0: none.
// Every element of o is written. Returns the launch's cudaError_t (0 on
// success); never synchronizes.
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
  const cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return dispatch<float>(p, d, b, h, s);
    case 1: return dispatch<__nv_bfloat16>(p, d, b, h, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
