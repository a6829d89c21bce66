// Flash attention forward (online softmax, blockwise) for Hopper.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/flash_attention.py
// _fwd_kernel (reached from _flash_fwd / flash_attention_bshd).  Same
// function: per (batch*head) row block, s = q.k^T / sqrt(D) + bias, causal
// entries set to -1e30, a running max m and sum l of exp(s - m), float32
// accumulation of p.v, o = acc / max(l, 1e-30) and lse = m + log(l) (+inf
// on rows whose l is 0).  In bf16 mode p is rounded to bf16 before the p.v
// product, as the TPU kernel does with p.astype(v.dtype).
//
// Bound on an H100: at the served shapes (D = 64, S = 128..512) the
// 4*BH*Sq*Sk*D FLOPs dominate the bytes.  This version runs them on the
// float32 FMA pipes (67 TFLOP/s peak), not the tensor cores; the limit in
// practice is how many FMAs each shared-memory load feeds.  wgmma/TMA come
// later.
//
// Design: one block of 256 threads per (64-row query tile, batch*head);
// the Q tile and each 64-key K/V tile are staged in shared memory (float32,
// bf16 widened on load).  Both products are register-tiled: thread (ty, tx)
// of a 16 x 16 grid owns query rows ty + 16i and keys tx + 16j (i, j < 4)
// of the score tile, so one pass over D costs 8 float4 loads for 64 FMAs,
// and rows ty + 16i by head dims 64c + 4tx .. +3 of the output, fed by one
// broadcast p load per row and one float4 of V.  The strides (rows D + 4
// floats apart, P rows 80 apart) keep every warp's shared-memory accesses
// free of bank conflicts.  A row's 64 scores live in the 16 threads of one
// half-warp: the tile max is a 4-step shuffle, and each thread keeps its
// own share of the softmax sum, added up once at the end.  Causal tiles
// above the diagonal are never loaded (block skipping); keys past Sk and
// rows past Sq are masked, so any lengths work.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kBlockM = 64;        // query rows per thread block
constexpr int kBlockN = 64;        // keys per K/V tile
constexpr int kThreads = 256;      // a 16 x 16 grid of threads
constexpr int kPStride = kBlockN + 16;
constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF

template <int D>
struct Tile {
  static constexpr int kStride = D + 4;   // Q/K rows: 4 banks apart
  static constexpr int kChunks = D / 64;  // 4-wide head-dim chunks a thread owns
  static constexpr size_t kSmem =
      (2 * kBlockM * kStride + kBlockN * D + kBlockM * kPStride) *
      sizeof(float);
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// rows [row0, row0 + 64) of src[rows, D] into dst[64][stride]; rows at or
// past `limit` are zero
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, int stride, const T* src,
                                      int row0, int limit) {
  for (int idx = threadIdx.x; idx < 64 * D / 4; idx += kThreads) {
    const int r = idx / (D / 4), c = 4 * (idx % (D / 4));
    const float4 v = row0 + r < limit
                         ? load4(src + static_cast<size_t>(row0 + r) * D + c)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(dst + r * stride + c) = v;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     T* __restrict__ o, float* __restrict__ lse, int sq,
                     int sk, int bias_ratio, int causal, float scale) {
  using C = Tile<D>;
  constexpr int S = C::kStride;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kBlockM][S]
  float* ks = qs + kBlockM * S;                 // [kBlockN][S]
  float* vs = ks + kBlockN * S;                 // [kBlockN][D]
  float* ps = vs + kBlockN * D;                 // [kBlockM][kPStride]

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bh = blockIdx.y;
  const int m0 = blockIdx.x * kBlockM;
  const T* kb = k + static_cast<size_t>(bh) * sk * D;
  const T* vb = v + static_cast<size_t>(bh) * sk * D;
  const float* bb =
      bias ? bias + static_cast<size_t>(bh / bias_ratio) * sq * sk : nullptr;

  stage<T, D>(qs, S, q + static_cast<size_t>(bh) * sq * D, m0, sq);

  float acc[4][C::kChunks][4];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C::kChunks; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  }
  const int kend = causal ? min(sk, m0 + kBlockM) : sk;

  for (int k0 = 0; k0 < kend; k0 += kBlockN) {
    __syncthreads();  // the previous tile is fully consumed
    stage<T, D>(ks, S, kb, k0, sk);
    stage<T, D>(vs, D, vb, k0, sk);
    __syncthreads();

    // s = q.k^T on the 4 x 4 register tile
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * S + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * S + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float t = s[i][j];
          t = fmaf(qv[i].x, kv[j].x, t);
          t = fmaf(qv[i].y, kv[j].y, t);
          t = fmaf(qv[i].z, kv[j].z, t);
          t = fmaf(qv[i].w, kv[j].w, t);
          s[i][j] = t;
        }
    }

    // scale, bias and masks; the tile's row max over the half-warp
    float mt[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + ty + 16 * i;
      mt[i] = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        float sv = s[i][j] * scale;
        if (bb && row < sq && key < sk)
          sv += bb[static_cast<size_t>(row) * sk + key];
        if (causal && key > row) sv = kNegInf;
        if (key >= sk) sv = -INFINITY;  // padding past Sk: weight exactly 0
        s[i][j] = sv;
        mt[i] = fmaxf(mt[i], sv);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], off));
    }

    // rescale the running state, write p for the p.v product
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float m_new = fmaxf(m[i], mt[i]);
      const float alpha = expf(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha;
#pragma unroll
      for (int c = 0; c < C::kChunks; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        l[i] += p;  // the softmax denominator sums the unrounded p
        ps[(ty + 16 * i) * kPStride + tx + 16 * j] = pt_round<T>(p);
      }
    }
    __syncthreads();

    // acc += p.v on the 4-row x 4*kChunks-dim register tile
#pragma unroll 4
    for (int j = 0; j < kBlockN; ++j) {
      float pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = ps[(ty + 16 * i) * kPStride + j];
#pragma unroll
      for (int c = 0; c < C::kChunks; ++c) {
        const float4 vv =
            *reinterpret_cast<const float4*>(vs + j * D + 64 * c + 4 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][c][0] = fmaf(pr[i], vv.x, acc[i][c][0]);
          acc[i][c][1] = fmaf(pr[i], vv.y, acc[i][c][1]);
          acc[i][c][2] = fmaf(pr[i], vv.z, acc[i][c][2]);
          acc[i][c][3] = fmaf(pr[i], vv.w, acc[i][c][3]);
        }
      }
    }
  }

  // each thread summed its own keys: add the 16 shares of every row
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* op = o + (static_cast<size_t>(bh) * sq + row) * D;
#pragma unroll
    for (int c = 0; c < C::kChunks; ++c)
      store4(op + 64 * c + 4 * tx,
             make_float4(acc[i][c][0] / denom, acc[i][c][1] / denom,
                         acc[i][c][2] / denom, acc[i][c][3] / denom));
    if (tx == 0)
      lse[static_cast<size_t>(bh) * sq + row] =
          l[i] > 0.f ? m[i] + logf(denom) : INFINITY;
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bias, void* o, void* lse, int bh, int sq,
                   int sk, int bias_ratio, int causal, float scale,
                   cudaStream_t stream) {
  using C = Tile<D>;
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::kSmem));
  if (err != cudaSuccess) return err;
  dim3 grid((sq + kBlockM - 1) / kBlockM, bh);
  kernel<<<grid, kThreads, C::kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<T*>(o), static_cast<float*>(lse), sq, sk, bias_ratio,
      causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v,
                       const void* bias, void* o, void* lse, int bh, int sq,
                       int sk, int bias_ratio, int causal, float scale,
                       cudaStream_t s) {
  switch (d) {
    case 64:
      return launch<T, 64>(q, k, v, bias, o, lse, bh, sq, sk, bias_ratio,
                           causal, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, bias, o, lse, bh, sq, sk, bias_ratio,
                            causal, scale, s);
    case 256:
      return launch<T, 256>(q, k, v, bias, o, lse, bh, sq, sk, bias_ratio,
                            causal, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// o[bh, sq, d], lse[bh, sq] from q[bh, sq, d], k/v[bh, sk, d] and an
// optional float32 additive bias[bh / bias_ratio, sq, sk] (NULL for none;
// bias_ratio = H shares one bias across the heads of a batch row).
// d must be 64, 128 or 256; causal requires sq == sk; q, k, v and o must be
// 16-byte aligned.
extern "C" int pt_flash_attn_fwd(int dtype, const void* q, const void* k,
                                 const void* v, const void* bias, void* o,
                                 void* lse, int bh, int sq, int sk, int d,
                                 int bias_ratio, int causal, float scale,
                                 void* stream) {
  if (bh < 1 || bh > 65535 || sq < 1 || sk < 1 || bias_ratio < 1 ||
      bh % bias_ratio != 0 || (causal && sq != sk))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == PT_F32) {
    err = dispatch_d<float>(d, q, k, v, bias, o, lse, bh, sq, sk, bias_ratio,
                            causal, scale, s);
  } else if (dtype == PT_BF16) {
    err = dispatch_d<__nv_bfloat16>(d, q, k, v, bias, o, lse, bh, sq, sk,
                                    bias_ratio, causal, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
