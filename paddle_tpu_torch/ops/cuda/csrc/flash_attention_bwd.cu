// Flash attention backward for Hopper: dq, and dk/dv.
//
// Replaces the TPU kernels paddle_tpu/ops/pallas/flash_attention.py
// _bwd_dq_kernel and _bwd_dkv_kernel (reached from _flash_bwd).  Same
// function, FlashAttention-2 style: both kernels recompute
// s = q.k^T * scale + bias (causal entries -1e30, keys past Sk -inf) and
// p = exp(s - lse) in float32 — a row whose lse is +inf (no unmasked key)
// gives p = 0 — and dp = do.v^T, masked and rescaled by the dropout keep
// mask; ds = p * (dp - delta) with delta = rowsum(do * o) (computed by the
// caller, as _flash_bwd does outside its kernels).  Then
//   dq = ds.k * scale,  dk = ds^T.q * scale,  dv = p_dropped^T.do.
// The keep mask is regenerated element by element from (seed, bh, row,
// col) with the forward's Philox (common.cuh), so it is bit-identical.
// The additive bias gets no gradient (zero by contract, as on the TPU).
//
// Bound on an H100: at BERT's shapes (D = 64, S = 128..512) the FLOPs
// (dq 6*BH*Sq*Sk*D, dk/dv 8*BH*Sq*Sk*D) dominate the bytes.  Like the
// forward, the products run on the float32 FMA pipes, register-tiled
// (flash_common.cuh), not on the tensor cores.
//
// Design.  dq: one block of 256 threads per (64-row query tile, bh) keeps
// its Q and dO rows in shared memory and walks the key tiles (causal: only
// up to the diagonal); K and V come in 64-wide head-dim chunks, so shared
// memory stays under the 227 KB limit at D = 256.  dk/dv: one block per
// (64-key tile, bh) keeps its K and V rows and walks the query tiles
// (causal: from the diagonal on), accumulating dk and dv in registers.
// Each block owns its output rows, so nothing is summed across blocks: no
// atomics, and the result is the same on every run.
#include "flash_common.cuh"

namespace {

template <int D>
struct BwdTile {
  static constexpr int kStride = D + 4;
  static constexpr int kChunks = D / 64;
  // dq: Q, dO resident; K, V chunks; ds tile
  static constexpr size_t kSmemDq =
      (2 * kBlockM * kStride + 2 * kBlockN * kCStride + kBlockM * kPStride) *
      sizeof(float);
  // dk/dv: K, V resident; Q, dO chunks; p_dropped and ds tiles
  static constexpr size_t kSmemDkv =
      (2 * kBlockN * kStride + 2 * kBlockM * kCStride +
       2 * kBlockN * kPStride) *
      sizeof(float);
};

struct BwdArgs {
  const void *q, *k, *v, *bias, *dout, *lse, *delta;
  void *dq, *dk, *dv;
  int bh, sq, sk, bias_ratio, causal;
  float scale;
  const int* seed;
  uint32_t threshold;
  float inv_keep;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const float* __restrict__ bias,
                        const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int sq, int sk, int bias_ratio, int causal,
                        float scale, const int* __restrict__ seed,
                        uint32_t threshold, float inv_keep) {
  using C = BwdTile<D>;
  constexpr int S = C::kStride;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kBlockM][S]
  float* dos = qs + kBlockM * S;                // [kBlockM][S]
  float* kc = dos + kBlockM * S;                // [kBlockN][kCStride]
  float* vc = kc + kBlockN * kCStride;          // [kBlockN][kCStride]
  float* dss = vc + kBlockN * kCStride;         // [kBlockM][kPStride]

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bh = blockIdx.y;
  const int m0 = blockIdx.x * kBlockM;
  const size_t qoff = static_cast<size_t>(bh) * sq;
  const T* kb = k + static_cast<size_t>(bh) * sk * D;
  const T* vb = v + static_cast<size_t>(bh) * sk * D;
  const float* bb =
      bias ? bias + static_cast<size_t>(bh / bias_ratio) * sq * sk : nullptr;
  const uint32_t sd = seed ? static_cast<uint32_t>(*seed) : 0u;

  stage<T, D, D>(qs, S, q + qoff * D, m0, sq);
  stage<T, D, D>(dos, S, dout + qoff * D, m0, sq);
  float row_lse[4], row_delta[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    row_lse[i] = row < sq ? lse[qoff + row] : INFINITY;
    row_delta[i] = row < sq ? delta[qoff + row] : 0.f;
  }

  float acc[C::kChunks][4][4];
#pragma unroll
  for (int c = 0; c < C::kChunks; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][i][e] = 0.f;
  const int kend = causal ? min(sk, m0 + kBlockM) : sk;

  for (int k0 = 0; k0 < kend; k0 += kBlockN) {
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll
    for (int c = 0; c < C::kChunks; ++c) {
      __syncthreads();  // the previous chunk (and ds tile) is consumed
      stage<T, D, 64>(kc, kCStride, kb, k0, sk, 64 * c);
      stage<T, D, 64>(vc, kCStride, vb, k0, sk, 64 * c);
      __syncthreads();
      tile_dot(s, qs + 64 * c, S, kc, kCStride, 64);
      tile_dot(dp, dos + 64 * c, S, vc, kCStride, 64);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        float sv = s[i][j] * scale;
        if (bb && row < sq && key < sk)
          sv += bb[static_cast<size_t>(row) * sk + key];
        if (causal && key > row) sv = kNegInf;
        if (key >= sk) sv = -INFINITY;
        const float p = expf(sv - row_lse[i]);
        float dpv = dp[i][j];
        if (seed)
          dpv = keep_element(sd, bh, row, key, threshold) ? dpv * inv_keep
                                                          : 0.f;
        dss[(ty + 16 * i) * kPStride + tx + 16 * j] =
            p * (dpv - row_delta[i]);
      }
    }
    __syncthreads();

    // acc += ds . k over the tile's keys, chunk by chunk of the head dim;
    // with one chunk the K chunk is still in place
#pragma unroll
    for (int c = 0; c < C::kChunks; ++c) {
      if (C::kChunks > 1) {
        __syncthreads();
        stage<T, D, 64>(kc, kCStride, kb, k0, sk, 64 * c);
        __syncthreads();
      }
      tile_acc(acc[c], dss, kc, kCStride);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= sq) continue;
    T* out = static_cast<T*>(dq) + (qoff + row) * D;
#pragma unroll
    for (int c = 0; c < C::kChunks; ++c)
      store4(out + 64 * c + 4 * tx,
             make_float4(acc[c][i][0] * scale, acc[c][i][1] * scale,
                         acc[c][i][2] * scale, acc[c][i][3] * scale));
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const float* __restrict__ bias,
                         const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv, int sq,
                         int sk, int bias_ratio, int causal, float scale,
                         const int* __restrict__ seed, uint32_t threshold,
                         float inv_keep) {
  using C = BwdTile<D>;
  constexpr int S = C::kStride;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [kBlockN][S]
  float* vs = ks + kBlockN * S;                 // [kBlockN][S]
  float* qc = vs + kBlockN * S;                 // [kBlockM][kCStride]
  float* dc = qc + kBlockM * kCStride;          // [kBlockM][kCStride] (dO)
  float* pds = dc + kBlockM * kCStride;         // [kBlockN][kPStride]
  float* dss = pds + kBlockN * kPStride;        // [kBlockN][kPStride]

  // thread (ty, tx) owns keys ty + 16i and query rows tx + 16j of the
  // transposed score tile
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bh = blockIdx.y;
  const int n0 = blockIdx.x * kBlockN;
  const size_t qoff = static_cast<size_t>(bh) * sq;
  const size_t koff = static_cast<size_t>(bh) * sk;
  const T* qb = q + qoff * D;
  const T* db = dout + qoff * D;
  const float* bb =
      bias ? bias + static_cast<size_t>(bh / bias_ratio) * sq * sk : nullptr;
  const uint32_t sd = seed ? static_cast<uint32_t>(*seed) : 0u;

  stage<T, D, D>(ks, S, k + koff * D, n0, sk);
  stage<T, D, D>(vs, S, v + koff * D, n0, sk);

  float dk_acc[C::kChunks][4][4], dv_acc[C::kChunks][4][4];
#pragma unroll
  for (int c = 0; c < C::kChunks; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk_acc[c][i][e] = dv_acc[c][i][e] = 0.f;
  // causal: query rows below the tile's first key see none of its keys
  const int qstart = causal ? (n0 / kBlockM) * kBlockM : 0;

  for (int m0 = qstart; m0 < sq; m0 += kBlockM) {
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll
    for (int c = 0; c < C::kChunks; ++c) {
      __syncthreads();
      stage<T, D, 64>(qc, kCStride, qb, m0, sq, 64 * c);
      stage<T, D, 64>(dc, kCStride, db, m0, sq, 64 * c);
      __syncthreads();
      tile_dot(s, ks + 64 * c, S, qc, kCStride, 64);
      tile_dot(dp, vs + 64 * c, S, dc, kCStride, 64);
    }

    float row_lse[4], row_delta[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = m0 + tx + 16 * j;
      row_lse[j] = row < sq ? lse[qoff + row] : INFINITY;
      row_delta[j] = row < sq ? delta[qoff + row] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = n0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = m0 + tx + 16 * j;
        float sv = s[i][j] * scale;
        if (bb && row < sq && key < sk)
          sv += bb[static_cast<size_t>(row) * sk + key];
        if (causal && key > row) sv = kNegInf;
        if (key >= sk) sv = -INFINITY;
        const float p = expf(sv - row_lse[j]);
        float pd = p, dpv = dp[i][j];
        if (seed && !keep_element(sd, bh, row, key, threshold)) {
          pd = 0.f;
          dpv = 0.f;
        } else if (seed) {
          pd *= inv_keep;
          dpv *= inv_keep;
        }
        pds[(ty + 16 * i) * kPStride + tx + 16 * j] = pd;
        dss[(ty + 16 * i) * kPStride + tx + 16 * j] =
            p * (dpv - row_delta[j]);
      }
    }
    __syncthreads();

    // dv += p_dropped^T . do, dk += ds^T . q, chunk by chunk of the head
    // dim; with one chunk the Q and dO chunks are still in place
#pragma unroll
    for (int c = 0; c < C::kChunks; ++c) {
      if (C::kChunks > 1) {
        __syncthreads();
        stage<T, D, 64>(qc, kCStride, qb, m0, sq, 64 * c);
        stage<T, D, 64>(dc, kCStride, db, m0, sq, 64 * c);
        __syncthreads();
      }
      tile_acc(dv_acc[c], pds, dc, kCStride);
      tile_acc(dk_acc[c], dss, qc, kCStride);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = n0 + ty + 16 * i;
    if (key >= sk) continue;
    T* kout = dk + (koff + key) * D;
    T* vout = dv + (koff + key) * D;
#pragma unroll
    for (int c = 0; c < C::kChunks; ++c) {
      store4(kout + 64 * c + 4 * tx,
             make_float4(dk_acc[c][i][0] * scale, dk_acc[c][i][1] * scale,
                         dk_acc[c][i][2] * scale, dk_acc[c][i][3] * scale));
      store4(vout + 64 * c + 4 * tx,
             make_float4(dv_acc[c][i][0], dv_acc[c][i][1], dv_acc[c][i][2],
                         dv_acc[c][i][3]));
    }
  }
}

template <typename T, int D>
cudaError_t launch_dq(const BwdArgs& a, cudaStream_t stream) {
  using C = BwdTile<D>;
  auto kernel = flash_bwd_dq_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::kSmemDq));
  if (err != cudaSuccess) return err;
  dim3 grid((a.sq + kBlockM - 1) / kBlockM, a.bh);
  kernel<<<grid, kThreads, C::kSmemDq, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const float*>(a.bias),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.dq), a.sq, a.sk,
      a.bias_ratio, a.causal, a.scale, a.seed, a.threshold, a.inv_keep);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const BwdArgs& a, cudaStream_t stream) {
  using C = BwdTile<D>;
  auto kernel = flash_bwd_dkv_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::kSmemDkv));
  if (err != cudaSuccess) return err;
  dim3 grid((a.sk + kBlockN - 1) / kBlockN, a.bh);
  kernel<<<grid, kThreads, C::kSmemDkv, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const float*>(a.bias),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.sq, a.sk, a.bias_ratio, a.causal, a.scale,
      a.seed, a.threshold, a.inv_keep);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(bool dkv, int d, const BwdArgs& a, cudaStream_t s) {
  switch (d) {
    case 64:
      return dkv ? launch_dkv<T, 64>(a, s) : launch_dq<T, 64>(a, s);
    case 128:
      return dkv ? launch_dkv<T, 128>(a, s) : launch_dq<T, 128>(a, s);
    case 256:
      return dkv ? launch_dkv<T, 256>(a, s) : launch_dq<T, 256>(a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

int run(bool dkv, int dtype, int d, const BwdArgs& a, void* stream) {
  if (a.bh < 1 || a.bh > 65535 || a.sq < 1 || a.sk < 1 ||
      a.bias_ratio < 1 || a.bh % a.bias_ratio != 0 ||
      (a.causal && a.sq != a.sk))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == PT_F32) {
    err = dispatch<float>(dkv, d, a, s);
  } else if (dtype == PT_BF16) {
    err = dispatch<__nv_bfloat16>(dkv, d, a, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

// dq[bh, sq, d] from q[bh, sq, d], k/v[bh, sk, d], the optional float32
// bias[bh / bias_ratio, sq, sk], dout[bh, sq, d], and the float32 row
// statistics lse[bh, sq] (the forward's) and delta[bh, sq] =
// rowsum(dout * o).  `seed`, `threshold` and `inv_keep` must be the
// forward's (NULL seed: no dropout).  Same shape rules as the forward.
extern "C" int pt_flash_attn_bwd_dq(int dtype, const void* q, const void* k,
                                    const void* v, const void* bias,
                                    const void* dout, const void* lse,
                                    const void* delta, void* dq, int bh,
                                    int sq, int sk, int d, int bias_ratio,
                                    int causal, float scale, const void* seed,
                                    unsigned int threshold, float inv_keep,
                                    void* stream) {
  const BwdArgs a{q,  k,      v,  bias, dout, lse, delta, dq,
                  nullptr, nullptr, bh, sq, sk, bias_ratio, causal, scale,
                  static_cast<const int*>(seed), threshold, inv_keep};
  return run(false, dtype, d, a, stream);
}

// dk, dv[bh, sk, d] from the same inputs as pt_flash_attn_bwd_dq.
extern "C" int pt_flash_attn_bwd_dkv(int dtype, const void* q, const void* k,
                                     const void* v, const void* bias,
                                     const void* dout, const void* lse,
                                     const void* delta, void* dk, void* dv,
                                     int bh, int sq, int sk, int d,
                                     int bias_ratio, int causal, float scale,
                                     const void* seed, unsigned int threshold,
                                     float inv_keep, void* stream) {
  const BwdArgs a{q,  k,  v,  bias, dout, lse, delta, nullptr,
                  dk, dv, bh, sq, sk, bias_ratio, causal, scale,
                  static_cast<const int*>(seed), threshold, inv_keep};
  return run(true, dtype, d, a, stream);
}
