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
// Dropout (training): as in the TPU kernel, l sums the undropped p and
// only the numerator is masked, p -> keep ? p / (1 - rate) : 0.  The TPU
// seeds its hardware generator per (head, q-block, k-block); here the keep
// bit of each score element is Philox-4x32-10 of (seed, bh, row, col)
// (common.cuh), so the backward kernels regenerate the same mask and the
// mask does not depend on the tiling.  The seed is read from device
// memory, so drawing it costs no host sync.  The kernel is instantiated
// with and without dropout: with the generator compiled into the one
// kernel, the inference forward ran 12 % slower on an H100 at S = 512.
//
// Bound on an H100: at the served shapes (D = 64, S = 128..512) the
// 4*BH*Sq*Sk*D FLOPs dominate the bytes.  This version runs them on the
// float32 FMA pipes (67 TFLOP/s peak), not the tensor cores; the limit in
// practice is how many FMAs each shared-memory load feeds.  wgmma/TMA come
// later.
//
// Design: one block of 256 threads per (64-row query tile, batch*head);
// the Q tile and each 64-key K/V tile are staged in shared memory (float32,
// bf16 widened on load).  Both products are register-tiled (flash_common.cuh):
// thread (ty, tx) of a 16 x 16 grid owns query rows ty + 16i and keys
// tx + 16j (i, j < 4) of the score tile, and rows ty + 16i by head dims
// 64c + 4tx .. +3 of the output.  A row's 64 scores live in the 16 threads
// of one half-warp: the tile max is a 4-step shuffle, and each thread keeps
// its own share of the softmax sum, added up once at the end.  Causal tiles
// above the diagonal are never loaded (block skipping); keys past Sk and
// rows past Sq are masked, so any lengths work.
#include "flash_common.cuh"

namespace {

template <int D>
struct Tile {
  static constexpr int kStride = D + 4;   // Q/K rows: 4 banks apart
  static constexpr int kChunks = D / 64;  // 4-wide head-dim chunks a thread owns
  static constexpr size_t kSmem =
      (2 * kBlockM * kStride + kBlockN * D + kBlockM * kPStride) *
      sizeof(float);
};

template <typename T, int D, bool kDropout>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     T* __restrict__ o, float* __restrict__ lse, int sq,
                     int sk, int bias_ratio, int causal, float scale,
                     const int* __restrict__ seed, uint32_t threshold,
                     float inv_keep) {
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
  const uint32_t sd = kDropout ? static_cast<uint32_t>(*seed) : 0u;

  stage<T, D, D>(qs, S, q + static_cast<size_t>(bh) * sq * D, m0, sq);

  float acc[C::kChunks][4][4];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C::kChunks; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][i][e] = 0.f;
  }
  const int kend = causal ? min(sk, m0 + kBlockM) : sk;

  for (int k0 = 0; k0 < kend; k0 += kBlockN) {
    __syncthreads();  // the previous tile is fully consumed
    stage<T, D, D>(ks, S, kb, k0, sk);
    stage<T, D, D>(vs, D, vb, k0, sk);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    tile_dot(s, qs, S, ks, S, D);

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

    // rescale the running state, write (dropped) p for the p.v product
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + ty + 16 * i;
      const float m_new = fmaxf(m[i], mt[i]);
      const float alpha = expf(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha;
#pragma unroll
      for (int c = 0; c < C::kChunks; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[c][i][e] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        float p = expf(s[i][j] - m_new);
        l[i] += p;  // the softmax denominator sums the undropped p
        if (kDropout)
          p = keep_element(sd, bh, row, key, threshold) ? p * inv_keep : 0.f;
        ps[(ty + 16 * i) * kPStride + tx + 16 * j] = pt_round<T>(p);
      }
    }
    __syncthreads();

#pragma unroll
    for (int c = 0; c < C::kChunks; ++c) tile_acc(acc[c], ps, vs + 64 * c, D);
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
             make_float4(acc[c][i][0] / denom, acc[c][i][1] / denom,
                         acc[c][i][2] / denom, acc[c][i][3] / denom));
    if (tx == 0)
      lse[static_cast<size_t>(bh) * sq + row] =
          l[i] > 0.f ? m[i] + logf(denom) : INFINITY;
  }
}

struct FwdArgs {
  const void *q, *k, *v, *bias;
  void *o, *lse;
  int bh, sq, sk, bias_ratio, causal;
  float scale;
  const int* seed;
  uint32_t threshold;
  float inv_keep;
};

template <typename T, int D, bool kDropout>
cudaError_t launch(const FwdArgs& a, cudaStream_t stream) {
  using C = Tile<D>;
  auto kernel = flash_fwd_kernel<T, D, kDropout>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::kSmem));
  if (err != cudaSuccess) return err;
  dim3 grid((a.sq + kBlockM - 1) / kBlockM, a.bh);
  kernel<<<grid, kThreads, C::kSmem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const float*>(a.bias),
      static_cast<T*>(a.o), static_cast<float*>(a.lse), a.sq, a.sk,
      a.bias_ratio, a.causal, a.scale, a.seed, a.threshold, a.inv_keep);
  return cudaGetLastError();
}

template <typename T, bool kDropout>
cudaError_t dispatch_d(int d, const FwdArgs& a, cudaStream_t s) {
  switch (d) {
    case 64:
      return launch<T, 64, kDropout>(a, s);
    case 128:
      return launch<T, 128, kDropout>(a, s);
    case 256:
      return launch<T, 256, kDropout>(a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch(int d, const FwdArgs& a, cudaStream_t s) {
  return a.seed ? dispatch_d<T, true>(d, a, s) : dispatch_d<T, false>(d, a, s);
}

}  // namespace

// o[bh, sq, d], lse[bh, sq] from q[bh, sq, d], k/v[bh, sk, d] and an
// optional float32 additive bias[bh / bias_ratio, sq, sk] (NULL for none;
// bias_ratio = H shares one bias across the heads of a batch row).
// d must be 64, 128 or 256; causal requires sq == sk; q, k, v and o must be
// 16-byte aligned.  `seed` (one int32 in device memory) turns dropout on:
// an element is kept when its Philox word is >= `threshold` and then
// scaled by `inv_keep`; NULL means no dropout.
extern "C" int pt_flash_attn_fwd(int dtype, const void* q, const void* k,
                                 const void* v, const void* bias, void* o,
                                 void* lse, int bh, int sq, int sk, int d,
                                 int bias_ratio, int causal, float scale,
                                 const void* seed, unsigned int threshold,
                                 float inv_keep, void* stream) {
  if (bh < 1 || bh > 65535 || sq < 1 || sk < 1 || bias_ratio < 1 ||
      bh % bias_ratio != 0 || (causal && sq != sk))
    return static_cast<int>(cudaErrorInvalidValue);
  const FwdArgs a{q, k, v, bias, o, lse, bh, sq, sk, bias_ratio, causal,
                  scale, static_cast<const int*>(seed), threshold, inv_keep};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == PT_F32) {
    err = dispatch<float>(d, a, s);
  } else if (dtype == PT_BF16) {
    err = dispatch<__nv_bfloat16>(d, a, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
