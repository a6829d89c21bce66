// Flash attention forward (online softmax, blockwise) for Hopper.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/flash_attention.py
// _fwd_kernel (reached from _flash_fwd / flash_attention_bshd).  Same
// function: per (batch*head) row block, s = q.k^T / sqrt(D) + bias, causal
// entries set to -1e30, a running max m and sum l of exp(s - m), float32
// accumulation of p.v, o = acc / max(l, 1e-30) and lse = m + log(l) (+inf
// on rows whose l is 0).  In bf16 and float16 p is rounded to the input
// type before the p.v product, as the TPU kernel does with
// p.astype(v.dtype).
//
// Dropout (training): as in the TPU kernel, l sums the undropped p and
// only the numerator is masked, p -> keep ? p / (1 - rate) : 0.  The TPU
// seeds its hardware generator per (head, q-block, k-block); here the keep
// bit of each score element is common.cuh's pt_dropout_word of (seed, bh,
// row, col), one Philox-4x32-10 draw for four elements, so the backward
// kernels regenerate the same mask and the mask does not depend on the
// tiling.  The seed is read from device memory, so drawing it costs no host
// sync.  The kernel is instantiated with and without dropout: with the
// generator compiled into the one kernel, the inference forward ran 12 %
// slower on an H100 at S = 512.
//
// Bound on an H100 SXM: the TPU kernel's function is two S^2 D products
// (4 BH Sq Sk D flops, half of it for causal) reading q, k, v and the bias
// once and writing o and lse.  At BERT-base's training shape (B32 H12 S128
// D64, float32, the head-shared padding bias) that is 0.0157 ms of bytes
// at 3.35 TB/s, above 0.0098 ms of 3xTF32 tensor-core operations (495
// TFLOP/s, three passes a product) and below the 0.0240 ms the products
// take on the float32 FMA pipes (67 TFLOP/s); served (B8 S128) 0.0039 ms.
// In bf16 at the mixed-precision program's shape (B96 H12 S128 D64, the
// padding bias) the bytes take 0.0246 ms, the products 0.0049 ms at 989
// TFLOP/s: bytes again.  Beside them every score costs an exponential and,
// in training, a quarter of a Philox draw (~100 instructions a draw): at
// B96 about 0.015 ms of the SMs' issue with dropout.
//
// Two designs: float32 (below) on mma.sync, and bf16 / float16 on Hopper's
// own machinery (the second half of the file).
//
// Design, float32 (head dims 64 and 128).
// * The products run on the tensor cores through mma.sync, as in the
//   backward (flash_common.cuh).  A block of 4 warps takes 32 query rows:
//   2 row warps of 16 rows, each twice, for the two 16-key parts of every
//   32-key stage.  The K and V stages are double-buffered in shared memory
//   by cp.async, in their own dtype, the next stage's copy in flight while
//   this one's products run.  A warp's 16 x 16 scores stay in registers
//   from q.k^T through the softmax to p.v: an accumulator fragment is an A
//   fragment with its k index permuted (acc_tile).  Each part keeps its own
//   running max, sum and accumulator; after the last stage the upper part
//   hands its state to the lower one through shared memory, which merges
//   the two (m = max(m_a, m_b), x = x_a e^(m_a - m) + x_b e^(m_b - m)).
//   The shape was measured on an H100 (tools/torch_kernel_ab.py, variants
//   of 32 or 64 rows, one or two key parts, 32 or 64 keys a stage): small
//   blocks (43.5 KB at D 64 in float32, at most 128 registers, four an SM)
//   spread BERT's served grid (B8 S128: 384 blocks) evenly over the 132
//   SMs, where 64-row blocks left 60 SMs with twice the work; the training
//   shapes run within 8 % of the best shape measured for them.  A row's
//   arithmetic does not depend on the block's row count, only on the parts
//   and stages.
// * float32: q.k^T is one fmaf chain per score over the head dim in order
//   from 0 (score_tile_fma), the float32 product the plain version's matmul
//   computes, and the scale and bias are applied with their own roundings,
//   as the plain version applies them.  Under BERT's -1e4 padding bias a
//   float32 score keeps 10 bits; summed in another order, a score of an
//   all-masked query row moves by an ulp and its p by 1e-3 of itself, and o
//   with it, past the 2e-5 tolerance against the plain version
//   (tests/test_torch_flash_fwd_numerics.py emulates both).  p.v is 3xTF32.
// * Dropout: one draw per 8-key tile of a thread's fragment (rows g and
//   g + 8 at two columns: the four words of one draw), four generator
//   chains at a time, folded into a bit mask (fragment_keep).
// * Row statistics: a row's scores lie in the 4 lanes of a quad, so the
//   tile max is two shuffles, and each thread keeps its own share of the
//   softmax sum, added up once at the end.
// * Causal tiles above the diagonal are never loaded (block skipping); keys
//   past Sk and rows past Sq are masked (their staged rows are zeros), so
//   any lengths work.
// * Head dim 256 takes the first port's kernel on the float32 FMA pipes
//   (flash_fwd_fma_kernel, below), in every dtype: a warp's 16 output rows
//   of 256 floats do not fit in its registers beside the score tiles.
//
// Design, bf16 and float16 (head dims 64 and 128; flash_fwd_sm90_kernel,
// hopper.cuh).
// * A block is one warpgroup and 64 query rows.  Q and a ring of two
//   64-key K/V stages arrive by TMA (3-D tensor maps over [BH, S, D], so a
//   tile's rows past S read as zeros within their own head), completing on
//   mbarriers; thread 0 issues the copies and refills a stage as soon as
//   the warpgroup's products have read it.  The loads of every K/V row
//   serve 64 query rows (the float32 design stages them for every 32).
// * q.k^T is wgmma m64n64k16 on the swizzled tiles; p.v is wgmma
//   m64nDk16 with p as the register operand (slices 2k and 2k + 1 of the
//   score accumulator, rounded to 16 bits, are the A fragment of step k)
//   and V through wgmma's transposed 16-bit operand: neither p nor V^T is
//   copied.  No merge of key parts: one warpgroup holds whole rows.
// * The bias tile (64 rows by 64 keys, float32) is staged by cp.async in
//   16-byte chunks where the rows allow (Sk % 4 == 0), else 4 bytes, and
//   read from shared memory without bank conflicts (rows 72 floats
//   apart); query blocks are the grid's fastest axis, so the heads of one
//   batch row run together and share the head-shared bias in L2.
// * The scale and the bias are applied in one rounding (fmaf), and
//   e^(s - m) is 2^(s log2 e - m log2 e): one fmaf and MUFU.EX2.  A row
//   whose every key so far is masked by a bias (the ring's -1e30: m below
//   kHugeNeg) takes 2^((s - m) log2 e) instead: there the rounding of
//   m log2 e (~1e23) would swamp s - m and give p = inf or 0, where the
//   plain version's s - m is exactly 0 (p = 1, the uniform mean of V).
// * The dropout mask (fragment_keep) is drawn while q.k^T runs.
// * 60 KB of shared memory and at most 168 registers at D 64: three
//   blocks an SM.  Measured on an H100 at B96 H12 S128 D64 bf16
//   (tools/torch_kernel_ab.py): 0.063 ms at dropout 0.1 where the float32
//   design's bf16 instantiation took 0.114 and SDPA 0.078.  Loading each
//   thread's bias pairs straight into registers while q.k^T runs (no
//   bias tile, no barrier for it) ran 0.068 (0.060 at dropout 0, against
//   0.053), and with four blocks an SM 0.062 (0.056) and slower at S 512.
#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

// A block: 2 row warps of 16 query rows, each twice, for the two 16-key
// parts of every 32-key stage; Q resident, K and V in two stages, rows 4
// words apart mod 32
template <typename T, int D>
struct FwdTile {
  static constexpr int kRows = 32;
  static constexpr int kKeys = 32;
  static constexpr int kThreads = 128;
  static constexpr int kS = D + (sizeof(T) == 4 ? 4 : 8);
  static constexpr size_t kSmem = (kRows + 4 * kKeys) * kS * sizeof(T);
  // the upper key part's row state (m, l and the accumulator), handed over
  // through the same shared memory after the last stage
  static constexpr size_t kMerge = (4 + D / 2) * 2 * kRows * sizeof(float);
  static_assert(kMerge <= kSmem, "the merge fits the tiles' memory");
};

// D 64: four blocks an SM (at most 128 registers a thread)
template <typename T, int D, bool kDropout>
__global__ void __launch_bounds__(128, D == 64 ? 4 : 1)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     T* __restrict__ o, float* __restrict__ lse, int sq,
                     int sk, int bias_ratio, int causal, float scale,
                     const int* __restrict__ seed, uint32_t threshold,
                     float inv_keep) {
  using L = FwdTile<T, D>;
  constexpr int S = L::kS, ROWS = L::kRows, NTH = L::kThreads;
  constexpr int BN = L::kKeys, HALF = BN / 2, NT = HALF / 8, DT = D / 8;
  constexpr int RW = ROWS / 16;  // row warps
  extern __shared__ float4 smem4[];
  T* qs = reinterpret_cast<T*>(smem4);  // [ROWS][S]
  T* ks = qs + ROWS * S;                // [2][BN][S]
  T* vs = ks + 2 * BN * S;              // [2][BN][S]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rw = warp % RW, half = warp / RW;  // row warp, key part
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.y, m0 = blockIdx.x * ROWS;
  const size_t qoff = static_cast<size_t>(bh) * sq;
  const size_t koff = static_cast<size_t>(bh) * sk;
  const T* kb = k + koff * D;
  const T* vb = v + koff * D;
  const float* bb =
      bias ? bias + static_cast<size_t>(bh / bias_ratio) * sq * sk : nullptr;
  const uint32_t sd = kDropout ? static_cast<uint32_t>(*seed) : 0u;
  // causal: the key tiles up to the diagonal
  const int kend = causal ? min(sk, m0 + ROWS) : sk;
  const int tiles = (kend + BN - 1) / BN;
  const int r0 = m0 + 16 * rw + g;  // this thread's rows: r0, r0 + 8

  auto stage_keys = [&](int buf, int k0) {
    copy_tile<T, D, BN, S, NTH>(ks + buf * BN * S, kb, D, k0, sk);
    copy_tile<T, D, BN, S, NTH>(vs + buf * BN * S, vb, D, k0, sk);
  };
  copy_tile<T, D, ROWS, S, NTH>(qs, q + qoff * D, D, m0, sq);
  stage_keys(0, 0);
  cp_async_commit();

  float acc[DT][4];
  zero(acc);
  float mrow[2] = {kNegInf, kNegInf}, lrow[2] = {0.f, 0.f};
  const T* qw = qs + 16 * rw * S;
  for (int i = 0; i < tiles; ++i) {
    if (i + 1 < tiles) stage_keys((i + 1) & 1, (i + 1) * BN);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int kw = i * BN + half * HALF;  // this warp's first key
    const T* kt = ks + ((i & 1) * BN + half * HALF) * S;
    const T* vt = vs + ((i & 1) * BN + half * HALF) * S;

    float bv[NT][4];  // the bias loads, all in flight at once
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = r0 + 8 * (c >> 1), key = kw + 8 * j + 2 * t + (c & 1);
        bv[j][c] = bb && row < sq && key < sk
                       ? bb[static_cast<size_t>(row) * sk + key]
                       : 0.f;
      }
    float s[NT][4];
    zero(s);
    if constexpr (sizeof(T) == 4)
      score_tile_fma<D, NT, S>(s, qw, kt, g, t);
    else
      score_tile<D, NT, S>(s, qw, kt, g, t);
    const uint32_t keep =
        kDropout ? fragment_keep<NT>(sd, bh, r0, kw + 2 * t, threshold) : ~0u;

    // scale, bias and masks; the max of rows r0 and r0 + 8 over the keys
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = r0 + 8 * (c >> 1), key = kw + 8 * j + 2 * t + (c & 1);
        float sv = __fadd_rn(__fmul_rn(s[j][c], scale), bv[j][c]);
        if (causal && key > row) sv = kNegInf;
        if (key >= sk) sv = -INFINITY;  // padding past Sk: weight exactly 0
        s[j][c] = sv;
        mt[c >> 1] = fmaxf(mt[c >> 1], sv);
      }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 1));
      mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 2));
      const float m_new = fmaxf(mrow[h], mt[h]);
      alpha[h] = expf(mrow[h] - m_new);
      mrow[h] = m_new;
      lrow[h] *= alpha[h];
    }
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[n][c] *= alpha[c >> 1];
    // p, its sum (undropped) and the dropped p that p.v takes
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[j][c] - mrow[c >> 1]);
        lrow[c >> 1] += p;
        s[j][c] = !kDropout ? p
                  : (keep >> (4 * j + c)) & 1u ? p * inv_keep : 0.f;
      }
    acc_tile<D, NT, S, false>(acc, s, vt, g, t);  // acc += p . v
    __syncthreads();  // the stage is read before the next copy into it
  }

  // the two key parts of each row: the upper warps hand (m, l, acc) to the
  // lower ones through shared memory, [value][thread] (conflict-free), and
  // the lower ones merge, m = max(m_a, m_b), x = x_a e^(m_a - m) + x_b
  // e^(m_b - m), and write the rows
  {
    constexpr int N = 32 * RW;
    cp_async_wait<0>();
    float* xs = reinterpret_cast<float*>(smem4);
    const int slot = rw * 32 + lane;
    if (half == 1) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        xs[h * N + slot] = mrow[h];
        xs[(2 + h) * N + slot] = lrow[h];
      }
#pragma unroll
      for (int n = 0; n < DT; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) xs[(4 + 4 * n + c) * N + slot] = acc[n][c];
    }
    __syncthreads();
    if (half == 1) return;
    float fb[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mb = xs[h * N + slot];
      const float m_new = fmaxf(mrow[h], mb);
      const float fa = expf(mrow[h] - m_new);
      fb[h] = expf(mb - m_new);
      lrow[h] = lrow[h] * fa + xs[(2 + h) * N + slot] * fb[h];
      mrow[h] = m_new;
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        acc[n][2 * h] *= fa;
        acc[n][2 * h + 1] *= fa;
      }
    }
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        acc[n][c] += xs[(4 + 4 * n + c) * N + slot] * fb[c >> 1];
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lrow[h] += __shfl_xor_sync(0xffffffffu, lrow[h], 1);
    lrow[h] += __shfl_xor_sync(0xffffffffu, lrow[h], 2);
    const int row = r0 + 8 * h;
    if (row >= sq) continue;
    const float denom = fmaxf(lrow[h], 1e-30f);
    T* op = o + (qoff + row) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < DT; ++n)
      store2(op + 8 * n, acc[n][2 * h] / denom, acc[n][2 * h + 1] / denom);
    if (t == 0)
      lse[qoff + row] = lrow[h] > 0.f ? mrow[h] + logf(denom) : INFINITY;
  }
}

// ---------------------------------------------------------------------------
// head dim 256: the first port's kernel on the float32 FMA pipes, 256
// threads as a 16 x 16 grid over 64 x 64 score tiles (flash_common.cuh):
// thread (ty, tx) owns query rows ty + 16i and keys tx + 16j (i, j < 4) of
// the score tile, and rows ty + 16i by head dims 64c + 4tx .. +3 of the
// output; the Q tile and each 64-key K/V tile are staged in shared memory
// as float32
// ---------------------------------------------------------------------------

template <int D>
struct FmaTile {
  static constexpr int kStride = D + 4;   // Q/K rows: 4 banks apart
  static constexpr int kChunks = D / 64;  // 4-wide head-dim chunks a thread owns
  static constexpr size_t kSmem =
      (2 * kBlockM * kStride + kBlockN * D + kBlockM * kPStride) *
      sizeof(float);
};

template <typename T, int D, bool kDropout>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_fma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     T* __restrict__ o, float* __restrict__ lse, int sq,
                     int sk, int bias_ratio, int causal, float scale,
                     const int* __restrict__ seed, uint32_t threshold,
                     float inv_keep) {
  using C = FmaTile<D>;
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

// ---------------------------------------------------------------------------
// bf16 and float16, head dims 64 and 128: Hopper's design (the source
// note's second part).  A block is one warpgroup and 64 query rows; Q and a
// ring of K/V stages arrive by TMA on mbarriers, the scores and p.v run on
// wgmma, the bias tile by cp.async.
// ---------------------------------------------------------------------------

template <int D>
struct Sm90FwdTile {
  static constexpr int kRows = 64;               // query rows: a warpgroup
  static constexpr int kKeys = 64;               // keys a stage
  static constexpr int kStages = 2;
  static constexpr int kPanel = 64 * 128;        // a 64-row, 128-byte panel
  static constexpr int kTile = D / 64 * kPanel;  // 64 rows of D columns
  static constexpr int kBiasS = kKeys + 8;       // bias row stride, floats
  static constexpr int kK = kTile;               // Q at 0
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBias = kV + kStages * kTile;
  static constexpr int kBar = kBias + kRows * kBiasS * 4;
  // Q, and K and V of each stage, one mbarrier each; 1024 bytes of slack
  // to align the tiles
  static constexpr size_t kSmem = kBar + 8 * (1 + 2 * kStages) + 1024;
};

// D 64: three blocks an SM (at most 168 registers a thread)
template <typename T, int D, bool kDropout>
__global__ void __launch_bounds__(128, D == 64 ? 3 : 2)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const float* __restrict__ bias,
                          T* __restrict__ o, float* __restrict__ lse, int sq,
                          int sk, int bias_ratio, int bias_vec, int causal,
                          float scale, const int* __restrict__ seed,
                          uint32_t threshold, float inv_keep) {
  using L = Sm90FwdTile<D>;
  constexpr int S = L::kStages, BN = L::kKeys, P = D / 64;
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = align1024(smem_raw);
  uint8_t* ks = qs + L::kK;  // [stage][panel][64][128 bytes]
  uint8_t* vs = qs + L::kV;
  float* bs = reinterpret_cast<float*>(qs + L::kBias);  // [64][kBiasS]
  uint64_t* qbar = reinterpret_cast<uint64_t*>(qs + L::kBar);
  uint64_t* kbar = qbar + 1;
  uint64_t* vbar = kbar + S;

  const int tid = threadIdx.x, warp = tid / 32;
  const int g = (tid % 32) / 4, t = tid % 4;
  const int bh = blockIdx.y, m0 = blockIdx.x * L::kRows;
  // causal: the key tiles up to the diagonal
  const int kend = causal ? min(sk, m0 + L::kRows) : sk;
  const int tiles = (kend + BN - 1) / BN;
  const float* bb =
      bias ? bias + static_cast<size_t>(bh / bias_ratio) * sq * sk : nullptr;
  const uint32_t sd = kDropout ? static_cast<uint32_t>(*seed) : 0u;
  const int r0 = m0 + 16 * warp + g;  // this thread's rows: r0, r0 + 8

  auto load_kv = [&](int i) {  // thread 0: key tile i into its stage
    const int st = i % S;
    mbar_expect(kbar + st, L::kTile);
    for (int p = 0; p < P; ++p)
      tma_load(ks + st * L::kTile + p * L::kPanel, &tk, kbar + st, 64 * p,
               BN * i, bh);
    mbar_expect(vbar + st, L::kTile);
    for (int p = 0; p < P; ++p)
      tma_load(vs + st * L::kTile + p * L::kPanel, &tv, vbar + st, 64 * p,
               BN * i, bh);
  };
  // the bias of the block's rows at keys k0 .. k0 + 63, zeros outside
  auto stage_bias = [&](int k0) {
    if (bias_vec) {  // rows 16-byte aligned: 16 chunks of 4 a row
      for (int i = tid; i < L::kRows * 16; i += 128) {
        const int r = i / 16, c = 4 * (i % 16);
        const bool ok = m0 + r < sq && k0 + c < sk;
        cp_async16(bs + r * L::kBiasS + c,
                   bb + (ok ? static_cast<size_t>(m0 + r) * sk + k0 + c : 0),
                   ok);
      }
    } else {
      for (int i = tid; i < L::kRows * BN; i += 128) {
        const int r = i / BN, c = i % BN;
        const bool ok = m0 + r < sq && k0 + c < sk;
        cp_async4(bs + r * L::kBiasS + c,
                  bb + (ok ? static_cast<size_t>(m0 + r) * sk + k0 + c : 0),
                  ok);
      }
    }
    cp_async_commit();
  };

  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int i = 0; i < S; ++i) {
      mbar_init(kbar + i, 1);
      mbar_init(vbar + i, 1);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect(qbar, L::kTile);
    for (int p = 0; p < P; ++p)
      tma_load(qs + p * L::kPanel, &tq, qbar, 64 * p, m0, bh);
    for (int i = 0; i < min(tiles, S); ++i) load_kv(i);
  }
  if (bb) stage_bias(0);

  float acc[D / 2], s[32];
#pragma unroll
  for (int n = 0; n < D / 2; ++n) acc[n] = 0.f;
#pragma unroll
  for (int n = 0; n < 32; ++n) s[n] = 0.f;
  float mrow[2] = {kNegInf, kNegInf}, lrow[2] = {0.f, 0.f};
  mbar_wait(qbar, 0);
  for (int i = 0; i < tiles; ++i) {
    const int st = i % S, k0 = BN * i;
    const uint32_t phase = (i / S) & 1;
    mbar_wait(kbar + st, phase);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {  // s = q . k^T
      const int at = kk / 4 * L::kPanel + kk % 4 * 32;
      wgmma_ss64<T>(s, wg_desc(qs + at, 16, 1024),
                    wg_desc(ks + st * L::kTile + at, 16, 1024), kk > 0);
    }
    wg_commit();
    // the keep mask of the tile, drawn while the product runs
    const uint32_t keep =
        kDropout ? fragment_keep<8>(sd, bh, r0, k0 + 2 * t, threshold) : ~0u;
    if (bb) cp_async_wait<0>();
    __syncthreads();  // the bias tile is in place for every thread
    wg_wait<0>();
    wg_hold(s);

    // scale and bias (one rounding); the masks where the tile reaches
    // past Sk or the diagonal; the max of rows r0 and r0 + 8
    const bool edge = k0 + BN > sk || (causal && k0 + BN - 1 > m0);
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 - m0 + 8 * h, c = 8 * j + 2 * t;
        const float2 b =
            bb ? *reinterpret_cast<const float2*>(bs + r * L::kBiasS + c)
               : make_float2(0.f, 0.f);
        float s0 = fmaf(s[4 * j + 2 * h], scale, b.x);
        float s1 = fmaf(s[4 * j + 2 * h + 1], scale, b.y);
        if (edge) {
          const int row = m0 + r, key = k0 + c;
          if (causal && key > row) s0 = kNegInf;
          if (causal && key + 1 > row) s1 = kNegInf;
          if (key >= sk) s0 = -INFINITY;  // padding past Sk: weight 0
          if (key + 1 >= sk) s1 = -INFINITY;
        }
        s[4 * j + 2 * h] = s0;
        s[4 * j + 2 * h + 1] = s1;
        mt[h] = fmaxf(mt[h], fmaxf(s0, s1));
      }
    if (bb) {
      __syncthreads();  // the bias tile is read: stage the next one
      if (i + 1 < tiles) stage_bias(k0 + BN);
    }
    float alpha[2], mneg[2];
    bool huge[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 1));
      mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 2));
      const float m_new = fmaxf(mrow[h], mt[h]);
      alpha[h] = ex2((mrow[h] - m_new) * kLog2e);
      mrow[h] = m_new;
      lrow[h] *= alpha[h];
      mneg[h] = -m_new * kLog2e;
      huge[h] = m_new < kHugeNeg;
    }
    // p = e^(s - m) as 2^(s log2 e - m log2 e) (a masked row: 2^((s - m)
    // log2 e)), its sum (undropped), and the dropped p rounded to 16 bits
    // as p.v's register operand
#pragma unroll
    for (int n = 0; n < 32; ++n) {
      const int h = (n >> 1) & 1;
      const float p = ex2(huge[h] ? (s[n] - mrow[h]) * kLog2e
                                  : fmaf(s[n], kLog2e, mneg[h]));
      lrow[(n >> 1) & 1] += p;
      s[n] = !kDropout ? p : (keep >> n) & 1u ? p * inv_keep : 0.f;
    }
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pa[kk][e] = pack16<T>(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
#pragma unroll
    for (int n = 0; n < D / 2; ++n) acc[n] *= alpha[(n >> 1) & 1];
    mbar_wait(vbar + st, phase);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // acc += p . v
      wgmma_rs<T, D>(acc, pa[kk],
                     wg_desc(vs + st * L::kTile + 2048 * kk, L::kPanel, 1024));
    }
    wg_commit();
    wg_wait<0>();
    wg_hold(acc);
    __syncthreads();  // every warp's products have read the stage
    if (tid == 0 && i + S < tiles) load_kv(i + S);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lrow[h] += __shfl_xor_sync(0xffffffffu, lrow[h], 1);
    lrow[h] += __shfl_xor_sync(0xffffffffu, lrow[h], 2);
    const int row = r0 + 8 * h;
    if (row >= sq) continue;
    const float denom = fmaxf(lrow[h], 1e-30f);
    T* op = o + (static_cast<size_t>(bh) * sq + row) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store2(op + 8 * j, acc[4 * j + 2 * h] / denom,
             acc[4 * j + 2 * h + 1] / denom);
    if (t == 0)
      lse[static_cast<size_t>(bh) * sq + row] =
          lrow[h] > 0.f ? mrow[h] + logf(denom) : INFINITY;
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
  using L = FwdTile<T, D>;
  static_assert(L::kSmem <= 232448, "forward tiles exceed shared memory");
  auto kernel = flash_fwd_kernel<T, D, kDropout>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::kSmem));
  if (err != cudaSuccess) return err;
  dim3 grid((a.sq + L::kRows - 1) / L::kRows, a.bh);
  kernel<<<grid, L::kThreads, L::kSmem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const float*>(a.bias),
      static_cast<T*>(a.o), static_cast<float*>(a.lse), a.sq, a.sk,
      a.bias_ratio, a.causal, a.scale, a.seed, a.threshold, a.inv_keep);
  return cudaGetLastError();
}

template <typename T, int D, bool kDropout>
cudaError_t launch_sm90(const FwdArgs& a, cudaStream_t stream) {
  using L = Sm90FwdTile<D>;
  static_assert(L::kSmem <= 232448, "forward tiles exceed shared memory");
  CUtensorMap tq, tk, tv;
  cudaError_t err = tile_map<T>(&tq, a.q, a.bh, a.sq, D, 64, 64);
  if (err == cudaSuccess) err = tile_map<T>(&tk, a.k, a.bh, a.sk, D, 64, 64);
  if (err == cudaSuccess) err = tile_map<T>(&tv, a.v, a.bh, a.sk, D, 64, 64);
  if (err != cudaSuccess) return err;
  auto kernel = flash_fwd_sm90_kernel<T, D, kDropout>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(L::kSmem));
  if (err != cudaSuccess) return err;
  const int vec = a.bias && a.sk % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(a.bias) % 16 == 0;
  dim3 grid((a.sq + L::kRows - 1) / L::kRows, a.bh);
  kernel<<<grid, 128, L::kSmem, stream>>>(
      tq, tk, tv, static_cast<const float*>(a.bias), static_cast<T*>(a.o),
      static_cast<float*>(a.lse), a.sq, a.sk, a.bias_ratio, vec, a.causal,
      a.scale, a.seed, a.threshold, a.inv_keep);
  return cudaGetLastError();
}

template <typename T, int D, bool kDropout>
cudaError_t launch_fma(const FwdArgs& a, cudaStream_t stream) {
  using C = FmaTile<D>;
  auto kernel = flash_fwd_fma_kernel<T, D, kDropout>;
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

// float32 takes the mma.sync kernel, bf16 and float16 Hopper's design;
// head dim 256 the FMA kernel in every dtype
template <typename T, bool kDropout>
cudaError_t dispatch_d(int d, const FwdArgs& a, cudaStream_t s) {
  if (d == 256) return launch_fma<T, 256, kDropout>(a, s);
  if (d != 64 && d != 128) return cudaErrorInvalidValue;
  if constexpr (sizeof(T) == 4)
    return d == 64 ? launch<T, 64, kDropout>(a, s)
                   : launch<T, 128, kDropout>(a, s);
  else
    return d == 64 ? launch_sm90<T, 64, kDropout>(a, s)
                   : launch_sm90<T, 128, kDropout>(a, s);
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
  } else if (dtype == PT_F16) {
    err = dispatch<__half>(d, a, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
