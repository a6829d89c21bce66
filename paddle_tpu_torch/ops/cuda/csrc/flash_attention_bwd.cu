// Flash attention backward for Hopper: dk/dv with the score gradient ds,
// then dq = ds.k.
//
// Replaces the TPU kernels paddle_tpu/ops/pallas/flash_attention.py
// _bwd_dkv_kernel (:177) and _bwd_dq_kernel (:133), reached from
// _flash_bwd (pallas_call at :338 and :317).  Same function:
//   s = q.k^T * scale + bias (causal entries -1e30, keys past Sk -inf),
//   p = exp(s - lse), 0 on a row whose lse is +inf (no unmasked key),
//   dp = do.v^T, masked and rescaled by the dropout keep mask,
//   ds = p * (dp - delta), delta = rowsum(do * o) from the caller (a ring
//   route passes delta - dlse), and
//   dq = ds.k * scale,  dk = ds^T.q * scale,  dv = p_dropped^T.do.
// The keep mask is common.cuh's pt_dropout_word of (seed, bh, row, col),
// one Philox-4x32-10 draw for four elements, bit for bit the forward's; the
// additive bias gets no gradient (zero by contract, as on the TPU).
//
// Bound on an H100 SXM at BERT-base's training shape (B32 H12 S128 D64,
// float32).  The TPU kernels' functions: dk/dv four S^2 D products (8 BH
// S^2 D flops), dq three (6 BH S^2 D: it recomputes q.k^T and do.v^T), each
// reading q, k, v, dO, the bias, lse and delta once.  On the float32 FMA
// pipes (67 TFLOP/s) that is 0.048 + 0.036 ms; as 3xTF32 on the tensor
// cores (495 TFLOP/s, three passes a product) 0.0195 + 0.0146 ms of
// operations, under the bytes' 0.0233 + 0.0195 ms at 3.35 TB/s: the bound
// chip_smoke.py holds each kernel to.  This design does the pair's work in
// four products, not seven: dk/dv (8 BH S^2 D) writes ds, 25 MB of float32
// (with it, dk/dv's byte bound is 0.0308 ms), and dq takes one product, ds.k
// (2 BH S^2 D, 0.0049 ms), bound by reading ds (0.0150 ms).  It keeps one of
// dk/dv's four products, q.k^T, on the FMA pipes in float32 (0.012 ms of FMA
// beside 0.0146 ms of tensor-core work; the two pipes run side by side).
// bf16 and float16 run one tensor-core pass a product (989 TFLOP/s). At
// the mixed-precision program's shape (B96 H12 S128 D64 bf16, the padding
// bias) dk/dv's bytes take 0.0360 ms (0.0585 with the float32 ds write,
// which dq reads: this design's own bound), its products 0.0098 ms.
//
// Two designs: float32 (below) on mma.sync, and dk/dv in bf16 / float16
// on Hopper's own machinery (the second part of the file); dq is the
// mma.sync kernel in every dtype.
//
// Design, float32 (and dq in every dtype).
// * The products (but float32's q.k^T, below) run on the tensor cores
//   through mma.sync.aligned.m16n8k8 (.tf32) and m16n8k16 (.bf16, .f16),
//   each thread loading its fragments from shared memory.  Not wgmma: with
//   .tf32 it reads only K-major operands from shared memory (its transpose
//   option exists for 16-bit types only), so three of the five products
//   would need K, dO and Q staged a second time transposed, and p and ds
//   would round-trip through shared memory.
//   With mma.sync the score tiles stay in registers from the product that
//   makes them to the products that use them (an accumulator fragment is an
//   A fragment with its k index permuted), and a thread reads B in any
//   layout, so p^T.dO, ds^T.Q and ds.K need no transposed copies.
// * In float32 the score product q.k^T stays on the FMA pipes: each score is
//   one fmaf chain over the head dim in order from 0, the float32 product
//   the plain version's matmul computes, bit for bit on the H100 (the first
//   port's FMA kernels, which summed the same way, agreed with the plain
//   version to 0.0 at every shape).  BERT's padding bias adds -1e4 to a
//   masked score, where a float32 ulp is 2^-10: summed in any other order,
//   some such scores move by an ulp, their p by 1e-3 of itself, and dq and
//   dk by up to 5e-4 at B32 S128 (on the card, with q.k^T in 3xTF32) -- past
//   the gradient tolerance against the plain version.  That tolerance holds
//   the kernel to the plain version's order of the sum, not to the exact
//   result: against the same backward in float64 (chip_smoke.py's witness)
//   kernel and plain version are both ~3.4e-4 off at B32 S128, the kernel
//   no further than the plain version.  The four other products carry no
//   such cancellation and run on the tensor cores.
// * float32 keeps float32 accuracy with 3xTF32 (CUTLASS's
//   OpMultiplyAddFastF32): a = hi + lo with hi = tf32(a), lo = tf32(a - hi)
//   (cvt.rna: nearest, ties away from zero), a.b ~ lo.hi' + hi.lo' + hi.hi',
//   small terms first, accumulated in float32.  Single-pass TF32 keeps
//   about three decimal digits and misses the gradient tolerance
//   (tests/test_torch_flash_bwd_numerics.py).  dq in 16 bits feeds k to
//   the tensor cores as it is and splits the float32 ds into two halves of
//   the type the same way.
// * One pass over the scores.  dk/dv (a block of 4 warps per 64 keys, 16
//   keys a warp) walks the queries 32 rows at a time with dk and dv in
//   registers (at most 170 a thread at D = 64: three blocks an SM; with 64
//   rows a stage it took 230 and ran 1.2x slower on the card); it
//   computes p, draws the keep mask (one draw per four elements, shared by
//   two lanes), and writes ds to a float32 scratch ds^T[bh][key][query],
//   both padded to 64.
//   dq (a block of 4 warps per 64 queries) is then the product ds.k over the
//   key tiles: it recomputes neither q.k^T and do.v^T (4 of the 6 S^2 D
//   products the first port's dq kernel did) nor the mask.
// * The loop body stays small enough for the instruction cache: the mask is
//   drawn four independent generator chains at a time, and the loops that
//   index only shared memory are unrolled twice, not
//   fully.  Fully unrolled (32 inlined Philox chains a tile), the float32
//   dk/dv kernel took 0.264 ms at B32 H12 S128; per-phase clock64() counts
//   showed the elementwise step, not the products, taking the time.  A
//   tile's bias loads are all issued before the first is used.
// * Copies overlap products: the streamed tiles (Q, dO and their rows' lse
//   and delta in dk/dv; K and ds in dq) are double-buffered in shared
//   memory with cp.async, so the next tile's copy flies while this tile's
//   products run.  Row strides are padded so that every fragment load is
//   free of bank conflicts.
// * Every sum runs in a fixed order with no atomics: each block owns its
//   output rows, so dq, dk and dv are bit-identical across launches.
// * Memory: the ds^T scratch is 4 BH round64(Sk) round64(Sq) bytes (25.2 MB
//   at B32 H12 S128, 101 MB at B8 H12 S512), O(S^2) where the kernels
//   below need O(S).  The caller caps it (flash_attention.py bwd_plan,
//   DS_SCRATCH_CAP = 1 GiB): a problem whose scratch would exceed the cap
//   takes the FMA route.
// * The FMA route (the last part of this file) is the first port's pair
//   on the float32 FMA pipes, each kernel recomputing the scores and the
//   mask, with no scratch.  It takes head dim 256 (a warp's dk and dv rows,
//   2 x 16 x 256 floats, do not fit in its registers beside the score
//   tiles) and any problem past the scratch cap, in every dtype; a NULL ds
//   selects it.
//
// Design, dk/dv in bf16 and float16 (head dims 64 and 128;
// flash_bwd_dkv_sm90_kernel, hopper.cuh).  With 16-bit operands wgmma
// reads either operand transposed, which is what kept the float32 design
// on mma.sync.
// * A block is one warpgroup and 64 keys, keys as the products' rows.  K
//   and V arrive once by TMA; Q and dO in 32-row tiles through a ring of
//   two stages (3-D tensor maps, rows past Sq read as zeros), completing on
//   mbarriers; each tile's bias (32 rows by 64 keys), lse and delta by
//   cp.async, lse +inf on rows past Sq so their p is 0.
// * s^T = k.q^T and dp^T = v.do^T are wgmma m64n32k16 on the swizzled
//   tiles; dv += p_dropped^T.do and dk += ds^T.q are wgmma m64nDk16 with
//   p and ds as register operands, rounded to 16 bits once, and dO and Q
//   read through wgmma's transposed operand from the same tiles that fed
//   the scores.  One rounding keeps dk and dv within 0.41 of the 16-bit
//   tolerance in a CPU emulation at S 128 and 512 (the split took two
//   passes a product).
// * ds^T is written to shared memory in TMA's 128-byte swizzle and leaves
//   by TMA stores (boxes of 32 queries by 64 keys) into the float32 scratch
//   in the layout dq reads: whole lines, where a thread's scattered 8-byte
//   stores wrote it before.
// * The mask is the float32 design's transposed draw (one shuffle a
//   tile), taken while the score products run; exp is 2^(s log2 e -
//   lse log2 e).
// * 32-row query tiles: 49 KB of shared memory and at most 168 registers
//   at D 64, three blocks an SM.  Measured on an H100 at B96 H12 S128
//   (tools/torch_kernel_ab.py, against 0.096-0.097 ms): 64-row tiles (234
//   registers, two blocks an SM) 0.105-0.109; four blocks an SM (128
//   registers) 0.112; three stages 0.097; each tile's dk/dv products left
//   in flight into the next tile (three stages, two buffers of rows, one
//   barrier fewer) 0.102.
#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

struct BwdArgs {
  const void *q, *k, *v, *bias, *dout, *lse, *delta;
  void *dq, *dk, *dv;
  float* ds;  // ds^T scratch [bh][round64(sk)][round64(sq)] (tensor cores)
  int bh, sq, sk, bias_ratio, causal;
  float scale;
  const int* seed;
  uint32_t threshold;
  float inv_keep;
};

__host__ __device__ constexpr int round64(int n) { return (n + 63) / 64 * 64; }

// acc[n] += ds[16 queries][0:64] . k[0:64][8n:8n + 8]: ds^T[key][query]
// (the warp's first query at column 0, rows SD apart) and k[key][d] (rows
// SK apart) in shared memory
template <int D, int SD, int SK>
__device__ __forceinline__ void dq_tile(float (&acc)[D / 8][4],
                                        const float* ds, const float* k,
                                        int g, int t) {
#pragma unroll
  for (int kk = 0; kk < kBlockN; kk += 8) {
    const float* a = ds + (kk + t) * SD + g;
    uint32_t ahi[4], alo[4];
    split_tf32(a[0], ahi[0], alo[0]);
    split_tf32(a[8], ahi[1], alo[1]);
    split_tf32(a[4 * SD], ahi[2], alo[2]);
    split_tf32(a[4 * SD + 8], ahi[3], alo[3]);
    const float* br = k + (kk + t) * SK + g;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      uint32_t bhi[2], blo[2];
      split_tf32(br[8 * n], bhi[0], blo[0]);
      split_tf32(br[4 * SK + 8 * n], bhi[1], blo[1]);
      mma_3xtf32(acc[n], ahi, alo, bhi, blo);
    }
  }
}

// bf16 and float16: ds split into two 16-bit halves
template <int D, int SD, int SK, typename T,
          typename = std::enable_if_t<sizeof(T) == 2>>
__device__ __forceinline__ void dq_tile(float (&acc)[D / 8][4],
                                        const float* ds, const T* k, int g,
                                        int t) {
#pragma unroll
  for (int kk = 0; kk < kBlockN; kk += 16) {
    const float* a = ds + (kk + 2 * t) * SD + g;
    uint32_t ahi[4], alo[4];
    split16<T>(a[0], a[SD], ahi[0], alo[0]);
    split16<T>(a[8], a[SD + 8], ahi[1], alo[1]);
    split16<T>(a[8 * SD], a[9 * SD], ahi[2], alo[2]);
    split16<T>(a[8 * SD + 8], a[9 * SD + 8], ahi[3], alo[3]);
    const T* br = k + (kk + 2 * t) * SK + g;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const uint32_t bf[2] = {ld_pair(br + 8 * n, SK),
                              ld_pair(br + 8 * SK + 8 * n, SK)};
      mma16<T>(acc[n], alo, bf);
      mma16<T>(acc[n], ahi, bf);
    }
  }
}

// ---------------------------------------------------------------------------
// dk/dv and ds
// ---------------------------------------------------------------------------

// K, V resident; Q, dO and their rows' lse and delta in two stages.  Row
// strides of 4 words mod 32 keep the fragment loads conflict-free.
template <typename T, int D, int BM>
struct DkvTile {
  static constexpr int kS = D + (sizeof(T) == 4 ? 4 : 8);
  static constexpr size_t kSmem =
      (2 * kBlockN + 4 * BM) * kS * sizeof(T) + 4 * BM * sizeof(float);
};

// D 64: three blocks an SM (at most 170 registers a thread, no spills)
template <typename T, int D, int BM>
__global__ void __launch_bounds__(kMmaThreads, D == 64 ? 3 : 1)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const float* __restrict__ bias,
                         const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv,
                         float* __restrict__ ds, int sq, int sk,
                         int bias_ratio, int causal, float scale,
                         const int* __restrict__ seed, uint32_t threshold,
                         float inv_keep) {
  using L = DkvTile<T, D, BM>;
  static_assert(BM % 16 == 0, "the mask pairs query tiles 2i and 2i + 1");
  constexpr int S = L::kS;
  constexpr int NT = BM / 8;  // 8-query tiles of a warp's scores
  constexpr int DT = D / 8;   // 8-column tiles of its dk and dv rows
  extern __shared__ float4 smem4[];
  T* ks = reinterpret_cast<T*>(smem4);  // [kBlockN][S]
  T* vs = ks + kBlockN * S;             // [kBlockN][S]
  T* qs = vs + kBlockN * S;             // [2][BM][S]
  T* dos = qs + 2 * BM * S;             // [2][BM][S]
  float* lses = reinterpret_cast<float*>(dos + 2 * BM * S);  // [2][BM]
  float* deltas = lses + 2 * BM;                             // [2][BM]

  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int bh = blockIdx.y, n0 = blockIdx.x * kBlockN;
  const int sqp = round64(sq);
  const size_t qoff = static_cast<size_t>(bh) * sq;
  const size_t koff = static_cast<size_t>(bh) * sk;
  const T* qb = q + qoff * D;
  const T* db = dout + qoff * D;
  const float* bb =
      bias ? bias + static_cast<size_t>(bh / bias_ratio) * sq * sk : nullptr;
  // this block's 64 rows of ds^T
  float* dsb =
      ds + (static_cast<size_t>(bh) * round64(sk) + n0 + 16 * warp) * sqp;
  const uint32_t sd = seed ? static_cast<uint32_t>(*seed) : 0u;

  auto stage_rows = [&](int buf, int m0) {
    copy_tile<T, D, BM, S>(qs + buf * BM * S, qb, D, m0, sq);
    copy_tile<T, D, BM, S>(dos + buf * BM * S, db, D, m0, sq);
    for (int i = threadIdx.x; i < BM; i += kMmaThreads) {
      const bool ok = m0 + i < sq;
      const size_t r = qoff + (ok ? m0 + i : 0);
      cp_async4(lses + buf * BM + i, lse + r, ok);
      cp_async4(deltas + buf * BM + i, delta + r, ok);
    }
  };
  copy_tile<T, D, kBlockN, S>(ks, k + koff * D, D, n0, sk);
  copy_tile<T, D, kBlockN, S>(vs, v + koff * D, D, n0, sk);
  // causal: query rows below the tile's first key see none of its keys
  const int qstart = causal ? n0 : 0;
  stage_rows(0, qstart);
  cp_async_commit();

  float dk_acc[DT][4], dv_acc[DT][4];
  zero(dk_acc);
  zero(dv_acc);
  const T* kw = ks + 16 * warp * S;
  const T* vw = vs + 16 * warp * S;
  int buf = 0;
  for (int m0 = qstart; m0 < sqp; m0 += BM, buf ^= 1) {
    if (m0 + BM < sqp) stage_rows(buf ^ 1, m0 + BM);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* qt = qs + buf * BM * S;
    const T* dt = dos + buf * BM * S;
    const float* lt = lses + buf * BM;
    const float* et = deltas + buf * BM;

    // the warp's 16 keys against the tile's queries: s = k.q^T, dp = v.do^T
    float s[NT][4], dp[NT][4];
    zero(s);
    zero(dp);
    if constexpr (sizeof(T) == 4)
      score_tile_fma<D, NT, S>(s, kw, qt, g, t);
    else
      score_tile<D, NT, S>(s, kw, qt, g, t);
    score_tile<D, NT, S>(dp, vw, dt, g, t);

    // p from the scores (s becomes p)
    float bv[NT][4];  // the bias loads of the tile, all in flight at once
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = m0 + 8 * j + 2 * t + (c & 1);
        const int key = n0 + 16 * warp + g + 8 * (c >> 1);
        bv[j][c] = bb && row < sq && key < sk
                       ? bb[static_cast<size_t>(row) * sk + key]
                       : 0.f;
      }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = 8 * j + 2 * t + (c & 1), row = m0 + col;
        const int key = n0 + 16 * warp + g + 8 * (c >> 1);
        float sv = s[j][c] * scale + bv[j][c];
        if (causal && key > row) sv = kNegInf;
        if (key >= sk) sv = -INFINITY;
        s[j][c] = row < sq ? expf(sv - lt[col]) : 0.f;
      }
    // the keep mask (common.cuh pt_dropout_word): the draw of counter
    // (key >> 1, query) serves keys g and g ^ 1 -- this lane and the lane
    // four apart -- at queries q and q + 8 (tiles 2i and 2i + 1, q's bit 3
    // clear).  Each lane draws the counters of its own query parity g & 1
    // (NT draws a stage, four generator chains at a time), keeps two words
    // of each and hands the other two to its partner as bits: one shuffle
    // a stage, a quarter of one draw per element
    uint32_t keep = ~0u;
    if (seed) {
      const int par = g & 1;
      uint32_t mine = 0, theirs = 0;
#pragma unroll 4
      for (int i = 0; i < NT; ++i) {
        const int h = i & 1, jp = i >> 1;
        const int key = n0 + 16 * warp + g + 8 * h;
        const uint32_t w = keep_bits(
            pt_philox(sd, static_cast<uint32_t>(key) >> 1,
                      static_cast<uint32_t>(m0 + 16 * jp + 2 * t + par),
                      static_cast<uint32_t>(bh)),
            threshold);
        const int at = 8 * jp + par + 2 * h;  // element (2jp, par + 2h)
        mine |= ((w >> par) & 1u) << at | ((w >> (2 + par)) & 1u) << (at + 4);
        theirs |= ((w >> (1 - par)) & 1u) << at |
                  ((w >> (3 - par)) & 1u) << (at + 4);
      }
      keep = mine | __shfl_xor_sync(0xffffffffu, theirs, 4);
    }
    // s becomes p_dropped and dp becomes ds, which goes to memory for dq
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = s[j][c];
        const float mult = !seed ? 1.f
                           : (keep >> (4 * j + c)) & 1u ? inv_keep : 0.f;
        s[j][c] = p * mult;
        dp[j][c] = p * (dp[j][c] * mult - et[8 * j + 2 * t + (c & 1)]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store2(dsb + static_cast<size_t>(g + 8 * h) * sqp + m0 + 8 * j +
                   2 * t,
               dp[j][2 * h], dp[j][2 * h + 1]);
    }
    acc_tile<D, NT, S>(dv_acc, s, dt, g, t);   // dv += p_dropped^T . do
    acc_tile<D, NT, S>(dk_acc, dp, qt, g, t);  // dk += ds^T . q
    __syncthreads();  // the stage is read before the next copy into it
  }

#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = n0 + 16 * warp + g + 8 * h;
      if (key >= sk) continue;
      const size_t at = (koff + key) * D + 8 * n + 2 * t;
      store2(dk + at, dk_acc[n][2 * h] * scale, dk_acc[n][2 * h + 1] * scale);
      store2(dv + at, dv_acc[n][2 * h], dv_acc[n][2 * h + 1]);
    }
}

// ---------------------------------------------------------------------------
// dq = ds.k * scale
// ---------------------------------------------------------------------------

// K and ds^T tiles in two stages; strides of 8 words mod 32 (K, float32
// ds) or 4 (bf16 K rows in words; ds read two rows at a time for bf16)
template <typename T, int D>
struct DqTile {
  static constexpr int kSK = D + 8;
  static constexpr int kSD = kBlockM + (sizeof(T) == 4 ? 8 : 4);
  static constexpr size_t kSmem =
      2 * (kBlockN * kSK * sizeof(T) + kBlockN * kSD * sizeof(float));
};

// D 64: three blocks an SM; D 128 may take the registers it needs (capped
// at 128 without the bound, it spilled)
template <typename T, int D>
__global__ void __launch_bounds__(kMmaThreads, D == 64 ? 3 : 1)
    flash_bwd_dq_kernel(const T* __restrict__ k,
                        const float* __restrict__ ds, T* __restrict__ dq,
                        int sq, int sk, int causal, float scale) {
  using L = DqTile<T, D>;
  constexpr int SK = L::kSK, SD = L::kSD, DT = D / 8;
  extern __shared__ float4 smem4[];
  T* ks = reinterpret_cast<T*>(smem4);  // [2][kBlockN][SK]
  // [2][kBlockN][SD]
  float* dss = reinterpret_cast<float*>(ks + 2 * kBlockN * SK);

  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int bh = blockIdx.y, m0 = blockIdx.x * kBlockM;
  const int sqp = round64(sq), skp = round64(sk);
  const T* kb = k + static_cast<size_t>(bh) * sk * D;
  // column m0 of this bh's ds^T
  const float* dsb = ds + static_cast<size_t>(bh) * skp * sqp + m0;
  // causal: the key tiles up to the diagonal
  const int kend = causal ? min(sk, m0 + kBlockM) : sk;
  const int tiles = (kend + kBlockN - 1) / kBlockN;

  auto stage_keys = [&](int buf, int k0) {
    copy_tile<T, D, kBlockN, SK>(ks + buf * kBlockN * SK, kb, D, k0, sk);
    copy_tile<float, kBlockM, kBlockN, SD>(dss + buf * kBlockN * SD, dsb,
                                           sqp, k0, skp);
  };
  stage_keys(0, 0);
  cp_async_commit();
  float acc[DT][4];
  zero(acc);
  for (int i = 0; i < tiles; ++i) {
    if (i + 1 < tiles) stage_keys((i + 1) & 1, (i + 1) * kBlockN);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    dq_tile<D, SD, SK>(acc, dss + (i & 1) * kBlockN * SD + 16 * warp,
                       ks + (i & 1) * kBlockN * SK, g, t);
    __syncthreads();  // the stage is read before the next copy into it
  }
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + 16 * warp + g + 8 * h;
      if (row >= sq) continue;
      store2(dq + (static_cast<size_t>(bh) * sq + row) * D + 8 * n + 2 * t,
             acc[n][2 * h] * scale, acc[n][2 * h + 1] * scale);
    }
}

// ---------------------------------------------------------------------------
// dk/dv and ds in bf16 and float16, head dims 64 and 128: Hopper's design
// (the source note's second part).  A block is one warpgroup and 64 keys;
// K and V arrive once by TMA, Q and dO in a ring of 32-row stages, their
// rows' bias, lse and delta by cp.async; the four products run on wgmma and
// ds^T leaves through shared memory by TMA stores.
// ---------------------------------------------------------------------------

template <int D>
struct Sm90DkvTile {
  static constexpr int kQRows = 32;  // query rows a stage
  static constexpr int kStages = 2;
  static constexpr int kKPanel = 64 * 128;      // 64 key rows of 128 bytes
  static constexpr int kQPanel = kQRows * 128;  // the query rows' panel
  static constexpr int kKTile = D / 64 * kKPanel;
  static constexpr int kQTile = D / 64 * kQPanel;
  static constexpr int kBiasS = 64 + 4;  // bias row stride, floats
  static constexpr int kV = kKTile;      // K at 0
  static constexpr int kQ = kV + kKTile;
  static constexpr int kDo = kQ + kStages * kQTile;
  static constexpr int kDs = kDo + kStages * kQTile;  // a 64 x 32 box
  static constexpr int kBias = kDs + 8192;
  static constexpr int kStats = kBias + kQRows * kBiasS * 4;  // lse, delta
  static constexpr int kBar = kStats + 2 * kQRows * 4;
  // K and V, and Q and dO of each stage, one mbarrier each; 1024 bytes of
  // slack to align the tiles
  static constexpr size_t kSmem = kBar + 8 * (1 + 2 * kStages) + 1024;
};

// D 64: three blocks an SM (at most 168 registers a thread)
template <typename T, int D>
__global__ void __launch_bounds__(128, D == 64 ? 3 : 2)
    flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tdo,
                              const __grid_constant__ CUtensorMap tds,
                              const float* __restrict__ bias,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              T* __restrict__ dk, T* __restrict__ dv, int sq,
                              int sk, int bias_ratio, int bias_vec,
                              int causal, float scale,
                              const int* __restrict__ seed,
                              uint32_t threshold, float inv_keep) {
  using L = Sm90DkvTile<D>;
  constexpr int S = L::kStages, P = D / 64, BM = L::kQRows, NT = BM / 8;
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ks = align1024(smem_raw);
  uint8_t* vs = ks + L::kV;
  uint8_t* qs = ks + L::kQ;    // [stage][panel][BM][128 bytes]
  uint8_t* dos = ks + L::kDo;  // the same for dO
  // ds^T: [64 keys][32 queries], TMA's 128-byte swizzle
  float* dss = reinterpret_cast<float*>(ks + L::kDs);
  float* bs = reinterpret_cast<float*>(ks + L::kBias);  // [BM][kBiasS]
  float* lses = reinterpret_cast<float*>(ks + L::kStats);  // [BM]
  float* deltas = lses + BM;
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(ks + L::kBar);
  uint64_t* qbar = kvbar + 1;
  uint64_t* dobar = qbar + S;

  const int tid = threadIdx.x, warp = tid / 32;
  const int g = (tid % 32) / 4, t = tid % 4;
  const int bh = blockIdx.y, n0 = blockIdx.x * 64;
  const size_t qoff = static_cast<size_t>(bh) * sq;
  const size_t koff = static_cast<size_t>(bh) * sk;
  const float* bb =
      bias ? bias + static_cast<size_t>(bh / bias_ratio) * sq * sk : nullptr;
  const uint32_t sd = seed ? static_cast<uint32_t>(*seed) : 0u;
  // causal: query rows below the block's first key see none of its keys
  const int qstart = causal ? n0 : 0;
  const int tiles = (round64(sq) - qstart) / BM;
  const int kr = 16 * warp + g;  // this thread's keys: n0 + kr, + 8

  auto load_rows = [&](int i) {  // thread 0: query tile i into its stage
    const int st = i % S, m0 = qstart + BM * i;
    mbar_expect(qbar + st, L::kQTile);
    for (int p = 0; p < P; ++p)
      tma_load(qs + st * L::kQTile + p * L::kQPanel, &tq, qbar + st, 64 * p,
               m0, bh);
    mbar_expect(dobar + st, L::kQTile);
    for (int p = 0; p < P; ++p)
      tma_load(dos + st * L::kQTile + p * L::kQPanel, &tdo, dobar + st,
               64 * p, m0, bh);
  };
  // the bias, lse and delta of query rows m0 .. m0 + BM - 1 (rows past Sq:
  // lse +inf, so their p is 0)
  auto stage_rows = [&](int m0) {
    if (bb && bias_vec) {  // rows 16-byte aligned: 16 chunks of 4 a row
      for (int i = tid; i < BM * 16; i += 128) {
        const int r = i / 16, c = 4 * (i % 16);
        const bool ok = m0 + r < sq && n0 + c < sk;
        cp_async16(bs + r * L::kBiasS + c,
                   bb + (ok ? static_cast<size_t>(m0 + r) * sk + n0 + c : 0),
                   ok);
      }
    } else if (bb) {
      for (int i = tid; i < BM * 64; i += 128) {
        const int r = i / 64, c = i % 64;
        const bool ok = m0 + r < sq && n0 + c < sk;
        cp_async4(bs + r * L::kBiasS + c,
                  bb + (ok ? static_cast<size_t>(m0 + r) * sk + n0 + c : 0),
                  ok);
      }
    }
    for (int i = tid; i < BM; i += 128) {
      if (m0 + i < sq) {
        cp_async4(lses + i, lse + qoff + m0 + i, true);
        cp_async4(deltas + i, delta + qoff + m0 + i, true);
      } else {
        lses[i] = INFINITY;
        deltas[i] = 0.f;
      }
    }
    cp_async_commit();
  };

  if (tid == 0) {
    mbar_init(kvbar, 1);
    for (int i = 0; i < S; ++i) {
      mbar_init(qbar + i, 1);
      mbar_init(dobar + i, 1);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect(kvbar, 2 * L::kKTile);
    for (int p = 0; p < P; ++p) {
      tma_load(ks + p * L::kKPanel, &tk, kvbar, 64 * p, n0, bh);
      tma_load(vs + p * L::kKPanel, &tv, kvbar, 64 * p, n0, bh);
    }
    for (int i = 0; i < min(tiles, S); ++i) load_rows(i);
  }
  stage_rows(qstart);

  float dk_acc[D / 2], dv_acc[D / 2], s[BM / 2], dp[BM / 2];
#pragma unroll
  for (int n = 0; n < D / 2; ++n) dk_acc[n] = dv_acc[n] = 0.f;
#pragma unroll
  for (int n = 0; n < BM / 2; ++n) s[n] = dp[n] = 0.f;
  mbar_wait(kvbar, 0);
  for (int i = 0; i < tiles; ++i) {
    const int st = i % S, m0 = qstart + BM * i;
    const uint32_t phase = (i / S) & 1;
    const uint8_t* qt = qs + st * L::kQTile;
    const uint8_t* dt = dos + st * L::kQTile;
    // the block's 64 keys against the tile's queries: s = k.q^T and
    // dp = v.do^T, keys as rows
    mbar_wait(qbar + st, phase);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss32<T>(s, wg_desc(ks + kk / 4 * L::kKPanel + kk % 4 * 32, 16,
                                 1024),
                      wg_desc(qt + kk / 4 * L::kQPanel + kk % 4 * 32, 16, 1024),
                      kk > 0);
    wg_commit();
    mbar_wait(dobar + st, phase);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss32<T>(dp, wg_desc(vs + kk / 4 * L::kKPanel + kk % 4 * 32, 16,
                                  1024),
                      wg_desc(dt + kk / 4 * L::kQPanel + kk % 4 * 32, 16, 1024),
                      kk > 0);
    wg_commit();
    // the keep mask (common.cuh pt_dropout_word), drawn while the products
    // run: the draw of counter (key >> 1, query) serves keys g and g ^ 1 --
    // this lane and the lane four apart -- at queries q and q + 8 (columns
    // 2i and 2i + 1 of 8, q's bit 3 clear).  Each lane draws the counters
    // of its own query parity g & 1, keeps two words of each and hands the
    // other two to its partner as bits: one shuffle a tile, a quarter of a
    // draw an element
    uint32_t keep = ~0u;
    if (seed) {
      const int par = g & 1;
      uint32_t mine = 0, theirs = 0;
#pragma unroll 4
      for (int u = 0; u < NT; ++u) {
        const int h = u & 1, jp = u >> 1;
        const int key = n0 + kr + 8 * h;
        const uint32_t w = keep_bits(
            pt_philox(sd, static_cast<uint32_t>(key) >> 1,
                      static_cast<uint32_t>(m0 + 16 * jp + 2 * t + par),
                      static_cast<uint32_t>(bh)),
            threshold);
        const int at = 8 * jp + par + 2 * h;  // element (2jp, par + 2h)
        mine |= ((w >> par) & 1u) << at | ((w >> (2 + par)) & 1u) << (at + 4);
        theirs |= ((w >> (1 - par)) & 1u) << at |
                  ((w >> (3 - par)) & 1u) << (at + 4);
      }
      keep = mine | __shfl_xor_sync(0xffffffffu, theirs, 4);
    }
    cp_async_wait<0>();
    __syncthreads();  // the tile's bias, lse and delta are in place
    wg_wait<1>();
    wg_hold(s);

    // p = e^(s - lse) as 2^(s log2 e - lse log2 e): s becomes p
    const bool edge = n0 + 64 > sk;
    const bool diagonal = causal && n0 + 63 > m0;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = 8 * j + 2 * t + (c & 1), key = kr + 8 * (c >> 1);
        float sv = bb ? fmaf(s[4 * j + c], scale, bs[col * L::kBiasS + key])
                      : s[4 * j + c] * scale;
        if (diagonal && n0 + key > m0 + col) sv = kNegInf;
        if (edge && n0 + key >= sk) sv = -INFINITY;
        s[4 * j + c] = ex2(fmaf(sv, kLog2e, -lses[col] * kLog2e));
      }
    wg_wait<0>();
    wg_hold(dp);
    // s becomes p_dropped and dp becomes ds = p (dp_dropped - delta)
#pragma unroll
    for (int n = 0; n < BM / 2; ++n) {
      const float mult = !seed ? 1.f : (keep >> n) & 1u ? inv_keep : 0.f;
      const float p = s[n];
      s[n] = p * mult;
      dp[n] = p * (dp[n] * mult - deltas[8 * (n / 4) + 2 * t + (n & 1)]);
    }
    if (tid == 0) bulk_wait_read();  // the last ds tile has left
    __syncthreads();  // ... and every thread read this tile's rows
    if (i + 1 < tiles) stage_rows(m0 + BM);
    // ds^T into shared memory: key row r, query q at chunk (q / 4) ^
    // (r % 8) of its 128-byte row
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = kr + 8 * h, q = 8 * j + 2 * t;
        *reinterpret_cast<float2*>(dss + r * 32 + ((q / 4) ^ (r % 8)) * 4 +
                                   q % 4) =
            make_float2(dp[4 * j + 2 * h], dp[4 * j + 2 * h + 1]);
      }
    fence_async_smem();
    uint32_t pa[BM / 16][4], da[BM / 16][4];
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pa[kk][e] = pack16<T>(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
        da[kk][e] = pack16<T>(dp[8 * kk + 2 * e], dp[8 * kk + 2 * e + 1]);
      }
    // dv += p_dropped^T . do, dk += ds^T . q
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk)
      wgmma_rs<T, D>(dv_acc, pa[kk],
                     wg_desc(dt + 2048 * kk, L::kQPanel, 1024));
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk)
      wgmma_rs<T, D>(dk_acc, da[kk],
                     wg_desc(qt + 2048 * kk, L::kQPanel, 1024));
    wg_commit();
    wg_wait<0>();
    wg_hold(dk_acc);
    wg_hold(dv_acc);
    __syncthreads();  // ds^T is in shared memory; the stage is read
    if (tid == 0) {
      tma_store(&tds, dss, m0, n0, bh);
      bulk_commit();
      if (i + S < tiles) load_rows(i + S);
    }
  }
  if (tid == 0) bulk_wait();

#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = n0 + kr + 8 * h;
      if (key >= sk) continue;
      const size_t at = (koff + key) * D + 8 * j + 2 * t;
      store2(dk + at, dk_acc[4 * j + 2 * h] * scale,
             dk_acc[4 * j + 2 * h + 1] * scale);
      store2(dv + at, dv_acc[4 * j + 2 * h], dv_acc[4 * j + 2 * h + 1]);
    }
}

template <typename T, int D, int BM>
cudaError_t launch_dkv(const BwdArgs& a, cudaStream_t stream) {
  using L = DkvTile<T, D, BM>;
  static_assert(L::kSmem <= 232448, "dk/dv tiles exceed shared memory");
  auto kernel = flash_bwd_dkv_kernel<T, D, BM>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::kSmem));
  if (err != cudaSuccess) return err;
  dim3 grid(round64(a.sk) / kBlockN, a.bh);
  kernel<<<grid, kMmaThreads, L::kSmem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const float*>(a.bias),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.ds, a.sq, a.sk, a.bias_ratio, a.causal,
      a.scale, a.seed, a.threshold, a.inv_keep);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv_sm90(const BwdArgs& a, cudaStream_t stream) {
  using L = Sm90DkvTile<D>;
  static_assert(L::kSmem <= 232448, "dk/dv tiles exceed shared memory");
  CUtensorMap tq, tk, tv, tdo, tds;
  cudaError_t err = tile_map<T>(&tq, a.q, a.bh, a.sq, D, L::kQRows, 64);
  if (err == cudaSuccess) err = tile_map<T>(&tk, a.k, a.bh, a.sk, D, 64, 64);
  if (err == cudaSuccess) err = tile_map<T>(&tv, a.v, a.bh, a.sk, D, 64, 64);
  if (err == cudaSuccess)
    err = tile_map<T>(&tdo, a.dout, a.bh, a.sq, D, L::kQRows, 64);
  if (err == cudaSuccess)
    err = tile_map<float>(&tds, a.ds, a.bh, round64(a.sk), round64(a.sq), 64,
                          32);
  if (err != cudaSuccess) return err;
  auto kernel = flash_bwd_dkv_sm90_kernel<T, D>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(L::kSmem));
  if (err != cudaSuccess) return err;
  const int vec = a.bias && a.sk % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(a.bias) % 16 == 0;
  dim3 grid(round64(a.sk) / 64, a.bh);
  kernel<<<grid, 128, L::kSmem, stream>>>(
      tq, tk, tv, tdo, tds, static_cast<const float*>(a.bias),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.sq, a.sk, a.bias_ratio,
      vec, a.causal, a.scale, a.seed, a.threshold, a.inv_keep);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const BwdArgs& a, cudaStream_t stream) {
  using L = DqTile<T, D>;
  static_assert(L::kSmem <= 232448, "dq tiles exceed shared memory");
  auto kernel = flash_bwd_dq_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::kSmem));
  if (err != cudaSuccess) return err;
  dim3 grid(round64(a.sq) / kBlockM, a.bh);
  kernel<<<grid, kMmaThreads, L::kSmem, stream>>>(
      static_cast<const T*>(a.k), a.ds, static_cast<T*>(a.dq), a.sq, a.sk,
      a.causal, a.scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// head dim 256: the first port's kernels on the float32 FMA pipes, both
// recomputing the scores and the mask, 256 threads as a 16 x 16 grid over
// 64 x 64 score tiles (flash_common.cuh)
// ---------------------------------------------------------------------------

template <int D>
struct FmaTile {
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


// D 64: two blocks an SM (128 registers a thread; dk/dv spills 4 bytes
// there, and with 168 registers at one block an SM the pair ran slower);
// D 128 and 256 take the registers they need
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, D == 64 ? 2 : 1)
    flash_bwd_dq_fma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const float* __restrict__ bias,
                        const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int sq, int sk, int bias_ratio, int causal,
                        float scale, const int* __restrict__ seed,
                        uint32_t threshold, float inv_keep) {
  using C = FmaTile<D>;
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
__global__ void __launch_bounds__(kThreads, D == 64 ? 2 : 1)
    flash_bwd_dkv_fma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const float* __restrict__ bias,
                         const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv, int sq,
                         int sk, int bias_ratio, int causal, float scale,
                         const int* __restrict__ seed, uint32_t threshold,
                         float inv_keep) {
  using C = FmaTile<D>;
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
cudaError_t launch_dq_fma(const BwdArgs& a, cudaStream_t stream) {
  using C = FmaTile<D>;
  auto kernel = flash_bwd_dq_fma_kernel<T, D>;
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
cudaError_t launch_dkv_fma(const BwdArgs& a, cudaStream_t stream) {
  using C = FmaTile<D>;
  auto kernel = flash_bwd_dkv_fma_kernel<T, D>;
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

// dk/dv: the tensor-core kernel where the caller gives a ds scratch (float32
// the mma.sync kernel, bf16 and float16 Hopper's design), else the FMA
// kernel (head dim 256 has only the FMA route)
template <typename T>
cudaError_t dispatch_dkv(int d, const BwdArgs& a, cudaStream_t s) {
  if (d == 256)
    return a.ds ? cudaErrorInvalidValue : launch_dkv_fma<T, 256>(a, s);
  if (d != 64 && d != 128) return cudaErrorInvalidValue;
  if (!a.ds)
    return d == 64 ? launch_dkv_fma<T, 64>(a, s)
                   : launch_dkv_fma<T, 128>(a, s);
  if constexpr (sizeof(T) == 4)
    return d == 64 ? launch_dkv<T, 64, 32>(a, s)
                   : launch_dkv<T, 128, 32>(a, s);
  else
    return d == 64 ? launch_dkv_sm90<T, 64>(a, s)
                   : launch_dkv_sm90<T, 128>(a, s);
}

// dq: from ds on the tensor-core route, from the inputs on the FMA route
template <typename T>
cudaError_t dispatch_dq(bool from_ds, int d, const BwdArgs& a,
                        cudaStream_t s) {
  switch (d) {
    case 64:
      return from_ds ? launch_dq<T, 64>(a, s) : launch_dq_fma<T, 64>(a, s);
    case 128:
      return from_ds ? launch_dq<T, 128>(a, s) : launch_dq_fma<T, 128>(a, s);
    case 256:
      return from_ds ? cudaErrorInvalidValue : launch_dq_fma<T, 256>(a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

enum class Kernel { kDkv, kDqFma, kDqDs };

int run(Kernel which, int dtype, int d, const BwdArgs& a, void* stream) {
  if (a.bh < 1 || a.bh > 65535 || a.sq < 1 || a.sk < 1 ||
      a.bias_ratio < 1 || a.bh % a.bias_ratio != 0 ||
      (a.causal && a.sq != a.sk) || (which == Kernel::kDqDs && !a.ds))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == PT_F32) {
    err = which == Kernel::kDkv
              ? dispatch_dkv<float>(d, a, s)
              : dispatch_dq<float>(which == Kernel::kDqDs, d, a, s);
  } else if (dtype == PT_BF16) {
    err = which == Kernel::kDkv
              ? dispatch_dkv<__nv_bfloat16>(d, a, s)
              : dispatch_dq<__nv_bfloat16>(which == Kernel::kDqDs, d, a, s);
  } else if (dtype == PT_F16) {
    err = which == Kernel::kDkv
              ? dispatch_dkv<__half>(d, a, s)
              : dispatch_dq<__half>(which == Kernel::kDqDs, d, a, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

// dk, dv[bh, sk, d] from q[bh, sq, d], k/v[bh, sk, d], the optional float32
// bias[bh / bias_ratio, sq, sk], dout[bh, sq, d], and the float32 row
// statistics lse[bh, sq] (the forward's) and delta[bh, sq] (rowsum(dout *
// o)).  `seed`, `threshold` and `inv_keep` must be the forward's (NULL
// seed: no dropout).  With a ds (d 64 and 128 only) the tensor-core kernel
// also writes the score gradient ds^T into the float32 scratch ds[bh,
// round64(sk), round64(sq)] that pt_flash_attn_bwd_dq_ds reads; with a NULL
// ds the FMA kernel runs.
extern "C" int pt_flash_attn_bwd_dkv(int dtype, const void* q, const void* k,
                                     const void* v, const void* bias,
                                     const void* dout, const void* lse,
                                     const void* delta, void* dk, void* dv,
                                     void* ds, int bh, int sq, int sk, int d,
                                     int bias_ratio, int causal, float scale,
                                     const void* seed, unsigned int threshold,
                                     float inv_keep, void* stream) {
  const BwdArgs a{q,  k,  v,  bias, dout, lse, delta, nullptr,
                  dk, dv, static_cast<float*>(ds), bh, sq, sk, bias_ratio,
                  causal, scale, static_cast<const int*>(seed), threshold,
                  inv_keep};
  return run(Kernel::kDkv, dtype, d, a, stream);
}

// dq[bh, sq, d] from the same inputs, on the FMA route: the kernel
// recomputes the scores and the mask (pt_flash_attn_bwd_dkv with a NULL ds
// is its pair).
extern "C" int pt_flash_attn_bwd_dq(int dtype, const void* q, const void* k,
                                    const void* v, const void* bias,
                                    const void* dout, const void* lse,
                                    const void* delta, void* dq, int bh,
                                    int sq, int sk, int d, int bias_ratio,
                                    int causal, float scale, const void* seed,
                                    unsigned int threshold, float inv_keep,
                                    void* stream) {
  const BwdArgs a{q,  k,       v,       bias,    dout, lse, delta,
                  dq, nullptr, nullptr, nullptr, bh,   sq,  sk,
                  bias_ratio, causal, scale, static_cast<const int*>(seed),
                  threshold, inv_keep};
  return run(Kernel::kDqFma, dtype, d, a, stream);
}

// dq[bh, sq, d] = ds.k * scale, on the tensor-core route (d 64 and 128):
// ds is the scratch pt_flash_attn_bwd_dkv wrote for the same problem.
extern "C" int pt_flash_attn_bwd_dq_ds(int dtype, const void* k,
                                       const void* ds, void* dq, int bh,
                                       int sq, int sk, int d, int causal,
                                       float scale, void* stream) {
  const BwdArgs a{nullptr, k,       nullptr, nullptr, nullptr,
                  nullptr, nullptr, dq,      nullptr, nullptr,
                  const_cast<float*>(static_cast<const float*>(ds)),
                  bh,      sq,      sk,      1,       causal,
                  scale,   nullptr, 0u,      1.f};  // q .. delta unread
  return run(Kernel::kDqDs, dtype, d, a, stream);
}
