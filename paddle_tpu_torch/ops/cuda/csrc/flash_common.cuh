// Tile helpers shared by the flash attention forward (flash_attention.cu)
// and backward (flash_attention_bwd.cu) kernels.
//
// * The FMA kernels (head dim 256, and the backward's route past its
//   scratch cap): 256 threads as a 16 x 16 grid over 64 x 64 score tiles,
//   float4 staging of (bf16 or float32) rows into float32 shared memory,
//   and the register-tiled products on the float32 FMA pipes.
// * The tensor-core kernels: warps of mma.sync.m16n8k8 (.tf32, float32 as
//   3xTF32) and m16n8k16 (.bf16, .f16) products whose score tiles stay in
//   registers, float32 score products as one FMA chain per score, and
//   cp.async copies of the streamed tiles.  (The 16-bit forward and dk/dv
//   kernels are Hopper's own: hopper.cuh.)
// * The dropout keep decision (common.cuh pt_dropout_word), per element and
//   per accumulator fragment.
#pragma once

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kBlockM = 64;        // query rows per tile
constexpr int kBlockN = 64;        // keys per tile
constexpr int kThreads = 256;      // a 16 x 16 grid of threads
constexpr int kPStride = kBlockN + 16;  // score-tile rows in shared memory
constexpr int kCStride = 64 + 4;        // a 64-wide head-dim chunk row
constexpr float kNegInf = -1e30f;  // the TPU kernels' NEG_INF
// below this a row max (or lse) comes from mask biases alone: the 16-bit
// kernels then take e^(s - m) unfused (see flash_fwd_sm90_kernel)
constexpr float kHugeNeg = -1e20f;
constexpr int kMmaThreads = 128;  // tensor-core kernels: 4 warps

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 load4(const __half* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
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
__device__ __forceinline__ void store4(__half* p, float4 v) {
  __half2 lo = __floats2half2_rn(v.x, v.y);
  __half2 hi = __floats2half2_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// Columns [c0, c0 + W) of rows [row0, row0 + 64) of src[rows, D] into
// dst[64][stride]; rows at or past `limit` are zero.
template <typename T, int D, int W>
__device__ __forceinline__ void stage(float* dst, int stride, const T* src,
                                      int row0, int limit, int c0 = 0) {
  for (int idx = threadIdx.x; idx < 64 * W / 4; idx += kThreads) {
    const int r = idx / (W / 4), c = 4 * (idx % (W / 4));
    const float4 v =
        row0 + r < limit
            ? load4(src + static_cast<size_t>(row0 + r) * D + c0 + c)
            : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(dst + r * stride + c) = v;
  }
}

// s[i][j] += a[ty + 16i][0:len] . b[tx + 16j][0:len] — thread (ty, tx)
// owns rows ty + 16i of `a` and rows tx + 16j of `b`; 8 float4 loads feed
// 64 FMAs, and strides of 4 (mod 32) floats keep the loads conflict-free.
__device__ __forceinline__ void tile_dot(float (&s)[4][4], const float* a,
                                         int sa, const float* b, int sb,
                                         int len) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 4
  for (int d = 0; d < len; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = load4(a + (ty + 16 * i) * sa + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = load4(b + (tx + 16 * j) * sb + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float t = s[i][j];
        t = fmaf(av[i].x, bv[j].x, t);
        t = fmaf(av[i].y, bv[j].y, t);
        t = fmaf(av[i].z, bv[j].z, t);
        t = fmaf(av[i].w, bv[j].w, t);
        s[i][j] = t;
      }
  }
}

// acc[i][e] += sum_j p[ty + 16i][j] * b[j][4tx + e] over the 64 columns j
// of a score tile p[64][kPStride]; b rows are `sb` floats apart.  One
// broadcast p load per row and one float4 of b feed 16 FMAs.
__device__ __forceinline__ void tile_acc(float (&acc)[4][4], const float* p,
                                         const float* b, int sb) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 4
  for (int j = 0; j < kBlockN; ++j) {
    float pr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pr[i] = p[(ty + 16 * i) * kPStride + j];
    const float4 bv = load4(b + j * sb + 4 * tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[i][0] = fmaf(pr[i], bv.x, acc[i][0]);
      acc[i][1] = fmaf(pr[i], bv.y, acc[i][1]);
      acc[i][2] = fmaf(pr[i], bv.z, acc[i][2]);
      acc[i][3] = fmaf(pr[i], bv.w, acc[i][3]);
    }
  }
}

// The keep decision of inverted dropout for score element (bh, row, col):
// P(keep) = 1 - threshold / 2^32, as the TPU kernel's bits >= threshold.
// One draw per element, of which one word is used (the FMA kernels).
__device__ __forceinline__ bool keep_element(uint32_t seed, int bh, int row,
                                             int col, uint32_t threshold) {
  return pt_dropout_word(seed, static_cast<uint32_t>(bh),
                         static_cast<uint32_t>(row),
                         static_cast<uint32_t>(col)) >= threshold;
}

// The four keep bits of one draw, word i at bit i.
__device__ __forceinline__ uint32_t keep_bits(uint4 w, uint32_t threshold) {
  return static_cast<uint32_t>(w.x >= threshold) |
         static_cast<uint32_t>(w.y >= threshold) << 1 |
         static_cast<uint32_t>(w.z >= threshold) << 2 |
         static_cast<uint32_t>(w.w >= threshold) << 3;
}

// Keep bits of a thread's score fragment over NT tiles of 8 keys, in the
// m16n8 accumulator layout: bit 4j + c for the element at row r0 + 8 (c >>
// 1) and column c0 + 8j + (c & 1), where r0 has bit 3 clear and c0 is even
// (lane (g, t) of a warp whose 16 rows start at a multiple of 16: r0 =
// row0 + g, c0 = col0 + 2t).  Those four elements are one draw's four
// words (pt_dropout_word), so a tile costs one draw.  The loop is left
// partly rolled: the generator is ~70 instructions a draw, and one inlined
// chain per element once made the backward's loop outgrow the instruction
// cache.
template <int NT>
__device__ __forceinline__ uint32_t fragment_keep(uint32_t seed, int bh,
                                                  int r0, int c0,
                                                  uint32_t threshold) {
  uint32_t keep = 0;
#pragma unroll 4
  for (int j = 0; j < NT; ++j)
    keep |= keep_bits(pt_philox(seed, static_cast<uint32_t>(c0 + 8 * j) >> 1,
                                static_cast<uint32_t>(r0),
                                static_cast<uint32_t>(bh)),
                      threshold)
            << (4 * j);
  return keep;
}

// ---------------------------------------------------------------------------
// tensor-core fragments and asynchronous copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32 values (3xTF32)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (a, b) = hi + lo, both pairs of bf16, a in the low halves
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

// (a, b) = hi + lo, both pairs of float16, a in the low halves
__device__ __forceinline__ void split_f16(float a, float b, uint32_t& hi,
                                          uint32_t& lo) {
  const __half2 h = __floats2half2_rn(a, b);
  const float2 hf = __half22float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  const __half2 l = __floats2half2_rn(a - hf.x, b - hf.y);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

template <typename T>
__device__ __forceinline__ void split16(float a, float b, uint32_t& hi,
                                        uint32_t& lo) {
  if constexpr (std::is_same<T, __half>::value)
    split_f16(a, b, hi, lo);
  else
    split_bf16(a, b, hi, lo);
}

// p[0] and p[stride] as one word, p[0] in the low half
template <typename T, typename = std::enable_if_t<sizeof(T) == 2>>
__device__ __forceinline__ uint32_t ld_pair(const T* p, int stride) {
  const uint32_t lo = *reinterpret_cast<const unsigned short*>(p);
  const uint32_t hi = *reinterpret_cast<const unsigned short*>(p + stride);
  return lo | (hi << 16);
}

// c[16x8] += a[16x8] . b[8x8]: TF32 in, float32 accumulate
__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c[16x8] += a[16x16] . b[16x8]: bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c[16x8] += a[16x16] . b[16x8]: float16 in, float32 accumulate
__device__ __forceinline__ void mma_f16(float (&c)[4],
                                        const uint32_t (&a)[4],
                                        const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename T>
__device__ __forceinline__ void mma16(float (&c)[4], const uint32_t (&a)[4],
                                      const uint32_t (&b)[2]) {
  if constexpr (std::is_same<T, __half>::value)
    mma_f16(c, a, b);
  else
    mma_bf16(c, a, b);
}

// c += a.b on split operands, the small terms first
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4],
                                           const uint32_t (&bhi)[2],
                                           const uint32_t (&blo)[2]) {
  mma_tf32(c, alo, bhi);
  mma_tf32(c, ahi, blo);
  mma_tf32(c, ahi, bhi);
}

// 16 (or 4) bytes from device to shared memory, zeros where !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most N of this thread's copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Rows [r0, r0 + R) of a row-major matrix (rows `ld` elements apart; W
// columns from `src`) into dst[R][S] with cp.async by a block of kBlock
// threads; rows at or past `limit` are zero.  W elements are a multiple of
// 16 bytes.
template <typename T, int W, int R, int S, int kBlock = kMmaThreads>
__device__ __forceinline__ void copy_tile(T* dst, const T* src, size_t ld,
                                          int r0, int limit) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = W / kVec;
  for (int i = threadIdx.x; i < R * kPerRow; i += kBlock) {
    const int r = i / kPerRow, c = (i % kPerRow) * kVec;
    const bool ok = r0 + r < limit;
    cp_async16(dst + r * S + c,
               src + (ok ? static_cast<size_t>(r0 + r) * ld : 0) + c, ok);
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

// ---------------------------------------------------------------------------
// warp products.  Lane (g, t) = (lane / 4, lane % 4) holds rows g and g + 8
// and columns 2t, 2t + 1 of each 16 x 8 accumulator tile.
// ---------------------------------------------------------------------------

// c[j] += a[16][0:D] . b[8j + n][0:D] (n < 8), j < NT: a's rows are the
// warp's, b's rows the tile's; both in shared memory, S elements apart
template <int D, int NT, int S>
__device__ __forceinline__ void score_tile(float (&c)[NT][4], const float* a,
                                           const float* b, int g, int t) {
#pragma unroll 2
  for (int kk = 0; kk < D; kk += 8) {
    uint32_t ahi[4], alo[4];
    split_tf32(a[g * S + kk + t], ahi[0], alo[0]);
    split_tf32(a[(g + 8) * S + kk + t], ahi[1], alo[1]);
    split_tf32(a[g * S + kk + t + 4], ahi[2], alo[2]);
    split_tf32(a[(g + 8) * S + kk + t + 4], ahi[3], alo[3]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t bhi[2], blo[2];
      split_tf32(b[(8 * j + g) * S + kk + t], bhi[0], blo[0]);
      split_tf32(b[(8 * j + g) * S + kk + t + 4], bhi[1], blo[1]);
      mma_3xtf32(c[j], ahi, alo, bhi, blo);
    }
  }
}

// float32 scores, exact: c[j] as score_tile's, each element one fmaf chain
// over the head dim in order from 0 -- the float32 product the plain
// version's matmul computes, bit for bit (see the source note)
template <int D, int NT, int S>
__device__ __forceinline__ void score_tile_fma(float (&c)[NT][4],
                                               const float* a,
                                               const float* b, int g,
                                               int t) {
  const float* a0 = a + g * S;
  const float* a1 = a0 + 8 * S;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    const float4 x0 = load4(a0 + d), x1 = load4(a1 + d);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float4 y = load4(b + (8 * j + 2 * t + e) * S + d);
        float u = c[j][e], w = c[j][2 + e];
        u = fmaf(x0.x, y.x, u);
        w = fmaf(x1.x, y.x, w);
        u = fmaf(x0.y, y.y, u);
        w = fmaf(x1.y, y.y, w);
        u = fmaf(x0.z, y.z, u);
        w = fmaf(x1.z, y.z, w);
        u = fmaf(x0.w, y.w, u);
        w = fmaf(x1.w, y.w, w);
        c[j][e] = u;
        c[j][2 + e] = w;
      }
  }
}

// acc[n] += p . b[0:8NT][8n:8n + 8] (n < D / 8): p is 16 x 8NT in
// score_tile's accumulator layout, b's rows in shared memory S apart.  The
// accumulator holds columns 2t, 2t + 1 of its tile j where an A fragment of
// m16n8k8 holds t and t + 4: read as that fragment, the k index is permuted,
// and b's rows 8j + 2t and 8j + 2t + 1 take the place of rows t and t + 4.
// (kSplit is unused: float32 is always 3xTF32.)
template <int D, int NT, int S, bool kSplit = true>
__device__ __forceinline__ void acc_tile(float (&acc)[D / 8][4],
                                         const float (&p)[NT][4],
                                         const float* b, int g, int t) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    uint32_t ahi[4], alo[4];
    split_tf32(p[j][0], ahi[0], alo[0]);
    split_tf32(p[j][2], ahi[1], alo[1]);
    split_tf32(p[j][1], ahi[2], alo[2]);
    split_tf32(p[j][3], ahi[3], alo[3]);
    const float* br = b + (8 * j + 2 * t) * S + g;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      uint32_t bhi[2], blo[2];
      split_tf32(br[8 * n], bhi[0], blo[0]);
      split_tf32(br[S + 8 * n], bhi[1], blo[1]);
      mma_3xtf32(acc[n], ahi, alo, bhi, blo);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[i][e] = 0.f;
}

}  // namespace
