// Tile helpers shared by the flash attention forward (flash_attention.cu)
// and backward (flash_attention_bwd.cu) kernels: 256 threads as a 16 x 16
// grid over 64 x 64 score tiles, float4 staging of (bf16 or float32) rows
// into float32 shared memory, and the register-tiled products.
#pragma once

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kBlockM = 64;        // query rows per tile
constexpr int kBlockN = 64;        // keys per tile
constexpr int kThreads = 256;      // a 16 x 16 grid of threads
constexpr int kPStride = kBlockN + 16;  // score-tile rows in shared memory
constexpr int kCStride = 64 + 4;        // a 64-wide head-dim chunk row
constexpr float kNegInf = -1e30f;  // the TPU kernels' NEG_INF

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
__device__ __forceinline__ bool keep_element(uint32_t seed, int bh, int row,
                                             int col, uint32_t threshold) {
  return pt_philox(seed, static_cast<uint32_t>(bh),
                   static_cast<uint32_t>(row),
                   static_cast<uint32_t>(col)) >= threshold;
}

}  // namespace
