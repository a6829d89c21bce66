// Shared helpers for the port's Hopper kernels: element loads/stores in
// float32 or bfloat16 (one at a time, or four as one vector access; the
// flash kernels' rounding also in float16), a
// float warp reduction and the counter-based dropout generator.
//
// Every kernel source in this directory exposes a plain C entry point that
// takes raw device pointers and a cudaStream_t (as void*), launches on that
// stream, allocates nothing, and returns cudaGetLastError() so the Python
// wrapper (loaded with ctypes) can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

// dtype codes shared with the Python wrappers (ops/cuda/__init__.py)
enum PtDtype { PT_F32 = 0, PT_BF16 = 1, PT_F16 = 2 };

__device__ __forceinline__ float pt_load(const float* p) { return *p; }
__device__ __forceinline__ float pt_load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void pt_store(float* p, float v) { *p = v; }
__device__ __forceinline__ void pt_store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Round a float to the storage type T and back (identity for float).
template <typename T> __device__ __forceinline__ float pt_round(float v);
template <> __device__ __forceinline__ float pt_round<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float pt_round<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}
template <> __device__ __forceinline__ float pt_round<__half>(float v) {
  return __half2float(__float2half_rn(v));
}

// kVec consecutive elements as floats: one 16-byte (float32) or 8-byte
// (bfloat16) access for kVec == 4, the pointer aligned to it
template <int kVec>
__device__ __forceinline__ void pt_load_n(const float* p, float* v) {
  if constexpr (kVec == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    v[0] = *p;
  }
}

template <int kVec>
__device__ __forceinline__ void pt_load_n(const __nv_bfloat16* p,
                                          float* v) {
  if constexpr (kVec == 4) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    const float2 lo =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
    const float2 hi =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
    v[0] = lo.x;
    v[1] = lo.y;
    v[2] = hi.x;
    v[3] = hi.y;
  } else {
    v[0] = pt_load(p);
  }
}

template <int kVec>
__device__ __forceinline__ void pt_store_n(float* p, const float* v) {
  if constexpr (kVec == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}

template <int kVec>
__device__ __forceinline__ void pt_store_n(__nv_bfloat16* p,
                                           const float* v) {
  if constexpr (kVec == 4) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 q;
    q.x = *reinterpret_cast<const uint32_t*>(&lo);
    q.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = q;
  } else {
    pt_store(p, v[0]);
  }
}

// Whether a host pointer is aligned to `bytes` (picks a vector width).
inline bool pt_aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

__device__ __forceinline__ float pt_warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Philox-4x32-10 (Salmon et al., SC 2011): the four output words of
// counter (c0, c1, c2, 0) under key (seed, 0).
__device__ __forceinline__ uint4 pt_philox(uint32_t seed, uint32_t c0,
                                           uint32_t c1, uint32_t c2) {
  uint32_t c3 = 0u, k0 = seed, k1 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c0, hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo1 = 0xCD9E8D57u * c2, hi1 = __umulhi(0xCD9E8D57u, c2);
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

// The dropout word of attention-score element (bh, row, col): one draw
// serves four elements,
//   counter (col >> 1, row & ~8, bh, 0), key (seed, 0),
//   word 2 * ((row >> 3) & 1) + (col & 1),
// a bijection from (bh, row, col) to (counter, word).  The four elements
// of a draw -- rows r and r + 8 (bit 3 of r clear) at columns c and c + 1
// (c even) -- are the four that one thread holds of an m16n8 accumulator
// tile whose first row is a multiple of 16, so a kernel in that layout
// draws once per tile and uses every word.  The mapping is a function of
// the element alone, not of any kernel's tiling: the forward and both
// backward kernels regenerate the mask bit for bit, and so does the plain
// version in ops/cuda/flash_attention.py (philox_bits).
__device__ __forceinline__ uint32_t pt_dropout_word(uint32_t seed,
                                                    uint32_t bh,
                                                    uint32_t row,
                                                    uint32_t col) {
  const uint4 w = pt_philox(seed, col >> 1, row & ~8u, bh);
  const uint32_t lo = col & 1u ? w.y : w.x, hi = col & 1u ? w.w : w.z;
  return row & 8u ? hi : lo;
}
