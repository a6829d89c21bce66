// Shared helpers for the port's Hopper kernels: element loads/stores in
// float32 or bfloat16 and a float block reduction.
//
// Every kernel source in this directory exposes a plain C entry point that
// takes raw device pointers and a cudaStream_t (as void*), launches on that
// stream, allocates nothing, and returns cudaGetLastError() so the Python
// wrapper (loaded with ctypes) can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

// dtype codes shared with the Python wrappers (ops/cuda/__init__.py)
enum PtDtype { PT_F32 = 0, PT_BF16 = 1 };

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

__device__ __forceinline__ float pt_warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum of `v` over the whole block, returned to every thread.  `scratch`
// holds one float per warp; blockDim.x must be a multiple of 32.
__device__ __forceinline__ float pt_block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = pt_warp_sum(v);
  __syncthreads();  // scratch may still be read by a previous reduction
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < nwarps; ++w) total += scratch[w];
  return total;
}
