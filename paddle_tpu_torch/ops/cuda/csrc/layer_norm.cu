// Row LayerNorm forward, with or without a residual addend, for Hopper.
//
// Replaces the TPU kernels paddle_tpu/ops/pallas/fused_ops.py
// _ln_fwd_kernel (LN(x)) and _aln_fwd_kernel (LN(a + b), the sum never
// written to memory).
//
// Bound on an H100: bytes.  Each row of D elements is read once per addend
// and written once, and the work is ~8 operations per element, far below
// the ~20 FLOP/byte the card needs before arithmetic matters.
//
// Design: one block of 128 threads per row.  The row (a + b, in float32) is
// staged in shared memory (D <= 8192 floats = 32 KB), so device memory is
// read once; the mean, then the mean of squared deviations (both float32,
// the order _ln_fwd_kernel uses) come from two block reductions, and the
// normalised row is written in one pass.  Loads are coalesced: thread t
// touches elements t, t + 128, ...  The residual sum never leaves the SM.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T, bool kResidual>
__global__ void ln_fwd_kernel(const T* __restrict__ a,
                              const T* __restrict__ b,
                              const T* __restrict__ scale,
                              const T* __restrict__ bias,
                              T* __restrict__ y, int d, float eps) {
  extern __shared__ float row[];           // d floats
  __shared__ float scratch[kThreads / 32];
  const size_t base = static_cast<size_t>(blockIdx.x) * d;

  float sum = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    float u = pt_load(a + base + i);
    if (kResidual) u += pt_load(b + base + i);
    row[i] = u;
    sum += u;
  }
  const float mean = pt_block_sum(sum, scratch) / d;

  // each thread re-reads only the elements it wrote: no barrier needed
  float sq = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float c = row[i] - mean;
    sq += c * c;
  }
  const float var = pt_block_sum(sq, scratch) / d;
  const float rstd = rsqrtf(var + eps);

  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = (row[i] - mean) * rstd * pt_load(scale + i) +
                    pt_load(bias + i);
    pt_store(y + base + i, v);
  }
}

template <typename T, bool kResidual>
cudaError_t launch(const void* a, const void* b, const void* scale,
                   const void* bias, void* y, int rows, int d, float eps,
                   cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  ln_fwd_kernel<T, kResidual><<<rows, kThreads, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const T*>(scale), static_cast<const T*>(bias),
      static_cast<T*>(y), d, eps);
  return cudaGetLastError();
}

}  // namespace

// y[rows, d] = LN(a (+ b)) * scale + bias.  `b` may be NULL (plain LN).
// Requires d % 128 == 0 and d <= 8192 (checked by the Python wrapper and
// re-checked here); all tensors contiguous, of the dtype `dtype` names.
extern "C" int pt_layer_norm_fwd(int dtype, const void* a, const void* b,
                                 const void* scale, const void* bias,
                                 void* y, int rows, int d, float eps,
                                 void* stream) {
  if (d <= 0 || d % 128 != 0 || d > 8192 || rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == PT_F32) {
    err = b ? launch<float, true>(a, b, scale, bias, y, rows, d, eps, s)
            : launch<float, false>(a, b, scale, bias, y, rows, d, eps, s);
  } else if (dtype == PT_BF16) {
    err = b ? launch<__nv_bfloat16, true>(a, b, scale, bias, y, rows, d,
                                          eps, s)
            : launch<__nv_bfloat16, false>(a, b, scale, bias, y, rows, d,
                                           eps, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
