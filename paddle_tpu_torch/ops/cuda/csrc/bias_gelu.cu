// Bias add + exact-erf GELU forward for Hopper.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/fused_ops.py _bg_fwd_kernel:
// y = gelu(x + bias) with gelu(u) = 0.5 * u * (1 + erf(u / sqrt(2))), the
// exact form (never the tanh approximation), so fused and unfused programs
// agree.
//
// Bound on an H100: bytes.  x[R, D] is read once and y written once (the
// D-wide bias stays in L1/L2); erff costs ~20 operations per element, still
// under the ~20 FLOP/byte ridge for 8 bytes per float32 element.
//
// Design: one block of 256 threads per row; thread t handles elements
// t, t + 256, ... of the row, so every access is coalesced and no index
// division is needed.  The sum x + bias lives only in registers.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void bias_gelu_fwd_kernel(const T* __restrict__ x,
                                     const T* __restrict__ bias,
                                     T* __restrict__ y, int d) {
  const size_t base = static_cast<size_t>(blockIdx.x) * d;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float u = pt_load(x + base + i) + pt_load(bias + i);
    pt_store(y + base + i, 0.5f * u * (1.0f + erff(u * 0.7071067811865476f)));
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* bias, void* y, int rows, int d,
                   cudaStream_t stream) {
  bias_gelu_fwd_kernel<T><<<rows, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(bias),
      static_cast<T*>(y), d);
  return cudaGetLastError();
}

}  // namespace

// y[rows, d] = gelu(x[rows, d] + bias[d]).  Requires d % 128 == 0 and
// d <= 16384 (the TPU kernel's gate, kept so both packages route alike).
extern "C" int pt_bias_gelu_fwd(int dtype, const void* x, const void* bias,
                                void* y, int rows, int d, void* stream) {
  if (d <= 0 || d % 128 != 0 || d > 16384 || rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == PT_F32) {
    err = launch<float>(x, bias, y, rows, d, s);
  } else if (dtype == PT_BF16) {
    err = launch<__nv_bfloat16>(x, bias, y, rows, d, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
