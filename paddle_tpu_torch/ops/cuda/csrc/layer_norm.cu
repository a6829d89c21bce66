// Row LayerNorm forward and backward, each with or without a residual
// addend, for Hopper.
//
// Replaces the TPU kernels paddle_tpu/ops/pallas/fused_ops.py
// _ln_fwd_kernel (LN(x)), _aln_fwd_kernel (LN(a + b), the sum never
// written to memory), _ln_bwd_kernel (dx, dscale, dbias) and
// _aln_bwd_kernel (the same for LN(a + b): the sum is recomputed in
// float32 and one dx is the gradient of both addends).
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
//
// Backward: the TPU kernel sums dscale/dbias across row blocks in scratch
// carried over its sequential grid; blocks here run in parallel.  So one
// block of 128 threads takes a run of rows, recomputes each row's mean and
// rstd in float32 (as _ln_bwd_kernel does), writes
// dx = rstd * (dy*s - mean(dy*s) - xhat * mean(dy*s*xhat)) and adds
// dy*xhat and dy into per-column partials in shared memory (each thread
// owns its columns, so no atomics); the block writes its partials to
// partial[block][2][D], and a second kernel sums them per column in block
// order.  The sums are deterministic.  Bound: bytes (x and dy read, dx
// written; the partials add 2 * 4 * D bytes per block).  The residual
// variant reads b as well and adds it to x as the row is staged, so the
// sum never reaches device memory in the backward either.
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

template <typename T, bool kResidual>
__global__ void ln_bwd_kernel(const T* __restrict__ x,
                              const T* __restrict__ b,
                              const T* __restrict__ scale,
                              const T* __restrict__ dy, T* __restrict__ dx,
                              float* __restrict__ partial, int rows, int d,
                              int rows_per_block, float eps) {
  extern __shared__ float sm[];  // xs[d], gs[d], dsp[d], dbp[d]
  __shared__ float scratch[kThreads / 32];
  float* xs = sm;
  float* gs = xs + d;
  float* dsp = gs + d;
  float* dbp = dsp + d;
  // every thread reads and writes only its own columns t, t + 128, ... of
  // these buffers, so they need no barrier
  for (int i = threadIdx.x; i < d; i += kThreads) dsp[i] = dbp[i] = 0.f;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(rows, r0 + rows_per_block);
  for (int r = r0; r < r1; ++r) {
    const size_t base = static_cast<size_t>(r) * d;
    float sum = 0.f;
    for (int i = threadIdx.x; i < d; i += kThreads) {
      float u = pt_load(x + base + i);
      if (kResidual) u += pt_load(b + base + i);
      xs[i] = u;
      gs[i] = pt_load(dy + base + i);
      sum += u;
    }
    const float mean = pt_block_sum(sum, scratch) / d;
    float sq = 0.f;
    for (int i = threadIdx.x; i < d; i += kThreads) {
      const float c = xs[i] - mean;
      sq += c * c;
    }
    const float rstd = rsqrtf(pt_block_sum(sq, scratch) / d + eps);
    float m1 = 0.f, m2 = 0.f;
    for (int i = threadIdx.x; i < d; i += kThreads) {
      const float xh = (xs[i] - mean) * rstd;
      const float g = gs[i];
      const float gsc = g * pt_load(scale + i);
      m1 += gsc;
      m2 += gsc * xh;
      dsp[i] += g * xh;
      dbp[i] += g;
      xs[i] = xh;
      gs[i] = gsc;
    }
    m1 = pt_block_sum(m1, scratch) / d;
    m2 = pt_block_sum(m2, scratch) / d;
    for (int i = threadIdx.x; i < d; i += kThreads)
      pt_store(dx + base + i, rstd * (gs[i] - m1 - xs[i] * m2));
  }
  float* out = partial + static_cast<size_t>(blockIdx.x) * 2 * d;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    out[i] = dsp[i];
    out[d + i] = dbp[i];
  }
}

// dscale[c] (c < d) and dbias[c - d] (c >= d): the column sums of the
// per-block partials, added in block order
template <typename T>
__global__ void ln_bwd_colsum_kernel(const float* __restrict__ partial,
                                     T* __restrict__ dscale,
                                     T* __restrict__ dbias, int nblocks,
                                     int d) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= 2 * d) return;
  float acc = 0.f;
  for (int b = 0; b < nblocks; ++b)
    acc += partial[static_cast<size_t>(b) * 2 * d + c];
  pt_store(c < d ? dscale + c : dbias + (c - d), acc);
}

template <typename T, bool kResidual>
cudaError_t launch_bwd(const void* x, const void* b, const void* scale,
                       const void* dy, void* dx, void* dscale, void* dbias,
                       void* partial, int rows, int d, int rows_per_block,
                       int nblocks, float eps, cudaStream_t stream) {
  const size_t smem = 4 * static_cast<size_t>(d) * sizeof(float);
  auto kernel = ln_bwd_kernel<T, kResidual>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<nblocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(b),
      static_cast<const T*>(scale), static_cast<const T*>(dy),
      static_cast<T*>(dx), static_cast<float*>(partial), rows, d,
      rows_per_block, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ln_bwd_colsum_kernel<T><<<(2 * d + kThreads - 1) / kThreads, kThreads, 0,
                            stream>>>(static_cast<const float*>(partial),
                                      static_cast<T*>(dscale),
                                      static_cast<T*>(dbias), nblocks, d);
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

// LayerNorm backward over rows of x (+ b)[rows, d] with scale[d] and
// dy[rows, d]: dx[rows, d] (with `b`, the gradient of both addends) and
// dscale, dbias[d] (same dtype as x).  `b` may be NULL (plain LN).
// `partial` is float32 scratch of [nblocks, 2, d] with
// nblocks = ceil(rows / rows_per_block).  Same width rule as the forward.
extern "C" int pt_layer_norm_bwd(int dtype, const void* x, const void* b,
                                 const void* scale, const void* dy, void* dx,
                                 void* dscale, void* dbias, void* partial,
                                 int rows, int d, int rows_per_block,
                                 int nblocks, float eps, void* stream) {
  if (d <= 0 || d % 128 != 0 || d > 8192 || rows < 1 || rows_per_block < 1 ||
      nblocks != (rows + rows_per_block - 1) / rows_per_block)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == PT_F32) {
    err = b ? launch_bwd<float, true>(x, b, scale, dy, dx, dscale, dbias,
                                      partial, rows, d, rows_per_block,
                                      nblocks, eps, s)
            : launch_bwd<float, false>(x, b, scale, dy, dx, dscale, dbias,
                                       partial, rows, d, rows_per_block,
                                       nblocks, eps, s);
  } else if (dtype == PT_BF16) {
    err = b ? launch_bwd<__nv_bfloat16, true>(x, b, scale, dy, dx, dscale,
                                              dbias, partial, rows, d,
                                              rows_per_block, nblocks, eps, s)
            : launch_bwd<__nv_bfloat16, false>(x, b, scale, dy, dx, dscale,
                                               dbias, partial, rows, d,
                                               rows_per_block, nblocks, eps,
                                               s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
