// Bias add + exact-erf GELU, forward and backward, for Hopper.
//
// Replaces the TPU kernels paddle_tpu/ops/pallas/fused_ops.py _bg_fwd_kernel:
// y = gelu(x + bias) with gelu(u) = 0.5 * u * (1 + erf(u / sqrt(2))), the
// exact form (never the tanh approximation), so fused and unfused programs
// agree; and _bg_bwd_kernel: dx = dy * (Phi(u) + u * phi(u)) with
// u = x + bias, in float32, and db = the column sum of dx (float32, before
// dx is rounded to its storage type).
//
// Bound on an H100: bytes.  x[R, D] is read once and y written once (the
// D-wide bias stays in L1/L2); erff costs ~20 operations per element, still
// under the ~20 FLOP/byte ridge for 8 bytes per float32 element.  The
// backward reads x and dy and writes dx: 12 bytes per float32 element
// against ~30 operations.
//
// Forward design: one block of 256 threads per row; thread t handles
// elements t, t + 256, ... of the row, so every access is coalesced and no
// index division is needed.  The sum x + bias lives only in registers.
//
// Backward design: the TPU kernel sums db across row blocks in scratch
// carried over its sequential grid; blocks here run in parallel.  So, as
// the LayerNorm backward does, one block of 256 threads takes a run of
// rows; thread t owns the four columns 4t .. 4t + 3 (then 4t + 1024, ...),
// reads them with one 16-byte (float32) or 8-byte (bfloat16) load when the
// pointers are aligned for it (one column per step otherwise), writes dx
// and adds it into its own columns of a float32 partial row in shared
// memory (no atomics, no barrier).  The block writes its partial row to
// partial[block][D]; a second kernel adds the partials of each column in a
// fixed order.  The bias gradient is the same bits every run.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

template <typename T, int kVec>
__global__ void bias_gelu_bwd_kernel(const T* __restrict__ x,
                                     const T* __restrict__ bias,
                                     const T* __restrict__ dy,
                                     T* __restrict__ dx,
                                     float* __restrict__ partial, int rows,
                                     int d, int rows_per_block) {
  extern __shared__ float dbp[];  // d floats: this block's column sums
  // every thread reads and writes only its own columns of dbp
  for (int c = threadIdx.x * kVec; c < d; c += kThreads * kVec) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) dbp[c + j] = 0.f;
  }
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(rows, r0 + rows_per_block);
  for (int r = r0; r < r1; ++r) {
    const size_t base = static_cast<size_t>(r) * d;
    for (int c = threadIdx.x * kVec; c < d; c += kThreads * kVec) {
      float xv[kVec], bv[kVec], g[kVec];
      pt_load_n<kVec>(x + base + c, xv);
      pt_load_n<kVec>(bias + c, bv);
      pt_load_n<kVec>(dy + base + c, g);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float u = xv[j] + bv[j];
        const float cdf = 0.5f * (1.0f + erff(u * 0.7071067811865476f));
        const float pdf = 0.3989422804014327f * expf(-0.5f * u * u);
        g[j] *= cdf + u * pdf;
        dbp[c + j] += g[j];
      }
      pt_store_n<kVec>(dx + base + c, g);
    }
  }
  float* out = partial + static_cast<size_t>(blockIdx.x) * d;
  for (int c = threadIdx.x * kVec; c < d; c += kThreads * kVec) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) out[c + j] = dbp[c + j];
  }
}

// db[c] = the sum over row blocks of partial[block][c].  A block takes 32
// columns: warp w adds blocks w, w + 8, ... for its lane's column, then the
// eight warp sums are added in warp order — the same order every run.
template <typename T>
__global__ void bias_gelu_bwd_colsum_kernel(const float* __restrict__ partial,
                                            T* __restrict__ db, int nblocks,
                                            int d) {
  __shared__ float sums[kWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float acc = 0.f;
  if (c < d)
    for (int b = warp; b < nblocks; b += kWarps)
      acc += partial[static_cast<size_t>(b) * d + c];
  sums[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && c < d) {
    float total = 0.f;
    for (int w = 0; w < kWarps; ++w) total += sums[w][lane];
    pt_store(db + c, total);
  }
}

template <typename T, int kVec>
cudaError_t launch_bwd_kernel(const void* x, const void* bias, const void* dy,
                              void* dx, void* partial, int rows, int d,
                              int rows_per_block, int nblocks,
                              cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  auto kernel = bias_gelu_bwd_kernel<T, kVec>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<nblocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(bias),
      static_cast<const T*>(dy), static_cast<T*>(dx),
      static_cast<float*>(partial), rows, d, rows_per_block);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* bias, const void* dy,
                       void* dx, void* db, void* partial, int rows, int d,
                       int rows_per_block, int nblocks, cudaStream_t stream) {
  // d % 128 == 0, so every row starts as aligned as its tensor does
  const size_t vec_bytes = 4 * sizeof(T);
  const bool vec = pt_aligned(x, vec_bytes) &&
                   pt_aligned(bias, vec_bytes) &&
                   pt_aligned(dy, vec_bytes) && pt_aligned(dx, vec_bytes);
  cudaError_t err =
      vec ? launch_bwd_kernel<T, 4>(x, bias, dy, dx, partial, rows, d,
                                    rows_per_block, nblocks, stream)
          : launch_bwd_kernel<T, 1>(x, bias, dy, dx, partial, rows, d,
                                    rows_per_block, nblocks, stream);
  if (err != cudaSuccess) return err;
  bias_gelu_bwd_colsum_kernel<T><<<(d + 31) / 32, kThreads, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<T*>(db), nblocks, d);
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

// Backward of y = gelu(x + bias) for the output gradient dy[rows, d]:
// dx[rows, d] and db[d] (same dtype as x).  `partial` is float32 scratch of
// [nblocks, d] with nblocks = ceil(rows / rows_per_block).  Same width rule
// as the forward.
extern "C" int pt_bias_gelu_bwd(int dtype, const void* x, const void* bias,
                                const void* dy, void* dx, void* db,
                                void* partial, int rows, int d,
                                int rows_per_block, int nblocks,
                                void* stream) {
  if (d <= 0 || d % 128 != 0 || d > 16384 || rows < 1 || rows_per_block < 1 ||
      nblocks != (rows + rows_per_block - 1) / rows_per_block)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == PT_F32) {
    err = launch_bwd<float>(x, bias, dy, dx, db, partial, rows, d,
                            rows_per_block, nblocks, s);
  } else if (dtype == PT_BF16) {
    err = launch_bwd<__nv_bfloat16>(x, bias, dy, dx, db, partial, rows, d,
                                    rows_per_block, nblocks, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
