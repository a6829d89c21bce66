// One-pass Adam update, in place, for Hopper.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/fused_ops.py _adam_kernel
// (reached from adam_update).  Same function, per element:
//   m = b1 * m + (1 - b1) * g
//   v = b2 * v + (1 - b2) * g * g
//   p = p - lr_t * m / (sqrt(v) + eps)
// with p, m and v overwritten in place (the TPU kernel aliases them) and
// the bias-corrected step lr_t read from device memory, so the 158 Adam
// ops of a BERT-base step enqueue without a host sync.
//
// The TPU kernel only takes numel % 128 == 0 and numel >= 1024 (its
// (rows, 128) tiling); this kernel takes any numel: a grid-stride loop
// over float4 vectors when every pointer is 16-byte aligned, and a scalar
// loop for the rest (or for everything when a pointer is not aligned).
//
// Bound on an H100: bytes.  7 floats move per element (p, g, m, v read;
// p, m, v written) = 28 B for ~12 operations.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

struct AdamArgs {
  float b1, omb1, b2, omb2, eps;
};

__device__ __forceinline__ void adam_one(float& p, float g, float& m,
                                         float& v, float lr,
                                         const AdamArgs& a) {
  m = a.b1 * m + a.omb1 * g;
  v = a.b2 * v + a.omb2 * g * g;
  p = p - lr * m / (sqrtf(v) + a.eps);
}

__global__ void __launch_bounds__(kThreads)
    adam_kernel(float* __restrict__ p, const float* __restrict__ g,
                float* __restrict__ m, float* __restrict__ v,
                const float* __restrict__ lr_t, long long n, int vec,
                AdamArgs a) {
  const float lr = *lr_t;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long tid =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  long long tail = 0;
  if (vec) {
    const long long n4 = n / 4;
    float4* p4 = reinterpret_cast<float4*>(p);
    float4* m4 = reinterpret_cast<float4*>(m);
    float4* v4 = reinterpret_cast<float4*>(v);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    for (long long i = tid; i < n4; i += stride) {
      float4 pp = p4[i], mm = m4[i], vv = v4[i];
      const float4 gg = g4[i];
      adam_one(pp.x, gg.x, mm.x, vv.x, lr, a);
      adam_one(pp.y, gg.y, mm.y, vv.y, lr, a);
      adam_one(pp.z, gg.z, mm.z, vv.z, lr, a);
      adam_one(pp.w, gg.w, mm.w, vv.w, lr, a);
      p4[i] = pp;
      m4[i] = mm;
      v4[i] = vv;
    }
    tail = n4 * 4;
  }
  for (long long i = tail + tid; i < n; i += stride) {
    float pp = p[i], mm = m[i], vv = v[i];
    adam_one(pp, g[i], mm, vv, lr, a);
    p[i] = pp;
    m[i] = mm;
    v[i] = vv;
  }
}

}  // namespace

// In-place Adam over n float32 elements of p, m, v with gradient g and the
// step size lr_t[0] (device memory).  n may be any positive count.
extern "C" int pt_adam(void* p, const void* g, void* m, void* v,
                       const void* lr_t, long long n, float beta1,
                       float one_minus_beta1, float beta2,
                       float one_minus_beta2, float eps, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t bits = reinterpret_cast<uintptr_t>(p) |
                         reinterpret_cast<uintptr_t>(g) |
                         reinterpret_cast<uintptr_t>(m) |
                         reinterpret_cast<uintptr_t>(v);
  const int vec = (bits % 16 == 0) ? 1 : 0;
  const long long work = vec ? (n + 3) / 4 : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // 16 blocks per SM, then stride
  const AdamArgs a{beta1, one_minus_beta1, beta2, one_minus_beta2, eps};
  adam_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(p), static_cast<const float*>(g),
      static_cast<float*>(m), static_cast<float*>(v),
      static_cast<const float*>(lr_t), n, vec, a);
  return static_cast<int>(cudaGetLastError());
}
