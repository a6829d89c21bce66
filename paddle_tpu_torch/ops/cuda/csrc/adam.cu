// Multi-tensor Adam / AdamW update, in place, for Hopper.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/fused_ops.py _adam_kernel
// (reached from adam_update), a one-pass in-place update of one tensor,
// per element:
//   m = b1 * m + (1 - b1) * g
//   v = b2 * v + (1 - b2) * g * g
//   p = p - lr_t * m / (sqrt(v) + eps)
// The JAX package's step is one XLA executable, which fuses a step's 158
// updates together with the scalar work around them (paddle_tpu/ops/
// optimizer_ops.py).  Here one launch takes a whole run of adam / adamw ops
// (the executor groups them, ops/optimizer_ops.py) and does that scalar
// work itself, per tensor:
//   lr_t = lr * sqrtf(1 - beta2_pow) / (1 - beta1_pow)   (IEEE sqrt, div)
//   p = p - lr_t * m / (sqrt(v) + eps) - (lr * coeff) * p_old   (AdamW's
//       decoupled decay when coeff != 0, p_old read before the update)
//   beta1_pow *= b1, beta2_pow *= b2   (once per tensor, after every block
//       has read them: the last block to finish, by an atomic ticket)
// each product, sum and quotient rounded on its own in the order of the
// per-op plain version (ops/cuda/optimizer.py adam_multi_plain), so the
// kernel gives its bits.  p, m, v and the powers are overwritten in place;
// lr and the powers are read from device memory, so nothing waits for the
// host.
//
// The tensor table (pointers, count, hyperparameters) is passed by value as
// a kernel parameter (sm_90 with CUDA >= 12.1 takes 32,764 bytes of them:
// kMaxTensors entries of 88 bytes); a longer run is split by the caller.
// Blocks walk a chunk list of (tensor, chunk) pairs of `chunk` elements
// (the caller's choice: 16 K, 6,800 blocks for BERT-base; 64 K ran 1.5 %
// slower on an H100), which holds no pointers, so the caller builds it once
// per run of element counts and keeps it on the device.  Each tensor is read in float4 vectors
// when its four pointers are 16-byte aligned, in scalars otherwise.
//
// Bound on an H100: bytes.  7 floats move per element (p, g, m, v read;
// p, m, v written) = 28 B, decay or not: 0.9203 ms for BERT-base's 110.1 M
// parameters at 3.35 TB/s.
#include <stdint.h>
#include <string.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTensors = 256;  // ops/cuda/optimizer.py MAX_TENSORS

// one tensor's update; the layout is the Python wrapper's table row
struct AdamTensor {
  float* p;
  const float* g;
  float* m;
  float* v;
  const float* lr;
  float* beta1_pow;
  float* beta2_pow;
  long long n;
  float b1, omb1, b2, omb2, eps, coeff;  // omb = float(1 - b), in double
};
static_assert(sizeof(AdamTensor) == 88, "the wrapper's table row");

struct AdamTable {
  AdamTensor t[kMaxTensors];
  uint32_t vec[kMaxTensors / 32];  // bit i: tensor i's pointers 16-B aligned
  int count;
};
static_assert(sizeof(AdamTable) <= 32000, "kernel parameter space");

__device__ unsigned int g_ticket = 0;  // blocks done; reset by the last one

__device__ __forceinline__ void adam_one(float& p, float g, float& m,
                                         float& v, float lr_t, float decay,
                                         const AdamTensor& a) {
  m = __fadd_rn(__fmul_rn(m, a.b1), __fmul_rn(g, a.omb1));
  v = __fadd_rn(__fmul_rn(v, a.b2), __fmul_rn(__fmul_rn(g, a.omb2), g));
  const float p_new = __fsub_rn(
      p, __fdiv_rn(__fmul_rn(lr_t, m), __fadd_rn(__fsqrt_rn(v), a.eps)));
  p = decay != 0.f ? __fsub_rn(p_new, __fmul_rn(decay, p)) : p_new;
}

__global__ void __launch_bounds__(kThreads)
    adam_multi_kernel(const AdamTable tab, const int2* __restrict__ chunks,
                      int chunk) {
  const int2 ch = chunks[blockIdx.x];  // (tensor, chunk of it)
  const AdamTensor& a = tab.t[ch.x];
  const float lr = *a.lr;
  const float lr_t = __fdiv_rn(
      __fmul_rn(lr, __fsqrt_rn(__fsub_rn(1.f, *a.beta2_pow))),
      __fsub_rn(1.f, *a.beta1_pow));
  const float decay = a.coeff != 0.f ? __fmul_rn(lr, a.coeff) : 0.f;
  const long long begin = static_cast<long long>(ch.y) * chunk;
  const long long end = min(a.n, begin + chunk);
  long long tail = begin;
  if ((tab.vec[ch.x / 32] >> (ch.x % 32)) & 1u) {
    tail = begin + ((end - begin) & ~3LL);
    float4* p4 = reinterpret_cast<float4*>(a.p);
    float4* m4 = reinterpret_cast<float4*>(a.m);
    float4* v4 = reinterpret_cast<float4*>(a.v);
    const float4* g4 = reinterpret_cast<const float4*>(a.g);
    for (long long i = begin / 4 + threadIdx.x; i < tail / 4; i += kThreads) {
      float4 pp = p4[i], mm = m4[i], vv = v4[i];
      const float4 gg = g4[i];
      adam_one(pp.x, gg.x, mm.x, vv.x, lr_t, decay, a);
      adam_one(pp.y, gg.y, mm.y, vv.y, lr_t, decay, a);
      adam_one(pp.z, gg.z, mm.z, vv.z, lr_t, decay, a);
      adam_one(pp.w, gg.w, mm.w, vv.w, lr_t, decay, a);
      p4[i] = pp;
      m4[i] = mm;
      v4[i] = vv;
    }
  }
  for (long long i = tail + threadIdx.x; i < end; i += kThreads) {
    float pp = a.p[i], mm = a.m[i], vv = a.v[i];
    adam_one(pp, a.g[i], mm, vv, lr_t, decay, a);
    a.p[i] = pp;
    a.m[i] = mm;
    a.v[i] = vv;
  }

  // the beta powers advance once, after every block has read them
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(&g_ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = threadIdx.x; i < tab.count; i += kThreads) {
    const AdamTensor& e = tab.t[i];
    *e.beta1_pow = __fmul_rn(*e.beta1_pow, e.b1);
    *e.beta2_pow = __fmul_rn(*e.beta2_pow, e.b2);
  }
  if (threadIdx.x == 0) g_ticket = 0;
}

}  // namespace

// In-place Adam over `count` tensors: `tensors` is a host array of
// AdamTensor rows (the wrapper's table), `chunks` a device array of
// `nchunks` (tensor, chunk) int pairs covering every tensor's elements in
// pieces of `chunk` (a multiple of 4).  No two rows may share a parameter,
// moment or beta power.
extern "C" int pt_adam_multi(const void* tensors, int count,
                             const void* chunks, int nchunks, int chunk,
                             void* stream) {
  if (count < 1 || count > kMaxTensors || nchunks < 1 || chunk < 4 ||
      chunk % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  AdamTable tab;
  memset(&tab, 0, sizeof(tab));
  memcpy(tab.t, tensors, sizeof(AdamTensor) * count);
  tab.count = count;
  for (int i = 0; i < count; ++i) {
    const AdamTensor& e = tab.t[i];
    if (e.n < 1) return static_cast<int>(cudaErrorInvalidValue);
    const uintptr_t bits = reinterpret_cast<uintptr_t>(e.p) |
                           reinterpret_cast<uintptr_t>(e.g) |
                           reinterpret_cast<uintptr_t>(e.m) |
                           reinterpret_cast<uintptr_t>(e.v);
    if (bits % 16 == 0) tab.vec[i / 32] |= 1u << (i % 32);
  }
  adam_multi_kernel<<<static_cast<unsigned>(nchunks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      tab, static_cast<const int2*>(chunks), chunk);
  return static_cast<int>(cudaGetLastError());
}
