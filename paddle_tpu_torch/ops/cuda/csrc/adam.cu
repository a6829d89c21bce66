// Multi-tensor Adam / AdamW update, in place, for Hopper.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/fused_ops.py _adam_kernel
// (reached from adam_update), a one-pass in-place update of one tensor,
// per element, in float32 whatever the operands' dtypes:
//   m = b1 * m + (1 - b1) * g
//   v = b2 * v + (1 - b2) * g * g
//   p = p - lr_t * m / (sqrt(v) + eps)
// each of p, m and v then rounded once to its own dtype (the p update reads
// the float32 m and v, not their rounded stores).
// The JAX package's step is one XLA executable, which fuses a step's 158
// updates together with the scalar work around them (paddle_tpu/ops/
// optimizer_ops.py).  Here one launch takes a whole run of adam / adamw ops
// (the executor groups them, ops/optimizer_ops.py) and does that scalar
// work itself, per tensor:
//   lr_t = lr * sqrtf(1 - beta2_pow) / (1 - beta1_pow)   (IEEE sqrt, div)
//   p = p - lr_t * m / (sqrt(v) + eps) - (lr * coeff) * p_old   (AdamW's
//       decoupled decay when coeff != 0, p_old read before the update;
//       with 16-bit p, as the JAX op computes it in p's dtype: lr, coeff,
//       the updated p and each product and difference of the decay
//       rounded to p's dtype)
//   beta1_pow *= b1, beta2_pow *= b2   (once per tensor, after every block
//       has read them: the last block to finish, by an atomic ticket)
// each product, sum and quotient rounded on its own in float32 in the
// order of the per-op plain version (ops/cuda/optimizer.py
// adam_multi_plain), so the kernel gives its bits.  p, m, v and the powers
// are overwritten in place; lr and the powers are read from device memory,
// so nothing waits for the host.
//
// The guarded training step (paddle_tpu_torch/framework/guardrails.py)
// passes its verdict as an optional device int `skip`: when it holds a
// nonzero value every block returns before its first store, so p, m, v
// and the beta powers stay bit for bit (the JAX package selects the old
// state after the update; here the update is in place, and a copy of the
// whole state each step would double it).  Every block reads the same
// word, so either all return or none does, and the powers' ticket is
// left untouched.
//
// Operand dtypes, as the TPU kernel takes them: p float32, bfloat16 or
// float16; m and v each float32 or p's dtype; g m's dtype (the op casts the
// gradient first, as the JAX op does).  The launch is templated per dtype
// combination (9 instantiations) rather than carrying a dtype code per
// table row: a run's rows then share one load/store path with no branch
// per element, the float32 instantiation is the code it was before, and
// the table row keeps its 88 bytes.  A run that mixes dtypes is split by
// the caller into one launch per combination.
//
// The tensor table (pointers, count, hyperparameters) is passed by value as
// a kernel parameter (sm_90 with CUDA >= 12.1 takes 32,764 bytes of them:
// kMaxTensors entries of 88 bytes); a longer run is split by the caller.
// Blocks walk a chunk list of (tensor, chunk) pairs of `chunk` elements
// (the caller's choice: 16 K, 6,800 blocks for BERT-base; 64 K ran 1.5 %
// slower on an H100), which holds no pointers, so the caller builds it once
// per run of element counts and keeps it on the device.  Each tensor is
// read four elements to a vector access (16 bytes in float32, 8 in 16
// bits) when its four pointers are aligned to that, in scalars otherwise.
//
// Bound on an H100: bytes.  Per element p, g, m, v are read and p, m, v
// written: 28 B in float32, decay or not (0.9203 ms for BERT-base's
// 110.1 M parameters at 3.35 TB/s); 24 B with 16-bit p and float32 m, v;
// 14 B with all four in 16 bits.
#include <stdint.h>
#include <string.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTensors = 256;  // ops/cuda/optimizer.py MAX_TENSORS

// one tensor's update; the layout is the Python wrapper's table row.  The
// pointers' element types are the launch's template arguments: p TP, g and
// m TM, v TV.
struct AdamTensor {
  void* p;
  const void* g;
  void* m;
  void* v;
  const float* lr;
  float* beta1_pow;
  float* beta2_pow;
  long long n;
  float b1, omb1, b2, omb2, eps, coeff;  // omb = float(1 - b), in double
};
static_assert(sizeof(AdamTensor) == 88, "the wrapper's table row");

struct AdamTable {
  AdamTensor t[kMaxTensors];
  uint32_t vec[kMaxTensors / 32];  // bit i: tensor i's pointers aligned
                                   // to four of their elements
  int count;
};
static_assert(sizeof(AdamTable) <= 32000, "kernel parameter space");

__device__ unsigned int g_ticket = 0;  // blocks done; reset by the last one

// p's AdamW decay is applied in p's dtype TP, as the JAX op subtracts it
// from the rounded ParamOut: p_new rounded, (lr * coeff) * p_old rounded,
// the difference rounded (pt_round is the identity for float32).
template <typename TP>
__device__ __forceinline__ void adam_one(float& p, float g, float& m,
                                         float& v, float lr_t, float decay,
                                         const AdamTensor& a) {
  m = __fadd_rn(__fmul_rn(m, a.b1), __fmul_rn(g, a.omb1));
  v = __fadd_rn(__fmul_rn(v, a.b2), __fmul_rn(__fmul_rn(g, a.omb2), g));
  const float p_new = pt_round<TP>(__fsub_rn(
      p, __fdiv_rn(__fmul_rn(lr_t, m), __fadd_rn(__fsqrt_rn(v), a.eps))));
  p = decay != 0.f
          ? pt_round<TP>(__fsub_rn(p_new, pt_round<TP>(__fmul_rn(decay, p))))
          : p_new;
}

template <typename TP, typename TM, typename TV>
__global__ void __launch_bounds__(kThreads)
    adam_multi_kernel(const AdamTable tab, const int2* __restrict__ chunks,
                      int chunk, const int* __restrict__ skip) {
  if (skip != nullptr && *skip != 0) return;  // a skipped step
  const int2 ch = chunks[blockIdx.x];  // (tensor, chunk of it)
  const AdamTensor& a = tab.t[ch.x];
  TP* const P = static_cast<TP*>(a.p);
  const TM* const G = static_cast<const TM*>(a.g);
  TM* const M = static_cast<TM*>(a.m);
  TV* const V = static_cast<TV*>(a.v);
  const float lr = *a.lr;
  const float lr_t = __fdiv_rn(
      __fmul_rn(lr, __fsqrt_rn(__fsub_rn(1.f, *a.beta2_pow))),
      __fsub_rn(1.f, *a.beta1_pow));
  // lr and coeff in p's dtype first, as the JAX op multiplies them
  const float decay =
      a.coeff != 0.f
          ? pt_round<TP>(__fmul_rn(pt_round<TP>(lr), pt_round<TP>(a.coeff)))
          : 0.f;
  const long long begin = static_cast<long long>(ch.y) * chunk;
  const long long end = min(a.n, begin + chunk);
  long long tail = begin;
  if ((tab.vec[ch.x / 32] >> (ch.x % 32)) & 1u) {
    tail = begin + ((end - begin) & ~3LL);
    for (long long i = begin + 4 * threadIdx.x; i < tail;
         i += 4 * kThreads) {
      float pp[4], gg[4], mm[4], vv[4];
      pt_load_n<4>(P + i, pp);
      pt_load_n<4>(G + i, gg);
      pt_load_n<4>(M + i, mm);
      pt_load_n<4>(V + i, vv);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        adam_one<TP>(pp[j], gg[j], mm[j], vv[j], lr_t, decay, a);
      pt_store_n<4>(P + i, pp);
      pt_store_n<4>(M + i, mm);
      pt_store_n<4>(V + i, vv);
    }
  }
  for (long long i = tail + threadIdx.x; i < end; i += kThreads) {
    float pp = pt_load(P + i), mm = pt_load(M + i), vv = pt_load(V + i);
    adam_one<TP>(pp, pt_load(G + i), mm, vv, lr_t, decay, a);
    pt_store(P + i, pp);
    pt_store(M + i, mm);
    pt_store(V + i, vv);
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

template <typename TP, typename TM, typename TV>
cudaError_t launch(const AdamTable& tab, const int2* chunks, int nchunks,
                   int chunk, const int* skip, cudaStream_t stream) {
  adam_multi_kernel<TP, TM, TV>
      <<<static_cast<unsigned>(nchunks), kThreads, 0, stream>>>(
          tab, chunks, chunk, skip);
  return cudaGetLastError();
}

bool known_dtype(int code) {
  return code == PT_F32 || code == PT_BF16 || code == PT_F16;
}

size_t dtype_bytes(int code) { return code == PT_F32 ? 4 : 2; }

// m (and with it g) and v each of float32 or p's dtype
template <typename TP>
cudaError_t launch_for(int p_dtype, int m_dtype, int v_dtype,
                       const AdamTable& tab, const int2* chunks,
                       int nchunks, int chunk, const int* skip,
                       cudaStream_t stream) {
  const bool m32 = m_dtype == PT_F32, v32 = v_dtype == PT_F32;
  if (!m32 && m_dtype != p_dtype) return cudaErrorInvalidValue;
  if (!v32 && v_dtype != p_dtype) return cudaErrorInvalidValue;
  if (m32 && v32)
    return launch<TP, float, float>(tab, chunks, nchunks, chunk, skip,
                                    stream);
  if (m32)
    return launch<TP, float, TP>(tab, chunks, nchunks, chunk, skip, stream);
  if (v32)
    return launch<TP, TP, float>(tab, chunks, nchunks, chunk, skip, stream);
  return launch<TP, TP, TP>(tab, chunks, nchunks, chunk, skip, stream);
}

}  // namespace

// In-place Adam over `count` tensors: `tensors` is a host array of
// AdamTensor rows (the wrapper's table), `chunks` a device array of
// `nchunks` (tensor, chunk) int pairs covering every tensor's elements in
// pieces of `chunk` (a multiple of 4).  Every row's p is of dtype code
// `p_dtype`, its g and m of `m_dtype`, its v of `v_dtype` (PtDtype; m and v
// each float32 or p's).  No two rows may share a parameter, moment or beta
// power.  `skip` is null or a device int: nonzero, nothing is written.
extern "C" int pt_adam_multi(const void* tensors, int count,
                             const void* chunks, int nchunks, int chunk,
                             int p_dtype, int m_dtype, int v_dtype,
                             const void* skip, void* stream) {
  if (count < 1 || count > kMaxTensors || nchunks < 1 || chunk < 4 ||
      chunk % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!known_dtype(p_dtype) || !known_dtype(m_dtype) ||
      !known_dtype(v_dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  AdamTable tab;
  memset(&tab, 0, sizeof(tab));
  memcpy(tab.t, tensors, sizeof(AdamTensor) * count);
  tab.count = count;
  const size_t pv = 4 * dtype_bytes(p_dtype), mv = 4 * dtype_bytes(m_dtype),
               vv = 4 * dtype_bytes(v_dtype);
  for (int i = 0; i < count; ++i) {
    const AdamTensor& e = tab.t[i];
    if (e.n < 1) return static_cast<int>(cudaErrorInvalidValue);
    if (pt_aligned(e.p, pv) && pt_aligned(e.g, mv) && pt_aligned(e.m, mv) &&
        pt_aligned(e.v, vv))
      tab.vec[i / 32] |= 1u << (i % 32);
  }
  const int2* ch = static_cast<const int2*>(chunks);
  const int* sk = static_cast<const int*>(skip);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  if (p_dtype == PT_F32) {
    if (m_dtype != PT_F32 || v_dtype != PT_F32)
      return static_cast<int>(cudaErrorInvalidValue);
    rc = launch<float, float, float>(tab, ch, nchunks, chunk, sk, st);
  } else if (p_dtype == PT_BF16) {
    rc = launch_for<__nv_bfloat16>(p_dtype, m_dtype, v_dtype, tab, ch,
                                   nchunks, chunk, sk, st);
  } else {
    rc = launch_for<__half>(p_dtype, m_dtype, v_dtype, tab, ch, nchunks,
                            chunk, sk, st);
  }
  return static_cast<int>(rc);
}
