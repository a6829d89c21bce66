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
// and written once, and the work is ~8 operations per element (~17 in the
// backward), far below the ~20 FLOP/byte the card needs before arithmetic
// matters.
//
// Row layout, both directions: a row lives in the registers of one warp,
// or of a fixed group of 2-16 warps when D > 768.  Each lane holds
// `kChunks` (2, 4 or 6) slices of 4 columns, read as one 16-byte (float32)
// or 8-byte (bfloat16) vector each when every pointer is aligned for it,
// as four coalesced scalars otherwise (chunk_col).  ln_row_layout in
// ops/cuda/fused_ops.py picks (chunks, group_warps) for both.  Sums come
// from shuffle trees; a multi-warp group adds its warps' sums in warp
// order through a few floats of shared memory under its own named barrier
// (group_sum).
//
// Forward design (ln_fwd_kernel; it replaces a first port that gave each
// row a block of 128 threads, staged the row in shared memory and took
// two block reductions, four block barriers a row).  At BERT's shapes
// (R <= 4096, D = 768) the bound is 2-11 us, near a launch, so what
// counts is the latency of one row's chain (load, two reductions, store)
// and how many rows are in flight at once.
//  * One row group takes one row, in registers: no shared-memory copy of
//    the row and no __syncthreads.  The residual variant adds b in float32
//    as it loads.
//  * Statistics in float32 as _ln_fwd_kernel takes them: the sum, then the
//    mean, then the sum of (u - mean)^2 from the registers (two passes,
//    never E[u^2] - mean^2), rsqrt(var + eps), y = fma(xhat, scale, bias)
//    rounded once to the output dtype.
//  * scale and bias are read as vectors in the output pass only, after
//    the reductions: every warp of an SM reads the same columns, so after
//    the first warp they come from L1, and keeping them in registers would
//    cost 8 * kChunks registers a lane.
//  * Blocks of 8 warps, 4 up to R = 1024 (more SMs share a small grid),
//    or of the one row group of 8 or 16 warps; ceil(R / groups) of them,
//    a function of (R, D) alone (ln_fwd_plan), and the bits of a row
//    depend on D and the alignment alone.  Held to 64 registers a thread,
//    32 warps fit on an SM, so R = 4096 rows of D = 768 run as one wave
//    on 132 SMs.
//  * A programmatic dependent launch: the grid may be scheduled while the
//    kernel before it drains, and waits in griddepcontrol.wait before it
//    touches device memory.
//
// Backward design (ln_bwd_rows_kernel, then ln_bwd_colsum_kernel).  Bound:
// bytes (x, dy and, residual, b read; dx written).  The TPU kernel sums
// dscale/dbias across row blocks in scratch carried over its sequential
// grid; blocks here run in parallel, so the sums take two deterministic
// stages.
//  * Each lane holds its slices of x (+ b) and dy.  Mean, variance
//    (recomputed in float32, mean first, as _ln_bwd_kernel does),
//    mean(dy*s) and mean(dy*s*xhat) come from the row layout's sums.  No
//    __syncthreads on the per-row path; dx =
//    rstd * (dy*s - mean(dy*s) - xhat * mean(dy*s*xhat)) is written from
//    registers.  scale is copied to shared memory once per block
//    (cp.async, while the first row's loads are in flight).
//  * Bytes in flight: 8 row groups per block of 256 threads (16 warps for
//    D > 6144), two blocks per SM (the kernel is held to 128 registers a
//    thread), so ~16 rows of loads are outstanding on each SM.  With
//    three inputs a row, the residual variant has no registers left to
//    keep them all in flight, so it stages each row in shared memory with
//    cp.async and starts the next row's copy before it reduces the
//    current one.  The plain variant loads straight into registers:
//    staging its two inputs measured slower, as the shared-memory traffic
//    doubles.
//  * Each lane adds dy*xhat and dy of its columns over every row its group
//    takes, in registers; at the end every row group writes its sums to
//    its own slice of shared memory and the block adds the slices of each
//    column in group order into one float32 partial row,
//    partial[block][2][D] (a group-by-group running sum serialised the
//    block behind eight barriers).  The grid is a function of (rows, D)
//    alone, at most 256 blocks (ln_bwd_plan in ops/cuda/fused_ops.py),
//    never of the device's SM count, so the bits are the same on every
//    card.
//  * ln_bwd_colsum_kernel adds the partials of each column in a fixed
//    order: a block takes 32 of the 2D columns and its 8 warps take every
//    8th partial row, 8 loads in flight at a time, then add their sums in
//    warp order.  It is a programmatic dependent launch: the row pass lets
//    it be scheduled once every row is done (earlier, its blocks stood in
//    the way of the row pass), and it waits in griddepcontrol.wait for the
//    row pass's writes, so the launch gap between the two is hidden.
// The residual variant adds b to x in float32 as the row is read, so the
// sum never reaches device memory in the backward either.
#include "common.cuh"

#include <type_traits>

namespace {

constexpr int kMaxRowWarps = 16;   // warps of the widest row group (D > 6144)
constexpr int kFwdBlocksPerSm = 2; // forward: 2 blocks of 512 threads (32
                                   // warps) an SM: at most 64 registers
constexpr int kBlockWarps = 8;     // warps of a backward block (or its group)
constexpr int kSumWarps = 8;       // warps of a column-sum block
constexpr int kSumLoads = 8;       // loads each of them keeps in flight

// ---------------------------------------------------------------------------
// the row layout
// ---------------------------------------------------------------------------

// Column of element j of the 4-column slice a lane holds of 128-column
// chunk k: with kVec4 128 k + 4 lane + j (one vector access), otherwise
// 128 k + 32 j + lane (four coalesced scalar accesses).
template <bool kVec4>
__device__ __forceinline__ int chunk_col(int k, int lane, int j) {
  return kVec4 ? k * 128 + lane * 4 + j : k * 128 + j * 32 + lane;
}

template <bool kVec4, typename T>
__device__ __forceinline__ void load4(const T* row, int k, int lane,
                                      float* v) {
  if constexpr (kVec4) {
    pt_load_n<4>(row + chunk_col<true>(k, lane, 0), v);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = pt_load(row + chunk_col<false>(k, lane, j));
  }
}

template <bool kVec4, typename T>
__device__ __forceinline__ void store4(T* row, int k, int lane,
                                       const float* v) {
  if constexpr (kVec4) {
    pt_store_n<4>(row + chunk_col<true>(k, lane, 0), v);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      pt_store(row + chunk_col<false>(k, lane, j), v[j]);
  }
}

// Asynchronous copy of kBytes (4, 8 or 16, both addresses aligned to it)
// from device to shared memory; cp_async_wait() waits for this thread's.
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(s),
               "l"(src), "n"(kBytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Sums of kN values over the warps of row group `grp`, returned to all
// its lanes: a shuffle tree in each warp (every lane ends with the same
// bits); with more than one warp a row, the warps' sums go through
// `xchg` and are added in warp order.  `xchg` alternates between two
// buffers, so one barrier a reduction suffices: a warp overwrites a buffer
// only after the next reduction's barrier, which its whole group reaches
// only after reading it.
template <int kN>
__device__ __forceinline__ void group_sum(float* v,
                                          float (*xchg)[kMaxRowWarps][2],
                                          int& phase, int group_warps,
                                          int grp) {
#pragma unroll
  for (int i = 0; i < kN; ++i) v[i] = pt_warp_sum(v[i]);
  if (group_warps == 1) return;
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int i = 0; i < kN; ++i) xchg[phase][warp][i] = v[i];
  }
  asm volatile("bar.sync %0, %1;" ::"r"(1 + grp), "r"(group_warps * 32)
               : "memory");
  const int first = grp * group_warps;
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    float t = 0.f;
    for (int w = 0; w < group_warps; ++w) t += xchg[phase][first + w][i];
    v[i] = t;
  }
  phase ^= 1;
}

// Calls f(std::integral_constant<int, chunks>(), std::bool_constant<vec4>())
// for the runtime (chunks, vec4): the kernels are instantiated for chunks
// 2, 4 and 6 (the entry points refuse any other), vectors or scalars.
template <typename F>
cudaError_t with_layout(int chunks, bool vec4, F&& f) {
  auto v = [&](auto c) {
    return vec4 ? f(c, std::true_type()) : f(c, std::false_type());
  };
  if (chunks == 2) return v(std::integral_constant<int, 2>());
  if (chunks == 4) return v(std::integral_constant<int, 4>());
  return v(std::integral_constant<int, 6>());
}

// Whether a row layout is one the kernels take: chunks * group_warps
// 128-column chunks cover the row, the group is 1-16 warps (a power of
// two) and the block a whole number of groups of at most 16 warps.
bool layout_ok(int d, int chunks, int group_warps, int block_warps) {
  const bool group_ok = group_warps == 1 || group_warps == 2 ||
                        group_warps == 4 || group_warps == 8 ||
                        group_warps == kMaxRowWarps;
  return d > 0 && d % 128 == 0 && d <= 8192 &&
         (chunks == 2 || chunks == 4 || chunks == 6) && group_ok &&
         chunks * group_warps * 128 >= d && block_warps >= group_warps &&
         block_warps <= kMaxRowWarps && block_warps % group_warps == 0;
}

// Launches `kernel` on `stream` as a programmatic dependent of the kernel
// before it: the grid may be scheduled while that kernel drains, and must
// wait in griddepcontrol.wait before it touches what that kernel writes.
template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), int blocks,
                             int threads, cudaStream_t stream,
                             Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// Row `blockIdx.x * groups + grp` of a (+ b), normalised into y by row
// group `grp` of `group_warps` warps; a lane's 4-column slices are chunks
// wg, wg + group_warps, ... of the row (wg: its warp in the group).
template <typename T, bool kResidual, int kChunks, bool kVec4>
__global__ void __launch_bounds__(kMaxRowWarps * 32, kFwdBlocksPerSm)
    ln_fwd_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  const T* __restrict__ scale, const T* __restrict__ bias,
                  T* __restrict__ y, int rows, int d, int group_warps,
                  float eps) {
  __shared__ float xchg[2][kMaxRowWarps][2];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = warp / group_warps;
  const int wg = warp % group_warps;
  const int r = blockIdx.x * ((blockDim.x >> 5) / group_warps) + grp;
  // launched as a programmatic dependent: the grid may be scheduled while
  // the kernel before it drains, and waits here, before reading or
  // writing device memory, until that kernel's writes are visible
  asm volatile("griddepcontrol.wait;" ::: "memory");
  // a whole group leaves together; its barrier counts its own warps only
  if (r >= rows) return;
  const int nk = d >> 7;  // 128-column chunks of a row
  const size_t base = static_cast<size_t>(r) * d;
  float u[kChunks * 4];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int k = c * group_warps + wg;
    if (k < nk) load4<kVec4>(a + base, k, lane, u + 4 * c);
  }
  if constexpr (kResidual) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int k = c * group_warps + wg;
      if (k >= nk) continue;
      float t[4];
      load4<kVec4>(b + base, k, lane, t);
#pragma unroll
      for (int j = 0; j < 4; ++j) u[4 * c + j] += t[j];
    }
  }
  float acc[1] = {0.f};
  int phase = 0;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    if (c * group_warps + wg < nk) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[0] += u[4 * c + j];
    }
  }
  group_sum<1>(acc, xchg, phase, group_warps, grp);
  const float mean = acc[0] / d;
  acc[0] = 0.f;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    if (c * group_warps + wg < nk) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        u[4 * c + j] -= mean;
        acc[0] = fmaf(u[4 * c + j], u[4 * c + j], acc[0]);
      }
    }
  }
  group_sum<1>(acc, xchg, phase, group_warps, grp);
  const float rstd = rsqrtf(acc[0] / d + eps);
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int k = c * group_warps + wg;
    if (k >= nk) continue;
    float s[4], o[4];
    load4<kVec4>(scale, k, lane, s);
    load4<kVec4>(bias, k, lane, o);
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j] = fmaf(u[4 * c + j] * rstd, s[j], o[j]);
    store4<kVec4>(y + base, k, lane, o);
  }
}

template <typename T, bool kResidual>
cudaError_t launch_fwd(const void* a, const void* b, const void* scale,
                       const void* bias, void* y, int rows, int d,
                       int chunks, int group_warps, int block_warps,
                       int blocks, float eps, cudaStream_t stream) {
  // d % 128 == 0, so every row starts as aligned as its tensor does
  const size_t vec_bytes = 4 * sizeof(T);
  const bool vec4 = pt_aligned(a, vec_bytes) &&
                    (!kResidual || pt_aligned(b, vec_bytes)) &&
                    pt_aligned(scale, vec_bytes) &&
                    pt_aligned(bias, vec_bytes) && pt_aligned(y, vec_bytes);
  return with_layout(chunks, vec4, [&](auto c, auto v) {
    return launch_dependent(
        ln_fwd_kernel<T, kResidual, decltype(c)::value, decltype(v)::value>,
        blocks, block_warps * 32, stream, static_cast<const T*>(a),
        static_cast<const T*>(b), static_cast<const T*>(scale),
        static_cast<const T*>(bias), static_cast<T*>(y), rows, d,
        group_warps, eps);
  });
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// Shared memory a row group needs per column: the residual variant's row
// buffers x, dy, b of T, which the epilogue reuses for the group's float32
// dscale, dbias sums.
template <typename T, bool kResidual>
__host__ __device__ constexpr size_t row_bytes() {
  return kResidual && 3 * sizeof(T) > 2 * sizeof(float) ? 3 * sizeof(T)
                                                        : 2 * sizeof(float);
}

// The plain variant: one lane's slices of row `base` of x and dy straight
// into registers u and g.
template <typename T, int kChunks, bool kVec4>
__device__ __forceinline__ void load_row(const T* x, const T* dy,
                                         size_t base, int nk,
                                         int group_warps, int wg, int lane,
                                         float* u, float* g) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int k = c * group_warps + wg;
    if (k >= nk) continue;
    load4<kVec4>(x + base, k, lane, u + 4 * c);
    load4<kVec4>(dy + base, k, lane, g + 4 * c);
  }
}

// The residual variant: one lane's slices of row `base` of x, dy and b
// into its row group's buffer buf[3][d] of shared memory, at their own
// columns: asynchronous 16- or 8-byte copies with kVec4, plain loads
// otherwise.  A lane reads back only what it staged, so no barrier is
// needed.
template <typename T, int kChunks, bool kVec4>
__device__ __forceinline__ void stage_row(T* buf, const T* x, const T* dy,
                                          const T* b, size_t base, int d,
                                          int nk, int group_warps, int wg,
                                          int lane) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int k = c * group_warps + wg;
    if (k >= nk) continue;
    if constexpr (kVec4) {
      const int col = chunk_col<true>(k, lane, 0);
      cp_async<4 * sizeof(T)>(buf + col, x + base + col);
      cp_async<4 * sizeof(T)>(buf + d + col, dy + base + col);
      cp_async<4 * sizeof(T)>(buf + 2 * d + col, b + base + col);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = chunk_col<false>(k, lane, j);
        buf[col] = x[base + col];
        buf[d + col] = dy[base + col];
        buf[2 * d + col] = b[base + col];
      }
    }
  }
}

// A lane's staged slices as float32: u = x + b, g = dy.
template <typename T, int kChunks, bool kVec4>
__device__ __forceinline__ void read_row(const T* buf, int d, int nk,
                                         int group_warps, int wg, int lane,
                                         float* u, float* g) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int k = c * group_warps + wg;
    if (k >= nk) continue;
    float t[4];
    load4<kVec4>(buf, k, lane, u + 4 * c);
    load4<kVec4>(buf + d, k, lane, g + 4 * c);
    load4<kVec4>(buf + 2 * d, k, lane, t);
#pragma unroll
    for (int j = 0; j < 4; ++j) u[4 * c + j] += t[j];
  }
}

// Rows [blockIdx.x * rows_per_block, ...) of x (+ b): row group `grp` (of
// `group_warps` warps) takes every (blockDim.x / 32 / group_warps)-th of
// them; writes dx and the block's partial[2][d] of dscale, dbias.  The
// residual variant stages each row in shared memory, and the next row's
// copy is in flight while the current one is reduced.
template <typename T, bool kResidual, int kChunks, bool kVec4>
__global__ void __launch_bounds__(kMaxRowWarps * 32, 1)
    ln_bwd_rows_kernel(const T* __restrict__ x, const T* __restrict__ b,
                       const T* __restrict__ scale,
                       const T* __restrict__ dy, T* __restrict__ dx,
                       float* __restrict__ partial, int rows, int d,
                       int rows_per_block, int group_warps, float eps) {
  // per row group, row_bytes() a column: the residual variant's row
  // buffer [3][d] of T, then the group's dscale, dbias sums [2][d] of
  // float; after them scale[d] of T
  extern __shared__ float4 smem[];
  __shared__ float xchg[2][kMaxRowWarps][2];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = warp / group_warps;
  const int wg = warp % group_warps;
  const int groups = (blockDim.x >> 5) / group_warps;
  const int nk = d >> 7;  // 128-column chunks of a row
  T* rowbuf = reinterpret_cast<T*>(smem) + 3 * grp * d;
  float* sums = reinterpret_cast<float*>(smem);
  T* sc_s = reinterpret_cast<T*>(reinterpret_cast<char*>(smem) +
                                 groups * d * row_bytes<T, kResidual>());
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(rows, r0 + rows_per_block);
  if constexpr (kVec4) {
    for (int i = 4 * threadIdx.x; i < d; i += 4 * blockDim.x)
      cp_async<4 * sizeof(T)>(sc_s + i, scale + i);
  } else {
    for (int i = threadIdx.x; i < d; i += blockDim.x) sc_s[i] = scale[i];
  }
  float u[kChunks * 4], g[kChunks * 4];
  int r = r0 + grp;
  if (r < r1) {
    if constexpr (kResidual)
      stage_row<T, kChunks, kVec4>(rowbuf, x, dy, b,
                                   static_cast<size_t>(r) * d, d, nk,
                                   group_warps, wg, lane);
    else
      load_row<T, kChunks, kVec4>(x, dy, static_cast<size_t>(r) * d, nk,
                                  group_warps, wg, lane, u, g);
  }
  cp_async_wait();
  __syncthreads();  // scale is staged (each lane's row slices need none)
  float ds[kChunks * 4], db[kChunks * 4];
#pragma unroll
  for (int i = 0; i < kChunks * 4; ++i) ds[i] = db[i] = 0.f;
  int phase = 0;
  for (; r < r1; r += groups) {
    const size_t base = static_cast<size_t>(r) * d;
    if constexpr (kResidual) {
      read_row<T, kChunks, kVec4>(rowbuf, d, nk, group_warps, wg, lane, u,
                                  g);
      // the next row's copy overwrites only what this lane has just read;
      // the warp barrier orders those reads before the copy's writes
      __syncwarp();
      if (r + groups < r1)
        stage_row<T, kChunks, kVec4>(rowbuf, x, dy, b,
                                     static_cast<size_t>(r + groups) * d, d,
                                     nk, group_warps, wg, lane);
    }
    float acc[2] = {0.f, 0.f};
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if (c * group_warps + wg < nk) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[0] += u[4 * c + j];
      }
    }
    group_sum<1>(acc, xchg, phase, group_warps, grp);
    const float mean = acc[0] / d;
    acc[0] = 0.f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if (c * group_warps + wg < nk) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float t = u[4 * c + j] - mean;
          acc[0] += t * t;
        }
      }
    }
    group_sum<1>(acc, xchg, phase, group_warps, grp);
    const float rstd = rsqrtf(acc[0] / d + eps);
    acc[0] = 0.f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int k = c * group_warps + wg;
      if (k < nk) {
        float sc[4];
        load4<kVec4>(sc_s, k, lane, sc);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = 4 * c + j;
          const float xh = (u[i] - mean) * rstd;
          const float gs = g[i] * sc[j];
          ds[i] += g[i] * xh;
          db[i] += g[i];
          acc[0] += gs;
          acc[1] += gs * xh;
          u[i] = xh;
          g[i] = gs;
        }
      }
    }
    group_sum<2>(acc, xchg, phase, group_warps, grp);
    const float m1 = acc[0] / d;
    const float m2 = acc[1] / d;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int k = c * group_warps + wg;
      if (k < nk) {
        float o[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          o[j] = rstd * (g[4 * c + j] - m1 - u[4 * c + j] * m2);
        store4<kVec4>(dx + base, k, lane, o);
      }
    }
    if constexpr (kResidual) {
      cp_async_wait();
    } else if (r + groups < r1) {
      load_row<T, kChunks, kVec4>(x, dy, static_cast<size_t>(r + groups) * d,
                                  nk, group_warps, wg, lane, u, g);
    }
  }
  // the column sum may be scheduled now (it waits for this grid's writes)
  asm volatile("griddepcontrol.launch_dependents;");
  // the block's partial row: each row group's sums into its own slice
  // (over the row buffers, once every group is done with them), then the
  // slices of each column added in group order
  __syncthreads();
  float* mine = sums + 2 * grp * d;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int k = c * group_warps + wg;
    if (k < nk) {
      store4<kVec4>(mine, k, lane, ds + 4 * c);
      store4<kVec4>(mine + d, k, lane, db + 4 * c);
    }
  }
  __syncthreads();
  float* out = partial + static_cast<size_t>(blockIdx.x) * 2 * d;
  for (int i = 4 * threadIdx.x; i < 2 * d; i += 4 * blockDim.x) {
    float4 t = *reinterpret_cast<const float4*>(sums + i);
    for (int gi = 1; gi < groups; ++gi) {
      const float4 v = *reinterpret_cast<const float4*>(sums + 2 * gi * d + i);
      t.x += v.x;
      t.y += v.y;
      t.z += v.z;
      t.w += v.w;
    }
    *reinterpret_cast<float4*>(out + i) = t;
  }
}

// dscale[c] (c < d) and dbias[c - d] (c >= d): the column sums of the
// blocks' partials.  A block takes 32 of the 2d columns; warp w adds
// partial rows w, w + 8, ... in that order, then the warp sums are added
// in warp order — the same order every run.
template <typename T>
__global__ void __launch_bounds__(kSumWarps * 32)
    ln_bwd_colsum_kernel(const float* __restrict__ partial,
                         T* __restrict__ dscale, T* __restrict__ dbias,
                         int nblocks, int d) {
  __shared__ float sums[kSumWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;  // 2d % 32 == 0: always < 2d
  const size_t stride = 2 * static_cast<size_t>(d);
  // launched as the row pass's programmatic dependent: wait for its writes
  asm volatile("griddepcontrol.wait;" ::: "memory");
  float acc = 0.f;
  for (int b0 = warp; b0 < nblocks; b0 += kSumLoads * kSumWarps) {
    float v[kSumLoads];
#pragma unroll
    for (int i = 0; i < kSumLoads; ++i) {
      const int blk = b0 + i * kSumWarps;
      v[i] = blk < nblocks ? partial[blk * stride + c] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kSumLoads; ++i) acc += v[i];
  }
  sums[warp][lane] = acc;
  __syncthreads();
  if (warp == 0) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kSumWarps; ++w) total += sums[w][lane];
    pt_store(c < d ? dscale + c : dbias + (c - d), total);
  }
}

template <typename T, bool kResidual, int kChunks, bool kVec4>
cudaError_t launch_rows(const void* x, const void* b, const void* scale,
                        const void* dy, void* dx, void* partial, int rows,
                        int d, int group_warps, int rows_per_block,
                        int nblocks, float eps, cudaStream_t stream) {
  auto kernel = ln_bwd_rows_kernel<T, kResidual, kChunks, kVec4>;
  const int warps = group_warps > kBlockWarps ? group_warps : kBlockWarps;
  const size_t smem = static_cast<size_t>(d) *
                      (warps / group_warps * row_bytes<T, kResidual>() +
                       sizeof(T));
  if (smem > 40 * 1024) {  // 48 KB with the static part needs opting in
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int threads = 32 * warps;
  kernel<<<nblocks, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(b),
      static_cast<const T*>(scale), static_cast<const T*>(dy),
      static_cast<T*>(dx), static_cast<float*>(partial), rows, d,
      rows_per_block, group_warps, eps);
  return cudaGetLastError();
}

template <typename T, bool kResidual>
cudaError_t launch_bwd(const void* x, const void* b, const void* scale,
                       const void* dy, void* dx, void* dscale, void* dbias,
                       void* partial, int rows, int d, int chunks,
                       int group_warps, int rows_per_block, int nblocks,
                       float eps, cudaStream_t stream) {
  // d % 128 == 0, so every row starts as aligned as its tensor does
  const size_t vec_bytes = 4 * sizeof(T);
  const bool vec4 = pt_aligned(x, vec_bytes) &&
                    (!kResidual || pt_aligned(b, vec_bytes)) &&
                    pt_aligned(scale, vec_bytes) &&
                    pt_aligned(dy, vec_bytes) && pt_aligned(dx, vec_bytes);
  const cudaError_t err = with_layout(chunks, vec4, [&](auto c, auto v) {
    return launch_rows<T, kResidual, decltype(c)::value, decltype(v)::value>(
        x, b, scale, dy, dx, partial, rows, d, group_warps, rows_per_block,
        nblocks, eps, stream);
  });
  if (err != cudaSuccess) return err;
  // the column sum is scheduled while the row pass runs and waits in
  // griddepcontrol.wait for all of its writes
  return launch_dependent(ln_bwd_colsum_kernel<T>, 2 * d / 32,
                          kSumWarps * 32, stream,
                          static_cast<const float*>(partial),
                          static_cast<T*>(dscale), static_cast<T*>(dbias),
                          nblocks, d);
}

// Calls f(T-typed tag, std::bool_constant<residual>()) for `dtype` and
// whether `b` is given; cudaErrorInvalidValue for any other dtype.
template <typename F>
cudaError_t with_types(int dtype, const void* b, F&& f) {
  auto r = [&](auto t) {
    return b ? f(t, std::true_type()) : f(t, std::false_type());
  };
  if (dtype == PT_F32) return r(float());
  if (dtype == PT_BF16) return r(__nv_bfloat16());
  return cudaErrorInvalidValue;
}

}  // namespace

// y[rows, d] = LN(a (+ b)) * scale + bias.  `b` may be NULL (plain LN).
// The launch is ln_fwd_plan's (ops/cuda/fused_ops.py): each lane holds
// `chunks` (2, 4 or 6) 4-column slices of a row shared by `group_warps`
// (1, 2, 4, 8 or 16) warps, with chunks * group_warps * 128 >= d; `blocks`
// blocks of `block_warps` warps, one row to each row group, so
// blocks = ceil(rows / (block_warps / group_warps)).  Requires d % 128 == 0
// and d <= 8192 (the Python wrapper's gate, re-checked here); all tensors
// contiguous, of the dtype `dtype` names.
extern "C" int pt_layer_norm_fwd(int dtype, const void* a, const void* b,
                                 const void* scale, const void* bias,
                                 void* y, int rows, int d, int chunks,
                                 int group_warps, int block_warps,
                                 int blocks, float eps, void* stream) {
  if (!layout_ok(d, chunks, group_warps, block_warps) || rows < 1 ||
      blocks != (rows - 1) / (block_warps / group_warps) + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_types(dtype, b, [&](auto t, auto res) {
    return launch_fwd<decltype(t), decltype(res)::value>(
        a, b, scale, bias, y, rows, d, chunks, group_warps, block_warps,
        blocks, eps, s);
  }));
}

// LayerNorm backward over rows of x (+ b)[rows, d] with scale[d] and
// dy[rows, d]: dx[rows, d] (with `b`, the gradient of both addends) and
// dscale, dbias[d] (same dtype as x).  `b` may be NULL (plain LN).  The
// launch is ln_bwd_plan's (ops/cuda/fused_ops.py): the forward's row
// layout; blocks of max(8, group_warps) warps take `rows_per_block` rows
// each; `partial` is float32 scratch of [nblocks, 2, d] with
// nblocks = ceil(rows / rows_per_block).  Same width rule as the forward.
extern "C" int pt_layer_norm_bwd(int dtype, const void* x, const void* b,
                                 const void* scale, const void* dy, void* dx,
                                 void* dscale, void* dbias, void* partial,
                                 int rows, int d, int chunks,
                                 int group_warps, int rows_per_block,
                                 int nblocks, float eps, void* stream) {
  const int block_warps =
      group_warps > kBlockWarps ? group_warps : kBlockWarps;
  if (!layout_ok(d, chunks, group_warps, block_warps) || rows < 1 ||
      rows_per_block < 1 ||
      nblocks != (rows + rows_per_block - 1) / rows_per_block)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_types(dtype, b, [&](auto t, auto res) {
    return launch_bwd<decltype(t), decltype(res)::value>(
        x, b, scale, dy, dx, dscale, dbias, partial, rows, d, chunks,
        group_warps, rows_per_block, nblocks, eps, s);
  }));
}
