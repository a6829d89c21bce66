// Hopper (sm_90a) building blocks of the 16-bit flash attention kernels
// (flash_attention.cu, flash_attention_bwd.cu): mbarriers, TMA copies of
// tiles between device memory and 128-byte-swizzled shared memory (and the
// tensor maps that describe them), and warpgroup matrix products (wgmma)
// on those tiles.
//
// The shared-memory tiles.  A 16-bit matrix is staged as panels of 64
// columns (128 bytes a row), each panel [rows][64] with TMA's 128-byte
// swizzle: the 16-byte chunk c of row r lies at chunk c ^ (r % 8).  Every
// panel starts on a 1024-byte boundary, so the swizzle is a function of
// the address alone and a wgmma descriptor may start anywhere in it.  One
// such panel serves as either operand layout of wgmma:
// * K-major (the product's inner index along the row): the 8-row groups
//   1024 bytes apart; a 16-deep step starts 32 bytes further along the
//   row (q.k^T, k.q^T, v.do^T);
// * N-major (the inner index down the rows, wgmma's transposed 16-bit
//   operand): the 8-row groups 1024 bytes apart, 64-column panels
//   `panel` bytes apart; a 16-deep step starts 16 rows (2048 bytes)
//   further down (p.v, p^T.do, ds^T.q).
// A wgmma accumulator gives warp w of the warpgroup rows 16w + g and
// 16w + g + 8 (g = lane / 4) and, of each 8-column slice j, columns
// 8j + 2t and 8j + 2t + 1 (t = lane % 4) in d[4j .. 4j + 3], row-major
// within the slice: the m16n8 layout of mma.sync, which the dropout draw
// (flash_common.cuh fragment_keep) assumes.  Slices 2k and 2k + 1 of an
// accumulator, rounded to 16 bits, are the register A fragment of the
// k-th 16-deep step of a product that takes it as its left operand.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (declarations only)
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// p rounded up to a 1024-byte boundary of shared memory
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t a = smem_addr(p);
  return p + ((1024u - (a & 1023u)) & 1023u);
}

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// one arrival that also announces `bytes` of TMA traffic to come
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// wait for the phase of parity `phase` to complete
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t phase) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(phase)
        : "memory");
  __syncwarp();  // converged again for the warpgroup's .aligned products
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

// box (c0, c1, c2) of `map` into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// shared memory into box (c0, c1, c2) of `map`, in this thread's bulk group
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// until this thread's bulk stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// until this thread's bulk stores are complete
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// this thread's shared-memory writes, visible to the TMA unit and wgmma
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// descriptor of a 128-byte-swizzled operand at p: `lead` bytes between
// 64-column panels (N-major; unused K-major), `stride` bytes between
// 8-row groups
__device__ __forceinline__ uint64_t wg_desc(const void* p, uint32_t lead,
                                            uint32_t stride) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFFu) >> 4) |
         static_cast<uint64_t>((lead >> 4) & 0x3FFFu) << 16 |
         static_cast<uint64_t>((stride >> 4) & 0x3FFFu) << 32 |
         1ull << 62;  // 128-byte swizzle
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// until at most N of the warpgroup's product groups are in flight
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from reading an accumulator before the wait that
// completes it
template <int N>
__device__ __forceinline__ void wg_hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// two floats as one 16-bit pair, a in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack16(float a, float b) {
  if constexpr (std::is_same<T, __half>::value) {
    const __half2 h = __floats2half2_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&h);
  } else {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
}

// 2^x (MUFU.EX2; ~2 ulp, 0 at -inf)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

#define PT_WGMMA_SS32(TY) \
  asm volatile( \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n32k16.f32." #TY "." #TY " " \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, " \
  "%16, %17, p, 1, 1, 0, 0;\n}\n" \
  : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
    "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), \
    "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]) \
  : "l"(da), "l"(db), "r"(accumulate))

// d (+)= A.B, m64n32k16: A (64 x 16) and B (16 x 32) both read from
// shared memory through K-major descriptors; d = A.B when !accumulate
template <typename T>
__device__ __forceinline__ void wgmma_ss32(float (&d)[16], uint64_t da,
                                           uint64_t db, int accumulate) {
  if constexpr (std::is_same<T, __half>::value)
    PT_WGMMA_SS32(f16);
  else
    PT_WGMMA_SS32(bf16);
}

#define PT_WGMMA_SS64(TY) \
  asm volatile( \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32." #TY "." #TY " " \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29," \
  "%30, %31}, " \
  "%32, %33, p, 1, 1, 0, 0;\n}\n" \
  : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
    "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), \
    "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
    "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), \
    "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), \
    "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), \
    "+f"(d[31]) \
  : "l"(da), "l"(db), "r"(accumulate))

// d (+)= A.B, m64n64k16: A (64 x 16) and B (16 x 64) both read from
// shared memory through K-major descriptors; d = A.B when !accumulate
template <typename T>
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t da,
                                           uint64_t db, int accumulate) {
  if constexpr (std::is_same<T, __half>::value)
    PT_WGMMA_SS64(f16);
  else
    PT_WGMMA_SS64(bf16);
}

#define PT_WGMMA_RS64(TY) \
  asm volatile( \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32." #TY "." #TY " " \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29," \
  "%30, %31}, " \
  "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n" \
  : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
    "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), \
    "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
    "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), \
    "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), \
    "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), \
    "+f"(d[31]) \
  : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

// d += A.B, m64n64k16: A from registers (each warp the m16n8k16 A
// fragment of its 16 rows), B (16 x 64) from shared memory through an
// N-major (transposed) descriptor
template <typename T>
__device__ __forceinline__ void wgmma_rs64(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  if constexpr (std::is_same<T, __half>::value)
    PT_WGMMA_RS64(f16);
  else
    PT_WGMMA_RS64(bf16);
}

#define PT_WGMMA_RS128(TY) \
  asm volatile( \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n128k16.f32." #TY "." #TY " " \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29," \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43," \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57," \
  "%58, %59, %60, %61, %62, %63}, " \
  "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n" \
  : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
    "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), \
    "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
    "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), \
    "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), \
    "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), \
    "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
    "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), \
    "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), \
    "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), \
    "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
    "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), \
    "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
  : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

// d += A.B, m64n128k16: A from registers (each warp the m16n8k16 A
// fragment of its 16 rows), B (16 x 128) from shared memory through an
// N-major (transposed) descriptor
template <typename T>
__device__ __forceinline__ void wgmma_rs128(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  if constexpr (std::is_same<T, __half>::value)
    PT_WGMMA_RS128(f16);
  else
    PT_WGMMA_RS128(bf16);
}

// d += A.B with N = 64 or 128 (a head dim's dk, dv or output rows)
template <typename T, int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 64)
    wgmma_rs64<T>(d, a, db);
  else
    wgmma_rs128<T>(d, a, db);
}

// ---------------------------------------------------------------------------
// tensor maps (host)
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda)
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault) != cudaSuccess)
      p = nullptr;
#endif
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

template <typename T>
constexpr CUtensorMapDataType tma_type() {
  return std::is_same<T, float>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
         : std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// A map of the row-major [n][rows][cols] tensor at `base` (16-byte aligned,
// rows of cols * sizeof(T) bytes, a multiple of 16) read and written in
// boxes of box_rows x box_cols (box_cols * sizeof(T) = 128 bytes) with the
// 128-byte swizzle; boxes past `rows` read zeros, so a tile never reads the
// next matrix's rows.
template <typename T>
cudaError_t tile_map(CUtensorMap* map, const void* base, int n, int rows,
                     int cols, int box_rows, int box_cols) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(cols) * sizeof(T),
      static_cast<cuuint64_t>(rows) * cols * sizeof(T)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t one[3] = {1, 1, 1};
  const CUresult r = encode(
      map, tma_type<T>(), 3, const_cast<void*>(base), dims, strides, box, one,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace
