// Hopper (sm_90a) building blocks of the flash-attention kernels
// (flash_fwd.cu, flash_bwd.cu): TMA tensor maps and loads, mbarriers,
// named barriers, wgmma descriptors and products, warpgroup register
// reallocation, the bulk reduce-add, and the launchers' register check.
//
// Shared-memory tiles are [64 rows][64 bf16 columns], 128 bytes a row, in
// the 128-byte swizzle that TMA writes (16-byte chunk j of row r lands at
// chunk j ^ (r % 8)), each aligned to 1024 bytes; a 128-column head is two
// such tiles side by side in memory, and 128 rows are two tiles one after
// the other (8-row groups stay 1024 bytes apart).  One tile serves both
// majors of a wgmma operand:
//   - K-major (the product's depth runs along the 64 columns): 8-row groups
//     1024 bytes apart; k-step kk of 16 columns starts kk * 32 bytes in;
//   - MN-major (the depth runs along the rows, read through the transpose
//     bit): one 64-wide swizzle atom across the columns; k-step kk of 16
//     rows starts kk * 2048 bytes in, 8-row groups 1024 bytes apart.
//
// wgmma m64nNk16 fragments (warp w of the warpgroup, g = lane / 4,
// t = lane % 4):
//   accumulator d[4j + 2i + e] = D[16w + g + 8i][8j + 2t + e]
//   register A  a0 = A[16w + g][2t..], a1 = A[16w + g + 8][2t..],
//               a2 = A[16w + g][2t + 8..], a3 = A[16w + g + 8][2t + 8..]
// so the accumulator's columns 16k .. 16k+15 repack as the register A of
// k-step k of a product whose depth runs along those columns (acc_as_a).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (no CUDA library is linked)

#include "flash_common.cuh"

namespace avion {
namespace sm90 {

constexpr int kTileRows = 64;                   // rows of a TMA box / tile
constexpr int kTileBytes = kTileRows * 64 * 2;  // one [64][64] bf16 tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier ------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// arrive and announce `bytes` of TMA transactions for the current phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA -----------------------------------------------------------------

// one [64][64] box at (column c0, row c1, batch c2) of a 3-D tensor map,
// completing on `bar`
__device__ __forceinline__ void tma_load_tile(void* dst, const CUtensorMap* map,
                                              uint64_t* bar, int c0, int c1,
                                              int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// ---- bulk reduce-add (shared -> global, f32) -----------------------------

__device__ __forceinline__ void bulk_reduce_add_f32(float* dst, const float* src,
                                                    uint32_t bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], "
      "%2;\n" ::"l"(dst),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// the issuing thread's bulk operations have finished reading shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// ... and have completed
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ---- fences, barriers, registers ------------------------------------------

// shared-memory writes of this thread become visible to the async proxy
// (wgmma operands, bulk copies)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// named barrier over `count` threads
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

template <int kRegs>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// ---- wgmma -----------------------------------------------------------------

// descriptor of a 128-byte-swizzled operand at `smem` (1024-byte aligned
// pattern; a k-step offset inside it stays below 1024 or is a multiple)
__device__ __forceinline__ uint64_t desc_sw128(const void* smem, uint32_t lbo,
                                               uint32_t sbo) {
  const uint32_t addr = smem_u32(smem);
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// K-major: the depth along the tile's columns
__device__ __forceinline__ uint64_t desc_k(const void* tile, int kk) {
  return desc_sw128(static_cast<const char*>(tile) + kk * 32, 16, 1024);
}

// MN-major: the depth along the tile's rows (one 64-wide atom across)
__device__ __forceinline__ uint64_t desc_mn(const void* tile, int kk) {
  return desc_sw128(static_cast<const char*>(tile) + kk * 2048, 1024, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the wait that releases them
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

#define AVION_D8(d, o)                                                       \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]),               \
      "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])
#define AVION_D32(d) \
  AVION_D8(d, 0), AVION_D8(d, 8), AVION_D8(d, 16), AVION_D8(d, 24)
#define AVION_D64(d)                                                 \
  AVION_D32(d), AVION_D8(d, 32), AVION_D8(d, 40), AVION_D8(d, 48), \
      AVION_D8(d, 56)

#define AVION_D32_REGS                                                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define AVION_D64_REGS                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "     \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "      \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "      \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "      \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (+)= A B, m64n64k16, bf16 in, f32 accumulators; A and B in shared
// memory.  kTransA / kTransB: 1 reads the operand MN-major.
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a,
                                         uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " AVION_D32_REGS
      ", %32, %33, p, 1, 1, %35, %36;\n}\n"
      : AVION_D32(d)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(kTransA),
        "n"(kTransB));
}

// the same at m64n128k16: 128 columns, 64 accumulators
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t desc_a,
                                         uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " AVION_D64_REGS
      ", %64, %65, p, 1, 1, %67, %68;\n}\n"
      : AVION_D64(d)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(kTransA),
        "n"(kTransB));
}

// d (+)= A B, m64n64k16, A from registers (a0..a3 as above), B in shared
// memory, kTransB as above.
template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " AVION_D32_REGS
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : AVION_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate), "n"(kTransB));
}

#undef AVION_D8
#undef AVION_D32
#undef AVION_D64
#undef AVION_D32_REGS
#undef AVION_D64_REGS

// register A of k-step k from accumulator columns 16k .. 16k+15
__device__ __forceinline__ void acc_as_a(uint32_t* a, const float* d, int k) {
  a[0] = pack_bf16(d[8 * k + 0], d[8 * k + 1]);
  a[1] = pack_bf16(d[8 * k + 2], d[8 * k + 3]);
  a[2] = pack_bf16(d[8 * k + 4], d[8 * k + 5]);
  a[3] = pack_bf16(d[8 * k + 6], d[8 * k + 7]);
}

// 2^x by the special-function unit (relative error about 2^-22; results
// below 2^-126 flush to 0, -inf gives 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// one [64][64 * n] bf16 tile scaled element by element into `dst` (same
// layout), rounded to bf16: 16 bytes a thread per step
template <int kBytes, int kThreads>
__device__ __forceinline__ void scale_tile(unsigned char* dst,
                                           const unsigned char* src,
                                           float scale, int tid) {
#pragma unroll
  for (int c = tid; c < kBytes / 16; c += kThreads) {
    uint4 v = reinterpret_cast<const uint4*>(src)[c];
    v.x = scale_bf16x2(v.x, scale);
    v.y = scale_bf16x2(v.y, scale);
    v.z = scale_bf16x2(v.z, scale);
    v.w = scale_bf16x2(v.w, scale);
    reinterpret_cast<uint4*>(dst)[c] = v;
  }
}

// byte offset of element (r, c) in a swizzled [64][64] bf16 tile
__device__ __forceinline__ int sw128_offset(int r, int c) {
  return r * 128 + ((((c >> 3) ^ (r & 7)) << 4) | ((c & 7) << 1));
}

// ---- host: tensor maps -----------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up at run time through
// cudaGetDriverEntryPoint so that the library needs no -lcuda
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &status) != cudaSuccess ||
        status != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// bf16 [batch][rows][cols] with the given byte strides, read in [64][64]
// boxes with the 128-byte swizzle; rows at or past `rows` read as zeros
inline cudaError_t make_tile_map(CUtensorMap* map, const void* base,
                                 long long cols, long long rows,
                                 long long batch, long long row_stride_bytes,
                                 long long batch_stride_bytes) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  if (cols <= 0 || rows <= 0 || batch <= 0 || row_stride_bytes <= 0 ||
      batch_stride_bytes <= 0 || row_stride_bytes % 16 ||
      batch_stride_bytes % 16 || row_stride_bytes >= (1ll << 40) ||
      batch_stride_bytes >= (1ll << 40) ||
      reinterpret_cast<uintptr_t>(base) % 16)
    return cudaErrorInvalidValue;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(row_stride_bytes),
                                 static_cast<cuuint64_t>(batch_stride_bytes)};
  const cuuint32_t box[3] = {64, kTileRows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// one bf16 operand [batch, >= rows, cols]: its base and element strides
struct Operand {
  const void* ptr;
  long long batch_stride, row_stride;
};

// a tensor map over the first `rows` rows of `op`; a batch of one never
// steps the batch coordinate
inline cudaError_t make_operand_map(CUtensorMap* map, const Operand& op,
                                    long long cols, long long rows,
                                    long long batch) {
  const long long row_bytes = op.row_stride * 2;
  const long long batch_bytes =
      batch > 1 ? op.batch_stride * 2 : row_bytes * rows;
  return make_tile_map(map, op.ptr, cols, rows, batch, row_bytes,
                       batch_bytes);
}

// the maps of q, k and v, each [batch, >= rows, cols]
inline cudaError_t make_qkv_maps(CUtensorMap* map_q, CUtensorMap* map_k,
                                 CUtensorMap* map_v, const Operand& q,
                                 const Operand& k, const Operand& v,
                                 long long cols, long long rows,
                                 long long batch) {
  cudaError_t err = make_operand_map(map_q, q, cols, rows, batch);
  if (err == cudaSuccess) err = make_operand_map(map_k, k, cols, rows, batch);
  if (err == cudaSuccess) err = make_operand_map(map_v, v, cols, rows, batch);
  return err;
}

// ---- host: launch preparation ---------------------------------------------

// lets `kernel` take `smem` bytes of dynamic shared memory, and refuses it
// (cudaErrorInvalidConfiguration) unless ptxas gave it `entry_regs`
// registers a thread: a setmaxnreg hand-over balances only at the count it
// was built for, and at another one could wait forever
template <typename Kernel>
cudaError_t prepare_kernel(Kernel kernel, int smem, int entry_regs) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  return attr.numRegs == entry_regs ? cudaSuccess
                                    : cudaErrorInvalidConfiguration;
}

}  // namespace sm90
}  // namespace avion
