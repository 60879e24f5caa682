// Device helpers shared by the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu): cp.async tile loads, bf16 mma.sync m16n8k16 with f32
// accumulation, ldmatrix, and bf16 packing.
//
// Fragment layouts of mma.m16n8k16.row.col (g = lane / 4, t = lane % 4):
//   A (16x16): a0 = A[g][2t..2t+1], a1 = A[g+8][2t..], a2 = A[g][2t+8..],
//              a3 = A[g+8][2t+8..]
//   B (16x8):  b0 = B[2t..2t+1][g], b1 = B[2t+8..2t+9][g]
//   C (16x8):  c0, c1 = C[g][2t..2t+1], c2, c3 = C[g+8][2t..2t+1]
// so a C tile pair (n-tiles 2k, 2k+1) repacks in registers as the A
// operand of a product over those 16 columns (pack_c_as_a).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace avion {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;  // bf16 elements of padding per shared-memory row

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem,
                                            bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// c += a * b for one m16n8k16 bf16 tile with f32 accumulators.
__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* smem) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t x, float s) {
  float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
  return pack_bf16(f.x * s, f.y * s);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Copy rows [row0, row0 + kRows) of one head's D columns into shared memory
// (row pitch D + kPad); rows at or past `rows` are zero-filled and never
// read from device memory.
template <int kRows, int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* smem,
                                          const __nv_bfloat16* src,
                                          long long row_stride, int row0,
                                          int rows) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    const int row = row0 + r;
    const bool valid = row < rows;
    const __nv_bfloat16* g = src + (valid ? row * row_stride + c : 0);
    cp_async_16(smem + r * (D + kPad) + c, g, valid);
  }
}

// A fragment of k-step kk from the C accumulators of n-tiles 2kk, 2kk+1.
__device__ __forceinline__ void pack_c_as_a(uint32_t* a, const float* c0,
                                            const float* c1) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// acc[dt] += a @ X[k0 .. k0+16, 0 .. 8*kNTiles) for X row-major in shared
// memory (pitch ld): the B operand of a product whose depth runs along X's
// rows, read with ldmatrix.trans.
template <int kNTiles>
__device__ __forceinline__ void mma_rows_b(float (*acc)[4], const uint32_t* a,
                                           const __nv_bfloat16* x, int ld,
                                           int k0) {
  const int lane = threadIdx.x % 32;
  const int mat = lane / 8;
  const __nv_bfloat16* p = x + (k0 + (mat & 1) * 8 + lane % 8) * ld +
                           (mat >> 1) * 8;
#pragma unroll
  for (int dt = 0; dt < kNTiles / 2; ++dt) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, p + dt * 16);
    mma_16816(acc[2 * dt], a, b[0], b[1]);
    mma_16816(acc[2 * dt + 1], a, b[2], b[3]);
  }
}

}  // namespace avion

// Each kernel library exports this beside its launchers.
extern "C" const char* avion_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
