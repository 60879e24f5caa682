// Device helpers shared by the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu, through flash_sm90.cuh): bf16 packing and the scaling of
// a bf16 pair in f32, and the error string every kernel library exports.
// The Hopper building blocks (TMA, mbarriers, wgmma) are in flash_sm90.cuh.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace avion {

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// both halves of a bf16 pair times `s` in f32, rounded back to bf16
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t x, float s) {
  float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
  return pack_bf16(f.x * s, f.y * s);
}

}  // namespace avion

// Each kernel library exports this beside its launchers.
extern "C" const char* avion_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
