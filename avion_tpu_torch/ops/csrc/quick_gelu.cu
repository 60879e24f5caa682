// QuickGELU, y = x * sigmoid(1.702 x), and its gradient, on bf16, f16 or
// f32 tensors: the activation of every CLIP tower's MLP
// (models/layers.py, through ops/activation.py).
//
// It replaces no TPU kernel: the JAX package leaves the activation to XLA,
// which fuses it into its neighbours.  Eager PyTorch runs the formula as
// three elementwise kernels forward and five in autograd's backward, each
// a full pass over the [tokens, 4 * width] hidden tensor.
//
// Bound: bytes.  A few dozen f32 operations an element against 2 bf16
// passes (forward: read x, write y) or 3 (backward: read x and dy, write
// dx), far below the card's ridge, so the only gain is fewer bytes: each
// input is read once and the output written once, the arithmetic stays in
// f32 registers and rounds once to the tensor's dtype.
//
// Design: one 16-byte vector load of each input and one store a thread (8
// bf16 or f16, or 4 f32), over a grid with a block for every 256 vectors,
// which the block scheduler streams through the SMs; a scalar loop takes
// the last n % 8 (or 4) elements, and the whole tensor where an operand's
// address is not 16-byte aligned.  On an H100 this runs at 90-93 % of the
// HBM rate, as PyTorch's own copy does; a grid-stride loop over a grid
// sized to the SMs' occupancy reached 82-85 %, unrolled or not.  Launches
// on the caller's stream and allocates nothing.

#include <cuda_fp16.h>

#include <algorithm>

#include "flash_common.cuh"  // bf16 types, avion_cuda_error_string

namespace {

constexpr float kAlpha = 1.702f;
constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 0x7fffffff;  // gridDim.x
// the launchers' `dtype` codes (ops/activation.py: _DTYPES)
enum { kF32 = 0, kBF16 = 1, kF16 = 2 };

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f32<__half>(__half v) {
  return __half2float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// 16 bytes of T, as one vector load or store moves them
template <typename T>
struct Pack {
  static constexpr int kN = 16 / sizeof(T);
  uint4 raw;
  __device__ __forceinline__ float get(int j) const {
    return to_f32(reinterpret_cast<const T*>(&raw)[j]);
  }
  __device__ __forceinline__ void set(int j, float v) {
    reinterpret_cast<T*>(&raw)[j] = from_f32<T>(v);
  }
};

// s = sigmoid(1.702 x), and 1 - s without cancellation: e * s where
// e = exp(-1.702 x) <= 1, else 1 - s, which is then at least 1/2
__device__ __forceinline__ float sigmoid(float x, float* rest) {
  const float e = expf(-kAlpha * x);
  const float s = 1.f / (1.f + e);
  *rest = x >= 0.f ? e * s : 1.f - s;
  return s;
}

__device__ __forceinline__ float forward(float x) {
  float rest;
  return x * sigmoid(x, &rest);
}

// d/dx [x s(x)] = s (1 + 1.702 x (1 - s))
__device__ __forceinline__ float backward(float x, float dy) {
  float rest;
  const float s = sigmoid(x, &rest);
  return dy * (s * fmaf(kAlpha * x, rest, 1.f));
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    quick_gelu_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
                          long long n) {
  const long long first = blockIdx.x * static_cast<long long>(kThreads)
                          + threadIdx.x;
  const long long stride = gridDim.x * static_cast<long long>(kThreads);
  long long tail = 0;
  if (kVec) {
    using P = Pack<T>;
    const long long nv = n / P::kN;
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    uint4* yv = reinterpret_cast<uint4*>(y);
    for (long long v = first; v < nv; v += stride) {
      P a{xv[v]}, out;
#pragma unroll
      for (int j = 0; j < P::kN; ++j) out.set(j, forward(a.get(j)));
      yv[v] = out.raw;
    }
    tail = nv * P::kN;
  }
  for (long long i = tail + first; i < n; i += stride)
    y[i] = from_f32<T>(forward(to_f32(x[i])));
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    quick_gelu_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                          T* __restrict__ dx, long long n) {
  const long long first = blockIdx.x * static_cast<long long>(kThreads)
                          + threadIdx.x;
  const long long stride = gridDim.x * static_cast<long long>(kThreads);
  long long tail = 0;
  if (kVec) {
    using P = Pack<T>;
    const long long nv = n / P::kN;
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    const uint4* dyv = reinterpret_cast<const uint4*>(dy);
    uint4* dxv = reinterpret_cast<uint4*>(dx);
    for (long long v = first; v < nv; v += stride) {
      P a{xv[v]}, g{dyv[v]}, out;
#pragma unroll
      for (int j = 0; j < P::kN; ++j)
        out.set(j, backward(a.get(j), g.get(j)));
      dxv[v] = out.raw;
    }
    tail = nv * P::kN;
  }
  for (long long i = tail + first; i < n; i += stride)
    dx[i] = from_f32<T>(backward(to_f32(x[i]), to_f32(dy[i])));
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// one block for every kThreads units of work (vectors, or elements on the
// scalar path): the block scheduler streams them through the SMs; the
// kernels' grid-stride loops cover what lies past the largest grid
unsigned grid_size(long long units) {
  const long long blocks = (units + kThreads - 1) / kThreads;
  return static_cast<unsigned>(std::min<long long>(blocks, kMaxBlocks));
}

template <typename T>
int fwd(const void* x, void* y, long long n, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (aligned16(x) && aligned16(y)) {
    const unsigned grid = grid_size((n + Pack<T>::kN - 1) / Pack<T>::kN);
    quick_gelu_fwd_kernel<T, true><<<grid, kThreads, 0, stream>>>(xt, yt, n);
  } else {
    quick_gelu_fwd_kernel<T, false><<<grid_size(n), kThreads, 0, stream>>>(
        xt, yt, n);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd(const void* x, const void* dy, void* dx, long long n,
        cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  T* dxt = static_cast<T*>(dx);
  if (aligned16(x) && aligned16(dy) && aligned16(dx)) {
    const unsigned grid = grid_size((n + Pack<T>::kN - 1) / Pack<T>::kN);
    quick_gelu_bwd_kernel<T, true><<<grid, kThreads, 0, stream>>>(xt, dyt,
                                                                  dxt, n);
  } else {
    quick_gelu_bwd_kernel<T, false><<<grid_size(n), kThreads, 0, stream>>>(
        xt, dyt, dxt, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// y = x * sigmoid(1.702 x) over n contiguous elements of `dtype`; y may not
// overlap x.  Launches on `stream`; returns the cudaError_t (0 on success,
// also for n == 0, which launches nothing; cudaErrorInvalidValue for a
// negative n or an unknown dtype).
int avion_quick_gelu_fwd(const void* x, void* y, long long n, int dtype,
                         void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return fwd<float>(x, y, n, s);
    case kBF16: return fwd<__nv_bfloat16>(x, y, n, s);
    case kF16: return fwd<__half>(x, y, n, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// dx = dy * s * (1 + 1.702 x (1 - s)), s = sigmoid(1.702 x), over n
// contiguous elements of `dtype` each; dx may not overlap x or dy.  As the
// forward otherwise.
int avion_quick_gelu_bwd(const void* x, const void* dy, void* dx,
                         long long n, int dtype, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return bwd<float>(x, dy, dx, n, s);
    case kBF16: return bwd<__nv_bfloat16>(x, dy, dx, n, s);
    case kF16: return bwd<__half>(x, dy, dx, n, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
