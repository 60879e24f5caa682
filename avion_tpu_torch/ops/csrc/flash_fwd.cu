// Flash-attention forward for Hopper, sm_90a.
//
// Replaces two Pallas TPU kernels of avion_tpu/ops/flash_attention.py,
// both reached from `_fwd_fused`: `_fwd_infer_kernel` (need_lse=False, the
// serving path) and `_fwd_kernel` (need_lse=True, the training forward,
// which also writes each row's logsumexp for the backward).  They compute
// softmax(sm_scale * Q K^T [+ causal mask]) V read straight off the fused
// qkv projection output, in the log2 domain; one template flag, kWriteLse,
// separates them.
//
// lse is the row logsumexp of the log2-domain scores, m + log2(l), as f32
// [B, H, S] (the TPU layout [B, H/hpp, hpp, S_pad] exists only for its lane
// packing).  Rows past S are not written.
//
// Numerics follow the TPU kernel: sm_scale * log2(e) is folded into the q
// tile (rounded back to bf16) before the score product, probabilities use
// exp2 in f32, P is cast to bf16 before the PV product (f32 accumulation),
// and the output is divided by the f32 row sum after PV.
//
// What bounds it on an H100.  Attention at the CLIP shapes does 4*S*D flops
// per 8*D bytes of q/k/v/out, i.e. S/2 flops per byte: the visual tower
// (S = 785 or 3137) sits above the card's ~295 flop/byte ridge and is
// bound by tensor-core operations; the causal text tower (S = 77) is far
// below it and bound by bytes.  The TPU design keeps all of K/V for a
// (batch, head-group) in VMEM and runs one big score matmul; 227 KB of
// shared memory cannot hold that, so this kernel tiles K/V with an online
// softmax (FlashAttention-2 style):
//   - one thread block per (q-tile of 64 rows, head, batch), 4 warps with
//     16 query rows each, so the score tile never leaves registers;
//   - K/V tiles of 64 keys double-buffered in shared memory with cp.async,
//     rows padded by 16 bytes so fragment loads are free of bank conflicts;
//   - bf16 tensor cores through mma.sync m16n8k16 with f32 accumulation;
//     the score accumulators are repacked in registers as the A operand of
//     the PV product, and V fragments come from ldmatrix.trans;
//   - no padding of S: the ragged last K/V tile is zero-filled and its
//     columns masked to -inf, out-of-range query rows are not written;
//   - causal blocks stop at the diagonal tile, halving the text tower's work.
// wgmma and TMA (the route to the card's full rate) are later work.

#include "flash_common.cuh"

namespace {

using namespace avion;

constexpr int kBlockM = 64;  // query rows per block, 16 per warp
constexpr int kBlockN = 64;  // keys per K/V tile

template <int D>
struct Tile {
  static constexpr int kLd = D + kPad;                  // row pitch, elements
  static constexpr int kElems = kBlockN * kLd;          // one K or V tile
  static constexpr int kSmemBytes = (kBlockM * kLd + 4 * kElems) * 2;
};

template <int D, bool kCausal, bool kWriteLse>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const __nv_bfloat16* __restrict__ qkv,
                     __nv_bfloat16* __restrict__ out,
                     float* __restrict__ lse, int seq, int width,
                     long long in_batch_stride, long long in_row_stride,
                     long long out_batch_stride, long long out_row_stride,
                     float scale_log2) {
  constexpr int kLd = Tile<D>::kLd;
  constexpr int kKSteps = D / 16;   // k-steps of the score product
  constexpr int kDTiles = D / 8;    // n-tiles of the output
  constexpr int kNTiles = kBlockN / 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* s_q = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* s_k = s_q + kBlockM * kLd;           // 2 buffers
  __nv_bfloat16* s_v = s_k + 2 * Tile<D>::kElems;     // 2 buffers

  const int q0 = blockIdx.x * kBlockM;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;    // fragment row group
  const int tig = lane % 4;  // thread in group

  const __nv_bfloat16* q_src = qkv + batch * in_batch_stride + head * D;
  const __nv_bfloat16* k_src = q_src + width;
  const __nv_bfloat16* v_src = q_src + 2 * width;

  int n_tiles = (seq + kBlockN - 1) / kBlockN;
  if (kCausal) n_tiles = min(n_tiles, q0 / kBlockN + 1);

  load_tile<kBlockN, D>(s_q, q_src, in_row_stride, q0, seq);
  cp_async_commit();
  load_tile<kBlockN, D>(s_k, k_src, in_row_stride, 0, seq);
  load_tile<kBlockN, D>(s_v, v_src, in_row_stride, 0, seq);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // q fragments for this warp's 16 rows, pre-scaled by sm_scale*log2(e)
  uint32_t qf[kKSteps][4];
  {
    const __nv_bfloat16* base = s_q + (warp * 16 + g) * kLd + tig * 2;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      const __nv_bfloat16* p = base + kk * 16;
      qf[kk][0] = scale_bf16x2(*reinterpret_cast<const uint32_t*>(p), scale_log2);
      qf[kk][1] = scale_bf16x2(*reinterpret_cast<const uint32_t*>(p + 8 * kLd), scale_log2);
      qf[kk][2] = scale_bf16x2(*reinterpret_cast<const uint32_t*>(p + 8), scale_log2);
      qf[kk][3] = scale_bf16x2(*reinterpret_cast<const uint32_t*>(p + 8 * kLd + 8), scale_log2);
    }
  }

  float acc_o[kDTiles][4];
#pragma unroll
  for (int n = 0; n < kDTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_o[n][e] = 0.f;
  // running max and this thread's partial row sum, rows g and g + 8
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  const int row_a = q0 + warp * 16 + g;  // row of c0/c1; c2/c3 are row_a + 8

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {
      load_tile<kBlockN, D>(s_k + (buf ^ 1) * Tile<D>::kElems, k_src, in_row_stride,
                   (t + 1) * kBlockN, seq);
      load_tile<kBlockN, D>(s_v + (buf ^ 1) * Tile<D>::kElems, v_src, in_row_stride,
                   (t + 1) * kBlockN, seq);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* k_t = s_k + buf * Tile<D>::kElems;
    const __nv_bfloat16* v_t = s_v + buf * Tile<D>::kElems;
    const int kv0 = t * kBlockN;

    // scores S = (scaled q) k^T, 16 x 64 per warp, log2 domain
    float acc_s[kNTiles][4];
#pragma unroll
    for (int j = 0; j < kNTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_s[j][e] = 0.f;
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
      const __nv_bfloat16* kp = k_t + (j * 8 + g) * kLd + tig * 2;
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kp + kk * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kp + kk * 16 + 8);
        mma_16816(acc_s[j], qf[kk], b0, b1);
      }
    }

    // mask keys past the sequence end and, if causal, past the query row
    const bool ragged = kv0 + kBlockN > seq;
    const bool diagonal = kCausal && kv0 + kBlockN - 1 > q0 + warp * 16;
    if (ragged || diagonal) {
#pragma unroll
      for (int j = 0; j < kNTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kv0 + j * 8 + tig * 2 + (e & 1);
          const int row = row_a + (e >> 1) * 8;
          if (key >= seq || (kCausal && key > row)) acc_s[j][e] = -INFINITY;
        }
    }

    // online softmax: new running max, rescale, probabilities
    float m_tile[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
      m_tile[0] = fmaxf(m_tile[0], fmaxf(acc_s[j][0], acc_s[j][1]));
      m_tile[1] = fmaxf(m_tile[1], fmaxf(acc_s[j][2], acc_s[j][3]));
    }
    float sub[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_tile[r] = fmaxf(m_tile[r], __shfl_xor_sync(0xffffffffu, m_tile[r], 1));
      m_tile[r] = fmaxf(m_tile[r], __shfl_xor_sync(0xffffffffu, m_tile[r], 2));
      const float m_new = fmaxf(m_run[r], m_tile[r]);
      sub[r] = m_new == -INFINITY ? 0.f : m_new;  // a row with no key yet
      alpha[r] = exp2f(m_run[r] - sub[r]);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < kDTiles; ++n) {
      acc_o[n][0] *= alpha[0];
      acc_o[n][1] *= alpha[0];
      acc_o[n][2] *= alpha[1];
      acc_o[n][3] *= alpha[1];
    }
#pragma unroll
    for (int j = 0; j < kNTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(acc_s[j][e] - sub[e >> 1]);
        acc_s[j][e] = p;
        l_run[e >> 1] += p;
      }

    // out += bf16(P) V: score accumulators become the A operand in place
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t a[4];
      pack_c_as_a(a, acc_s[2 * kk], acc_s[2 * kk + 1]);
      mma_rows_b<kDTiles>(acc_o, a, v_t, kLd, kk * 16);
    }
    __syncthreads();  // this buffer is refilled two iterations on
  }

  // finish the row sums across the 4 threads of a row, normalize, store
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  __nv_bfloat16* o_dst = out + batch * out_batch_stride + head * D + tig * 2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + r * 8;
    if (row >= seq) continue;
    if (kWriteLse && tig == 0)
      lse[(static_cast<long long>(batch) * gridDim.y + head) * seq + row] =
          m_run[r] + log2f(l_run[r]);
    const float inv = 1.f / l_run[r];
    __nv_bfloat16* o_row = o_dst + row * out_row_stride;
#pragma unroll
    for (int n = 0; n < kDTiles; ++n) {
      *reinterpret_cast<uint32_t*>(o_row + n * 8) =
          pack_bf16(acc_o[n][2 * r] * inv, acc_o[n][2 * r + 1] * inv);
    }
  }
}

template <int D, bool kCausal, bool kWriteLse>
int launch(const void* qkv, void* out, float* lse, int batch, int seq,
           int heads, long long in_batch_stride, long long in_row_stride,
           long long out_batch_stride, long long out_row_stride,
           float scale_log2, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<D, kCausal, kWriteLse>;
  constexpr int smem = Tile<D>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((seq + kBlockM - 1) / kBlockM, heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(out),
      lse, seq, heads * D, in_batch_stride, in_row_stride, out_batch_stride,
      out_row_stride, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// qkv: [batch, >= seq rows, 3 * heads * head_dim] bf16, rows `in_row_stride`
// elements apart, q/k/v sections at column 0, W and 2W (W = heads*head_dim).
// out: [batch, seq, W] bf16.  lse: null (inference) or [batch, heads, seq]
// f32, the row logsumexp in log2 units.  Launches on `stream`; returns the
// launch's cudaError_t (0 on success).
int avion_flash_fwd_bf16(const void* qkv, void* out, void* lse, int batch,
                         int seq,
                         int heads, int head_dim, long long in_batch_stride,
                         long long in_row_stride, long long out_batch_stride,
                         long long out_row_stride, int causal,
                         float scale_log2, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || batch > 65535 || heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
#define AVION_LAUNCH(D, C, L)                                                \
  return launch<D, C, L>(qkv, out, l, batch, seq, heads, in_batch_stride,    \
                         in_row_stride, out_batch_stride, out_row_stride,    \
                         scale_log2, s)
#define AVION_LAUNCH_LSE(D, C) \
  if (l) AVION_LAUNCH(D, C, true); \
  AVION_LAUNCH(D, C, false)
  if (head_dim == 64) {
    if (causal) { AVION_LAUNCH_LSE(64, true); }
    AVION_LAUNCH_LSE(64, false);
  }
  if (head_dim == 128) {
    if (causal) { AVION_LAUNCH_LSE(128, true); }
    AVION_LAUNCH_LSE(128, false);
  }
#undef AVION_LAUNCH_LSE
#undef AVION_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
