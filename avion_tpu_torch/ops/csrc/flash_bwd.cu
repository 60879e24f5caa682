// Flash-attention backward for Hopper, sm_90a: dq, dk and dv of
// softmax(sm_scale * Q K^T [+ causal mask]) V, read straight off the fused
// qkv projection output and written into one fused gradient [B, S, 3W]
// (dq in columns [0, W), dk in [W, 2W), dv in [2W, 3W)); nothing is
// concatenated afterwards.
//
// Replaces three Pallas TPU kernels of avion_tpu/ops/flash_attention.py:
//   - `_bwd_combined_kernel` (used while ceil(S, 128) <= 1024): dq, dk and
//     dv from one score recompute.  Here: `bwd_kv_kernel<..., kDq=true>`
//     plus `dq_convert_kernel`;
//   - `_bwd_dkv_kernel`: dk and dv per key tile from transposed scores.
//     Here: `bwd_kv_kernel<..., kDq=false>`;
//   - `_bwd_dq_kernel`: dq per query tile, delta computed in-kernel.  Here:
//     `bwd_dq_kernel`.
// The three share their device code (one file, templates on D in {64, 128}
// and on causal).
//
// Math, in the log2 domain of the forward (flash_fwd.cu): S2 = (q scaled
// by sm_scale * log2(e), rounded to bf16) k^T, P = exp2(S2 - lse) with the
// forward's lse, dP = dO V^T, dS = P * (dP - delta) with delta = rowsum(dO *
// O), then dV = bf16(P)^T dO, dK = bf16(dS)^T Q * sm_scale and dQ = bf16(dS)
// K * sm_scale, every product in bf16 with f32 accumulation.
//
// What bounds it on an H100.  The backward does five S x S x D products to
// the forward's two (2.5x the tensor-core work; the split route recomputes
// the scores and dP once more, seven).  At the visual tower's S = 785 that
// is far above the card's ~295 flop/byte ridge: it is bound by tensor-core
// operations, and the causal text tower (S = 77) by bytes.  The TPU kernel
// holds the whole [S_pad, S_pad] score tile of a (batch, head-group) in
// VMEM; 227 KB of shared memory cannot, so the design is FlashAttention-2's:
//   - one block per (key tile of 64, head, batch), 4 warps with 16 keys
//     each, looping over query tiles (64 rows at D = 64, 32 at D = 128 to
//     stay within 255 registers); dk and dv accumulate in registers for the
//     whole loop, S^T and dP^T never leave registers, and P^T / dS^T are
//     repacked in registers as the A operand of the dV / dK products;
//   - query, dO, lse and delta tiles are double-buffered in shared memory
//     (cp.async), keys and values stay resident;
//   - the combined route also needs dq, a sum over key tiles, i.e. across
//     blocks: dS goes through shared memory, each block computes its
//     [rows, D] share of dQ and adds it with f32 atomics into an f32
//     scratch [B, S, W], which dq_convert_kernel scales and casts into the
//     dq section.  The atomics make dq's summation order, and so its last
//     bits, vary from run to run; the split route has none;
//   - no padding of S: ragged tiles are zero-filled by cp.async, keys past
//     S are masked to -inf before exp2, query rows past S get lse = +inf
//     (so P = 0 and dS = 0) and no row past S is stored;
//   - causal: key tiles skip the query tiles wholly above the diagonal, and
//     the dq kernel stops at the diagonal tile.
// mma.sync m16n8k16; wgmma and TMA are later work.

#include "flash_common.cuh"

namespace {

using namespace avion;

constexpr int kBlockK = 64;   // keys per block of the dk/dv kernel
constexpr int kBlockQd = 64;  // query rows per block of the dq kernel

template <int D>
struct KvTile {
  static constexpr int kBlockQ = D == 64 ? 64 : 32;  // query rows per step
  static constexpr int kLd = D + kPad;
  static constexpr int kLdS = kBlockK + kPad;  // pitch of the dS tile
  // K, V; Q and dO double-buffered; dS; lse and delta double-buffered
  static constexpr int kSmemBytes =
      (2 * kBlockK * kLd + 4 * kBlockQ * kLd + kBlockQ * kLdS) * 2 +
      4 * kBlockQ * 4;
};

template <int D>
struct DqTile {
  static constexpr int kLd = D + kPad;
  // Q, dO; K and V double-buffered; lse, delta
  static constexpr int kSmemBytes =
      (2 * kBlockQd * kLd + 4 * kBlockK * kLd) * 2 + 2 * kBlockQd * 4;
};

// One A fragment (16 rows from `row0`, k-step at column `col`) of a
// row-major bf16 tile in shared memory.
__device__ __forceinline__ void load_a(uint32_t* a, const __nv_bfloat16* x,
                                       int ld, int row0, int col) {
  const int lane = threadIdx.x % 32;
  const __nv_bfloat16* p = x + (row0 + lane / 4) * ld + col + (lane % 4) * 2;
  a[0] = ld_u32(p);
  a[1] = ld_u32(p + 8 * ld);
  a[2] = ld_u32(p + 8);
  a[3] = ld_u32(p + 8 * ld + 8);
}

// dk and dv (and, with kDq, this key tile's share of dq) for one
// (key tile, head, batch).
template <int D, bool kCausal, bool kDq>
__global__ void __launch_bounds__(kThreads)
    bwd_kv_kernel(const __nv_bfloat16* __restrict__ qkv,
                  const __nv_bfloat16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dqkv,
                  float* __restrict__ dq_acc, int seq, int width,
                  long long in_batch_stride, long long in_row_stride,
                  long long g_batch_stride, long long g_row_stride,
                  float scale_log2, float sm_scale) {
  using T = KvTile<D>;
  constexpr int kBlockQ = T::kBlockQ;
  constexpr int kLd = T::kLd;
  constexpr int kLdS = T::kLdS;
  constexpr int kQTiles = kBlockQ / 8;  // n-tiles of S^T and dP^T
  constexpr int kDTiles = D / 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* s_k = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* s_v = s_k + kBlockK * kLd;
  __nv_bfloat16* s_q = s_v + kBlockK * kLd;     // 2 buffers
  __nv_bfloat16* s_do = s_q + 2 * kBlockQ * kLd;  // 2 buffers
  __nv_bfloat16* s_ds = s_do + 2 * kBlockQ * kLd;
  float* s_lse = reinterpret_cast<float*>(s_ds + kBlockQ * kLdS);  // 2 buffers
  float* s_delta = s_lse + 2 * kBlockQ;                             // 2 buffers

  const int k0 = blockIdx.x * kBlockK;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int tig = lane % 4;

  const __nv_bfloat16* q_src = qkv + batch * in_batch_stride + head * D;
  const __nv_bfloat16* k_src = q_src + width;
  const __nv_bfloat16* v_src = q_src + 2 * width;
  const __nv_bfloat16* do_src =
      dout + static_cast<long long>(batch) * seq * width + head * D;
  const long long row_base = (static_cast<long long>(batch) * gridDim.y + head)
                             * seq;  // of lse and delta

  auto load_q_tile = [&](int t, int buf) {
    load_tile<kBlockQ, D>(s_q + buf * kBlockQ * kLd, q_src, in_row_stride,
                          t * kBlockQ, seq);
    load_tile<kBlockQ, D>(s_do + buf * kBlockQ * kLd, do_src, width,
                          t * kBlockQ, seq);
    if (threadIdx.x < kBlockQ) {
      const int q = t * kBlockQ + threadIdx.x;
      s_lse[buf * kBlockQ + threadIdx.x] =
          q < seq ? lse[row_base + q] : INFINITY;  // P = 0 past S
      s_delta[buf * kBlockQ + threadIdx.x] = q < seq ? delta[row_base + q] : 0.f;
    }
  };

  const int n_q = (seq + kBlockQ - 1) / kBlockQ;
  const int t0 = kCausal ? k0 / kBlockQ : 0;  // earlier rows see no key here

  load_tile<kBlockK, D>(s_k, k_src, in_row_stride, k0, seq);
  load_tile<kBlockK, D>(s_v, v_src, in_row_stride, k0, seq);
  load_q_tile(t0, 0);
  cp_async_commit();

  float acc_dk[kDTiles][4], acc_dv[kDTiles][4];
#pragma unroll
  for (int n = 0; n < kDTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[n][e] = acc_dv[n][e] = 0.f;
  const int key_a = k0 + warp * 16 + g;  // key of c0/c1; c2/c3 are key_a + 8

  for (int t = t0; t < n_q; ++t) {
    const int buf = (t - t0) & 1;
    if (t + 1 < n_q) {
      load_q_tile(t + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* q_t = s_q + buf * kBlockQ * kLd;
    const __nv_bfloat16* do_t = s_do + buf * kBlockQ * kLd;
    const float* lse_t = s_lse + buf * kBlockQ;
    const float* delta_t = s_delta + buf * kBlockQ;
    const int q0 = t * kBlockQ;

    // S^T = K (scaled q)^T and dP^T = V dO^T: 16 keys x kBlockQ per warp
    float acc_s[kQTiles][4], acc_dp[kQTiles][4];
#pragma unroll
    for (int j = 0; j < kQTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_s[j][e] = acc_dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ak[4], av[4];
      load_a(ak, s_k, kLd, warp * 16, kk * 16);
      load_a(av, s_v, kLd, warp * 16, kk * 16);
#pragma unroll
      for (int j = 0; j < kQTiles; ++j) {
        const __nv_bfloat16* qp = q_t + (j * 8 + g) * kLd + kk * 16 + tig * 2;
        mma_16816(acc_s[j], ak, scale_bf16x2(ld_u32(qp), scale_log2),
                  scale_bf16x2(ld_u32(qp + 8), scale_log2));
        const __nv_bfloat16* dp = do_t + (j * 8 + g) * kLd + kk * 16 + tig * 2;
        mma_16816(acc_dp[j], av, ld_u32(dp), ld_u32(dp + 8));
      }
    }

    // P^T = exp2(S^T - lse) with keys past S (and, if causal, past the
    // query) at -inf; dS^T = P^T (dP^T - delta)
#pragma unroll
    for (int j = 0; j < kQTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key_a + (e >> 1) * 8;
        const int ql = j * 8 + tig * 2 + (e & 1);
        float s = acc_s[j][e];
        if (key >= seq || (kCausal && key > q0 + ql)) s = -INFINITY;
        const float p = exp2f(s - lse_t[ql]);
        acc_s[j][e] = p;
        acc_dp[j][e] = p * (acc_dp[j][e] - delta_t[ql]);
      }

    // dV += bf16(P^T) dO, dK += bf16(dS^T) Q: depth along the query rows
#pragma unroll
    for (int kk = 0; kk < kBlockQ / 16; ++kk) {
      uint32_t a[4];
      pack_c_as_a(a, acc_s[2 * kk], acc_s[2 * kk + 1]);
      mma_rows_b<kDTiles>(acc_dv, a, do_t, kLd, kk * 16);
      pack_c_as_a(a, acc_dp[2 * kk], acc_dp[2 * kk + 1]);
      mma_rows_b<kDTiles>(acc_dk, a, q_t, kLd, kk * 16);
    }

    if (kDq) {
      // dS, query-major, through shared memory; then dQ[q0 .., :] +=
      // bf16(dS) K over this block's 64 keys, split over the 4 warps as
      // (16-row group, column range) and added with f32 atomics
#pragma unroll
      for (int j = 0; j < kQTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s_ds[(j * 8 + tig * 2 + (e & 1)) * kLdS + warp * 16 + g +
               (e >> 1) * 8] = __float2bfloat16_rn(acc_dp[j][e]);
      __syncthreads();
      constexpr int kRowGroups = kBlockQ / 16;
      constexpr int kCols = D / (kWarps / kRowGroups);
      const int rg = warp % kRowGroups;
      const int c0 = (warp / kRowGroups) * kCols;
      float acc_dq[kCols / 8][4];
#pragma unroll
      for (int n = 0; n < kCols / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_dq[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk) {
        uint32_t a[4];
        load_a(a, s_ds, kLdS, rg * 16, kk * 16);
        mma_rows_b<kCols / 8>(acc_dq, a, s_k + c0, kLd, kk * 16);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int q = q0 + rg * 16 + g + r * 8;
        if (q >= seq) continue;
        float* dst = dq_acc + (static_cast<long long>(batch) * seq + q) * width +
                     head * D + c0 + tig * 2;
#pragma unroll
        for (int n = 0; n < kCols / 8; ++n) {
          atomicAdd(dst + n * 8, acc_dq[n][2 * r]);
          atomicAdd(dst + n * 8 + 1, acc_dq[n][2 * r + 1]);
        }
      }
    }
    __syncthreads();  // these buffers are refilled next iteration
  }

  // store dk (times sm_scale) and dv for keys below S
  __nv_bfloat16* dst = dqkv + batch * g_batch_stride + head * D + tig * 2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key_a + r * 8;
    if (key >= seq) continue;
    __nv_bfloat16* row = dst + key * g_row_stride;
#pragma unroll
    for (int n = 0; n < kDTiles; ++n) {
      *reinterpret_cast<uint32_t*>(row + width + n * 8) = pack_bf16(
          acc_dk[n][2 * r] * sm_scale, acc_dk[n][2 * r + 1] * sm_scale);
      *reinterpret_cast<uint32_t*>(row + 2 * width + n * 8) =
          pack_bf16(acc_dv[n][2 * r], acc_dv[n][2 * r + 1]);
    }
  }
}

// dq for one (query tile, head, batch), with delta = rowsum(dO * O)
// computed here from dO and the forward's output.
template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads)
    bwd_dq_kernel(const __nv_bfloat16* __restrict__ qkv,
                  const __nv_bfloat16* __restrict__ dout,
                  const __nv_bfloat16* __restrict__ out,
                  const float* __restrict__ lse,
                  __nv_bfloat16* __restrict__ dqkv, int seq, int width,
                  long long in_batch_stride, long long in_row_stride,
                  long long g_batch_stride, long long g_row_stride,
                  float scale_log2, float sm_scale) {
  constexpr int kLd = DqTile<D>::kLd;
  constexpr int kElems = kBlockK * kLd;
  constexpr int kDTiles = D / 8;
  constexpr int kNTiles = kBlockK / 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* s_q = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* s_do = s_q + kBlockQd * kLd;
  __nv_bfloat16* s_k = s_do + kBlockQd * kLd;  // 2 buffers
  __nv_bfloat16* s_v = s_k + 2 * kElems;        // 2 buffers
  float* s_lse = reinterpret_cast<float*>(s_v + 2 * kElems);
  float* s_delta = s_lse + kBlockQd;

  const int q0 = blockIdx.x * kBlockQd;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int tig = lane % 4;

  const __nv_bfloat16* q_src = qkv + batch * in_batch_stride + head * D;
  const __nv_bfloat16* k_src = q_src + width;
  const __nv_bfloat16* v_src = q_src + 2 * width;
  const long long io_base = static_cast<long long>(batch) * seq * width +
                            head * D;  // of dO and O

  int n_tiles = (seq + kBlockK - 1) / kBlockK;
  if (kCausal) n_tiles = min(n_tiles, q0 / kBlockK + 1);

  load_tile<kBlockQd, D>(s_q, q_src, in_row_stride, q0, seq);
  load_tile<kBlockQd, D>(s_do, dout + io_base, width, q0, seq);
  cp_async_commit();
  load_tile<kBlockK, D>(s_k, k_src, in_row_stride, 0, seq);
  load_tile<kBlockK, D>(s_v, v_src, in_row_stride, 0, seq);
  cp_async_commit();

  // delta and lse of the tile's rows: two threads per row, half of D each
  {
    const int rl = threadIdx.x / 2;
    const int row = q0 + rl;
    float part = 0.f;
    if (row < seq) {
      const long long off = io_base + static_cast<long long>(row) * width +
                            (threadIdx.x % 2) * (D / 2);
#pragma unroll 8
      for (int c = 0; c < D / 2; c += 2) {
        const float2 a = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(dout + off + c));
        const float2 b = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(out + off + c));
        part += a.x * b.x + a.y * b.y;
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if (threadIdx.x % 2 == 0) {
      s_delta[rl] = part;
      s_lse[rl] = row < seq
          ? lse[(static_cast<long long>(batch) * gridDim.y + head) * seq + row]
          : INFINITY;  // P = 0 past S
    }
  }
  cp_async_wait<1>();
  __syncthreads();

  // q fragments for this warp's 16 rows, pre-scaled by sm_scale*log2(e)
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    load_a(qf[kk], s_q, kLd, warp * 16, kk * 16);
#pragma unroll
    for (int i = 0; i < 4; ++i) qf[kk][i] = scale_bf16x2(qf[kk][i], scale_log2);
  }
  const int row_a = q0 + warp * 16 + g;  // row of c0/c1; c2/c3 are row_a + 8
  const float lse_r[2] = {s_lse[warp * 16 + g], s_lse[warp * 16 + g + 8]};
  const float delta_r[2] = {s_delta[warp * 16 + g], s_delta[warp * 16 + g + 8]};

  float acc_dq[kDTiles][4];
#pragma unroll
  for (int n = 0; n < kDTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dq[n][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {
      load_tile<kBlockK, D>(s_k + (buf ^ 1) * kElems, k_src, in_row_stride,
                            (t + 1) * kBlockK, seq);
      load_tile<kBlockK, D>(s_v + (buf ^ 1) * kElems, v_src, in_row_stride,
                            (t + 1) * kBlockK, seq);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* k_t = s_k + buf * kElems;
    const __nv_bfloat16* v_t = s_v + buf * kElems;
    const int kv0 = t * kBlockK;

    // S = (scaled q) K^T and dP = dO V^T: 16 rows x 64 keys per warp
    float acc_s[kNTiles][4], acc_dp[kNTiles][4];
#pragma unroll
    for (int j = 0; j < kNTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_s[j][e] = acc_dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ado[4];
      load_a(ado, s_do, kLd, warp * 16, kk * 16);
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
        const __nv_bfloat16* kp = k_t + (j * 8 + g) * kLd + kk * 16 + tig * 2;
        mma_16816(acc_s[j], qf[kk], ld_u32(kp), ld_u32(kp + 8));
        const __nv_bfloat16* vp = v_t + (j * 8 + g) * kLd + kk * 16 + tig * 2;
        mma_16816(acc_dp[j], ado, ld_u32(vp), ld_u32(vp + 8));
      }
    }

    // P = exp2(S - lse), keys past S (and past the row, if causal) at -inf;
    // dS = P (dP - delta)
#pragma unroll
    for (int j = 0; j < kNTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kv0 + j * 8 + tig * 2 + (e & 1);
        const int row = row_a + (e >> 1) * 8;
        float s = acc_s[j][e];
        if (key >= seq || (kCausal && key > row)) s = -INFINITY;
        const float p = exp2f(s - lse_r[e >> 1]);
        acc_dp[j][e] = p * (acc_dp[j][e] - delta_r[e >> 1]);
      }

    // dQ += bf16(dS) K: depth along the keys
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      uint32_t a[4];
      pack_c_as_a(a, acc_dp[2 * kk], acc_dp[2 * kk + 1]);
      mma_rows_b<kDTiles>(acc_dq, a, k_t, kLd, kk * 16);
    }
    __syncthreads();  // this buffer is refilled two iterations on
  }

  __nv_bfloat16* dst = dqkv + batch * g_batch_stride + head * D + tig * 2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + r * 8;
    if (row >= seq) continue;
    __nv_bfloat16* o_row = dst + row * g_row_stride;
#pragma unroll
    for (int n = 0; n < kDTiles; ++n)
      *reinterpret_cast<uint32_t*>(o_row + n * 8) = pack_bf16(
          acc_dq[n][2 * r] * sm_scale, acc_dq[n][2 * r + 1] * sm_scale);
  }
}

// dq section of dqkv = bf16(dq_acc * sm_scale); dq_acc is [B, S, W] f32.
__global__ void dq_convert_kernel(const float* __restrict__ dq_acc,
                                  __nv_bfloat16* __restrict__ dqkv, int seq,
                                  int width, long long g_batch_stride,
                                  long long g_row_stride, float sm_scale,
                                  long long pairs) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < pairs; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long idx = 2 * i;
    const long long row = idx / width;  // batch * seq + position
    const int col = static_cast<int>(idx % width);
    const float2 v = reinterpret_cast<const float2*>(dq_acc)[i];
    *reinterpret_cast<uint32_t*>(dqkv + (row / seq) * g_batch_stride +
                                 (row % seq) * g_row_stride + col) =
        pack_bf16(v.x * sm_scale, v.y * sm_scale);
  }
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

struct Args {
  const void* qkv;
  const void* dout;
  const void* out;
  const void* lse;
  const void* delta;
  void* dq_acc;
  void* dqkv;
  int batch, seq, heads;
  long long in_batch_stride, in_row_stride, g_batch_stride, g_row_stride;
  float scale_log2, sm_scale;
  cudaStream_t stream;
};

template <int D, bool kCausal, bool kDq>
int launch_kv(const Args& a) {
  auto kernel = bwd_kv_kernel<D, kCausal, kDq>;
  constexpr int smem = KvTile<D>::kSmemBytes;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.seq + kBlockK - 1) / kBlockK, a.heads, a.batch);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.qkv),
      static_cast<const __nv_bfloat16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<__nv_bfloat16*>(a.dqkv), static_cast<float*>(a.dq_acc),
      a.seq, a.heads * D, a.in_batch_stride, a.in_row_stride,
      a.g_batch_stride, a.g_row_stride, a.scale_log2, a.sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || !kDq) return static_cast<int>(err);
  const long long pairs =
      static_cast<long long>(a.batch) * a.seq * a.heads * D / 2;
  const long long want = (pairs + 255) / 256;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  dq_convert_kernel<<<blocks, 256, 0, a.stream>>>(
      static_cast<const float*>(a.dq_acc), static_cast<__nv_bfloat16*>(a.dqkv),
      a.seq, a.heads * D, a.g_batch_stride, a.g_row_stride, a.sm_scale, pairs);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kCausal>
int launch_dq(const Args& a) {
  auto kernel = bwd_dq_kernel<D, kCausal>;
  constexpr int smem = DqTile<D>::kSmemBytes;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.seq + kBlockQd - 1) / kBlockQd, a.heads, a.batch);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.qkv),
      static_cast<const __nv_bfloat16*>(a.dout),
      static_cast<const __nv_bfloat16*>(a.out),
      static_cast<const float*>(a.lse), static_cast<__nv_bfloat16*>(a.dqkv),
      a.seq, a.heads * D, a.in_batch_stride, a.in_row_stride,
      a.g_batch_stride, a.g_row_stride, a.scale_log2, a.sm_scale);
  return static_cast<int>(cudaGetLastError());
}

enum Route { kCombined, kDkv, kDqOnly };

int dispatch(Route route, int head_dim, int causal, const Args& a) {
  if (a.batch <= 0 || a.seq <= 0 || a.heads <= 0 || a.batch > 65535 ||
      a.heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
#define AVION_ROUTES(D, C)                                   \
  switch (route) {                                           \
    case kCombined: return launch_kv<D, C, true>(a);         \
    case kDkv: return launch_kv<D, C, false>(a);             \
    case kDqOnly: return launch_dq<D, C>(a);                 \
  }
  if (head_dim == 64) {
    if (causal) { AVION_ROUTES(64, true) } else { AVION_ROUTES(64, false) }
  }
  if (head_dim == 128) {
    if (causal) { AVION_ROUTES(128, true) } else { AVION_ROUTES(128, false) }
  }
#undef AVION_ROUTES
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Common arguments.  qkv: [batch, >= seq rows, 3W] bf16 (W = heads *
// head_dim), rows `in_row_stride` elements apart.  dout (and out): [batch,
// seq, W] bf16, contiguous.  lse, delta: [batch, heads, seq] f32, contiguous
// (lse in log2 units, as the forward wrote it).  dqkv: [batch, >= seq rows,
// 3W] bf16, rows `g_row_stride` elements apart; rows past seq are not
// written.  scale_log2 must be the forward's (sm_scale * log2(e) as f32).
// Each launches on `stream` and returns the cudaError_t (0 on success).

// dq, dk and dv; dq_acc: [batch, seq, W] f32 scratch, zero on entry.
int avion_flash_bwd_combined_bf16(
    const void* qkv, const void* dout, const void* lse, const void* delta,
    void* dq_acc, void* dqkv, int batch, int seq, int heads, int head_dim,
    long long in_batch_stride, long long in_row_stride,
    long long g_batch_stride, long long g_row_stride, int causal,
    float scale_log2, float sm_scale, void* stream) {
  const Args a{qkv, dout, nullptr, lse, delta, dq_acc, dqkv, batch, seq,
               heads, in_batch_stride, in_row_stride, g_batch_stride,
               g_row_stride, scale_log2, sm_scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch(kCombined, head_dim, causal, a);
}

// dk and dv only.
int avion_flash_bwd_dkv_bf16(
    const void* qkv, const void* dout, const void* lse, const void* delta,
    void* dqkv, int batch, int seq, int heads, int head_dim,
    long long in_batch_stride, long long in_row_stride,
    long long g_batch_stride, long long g_row_stride, int causal,
    float scale_log2, float sm_scale, void* stream) {
  const Args a{qkv, dout, nullptr, lse, delta, nullptr, dqkv, batch, seq,
               heads, in_batch_stride, in_row_stride, g_batch_stride,
               g_row_stride, scale_log2, sm_scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch(kDkv, head_dim, causal, a);
}

// dq only; out: the forward's output, for delta.
int avion_flash_bwd_dq_bf16(
    const void* qkv, const void* dout, const void* out, const void* lse,
    void* dqkv, int batch, int seq, int heads, int head_dim,
    long long in_batch_stride, long long in_row_stride,
    long long g_batch_stride, long long g_row_stride, int causal,
    float scale_log2, float sm_scale, void* stream) {
  const Args a{qkv, dout, out, lse, nullptr, nullptr, dqkv, batch, seq,
               heads, in_batch_stride, in_row_stride, g_batch_stride,
               g_row_stride, scale_log2, sm_scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch(kDqOnly, head_dim, causal, a);
}

}  // extern "C"
