// Flash-attention backward for Hopper, sm_90a: dq, dk and dv of
// softmax(sm_scale * Q K^T + extra_bias [+ causal mask]) V, written into
// one fused gradient [B, S, 3W] (dq in columns [0, W), dk in [W, 2W), dv
// in [2W, 3W)); nothing is concatenated afterwards.  The gradient is bf16,
// or f32 on the split routes (a ring hop's, so that the ring sums its hops
// without rounding each to bf16).  q, k and v are three
// operands with their own bases, strides and tensor maps: the fused path
// passes column views of the qkv projection output, a ring hop
// (ops/ring_attention.py; `_bwd` with `extra_bias` in the JAX package) its
// local q and a neighbour's [B, S, 2W] k/v buffer, with the global out and
// lse.  extra_bias, an f32 runtime argument, is added to every log2-domain
// score before P = exp2(S2 - lse): on a hop voided with -1e30 and a finite
// global lse, P and so every gradient term come out exactly 0.
//
// Replaces three Pallas TPU kernels of avion_tpu/ops/flash_attention.py:
//   - `_bwd_combined_kernel` (used while ceil(S, 128) <= 1024): dq, dk and
//     dv from one score recompute.  Here: `delta_kernel`, then
//     `bwd_kv_kernel<..., kDq=true>`, then `dq_convert_kernel`;
//   - `_bwd_dkv_kernel`: dk and dv per key tile from transposed scores.
//     Here: `delta_kernel`, then `bwd_kv_kernel<..., kDq=false>`;
//   - `_bwd_dq_kernel`: dq per query tile, delta computed in-kernel.  Here:
//     `bwd_dq_kernel`.
// Templates on D in {64, 128} and on causal; Hopper helpers in
// flash_sm90.cuh.
//
// Math, in the log2 domain of the forward (flash_fwd.cu): S2 = (q scaled
// by sm_scale * log2(e) in f32, rounded to bf16) k^T, P = exp2(S2 - lse)
// with the forward's lse, so P is the forward's P; dP = dO V^T, dS = P *
// (dP - delta) with delta = rowsum(dO * O), then dV = bf16(P)^T dO, dK =
// bf16(dS)^T Q * sm_scale and dQ = bf16(dS) K * sm_scale, every product in
// bf16 with f32 accumulation.
//
// What bounds it on an H100.  The backward does five S x S x D products to
// the forward's two (the split route recomputes the scores and dP once
// more, seven).  At the visual tower's S = 785 and S = 3137 that is far
// above the card's ~295 flop/byte ridge: tensor-core operations bound it.
// The causal text tower (S = 77, one key tile) does little arithmetic per
// byte and is bound by bytes and launch latency.  On this card only wgmma
// reaches the tensor cores' full rate, and it wants its operands in
// swizzled shared memory, fed without the math warps' help.  So:
//   - each block is one consumer warpgroup (64 keys of the dk/dv kernel, or
//     64 query rows of the dq kernel) and a producer warpgroup that gives
//     its registers to the consumers (setmaxnreg, 24 against 232 a thread)
//     and of which one warp keeps TMA loads in flight through a 2-stage
//     ring of mbarriers (full / empty); two blocks share an SM;
//   - dk/dv kernel: K and V stay resident; the ring carries the query
//     tiles (Q, dO, lse, delta).  S^T = K Q~^T and dP^T = V dO^T with both
//     operands in shared memory; dV += bf16(P^T) dO and dK += bf16(dS^T) Q
//     with A taken from the accumulators repacked in registers and B read
//     MN-major.  Q~ (q scaled and rounded as the forward does it) is made
//     once per stage into a buffer of its own, not once per product;
//   - dq kernel: Q (scaled once, in place) and dO stay resident; the ring
//     carries (K, V).  S = Q~ K^T, dP = dO V^T, dQ += bf16(dS) K;
//   - the combined route's dq is a sum over key tiles, i.e. across blocks.
//     Each block writes dS^T to shared memory, forms its [64, D] share of
//     dQ by wgmma (dS read MN-major), stages it in shared memory (row-major,
//     16-byte chunks swizzled against bank conflicts) and adds it to an f32
//     scratch with one bulk reduce-add (FlashAttention-3's scheme; no
//     per-element atomics); dq_convert_kernel scales and casts it into the
//     dq section.  The order of the sums, and so dq's last bits, varies from
//     run to run; the split route's does not;
//   - no padding of S: the tensor maps end at row S, so TMA zero-fills the
//     ragged tile and never reads a row past S; keys past S are masked to
//     -inf before exp2 (against inf * 0 when an lse is below -128), query
//     rows past S get lse = +inf (P = 0, dS = 0), and no row past S is
//     stored;
//   - causal: key tiles skip the query tiles wholly above the diagonal, and
//     the dq kernel stops at the diagonal tile;
//   - delta = rowsum(dO * O), which the JAX package computes outside its
//     combined and dkv kernels, is delta_kernel here: one pass over dO and
//     O (bytes bound);
//   - P = exp2(S2 - lse) by the special-function unit (ex2.approx, relative
//     error ~2^-22, far below bf16(P)'s 2^-9).

#include "flash_sm90.cuh"

namespace {

using namespace avion;
using namespace avion::sm90;

constexpr int kBlock = 64;        // keys, query rows and rows of every tile
constexpr int kConsumers = 128;   // one consumer warpgroup
constexpr int kStages = 2;        // of the ring
// and a producer warpgroup, of which one warp works: setmaxnreg moves
// registers a warpgroup at a time
constexpr int kBwdThreads = kConsumers + 128;
// two blocks an SM give each thread kEntryRegs at launch (ptxas); the
// producer warpgroup hands what it does not need to the consumers
constexpr int kEntryRegs = 128, kProducerRegs = 24, kConsumerRegs = 232;
static_assert(128 * (kEntryRegs - kProducerRegs) ==
                  kConsumers * (kConsumerRegs - kEntryRegs),
              "register hand-over must balance");

// two adjacent gradient columns into an f32 or a bf16 gradient
__device__ __forceinline__ void store_pair(float* g, float lo, float hi) {
  *reinterpret_cast<float2*>(g) = make_float2(lo, hi);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* g, float lo,
                                           float hi) {
  *reinterpret_cast<uint32_t*>(g) = pack_bf16(lo, hi);
}

// byte offsets of the dk/dv kernel's shared memory, from a 1024-aligned base
template <int D, bool kDq>
struct KvSmem {
  static constexpr int kTile = D / 64 * kTileBytes;  // one [64, D] tile
  static constexpr int kK = 0;
  static constexpr int kV = kK + kTile;
  static constexpr int kQ = kV + kTile;                   // per stage
  static constexpr int kDo = kQ + kStages * kTile;        // per stage
  static constexpr int kQs = kDo + kStages * kTile;       // per stage: q~
  static constexpr int kDs = kQs + kStages * kTile;       // dS^T [keys][queries]
  static constexpr int kDqStage = kDs + (kDq ? kTileBytes : 0);  // f32 dQ share
  static constexpr int kLse = kDqStage + (kDq ? kBlock * D * 4 : 0);  // per stage
  static constexpr int kDelta = kLse + kStages * kBlock * 4;          // per stage
  static constexpr int kBars = kDelta + kStages * kBlock * 4;
  static constexpr int kBytes = kBars + (2 * kStages + 1) * 8 + 1024;
};

// byte offsets of the dq kernel's shared memory
template <int D>
struct DqSmem {
  static constexpr int kTile = D / 64 * kTileBytes;
  static constexpr int kQ = 0;
  static constexpr int kDo = kQ + kTile;
  static constexpr int kK = kDo + kTile;              // per stage
  static constexpr int kV = kK + kStages * kTile;     // per stage
  static constexpr int kDelta = kV + kStages * kTile;
  static constexpr int kBars = kDelta + kBlock * 4;
  static constexpr int kBytes = kBars + (2 * kStages + 1) * 8 + 1024;
};

// dk and dv (and, with kDq, this key tile's share of dq) for one
// (key tile of 64, head, batch).
template <int D, bool kCausal, bool kDq>
__global__ void __launch_bounds__(kBwdThreads, 2)
    bwd_kv_kernel(const __grid_constant__ CUtensorMap map_q,
                  const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_v,
                  const __grid_constant__ CUtensorMap map_do,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  void* __restrict__ dqkv,
                  float* __restrict__ dq_acc, int seq, int width,
                  long long g_batch_stride, long long g_row_stride,
                  float scale_log2, float sm_scale, float extra_bias,
                  int out_f32) {
  using L = KvSmem<D, kDq>;
  constexpr int kChunks = D / 64;  // 64-column tiles across the head

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* kv_bar = empty + kStages;
  float* s_lse = reinterpret_cast<float*>(smem + L::kLse);
  float* s_delta = reinterpret_cast<float*>(smem + L::kDelta);

  const int k0 = blockIdx.x * kBlock;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int n_q = (seq + kBlock - 1) / kBlock;
  const int t0 = kCausal ? blockIdx.x : 0;  // earlier rows see no key here
  const int n_steps = n_q - t0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);  // every producer lane (lse, delta) + TMA bytes
      mbar_init(&empty[s], kConsumers);
    }
    mbar_init(kv_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer warp: K, V once; then (Q, dO, lse, delta) per stage
    regs_dealloc<kProducerRegs>();
    const int lane = threadIdx.x - kConsumers;
    if (lane >= 32) return;  // the warpgroup's other warps have no work
    const long long row_base =
        (static_cast<long long>(batch) * gridDim.y + head) * seq;
    if (lane == 0) {
      tma_prefetch_map(&map_q);
      tma_prefetch_map(&map_k);
      tma_prefetch_map(&map_v);
      tma_prefetch_map(&map_do);
      mbar_arrive_expect_tx(kv_bar, 2 * L::kTile);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        tma_load_tile(smem + L::kK + c * kTileBytes, &map_k, kv_bar,
                      head * D + 64 * c, k0, batch);
        tma_load_tile(smem + L::kV + c * kTileBytes, &map_v, kv_bar,
                      head * D + 64 * c, k0, batch);
      }
    }
    for (int i = 0; i < n_steps; ++i) {
      const int stage = i % kStages;
      mbar_wait(&empty[stage], ((i / kStages) & 1) ^ 1);
      const int q0 = (t0 + i) * kBlock;
      for (int r = lane; r < kBlock; r += 32) {
        const int q = q0 + r;
        s_lse[stage * kBlock + r] = q < seq ? lse[row_base + q] : INFINITY;
        s_delta[stage * kBlock + r] = q < seq ? delta[row_base + q] : 0.f;
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[stage], 2 * L::kTile);
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          const int off = stage * L::kTile + c * kTileBytes;
          tma_load_tile(smem + L::kQ + off, &map_q, &full[stage],
                        head * D + 64 * c, q0, batch);
          tma_load_tile(smem + L::kDo + off, &map_do, &full[stage],
                        head * D + 64 * c, q0, batch);
        }
      } else {
        mbar_arrive(&full[stage]);
      }
    }
  } else {
    // ---- consumer warpgroup: 64 keys, 16 a warp
    regs_alloc<kConsumerRegs>();
    const int tid = threadIdx.x;
    const int warp = tid / 32;
    const int g = (tid % 32) / 4;
    const int tq = tid % 4;
    const unsigned char* s_k = smem + L::kK;
    const unsigned char* s_v = smem + L::kV;
    const int key_a = k0 + warp * 16 + g;  // key of rows i = 0; +8 for i = 1

    float acc_dk[kChunks][32], acc_dv[kChunks][32];
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc_dk[c][e] = acc_dv[c][e] = 0.f;

    mbar_wait(kv_bar, 0);
    for (int i = 0; i < n_steps; ++i) {
      const int stage = i % kStages;
      const int q0 = (t0 + i) * kBlock;
      mbar_wait(&full[stage], (i / kStages) & 1);
      const unsigned char* s_q = smem + L::kQ + stage * L::kTile;
      const unsigned char* s_do = smem + L::kDo + stage * L::kTile;
      unsigned char* s_qs = smem + L::kQs + stage * L::kTile;
      const float* lse_t = s_lse + stage * kBlock;
      const float* delta_t = s_delta + stage * kBlock;

      // q~ = bf16(q * sm_scale * log2(e)), once per stage
      scale_tile<L::kTile, kConsumers>(s_qs, s_q, scale_log2, tid);
      fence_proxy_async();
      bar_sync(1, kConsumers);

      // S^T = K q~^T and dP^T = V dO^T: [64 keys, 64 queries]
      float acc_s[32], acc_dp[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<0, 0>(acc_s, desc_k(s_k + kk / 4 * kTileBytes, kk % 4),
                       desc_k(s_qs + kk / 4 * kTileBytes, kk % 4), kk);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<0, 0>(acc_dp, desc_k(s_v + kk / 4 * kTileBytes, kk % 4),
                       desc_k(s_do + kk / 4 * kTileBytes, kk % 4), kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_s);
      fence_regs(acc_dp);

      // P^T = exp2(S^T + extra_bias - lse) with keys past S (and, if
      // causal, past the query) at -inf; dS^T = P^T (dP^T - delta)
      const bool masked = k0 + kBlock > seq || (kCausal && i == 0);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int ql = 8 * j + 2 * tq;
        const float2 l2 = *reinterpret_cast<const float2*>(lse_t + ql);
        const float2 d2 = *reinterpret_cast<const float2*>(delta_t + ql);
#pragma unroll
        for (int ii = 0; ii < 2; ++ii)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int idx = 4 * j + 2 * ii + e;
            const int key = key_a + 8 * ii;
            float s = acc_s[idx] + extra_bias;
            if (masked && (key >= seq || (kCausal && key > q0 + ql + e)))
              s = -INFINITY;
            const float p = exp2_approx(s - (e ? l2.y : l2.x));
            acc_s[idx] = p;
            acc_dp[idx] = p * (acc_dp[idx] - (e ? d2.y : d2.x));
          }
      }

      // dV += bf16(P^T) dO, dK += bf16(dS^T) Q: depth along the queries
      uint32_t a_p[4][4], a_ds[4][4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        acc_as_a(a_p[k], acc_s, k);
        acc_as_a(a_ds[k], acc_dp, k);
      }
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          wgmma_rs<1>(acc_dv[c], a_p[k], desc_mn(s_do + c * kTileBytes, k), 1);
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          wgmma_rs<1>(acc_dk[c], a_ds[k], desc_mn(s_q + c * kTileBytes, k), 1);
      wgmma_commit();

      if (kDq) {
        // dS^T into shared memory, swizzled as TMA would write it
        unsigned char* s_ds = smem + L::kDs;
        const int r0 = warp * 16 + g;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int c0 = 16 * k + 2 * tq;
          *reinterpret_cast<uint32_t*>(s_ds + sw128_offset(r0, c0)) = a_ds[k][0];
          *reinterpret_cast<uint32_t*>(s_ds + sw128_offset(r0 + 8, c0)) = a_ds[k][1];
          *reinterpret_cast<uint32_t*>(s_ds + sw128_offset(r0, c0 + 8)) = a_ds[k][2];
          *reinterpret_cast<uint32_t*>(s_ds + sw128_offset(r0 + 8, c0 + 8)) = a_ds[k][3];
        }
        fence_proxy_async();
        if (tid == 0) bulk_wait_read();  // the last share has left the stage
        bar_sync(1, kConsumers);

        // dQ[q0 .., :] share = bf16(dS) K over these 64 keys, 64 columns at
        // a time, staged row-major [64][D] f32 with the 16-byte chunks of
        // row r swizzled by r % 8 (no bank conflicts), then bulk-added to
        // dq_acc by one thread
        float* stage_dq = reinterpret_cast<float*>(smem + L::kDqStage);
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          float acc_dq[32];
          wgmma_fence();
#pragma unroll
          for (int k = 0; k < 4; ++k)
            wgmma_ss<1, 1>(acc_dq, desc_mn(s_ds, k),
                           desc_mn(s_k + c * kTileBytes, k), k);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(acc_dq);
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int ii = 0; ii < 2; ++ii) {
              const int r = warp * 16 + g + 8 * ii;
              const int chunk = (16 * c + 2 * j + (tq >> 1)) ^ (r & 7);
              *reinterpret_cast<float2*>(stage_dq + r * D + chunk * 4 +
                                         (tq & 1) * 2) =
                  make_float2(acc_dq[4 * j + 2 * ii], acc_dq[4 * j + 2 * ii + 1]);
            }
        }
        fence_proxy_async();
        bar_sync(1, kConsumers);
        if (tid == 0)
          bulk_reduce_add_f32(
              dq_acc + ((static_cast<long long>(batch) * gridDim.y + head) * n_q +
                        t0 + i) * (kBlock * D),
              stage_dq, kBlock * D * 4);
      }
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        fence_regs(acc_dv[c]);
        fence_regs(acc_dk[c]);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        fence_regs(a_p[k]);
        fence_regs(a_ds[k]);
      }
      mbar_arrive(&empty[stage]);
    }
    if (kDq && tid == 0) bulk_wait();

    // store dk (times sm_scale) and dv for keys below S
    auto store = [&](auto* g) {
      auto* dst = g + batch * g_batch_stride + head * D + 2 * tq;
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const int key = key_a + 8 * ii;
        if (key >= seq) continue;
        auto* row = dst + key * g_row_stride;
#pragma unroll
        for (int c = 0; c < kChunks; ++c)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int idx = 4 * j + 2 * ii;
            const int col = 64 * c + 8 * j;
            store_pair(row + width + col, acc_dk[c][idx] * sm_scale,
                       acc_dk[c][idx + 1] * sm_scale);
            store_pair(row + 2 * width + col, acc_dv[c][idx],
                       acc_dv[c][idx + 1]);
          }
      }
    };
    if (out_f32)
      store(static_cast<float*>(dqkv));
    else
      store(static_cast<__nv_bfloat16*>(dqkv));
  }
}

// dq for one (query tile of 64, head, batch), with delta = rowsum(dO * O)
// computed here from dO and the forward's output.
template <int D, bool kCausal>
__global__ void __launch_bounds__(kBwdThreads, 2)
    bwd_dq_kernel(const __grid_constant__ CUtensorMap map_q,
                  const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_v,
                  const __grid_constant__ CUtensorMap map_do,
                  const __nv_bfloat16* __restrict__ dout,
                  const __nv_bfloat16* __restrict__ out,
                  const float* __restrict__ lse,
                  void* __restrict__ dqkv, int seq, int width,
                  long long g_batch_stride, long long g_row_stride,
                  float scale_log2, float sm_scale, float extra_bias,
                  int out_f32) {
  using L = DqSmem<D>;
  constexpr int kChunks = D / 64;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* q_bar = empty + kStages;
  float* s_delta = reinterpret_cast<float*>(smem + L::kDelta);

  const int q0 = blockIdx.x * kBlock;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  int n_tiles = (seq + kBlock - 1) / kBlock;
  if (kCausal) n_tiles = min(n_tiles, static_cast<int>(blockIdx.x) + 1);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_init(q_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer warp: Q, dO once; then (K, V) per stage
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x == kConsumers) {
      tma_prefetch_map(&map_q);
      tma_prefetch_map(&map_k);
      tma_prefetch_map(&map_v);
      tma_prefetch_map(&map_do);
      mbar_arrive_expect_tx(q_bar, 2 * L::kTile);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        tma_load_tile(smem + L::kQ + c * kTileBytes, &map_q, q_bar,
                      head * D + 64 * c, q0, batch);
        tma_load_tile(smem + L::kDo + c * kTileBytes, &map_do, q_bar,
                      head * D + 64 * c, q0, batch);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int stage = i % kStages;
        mbar_wait(&empty[stage], ((i / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[stage], 2 * L::kTile);
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          tma_load_tile(smem + L::kK + stage * L::kTile + c * kTileBytes,
                        &map_k, &full[stage], head * D + 64 * c, i * kBlock,
                        batch);
          tma_load_tile(smem + L::kV + stage * L::kTile + c * kTileBytes,
                        &map_v, &full[stage], head * D + 64 * c, i * kBlock,
                        batch);
        }
      }
    }
  } else {
    // ---- consumer warpgroup: 64 query rows, 16 a warp
    regs_alloc<kConsumerRegs>();
    const int tid = threadIdx.x;
    const int warp = tid / 32;
    const int g = (tid % 32) / 4;
    const int tq = tid % 4;
    const int row_a = q0 + warp * 16 + g;  // row of i = 0; +8 for i = 1

    // delta of the tile's rows from global memory: two threads a row
    {
      const int rl = tid / 2;
      const int row = q0 + rl;
      float part = 0.f;
      if (row < seq) {
        const long long off =
            (static_cast<long long>(batch) * seq + row) * width + head * D +
            (tid % 2) * (D / 2);
#pragma unroll
        for (int c = 0; c < D / 2; c += 8) {
          const uint4 a = *reinterpret_cast<const uint4*>(dout + off + c);
          const uint4 b = *reinterpret_cast<const uint4*>(out + off + c);
          const uint32_t* pa = reinterpret_cast<const uint32_t*>(&a);
          const uint32_t* pb = reinterpret_cast<const uint32_t*>(&b);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float2 x = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&pa[u]));
            const float2 y = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&pb[u]));
            part += x.x * y.x + x.y * y.y;
          }
        }
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      if (tid % 2 == 0) s_delta[rl] = part;
    }
    float lse_r[2];
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      const int row = row_a + 8 * ii;
      lse_r[ii] = row < seq
          ? lse[(static_cast<long long>(batch) * gridDim.y + head) * seq + row]
          : INFINITY;  // P = 0 past S
    }

    // q~ = bf16(q * sm_scale * log2(e)), once, in place
    mbar_wait(q_bar, 0);
    unsigned char* s_q = smem + L::kQ;
    const unsigned char* s_do = smem + L::kDo;
    scale_tile<L::kTile, kConsumers>(s_q, s_q, scale_log2, tid);
    fence_proxy_async();
    bar_sync(1, kConsumers);
    const float delta_r[2] = {s_delta[warp * 16 + g], s_delta[warp * 16 + g + 8]};

    float acc_dq[kChunks][32];
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc_dq[c][e] = 0.f;

    for (int i = 0; i < n_tiles; ++i) {
      const int stage = i % kStages;
      const int kv0 = i * kBlock;
      mbar_wait(&full[stage], (i / kStages) & 1);
      const unsigned char* s_k = smem + L::kK + stage * L::kTile;
      const unsigned char* s_v = smem + L::kV + stage * L::kTile;

      // S = q~ K^T and dP = dO V^T: [64 rows, 64 keys]
      float acc_s[32], acc_dp[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<0, 0>(acc_s, desc_k(s_q + kk / 4 * kTileBytes, kk % 4),
                       desc_k(s_k + kk / 4 * kTileBytes, kk % 4), kk);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<0, 0>(acc_dp, desc_k(s_do + kk / 4 * kTileBytes, kk % 4),
                       desc_k(s_v + kk / 4 * kTileBytes, kk % 4), kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_s);
      fence_regs(acc_dp);

      // P = exp2(S + extra_bias - lse), keys past S (and past the row, if
      // causal) at -inf; dS = P (dP - delta)
      const bool masked = kv0 + kBlock > seq || (kCausal && kv0 == q0);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int ii = 0; ii < 2; ++ii)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int idx = 4 * j + 2 * ii + e;
            const int key = kv0 + 8 * j + 2 * tq + e;
            float s = acc_s[idx] + extra_bias;
            if (masked && (key >= seq || (kCausal && key > row_a + 8 * ii)))
              s = -INFINITY;
            const float p = exp2_approx(s - lse_r[ii]);
            acc_dp[idx] = p * (acc_dp[idx] - delta_r[ii]);
          }

      // dQ += bf16(dS) K: depth along the keys, K read MN-major
      uint32_t a_ds[4][4];
#pragma unroll
      for (int k = 0; k < 4; ++k) acc_as_a(a_ds[k], acc_dp, k);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          wgmma_rs<1>(acc_dq[c], a_ds[k], desc_mn(s_k + c * kTileBytes, k), 1);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < kChunks; ++c) fence_regs(acc_dq[c]);
#pragma unroll
      for (int k = 0; k < 4; ++k) fence_regs(a_ds[k]);
      mbar_arrive(&empty[stage]);
    }

    auto store = [&](auto* g) {
      auto* dst = g + batch * g_batch_stride + head * D + 2 * tq;
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const int row = row_a + 8 * ii;
        if (row >= seq) continue;
        auto* o_row = dst + row * g_row_stride;
#pragma unroll
        for (int c = 0; c < kChunks; ++c)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int idx = 4 * j + 2 * ii;
            store_pair(o_row + 64 * c + 8 * j, acc_dq[c][idx] * sm_scale,
                       acc_dq[c][idx + 1] * sm_scale);
          }
      }
    };
    if (out_f32)
      store(static_cast<float*>(dqkv));
    else
      store(static_cast<__nv_bfloat16*>(dqkv));
  }
}

// dq section of dqkv = bf16(dq_acc * sm_scale) for one (query tile, head,
// batch).  dq_acc holds, per (batch, head, query tile), the [64, D] share
// as the dk/dv kernel staged it: row-major, 16-byte chunks swizzled.
template <int D>
__global__ void __launch_bounds__(kConsumers)
    dq_convert_kernel(const float* __restrict__ dq_acc,
                      __nv_bfloat16* __restrict__ dqkv, int seq,
                      long long g_batch_stride, long long g_row_stride,
                      float sm_scale) {
  constexpr int kRowChunks = D / 4;
  const int t = blockIdx.x;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const float4* src = reinterpret_cast<const float4*>(
      dq_acc + ((static_cast<long long>(batch) * gridDim.y + head) * gridDim.x +
                t) * (kBlock * D));
  __nv_bfloat16* dst = dqkv + batch * g_batch_stride + head * D;
#pragma unroll 4
  for (int i = threadIdx.x; i < kBlock * kRowChunks; i += kConsumers) {
    const int r = i / kRowChunks;
    const int c = i % kRowChunks;
    const int row = t * kBlock + r;
    if (row >= seq) break;  // rows only grow with i
    const float4 v = src[r * kRowChunks + (c ^ (r & 7))];
    *reinterpret_cast<uint2*>(dst + row * g_row_stride + 4 * c) = make_uint2(
        pack_bf16(v.x * sm_scale, v.y * sm_scale),
        pack_bf16(v.z * sm_scale, v.w * sm_scale));
  }
}

// delta[b, h, s] = rowsum over head h's D columns of dO * O, in f32: one
// warp a row of the [B * S, W] inputs, D / 8 lanes a head.
template <int D>
__global__ void __launch_bounds__(256)
    delta_kernel(const __nv_bfloat16* __restrict__ dout,
                 const __nv_bfloat16* __restrict__ out,
                 float* __restrict__ delta, int seq, int heads,
                 long long rows) {
  const long long row = blockIdx.x * 8ll + threadIdx.x / 32;
  if (row >= rows) return;  // a whole warp
  const int lane = threadIdx.x % 32;
  const int width = heads * D;
  const long long batch = row / seq;
  const int pos = static_cast<int>(row % seq);
  for (int base = 0; base < width; base += 256) {
    const int c = base + lane * 8;
    float part = 0.f;
    if (c < width) {
      const uint4 a = *reinterpret_cast<const uint4*>(dout + row * width + c);
      const uint4 b = *reinterpret_cast<const uint4*>(out + row * width + c);
      const uint32_t* pa = reinterpret_cast<const uint32_t*>(&a);
      const uint32_t* pb = reinterpret_cast<const uint32_t*>(&b);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float2 x =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&pa[u]));
        const float2 y =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&pb[u]));
        part += x.x * y.x + x.y * y.y;
      }
    }
#pragma unroll
    for (int off = D / 16; off > 0; off /= 2)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (c < width && lane % (D / 8) == 0)
      delta[(batch * heads + c / D) * seq + pos] = part;
  }
}

struct Args {
  Operand q, k, v;
  const void* dout;
  const void* out;
  const void* lse;
  void* delta;
  void* dq_acc;
  void* dqkv;
  int batch, seq, heads;
  long long g_batch_stride, g_row_stride;
  float scale_log2, sm_scale, extra_bias;
  int out_f32;  // dqkv is f32 (split routes only), else bf16
  cudaStream_t stream;
};

// tensor maps over q, k, v (columns W, rows seq, batch) and dO
struct Maps {
  CUtensorMap q, k, v, dout;
};

cudaError_t make_maps(const Args& a, int head_dim, Maps* m) {
  const long long w = static_cast<long long>(a.heads) * head_dim;
  cudaError_t err =
      make_qkv_maps(&m->q, &m->k, &m->v, a.q, a.k, a.v, w, a.seq, a.batch);
  if (err != cudaSuccess) return err;
  return make_tile_map(&m->dout, a.dout, w, a.seq, a.batch, w * 2,
                       w * 2 * a.seq);
}

template <int D, bool kCausal, bool kDq>
int launch_kv(const Args& a) {
  auto kernel = bwd_kv_kernel<D, kCausal, kDq>;
  constexpr int smem = KvSmem<D, kDq>::kBytes;
  cudaError_t err = prepare_kernel(kernel, smem, kEntryRegs);
  if (err != cudaSuccess) return static_cast<int>(err);
  Maps m;
  err = make_maps(a, D, &m);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(a.batch) * a.seq;
  delta_kernel<D><<<static_cast<unsigned>((rows + 7) / 8), 256, 0,
                    a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.dout),
      static_cast<const __nv_bfloat16*>(a.out), static_cast<float*>(a.delta),
      a.seq, a.heads, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_q = (a.seq + kBlock - 1) / kBlock;
  const dim3 grid(n_q, a.heads, a.batch);
  kernel<<<grid, kBwdThreads, smem, a.stream>>>(
      m.q, m.k, m.v, m.dout, static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), a.dqkv,
      static_cast<float*>(a.dq_acc), a.seq, a.heads * D, a.g_batch_stride,
      a.g_row_stride, a.scale_log2, a.sm_scale, a.extra_bias, a.out_f32);
  err = cudaGetLastError();
  if (err != cudaSuccess || !kDq) return static_cast<int>(err);
  dq_convert_kernel<D><<<grid, kConsumers, 0, a.stream>>>(
      static_cast<const float*>(a.dq_acc), static_cast<__nv_bfloat16*>(a.dqkv),
      a.seq, a.g_batch_stride, a.g_row_stride, a.sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kCausal>
int launch_dq(const Args& a) {
  auto kernel = bwd_dq_kernel<D, kCausal>;
  constexpr int smem = DqSmem<D>::kBytes;
  cudaError_t err = prepare_kernel(kernel, smem, kEntryRegs);
  if (err != cudaSuccess) return static_cast<int>(err);
  Maps m;
  err = make_maps(a, D, &m);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.seq + kBlock - 1) / kBlock, a.heads, a.batch);
  kernel<<<grid, kBwdThreads, smem, a.stream>>>(
      m.q, m.k, m.v, m.dout, static_cast<const __nv_bfloat16*>(a.dout),
      static_cast<const __nv_bfloat16*>(a.out),
      static_cast<const float*>(a.lse), a.dqkv,
      a.seq, a.heads * D, a.g_batch_stride, a.g_row_stride, a.scale_log2,
      a.sm_scale, a.extra_bias, a.out_f32);
  return static_cast<int>(cudaGetLastError());
}

enum Route { kCombined, kDkv, kDqOnly };

int dispatch(Route route, int head_dim, int causal, const Args& a) {
  if (a.batch <= 0 || a.seq <= 0 || a.heads <= 0 || a.batch > 65535 ||
      a.heads > 65535 || (a.out_f32 && route == kCombined))
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

// Common arguments.  q, k, v: [batch, >= seq rows, W] bf16 each (W = heads
// * head_dim), rows `*_row_stride` and batches `*_batch_stride` elements
// apart, both multiples of 8, 16-byte aligned; they may be column views of
// one tensor.  dout and out (the forward's output; a ring passes the merged
// one): [batch, seq, W] bf16, contiguous, 16-byte aligned.  lse: [batch,
// heads, seq] f32, contiguous, in log2 units as the forward wrote it (a
// ring passes the global one).  dqkv: [batch, >= seq rows, 3W], bf16, or
// f32 with out_f32 (dq and dkv only), rows `g_row_stride` elements apart;
// rows past seq are not written.
// scale_log2 must be the forward's (sm_scale * log2(e) as f32), extra_bias
// the one its scores took.  Each launches on `stream` and returns the
// cudaError_t (0 on success; cudaErrorInvalidValue when a tensor map
// cannot describe an input).
#define AVION_BWD_PARAMS                                                    \
  int batch, int seq, int heads, int head_dim, long long q_batch_stride,    \
      long long q_row_stride, long long k_batch_stride,                     \
      long long k_row_stride, long long v_batch_stride,                     \
      long long v_row_stride, long long g_batch_stride,                     \
      long long g_row_stride, int causal, float scale_log2, float sm_scale, \
      float extra_bias, int out_f32, void *stream
#define AVION_BWD_ARGS(delta, dq_acc)                                       \
  const Args a {                                                            \
    {q, q_batch_stride, q_row_stride}, {k, k_batch_stride, k_row_stride},   \
        {v, v_batch_stride, v_row_stride}, dout, out, lse, delta, dq_acc,   \
        dqkv, batch, seq, heads, g_batch_stride, g_row_stride, scale_log2,  \
        sm_scale, extra_bias, out_f32, static_cast<cudaStream_t>(stream)    \
  }

// dq, dk and dv.  delta: [batch, heads, seq] f32 scratch (rowsum(dO * O)
// is written there first); dq_acc: [batch, heads, ceil(seq / 64) * 64,
// head_dim] f32 scratch, zero on entry.
int avion_flash_bwd_combined_bf16(const void* q, const void* k, const void* v,
                                  const void* dout, const void* out,
                                  const void* lse, void* delta, void* dq_acc,
                                  void* dqkv, AVION_BWD_PARAMS) {
  AVION_BWD_ARGS(delta, dq_acc);
  return dispatch(kCombined, head_dim, causal, a);
}

// dk and dv only; delta as for the combined route.
int avion_flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                             const void* dout, const void* out,
                             const void* lse, void* delta, void* dqkv,
                             AVION_BWD_PARAMS) {
  AVION_BWD_ARGS(delta, nullptr);
  return dispatch(kDkv, head_dim, causal, a);
}

// dq only, with delta computed in the kernel.
int avion_flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                            const void* dout, const void* out,
                            const void* lse, void* dqkv, AVION_BWD_PARAMS) {
  AVION_BWD_ARGS(nullptr, nullptr);
  return dispatch(kDqOnly, head_dim, causal, a);
}

#undef AVION_BWD_ARGS
#undef AVION_BWD_PARAMS

}  // extern "C"
