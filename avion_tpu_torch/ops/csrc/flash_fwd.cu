// Flash-attention forward for Hopper, sm_90a.
//
// Replaces two Pallas TPU kernels of avion_tpu/ops/flash_attention.py,
// reached from `_fwd_fused` and `_fwd`: `_fwd_infer_kernel` (need_lse=False,
// the serving path) and `_fwd_kernel` (need_lse=True, the training forward,
// which also writes each row's logsumexp for the backward).  They compute
// softmax(sm_scale * Q K^T + extra_bias [+ causal mask]) V in the log2
// domain; one template flag, kWriteLse, separates them.  q, k and v are
// three operands, each with its own base, strides and tensor map: the fused
// path passes three column views of the qkv projection output, a ring hop
// (ops/ring_attention.py, `_fwd` with `extra_bias` in the JAX package) its
// local q and a neighbour's [B, S, 2W] k/v buffer.
//
// extra_bias is an f32 runtime argument added to every log2-domain score
// (the ring voids a hop of future keys with the mask value -1e30).  Then
// every valid score rounds to exactly -1e30, the row max is -1e30 and not
// -inf, so P = 1 on the valid keys: a finite output (the mean of v) and
// lse = -1e30 + log2(S), which the ring's f32 merge weights to 0.  Keys
// past S stay at -inf and still get P = 0.
//
// lse is the row logsumexp of the log2-domain scores, m + log2(l), as f32
// [B, H, S] (the TPU layout [B, H/hpp, hpp, S_pad] exists only for its lane
// packing).  Rows past S are not written.
//
// Numerics follow the TPU kernel, and the backward (flash_bwd.cu) relies on
// them: q is scaled by sm_scale * log2(e) in f32 and rounded back to bf16
// (q~) before the score product, so the backward's P = exp2(q~ k^T - lse)
// is this kernel's P; probabilities are exp2 in f32 by the special-function
// unit (ex2.approx.ftz, relative error ~2^-22, as in the backward); P is
// cast to bf16 before the PV product (f32 accumulation); the output is
// divided by the f32 row sum after PV.
//
// What bounds it on an H100.  Attention at the CLIP shapes does 4*S*D flops
// per 8*D bytes of q/k/v/out, i.e. S/2 flops per byte: the visual tower
// (S = 785 or 3137) sits above the card's ~295 flop/byte ridge and is
// bound by tensor-core operations; the causal text tower (S = 77, one key
// tile) is far below it and bound by bytes and launch latency.  On this
// card only wgmma reaches the tensor cores' full rate; it wants its
// operands in swizzled shared memory, fed without the math warps' help;
// and at D = 64 the softmax's exp2 keeps the special-function unit busy
// about as long as the two products keep the tensor cores, so the two
// have to run side by side (FlashAttention-3).  So:
//   - a block is one consumer warpgroup (64 query rows, 16 a warp) and a
//     producer warpgroup that hands its registers to the consumers
//     (setmaxnreg, 24 against 232 a thread); two blocks share an SM, so one
//     block's softmax runs beside the other's products and one's prologue
//     and epilogue beside the other's main loop;
//   - one producer thread loads the block's q tile once and rings K and V
//     tiles of kKeys keys (128 at D = 64, 64 at D = 128, where two blocks
//     of 128 would not fit in shared memory) through two stages each by
//     TMA, on barriers of their own, K one tile ahead of V, so a stage of K
//     is refilled as soon as its score product is done;
//   - q~ is made once per block, in place in shared memory; S = q~ K^T
//     is a shared-shared wgmma with both operands K-major (m64n128k16 at
//     128 keys); O += bf16(P) V takes P from the score accumulators
//     repacked as register A (acc_as_a) and V MN-major through the
//     transpose bit, 64 output columns a product;
//   - overlap within the warpgroup: tile j's S and tile j-1's PV are issued
//     together, S is waited for alone, and tile j's softmax runs while PV
//     is on the tensor cores (FlashAttention-3 §3.2);
//   - no wgmma sits in a branch: ptxas serializes every wgmma of a kernel
//     that has one on a divergent path (its C7520 note), which cost a
//     quarter of the time in bring-up;
//   - no padding of S: the tensor maps end at row S, so TMA zero-fills the
//     ragged tile and never reads a row past S; keys at or past S (and,
//     causal, past the row) go to -inf before exp2; no output row or lse
//     past S is stored;
//   - extra_bias is one FADD a score, outside any branch;
//   - causal blocks stop at the diagonal tile and start longest first.
// Two consumer warpgroups a block (128 rows sharing each K/V stage, one
// block an SM), with or without a ping-pong between them on named barriers
// (FlashAttention-3 §3.1), and 64-key tiles at D = 64 measured slower than
// this layout on an H100; PERF.md has the times.

#include "flash_sm90.cuh"

namespace {

using namespace avion;
using namespace avion::sm90;

constexpr int kBlockM = 64;       // query rows a block: one warpgroup's
constexpr int kConsumers = 128;
// and a producer warpgroup, of which one thread works: setmaxnreg moves
// registers a warpgroup at a time
constexpr int kFwdThreads = kConsumers + 128;
constexpr int kStages = 2;        // of K and of V each
// registers a thread at launch (ptxas, from the launch bounds: two blocks
// of 8 warps) and after the hand-over
constexpr int kMinBlocks = 2;
constexpr int kEntryRegs = 128;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 232;
static_assert(128 * (kEntryRegs - kProducerRegs) ==
                  kConsumers * (kConsumerRegs - kEntryRegs),
              "register hand-over must balance");

// byte offsets of the shared memory, from a 1024-aligned base
template <int D>
struct FwdSmem {
  static constexpr int kKeys = D == 64 ? 128 : 64;
  static constexpr int kQTile = D / 64 * kTileBytes;  // [64, D]
  static constexpr int kKvChunk = kKeys * 128;        // [kKeys][64 columns]
  static constexpr int kKvTile = D / 64 * kKvChunk;   // [kKeys, D]
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQTile;              // per stage
  static constexpr int kV = kK + kStages * kKvTile;   // per stage
  static constexpr int kBars = kV + kStages * kKvTile;
  static constexpr int kBytes = kBars + (1 + 4 * kStages) * 8 + 1024;
};

// one [kKeys, D] tile of K or V (columns from col0) on `bar`
template <int D, int kKeys>
__device__ __forceinline__ void load_kv(unsigned char* dst,
                                        const CUtensorMap* map, uint64_t* bar,
                                        int col0, int row0, int batch) {
  mbar_arrive_expect_tx(bar, D / 64 * kKeys * 128);
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
#pragma unroll
    for (int r = 0; r < kKeys / 64; ++r)
      tma_load_tile(dst + c * kKeys * 128 + r * kTileBytes, map, bar,
                    col0 + 64 * c, row0 + 64 * r, batch);
}

// S = q~ K^T: [64 rows, kKeys keys], both operands K-major
template <int D, int kKeys>
__device__ __forceinline__ void issue_scores(float (&s)[kKeys / 2],
                                             const unsigned char* q,
                                             const unsigned char* k) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<0, 0>(s, desc_k(q + kk / 4 * kTileBytes, kk % 4),
                   desc_k(k + kk / 4 * (kKeys * 128), kk % 4), kk);
}

// O += bf16(P) V: depth along the keys, V read MN-major
template <int D, int kKeys>
__device__ __forceinline__ void issue_pv(float (&o)[D / 64][32],
                                         uint32_t (&p)[kKeys / 16][4],
                                         const unsigned char* v) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
#pragma unroll
    for (int k = 0; k < kKeys / 16; ++k)
      wgmma_rs<1>(o[c], p[k], desc_mn(v + c * (kKeys * 128), k), 1);
}

// keys at or past S and, causal, past the row to -inf; key0 is the key of
// this thread's first column, row0 the row of its first accumulator row
template <bool kCausal, int N>
__device__ __forceinline__ void mask_scores(float (&s)[N], int key0, int row0,
                                            int seq) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = key0 + 8 * j + e;
        if (key >= seq || (kCausal && key > row0 + 8 * i))
          s[4 * j + 2 * i + e] = -INFINITY;
      }
}

// Online softmax over one tile, in place: with the running max m and this
// thread's partial row sums l of its two rows, the scores become
// exp2(s - m_new); alpha = exp2(m_old - m_new) rescales the old output.
template <int N>
__device__ __forceinline__ void softmax_tile(float (&s)[N], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2]) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      mx[i] = fmaxf(mx[i], fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
  float sub[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    // the 4 threads of a row
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    sub[i] = mx[i] == -INFINITY ? 0.f : mx[i];  // a row with no key yet
    alpha[i] = exp2_approx(m[i] - sub[i]);
    m[i] = mx[i];
    l[i] *= alpha[i];
  }
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * i + e];
        x = exp2_approx(x - sub[i]);
        l[i] += x;
      }
}

template <int D, bool kCausal, bool kWriteLse>
__global__ void __launch_bounds__(kFwdThreads, kMinBlocks)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     __nv_bfloat16* __restrict__ out,
                     float* __restrict__ lse, int seq,
                     long long out_batch_stride, long long out_row_stride,
                     float scale_log2, float extra_bias) {
  using L = FwdSmem<D>;
  constexpr int kKeys = L::kKeys;
  constexpr int kChunks = D / 64;  // 64-column tiles across the head

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full_k = q_bar + 1;
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty_k = full_v + kStages;
  uint64_t* empty_v = empty_k + kStages;

  // causal: the blocks with the most key tiles start first
  const int m_block = kCausal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = m_block * kBlockM;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  int n_tiles = (seq + kKeys - 1) / kKeys;
  if (kCausal) n_tiles = min(n_tiles, (q0 + kBlockM - 1) / kKeys + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], kConsumers / 32);  // one arrival a warp
      mbar_init(&empty_v[s], kConsumers / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer: q once, then K and V tiles through their rings
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x == kConsumers) {
      tma_prefetch_map(&map_q);
      tma_prefetch_map(&map_k);
      tma_prefetch_map(&map_v);
      mbar_arrive_expect_tx(q_bar, L::kQTile);
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
        tma_load_tile(smem + L::kQ + c * kTileBytes, &map_q, q_bar,
                      head * D + 64 * c, q0, batch);
      // K runs one tile ahead of V, as the consumers use them
      for (int i = 0; i <= n_tiles; ++i) {
        if (i < n_tiles) {
          const int stage = i % kStages;
          mbar_wait(&empty_k[stage], ((i / kStages) & 1) ^ 1);
          load_kv<D, kKeys>(smem + L::kK + stage * L::kKvTile, &map_k,
                            &full_k[stage], head * D, i * kKeys, batch);
        }
        if (i > 0) {
          const int stage = (i - 1) % kStages;
          mbar_wait(&empty_v[stage], (((i - 1) / kStages) & 1) ^ 1);
          load_kv<D, kKeys>(smem + L::kV + stage * L::kKvTile, &map_v,
                            &full_v[stage], head * D, (i - 1) * kKeys,
                            batch);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows, 16 a warp
    regs_alloc<kConsumerRegs>();
    const int tid = threadIdx.x;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;
    const int tq = lane % 4;
    const int row_a = q0 + warp * 16 + g;  // row of i = 0; +8 for i = 1
    unsigned char* s_q = smem + L::kQ;

    // q~ = bf16(q * sm_scale * log2(e)), once, in place; named barrier 1
    // holds the consumers alone
    mbar_wait(q_bar, 0);
    scale_tile<L::kQTile, 128>(s_q, s_q, scale_log2, tid);
    fence_proxy_async();
    bar_sync(1, kConsumers);

    float acc_s[kKeys / 2];
    uint32_t a_p[kKeys / 16][4];
    float acc_o[kChunks][32];
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc_o[c][e] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};  // this thread's columns only
    float alpha[2];

    // each warp tells the producer a stage is free once its products are
    // done (wgmma.wait_group is warp-wide)
    auto release = [&](uint64_t* bar) {
      if (lane == 0) mbar_arrive(bar);
    };
    // bias, mask and softmax of key tile i's scores; P into register A
    auto softmax = [&](int i) {
      const int kv0 = i * kKeys;
#pragma unroll
      for (int e = 0; e < kKeys / 2; ++e) acc_s[e] += extra_bias;
      if (kv0 + kKeys > seq ||
          (kCausal && kv0 + kKeys - 1 > q0 + warp * 16))
        mask_scores<kCausal>(acc_s, kv0 + 2 * tq, row_a, seq);
      softmax_tile(acc_s, m_run, l_run, alpha);
    };
    auto pack_p = [&]() {
#pragma unroll
      for (int k = 0; k < kKeys / 16; ++k) acc_as_a(a_p[k], acc_s, k);
    };

    // key tile 0: its scores alone
    mbar_wait(&full_k[0], 0);
    wgmma_fence();
    issue_scores<D, kKeys>(acc_s, s_q, smem + L::kK);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_s);
    release(&empty_k[0]);
    softmax(0);
    pack_p();

    // tile i's scores and tile i-1's PV in flight together; tile i's
    // softmax runs while PV does
    for (int i = 1; i < n_tiles; ++i) {
      const int stage = i % kStages;
      const int prev = (i - 1) % kStages;
      mbar_wait(&full_k[stage], (i / kStages) & 1);
      mbar_wait(&full_v[prev], ((i - 1) / kStages) & 1);
      wgmma_fence();
      issue_scores<D, kKeys>(acc_s, s_q, smem + L::kK + stage * L::kKvTile);
      wgmma_commit();
      issue_pv<D, kKeys>(acc_o, a_p, smem + L::kV + prev * L::kKvTile);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(acc_s);
      release(&empty_k[stage]);
      softmax(i);
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < kChunks; ++c) fence_regs(acc_o[c]);
#pragma unroll
      for (int k = 0; k < kKeys / 16; ++k) fence_regs(a_p[k]);
      release(&empty_v[prev]);
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
#pragma unroll
        for (int e = 0; e < 32; ++e) acc_o[c][e] *= alpha[(e >> 1) & 1];
      pack_p();
    }

    // the last tile's PV
    const int last = (n_tiles - 1) % kStages;
    mbar_wait(&full_v[last], ((n_tiles - 1) / kStages) & 1);
    wgmma_fence();
    issue_pv<D, kKeys>(acc_o, a_p, smem + L::kV + last * L::kKvTile);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < kChunks; ++c) fence_regs(acc_o[c]);

    // the row sums across the 4 threads of a row; normalize and store the
    // rows below S
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
      l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
    }
    __nv_bfloat16* o_dst = out + batch * out_batch_stride + head * D + 2 * tq;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row_a + 8 * i;
      if (row >= seq) continue;
      if (kWriteLse && tq == 0)
        lse[(static_cast<long long>(batch) * gridDim.y + head) * seq + row] =
            m_run[i] + log2f(l_run[i]);
      const float inv = 1.f / l_run[i];
      __nv_bfloat16* o_row = o_dst + row * out_row_stride;
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<uint32_t*>(o_row + 64 * c + 8 * j) =
              pack_bf16(acc_o[c][4 * j + 2 * i] * inv,
                        acc_o[c][4 * j + 2 * i + 1] * inv);
    }
  }
}

struct FwdArgs {
  Operand q, k, v;
  void* out;
  float* lse;
  int batch, seq, heads;
  long long out_batch_stride, out_row_stride;
  float scale_log2, extra_bias;
  cudaStream_t stream;
};

template <int D, bool kCausal, bool kWriteLse>
int launch(const FwdArgs& a) {
  auto kernel = flash_fwd_kernel<D, kCausal, kWriteLse>;
  constexpr int smem = FwdSmem<D>::kBytes;
  cudaError_t err = prepare_kernel(kernel, smem, kEntryRegs);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap map_q, map_k, map_v;
  const long long w = static_cast<long long>(a.heads) * D;
  err = make_qkv_maps(&map_q, &map_k, &map_v, a.q, a.k, a.v, w, a.seq,
                      a.batch);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.seq + kBlockM - 1) / kBlockM, a.heads, a.batch);
  kernel<<<grid, kFwdThreads, smem, a.stream>>>(
      map_q, map_k, map_v, static_cast<__nv_bfloat16*>(a.out), a.lse, a.seq,
      a.out_batch_stride, a.out_row_stride, a.scale_log2, a.extra_bias);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, k, v: [batch, >= seq rows, W] bf16 each (W = heads * head_dim), rows
// `*_row_stride` and batches `*_batch_stride` elements apart (multiples of
// 8, below 2^39), 16-byte aligned; they may be column views of one tensor.
// out: [batch, seq, W] bf16.  lse: null (inference) or [batch, heads, seq]
// f32, the row logsumexp in log2 units.  extra_bias is added to every
// log2-domain score.  Launches on `stream`; returns the cudaError_t (0 on
// success; cudaErrorInvalidValue when a tensor map cannot describe an
// operand).
int avion_flash_fwd_bf16(const void* q, const void* k, const void* v,
                         void* out, void* lse, int batch, int seq, int heads,
                         int head_dim, long long q_batch_stride,
                         long long q_row_stride, long long k_batch_stride,
                         long long k_row_stride, long long v_batch_stride,
                         long long v_row_stride, long long out_batch_stride,
                         long long out_row_stride, int causal,
                         float scale_log2, float extra_bias, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || batch > 65535 || heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const FwdArgs a{{q, q_batch_stride, q_row_stride},
                  {k, k_batch_stride, k_row_stride},
                  {v, v_batch_stride, v_row_stride},
                  out, static_cast<float*>(lse), batch, seq, heads,
                  out_batch_stride, out_row_stride, scale_log2, extra_bias,
                  static_cast<cudaStream_t>(stream)};
#define AVION_LAUNCH(D, C, L) return launch<D, C, L>(a)
#define AVION_LAUNCH_LSE(D, C) \
  if (a.lse) AVION_LAUNCH(D, C, true); \
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
