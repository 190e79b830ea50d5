// Non-causal flash-attention backward for Hopper (sm_90a), FlashAttention-2 split.
//
// Given q, k, v, the forward's lse residual (natural log of the scaled logits'
// normaliser, fp32 (B, H, Tq)), the output cotangent dO and delta = rowsum(dO * O) (fp32
// (B, H, Tq), computed by the wrapper), two kernels recompute P = exp(q k^T * scale - lse)
// tile by tile and form
//   dV = P^T dO,   dP = dO V^T,   dS = P * (dP - delta),
//   dQ = dS K * scale,   dK = dS^T Q * scale.
// The dq kernel owns query rows and loops over key tiles; the dk/dv kernel owns keys and
// loops over query tiles. Each output element is written by one thread of one block, with
// its sums in a fixed order: no atomics, and two calls give the same bits.
//
// Replaces the TPU's backward kernels of mapanything_tpu/ops/flash_attention.py:
//   K5 _dq_aug_kernel (:227, launched :1055) and _dkv_aug_kernel (:262, launched :1074),
//      called from _core_bwd (:1036) at d % 128 != 0: encoder and trunk frame layers;
//   K6 _pair_dq_kernel (:715, launched :841) and _pair_dkv_kernel (:753, launched :862),
//      called from _pair_core_bwd (:807): trunk global layers at d = 64;
//   K8 _dq_kernel (:306, launched :1107) and _dkv_kernel (:339, launched :1128), called
//      from _core_bwd at d % 128 == 0: every backward with 128-wide heads.
// On the TPU these differ by head-pair packing, augmented ones/bias columns and a
// constant-shift base-2 softmax, all ways to fit VMEM and the 128-wide MXU. Here one
// streaming design serves every length, as the forward does.
//
// Layout. q, k, v and dO are (B, T, H, D) with a unit head-dim stride, read in place
// (the views of the fused qkv projection need no copy). dq, dk and dv are written as
// contiguous (B, T, H, D) tensors; rows past Tq or Tk are never stored.
//
// fa_bwd_dq_bf16<D> / fa_bwd_dkv_bf16<D>, D = 64 and 128: the main path's instances, in
// the design of the bf16 forward (csrc/flash_attention_fwd.cu).
//   Bound on this card. Five T^2*D products (S, dP, dV, dK, dQ), 10*B*H*T^2*D flop,
//   against O(T*H*D) bytes: the tensor cores bound it. The split recomputes S and dP in
//   the dq kernel, 14 products' worth for the 10 needed, so it cannot pass 10/14 of the
//   bound; in exchange no output needs atomics. Each kernel takes one ex2 a score
//   (16 a clock per SM) against 4 or 6 products of D flop each on the tensor cores.
//   Design. A persistent grid of one block an SM, each block walking work tiles of 128
//   rows of one (batch, head): w = blockIdx.x, + gridDim.x, ... Warpgroup 0 is the
//   producer: it gives up its registers (setmaxnreg 24), and one thread issues TMA loads
//   through 4-D tensor maps over (D, T, H, B) (64-column boxes in the 128-byte swizzle;
//   TMA zero-fills rows past T, so a padded row adds exactly zero to every product).
//   Warpgroups 1 and 2 are consumers of 64 rows each (setmaxnreg 240) that run every
//   product with wgmma.
//   dq: a work tile is 128 query rows; its Q and dO tiles load once, K and V tiles of
//   kBlockN keys stream through two rings with full and empty mbarriers. For key tile j
//   a consumer issues S_j = Q K_j^T and dP_j = dO V_j^T (wgmma from shared memory, both
//   operands K-major) together with dQ += dS_{j-1} K_{j-1} (A from registers, K through
//   the transpose bit), then forms dS_j = exp2(S_j scale log2e - lse2) (dP_j - delta) in
//   the S accumulators while that product runs, and packs it to bf16 in place as the
//   next product's A fragments (the accumulator's layout is the A fragment's). Each
//   thread reads its two rows' lse and delta once a work tile. Keys past Tk get dS = 0.
//   The two consumers take turns to issue on two named barriers (ping-pong), so that
//   one's exponentials run under the other's products: without it dq took 1.2x as long.
//   dk/dv: a work tile is 128 keys; its K and V tiles load once, and stages of kBlockM
//   query rows stream through one ring: each stage holds a Q and a dO tile (TMA) and the
//   rows' base-2 lse and delta, which the producer's other three warps fill with plain
//   loads, a row a thread (their (B, H, Tq) rows are Tq * 4 bytes apart, which breaks
//   TMA's 16-byte stride rule whenever Tq % 4 != 0); their 96 arrivals and the TMA's
//   bytes complete the stage's full barrier. For stage i a consumer forms
//   P_i^T = exp2(S_i^T scale log2e - lse2[col]), issues dV += P_i^T dO_i, forms
//   dS_i^T = P_i^T (dP_i^T - delta[col]), then issues S_{i+1}^T = K Q_{i+1}^T and
//   dP_{i+1}^T = V dO_{i+1}^T with dK += dS_i^T Q_i; one set of fragments serves P^T and
//   dS^T in turn. Its products are small and depend on each other, so it runs without
//   the ping-pong (1.14x as long with it at the global layer). Query rows past Tq read
//   lse = +inf and delta = 0, so their P and dS are 0.
//   Tile sizes, registers and every choice above were held by same-call A/Bs of
//   variants (PERF.md, section 6). P and dS are rounded to bf16 for the products that
//   consume them, as FlashAttention-2 does. Shared memory (dynamic, raised once per
//   instance and device): dq 129.1 KB at D = 64 and 161.1 KB at D = 128, dk/dv 107.3 KB
//   and 113.8 KB.
// fa_bwd_dq_f32 / fa_bwd_dkv_f32: fp32 SIMT, D / 32 threads per row (2 at D = 64, 4 at
//   D = 128), each holding its share of the head dim; the fp32 model's path. Their tiles
//   take 32.5 KB and 64.5 KB; above 48 KB as dynamic shared memory.

#include "flash_attention_common.cuh"

namespace {

// Tile plans of the bf16 instances (ops/flash_attention.py's BWD_TILES mirrors them; the
// launchers refuse tensor maps of another box). A consumer thread holds S and dP (kBlockN
// / 2 floats each in dq, kBlockM / 2 in dk/dv), its accumulators (dQ: D / 2; dK and dV:
// D / 2 each) and the bf16 A fragments of one product (kBlockN / 4 or kBlockM / 4): 192
// registers for dq at D = 64, 144 at D = 128; 184 and 168 for dk/dv, within setmaxnreg's
// 240 and with no spill. 64-row dk/dv stages at D = 128 (208) spilled; at D = 64, 96 rows
// ran 1.1x faster than 64.
template <int D>
struct DqPlan {
  static constexpr int kBlockM = 128;              // query rows a work tile
  static constexpr int kBlockN = D == 64 ? 128 : 64;  // keys a K or V tile
  static constexpr int kStages = 3;
  static constexpr int kConsumers = kBlockM / 64;
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kPanels = D / 64;           // 64-column (128-byte) boxes a row
  static constexpr int kPanelQ = kBlockM * 128;    // bytes of one panel of the Q (or dO) tile
  static constexpr int kPanelKV = kBlockN * 128;   // of a K or V tile
  static constexpr int kQBytes = kPanels * kPanelQ;
  static constexpr int kTileBytes = kPanels * kPanelKV;
  static constexpr int kBarriers = 2 + 4 * kStages;  // full and empty of Q/dO and of each K and V stage
  static constexpr int kBarOffset = 2 * kQBytes + 2 * kStages * kTileBytes;
  static constexpr int kSmem = kBarOffset + 8 * kBarriers + 1024;  // + slack to align to 1024
};

template <int D>
struct DkvPlan {
  static constexpr int kBlockN = 128;  // keys a work tile
  static constexpr int kBlockM = D == 64 ? 96 : 32;  // query rows a stage
  static constexpr int kStatThreads = 96;  // the producer's warps 1-3 fill the statistics
  static constexpr int kStages = 3;
  // D = 128: dS^T forms before dV is issued, and S^T and dP^T are dead (re-zeroed) from
  // their last use to the next stage's issue. D = 64 forms P^T under the previous
  // stage's dK and dS^T under dV. Each order is 1.05x faster than the other where used.
  static constexpr bool kEarlyDs = D == 128;
  static constexpr int kConsumers = kBlockN / 64;
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kPanels = D / 64;
  static constexpr int kPanelKV = kBlockN * 128;  // bytes of one panel of the K (or V) tile
  static constexpr int kPanelQ = kBlockM * 128;   // of a stage's Q (or dO) tile
  static constexpr int kKVBytes = kPanels * kPanelKV;
  static constexpr int kStageBytes = kPanels * kPanelQ;
  static constexpr int kStatOffset = 2 * kKVBytes + 2 * kStages * kStageBytes;  // lse2, delta of each stage
  static constexpr int kBarOffset = kStatOffset + kStages * 2 * kBlockM * 4;
  static constexpr int kBarriers = 2 + 2 * kStages;  // full and empty of K/V and of each stage
  static constexpr int kSmem = kBarOffset + 8 * kBarriers + 1024;
};

constexpr int kProducerRegs = 24, kConsumerRegs = 240;

// Named barriers of the dq consumers' ping-pong: consumer c issues its products after
// syncing on kSchedBarrier + c, then lets the other one issue. Consumer 0 goes first;
// after the block's last issue, consumer 1's turn would pass to no one, so it skips that
// arrival.
constexpr int kSchedBarrier = 1;

// Store a consumer's 64 x D accumulators (the wgmma fragment layout), times `mul`, as
// bf16 rows row0 and row0 + 8 of a contiguous (B, T, H, D); rows at or past T are skipped.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, const float (&acc)[D / 2], float mul, int b, int h,
                                           int row0, int T, int H, int t) {
  const int row1 = row0 + 8;
  __nv_bfloat16* o0 = out + ((static_cast<long long>(b) * T + row0) * H + h) * D;
  __nv_bfloat16* o1 = out + ((static_cast<long long>(b) * T + row1) * H + h) * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (row0 < T) *reinterpret_cast<uint32_t*>(o0 + col) = pack_bf16(acc[4 * j] * mul, acc[4 * j + 1] * mul);
    if (row1 < T) *reinterpret_cast<uint32_t*>(o1 + col) = pack_bf16(acc[4 * j + 2] * mul, acc[4 * j + 3] * mul);
  }
}

// x (64 x N fp32 accumulators) to bf16 A fragments, one per 16 columns.
template <int N>
__device__ __forceinline__ void pack_fragments(uint32_t (&pa)[N / 16][4], const float (&x)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) pa[kk][i] = pack_bf16(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
}

// dQ for work tiles of 128 query rows of one (batch, head).
template <int D>
__global__ void __launch_bounds__(DqPlan<D>::kThreads, 1)
    fa_bwd_dq_bf16(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                   const float* __restrict__ lse, const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
                   int Tq, int Tk, int H, int n_work, float scale, float scale_log2) {
  static_assert(D == 64 || D == 128, "the tile plan covers D in {64, 128}");
  using P = DqPlan<D>;
  constexpr int kBlockN = P::kBlockN, kStages = P::kStages;
  extern __shared__ __align__(1024) unsigned char dq_smem[];
  const uint32_t base = (smem_u32(dq_smem) + 1023) & ~1023u;
  const uint32_t sQ = base, sdO = sQ + P::kQBytes, sK = sdO + P::kQBytes, sV = sK + kStages * P::kTileBytes;
  const uint32_t full_q = base + P::kBarOffset, empty_q = full_q + 8;
  auto full_k = [&](int s) { return full_q + 8 * (2 + s); };
  auto empty_k = [&](int s) { return full_q + 8 * (2 + kStages + s); };
  auto full_v = [&](int s) { return full_q + 8 * (2 + 2 * kStages + s); };
  auto empty_v = [&](int s) { return full_q + 8 * (2 + 3 * kStages + s); };

  // Work tile w: query rows 128 * (w % m_blocks) .. + 127 of head (w / m_blocks) % H of
  // batch w / (m_blocks * H).
  const int m_blocks = (Tq + P::kBlockM - 1) / P::kBlockM;
  const int n_tiles = (Tk + kBlockN - 1) / kBlockN;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    mbar_init(empty_q, 4 * P::kConsumers);  // one arrival a consumer warp
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), 4 * P::kConsumers);
      mbar_init(empty_v(s), 4 * P::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // Producer. Q and dO of the next work tile load as soon as the consumers have issued
    // their last S and dP of this one; K_j and V_j load side by side. V_j is released
    // after dP_j, K_j after dQ += dS_j K_j. The rings' stages and phases run on across
    // work tiles (n_tiles loads each).
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      auto load = [&](const CUtensorMap* map, uint32_t ring, uint32_t full, uint32_t empty, int i, int j, int h,
                      int b) {
        mbar_wait(empty, ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full, P::kTileBytes);
        for (int p = 0; p < P::kPanels; ++p) tma_load_4d(ring + p * P::kPanelKV, map, full, 64 * p, j * kBlockN, h, b);
      };
      int it = 0;  // K (and V) tiles loaded before this work tile
      for (int w = blockIdx.x, round = 0; w < n_work; w += gridDim.x, ++round, it += n_tiles) {
        const int m0 = (w % m_blocks) * P::kBlockM, h = (w / m_blocks) % H, b = w / (m_blocks * H);
        mbar_wait(empty_q, (round & 1) ^ 1);
        mbar_expect_tx(full_q, 2 * P::kQBytes);
        for (int p = 0; p < P::kPanels; ++p) {
          tma_load_4d(sQ + p * P::kPanelQ, &tm_q, full_q, 64 * p, m0, h, b);
          tma_load_4d(sdO + p * P::kPanelQ, &tm_do, full_q, 64 * p, m0, h, b);
        }
        for (int j = 0; j < n_tiles; ++j) {
          const int s = (it + j) % kStages;
          load(&tm_k, sK + s * P::kTileBytes, full_k(s), empty_k(s), it + j, j, h, b);
          load(&tm_v, sV + s * P::kTileBytes, full_v(s), empty_v(s), it + j, j, h, b);
        }
      }
    }
  } else {
    regs_alloc<kConsumerRegs>();
    const int c = wg - 1;  // consumer: query rows 64c .. 64c + 63 of each work tile
    const int tw = threadIdx.x % 128, warp = tw / 32, lane = tw % 32;
    const int g = lane >> 2, t = lane & 3;
    const uint32_t q_rows = sQ + c * 64 * 128, do_rows = sdO + c * 64 * 128;

    float acc[D / 2];                // dQ, 64 x D
    float s[kBlockN / 2];            // S, then dS, 64 x kBlockN
    float dp[kBlockN / 2];           // dP
    uint32_t pa[kBlockN / 16][4];    // dS in bf16 as the A fragments of dQ += dS K
    float lse2[2], dlt[2];           // this thread's two rows' base-2 lse and delta
#pragma unroll
    for (int i = 0; i < kBlockN / 2; ++i) s[i] = dp[i] = 0.f;

    auto issue_sdp = [&](int stage) {  // S = Q K^T, dP = dO V^T
      const uint32_t k_tile = sK + stage * P::kTileBytes, v_tile = sV + stage * P::kTileBytes;
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;  // 16 columns of the 128-byte row
        Wgmma<kBlockN>::ss(s, sw128_desc(q_rows + (kk / 4) * P::kPanelQ + off, 16),
                           sw128_desc(k_tile + (kk / 4) * P::kPanelKV + off, 16), kk > 0);
        Wgmma<kBlockN>::ss(dp, sw128_desc(do_rows + (kk / 4) * P::kPanelQ + off, 16),
                           sw128_desc(v_tile + (kk / 4) * P::kPanelKV + off, 16), kk > 0);
      }
      wgmma_commit();
    };
    auto issue_dq = [&](int stage) {  // dQ += dS K
      const uint32_t k_tile = sK + stage * P::kTileBytes;
      fence_regs(acc);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) Wgmma<D>::rs(acc, pa[kk], sw128_desc(k_tile + kk * 2048, P::kPanelKV), 1);
      wgmma_commit();
    };
    // s = dS = P (dP - delta), P = exp2(S scale log2e - lse2); keys at or past Tk get 0.
    auto form_ds = [&](int kv0) {
#pragma unroll
      for (int j = 0; j < kBlockN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          s[4 * j + e] = ex2(fmaf(s[4 * j + e], scale_log2, -lse2[r])) * (dp[4 * j + e] - dlt[r]);
        }
      if (kv0 + kBlockN > Tk) {
#pragma unroll
        for (int j = 0; j < kBlockN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (kv0 + 8 * j + 2 * t + (e & 1) >= Tk) s[4 * j + e] = 0.f;
      }
    };
    auto release = [&](uint32_t empty) {
      if (lane == 0) mbar_arrive(empty);
    };

    if (c == 0) named_arrive(kSchedBarrier, 256);  // consumer 0 issues first
    int it = 0;
    for (int w = blockIdx.x, round = 0; w < n_work; w += gridDim.x, ++round, it += n_tiles) {
      const int m0 = (w % m_blocks) * P::kBlockM, h = (w / m_blocks) % H, b = w / (m_blocks * H);
      const int row0 = m0 + c * 64 + warp * 16 + g;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        const long long i = (static_cast<long long>(b) * H + h) * Tq + row;
        lse2[r] = row < Tq ? lse[i] * kLog2e : INFINITY;
        dlt[r] = row < Tq ? delta[i] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      mbar_wait(full_q, round & 1);

      // Key tile 0: S_0 and dP_0 alone.
      const int s0 = it % kStages;
      mbar_wait(full_k(s0), (it / kStages) & 1);
      mbar_wait(full_v(s0), (it / kStages) & 1);
      named_sync(kSchedBarrier + c, 256);
      issue_sdp(s0);
      named_arrive(kSchedBarrier + (c ^ 1), 256);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      release(empty_v(s0));
      if (n_tiles == 1) release(empty_q);
      form_ds(0);
      pack_fragments<kBlockN>(pa, s);

      // Key tile j: issue S_j, dP_j and dQ += dS_{j-1} K_{j-1}; dS_j forms under the last.
      for (int j = 1; j < n_tiles; ++j) {
        const int sj = (it + j) % kStages, sp = (it + j - 1) % kStages;
        mbar_wait(full_k(sj), ((it + j) / kStages) & 1);
        mbar_wait(full_v(sj), ((it + j) / kStages) & 1);
        named_sync(kSchedBarrier + c, 256);
        issue_sdp(sj);
        issue_dq(sp);
        named_arrive(kSchedBarrier + (c ^ 1), 256);
        wgmma_wait<1>();
        fence_regs(s);
        fence_regs(dp);
        release(empty_v(sj));
        if (j == n_tiles - 1) release(empty_q);
        form_ds(j * kBlockN);
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(pa);
        release(empty_k(sp));
        pack_fragments<kBlockN>(pa, s);
      }

      // The last key tile's dQ product.
      const int sl = (it + n_tiles - 1) % kStages;
      named_sync(kSchedBarrier + c, 256);
      issue_dq(sl);
      if (c == 0 || w + static_cast<int>(gridDim.x) < n_work) named_arrive(kSchedBarrier + (c ^ 1), 256);
      wgmma_wait<0>();
      fence_regs(acc);
      release(empty_k(sl));
      store_rows<D>(dq, acc, scale, b, h, row0, Tq, H, t);
    }
  }
}

// dK and dV for work tiles of 128 keys of one (batch, head).
template <int D>
__global__ void __launch_bounds__(DkvPlan<D>::kThreads, 1)
    fa_bwd_dkv_bf16(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                    const float* __restrict__ lse, const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, int Tq, int Tk, int H, int n_work, float scale, float scale_log2) {
  static_assert(D == 64 || D == 128, "the tile plan covers D in {64, 128}");
  using P = DkvPlan<D>;
  constexpr int kBlockM = P::kBlockM, kStages = P::kStages;
  extern __shared__ __align__(1024) unsigned char dkv_smem[];
  const uint32_t pad = (1024 - (smem_u32(dkv_smem) & 1023)) & 1023;
  const uint32_t base = smem_u32(dkv_smem) + pad;
  const uint32_t sK = base, sV = sK + P::kKVBytes, sQ = sV + P::kKVBytes, sdO = sQ + kStages * P::kStageBytes;
  // Stage s's statistics: kBlockM base-2 lse values, then kBlockM delta values.
  float* const stats = reinterpret_cast<float*>(dkv_smem + pad + P::kStatOffset);
  const uint32_t full_kv = base + P::kBarOffset, empty_kv = full_kv + 8;
  auto full_s = [&](int s) { return full_kv + 8 * (2 + s); };
  auto empty_s = [&](int s) { return full_kv + 8 * (2 + kStages + s); };

  // Work tile w: keys 128 * (w % n_blocks) .. + 127 of head (w / n_blocks) % H of batch
  // w / (n_blocks * H).
  const int n_blocks = (Tk + P::kBlockN - 1) / P::kBlockN;
  const int n_stages = (Tq + kBlockM - 1) / kBlockM;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    mbar_init(empty_kv, 4 * P::kConsumers);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_s(s), 1 + P::kStatThreads);  // the TMA thread's and the statistics threads' arrivals
      mbar_init(empty_s(s), 4 * P::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: thread 0 loads K and V once a work tile (as soon as the consumers have
    // issued their last S^T and dP^T of the previous one) and each stage's Q and dO;
    // warp 1 fills each stage's statistics. The stages run on across work tiles
    // (n_stages each).
    regs_dealloc<kProducerRegs>();
    const int warp = threadIdx.x / 32;
    if (threadIdx.x == 0) {
      int it = 0;  // stages loaded before this work tile
      for (int w = blockIdx.x, round = 0; w < n_work; w += gridDim.x, ++round, it += n_stages) {
        const int n0 = (w % n_blocks) * P::kBlockN, h = (w / n_blocks) % H, b = w / (n_blocks * H);
        mbar_wait(empty_kv, (round & 1) ^ 1);
        mbar_expect_tx(full_kv, 2 * P::kKVBytes);
        for (int p = 0; p < P::kPanels; ++p) {
          tma_load_4d(sK + p * P::kPanelKV, &tm_k, full_kv, 64 * p, n0, h, b);
          tma_load_4d(sV + p * P::kPanelKV, &tm_v, full_kv, 64 * p, n0, h, b);
        }
        for (int i = 0; i < n_stages; ++i) {
          const int st = (it + i) % kStages;
          mbar_wait(empty_s(st), (((it + i) / kStages) & 1) ^ 1);
          mbar_expect_tx(full_s(st), 2 * P::kStageBytes);
          for (int p = 0; p < P::kPanels; ++p) {
            tma_load_4d(sQ + st * P::kStageBytes + p * P::kPanelQ, &tm_q, full_s(st), 64 * p, i * kBlockM, h, b);
            tma_load_4d(sdO + st * P::kStageBytes + p * P::kPanelQ, &tm_do, full_s(st), 64 * p, i * kBlockM, h, b);
          }
        }
      }
    } else if (warp > 0) {
      int it = 0;
      for (int w = blockIdx.x; w < n_work; w += gridDim.x, it += n_stages) {
        const long long row_base = static_cast<long long>(w / n_blocks) * Tq;  // (b * H + h) * Tq
        const float *lse_rows = lse + row_base, *delta_rows = delta + row_base;
        for (int i = 0; i < n_stages; ++i) {
          const int st = (it + i) % kStages;
          mbar_wait(empty_s(st), (((it + i) / kStages) & 1) ^ 1);
          float* const st_stats = stats + st * 2 * kBlockM;
          for (int r = threadIdx.x - 32; r < kBlockM; r += P::kStatThreads) {
            const int row = i * kBlockM + r;
            st_stats[r] = row < Tq ? lse_rows[row] * kLog2e : INFINITY;
            st_stats[kBlockM + r] = row < Tq ? delta_rows[row] : 0.f;
          }
          mbar_arrive(full_s(st));
        }
      }
    }
  } else {
    regs_alloc<kConsumerRegs>();
    const int c = wg - 1;  // consumer: keys 64c .. 64c + 63 of each work tile
    const int tw = threadIdx.x % 128, warp = tw / 32, lane = tw % 32;
    const int g = lane >> 2, t = lane & 3;
    const uint32_t k_rows = sK + c * 64 * 128, v_rows = sV + c * 64 * 128;

    float dk_acc[D / 2], dv_acc[D / 2];  // dK and dV, 64 x D each
    float s[kBlockM / 2];                // S^T, then P^T, then dS^T, 64 x kBlockM
    float dp[kBlockM / 2];               // dP^T
    uint32_t pa[kBlockM / 16][4];        // P^T, then dS^T, in bf16 as A fragments
#pragma unroll
    for (int i = 0; i < kBlockM / 2; ++i) s[i] = dp[i] = 0.f;

    auto issue_sdp = [&](int st) {  // S^T = K Q^T, dP^T = V dO^T
      const uint32_t q_tile = sQ + st * P::kStageBytes, do_tile = sdO + st * P::kStageBytes;
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        Wgmma<kBlockM>::ss(s, sw128_desc(k_rows + (kk / 4) * P::kPanelKV + off, 16),
                           sw128_desc(q_tile + (kk / 4) * P::kPanelQ + off, 16), kk > 0);
        Wgmma<kBlockM>::ss(dp, sw128_desc(v_rows + (kk / 4) * P::kPanelKV + off, 16),
                           sw128_desc(do_tile + (kk / 4) * P::kPanelQ + off, 16), kk > 0);
      }
      wgmma_commit();
    };
    // acc += a * tile, with tile a stage's dO (dV += P^T dO) or Q (dK += dS^T Q).
    auto issue_acc = [&](float(&acc)[D / 2], uint32_t(&a)[kBlockM / 16][4], uint32_t tile) {
      fence_regs(acc);
      fence_regs(a);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockM / 16; ++kk) Wgmma<D>::rs(acc, a[kk], sw128_desc(tile + kk * 2048, P::kPanelQ), 1);
      wgmma_commit();
    };
    auto form_p = [&](int st) {  // s = P^T = exp2(S^T scale log2e - lse2[col])
      const float* l2 = stats + st * 2 * kBlockM + 2 * t;
#pragma unroll
      for (int j = 0; j < kBlockM / 8; ++j) {
        const float2 l = *reinterpret_cast<const float2*>(l2 + 8 * j);
        s[4 * j] = ex2(fmaf(s[4 * j], scale_log2, -l.x));
        s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], scale_log2, -l.y));
        s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], scale_log2, -l.x));
        s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], scale_log2, -l.y));
      }
    };
    auto form_ds = [&](int st, float(&ds)[kBlockM / 2]) {  // ds = dS^T = P^T (dP^T - delta[col]), P^T in s
      const float* dl = stats + st * 2 * kBlockM + kBlockM + 2 * t;
#pragma unroll
      for (int j = 0; j < kBlockM / 8; ++j) {
        const float2 d = *reinterpret_cast<const float2*>(dl + 8 * j);
        ds[4 * j] = s[4 * j] * (dp[4 * j] - d.x);
        ds[4 * j + 1] = s[4 * j + 1] * (dp[4 * j + 1] - d.y);
        ds[4 * j + 2] = s[4 * j + 2] * (dp[4 * j + 2] - d.x);
        ds[4 * j + 3] = s[4 * j + 3] * (dp[4 * j + 3] - d.y);
      }
    };
    auto release = [&](uint32_t empty) {
      if (lane == 0) mbar_arrive(empty);
    };

    int it = 0;
    for (int w = blockIdx.x, round = 0; w < n_work; w += gridDim.x, ++round, it += n_stages) {
      const int n0 = (w % n_blocks) * P::kBlockN, h = (w / n_blocks) % H, b = w / (n_blocks * H);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
      mbar_wait(full_kv, round & 1);

      // Stage 0's S^T and dP^T.
      mbar_wait(full_s(it % kStages), (it / kStages) & 1);
      issue_sdp(it % kStages);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      if (n_stages == 1) release(empty_kv);

      // Stage i: P^T, dV += P^T dO, dS^T, then the next stage's S^T and dP^T with this
      // stage's dK += dS^T Q. dK of stage i - 1, then dV of stage i, must finish before
      // each pack into the fragments.
      for (int i = 0; i < n_stages; ++i) {
        const int st = (it + i) % kStages;
        auto dk_done = [&]() {
          wgmma_wait<0>();
          fence_regs(dk_acc);
          fence_regs(pa);
          if (i > 0) release(empty_s((it + i - 1) % kStages));
        };
        if constexpr (P::kEarlyDs) {
          dk_done();
          form_p(st);
          form_ds(st, dp);
        } else {
          form_p(st);  // under dK of stage i - 1
          dk_done();
        }
        pack_fragments<kBlockM>(pa, s);
        issue_acc(dv_acc, pa, sdO + st * P::kStageBytes);
        if constexpr (!P::kEarlyDs) form_ds(st, s);  // under dV
        wgmma_wait<0>();
        fence_regs(dv_acc);
        fence_regs(pa);
        if constexpr (P::kEarlyDs)
          pack_fragments<kBlockM>(pa, dp);
        else
          pack_fragments<kBlockM>(pa, s);
        if (i + 1 < n_stages) {  // the next stage's S^T and dP^T with this stage's dK += dS^T Q
          const int sn = (it + i + 1) % kStages;
          if constexpr (P::kEarlyDs) {
#pragma unroll
            for (int e = 0; e < kBlockM / 2; ++e) s[e] = dp[e] = 0.f;  // a new value: the old ones die at the packs
          }
          mbar_wait(full_s(sn), ((it + i + 1) / kStages) & 1);
          issue_sdp(sn);
          issue_acc(dk_acc, pa, sQ + st * P::kStageBytes);
          wgmma_wait<1>();  // S^T and dP^T are done
          fence_regs(s);
          fence_regs(dp);
          if (i + 2 == n_stages) release(empty_kv);  // the tile's last S^T and dP^T are done
        } else {  // the last stage's dK += dS^T Q alone
          issue_acc(dk_acc, pa, sQ + st * P::kStageBytes);
        }
      }
      wgmma_wait<0>();
      fence_regs(dk_acc);
      fence_regs(dv_acc);
      release(empty_s((it + n_stages - 1) % kStages));
      const int key0 = n0 + c * 64 + warp * 16 + g;
      store_rows<D>(dk, dk_acc, scale, b, h, key0, Tk, H, t);
      store_rows<D>(dv, dv_acc, 1.f, b, h, key0, Tk, H, t);
    }
  }
}

// fp32 instances: kSplit threads a row (2 at D = 64, 4 at D = 128, so that a thread
// holds D / kSplit elements of each of its rows' vectors); thread part `hf` holds the
// head-dim elements d = kSplit * i + hf, so the parts of a row read neighbouring banks.
template <int D>
struct BwdF32Tiles {
  static constexpr int kRows = 64, kStream = 64;
  static constexpr int kSplit = D / 32;
  static constexpr int kThreads = kRows * kSplit;
  static constexpr int kSmem = 2 * kStream * D * 4 + 2 * kStream * 4;  // two tiles; sL, sD
};

template <int D>
__device__ __forceinline__ float dot_part(const float (&x)[D / BwdF32Tiles<D>::kSplit],
                                          const float* row, int hf) {
  constexpr int kSplit = BwdF32Tiles<D>::kSplit;
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < D / kSplit; ++i) s = fmaf(x[i], row[kSplit * i + hf], s);
#pragma unroll
  for (int lanes = 1; lanes < kSplit; lanes <<= 1) s += __shfl_xor_sync(0xffffffffu, s, lanes);
  return s;
}

// Stage rows [row0, row0 + ROWS) of a (batch, head) slice into a [ROWS][D] fp32 tile;
// rows past `rows_total` are zero.
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile_f32(float (*dst)[D], const float* base,
                                              long long stride_t, int row0, int rows_total,
                                              int tid) {
  for (int i = tid; i < ROWS * D / 4; i += THREADS) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    const int gr = row0 + r;
    *reinterpret_cast<float4*>(&dst[r][c]) =
        gr < rows_total ? *reinterpret_cast<const float4*>(base + gr * stride_t + c)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <int D>
__global__ void __launch_bounds__(BwdF32Tiles<D>::kThreads)
    fa_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  float* __restrict__ dq, int Tq, int Tk, int H, long long sqb, long long sqt,
                  long long sqh, long long skb, long long skt, long long skh, long long svb,
                  long long svt, long long svh, long long sdb, long long sdt, long long sdh,
                  float scale, float scale_log2) {
  using Tl = BwdF32Tiles<D>;
  constexpr int kSplit = Tl::kSplit, kPart = D / kSplit, kStream = Tl::kStream;
  float(*sK)[D] = reinterpret_cast<float(*)[D]>(block_smem<Tl::kSmem>());
  float(*sV)[D] = sK + kStream;
  const int tid = threadIdx.x, hf = tid % kSplit;
  const int h = blockIdx.y, b = blockIdx.z;
  const int row = blockIdx.x * Tl::kRows + tid / kSplit;
  const bool live = row < Tq;
  const float* qp = q + b * sqb + h * sqh + static_cast<long long>(live ? row : 0) * sqt;
  const float* dp_ = dout + b * sdb + h * sdh + static_cast<long long>(live ? row : 0) * sdt;
  const float* kbase = k + b * skb + h * skh;
  const float* vbase = v + b * svb + h * svh;
  const long long si = (static_cast<long long>(b) * H + h) * Tq + row;
  const float lse2 = live ? lse[si] * kLog2e : INFINITY;
  const float dlt = live ? delta[si] : 0.f;

  float qr[kPart], dor[kPart], acc[kPart];
#pragma unroll
  for (int i = 0; i < kPart; ++i) {
    qr[i] = live ? qp[kSplit * i + hf] : 0.f;
    dor[i] = live ? dp_[kSplit * i + hf] : 0.f;
    acc[i] = 0.f;
  }
  for (int kv0 = 0; kv0 < Tk; kv0 += kStream) {
    load_tile_f32<D, kStream, Tl::kThreads>(sK, kbase, skt, kv0, Tk, tid);
    load_tile_f32<D, kStream, Tl::kThreads>(sV, vbase, svt, kv0, Tk, tid);
    __syncthreads();
    const int n = min(kStream, Tk - kv0);
    for (int j = 0; j < n; ++j) {
      const float s = dot_part<D>(qr, sK[j], hf);
      const float dpj = dot_part<D>(dor, sV[j], hf);
      const float ds = ex2(fmaf(s, scale_log2, -lse2)) * (dpj - dlt);
#pragma unroll
      for (int i = 0; i < kPart; ++i) acc[i] = fmaf(ds, sK[j][kSplit * i + hf], acc[i]);
    }
    __syncthreads();
  }
  if (live) {
    float* op = dq + ((static_cast<long long>(b) * Tq + row) * H + h) * D;
#pragma unroll
    for (int i = 0; i < kPart; ++i) op[kSplit * i + hf] = acc[i] * scale;
  }
}

template <int D>
__global__ void __launch_bounds__(BwdF32Tiles<D>::kThreads)
    fa_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   float* __restrict__ dk, float* __restrict__ dv, int Tq, int Tk, int H,
                   long long sqb, long long sqt, long long sqh, long long skb, long long skt,
                   long long skh, long long svb, long long svt, long long svh, long long sdb,
                   long long sdt, long long sdh, float scale, float scale_log2) {
  using Tl = BwdF32Tiles<D>;
  constexpr int kSplit = Tl::kSplit, kPart = D / kSplit, kStream = Tl::kStream;
  float(*sQ)[D] = reinterpret_cast<float(*)[D]>(block_smem<Tl::kSmem>());
  float(*sdO)[D] = sQ + kStream;
  float* sL = reinterpret_cast<float*>(sdO + kStream);
  float* sD = sL + kStream;
  const int tid = threadIdx.x, hf = tid % kSplit;
  const int h = blockIdx.y, b = blockIdx.z;
  const int key = blockIdx.x * Tl::kRows + tid / kSplit;
  const bool live = key < Tk;
  const float* kp = k + b * skb + h * skh + static_cast<long long>(live ? key : 0) * skt;
  const float* vp = v + b * svb + h * svh + static_cast<long long>(live ? key : 0) * svt;
  const float* qbase = q + b * sqb + h * sqh;
  const float* dbase = dout + b * sdb + h * sdh;
  const long long stat0 = (static_cast<long long>(b) * H + h) * Tq;

  float kr[kPart], vr[kPart], dk_acc[kPart], dv_acc[kPart];
#pragma unroll
  for (int i = 0; i < kPart; ++i) {
    kr[i] = live ? kp[kSplit * i + hf] : 0.f;
    vr[i] = live ? vp[kSplit * i + hf] : 0.f;
    dk_acc[i] = dv_acc[i] = 0.f;
  }
  for (int m = 0; m < Tq; m += kStream) {
    load_tile_f32<D, kStream, Tl::kThreads>(sQ, qbase, sqt, m, Tq, tid);
    load_tile_f32<D, kStream, Tl::kThreads>(sdO, dbase, sdt, m, Tq, tid);
    if (tid < kStream) {
      const int row = m + tid;
      sL[tid] = row < Tq ? lse[stat0 + row] * kLog2e : INFINITY;
      sD[tid] = row < Tq ? delta[stat0 + row] : 0.f;
    }
    __syncthreads();
    const int n = min(kStream, Tq - m);
    for (int i = 0; i < n; ++i) {
      const float s = dot_part<D>(kr, sQ[i], hf);
      const float dpi = dot_part<D>(vr, sdO[i], hf);
      const float p = ex2(fmaf(s, scale_log2, -sL[i]));
      const float ds = p * (dpi - sD[i]);
#pragma unroll
      for (int c = 0; c < kPart; ++c) {
        dv_acc[c] = fmaf(p, sdO[i][kSplit * c + hf], dv_acc[c]);
        dk_acc[c] = fmaf(ds, sQ[i][kSplit * c + hf], dk_acc[c]);
      }
    }
    __syncthreads();
  }
  if (live) {
    const long long o = ((static_cast<long long>(b) * Tk + key) * H + h) * D;
#pragma unroll
    for (int c = 0; c < kPart; ++c) {
      dk[o + kSplit * c + hf] = dk_acc[c] * scale;
      dv[o + kSplit * c + hf] = dv_acc[c];
    }
  }
}

// ---- Host: launchers ----

// The bf16 launchers: the tensor maps of q, k, v and dO (11 values each, see encode_map),
// with boxes of the plan's rows, then a persistent grid of one block an SM.
struct BwdBf16Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  __nv_bfloat16 *o0, *o1;  // dq; or dk and dv
  const long long* maps;
  int B, Tq, Tk, H;
  float scale;
  cudaStream_t st;
};

template <int D>
int encode_bwd_maps(CUtensorMap (&tm)[4], const BwdBf16Args& a, int q_rows, int kv_rows) {
  int err = encode_map(&tm[0], a.q, a.maps, D, a.Tq, a.H, a.B, q_rows);
  if (!err) err = encode_map(&tm[1], a.k, a.maps + kMapLongs, D, a.Tk, a.H, a.B, kv_rows);
  if (!err) err = encode_map(&tm[2], a.v, a.maps + 2 * kMapLongs, D, a.Tk, a.H, a.B, kv_rows);
  if (!err) err = encode_map(&tm[3], a.dout, a.maps + 3 * kMapLongs, D, a.Tq, a.H, a.B, q_rows);
  return err;
}

template <int D>
int bwd_dq_bf16(const BwdBf16Args& a) {
  using P = DqPlan<D>;
  static_assert(P::kSmem > kStaticSmemLimit, "launch() sizes dynamic shared memory above 48 KB only");
  CUtensorMap tm[4];
  int n_work = 0, blocks = 0;
  int err = encode_bwd_maps<D>(tm, a, P::kBlockM, P::kBlockN);
  if (!err) err = persistent_grid(static_cast<long long>((a.Tq + P::kBlockM - 1) / P::kBlockM) * a.H * a.B, n_work, blocks);
  if (err) return err;
  static SmemOptIn opt_in;
  return launch(fa_bwd_dq_bf16<D>, opt_in, dim3(blocks), P::kThreads, P::kSmem, a.st, tm[0], tm[1], tm[2], tm[3],
                a.lse, a.delta, a.o0, a.Tq, a.Tk, a.H, n_work, a.scale, a.scale * kLog2e);
}

template <int D>
int bwd_dkv_bf16(const BwdBf16Args& a) {
  using P = DkvPlan<D>;
  static_assert(P::kSmem > kStaticSmemLimit, "launch() sizes dynamic shared memory above 48 KB only");
  CUtensorMap tm[4];
  int n_work = 0, blocks = 0;
  int err = encode_bwd_maps<D>(tm, a, P::kBlockM, P::kBlockN);
  if (!err) err = persistent_grid(static_cast<long long>((a.Tk + P::kBlockN - 1) / P::kBlockN) * a.H * a.B, n_work, blocks);
  if (err) return err;
  static SmemOptIn opt_in;
  return launch(fa_bwd_dkv_bf16<D>, opt_in, dim3(blocks), P::kThreads, P::kSmem, a.st, tm[0], tm[1], tm[2], tm[3],
                a.lse, a.delta, a.o0, a.o1, a.Tq, a.Tk, a.H, n_work, a.scale, a.scale * kLog2e);
}

// The fp32 launchers, a block for each 64 rows of each (batch, head); each instance raises
// its shared memory limit once per device. Strides in elements: batch, token and head of
// q, k, v and dO.
struct BwdF32Args {
  const float *q, *k, *v, *dout;
  const float *lse, *delta;
  float *o0, *o1;  // dq; or dk and dv
  int B, Tq, Tk, H;
  long long sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, sdb, sdt, sdh;
  float scale;
  cudaStream_t st;
};

#define FA_BWD_F32_ARGS                                                                                    \
  a.q, a.k, a.v, a.dout, a.lse, a.delta
#define FA_BWD_F32_STRIDES                                                                                 \
  a.Tq, a.Tk, a.H, a.sqb, a.sqt, a.sqh, a.skb, a.skt, a.skh, a.svb, a.svt, a.svh, a.sdb, a.sdt, a.sdh, a.scale, \
      a.scale * kLog2e

template <int D>
int bwd_dq_f32(const BwdF32Args& a) {
  using Tl = BwdF32Tiles<D>;
  static SmemOptIn opt_in;
  return launch(fa_bwd_dq_f32<D>, opt_in, dim3((a.Tq + Tl::kRows - 1) / Tl::kRows, a.H, a.B), Tl::kThreads,
                Tl::kSmem, a.st, FA_BWD_F32_ARGS, a.o0, FA_BWD_F32_STRIDES);
}

template <int D>
int bwd_dkv_f32(const BwdF32Args& a) {
  using Tl = BwdF32Tiles<D>;
  static SmemOptIn opt_in;
  return launch(fa_bwd_dkv_f32<D>, opt_in, dim3((a.Tk + Tl::kRows - 1) / Tl::kRows, a.H, a.B), Tl::kThreads,
                Tl::kSmem, a.st, FA_BWD_F32_ARGS, a.o0, a.o1, FA_BWD_F32_STRIDES);
}

#undef FA_BWD_F32_ARGS
#undef FA_BWD_F32_STRIDES

}  // namespace

// The bf16 backward. maps: the tensor maps' layout of q, k, v and dO, 11 values each
// (encode_map), with boxes of BWD_TILES' rows (ops/flash_attention.py); D: 64 or 128. lse
// and delta are contiguous fp32 (B, H, Tq); outputs are contiguous (B, T, H, D). Each
// returns cudaErrorInvalidValue for arguments no instance takes or a map the driver
// refuses, cudaErrorNotSupported if the driver has no cuTensorMapEncodeTiled, else the
// shared memory attribute call's error or cudaGetLastError() after its launch.
#define FA_BWD_BF16_ARGS \
  const long long *maps, int B, int Tq, int Tk, int H, int D, float scale, void *stream

extern "C" int flash_attention_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* dout,
                                           const float* lse, const float* delta, void* dq, FA_BWD_BF16_ARGS) {
  const BwdBf16Args a{q,    k, v,  dout, lse, delta, static_cast<__nv_bfloat16*>(dq), nullptr, maps,
                      B,    Tq, Tk, H,    scale, static_cast<cudaStream_t>(stream)};
  return by_head_dim(D, B, Tq, Tk, H, [&] { return bwd_dq_bf16<64>(a); }, [&] { return bwd_dq_bf16<128>(a); });
}

extern "C" int flash_attention_bwd_dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                                            const float* lse, const float* delta, void* dk, void* dv,
                                            FA_BWD_BF16_ARGS) {
  const BwdBf16Args a{q,  k,  v, dout, lse,   delta, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
                      maps, B, Tq, Tk,  H, scale, static_cast<cudaStream_t>(stream)};
  return by_head_dim(D, B, Tq, Tk, H, [&] { return bwd_dkv_bf16<64>(a); }, [&] { return bwd_dkv_bf16<128>(a); });
}

// The fp32 backward. q, k, v, dout strides are in elements (batch, token, head; the
// head-dim stride is 1). Returns as the bf16 entry points, without the maps.
#define FA_BWD_F32_ENTRY_ARGS                                                                                     \
  int B, int Tq, int Tk, int H, int D, long long sqb, long long sqt, long long sqh, long long skb, long long skt, \
      long long skh, long long svb, long long svt, long long svh, long long sdb, long long sdt, long long sdh,    \
      float scale, void *stream

extern "C" int flash_attention_bwd_dq_f32(const void* q, const void* k, const void* v, const void* dout,
                                          const float* lse, const float* delta, void* dq, FA_BWD_F32_ENTRY_ARGS) {
  const BwdF32Args a{static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
                     static_cast<const float*>(dout), lse, delta, static_cast<float*>(dq), nullptr, B, Tq, Tk, H,
                     sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, sdb, sdt, sdh, scale,
                     static_cast<cudaStream_t>(stream)};
  return by_head_dim(D, B, Tq, Tk, H, [&] { return bwd_dq_f32<64>(a); }, [&] { return bwd_dq_f32<128>(a); });
}

extern "C" int flash_attention_bwd_dkv_f32(const void* q, const void* k, const void* v, const void* dout,
                                           const float* lse, const float* delta, void* dk, void* dv,
                                           FA_BWD_F32_ENTRY_ARGS) {
  const BwdF32Args a{static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
                     static_cast<const float*>(dout), lse, delta, static_cast<float*>(dk), static_cast<float*>(dv),
                     B, Tq, Tk, H, sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, sdb, sdt, sdh, scale,
                     static_cast<cudaStream_t>(stream)};
  return by_head_dim(D, B, Tq, Tk, H, [&] { return bwd_dkv_f32<64>(a); }, [&] { return bwd_dkv_f32<128>(a); });
}

// Bytes of dynamic shared memory a block of the bf16 dq (kernel 0) or dk/dv (kernel 1)
// instance of head dim D takes (0 for another D): printed in the build line.
extern "C" int flash_attention_bwd_bf16_smem(int kernel, int D) {
  if (D == 64) return kernel == 0 ? DqPlan<64>::kSmem : DkvPlan<64>::kSmem;
  if (D == 128) return kernel == 0 ? DqPlan<128>::kSmem : DkvPlan<128>::kSmem;
  return 0;
}
