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
// fa_bwd_dq_bf16<D> / fa_bwd_dkv_bf16<D>, D = 64 and 128: the bf16 model's instances, in
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
// fa_bwd_dq_f32<D> / fa_bwd_dkv_f32<D>, D = 64 and 128, and fa_bwd_dq_f32_narrow<32> /
//   fa_bwd_dkv_f32_narrow<32>: the fp32 model's instances (compute_dtype="float32", the
//   model's default; D = 32 the RGB models' MAE decoder, trained in fp32 whatever the
//   model's dtype, _dq_aug_kernel (:227) and _dkv_aug_kernel (:262) on the TPU), in the same
//   design on the tensor cores. Single-pass bf16 or TF32 products would keep about 8 or 11
//   of fp32's 24 significand bits; instead each fp32 operand x is split into three bf16
//   parts, hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), which carry its 24
//   bits, and a product A B becomes six bf16 wgmma products (lo.hi, mid.mid, hi.lo, mid.hi,
//   hi.mid, hi.hi: only terms of order 2^-24 and below are dropped, and each bf16 x bf16
//   product is exact in fp32).
//   Bound on this card. Six bf16 passes of the backward's 10*B*H*T^2*D flop at 989
//   TFLOP/s: 60*B*H*T^2*D / 989e12 s, 4.1x less than the same work in fp32 FMA (67
//   TFLOP/s). (3xTF32 reaches the same ceiling, 3 passes at 495 TFLOP/s, but tf32 wgmma
//   reads shared-memory operands K-major only and takes 8 bytes an element.) The
//   exponentials (one a score in each kernel, 16 a clock per SM) bound D = 32 at a third of
//   the dq kernel's six passes.
//   Design. A split pass (fa_split_f32, one launch a backward) writes the parts of q, k,
//   v and dO, contiguous bf16 (3, B, T, H, D), no column padded, which both kernels read
//   through TMA maps over (D, T, H, 3B). dq and dk/dv are fa_bwd_dq_bf16 and fa_bwd_dkv_bf16
//   with every staged tile in three parts: S and dP (S^T and dP^T) accumulate six passes in
//   fp32, P and dS are formed in fp32 and split into three sets of A fragments in
//   registers. Each key tile's (query stage's) dQ, dK or dV product goes into a fresh
//   accumulator that is then added to the running sum in fp32 registers, so that the
//   tensor cores' accumulation rounds within one tile's wgmma only, not across every key
//   (query row). Three tiles a staged operand take 3x the bf16 plan's shared memory (192 KB
//   of the 227 KB a block at D = 64 and 128), and the fragments 3x its registers: dq takes
//   64-key tiles (D = 64) or one consumer of 64 query rows and 32-key tiles (D = 128);
//   dk/dv 32-row query stages, and one consumer of 64 keys at D = 128 with dV's running
//   sum in shared memory. Plans: DqF32Plan and DkvF32Plan below.
//   At D = 32 every product runs at the true width (fa_bwd_{dq,dkv}_f32_narrow, plans
//   DqF32NarrowPlan and DkvF32NarrowPlan): TMA stages the 32-column parts in 16-column
//   panels of 32-byte rows (boxes 16 columns wide, the 32-byte swizzle), as the narrow
//   forward (fa_fwd_f32_narrow) stages its own; S and dP (S^T and dP^T) take D / 16 = 2
//   k-steps a pass, and dQ = dS K, dV = P^T dO and dK = dS^T Q three products a 16-key
//   (16-row) step over whole parts: the hi fragments at N = 3D against [hi mid lo], mid at
//   2D, lo at D (the six passes, no column padded; a D = 64 plan over parts padded to 64
//   columns ran 2x the products and stored 2x the split's bytes). delta (computed outside,
//   from o and dO) is each D's own.
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
  static_assert(D == 64 || D == 128, "the bf16 dq plans: D = 64 and 128");
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
  static_assert(D == 64 || D == 128, "the bf16 dk/dv plans: D = 64 and 128");
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

// ---- fp32 instances: each product as six bf16 products of split operands ----

// The split pass of the fp32 forward and backward: q, k, v and, for the backward, dO
// (blockIdx.y picks one), fp32 (B, T, H, D) in any batch, token and head strides with a
// unit head-dim stride, into contiguous bf16 parts (3, B, T, H, D): hi, mid, lo (split3), no
// column padded. Each thread splits 8 columns a step (two 16-byte loads, three 16-byte
// stores).
struct SplitArgs {
  const float* x[4];
  __nv_bfloat16* parts[4];
  long long stride[4][3];  // batch, token, head, in elements
  int T[4];
  int B, H, D;
};

constexpr int kSplitThreads = 256;

__global__ void __launch_bounds__(kSplitThreads) fa_split_f32(const __grid_constant__ SplitArgs a) {
  const int which = blockIdx.y;
  const int T = a.T[which], H = a.H, chunks = a.D / 8;
  const long long n = static_cast<long long>(a.B) * T * H * chunks;
  const long long part = 8 * n;  // elements of one part
  const float* const x = a.x[which];
  __nv_bfloat16* const out = a.parts[which];
  const long long sb = a.stride[which][0], st = a.stride[which][1], sh = a.stride[which][2];
  for (long long i = static_cast<long long>(blockIdx.x) * kSplitThreads + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * kSplitThreads) {
    const int c = static_cast<int>(i % chunks);
    long long r = i / chunks;
    const int h = static_cast<int>(r % H);
    r /= H;
    const int t = static_cast<int>(r % T);
    const long long b = r / T;
    const float* src = x + b * sb + t * st + h * sh + 8 * c;
    const float4 u = *reinterpret_cast<const float4*>(src), w = *reinterpret_cast<const float4*>(src + 4);
    uint4 hi, mid, lo;
    split3(u.x, u.y, hi.x, mid.x, lo.x);
    split3(u.z, u.w, hi.y, mid.y, lo.y);
    split3(w.x, w.y, hi.z, mid.z, lo.z);
    split3(w.z, w.w, hi.w, mid.w, lo.w);
    // Element 8i of a contiguous (B, T, H, D) part is row (b, t, h), column 8c.
    *reinterpret_cast<uint4*>(out + 8 * i) = hi;
    *reinterpret_cast<uint4*>(out + part + 8 * i) = mid;
    *reinterpret_cast<uint4*>(out + 2 * part + 8 * i) = lo;
  }
}

// Tile plans of the fp32 instances at D = 64 and 128 (ops/flash_attention.py's
// BWD_F32_TILES mirrors them; D = 32 has plans of its own, DqF32NarrowPlan and
// DkvF32NarrowPlan below). Each staged operand is three bf16 tiles (hi, mid, lo), 3x the
// bf16 plan's bytes, so the tiles are smaller. The dQ, dK and dV products of each key tile
// (query stage) go into a fresh accumulator, `tile`, which is then added to the running sum
// in fp32 registers: the tensor cores' accumulation is not IEEE round-to-nearest, and one
// sum over every key (query) would accumulate their rounding thousands of times (PERF.md,
// section 6). dq: D = 64, two consumers of 64 query rows and 64-key tiles in two stages (Q,
// dO and the K/V rings take 192 KB); a consumer holds S, dP (32 floats each), dQ and its
// tile (32 each) and the three fragment sets of dS (48). D = 128: 64 query rows (one
// consumer) and 32-key tiles, for the same 192 KB.
template <int D>
struct DqF32Plan {
  static_assert(D == 64 || D == 128, "the fp32 dq plans: D = 64 and 128 (D = 32: DqF32NarrowPlan)");
  static constexpr int kBlockM = D == 64 ? 128 : 64;  // query rows a work tile
  static constexpr int kBlockN = D == 64 ? 64 : 32;   // keys a K or V tile
  static constexpr int kStages = 2;
  static constexpr int kConsumers = kBlockM / 64;
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kPanels = D / 64;
  static constexpr int kPanelQ = kBlockM * 128;  // bytes of one panel of one part of the Q (or dO) tile
  static constexpr int kPanelKV = kBlockN * 128;  // of a K or V tile
  static constexpr int kQPart = kPanels * kPanelQ;
  static constexpr int kKVPart = kPanels * kPanelKV;
  static constexpr int kQBytes = 3 * kQPart;
  static constexpr int kTileBytes = 3 * kKVPart;
  static constexpr int kBarriers = 2 + 4 * kStages;
  static constexpr int kBarOffset = 2 * kQBytes + 2 * kStages * kTileBytes;
  static constexpr int kSmem = kBarOffset + 8 * kBarriers + 1024;
  static constexpr bool kReloadBases = D == 128;  // reloaded_zero on Q's and dO's bases (1.04x the time)
};

// dk/dv: D = 64, two consumers of 64 keys and query stages of 64 rows in two stages; a
// consumer holds dK, dV and the tile (32 floats each), S^T, dP^T (32 each) and three
// fragment sets (48). (Stages of 32 and 48 rows took 1.11x and 1.04x as long.) D = 128:
// 64 keys (one consumer), 32-row stages in two stages, and dV's running sum in shared
// memory (dK, dV and the tile would take 192 registers).
template <int D>
struct DkvF32Plan {
  static_assert(D == 64 || D == 128, "the fp32 dk/dv plans: D = 64 and 128 (D = 32: DkvF32NarrowPlan)");
  static constexpr int kBlockN = D == 64 ? 128 : 64;  // keys a work tile
  static constexpr int kBlockM = D == 64 ? 64 : 32;   // query rows a stage
  static constexpr int kStatThreads = 96;
  static constexpr int kStages = 2;
  static constexpr bool kSmemDv = D == 128;
  static constexpr int kConsumers = kBlockN / 64;
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kPanels = D / 64;
  static constexpr int kPanelKV = kBlockN * 128;
  static constexpr int kPanelQ = kBlockM * 128;
  static constexpr int kKVPart = kPanels * kPanelKV;
  static constexpr int kQPart = kPanels * kPanelQ;
  static constexpr int kKVBytes = 3 * kKVPart;
  static constexpr int kStageBytes = 3 * kQPart;
  static constexpr int kStatOffset = 2 * kKVBytes + 2 * kStages * kStageBytes;
  static constexpr int kDvOffset = kStatOffset + kStages * 2 * kBlockM * 4;
  static constexpr int kBarOffset = kDvOffset + (kSmemDv ? kConsumers * 64 * D * 4 : 0);
  static constexpr int kBarriers = 2 + 2 * kStages;
  static constexpr int kSmem = kBarOffset + 8 * kBarriers + 1024;
  static constexpr bool kReloadBases = D == 128;  // reloaded_zero on K's and V's bases
  // S^T's and dP^T's passes unrolled two at a time at D = 64: all six spilled 16 bytes
  // there (0.97x the time); at D = 128 fewer than six took 2x the time.
  static constexpr int kPassUnroll = D == 64 ? 2 : kPasses;
};

// dQ for work tiles of kBlockM query rows of one (batch, head), from the split parts of
// q, k, v and dO: four tensor maps over (D, T, H, 3B), part p of batch b at p * B + b.
template <int D>
__global__ void __launch_bounds__(DqF32Plan<D>::kThreads, 1)
    fa_bwd_dq_f32(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                  const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dq, int B,
                  int Tq, int Tk, int H, int n_work, float scale, float scale_log2) {
  using P = DqF32Plan<D>;
  constexpr int kBlockN = P::kBlockN, kStages = P::kStages, kF = kBlockN / 16;
  constexpr bool kPingPong = P::kConsumers == 2;
  extern __shared__ __align__(1024) unsigned char dq_smem[];
  __shared__ uint32_t zero;
  const uint32_t base = (smem_u32(dq_smem) + 1023) & ~1023u;
  const uint32_t sQ = base, sdO = sQ + P::kQBytes, sK = sdO + P::kQBytes, sV = sK + kStages * P::kTileBytes;
  const uint32_t full_q = base + P::kBarOffset, empty_q = full_q + 8;
  auto full_k = [&](int s) { return full_q + 8 * (2 + s); };
  auto empty_k = [&](int s) { return full_q + 8 * (2 + kStages + s); };
  auto full_v = [&](int s) { return full_q + 8 * (2 + 2 * kStages + s); };
  auto empty_v = [&](int s) { return full_q + 8 * (2 + 3 * kStages + s); };

  const int m_blocks = (Tq + P::kBlockM - 1) / P::kBlockM;
  const int n_tiles = (Tk + kBlockN - 1) / kBlockN;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    zero = 0;
    mbar_init(full_q, 1);
    mbar_init(empty_q, 4 * P::kConsumers);
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
    // Producer, as in fa_bwd_dq_bf16; each tile is its three parts.
    if constexpr (kPingPong) regs_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      auto load = [&](const CUtensorMap* map, uint32_t ring, uint32_t full, uint32_t empty, int i, int j, int h,
                      int b) {
        mbar_wait(empty, ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full, P::kTileBytes);
        for (int part = 0; part < 3; ++part)
          for (int p = 0; p < P::kPanels; ++p)
            tma_load_4d(ring + part * P::kKVPart + p * P::kPanelKV, map, full, 64 * p, j * kBlockN, h, part * B + b);
      };
      int it = 0;
      for (int w = blockIdx.x, round = 0; w < n_work; w += gridDim.x, ++round, it += n_tiles) {
        const int m0 = (w % m_blocks) * P::kBlockM, h = (w / m_blocks) % H, b = w / (m_blocks * H);
        mbar_wait(empty_q, (round & 1) ^ 1);
        mbar_expect_tx(full_q, 2 * P::kQBytes);
        for (int part = 0; part < 3; ++part)
          for (int p = 0; p < P::kPanels; ++p) {
            const uint32_t off = part * P::kQPart + p * P::kPanelQ;
            tma_load_4d(sQ + off, &tm_q, full_q, 64 * p, m0, h, part * B + b);
            tma_load_4d(sdO + off, &tm_do, full_q, 64 * p, m0, h, part * B + b);
          }
        for (int j = 0; j < n_tiles; ++j) {
          const int s = (it + j) % kStages;
          load(&tm_k, sK + s * P::kTileBytes, full_k(s), empty_k(s), it + j, j, h, b);
          load(&tm_v, sV + s * P::kTileBytes, full_v(s), empty_v(s), it + j, j, h, b);
        }
      }
    }
  } else {
    if constexpr (kPingPong) regs_alloc<kConsumerRegs>();
    const int c = wg - 1;
    const int tw = threadIdx.x % 128, warp = tw / 32, lane = tw % 32;
    const int g = lane >> 2, t = lane & 3;
    const uint32_t q_rows = sQ + c * 64 * 128, do_rows = sdO + c * 64 * 128;

    float acc[D / 2];           // dQ, 64 x D
    float tile[D / 2];          // one key tile's dS K
    float s[kBlockN / 2];       // S, then dS
    float dp[kBlockN / 2];      // dP
    uint32_t pa[3 * kF][4];     // dS split: hi, mid and lo A fragments of dS K
    float lse2[2], dlt[2];
#pragma unroll
    for (int i = 0; i < kBlockN / 2; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) tile[i] = 0.f;

    auto issue_sdp = [&](int stage) {  // S = Q K^T, dP = dO V^T, six passes each
      const uint32_t z = P::kReloadBases ? reloaded_zero(&zero) : 0;
      const uint64_t qd = sw128_desc(q_rows + z, 16), dod = sw128_desc(do_rows + z, 16);
      const uint64_t kd = sw128_desc(sK + stage * P::kTileBytes, 16), vd = sw128_desc(sV + stage * P::kTileBytes, 16);
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int pass = 0; pass < kPasses; ++pass)
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t a = pass_a(pass) * P::kQPart + (kk / 4) * P::kPanelQ + (kk % 4) * 32;
          const uint32_t bo = pass_b(pass) * P::kKVPart + (kk / 4) * P::kPanelKV + (kk % 4) * 32;
          const int accumulate = pass > 0 || kk > 0;
          Wgmma<kBlockN>::ss(s, desc_at(qd, a), desc_at(kd, bo), accumulate);
          Wgmma<kBlockN>::ss(dp, desc_at(dod, a), desc_at(vd, bo), accumulate);
        }
      wgmma_commit();
    };
    auto issue_dq = [&](int stage) {  // tile = dS K, six passes
      const uint64_t kd = sw128_desc(sK + stage * P::kTileBytes, P::kPanelKV);
      fence_regs(tile);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int pass = 0; pass < kPasses; ++pass)
#pragma unroll
        for (int kk = 0; kk < kF; ++kk)
          Wgmma<D>::rs(tile, pa[pass_a(pass) * kF + kk], desc_at(kd, pass_b(pass) * P::kKVPart + kk * 2048),
                       pass > 0 || kk > 0);
      wgmma_commit();
    };
    auto form_ds = [&](int kv0) {  // s = dS = P (dP - delta), P = exp2(S scale log2e - lse2)
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
    auto add_tile = [&]() {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] += tile[i];
    };
    auto release = [&](uint32_t empty) {
      if (lane == 0) mbar_arrive(empty);
    };
    // Two consumers take turns to issue (ping-pong, as in fa_bwd_dq_bf16).
    auto turn_begin = [&]() {
      if constexpr (kPingPong) named_sync(kSchedBarrier + c, 256);
    };
    auto turn_end = [&](bool pass_on) {
      if constexpr (kPingPong) {
        if (pass_on) named_arrive(kSchedBarrier + (c ^ 1), 256);
      }
    };

    if (kPingPong && c == 0) named_arrive(kSchedBarrier, 256);
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

      const int s0 = it % kStages;
      mbar_wait(full_k(s0), (it / kStages) & 1);
      mbar_wait(full_v(s0), (it / kStages) & 1);
      turn_begin();
      issue_sdp(s0);
      turn_end(true);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      release(empty_v(s0));
      if (n_tiles == 1) release(empty_q);
      form_ds(0);
      split_fragments<kBlockN>(pa, s);

      for (int j = 1; j < n_tiles; ++j) {
        const int sj = (it + j) % kStages, sp = (it + j - 1) % kStages;
        mbar_wait(full_k(sj), ((it + j) / kStages) & 1);
        mbar_wait(full_v(sj), ((it + j) / kStages) & 1);
        turn_begin();
        issue_sdp(sj);
        issue_dq(sp);
        turn_end(true);
        wgmma_wait<1>();
        fence_regs(s);
        fence_regs(dp);
        release(empty_v(sj));
        if (j == n_tiles - 1) release(empty_q);
        form_ds(j * kBlockN);
        wgmma_wait<0>();
        fence_regs(tile);
        fence_regs(pa);
        release(empty_k(sp));
        add_tile();
        split_fragments<kBlockN>(pa, s);
      }

      const int sl = (it + n_tiles - 1) % kStages;
      turn_begin();
      issue_dq(sl);
      turn_end(c == 0 || w + static_cast<int>(gridDim.x) < n_work);
      wgmma_wait<0>();
      fence_regs(tile);
      release(empty_k(sl));
      add_tile();
      store_rows_f32<D>(dq, [&](int i) { return acc[i]; }, scale, b, h, row0, Tq, H, t);
    }
  }
}

// dK and dV for work tiles of kBlockN keys of one (batch, head), from the split parts.
template <int D>
__global__ void __launch_bounds__(DkvF32Plan<D>::kThreads, 1)
    fa_bwd_dkv_f32(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                   const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dk,
                   float* __restrict__ dv, int B, int Tq, int Tk, int H, int n_work, float scale, float scale_log2) {
  using P = DkvF32Plan<D>;
  constexpr int kBlockM = P::kBlockM, kStages = P::kStages, kF = kBlockM / 16;
  constexpr bool kTwoConsumers = P::kConsumers == 2;
  extern __shared__ __align__(1024) unsigned char dkv_smem[];
  __shared__ uint32_t zero;
  const uint32_t pad = (1024 - (smem_u32(dkv_smem) & 1023)) & 1023;
  const uint32_t base = smem_u32(dkv_smem) + pad;
  const uint32_t sK = base, sV = sK + P::kKVBytes, sQ = sV + P::kKVBytes, sdO = sQ + kStages * P::kStageBytes;
  float* const stats = reinterpret_cast<float*>(dkv_smem + pad + P::kStatOffset);
  const uint32_t full_kv = base + P::kBarOffset, empty_kv = full_kv + 8;
  auto full_s = [&](int s) { return full_kv + 8 * (2 + s); };
  auto empty_s = [&](int s) { return full_kv + 8 * (2 + kStages + s); };

  const int n_blocks = (Tk + P::kBlockN - 1) / P::kBlockN;
  const int n_stages = (Tq + kBlockM - 1) / kBlockM;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    zero = 0;
    mbar_init(full_kv, 1);
    mbar_init(empty_kv, 4 * P::kConsumers);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_s(s), 1 + P::kStatThreads);
      mbar_init(empty_s(s), 4 * P::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // Producer, as in fa_bwd_dkv_bf16; each tile is its three parts.
    if constexpr (kTwoConsumers) regs_dealloc<kProducerRegs>();
    const int warp = threadIdx.x / 32;
    if (threadIdx.x == 0) {
      int it = 0;
      for (int w = blockIdx.x, round = 0; w < n_work; w += gridDim.x, ++round, it += n_stages) {
        const int n0 = (w % n_blocks) * P::kBlockN, h = (w / n_blocks) % H, b = w / (n_blocks * H);
        mbar_wait(empty_kv, (round & 1) ^ 1);
        mbar_expect_tx(full_kv, 2 * P::kKVBytes);
        for (int part = 0; part < 3; ++part)
          for (int p = 0; p < P::kPanels; ++p) {
            const uint32_t off = part * P::kKVPart + p * P::kPanelKV;
            tma_load_4d(sK + off, &tm_k, full_kv, 64 * p, n0, h, part * B + b);
            tma_load_4d(sV + off, &tm_v, full_kv, 64 * p, n0, h, part * B + b);
          }
        for (int i = 0; i < n_stages; ++i) {
          const int st = (it + i) % kStages;
          mbar_wait(empty_s(st), (((it + i) / kStages) & 1) ^ 1);
          mbar_expect_tx(full_s(st), 2 * P::kStageBytes);
          for (int part = 0; part < 3; ++part)
            for (int p = 0; p < P::kPanels; ++p) {
              const uint32_t off = st * P::kStageBytes + part * P::kQPart + p * P::kPanelQ;
              tma_load_4d(sQ + off, &tm_q, full_s(st), 64 * p, i * kBlockM, h, part * B + b);
              tma_load_4d(sdO + off, &tm_do, full_s(st), 64 * p, i * kBlockM, h, part * B + b);
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
    if constexpr (kTwoConsumers) regs_alloc<kConsumerRegs>();
    const int c = wg - 1;  // consumer: keys 64c .. 64c + 63 of each work tile
    const int tw = threadIdx.x % 128, warp = tw / 32, lane = tw % 32;
    const int g = lane >> 2, t = lane & 3;
    const uint32_t k_rows = sK + c * 64 * 128, v_rows = sV + c * 64 * 128;
    // dV's running sum in shared memory where the plan says so: element i of thread tw at
    // [i][tw], so a warp's accesses fall on 32 banks.
    float* const dv_smem = reinterpret_cast<float*>(dkv_smem + pad + P::kDvOffset) + c * 64 * D;

    float dk_acc[D / 2], dv_acc[P::kSmemDv ? 1 : D / 2];  // dK; dV unless kSmemDv
    float tile[D / 2];                   // one stage's P^T dO or dS^T Q
    float s[kBlockM / 2];                // S^T, then P^T
    float dp[kBlockM / 2];               // dP^T, then dS^T
    uint32_t pa[3 * kF][4];              // P^T, then dS^T, split into A fragments
#pragma unroll
    for (int i = 0; i < kBlockM / 2; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) tile[i] = 0.f;

    auto issue_sdp = [&](int st) {  // S^T = K Q^T, dP^T = V dO^T, six passes each
      const uint32_t z = P::kReloadBases ? reloaded_zero(&zero) : 0;
      const uint64_t kd = sw128_desc(k_rows + z, 16), vd = sw128_desc(v_rows + z, 16);
      const uint64_t qd = sw128_desc(sQ + st * P::kStageBytes, 16), dod = sw128_desc(sdO + st * P::kStageBytes, 16);
#pragma unroll
      for (int i = 0; i < kBlockM / 2; ++i) s[i] = dp[i] = 0.f;  // a new value: the old ones died at the split
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll (P::kPassUnroll)
      for (int pass = 0; pass < kPasses; ++pass)
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t col = (kk % 4) * 32;
          const uint32_t a = pass_a(pass) * P::kKVPart + (kk / 4) * P::kPanelKV + col;
          const uint32_t bo = pass_b(pass) * P::kQPart + (kk / 4) * P::kPanelQ + col;
          const int accumulate = pass > 0 || kk > 0;
          Wgmma<kBlockM>::ss(s, desc_at(kd, a), desc_at(qd, bo), accumulate);
          Wgmma<kBlockM>::ss(dp, desc_at(vd, a), desc_at(dod, bo), accumulate);
        }
      wgmma_commit();
    };
    // tile = a * stage tile, with the stage's dO (P^T dO) or Q (dS^T Q), six passes.
    auto issue_acc = [&](uint32_t stage_tile) {
      const uint64_t td = sw128_desc(stage_tile, P::kPanelQ);
      fence_regs(tile);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int pass = 0; pass < kPasses; ++pass)
#pragma unroll
        for (int kk = 0; kk < kF; ++kk)
          Wgmma<D>::rs(tile, pa[pass_a(pass) * kF + kk], desc_at(td, pass_b(pass) * P::kQPart + kk * 2048),
                       pass > 0 || kk > 0);
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
    auto form_ds = [&](int st) {  // dp = dS^T = P^T (dP^T - delta[col]), P^T in s
      const float* dl = stats + st * 2 * kBlockM + kBlockM + 2 * t;
#pragma unroll
      for (int j = 0; j < kBlockM / 8; ++j) {
        const float2 d = *reinterpret_cast<const float2*>(dl + 8 * j);
        dp[4 * j] = s[4 * j] * (dp[4 * j] - d.x);
        dp[4 * j + 1] = s[4 * j + 1] * (dp[4 * j + 1] - d.y);
        dp[4 * j + 2] = s[4 * j + 2] * (dp[4 * j + 2] - d.x);
        dp[4 * j + 3] = s[4 * j + 3] * (dp[4 * j + 3] - d.y);
      }
    };
    auto add_dk = [&]() {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dk_acc[i] += tile[i];
    };
    auto add_dv = [&]() {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) {
        if constexpr (P::kSmemDv)
          dv_smem[i * 128 + tw] += tile[i];
        else
          dv_acc[i] += tile[i];
      }
    };
    auto release = [&](uint32_t empty) {
      if (lane == 0) mbar_arrive(empty);
    };

    int it = 0;
    for (int w = blockIdx.x, round = 0; w < n_work; w += gridDim.x, ++round, it += n_stages) {
      const int n0 = (w % n_blocks) * P::kBlockN, h = (w / n_blocks) % H, b = w / (n_blocks * H);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) {
        dk_acc[i] = 0.f;
        if constexpr (P::kSmemDv)
          dv_smem[i * 128 + tw] = 0.f;
        else
          dv_acc[i] = 0.f;
      }
      mbar_wait(full_kv, round & 1);

      // Stage 0's S^T and dP^T.
      mbar_wait(full_s(it % kStages), (it / kStages) & 1);
      issue_sdp(it % kStages);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      if (n_stages == 1) release(empty_kv);

      // Stage i: P^T (under dK of stage i - 1), tile = P^T dO and dS^T under it, dV +=
      // tile; then the next stage's S^T and dP^T with tile = dS^T Q.
      for (int i = 0; i < n_stages; ++i) {
        const int st = (it + i) % kStages;
        form_p(st);
        wgmma_wait<0>();
        fence_regs(tile);
        fence_regs(pa);
        if (i > 0) {
          release(empty_s((it + i - 1) % kStages));
          add_dk();
        }
        split_fragments<kBlockM>(pa, s);
        issue_acc(sdO + st * P::kStageBytes);
        form_ds(st);
        wgmma_wait<0>();
        fence_regs(tile);
        fence_regs(pa);
        add_dv();
        split_fragments<kBlockM>(pa, dp);
        if (i + 1 < n_stages) {
          const int sn = (it + i + 1) % kStages;
          mbar_wait(full_s(sn), ((it + i + 1) / kStages) & 1);
          issue_sdp(sn);
          issue_acc(sQ + st * P::kStageBytes);
          wgmma_wait<1>();  // S^T and dP^T are done
          fence_regs(s);
          fence_regs(dp);
          if (i + 2 == n_stages) release(empty_kv);
        } else {
          issue_acc(sQ + st * P::kStageBytes);
        }
      }
      wgmma_wait<0>();
      fence_regs(tile);
      release(empty_s((it + n_stages - 1) % kStages));
      add_dk();
      const int key0 = n0 + c * 64 + warp * 16 + g;
      store_rows_f32<D>(dk, [&](int i) { return dk_acc[i]; }, scale, b, h, key0, Tk, H, t);
      if constexpr (P::kSmemDv)
        store_rows_f32<D>(dv, [&](int i) { return dv_smem[i * 128 + tw]; }, 1.f, b, h, key0, Tk, H, t);
      else
        store_rows_f32<D>(dv, [&](int i) { return dv_acc[i]; }, 1.f, b, h, key0, Tk, H, t);
    }
  }
}

// ---- The fp32 backward at D = 32: every product at the true width ----

// Tile plans of fa_bwd_dq_f32_narrow and fa_bwd_dkv_f32_narrow (ops/flash_attention.py's
// BWD_F32_TILES[32] mirrors them; the launchers refuse maps of another box). The split pass
// writes the D = 32 parts 32 columns wide, and TMA stages them as fa_fwd_f32_narrow's
// producer does: 16-column panels of 32-byte rows (boxes 16 columns wide in the 32-byte
// swizzle of sw32_desc), D / 16 panels a part, the parts one after another, so that the
// panels of [hi mid lo] are equally spaced. S and dP (S^T and dP^T) take D / 16 k-steps a
// pass; dQ = dS K, dV = P^T dO and dK = dS^T Q take three products a 16-key (16-row) step
// over whole parts (tile_products). A consumer thread holds S and dP (kBlockN / 2 or kBlockM
// / 2 floats each), the three fragment sets (3 kBlockN / 4 or 3 kBlockM / 4), a key tile's
// (stage's) product in three column blocks (3 D / 2) and its running sums (D / 2 each): 176
// floats in dq, 192 in dk/dv, none spilled under setmaxnreg's 240. dq: two consumers of 64
// query rows issuing freely, 64-key tiles; dk/dv: two consumers of 64 keys, 64-row query
// stages; both rings four stages deep, 145 and 147 KB of shared memory. Chosen by same-call
// A/Bs at the MAE decoder's 4 x 1369 x 16 x 32 on an NVIDIA H100 80GB HBM3 at 700.00 W
// (PERF.md, section 6): with two stages dq took 1.57x and dk/dv 1.24x as long, with three
// 1.00x and 1.03x; consumers taking turns (fa_bwd_dq_f32<64>'s ping-pong) 1.01x; six passes
// at N = D instead of the merged three, the same time (and then 96-key tiles, the same;
// 96-row stages spilled); 32-key tiles and 32-row stages in six stages, 1.17x.
template <int D>
struct DqF32NarrowPlan {
  static_assert(D == 32, "the true-width fp32 dq plan: D = 32");
  static constexpr int kBlockM = 128;  // query rows a work tile, 64 a consumer
  static constexpr int kBlockN = 64;   // keys a K or V tile
  static constexpr int kStages = 4;
  static constexpr int kConsumers = kBlockM / 64;
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kPanels = D / 16;         // 16-column panels a part
  static constexpr int kPanelQ = kBlockM * 32;   // bytes of one panel of one part of the Q (or dO) tile
  static constexpr int kPanelKV = kBlockN * 32;  // of a K or V tile
  static constexpr int kQPart = kPanels * kPanelQ;
  static constexpr int kKVPart = kPanels * kPanelKV;
  static constexpr int kQBytes = 3 * kQPart;
  static constexpr int kTileBytes = 3 * kKVPart;
  static constexpr int kBarriers = 2 + 4 * kStages;
  static constexpr int kBarOffset = 2 * kQBytes + 2 * kStages * kTileBytes;
  static constexpr int kSmem = kBarOffset + 8 * kBarriers + 1024;
};

template <int D>
struct DkvF32NarrowPlan {
  static_assert(D == 32, "the true-width fp32 dk/dv plan: D = 32");
  static constexpr int kBlockN = 128;  // keys a work tile, 64 a consumer
  static constexpr int kBlockM = 64;   // query rows a stage
  static constexpr int kStatThreads = 96;
  static constexpr int kStages = 4;
  static constexpr int kConsumers = kBlockN / 64;
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kPanels = D / 16;
  static constexpr int kPanelKV = kBlockN * 32;  // bytes of one panel of one part of the K (or V) tile
  static constexpr int kPanelQ = kBlockM * 32;   // of a stage's Q (or dO) tile
  static constexpr int kKVPart = kPanels * kPanelKV;
  static constexpr int kQPart = kPanels * kPanelQ;
  static constexpr int kKVBytes = 3 * kKVPart;
  static constexpr int kStageBytes = 3 * kQPart;
  static constexpr int kStatOffset = 2 * kKVBytes + 2 * kStages * kStageBytes;
  static constexpr int kBarOffset = kStatOffset + kStages * 2 * kBlockM * 4;
  static constexpr int kBarriers = 2 + 2 * kStages;
  static constexpr int kSmem = kBarOffset + 8 * kBarriers + 1024;
};

// tile = A B, B a staged tile of 16-column panels (kPanel bytes each, the parts one after
// another) over kF k-steps of 16 rows, A's three fragment sets in pa (hi, mid, lo): the six
// products of the split as three a step, A_hi [B_hi B_mid B_lo] at N = 3D, A_mid [B_hi
// B_mid] at 2D into tile's first 2D columns, A_lo B_hi at D into its first D (as
// fa_fwd_f32_narrow's P V). Column blocks: hi.hi + mid.hi + lo.hi, hi.mid + mid.mid, hi.lo;
// tile_sum adds them, the small ones first.
template <int D, int kF, int kPanel>
__device__ __forceinline__ void tile_products(float (&tile)[3 * D / 2], uint32_t (&pa)[3 * kF][4],
                                              uint32_t tile_base) {
  const uint64_t bd = sw32_desc(tile_base, kPanel);
  fence_regs(tile);
  fence_regs(pa);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kF; ++kk) {  // 16 rows a k-step: 512 bytes of each panel
    const uint64_t b = desc_at(bd, kk * 512);
    Wgmma<3 * D>::rs(tile, pa[kk], b, kk > 0);
    Wgmma<2 * D>::rs(reinterpret_cast<float(&)[D]>(tile), pa[kF + kk], b, 1);
    Wgmma<D>::rs(reinterpret_cast<float(&)[D / 2]>(tile), pa[2 * kF + kk], b, 1);
  }
  wgmma_commit();
}

template <int D>
__device__ __forceinline__ float tile_sum(const float (&tile)[3 * D / 2], int i) {
  return (tile[i + D] + tile[i + D / 2]) + tile[i];
}

// dQ for work tiles of 128 query rows of one (batch, head), from the split parts at D = 32:
// fa_bwd_dq_f32's schedule (S_j and dP_j issued with the previous key tile's dS K; each key
// tile's dS K in a fresh accumulator, added to dQ in fp32) on 16-column panels, the two
// consumers issuing freely.
template <int D>
__global__ void __launch_bounds__(DqF32NarrowPlan<D>::kThreads, 1)
    fa_bwd_dq_f32_narrow(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                         const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dq,
                         int B, int Tq, int Tk, int H, int n_work, float scale, float scale_log2) {
  using P = DqF32NarrowPlan<D>;
  constexpr int kBlockN = P::kBlockN, kStages = P::kStages, kF = kBlockN / 16;
  extern __shared__ __align__(1024) unsigned char dq_smem[];
  const uint32_t base = (smem_u32(dq_smem) + 1023) & ~1023u;
  const uint32_t sQ = base, sdO = sQ + P::kQBytes, sK = sdO + P::kQBytes, sV = sK + kStages * P::kTileBytes;
  const uint32_t full_q = base + P::kBarOffset, empty_q = full_q + 8;
  auto full_k = [&](int s) { return full_q + 8 * (2 + s); };
  auto empty_k = [&](int s) { return full_q + 8 * (2 + kStages + s); };
  auto full_v = [&](int s) { return full_q + 8 * (2 + 2 * kStages + s); };
  auto empty_v = [&](int s) { return full_q + 8 * (2 + 3 * kStages + s); };

  const int m_blocks = (Tq + P::kBlockM - 1) / P::kBlockM;
  const int n_tiles = (Tk + kBlockN - 1) / kBlockN;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    mbar_init(empty_q, 4 * P::kConsumers);
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
    // Producer, as in fa_bwd_dq_f32: each tile is its three parts, a part D / 16 boxes.
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      auto load = [&](const CUtensorMap* map, uint32_t ring, uint32_t full, uint32_t empty, int i, int j, int h,
                      int b) {
        mbar_wait(empty, ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full, P::kTileBytes);
        for (int part = 0; part < 3; ++part)
          for (int p = 0; p < P::kPanels; ++p)
            tma_load_4d(ring + part * P::kKVPart + p * P::kPanelKV, map, full, 16 * p, j * kBlockN, h, part * B + b);
      };
      int it = 0;
      for (int w = blockIdx.x, round = 0; w < n_work; w += gridDim.x, ++round, it += n_tiles) {
        const int m0 = (w % m_blocks) * P::kBlockM, h = (w / m_blocks) % H, b = w / (m_blocks * H);
        mbar_wait(empty_q, (round & 1) ^ 1);
        mbar_expect_tx(full_q, 2 * P::kQBytes);
        for (int part = 0; part < 3; ++part)
          for (int p = 0; p < P::kPanels; ++p) {
            const uint32_t off = part * P::kQPart + p * P::kPanelQ;
            tma_load_4d(sQ + off, &tm_q, full_q, 16 * p, m0, h, part * B + b);
            tma_load_4d(sdO + off, &tm_do, full_q, 16 * p, m0, h, part * B + b);
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
    const uint32_t q_rows = sQ + c * 64 * 32, do_rows = sdO + c * 64 * 32;

    float acc[D / 2];        // dQ, 64 x D
    float tile[3 * D / 2];   // one key tile's dS K in three column blocks (tile_products)
    float s[kBlockN / 2];    // S, then dS
    float dp[kBlockN / 2];   // dP
    uint32_t pa[3 * kF][4];  // dS split: hi, mid and lo A fragments of dS K
    float lse2[2], dlt[2];
#pragma unroll
    for (int i = 0; i < kBlockN / 2; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 3 * D / 2; ++i) tile[i] = 0.f;

    auto issue_sdp = [&](int stage) {  // S = Q K^T, dP = dO V^T, six passes of D / 16 k-steps each
      const uint64_t qd = sw32_desc(q_rows, 16), dod = sw32_desc(do_rows, 16);
      const uint64_t kd = sw32_desc(sK + stage * P::kTileBytes, 16), vd = sw32_desc(sV + stage * P::kTileBytes, 16);
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int pass = 0; pass < kPasses; ++pass)
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t a = pass_a(pass) * P::kQPart + kk * P::kPanelQ;
          const uint32_t bo = pass_b(pass) * P::kKVPart + kk * P::kPanelKV;
          const int accumulate = pass > 0 || kk > 0;
          Wgmma<kBlockN>::ss(s, desc_at(qd, a), desc_at(kd, bo), accumulate);
          Wgmma<kBlockN>::ss(dp, desc_at(dod, a), desc_at(vd, bo), accumulate);
        }
      wgmma_commit();
    };
    auto issue_dq = [&](int stage) { tile_products<D, kF, P::kPanelKV>(tile, pa, sK + stage * P::kTileBytes); };
    auto form_ds = [&](int kv0) {  // s = dS = P (dP - delta), P = exp2(S scale log2e - lse2)
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
    auto add_tile = [&]() {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] += tile_sum<D>(tile, i);
    };
    auto release = [&](uint32_t empty) {
      if (lane == 0) mbar_arrive(empty);
    };
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

      const int s0 = it % kStages;
      mbar_wait(full_k(s0), (it / kStages) & 1);
      mbar_wait(full_v(s0), (it / kStages) & 1);
      issue_sdp(s0);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      release(empty_v(s0));
      if (n_tiles == 1) release(empty_q);
      form_ds(0);
      split_fragments<kBlockN>(pa, s);

      for (int j = 1; j < n_tiles; ++j) {
        const int sj = (it + j) % kStages, sp = (it + j - 1) % kStages;
        mbar_wait(full_k(sj), ((it + j) / kStages) & 1);
        mbar_wait(full_v(sj), ((it + j) / kStages) & 1);
        issue_sdp(sj);
        issue_dq(sp);
        wgmma_wait<1>();
        fence_regs(s);
        fence_regs(dp);
        release(empty_v(sj));
        if (j == n_tiles - 1) release(empty_q);
        form_ds(j * kBlockN);
        wgmma_wait<0>();
        fence_regs(tile);
        fence_regs(pa);
        release(empty_k(sp));
        add_tile();
        split_fragments<kBlockN>(pa, s);
      }

      const int sl = (it + n_tiles - 1) % kStages;
      issue_dq(sl);
      wgmma_wait<0>();
      fence_regs(tile);
      release(empty_k(sl));
      add_tile();
      store_rows_f32<D>(dq, [&](int i) { return acc[i]; }, scale, b, h, row0, Tq, H, t);
    }
  }
}

// dK and dV for work tiles of 128 keys of one (batch, head), from the split parts at D = 32:
// fa_bwd_dkv_f32's schedule (each stage's P^T dO and dS^T Q in a fresh accumulator, added
// to dV and dK in fp32) on 16-column panels.
template <int D>
__global__ void __launch_bounds__(DkvF32NarrowPlan<D>::kThreads, 1)
    fa_bwd_dkv_f32_narrow(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                          const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dk,
                          float* __restrict__ dv, int B, int Tq, int Tk, int H, int n_work, float scale,
                          float scale_log2) {
  using P = DkvF32NarrowPlan<D>;
  constexpr int kBlockM = P::kBlockM, kStages = P::kStages, kF = kBlockM / 16;
  extern __shared__ __align__(1024) unsigned char dkv_smem[];
  const uint32_t pad = (1024 - (smem_u32(dkv_smem) & 1023)) & 1023;
  const uint32_t base = smem_u32(dkv_smem) + pad;
  const uint32_t sK = base, sV = sK + P::kKVBytes, sQ = sV + P::kKVBytes, sdO = sQ + kStages * P::kStageBytes;
  float* const stats = reinterpret_cast<float*>(dkv_smem + pad + P::kStatOffset);
  const uint32_t full_kv = base + P::kBarOffset, empty_kv = full_kv + 8;
  auto full_s = [&](int s) { return full_kv + 8 * (2 + s); };
  auto empty_s = [&](int s) { return full_kv + 8 * (2 + kStages + s); };

  const int n_blocks = (Tk + P::kBlockN - 1) / P::kBlockN;
  const int n_stages = (Tq + kBlockM - 1) / kBlockM;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    mbar_init(empty_kv, 4 * P::kConsumers);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_s(s), 1 + P::kStatThreads);
      mbar_init(empty_s(s), 4 * P::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // Producer, as in fa_bwd_dkv_f32: each tile is its three parts, a part D / 16 boxes.
    regs_dealloc<kProducerRegs>();
    const int warp = threadIdx.x / 32;
    if (threadIdx.x == 0) {
      int it = 0;
      for (int w = blockIdx.x, round = 0; w < n_work; w += gridDim.x, ++round, it += n_stages) {
        const int n0 = (w % n_blocks) * P::kBlockN, h = (w / n_blocks) % H, b = w / (n_blocks * H);
        mbar_wait(empty_kv, (round & 1) ^ 1);
        mbar_expect_tx(full_kv, 2 * P::kKVBytes);
        for (int part = 0; part < 3; ++part)
          for (int p = 0; p < P::kPanels; ++p) {
            const uint32_t off = part * P::kKVPart + p * P::kPanelKV;
            tma_load_4d(sK + off, &tm_k, full_kv, 16 * p, n0, h, part * B + b);
            tma_load_4d(sV + off, &tm_v, full_kv, 16 * p, n0, h, part * B + b);
          }
        for (int i = 0; i < n_stages; ++i) {
          const int st = (it + i) % kStages;
          mbar_wait(empty_s(st), (((it + i) / kStages) & 1) ^ 1);
          mbar_expect_tx(full_s(st), 2 * P::kStageBytes);
          for (int part = 0; part < 3; ++part)
            for (int p = 0; p < P::kPanels; ++p) {
              const uint32_t off = st * P::kStageBytes + part * P::kQPart + p * P::kPanelQ;
              tma_load_4d(sQ + off, &tm_q, full_s(st), 16 * p, i * kBlockM, h, part * B + b);
              tma_load_4d(sdO + off, &tm_do, full_s(st), 16 * p, i * kBlockM, h, part * B + b);
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
    const uint32_t k_rows = sK + c * 64 * 32, v_rows = sV + c * 64 * 32;

    float dk_acc[D / 2], dv_acc[D / 2];  // dK and dV, 64 x D each
    float tile[3 * D / 2];               // one stage's P^T dO or dS^T Q in three column blocks
    float s[kBlockM / 2];                // S^T, then P^T
    float dp[kBlockM / 2];               // dP^T, then dS^T
    uint32_t pa[3 * kF][4];              // P^T, then dS^T, split into A fragments
#pragma unroll
    for (int i = 0; i < kBlockM / 2; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 3 * D / 2; ++i) tile[i] = 0.f;

    auto issue_sdp = [&](int st) {  // S^T = K Q^T, dP^T = V dO^T, six passes of D / 16 k-steps each
      const uint64_t kd = sw32_desc(k_rows, 16), vd = sw32_desc(v_rows, 16);
      const uint64_t qd = sw32_desc(sQ + st * P::kStageBytes, 16), dod = sw32_desc(sdO + st * P::kStageBytes, 16);
#pragma unroll
      for (int i = 0; i < kBlockM / 2; ++i) s[i] = dp[i] = 0.f;  // a new value: the old ones died at the split
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int pass = 0; pass < kPasses; ++pass)
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t a = pass_a(pass) * P::kKVPart + kk * P::kPanelKV;
          const uint32_t bo = pass_b(pass) * P::kQPart + kk * P::kPanelQ;
          const int accumulate = pass > 0 || kk > 0;
          Wgmma<kBlockM>::ss(s, desc_at(kd, a), desc_at(qd, bo), accumulate);
          Wgmma<kBlockM>::ss(dp, desc_at(vd, a), desc_at(dod, bo), accumulate);
        }
      wgmma_commit();
    };
    // tile = a * stage tile, with the stage's dO (P^T dO) or Q (dS^T Q).
    auto issue_acc = [&](uint32_t stage_tile) { tile_products<D, kF, P::kPanelQ>(tile, pa, stage_tile); };
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
    auto form_ds = [&](int st) {  // dp = dS^T = P^T (dP^T - delta[col]), P^T in s
      const float* dl = stats + st * 2 * kBlockM + kBlockM + 2 * t;
#pragma unroll
      for (int j = 0; j < kBlockM / 8; ++j) {
        const float2 d = *reinterpret_cast<const float2*>(dl + 8 * j);
        dp[4 * j] = s[4 * j] * (dp[4 * j] - d.x);
        dp[4 * j + 1] = s[4 * j + 1] * (dp[4 * j + 1] - d.y);
        dp[4 * j + 2] = s[4 * j + 2] * (dp[4 * j + 2] - d.x);
        dp[4 * j + 3] = s[4 * j + 3] * (dp[4 * j + 3] - d.y);
      }
    };
    auto add_tile = [&](float(&sum)[D / 2]) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) sum[i] += tile_sum<D>(tile, i);
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

      // Stage i: P^T (under dK of stage i - 1), tile = P^T dO and dS^T under it, dV +=
      // tile; then the next stage's S^T and dP^T with tile = dS^T Q.
      for (int i = 0; i < n_stages; ++i) {
        const int st = (it + i) % kStages;
        form_p(st);
        wgmma_wait<0>();
        fence_regs(tile);
        fence_regs(pa);
        if (i > 0) {
          release(empty_s((it + i - 1) % kStages));
          add_tile(dk_acc);
        }
        split_fragments<kBlockM>(pa, s);
        issue_acc(sdO + st * P::kStageBytes);
        form_ds(st);
        wgmma_wait<0>();
        fence_regs(tile);
        fence_regs(pa);
        add_tile(dv_acc);
        split_fragments<kBlockM>(pa, dp);
        if (i + 1 < n_stages) {
          const int sn = (it + i + 1) % kStages;
          mbar_wait(full_s(sn), ((it + i + 1) / kStages) & 1);
          issue_sdp(sn);
          issue_acc(sQ + st * P::kStageBytes);
          wgmma_wait<1>();  // S^T and dP^T are done
          fence_regs(s);
          fence_regs(dp);
          if (i + 2 == n_stages) release(empty_kv);
        } else {
          issue_acc(sQ + st * P::kStageBytes);
        }
      }
      wgmma_wait<0>();
      fence_regs(tile);
      release(empty_s((it + n_stages - 1) % kStages));
      add_tile(dk_acc);
      const int key0 = n0 + c * 64 + warp * 16 + g;
      store_rows_f32<D>(dk, [&](int i) { return dk_acc[i]; }, scale, b, h, key0, Tk, H, t);
      store_rows_f32<D>(dv, [&](int i) { return dv_acc[i]; }, 1.f, b, h, key0, Tk, H, t);
    }
  }
}

// ---- Host: launchers ----

// The launchers of both dtypes: the tensor maps of q, k, v and dO (11 values each, see
// encode_map; in fp32, of their split parts), with boxes of the plan's rows, then a
// persistent grid of one block an SM.
struct BwdArgs {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *o0, *o1;  // dq; or dk and dv
  const long long* maps;
  int B, Tq, Tk, H;
  float scale;
  cudaStream_t st;
};

// `D`: the maps' width; `batches`: B, or 3B for the fp32 parts' maps (part p of batch b at
// p * B + b); `box_cols`: 64, or 16 for the true-width D = 32 instances.
int encode_bwd_maps(CUtensorMap (&tm)[4], const BwdArgs& a, int D, int batches, int q_rows, int kv_rows,
                    int box_cols = 64) {
  int err = encode_map(&tm[0], a.q, a.maps, D, a.Tq, a.H, batches, q_rows, box_cols);
  if (!err) err = encode_map(&tm[1], a.k, a.maps + kMapLongs, D, a.Tk, a.H, batches, kv_rows, box_cols);
  if (!err) err = encode_map(&tm[2], a.v, a.maps + 2 * kMapLongs, D, a.Tk, a.H, batches, kv_rows, box_cols);
  if (!err) err = encode_map(&tm[3], a.dout, a.maps + 3 * kMapLongs, D, a.Tq, a.H, batches, q_rows, box_cols);
  return err;
}

template <int D>
int bwd_dq_bf16(const BwdArgs& a) {
  using P = DqPlan<D>;
  static_assert(P::kSmem > kStaticSmemLimit, "launch() sizes dynamic shared memory above 48 KB only");
  CUtensorMap tm[4];
  int n_work = 0, blocks = 0;
  int err = encode_bwd_maps(tm, a, D, a.B, P::kBlockM, P::kBlockN);
  if (!err) err = persistent_grid(static_cast<long long>((a.Tq + P::kBlockM - 1) / P::kBlockM) * a.H * a.B, n_work, blocks);
  if (err) return err;
  static SmemOptIn opt_in;
  return launch(fa_bwd_dq_bf16<D>, opt_in, dim3(blocks), P::kThreads, P::kSmem, a.st, tm[0], tm[1], tm[2], tm[3],
                a.lse, a.delta, static_cast<__nv_bfloat16*>(a.o0), a.Tq, a.Tk, a.H, n_work, a.scale,
                a.scale * kLog2e);
}

template <int D>
int bwd_dkv_bf16(const BwdArgs& a) {
  using P = DkvPlan<D>;
  static_assert(P::kSmem > kStaticSmemLimit, "launch() sizes dynamic shared memory above 48 KB only");
  CUtensorMap tm[4];
  int n_work = 0, blocks = 0;
  int err = encode_bwd_maps(tm, a, D, a.B, P::kBlockM, P::kBlockN);
  if (!err) err = persistent_grid(static_cast<long long>((a.Tk + P::kBlockN - 1) / P::kBlockN) * a.H * a.B, n_work, blocks);
  if (err) return err;
  static SmemOptIn opt_in;
  return launch(fa_bwd_dkv_bf16<D>, opt_in, dim3(blocks), P::kThreads, P::kSmem, a.st, tm[0], tm[1], tm[2], tm[3],
                a.lse, a.delta, static_cast<__nv_bfloat16*>(a.o0), static_cast<__nv_bfloat16*>(a.o1), a.Tq, a.Tk,
                a.H, n_work, a.scale, a.scale * kLog2e);
}

// The fp32 launchers: D = 32 runs the true-width instances (16-column boxes), 64 and 128
// fa_bwd_dq_f32 and fa_bwd_dkv_f32 (64-column boxes).
template <int D>
int bwd_dq_f32(const BwdArgs& a) {
  constexpr bool kNarrow = D == 32;
  using P = std::conditional_t<kNarrow, DqF32NarrowPlan<D>, DqF32Plan<D>>;
  static_assert(P::kSmem > kStaticSmemLimit, "launch() sizes dynamic shared memory above 48 KB only");
  CUtensorMap tm[4];
  int n_work = 0, blocks = 0;
  int err = encode_bwd_maps(tm, a, D, 3 * a.B, P::kBlockM, P::kBlockN, kNarrow ? 16 : 64);
  if (!err) err = persistent_grid(static_cast<long long>((a.Tq + P::kBlockM - 1) / P::kBlockM) * a.H * a.B, n_work, blocks);
  if (err) return err;
  static SmemOptIn opt_in;
  auto run = [&](auto kernel) {
    return launch(kernel, opt_in, dim3(blocks), P::kThreads, P::kSmem, a.st, tm[0], tm[1], tm[2], tm[3], a.lse,
                  a.delta, static_cast<float*>(a.o0), a.B, a.Tq, a.Tk, a.H, n_work, a.scale, a.scale * kLog2e);
  };
  if constexpr (kNarrow)
    return run(fa_bwd_dq_f32_narrow<D>);
  else
    return run(fa_bwd_dq_f32<D>);
}

template <int D>
int bwd_dkv_f32(const BwdArgs& a) {
  constexpr bool kNarrow = D == 32;
  using P = std::conditional_t<kNarrow, DkvF32NarrowPlan<D>, DkvF32Plan<D>>;
  static_assert(P::kSmem > kStaticSmemLimit, "launch() sizes dynamic shared memory above 48 KB only");
  CUtensorMap tm[4];
  int n_work = 0, blocks = 0;
  int err = encode_bwd_maps(tm, a, D, 3 * a.B, P::kBlockM, P::kBlockN, kNarrow ? 16 : 64);
  if (!err) err = persistent_grid(static_cast<long long>((a.Tk + P::kBlockN - 1) / P::kBlockN) * a.H * a.B, n_work, blocks);
  if (err) return err;
  static SmemOptIn opt_in;
  auto run = [&](auto kernel) {
    return launch(kernel, opt_in, dim3(blocks), P::kThreads, P::kSmem, a.st, tm[0], tm[1], tm[2], tm[3], a.lse,
                  a.delta, static_cast<float*>(a.o0), static_cast<float*>(a.o1), a.B, a.Tq, a.Tk, a.H, n_work,
                  a.scale, a.scale * kLog2e);
  };
  if constexpr (kNarrow)
    return run(fa_bwd_dkv_f32_narrow<D>);
  else
    return run(fa_bwd_dkv_f32<D>);
}

}  // namespace

// The backward. maps: the tensor maps' layout of q, k, v and dO, 11 values each
// (encode_map), with boxes of BWD_TILES' rows in bf16 and BWD_F32_TILES' in fp32
// (ops/flash_attention.py; 64 columns wide, 16 at fp32 D = 32); D: 64 or 128 in bf16, 32,
// 64 or 128 in fp32. The bf16 entry
// points take q, k, v and dO themselves, the fp32 ones their split parts
// (flash_attention_split_f32), each a contiguous bf16 (3, B, T, H, D). lse
// and delta are contiguous fp32 (B, H, Tq); outputs are contiguous (B, T, H, D) in the inputs' dtype. Each returns cudaErrorInvalidValue for
// arguments no instance takes or a map the driver refuses, cudaErrorNotSupported if the
// driver has no cuTensorMapEncodeTiled, else the shared memory attribute call's error or
// cudaGetLastError() after its launch.
#define FA_BWD_ARGS \
  const long long *maps, int B, int Tq, int Tk, int H, int D, float scale, void *stream

extern "C" int flash_attention_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* dout,
                                           const float* lse, const float* delta, void* dq, FA_BWD_ARGS) {
  const BwdArgs a{q, k, v, dout, lse, delta, dq, nullptr, maps, B, Tq, Tk, H, scale, static_cast<cudaStream_t>(stream)};
  return by_head_dim<64, 128>(D, B, Tq, Tk, H, [&](auto d) { return bwd_dq_bf16<decltype(d)::value>(a); });
}

extern "C" int flash_attention_bwd_dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                                            const float* lse, const float* delta, void* dk, void* dv, FA_BWD_ARGS) {
  const BwdArgs a{q, k, v, dout, lse, delta, dk, dv, maps, B, Tq, Tk, H, scale, static_cast<cudaStream_t>(stream)};
  return by_head_dim<64, 128>(D, B, Tq, Tk, H, [&](auto d) { return bwd_dkv_bf16<decltype(d)::value>(a); });
}

extern "C" int flash_attention_bwd_dq_f32(const void* q_parts, const void* k_parts, const void* v_parts,
                                          const void* dout_parts, const float* lse, const float* delta, void* dq,
                                          FA_BWD_ARGS) {
  const BwdArgs a{q_parts, k_parts, v_parts, dout_parts, lse, delta, dq, nullptr, maps, B, Tq, Tk, H, scale,
                  static_cast<cudaStream_t>(stream)};
  return by_head_dim<32, 64, 128>(D, B, Tq, Tk, H, [&](auto d) { return bwd_dq_f32<decltype(d)::value>(a); });
}

extern "C" int flash_attention_bwd_dkv_f32(const void* q_parts, const void* k_parts, const void* v_parts,
                                           const void* dout_parts, const float* lse, const float* delta, void* dk,
                                           void* dv, FA_BWD_ARGS) {
  const BwdArgs a{q_parts, k_parts, v_parts, dout_parts, lse, delta, dk, dv, maps, B, Tq, Tk, H, scale,
                  static_cast<cudaStream_t>(stream)};
  return by_head_dim<32, 64, 128>(D, B, Tq, Tk, H, [&](auto d) { return bwd_dkv_f32<decltype(d)::value>(a); });
}

// The split pass of the fp32 forward at D = 64 and 128 (dout null: q, k and v) and of the
// fp32 backward (q, k, v and dout): fp32 (B, T, H, D) (Tq rows for q and dout, Tk for k and
// v) with their batch, token and head strides in elements (the head-dim stride is 1; rows
// 16-byte aligned; dout's strides are not read without it), into the contiguous bf16 parts
// q_parts .. dout_parts, (3, B, T, H, D) each. One launch. Returns
// cudaErrorInvalidValue for a D other than 32, 64 or 128 or empty shapes, else
// cudaGetLastError() after the launch. (The forward at D = 32 and 48 splits in its own
// shared memory: fa_fwd_f32_narrow.)
extern "C" int flash_attention_split_f32(const void* q, const void* k, const void* v, const void* dout, void* q_parts,
                                         void* k_parts, void* v_parts, void* dout_parts, int B, int Tq, int Tk, int H,
                                         int D, long long sqb, long long sqt, long long sqh, long long skb,
                                         long long skt, long long skh, long long svb, long long svt, long long svh,
                                         long long sdb, long long sdt, long long sdh, void* stream) {
  if (by_head_dim<32, 64, 128>(D, B, Tq, Tk, H, [](auto) { return 0; }))
    return static_cast<int>(cudaErrorInvalidValue);
  const SplitArgs a{{static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
                     static_cast<const float*>(dout)},
                    {static_cast<__nv_bfloat16*>(q_parts), static_cast<__nv_bfloat16*>(k_parts),
                     static_cast<__nv_bfloat16*>(v_parts), static_cast<__nv_bfloat16*>(dout_parts)},
                    {{sqb, sqt, sqh}, {skb, skt, skh}, {svb, svt, svh}, {sdb, sdt, sdh}},
                    {Tq, Tk, Tk, Tq},
                    B,
                    H,
                    D};
  const long long chunks = static_cast<long long>(B) * std::max(Tq, Tk) * H * (D / 8);
  const int blocks = static_cast<int>(std::min<long long>((chunks + kSplitThreads - 1) / kSplitThreads, 4096));
  fa_split_f32<<<dim3(blocks, dout ? 4 : 3), kSplitThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Bytes of dynamic shared memory a block of an instance of head dim D takes (0 for
// another D): kernel 0 the bf16 dq, 1 the bf16 dk/dv, 2 the fp32 dq, 3 the fp32 dk/dv.
// Printed in the build line.
extern "C" int flash_attention_bwd_smem(int kernel, int D) {
  switch (kernel) {
    case 0:
      return D == 64 ? DqPlan<64>::kSmem : D == 128 ? DqPlan<128>::kSmem : 0;
    case 1:
      return D == 64 ? DkvPlan<64>::kSmem : D == 128 ? DkvPlan<128>::kSmem : 0;
    case 2:
      return D == 32 ? DqF32NarrowPlan<32>::kSmem : D == 64 ? DqF32Plan<64>::kSmem : D == 128 ? DqF32Plan<128>::kSmem : 0;
    case 3:
      return D == 32 ? DkvF32NarrowPlan<32>::kSmem : D == 64 ? DkvF32Plan<64>::kSmem : D == 128 ? DkvF32Plan<128>::kSmem : 0;
    default:
      return 0;
  }
}
