// Non-causal flash-attention forward for Hopper (sm_90a): o = softmax(q k^T * scale) v.
//
// Replaces these TPU Pallas kernels of mapanything_tpu/ops/flash_attention.py:
//   K1 _packed_single_kernel (:395, launched by _packed_forward :443): encoder and
//      trunk frame layers, <= 2048 padded tokens;
//   K2 _pair_stream_kernel (:516, launched by _run_pair :646): trunk global layers,
//      d = 64, 2048 < padded tokens <= 12288;
//   K3 _fwd_stream_aug (:164, body :126, launched in _core_fwd :967): longer
//      sequences, odd head counts and fp32, d % 128 != 0;
//   K8 _fwd_kernel (:214, body _fwd_stream_body :177, launched in _core_fwd :989):
//      the long regime at d % 128 == 0.
// Those differ only in how they fit the TPU's VMEM and 128-wide MXU (head-pair
// packing, augmented ones/bias columns, constant-shift base-2 softmax, and for K8 a
// separate bias row instead of augmented columns). Here one streaming kernel serves
// every length: a max-stabilised online softmax in fp32 registers over K/V tiles.
//
// Layout. q is (B, Tq, H, D) and k, v are (B, Tk, H, D), read in place through their
// batch, token and head strides (the last stride is 1), so the views that Attention
// cuts out of its fused qkv projection need no transpose or copy. o is written as a
// contiguous (B, Tq, H, D) tensor. The kernels allocate nothing and do not
// synchronise; they run on the stream they are given.
//
// Each instance comes in two forms, chosen by the template flag kLse. Without it
// (inference) the kernel writes o alone. With it (training) the kernel also writes the
// softmax normaliser lse = log(sum_j exp(s_ij)) of the scaled logits s = q.k * scale,
// fp32 (B, H, Tq), natural log: the residual the backward kernels
// (csrc/flash_attention_bwd.cu) recompute P from, and that the ring's merge reads. That
// form replaces the TPU's lse-writing kernels K4 _fwd_kernel_single_lse (:118, launched
// :942), K6's forward _pair_stream_kernel_lse (:600, launched :674), K7
// _fwd_stream_aug_lse (:168, launched :967) and K8's _fwd_kernel_lse (:218, launched
// :989). The running max is kept in base-2 units; it becomes a natural log at the store.
//
// fa_fwd_bf16<D, kLse>, D = 64 and 128: the main-path instance.
//   Bound on this card. At the main-path shapes (encoder 8x1370x16x64, frame
//   8x1369x12x64, global 1x10953x12x64, the 64-view global layer 1x87617x12x64; with
//   128-wide trunk heads 8x1369x6x128 and 1x10953x6x128) the work is 4*T^2*D*H flop per
//   call against 4*T*H*D*2 bytes moved, hundreds of flop per byte: the tensor cores bound
//   it (989 dense bf16 TFLOP/s on an H100 SXM). Each score also costs one ex2 on the
//   SFU, 16 a clock per SM, while its 4*D flop take 4*D / 4096 of a clock on the tensor
//   cores: at D = 64 the exponentials alone take as long as the products (the exp
//   bound equals the flop bound), at D = 128 half as long. A kernel that runs softmax
//   and products in turn cannot pass about 50% of the flop bound at D = 64, 67% at
//   D = 128.
//   Design. A work tile is 128 query rows of one (batch, head); the grid is persistent,
//   one block of 3 warpgroups an SM, each block walking the work tiles blockIdx.x,
//   + gridDim.x, ... (at T = 1370 a tile streams only 8 key tiles, and one block a
//   tile left each tile's Q load and ring fill exposed: 8-9% of the time there).
//   Warpgroup 0 is the producer: it gives up its registers (setmaxnreg.dec) and one
//   thread issues TMA loads through 4-D tensor maps over (D, T, H, B), built on the
//   host at each call from the tensors' pointers, shapes and strides, 64-column boxes
//   in the 128-byte swizzle: each work tile's Q tile (as soon as the consumers have
//   issued their last S of the previous one), then K and V tiles of kBlockN keys into
//   two rings of kStages stages with full and empty mbarriers. TMA zero-fills rows
//   past T. Warpgroups 1 and 2 are consumers of 64 query
//   rows each (setmaxnreg.inc): S = Q K^T by wgmma from shared memory (both K-major),
//   the online softmax on the S accumulators, P packed to bf16 in place (the
//   accumulator's layout is the A-register fragment's), and O += P V by wgmma with A
//   from registers and V from shared memory through the transpose bit. Two overlaps
//   keep the tensor cores busy during the exponentials: each consumer issues S_{j+1}
//   before the softmax of S_j and P_j V_j after it (both asynchronous), and the two
//   consumers take turns to issue on two named barriers (ping-pong), so that one's
//   softmax runs under the other's products. The last key tile's columns past Tk are
//   masked to -inf; query rows past Tq are computed on zeros and not stored.
// fa_fwd_f32<D, kLse>: fp32 inputs, SIMT fp32 FMA, one thread per query row at D = 64
//   and two at D = 128 (a whole row's q and o would take 256 registers; the two halves'
//   dot products are summed with one shuffle), K/V tiles of 64 keys staged in shared
//   memory by the block's threads. It serves the fp32 model (compute_dtype="float32"),
//   which K3/K4/K7/K8 served on the TPU. Its tiles take 2 * 64 * D * 4 bytes (32 KB,
//   64 KB); above 48 KB the launcher raises the instance's dynamic shared memory limit
//   once per device before its first launch there.

#include "flash_attention_common.cuh"

namespace {

// Tile plan of the bf16 instance: kBlockM query rows a block (64 a consumer warpgroup),
// K and V tiles of kBlockN keys in rings of kStages stages. 176 keys beat 128 at every
// main-path shape, D = 64 and 128 alike; 192 gained at long T and lost at T = 1370,
// where its last tile is mostly masked (PERF.md, PR 6). Shared memory: the Q tile, the
// rings, the mbarriers, and 1 KB of slack to align the tiles to the swizzle's
// 1024-byte atoms: 149 KB at D = 64, 209 KB at D = 128, one block an SM (registers:
// 24 a producer thread, 240 a consumer thread).
template <int D>
struct FwdPlan {
  static constexpr int kBlockM = 128, kBlockN = 176;
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr int kConsumers = kBlockM / 64;
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kPanels = D / 64;          // 64-column (128-byte) boxes a row
  static constexpr int kPanelQ = kBlockM * 128;   // bytes of one panel of the Q tile
  static constexpr int kPanelKV = kBlockN * 128;  // of a K or V tile
  static constexpr int kQBytes = kPanels * kPanelQ;
  static constexpr int kTileBytes = kPanels * kPanelKV;
  static constexpr int kBarriers = 2 + 4 * kStages;  // full and empty of Q and of each K and V stage
  static constexpr int kBarOffset = kQBytes + 2 * kStages * kTileBytes;
  static constexpr int kSmem = kBarOffset + 8 * kBarriers + 1024;
  static constexpr int kProducerRegs = 24, kConsumerRegs = 240;
};

// Named barriers of the consumers' ping-pong: consumer c issues its products after
// syncing on kSchedBarrier + c, then lets the other one issue.
constexpr int kSchedBarrier = 1;

// Mask the columns of an S tile at or past Tk, then fold it into the running max and
// sum: on return s holds P = exp2(s * scale_log2 - m) and alpha the factor by which the
// rows' earlier sums and outputs shrink. Every tile holds at least one key < Tk, so the
// new max is finite; alpha is 0 on the first tile.
template <int N>
__device__ __forceinline__ void online_softmax(float (&s)[N / 2], float (&m_run)[2], float (&l_run)[2],
                                               float (&alpha)[2], int kv0, int Tk, int t, float scale_log2) {
  if (kv0 + N > Tk) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (kv0 + 8 * j + 2 * t + (e & 1) >= Tk) s[4 * j + e] = -INFINITY;
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m_run[r], mx[r] * scale_log2);
    alpha[r] = ex2(m_run[r] - m_new);
    m_run[r] = m_new;
    l_run[r] *= alpha[r];
  }
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * j + e] = ex2(fmaf(s[4 * j + e], scale_log2, -m_run[e >> 1]));
      l_run[e >> 1] += s[4 * j + e];
    }
}

template <int D, bool kLse>
__global__ void __launch_bounds__(FwdPlan<D>::kThreads, 1)
    fa_fwd_bf16(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
                float* __restrict__ lse, int Tq, int Tk, int H, int n_work, float scale_log2) {
  static_assert(D == 64 || D == 128, "the tile plan covers D in {64, 128}");
  using P = FwdPlan<D>;
  constexpr int kBlockN = P::kBlockN, kStages = P::kStages;
  extern __shared__ __align__(1024) unsigned char fwd_smem[];
  const uint32_t base = (smem_u32(fwd_smem) + 1023) & ~1023u;
  const uint32_t sQ = base, sK = base + P::kQBytes, sV = sK + kStages * P::kTileBytes;
  const uint32_t full_q = base + P::kBarOffset, empty_q = full_q + 8;
  auto full_k = [&](int s) { return full_q + 8 * (2 + s); };
  auto empty_k = [&](int s) { return full_q + 8 * (2 + kStages + s); };
  auto full_v = [&](int s) { return full_q + 8 * (2 + 2 * kStages + s); };
  auto empty_v = [&](int s) { return full_q + 8 * (2 + 3 * kStages + s); };

  // Work tile w: query rows 128 * (w % m_blocks) .. + 127 of head (w / m_blocks) % H of
  // batch w / (m_blocks * H); the block takes w = blockIdx.x, + gridDim.x, ...
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
    // Producer. The Q tile of the next work tile loads as soon as the consumers have
    // issued their last S of this one. K is consumed one step ahead of V (S_j before
    // P_{j-1} V_{j-1}), so the loads go K_0, then K_j and V_{j-1}, then the last V. The
    // rings' stages and phases run on across work tiles (n_tiles loads each).
    regs_dealloc<P::kProducerRegs>();
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
        mbar_expect_tx(full_q, P::kQBytes);
        for (int p = 0; p < P::kPanels; ++p) tma_load_4d(sQ + p * P::kPanelQ, &tm_q, full_q, 64 * p, m0, h, b);
        for (int j = 0; j <= n_tiles; ++j) {
          if (j < n_tiles) {
            const int s = (it + j) % kStages;
            load(&tm_k, sK + s * P::kTileBytes, full_k(s), empty_k(s), it + j, j, h, b);
          }
          if (j > 0) {
            const int s = (it + j - 1) % kStages;
            load(&tm_v, sV + s * P::kTileBytes, full_v(s), empty_v(s), it + j - 1, j - 1, h, b);
          }
        }
      }
    }
  } else {
    regs_alloc<P::kConsumerRegs>();
    const int c = wg - 1;  // consumer: query rows 64c .. 64c + 63 of each work tile
    const int tw = threadIdx.x % 128, warp = tw / 32, lane = tw % 32;
    const int g = lane >> 2, t = lane & 3;
    const uint32_t q_rows = sQ + c * 64 * 128;

    float acc[D / 2];               // O, 64 x D
    float s[kBlockN / 2];           // S, then P, 64 x kBlockN
    uint32_t pa[kBlockN / 16][4];   // P in bf16 as the A fragments of P V
    float m_run[2], l_run[2], alpha[2];
#pragma unroll
    for (int i = 0; i < kBlockN / 2; ++i) s[i] = 0.f;

    auto issue_qk = [&](int stage) {
      const uint32_t k_tile = sK + stage * P::kTileBytes;
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;  // 16 columns of the 128-byte row
        Wgmma<kBlockN>::ss(s, sw128_desc(q_rows + (kk / 4) * P::kPanelQ + off, 16),
                           sw128_desc(k_tile + (kk / 4) * P::kPanelKV + off, 16), kk > 0);
      }
      wgmma_commit();
    };
    auto issue_pv = [&](int stage) {
      const uint32_t v_tile = sV + stage * P::kTileBytes;
      fence_regs(acc);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk)
        Wgmma<D>::rs(acc, pa[kk], sw128_desc(v_tile + kk * 2048, P::kPanelKV), 1);
      wgmma_commit();
    };
    auto rescale = [&]() {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j] *= alpha[0];
        acc[4 * j + 1] *= alpha[0];
        acc[4 * j + 2] *= alpha[1];
        acc[4 * j + 3] *= alpha[1];
      }
    };
    auto pack = [&]() {
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) pa[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
    };
    auto release = [&](uint32_t empty) {
      if (lane == 0) mbar_arrive(empty);
    };

    if (c == 0) named_arrive(kSchedBarrier, 256);  // consumer 0 issues first
    int it = 0;
    for (int w = blockIdx.x, round = 0; w < n_work; w += gridDim.x, ++round, it += n_tiles) {
      const int m0 = (w % m_blocks) * P::kBlockM, h = (w / m_blocks) % H, b = w / (m_blocks * H);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      m_run[0] = m_run[1] = -INFINITY;
      l_run[0] = l_run[1] = 0.f;
      mbar_wait(full_q, round & 1);

      // Tile 0: S_0 alone.
      mbar_wait(full_k(it % kStages), (it / kStages) & 1);
      named_sync(kSchedBarrier + c, 256);
      issue_qk(it % kStages);
      named_arrive(kSchedBarrier + (c ^ 1), 256);
      wgmma_wait<0>();
      fence_regs(s);
      release(empty_k(it % kStages));
      if (n_tiles == 1) release(empty_q);
      online_softmax<kBlockN>(s, m_run, l_run, alpha, 0, Tk, t, scale_log2);
      pack();

      // Tile j: issue S_j and P_{j-1} V_{j-1}; the softmax of S_j runs under P V.
      for (int j = 1; j < n_tiles; ++j) {
        const int sj = (it + j) % kStages, sp = (it + j - 1) % kStages;
        mbar_wait(full_k(sj), ((it + j) / kStages) & 1);
        named_sync(kSchedBarrier + c, 256);
        issue_qk(sj);
        rescale();
        mbar_wait(full_v(sp), ((it + j - 1) / kStages) & 1);
        issue_pv(sp);
        named_arrive(kSchedBarrier + (c ^ 1), 256);
        wgmma_wait<1>();
        fence_regs(s);
        release(empty_k(sj));
        if (j == n_tiles - 1) release(empty_q);
        online_softmax<kBlockN>(s, m_run, l_run, alpha, j * kBlockN, Tk, t, scale_log2);
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(pa);
        release(empty_v(sp));
        pack();
      }

      // The last tile's P V. After the block's last work tile, consumer 1's turn would
      // pass to no one: it arrives no more.
      const int sl = (it + n_tiles - 1) % kStages;
      rescale();
      mbar_wait(full_v(sl), ((it + n_tiles - 1) / kStages) & 1);
      named_sync(kSchedBarrier + c, 256);
      issue_pv(sl);
      if (c == 0 || w + static_cast<int>(gridDim.x) < n_work) named_arrive(kSchedBarrier + (c ^ 1), 256);
      wgmma_wait<0>();
      fence_regs(acc);
      release(empty_v(sl));

      float inv[2];
      const int row0 = m0 + c * 64 + warp * 16 + g, row1 = row0 + 8;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float l = l_run[r];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        inv[r] = 1.f / l;
        if constexpr (kLse) {
          const int row = r ? row1 : row0;
          if (t == 0 && row < Tq)
            lse[(static_cast<long long>(b) * H + h) * Tq + row] = (m_run[r] + log2f(l)) * kLn2;
        }
      }
      __nv_bfloat16* o0 = o + ((static_cast<long long>(b) * Tq + row0) * H + h) * D;
      __nv_bfloat16* o1 = o + ((static_cast<long long>(b) * Tq + row1) * H + h) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int col = 8 * j + 2 * t;
        if (row0 < Tq)
          *reinterpret_cast<uint32_t*>(o0 + col) = pack_bf16(acc[4 * j] * inv[0], acc[4 * j + 1] * inv[0]);
        if (row1 < Tq)
          *reinterpret_cast<uint32_t*>(o1 + col) = pack_bf16(acc[4 * j + 2] * inv[1], acc[4 * j + 3] * inv[1]);
      }
    }
  }
}

constexpr int kF32SubTile = 16;  // keys per online-softmax step in the fp32 instance

// Tiles of the fp32 instance: kBlockM query rows a block, kSplit threads a row, each
// holding D / kSplit of the row's q and o (one thread a row at D = 64; two at D = 128,
// where a whole row would take 2 * D = 256 registers), over K/V tiles of kBlockN keys.
template <int D>
struct FwdF32Tiles {
  static constexpr int kBlockM = 64, kBlockN = 64;
  static constexpr int kSplit = D / 64;
  static constexpr int kThreads = kBlockM * kSplit;
  static constexpr int kSmem = 2 * kBlockN * D * 4;  // sK, sV (fp32)
};

template <int D, bool kLse>
__global__ void __launch_bounds__(FwdF32Tiles<D>::kThreads)
    fa_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
               int Tq, int Tk, int H,
               long long sqb, long long sqt, long long sqh, long long skb, long long skt,
               long long skh, long long svb, long long svt, long long svh, float scale_log2) {
  using Tl = FwdF32Tiles<D>;
  constexpr int kBlockM = Tl::kBlockM, kBlockN = Tl::kBlockN, kSplit = Tl::kSplit;
  constexpr int kPart = D / kSplit;  // head-dim elements a thread holds
  static_assert(kBlockN == kBlockM, "each row slot stages one K/V row");
  float(*sK)[D] = reinterpret_cast<float(*)[D]>(block_smem<Tl::kSmem>());
  float(*sV)[D] = sK + kBlockN;

  const int tid = threadIdx.x, slot = tid / kSplit, hf = tid % kSplit;
  const int h = blockIdx.y, b = blockIdx.z;
  const int row = blockIdx.x * kBlockM + slot;
  const bool live = row < Tq;
  const float* qp = q + b * sqb + h * sqh + static_cast<long long>(live ? row : 0) * sqt;
  const float* kbase = k + b * skb + h * skh;
  const float* vbase = v + b * svb + h * svh;
  // This thread's elements d .. d+3 (d a multiple of 4 below kPart) are head-dim columns
  // col(d) .. col(d)+3: 16-byte chunks dealt round-robin to the kSplit threads of a row,
  // so that the row's threads read neighbouring banks.
  auto col = [hf](int d) { return 4 * (kSplit * (d / 4) + hf); };

  float qr[kPart], acc[kPart];
#pragma unroll
  for (int d = 0; d < kPart; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(qp + col(d));
    qr[d] = x.x * scale_log2;
    qr[d + 1] = x.y * scale_log2;
    qr[d + 2] = x.z * scale_log2;
    qr[d + 3] = x.w * scale_log2;
    acc[d] = acc[d + 1] = acc[d + 2] = acc[d + 3] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int kv0 = 0; kv0 < Tk; kv0 += kBlockN) {
    const int r = kv0 + slot;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    const float* kr = kbase + static_cast<long long>(r < Tk ? r : 0) * skt;
    const float* vr = vbase + static_cast<long long>(r < Tk ? r : 0) * svt;
#pragma unroll
    for (int d = 0; d < kPart; d += 4) {
      *reinterpret_cast<float4*>(&sK[slot][col(d)]) =
          r < Tk ? *reinterpret_cast<const float4*>(kr + col(d)) : zero;
      *reinterpret_cast<float4*>(&sV[slot][col(d)]) =
          r < Tk ? *reinterpret_cast<const float4*>(vr + col(d)) : zero;
    }
    __syncthreads();
    const int n = min(kBlockN, Tk - kv0);
    for (int j0 = 0; j0 < n; j0 += kF32SubTile) {
      float s[kF32SubTile];
      float mx = m;
#pragma unroll
      for (int jj = 0; jj < kF32SubTile; ++jj) {
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < kPart; ++d) dot = fmaf(qr[d], sK[j0 + jj][col(d) + d % 4], dot);
#pragma unroll
        for (int lanes = 1; lanes < kSplit; lanes <<= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, lanes);
        s[jj] = (j0 + jj < n) ? dot : -INFINITY;
        mx = fmaxf(mx, s[jj]);
      }
      const float alpha = ex2(m - mx);  // 0 on the first step
      l *= alpha;
#pragma unroll
      for (int d = 0; d < kPart; ++d) acc[d] *= alpha;
#pragma unroll
      for (int jj = 0; jj < kF32SubTile; ++jj) {
        const float p = ex2(s[jj] - mx);
        l += p;
#pragma unroll
        for (int d = 0; d < kPart; ++d) acc[d] = fmaf(p, sV[j0 + jj][col(d) + d % 4], acc[d]);
      }
      m = mx;
    }
    __syncthreads();
  }

  if (live) {
    if constexpr (kLse)
      if (hf == 0) lse[(static_cast<long long>(b) * H + h) * Tq + row] = (m + log2f(l)) * kLn2;
    const float inv = 1.f / l;
    float* op = o + ((static_cast<long long>(b) * Tq + row) * H + h) * D;
#pragma unroll
    for (int d = 0; d < kPart; d += 4)
      *reinterpret_cast<float4*>(op + col(d)) =
          make_float4(acc[d] * inv, acc[d + 1] * inv, acc[d + 2] * inv, acc[d + 3] * inv);
  }
}

// ---- Host: launchers ----

template <int D, bool kLse>
int fwd_bf16(const void* q, const void* k, const void* v, void* o, float* lse, const long long* maps, int B, int Tq,
             int Tk, int H, float scale_log2, cudaStream_t st) {
  using P = FwdPlan<D>;
  CUtensorMap tq, tk, tv;
  int err = encode_map(&tq, q, maps, D, Tq, H, B, P::kBlockM);
  if (!err) err = encode_map(&tk, k, maps + kMapLongs, D, Tk, H, B, P::kBlockN);
  if (!err) err = encode_map(&tv, v, maps + 2 * kMapLongs, D, Tk, H, B, P::kBlockN);
  if (err) return err;
  static SmemOptIn opt_in;
  int n_work = 0, blocks = 0;
  err = persistent_grid(static_cast<long long>((Tq + P::kBlockM - 1) / P::kBlockM) * H * B, n_work, blocks);
  if (err) return err;
  // Each block walks the work tiles w = blockIdx.x + k * gridDim.x.
  return launch(fa_fwd_bf16<D, kLse>, opt_in, dim3(blocks), P::kThreads, P::kSmem, st, tq, tk, tv,
                static_cast<__nv_bfloat16*>(o), lse, Tq, Tk, H, n_work, scale_log2);
}

template <int D>
int fwd_f32(const float* q, const float* k, const float* v, float* o, float* lse, int B, int Tq, int Tk, int H,
            const long long* st, float scale_log2, cudaStream_t stream) {
  using Tl = FwdF32Tiles<D>;
  static SmemOptIn opt_in[2];
  const dim3 grid((Tq + Tl::kBlockM - 1) / Tl::kBlockM, H, B);
  if (lse == nullptr)
    return launch(fa_fwd_f32<D, false>, opt_in[0], grid, Tl::kThreads, Tl::kSmem, stream, q, k, v, o, lse, Tq, Tk,
                  H, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale_log2);
  return launch(fa_fwd_f32<D, true>, opt_in[1], grid, Tl::kThreads, Tl::kSmem, stream, q, k, v, o, lse, Tq, Tk, H,
                st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale_log2);
}

}  // namespace

// The bf16 forward. maps: the tensor maps' layout of q, k and v, 11 values each (see
// encode_map); D: 64 or 128 (the instantiated head dims). lse is null for the inference
// form, else a contiguous fp32 (B, H, Tq) buffer. Returns cudaErrorInvalidValue for
// arguments no instance takes or a map the driver refuses, cudaErrorNotSupported if the
// driver has no cuTensorMapEncodeTiled, else the shared memory attribute call's error or
// cudaGetLastError() after the launch (0 on success).
extern "C" int flash_attention_fwd_bf16(const void* q, const void* k, const void* v, void* o, float* lse,
                                        const long long* maps, int B, int Tq, int Tk, int H, int D, float scale,
                                        void* stream) {
  const float sl = scale * kLog2e;
  const auto st = static_cast<cudaStream_t>(stream);
  return by_head_dim(
      D, B, Tq, Tk, H,
      [&] {
        return lse ? fwd_bf16<64, true>(q, k, v, o, lse, maps, B, Tq, Tk, H, sl, st)
                   : fwd_bf16<64, false>(q, k, v, o, lse, maps, B, Tq, Tk, H, sl, st);
      },
      [&] {
        return lse ? fwd_bf16<128, true>(q, k, v, o, lse, maps, B, Tq, Tk, H, sl, st)
                   : fwd_bf16<128, false>(q, k, v, o, lse, maps, B, Tq, Tk, H, sl, st);
      });
}

// The fp32 forward. strides: q's, k's and v's batch, token and head strides in elements
// (9 values). Returns as flash_attention_fwd_bf16, without the maps.
extern "C" int flash_attention_fwd_f32(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                                       int Tq, int Tk, int H, int D, long long sqb, long long sqt, long long sqh,
                                       long long skb, long long skt, long long skh, long long svb, long long svt,
                                       long long svh, float scale, void* stream) {
  const long long st[9] = {sqb, sqt, sqh, skb, skt, skh, svb, svt, svh};
  const auto qf = static_cast<const float*>(q), kf = static_cast<const float*>(k), vf = static_cast<const float*>(v);
  const auto of = static_cast<float*>(o);
  const auto stream_ = static_cast<cudaStream_t>(stream);
  return by_head_dim(
      D, B, Tq, Tk, H, [&] { return fwd_f32<64>(qf, kf, vf, of, lse, B, Tq, Tk, H, st, scale * kLog2e, stream_); },
      [&] { return fwd_f32<128>(qf, kf, vf, of, lse, B, Tq, Tk, H, st, scale * kLog2e, stream_); });
}

// Bytes of dynamic shared memory a block of the bf16 instance of head dim D takes (0 for
// another D): printed beside each instance's registers in the build line.
extern "C" int flash_attention_fwd_bf16_smem(int D) {
  return D == 64 ? FwdPlan<64>::kSmem : D == 128 ? FwdPlan<128>::kSmem : 0;
}
