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
// Layout. q is (B, Tq, H, D) and k, v are (B, Tk, H, D). The bf16 instance reads them in
// place through tensor maps of their batch, token and head strides (the last stride is
// 1), so the views that Attention cuts out of its fused qkv projection need no transpose
// or copy; the fp32 instance reads their split parts, which the split pass writes from
// those views. o is written as a contiguous (B, Tq, H, D) tensor. The kernels allocate
// nothing and do not synchronise; they run on the stream they are given.
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
// fa_fwd_f32<D, kLse>, D = 32, 48, 64 and 128: the fp32 model's instance (compute_dtype="float32",
//   the model's default), which K3/K4/K7/K8 and _fwd_kernel_single (:114) served on the
//   TPU in fp32; at D = 32 the RGB models' MAE decoder (8 blocks of 16 heads of 32, fp32
//   whatever the model's dtype), which _fwd_kernel_single(_lse) (:114, :118) and
//   _fwd_stream_aug(_lse) (:164, :168) served there; at D = 48 (lse-free only) the VGGSfM
//   tracker's coarse transformer (8 heads of 48), whose point-to-virtual attention took
//   _fwd_kernel_single (:114) there. One bf16 or TF32 pass would keep 8 or
//   11 of fp32's 24 significand bits.
//   As in the fp32 backward (csrc/flash_attention_bwd.cu), each fp32 operand x is split
//   into three bf16 parts, hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), and
//   each product becomes six bf16 wgmma products of the parts (lo.hi, mid.mid, hi.lo,
//   mid.hi, hi.mid, hi.hi) summed in fp32.
//   Bound on this card. Six bf16 passes of 4*B*H*T^2*D flop at 989 TFLOP/s: the same
//   work in fp32 FMA (67 TFLOP/s) would take 2.46x as long. The exponentials (one a score,
//   16 a clock per SM) take 1/6 of the six passes' tensor-core time at D = 64 and 1/12
//   at D = 128, so the softmax can hide under the products.
//   Design. fa_fwd_bf16's, on operands in three parts. A split pass (fa_split_f32, in
//   csrc/flash_attention_bwd.cu; one launch a forward) writes q, k and v as contiguous bf16
//   (3, B, T, H, D) parts, read through tensor maps over (D, T, H, 3B). The producer
//   stages each Q, K and V tile as its three parts; each consumer issues S_j = Q K_j^T as
//   six passes into one fp32 accumulator with P_{j-1} V_{j-1}, runs the online softmax on
//   S_j while that product runs, and splits P_j in registers into three sets of A
//   fragments (the accumulator's layout is the A fragment's). Each key tile's P V goes
//   into a fresh accumulator that is then added to the rescaled O in fp32 registers: the
//   tensor cores' accumulation is not IEEE round-to-nearest, and one sum over thousands of
//   keys drifts (the fp32 backward's dq read 24x the plain version's error that way). The
//   two consumers issue without taking turns. The plan (FwdF32Plan) takes smaller key
//   tiles than the bf16 one: three parts a tile. D = 32 runs the D = 64 plan: its parts are
//   written zero-padded to 64 columns (one 128-byte swizzle row), the zero columns add
//   nothing to q.k or P V, and o's rows are stored 32 wide.

#include "flash_attention_common.cuh"

#include <type_traits>

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
  static_assert(D == 64 || D == 128, "the bf16 forward's plans: D = 64 and 128");
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

// Tile plan of the fp32 instance (ops/flash_attention.py's FWD_F32_TILES mirrors it; the
// launcher refuses maps of another box). Q, K and V are staged as three bf16 parts each,
// 3x the bf16 plan's bytes a tile: Q takes 48 KB at D = 64 and 96 KB at D = 128 for the
// two consumers' 128 rows, a K or V tile 36 KB at D = 64 (96 keys) and 24 KB at D = 128
// (32 keys), in rings of 2 stages: 193 KB with the barriers and the slack. A consumer
// thread holds O and the fresh P V tile (D / 2 floats each), S (kBlockN / 2) and the three
// fragment sets of P (3 kBlockN / 4): 184 registers at D = 64, 168 at D = 128, against
// setmaxnreg's 240; none spilled. 96-key tiles ran 0.93-0.97x the time of 64-key ones at
// D = 64, where 3 stages of 64 keys ran as 2 did (PERF.md, section 6). At D = 128 the Q
// descriptors stay in registers: the backward's reloaded_zero cost 1.04-1.05x here.
// D = 32 (the MAE decoder's heads) and D = 48 (the VGGSfM tracker's coarse transformer, 8
// heads of 48) are the D = 64 plan on parts zero-padded to 64 columns (f32_part_cols): 2x
// and 1.33x the necessary products, every store clipped at D (a row of o is 96 or 192
// bytes, so no store of a whole 64-column tile). D = 48 has the lse-free form only: the
// tracker runs inference alone.
template <int D>
struct FwdF32Plan {
  static_assert(D == 32 || D == 48 || D == 64 || D == 128, "the fp32 forward's plans: D = 32, 48, 64 and 128");
  static constexpr int kCols = f32_part_cols(D);          // columns of the staged parts
  static constexpr int kBlockM = 128;                     // query rows a work tile, 64 a consumer
  static constexpr int kBlockN = kCols == 64 ? 96 : 32;  // keys a K or V tile
  static constexpr int kStages = 2;
  static constexpr int kConsumers = kBlockM / 64;
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kPanels = kCols / 64;
  static constexpr int kPanelQ = kBlockM * 128;   // bytes of one panel of one part of the Q tile
  static constexpr int kPanelKV = kBlockN * 128;  // of a K or V tile
  static constexpr int kQPart = kPanels * kPanelQ;
  static constexpr int kKVPart = kPanels * kPanelKV;
  static constexpr int kQBytes = 3 * kQPart;
  static constexpr int kTileBytes = 3 * kKVPart;
  static constexpr int kBarriers = 2 + 4 * kStages;
  static constexpr int kBarOffset = kQBytes + 2 * kStages * kTileBytes;
  static constexpr int kSmem = kBarOffset + 8 * kBarriers + 1024;
  static constexpr int kProducerRegs = 24, kConsumerRegs = 240;
};

// The fp32 forward on the split parts of q, k and v: three tensor maps over (D, T, H, 3B),
// part p of batch b at p * B + b. fa_fwd_bf16's schedule, with each product as six passes
// and each key tile's P V into a fresh accumulator added to O in fp32, and without the
// ping-pong: the products take six times the exponentials' time here, and two consumers
// that issue freely ran 0.98-1.00x (D = 64) and 0.93-0.99x (D = 128) the time of the
// turn-taking.
template <int D, bool kLse>
__global__ void __launch_bounds__(FwdF32Plan<D>::kThreads, 1)
    fa_fwd_f32(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v, float* __restrict__ o, float* __restrict__ lse, int B,
               int Tq, int Tk, int H, int n_work, float scale_log2) {
  using P = FwdF32Plan<D>;
  constexpr int kC = P::kCols;  // the products' width; o's rows are D wide
  constexpr int kBlockN = P::kBlockN, kStages = P::kStages, kF = kBlockN / 16;
  extern __shared__ __align__(1024) unsigned char fwd_smem[];
  const uint32_t base = (smem_u32(fwd_smem) + 1023) & ~1023u;
  const uint32_t sQ = base, sK = base + P::kQBytes, sV = sK + kStages * P::kTileBytes;
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
    // Producer, as in fa_fwd_bf16; each tile is its three parts.
    regs_dealloc<P::kProducerRegs>();
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
        mbar_expect_tx(full_q, P::kQBytes);
        for (int part = 0; part < 3; ++part)
          for (int p = 0; p < P::kPanels; ++p)
            tma_load_4d(sQ + part * P::kQPart + p * P::kPanelQ, &tm_q, full_q, 64 * p, m0, h, part * B + b);
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
    const int c = wg - 1;
    const int tw = threadIdx.x % 128, warp = tw / 32, lane = tw % 32;
    const int g = lane >> 2, t = lane & 3;
    const uint32_t q_rows = sQ + c * 64 * 128;

    float acc[kC / 2];         // O, 64 x kC
    float tile[kC / 2];        // one key tile's P V
    float s[kBlockN / 2];      // S, then P, 64 x kBlockN
    uint32_t pa[3 * kF][4];    // P split: hi, mid and lo A fragments of P V
    float m_run[2], l_run[2], alpha[2];
#pragma unroll
    for (int i = 0; i < kBlockN / 2; ++i) s[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kC / 2; ++i) tile[i] = 0.f;

    auto issue_qk = [&](int stage) {  // S = Q K^T, six passes
      const uint64_t qd = sw128_desc(q_rows, 16), kd = sw128_desc(sK + stage * P::kTileBytes, 16);
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int pass = 0; pass < kPasses; ++pass)
#pragma unroll
        for (int kk = 0; kk < kC / 16; ++kk) {
          const uint32_t a = pass_a(pass) * P::kQPart + (kk / 4) * P::kPanelQ + (kk % 4) * 32;
          const uint32_t bo = pass_b(pass) * P::kKVPart + (kk / 4) * P::kPanelKV + (kk % 4) * 32;
          Wgmma<kBlockN>::ss(s, desc_at(qd, a), desc_at(kd, bo), pass > 0 || kk > 0);
        }
      wgmma_commit();
    };
    auto issue_pv = [&](int stage) {  // tile = P V, six passes into a fresh accumulator
      const uint64_t vd = sw128_desc(sV + stage * P::kTileBytes, P::kPanelKV);
      fence_regs(tile);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int pass = 0; pass < kPasses; ++pass)
#pragma unroll
        for (int kk = 0; kk < kF; ++kk)
          Wgmma<kC>::rs(tile, pa[pass_a(pass) * kF + kk], desc_at(vd, pass_b(pass) * P::kKVPart + kk * 2048),
                       pass > 0 || kk > 0);
      wgmma_commit();
    };
    auto rescale = [&]() {  // O *= alpha, row by row
#pragma unroll
      for (int i = 0; i < kC / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
    };
    auto add_tile = [&]() {
#pragma unroll
      for (int i = 0; i < kC / 2; ++i) acc[i] += tile[i];
    };
    auto release = [&](uint32_t empty) {
      if (lane == 0) mbar_arrive(empty);
    };

    int it = 0;
    for (int w = blockIdx.x, round = 0; w < n_work; w += gridDim.x, ++round, it += n_tiles) {
      const int m0 = (w % m_blocks) * P::kBlockM, h = (w / m_blocks) % H, b = w / (m_blocks * H);
#pragma unroll
      for (int i = 0; i < kC / 2; ++i) acc[i] = 0.f;
      m_run[0] = m_run[1] = -INFINITY;
      l_run[0] = l_run[1] = 0.f;
      mbar_wait(full_q, round & 1);

      // Tile 0: S_0 alone.
      mbar_wait(full_k(it % kStages), (it / kStages) & 1);
      issue_qk(it % kStages);
      wgmma_wait<0>();
      fence_regs(s);
      release(empty_k(it % kStages));
      if (n_tiles == 1) release(empty_q);
      online_softmax<kBlockN>(s, m_run, l_run, alpha, 0, Tk, t, scale_log2);
      split_fragments<kBlockN>(pa, s);

      // Tile j: issue S_j and P_{j-1} V_{j-1}; the softmax of S_j runs under P V. O takes
      // S_{j-1}'s alpha meanwhile (P V goes into `tile`, not into O).
      for (int j = 1; j < n_tiles; ++j) {
        const int sj = (it + j) % kStages, sp = (it + j - 1) % kStages;
        mbar_wait(full_k(sj), ((it + j) / kStages) & 1);
        issue_qk(sj);
        mbar_wait(full_v(sp), ((it + j - 1) / kStages) & 1);
        issue_pv(sp);
        rescale();
        wgmma_wait<1>();
        fence_regs(s);
        release(empty_k(sj));
        if (j == n_tiles - 1) release(empty_q);
        online_softmax<kBlockN>(s, m_run, l_run, alpha, j * kBlockN, Tk, t, scale_log2);
        wgmma_wait<0>();
        fence_regs(tile);
        fence_regs(pa);
        release(empty_v(sp));
        add_tile();
        split_fragments<kBlockN>(pa, s);
      }

      // The last tile's P V.
      const int sl = (it + n_tiles - 1) % kStages;
      mbar_wait(full_v(sl), ((it + n_tiles - 1) / kStages) & 1);
      issue_pv(sl);
      rescale();
      wgmma_wait<0>();
      fence_regs(tile);
      release(empty_v(sl));
      add_tile();

      float inv[2];
      const int row0 = m0 + c * 64 + warp * 16 + g;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float l = l_run[r];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        inv[r] = 1.f / l;
        if constexpr (kLse) {
          const int row = row0 + 8 * r;
          if (t == 0 && row < Tq)
            lse[(static_cast<long long>(b) * H + h) * Tq + row] = (m_run[r] + log2f(l)) * kLn2;
        }
      }
      store_rows_f32<kC, D>(o, [&](int i) { return acc[i] * inv[(i >> 1) & 1]; }, 1.f, b, h, row0, Tq, H, t);
    }
  }
}

// ---- Host: launchers ----

// One launch of the bf16 (kF32 false) or fp32 instance: the tensor maps of q, k and v (in
// fp32, of their split parts, 3B batches), boxed by the plan's rows, then a persistent
// grid of one block an SM, each block walking the work tiles w = blockIdx.x + k * gridDim.x.
template <int D, bool kLse, bool kF32>
int fwd(const void* q, const void* k, const void* v, void* o, float* lse, const long long* maps, int B, int Tq,
        int Tk, int H, float scale_log2, cudaStream_t st) {
  using P = std::conditional_t<kF32, FwdF32Plan<D>, FwdPlan<D>>;
  static_assert(P::kSmem > kStaticSmemLimit, "launch() sizes dynamic shared memory above 48 KB only");
  const int batches = kF32 ? 3 * B : B;
  const int cols = kF32 ? f32_part_cols(D) : D;  // the maps' width: in fp32 the parts'
  CUtensorMap tq, tk, tv;
  int err = encode_map(&tq, q, maps, cols, Tq, H, batches, P::kBlockM);
  if (!err) err = encode_map(&tk, k, maps + kMapLongs, cols, Tk, H, batches, P::kBlockN);
  if (!err) err = encode_map(&tv, v, maps + 2 * kMapLongs, cols, Tk, H, batches, P::kBlockN);
  if (err) return err;
  static SmemOptIn opt_in;
  int n_work = 0, blocks = 0;
  err = persistent_grid(static_cast<long long>((Tq + P::kBlockM - 1) / P::kBlockM) * H * B, n_work, blocks);
  if (err) return err;
  if constexpr (kF32)
    return launch(fa_fwd_f32<D, kLse>, opt_in, dim3(blocks), P::kThreads, P::kSmem, st, tq, tk, tv,
                  static_cast<float*>(o), lse, B, Tq, Tk, H, n_work, scale_log2);
  else
    return launch(fa_fwd_bf16<D, kLse>, opt_in, dim3(blocks), P::kThreads, P::kSmem, st, tq, tk, tv,
                  static_cast<__nv_bfloat16*>(o), lse, Tq, Tk, H, n_work, scale_log2);
}

template <bool kF32>
int fwd_by_head_dim(const void* q, const void* k, const void* v, void* o, float* lse, const long long* maps, int B,
                    int Tq, int Tk, int H, int D, float scale, void* stream) {
  const float sl = scale * kLog2e;
  const auto st = static_cast<cudaStream_t>(stream);
  auto run = [&](auto d) {
    constexpr int kD = decltype(d)::value;
    return lse ? fwd<kD, true, kF32>(q, k, v, o, lse, maps, B, Tq, Tk, H, sl, st)
               : fwd<kD, false, kF32>(q, k, v, o, lse, maps, B, Tq, Tk, H, sl, st);
  };
  if constexpr (kF32)
    return by_head_dim<32, 48, 64, 128>(D, B, Tq, Tk, H, [&](auto d) {
      if constexpr (decltype(d)::value == 48)  // the lse-free form alone (FwdF32Plan)
        return lse ? static_cast<int>(cudaErrorInvalidValue)
                   : fwd<48, false, true>(q, k, v, o, lse, maps, B, Tq, Tk, H, sl, st);
      else
        return run(d);
    });
  else
    return by_head_dim<64, 128>(D, B, Tq, Tk, H, run);
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
  return fwd_by_head_dim<false>(q, k, v, o, lse, maps, B, Tq, Tk, H, D, scale, stream);
}

// The fp32 forward on the split parts of q, k and v (flash_attention_split_f32), each a
// contiguous bf16 (3, B, T, H, f32_part_cols(D)); maps: their tensor maps' layout as (3B, T,
// H, f32_part_cols(D)), boxed by FWD_F32_TILES' rows; D: 32, 48 (lse null only), 64 or 128.
// o is a contiguous fp32 (B, Tq, H, D). Returns as the bf16 forward.
extern "C" int flash_attention_fwd_f32(const void* q_parts, const void* k_parts, const void* v_parts, void* o,
                                       float* lse, const long long* maps, int B, int Tq, int Tk, int H, int D,
                                       float scale, void* stream) {
  return fwd_by_head_dim<true>(q_parts, k_parts, v_parts, o, lse, maps, B, Tq, Tk, H, D, scale, stream);
}

// Bytes of dynamic shared memory a block of the instance of head dim D takes (0 for
// another D): kernel 0 the bf16 forward, 1 the fp32 forward. Printed beside each
// instance's registers in the build line.
extern "C" int flash_attention_fwd_smem(int kernel, int D) {
  switch (kernel) {
    case 0:
      return D == 64 ? FwdPlan<64>::kSmem : D == 128 ? FwdPlan<128>::kSmem : 0;
    case 1:
      return D == 32   ? FwdF32Plan<32>::kSmem
             : D == 48 ? FwdF32Plan<48>::kSmem
             : D == 64 ? FwdF32Plan<64>::kSmem
             : D == 128 ? FwdF32Plan<128>::kSmem
                        : 0;
    default:
      return 0;
  }
}
