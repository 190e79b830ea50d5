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
// or copy; the fp32 instance at D = 64 and 128 reads their split parts, which the split
// pass writes from those views; at D = 32 and 48 it reads them in place with 16-byte loads. o is written as a contiguous (B, Tq, H, D) tensor. The kernels allocate
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
// fa_fwd_f32<D, kLse>, D = 64 and 128: the fp32 model's instance (compute_dtype="float32",
//   the model's default), which K3/K4/K7/K8 and _fwd_kernel_single (:114) served on the
//   TPU in fp32. One bf16 or TF32 pass would keep 8 or 11 of fp32's 24 significand bits.
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
//   tiles than the bf16 one: three parts a tile.
// fa_fwd_f32_narrow<D, kLse, kPacked>, D = 32 and 48: the same arithmetic at the narrow
//   head dims. D = 32 is the RGB models' MAE decoder (8 blocks of 16 heads of 32, fp32
//   whatever the model's dtype: 8 x 1369 x 16 x 32 an infer) and the VGGSfM tracker's fine
//   transformer (512 x 8 x 8 x 32), which _fwd_kernel_single(_lse) (:114, :118) and
//   _fwd_stream_aug(_lse) (:164, :168) served on the TPU; D = 48 (lse-free only: the tracker
//   runs inference alone) the tracker's coarse transformer (8 heads of 48: 576 x 8 x 8, 8 x
//   64 against 512 and 64 keys, 8 x 512 against 64), whose point-to-virtual attention took
//   _fwd_kernel_single (:114) from 1024 queries on (below that the JAX sdpa takes XLA,
//   mapanything_tpu/ops/attention.py:73).
//   Bound on this card. The MAE decoder's shape is bound by the six passes (0.186 ms) and
//   its exponentials take a third of that; the tracker's shapes move a few MB and do well
//   under a microsecond of products: the bytes bound them (0.001-0.009 ms), and each call's
//   host time (~0.1 ms) exceeds its device time.
//   Design. Three changes to fa_fwd_f32 for these shapes. (1) Products at the true width:
//   parts are staged in 16-column panels of 32-byte rows (the 32-byte swizzle), so S takes
//   D / 16 k-steps, and P V takes three products a 16-key step over whole parts (P_hi at
//   N = 3D against [V_hi V_mid V_lo], P_mid at 2D, P_lo at D: the six of the split, no
//   column padded; fa_fwd_f32 padded D = 32 and 48 to its 64-column rows: 2x and 1.33x the
//   products). (2) Tiles that fit short sequences: where Tq and Tk are at most 64, a work
//   tile packs 128 / max(Tq, Tk) sequences (both rounded up to powers of two) and their
//   keys in one 128-key tile under a block-diagonal mask (the tracker's 8-token time
//   attention filled 8 of 128 rows a tile); other shapes stream key tiles as fa_fwd_f32
//   does. (3) The split inside the kernel: the producer warpgroup
//   reads q, k and v in place (any batch, token and head strides: the MAE decoder's views
//   of its fused qkv) with 16-byte loads and writes their parts into shared memory only,
//   so one launch replaces the split pass and the forward.

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
// D = 32 and 48 have a plan of their own (FwdF32NarrowPlan).
template <int D>
struct FwdF32Plan {
  static_assert(D == 64 || D == 128, "the fp32 forward's plans: D = 64 and 128");
  static constexpr int kBlockM = 128;                 // query rows a work tile, 64 a consumer
  static constexpr int kBlockN = D == 64 ? 96 : 32;  // keys a K or V tile
  static constexpr int kStages = 2;
  static constexpr int kConsumers = kBlockM / 64;
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kPanels = D / 64;
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

    float acc[D / 2];          // O, 64 x D
    float tile[D / 2];         // one key tile's P V
    float s[kBlockN / 2];      // S, then P, 64 x kBlockN
    uint32_t pa[3 * kF][4];    // P split: hi, mid and lo A fragments of P V
    float m_run[2], l_run[2], alpha[2];
#pragma unroll
    for (int i = 0; i < kBlockN / 2; ++i) s[i] = 0.f;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) tile[i] = 0.f;

    auto issue_qk = [&](int stage) {  // S = Q K^T, six passes
      const uint64_t qd = sw128_desc(q_rows, 16), kd = sw128_desc(sK + stage * P::kTileBytes, 16);
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int pass = 0; pass < kPasses; ++pass)
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
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
          Wgmma<D>::rs(tile, pa[pass_a(pass) * kF + kk], desc_at(vd, pass_b(pass) * P::kKVPart + kk * 2048),
                       pass > 0 || kk > 0);
      wgmma_commit();
    };
    auto rescale = [&]() {  // O *= alpha, row by row
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
    };
    auto add_tile = [&]() {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] += tile[i];
    };
    auto release = [&](uint32_t empty) {
      if (lane == 0) mbar_arrive(empty);
    };

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
      store_rows_f32<D>(o, [&](int i) { return acc[i] * inv[(i >> 1) & 1]; }, 1.f, b, h, row0, Tq, H, t);
    }
  }
}

// ---- The fp32 forward at the narrow head dims, D = 32 and 48 ----

// Tile plan of fa_fwd_f32_narrow (ops/flash_attention.py's fwd_f32_narrow_plan mirrors the
// host side, narrow_plan below). Each operand is staged as three bf16 parts in panels of 16
// columns (32-byte rows, the 32-byte swizzle): D / 16 panels a part, so every product runs
// at the true width, no column padded (S over D / 16 k-steps; P V over whole parts, see
// issue_pv), and a part of a 128-row tile takes 4 KB a panel. Two regimes, one instance each:
//   packed (kPacked; Tq and Tk at most 64): a work tile holds `seqs` sequences (a sequence
//   is one (batch, head)), each on Tq rounded up to a power of two rows and Tk so rounded
//   keys, in one key tile of 128 keys; S carries a block-diagonal mask. The VGGSfM
//   tracker's time attention (8 queries, 8 keys) takes 16 sequences a tile.
//   streaming: 128 query rows of one sequence a work tile against key tiles of 96 keys
//   (D = 32: at the MAE decoder's 1369 keys, fa_fwd_f32<64>'s tile) or 64 (D = 48: the
//   tracker's 64 and 512 keys).
// The producer warpgroup loads each tile's fp32 rows with 16-byte loads (at D = 32 K_j's
// and V_{j-1}'s together, a streamed Q in two halves), then splits them into their parts.
// Shared memory: the Q tile's parts, kStages K and V stages of parts, the barriers and 1 KB
// of slack: 97 KB (D = 32 streaming), 109 KB (D = 48 streaming), 121 KB (D = 32 packed),
// 181 KB (D = 48 packed). Registers: the producer 104, the consumers 200: S (kBlockN / 2),
// P's three fragment sets (3 kBlockN / 4), a key tile's P V in three column blocks
// (3 D / 2) and, streaming, O (D / 2). No wgmma is serialized by ptxas; the packed D = 48
// producer spills 12 bytes (its 6 chunks a tile; 120 producer registers removed the spill
// and made ptxas serialize the consumers' wgmma, in the same time).
// Tried at the MAE decoder's shape (8 x 1369 x 16 x 32; PERF.md, PR 18), each in one call
// with the plan it changed: S from Q's fragments in registers, 1.16x the time (and ptxas
// serialized the wgmma for want of registers); 64-key tiles, 1.15x; K and V loaded one
// at a time with the registers moved to the consumers, 1.08-1.18x; 88 or 72 producer
// registers, 1.04x and 1.12x; 3 stages or consumers taking turns (fa_fwd_bf16's
// ping-pong), no change. In two calls: copying the rows first into a staging ring with
// cp.async, 6 tiles ahead, 0.628 ms against 0.561 (the ring's shared-memory traffic).
template <int D, bool kPacked>
struct FwdF32NarrowPlan {
  static_assert(D == 32 || D == 48, "the narrow fp32 forward's plans: D = 32 and 48");
  static constexpr int kBlockM = 128;                                // query rows a work tile, 64 a consumer
  static constexpr int kBlockN = kPacked ? 128 : D == 32 ? 96 : 64;  // keys a K or V tile
  static constexpr int kStages = 2;                                  // K and V stages of parts
  static constexpr int kConsumers = kBlockM / 64;
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kPanels = D / 16;          // 16-column panels a row
  static constexpr int kPanelQ = kBlockM * 32;    // bytes of one panel of one part of the Q tile
  static constexpr int kPanelKV = kBlockN * 32;   // of a K or V tile
  static constexpr int kQPart = kPanels * kPanelQ;
  static constexpr int kKVPart = kPanels * kPanelKV;
  static constexpr int kQBytes = 3 * kQPart;
  static constexpr int kTileBytes = 3 * kKVPart;
  static constexpr int kBarriers = 2 + 4 * kStages;
  static constexpr int kBarOffset = kQBytes + 2 * kStages * kTileBytes;
  static constexpr int kSmem = kBarOffset + 8 * kBarriers + 1024;
  static constexpr int kProducerRegs = 104, kConsumerRegs = 200;  // 128 * (168 - 104) = 256 * (200 - 168)
  static_assert(kBlockM * (D / 8) % 128 == 0 && kBlockN * (D / 8) % 128 == 0, "whole chunks a producer thread");
  static_assert(kSmem <= 232448, "a block's shared memory");
};

// The arguments of fa_fwd_f32_narrow. q, k and v are fp32 (B, T, H, D) read in place, rows
// 16-byte aligned; sequence s is batch s / H, head s % H.
struct NarrowArgs {
  const float* x[3];         // q, k, v
  long long stride[3][3];    // their batch, token and head strides, in elements
  float* o;                  // contiguous fp32 (B, Tq, H, D)
  float* lse;                // contiguous fp32 (B, H, Tq), or null
  int Tq, Tk, H, n_seq;      // n_seq = B * H
  int n_work, seqs;          // work tiles; sequences a tile (packed) or 1
  int lq, lk;                // packed: log2 of the rows and of the keys a sequence takes in a tile
  int m_blocks;              // streaming: 128-row blocks a sequence
  float scale_log2;
};

__device__ __forceinline__ void st_shared_v4(uint32_t addr, const uint4& v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// Make this thread's shared-memory stores visible to the async proxy (wgmma) before it
// arrives on a full barrier.
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// One producer thread's chunks kU0 .. kU0 + kCount - 1 of a tile of kRows rows, loaded in
// one go, then split: its chunk u is the tile's chunk i = 128 u + tid, 8 fp32 columns (row
// i / (D / 8), columns 8 (i % (D / 8)) ..).
template <int D, int kRows, int kU0 = 0, int kCount = kRows * (D / 8) / 128>
struct TileChunks {
  float4 a[kCount], b[kCount];

  // Load each chunk from row `src(r)` (null: zeros), through the read-only path.
  template <class Src>
  __device__ __forceinline__ void load(Src src, int tid) {
#pragma unroll
    for (int u = 0; u < kCount; ++u) {
      const int i = (kU0 + u) * 128 + tid, r = i / (D / 8), c = i % (D / 8);
      const float* row = src(r);
      if (row != nullptr) {
        a[u] = __ldg(reinterpret_cast<const float4*>(row + 8 * c));
        b[u] = __ldg(reinterpret_cast<const float4*>(row + 8 * c + 4));
      } else {
        a[u] = b[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  }

  // Split each chunk into its hi, mid and lo parts and store them at `dst`: part p at
  // dst + p * kPart, panel j (columns 16j ..) at + j * kPanel, row r's 16-byte chunk c at
  // + 32 r + 16 ((c ^ (r >> 2)) & 1) (the 32-byte swizzle of sw32_desc).
  __device__ __forceinline__ void store(uint32_t dst, int tid) const {
    constexpr int kPanel = kRows * 32, kPart = (D / 16) * kPanel;
#pragma unroll
    for (int u = 0; u < kCount; ++u) {
      const int i = (kU0 + u) * 128 + tid, r = i / (D / 8), c = i % (D / 8);
      uint4 hi, mid, lo;
      split3(a[u].x, a[u].y, hi.x, mid.x, lo.x);
      split3(a[u].z, a[u].w, hi.y, mid.y, lo.y);
      split3(b[u].x, b[u].y, hi.z, mid.z, lo.z);
      split3(b[u].z, b[u].w, hi.w, mid.w, lo.w);
      const uint32_t off = (c >> 1) * kPanel + r * 32 + ((((c & 1) ^ (r >> 2)) & 1) << 4);
      st_shared_v4(dst + off, hi);
      st_shared_v4(dst + kPart + off, mid);
      st_shared_v4(dst + 2 * kPart + off, lo);
    }
  }
};

// The fp32 forward at D = 32 and 48 (lse-free, and at D = 32 also with lse) on fp32 q, k
// and v read in place: fa_fwd_f32's schedule and six-pass products, with the split in the
// kernel. Warpgroup 0 (the producer, all 128 threads) loads each tile's fp32 rows with
// 16-byte loads, splits them into hi, mid and lo (split3) and stores the parts into shared
// memory in the layout the wgmma descriptors read, then fences them for the async proxy and
// arrives on the tile's full barrier (128 arrivals). No part reaches device memory. The
// consumers run as in fa_fwd_f32 on 16-column panels: S = Q K^T over D / 16 k-steps (when
// streaming, from Q's fragments loaded into registers once a work tile, which frees the Q
// tile for the next one at once), P V as three products a 16-key step (issue_pv). A packed
// tile has one key tile: O is its P V.
template <int D, bool kLse, bool kPacked>
__global__ void __launch_bounds__(FwdF32NarrowPlan<D, kPacked>::kThreads, 1)
    fa_fwd_f32_narrow(const __grid_constant__ NarrowArgs a) {
  using P = FwdF32NarrowPlan<D, kPacked>;
  constexpr int kBlockN = P::kBlockN, kStages = P::kStages, kF = kBlockN / 16;
  extern __shared__ __align__(1024) unsigned char fwd_smem[];
  const uint32_t base = (smem_u32(fwd_smem) + 1023) & ~1023u;
  const uint32_t sQ = base, sK = base + P::kQBytes, sV = sK + kStages * P::kTileBytes;
  const uint32_t full_q = base + P::kBarOffset, empty_q = full_q + 8;
  auto full_k = [&](int s) { return full_q + 8 * (2 + s); };
  auto empty_k = [&](int s) { return full_q + 8 * (2 + kStages + s); };
  auto full_v = [&](int s) { return full_q + 8 * (2 + 2 * kStages + s); };
  auto empty_v = [&](int s) { return full_q + 8 * (2 + 3 * kStages + s); };

  const int n_tiles = kPacked ? 1 : (a.Tk + kBlockN - 1) / kBlockN;
  const int wg = threadIdx.x / 128;
  // Work tile w: packed, sequences w * seqs ..; streaming, query rows 128 (w % m_blocks) ..
  // of sequence w / m_blocks.
  auto first_seq = [&](int w) { return kPacked ? w * a.seqs : w / a.m_blocks; };
  auto first_row = [&](int w) { return kPacked ? 0 : (w % a.m_blocks) * P::kBlockM; };

  if (threadIdx.x == 0) {
    mbar_init(full_q, 128);  // every producer thread arrives after its stores
    mbar_init(empty_q, 4 * P::kConsumers);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k(s), 128);
      mbar_init(full_v(s), 128);
      mbar_init(empty_k(s), 4 * P::kConsumers);
      mbar_init(empty_v(s), 4 * P::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    regs_dealloc<P::kProducerRegs>();
    const int tid = threadIdx.x;
    // Row r of a tile of operand `which` (0 q, 1 k, 2 v): packed, token r % 2^shift of
    // sequence seq0 + r / 2^shift; streaming, token t0 + r of sequence seq0. Null past the
    // operand's length or the last sequence: the tile row is zeros.
    auto row_of = [&](int which, int seq0, int t0, int shift, int T) {
      if constexpr (kPacked) {
        return [=, &a](int r) -> const float* {
          const int seq = seq0 + (r >> shift), tok = r & ((1 << shift) - 1);
          if (seq >= a.n_seq || tok >= T) return nullptr;
          const int b = seq / a.H, h = seq - b * a.H;
          return a.x[which] + b * a.stride[which][0] + tok * a.stride[which][1] + h * a.stride[which][2];
        };
      } else {  // the tile's one sequence: its first row's address and the row stride, once
        const int b = seq0 / a.H, h = seq0 - b * a.H;
        const float* base = a.x[which] + b * a.stride[which][0] + h * a.stride[which][2];
        const long long st = a.stride[which][1];
        return [=](int r) -> const float* { return t0 + r < T ? base + (t0 + r) * st : nullptr; };
      }
    };
    // Store a loaded tile at `dst`, the i-th of its ring (Q's: i = round, one stage), once
    // the consumers have released that stage; then release it to them.
    auto put = [&](const auto& chunks, uint32_t dst, uint32_t full, uint32_t empty, int i, int stages) {
      mbar_wait(empty, ((i / stages) & 1) ^ 1);
      chunks.store(dst, tid);
      fence_proxy_async();
      mbar_arrive(full);
    };
    int it = 0;  // K (and V) tiles filled before this work tile
    for (int w = blockIdx.x, round = 0; w < a.n_work; w += gridDim.x, ++round, it += n_tiles) {
      const int seq0 = first_seq(w), m0 = first_row(w);
      if constexpr (kPacked) {  // a packed tile's whole Q at once (the tile's latency counts)
        TileChunks<D, P::kBlockM> q;
        q.load(row_of(0, seq0, m0, a.lq, a.Tq), tid);
        put(q, sQ, full_q, empty_q, round, 1);
      } else {  // a streamed one's in two halves of D / 16 chunks a thread: fewer registers
        constexpr int kHalf = D / 16;
        const auto q_row = row_of(0, seq0, m0, a.lq, a.Tq);
        TileChunks<D, P::kBlockM, 0, kHalf> q0;
        q0.load(q_row, tid);
        mbar_wait(empty_q, (round & 1) ^ 1);
        q0.store(sQ, tid);
        TileChunks<D, P::kBlockM, kHalf, kHalf> q1;
        q1.load(q_row, tid);
        q1.store(sQ, tid);
        fence_proxy_async();
        mbar_arrive(full_q);
      }
      if constexpr (kPacked) {  // one key tile: K, then V
        const int s = it % kStages;
        TileChunks<D, kBlockN> kv;
        kv.load(row_of(1, seq0, 0, a.lk, a.Tk), tid);
        put(kv, sK + s * P::kTileBytes, full_k(s), empty_k(s), it, kStages);
        kv.load(row_of(2, seq0, 0, a.lk, a.Tk), tid);
        put(kv, sV + s * P::kTileBytes, full_v(s), empty_v(s), it, kStages);
      } else if constexpr (D == 32) {
        // K is consumed one step ahead of V: fill K_0, then K_j with V_{j-1} (both loaded
        // before either is stored: one tile at a time ran 1.08x as long at the MAE
        // decoder's shape), then the last V.
        for (int j = 0; j <= n_tiles; ++j) {
          TileChunks<D, kBlockN> kc, vc;
          if (j < n_tiles) kc.load(row_of(1, seq0, j * kBlockN, 0, a.Tk), tid);
          if (j > 0) vc.load(row_of(2, seq0, (j - 1) * kBlockN, 0, a.Tk), tid);
          if (j < n_tiles) {
            const int s = (it + j) % kStages;
            put(kc, sK + s * P::kTileBytes, full_k(s), empty_k(s), it + j, kStages);
          }
          if (j > 0) {
            const int s = (it + j - 1) % kStages;
            put(vc, sV + s * P::kTileBytes, full_v(s), empty_v(s), it + j - 1, kStages);
          }
        }
      } else {  // the same order, one tile loaded at a time: at D = 48 the joint loads spilled
        for (int j = 0; j <= n_tiles; ++j) {
          if (j < n_tiles) {
            const int s = (it + j) % kStages;
            TileChunks<D, kBlockN> kc;
            kc.load(row_of(1, seq0, j * kBlockN, 0, a.Tk), tid);
            put(kc, sK + s * P::kTileBytes, full_k(s), empty_k(s), it + j, kStages);
          }
          if (j > 0) {
            const int s = (it + j - 1) % kStages;
            TileChunks<D, kBlockN> vc;
            vc.load(row_of(2, seq0, (j - 1) * kBlockN, 0, a.Tk), tid);
            put(vc, sV + s * P::kTileBytes, full_v(s), empty_v(s), it + j - 1, kStages);
          }
        }
      }
    }
  } else {
    regs_alloc<P::kConsumerRegs>();
    const int c = wg - 1;  // consumer: query rows 64c .. 64c + 63 of each work tile
    const int tw = threadIdx.x % 128, warp = tw / 32, lane = tw % 32;
    const int g = lane >> 2, t = lane & 3;
    const int row0 = c * 64 + warp * 16 + g;  // this thread's rows of the tile: row0 and row0 + 8
    const uint32_t q_rows = sQ + c * 64 * 32;

    float acc[D / 2];          // O, 64 x D (streaming; a packed tile's O is its P V sum)
    float tile[3 * D / 2];     // a key tile's P V as three column blocks (issue_pv), summed after
    float s[kBlockN / 2];      // S, then P, 64 x kBlockN
    uint32_t pa[3 * kF][4];    // P split: hi, mid and lo A fragments of P V
    float m_run[2], l_run[2], alpha[2];
#pragma unroll
    for (int i = 0; i < kBlockN / 2; ++i) s[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 3 * D / 2; ++i) tile[i] = 0.f;

    auto issue_qk = [&](int stage) {  // S = Q K^T, six passes of D / 16 k-steps
      const uint64_t qd = sw32_desc(q_rows, 16), kd = sw32_desc(sK + stage * P::kTileBytes, 16);
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int pass = 0; pass < kPasses; ++pass)
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          Wgmma<kBlockN>::ss(s, desc_at(qd, pass_a(pass) * P::kQPart + kk * P::kPanelQ),
                             desc_at(kd, pass_b(pass) * P::kKVPart + kk * P::kPanelKV), pass > 0 || kk > 0);
      wgmma_commit();
    };
    // dst = P V, the six products as three a 16-key step: P_hi [V_hi V_mid V_lo] at N = 3D,
    // P_mid [V_hi V_mid] at 2D into dst's first 2D columns, P_lo V_hi at D into its first D
    // (the parts lie one after another, so the panels of [V_hi V_mid V_lo] are equally
    // spaced: the descriptor's LBO). Column blocks: hi.hi + mid.hi + lo.hi, hi.mid + mid.mid,
    // hi.lo; their sum is P V.
    auto issue_pv = [&](int stage, float (&dst)[3 * D / 2]) {
      const uint64_t vd = sw32_desc(sV + stage * P::kTileBytes, P::kPanelKV);
      fence_regs(dst);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kF; ++kk) {  // 16 keys a k-step: 512 bytes of each panel
        const uint64_t v = desc_at(vd, kk * 512);
        Wgmma<3 * D>::rs(dst, pa[kk], v, kk > 0);
        Wgmma<2 * D>::rs(reinterpret_cast<float (&)[D]>(dst), pa[kF + kk], v, 1);
        Wgmma<D>::rs(reinterpret_cast<float (&)[D / 2]>(dst), pa[2 * kF + kk], v, 1);
      }
      wgmma_commit();
    };
    auto tile_sum = [&](int i) { return (tile[i + D] + tile[i + D / 2]) + tile[i]; };  // P V, element i
    auto softmax = [&](int j) {
      if constexpr (kPacked) {
        // Row r sees the keys of its own sequence, (r >> lq), that are < Tk. Rows past the
        // tile's sequences (computed on zeros, never stored) see the last one's.
        const int kmask = (1 << a.lk) - 1;
        int seq[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) seq[r] = min((row0 + 8 * r) >> a.lq, a.seqs - 1);
#pragma unroll
        for (int jj = 0; jj < kBlockN / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * jj + 2 * t + (e & 1);
            if ((col >> a.lk) != seq[e >> 1] || (col & kmask) >= a.Tk) s[4 * jj + e] = -INFINITY;
          }
        online_softmax<kBlockN>(s, m_run, l_run, alpha, 0, kBlockN, t, a.scale_log2);
      } else {
        online_softmax<kBlockN>(s, m_run, l_run, alpha, j * kBlockN, a.Tk, t, a.scale_log2);
      }
    };
    auto rescale = [&]() {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
    };
    auto add_tile = [&]() {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] += tile_sum(i);
    };
    auto release = [&](uint32_t empty) {
      if (lane == 0) mbar_arrive(empty);
    };
    int it = 0;
    for (int w = blockIdx.x, round = 0; w < a.n_work; w += gridDim.x, ++round, it += n_tiles) {
      if constexpr (!kPacked) {  // a packed tile's P V overwrites O
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      }
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
      softmax(0);
      split_fragments<kBlockN>(pa, s);

      if constexpr (!kPacked) {
        // Tile j: issue S_j and P_{j-1} V_{j-1}; the softmax of S_j runs under P V.
        for (int j = 1; j < n_tiles; ++j) {
          const int sj = (it + j) % kStages, sp = (it + j - 1) % kStages;
          mbar_wait(full_k(sj), ((it + j) / kStages) & 1);
          mbar_wait(full_v(sp), ((it + j - 1) / kStages) & 1);
          issue_qk(sj);
          issue_pv(sp, tile);
          rescale();
          wgmma_wait<1>();
          fence_regs(s);
          release(empty_k(sj));
          if (j == n_tiles - 1) release(empty_q);
          softmax(j);
          wgmma_wait<0>();
          fence_regs(tile);
          fence_regs(pa);
          release(empty_v(sp));
          add_tile();
          split_fragments<kBlockN>(pa, s);
        }
      }

      // The last tile's P V: packed, O itself (the only tile); streaming, a fresh sum added
      // to the rescaled O.
      const int sl = (it + n_tiles - 1) % kStages;
      mbar_wait(full_v(sl), ((it + n_tiles - 1) / kStages) & 1);
      issue_pv(sl, tile);
      if constexpr (kPacked) {  // the only tile: O is its sum (read from it at the store)
        wgmma_wait<0>();
        fence_regs(tile);
        release(empty_v(sl));
      } else {
        rescale();
        wgmma_wait<0>();
        fence_regs(tile);
        release(empty_v(sl));
        add_tile();
      }

      const int seq0 = first_seq(w), m0 = first_row(w);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float l = l_run[r];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        const float inv = 1.f / l;
        const int row = row0 + 8 * r;
        const int seq = kPacked ? seq0 + (row >> a.lq) : seq0;
        const int tok = kPacked ? row & ((1 << a.lq) - 1) : m0 + row;
        if ((kPacked && (row >> a.lq) >= a.seqs) || seq >= a.n_seq || tok >= a.Tq) continue;
        const int b = seq / a.H, h = seq - b * a.H;
        if constexpr (kLse) {
          if (t == 0) a.lse[(static_cast<long long>(b) * a.H + h) * a.Tq + tok] = (m_run[r] + log2f(l)) * kLn2;
        }
        float* out = a.o + ((static_cast<long long>(b) * a.Tq + tok) * a.H + h) * D;
        auto o_at = [&](int i) { return kPacked ? tile_sum(i) : acc[i]; };
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<float2*>(out + 8 * j + 2 * t) =
              make_float2(o_at(4 * j + 2 * r) * inv, o_at(4 * j + 2 * r + 1) * inv);
      }
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
  CUtensorMap tq, tk, tv;
  int err = encode_map(&tq, q, maps, D, Tq, H, batches, P::kBlockM);
  if (!err) err = encode_map(&tk, k, maps + kMapLongs, D, Tk, H, batches, P::kBlockN);
  if (!err) err = encode_map(&tv, v, maps + 2 * kMapLongs, D, Tk, H, batches, P::kBlockN);
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
  return by_head_dim<64, 128>(D, B, Tq, Tk, H, run);
}

// The narrow forward's plan (ops/flash_attention.py's fwd_f32_narrow_plan is the same):
// packed when Tq and Tk are at most 64, else streaming.
struct NarrowPlan {
  int packed, seqs, rows, keys, tile_keys;  // sequences a tile; rows and keys a sequence takes; keys a tile
  long long work;                           // work tiles
};

template <int D>
NarrowPlan narrow_plan(int B, int Tq, int Tk, int H) {
  const long long n_seq = static_cast<long long>(B) * H;
  if (Tq <= 64 && Tk <= 64) {
    int tq = 1, tk = 1;
    while (tq < Tq) tq <<= 1;
    while (tk < Tk) tk <<= 1;
    const int g = 128 / std::max(tq, tk);
    return {1, g, tq, tk, FwdF32NarrowPlan<D, true>::kBlockN, (n_seq + g - 1) / g};
  }
  constexpr int kRows = FwdF32NarrowPlan<D, false>::kBlockM;
  return {0, 1, kRows, Tk, FwdF32NarrowPlan<D, false>::kBlockN, (Tq + kRows - 1) / kRows * n_seq};
}

__host__ constexpr int log2_of(int x) { return x > 1 ? 1 + log2_of(x >> 1) : 0; }

template <int D, bool kLse>
int fwd_narrow(const float* q, const float* k, const float* v, float* o, float* lse, const long long* layout,
               const int* plan, int B, int Tq, int Tk, int H, float scale_log2, cudaStream_t st) {
  // Each operand's layout: dims (D, T, H, B) and the byte strides of T, H and B (16-byte
  // multiples: every row a chunk reads is 16-byte aligned), as ops/flash_attention.py's
  // narrow_layout computes them.
  const float* xs[3] = {q, k, v};
  const int lengths[3] = {Tq, Tk, Tk};
  NarrowArgs a{};
  for (int i = 0; i < 3; ++i) {
    const long long* m = layout + 7 * i;
    if (m[0] != D || m[1] != lengths[i] || m[2] != H || m[3] != B || (m[4] | m[5] | m[6]) % 16 ||
        reinterpret_cast<uintptr_t>(xs[i]) % 16)
      return static_cast<int>(cudaErrorInvalidValue);
    a.x[i] = xs[i];
    a.stride[i][0] = m[6] / 4;  // batch, token and head strides, in elements
    a.stride[i][1] = m[4] / 4;
    a.stride[i][2] = m[5] / 4;
  }
  const NarrowPlan p = narrow_plan<D>(B, Tq, Tk, H);
  if (plan[0] != p.packed || plan[1] != p.seqs || plan[2] != p.rows || plan[3] != p.keys ||
      plan[4] != p.tile_keys || plan[5] != p.work)
    return static_cast<int>(cudaErrorInvalidValue);
  int n_work = 0, blocks = 0;
  int err = persistent_grid(p.work, n_work, blocks);
  if (err) return err;
  a.o = o;
  a.lse = lse;
  a.Tq = Tq;
  a.Tk = Tk;
  a.H = H;
  a.n_seq = B * H;
  a.n_work = n_work;
  a.seqs = p.seqs;
  a.lq = log2_of(p.rows);
  a.lk = p.packed ? log2_of(p.keys) : 0;
  a.m_blocks = (Tq + 127) / 128;
  a.scale_log2 = scale_log2;
  if (p.packed) {
    using Pl = FwdF32NarrowPlan<D, true>;
    static SmemOptIn opt_in;
    return launch(fa_fwd_f32_narrow<D, kLse, true>, opt_in, dim3(blocks), Pl::kThreads, Pl::kSmem, st, a);
  }
  using Pl = FwdF32NarrowPlan<D, false>;
  static SmemOptIn opt_in;
  return launch(fa_fwd_f32_narrow<D, kLse, false>, opt_in, dim3(blocks), Pl::kThreads, Pl::kSmem, st, a);
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
// contiguous bf16 (3, B, T, H, D); maps: their tensor maps' layout as (3B, T, H, D), boxed
// by FWD_F32_TILES' rows; D: 64 or 128. o is a contiguous fp32 (B, Tq, H, D). Returns as the
// bf16 forward.
extern "C" int flash_attention_fwd_f32(const void* q_parts, const void* k_parts, const void* v_parts, void* o,
                                       float* lse, const long long* maps, int B, int Tq, int Tk, int H, int D,
                                       float scale, void* stream) {
  return fwd_by_head_dim<true>(q_parts, k_parts, v_parts, o, lse, maps, B, Tq, Tk, H, D, scale, stream);
}

// The fp32 forward at D = 32 and 48 on fp32 q, k and v (B, T, H, D) read in place (unit
// head-dim stride; rows 16-byte aligned): fa_fwd_f32_narrow, which splits them in its own
// shared memory. layout: each operand's dims (D, T, H, B) and byte strides of T, H and B, 7
// values each (narrow_layout in ops/flash_attention.py); plan: the 6 values of
// fwd_f32_narrow_plan (packed, sequences a tile, rows and keys a sequence, keys a tile, work
// tiles), which must equal the launcher's own. lse null for the inference form (D = 48 has
// that form alone), else a contiguous fp32 (B, H, Tq); o a contiguous fp32 (B, Tq, H, D).
// Returns cudaErrorInvalidValue for arguments no instance takes, a layout that does not fit
// or a plan that differs, else the shared memory attribute call's error or
// cudaGetLastError() after the launch (0 on success).
extern "C" int flash_attention_fwd_f32_narrow(const void* q, const void* k, const void* v, void* o, float* lse,
                                              const long long* layout, const int* plan, int B, int Tq, int Tk,
                                              int H, int D, float scale, void* stream) {
  const float sl = scale * kLog2e;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto *fq = static_cast<const float*>(q), *fk = static_cast<const float*>(k),
             *fv = static_cast<const float*>(v);
  auto* fo = static_cast<float*>(o);
  return by_head_dim<32, 48>(D, B, Tq, Tk, H, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    if (lse == nullptr) return fwd_narrow<kD, false>(fq, fk, fv, fo, lse, layout, plan, B, Tq, Tk, H, sl, st);
    if constexpr (kD == 32) return fwd_narrow<32, true>(fq, fk, fv, fo, lse, layout, plan, B, Tq, Tk, H, sl, st);
    return static_cast<int>(cudaErrorInvalidValue);
  });
}

// Bytes of dynamic shared memory a block of the instance of head dim D takes (0 for
// another D): kernel 0 the bf16 forward, 1 the fp32 forward, 2 the narrow fp32 forward
// streaming, 3 packed. Printed beside each instance's registers in the build line.
extern "C" int flash_attention_fwd_smem(int kernel, int D) {
  switch (kernel) {
    case 0:
      return D == 64 ? FwdPlan<64>::kSmem : D == 128 ? FwdPlan<128>::kSmem : 0;
    case 1:
      return D == 64 ? FwdF32Plan<64>::kSmem : D == 128 ? FwdF32Plan<128>::kSmem : 0;
    case 2:
      return D == 32 ? FwdF32NarrowPlan<32, false>::kSmem : D == 48 ? FwdF32NarrowPlan<48, false>::kSmem : 0;
    case 3:
      return D == 32 ? FwdF32NarrowPlan<32, true>::kSmem : D == 48 ? FwdF32NarrowPlan<48, true>::kSmem : 0;
    default:
      return 0;
  }
}
