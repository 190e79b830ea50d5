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
// every length: a max-stabilised online softmax in fp32 registers over K/V tiles of 64
// tokens.
//
// Layout. q is (B, Tq, H, D) and k, v are (B, Tk, H, D), read in place through their
// batch, token and head strides (the last stride is 1), so the views that Attention
// cuts out of its fused qkv projection need no transpose or copy. o is written as a
// contiguous (B, Tq, H, D) tensor. The kernel allocates nothing and does not
// synchronise; it runs on the stream it is given.
//
// Schedule. One block handles 64 query rows of one (batch, head): grid
// (ceil(Tq / 64), H, B). K/V tiles of 64 tokens are staged in shared memory with
// cp.async, double-buffered, in a 16-byte-chunk XOR swizzle that keeps every
// fragment load free of bank conflicts. The ragged last K tile is zero-filled and
// its columns masked to -inf; ragged query rows are computed on zeros and not stored.
//
// Instances, templated on the head dim D and instantiated for D = 64 and D = 128:
//   fa_fwd_bf16<D>: bf16 inputs, tensor cores via mma.sync m16n8k16 (bf16 -> fp32),
//     4 warps of 16 query rows each. This is the main-path instance.
//   fa_fwd_f32<D>: fp32 inputs, SIMT fp32 FMA, one thread per query row at D = 64 and
//     two at D = 128 (a whole row's q and o would take 256 registers; the two halves'
//     dot products are summed with one shuffle). It serves the fp32 model
//     (compute_dtype="float32"), which K3/K4 served on the TPU.
// Shared memory. The bf16 instance's tiles take (64 + 4 * 64) * D * 2 bytes (40 KB at
// D = 64, 80 KB at D = 128: the q tile and two K and two V buffers), the fp32 one's
// 2 * 64 * D * 4 (32 KB, 64 KB). Up to 48 KB they are static shared memory; above, the
// D = 128 instances take dynamic shared memory, and the launcher raises the instance's
// limit once per device (cudaFuncSetAttribute) before its first launch there (an H100
// block may take up to 227 KB).
// Each comes in two forms, chosen by the template flag kLse. Without it (inference) the
// kernel writes o alone. With it (training) the kernel also writes the softmax
// normaliser lse = log(sum_j exp(s_ij)) of the scaled logits s = q.k * scale, fp32
// (B, H, Tq), natural log: the residual the backward kernels
// (csrc/flash_attention_bwd.cu) recompute P from. That form replaces the TPU's
// lse-writing kernels K4 _fwd_kernel_single_lse (:118, launched :942), K6's forward
// _pair_stream_kernel_lse (:600, launched :674), K7 _fwd_stream_aug_lse (:168,
// launched :967) and K8's _fwd_kernel_lse (:218, launched :989). The running max is
// kept in base-2 units; it is turned into a natural log once, at the store.
//
// Bound on this card. At the main-path shapes (encoder 8x1370x16x64, frame
// 8x1369x12x64, global 1x10953x12x64; with 128-wide trunk heads 8x1369x6x128 and
// 1x10953x6x128) the work is about 4*T^2*D*H flop per call against 4*T*H*D*2 bytes
// moved, hundreds of flop per byte, so the bf16 instance is bound by tensor-core
// throughput (989 dense bf16 TFLOP/s on an H100 SXM). mma.sync reaches only part of
// that rate; wgmma, TMA and warp specialisation are later work.

#include "flash_attention_common.cuh"

namespace {

// Tiles of the bf16 instance: kBlockM query rows a block, 16 a warp, over K/V tiles of
// kBlockN keys. The same at D = 64 and D = 128; its shared memory grows with D.
template <int D>
struct FwdTiles {
  static constexpr int kBlockM = 64, kBlockN = 64;
  static constexpr int kThreads = kBlockM / 16 * 32;
  static constexpr int kSmem = (kBlockM + 4 * kBlockN) * D * 2;  // sQ, 2 sK, 2 sV (bf16)
};

template <int D, bool kLse>
__global__ void __launch_bounds__(FwdTiles<D>::kThreads)
    fa_fwd_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                float* __restrict__ lse, int Tq, int Tk, int H, long long sqb, long long sqt,
                long long sqh, long long skb, long long skt, long long skh, long long svb,
                long long svt, long long svh, float scale_log2) {
  static_assert(D % 64 == 0 && D <= 128, "swizzle and register plan assume D in {64, 128}");
  using Tl = FwdTiles<D>;
  constexpr int kBlockM = Tl::kBlockM, kBlockN = Tl::kBlockN, kThreads = Tl::kThreads;
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(block_smem<Tl::kSmem>());
  __nv_bfloat16* sK = sQ + kBlockM * D;      // two K tiles
  __nv_bfloat16* sV = sK + 2 * kBlockN * D;  // two V tiles

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group and column pair
  const int m0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y, b = blockIdx.z;
  const __nv_bfloat16* qbase = q + b * sqb + h * sqh;
  const __nv_bfloat16* kbase = k + b * skb + h * skh;
  const __nv_bfloat16* vbase = v + b * svb + h * svh;
  const int n_tiles = (Tk + kBlockN - 1) / kBlockN;

  load_tile<D, kBlockM, kThreads>(sQ, qbase, sqt, m0, Tq, tid);
  load_tile<D, kBlockN, kThreads>(sK, kbase, skt, 0, Tk, tid);
  load_tile<D, kBlockN, kThreads>(sV, vbase, svt, 0, Tk, tid);
  cp_async_commit();

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // running max of scaled log2 logits, rows g, g+8
  float l_run[2] = {0.f, 0.f};              // this thread's partial row sums
  uint32_t qf[D / 16][4];

  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_tiles) {
      load_tile<D, kBlockN, kThreads>(sK + (buf ^ 1) * kBlockN * D, kbase, skt, (it + 1) * kBlockN, Tk,
                                      tid);
      load_tile<D, kBlockN, kThreads>(sV + (buf ^ 1) * kBlockN * D, vbase, svt, (it + 1) * kBlockN, Tk,
                                      tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    if (it == 0) {
      const int r0 = warp * 16;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk * 16 + 2 * t;
        qf[kk][0] = lds32<D>(sQ, r0 + g, c);
        qf[kk][1] = lds32<D>(sQ, r0 + g + 8, c);
        qf[kk][2] = lds32<D>(sQ, r0 + g, c + 8);
        qf[kk][3] = lds32<D>(sQ, r0 + g + 8, c + 8);
      }
    }
    const __nv_bfloat16* Ks = sK + buf * kBlockN * D;
    const __nv_bfloat16* Vs = sV + buf * kBlockN * D;

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys.
    float s[kBlockN / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t b0 = lds32<D>(Ks, 8 * j + g, kk * 16 + 2 * t);
        const uint32_t b1 = lds32<D>(Ks, 8 * j + g, kk * 16 + 2 * t + 8);
        mma_16816(s[j], qf[kk], b0, b1);
      }
    }
    const int kv0 = it * kBlockN;
    if (kv0 + kBlockN > Tk) {
#pragma unroll
      for (int j = 0; j < kBlockN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (kv0 + 8 * j + 2 * t + (e & 1) >= Tk) s[j][e] = -INFINITY;
    }

    // Online softmax. Every tile holds at least one key < Tk, so the new max is finite.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r] * scale_log2);
      alpha[r] = ex2(m_run[r] - m_new);  // 0 on the first tile
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
      s[j][0] = ex2(fmaf(s[j][0], scale_log2, -m_run[0]));
      s[j][1] = ex2(fmaf(s[j][1], scale_log2, -m_run[0]));
      s[j][2] = ex2(fmaf(s[j][2], scale_log2, -m_run[1]));
      s[j][3] = ex2(fmaf(s[j][3], scale_log2, -m_run[1]));
      l_run[0] += s[j][0] + s[j][1];
      l_run[1] += s[j][2] + s[j][3];
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // O += P V: the S accumulators of two key groups of 8 form one A fragment.
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const int key = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int jj = 0; jj < D / 16; ++jj) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, Vs + swz<D>(key, jj * 16 + (lane >> 4) * 8));
        mma_16816(acc[2 * jj], pa, vb[0], vb[1]);
        mma_16816(acc[2 * jj + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // the next iteration's prefetch overwrites this buffer
  }

  float inv[2];
  const int row0 = m0 + warp * 16 + g;
  const int row1 = row0 + 8;
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
      *reinterpret_cast<uint32_t*>(o0 + col) = pack_bf16(acc[j][0] * inv[0], acc[j][1] * inv[0]);
    if (row1 < Tq)
      *reinterpret_cast<uint32_t*>(o1 + col) = pack_bf16(acc[j][2] * inv[1], acc[j][3] * inv[1]);
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

// The launchers of one head dim; each instance raises its shared memory limit once per
// device. lse is null for the inference form.
struct FwdArgs {
  const void *q, *k, *v;
  void* o;
  float* lse;
  int B, Tq, Tk, H;
  long long sqb, sqt, sqh, skb, skt, skh, svb, svt, svh;
  float scale_log2;
  cudaStream_t st;
};

#define FA_FWD_KERNEL_ARGS(T)                                                                \
  static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),        \
      static_cast<T*>(a.o), a.lse, a.Tq, a.Tk, a.H, a.sqb, a.sqt, a.sqh, a.skb, a.skt, a.skh, \
      a.svb, a.svt, a.svh, a.scale_log2

template <int D, bool kLse>
int fwd_bf16(const FwdArgs& a) {
  using Tl = FwdTiles<D>;
  static SmemOptIn opt_in;
  return launch(fa_fwd_bf16<D, kLse>, opt_in, dim3((a.Tq + Tl::kBlockM - 1) / Tl::kBlockM, a.H, a.B),
                Tl::kThreads, Tl::kSmem, a.st, FA_FWD_KERNEL_ARGS(__nv_bfloat16));
}

template <int D, bool kLse>
int fwd_f32(const FwdArgs& a) {
  using Tl = FwdF32Tiles<D>;
  static SmemOptIn opt_in;
  return launch(fa_fwd_f32<D, kLse>, opt_in, dim3((a.Tq + Tl::kBlockM - 1) / Tl::kBlockM, a.H, a.B),
                Tl::kThreads, Tl::kSmem, a.st, FA_FWD_KERNEL_ARGS(float));
}

#undef FA_FWD_KERNEL_ARGS

template <int D>
int fwd(int dtype, const FwdArgs& a) {
  if (dtype == 0) return a.lse == nullptr ? fwd_bf16<D, false>(a) : fwd_bf16<D, true>(a);
  if (dtype == 1) return a.lse == nullptr ? fwd_f32<D, false>(a) : fwd_f32<D, true>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = bf16, 1 = fp32; D: 64 or 128 (the instantiated head dims). Strides are in
// elements. lse is null for the inference form, else a contiguous fp32 (B, H, Tq)
// buffer. Returns cudaErrorInvalidValue for arguments no instance takes, else the
// shared memory attribute call's error or cudaGetLastError() after the launch (0 on
// success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   float* lse, int dtype, int B, int Tq, int Tk, int H, int D,
                                   long long sqb, long long sqt, long long sqh, long long skb,
                                   long long skt, long long skh, long long svb, long long svt,
                                   long long svh, float scale, void* stream) {
  const FwdArgs a{q,   k,   v,   o,   lse, B,   Tq,  Tk,  H,   sqb, sqt,
                  sqh, skb, skt, skh, svb, svt, svh, scale * kLog2e,
                  static_cast<cudaStream_t>(stream)};
  return by_head_dim(D, B, Tq, Tk, H, [&] { return fwd<64>(dtype, a); },
                     [&] { return fwd<128>(dtype, a); });
}
