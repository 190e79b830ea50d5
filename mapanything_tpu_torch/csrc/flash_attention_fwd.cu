// Non-causal flash-attention forward for Hopper (sm_90a): o = softmax(q k^T * scale) v.
//
// Replaces three TPU Pallas kernels of mapanything_tpu/ops/flash_attention.py:
//   K1 _packed_single_kernel (:395, launched by _packed_forward :443): encoder and
//      trunk frame layers, <= 2048 padded tokens;
//   K2 _pair_stream_kernel (:516, launched by _run_pair :646): trunk global layers,
//      2048 < padded tokens <= 12288;
//   K3 _fwd_stream_aug (:164, body :126, launched in _core_fwd :967): longer
//      sequences, odd head counts and fp32.
// Those three differ only in how they fit the TPU's VMEM and 128-wide MXU (head-pair
// packing, augmented ones/bias columns, constant-shift base-2 softmax). Here one
// streaming kernel serves every length: a max-stabilised online softmax in fp32
// registers over K/V tiles of 64 tokens.
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
// Instances (both templated on the head dim D; only D = 64 is instantiated):
//   fa_fwd_bf16<64>: bf16 inputs, tensor cores via mma.sync m16n8k16 (bf16 -> fp32),
//     4 warps of 16 query rows each. This is the main-path instance.
//   fa_fwd_f32<64>: fp32 inputs, SIMT fp32 FMA, one thread per query row. It serves
//     the fp32 model (compute_dtype="float32"), which K3/K4 served on the TPU.
// Each comes in two forms, chosen by the template flag kLse. Without it (inference) the
// kernel writes o alone, the same code as before the lse output was added. With it (training) the kernel also
// writes the softmax normaliser lse = log(sum_j exp(s_ij)) of the scaled logits
// s = q.k * scale, fp32 (B, H, Tq), natural log: the residual the backward kernels
// (csrc/flash_attention_bwd.cu) recompute P from. That form replaces the TPU's
// lse-writing kernels K4 _fwd_kernel_single_lse (:118, launched :942), K6's forward
// _pair_stream_kernel_lse (:600, launched :674) and K7 _fwd_stream_aug_lse (:168,
// launched :967). The running max is kept in base-2 units; it is turned into a
// natural log once, at the store.
//
// Bound on this card. At the main-path shapes (encoder 8x1370x16x64, frame
// 8x1369x12x64, global 1x10953x12x64) the work is about 4*T^2*D*H flop per call
// against 4*T*H*D*2 bytes moved, hundreds of flop per byte, so the bf16 instance is
// bound by tensor-core throughput (989 dense bf16 TFLOP/s on an H100 SXM). mma.sync
// reaches only part of that rate; wgmma, TMA and warp specialisation are later work.

#include "flash_attention_common.cuh"

namespace {

template <int D, bool kLse>
__global__ void __launch_bounds__(kWarps * 32)
    fa_fwd_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                float* __restrict__ lse, int Tq, int Tk, int H, long long sqb, long long sqt,
                long long sqh, long long skb, long long skt, long long skh, long long svb,
                long long svt, long long svh, float scale_log2) {
  static_assert(D % 64 == 0 && D <= 128, "swizzle and register plan assume D in {64, 128}");
  __shared__ __align__(128) __nv_bfloat16 sQ[kBlockM * D];
  __shared__ __align__(128) __nv_bfloat16 sK[2][kBlockN * D];
  __shared__ __align__(128) __nv_bfloat16 sV[2][kBlockN * D];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group and column pair
  const int m0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y, b = blockIdx.z;
  const __nv_bfloat16* qbase = q + b * sqb + h * sqh;
  const __nv_bfloat16* kbase = k + b * skb + h * skh;
  const __nv_bfloat16* vbase = v + b * svb + h * svh;
  const int n_tiles = (Tk + kBlockN - 1) / kBlockN;

  load_tile<D, kBlockM>(sQ, qbase, sqt, m0, Tq, tid);
  load_tile<D, kBlockN>(sK[0], kbase, skt, 0, Tk, tid);
  load_tile<D, kBlockN>(sV[0], vbase, svt, 0, Tk, tid);
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
      load_tile<D, kBlockN>(sK[buf ^ 1], kbase, skt, (it + 1) * kBlockN, Tk, tid);
      load_tile<D, kBlockN>(sV[buf ^ 1], vbase, svt, (it + 1) * kBlockN, Tk, tid);
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
    const __nv_bfloat16* Ks = sK[buf];
    const __nv_bfloat16* Vs = sV[buf];

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

template <int D, bool kLse>
__global__ void __launch_bounds__(kBlockM)
    fa_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
               int Tq, int Tk, int H,
               long long sqb, long long sqt, long long sqh, long long skb, long long skt,
               long long skh, long long svb, long long svt, long long svh, float scale_log2) {
  __shared__ __align__(16) float sK[kBlockN][D];
  __shared__ __align__(16) float sV[kBlockN][D];

  const int tid = threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int row = blockIdx.x * kBlockM + tid;
  const bool live = row < Tq;
  const float* qp = q + b * sqb + h * sqh + static_cast<long long>(live ? row : 0) * sqt;
  const float* kbase = k + b * skb + h * skh;
  const float* vbase = v + b * svb + h * svh;

  float qr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(qp + d);
    qr[d] = x.x * scale_log2;
    qr[d + 1] = x.y * scale_log2;
    qr[d + 2] = x.z * scale_log2;
    qr[d + 3] = x.w * scale_log2;
    acc[d] = acc[d + 1] = acc[d + 2] = acc[d + 3] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int kv0 = 0; kv0 < Tk; kv0 += kBlockN) {
    const int r = kv0 + tid;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    const float* kr = kbase + static_cast<long long>(r < Tk ? r : 0) * skt;
    const float* vr = vbase + static_cast<long long>(r < Tk ? r : 0) * svt;
#pragma unroll
    for (int d = 0; d < D; d += 4) {
      *reinterpret_cast<float4*>(&sK[tid][d]) =
          r < Tk ? *reinterpret_cast<const float4*>(kr + d) : zero;
      *reinterpret_cast<float4*>(&sV[tid][d]) =
          r < Tk ? *reinterpret_cast<const float4*>(vr + d) : zero;
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
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], sK[j0 + jj][d], dot);
        s[jj] = (j0 + jj < n) ? dot : -INFINITY;
        mx = fmaxf(mx, s[jj]);
      }
      const float alpha = ex2(m - mx);  // 0 on the first step
      l *= alpha;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
      for (int jj = 0; jj < kF32SubTile; ++jj) {
        const float p = ex2(s[jj] - mx);
        l += p;
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] = fmaf(p, sV[j0 + jj][d], acc[d]);
      }
      m = mx;
    }
    __syncthreads();
  }

  if (live) {
    if constexpr (kLse) lse[(static_cast<long long>(b) * H + h) * Tq + row] = (m + log2f(l)) * kLn2;
    const float inv = 1.f / l;
    float* op = o + ((static_cast<long long>(b) * Tq + row) * H + h) * D;
#pragma unroll
    for (int d = 0; d < D; d += 4)
      *reinterpret_cast<float4*>(op + d) =
          make_float4(acc[d] * inv, acc[d + 1] * inv, acc[d + 2] * inv, acc[d + 3] * inv);
  }
}

}  // namespace

// dtype: 0 = bf16, 1 = fp32. Strides are in elements. lse is null for the inference
// form, else a contiguous fp32 (B, H, Tq) buffer. Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   float* lse, int dtype, int B, int Tq, int Tk, int H, int D,
                                   long long sqb, long long sqt, long long sqh, long long skb,
                                   long long skt, long long skh, long long svb, long long svt,
                                   long long svh, float scale, void* stream) {
  if (D != 64 || B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((Tq + kBlockM - 1) / kBlockM, H, B);
  const float scale_log2 = scale * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const auto* qp = static_cast<const __nv_bfloat16*>(q);
    const auto* kp = static_cast<const __nv_bfloat16*>(k);
    const auto* vp = static_cast<const __nv_bfloat16*>(v);
    auto* op = static_cast<__nv_bfloat16*>(o);
    if (lse == nullptr)
      fa_fwd_bf16<64, false><<<grid, kWarps * 32, 0, st>>>(qp, kp, vp, op, lse, Tq, Tk, H, sqb, sqt,
                                                           sqh, skb, skt, skh, svb, svt, svh, scale_log2);
    else
      fa_fwd_bf16<64, true><<<grid, kWarps * 32, 0, st>>>(qp, kp, vp, op, lse, Tq, Tk, H, sqb, sqt,
                                                          sqh, skb, skt, skh, svb, svt, svh, scale_log2);
  } else if (dtype == 1) {
    const auto* qp = static_cast<const float*>(q);
    const auto* kp = static_cast<const float*>(k);
    const auto* vp = static_cast<const float*>(v);
    auto* op = static_cast<float*>(o);
    if (lse == nullptr)
      fa_fwd_f32<64, false><<<grid, kBlockM, 0, st>>>(qp, kp, vp, op, lse, Tq, Tk, H, sqb, sqt, sqh,
                                                       skb, skt, skh, svb, svt, svh, scale_log2);
    else
      fa_fwd_f32<64, true><<<grid, kBlockM, 0, st>>>(qp, kp, vp, op, lse, Tq, Tk, H, sqb, sqt, sqh,
                                                      skb, skt, skh, svb, svt, svh, scale_log2);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
