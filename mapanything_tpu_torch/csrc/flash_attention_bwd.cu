// Non-causal flash-attention backward for Hopper (sm_90a), FlashAttention-2 split.
//
// Given q, k, v, the forward's output o, its lse residual (natural log of the scaled
// logits' normaliser, fp32 (B, H, Tq)), the output cotangent dO and
// delta = rowsum(dO * O) (fp32 (B, H, Tq), computed by the wrapper), two kernels
// recompute P = exp(q k^T * scale - lse) tile by tile and form
//   dV = P^T dO,   dP = dO V^T,   dS = P * (dP - delta),
//   dQ = dS K * scale,   dK = dS^T Q * scale.
// The dq kernel owns 64 query rows and loops over key tiles; the dk/dv kernel owns 64
// keys and loops over query tiles. Each output element is written by one block, so no
// atomics are needed and the result is deterministic.
//
// Replaces the TPU's backward kernels of mapanything_tpu/ops/flash_attention.py:
//   K5 _dq_aug_kernel (:227, launched :1055) and _dkv_aug_kernel (:262, launched :1074),
//      called from _core_bwd (:1036): encoder and trunk frame layers;
//   K6 _pair_dq_kernel (:715, launched :841) and _pair_dkv_kernel (:753, launched :862),
//      called from _pair_core_bwd (:807): trunk global layers.
// On the TPU these differ by head-pair packing, augmented ones/bias columns and a
// constant-shift base-2 softmax, all ways to fit VMEM and the 128-wide MXU. Here one
// streaming design serves every length, as the forward does.
//
// Layout. q, k, v and dO are (B, T, H, D) read through their batch, token and head
// strides (last stride 1), so the views of the fused qkv projection need no copy.
// dq, dk and dv are written as contiguous (B, T, H, D) tensors. Ragged tails: rows past
// Tq or Tk are zero-filled on load; query rows past Tq get P = 0 (lse = +inf), keys past
// Tk get P = 0 in the dq kernel, and rows past the end are never stored.
//
// Instances (D = 64 only):
//   fa_bwd_dq_bf16 / fa_bwd_dkv_bf16: bf16 inputs and outputs, mma.sync m16n8k16 with
//     fp32 accumulation, 4 warps of 16 rows. P and dS are rounded to bf16 for the
//     products that consume them, as FlashAttention-2 does.
//   fa_bwd_dq_f32 / fa_bwd_dkv_f32: fp32 SIMT, two threads per row, each holding half
//     of the head dim; the fp32 model's path.
//
// Bound on this card. The backward does five T^2*D products (S, dP, dV, dK, dQ), 10 *
// B*H*T^2*D flop, of which the dq kernel recomputes S and dP a second time; bytes moved
// are O(T*H*D). At the training shapes it is bound by tensor-core throughput. mma.sync
// reaches only part of that rate; wgmma, TMA and warp specialisation are later work.

#include "flash_attention_common.cuh"

namespace {

// Load 16 rows x D of a swizzled tile as A fragments (rows r0 .. r0+15).
template <int D>
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[D / 16][4], const __nv_bfloat16* tile,
                                             int r0, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    f[kk][0] = lds32<D>(tile, r0 + g, c);
    f[kk][1] = lds32<D>(tile, r0 + g + 8, c);
    f[kk][2] = lds32<D>(tile, r0 + g, c + 8);
    f[kk][3] = lds32<D>(tile, r0 + g + 8, c + 8);
  }
}

// acc[j] = A (16 x D, fragments) times B^T, with B a swizzled [64][D] tile: 16 x 64.
template <int D>
__device__ __forceinline__ void mma_abt(float (&acc)[8][4], const uint32_t (&a)[D / 16][4],
                                        const __nv_bfloat16* tile, int g, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t b0 = lds32<D>(tile, 8 * j + g, kk * 16 + 2 * t);
      const uint32_t b1 = lds32<D>(tile, 8 * j + g, kk * 16 + 2 * t + 8);
      mma_16816(acc[j], a[kk], b0, b1);
    }
  }
}

// out (16 x D) += X (16 x 64, fp32 accumulators, rounded to bf16) times a swizzled
// [64][D] tile.
template <int D>
__device__ __forceinline__ void mma_xb(float (&out)[D / 8][4], const float (&x)[8][4],
                                       const __nv_bfloat16* tile, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t xa[4] = {pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                            pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                            pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                            pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
    const int row = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int jj = 0; jj < D / 16; ++jj) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, tile + swz<D>(row, jj * 16 + (lane >> 4) * 8));
      mma_16816(out[2 * jj], xa, b[0], b[1]);
      mma_16816(out[2 * jj + 1], xa, b[2], b[3]);
    }
  }
}

// Store 16 x D fp32 accumulators, times `mul`, as bf16 rows of a contiguous (B, T, H, D).
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, const float (&acc)[D / 8][4],
                                           float mul, int b, int h, int row0, int T, int H,
                                           int t) {
  const int row1 = row0 + 8;
  __nv_bfloat16* o0 = out + ((static_cast<long long>(b) * T + row0) * H + h) * D;
  __nv_bfloat16* o1 = out + ((static_cast<long long>(b) * T + row1) * H + h) * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (row0 < T)
      *reinterpret_cast<uint32_t*>(o0 + col) = pack_bf16(acc[j][0] * mul, acc[j][1] * mul);
    if (row1 < T)
      *reinterpret_cast<uint32_t*>(o1 + col) = pack_bf16(acc[j][2] * mul, acc[j][3] * mul);
  }
}

template <int D>
__device__ __forceinline__ void zero(float (&acc)[D / 8][4]) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

// dQ for 64 query rows of one (batch, head); grid (ceil(Tq / 64), H, B).
template <int D>
__global__ void __launch_bounds__(kWarps * 32)
    fa_bwd_dq_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dq, int Tq, int Tk, int H, long long sqb,
                   long long sqt, long long sqh, long long skb, long long skt, long long skh,
                   long long svb, long long svt, long long svh, long long sdb, long long sdt,
                   long long sdh, float scale, float scale_log2) {
  __shared__ __align__(128) __nv_bfloat16 sQ[kBlockM * D];
  __shared__ __align__(128) __nv_bfloat16 sdO[kBlockM * D];
  __shared__ __align__(128) __nv_bfloat16 sK[2][kBlockN * D];
  __shared__ __align__(128) __nv_bfloat16 sV[2][kBlockN * D];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y, b = blockIdx.z;
  const __nv_bfloat16* kbase = k + b * skb + h * skh;
  const __nv_bfloat16* vbase = v + b * svb + h * svh;
  const int n_tiles = (Tk + kBlockN - 1) / kBlockN;

  load_tile<D, kBlockM>(sQ, q + b * sqb + h * sqh, sqt, m0, Tq, tid);
  load_tile<D, kBlockM>(sdO, dout + b * sdb + h * sdh, sdt, m0, Tq, tid);
  load_tile<D, kBlockN>(sK[0], kbase, skt, 0, Tk, tid);
  load_tile<D, kBlockN>(sV[0], vbase, svt, 0, Tk, tid);
  cp_async_commit();

  // Row statistics of rows g and g + 8 of this warp: base-2 lse and delta.
  const int row0 = m0 + warp * 16 + g;
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const long long i = (static_cast<long long>(b) * H + h) * Tq + row;
    lse2[r] = row < Tq ? lse[i] * kLog2e : INFINITY;
    dlt[r] = row < Tq ? delta[i] : 0.f;
  }

  uint32_t qf[D / 16][4], dof[D / 16][4];
  float acc[D / 8][4];
  zero<D>(acc);

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
      load_a_frags<D>(qf, sQ, warp * 16, g, t);
      load_a_frags<D>(dof, sdO, warp * 16, g, t);
    }
    const __nv_bfloat16* Ks = sK[buf];
    const __nv_bfloat16* Vs = sV[buf];

    float p[8][4], dp[8][4];
    mma_abt<D>(p, qf, Ks, g, t);   // S = Q K^T
    mma_abt<D>(dp, dof, Vs, g, t);  // dP = dO V^T
    const int kv0 = it * kBlockN;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const bool live = kv0 + 8 * j + 2 * t + (e & 1) < Tk;
        const float pe = live ? ex2(fmaf(p[j][e], scale_log2, -lse2[r])) : 0.f;
        p[j][e] = pe * (dp[j][e] - dlt[r]);  // dS
      }
    mma_xb<D>(acc, p, Ks, lane);  // dQ += dS K
    __syncthreads();
  }
  store_rows<D>(dq, acc, scale, b, h, row0, Tq, H, t);
}

// dK and dV for 64 keys of one (batch, head); grid (ceil(Tk / 64), H, B).
template <int D>
__global__ void __launch_bounds__(kWarps * 32)
    fa_bwd_dkv_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Tq,
                    int Tk, int H, long long sqb, long long sqt, long long sqh, long long skb,
                    long long skt, long long skh, long long svb, long long svt, long long svh,
                    long long sdb, long long sdt, long long sdh, float scale, float scale_log2) {
  __shared__ __align__(128) __nv_bfloat16 sQ[2][kBlockM * D];
  __shared__ __align__(128) __nv_bfloat16 sdO[2][kBlockM * D];
  __shared__ __align__(128) __nv_bfloat16 sKV[kBlockN * D];  // K, then V, then reused
  __shared__ float sL[2][kBlockM];                            // base-2 lse of the q tile
  __shared__ float sD[2][kBlockM];                            // delta of the q tile

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kBlockN;
  const int h = blockIdx.y, b = blockIdx.z;
  const __nv_bfloat16* qbase = q + b * sqb + h * sqh;
  const __nv_bfloat16* dbase = dout + b * sdb + h * sdh;
  const long long stat0 = (static_cast<long long>(b) * H + h) * Tq;
  const int n_tiles = (Tq + kBlockM - 1) / kBlockM;

  // K and V fragments of this warp's 16 keys, staged through one shared tile.
  uint32_t kf[D / 16][4], vf[D / 16][4];
  load_tile<D, kBlockN>(sKV, k + b * skb + h * skh, skt, n0, Tk, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  load_a_frags<D>(kf, sKV, warp * 16, g, t);
  __syncthreads();
  load_tile<D, kBlockN>(sKV, v + b * svb + h * svh, svt, n0, Tk, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  load_a_frags<D>(vf, sKV, warp * 16, g, t);

  auto stage = [&](int tile, int buf) {
    const int m = tile * kBlockM;
    load_tile<D, kBlockM>(sQ[buf], qbase, sqt, m, Tq, tid);
    load_tile<D, kBlockM>(sdO[buf], dbase, sdt, m, Tq, tid);
    if (tid < kBlockM) {
      const int row = m + tid;
      sL[buf][tid] = row < Tq ? lse[stat0 + row] * kLog2e : INFINITY;
      sD[buf][tid] = row < Tq ? delta[stat0 + row] : 0.f;
    }
  };
  stage(0, 0);
  cp_async_commit();

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
  zero<D>(dk_acc);
  zero<D>(dv_acc);

  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_tiles) stage(it + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* Qs = sQ[buf];
    const __nv_bfloat16* dOs = sdO[buf];

    // S^T = K Q^T and dP^T = V dO^T: rows are this warp's keys, columns the tile's queries.
    float p[8][4], dp[8][4];
    mma_abt<D>(p, kf, Qs, g, t);
    mma_abt<D>(dp, vf, dOs, g, t);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1);
        p[j][e] = ex2(fmaf(p[j][e], scale_log2, -sL[buf][col]));  // P^T
      }
    mma_xb<D>(dv_acc, p, dOs, lane);  // dV += P^T dO
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1);
        p[j][e] *= dp[j][e] - sD[buf][col];  // dS^T
      }
    mma_xb<D>(dk_acc, p, Qs, lane);  // dK += dS^T Q
    __syncthreads();
  }
  const int row0 = n0 + warp * 16 + g;
  store_rows<D>(dk, dk_acc, scale, b, h, row0, Tk, H, t);
  store_rows<D>(dv, dv_acc, 1.f, b, h, row0, Tk, H, t);
}

// fp32 instances: 128 threads a block, two per row; thread half `hf` holds the head-dim
// elements d = 2 * i + hf, so the two halves of a pair read neighbouring banks.
constexpr int kF32Threads = 2 * kBlockM;

template <int D>
__device__ __forceinline__ float dot_half(const float (&x)[D / 2], const float* row, int hf) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) s = fmaf(x[i], row[2 * i + hf], s);
  return s + __shfl_xor_sync(0xffffffffu, s, 1);
}

// Stage rows [row0, row0 + 64) of a (batch, head) slice into a [64][D] fp32 tile;
// rows past `rows_total` are zero.
template <int D>
__device__ __forceinline__ void load_tile_f32(float (*dst)[D], const float* base,
                                              long long stride_t, int row0, int rows_total,
                                              int tid) {
  for (int i = tid; i < kBlockM * D / 4; i += kF32Threads) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    const int gr = row0 + r;
    *reinterpret_cast<float4*>(&dst[r][c]) =
        gr < rows_total ? *reinterpret_cast<const float4*>(base + gr * stride_t + c)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <int D>
__global__ void __launch_bounds__(kF32Threads)
    fa_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  float* __restrict__ dq, int Tq, int Tk, int H, long long sqb, long long sqt,
                  long long sqh, long long skb, long long skt, long long skh, long long svb,
                  long long svt, long long svh, long long sdb, long long sdt, long long sdh,
                  float scale, float scale_log2) {
  __shared__ __align__(16) float sK[kBlockN][D];
  __shared__ __align__(16) float sV[kBlockN][D];
  const int tid = threadIdx.x, hf = tid & 1;
  const int h = blockIdx.y, b = blockIdx.z;
  const int row = blockIdx.x * kBlockM + (tid >> 1);
  const bool live = row < Tq;
  const float* qp = q + b * sqb + h * sqh + static_cast<long long>(live ? row : 0) * sqt;
  const float* dp_ = dout + b * sdb + h * sdh + static_cast<long long>(live ? row : 0) * sdt;
  const float* kbase = k + b * skb + h * skh;
  const float* vbase = v + b * svb + h * svh;
  const long long si = (static_cast<long long>(b) * H + h) * Tq + row;
  const float lse2 = live ? lse[si] * kLog2e : INFINITY;
  const float dlt = live ? delta[si] : 0.f;

  float qr[D / 2], dor[D / 2], acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    qr[i] = live ? qp[2 * i + hf] : 0.f;
    dor[i] = live ? dp_[2 * i + hf] : 0.f;
    acc[i] = 0.f;
  }
  for (int kv0 = 0; kv0 < Tk; kv0 += kBlockN) {
    load_tile_f32<D>(sK, kbase, skt, kv0, Tk, tid);
    load_tile_f32<D>(sV, vbase, svt, kv0, Tk, tid);
    __syncthreads();
    const int n = min(kBlockN, Tk - kv0);
    for (int j = 0; j < n; ++j) {
      const float s = dot_half<D>(qr, sK[j], hf);
      const float dpj = dot_half<D>(dor, sV[j], hf);
      const float ds = ex2(fmaf(s, scale_log2, -lse2)) * (dpj - dlt);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = fmaf(ds, sK[j][2 * i + hf], acc[i]);
    }
    __syncthreads();
  }
  if (live) {
    float* op = dq + ((static_cast<long long>(b) * Tq + row) * H + h) * D;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) op[2 * i + hf] = acc[i] * scale;
  }
}

template <int D>
__global__ void __launch_bounds__(kF32Threads)
    fa_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   float* __restrict__ dk, float* __restrict__ dv, int Tq, int Tk, int H,
                   long long sqb, long long sqt, long long sqh, long long skb, long long skt,
                   long long skh, long long svb, long long svt, long long svh, long long sdb,
                   long long sdt, long long sdh, float scale, float scale_log2) {
  __shared__ __align__(16) float sQ[kBlockM][D];
  __shared__ __align__(16) float sdO[kBlockM][D];
  __shared__ float sL[kBlockM];
  __shared__ float sD[kBlockM];
  const int tid = threadIdx.x, hf = tid & 1;
  const int h = blockIdx.y, b = blockIdx.z;
  const int key = blockIdx.x * kBlockN + (tid >> 1);
  const bool live = key < Tk;
  const float* kp = k + b * skb + h * skh + static_cast<long long>(live ? key : 0) * skt;
  const float* vp = v + b * svb + h * svh + static_cast<long long>(live ? key : 0) * svt;
  const float* qbase = q + b * sqb + h * sqh;
  const float* dbase = dout + b * sdb + h * sdh;
  const long long stat0 = (static_cast<long long>(b) * H + h) * Tq;

  float kr[D / 2], vr[D / 2], dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    kr[i] = live ? kp[2 * i + hf] : 0.f;
    vr[i] = live ? vp[2 * i + hf] : 0.f;
    dk_acc[i] = dv_acc[i] = 0.f;
  }
  for (int m = 0; m < Tq; m += kBlockM) {
    load_tile_f32<D>(sQ, qbase, sqt, m, Tq, tid);
    load_tile_f32<D>(sdO, dbase, sdt, m, Tq, tid);
    if (tid < kBlockM) {
      const int row = m + tid;
      sL[tid] = row < Tq ? lse[stat0 + row] * kLog2e : INFINITY;
      sD[tid] = row < Tq ? delta[stat0 + row] : 0.f;
    }
    __syncthreads();
    const int n = min(kBlockM, Tq - m);
    for (int i = 0; i < n; ++i) {
      const float s = dot_half<D>(kr, sQ[i], hf);
      const float dpi = dot_half<D>(vr, sdO[i], hf);
      const float p = ex2(fmaf(s, scale_log2, -sL[i]));
      const float ds = p * (dpi - sD[i]);
#pragma unroll
      for (int c = 0; c < D / 2; ++c) {
        dv_acc[c] = fmaf(p, sdO[i][2 * c + hf], dv_acc[c]);
        dk_acc[c] = fmaf(ds, sQ[i][2 * c + hf], dk_acc[c]);
      }
    }
    __syncthreads();
  }
  if (live) {
    const long long o = ((static_cast<long long>(b) * Tk + key) * H + h) * D;
#pragma unroll
    for (int c = 0; c < D / 2; ++c) {
      dk[o + 2 * c + hf] = dk_acc[c] * scale;
      dv[o + 2 * c + hf] = dv_acc[c];
    }
  }
}

}  // namespace

// dtype: 0 = bf16, 1 = fp32. q, k, v, dout strides are in elements (batch, token, head;
// the head-dim stride is 1). lse and delta are contiguous fp32 (B, H, Tq); outputs are
// contiguous (B, T, H, D). Each returns cudaGetLastError() after its launch.
#define FA_BWD_ARGS                                                                          \
  int dtype, int B, int Tq, int Tk, int H, int D, long long sqb, long long sqt,             \
      long long sqh, long long skb, long long skt, long long skh, long long svb,            \
      long long svt, long long svh, long long sdb, long long sdt, long long sdh, float scale, \
      void* stream
#define FA_BWD_STRIDES sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, sdb, sdt, sdh, scale, scale * kLog2e

extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* dout, const float* lse, const float* delta,
                                      void* dq, FA_BWD_ARGS) {
  if (D != 64 || B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((Tq + kBlockM - 1) / kBlockM, H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    using T = __nv_bfloat16;
    fa_bwd_dq_bf16<64><<<grid, kWarps * 32, 0, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), Tq, Tk, H, FA_BWD_STRIDES);
  } else if (dtype == 1) {
    fa_bwd_dq_f32<64><<<grid, kF32Threads, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), lse, delta, static_cast<float*>(dq), Tq, Tk, H,
        FA_BWD_STRIDES);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* dout, const float* lse, const float* delta,
                                       void* dk, void* dv, FA_BWD_ARGS) {
  if (D != 64 || B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((Tk + kBlockN - 1) / kBlockN, H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    using T = __nv_bfloat16;
    fa_bwd_dkv_bf16<64><<<grid, kWarps * 32, 0, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), Tq,
        Tk, H, FA_BWD_STRIDES);
  } else if (dtype == 1) {
    fa_bwd_dkv_f32<64><<<grid, kF32Threads, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), lse, delta, static_cast<float*>(dk),
        static_cast<float*>(dv), Tq, Tk, H, FA_BWD_STRIDES);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
