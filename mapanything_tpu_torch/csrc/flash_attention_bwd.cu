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
//      called from _core_bwd (:1036) at d % 128 != 0: encoder and trunk frame layers;
//   K6 _pair_dq_kernel (:715, launched :841) and _pair_dkv_kernel (:753, launched :862),
//      called from _pair_core_bwd (:807): trunk global layers at d = 64;
//   K8 _dq_kernel (:306, launched :1107) and _dkv_kernel (:339, launched :1128), called
//      from _core_bwd at d % 128 == 0: every backward with 128-wide heads.
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
// Instances, templated on the head dim D and instantiated for D = 64 and D = 128:
//   fa_bwd_dq_bf16 / fa_bwd_dkv_bf16: bf16 inputs and outputs, mma.sync m16n8k16 with
//     fp32 accumulation, 4 warps of 16 rows. P and dS are rounded to bf16 for the
//     products that consume them, as FlashAttention-2 does. At D = 64 a warp keeps its
//     A operands (Q and dO, or K and V) in registers. At D = 128 its accumulators alone
//     are 64 (dq) or 128 (dk/dv) floats a thread, so it reads the A operands from shared
//     memory at each use (SmemA), and dk/dv streams 32-query tiles instead of 64.
//   fa_bwd_dq_f32 / fa_bwd_dkv_f32: fp32 SIMT, D / 32 threads per row (2 at D = 64, 4
//     at D = 128), each holding its share of the head dim; the fp32 model's path.
// Shared memory. The dq kernel's tiles take 48 KB at D = 64 and 96 KB at D = 128 (its q
// and dO tiles, two K and two V buffers), dk/dv's 41 KB and 64.5 KB (K and V, two q and
// two dO buffers of 64 or 32 rows, their lse and delta), the fp32 instances' 32.5 KB
// and 64.5 KB. Up to 48 KB they are static shared memory; above, the D = 128 instances
// take dynamic shared memory, and the launcher raises the instance's limit once per
// device (cudaFuncSetAttribute) before its first launch there.
//
// Bound on this card. The backward does five T^2*D products (S, dP, dV, dK, dQ), 10 *
// B*H*T^2*D flop, of which the dq kernel recomputes S and dP a second time; bytes moved
// are O(T*H*D). At the training shapes it is bound by tensor-core throughput. mma.sync
// reaches only part of that rate; wgmma, TMA and warp specialisation are later work.

#include <type_traits>

#include "flash_attention_common.cuh"

namespace {

// Tiles of the bf16 instances. A block owns kRows = 16 a warp rows of its side (query
// rows for dq, keys for dk/dv) and streams tiles of kStream rows of the other side. At
// D = 64 a warp holds its A operands (Q and dO for dq, K and V for dk/dv) in registers;
// at D = 128 it reads them from shared memory (SmemA), which keeps the dQ or the dK and
// dV accumulators (D / 4 or D / 2 floats a thread) in registers without spills, and
// dk/dv streams 32-query tiles, which halves its P and dP registers.
template <int D>
struct DqTiles {
  static constexpr int kRows = 64, kStream = 64;
  static constexpr int kThreads = kRows / 16 * 32;
  using A = std::conditional_t<(D > 64), SmemA<D>, RegA<D>>;
  static constexpr int kSmem = (2 * kRows + 4 * kStream) * D * 2;  // sQ, sdO, 2 sK, 2 sV
};

template <int D>
struct DkvTiles {
  static constexpr int kRows = 64, kStream = D > 64 ? 32 : 64;
  static constexpr int kThreads = kRows / 16 * 32;
  using A = std::conditional_t<(D > 64), SmemA<D>, RegA<D>>;
  // K and V tiles: one staging tile when the fragments go to registers, else both stay.
  static constexpr int kKVTiles = D > 64 ? 2 : 1;
  static constexpr int kTileSmem = (kKVTiles * kRows + 4 * kStream) * D * 2;  // K/V, 2 q, 2 dO
  static constexpr int kStatSmem = 4 * kStream * 4;  // lse and delta of two q tiles
  // Static memory keeps the statistics in arrays of their own (the D = 64 instance ran
  // 30% slower with them in the tiles' array); dynamic memory holds both.
  static constexpr bool kStatic = kTileSmem + kStatSmem <= kStaticSmemLimit;
  static constexpr int kSmem = kStatic ? kTileSmem : kTileSmem + kStatSmem;
};

// acc = A (16 x D) times B^T, with B a swizzled [N][D] tile: 16 x N. Each A fragment
// is fetched once (from registers or from shared memory) for all N / 8 output tiles.
template <int D, int N, class A>
__device__ __forceinline__ void mma_abt(float (&acc)[N / 8][4], const A& a,
                                        const __nv_bfloat16* tile, int g, int t) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4];
    a.get(kk, af);
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const uint32_t b0 = lds32<D>(tile, 8 * j + g, kk * 16 + 2 * t);
      const uint32_t b1 = lds32<D>(tile, 8 * j + g, kk * 16 + 2 * t + 8);
      mma_16816(acc[j], af, b0, b1);
    }
  }
}

// out (16 x D) += X (16 x N, fp32 accumulators, rounded to bf16) times a swizzled
// [N][D] tile.
template <int D, int N>
__device__ __forceinline__ void mma_xb(float (&out)[D / 8][4], const float (&x)[N / 8][4],
                                       const __nv_bfloat16* tile, int lane) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
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
__global__ void __launch_bounds__(DqTiles<D>::kThreads)
    fa_bwd_dq_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dq, int Tq, int Tk, int H, long long sqb,
                   long long sqt, long long sqh, long long skb, long long skt, long long skh,
                   long long svb, long long svt, long long svh, long long sdb, long long sdt,
                   long long sdh, float scale, float scale_log2) {
  using Tl = DqTiles<D>;
  constexpr int kRows = Tl::kRows, kStream = Tl::kStream, kThreads = Tl::kThreads;
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(block_smem<Tl::kSmem>());
  __nv_bfloat16* sdO = sQ + kRows * D;
  __nv_bfloat16* sK = sdO + kRows * D;       // two K tiles
  __nv_bfloat16* sV = sK + 2 * kStream * D;  // two V tiles

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * kRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const __nv_bfloat16* kbase = k + b * skb + h * skh;
  const __nv_bfloat16* vbase = v + b * svb + h * svh;
  const int n_tiles = (Tk + kStream - 1) / kStream;

  load_tile<D, kRows, kThreads>(sQ, q + b * sqb + h * sqh, sqt, m0, Tq, tid);
  load_tile<D, kRows, kThreads>(sdO, dout + b * sdb + h * sdh, sdt, m0, Tq, tid);
  load_tile<D, kStream, kThreads>(sK, kbase, skt, 0, Tk, tid);
  load_tile<D, kStream, kThreads>(sV, vbase, svt, 0, Tk, tid);
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

  typename Tl::A qa, doa;  // this warp's rows of Q and dO
  float acc[D / 8][4];
  zero<D>(acc);

  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_tiles) {
      load_tile<D, kStream, kThreads>(sK + (buf ^ 1) * kStream * D, kbase, skt, (it + 1) * kStream,
                                      Tk, tid);
      load_tile<D, kStream, kThreads>(sV + (buf ^ 1) * kStream * D, vbase, svt, (it + 1) * kStream,
                                      Tk, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (it == 0) {
      qa.load(sQ, warp * 16, g, t);
      doa.load(sdO, warp * 16, g, t);
    }
    const __nv_bfloat16* Ks = sK + buf * kStream * D;
    const __nv_bfloat16* Vs = sV + buf * kStream * D;

    float p[kStream / 8][4], dp[kStream / 8][4];
    mma_abt<D, kStream>(p, qa, Ks, g, t);    // S = Q K^T
    mma_abt<D, kStream>(dp, doa, Vs, g, t);  // dP = dO V^T
    const int kv0 = it * kStream;
#pragma unroll
    for (int j = 0; j < kStream / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const bool live = kv0 + 8 * j + 2 * t + (e & 1) < Tk;
        const float pe = live ? ex2(fmaf(p[j][e], scale_log2, -lse2[r])) : 0.f;
        p[j][e] = pe * (dp[j][e] - dlt[r]);  // dS
      }
    mma_xb<D, kStream>(acc, p, Ks, lane);  // dQ += dS K
    __syncthreads();
  }
  store_rows<D>(dq, acc, scale, b, h, row0, Tq, H, t);
}

// dK and dV for 64 keys of one (batch, head); grid (ceil(Tk / 64), H, B).
template <int D>
__global__ void __launch_bounds__(DkvTiles<D>::kThreads)
    fa_bwd_dkv_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Tq,
                    int Tk, int H, long long sqb, long long sqt, long long sqh, long long skb,
                    long long skt, long long skh, long long svb, long long svt, long long svh,
                    long long sdb, long long sdt, long long sdh, float scale, float scale_log2) {
  using Tl = DkvTiles<D>;
  constexpr int kRows = Tl::kRows, kStream = Tl::kStream, kThreads = Tl::kThreads;
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(block_smem<Tl::kSmem>());
  __nv_bfloat16* sV = sK + (Tl::kKVTiles - 1) * kRows * D;  // own tile, or the K tile reused
  __nv_bfloat16* sQ = sK + Tl::kKVTiles * kRows * D;        // two q tiles
  __nv_bfloat16* sdO = sQ + 2 * kStream * D;                // two dO tiles
  float *sL, *sD;  // base-2 lse and delta of two q tiles
  if constexpr (Tl::kStatic) {
    __shared__ float lse_tiles[2 * kStream], delta_tiles[2 * kStream];
    sL = lse_tiles;
    sD = delta_tiles;
  } else {
    sL = reinterpret_cast<float*>(sdO + 2 * kStream * D);
    sD = sL + 2 * kStream;
  }

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const __nv_bfloat16* qbase = q + b * sqb + h * sqh;
  const __nv_bfloat16* dbase = dout + b * sdb + h * sdh;
  const long long stat0 = (static_cast<long long>(b) * H + h) * Tq;
  const int n_tiles = (Tq + kStream - 1) / kStream;

  // K and V of this warp's 16 keys: fragments staged through one shared tile, or both
  // tiles kept for SmemA.
  typename Tl::A ka, va;
  load_tile<D, kRows, kThreads>(sK, k + b * skb + h * skh, skt, n0, Tk, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  ka.load(sK, warp * 16, g, t);
  __syncthreads();
  load_tile<D, kRows, kThreads>(sV, v + b * svb + h * svh, svt, n0, Tk, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  va.load(sV, warp * 16, g, t);

  auto stage = [&](int tile, int buf) {
    const int m = tile * kStream;
    load_tile<D, kStream, kThreads>(sQ + buf * kStream * D, qbase, sqt, m, Tq, tid);
    load_tile<D, kStream, kThreads>(sdO + buf * kStream * D, dbase, sdt, m, Tq, tid);
    if (tid < kStream) {
      const int row = m + tid;
      sL[buf * kStream + tid] = row < Tq ? lse[stat0 + row] * kLog2e : INFINITY;
      sD[buf * kStream + tid] = row < Tq ? delta[stat0 + row] : 0.f;
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
    const __nv_bfloat16* Qs = sQ + buf * kStream * D;
    const __nv_bfloat16* dOs = sdO + buf * kStream * D;
    const float* Ls = sL + buf * kStream;
    const float* Ds = sD + buf * kStream;

    // S^T = K Q^T and dP^T = V dO^T: rows are this warp's keys, columns the tile's queries.
    float p[kStream / 8][4], dp[kStream / 8][4];
    mma_abt<D, kStream>(p, ka, Qs, g, t);
    mma_abt<D, kStream>(dp, va, dOs, g, t);
#pragma unroll
    for (int j = 0; j < kStream / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1);
        p[j][e] = ex2(fmaf(p[j][e], scale_log2, -Ls[col]));  // P^T
      }
    mma_xb<D, kStream>(dv_acc, p, dOs, lane);  // dV += P^T dO
#pragma unroll
    for (int j = 0; j < kStream / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1);
        p[j][e] *= dp[j][e] - Ds[col];  // dS^T
      }
    mma_xb<D, kStream>(dk_acc, p, Qs, lane);  // dK += dS^T Q
    __syncthreads();
  }
  const int row0 = n0 + warp * 16 + g;
  store_rows<D>(dk, dk_acc, scale, b, h, row0, Tk, H, t);
  store_rows<D>(dv, dv_acc, 1.f, b, h, row0, Tk, H, t);
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

// The launchers of one head dim; each instance raises its shared memory limit once per
// device. Outputs: dq, or dk and dv.
struct BwdArgs {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *o0, *o1;
  int B, Tq, Tk, H;
  long long sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, sdb, sdt, sdh;
  float scale;
  cudaStream_t st;
};

#define FA_BWD_KERNEL_ARGS(T)                                                                  \
  static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),          \
      static_cast<const T*>(a.dout), a.lse, a.delta
#define FA_BWD_KERNEL_STRIDES                                                                  \
  a.Tq, a.Tk, a.H, a.sqb, a.sqt, a.sqh, a.skb, a.skt, a.skh, a.svb, a.svt, a.svh, a.sdb, a.sdt, \
      a.sdh, a.scale, a.scale * kLog2e

template <int D>
int bwd_dq(int dtype, const BwdArgs& a) {
  if (dtype == 0) {
    using T = __nv_bfloat16;
    using Tl = DqTiles<D>;
    static SmemOptIn opt_in;
    return launch(fa_bwd_dq_bf16<D>, opt_in, dim3((a.Tq + Tl::kRows - 1) / Tl::kRows, a.H, a.B),
                  Tl::kThreads, Tl::kSmem, a.st, FA_BWD_KERNEL_ARGS(T), static_cast<T*>(a.o0),
                  FA_BWD_KERNEL_STRIDES);
  }
  if (dtype == 1) {
    using Tl = BwdF32Tiles<D>;
    static SmemOptIn opt_in;
    return launch(fa_bwd_dq_f32<D>, opt_in, dim3((a.Tq + Tl::kRows - 1) / Tl::kRows, a.H, a.B),
                  Tl::kThreads, Tl::kSmem, a.st, FA_BWD_KERNEL_ARGS(float), static_cast<float*>(a.o0),
                  FA_BWD_KERNEL_STRIDES);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int D>
int bwd_dkv(int dtype, const BwdArgs& a) {
  if (dtype == 0) {
    using T = __nv_bfloat16;
    using Tl = DkvTiles<D>;
    static SmemOptIn opt_in;
    return launch(fa_bwd_dkv_bf16<D>, opt_in, dim3((a.Tk + Tl::kRows - 1) / Tl::kRows, a.H, a.B),
                  Tl::kThreads, Tl::kSmem, a.st, FA_BWD_KERNEL_ARGS(T), static_cast<T*>(a.o0),
                  static_cast<T*>(a.o1), FA_BWD_KERNEL_STRIDES);
  }
  if (dtype == 1) {
    using Tl = BwdF32Tiles<D>;
    static SmemOptIn opt_in;
    return launch(fa_bwd_dkv_f32<D>, opt_in, dim3((a.Tk + Tl::kRows - 1) / Tl::kRows, a.H, a.B),
                  Tl::kThreads, Tl::kSmem, a.st, FA_BWD_KERNEL_ARGS(float),
                  static_cast<float*>(a.o0), static_cast<float*>(a.o1), FA_BWD_KERNEL_STRIDES);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

#undef FA_BWD_KERNEL_ARGS
#undef FA_BWD_KERNEL_STRIDES

}  // namespace

// dtype: 0 = bf16, 1 = fp32; D: 64 or 128. q, k, v, dout strides are in elements (batch,
// token, head; the head-dim stride is 1). lse and delta are contiguous fp32 (B, H, Tq);
// outputs are contiguous (B, T, H, D). Each returns cudaErrorInvalidValue for arguments
// no instance takes, else the shared memory attribute call's error or
// cudaGetLastError() after its launch.
#define FA_BWD_ARGS                                                                          \
  int dtype, int B, int Tq, int Tk, int H, int D, long long sqb, long long sqt,             \
      long long sqh, long long skb, long long skt, long long skh, long long svb,            \
      long long svt, long long svh, long long sdb, long long sdt, long long sdh, float scale, \
      void* stream

extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* dout, const float* lse, const float* delta,
                                      void* dq, FA_BWD_ARGS) {
  const BwdArgs a{q,   k,   v,   dout, lse, delta, dq,  nullptr, B,   Tq,  Tk,  H,   sqb, sqt,
                  sqh, skb, skt, skh,  svb, svt,   svh, sdb,     sdt, sdh, scale,
                  static_cast<cudaStream_t>(stream)};
  return by_head_dim(D, B, Tq, Tk, H, [&] { return bwd_dq<64>(dtype, a); },
                     [&] { return bwd_dq<128>(dtype, a); });
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* dout, const float* lse, const float* delta,
                                       void* dk, void* dv, FA_BWD_ARGS) {
  const BwdArgs a{q,   k,   v,   dout, lse, delta, dk,  dv,  B,   Tq,  Tk,  H,   sqb, sqt,
                  sqh, skb, skt, skh,  svb, svt,   svh, sdb, sdt, sdh, scale,
                  static_cast<cudaStream_t>(stream)};
  return by_head_dim(D, B, Tq, Tk, H, [&] { return bwd_dkv<64>(dtype, a); },
                     [&] { return bwd_dkv<128>(dtype, a); });
}
