// Masked non-causal attention for Hopper (sm_90a): o = softmax(where(mask, q k^T * scale, c)) v,
// with c = -0.7 * FLT_MAX, and its backward (dq; dk and dv).
//
// Replaces no Pallas kernel: on the TPU every masked call of mapanything_tpu/ops/attention.py
// sdpa (:67-77) goes to XLA's fused attention (jax.nn.dot_product_attention, :81). The port
// keeps one rule for every sdpa call (a CUDA tensor launches a hand-written kernel or raises),
// so the masked form has kernels of its own. They follow JAX 0.9's semantics
// (jax/_src/nn/functions.py _apply_masks, _get_large_negative): the logits are q.k in fp32
// times scale; a masked logit is *replaced* by c; the softmax is taken in fp32; in bf16 the
// probabilities are rounded to bf16 before the P.V product. Hence:
//   - a fully masked row attends every key with weight 1/Tk: its o is the mean of V over Tk;
//   - its lse, c + log(Tk), rounds to c in fp32, so exp(s - lse) cannot rebuild its P
//     (1 instead of 1/Tk). The backward marks such rows by lse <= c / 2 (a row with any key
//     left has lse >= its largest real logit) and gives their P as 1/Tk;
//   - dS is zero at every masked position, a fully masked row's included (where() passes no
//     gradient to a replaced logit): such a row adds to dV alone.
// The softmax runs in the natural-log domain: c * log2(e) would overflow to -inf, and
// exp2(-inf - -inf) is NaN.
//
// Layout. q is (B, Tq, H, D), k and v (B, Tk, H, D), read in place through their batch,
// token and head strides (unit head-dim stride, 16-byte aligned rows: 16-byte loads); dO
// likewise. The mask is bytes (torch.bool) read through four strides (batch, head, query,
// key), so a dimension of size 1 broadcasts with stride 0 and is never materialised. o, dq,
// dk and dv are written contiguous; lse and delta are contiguous fp32 (B, H, Tq).
//
// Design (a simple one that is right; making it fast is later work). One block of 4 warps
// per (b, h, tile): the forward and dq kernels take 64 query rows a block (16 a warp) and
// stream keys in tiles of 64; the dk/dv kernel takes 64 keys a block (16 a warp) and streams
// query rows in stages of 64. Each tile is staged in shared memory with its mask tile, read
// as bytes and coded 1 (attend), 0 (masked: c) or 2 (no such key or query: left out). Every
// product is a warp's 16 rows times a tile: in bf16 by mma.sync m16n8k16 (fp32 accumulate)
// from fragments loaded out of shared memory; in fp32 by scalar FMAs at the same fragment
// positions, each tile's sum started fresh and then added to the running one (a two-level
// sum, as the fp32 plain version's blocked products sum). The scores (and P, dS) of a warp
// pass through its own shared-memory scratch to become the next product's A operand.
//
// Bound on this card. At the shapes of chip_smoke.py phase 3h (e.g. 8x1369x12x64 bf16) the
// work is 4*B*H*Tq*Tk*D flop (10*... for the backward) against a few bytes a score of mask:
// hundreds of flop per byte, so the tensor cores bound it in bf16 (989 TFLOP/s) and the FMA
// units in fp32 (67 TFLOP/s). mma.sync from shared memory without a pipeline reaches a
// fraction of that; PERF.md records the times beside the bounds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <math.h>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kQT = 64;      // query rows a block (forward, dq) or a stage (dk/dv)
constexpr int kKT = 64;      // keys a tile (forward, dq) or a block (dk/dv)
constexpr int kWarps = 4;    // each takes 16 rows
constexpr int kThreads = 32 * kWarps;
constexpr float kMasked = -0x1.666664p+127f;  // -0.7 * FLT_MAX rounded to fp32, as JAX's
constexpr unsigned char kAttend = 1, kMaskedCode = 0, kAbsent = 2;

struct Strides {
  long long q[3], k[3], v[3], dout[3];  // (batch, token, head), in elements
  long long m[4];                       // the mask's (batch, head, query, key), in bytes
};

template <typename T>
constexpr int pad() { return sizeof(T) == 2 ? 8 : 4; }  // 16 bytes a row, keeps rows 16-byte aligned

// The shared-memory layout of an instance: row strides of a [rows][D] tile and of a [D][64]
// (transposed) tile or a warp's scratch, in elements, and the scratch's size.
template <typename T, int D>
struct Smem {
  static constexpr int kLd = D + pad<T>();
  static constexpr int kLdt = 64 + pad<T>();
  static constexpr int kScratch = kWarps * 16 * kLdt;
};

// Each kernel's dynamic shared memory in bytes; the launchers and flash_attention_masked_smem
// read them.
template <typename T, int D>
constexpr int smem_fwd() {
  using S = Smem<T, D>;
  return ((kQT + kKT) * S::kLd + D * S::kLdt + S::kScratch) * (int)sizeof(T) + kQT * kKT;
}

template <typename T, int D>
constexpr int smem_dq() {
  using S = Smem<T, D>;
  return ((2 * kQT + 2 * kKT) * S::kLd + D * S::kLdt + S::kScratch) * (int)sizeof(T) + kQT * kKT;
}

template <typename T, int D>
constexpr int smem_dkv() {
  using S = Smem<T, D>;
  return ((2 * kKT + 2 * kQT) * S::kLd + 2 * D * S::kLdt + S::kScratch) * (int)sizeof(T) + 2 * kQT * 4 + kQT * kKT;
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) { return *reinterpret_cast<const uint32_t*>(p); }

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[j] += A (the warp's 16 rows, K deep; row-major, stride lda) times B (K x 8*NT), B given
// n-major: element (k, n) at b[n * ldb + k]. acc[j][e] is row g (e < 2) or g + 8, column
// 8j + 2t + (e & 1), g = lane / 4, t = lane % 4: mma.sync's accumulator layout.
template <int NT, int K>
__device__ __forceinline__ void warp_mm(float (&acc)[NT][4], const bf16* a, int lda, const bf16* b, int ldb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 16) {
    const uint32_t af[4] = {ld32(a + g * lda + k0 + 2 * t), ld32(a + (g + 8) * lda + k0 + 2 * t),
                            ld32(a + g * lda + k0 + 8 + 2 * t), ld32(a + (g + 8) * lda + k0 + 8 + 2 * t)};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const bf16* bn = b + (8 * j + g) * ldb + k0 + 2 * t;
      const uint32_t bf[2] = {ld32(bn), ld32(bn + 8)};
      mma_bf16(acc[j], af, bf);
    }
  }
}

template <int NT, int K>
__device__ __forceinline__ void warp_mm(float (&acc)[NT][4], const float* a, int lda, const float* b, int ldb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* a0 = a + g * lda;
  const float* a1 = a + (g + 8) * lda;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float* b0 = b + (8 * j + 2 * t) * ldb;
    const float* b1 = b0 + ldb;
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll 8
    for (int k = 0; k < K; ++k) {
      const float x0 = a0[k], x1 = a1[k], y0 = b0[k], y1 = b1[k];
      s0 = fmaf(x0, y0, s0);
      s1 = fmaf(x0, y1, s1);
      s2 = fmaf(x1, y0, s2);
      s3 = fmaf(x1, y1, s3);
    }
    acc[j][0] += s0;
    acc[j][1] += s1;
    acc[j][2] += s2;
    acc[j][3] += s3;
  }
}

template <typename T>
__device__ __forceinline__ T to_elem(float x) {
  if constexpr (std::is_same<T, float>::value) {
    return x;
  } else {
    return __float2bfloat16_rn(x);
  }
}

// Rows t0 .. t0 + ROWS of one (batch, head) of a (B, T, H, D) tensor (``src`` at that batch and
// head, token stride ``st``) into shared memory: [ROWS][kLd] at ``dst`` and/or transposed,
// [D][kLdt] at ``dst_t``; rows past ``len`` are zero.
template <typename T, int D, int ROWS>
__device__ void load_rows(T* dst, T* dst_t, const T* src, long long st, int t0, int len) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kLd = Smem<T, D>::kLd, kLdt = Smem<T, D>::kLdt;
  for (int i = threadIdx.x; i < ROWS * (D / kVec); i += kThreads) {
    const int r = i / (D / kVec), c = (i % (D / kVec)) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t0 + r < len) val = *reinterpret_cast<const uint4*>(src + (long long)(t0 + r) * st + c);
    if (dst != nullptr) *reinterpret_cast<uint4*>(dst + r * kLd + c) = val;
    if (dst_t != nullptr) {
      const T* e = reinterpret_cast<const T*>(&val);
#pragma unroll
      for (int j = 0; j < kVec; ++j) dst_t[(c + j) * kLdt + r] = e[j];
    }
  }
}

// The mask tile [kQT][kKT] of queries q0.. and keys k0..: kAttend or kMaskedCode from the
// mask's bytes, kAbsent past Tk, and past Tq where ``absent_rows`` (else kAttend, harmless).
__device__ void load_mask(unsigned char* sm, const unsigned char* mask, long long sq, long long sk, int q0, int k0,
                          int tq, int tk, bool absent_rows) {
  for (int i = threadIdx.x; i < kQT * kKT; i += kThreads) {
    const int qi = q0 + i / kKT, ki = k0 + i % kKT;
    unsigned char code = kAbsent;
    if (ki < tk) {
      if (qi < tq) {
        code = mask[qi * sq + ki * sk] ? kAttend : kMaskedCode;
      } else if (!absent_rows) {
        code = kAttend;
      }
    }
    sm[i] = code;
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ bool fully_masked(float lse) { return lse <= 0.5f * kMasked; }

// ---------------------------------------------------------------- forward

template <typename T, int D, bool kLse>
__global__ void __launch_bounds__(kThreads) fa_fwd_masked(const T* __restrict__ q, const T* __restrict__ k,
                                                          const T* __restrict__ v, const unsigned char* __restrict__ mask,
                                                          T* __restrict__ o, float* __restrict__ lse, int B, int Tq,
                                                          int Tk, int H, Strides st, float scale) {
  using S = Smem<T, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sq = reinterpret_cast<T*>(smem);
  T* sk = sq + kQT * S::kLd;
  T* svt = sk + kKT * S::kLd;
  T* sp = svt + D * S::kLdt;
  unsigned char* sm = reinterpret_cast<unsigned char*>(sp + S::kScratch);
  const int q0 = blockIdx.x * kQT, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  T* spw = sp + warp * 16 * S::kLdt;
  const unsigned char* mbh = mask + b * st.m[0] + h * st.m[1];
  load_rows<T, D, kQT>(sq, nullptr, q + b * st.q[0] + h * st.q[2], st.q[1], q0, Tq);

  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int k0 = 0; k0 < Tk; k0 += kKT) {
    __syncthreads();  // the previous tile is read
    load_rows<T, D, kKT>(sk, nullptr, k + b * st.k[0] + h * st.k[2], st.k[1], k0, Tk);
    load_rows<T, D, kKT>(nullptr, svt, v + b * st.v[0] + h * st.v[2], st.v[1], k0, Tk);
    load_mask(sm, mbh, st.m[2], st.m[3], q0, k0, Tq, Tk, false);
    __syncthreads();
    float s[kKT / 8][4];
#pragma unroll
    for (int j = 0; j < kKT / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    warp_mm<kKT / 8, D>(s, sq + warp * 16 * S::kLd, S::kLd, sk, S::kLd);
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < kKT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = warp * 16 + g + 8 * (e >> 1), col = 8 * j + 2 * t + (e & 1);
        const unsigned char code = sm[row * kKT + col];
        const float x = code == kAttend ? s[j][e] * scale : code == kMaskedCode ? kMasked : -INFINITY;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);  // finite: every tile holds a key, each scored or c
      alpha[r] = expf(m_run[r] - mx[r]);
      m_run[r] = mx[r];
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < kKT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - mx[e >> 1]);
        l_run[e >> 1] += p;
        spw[(g + 8 * (e >> 1)) * S::kLdt + 8 * j + 2 * t + (e & 1)] = to_elem<T>(p);
      }
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }
    __syncwarp();
    warp_mm<D / 8, kKT>(acc, spw, S::kLdt, svt, S::kLdt);
  }

  const long long bh = (long long)b * H + h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = quad_sum(l_run[r]);
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= Tq) continue;
    T* orow = o + (((long long)b * Tq + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      orow[8 * j + 2 * t] = to_elem<T>(acc[j][2 * r] / l);
      orow[8 * j + 2 * t + 1] = to_elem<T>(acc[j][2 * r + 1] / l);
    }
    if (kLse && t == 0) lse[bh * Tq + row] = m_run[r] + logf(l);
  }
}

// ---------------------------------------------------------------- dq

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) fa_bwd_dq_masked(const T* __restrict__ q, const T* __restrict__ k,
                                                             const T* __restrict__ v, const T* __restrict__ dout,
                                                             const unsigned char* __restrict__ mask,
                                                             const float* __restrict__ lse,
                                                             const float* __restrict__ delta, T* __restrict__ dq,
                                                             int B, int Tq, int Tk, int H, Strides st, float scale) {
  using S = Smem<T, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sq = reinterpret_cast<T*>(smem);
  T* sdo = sq + kQT * S::kLd;
  T* sk = sdo + kQT * S::kLd;
  T* sv = sk + kKT * S::kLd;
  T* skt = sv + kKT * S::kLd;
  T* sp = skt + D * S::kLdt;
  unsigned char* sm = reinterpret_cast<unsigned char*>(sp + S::kScratch);
  const int q0 = blockIdx.x * kQT, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  T* spw = sp + warp * 16 * S::kLdt;
  const unsigned char* mbh = mask + b * st.m[0] + h * st.m[1];
  const long long bh = (long long)b * H + h;
  load_rows<T, D, kQT>(sq, nullptr, q + b * st.q[0] + h * st.q[2], st.q[1], q0, Tq);
  load_rows<T, D, kQT>(sdo, nullptr, dout + b * st.dout[0] + h * st.dout[2], st.dout[1], q0, Tq);
  float row_lse[2], row_delta[2];
  bool row_full[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    row_lse[r] = row < Tq ? lse[bh * Tq + row] : 0.f;
    row_delta[r] = row < Tq ? delta[bh * Tq + row] : 0.f;
    row_full[r] = fully_masked(row_lse[r]);  // adds nothing to dq
  }
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int k0 = 0; k0 < Tk; k0 += kKT) {
    __syncthreads();
    load_rows<T, D, kKT>(sk, skt, k + b * st.k[0] + h * st.k[2], st.k[1], k0, Tk);
    load_rows<T, D, kKT>(sv, nullptr, v + b * st.v[0] + h * st.v[2], st.v[1], k0, Tk);
    load_mask(sm, mbh, st.m[2], st.m[3], q0, k0, Tq, Tk, true);
    __syncthreads();
    float s[kKT / 8][4], dp[kKT / 8][4];
#pragma unroll
    for (int j = 0; j < kKT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
    warp_mm<kKT / 8, D>(s, sq + warp * 16 * S::kLd, S::kLd, sk, S::kLd);     // S = Q K^T
    warp_mm<kKT / 8, D>(dp, sdo + warp * 16 * S::kLd, S::kLd, sv, S::kLd);   // dP = dO V^T
#pragma unroll
    for (int j = 0; j < kKT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, row = warp * 16 + g + 8 * r, col = 8 * j + 2 * t + (e & 1);
        float ds = 0.f;
        if (sm[row * kKT + col] == kAttend && !row_full[r]) {
          ds = expf(s[j][e] * scale - row_lse[r]) * (dp[j][e] - row_delta[r]);
        }
        spw[(g + 8 * r) * S::kLdt + col] = to_elem<T>(ds);
      }
    }
    __syncwarp();
    warp_mm<D / 8, kKT>(acc, spw, S::kLdt, skt, S::kLdt);  // dQ += dS K
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= Tq) continue;
    T* out = dq + (((long long)b * Tq + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      out[8 * j + 2 * t] = to_elem<T>(acc[j][2 * r] * scale);
      out[8 * j + 2 * t + 1] = to_elem<T>(acc[j][2 * r + 1] * scale);
    }
  }
}

// ---------------------------------------------------------------- dk, dv

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) fa_bwd_dkv_masked(const T* __restrict__ q, const T* __restrict__ k,
                                                              const T* __restrict__ v, const T* __restrict__ dout,
                                                              const unsigned char* __restrict__ mask,
                                                              const float* __restrict__ lse,
                                                              const float* __restrict__ delta, T* __restrict__ dk,
                                                              T* __restrict__ dv, int B, int Tq, int Tk, int H,
                                                              Strides st, float scale) {
  using S = Smem<T, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sk = reinterpret_cast<T*>(smem);
  T* sv = sk + kKT * S::kLd;
  T* sq = sv + kKT * S::kLd;
  T* sdo = sq + kQT * S::kLd;
  T* sqt = sdo + kQT * S::kLd;
  T* sdot = sqt + D * S::kLdt;
  T* sp = sdot + D * S::kLdt;
  float* slse = reinterpret_cast<float*>(sp + S::kScratch);
  float* sdelta = slse + kQT;
  unsigned char* sm = reinterpret_cast<unsigned char*>(sdelta + kQT);
  const int k0 = blockIdx.x * kKT, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  T* spw = sp + warp * 16 * S::kLdt;
  const unsigned char* mbh = mask + b * st.m[0] + h * st.m[1];
  const long long bh = (long long)b * H + h;
  const float uniform = 1.f / Tk;  // P of a fully masked row
  load_rows<T, D, kKT>(sk, nullptr, k + b * st.k[0] + h * st.k[2], st.k[1], k0, Tk);
  load_rows<T, D, kKT>(sv, nullptr, v + b * st.v[0] + h * st.v[2], st.v[1], k0, Tk);
  float acc_dk[D / 8][4], acc_dv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[j][e] = acc_dv[j][e] = 0.f;
  }

  for (int q0 = 0; q0 < Tq; q0 += kQT) {
    __syncthreads();
    load_rows<T, D, kQT>(sq, sqt, q + b * st.q[0] + h * st.q[2], st.q[1], q0, Tq);
    load_rows<T, D, kQT>(sdo, sdot, dout + b * st.dout[0] + h * st.dout[2], st.dout[1], q0, Tq);
    for (int i = threadIdx.x; i < kQT; i += kThreads) {
      slse[i] = q0 + i < Tq ? lse[bh * Tq + q0 + i] : 0.f;
      sdelta[i] = q0 + i < Tq ? delta[bh * Tq + q0 + i] : 0.f;
    }
    load_mask(sm, mbh, st.m[2], st.m[3], q0, k0, Tq, Tk, true);
    __syncthreads();
    float s[kQT / 8][4];  // S^T: the warp's 16 keys by the stage's 64 query rows, then P^T
#pragma unroll
    for (int j = 0; j < kQT / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    warp_mm<kQT / 8, D>(s, sk + warp * 16 * S::kLd, S::kLd, sq, S::kLd);
#pragma unroll
    for (int j = 0; j < kQT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = warp * 16 + g + 8 * (e >> 1), col = 8 * j + 2 * t + (e & 1);
        const unsigned char code = sm[col * kKT + key];
        const float l = slse[col];
        float p = 0.f;
        if (code != kAbsent) {
          p = fully_masked(l) ? uniform : code == kAttend ? expf(s[j][e] * scale - l) : 0.f;
        }
        s[j][e] = p;
        spw[(g + 8 * (e >> 1)) * S::kLdt + col] = to_elem<T>(p);
      }
    }
    __syncwarp();
    warp_mm<D / 8, kQT>(acc_dv, spw, S::kLdt, sdot, S::kLdt);  // dV += P^T dO
    float dp[kQT / 8][4];  // dP^T = V dO^T
#pragma unroll
    for (int j = 0; j < kQT / 8; ++j) dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    warp_mm<kQT / 8, D>(dp, sv + warp * 16 * S::kLd, S::kLd, sdo, S::kLd);
    __syncwarp();  // every lane has read P^T
#pragma unroll
    for (int j = 0; j < kQT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = warp * 16 + g + 8 * (e >> 1), col = 8 * j + 2 * t + (e & 1);
        float ds = 0.f;
        if (sm[col * kKT + key] == kAttend && !fully_masked(slse[col])) ds = s[j][e] * (dp[j][e] - sdelta[col]);
        spw[(g + 8 * (e >> 1)) * S::kLdt + col] = to_elem<T>(ds);
      }
    }
    __syncwarp();
    warp_mm<D / 8, kQT>(acc_dk, spw, S::kLdt, sqt, S::kLdt);  // dK += dS^T Q
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + warp * 16 + g + 8 * r;
    if (key >= Tk) continue;
    const long long off = (((long long)b * Tk + key) * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      dk[off + 8 * j + 2 * t] = to_elem<T>(acc_dk[j][2 * r] * scale);
      dk[off + 8 * j + 2 * t + 1] = to_elem<T>(acc_dk[j][2 * r + 1] * scale);
      dv[off + 8 * j + 2 * t] = to_elem<T>(acc_dv[j][2 * r]);
      dv[off + 8 * j + 2 * t + 1] = to_elem<T>(acc_dv[j][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------- launchers

struct Args {
  const void *q, *k, *v, *dout;
  const unsigned char* mask;
  const float *lse_in, *delta;
  void *out0, *out1;
  float* lse_out;
  int B, Tq, Tk, H;
  Strides st;
  float scale;
  cudaStream_t stream;
};

template <typename Kernel>
int launch(Kernel kernel, int smem, dim3 grid, const Args& a, void** params) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernel(reinterpret_cast<const void*>(kernel), grid, dim3(kThreads), params, smem, a.stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, int D, bool kLse>
int launch_fwd(Args a) {
  const T *q = static_cast<const T*>(a.q), *k = static_cast<const T*>(a.k), *v = static_cast<const T*>(a.v);
  T* o = static_cast<T*>(a.out0);
  void* params[] = {&q, &k, &v, &a.mask, &o, &a.lse_out, &a.B, &a.Tq, &a.Tk, &a.H, &a.st, &a.scale};
  const dim3 grid((a.Tq + kQT - 1) / kQT, a.H, a.B);
  return launch(fa_fwd_masked<T, D, kLse>, smem_fwd<T, D>(), grid, a, params);
}

template <typename T, int D>
int launch_dq(Args a) {
  const T *q = static_cast<const T*>(a.q), *k = static_cast<const T*>(a.k), *v = static_cast<const T*>(a.v),
          *dout = static_cast<const T*>(a.dout);
  T* dq = static_cast<T*>(a.out0);
  void* params[] = {&q, &k, &v, &dout, &a.mask, &a.lse_in, &a.delta, &dq, &a.B, &a.Tq, &a.Tk, &a.H, &a.st, &a.scale};
  const dim3 grid((a.Tq + kQT - 1) / kQT, a.H, a.B);
  return launch(fa_bwd_dq_masked<T, D>, smem_dq<T, D>(), grid, a, params);
}

template <typename T, int D>
int launch_dkv(Args a) {
  const T *q = static_cast<const T*>(a.q), *k = static_cast<const T*>(a.k), *v = static_cast<const T*>(a.v),
          *dout = static_cast<const T*>(a.dout);
  T *dk = static_cast<T*>(a.out0), *dv = static_cast<T*>(a.out1);
  void* params[] = {&q,  &k,  &v,   &dout, &a.mask, &a.lse_in, &a.delta, &dk,
                    &dv, &a.B, &a.Tq, &a.Tk, &a.H,   &a.st,     &a.scale};
  const dim3 grid((a.Tk + kKT - 1) / kKT, a.H, a.B);
  return launch(fa_bwd_dkv_masked<T, D>, smem_dkv<T, D>(), grid, a, params);
}

Args make_args(const void* q, const void* k, const void* v, const void* dout, const unsigned char* mask, int B,
               int Tq, int Tk, int H, const long long* strides, float scale, void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.mask = mask;
  a.B = B;
  a.Tq = Tq;
  a.Tk = Tk;
  a.H = H;
  for (int i = 0; i < 3; ++i) {
    a.st.q[i] = strides[i];
    a.st.k[i] = strides[3 + i];
    a.st.v[i] = strides[6 + i];
    a.st.dout[i] = strides[9 + i];
  }
  for (int i = 0; i < 4; ++i) a.st.m[i] = strides[12 + i];
  a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  return a;
}

constexpr int kBadShape = cudaErrorInvalidValue;

}  // namespace

// The instances: bf16 at D = 64 and 128; fp32 at 32, 64 and 128, and the fp32 lse-free
// forward also at 48 (the unmasked kernels' head dims). ``fp32`` picks the dtype; ``strides``
// holds 16 int64: q, k, v, dO (batch, token, head; in elements; dO's unread by the forward),
// then the mask's (batch, head, query, key) in bytes. Each returns the launch's CUDA error.
extern "C" int flash_attention_masked_fwd(const void* q, const void* k, const void* v, const unsigned char* mask,
                                          void* o, float* lse, int fp32, int B, int Tq, int Tk, int H, int D,
                                          const long long* strides, float scale, void* stream) {
  Args a = make_args(q, k, v, nullptr, mask, B, Tq, Tk, H, strides, scale, stream);
  a.out0 = o;
  a.lse_out = lse;
  const bool with_lse = lse != nullptr;
  if (fp32) {
    switch (D) {
      case 32: return with_lse ? launch_fwd<float, 32, true>(a) : launch_fwd<float, 32, false>(a);
      case 48: return with_lse ? kBadShape : launch_fwd<float, 48, false>(a);
      case 64: return with_lse ? launch_fwd<float, 64, true>(a) : launch_fwd<float, 64, false>(a);
      case 128: return with_lse ? launch_fwd<float, 128, true>(a) : launch_fwd<float, 128, false>(a);
      default: return kBadShape;
    }
  }
  switch (D) {
    case 64: return with_lse ? launch_fwd<bf16, 64, true>(a) : launch_fwd<bf16, 64, false>(a);
    case 128: return with_lse ? launch_fwd<bf16, 128, true>(a) : launch_fwd<bf16, 128, false>(a);
    default: return kBadShape;
  }
}

extern "C" int flash_attention_masked_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                             const unsigned char* mask, const float* lse, const float* delta,
                                             void* dq, int fp32, int B, int Tq, int Tk, int H, int D,
                                             const long long* strides, float scale, void* stream) {
  Args a = make_args(q, k, v, dout, mask, B, Tq, Tk, H, strides, scale, stream);
  a.lse_in = lse;
  a.delta = delta;
  a.out0 = dq;
  if (fp32) {
    switch (D) {
      case 32: return launch_dq<float, 32>(a);
      case 64: return launch_dq<float, 64>(a);
      case 128: return launch_dq<float, 128>(a);
      default: return kBadShape;
    }
  }
  switch (D) {
    case 64: return launch_dq<bf16, 64>(a);
    case 128: return launch_dq<bf16, 128>(a);
    default: return kBadShape;
  }
}

extern "C" int flash_attention_masked_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                              const unsigned char* mask, const float* lse, const float* delta,
                                              void* dk, void* dv, int fp32, int B, int Tq, int Tk, int H, int D,
                                              const long long* strides, float scale, void* stream) {
  Args a = make_args(q, k, v, dout, mask, B, Tq, Tk, H, strides, scale, stream);
  a.lse_in = lse;
  a.delta = delta;
  a.out0 = dk;
  a.out1 = dv;
  if (fp32) {
    switch (D) {
      case 32: return launch_dkv<float, 32>(a);
      case 64: return launch_dkv<float, 64>(a);
      case 128: return launch_dkv<float, 128>(a);
      default: return kBadShape;
    }
  }
  switch (D) {
    case 64: return launch_dkv<bf16, 64>(a);
    case 128: return launch_dkv<bf16, 128>(a);
    default: return kBadShape;
  }
}

// Dynamic shared memory of each kernel: ``kernel`` 0 the forward, 1 dq, 2 dk/dv; 0 where
// there is no such instance.
extern "C" int flash_attention_masked_smem(int kernel, int fp32, int D) {
  const int sizes_f32[3][4] = {{smem_fwd<float, 32>(), smem_fwd<float, 48>(), smem_fwd<float, 64>(),
                                smem_fwd<float, 128>()},
                               {smem_dq<float, 32>(), 0, smem_dq<float, 64>(), smem_dq<float, 128>()},
                               {smem_dkv<float, 32>(), 0, smem_dkv<float, 64>(), smem_dkv<float, 128>()}};
  const int sizes_bf16[3][4] = {{0, 0, smem_fwd<bf16, 64>(), smem_fwd<bf16, 128>()},
                                {0, 0, smem_dq<bf16, 64>(), smem_dq<bf16, 128>()},
                                {0, 0, smem_dkv<bf16, 64>(), smem_dkv<bf16, 128>()}};
  const int col = D == 32 ? 0 : D == 48 ? 1 : D == 64 ? 2 : D == 128 ? 3 : -1;
  if (kernel < 0 || kernel > 2 || col < 0) return 0;
  return fp32 ? sizes_f32[kernel][col] : sizes_bf16[kernel][col];
}
