// Device helpers shared by the port's attention kernels (flash_attention_fwd.cu and
// flash_attention_bwd.cu): tile sizes, cp.async staging into XOR-swizzled bf16 tiles,
// mma.sync m16n8k16 (bf16 in, fp32 accumulate), ldmatrix and bf16 packing.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kBlockM = 64;  // query rows per block
constexpr int kBlockN = 64;  // keys per K/V tile
constexpr int kWarps = 4;    // bf16 instances: 16 rows per warp
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 16-byte async copy global -> shared; src_bytes = 0 zero-fills the destination.
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// d += a * b for one 16x8x16 tile, bf16 inputs, fp32 accumulation.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// Element offset of (row, col) in a [rows][D] bf16 tile whose 16-byte chunks are
// XOR-swizzled by the row's low three bits.
template <int D>
__device__ __forceinline__ int swz(int row, int col) {
  return row * D + ((((col >> 3) ^ (row & 7))) << 3) + (col & 7);
}

template <int D>
__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* tile, int row, int col) {
  return *reinterpret_cast<const uint32_t*>(tile + swz<D>(row, col));
}

// Stage rows [row0, row0 + ROWS) of one (batch, head) slice into a swizzled tile;
// rows at or past `rows_total` are zero-filled.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* base,
                                          long long stride_t, int row0, int rows_total,
                                          int tid) {
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int i = tid; i < ROWS * kChunks; i += kWarps * 32) {
    const int r = i / kChunks, c = i % kChunks;
    const int gr = row0 + r;
    const bool valid = gr < rows_total;
    const __nv_bfloat16* src = base + static_cast<long long>(valid ? gr : 0) * stride_t + c * 8;
    cp_async_16(dst + swz<D>(r, c * 8), src, valid);
  }
}

}  // namespace
