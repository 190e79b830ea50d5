// Device helpers shared by the port's attention kernels (flash_attention_fwd.cu and
// flash_attention_bwd.cu): cp.async staging into XOR-swizzled bf16 tiles, mma.sync
// m16n8k16 (bf16 in, fp32 accumulate), ldmatrix, bf16 packing, the tiles' shared memory,
// and the A operand of a warp's 16-row products, held in registers or in shared memory.
// Tile sizes belong to each kernel instance (see the traits in each source).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <cmath>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kStaticSmemLimit = 48 * 1024;  // above this a kernel must opt in

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// BYTES of shared memory for the block's tiles: a static array when it fits the 48 KB
// that static shared memory allows (every D = 64 instance), else the block's dynamic
// shared memory, which the launch sizes (launch() below).
template <int BYTES>
__device__ __forceinline__ unsigned char* block_smem() {
  if constexpr (BYTES <= kStaticSmemLimit) {
    __shared__ __align__(128) unsigned char smem[BYTES];
    return smem;
  } else {
    extern __shared__ __align__(128) unsigned char dyn_smem[];
    return dyn_smem;
  }
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
// XOR-swizzled by the row's low three bits. Conflict-free at D = 64 and D = 128 alike:
// a row is 8 or 16 chunks, and the XOR on the low three chunk bits sends the same
// chunk of 8 consecutive rows to 8 different 16-byte bank groups.
template <int D>
__device__ __forceinline__ int swz(int row, int col) {
  return row * D + ((((col >> 3) ^ (row & 7))) << 3) + (col & 7);
}

template <int D>
__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* tile, int row, int col) {
  return *reinterpret_cast<const uint32_t*>(tile + swz<D>(row, col));
}

// Stage rows [row0, row0 + ROWS) of one (batch, head) slice into a swizzled tile with
// THREADS threads; rows at or past `rows_total` are zero-filled.
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* base,
                                          long long stride_t, int row0, int rows_total,
                                          int tid) {
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int i = tid; i < ROWS * kChunks; i += THREADS) {
    const int r = i / kChunks, c = i % kChunks;
    const int gr = row0 + r;
    const bool valid = gr < rows_total;
    const __nv_bfloat16* src = base + static_cast<long long>(valid ? gr : 0) * stride_t + c * 8;
    cp_async_16(dst + swz<D>(r, c * 8), src, valid);
  }
}

// The A operand (16 rows x D) of a warp's products, rows r0 .. r0+15 of a swizzled tile.
// RegA loads its fragments into registers once; SmemA reads them from the tile at each
// use, which frees D / 4 registers a thread where the D = 128 instances need them.
template <int D>
struct RegA {
  uint32_t f[D / 16][4];
  __device__ __forceinline__ void load(const __nv_bfloat16* tile, int r0, int g, int t) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 + 2 * t;
      f[kk][0] = lds32<D>(tile, r0 + g, c);
      f[kk][1] = lds32<D>(tile, r0 + g + 8, c);
      f[kk][2] = lds32<D>(tile, r0 + g, c + 8);
      f[kk][3] = lds32<D>(tile, r0 + g + 8, c + 8);
    }
  }
  __device__ __forceinline__ void get(int kk, uint32_t (&a)[4]) const {
    a[0] = f[kk][0];
    a[1] = f[kk][1];
    a[2] = f[kk][2];
    a[3] = f[kk][3];
  }
};

template <int D>
struct SmemA {
  const __nv_bfloat16* tile;
  int r0, g, t;
  __device__ __forceinline__ void load(const __nv_bfloat16* tile_, int r0_, int g_, int t_) {
    tile = tile_;
    r0 = r0_;
    g = g_;
    t = t_;
  }
  __device__ __forceinline__ void get(int kk, uint32_t (&a)[4]) const {
    const int c = kk * 16 + 2 * t;
    a[0] = lds32<D>(tile, r0 + g, c);
    a[1] = lds32<D>(tile, r0 + g + 8, c);
    a[2] = lds32<D>(tile, r0 + g, c + 8);
    a[3] = lds32<D>(tile, r0 + g + 8, c + 8);
  }
};

// Raises a kernel instance's dynamic shared memory limit once per device, before its
// first launch there. One object per instance (a static in the instance's launcher).
struct SmemOptIn {
  std::atomic<unsigned> ready{0};  // one bit per device
  template <class Kernel>
  cudaError_t operator()(Kernel kernel, int bytes) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const unsigned bit = 1u << (dev & 31);
    if (ready.load() & bit) return cudaSuccess;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess) ready.fetch_or(bit);
    return err;
  }
};

// Launch `kernel`, whose tiles take `smem` bytes (block_smem<smem>): above 48 KB as
// dynamic shared memory, after raising the instance's limit (once per device, through
// its own `opt_in`). Returns the attribute call's error if it failed, else
// cudaGetLastError() after the launch (0 on success).
template <class Kernel, class... Args>
int launch(Kernel kernel, SmemOptIn& opt_in, dim3 grid, int threads, int smem, cudaStream_t st,
           Args... args) {
  const int dynamic = smem > kStaticSmemLimit ? smem : 0;
  if (dynamic) {
    const cudaError_t err = opt_in(kernel, dynamic);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, threads, dynamic, st>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// Dispatch on the head dim: 64 and 128 are instantiated; any other D, and empty shapes,
// are refused with cudaErrorInvalidValue.
template <class Fn64, class Fn128>
int by_head_dim(int D, int B, int Tq, int Tk, int H, Fn64 fn64, Fn128 fn128) {
  if (B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 64:
      return fn64();
    case 128:
      return fn128();
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
