// Device helpers of the port's attention kernels (flash_attention_fwd.cu and
// flash_attention_bwd.cu). Both: ex2, bf16 packing, the tiles' shared memory and the
// launch. The backward: cp.async staging into XOR-swizzled tiles,
// mma.sync m16n8k16 (bf16 in, fp32 accumulate), ldmatrix, and the A operand of a warp's
// 16-row products, held in registers or in shared memory. The bf16 forward, Hopper's own
// (sm_90a): mbarriers, TMA loads through tensor maps, wgmma with its shared-memory
// descriptors, named barriers and setmaxnreg.
// Tile sizes belong to each kernel instance (see the traits in each source).
#pragma once

#include <cuda.h>  // CUtensorMap and the driver's enums; the header alone, nothing is linked
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

// ---- Hopper: mbarriers, TMA, wgmma, named barriers, setmaxnreg ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// One arrival that also announces `bytes` of TMA traffic the phase must wait for.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` has completed (a fresh barrier is in phase 0,
// so waiting on parity 1 passes at once).
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: copy the box at coordinates (c0, c1, c2, c3) of a 4-D tensor map into shared
// memory at `dst`, completing `bytes` of the barrier's transaction count. Elements
// outside the tensor are written as zeros.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// Named barriers 1..15 (0 is __syncthreads): sync waits for `threads` arrivals, arrive
// adds this warp's without waiting.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Move registers between warpgroups (all four warps of one execute it together).
template <int R>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// wgmma shared-memory descriptor of a bf16 tile in the 128-byte swizzle that TMA writes
// (CU_TENSOR_MAP_SWIZZLE_128B): rows of 128 bytes (64 elements), in atoms of 8 rows
// (1024 bytes, the stride between 8-row groups). `lbo` is the byte stride between
// 64-element panels along M or N, read for MN-major operands only. The tile base must be
// 1024-byte aligned; a K-major operand advances along K by adding bytes within the row.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin registers that an asynchronous wgmma reads or writes at this point of the program,
// so that the compiler moves no access to them across a wgmma issue or wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int R, int C>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// wgmma m64nNk16, bf16 inputs, fp32 accumulators in the warpgroup's fragment layout
// (thread lane of warp w holds rows 16w + lane/4 and +8, columns 8j + 2(lane%4) and +1 of
// each 8-column group j: d[4j .. 4j+3]). ss: A and B from shared memory, both K-major
// (N = 176: S = Q K^T of the forward). rs: A from registers (the same fragment layout as
// mma.sync's m16n8k16 A, one per warp), B from shared memory MN-major (the transpose bit
// of 16-bit types; N = D: O += P V). `accumulate` = 0 overwrites d.
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  // d (64 x 64, fp32) (+)= a (64 x 16, registers) * b (16 x 64, smem, MN-major)
  __device__ __forceinline__ static void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
  }
};

template <>
struct Wgmma<128> {
  // d (64 x 128, fp32) (+)= a (64 x 16, registers) * b (16 x 128, smem, MN-major)
  __device__ __forceinline__ static void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
  }
};

template <>
struct Wgmma<176> {
  // d (64 x 176, fp32) (+)= a (64 x 16, smem, K-major) * b (16 x 176, smem, K-major)
  __device__ __forceinline__ static void ss(float (&d)[88], uint64_t a, uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %90, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n176k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87}, "
        "%88, %89, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87])
        : "l"(a), "l"(b), "r"(accumulate));
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
