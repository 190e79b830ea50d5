// Device helpers of the port's attention kernels (flash_attention_fwd.cu and
// flash_attention_bwd.cu): ex2, bf16 packing and the launch; Hopper (sm_90a) primitives:
// mbarriers, TMA loads through tensor maps (encoded on the host from the layout
// ops/flash_attention.py's tensor_map computes), wgmma with its shared-memory descriptors,
// named barriers and setmaxnreg; and the fp32 instances' split arithmetic: three bf16 parts
// of each fp32 value, six bf16 products for each fp32 one. Tile sizes belong to each kernel
// instance (see the plans in each source).
#pragma once

#include <cuda.h>  // CUtensorMap and the driver's enums; the header alone, nothing is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <climits>
#include <cmath>
#include <type_traits>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kStaticSmemLimit = 48 * 1024;  // above this a kernel must opt in

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

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

// The same in the 32-byte swizzle (the fp32 tiles at D = 32 and 48, written by
// fa_fwd_f32_narrow's producer or by TMA under CU_TENSOR_MAP_SWIZZLE_32B): rows of 32 bytes (16
// elements, one k-step of a K-major operand), in atoms of 8 rows (256 bytes, the stride
// between 8-row groups); the 16-byte chunk c of row r lies at chunk c ^ ((r >> 2) & 1).
// `lbo` is the byte stride between 16-column panels along M or N, read for MN-major
// operands only. The tile base must be 256-byte aligned.
__device__ __forceinline__ uint64_t sw32_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32) | (3ull << 62);
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
// (S = Q K^T of the bf16 forward at N = 176, of the fp32 forward at N = 32, 64, 96 and
// 128; the backward's S and dP at N = 32, 64, 96 and 128). rs: A
// from registers (the same fragment layout as mma.sync's m16n8k16 A, one per warp), B
// from shared memory MN-major (the transpose bit of 16-bit types; N = D: the forward's
// O += P V, the backward's dQ += dS K, dV += P^T dO and dK += dS^T Q; the narrow fp32
// forward's P V and the fp32 D = 32 backward's dS K, P^T dO and dS^T Q over one, two or
// three parts at N = 32, 64, 96 (D = 32) and 48, 96, 144 (D = 48)). `accumulate` = 0
// overwrites d.
template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  // d (64 x 32, fp32) (+)= a (64 x 16, smem, K-major) * b (16 x 32, smem, K-major)
  __device__ __forceinline__ static void ss(float (&d)[16], uint64_t a, uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(accumulate));
  }
  // d (64 x 32, fp32) (+)= a (64 x 16, registers) * b (16 x 32, smem, MN-major)
  __device__ __forceinline__ static void rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
  }
};

template <>
struct Wgmma<48> {
  // d (64 x 48, fp32) (+)= a (64 x 16, registers) * b (16 x 48, smem, MN-major)
  __device__ __forceinline__ static void rs(float (&d)[24], const uint32_t (&a)[4], uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23}, "
        "{%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
  }
};

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
// d (64 x 64, fp32) (+)= a (64 x 16, smem, K-major) * b (16 x 64, smem, K-major)
  __device__ __forceinline__ static void ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <>
struct Wgmma<96> {
  // d (64 x 96, fp32) (+)= a (64 x 16, smem, K-major) * b (16 x 96, smem, K-major)
  __device__ __forceinline__ static void ss(float (&d)[48], uint64_t a, uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
        "%48, %49, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "l"(a), "l"(b), "r"(accumulate));
  }
  // d (64 x 96, fp32) (+)= a (64 x 16, registers) * b (16 x 96, smem, MN-major)
  __device__ __forceinline__ static void rs(float (&d)[48], const uint32_t (&a)[4], uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
        "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
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
  // d (64 x 128, fp32) (+)= a (64 x 16, smem, K-major) * b (16 x 128, smem, K-major)
  __device__ __forceinline__ static void ss(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <>
struct Wgmma<144> {
  // d (64 x 144, fp32) (+)= a (64 x 16, registers) * b (16 x 144, smem, MN-major)
  __device__ __forceinline__ static void rs(float (&d)[72], const uint32_t (&a)[4], uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %77, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71}, "
        "{%72, %73, %74, %75}, %76, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71])
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

// Launch `kernel`, whose tiles take `smem` bytes: above 48 KB as dynamic shared memory, after raising the instance's limit (once per device, through
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

// Dispatch on the head dim: `fn` is called with std::integral_constant<int, D> for the D
// among `Dims` (the instantiated head dims of the caller's instance family); any other D,
// and empty shapes, are refused with cudaErrorInvalidValue.
template <int... Dims, class Fn>
int by_head_dim(int D, int B, int Tq, int Tk, int H, Fn fn) {
  if (B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int err = static_cast<int>(cudaErrorInvalidValue);
  ((D == Dims ? (err = fn(std::integral_constant<int, Dims>{}), true) : false) || ...);
  return err;
}

// ---- The fp32 instances: each product as six bf16 products of split operands ----

// bf16 halves of a packed pair as fp32 (the low half is the pair's first value).
__device__ __forceinline__ float bf16_low(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_high(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// Split the pair (a, b) into three packed bf16 pairs, a in each low half: hi = bf16(x),
// mid = bf16(x - hi), lo = bf16(x - hi - mid), rounded to nearest even. Both differences
// are exact in fp32, and x - hi - mid - lo is within 2^-24 |x|: the parts carry x's 24
// significand bits (ops/flash_attention.py's split_bf16x3_reference is the same split).
__device__ __forceinline__ void split3(float a, float b, uint32_t& hi, uint32_t& mid, uint32_t& lo) {
  hi = pack_bf16(a, b);
  a -= bf16_low(hi);
  b -= bf16_high(hi);
  mid = pack_bf16(a, b);
  a -= bf16_low(mid);
  b -= bf16_high(mid);
  lo = pack_bf16(a, b);
}

// The descriptor of the tile `off` bytes past the tile whose descriptor is `base`, formed
// here: the address field is the low 14 bits of the descriptor (bytes / 16), and no tile
// here carries out of it. A product over three parts addresses 3 * D / 16 tiles of each
// operand; without the pin the compiler forms their 64-bit descriptors ahead of the
// wgmma (dq spilled 16 bytes at D = 64).
__device__ __forceinline__ uint64_t desc_at(uint64_t base, uint32_t off) {
  asm volatile("" : "+l"(base));
  return base + (off >> 4);
}

// 0, read from shared memory at each call: added to a tile base that does not change over
// the kernel's loops (dq's Q and dO, dk/dv's K and V), it keeps ptxas from forming that
// operand's 3 * D / 16 descriptors once and holding them across the loops (96 registers
// at D = 128, where they spilled 36 and 100 bytes).
__device__ __forceinline__ uint32_t reloaded_zero(const uint32_t* zero) {
  return *static_cast<const volatile uint32_t*>(zero);
}

// The six bf16 products of a split product A B, pass p taking part pass_a(p) of A and
// pass_b(p) of B (0 hi, 1 mid, 2 lo): lo.hi, mid.mid, hi.lo, mid.hi, hi.mid, hi.hi. The
// small terms go first, while the accumulator is still small; the dropped terms (mid.lo,
// lo.mid, lo.lo) are of order 2^-24 of the product and below.
__host__ __device__ constexpr int pass_a(int p) { return p == 0 ? 2 : p == 1 || p == 3 ? 1 : 0; }
__host__ __device__ constexpr int pass_b(int p) { return p == 2 ? 2 : p == 1 || p == 4 ? 1 : 0; }
constexpr int kPasses = 6;

// x (64 x N fp32 accumulators) as three sets of bf16 A fragments, one per 16 columns:
// pa[part * N / 16 + kk].
template <int N>
__device__ __forceinline__ void split_fragments(uint32_t (&pa)[3 * N / 16][4], const float (&x)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      split3(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1], pa[kk][i], pa[N / 16 + kk][i], pa[2 * N / 16 + kk][i]);
}

// Store a consumer's 64 x D fp32 accumulators (the wgmma fragment layout; acc(i) reads
// element i), times `mul`, as rows row0 and row0 + 8 of a contiguous fp32 (B, T, H, D);
// rows at or past T are skipped.
template <int D, class Acc>
__device__ __forceinline__ void store_rows_f32(float* out, const Acc& acc, float mul, int b, int h, int row0, int T,
                                               int H, int t) {
  static_assert(D % 8 == 0, "a row stores whole 8-column fragment groups of the accumulator");
  const int row1 = row0 + 8;
  float* o0 = out + ((static_cast<long long>(b) * T + row0) * H + h) * D;
  float* o1 = out + ((static_cast<long long>(b) * T + row1) * H + h) * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (row0 < T) *reinterpret_cast<float2*>(o0 + col) = make_float2(acc(4 * j) * mul, acc(4 * j + 1) * mul);
    if (row1 < T) *reinterpret_cast<float2*>(o1 + col) = make_float2(acc(4 * j + 2) * mul, acc(4 * j + 3) * mul);
  }
}

// ---- Host: TMA tensor maps and the persistent grid ----

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, found through the runtime (cudaGetDriverEntryPoint),
// so that the library links nothing beyond the runtime. Null if the driver lacks it.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(ptr)
                                                                      : nullptr;
  }();
  return fn;
}

// One tensor's map: m holds the global dims (D, T, H, B), the byte strides of T, H and
// B, and the box (cols, rows, 1, 1), as ops/flash_attention.py's tensor_map computes them:
// cols 64, one row of the 128-byte swizzle (sw128_desc), or 16, one row of the 32-byte
// swizzle (sw32_desc: the fp32 D = 32 backward's 16-column panels). Refuses
// (cudaErrorInvalidValue) a map whose dims or box do not fit the launch.
int encode_map(CUtensorMap* map, const void* ptr, const long long* m, int D, int T, int H, int B, int rows,
               int cols = 64) {
  if (m[0] != D || m[1] != T || m[2] != H || m[3] != B || m[7] != cols || m[8] != rows || m[9] != 1 ||
      m[10] != 1 || (cols != 64 && cols != 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(m[0]), static_cast<cuuint64_t>(m[1]),
                              static_cast<cuuint64_t>(m[2]), static_cast<cuuint64_t>(m[3])};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(m[4]), static_cast<cuuint64_t>(m[5]),
                                 static_cast<cuuint64_t>(m[6])};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols), static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

constexpr int kMapLongs = 11;  // dims[4], strides[3], box[4]

// The persistent grid over `work` tiles: one block an SM, and no more blocks than tiles.
// Sets n_work and blocks; returns cudaErrorInvalidValue if the tiles do not fit an int,
// else the device queries' error.
int persistent_grid(long long work, int& n_work, int& blocks) {
  if (work > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  n_work = static_cast<int>(work);
  int dev = 0, sms = 0;
  int err = static_cast<int>(cudaGetDevice(&dev));
  if (!err) err = static_cast<int>(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  blocks = std::min(n_work, sms);
  return err;
}

}  // namespace
