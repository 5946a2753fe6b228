// Hopper's own tensor-core path for the bf16 implicit-GEMM kernels
// (conv_tc.cu, conv_chain_tc.cu, wgrad_tc.cu): warpgroup MMAs
// (wgmma.mma_async, A from registers, B from shared memory through a matrix
// descriptor) and the tap mainloops the convs run on them, the shared-memory
// barriers (mbarrier) that hand staged tiles from producer warpgroups to
// consumer warpgroups, tensor copies by the tensor memory accelerator that
// complete on such a barrier, the hand-over of registers between warpgroups
// (setmaxnreg), and named barriers over a warpgroup's threads. sm_90a only:
// wgmma and setmaxnreg do not exist on plain sm_90.
//
// The B operand sits in shared memory in the canonical K-major layout
// without swizzle: 8 x 8 "core matrices" (8 columns n, 8 values k each, one
// 16-byte row a column) of 128 contiguous bytes; a block of np columns stores
// its k-values 8 at a time, column after column, so value (n, k) is element
//   (k / 8) * np * 8 + n * 8 + k % 8
// (kmajor). A k16 step of an m64nNk16 wgmma then reads N / 8 core matrices
// 128 bytes apart along n (the stride byte offset) for each of its two
// k-halves, np * 16 bytes apart (the leading byte offset). No row is padded:
// a core matrix is 32 banks wide, so the reads are conflict-free.
//
// The A operand comes from registers: warp w of the warpgroup holds rows
// 16 w .. 16 w + 15 of the 64 (lane l: register 0 row l / 4, columns
// 2 (l % 4) and + 1, the low half first; register 1 the same 8 rows down;
// registers 2 and 3 those 8 columns right), which tc.cuh's ldsm_x4 loads
// from any 16 row addresses. The f32
// accumulator d of an m64nNk16: thread (warp w, lane l) holds, for each
// 8-column block j, d[4 j + e] at row 16 w + l / 4 + 8 (e / 2), column
// 8 j + 2 (l % 4) + e % 2.
#pragma once

#include <cuda.h>

#include "tc.cuh"

namespace nct {
namespace hop {

// element offset of (n, k) in a K-major block of np columns
__host__ __device__ constexpr int kmajor(int n, int k, int np) { return (k >> 3) * np * 8 + n * 8 + (k & 7); }

// The descriptor of a K-major, unswizzled B block at shared-space address
// addr with np columns: start address, leading byte offset (between the two
// 8-value k-halves of a k16 step) np * 16, stride byte offset (between
// 8-column groups) 128, all in 16-byte units; base offset 0, no swizzle.
// The k16 step s of the block starts 2 * np * 16 * s bytes further:
// desc + (np * 2 * s) in the address field (kstep).
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr, int np) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(np) << 16) |
         (static_cast<uint64_t>(128 >> 4) << 32);
}
__device__ __forceinline__ uint64_t kstep(uint64_t desc, int np, int s) { return desc + 2 * np * s; }
// the descriptor moved by a byte offset (a multiple of 16) inside the block
__device__ __forceinline__ uint64_t desc_at(uint64_t desc, uint32_t bytes) { return desc + (bytes >> 4); }

// d += A (64 x 16, four registers a warp-row fragment) x B (16 x N,
// descriptor b); asynchronous until wgmma_wait. wgmma_rs0: d = A x B
// afresh (scale-d 0), d an output only, so no other instruction has to
// define d first (ptxas serializes the wgmmas of a kernel where one does
// while a group is in flight).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b);
template <int N>
__device__ __forceinline__ void wgmma_rs0(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs0<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs0<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs0<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs0<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));
}

// The widths the weight-cotangent kernel and the 4x4/s2 conv's column groups
// add: one cout (8), 33 (40) and 65 (72) columns.
template <>
__device__ __forceinline__ void wgmma_rs<8>(float (&d)[4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3"
      "}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs0<8>(float (&d)[4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3"
      "}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));
}

template <>
__device__ __forceinline__ void wgmma_rs<40>(float (&d)[20], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19"
      "}, "
      "{%20, %21, %22, %23}, %24, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs0<40>(float (&d)[20], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19"
      "}, "
      "{%20, %21, %22, %23}, %24, p, 1, 1, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));
}

template <>
__device__ __forceinline__ void wgmma_rs<72>(float (&d)[36], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35"
      "}, "
      "{%36, %37, %38, %39}, %40, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs0<72>(float (&d)[36], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35"
      "}, "
      "{%36, %37, %38, %39}, %40, p, 1, 1, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));
}

// Before the first wgmma of a sequence whose registers (A or accumulator)
// other instructions wrote.
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
// wait until at most N committed groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin accumulator registers in place: the compiler sees each written here,
// so no read of them moves above the wgmma_wait before this (wgmma writes
// them asynchronously, which the asm's operands do not tell it).
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Generic-proxy writes to shared memory (the staged weights) made visible to
// the async proxy, which wgmma reads B through.
__device__ __forceinline__ void fence_async_shared() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// -- mbarriers (64-bit, in shared memory, shared-space addresses)
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// one arrival (release: this thread's earlier shared-memory accesses happen
// before the phase completes)
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// one arrival that also expects `bytes` more of asynchronous copies (tx-count)
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
// Host side: a bf16 tensor map of the given rank, dims, byte strides (of
// dims 1 ..) and box, zeros out of bounds, for tma_load_4d / tma_load_5d /
// tma_store_4d (the encoder found through the runtime's entry-point query,
// no link to libcuda); 0 or an error.
inline int tensor_map(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims, const cuuint64_t* strides,
                      const cuuint32_t* box, CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_NONE) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                              const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                              CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static const Encode encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q{};
    return cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q) == cudaSuccess &&
                   q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<Encode>(fn)
               : nullptr;
  }();
  if (!encode) return static_cast<int>(cudaErrorNotSupported);
  const cuuint32_t estr[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims, strides, box,
                            estr, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// A tensor copy (tile mode) of one box of a 4-d tensor map at signed
// coordinates (c0 innermost) into shared memory at dst (128-byte aligned), by
// the tensor memory accelerator; out-of-bounds elements land as zeros, and
// the box's bytes complete on bar's tx-count. The map lives in kernel
// parameter space (__grid_constant__).
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* map, int c0, int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, "
      "%5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// A tensor store of one box of a 4-d tensor map from shared memory at src
// (aligned as the map's swizzle needs), asynchronous: commit with
// bulk_commit; src may be written again once bulk_wait_read has returned.
// Elements outside the tensor are not written.
__device__ __forceinline__ void tma_store_4d(const void* map, int c0, int c1, int c2, int c3, uint32_t src) {
  asm volatile("cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%1, %2, %3, %4}], [%5];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(src)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
// wait until at most N committed tensor stores still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// wait until the committed tensor stores are complete
__device__ __forceinline__ void bulk_wait_all() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

// the same of a 5-d tensor map
__device__ __forceinline__ void tma_load_5d(uint32_t dst, const void* map, int c0, int c1, int c2, int c3, int c4,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, "
      "%5, %6}], [%7];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4), "r"(bar)
      : "memory");
}

// Wait (acquire) until the phase of the given parity has completed. A
// barrier starts in phase 0, so a wait on parity 1 returns at once: the
// producer's first pass over its empty barriers.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// One tap's A fragments on a consumer warpgroup (the warp's 16 rows, kch
// k16 steps from the lane's ldmatrix address; KMAX at most), and their
// wgmmas against a K-major B block of np columns (its first N): d = A x B
// over all of K, the first step afresh.
template <int N, int KMAX>
struct TapA {
  uint32_t f[KMAX][4];
  __device__ __forceinline__ void load(uint32_t addr, int kch) {
#pragma unroll
    for (int k = 0; k < KMAX; ++k)
      if (k < kch) ldsm_x4(f[k], addr + 32 * k);
  }
  __device__ __forceinline__ void mma(float (&d)[N / 2], uint64_t desc, int np, int kch) const {
    wgmma_rs0<N>(d, f[0], desc);
#pragma unroll
    for (int k = 1; k < KMAX; ++k)
      if (k < kch) wgmma_rs<N>(d, f[k], kstep(desc, np, k));
  }
};

// The mainloop of an m64 x N tile over `taps` taps: acc = the sum over taps
// t of A(t) x B(t), A at the lane's address addr(t), B the block at desc(t)
// (np columns). The tensor cores truncate their f32 sums, so each tap sums
// into a partial sum afresh and joins acc with one rounded add. Two sets of
// A fragments and partial sums alternate, so tap t's wgmmas run while tap
// t - 1's partial sum is added and tap t + 1's fragments load (a wait per
// tap would expose the wgmma latency nine times a tile); the loop runs two
// taps a turn and is not unrolled further (unrolled, it spilled). DEEP
// false: one set, one tap at a time. release() runs right after the last A
// read of the stage.
template <int N, int KMAX, bool DEEP = (N <= 64), class Addr, class Desc, class Release>
__device__ __forceinline__ void gemm_taps(float (&acc)[N / 2], int taps, int kch, int np, Addr addr, Desc desc,
                                          Release release) {
  constexpr int R = N / 2;
  if constexpr (!DEEP) {
    // one tap at a time, where two sets do not fit beside acc and the
    // caller's state (N = 128: 64 + 2 x 64 + 2 x 32 registers)
    TapA<N, KMAX> a;
    float p[R];
#pragma unroll
    for (int e = 0; e < R; ++e) acc[e] = 0.f;
#pragma unroll 1
    for (int t = 0; t < taps; ++t) {
      a.load(addr(t), kch);
      if (t == taps - 1) release();
      wgmma_fence();
      a.mma(p, desc(t), np, kch);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(p);
#pragma unroll
      for (int e = 0; e < R; ++e) acc[e] += p[e];
    }
  } else {
    TapA<N, KMAX> a0, a1;
    float p0[R], p1[R];
    const auto join = [&](float (&p)[R]) {
      fence_regs(p);
#pragma unroll
      for (int e = 0; e < R; ++e) acc[e] += p[e];
    };
#pragma unroll
    for (int e = 0; e < R; ++e) acc[e] = 0.f;
    a0.load(addr(0), kch);
    if (taps == 1) release();
    wgmma_fence();
    a0.mma(p0, desc(0), np, kch);
    wgmma_commit();
    int t = 1;
#pragma unroll 1
    for (; t + 1 < taps; t += 2) {  // taps t (set 1) and t + 1 (set 0)
      a1.load(addr(t), kch);
      wgmma_fence();
      a1.mma(p1, desc(t), np, kch);
      wgmma_commit();
      wgmma_wait<1>();  // tap t - 1
      join(p0);
      a0.load(addr(t + 1), kch);
      if (t + 2 == taps) release();
      wgmma_fence();
      a0.mma(p0, desc(t + 1), np, kch);
      wgmma_commit();
      wgmma_wait<1>();  // tap t
      join(p1);
    }
    if (t < taps) {  // the last tap, on set 1
      a1.load(addr(t), kch);
      release();
      wgmma_fence();
      a1.mma(p1, desc(t), np, kch);
      wgmma_commit();
      wgmma_wait<1>();
      join(p0);
      wgmma_wait<0>();
      join(p1);
    } else {
      wgmma_wait<0>();
      join(p0);
    }
  }
}

// MT m64 tiles over the same taps and B blocks at once: acc[m] = the sum
// over taps t of A(m, t) x B(t). A tap's fragments of all MT tiles load, their
// wgmmas issue as one group, and one wait a tap covers them (at small N a
// group's time is its latency, so MT tiles cost about what one does); each
// tile's partial sum joins its total with one rounded add.
template <int N, int KMAX, int MT, class Addr, class Desc, class Release>
__device__ __forceinline__ void gemm_taps_mt(float (&acc)[MT][N / 2], int taps, int kch, int np, Addr addr,
                                             Desc desc, Release release) {
  TapA<N, KMAX> a[MT];
  float p[MT][N / 2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int e = 0; e < N / 2; ++e) acc[m][e] = 0.f;
#pragma unroll 1
  for (int t = 0; t < taps; ++t) {
#pragma unroll
    for (int m = 0; m < MT; ++m) a[m].load(addr(m, t), kch);
    if (t == taps - 1) release();
    wgmma_fence();
    const uint64_t d = desc(t);
#pragma unroll
    for (int m = 0; m < MT; ++m) a[m].mma(p[m], d, np, kch);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      fence_regs(p[m]);
#pragma unroll
      for (int e = 0; e < N / 2; ++e) acc[m][e] += p[m][e];
    }
  }
}

// Hand registers between warpgroups (all four warps of a warpgroup run it):
// a producer gives back to PREG, a consumer takes up to CREG. The block's
// pool is its launch allocation, so a plan must satisfy 128 x (producers x
// PREG + consumers x CREG) <= threads x the kernel's register count, which
// the host checks before a launch (reg_plan_fits): an increase the pool
// cannot serve would wait for ever.
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// Host side: whether kernel k's register count serves a setmaxnreg plan of
// `producers` and `consumers` warpgroups at preg and creg registers a
// thread (the count is the kernel's, cached by the caller).
template <class K>
inline bool reg_plan_fits(K k, int threads, int producers, int preg, int consumers, int creg) {
  cudaFuncAttributes fa{};
  if (cudaFuncGetAttributes(&fa, k) != cudaSuccess) return false;
  return 128 * (producers * preg + consumers * creg) <= threads * fa.numRegs;
}

// A barrier over the n threads (whole warps) that name it: id 1..15 (0 is
// __syncthreads').
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// The ring of input stages a producer warpgroup fills and the consumer
// warpgroups drain: stage i % n of the block's i-th tile, full[s] completed
// by every producer thread's arrival, empty[s] by every consumer thread's.
// Phase of the i-th use of a stage: (i / n) & 1.
struct Ring {
  uint32_t full, empty;  // shared-space address of full[0] / empty[0]; stage s at + 8 s
  int n;
  __device__ __forceinline__ uint32_t parity(int i) const { return (i / n) & 1; }
  __device__ __forceinline__ int stage(int i) const { return i % n; }
  __device__ __forceinline__ void init(int producers, int consumers) const {
    for (int s = 0; s < n; ++s) {
      mbar_init(full + 8 * s, producers);
      mbar_init(empty + 8 * s, consumers);
    }
  }
  // the producer's side of tile i: wait for the stage to be free, then (after
  // its writes) mark it full
  __device__ __forceinline__ void acquire(int i) const { mbar_wait(empty + 8 * stage(i), parity(i) ^ 1); }
  __device__ __forceinline__ void publish(int i) const { mbar_arrive(full + 8 * stage(i)); }
  // the consumers' side: wait for the stage to be full, then (after their
  // last read) hand it back
  __device__ __forceinline__ void take(int i) const { mbar_wait(full + 8 * stage(i), parity(i)); }
  __device__ __forceinline__ void release(int i) const { mbar_arrive(empty + 8 * stage(i)); }
};

}  // namespace hop
}  // namespace nct
