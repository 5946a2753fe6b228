// The tensor-core primitives of the bf16 implicit-GEMM kernels (conv_tc.cu,
// conv_chain_tc.cu): ldmatrix and mma.sync m16n8k16 bf16 -> f32. A build may
// predefine NCT_TC_PRIMITIVES and supply its own, as it may NCT_LAUNCH, to
// run the kernels elsewhere than on the card.
#pragma once

#include "common.cuh"

#ifndef NCT_TC_PRIMITIVES
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices; lane l gives the row address of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
#endif

namespace nct {
namespace tc {

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// A thread's walk over a flat index i = tid, tid + nthr, ... as the pair
// (q, rest) = (i % n, i / n), one division at the start and none a step.
struct Walk {
  int q, rest, dq, dr, nq;
  __device__ __forceinline__ Walk(int i, int nthr, int n)
      : q(i % n), rest(i / n), dq(nthr % n), dr(nthr / n), nq(n) {}
  __device__ __forceinline__ void next() {
    q += dq;
    rest += dr;
    if (q >= nq) {
      q -= nq;
      ++rest;
    }
  }
};

// Pixel j of four 16-byte rows of 8 bf16 (one per channel of a quad), as one
// 8-byte channel-quad: the unit of the channels-last staging.
__device__ __forceinline__ uint2 quad_of(const uint4 (&v)[4], int j) {
  const uint32_t sel = (j & 1) ? 0x7632 : 0x5410;  // high or low halves of two words
  return make_uint2(__byte_perm(word(v[0], j >> 1), word(v[1], j >> 1), sel),
                    __byte_perm(word(v[2], j >> 1), word(v[3], j >> 1), sel));
}

}  // namespace tc
}  // namespace nct
