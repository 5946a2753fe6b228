// The shared-memory primitives of the bf16 implicit-GEMM kernels (conv_tc.cu,
// conv_chain_tc.cu, wgrad_tc.cu): ldmatrix, plain and transposing, which
// loads wgmma's A fragments, and stmatrix.trans, which with ldmatrix turns
// a landed NCHW tile channels-last (cp.async is common.cuh's; Hopper's wgmma and
// mbarriers are hopper.cuh's), and the channels-last staging. A build may
// predefine NCT_TC_PRIMITIVES and supply its own, as it may NCT_LAUNCH, to
// run the kernels elsewhere than on the card.
#pragma once

#include "common.cuh"

#ifndef NCT_TC_PRIMITIVES
// four 8x8 b16 matrices; lane l gives the row address of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// the same, each matrix transposed: lane l receives elements (2 (l % 4), l / 4)
// and (2 (l % 4) + 1, l / 4) of its matrices (rows as addressed)
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// four 8x8 b16 matrices from registers, each stored transposed; lane l gives
// the row address of matrix l / 8
__device__ __forceinline__ void stsm_x4_t(uint32_t addr, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(r[0]),
               "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
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
  Walk() = default;
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

// 8 pixels from x of an image row of part q (row: its first pixel), as
// raw bf16 bits, zero outside [0, W); vec: the part's rows may be read as
// aligned 16-byte vectors.
__device__ __forceinline__ uint4 row8(const Part& q, int vec, const unsigned short* row, int x, int W) {
  if (vec && x >= 0 && x + 8 <= W) return *reinterpret_cast<const uint4*>(row + x);
  uint32_t e[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int xj = x + j;
    e[j] = (xj >= 0 && xj < W) ? row[xj * q.sw] : 0u;
  }
  return make_uint4(e[0] | (e[1] << 16), e[2] | (e[3] << 16), e[4] | (e[5] << 16), e[6] | (e[7] << 16));
}

// Four logical channels c0 .. c0 + 3 (of C) of a part list at batch b, image
// row y (of Hh), 8 pixels from x (of Ww), as four 16-byte rows of raw bf16
// bits; zero outside the image and past C.
__device__ __forceinline__ void load_quad(const Part* parts, const int* vec, int np, int C, int b, int c0,
                                          int y, int Hh, int x, int Ww, uint4 (&v)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = make_uint4(0, 0, 0, 0);
  if (c0 >= C || y < 0 || y >= Hh || x + 8 <= 0 || x >= Ww) return;
  int cc = c0;
  const int p = part_of(parts, np, cc);
  if (c0 + 4 <= C && cc + 4 <= parts[p].c) {  // four channels of one part
    const Part& q = parts[p];
    const unsigned short* row = static_cast<const unsigned short*>(q.ptr) + b * q.sb + cc * q.sc + y * q.sh;
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = row8(q, vec[p], row + k * q.sc, x, Ww);
    return;
  }
  for (int k = 0; k < 4 && c0 + k < C; ++k) {
    int ck = c0 + k;
    const int pk = part_of(parts, np, ck);
    const Part& q = parts[pk];
    v[k] = row8(q, vec[pk], static_cast<const unsigned short*>(q.ptr) + b * q.sb + ck * q.sc + y * q.sh, x, Ww);
  }
}

}  // namespace tc
}  // namespace nct
