// K2 and K3 in bf16 on the tensor cores: the 3x3 pad-1 conv (stride 1 or 2,
// bias, ReLU, optional fused 1x1 residual shortcut, input as a list of
// parts), the 4x4/s2/p1 transpose conv (bias, ReLU, parts), and three
// input cotangents of the mixed schedule's backward, no bias: the 3x3/s2/p1
// transpose conv with output_padding 1 (of a 3x3 stride-2 conv), the 3x3
// pad-1 conv with the flipped, in/out-transposed weight (of a stride-1
// conv) and the 4x4/s2/p1 conv (of the 4x4/s2 transpose conv); bf16 in and
// out with f32 accumulation, as implicit-GEMM kernel templates behind one
// entry (nct_conv_tc).
//
// Replaces nconv_tpu/ops/pallas_conv.py:_kernel (:128) in its bf16 stride-1,
// residual_channels, multi-part, stride-2 and d2s_channels forms (the mixed
// schedule's feature convs), and in the three bf16 forms the mixed
// schedule's backward runs: the d2s_channels form on the stride-2 cotangent
// (pallas_s2._s2_res_bwd, :123-136), the stride-1 conv of the cotangent
// with the flipped kernel (pallas_conv.transpose_conv_bhcw, :797) and the
// lane_stride2 kw=4 conv of the transpose conv's cotangent (pallas_s2._ct_bwd,
// :220). f32 stays on the CUDA-core kernels of conv.cu and convt.cu, the
// uint8 frame and the 1-channel heads run on conv_thin.cu, and the bf16
// conv chain on conv_chain_tc.cu, which shares tc.cuh and hopper.cuh.
//
// Bound on the H100: at 32-64 channels a 3x3 conv does 2*9*cout FLOP per
// input value over (cin + cout) * 2 bytes, at the card's bf16 ridge (~295
// FLOP/byte), so both the bytes and the tensor-core issue matter, and a
// design that reads its input once per few output channels (as conv.cu
// does) is bound by re-reads. So every mode runs one implicit-GEMM design
// on Hopper's warpgroup MMAs (conv_wg_kernel):
//  * GEMM: M = the output pixels of a tile (rows of TW = 16 along W; a
//    transpose conv tiles its input grid), N = every output channel of the
//    block's column group (the residual form's shortcut is a second
//    accumulator that runs the centre tap only), K = taps x cin.
//  * The input tile is staged once, channels-last ([pixel][channel], rows
//    padded by 8 channels so ldmatrix is conflict-free), transposed on the
//    way in from NCHW: 16-byte vectors along W where a part allows it,
//    elements otherwise (strided views); channels past cin zero-filled. A tap
//    (ky, kx) at stride 1 or 2 is then just a per-lane row address: no
//    im2col, no shifted copies. Each input byte leaves HBM once, plus the
//    halo.
//  * A block holds the weights of its columns resident in shared memory as
//    bf16 (rounded to nearest even as it stages them from their stored type,
//    f32 or bf16), staged once: blocks are persistent (one an SM) and loop
//    over tiles.
//  * Two producer warpgroups stage input tiles into a ring of one or two
//    stages, each guarded by a pair of mbarriers (full: every producer
//    thread's arrival; empty: every consumer thread's, after its last
//    ldmatrix of the tile, so the next tile loads during the last tap's
//    MMAs and the epilogue). Neighbouring producer threads read neighbouring
//    16-byte pieces of a channel row and keep four units' loads in flight.
//  * One or two consumer warpgroups each own 4 tile rows (64 GEMM rows) and
//    run wgmma m64nNk16 (N = 32, 40, 64 or 128): A from registers (ldmatrix
//    at the per-lane tap addresses), B read straight from the resident
//    weights through descriptors (K-major, hopper.cuh). The tensor cores
//    truncate their f32 sums, so each tap sums into a partial sum afresh
//    and joins the total with one rounded add; two taps are in flight
//    (hopper.cuh, gemm_taps), since at these widths a tap's time is mostly
//    the wgmma's latency. setmaxnreg leaves the producers 104-112 registers
//    and gives the consumers 152 (two warpgroups) or 232 (one); the host
//    checks the kernel's register count against that plan before a launch.
//  * Each consumer warpgroup has its own output stage and synchronises only
//    its own 128 threads (named barriers). Epilogue: bias in f32, ReLU, the
//    shortcut added, one rounding to bf16, staged so the NCHW stores are
//    16-byte vectors (a transpose conv's depth-to-space included).
//  * Plan (wg_plan): two consumer warpgroups (8 tile rows) where N <= 64
//    (32 for a transpose conv) and kc <= 64 (T3 in chains: any kc), else
//    one (4 rows); two stages where they fit beside the weights, else one.
// The transpose convs run their output parities in turn on each consumer's
// rows, so the warpgroups share the work evenly:
//  * T (4x4/s2): parity (py, px) takes 2x2 of the 16 taps (dy in {-1, 0}
//    for py = 0, {0, 1} for py = 1, the same for x), 4 taps each.
//  * T3 (3x3/s2, output_padding 1): output (2i + py, 2j + px) reads input
//    (i + ay, j + ax) at tap (py + 1 - 2 ay, px + 1 - 2 ax): parity (0, 0)
//    1 tap, (0, 1) and (1, 0) 2, (1, 1) 4. The residual conv's backward
//    stacks its 1x1 shortcut under the 3x3 weight (cotangent [gm | g]), so
//    the trailing half of K meets non-zero weights only at the centre tap,
//    which parity (0, 0) alone reads: the caller passes that count
//    (`centre`) and the other parities' taps stop at the channels before it
//    (at 128 -> 64 channels 40 k16 steps a tile instead of 72). All nine
//    taps stay resident (147 KB at 128 -> 64 channels).
//    Where the cotangent is one part of aligned rows, one producer thread
//    lands a tile's window as one tensor copy (T3_BOXW x (TH + 1) x kc, NCHW
//    as stored, zeros outside the image and past cin) and the producers
//    turn it channels-last (ldmatrix, stmatrix.trans), so the producers'
//    per-thread copies no longer crowd the consumers' issue slots.
//    Where kc is a multiple of 64, a tap runs as chains of 64 channels,
//    4 k16 steps a compile-time count (no predicated step), the channels
//    before `centre` rounded up to a block, and two consumer warpgroups
//    take a tile where their shared memory fits (128 -> 32).
//  * K4 (the 4x4/s2/p1 conv, input cotangent of T) is mode S2's geometry
//    with a 4x4 footprint: an input tile of (TH - 1) * 2 + 4 rows by 34
//    pixels, 16 tap slots. Its 16 taps at 64 -> 65 channels would take 262 KB
//    of resident weights at 128 columns, so the columns go in the fewest
//    groups of at most 64 (32, 40 or 64 wide; 65 -> two groups of 40)
//    whose plan fits a block (dispatch_k4); a block holds one group's
//    weights and walks every tile for it, and the blocks of one tile are
//    neighbours in the grid, so the input's second read comes from L2.
#include "hopper.cuh"

namespace nct {
namespace tc {

constexpr int TW = 16;  // tile width in output pixels: 16 GEMM rows per tile row
constexpr int T3_BOXW = 24;  // T3 by tensor copies: a tile's 17 input columns from ox0, 16-byte rows

// conv stride 1, conv stride 2, 4x4/s2 transpose conv, 3x3/s2 transpose
// conv, 4x4/s2 conv, and the stride-1 conv on a flipped, in/out-transposed
// weight (mode S1 with w_flip on the C entry)
enum Mode : int { S1 = 0, S2 = 1, T = 2, T3 = 3, K4 = 4, S1F = 5 };

// the transpose convs tile their input grid and store depth-to-space
__host__ __device__ constexpr bool transposed(int mode) { return mode == T || mode == T3; }
__host__ __device__ constexpr int stride_of(int mode) { return mode == S2 || mode == K4 ? 2 : 1; }
__host__ __device__ constexpr int ksize(int mode) { return mode == K4 ? 4 : 3; }
__host__ __device__ constexpr int slots(int mode, bool res) {
  return mode == T || mode == K4 ? 16 : mode == T3 ? 9 : (res ? 10 : 9);
}

struct Args {
  CUtensorMap xmap;  // T3: the cotangent, one part, as (W, H, C, B), boxes of T3_BOXW x (TH + 1) x kc
  Part parts[MAX_PARTS];
  int vec[MAX_PARTS];  // 1: rows may be read as aligned 16-byte vectors
  int nparts, B, H, W, cin, cout, ho, wo;
  int kc;     // cin rounded up to 16
  int cps;    // shared-memory row of a staged pixel, bf16: kc + 8
  int centre;  // T3: trailing input channels whose weights are centre-only
  int tma;     // T3: the cotangent lands by tensor copies and is turned channels-last in shared memory
  int blocks64, blocks64_c;  // T3 where kc is a multiple of 64: 64-channel blocks of the centre tap, of the others
  int kch_c;   // T3: k16 steps of the taps outside parity (0, 0), cin without those channels
  int coutp;   // a block's columns: its group of cout, rounded up to the columns of the warps (wgmma: N)
  int groups;  // column groups: block b computes columns [(b % groups) * coutp, + coutp)
  int stages;  // wgmma: input stages in the ring (1 or 2)
  int relu;
  const void* w;    // conv (cout, cin, k, k); transpose conv and S1F (cin, cout, k, k)
  const void* wsc;  // (cout, cin): 1x1 shortcut of the residual form, w's type
  int w_bf16;
  const void* bias;  // (cout) or null
  int bias_bf16;
  __nv_bfloat16* out;  // (B, cout, ho, wo), contiguous
  int out_vec;         // 1: output rows may be written as 16-byte vectors
  int tiles_x, tiles_y, tiles;
};

template <int MODE, int TH>
struct Geo {
  static constexpr int S = stride_of(MODE);
  static constexpr int IH = (TH - 1) * S + ksize(MODE), IW = (TW - 1) * S + ksize(MODE);
  // 8-pixel groups of an input row, loaded from x = ox0 * S - 8 (aligned):
  // group g, element j is tile column 8 g + j - 7
  static constexpr int G = (IW + 14) / 8;
  // output stage: one row of TH x TW (conv) or 2TH x 2TW (transpose conv)
  // pixels per channel, padded so the fragment stores are conflict-free
  static constexpr int OH = transposed(MODE) ? 2 * TH : TH, OW = transposed(MODE) ? 2 * TW : TW;
  static constexpr int OS = OH * OW + 8;
};

// The input tile is loaded in units of four channels x 8 pixels of one tile
// row (four 16-byte row pieces, stored as 8 channel-quads of 8 bytes): unit
// (q, g, yy) is channel quad q of 8-pixel group g of tile row yy.
__device__ __forceinline__ void load_unit(const Args& a, int b, int iy0, int x0, int q, int g, int yy,
                                          uint4 (&v)[4]) {
  load_quad(a.parts, a.vec, a.nparts, a.cin, b, 4 * q, iy0 + yy, a.H, x0 + 8 * g, a.W, v);
}

// pixel j of the unit's four channels, as one 8-byte channel-quad
template <int G, int IW>
__device__ __forceinline__ void store_unit(const Args& a, unsigned short* u, int q, int g, int yy,
                                           const uint4 (&v)[4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int xx = 8 * g + j - 7;
    if (xx < 0 || xx >= IW) continue;
    *reinterpret_cast<uint2*>(u + (yy * IW + xx) * a.cps + 4 * q) = quad_of(v, j);
  }
}

template <int MODE, int TH>
__device__ __forceinline__ void tile_origin(const Args& a, int t, int& b, int& oy0, int& ox0) {
  const int per = a.tiles_x * a.tiles_y, r = t % per;
  b = t / per;
  oy0 = (r / a.tiles_x) * TH;
  ox0 = (r % a.tiles_x) * TW;
}

// Output rows from a stage of NR rows of OW pixels per column (column co at
// st + co * os), by nthr threads from thread i0: rows y0 + rr * rstep,
// columns x0 .. x0 + OW - 1 of channel co of image b, 16-byte vectors where
// the output allows, elements at its ragged edge; nothing outside it.
template <int NR, int OW>
__device__ __forceinline__ void store_rows(const Args& a, const unsigned short* st, int os, int ncol, int b,
                                           int cbase, int y0, int rstep, int x0, int i0, int nthr) {
  constexpr int VPR = OW / 8;  // 16-byte vectors per stage row
  for (int i = i0; i < ncol * NR * VPR; i += nthr) {
    const int vx = i % VPR, rr = (i / VPR) % NR, co = i / (VPR * NR);
    const int oy = y0 + rr * rstep, ox = x0 + vx * 8;
    if (oy >= a.ho || ox >= a.wo) continue;
    const uint4 v = *reinterpret_cast<const uint4*>(st + co * os + rr * OW + vx * 8);
    unsigned short* dst = reinterpret_cast<unsigned short*>(a.out) +
                          ((static_cast<long long>(b) * a.cout + cbase + co) * a.ho + oy) * a.wo + ox;
    if (a.out_vec && ox + 8 <= a.wo) {
      *reinterpret_cast<uint4*>(dst) = v;
    } else {
      const unsigned short* e = reinterpret_cast<const unsigned short*>(&v);
      for (int j = 0; j < 8 && ox + j < a.wo; ++j) dst[j] = e[j];
    }
  }
}

// ---------------------------------------------------------------------------
// Hopper's mainloop: modes S1, S2 (each with the residual form), T, S1F
// ---------------------------------------------------------------------------

// CW consumer warpgroups a block, each 4 tile rows of TW pixels (its 64
// GEMM rows; warp w the w-th row), behind PW = 2 producer warpgroups (the
// staging, not the MMAs, bounds most forms on the H100: one producer left
// the consumers waiting). One block an SM: the launch gives each thread
// LREG registers; setmaxnreg then leaves the producers PREG and gives the
// consumers CREG (two partial sums, two sets of A fragments and the total:
// about 150 at N = 64 and two consumers, 190 at N = 128 and one).
template <int CW>
struct Wg {
  static constexpr int PW = 2;
  static constexpr int TH = 4 * CW, THREADS = 128 * (CW + PW);
  static constexpr int LREG = CW == 2 ? 128 : 168, PREG = CW == 2 ? 104 : 112, CREG = CW == 2 ? 152 : 232;
  static_assert(128 * (PW * PREG + CW * CREG) <= THREADS * LREG, "the consumers' registers come from the producers'");
  // k16 steps whose A fragments a consumer holds for a tap: kc <= 64 with
  // two consumers, kc <= 128 with one
  static constexpr int KMAX = CW == 2 ? 4 : 8;
};

// a consumer's output stage: its 4 rows (each OW = TW, 2 TW for a
// transpose conv's parity row pair) per column, padded by 8 (conflict-free
// fragment stores)
__host__ __device__ constexpr int out_stride(int mode) { return 4 * (transposed(mode) ? 2 * TW : TW) + 8; }

// Shared memory of conv_wg_kernel, byte offsets: the weights at 0 (slots x
// np x kc bf16, each slot a K-major block of np columns), the bias (np
// f32), the ring's barriers (full[4], empty[4]; T3 by tensor copies also
// landed), its landing area, the input stages, one output stage per
// consumer warpgroup.
struct WgLayout {
  size_t bias, bars, land, land_bytes, in, in_bytes, out, out_bytes, total;
  __host__ __device__ WgLayout(int mode, bool res, int cw, int stages, int np, int kc, int cps, bool tma = false) {
    const int th = 4 * cw, s = stride_of(mode), k = ksize(mode);
    const size_t ih = (th - 1) * s + k, iw = (TW - 1) * s + k;
    bias = static_cast<size_t>(slots(mode, res)) * np * kc * 2;
    bars = bias + static_cast<size_t>(np) * 4;
    // with tensor copies (T3): a landed barrier after the ring's, and a
    // 128-byte aligned landing area for one box, T3_BOXW x (th + 1) x kc
    land = tma ? (bars + 128 + 127) / 128 * 128 : bars + 64;
    land_bytes = tma ? static_cast<size_t>(T3_BOXW) * (th + 1) * kc * 2 : 0;
    in = land + land_bytes;
    in_bytes = (ih * iw * cps * 2 + 15) / 16 * 16 + (tma ? 16 : 0);  // a spare row for the transpose's strays
    out = in + stages * in_bytes;
    out_bytes = static_cast<size_t>(np) * out_stride(mode) * 2;
    total = out + cw * out_bytes;
  }
};

// The producer warpgroups' copy of one input tile into a stage: their NP
// threads over the units, group fastest (neighbouring threads read
// neighbouring 16-byte pieces of a channel row: whole 32-byte sectors),
// four units' loads in flight a thread.
template <class Gm, int NP>
__device__ __forceinline__ void stage_tile(const Args& a, unsigned short* u, int b, int iy0, int x0, int ptid) {
  constexpr int U = 4, G = Gm::G;
  const int nq = a.kc / 4, units = Gm::IH * G * nq;
  Walk w(ptid, NP, G * nq);  // q: group + G x quad, rest: tile row
  for (int base = ptid; base < units; base += NP * U) {
    uint4 v[U][4];
    Walk wu[U];
#pragma unroll
    for (int j = 0; j < U; ++j, w.next()) {
      wu[j] = w;
      if (base + NP * j < units) load_unit(a, b, iy0, x0, w.q / G, w.q % G, w.rest, v[j]);
    }
#pragma unroll
    for (int j = 0; j < U; ++j)
      if (base + NP * j < units) store_unit<G, Gm::IW>(a, u, wu[j].q / G, wu[j].q % G, wu[j].rest, v[j]);
  }
}

// MODE: S1, S2, T, T3, K4 or S1F. RES: the residual form (S1, S2). N: the
// padded cout, the wgmma width (T, T3: a parity's). CW: consumer warpgroups.
template <int MODE, bool RES, int N, int CW>
__global__ void __launch_bounds__(Wg<CW>::THREADS, 1) conv_wg_kernel(const __grid_constant__ Args a) {
  using P = Wg<CW>;
  constexpr int TH = P::TH, KMAX = P::KMAX, PW = P::PW, NR = N / 2;
  constexpr bool TR = transposed(MODE);
  using Gm = Geo<MODE, TH>;
  constexpr int S = Gm::S, OW = TR ? 2 * TW : TW, OS = out_stride(MODE), nslots = slots(MODE, RES);
  NCT_DYN_SHARED(unsigned char, smem);
  const WgLayout L(MODE, RES, CW, a.stages, N, a.kc, a.cps, MODE == T3 && a.tma);
  unsigned short* ws = reinterpret_cast<unsigned short*>(smem);
  float* bs = reinterpret_cast<float*>(smem + L.bias);
  const uint32_t bars = smem_u32(smem + L.bars);
  const hop::Ring ring{bars, bars + 32, a.stages};
  const int tid = threadIdx.x, nthr = blockDim.x, warp = tid >> 5, lane = tid & 31;
  // the block's column group: output channels [cbase, cbase + ncol); its
  // blocks walk every tile (K4 only has more than one group)
  const int cbase = (blockIdx.x % a.groups) * N, ncol = min(N, a.cout - cbase);
  const int t0 = blockIdx.x / a.groups, tstep = gridDim.x / a.groups;

  // -- weights (K-major, rounded to bf16), bias and barriers, once per block
  for (int i = tid; i < nslots * N * a.kc / 8; i += nthr) reinterpret_cast<uint4*>(ws)[i] = make_uint4(0, 0, 0, 0);
  for (int i = tid; i < N; i += nthr) bs[i] = (a.bias && i < ncol) ? load_w(a.bias, a.bias_bf16, cbase + i) : 0.f;
  const uint32_t landed = bars + 64;  // T3 by tensor copies: the box of the producers' next tile has landed
  if (tid == 0) {
    ring.init(128 * PW, 128 * CW);
    if (MODE == T3 && a.tma) hop::mbar_init(landed, 1);
    hop::mbar_init_fence();
  }
  __syncthreads();
  const int slot_el = N * a.kc;
  auto put = [&](int slot, int co, int k, const void* src, long long i) {
    ws[slot * slot_el + hop::kmajor(co, k, N)] = __bfloat16_as_ushort(__float2bfloat16(load_w(src, a.w_bf16, i)));
  };
  if constexpr (MODE == T) {
    // (cin, cout, 4, 4): tap ky = 3 - py - 2 ay of parity py reads input
    // row i + ay - 1 + py; slot = parity * 4 + ay * 2 + ax
    Walk w(tid, nthr, a.cout);  // q: output channel, rest: input channel
    for (int rr = tid; rr < a.cin * a.cout; rr += nthr, w.next()) {
#pragma unroll
      for (int kk = 0; kk < 16; ++kk) {
        const int ky = kk / 4, kx = kk % 4;
        const int py = (3 - ky) & 1, px = (3 - kx) & 1, ay = (3 - ky) >> 1, ax = (3 - kx) >> 1;
        put((py * 2 + px) * 4 + ay * 2 + ax, w.q, w.rest, a.w, 16LL * rr + kk);
      }
    }
  } else if constexpr (MODE == K4) {
    // (cout, cin, 4, 4), the block's columns only: slot = ky * 4 + kx
    Walk w(tid, nthr, a.cin);  // q: input channel, rest: the block's output channel
    for (int rr = tid; rr < ncol * a.cin; rr += nthr, w.next()) {
      const long long row = static_cast<long long>(cbase + w.rest) * a.cin + w.q;
#pragma unroll
      for (int tap = 0; tap < 16; ++tap) put(tap, w.rest, w.q, a.w, 16 * row + tap);
    }
  } else if constexpr (MODE == T3) {
    // (cin, cout, 3, 3): slot = ky * 3 + kx; of the trailing centre-only
    // input channels the centre tap alone (the zero fill holds the rest)
    const int cfull = a.cin - a.centre;
    Walk w(tid, nthr, a.cout);  // q: output channel, rest: input channel
    for (int rr = tid; rr < a.cin * a.cout; rr += nthr, w.next()) {
#pragma unroll
      for (int tap = 0; tap < 9; ++tap)
        if (tap == 4 || w.rest < cfull) put(tap, w.q, w.rest, a.w, 9LL * rr + tap);
    }
  } else if constexpr (MODE == S1F) {
    // the stride-1 conv's weight (cin, cout, 3, 3), flipped: slot = (2 - ky) * 3 + 2 - kx
    Walk w(tid, nthr, a.cout);  // q: output channel, rest: input channel
    for (int rr = tid; rr < a.cin * a.cout; rr += nthr, w.next()) {
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) put(8 - tap, w.q, w.rest, a.w, 9LL * rr + tap);
    }
  } else {
    Walk w(tid, nthr, a.cin);  // q: input channel, rest: output channel
    for (int rr = tid; rr < a.cout * a.cin; rr += nthr, w.next()) {
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) put(tap, w.rest, w.q, a.w, 9LL * rr + tap);
      if constexpr (RES) put(9, w.rest, w.q, a.wsc, rr);
    }
  }
  hop::fence_async_shared();  // the weights, written by threads, are read by wgmma
  __syncthreads();

  if (warp < 4 * PW) {
    // -- the producer warpgroups: the block's tiles, one stage each, in turn
    hop::setmaxnreg_dec<P::PREG>();
    if constexpr (MODE == T3) {
      if (a.tma) {
        // one thread lands tile i + 1's box (NCHW, T3_BOXW x (TH + 1) x kc
        // from (ox0, oy0)) while the producers turn tile i's channels-last:
        // 8 x 8 blocks (8 channels of 8 pixels of a row) by ldmatrix, stored
        // transposed by stmatrix into stage rows (yy, xx) = (row + 1, pixel
        // + 1); pixels past the stage's 18 columns go to its spare row
        const uint32_t land = smem_u32(smem + L.land);
        const auto issue = [&](int t) {
          int b, oy0, ox0;
          tile_origin<MODE, TH>(a, t, b, oy0, ox0);
          hop::mbar_arrive_tx(landed, static_cast<uint32_t>(L.land_bytes));
          hop::tma_load_4d(land, &a.xmap, ox0, oy0, 0, b, landed);
        };
        const int nc8 = a.kc / 8, G3 = T3_BOXW / 8, blocks = nc8 * (TH + 1) * G3, r8 = lane & 7;
        if (tid == 0 && t0 < a.tiles) issue(t0);
        int i = 0;
        for (int t = t0; t < a.tiles; t += tstep, ++i) {
          hop::mbar_wait(landed, i & 1);
          ring.acquire(i);
          const uint32_t stg = smem_u32(smem + L.in + ring.stage(i) * L.in_bytes);
          const uint32_t spare = stg + static_cast<uint32_t>(L.in_bytes - 16);
          for (int b4 = 4 * warp; b4 < blocks; b4 += 16 * PW) {
            int bl = b4 + (lane >> 3);
            bl = bl < blocks ? bl : blocks - 1;  // a repeat of the last block: the same bytes again
            const int g = bl % G3, row = (bl / G3) % (TH + 1), c8 = bl / (G3 * (TH + 1)), xx = 8 * g + r8 + 1;
            uint32_t v[4];
            ldsm_x4(v, land + (((8 * c8 + r8) * (TH + 1) + row) * T3_BOXW + 8 * g) * 2);
            stsm_x4_t(xx < Gm::IW ? stg + (((row + 1) * Gm::IW + xx) * a.cps + 8 * c8) * 2 : spare, v);
          }
          hop::named_sync(3, 128 * PW);  // the box is read: the next one may land
          if (tid == 0 && t + tstep < a.tiles) issue(t + tstep);
          ring.publish(i);
        }
        return;
      }
    }
    int i = 0;
    for (int t = t0; t < a.tiles; t += tstep, ++i) {
      int b, oy0, ox0;
      tile_origin<MODE, TH>(a, t, b, oy0, ox0);
      ring.acquire(i);
      stage_tile<Gm, 128 * PW>(a, reinterpret_cast<unsigned short*>(smem + L.in + ring.stage(i) * L.in_bytes), b,
                               oy0 * S - 1, ox0 * S - 8, tid);
      ring.publish(i);
    }
    return;
  }

  // -- consumer warpgroup c: warp w computes tile row r = 4 c + w (for T
  // and T3, input row r, output rows 2 r and 2 r + 1)
  hop::setmaxnreg_inc<P::CREG>();
  const int c = (warp >> 2) - PW, w = warp & 3, r = 4 * c + w, ctid = tid - 128 * (c + PW);
  const int kch = a.kc / 16, gid = lane >> 2, cq = (lane & 3) * 2;
  const uint32_t rowb = a.cps * 2;  // bytes per staged pixel
  // ldmatrix lanes: A row = pixel lane % 16 of the warp's row, at channel 8 (lane / 16)
  const uint32_t a_lane = ((r * S) * Gm::IW + (lane & 15) * S) * rowb + (lane >> 4) * 16;
  const uint64_t bd = hop::kmajor_desc(smem_u32(ws), N);
  const uint32_t slot_b = slot_el * 2;
  unsigned short* st = reinterpret_cast<unsigned short*>(smem + L.out + c * L.out_bytes);
  float acc[NR], accs[RES ? NR : 1];
  int i = 0;
  for (int t = t0; t < a.tiles; t += tstep, ++i) {
    int b, oy0, ox0;
    tile_origin<MODE, TH>(a, t, b, oy0, ox0);
    ring.take(i);
    const uint32_t ab = smem_u32(smem + L.in + ring.stage(i) * L.in_bytes) + a_lane;
    if constexpr (TR) {
      for (int py = 0; py < 2; ++py) {
#pragma unroll 1
        for (int px = 0; px < 2; ++px) {
          const int par = 2 * py + px;
          const auto release = [&] {
            if (par == 3) ring.release(i);  // the tile's last read of the stage
          };
          if constexpr (MODE == T) {
            // parity (py, px): taps (ay, ax) = (t / 2, t % 2) read input (r + ay + py - 1, x + ax + px - 1)
            hop::gemm_taps<N, KMAX>(
                acc, 4, kch, N, [&](int t) { return ab + (((t >> 1) + py) * Gm::IW + (t & 1) + px) * rowb; },
                [&](int t) { return hop::desc_at(bd, (par * 4 + t) * slot_b); }, release);
          } else {
            // parity (py, px): (py + 1) (px + 1) taps (ay, ax) read input
            // (r + ay, x + ax), staged at (r + ay + 1, x + ax + 1), at weight
            // tap (py + 1 - 2 ay, px + 1 - 2 ax); outside parity (0, 0) only
            // the channels whose weights are not centre-only
            const auto ay = [&](int t) { return px ? t >> 1 : t; };
            const auto ax = [&](int t) { return px ? t & 1 : 0; };
            const auto a_of = [&](int t) { return ab + ((ay(t) + 1) * Gm::IW + ax(t) + 1) * rowb; };
            const auto d_of = [&](int t) {
              return hop::desc_at(bd, ((py + 1 - 2 * ay(t)) * 3 + px + 1 - 2 * ax(t)) * slot_b);
            };
            if (a.blocks64) {
              // chains of 64 channels (4 k16 steps, a compile-time count:
              // straight-line code, no step the predicates of a runtime
              // count would guard): chain q of the parity is channel block
              // q % nb of tap q / nb, nb = the blocks its taps read
              const int nb = par ? a.blocks64_c : a.blocks64;
              hop::gemm_taps<N, 4>(
                  acc, (py + 1) * (px + 1) * nb, 4, N, [&](int q) { return a_of(q / nb) + (q % nb) * 128; },
                  [&](int q) { return hop::kstep(d_of(q / nb), N, 4 * (q % nb)); }, release);
            } else {
              hop::gemm_taps<N, KMAX>(acc, (py + 1) * (px + 1), par ? a.kch_c : kch, N, a_of, d_of, release);
            }
          }
          // bias, ReLU, bf16: output (2 r + py, 2 x + px) at stage row w
#pragma unroll
          for (int j = 0; j < N / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = 8 * j + cq + (e & 1), x = gid + 8 * (e >> 1);
              float v = acc[4 * j + e] + bs[col];
              if (a.relu) v = fmaxf(v, 0.f);
              st[col * OS + w * OW + 2 * x + px] = __bfloat16_as_ushort(__float2bfloat16(v));
            }
        }
        hop::named_sync(1 + c, 128);
        store_rows<4, OW>(a, st, OS, a.cout, b, 0, 2 * (oy0 + 4 * c) + py, 2, 2 * ox0, ctid, 128);
        hop::named_sync(1 + c, 128);  // the stage is read out
      }
    } else {
      // tap t = (ky, kx) = (t / k, t % k)
      constexpr int KS = ksize(MODE);
      hop::gemm_taps<N, KMAX>(
          acc, KS * KS, kch, N, [&](int t) { return ab + ((t / KS) * Gm::IW + t % KS) * rowb; },
          [&](int t) { return hop::desc_at(bd, t * slot_b); }, [&] {
            if constexpr (!RES) ring.release(i);  // the tile's last read of the stage
          });
      if constexpr (RES) {
        // the shortcut (slot 9) on the centre tap, afresh: one tap more
        hop::gemm_taps<N, KMAX>(
            accs, 1, kch, N, [&](int) { return ab + (Gm::IW + 1) * rowb; },
            [&](int) { return hop::desc_at(bd, 9 * slot_b); }, [&] { ring.release(i); });
      }
      // bias, ReLU, shortcut, bf16 at stage row w
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + cq + (e & 1), x = gid + 8 * (e >> 1);
          float v = acc[4 * j + e] + bs[col];
          if (a.relu) v = fmaxf(v, 0.f);
          if constexpr (RES) v += accs[4 * j + e];
          st[col * OS + w * OW + x] = __bfloat16_as_ushort(__float2bfloat16(v));
        }
      hop::named_sync(1 + c, 128);
      store_rows<4, OW>(a, st, OS, ncol, b, cbase, oy0 + 4 * c, 1, ox0, ctid, 128);
      hop::named_sync(1 + c, 128);  // the stage is read out
    }
  }
}

// The widest N two consumers take (their registers: two partial sums, two
// sets of A fragments and the total; a transpose conv's parity loop needs
// more, and at 64 ptxas serialized its wgmmas).
__host__ __device__ constexpr int wg2_max_n(int mode) { return transposed(mode) ? 32 : 64; }

// The first of (consumers, stages) = (2, 2), (1, 2), (2, 1), (1, 1) whose
// shared memory fits a block; two consumers only where N <= wg2_max_n and
// kc <= 64, one where kc <= 128. T3 in 64-channel chains takes two consumers
// at any kc (a chain's A fragments are 4 k16 steps) and before two stages:
// with one consumer warpgroup, a warp a scheduler, each warp's latencies lay
// bare (128 -> 32 at 176x608 on the H100: 0.074 ms with one, 0.051 with
// two, PERF.md). False if none fits.
inline bool wg_plan(Args& a, int mode, bool res, int& cw, size_t& smem) {
  static constexpr int opts[4][2] = {{2, 2}, {1, 2}, {2, 1}, {1, 1}};
  static constexpr int opts_t3[4][2] = {{2, 2}, {2, 1}, {1, 2}, {1, 1}};
  const bool chains = mode == T3 && a.blocks64;
  for (const auto& o : chains ? opts_t3 : opts) {
    if (a.kc > (o[0] == 2 && !chains ? 64 : 128) || (o[0] == 2 && a.coutp > wg2_max_n(mode))) continue;
    const size_t s = WgLayout(mode, res, o[0], o[1], a.coutp, a.kc, a.cps, mode == T3 && a.tma).total;
    if (s <= MAX_SMEM) {
      cw = o[0], a.stages = o[1], smem = s;
      return true;
    }
  }
  return false;
}

template <int MODE, bool RES, int N, int CW>
int launch_wg(Args& a, size_t smem, cudaStream_t st) {
  using P = Wg<CW>;
  constexpr int TH = P::TH;
  void (*k)(const Args) = conv_wg_kernel<MODE, RES, N, CW>;
  static const bool regs = hop::reg_plan_fits(k, P::THREADS, P::PW, P::PREG, CW, P::CREG);
  if (!regs) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int gy = transposed(MODE) ? a.H : a.ho, gx = transposed(MODE) ? a.W : a.wo;
  a.tiles_x = (gx + TW - 1) / TW;
  a.tiles_y = (gy + TH - 1) / TH;
  a.tiles = a.B * a.tiles_x * a.tiles_y;
  if (MODE == T3 && a.tma) {
    // the cotangent as (W, H, C, B), boxes of T3_BOXW x (TH + 1) x kc
    const Part& q = a.parts[0];
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(a.W), static_cast<cuuint64_t>(a.H),
                                static_cast<cuuint64_t>(a.cin), static_cast<cuuint64_t>(a.B)};
    const cuuint64_t strides[3] = {static_cast<cuuint64_t>(q.sh) * 2, static_cast<cuuint64_t>(q.sc) * 2,
                                   static_cast<cuuint64_t>(q.sb) * 2};
    const cuuint32_t box[4] = {T3_BOXW, TH + 1, static_cast<cuuint32_t>(a.kc), 1};
    if (const int e = hop::tensor_map(&a.xmap, q.ptr, 4, dims, strides, box)) return e;
  }
  int resident = 0;
  if (const int e = resident_blocks(k, P::THREADS, smem, resident)) return e;
  // as many blocks as fit, the same number for every column group
  const int fit = resident / a.groups > 1 ? resident / a.groups : 1;
  NCT_LAUNCH(k, dim3((a.tiles < fit ? a.tiles : fit) * a.groups), dim3(P::THREADS), smem, st, a);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE, bool RES, int N>
int launch_wg_cw(Args& a, int cw, size_t smem, cudaStream_t st) {
  if constexpr (N <= wg2_max_n(MODE)) {
    if (cw == 2) return launch_wg<MODE, RES, N, 2>(a, smem, st);
  }
  return launch_wg<MODE, RES, N, 1>(a, smem, st);
}

template <int MODE, bool RES>
int dispatch_wg(Args& a, cudaStream_t st) {
  int cw = 0;
  size_t smem = 0;
  if (!wg_plan(a, MODE, RES, cw, smem)) return static_cast<int>(cudaErrorInvalidValue);
  switch (a.coutp) {
    case 32: return launch_wg_cw<MODE, RES, 32>(a, cw, smem, st);
    case 64: return launch_wg_cw<MODE, RES, 64>(a, cw, smem, st);
  }
  if constexpr (MODE == K4) {
    if (a.coutp == 40) return launch_wg_cw<MODE, RES, 40>(a, cw, smem, st);
  }
  if constexpr (!RES && !transposed(MODE) && MODE != K4) {
    if (a.coutp == 128) return launch_wg_cw<MODE, RES, 128>(a, cw, smem, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Mode K4's columns: the fewest column groups whose width (cout / groups,
// rounded up to 32, 40 or 64 columns) leaves a plan inside a block; each
// block holds one group's weights and walks every tile for it.
inline int dispatch_k4(Args& a, cudaStream_t st) {
  for (int g = 1; g <= a.cout; ++g) {
    const int w = (a.cout + g - 1) / g;
    if (w > 64) continue;
    a.coutp = w <= 32 ? 32 : w <= 40 ? 40 : 64;
    a.groups = (a.cout + a.coutp - 1) / a.coutp;
    int cw = 0;
    size_t smem = 0;
    if (wg_plan(a, K4, false, cw, smem)) return dispatch_wg<K4, false>(a, st);
    if (a.coutp == 32) break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tc
}  // namespace nct

// Plain C entry. parts: n pointers + 6*n metadata (see nct::fill_parts), bf16,
// all of (B, H, W); mode 0: 3x3 pad-1 conv at stride 1, 1: at stride 2, 2:
// 4x4/s2/p1 transpose conv, 3: 3x3/s2/p1 transpose conv with output_padding
// 1, 4: 4x4 pad-1 conv at stride 2 (H, W >= 2). w: f32 (w_dtype 0) or bf16
// (1), (cout, cin, k, k) for a conv, (cin, cout, 4, 4) or (cin, cout, 3, 3)
// for a transpose conv; w_flip 1 (mode 0 only, no shortcut) reads a (cin,
// cout, 3, 3) w as the stride-1 conv whose input cotangent this is: tap
// (ky, kx) of w[ci][co] at (2 - ky, 2 - kx); wsc (cout, cin) of w's type
// selects the residual form of a conv, relu(conv + bias) + conv1x1; bias
// (cout) f32 (bias_dtype 0) or bf16 (1), or null. centre (mode 3 only, 0 <=
// centre < cin): the number of trailing input channels whose weights are
// zero outside the centre tap (1, 1), whose other taps the kernel then
// skips; 0 reads every tap of every channel. out: (B, cout, ho, wo) bf16,
// contiguous. Takes cout up to 128 (64 for the residual form and the
// transpose convs; any for mode 4, in column groups) where the weights and
// the input tiles fit in shared memory (cin up to 128); returns
// cudaErrorInvalidValue for any other call, else cudaGetLastError() after
// the launch. Every mode runs Hopper's mainloop (conv_wg_kernel).
extern "C" int nct_conv_tc(const void* const* part_ptrs, const long long* part_meta, int nparts,
                           int B, int H, int W, int cin, int cout, int mode, const void* w,
                           int w_dtype, int w_flip, const void* wsc, const void* bias, int bias_dtype,
                           void* out, int relu, int centre, void* stream) {
  using namespace nct;
  using namespace nct::tc;
  const bool res = wsc != nullptr;
  if (nparts < 1 || nparts > MAX_PARTS || B < 1 || H < 1 || W < 1 || cin < 1 || cout < 1 ||
      mode < S1 || mode > K4 || (res && mode != S1 && mode != S2) || (w_flip != 0 && w_flip != 1) ||
      (w_flip && (mode != S1 || res)) || (mode == K4 && (H < 2 || W < 2)) ||
      (w_dtype != F32 && w_dtype != BF16) || (bias_dtype != F32 && bias_dtype != BF16) || centre < 0 ||
      centre >= cin || (centre && mode != T3))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  fill_parts(a.parts, part_ptrs, part_meta, nparts);
  int total = 0;
  for (int i = 0; i < nparts; ++i) {
    const Part& p = a.parts[i];
    total += p.c;
    a.vec[i] = vec_rows<2>(p);
    if (p.up2) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (total != cin) return static_cast<int>(cudaErrorInvalidValue);
  a.nparts = nparts;
  a.B = B, a.H = H, a.W = W, a.cin = cin, a.cout = cout;
  a.ho = transposed(mode) ? 2 * H : mode == S2 ? (H - 1) / 2 + 1 : mode == K4 ? H / 2 : H;
  a.wo = transposed(mode) ? 2 * W : mode == S2 ? (W - 1) / 2 + 1 : mode == K4 ? W / 2 : W;
  a.kc = (cin + 15) / 16 * 16;
  a.cps = a.kc + 8;
  a.centre = centre;
  // T3's cotangent by tensor copies where it is one part of aligned 16-byte rows
  a.tma = mode == T3 && nparts == 1 && a.vec[0];
  // T3's taps in chains of 64 channels where kc allows it (a block past the
  // channels that are not centre-only has their weights' zeros)
  a.blocks64 = mode == T3 && a.kc % 64 == 0 ? a.kc / 64 : 0;
  a.blocks64_c = (cin - centre + 63) / 64;
  a.kch_c = (cin - centre + 15) / 16;
  a.groups = 1;
  a.relu = relu;
  a.w = w, a.wsc = wsc, a.w_bf16 = w_dtype == BF16;
  a.bias = bias, a.bias_bf16 = bias_dtype == BF16;
  a.out = static_cast<__nv_bfloat16*>(out);
  a.out_vec = reinterpret_cast<uintptr_t>(out) % 16 == 0 && a.wo % 8 == 0;
  auto st = static_cast<cudaStream_t>(stream);
  if (mode == K4) return dispatch_k4(a, st);
  a.coutp = cout <= 32 ? 32 : cout <= 64 ? 64 : 128;
  if (cout > (transposed(mode) || res ? 64 : 128)) return static_cast<int>(cudaErrorInvalidValue);
  switch (mode) {
    case S1:
      if (w_flip) return dispatch_wg<S1F, false>(a, st);
      return res ? dispatch_wg<S1, true>(a, st) : dispatch_wg<S1, false>(a, st);
    case S2: return res ? dispatch_wg<S2, true>(a, st) : dispatch_wg<S2, false>(a, st);
    case T3: return dispatch_wg<T3, false>(a, st);
    default: return dispatch_wg<T, false>(a, st);
  }
}
