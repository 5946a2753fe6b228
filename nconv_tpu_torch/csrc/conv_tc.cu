// K2 and K3 in bf16 on the tensor cores: the 3x3 pad-1 conv (stride 1 or 2,
// bias, ReLU, optional fused 1x1 residual shortcut, input as a list of
// parts), the 4x4/s2/p1 transpose conv (bias, ReLU, parts), and three
// input cotangents of the mixed schedule's backward, no bias: the 3x3/s2/p1
// transpose conv with output_padding 1 (of a 3x3 stride-2 conv), the 3x3
// pad-1 conv with the flipped, in/out-transposed weight (of a stride-1
// conv) and the 4x4/s2/p1 conv (of the 4x4/s2 transpose conv); bf16 in and
// out with f32 accumulation, as one implicit-GEMM kernel template
// (nct_conv_tc).
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
// conv chain on conv_chain_tc.cu, which shares tc.cuh.
//
// Bound on the H100: at 32-64 channels a 3x3 conv does 2*9*cout FLOP per
// input value over (cin + cout) * 2 bytes, at the card's bf16 ridge (~295
// FLOP/byte), so both the bytes and the tensor-core issue matter, and a
// design that reads its input once per few output channels (as conv.cu
// does) is bound by re-reads. Here:
//  * GEMM: M = the output pixels of a tile (rows of 16 along W), N = every
//    output channel (2 * cout for the residual form, whose shortcut columns
//    run the centre tap only; 4 * cout for the transpose conv, one group per
//    output parity), K = taps x cin. mma.sync m16n8k16 bf16 -> f32, operands
//    fed by ldmatrix.
//  * The input tile is staged once, channels-last ([pixel][channel], rows
//    padded by 8 channels so ldmatrix is conflict-free), transposed on the
//    way in from NCHW: 16-byte vectors along W where a part allows it,
//    elements otherwise (strided views); channels past cin zero-filled. A tap
//    (ky, kx) at stride 1 or 2 is then just a per-lane row address: no
//    im2col, no shifted copies. Each input byte leaves HBM once, plus the
//    halo.
//  * One block computes all output channels of its tile, and holds all its
//    weights resident in shared memory as bf16 (rounded to nearest even as
//    it stages them from their stored type, f32 or bf16), staged once:
//    blocks are persistent (as many as fit on the card) and loop over
//    tiles, each prefetching its next tile into registers while its MMAs run.
//  * The transpose conv is a 3x3-footprint conv over its input grid: output
//    parity (py, px) takes 2x2 of the taps (dy in {-1, 0} for py = 0, {0, 1}
//    for py = 1, the same for x), each warp's columns belong to one parity
//    and run only its 4 taps, and the epilogue stores depth-to-space.
//  * The 3x3/s2 transpose conv (mode T3) is the same over a 2x2 footprint:
//    output (2i + py, 2j + px) reads input (i + ay, j + ax) at tap
//    (py + 1 - 2 ay, px + 1 - 2 ax), so parity (0, 0) takes 1 tap, (0, 1)
//    and (1, 0) take 2 and (1, 1) takes 4, the nine taps once each. All nine
//    stay resident, one slot a tap: 157 KB at 128 -> 64 channels; with the
//    4 x 16 tile's input and depth-to-space output stages (one buffer, 34
//    KB) 191 KB, one block a SM. The warps of parity (1, 1) run 4 taps
//    while those of (0, 0) run 1, and the block waits on the longest; on
//    the guided net's cotangents that costs nothing measurable (pairing the
//    parities 4 + 1 and 2 + 2 on each warp scheduler gained nothing on the
//    H100): the loads and the epilogue, not the MMAs, set the time.
//  * The input cotangent of a stride-1 conv (mode S1F, mode S1 with w_flip
//    on the C entry) is mode S1 on the forward conv's own weight as stored,
//    (o, i, 3, 3) for forward output o (here an input channel) and input i
//    (here an output column): the staging puts tap 8 - t of w[o][i] into
//    slot t, column i, so no flipped, transposed copy is made per call.
//  * The 4x4/s2/p1 conv (mode K4) is mode S2's geometry with a 4x4
//    footprint: an input tile of (TH - 1) * 2 + 4 rows by 34 pixels, 16 tap
//    slots, a tap a row address at stride 2 (so, as in mode S2, a tap's 16
//    rows sit two pixels apart and its A reads are 2-way bank-conflicted).
//    Its 16 taps do not all fit resident at 64 -> 65 channels (128 columns:
//    295 KB), so the columns run at a granularity of 16 and, where the
//    weights and a 4 x 16 tile still exceed a block, split into column
//    groups: each block holds one group's weights (65 -> two groups of 48:
//    111 KB) and walks every tile for that group, so the input is read once
//    per group.
//  * Epilogue: bias in f32, ReLU, the shortcut columns added, one rounding to
//    bf16, staged in shared memory so the NCHW stores are 16-byte vectors.
#include "tc.cuh"

namespace nct {
namespace tc {

constexpr int TW = 16;       // tile width in output pixels: one m16 MMA tile per tile row
constexpr int THREADS = 256;  // at most, per block

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
  Part parts[MAX_PARTS];
  int vec[MAX_PARTS];  // 1: rows may be read as aligned 16-byte vectors
  int nparts, B, H, W, cin, cout, ho, wo;
  int kc;     // cin rounded up to 16
  int cps;    // shared-memory row of a pixel or a weight column, bf16: kc + 8
  int coutp;   // a block's columns: its group of cout, rounded up to the columns of the warps
  int groups;  // column groups: block b computes columns [(b % groups) * coutp, + coutp)
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
// i is quad q of group g, row yy, with rest = yy * G + g and n the quads per
// pixel (a Walk over the units).
template <int G>
__device__ __forceinline__ void load_unit(const Args& a, int b, int iy0, int x0, const Walk& w,
                                          uint4 (&v)[4]) {
  load_quad(a.parts, a.vec, a.nparts, a.cin, b, 4 * w.q, iy0 + w.rest / G, a.H, x0 + 8 * (w.rest % G), a.W, v);
}

// pixel j of the unit's four channels, as one 8-byte channel-quad
template <int G, int IW>
__device__ __forceinline__ void store_unit(const Args& a, unsigned short* u, const Walk& w,
                                           const uint4 (&v)[4]) {
  const int g = w.rest % G, yy = w.rest / G;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int xx = 8 * g + j - 7;
    if (xx < 0 || xx >= IW) continue;
    *reinterpret_cast<uint2*>(u + (yy * IW + xx) * a.cps + 4 * w.q) = quad_of(v, j);
  }
}

template <int MODE, int TH>
__device__ __forceinline__ void tile_origin(const Args& a, int t, int& b, int& oy0, int& ox0) {
  const int per = a.tiles_x * a.tiles_y, r = t % per;
  b = t / per;
  oy0 = (r / a.tiles_x) * TH;
  ox0 = (r % a.tiles_x) * TW;
}

// acc[mt][nt] += A(tap) x B(slot) over all of K: two m-tiles (the warp's two
// tile rows) by NTP pairs of n-tiles. a0: the lane's ldmatrix row address of
// m-tile 0 at channel 0; arow: bytes from m-tile 0 to m-tile 1; b0: the
// lane's address in the slot's first column pair; bpair: bytes between pairs.
// The fragments of chunk k + 1 load while the MMAs of chunk k issue.
template <int NTP>
struct Frags {
  uint32_t a[2][4], b[NTP][4];
  __device__ __forceinline__ void load(uint32_t a0, uint32_t arow, uint32_t b0, uint32_t bpair, int k) {
    ldsm_x4(a[0], a0 + 32 * k);
    ldsm_x4(a[1], a0 + arow + 32 * k);
#pragma unroll
    for (int p = 0; p < NTP; ++p) ldsm_x4(b[p], b0 + p * bpair + 32 * k);
  }
  __device__ __forceinline__ void mma(float (&acc)[2][2 * NTP][4]) const {
#pragma unroll
    for (int p = 0; p < NTP; ++p)
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        mma_bf16(acc[m][2 * p], a[m], b[p][0], b[p][1]);
        mma_bf16(acc[m][2 * p + 1], a[m], b[p][2], b[p][3]);
      }
  }
};

// The tensor cores' f32 sums are not rounded to nearest (they truncate, a
// bias toward zero at every MMA), so a tap's MMAs sum into registers of their
// own that join the total with one rounded add: the bias stays that of
// kchunks MMAs, not of 9 x kchunks, and bf16 outputs round as an f32 sum
// would round them.
template <int NTP>
__device__ __forceinline__ void mma_tap(float (&acc)[2][2 * NTP][4], uint32_t a0, uint32_t arow,
                                        uint32_t b0, uint32_t bpair, int kchunks) {
  float part[2][2 * NTP][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 2 * NTP; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[m][n][e] = 0.f;
  Frags<NTP> f0, f1;
  f0.load(a0, arow, b0, bpair, 0);
  int k = 0;
  for (; k + 2 <= kchunks; k += 2) {
    f1.load(a0, arow, b0, bpair, k + 1);
    f0.mma(part);
    if (k + 2 < kchunks) f0.load(a0, arow, b0, bpair, k + 2);
    f1.mma(part);
  }
  if (k < kchunks) f0.mma(part);
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 2 * NTP; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] += part[m][n][e];
}

// MODE: a Mode. RES: the residual form (conv only). NTP: pairs of 8-column
// n-tiles per warp and column group. WM: warps along M, two tile rows each
// (TH = 2 WM). The block has WM x WN warps, WN = coutp / (16 NTP) column
// blocks (times 4 parities for T and T3).
template <int MODE, bool RES, int NTP, int WM>
__global__ void __launch_bounds__(THREADS) conv_tc_kernel(const Args a) {
  constexpr int TH = 2 * WM, NT = 2 * NTP;
  // input units (4 channels x 8 pixels) prefetched per thread; fewer where
  // the accumulators of 3 or 4 column pairs leave fewer registers
  constexpr int MAXU = NTP >= 3 ? 1 : 3;
  using Gm = Geo<MODE, TH>;
  constexpr int S = Gm::S;
  NCT_DYN_SHARED(unsigned char, smem);
  constexpr int nslots = slots(MODE, RES);
  unsigned short* ws = reinterpret_cast<unsigned short*>(smem);
  float* bs = reinterpret_cast<float*>(smem + static_cast<size_t>(nslots) * a.coutp * a.cps * 2);
  unsigned short* u = reinterpret_cast<unsigned short*>(bs + a.coutp);
  const int tid = threadIdx.x, nthr = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WM, wn = warp / WM;
  // the block's column group: output channels [cbase, cbase + ncol)
  const int cbase = (blockIdx.x % a.groups) * a.coutp, ncol = min(a.coutp, a.cout - cbase);

  // -- weights and bias, once per block: zero, then scatter in read order
  for (int i = tid; i < nslots * a.coutp * a.cps / 8; i += nthr)
    reinterpret_cast<uint4*>(ws)[i] = make_uint4(0, 0, 0, 0);
  for (int i = tid; i < a.coutp; i += nthr)
    bs[i] = (a.bias && i < ncol) ? load_w(a.bias, a.bias_bf16, cbase + i) : 0.f;
  __syncthreads();
  // each thread walks rows of the stored weight (the taps of one input and
  // one output channel, contiguous), rounding each tap to bf16 into its slot
  auto put = [&](int slot, int co, int k, const void* src, long long i) {
    ws[(slot * a.coutp + co) * a.cps + k] = __bfloat16_as_ushort(__float2bfloat16(load_w(src, a.w_bf16, i)));
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
  } else if constexpr (MODE == T3 || MODE == S1F) {
    // (cin, cout, 3, 3): slot = ky * 3 + kx; for S1F the stride-1 conv's
    // weight, flipped: slot = (2 - ky) * 3 + 2 - kx
    Walk w(tid, nthr, a.cout);  // q: output channel, rest: input channel
    for (int rr = tid; rr < a.cin * a.cout; rr += nthr, w.next()) {
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) put(MODE == S1F ? 8 - tap : tap, w.q, w.rest, a.w, 9LL * rr + tap);
    }
  } else if constexpr (MODE == K4) {
    // (cout, cin, 4, 4), the block's columns only: slot = ky * 4 + kx
    Walk w(tid, nthr, a.cin);  // q: input channel, rest: the block's output channel
    for (int rr = tid; rr < ncol * a.cin; rr += nthr, w.next()) {
      const long long row = static_cast<long long>(cbase + w.rest) * a.cin + w.q;
#pragma unroll
      for (int tap = 0; tap < 16; ++tap) put(tap, w.rest, w.q, a.w, 16 * row + tap);
    }
  } else {
    Walk w(tid, nthr, a.cin);  // q: input channel, rest: output channel
    for (int rr = tid; rr < a.cout * a.cin; rr += nthr, w.next()) {
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) put(tap, w.rest, w.q, a.w, 9LL * rr + tap);
      if constexpr (RES) put(9, w.rest, w.q, a.wsc, rr);
    }
  }

  // -- the warp's place: tile rows 2 wm, 2 wm + 1; columns [c0, c0 + 16 NTP)
  // of each of its groups (for T, of parity par's group)
  const int wnc = a.coutp / (16 * NTP);
  const int par = transposed(MODE) ? wn / wnc : 0;
  const int c0 = (transposed(MODE) ? wn % wnc : wn) * 16 * NTP;
  const int kchunks = a.kc / 16;
  const uint32_t rowb = a.cps * 2;  // bytes per pixel row of the tile / weight column
  // ldmatrix lanes: A row = pixel q (lane % 16) at channel 8 (lane / 16);
  // B: column (lane / 16) * 8 + lane % 8 at channel 8 ((lane / 8) % 2)
  const int q = lane & 15;
  const uint32_t a_lane = smem_u32(u) + ((2 * wm * S) * Gm::IW + q * S) * rowb + (lane >> 4) * 16;
  const uint32_t b_lane = smem_u32(ws) + (c0 + (lane >> 4) * 8 + (lane & 7)) * rowb + ((lane >> 3) & 1) * 16;
  const uint32_t arow = S * Gm::IW * rowb, bpair = 16 * rowb, bslot = a.coutp * rowb;

  const int nq = a.kc / 4, units = Gm::IH * Gm::G * nq;
  // the group's blocks walk every tile
  const int tstep = gridDim.x / a.groups;
  int t = blockIdx.x / a.groups;
  if (t >= a.tiles) return;
  {
    int b, oy0, ox0;
    tile_origin<MODE, TH>(a, t, b, oy0, ox0);
    Walk w(tid, nthr, nq);
    for (int ui = tid; ui < units; ui += nthr, w.next()) {
      uint4 v[4];
      load_unit<Gm::G>(a, b, oy0 * S - 1, ox0 * S - 8, w, v);
      store_unit<Gm::G, Gm::IW>(a, u, w, v);
    }
  }
  __syncthreads();

  for (; t < a.tiles; t += tstep) {
    int b, oy0, ox0;
    tile_origin<MODE, TH>(a, t, b, oy0, ox0);
    // prefetch the block's next tile into registers while the MMAs run
    const int tn = t + tstep;
    int nb = 0, noy0 = 0, nox0 = 0;
    uint4 pf[MAXU][4];
    if (tn < a.tiles) {
      tile_origin<MODE, TH>(a, tn, nb, noy0, nox0);
      Walk w(tid, nthr, nq);
#pragma unroll
      for (int i = 0; i < MAXU; ++i, w.next())
        if (tid + i * nthr < units) load_unit<Gm::G>(a, nb, noy0 * S - 1, nox0 * S - 8, w, pf[i]);
    }

    float acc[2][NT][4];
    float accs[RES ? 2 : 1][RES ? NT : 1][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[m][n][e] = 0.f;
          if constexpr (RES) accs[m][n][e] = 0.f;
        }
    if constexpr (MODE == T) {
      const int py = par >> 1, px = par & 1;
#pragma unroll
      for (int ay = 0; ay < 2; ++ay)
#pragma unroll
        for (int ax = 0; ax < 2; ++ax)
          mma_tap<NTP>(acc, a_lane + ((ay + py) * Gm::IW + ax + px) * rowb, arow,
                       b_lane + (par * 4 + ay * 2 + ax) * bslot, bpair, kchunks);
    } else if constexpr (MODE == T3) {
      // input (i + ay, j + ax) is staged pixel (ay + 1, ax + 1) from the warp's own
      const int py = par >> 1, px = par & 1;
#pragma unroll 1
      for (int ay = 0; ay <= py; ++ay)
#pragma unroll 1
        for (int ax = 0; ax <= px; ++ax)
          mma_tap<NTP>(acc, a_lane + ((ay + 1) * Gm::IW + ax + 1) * rowb, arow,
                       b_lane + ((py + 1 - 2 * ay) * 3 + px + 1 - 2 * ax) * bslot, bpair, kchunks);
    } else {
      constexpr int K = ksize(MODE);
#pragma unroll 1
      for (int tap = 0; tap < K * K; ++tap)
        mma_tap<NTP>(acc, a_lane + ((tap / K) * Gm::IW + tap % K) * rowb, arow, b_lane + tap * bslot,
                     bpair, kchunks);
      if constexpr (RES)
        mma_tap<NTP>(accs, a_lane + (Gm::IW + 1) * rowb, arow, b_lane + 9 * bslot, bpair, kchunks);
    }
    __syncthreads();  // every warp is done with the input tile

    // -- epilogue: bias, ReLU, shortcut, bf16, into the stage over the tile
    {
      const int gid = lane >> 2, cq = (lane & 3) * 2;
      __nv_bfloat16* st = reinterpret_cast<__nv_bfloat16*>(u);
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int px_ = gid + (e >> 1) * 8, col = c0 + n * 8 + cq + (e & 1), r = 2 * wm + m;
            float v = acc[m][n][e] + bs[col];
            if (a.relu) v = fmaxf(v, 0.f);
            if constexpr (RES) v += accs[m][n][e];
            if constexpr (transposed(MODE))
              st[col * Gm::OS + (2 * r + (par >> 1)) * Gm::OW + 2 * px_ + (par & 1)] = __float2bfloat16(v);
            else
              st[col * Gm::OS + r * Gm::OW + px_] = __float2bfloat16(v);
          }
    }
    __syncthreads();
    {
      constexpr int VPR = Gm::OW / 8;  // 16-byte vectors per stage row
      const int oyb = transposed(MODE) ? 2 * oy0 : oy0, oxb = transposed(MODE) ? 2 * ox0 : ox0;
      for (int i = tid; i < ncol * Gm::OH * VPR; i += nthr) {
        const int vx = i % VPR, rr = (i / VPR) % Gm::OH, co = i / (VPR * Gm::OH);
        const int oy = oyb + rr, ox = oxb + vx * 8;
        if (oy >= a.ho || ox >= a.wo) continue;
        const uint4 v = *reinterpret_cast<const uint4*>(u + co * Gm::OS + rr * Gm::OW + vx * 8);
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
    __syncthreads();  // the stage is read out

    if (tn < a.tiles) {
      Walk w(tid, nthr, nq);
#pragma unroll
      for (int i = 0; i < MAXU; ++i, w.next())
        if (tid + i * nthr < units) store_unit<Gm::G, Gm::IW>(a, u, w, pf[i]);
      for (int ui = tid + MAXU * nthr; ui < units; ui += nthr, w.next()) {
        uint4 v[4];
        load_unit<Gm::G>(a, nb, noy0 * S - 1, nox0 * S - 8, w, v);
        store_unit<Gm::G, Gm::IW>(a, u, w, v);
      }
    }
    __syncthreads();
  }
}

inline size_t smem_bytes(int mode, bool res, int th, int coutp, int cps) {
  const int s = stride_of(mode), k = ksize(mode);
  const int ih = (th - 1) * s + k, iw = (TW - 1) * s + k;
  const int oh = transposed(mode) ? 2 * th : th, ow = transposed(mode) ? 2 * TW : TW;
  const size_t in = static_cast<size_t>(ih) * iw * cps * 2;
  const size_t out = static_cast<size_t>(coutp) * (oh * ow + 8) * 2;
  const int nslots = slots(mode, res);
  return static_cast<size_t>(nslots) * coutp * cps * 2 + coutp * 4 + (in > out ? in : out);
}

template <int MODE, bool RES, int NTP, int WM>
int launch(Args& a, int wn, cudaStream_t st) {
  constexpr int TH = 2 * WM;
  void (*k)(const Args) = conv_tc_kernel<MODE, RES, NTP, WM>;
  const int threads = 32 * WM * wn;
  const size_t smem = smem_bytes(MODE, RES, TH, a.coutp, a.cps);
  const int gy = transposed(MODE) ? a.H : a.ho, gx = transposed(MODE) ? a.W : a.wo;
  a.tiles_x = (gx + TW - 1) / TW;
  a.tiles_y = (gy + TH - 1) / TH;
  a.tiles = a.B * a.tiles_x * a.tiles_y;
  int resident = 0;
  if (const int e = resident_blocks(k, threads, smem, resident)) return e;
  // as many blocks as fit, the same number for every column group
  const int fit = resident / a.groups > 1 ? resident / a.groups : 1;
  const int per_group = a.tiles < fit ? a.tiles : fit;
  NCT_LAUNCH(k, dim3(per_group * a.groups), dim3(threads), smem, st, a);
  return static_cast<int>(cudaGetLastError());
}

// The larger tile (WM 4, else 2) whose warps, weights and input tile fit a
// block (a transpose conv has at least 4 column groups, so WM 2).
template <int MODE, bool RES, int NTP>
int launch_fit(Args& a, int wn, cudaStream_t st) {
  if constexpr (!transposed(MODE)) {
    if (4 * wn * 32 <= THREADS && smem_bytes(MODE, RES, 8, a.coutp, a.cps) <= MAX_SMEM)
      return launch<MODE, RES, NTP, 4>(a, wn, st);
  }
  if (2 * wn * 32 <= THREADS && smem_bytes(MODE, RES, 4, a.coutp, a.cps) <= MAX_SMEM)
    return launch<MODE, RES, NTP, 2>(a, wn, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int MODE, bool RES>
int dispatch_ntp(Args& a, int ntp, cudaStream_t st) {
  const int wnc = a.coutp / (16 * ntp), wn = transposed(MODE) ? 4 * wnc : wnc;
  switch (ntp) {
    case 1: return launch_fit<MODE, RES, 1>(a, wn, st);
    case 2: return launch_fit<MODE, RES, 2>(a, wn, st);
  }
  if constexpr (MODE == K4) {
    if (ntp == 3) return launch_fit<MODE, RES, 3>(a, wn, st);
  } else if constexpr (!RES) {
    if (ntp == 4) return launch_fit<MODE, RES, 4>(a, wn, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Mode K4's columns: cout at a granularity of 16 (33 -> 48, not 64: faster
// on the guided net's three calls than 32, measured on the H100), split
// into as few groups as leave each group at most 128 columns in at most 4
// warp columns, and its weights and a 4 x 16 tile inside a block; the pairs
// per warp: 3 where they divide the group's, else 2, else 1.
inline int k4_ntp(int coutp) {
  const int cp = coutp / 16;
  return cp % 3 == 0 ? 3 : cp % 2 == 0 ? 2 : 1;
}
inline void k4_columns(Args& a) {
  for (int g = 1;; ++g) {
    a.coutp = ((a.cout + g - 1) / g + 15) / 16 * 16;
    a.groups = (a.cout + a.coutp - 1) / a.coutp;
    if (a.coutp == 16 || (a.coutp <= 128 && a.coutp / (16 * k4_ntp(a.coutp)) <= 4 &&
                          smem_bytes(K4, false, 4, a.coutp, a.cps) <= MAX_SMEM))
      return;
  }
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
// (cout) f32 (bias_dtype 0) or bf16 (1), or null. out: (B, cout, ho, wo)
// bf16, contiguous. Takes cout up to 128 (64 for the residual form and the
// transpose convs; any for mode 4, in column groups) where the weights and
// one input tile fit in shared memory; returns cudaErrorInvalidValue for any
// other call, else cudaGetLastError() after the launch.
extern "C" int nct_conv_tc(const void* const* part_ptrs, const long long* part_meta, int nparts,
                           int B, int H, int W, int cin, int cout, int mode, const void* w,
                           int w_dtype, int w_flip, const void* wsc, const void* bias, int bias_dtype,
                           void* out, int relu, void* stream) {
  using namespace nct;
  using namespace nct::tc;
  const bool res = wsc != nullptr;
  if (nparts < 1 || nparts > MAX_PARTS || B < 1 || H < 1 || W < 1 || cin < 1 || cout < 1 ||
      mode < S1 || mode > K4 || (res && mode != S1 && mode != S2) || (w_flip != 0 && w_flip != 1) ||
      (w_flip && (mode != S1 || res)) || (mode == K4 && (H < 2 || W < 2)))
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
  const int gran = cout <= 16 ? 16 : cout <= 64 ? 32 : 64;
  a.coutp = (cout + gran - 1) / gran * gran;
  a.groups = 1;
  if (mode == K4) k4_columns(a);
  a.relu = relu;
  a.w = w, a.wsc = wsc, a.w_bf16 = w_dtype == BF16;
  a.bias = bias, a.bias_bf16 = bias_dtype == BF16;
  a.out = static_cast<__nv_bfloat16*>(out);
  a.out_vec = reinterpret_cast<uintptr_t>(out) % 16 == 0 && a.wo % 8 == 0;
  // column pairs per warp: a conv's columns at most two warps wide (one up
  // to 32 channels, measured faster than two narrower warps); a transpose
  // conv's parity groups one warp wide
  int ntp = a.coutp / 32 > 1 ? a.coutp / 32 : a.coutp / 16;
  if (transposed(mode)) ntp = a.coutp / 16 > 4 ? 4 : a.coutp / 16;
  if (mode == K4) ntp = k4_ntp(a.coutp);
  if (a.coutp > (transposed(mode) || res ? 64 : 128) || (w_dtype != F32 && w_dtype != BF16) ||
      (bias_dtype != F32 && bias_dtype != BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case S1:
      if (w_flip) return dispatch_ntp<S1F, false>(a, ntp, st);
      return res ? dispatch_ntp<S1, true>(a, ntp, st) : dispatch_ntp<S1, false>(a, ntp, st);
    case S2: return res ? dispatch_ntp<S2, true>(a, ntp, st) : dispatch_ntp<S2, false>(a, ntp, st);
    case T: return dispatch_ntp<T, false>(a, ntp, st);
    case T3: return dispatch_ntp<T3, false>(a, ntp, st);
    default: return dispatch_ntp<K4, false>(a, ntp, st);
  }
}
