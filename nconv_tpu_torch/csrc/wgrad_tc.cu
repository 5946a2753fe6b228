// K6 in bf16 on the tensor cores (nct_wgrad_tc): the weight cotangent of a
// K x K convolution at stride S and pad P from bf16 operands, f32 out,
//
//   d_w[m, ci, dy, dx] = sum_{b, i, j} x_pad[b, ci, S*i + dy, S*j + dx] * g[b, m, i, j]
//
// with x (B, cin, H, W) the conv's input read as 0 outside the image and g
// (B, M, Ho, Wo) its output cotangent, both lists of parts read through their
// strides (a channel-offset view included). Forms: 3x3 stride 1, 3x3 stride 2
// and 4x4 stride 2 with the roles swapped for the 4x4/s2/p1 transpose conv
// (x its output cotangent, g its saved input, d_w in the ConvTranspose2d
// layout (cin, cout, 4, 4)). The f32 form stays on the CUDA cores (wgrad.cu):
// TF32 would round its operands.
//
// Replaces nconv_tpu/ops/pallas_conv.py:_filtergrad_kernel (:1093, through
// conv_filtergrad_pallas_bhcw) in the mixed schedule's guided backwards,
// which contract bf16 tiles on the MXU with f32 sums.
//
// Bound on the H100: a GEMM of (K*K*cin) x M contracted over B*Ho*Wo pixels
// (428k at 352x1216 a stream): 2 M K*K*cin FLOP a pixel against
// 2 (M + S*S*cin) bytes. At M = cin = 32 that is 144 FLOP a byte, under the
// card's bf16 ridge (~295), so the full-resolution calls are bound by their
// bytes; the 64 x 64 and 64 x 128 calls sit at the ridge; the M = 1 and
// cin = 1, 3 calls stream. So the design reads each operand from HBM about
// once, lands it without per-thread address work, and feeds the tensor cores
// from shared memory:
//  * GEMM D[(tap, ci), m] = X[(tap, ci), p] G[p, m] on Hopper's warpgroup MMA
//    (hopper.cuh): wgmma m64nNk16, N = M padded (8, 32, 40, 64, 72 or 128;
//    wider M in column groups of at most 128), the pixels its k. D's rows are
//    (8-channel group, tap) half-units, channel-major, so a block's rows need
//    only a few of x's channels: 64 rows an m-tile, a warp 16 of them, each
//    8 an ldmatrix matrix with addresses of its own (cin 1 or 3 pads to 8
//    channels, not 16).
//  * A = x from registers: ldmatrix.trans at per-lane tap addresses out of a
//    channels-last x stage ([pixel][channel], rows an odd multiple of 16
//    bytes, so conflict-free). A tap (dy, dx) at stride S is a row address:
//    no im2col, no shifted copies; at S = 2 the stage keeps its columns split
//    by parity (even, then odd), so a tap's 16 pixels are 16 consecutive rows.
//  * B = g through a descriptor, K-major (kmajor(n, k, N)): one 16-byte
//    piece of g (8 pixels of one channel, NCHW as stored) is one core-matrix
//    row. A tile is 4 x 32 pixels of the output grid.
//  * Loads by the tensor memory accelerator: one thread a tile issues g's
//    stage as one box of a 5-d map (8 pixels, N channels, 4 groups, 4 rows:
//    it lands as the K-major stage) and x's window as one box an 8-channel
//    group (8 G pixels x ih rows x 8 channels, NCHW as stored); pixels
//    outside the image and channels past a part land as zeros; the stage's
//    landed barrier counts the bytes. Per-thread copies (cp.async pieces of
//    16 bytes, with the part and row arithmetic of each) bounded every call
//    on the H100 (their issue took microseconds a tile, PERF.md); they remain
//    for parts the maps cannot describe (rows not 16-byte aligned, a
//    channels-last view, channel groups across parts, widths not a multiple
//    of 8).
//  * Two producer warpgroups take alternate tiles into a ring of up to 6
//    stages guarded by mbarriers and turn x's landed window channels-last:
//    8 x 8 blocks (8 channels x 8 pixels) by ldmatrix and stmatrix.trans,
//    four an instruction. A warpgroup issues tile i's copies before it
//    finishes tile i - 2 where the ring has 4 stages or more (with 3 it was
//    slower on the H100: a warpgroup then holds two of the three). The
//    consumers hand a stage back once their wgmmas have read it.
//  * Two consumer warpgroups each own MT m-tiles (the block 2 MT: every m-tile
//    of the call at N <= 32 and most calls, so g leaves HBM once; at N = 64,
//    four m-tiles a block) and keep their running totals in registers;
//    setmaxnreg leaves the producers 72 registers and gives the consumers
//    184. Blocks over the m-tiles of one tile are neighbours in the grid, so
//    they read g's tiles from L2.
//  * The tensor cores truncate their f32 sums, so each chain (one tile's 8
//    k16 steps, 128 pixels, one wgmma group started afresh by wgmma_rs0)
//    joins the m-tile's running total with one rounded add: the bias stays
//    that of 8 MMAs. Two chains are in flight (two sets of A fragments and
//    partial sums) where the registers allow; else the next chain's A
//    fragments load while one runs. Chains of 4 k16 steps were slower.
//  * Split-K over pixel slices, about one wave of blocks in all (slice s takes
//    tiles s, s + slices, ...): each block writes its rows of one slice's
//    partial sum and a second kernel sums the slices of each output in slice
//    order. No atomics, and the plan is a function of the shape alone, so a
//    run is bitwise repeatable for a given shape.
// Routing is fixed by shape: (N, MT) by M and cin, the loads by the parts'
// layout; no other path.
#include "hopper.cuh"

namespace nct {
namespace wtc {

constexpr int TW = 32, TH = 4, TP = TH * TW;  // a pixel tile: 4 rows of 32, 8 k16 steps
constexpr int KH = 8;                         // k16 steps a chain (a whole tile)
constexpr int PW = 2, CW = 2, THREADS = 128 * (PW + CW);
// one block an SM at 128 registers a thread; setmaxnreg moves them to the consumers
constexpr int PREG = 72, CREG = 184;
static_assert(128 * (PW * PREG + CW * CREG) <= THREADS * 128, "the consumers' registers come from the producers'");
constexpr int MAX_STAGES = 6;
constexpr int BARS = 256;            // bytes before the stages: full[6], empty[6], landed[6]
constexpr int TARGET_BLOCKS = 132;   // about one wave of one-block-an-SM blocks on the H100
constexpr int MIN_TILES = 2;         // pixel tiles a slice keeps at least

struct Args {
  CUtensorMap xmap[MAX_PARTS];  // x's parts for the tensor memory accelerator (tma): (W, H, C, B), boxes of
                                // 8 G pixels x ih rows x 8 channels
  CUtensorMap gmap;             // g, one part, as (8 pixels, M, wo / 8, ho, B): a box is a K-major g stage
  Part g[MAX_PARTS];  // (B, M, ho, wo)
  Part x[MAX_PARTS];  // (B, cin, H, W)
  int gvec[MAX_PARTS], xvec[MAX_PARTS];  // 1: a part's rows may be read as 16-byte vectors
  int ng, nx, M, cin, H, W, ho, wo, pad;
  int K, S, KK;                  // footprint, stride, taps
  int nhu;                       // D's half-units (8 rows each): KK * ceil(cin / 8), channel-major
  int mgroups;                   // blocks over the m-tiles, for each column group
  int xc, xs;                    // x channels a stage holds (a multiple of 8); a staged pixel's row, bf16
  int ih, iw, iwh, iws, gx;      // x window rows and columns, half columns, stage columns, 8-pixel groups a row
  int tiles_x, tiles_y, tiles;
  int tma, gtma;                 // 1: x (g) lands by tensor copies, else by cp.async pieces
  int stages, g_bytes, land, seg, box, stage_bytes;  // a stage: g (K-major, N x TP), x (ih x iws x xs), x
                                                     // as landed (a box of 8 channels x ih rows x seg bytes
                                                     // a channel group)
  float* part;                       // (slices, M, K * K, cin)
};

// the first staged 8-channel group of the block whose first m-tile is mt0
__host__ __device__ inline int first_c8(const Args& a, int mt0) {
  const int hu = 8 * mt0 < a.nhu ? 8 * mt0 : a.nhu - 1;
  return hu / a.KK;
}

__device__ __forceinline__ void tile_of(const Args& a, int t, int& b, int& i0, int& j0) {
  const int per_img = a.tiles_x * a.tiles_y, r = t % per_img;
  b = t / per_img;
  i0 = (r / a.tiles_x) * TH;
  j0 = (r % a.tiles_x) * TW;
}

// 8 pixels from x of an image row with element stride sw, as raw bf16 bits,
// zero outside [0, W)
__device__ __forceinline__ uint4 row8s(const unsigned short* row, int sw, int x, int W) {
  uint32_t e[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) e[j] = x + j >= 0 && x + j < W ? row[(x + j) * sw] : 0u;
  return make_uint4(e[0] | (e[1] << 16), e[2] | (e[3] << 16), e[4] | (e[5] << 16), e[6] | (e[7] << 16));
}

// A channel of a list of parts: its part's fields, selected by uniform
// branches over the (at most four) parts, so no parameter is read through a
// per-thread index.
struct Chan {
  const unsigned short* ptr;  // the channel's plane at batch 0
  long long sb, sh;
  int sw, vec;
};
__device__ __forceinline__ Chan chan_of(const Part (&parts)[MAX_PARTS], const int (&vec)[MAX_PARTS], int np, int c) {
  Chan r{static_cast<const unsigned short*>(parts[0].ptr) + c * parts[0].sc, parts[0].sb, parts[0].sh,
         static_cast<int>(parts[0].sw), vec[0]};
#pragma unroll
  for (int i = 1; i < MAX_PARTS; ++i) {
    c -= parts[i - 1].c;
    if (i < np && c >= 0)
      r = Chan{static_cast<const unsigned short*>(parts[i].ptr) + c * parts[i].sc, parts[i].sb, parts[i].sh,
               static_cast<int>(parts[i].sw), vec[i]};
  }
  return r;
}

// g's tile t, columns n0 .., into a stage, K-major: the 16-byte piece (channel
// n, tile row rr, 8-pixel group gg) at ((4 rr + gg) N + n) 16 bytes; zero
// outside the image and past M. A thread keeps (rr, gg) = ((ptid / 4) % 4,
// ptid % 4) and channels ptid / 16 + 8 k (neighbouring threads on
// neighbouring pieces of a channel row).
template <int N>
__device__ __forceinline__ void stage_g(const Args& a, unsigned char* st, int t, int n0, int ptid) {
  int b, i0, j0;
  tile_of(a, t, b, i0, j0);
  const int gg = ptid & 3, rr = (ptid >> 2) & 3, y = i0 + rr, x = j0 + 8 * gg;
  const bool in = y < a.ho && x < a.wo;
  const int bytes = 2 * (a.wo - x < 8 ? a.wo - x : 8);
  const uint32_t base = smem_u32(st) + ((4 * rr + gg) * N + (ptid >> 4)) * 16;
#pragma unroll
  for (int k = 0; k < N / 8; ++k) {
    const int c = n0 + (ptid >> 4) + 8 * k;
    const uint32_t dst = base + 8 * k * 16;
    if (!in || c >= a.M) {
      cp_async16(dst, a.g[0].ptr, 0);
      continue;
    }
    const Chan ch = chan_of(a.g, a.gvec, a.ng, c);
    const unsigned short* row = ch.ptr + b * ch.sb + y * ch.sh;
    if (ch.vec)
      cp_async16(dst, row + x, bytes);
    else
      *reinterpret_cast<uint4*>(st + (dst - smem_u32(st))) = row8s(row, ch.sw, x, a.wo);
  }
}

// x's landing where the tensor memory accelerator cannot take the parts: the
// 16-byte piece (channel c, window row lr, 8-pixel group gg) of tile t's
// window, from x = S j0 - 8 + 8 gg, at (c ih + lr) seg + 16 gg bytes of the
// landing area (the tensor copies' layout), by cp.async (zero outside the
// image and past cin; element loads where a part's rows are not 16-byte
// aligned). A thread
// keeps up to XP (group, channel) pairs, group fastest (neighbouring threads
// on neighbouring pieces of a channel row), resolved to channel planes once,
// and walks the window's rows from a row pointer.
struct LandX {
  static constexpr int XP = 4;  // the plan keeps G * xc <= 4 * 128
  const unsigned short* plane[XP];
  long long sb[XP], sh[XP];
  int gc[XP];  // group | channel << 8 | vec << 30; -1: no pair
  int sw[XP];
  __device__ void init(const Args& a, int c_lo, int ptid) {
#pragma unroll
    for (int k = 0; k < XP; ++k) {
      const int pr = ptid + 128 * k, gg = pr % a.gx, cl = pr / a.gx, c = c_lo + cl;
      gc[k] = pr < a.gx * a.xc ? gg | cl << 8 : -1;
      if (gc[k] >= 0 && c < a.cin) {
        const Chan ch = chan_of(a.x, a.xvec, a.nx, c);
        plane[k] = ch.ptr, sb[k] = ch.sb, sh[k] = ch.sh, sw[k] = ch.sw, gc[k] |= ch.vec << 30;
      } else {
        plane[k] = nullptr, sb[k] = sh[k] = 0, sw[k] = 1;
      }
    }
  }
  __device__ __forceinline__ void land(const Args& a, unsigned char* area, int t) const {
    int b, i0, j0;
    tile_of(a, t, b, i0, j0);
    const int y0 = a.S * i0 - a.pad;
    const uint32_t base = smem_u32(area), dstep = a.seg;
#pragma unroll
    for (int k = 0; k < XP; ++k) {
      if (gc[k] < 0) continue;
      const int gg = gc[k] & 255, cl = (gc[k] >> 8) & 0x3fffff, x = a.S * j0 - 8 + 8 * gg;
      const int bytes = x < 0 || x >= a.W ? 0 : 2 * (a.W - x < 8 ? a.W - x : 8);
      uint32_t dst = base + cl * a.ih * a.seg + gg * 16;
      if (!plane[k] || bytes == 0) {
        for (int lr = 0; lr < a.ih; ++lr, dst += dstep) cp_async16(dst, a.x[0].ptr, 0);
        continue;
      }
      const unsigned short* row = plane[k] + b * sb[k] + y0 * sh[k];
      const bool vec = gc[k] >> 30;
      for (int lr = 0; lr < a.ih; ++lr, dst += dstep, row += sh[k]) {
        const int y = y0 + lr;
        if (y < 0 || y >= a.H)
          cp_async16(dst, a.x[0].ptr, 0);
        else if (vec)
          cp_async16(dst, row + x, bytes);
        else
          *reinterpret_cast<uint4*>(area + (dst - base)) = row8s(row, sw[k], x, a.W);
      }
    }
  }
};

// The tensor copies of tile t into stage st, by one thread, counted on the
// stage's landed barrier (which expects every box's bytes): g's columns
// n0 .. n0 + N as one box of its map (the K-major stage: 8 pixels, N
// channels, 4 groups, 4 rows); each 8-channel group of x's channels c_lo ..
// c_lo + xc as one box (8 G pixels from x = S j0 - 8, ih rows from
// S i0 - pad, 8 channels) of its part's map, at group * box bytes of the
// landing area. Pixels outside the image and channels past a part land as
// zeros. Without tensor copies the barrier completes on this arrival.
template <int N>
__device__ __forceinline__ void land_tma(const Args& a, uint32_t st, uint32_t landed, int t, int n0, int c_lo) {
  int b, i0, j0;
  tile_of(a, t, b, i0, j0);
  hop::mbar_arrive_tx(landed, (a.tma ? a.xc / 8 * a.box : 0) + (a.gtma ? N * TP * 2 : 0));
  if (a.gtma) hop::tma_load_5d(st, &a.gmap, 0, n0, j0 / 8, i0, b, landed);
  if (!a.tma) return;
  const int x0 = a.S * j0 - 8, y0 = a.S * i0 - a.pad;
  for (int g8 = 0; g8 < a.xc / 8; ++g8) {
    int c = c_lo + 8 * g8, p = 0;
    while (p < a.nx - 1 && c >= a.x[p].c) c -= a.x[p++].c;  // groups do not straddle parts (host)
    hop::tma_load_4d(st + a.land + g8 * a.box, &a.xmap[p], x0, y0, c, b, landed);
  }
}

// wait until at most N of this thread's cp.async groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The landed window into the x stage, channels-last, by the producer
// warpgroup's four warps: an 8 x 8 block (8 channels c8 .. c8 + 7 of window
// row lr, 8-pixel group gg) loaded by ldmatrix (a row a channel) and stored
// by stmatrix.trans (a row a pixel: window column lc = 8 gg + r - 8 + pad, at
// S = 2 in the parity-split column; a pixel outside the window goes to the
// stage's spare row), four blocks an instruction.
__device__ __forceinline__ void transpose_x(const Args& a, const unsigned char* land, uint32_t xb, int ptid) {
  const int nc8 = a.xc / 8, G = a.gx, blocks = nc8 * G * a.ih, lane = ptid & 31, r = lane & 7;
  const uint32_t lb = smem_u32(land), spare = xb + a.ih * a.iws * a.xs * 2;
  // n / d as (n * ceil(2^16 / d)) >> 16, exact for n * d < 2^16 (blocks < 2^12, d <= 16)
  const uint32_t m8 = (65536 + nc8 - 1) / nc8, mg = (65536 + G - 1) / G;
  for (int b4 = 4 * (ptid >> 5); b4 < blocks; b4 += 16) {
    int bl = b4 + (lane >> 3);
    bl = bl < blocks ? bl : blocks - 1;  // a repeat of the last block: the same bytes again
    const int rest = (bl * m8) >> 16, c8 = bl - rest * nc8, lr = (rest * mg) >> 16, gg = rest - lr * G;
    uint32_t v[4];
    ldsm_x4(v, lb + ((8 * c8 + r) * a.ih + lr) * a.seg + gg * 16);
    const int lc = 8 * gg + r - 8 + a.pad;
    const int col = a.S == 2 ? (lc & 1) * a.iwh + (lc >> 1) : lc;
    stsm_x4_t(lc < 0 || lc >= a.iw ? spare : xb + ((lr * a.iws + col) * a.xs + 8 * c8) * 2, v);
  }
}

// One chain's A fragments: KH k16 steps of the warp's 16 rows (its two
// half-units) by ldmatrix.trans, k16 step s at row step s / 2 and column
// step s % 2 of the x stage; and their wgmmas against g's k16 steps from s0,
// the first afresh.
template <int N>
struct Chain {
  uint32_t f[KH][4];
  __device__ __forceinline__ void load(uint32_t addr, uint32_t rowstep, uint32_t colstep) {
#pragma unroll
    for (int k = 0; k < KH; ++k) ldsm_x4_t(f[k], addr + (k >> 1) * rowstep + (k & 1) * colstep);
  }
  __device__ __forceinline__ void mma(float (&d)[N / 2], uint64_t gd, int s0) const {
    hop::wgmma_rs0<N>(d, f[0], hop::kstep(gd, N, s0));
#pragma unroll
    for (int k = 1; k < KH; ++k) hop::wgmma_rs<N>(d, f[k], hop::kstep(gd, N, s0 + k));
  }
};

// A block: column group blockIdx.x / mgroups (g channels n0 .. n0 + N), m-tiles
// from mt0 (CW x MT of them), pixel slice blockIdx.y.
template <int N, int MT>
__global__ void __launch_bounds__(THREADS, 1) wgrad_wg_kernel(const __grid_constant__ Args a) {
  constexpr int R = N / 2;
  // the consumers' chain pipeline, the deepest whose registers (running
  // totals, partial sums, A fragments) fit beside the rest: 2, two chains in
  // flight (two A sets, two partial sums); 1, the next chain's A fragments
  // load while a chain runs; 0, one chain at a time
  constexpr int HC = TP / 16 / KH;  // chains a tile and m-tile
  constexpr int PIPE = MT * R + 2 * R + 8 * KH <= CREG - 24 ? 2 : MT * R + R + 8 * KH <= CREG - 24 ? 1 : 0;
  NCT_DYN_SHARED(unsigned char, smem);
  const uint32_t bars = smem_u32(smem);
  const hop::Ring ring{bars, bars + 8 * MAX_STAGES, a.stages};
  unsigned char* stages = smem + BARS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = (blockIdx.x / a.mgroups) * N, mt0 = (blockIdx.x % a.mgroups) * CW * MT;
  const int c8lo = first_c8(a, mt0);
  // slice blockIdx.y takes every gridDim.y-th tile, so the blocks in flight
  // work on neighbouring tiles (x's rows and their DRAM pages are shared)
  const int ntiles = (a.tiles - blockIdx.y + gridDim.y - 1) / gridDim.y;
  const auto tile = [&](int i) { return static_cast<int>(blockIdx.y + i * gridDim.y); };
  const uint32_t landed = bars + 16 * MAX_STAGES;  // landed[s]: stage s's tensor copies of x
  if (tid == 0) {
    ring.init(128, 128 * CW);  // a tile is one producer warpgroup's
    for (int s = 0; s < a.stages; ++s) hop::mbar_init(landed + 8 * s, 1);
    hop::mbar_init_fence();
  }
  __syncthreads();

  if (warp < 4 * PW) {
    // -- producer warpgroup pw: tiles pw, pw + PW, ... of the slice
    hop::setmaxnreg_dec<PREG>();
    // tile i's copies are issued before tile i - PW's are awaited where the
    // ring has 4 stages or more (with 2 a warpgroup would hold both, with 3
    // it was slower), so two tiles' loads are in flight a producer warpgroup
    const int pw = warp >> 2, ptid = tid & 127;
    const bool lag = a.stages >= 4;
    LandX lx;
    lx.init(a, 8 * c8lo, ptid);
    const auto finish = [&](int i) {
      hop::named_sync(1 + pw, 128);  // every thread's pieces of tile i have landed
      hop::mbar_wait(landed + 8 * ring.stage(i), ring.parity(i));  // and its tensor copies
      unsigned char* st = stages + ring.stage(i) * a.stage_bytes;
      transpose_x(a, st + a.land, smem_u32(st + a.g_bytes), ptid);
      hop::fence_async_shared();  // g, landed by cp.async, is read by wgmma
      ring.publish(i);
    };
    for (int i = pw; i < ntiles; i += PW) {
      ring.acquire(i);
      unsigned char* st = stages + ring.stage(i) * a.stage_bytes;
      if (!a.gtma) stage_g<N>(a, st, tile(i), n0, ptid);
      if (!a.tma) lx.land(a, st + a.land, tile(i));
      if (ptid == 0) land_tma<N>(a, smem_u32(st), landed + 8 * ring.stage(i), tile(i), n0, 8 * c8lo);
      cp_async_commit();
      if (!lag) {
        cp_async_wait_all();
        finish(i);
      } else if (i >= PW) {
        cp_async_wait_group<1>();
        finish(i - PW);
      }
    }
    if (lag && ntiles > pw) {
      cp_async_wait_all();
      finish(pw + (ntiles - 1 - pw) / PW * PW);
    }
    return;
  }

  // -- consumer warpgroup c, warp w: rows 16 w .. 16 w + 15 of each of its m-tiles
  hop::setmaxnreg_inc<CREG>();
  const int c = (warp >> 2) - PW, w = warp & 3;
  // ldmatrix.trans lanes: matrix i = lane / 8 is half-unit 2 w + (i & 1) at
  // pixels 8 (i >> 1) + lane % 8 of a k16 step
  const int kp = (lane & 7) + 8 * (lane >> 4);
  uint32_t lane_off[MT];
#pragma unroll
  for (int j = 0; j < MT; ++j) {
    int hu = 8 * (mt0 + c * MT + j) + 2 * w + ((lane >> 3) & 1);
    hu = hu < a.nhu ? hu : a.nhu - 1;  // rows past D: any address in the stage, never stored
    const int c8 = hu / a.KK, tap = hu % a.KK, dy = tap / a.K, dx = tap % a.K;
    const int col = a.S == 2 ? (dx & 1) * a.iwh + kp + (dx >> 1) : kp + dx;
    lane_off[j] = a.g_bytes + ((dy * a.iws + col) * a.xs + 8 * (c8 - c8lo)) * 2;
  }
  const uint32_t rowstep = a.S * a.iws * a.xs * 2, colstep = 16 * a.xs * 2;
  const uint32_t st0 = smem_u32(stages);

  float tot[MT][R];
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int e = 0; e < R; ++e) tot[j][e] = 0.f;
  const auto join = [&](float (&t)[R], float (&p)[R]) {
    hop::fence_regs(p);
#pragma unroll
    for (int e = 0; e < R; ++e) t[e] += p[e];
  };

  for (int i = 0; i < ntiles; ++i) {
    ring.take(i);
    const uint32_t sb = st0 + ring.stage(i) * a.stage_bytes;
    const uint64_t gd = hop::kmajor_desc(sb, N);
    // chain q: m-tile q / HC, k16 steps KH (q % HC) .. of the tile, whose
    // first window row is (KH / 2) (q % HC) rows of S down
    const auto a_at = [&](int q) { return sb + lane_off[q / HC] + (KH / 2) * (q % HC) * rowstep; };
    if constexpr (PIPE == 2) {
      // two chains in flight: A and partial-sum set q % 2
      Chain<N> ch[2];
      float p[2][R];
#pragma unroll
      for (int q = 0; q < HC * MT; ++q) {
        ch[q & 1].load(a_at(q), rowstep, colstep);
        hop::wgmma_fence();
        ch[q & 1].mma(p[q & 1], gd, KH * (q % HC));
        hop::wgmma_commit();
        if (q > 0) {
          hop::wgmma_wait<1>();  // chain q - 1
          join(tot[(q - 1) / HC], p[(q - 1) & 1]);
        }
      }
      hop::wgmma_wait<0>();
      join(tot[MT - 1], p[(HC * MT - 1) & 1]);
    } else if constexpr (PIPE == 1) {
      // one partial sum; chain q + 1's A fragments load while chain q runs
      Chain<N> ch[2];
      float p[R];
      ch[0].load(a_at(0), rowstep, colstep);
#pragma unroll
      for (int q = 0; q < HC * MT; ++q) {
        hop::wgmma_fence();
        ch[q & 1].mma(p, gd, KH * (q % HC));
        hop::wgmma_commit();
        if (q + 1 < HC * MT) ch[(q + 1) & 1].load(a_at(q + 1), rowstep, colstep);
        hop::wgmma_wait<0>();
        join(tot[q / HC], p);
      }
    } else {
      Chain<N> ch;
      float p[R];
#pragma unroll
      for (int q = 0; q < HC * MT; ++q) {
        ch.load(a_at(q), rowstep, colstep);
        hop::wgmma_fence();
        ch.mma(p, gd, KH * (q % HC));
        hop::wgmma_commit();
        hop::wgmma_wait<0>();
        join(tot[q / HC], p);
      }
    }
    ring.release(i);  // g read by the wgmmas, x by ldmatrix: the stage is free
  }

  // D fragment: element 4 jj + e of m-tile j is row 16 w + lane / 4 + 8 (e / 2)
  // (half-unit 2 w + e / 2: channel 8 c8 + lane / 4 at its tap), column
  // 8 jj + 2 (lane % 4) + e % 2; the partial sum is laid out (M, K*K, cin)
  float* part = a.part + blockIdx.y * static_cast<long long>(a.M) * a.KK * a.cin;
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int hu = 8 * (mt0 + c * MT + j) + 2 * w + h;
      const int ci = (hu / a.KK) * 8 + (lane >> 2), tap = hu % a.KK;
      if (hu >= a.nhu || ci >= a.cin) continue;
#pragma unroll
      for (int jj = 0; jj < N / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = n0 + 8 * jj + 2 * (lane & 3) + e;
          if (m < a.M) part[(static_cast<long long>(m) * a.KK + tap) * a.cin + ci] = tot[j][4 * jj + 2 * h + e];
        }
    }
}

// Second pass: out (M, cin, kk) = the sum of part (slices, M, kk, cin) over
// the slices in order, one partial element a thread (reads coalesced).
__global__ void __launch_bounds__(256) reduce_kernel(const float* part, int slices, int cin, int kk,
                                                     long long n_out, float* out) {
  const long long o = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (o >= n_out) return;
  float s = 0.f;
  for (int z = 0; z < slices; ++z) s += part[z * n_out + o];
  const long long ch = o % cin, tap = (o / cin) % kk, m = o / (static_cast<long long>(cin) * kk);
  out[(m * cin + ch) * kk + tap] = s;
}

struct Plan {
  int N, MT, ngroups, mgroups, nhu, span, tiles_x, tiles_y, tiles, per, slices;
};

inline int width_of(int m) { return m <= 8 ? 8 : m <= 32 ? 32 : m <= 40 ? 40 : m <= 64 ? 64 : m <= 72 ? 72 : 128; }
inline int mt_most(int n) { return n <= 32 ? 5 : n == 40 ? 3 : n == 64 ? 2 : 1; }
// 8-pixel groups of an x window row
inline int groups_x(int k, int s) { return ((TW - 1) * s + k + 15) / 8; }

// the widest span of 8-channel groups that one block's rows reach
inline int span_c8(int nhu, int kk, int mgroups, int mt) {
  int span = 1;
  for (int mg = 0; mg < mgroups; ++mg) {
    const int lo = 8 * mg * CW * mt, hi = 8 * (mg + 1) * CW * mt;
    const int first = (lo < nhu ? lo : nhu - 1) / kk, last = (hi < nhu ? hi : nhu) - 1;
    span = last / kk - first + 1 > span ? last / kk - first + 1 : span;
  }
  return span;
}

// The launch plan, a function of the shape alone: M in column groups of at
// most 128, each N wide (the wgmma width); D's m-tiles in mgroups blocks of
// CW x MT (as many a consumer as its registers hold at N: 5 up to 32, 3 at
// 40, 2 at 64, 1 wider; MT 4 runs as 5; fewer where a block's x channel
// quads times its window's 8-pixel groups would pass the 128 producer
// threads, or where the call has too few tiles for half TARGET_BLOCKS);
// the pixel tiles in slices, about TARGET_BLOCKS blocks in all while a slice
// keeps MIN_TILES tiles.
inline Plan plan(int B, int ho, int wo, int M, int cin, int k, int s) {
  Plan p{};
  p.ngroups = (M + 127) / 128;
  p.N = width_of((M + p.ngroups - 1) / p.ngroups);
  p.nhu = k * k * ((cin + 7) / 8);
  const int mtiles = (p.nhu + 7) / 8, most = mt_most(p.N);
  p.tiles_x = (wo + TW - 1) / TW;
  p.tiles_y = (ho + TH - 1) / TH;
  p.tiles = B * p.tiles_x * p.tiles_y;
  p.mgroups = (mtiles + CW * most - 1) / (CW * most);
  p.MT = (mtiles + CW * p.mgroups - 1) / (CW * p.mgroups);
  if (p.MT == 4) p.MT = 5;
  for (;;) {
    p.span = span_c8(p.nhu, k * k, p.mgroups, p.MT);
    const bool fits = 2 * p.span * groups_x(k, s) <= 128;
    // a call of few tiles takes more, narrower blocks: at least half a wave
    const bool fills = 2LL * p.ngroups * p.mgroups * ((p.tiles + MIN_TILES - 1) / MIN_TILES) >= TARGET_BLOCKS;
    if ((fits && fills) || p.MT == 1) break;
    p.MT = p.MT == 5 ? 3 : p.MT - 1;
    p.mgroups = (mtiles + CW * p.MT - 1) / (CW * p.MT);
  }
  const int groups = p.ngroups * p.mgroups;
  long long sl = TARGET_BLOCKS / groups;
  const long long most_s = (p.tiles + MIN_TILES - 1) / MIN_TILES;
  sl = sl < most_s ? sl : most_s;
  sl = sl < 1 ? 1 : sl;
  p.per = static_cast<int>((p.tiles + sl - 1) / sl);
  p.slices = (p.tiles + p.per - 1) / p.per;
  return p;
}

// The x window and the stages: a stage holds x's channels over the widest
// span of 8-channel groups any block's rows reach; as many stages (up to 6)
// as fit a block.
inline void geometry(Args& a, const Plan& p) {
  a.KK = a.K * a.K;
  a.nhu = p.nhu;
  a.mgroups = p.mgroups;
  a.ih = (TH - 1) * a.S + a.K;
  a.iw = (TW - 1) * a.S + a.K;
  a.iwh = (a.iw + 1) / 2;
  a.iws = a.S == 2 ? 2 * a.iwh : a.iw;
  a.gx = groups_x(a.K, a.S);
  a.xc = 8 * p.span;
  a.xs = p.span % 2 ? a.xc : a.xc + 8;  // an odd number of 16-byte pieces a pixel: conflict-free ldmatrix
  a.g_bytes = p.N * TP * 2;
  a.land = a.g_bytes + (a.ih * a.iws * a.xs * 2 + 16 + 127) / 128 * 128;  // x, a spare row, the landing area
  a.seg = 16 * a.gx;
  a.box = 8 * a.ih * a.seg;  // a multiple of 128 bytes: the tensor copies' alignment
  a.stage_bytes = a.land + a.xc / 8 * a.box;
  const int fit = static_cast<int>((MAX_SMEM - BARS) / a.stage_bytes);
  a.stages = fit < MAX_STAGES ? fit : MAX_STAGES;
  a.tiles_x = p.tiles_x, a.tiles_y = p.tiles_y, a.tiles = p.tiles;
}

// x's part i as (W, H, C, B) with boxes of 8 G pixels x ih rows x 8 channels;
// g (one part) as (8 pixels, M, wo / 8, ho, B) with boxes of 8 x N x 4 x 4:
// the box lands as [4 rr + gg][n][8 pixels], the K-major stage
inline int x_map(Args& a, int i) {
  const Part& q = a.x[i];
  const int B = a.tiles / (a.tiles_x * a.tiles_y);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(a.W), static_cast<cuuint64_t>(a.H),
                              static_cast<cuuint64_t>(q.c), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(q.sh) * 2, static_cast<cuuint64_t>(q.sc) * 2,
                                 static_cast<cuuint64_t>(q.sb) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(8 * a.gx), static_cast<cuuint32_t>(a.ih), 8, 1};
  return hop::tensor_map(&a.xmap[i], q.ptr, 4, dims, strides, box);
}
inline int g_map(Args& a, int n) {
  const Part& q = a.g[0];
  const int B = a.tiles / (a.tiles_x * a.tiles_y);
  const cuuint64_t dims[5] = {8, static_cast<cuuint64_t>(a.M), static_cast<cuuint64_t>(a.wo / 8),
                              static_cast<cuuint64_t>(a.ho), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[4] = {static_cast<cuuint64_t>(q.sc) * 2, 16, static_cast<cuuint64_t>(q.sh) * 2,
                                 static_cast<cuuint64_t>(q.sb) * 2};
  const cuuint32_t box[5] = {8, static_cast<cuuint32_t>(n), TW / 8, TH, 1};
  return hop::tensor_map(&a.gmap, q.ptr, 5, dims, strides, box);
}

template <int N, int MT>
int launch(Args& a, const Plan& p, float* out, cudaStream_t st) {
  void (*k)(const Args) = wgrad_wg_kernel<N, MT>;
  static const bool regs = hop::reg_plan_fits(k, THREADS, PW, PREG, CW, CREG);
  if (!regs || a.stages < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = BARS + static_cast<size_t>(a.stages) * a.stage_bytes;
  int resident = 0;  // sets the kernel's shared-memory limit on this device
  if (const int e = resident_blocks(k, THREADS, smem, resident)) return e;
  NCT_LAUNCH(k, dim3(p.ngroups * p.mgroups, p.slices), dim3(THREADS), smem, st, a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long n_out = static_cast<long long>(a.M) * a.cin * a.KK;
  void (*rk)(const float*, int, int, int, long long, float*) = reduce_kernel;
  NCT_LAUNCH(rk, dim3(static_cast<unsigned>((n_out + 255) / 256)), dim3(256), 0, st, a.part, p.slices, a.cin,
             a.KK, n_out, out);
  return static_cast<int>(cudaGetLastError());
}

template <int N, int... MTS>
int dispatch_mt(Args& a, const Plan& p, float* out, cudaStream_t st) {
  int e = static_cast<int>(cudaErrorInvalidValue);
  ((p.MT == MTS ? (e = launch<N, MTS>(a, p, out, st), true) : false) || ...);
  return e;
}

inline int dispatch(Args& a, const Plan& p, float* out, cudaStream_t st) {
  switch (p.N) {
    case 8: return dispatch_mt<8, 1, 2, 3, 5>(a, p, out, st);
    case 32: return dispatch_mt<32, 1, 2, 3, 5>(a, p, out, st);
    case 40: return dispatch_mt<40, 1, 2, 3>(a, p, out, st);
    case 64: return dispatch_mt<64, 1, 2>(a, p, out, st);
    case 72: return dispatch_mt<72, 1>(a, p, out, st);
    case 128: return dispatch_mt<128, 1>(a, p, out, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace wtc
}  // namespace nct

// Rows of the partial-sum buffer for a weight cotangent of M x (cin K K)
// outputs over B * ho * wo pixels, K = ksize, at the given stride; the caller
// allocates part as (slices, M, cin * K * K).
extern "C" int nct_wgrad_tc_slices(int B, int ho, int wo, int M, int cin, int ksize, int stride) {
  return nct::wtc::plan(B, ho, wo, M, cin, ksize, stride).slices;
}

// Plain C entry. g: ng parts (B, M, ho, wo); x: nx parts (B, cin, H, W)
// (pointers + 6 metadata values each, see nct::fill_parts), all bf16, any
// strides; (ksize, stride) in {(3, 1), (3, 2), (4, 2)}, pad in [0, ksize),
// (ho, wo) = ((H, W) + 2 pad - ksize) / stride + 1; part (slices, M, cin *
// ksize^2) f32 scratch (laid out (slices, M, ksize^2, cin)); out (M, cin, ksize, ksize) f32 contiguous.
extern "C" int nct_wgrad_tc(const void* const* g_ptrs, const long long* g_meta, int ng,
                            const void* const* x_ptrs, const long long* x_meta, int nx, int B, int M,
                            int cin, int H, int W, int ho, int wo, int ksize, int stride, int pad,
                            float* part, float* out, void* stream) {
  using namespace nct;
  using namespace nct::wtc;
  if (ng < 1 || ng > MAX_PARTS || nx < 1 || nx > MAX_PARTS || B < 1 || M < 1 || cin < 1 || pad < 0 ||
      pad >= ksize || stride < 1 || H + 2 * pad < ksize || W + 2 * pad < ksize ||
      ho != (H + 2 * pad - ksize) / stride + 1 || wo != (W + 2 * pad - ksize) / stride + 1 ||
      !((ksize == 3 && (stride == 1 || stride == 2)) || (ksize == 4 && stride == 2)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  fill_parts(a.g, g_ptrs, g_meta, ng);
  fill_parts(a.x, x_ptrs, x_meta, nx);
  int mg = 0, cx = 0;
  for (int i = 0; i < ng; ++i) mg += a.g[i].c, a.gvec[i] = vec_rows<2>(a.g[i]);
  for (int i = 0; i < nx; ++i) cx += a.x[i].c, a.xvec[i] = vec_rows<2>(a.x[i]);
  for (int i = 0; i < ng; ++i)
    if (a.g[i].up2) return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < nx; ++i)
    if (a.x[i].up2) return static_cast<int>(cudaErrorInvalidValue);
  if (mg != M || cx != cin) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = plan(B, ho, wo, M, cin, ksize, stride);
  a.ng = ng, a.nx = nx, a.M = M, a.cin = cin, a.H = H, a.W = W, a.ho = ho, a.wo = wo, a.pad = pad;
  a.K = ksize, a.S = stride;
  geometry(a, p);
  // tensor copies of x where every part's rows are 16-byte vectors, W a
  // multiple of 8, and no 8-channel group straddles two parts
  a.tma = W % 8 == 0;
  for (int i = 0; i < nx; ++i) a.tma &= a.xvec[i] && (i == nx - 1 || a.x[i].c % 8 == 0);
  for (int i = 0; a.tma && i < nx; ++i)
    if (const int e = x_map(a, i)) return e;
  // and of g where it is one such part and wo a multiple of 8
  a.gtma = ng == 1 && a.gvec[0] && wo % 8 == 0;
  if (a.gtma)
    if (const int e = g_map(a, p.N)) return e;
  a.part = part;
  return dispatch(a, p, out, static_cast<cudaStream_t>(stream));
}
