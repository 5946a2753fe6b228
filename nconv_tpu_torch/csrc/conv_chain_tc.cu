// K4 in bf16 on the tensor cores (nct_conv_chain_tc): two chained 3x3 pad-1
// conv + bias + ReLU stages, out = relu(conv(relu(conv(x, w1) + b1), w2) +
// b2), with the intermediate kept in shared memory, bf16 in and out with f32
// sums. The f32 chain stays on the CUDA cores (chain.cu).
//
// Replaces nconv_tpu/ops/pallas_chain.py:_chain_kernel (:169) in its bf16
// two-stage form (the mixed schedule's fuse_conv2 -> fuse_conv3).
//
// Bound on the H100: at 32-64 channels each stage does 2 * 9 * cmid FLOP
// per byte-pair it reads, near the card's bf16 ridge, so both the bytes and
// the tensor-core issue count; two separate convs would add the intermediate's
// write and read (2 x 57 MB at full resolution and 32 channels). Per tile of
// TH x TW output pixels, built from conv_tc.cu's machinery (channels-last
// staging transposed on the way in from NCHW, ldmatrix, mma.sync m16n8k16
// bf16 -> f32, per-tap partial sums, weights resident, persistent blocks):
//  1. the input tile with a 2-pixel halo, channels-last bf16, zero outside
//     the image;
//  2. stage 1 as a GEMM over the intermediate tile with its 1-pixel halo,
//     (TH + 2) x (TW + 2) pixels taken 16 at a time in row-major order (an
//     A row is any pixel, by its lane's ldmatrix address, so the 18-wide
//     rows waste no MMA rows but the last tile's);
//  3. bias, ReLU, one rounding to bf16 and zero outside the image (stage 2's
//     padding) into shared memory, channels-last;
//  4. stage 2 as a GEMM from shared memory, one output row of 16 per m-tile;
//  5. the epilogue as conv_tc's: bias, ReLU, bf16, staged so the NCHW stores
//     are 16-byte vectors.
// Both stages' weights stay resident (up to 2 x 9 x 64 x 72 bf16 = 166 KB at
// 64 channels with the conflict-free row padding), so a block holds one
// 8 x 16 tile: stage 1 computes 180 intermediate pixels (192 MMA rows) for
// 128 outputs, a halo recompute of 1.41x (1.5x in MMA rows) on stage 1 and
// none on stage 2. The next tile's input loads into registers while stage 2
// runs.
#include "tc.cuh"

namespace nct {
namespace chain_tc {

constexpr int TH = 8, TW = 16;            // output tile
constexpr int MH = TH + 2, MW = TW + 2;   // intermediate tile
constexpr int MP = MH * MW;               // its pixels
constexpr int IH = TH + 4, IW = TW + 4;   // input tile
constexpr int G = 4;                      // 8-pixel groups loaded per input row, from ox0 - 8
constexpr int WM = 4, WN = 2;             // warps along M and N
constexpr int THREADS = 32 * WM * WN;
constexpr int MT1 = 3;                    // stage-1 m-tiles per warp: WM x MT1 x 16 = 192 >= MP
constexpr int MT2 = TH / WM;              // stage-2 m-tiles (output rows) per warp
constexpr int OS = TH * TW + 8;           // output stage: bf16 per channel, padded
static_assert(WM * MT1 * 16 >= MP, "stage-1 m-tiles cover the intermediate tile");

struct Args {
  const unsigned short* x;  // (B, cin, H, W) bf16 bits, contiguous
  int B, H, W, cin, cmid, cout;
  int kc1;           // cin rounded up to 16
  int cmidp, coutp;  // cmid and cout rounded up to the warps' columns (32 or 64): zero weights past them
  int cps1, cps2;    // shared-memory row, bf16, of an input pixel / w1 column (kc1 + 8), a mid pixel / w2 column
  const void *w1, *b1, *w2, *b2;  // (cmid, cin, 3, 3), (cmid), (cout, cmid, 3, 3), (cout)
  int w_bf16;                      // their storage type: f32 (0) or bf16 (1)
  unsigned short* out;             // (B, cout, H, W) bf16 bits, contiguous
  int vec;                         // 1: x's rows may be read as aligned 16-byte vectors
  int out_vec;                     // 1: out's rows may be written as 16-byte vectors
  int tiles_x, tiles_y, tiles;
};

struct Smem {  // byte offsets into the dynamic shared memory (cmid, cout: padded)
  size_t w1, w2, b1, b2, in, mid, total;
  __host__ __device__ Smem(int cmid, int cout, int cps1, int cps2) {
    w1 = 0;
    w2 = w1 + size_t(9) * cmid * cps1 * 2;
    b1 = w2 + size_t(9) * cout * cps2 * 2;
    b2 = b1 + size_t(cmid) * 4;
    in = b2 + size_t(cout) * 4;
    mid = in + size_t(IH) * IW * cps1 * 2;  // then the output stage
    const size_t mid_rows = size_t(WM) * MT1 * 16 * cps2 * 2, stage = size_t(cout) * OS * 2;
    total = mid + (mid_rows > stage ? mid_rows : stage);
  }
};

// Four channels (c0 .. c0 + 3) x 8 pixels from x of input-tile row yy and
// 8-pixel group g of the tile at (b, oy0, ox0), as four 16-byte rows; zero
// outside the image and past cin.
__device__ __forceinline__ void load_unit(const Args& a, int b, int oy0, int ox0, int q, int rest,
                                          uint4 (&v)[4]) {
  const int y = oy0 - 2 + rest / G, x = ox0 - 8 + 8 * (rest % G), c0 = 4 * q;
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = make_uint4(0, 0, 0, 0);
  if (c0 >= a.cin || y < 0 || y >= a.H || x + 8 <= 0 || x >= a.W) return;
  const long long plane = static_cast<long long>(a.H) * a.W;
  const unsigned short* row = a.x + (static_cast<long long>(b) * a.cin + c0) * plane + static_cast<long long>(y) * a.W;
  const bool whole = a.vec && x >= 0 && x + 8 <= a.W;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (c0 + k >= a.cin) break;
    const unsigned short* r = row + k * plane;
    if (whole) {
      v[k] = *reinterpret_cast<const uint4*>(r + x);
    } else {
      uint32_t e[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] = (x + j >= 0 && x + j < a.W) ? r[x + j] : 0u;
      v[k] = make_uint4(e[0] | (e[1] << 16), e[2] | (e[3] << 16), e[4] | (e[5] << 16), e[6] | (e[7] << 16));
    }
  }
}

// The unit's pixels that fall in the tile (columns 8 g + j - 6), as
// channel-quads of the input tile's rows.
__device__ __forceinline__ void store_unit(const Args& a, unsigned short* in, int q, int rest, const uint4 (&v)[4]) {
  const int g = rest % G, yy = rest / G;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int xx = 8 * g + j - 6;
    if (xx < 0 || xx >= IW) continue;
    *reinterpret_cast<uint2*>(in + (yy * IW + xx) * a.cps1 + 4 * q) = tc::quad_of(v, j);
  }
}

__device__ __forceinline__ void tile_origin(const Args& a, int t, int& b, int& oy0, int& ox0) {
  const int per = a.tiles_x * a.tiles_y, r = t % per;
  b = t / per;
  oy0 = (r / a.tiles_x) * TH;
  ox0 = (r % a.tiles_x) * TW;
}

// MT m-tiles (A rows at per-lane addresses am[m]) by NTP pairs of 8-column
// n-tiles; the fragments of k-chunk k + 1 load while the MMAs of chunk k
// issue.
template <int MT, int NTP>
struct Frags {
  uint32_t a[MT][4], b[NTP][4];
  __device__ __forceinline__ void load(const uint32_t (&am)[MT], uint32_t b0, uint32_t bpair, int k) {
#pragma unroll
    for (int m = 0; m < MT; ++m) ldsm_x4(a[m], am[m] + 32 * k);
#pragma unroll
    for (int p = 0; p < NTP; ++p) ldsm_x4(b[p], b0 + p * bpair + 32 * k);
  }
  __device__ __forceinline__ void mma(float (&acc)[MT][2 * NTP][4]) const {
#pragma unroll
    for (int p = 0; p < NTP; ++p)
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        mma_bf16(acc[m][2 * p], a[m], b[p][0], b[p][1]);
        mma_bf16(acc[m][2 * p + 1], a[m], b[p][2], b[p][3]);
      }
  }
};

// acc += one tap's product over all of K, summed apart and joined with one
// rounded add (the tensor cores' f32 sums truncate: conv_tc.cu, mma_tap).
template <int MT, int NTP>
__device__ __forceinline__ void mma_tap(float (&acc)[MT][2 * NTP][4], const uint32_t (&am)[MT], uint32_t tap,
                                        uint32_t b0, uint32_t bpair, int kchunks) {
  uint32_t at[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) at[m] = am[m] + tap;
  float part[MT][2 * NTP][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < 2 * NTP; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[m][n][e] = 0.f;
  Frags<MT, NTP> f0, f1;
  f0.load(at, b0, bpair, 0);
  int k = 0;
  for (; k + 2 <= kchunks; k += 2) {
    f1.load(at, b0, bpair, k + 1);
    f0.mma(part);
    if (k + 2 < kchunks) f0.load(at, b0, bpair, k + 2);
    f1.mma(part);
  }
  if (k < kchunks) f0.mma(part);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < 2 * NTP; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] += part[m][n][e];
}

// NTP1 = cmidp / 32, NTP2 = coutp / 32: each of the WN warps along N takes
// half of a stage's columns. One block a SM: the 64-channel weights fill its
// shared memory, and capping the 32-channel forms at 128 registers for two
// blocks spilled and ran slower on the H100.
template <int NTP1, int NTP2>
__global__ void __launch_bounds__(THREADS, 1) chain_tc_kernel(const Args a) {
  constexpr int MAXU = 3;  // input units (4 channels x 8 pixels) prefetched per thread
  NCT_DYN_SHARED(unsigned char, smem);
  const Smem sm(a.cmidp, a.coutp, a.cps1, a.cps2);
  unsigned short* w1s = reinterpret_cast<unsigned short*>(smem + sm.w1);
  unsigned short* w2s = reinterpret_cast<unsigned short*>(smem + sm.w2);
  float* b1s = reinterpret_cast<float*>(smem + sm.b1);
  float* b2s = reinterpret_cast<float*>(smem + sm.b2);
  unsigned short* in = reinterpret_cast<unsigned short*>(smem + sm.in);
  unsigned short* mid = reinterpret_cast<unsigned short*>(smem + sm.mid);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WM, wn = warp / WM;

  // -- weights (rounded to bf16) and biases, once per block: zero, then
  // scatter each stored row of 9 taps into its slots [tap][column][k]
  for (int i = tid; i < static_cast<int>(sm.in / 16); i += THREADS)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  for (int i = tid; i < a.cmidp; i += THREADS) b1s[i] = i < a.cmid ? load_w(a.b1, a.w_bf16, i) : 0.f;
  for (int i = tid; i < a.coutp; i += THREADS) b2s[i] = i < a.cout ? load_w(a.b2, a.w_bf16, i) : 0.f;
  auto put = [&](unsigned short* ws, int cps, int ncol, int slot, int co, int k, const void* src, long long i) {
    ws[(slot * ncol + co) * cps + k] = __bfloat16_as_ushort(__float2bfloat16(load_w(src, a.w_bf16, i)));
  };
  {
    tc::Walk w(tid, THREADS, a.cin);  // q: input channel, rest: output channel
    for (int rr = tid; rr < a.cmid * a.cin; rr += THREADS, w.next())
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) put(w1s, a.cps1, a.cmidp, tap, w.rest, w.q, a.w1, 9LL * rr + tap);
  }
  {
    tc::Walk w(tid, THREADS, a.cmid);
    for (int rr = tid; rr < a.cout * a.cmid; rr += THREADS, w.next())
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) put(w2s, a.cps2, a.coutp, tap, w.rest, w.q, a.w2, 9LL * rr + tap);
  }

  // -- per-lane ldmatrix addresses. A: row q = lane % 16 of an m-tile, at
  // channel 8 (lane / 16); B: column (lane / 16) * 8 + lane % 8 of the
  // warp's first column pair, at channel 8 ((lane / 8) % 2)
  const int q = lane & 15;
  const uint32_t rowb1 = a.cps1 * 2, rowb2 = a.cps2 * 2;
  uint32_t am1[MT1], am2[MT2];
#pragma unroll
  for (int m = 0; m < MT1; ++m) {
    int p = (wm * MT1 + m) * 16 + q;
    p = p < MP ? p : MP - 1;  // rows past the intermediate tile read its last pixel; never stored
    am1[m] = smem_u32(in) + ((p / MW) * IW + p % MW) * rowb1 + (lane >> 4) * 16;
  }
#pragma unroll
  for (int m = 0; m < MT2; ++m) am2[m] = smem_u32(mid) + ((wm * MT2 + m) * MW + q) * rowb2 + (lane >> 4) * 16;
  const int c1 = wn * 16 * NTP1, c2 = wn * 16 * NTP2;  // the warp's first column of each stage
  const int bcol = (lane >> 4) * 8 + (lane & 7);
  const uint32_t bk = ((lane >> 3) & 1) * 16;
  const uint32_t bl1 = smem_u32(w1s) + (c1 + bcol) * rowb1 + bk, bl2 = smem_u32(w2s) + (c2 + bcol) * rowb2 + bk;
  const uint32_t slot1 = a.cmidp * rowb1, slot2 = a.coutp * rowb2;
  const int k1 = a.kc1 / 16, k2 = a.cmidp / 16;
  const int nq = a.kc1 / 4, units = IH * G * nq;
  const int gid = lane >> 2, cq = (lane & 3) * 2;

  int t = blockIdx.x;
  if (t >= a.tiles) return;
  {
    int b, oy0, ox0;
    tile_origin(a, t, b, oy0, ox0);
    tc::Walk w(tid, THREADS, nq);
    for (int ui = tid; ui < units; ui += THREADS, w.next()) {
      uint4 v[4];
      load_unit(a, b, oy0, ox0, w.q, w.rest, v);
      store_unit(a, in, w.q, w.rest, v);
    }
  }
  __syncthreads();

  for (; t < a.tiles; t += gridDim.x) {
    int b, oy0, ox0;
    tile_origin(a, t, b, oy0, ox0);

    // -- stage 1: the intermediate tile from the input tile
    {
      float acc[MT1][2 * NTP1][4];
#pragma unroll
      for (int m = 0; m < MT1; ++m)
#pragma unroll
        for (int n = 0; n < 2 * NTP1; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap)
        mma_tap<MT1, NTP1>(acc, am1, ((tap / 3) * IW + tap % 3) * rowb1, bl1 + tap * slot1, 16 * rowb1, k1);
      // bias, ReLU, one rounding to bf16, zero outside the image
#pragma unroll
      for (int m = 0; m < MT1; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = (wm * MT1 + m) * 16 + gid + 8 * h;
          if (p >= MP) continue;
          const int gy = oy0 - 1 + p / MW, gx = ox0 - 1 + p % MW;
          const bool inside = gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
#pragma unroll
          for (int n = 0; n < 2 * NTP1; ++n) {
            const int col = c1 + n * 8 + cq;
            uint32_t pair = 0;
            if (inside) {
              const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16(fmaxf(acc[m][n][2 * h] + b1s[col], 0.f)));
              const uint32_t hi =
                  __bfloat16_as_ushort(__float2bfloat16(fmaxf(acc[m][n][2 * h + 1] + b1s[col + 1], 0.f)));
              pair = lo | (hi << 16);
            }
            *reinterpret_cast<uint32_t*>(mid + p * a.cps2 + col) = pair;
          }
        }
    }
    __syncthreads();  // the intermediate is whole; the input tile is free

    // -- the next tile's input, into registers while stage 2 runs
    const int tn = t + gridDim.x;
    int nb = 0, noy0 = 0, nox0 = 0;
    uint4 pf[MAXU][4];
    if (tn < a.tiles) {
      tile_origin(a, tn, nb, noy0, nox0);
      tc::Walk w(tid, THREADS, nq);
#pragma unroll
      for (int i = 0; i < MAXU; ++i, w.next())
        if (tid + i * THREADS < units) load_unit(a, nb, noy0, nox0, w.q, w.rest, pf[i]);
    }

    // -- stage 2: the output tile from the intermediate
    float acc[MT2][2 * NTP2][4];
#pragma unroll
    for (int m = 0; m < MT2; ++m)
#pragma unroll
      for (int n = 0; n < 2 * NTP2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap)
      mma_tap<MT2, NTP2>(acc, am2, ((tap / 3) * MW + tap % 3) * rowb2, bl2 + tap * slot2, 16 * rowb2, k2);

    if (tn < a.tiles) {
      tc::Walk w(tid, THREADS, nq);
#pragma unroll
      for (int i = 0; i < MAXU; ++i, w.next())
        if (tid + i * THREADS < units) store_unit(a, in, w.q, w.rest, pf[i]);
      for (int ui = tid + MAXU * THREADS; ui < units; ui += THREADS, w.next()) {
        uint4 v[4];
        load_unit(a, nb, noy0, nox0, w.q, w.rest, v);
        store_unit(a, in, w.q, w.rest, v);
      }
    }
    __syncthreads();  // every warp is done with the intermediate

    // -- epilogue: bias, ReLU, bf16 into the stage over the intermediate
    {
      __nv_bfloat16* st = reinterpret_cast<__nv_bfloat16*>(mid);
#pragma unroll
      for (int m = 0; m < MT2; ++m)
#pragma unroll
        for (int n = 0; n < 2 * NTP2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int px = gid + (e >> 1) * 8, col = c2 + n * 8 + cq + (e & 1), r = wm * MT2 + m;
            st[col * OS + r * TW + px] = __float2bfloat16(fmaxf(acc[m][n][e] + b2s[col], 0.f));
          }
    }
    __syncthreads();
    {
      constexpr int VPR = TW / 8;  // 16-byte vectors per stage row
      for (int i = tid; i < a.cout * TH * VPR; i += THREADS) {
        const int vx = i % VPR, rr = (i / VPR) % TH, co = i / (VPR * TH);
        const int oy = oy0 + rr, ox = ox0 + vx * 8;
        if (oy >= a.H || ox >= a.W) continue;
        const uint4 v = *reinterpret_cast<const uint4*>(mid + co * OS + rr * TW + vx * 8);
        unsigned short* dst = a.out + ((static_cast<long long>(b) * a.cout + co) * a.H + oy) * a.W + ox;
        if (a.out_vec && ox + 8 <= a.W) {
          *reinterpret_cast<uint4*>(dst) = v;
        } else {
          const unsigned short* e = reinterpret_cast<const unsigned short*>(&v);
          for (int j = 0; j < 8 && ox + j < a.W; ++j) dst[j] = e[j];
        }
      }
    }
    __syncthreads();  // the stage is read out; the next input tile is whole
  }
}

template <int NTP1, int NTP2>
int launch(Args& a, size_t smem, cudaStream_t st) {
  void (*k)(const Args) = chain_tc_kernel<NTP1, NTP2>;
  int resident = 0;
  if (const int e = resident_blocks(k, THREADS, smem, resident)) return e;
  const int grid = a.tiles < resident ? a.tiles : resident;
  NCT_LAUNCH(k, dim3(grid), dim3(THREADS), smem, st, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace chain_tc
}  // namespace nct

// Plain C entry. x: (B, cin, H, W) bf16, contiguous; w1 (cmid, cin, 3, 3),
// b1 (cmid), w2 (cout, cmid, 3, 3), b2 (cout), all f32 (w_dtype 0) or all
// bf16 (1), the weights rounded to bf16 as they are staged; out (B, cout, H,
// W) bf16, contiguous. Takes cmid and cout up to 64 (run as 32 or 64
// columns) and cin up to where both stages' weights and the tiles fit in
// shared memory (80 at 64 channels); returns cudaErrorInvalidValue for any
// other call, else cudaGetLastError() after the launch.
extern "C" int nct_conv_chain_tc(const void* x, int B, int H, int W, int cin, int cmid, int cout, const void* w1,
                                 const void* b1, const void* w2, const void* b2, int w_dtype, void* out,
                                 void* stream) {
  using namespace nct;
  using namespace nct::chain_tc;
  if (B < 1 || H < 1 || W < 1 || cin < 1 || cmid < 1 || cmid > 64 || cout < 1 || cout > 64 ||
      (w_dtype != F32 && w_dtype != BF16) || !b1 || !b2)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.x = static_cast<const unsigned short*>(x);
  a.B = B, a.H = H, a.W = W, a.cin = cin, a.cmid = cmid, a.cout = cout;
  a.kc1 = (cin + 15) / 16 * 16;
  a.cmidp = cmid <= 32 ? 32 : 64;
  a.coutp = cout <= 32 ? 32 : 64;
  a.cps1 = a.kc1 + 8;
  a.cps2 = a.cmidp + 8;
  a.w1 = w1, a.b1 = b1, a.w2 = w2, a.b2 = b2, a.w_bf16 = w_dtype == BF16;
  a.out = static_cast<unsigned short*>(out);
  a.vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && W % 8 == 0;
  a.out_vec = reinterpret_cast<uintptr_t>(out) % 16 == 0 && W % 8 == 0;
  a.tiles_x = (W + TW - 1) / TW;
  a.tiles_y = (H + TH - 1) / TH;
  a.tiles = B * a.tiles_x * a.tiles_y;
  const size_t smem = Smem(a.cmidp, a.coutp, a.cps1, a.cps2).total;
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (a.cmidp == 64) return a.coutp == 64 ? launch<2, 2>(a, smem, st) : launch<2, 1>(a, smem, st);
  return a.coutp == 64 ? launch<1, 2>(a, smem, st) : launch<1, 1>(a, smem, st);
}
