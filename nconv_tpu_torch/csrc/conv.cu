// K2: direct 3x3 pad-1 convolution, stride 1 or 2, + bias + optional ReLU,
// with an optional fused residual epilogue relu(conv3x3(x) + b) + conv1x1(x)
// (the 1x1 shortcut at the same stride reads the 3x3 window's centre tap);
// and a K x K form without bias for the training backward (nct_conv_kxk):
// K in {1, 3, 5} at stride 1, and 4x4 at stride 2, f32 in and out. Both run
// on one output-stationary kernel (convkxk_kernel below), the forward as a
// form of it. The bf16 -> bf16 forward with 8 or more output channels and
// the bf16 forms of the K x K backward run on the tensor cores instead
// (conv_tc.cu), and the stride-1 bf16 outputs of narrow heads and of the
// uint8 frame on the thin form (conv_thin.cu).
//
// Replaces nconv_tpu/ops/pallas_conv.py:_kernel in its stride-1,
// residual_channels, multi-part, uint8-decode and stride-2 (lane_stride2 /
// s2d) forms. Strided access is native here, so stride 2 is a strided read
// of the staged rows instead of the TPU's row-pair transforms.
//
// Which kernel takes a call of nct_conv3x3: f32 parts, and uint8 parts with
// an f32 output (the f32 frame's encoder), go to the output-stationary
// kernel. The bf16-input and bf16-output forms that no recorded path
// reaches (bf16 parts with an f32 output; bf16 -> bf16 at stride 2 below 8
// channels; uint8 -> bf16 at stride 2; the mixed schedule runs conv_tc and
// conv_thin) stay on the first, simple template below: a block stages an
// input tile of 8 channels with halo and the weights of COT = 16 output
// channels in shared memory, each thread keeps COT channels of one pixel.
#include "common.cuh"

namespace nct {

constexpr int C_TW = 32, C_TH = 4, C_CIC = 8, C_THREADS = C_TW * C_TH;

struct ConvArgs {
  Part parts[MAX_PARTS];
  int nparts, B, H, W, cin, ho, wo, cout, relu;
  const float* w;     // (cout, cin, 3, 3)
  const float* wsc;   // (cout, cin): 1x1 shortcut, residual form only
  const float* bias;  // (cout) or null
  void* out;          // (B, cout, ho, wo), contiguous
};

template <typename Tin, typename Tout, int S, int COT, bool RES>
__global__ void __launch_bounds__(C_THREADS) conv3x3_kernel(const ConvArgs a) {
  constexpr int IW = (C_TW - 1) * S + 3, IH = (C_TH - 1) * S + 3;
  __shared__ float xs[C_CIC][IH][IW];
  __shared__ __align__(16) float ws[C_CIC * 9][COT];
  __shared__ __align__(16) float wss[RES ? C_CIC : 1][COT];

  const int groups = (a.cout + COT - 1) / COT;
  const int b = blockIdx.z / groups, co0 = (blockIdx.z % groups) * COT;
  const int tx = threadIdx.x % C_TW, ty = threadIdx.x / C_TW;
  const int ox = blockIdx.x * C_TW + tx, oy = blockIdx.y * C_TH + ty;
  const int ix0 = blockIdx.x * C_TW * S - 1, iy0 = blockIdx.y * C_TH * S - 1;

  float acc[COT];
  float accs[RES ? COT : 1];
#pragma unroll
  for (int j = 0; j < COT; ++j) acc[j] = 0.f;
#pragma unroll
  for (int j = 0; j < (RES ? COT : 1); ++j) accs[j] = 0.f;

  for (int c0 = 0; c0 < a.cin; c0 += C_CIC) {
    __syncthreads();
    for (int i = threadIdx.x; i < C_CIC * IH * IW; i += C_THREADS) {
      const int cc = i / (IH * IW), r = i % (IH * IW);
      const int yy = r / IW, xx = r % IW, c = c0 + cc;
      xs[cc][yy][xx] = c < a.cin ? load_parts<Tin>(a.parts, a.nparts, b, c,
                                                   iy0 + yy, ix0 + xx, a.H, a.W)
                                 : 0.f;
    }
    for (int i = threadIdx.x; i < C_CIC * 9 * COT; i += C_THREADS) {
      const int j = i % COT, t = i / COT, cc = t / 9, k = t % 9;
      const int co = co0 + j, c = c0 + cc;
      ws[t][j] = (co < a.cout && c < a.cin)
                     ? a.w[((long long)co * a.cin + c) * 9 + k]
                     : 0.f;
    }
    if constexpr (RES) {
      for (int i = threadIdx.x; i < C_CIC * COT; i += C_THREADS) {
        const int j = i % COT, cc = i / COT, co = co0 + j, c = c0 + cc;
        wss[cc][j] = (co < a.cout && c < a.cin)
                         ? a.wsc[(long long)co * a.cin + c]
                         : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int cc = 0; cc < C_CIC; ++cc) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float v = xs[cc][ty * S + ky][tx * S + kx];
#pragma unroll
          for (int j = 0; j < COT; ++j)
            acc[j] = fmaf(v, ws[cc * 9 + ky * 3 + kx][j], acc[j]);
        }
      }
      if constexpr (RES) {
        const float v = xs[cc][ty * S + 1][tx * S + 1];
#pragma unroll
        for (int j = 0; j < COT; ++j) accs[j] = fmaf(v, wss[cc][j], accs[j]);
      }
    }
  }

  if (oy >= a.ho || ox >= a.wo) return;
  Tout* out = static_cast<Tout*>(a.out);
#pragma unroll
  for (int j = 0; j < COT; ++j) {
    const int co = co0 + j;
    if (co < a.cout) {
      float v = acc[j] + (a.bias ? a.bias[co] : 0.f);
      if (a.relu) v = fmaxf(v, 0.f);
      if constexpr (RES) v += accs[j];
      out[(((long long)b * a.cout + co) * a.ho + oy) * a.wo + ox] =
          from_f<Tout>(v);
    }
  }
}

template <typename Tin, typename Tout, int S, int COT, bool RES>
static int launch(const ConvArgs& a, cudaStream_t st) {
  const dim3 grid((a.wo + C_TW - 1) / C_TW, (a.ho + C_TH - 1) / C_TH,
                  a.B * ((a.cout + COT - 1) / COT));
  void (*k)(const ConvArgs) = conv3x3_kernel<Tin, Tout, S, COT, RES>;
  NCT_LAUNCH(k, grid, dim3(C_THREADS), 0, st, a);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tin, typename Tout, int S>
static int dispatch_form(const ConvArgs& a, bool res, cudaStream_t st) {
  if (res) return launch<Tin, Tout, S, 16, true>(a, st);
  if (a.cout >= 16) return launch<Tin, Tout, S, 16, false>(a, st);
  return launch<Tin, Tout, S, 1, false>(a, st);
}

template <typename Tin, typename Tout>
static int dispatch_stride(const ConvArgs& a, int stride, bool res,
                           cudaStream_t st) {
  return stride == 1 ? dispatch_form<Tin, Tout, 1>(a, res, st)
                     : dispatch_form<Tin, Tout, 2>(a, res, st);
}

// ---------------------------------------------------------------------------
// The output-stationary kernel, f32 out, in three forms (template F):
//  * GRAD, the training backward's K x K conv, no bias and no ReLU, one f32
//    part, pad in [0, K-1]:
//    - stride 1, K in {1, 3, 5}: the input-gradient conv of a stride-1 conv
//      (the cotangent against the flipped, in/out-transposed kernel), which
//      the TPU ran on the same _kernel through transpose_conv_bhcw
//      (pallas_conv.py:797). The weight is the forward conv's (cin_fwd =
//      cout, cout_fwd = cin, K, K) as stored, flipped and transposed while
//      staged, so no call copies it;
//    - stride 2, K = 4, pad 1: the input gradient of the 4x4/s2/p1
//      transpose conv, a plain strided conv of its output cotangent with the
//      transpose conv's (cin, cout, 4, 4) weight read as OIHW (no flip),
//      which the TPU ran as a row-pair lane_stride2 conv (pallas_s2.py:
//      _ct_bwd, :228-248);
//  * FWD, K2's forward: the 3x3 pad-1 conv at stride 1 or 2 over up to 4
//    parts of f32 or uint8 (raw 0..255; the f32 frame's NHWC encoder input),
//    each read through its own strides, OIHW weight as stored, + bias
//    (optional) and ReLU (optional) in the epilogue;
//  * FWD_RES, the residual forward relu(conv3x3(x) + b) + conv1x1(x), in the
//    JAX order: the shortcut sums in a second accumulator from the window's
//    centre tap, its weight a tenth row of each channel's staged weights.
// The layout of the weight follows the form and the stride: no runtime flag.
//
// Bound on the H100: operations (f32 FMAs on the CUDA cores; a 3x3 call
// does 9 x cout FMAs a staged input value), except the cout-1 heads, which
// are bound by reading their input. Design:
//  * A block covers R rows x 32 pixels of the output and a group of output
//    channels: all of them up to 128 (48 for the 4x4/s2 backward), wider
//    calls in balanced groups (65 -> 33 + 32, never 64 + 1), so the input
//    tile is staged once a group, not once every 16 channels. A grid short
//    of half the SMs (the 44x152 level at B = 1) splits its channels into
//    more groups instead, down to 16 a group, except in the forward's
//    stride-2 calls, where the split loses.
//  * Warp (tile row, channel slab); lane (pixel group, channel group): a
//    thread holds PX consecutive pixels x CO channels of PY rows. Per input
//    channel it loads the S (PX - 1) + K input values its pixels' taps span
//    in each staged row it reads, then per tap its CO weights as float4
//    broadcasts, once for all PY rows: at PX 4, CO 8, K = 3, PY 1, 96 FMAs
//    per 12 shared-memory loads.
//  * At stride 2 the staged rows are split by column parity (even columns,
//    then odd), so a warp's strided reads are unit-stride and free of bank
//    conflicts. At stride 1 a row starts 4 columns before the tile, so an
//    f32 part whose rows are 16-byte aligned (vec_rows<4>, width a multiple
//    of 4) is staged by 16-byte copies.
//  * Input channels come in chunks (8; 4 at stride 2, whose patch is twice
//    as wide), staged by cp.async (zero outside the image; the part looked
//    up once a staged row) two stages deep: chunk c + 1's copies fly while
//    chunk c's FMAs run. A uint8 part is widened by plain loads into the
//    same stage. Weights are staged as [channel x tap][output channel]
//    rows (common.cuh padded_row: the transposing copies do not collide on
//    a bank). The channel loop stops at cin: the 1- and 3-channel calls do
//    no FMAs on staged zeros.
//  * Tile shapes by plan, slab = CGW x CO channels: D (PX 2, CO 4, slab 8)
//    up to 8 channels, C (4, 4, slab 16) for 9-16 (and a small grid's
//    groups), then by form: the backward's stride-1 groups P (4, 8, PY 2,
//    slab 32), its 4x4/s2 groups C up to 32 and E (4, 12, slab 48) for
//    33-48; the forward's B (4, 8, slab 32) at stride 1 and in the residual
//    form, F (8, 8, slab 64) at stride 2, H (1, 1) for the cout-1 heads.
//    Each beats the tiles it displaces on the calls that take it
//    (runtime/plan_probe.py; PERF.md).
// ---------------------------------------------------------------------------

namespace kxk {

constexpr int TW = 32, MAX_WARPS = 8, SMS = 132;

enum Form : int { GRAD = 0, FWD = 1, FWD_RES = 2 };

struct Args {
  Part parts[MAX_PARTS];  // the input's channel concat, all (B, H, W); GRAD: one part
  int nparts, u8, vec;    // u8: the parts are uint8; vec: stride 1, every part's rows as 16-byte vectors
  int B, H, W, cin, ho, wo, cout, pad, relu;
  int width, wst;    // output channels a group, and a staged weight row (slabs x slab, padded_row)
  int ns, rows;      // slabs, and output rows a block (its warp rows x PY)
  const float* w;    // GRAD at S = 1: the forward conv's (cin, cout, K, K), read flipped; else (cout, cin, K, K)
  const float* wsc;  // FWD_RES: (cout, cin), the 1x1 shortcut
  const float* bias; // FWD, FWD_RES: (cout) or null
  float* out;        // (B, cout, ho, wo), contiguous
};

template <int K, int S, int F>
struct Geo {
  // weight rows a channel: the taps, then the shortcut's
  static constexpr int KK = K * K, KW = KK + (F == FWD_RES);
  // input channels a stage: 4 at stride 2, whose patch is twice as wide, so
  // two stages leave room for two blocks an SM
  static constexpr int IW = (TW - 1) * S + K, CIC = S == 2 ? 4 : 8;
  // a stage row: at stride 1 from 4 columns before the tile (16-byte
  // aligned), at stride 2 split by column parity
  static constexpr int IWH = (IW + 1) / 2, IWS = S == 2 ? 2 * IWH : (IW + 7) / 4 * 4;
  static __host__ __device__ constexpr int ih(int rows) { return (rows - 1) * S + K; }
  // one stage: the x patch of CIC channels, then CIC x KW weight rows
  static __host__ __device__ constexpr int xsz(int rows) { return CIC * ih(rows) * IWS; }
  static __host__ __device__ constexpr int stage(int rows, int wst) { return xsz(rows) + CIC * KW * wst; }
};

template <int K, int S, int F, int PX, int CO, int CGW, int PY>
__global__ void __launch_bounds__(32 * MAX_WARPS) convkxk_kernel(const Args a) {
  using G = Geo<K, S, F>;
  constexpr int PGW = 32 / CGW, SEG = S * (PX - 1) + K, SLAB = CGW * CO, RY = S * (PY - 1) + K;
  constexpr bool RES = F == FWD_RES;
  static_assert(PGW * PX == TW && (CO % 4 == 0 || CO == 1), "a warp spans a 32-pixel row; weights as float4");
  NCT_DYN_SHARED(float, smem);
  const int nthr = blockDim.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slab = warp % a.ns, row = warp / a.ns;
  const int pg = lane % PGW, cg = lane / PGW;
  const int groups = (a.cout + a.width - 1) / a.width;
  const int b = blockIdx.z / groups, co0 = (blockIdx.z % groups) * a.width;
  const int co_end = co0 + a.width < a.cout ? co0 + a.width : a.cout;
  const int ih = G::ih(a.rows), stage_sz = G::stage(a.rows, a.wst);
  const int xb = blockIdx.x * TW, iy0 = blockIdx.y * a.rows * S - a.pad, ix0 = xb * S - a.pad;
  // the stage column of patch column c (input column ix0 + c); at stride 1
  // input column x sits at x - (xb - 4)
  const int off = 4 - a.pad;
  auto col = [&](int c) { return S == 2 ? (c & 1) * G::IWH + (c >> 1) : c + off; };

  // input channels c0 .. c0 + CIC - 1 (up to cin) into stage buf: the patch, then the weights
  auto stage = [&](int c0, int buf) {
    float* xs = smem + buf * stage_sz;
    float* ws = xs + G::xsz(a.rows);
    const int ncc = a.cin - c0 < G::CIC ? a.cin - c0 : G::CIC;
    for (int u = warp; u < ncc * ih; u += nthr / 32) {
      const int y = iy0 + u % ih;
      int c = c0 + u / ih;
      const Part& p = a.parts[part_of(a.parts, a.nparts, c)];
      float* drow = xs + u * G::IWS;
      const bool live = y >= 0 && y < a.H;
      const long long base = live ? b * p.sb + c * p.sc + y * p.sh : 0;
      if (a.u8) {  // widened by plain loads
        const uint8_t* src = static_cast<const uint8_t*>(p.ptr) + base;
        for (int xx = lane; xx < G::IW; xx += 32) {
          const int x = ix0 + xx;
          drow[col(xx)] = live && x >= 0 && x < a.W ? static_cast<float>(src[x * p.sw]) : 0.f;
        }
      } else if (S == 1 && a.vec) {  // whole vectors, in or out of the image (W % 4 == 0)
        stage_row<4>(drow, static_cast<const float*>(p.ptr) + base, xb - 4, G::IWS / 4, a.W, live, lane);
      } else {
        const float* src = static_cast<const float*>(p.ptr) + base;
        for (int xx = lane; xx < G::IW; xx += 32) {
          const int x = ix0 + xx;
          const bool in = live && x >= 0 && x < a.W;
          cp_async4(smem_u32(drow + col(xx)), in ? src + x * p.sw : src, in ? 4 : 0);
        }
      }
    }
    if constexpr (F == GRAD && S == 1) {  // forward w[c][co][K-1-dy][K-1-dx]: an input channel's width x KK are contiguous
      for (int cc = 0; cc < ncc; ++cc) {
        const int c = c0 + cc;
        for (int i = tid; i < a.wst * G::KK; i += nthr) {
          const int j = i / G::KK, t = i % G::KK, co = co0 + j;
          const bool in = co < co_end;
          const float* src = a.w + (in ? (static_cast<long long>(c) * a.cout + co) * G::KK + G::KK - 1 - t : 0);
          cp_async4(smem_u32(ws + (cc * G::KW + t) * a.wst + j), src, in ? 4 : 0);
        }
      }
    } else {  // w[co][c][tap]: an output channel's KK taps of a channel are contiguous
      for (int cc = 0; cc < ncc; ++cc) {
        const float* wc = a.w + static_cast<long long>(c0 + cc) * G::KK;
        for (int i = tid; i < a.wst * G::KK; i += nthr) {
          const int j = i / G::KK, t = i % G::KK, co = co0 + j;
          const bool in = co < co_end;
          cp_async4(smem_u32(ws + (cc * G::KW + t) * a.wst + j), in ? wc + static_cast<long long>(co) * a.cin * G::KK + t : a.w,
                    in ? 4 : 0);
        }
      }
      if constexpr (RES) {
        for (int i = tid; i < a.wst * ncc; i += nthr) {
          const int j = i / ncc, cc = i % ncc, co = co0 + j;
          const bool in = co < co_end;
          const float* src = a.wsc + (in ? static_cast<long long>(co) * a.cin + c0 + cc : 0);
          cp_async4(smem_u32(ws + (cc * G::KW + G::KK) * a.wst + j), src, in ? 4 : 0);
        }
      }
    }
  };

  float acc[PY][PX][CO];
  float accs[RES ? PY : 1][RES ? PX : 1][CO];
#pragma unroll
  for (int y = 0; y < PY; ++y)
#pragma unroll
    for (int q = 0; q < PX; ++q)
#pragma unroll
      for (int k = 0; k < CO; ++k) acc[y][q][k] = 0.f;
  if constexpr (RES) {
#pragma unroll
    for (int y = 0; y < PY; ++y)
#pragma unroll
      for (int q = 0; q < PX; ++q)
#pragma unroll
        for (int k = 0; k < CO; ++k) accs[y][q][k] = 0.f;
  }

  const int wcol = slab * SLAB + cg * CO;  // the thread's first channel in a weight row
  stage(0, 0);
  cp_async_commit();
  for (int c0 = 0; c0 < a.cin; c0 += G::CIC) {
    const int buf = (c0 / G::CIC) & 1;
    cp_async_wait_all();
    __syncthreads();  // chunk c0 staged; every warp is done with the previous chunk's stage
    if (c0 + G::CIC < a.cin) {  // the next chunk's copies fly while this chunk's FMAs run
      stage(c0 + G::CIC, buf ^ 1);
      cp_async_commit();
    }
    const float* xs = smem + buf * stage_sz + row * PY * S * G::IWS;
    const float* ws = smem + buf * stage_sz + G::xsz(a.rows) + wcol;
    const int ncc = a.cin - c0 < G::CIC ? a.cin - c0 : G::CIC;
#pragma unroll 1
    for (int cc = 0; cc < ncc; ++cc) {
      float seg[RY][SEG];  // the S (PX - 1) + K values of each staged row the thread's taps span
#pragma unroll
      for (int r = 0; r < RY; ++r)
#pragma unroll
        for (int e = 0; e < SEG; ++e) seg[r][e] = xs[(cc * ih + r) * G::IWS + col(S * PX * pg + e)];
#pragma unroll
      for (int dy = 0; dy < K; ++dy) {
#pragma unroll
        for (int dx = 0; dx < K; ++dx) {  // a tap's CO weights, read once for the PY rows
          float wv[CO];
          load_w<CO>(ws + (cc * G::KW + dy * K + dx) * a.wst, wv);
#pragma unroll
          for (int y = 0; y < PY; ++y)
#pragma unroll
            for (int q = 0; q < PX; ++q)
#pragma unroll
              for (int k = 0; k < CO; ++k) acc[y][q][k] = fmaf(seg[dy + S * y][S * q + dx], wv[k], acc[y][q][k]);
        }
      }
      if constexpr (RES) {  // the shortcut reads the window's centre tap (pad 1)
        float wv[CO];
        load_w<CO>(ws + (cc * G::KW + G::KK) * a.wst, wv);
#pragma unroll
        for (int y = 0; y < PY; ++y)
#pragma unroll
          for (int q = 0; q < PX; ++q)
#pragma unroll
            for (int k = 0; k < CO; ++k) accs[y][q][k] = fmaf(seg[1 + S * y][S * q + 1], wv[k], accs[y][q][k]);
      }
    }
  }

  const int ox = xb + PX * pg;
  const bool vec_out = PX % 4 == 0 && (a.wo & 3) == 0 && ox + PX <= a.wo;
#pragma unroll
  for (int y = 0; y < PY; ++y) {
    const int oy = blockIdx.y * a.rows + row * PY + y;
    if (oy >= a.ho) break;
#pragma unroll
    for (int k = 0; k < CO; ++k) {
      const int co = co0 + wcol + k;
      if (co >= co_end) break;
      float v[PX];
      const float bk = F != GRAD && a.bias ? a.bias[co] : 0.f;
#pragma unroll
      for (int q = 0; q < PX; ++q) {
        v[q] = acc[y][q][k];
        if constexpr (F != GRAD) {
          v[q] += bk;
          if (a.relu) v[q] = fmaxf(v[q], 0.f);
          if constexpr (RES) v[q] += accs[y][q][k];
        }
      }
      float* o = a.out + ((static_cast<long long>(b) * a.cout + co) * a.ho + oy) * a.wo + ox;
      if (vec_out) {
#pragma unroll
        for (int q = 0; q < PX; q += 4) *reinterpret_cast<float4*>(o + q) = float4{v[q], v[q + 1], v[q + 2], v[q + 3]};
      } else {
#pragma unroll
        for (int q = 0; q < PX; ++q)
          if (ox + q < a.wo) o[q] = v[q];
      }
    }
  }
}

// The launch plan, a function of the shape and form alone: the channel
// groups, the tile shape and its slabs, and the warp rows (8 warps, or 6
// with 3 slabs).
struct Plan {
  char tile;  // 'B' .. 'F', 'H', 'P', as above
  int width, ns, slab, rows;
};

// The widest group a form takes: 48 channels for the 4x4/s2 backward (its
// 16 taps' weights), else 128.
inline int most_of(int form, int stride) { return form == GRAD && stride == 2 ? 48 : 128; }

// The blocks of a grid of groups x (8-row tiles): what the split below reads.
inline long long blocks_of(int B, int ho, int wo, int groups, int rows) {
  return static_cast<long long>((wo + TW - 1) / TW) * B * ((ho + rows - 1) / rows) * groups;
}

// Balanced groups of at most `most` channels; a grid of 8-row tiles short of
// half the SMs (the 44x152 level at B = 1) splits its channels into more
// groups instead, down to 16 channels a group, but in the forward's stride-2
// calls.
inline int groups_of(int B, int ho, int wo, int cout, int stride, int form) {
  const int most = most_of(form, stride), groups = (cout + most - 1) / most;
  if (stride == 2 && form != GRAD) return groups;
  const long long base = blocks_of(B, ho, wo, 1, MAX_WARPS);
  if (base * groups >= SMS / 2) return groups;
  const long long more = (2 * SMS + base - 1) / base, narrowest = (cout + 15) / 16;
  return static_cast<int>(more < narrowest ? more : narrowest);
}

// The tile a group of width output channels takes.
inline char tile_of(int width, int stride, int form) {
  if (form == GRAD && stride == 2) return width > 32 ? 'E' : 'C';
  if (form == FWD && stride == 1 && width == 1) return 'H';
  if (width <= 8) return 'D';
  if (width <= 16) return 'C';
  if (form == GRAD) return 'P';
  return form == FWD && stride == 2 ? 'F' : 'B';
}

// cout in groups of tile t.
inline Plan plan_of(int cout, int groups, char t) {
  Plan p{};
  p.tile = t;
  p.width = (cout + groups - 1) / groups;
  p.slab = t == 'B' || t == 'P' ? 32 : t == 'C' ? 16 : t == 'D' ? 8 : t == 'E' ? 48 : t == 'F' ? 64 : 1;
  p.ns = (p.width + p.slab - 1) / p.slab;
  p.rows = MAX_WARPS / p.ns;
  return p;
}

// The plan of a call: its groups and their tile; F only where its grid
// fills the SMs (B below).
inline Plan plan(int B, int ho, int wo, int cout, int stride, int form) {
  const int groups = groups_of(B, ho, wo, cout, stride, form);
  const Plan p = plan_of(cout, groups, tile_of((cout + groups - 1) / groups, stride, form));
  if (p.tile == 'F' && blocks_of(B, ho, wo, groups, p.rows) < SMS) return plan_of(cout, groups, 'B');
  return p;
}

template <int K, int S, int F, int PX, int CO, int CGW, int PY>
int launch(Args& a, const Plan& p, cudaStream_t st) {
  using G = Geo<K, S, F>;
  void (*k)(const Args) = convkxk_kernel<K, S, F, PX, CO, CGW, PY>;
  a.ns = p.ns, a.rows = p.rows * PY, a.width = p.width, a.wst = padded_row(p.ns * p.slab);
  const int threads = 32 * p.ns * p.rows;
  const size_t smem = 2 * sizeof(float) * G::stage(a.rows, a.wst);
  int resident = 0;  // sets the kernel's shared-memory limit on this device
  if (const int e = resident_blocks(k, threads, smem, resident)) return e;
  const dim3 grid((a.wo + TW - 1) / TW, (a.ho + a.rows - 1) / a.rows, a.B * ((a.cout + a.width - 1) / a.width));
  NCT_LAUNCH(k, grid, dim3(threads), smem, st, a);
  return static_cast<int>(cudaGetLastError());
}

// The tiles a (K, S, F) form is built with: B-D everywhere but the 4x4/s2
// backward (C, E); P at stride 1 but in the residual form; F and H for the
// plain forward at stride 2 and 1. Those its plan does not take stay for
// runtime/plan_probe.py to time against it.
template <int K, int S, int F>
int dispatch(Args& a, const Plan& p, cudaStream_t st) {
  constexpr bool T4 = F == GRAD && S == 2;
  if (p.rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (p.tile) {
    case 'B':
      if constexpr (!T4) return launch<K, S, F, 4, 8, 4, 1>(a, p, st);
      break;
    case 'C': return launch<K, S, F, 4, 4, 4, 1>(a, p, st);
    case 'D':
      if constexpr (!T4) return launch<K, S, F, 2, 4, 2, 1>(a, p, st);
      break;
    case 'E':
      if constexpr (T4) return launch<K, S, F, 4, 12, 4, 1>(a, p, st);
      break;
    case 'H':
      if constexpr (S == 1 && F == FWD) return launch<K, S, F, 1, 1, 1, 1>(a, p, st);
      break;
    case 'F':
      if constexpr (S == 2 && F == FWD) return launch<K, S, F, 8, 8, 8, 1>(a, p, st);
      break;
    case 'P':
      if constexpr (S == 1 && F != FWD_RES) return launch<K, S, F, 4, 8, 4, 2>(a, p, st);
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Launches plan p on form (form, ksize, stride).
inline int run(Args& a, const Plan& p, int form, int ksize, int stride, cudaStream_t st) {
  if (form == GRAD) {
    if (stride == 1) {
      switch (ksize) {
        case 1: return dispatch<1, 1, GRAD>(a, p, st);
        case 3: return dispatch<3, 1, GRAD>(a, p, st);
        case 5: return dispatch<5, 1, GRAD>(a, p, st);
      }
    } else if (stride == 2 && ksize == 4) {
      return dispatch<4, 2, GRAD>(a, p, st);
    }
  } else if (ksize == 3 && (stride == 1 || stride == 2)) {
    if (form == FWD) return stride == 1 ? dispatch<3, 1, FWD>(a, p, st) : dispatch<3, 2, FWD>(a, p, st);
    if (form == FWD_RES) return stride == 1 ? dispatch<3, 1, FWD_RES>(a, p, st) : dispatch<3, 2, FWD_RES>(a, p, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Host side: the forward's Args from nct_conv3x3's (f32 or uint8 parts, f32
// out); false if the parts do not fit (an up2 part, channels that do not sum
// to cin, a wrong output size).
inline bool forward_args(Args& a, const void* const* part_ptrs, const long long* part_meta, int nparts, int u8,
                         int B, int H, int W, int cin, int ho, int wo, int cout, int stride, const float* w,
                         const float* wsc, const float* bias, void* out, int relu) {
  fill_parts(a.parts, part_ptrs, part_meta, nparts);
  a.nparts = nparts, a.u8 = u8, a.vec = !u8 && stride == 1 && W % 4 == 0;
  int c = 0;
  for (int i = 0; i < nparts; ++i) {
    if (a.parts[i].up2) return false;  // no caller reads an upsampled part through K2
    c += a.parts[i].c;
    a.vec = a.vec && vec_rows<4>(a.parts[i]);
  }
  if (B < 1 || cin < 1 || cout < 1 || c != cin || ho != (H - 1) / stride + 1 || wo != (W - 1) / stride + 1)
    return false;
  a.B = B, a.H = H, a.W = W, a.cin = cin, a.ho = ho, a.wo = wo, a.cout = cout, a.pad = 1, a.relu = relu;
  a.w = w, a.wsc = wsc, a.bias = bias, a.out = static_cast<float*>(out);
  return true;
}

}  // namespace kxk

}  // namespace nct

// Plain C entry. parts: n pointers + 6*n metadata (see nct::fill_parts);
// all parts share (B, H, W), and none is read upsampled (up2 0). f32 parts,
// and uint8 parts with an f32 output, run on the output-stationary kernel
// (nct::kxk, forms FWD / FWD_RES); the bf16-input and bf16-output forms on
// the simple template. Returns cudaGetLastError() after the launch.
extern "C" int nct_conv3x3(const void* const* part_ptrs,
                           const long long* part_meta, int nparts,
                           int in_dtype, int out_dtype, int B, int H, int W,
                           int cin, int ho, int wo, int cout, int stride,
                           const float* w, const float* wsc, const float* bias,
                           void* out, int relu, void* stream) {
  using namespace nct;
  if (nparts < 1 || nparts > MAX_PARTS || (stride != 1 && stride != 2) ||
      (in_dtype == F32 && out_dtype != F32))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < nparts; ++i)
    if (part_meta[6 * i + 1]) return static_cast<int>(cudaErrorInvalidValue);
  const bool res = wsc != nullptr;
  auto st = static_cast<cudaStream_t>(stream);
  if (out_dtype == F32 && (in_dtype == F32 || in_dtype == U8)) {
    kxk::Args a{};
    if (!kxk::forward_args(a, part_ptrs, part_meta, nparts, in_dtype == U8, B, H, W, cin, ho, wo, cout, stride, w,
                           wsc, bias, out, relu))
      return static_cast<int>(cudaErrorInvalidValue);
    const int form = res ? kxk::FWD_RES : kxk::FWD;
    return kxk::run(a, kxk::plan(B, ho, wo, cout, stride, form), form, 3, stride, st);
  }
  ConvArgs a{};
  fill_parts(a.parts, part_ptrs, part_meta, nparts);
  a.nparts = nparts;
  a.B = B, a.H = H, a.W = W, a.cin = cin, a.ho = ho, a.wo = wo;
  a.cout = cout, a.relu = relu;
  a.w = w, a.wsc = wsc, a.bias = bias, a.out = out;
  const bool bf_out = out_dtype == BF16;
  switch (in_dtype) {
    case BF16:
      if (!bf_out) return dispatch_stride<__nv_bfloat16, float>(a, stride, res, st);
      // bf16 -> bf16 here only at stride 2 below 8 output channels; wider
      // convs run on the tensor cores (conv_tc.cu), stride-1 heads on the
      // thin form (conv_thin.cu)
      if (res || cout >= 8 || stride != 2) return static_cast<int>(cudaErrorInvalidValue);
      return launch<__nv_bfloat16, __nv_bfloat16, 2, 1, false>(a, st);
    case U8:
      // u8 -> bf16 at stride 1 runs on the thin form (conv_thin.cu)
      if (stride != 2) return static_cast<int>(cudaErrorInvalidValue);
      return dispatch_form<uint8_t, __nv_bfloat16, 2>(a, res, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Plain C entry of the K x K form (nct::kxk, form GRAD): one input part
// (pointer + 6 metadata values, see nct::fill_parts) of storage type dtype,
// which the output shares, F32 only (bf16: nct_conv_tc); (ksize, stride) in
// {1, 3, 5} x {1} or (4, 2); pad in [0, ksize - 1], output (ho, wo) = ((H,
// W) + 2 pad - ksize) / stride + 1. w: at stride 1 the forward conv's (cin,
// cout, ksize, ksize) as stored, read spatially flipped and
// in/out-transposed; at stride 2 (cout, cin, 4, 4).
extern "C" int nct_conv_kxk(const void* const* x_ptr, const long long* x_meta,
                            int dtype, int B, int H, int W, int cin, int ho,
                            int wo, int cout, int ksize, int stride, int pad,
                            const float* w, void* out, void* stream) {
  using namespace nct;
  if (dtype != F32 || B < 1 || cin < 1 || cout < 1 || pad < 0 || pad > ksize - 1 || stride < 1 ||
      H + 2 * pad < ksize || W + 2 * pad < ksize ||
      ho != (H + 2 * pad - ksize) / stride + 1 ||
      wo != (W + 2 * pad - ksize) / stride + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  kxk::Args a{};
  fill_parts(a.parts, x_ptr, x_meta, 1);
  a.nparts = 1, a.vec = stride == 1 && W % 4 == 0 && vec_rows<4>(a.parts[0]);
  a.B = B, a.H = H, a.W = W, a.cin = cin, a.ho = ho, a.wo = wo;
  a.cout = cout, a.pad = pad, a.w = w, a.out = static_cast<float*>(out);
  return kxk::run(a, kxk::plan(B, ho, wo, cout, stride, kxk::GRAD), kxk::GRAD, ksize, stride,
                  static_cast<cudaStream_t>(stream));
}

extern "C" const char* nct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
