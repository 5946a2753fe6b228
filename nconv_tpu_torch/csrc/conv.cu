// K2: direct 3x3 pad-1 convolution, stride 1 or 2, + bias + optional ReLU,
// with an optional fused residual epilogue relu(conv3x3(x) + b) + conv1x1(x)
// (the 1x1 shortcut at the same stride reads the 3x3 window's centre tap);
// and a K x K form without bias for the training backward (below,
// nct_conv_kxk): K in {1, 3, 5} at stride 1, and 4x4 at stride 2, f32 in
// and out. The bf16 -> bf16 forward with 8 or more output channels and the
// bf16 forms of the K x K backward (3x3 at stride 1, 4x4 at stride 2) run on
// the tensor cores instead (conv_tc.cu), and the stride-1 bf16 outputs of
// narrow heads and of the uint8 frame on the thin form (conv_thin.cu); here
// bf16 out is only their stride-2 forms.
//
// Replaces nconv_tpu/ops/pallas_conv.py:_kernel in its stride-1,
// residual_channels, multi-part, uint8-decode and stride-2 (lane_stride2 /
// s2d) forms. Strided access is native here, so stride 2 is a plain strided
// read of the shared-memory tile instead of the TPU's row-pair transforms.
//
// Bound on the H100: at 32-64 channels a 3x3 conv does ~9*Cout FMAs per
// input value read, near the ridge of the card's f32 CUDA-core rate against
// its 3.35 TB/s. The simple design stages an input tile (8 channels at a
// time, with halo) and the matching weights in shared memory once per block,
// and each thread keeps COT output channels of one pixel in registers, so
// every staged input value feeds COT FMAs and every weight is a broadcast.
// Tensor cores (wgmma) are left for a later version.
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
// K x K form, no bias and no ReLU, pad in [0, K-1], stride S:
//  * stride 1, K in {1, 3, 5}: the input-gradient conv of a stride-1 conv
//    (the cotangent against the flipped, in/out-transposed kernel), which
//    the TPU ran on the same _kernel through transpose_conv_bhcw
//    (pallas_conv.py:797). The weight is the forward conv's (cin_fwd =
//    cout, cout_fwd = cin, K, K) as stored, flipped and transposed while
//    staged, so no call copies it;
//  * stride 2, K = 4, pad 1: the input gradient of the 4x4/s2/p1 transpose
//    conv, a plain strided conv of its output cotangent with the transpose
//    conv's (cin, cout, 4, 4) weight read as OIHW (no flip), which the TPU
//    ran as a row-pair lane_stride2 conv (pallas_s2.py:_ct_bwd, :228-248).
//
// Bound on the H100: operations (f32 FMAs on the CUDA cores; the guided
// calls do 9-16 x cout FMAs a staged input value). Design, output-stationary
// tiles over all output channels:
//  * A block covers R rows x 32 pixels of the output and a group of output
//    channels: all of them up to 128 at stride 1 (48 at stride 2), wider
//    calls in balanced groups (65 -> 33 + 32, never 64 + 1), so the input
//    tile is staged once a group, not once every 16 channels. A grid short
//    of half the SMs (the 44x152 level at B = 1) splits its channels into
//    more groups instead, down to 16 a group.
//  * Warp (tile row, channel slab); lane (pixel group, channel group): a
//    thread holds PX consecutive pixels x CO channels. Per input channel and
//    tap row it loads the S (PX - 1) + K input values its pixels' taps span
//    and, per tap, its CO weights as float4 broadcasts: at PX 4, CO 8, K =
//    3, 96 FMAs per 12 shared-memory loads.
//  * At stride 2 the staged rows are split by column parity (even columns,
//    then odd), so a warp's strided reads are unit-stride and free of bank
//    conflicts.
//  * Input channels come in chunks (8; 4 at stride 2, whose patch is twice
//    as wide), staged by 4-byte cp.async (zero outside the image) two
//    stages deep: chunk c + 1's copies fly while chunk c's FMAs run.
//  * Tile shapes by plan, slab = CGW x CO channels: B (PX 4, CO 8, slab 32)
//    for more than 16 channels at stride 1 (up to four slabs), C (4, 4,
//    slab 16) for 9-16 and for every stride-2 group up to 32, D (2, 4, slab
//    8) for up to 8 (step 1's narrow calls), E (4, 12, slab 48) for the
//    stride-2 groups of 33-48 (the 33- and 65-channel calls). Each beats the
//    tiles it displaces on the calls that take it (runtime/plan_probe.py).
// The input is one part read through its strides, so a crop is a view.
// Storage type f32 only (the mixed schedule's bf16 forms are modes of
// conv_tc.cu).
// ---------------------------------------------------------------------------

namespace kxk {

constexpr int TW = 32, MAX_WARPS = 8, SMS = 132;

struct Args {
  Part x;  // (B, cin, H, W), any strides
  int B, H, W, cin, ho, wo, cout, pad;
  int width, wst;   // output channels a group, and a staged weight row (slabs x slab)
  int ns, rows;     // slabs and tile rows: a block of 32 ns rows threads
  const float* w;   // S = 1: the forward conv's (cin, cout, K, K), read flipped; S = 2: (cout, cin, K, K)
  float* out;       // (B, cout, ho, wo), contiguous
};

template <int K, int S>
struct Geo {
  // input channels a stage: 4 at stride 2, whose patch is twice as wide, so
  // two stages leave room for two blocks an SM
  static constexpr int KK = K * K, IW = (TW - 1) * S + K, CIC = S == 2 ? 4 : 8;
  static constexpr int IWH = (IW + 1) / 2, IWS = S == 2 ? 2 * IWH : IW;  // stage row, parity-split at S = 2
  static __host__ __device__ constexpr int ih(int rows) { return (rows - 1) * S + K; }
  static __device__ __forceinline__ int col(int c) { return S == 2 ? (c & 1) * IWH + (c >> 1) : c; }
  // one stage: the x patch of CIC channels, then CIC x KK weight rows
  static __host__ __device__ constexpr int xsz(int rows) { return CIC * ih(rows) * IWS; }
  static __host__ __device__ constexpr int stage(int rows, int wst) { return xsz(rows) + CIC * KK * wst; }
};

template <int K, int S, int PX, int CO, int CGW>
__global__ void __launch_bounds__(32 * MAX_WARPS) convkxk_kernel(const Args a) {
  using G = Geo<K, S>;
  constexpr int PGW = 32 / CGW, SEG = S * (PX - 1) + K, SLAB = CGW * CO;
  static_assert(PGW * PX == TW && CO % 4 == 0, "a warp spans a 32-pixel row; weights as float4");
  NCT_DYN_SHARED(float, smem);
  const int nthr = blockDim.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slab = warp % a.ns, row = warp / a.ns;
  const int pg = lane % PGW, cg = lane / PGW;
  const int groups = (a.cout + a.width - 1) / a.width;
  const int b = blockIdx.z / groups, co0 = (blockIdx.z % groups) * a.width;
  const int co_end = co0 + a.width < a.cout ? co0 + a.width : a.cout;
  const int ih = G::ih(a.rows), stage_sz = G::stage(a.rows, a.wst);
  const int iy0 = blockIdx.y * a.rows * S - a.pad, ix0 = blockIdx.x * TW * S - a.pad;

  // input channels c0 .. c0 + CIC - 1 into stage buf: the patch, then the weights
  auto stage = [&](int c0, int buf) {
    float* xs = smem + buf * stage_sz;
    float* ws = xs + G::xsz(a.rows);
    for (int u = warp; u < G::CIC * ih; u += nthr / 32) {
      const int cc = u / ih, yy = u % ih, c = c0 + cc, y = iy0 + yy;
      float* drow = xs + u * G::IWS;
      const bool live = c < a.cin && y >= 0 && y < a.H;
      const float* src = static_cast<const float*>(a.x.ptr) + (live ? b * a.x.sb + c * a.x.sc + y * a.x.sh : 0);
      for (int xx = lane; xx < G::IW; xx += 32) {
        const int x = ix0 + xx;
        const bool in = live && x >= 0 && x < a.W;
        cp_async4(smem_u32(drow + G::col(xx)), in ? src + x * a.x.sw : src, in ? 4 : 0);
      }
    }
    if constexpr (S == 2) {  // w[co][c][tap]: an output channel's CIC x KK weights are contiguous
      for (int i = tid; i < a.wst * G::CIC * G::KK; i += nthr) {
        const int j = i / (G::CIC * G::KK), cc = (i / G::KK) % G::CIC, t = i % G::KK, co = co0 + j, c = c0 + cc;
        const bool in = co < co_end && c < a.cin;
        const float* src = a.w + (in ? (static_cast<long long>(co) * a.cin + c) * G::KK + t : 0);
        cp_async4(smem_u32(ws + (cc * G::KK + t) * a.wst + j), src, in ? 4 : 0);
      }
    } else {  // forward w[c][co][K-1-dy][K-1-dx]: an input channel's width x KK are contiguous
      for (int cc = 0; cc < G::CIC; ++cc) {
        const int c = c0 + cc;
        for (int i = tid; i < a.wst * G::KK; i += nthr) {
          const int j = i / G::KK, t = i % G::KK, co = co0 + j;
          const bool in = co < co_end && c < a.cin;
          const float* src = a.w + (in ? (static_cast<long long>(c) * a.cout + co) * G::KK + G::KK - 1 - t : 0);
          cp_async4(smem_u32(ws + (cc * G::KK + t) * a.wst + j), src, in ? 4 : 0);
        }
      }
    }
  };

  float acc[PX][CO];
#pragma unroll
  for (int q = 0; q < PX; ++q)
#pragma unroll
    for (int k = 0; k < CO; ++k) acc[q][k] = 0.f;

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
    const float* xs = smem + buf * stage_sz + row * S * G::IWS;
    const float* ws = smem + buf * stage_sz + G::xsz(a.rows) + wcol;
#pragma unroll 1
    for (int cc = 0; cc < G::CIC; ++cc) {
#pragma unroll
      for (int dy = 0; dy < K; ++dy) {
        const float* xr = xs + (cc * ih + dy) * G::IWS;
        float seg[SEG];
#pragma unroll
        for (int e = 0; e < SEG; ++e) seg[e] = xr[G::col(S * PX * pg + e)];
#pragma unroll
        for (int dx = 0; dx < K; ++dx) {
          const float4* wr = reinterpret_cast<const float4*>(ws + (cc * G::KK + dy * K + dx) * a.wst);
          float wv[CO];
#pragma unroll
          for (int k = 0; k < CO / 4; ++k) {
            const float4 v = wr[k];
            wv[4 * k] = v.x, wv[4 * k + 1] = v.y, wv[4 * k + 2] = v.z, wv[4 * k + 3] = v.w;
          }
#pragma unroll
          for (int q = 0; q < PX; ++q)
#pragma unroll
            for (int k = 0; k < CO; ++k) acc[q][k] = fmaf(seg[S * q + dx], wv[k], acc[q][k]);
        }
      }
    }
  }

  const int oy = blockIdx.y * a.rows + row, ox = blockIdx.x * TW + PX * pg;
  if (oy >= a.ho) return;
#pragma unroll
  for (int k = 0; k < CO; ++k) {
    const int co = co0 + wcol + k;
    if (co >= co_end) break;
    float* o = a.out + ((static_cast<long long>(b) * a.cout + co) * a.ho + oy) * a.wo;
#pragma unroll
    for (int q = 0; q < PX; ++q)
      if (ox + q < a.wo) o[ox + q] = acc[q][k];
  }
}

// The launch plan, a function of the shape alone: the channel groups, the
// tile shape and its slabs, and the tile rows (8 warps, or 6 with 3 slabs).
struct Plan {
  char tile;  // 'B' .. 'E', as above
  int width, ns, slab, rows;
};

// Balanced groups of at most 128 channels (48 at stride 2); a grid short of
// half the SMs (the 44x152 level at B = 1) splits its channels into more
// groups instead, down to 16 channels a group.
inline int groups_of(int B, int ho, int wo, int cout, int stride) {
  const int most = stride == 2 ? 48 : 128;
  const int groups = (cout + most - 1) / most;
  const long long base = static_cast<long long>((wo + TW - 1) / TW) * B * ((ho + MAX_WARPS - 1) / MAX_WARPS);
  if (base * groups >= SMS / 2) return groups;
  const long long more = (2 * SMS + base - 1) / base, narrowest = (cout + 15) / 16;
  return static_cast<int>(more < narrowest ? more : narrowest);
}

// The tile a group of width output channels takes.
inline char tile_of(int width, int stride) {
  if (stride == 2) return width > 32 ? 'E' : 'C';
  return width <= 8 ? 'D' : width <= 16 ? 'C' : 'B';
}

// cout in groups of tile t.
inline Plan plan_of(int cout, int groups, char t) {
  Plan p{};
  p.tile = t;
  p.width = (cout + groups - 1) / groups;
  p.slab = t == 'B' ? 32 : t == 'C' ? 16 : t == 'D' ? 8 : 48;
  p.ns = (p.width + p.slab - 1) / p.slab;
  p.rows = MAX_WARPS / p.ns;
  return p;
}

inline Plan plan(int B, int ho, int wo, int cout, int stride) {
  const int groups = groups_of(B, ho, wo, cout, stride);
  return plan_of(cout, groups, tile_of((cout + groups - 1) / groups, stride));
}

template <int K, int S, int PX, int CO, int CGW>
int launch(Args& a, const Plan& p, cudaStream_t st) {
  using G = Geo<K, S>;
  void (*k)(const Args) = convkxk_kernel<K, S, PX, CO, CGW>;
  a.ns = p.ns, a.rows = p.rows, a.width = p.width, a.wst = p.ns * p.slab;
  const int threads = 32 * a.ns * a.rows;
  const size_t smem = 2 * sizeof(float) * G::stage(a.rows, a.wst);
  int resident = 0;  // sets the kernel's shared-memory limit on this device
  if (const int e = resident_blocks(k, threads, smem, resident)) return e;
  const dim3 grid((a.wo + TW - 1) / TW, (a.ho + a.rows - 1) / a.rows, a.B * ((a.cout + a.width - 1) / a.width));
  NCT_LAUNCH(k, grid, dim3(threads), smem, st, a);
  return static_cast<int>(cudaGetLastError());
}

template <int K, int S>
int dispatch(Args& a, const Plan& p, cudaStream_t st) {
  if (p.rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (S == 2) {
    switch (p.tile) {
      case 'C': return launch<K, S, 4, 4, 4>(a, p, st);
      case 'E': return launch<K, S, 4, 12, 4>(a, p, st);
    }
  } else {
    switch (p.tile) {
      case 'B': return launch<K, S, 4, 8, 4>(a, p, st);
      case 'C': return launch<K, S, 4, 4, 4>(a, p, st);
      case 'D': return launch<K, S, 2, 4, 2>(a, p, st);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Launches plan p on the K x K form (ksize, stride).
inline int run(Args& a, const Plan& p, int ksize, int stride, cudaStream_t st) {
  if (stride == 1) {
    switch (ksize) {
      case 1: return dispatch<1, 1>(a, p, st);
      case 3: return dispatch<3, 1>(a, p, st);
      case 5: return dispatch<5, 1>(a, p, st);
    }
  } else if (stride == 2 && ksize == 4) {
    return dispatch<4, 2>(a, p, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace kxk

}  // namespace nct

// Plain C entry. parts: n pointers + 6*n metadata (see nct::fill_parts);
// all parts share (B, H, W). Returns cudaGetLastError() after the launch.
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
  ConvArgs a{};
  fill_parts(a.parts, part_ptrs, part_meta, nparts);
  a.nparts = nparts;
  a.B = B, a.H = H, a.W = W, a.cin = cin, a.ho = ho, a.wo = wo;
  a.cout = cout, a.relu = relu;
  a.w = w, a.wsc = wsc, a.bias = bias, a.out = out;
  const bool res = wsc != nullptr;
  auto st = static_cast<cudaStream_t>(stream);
  const bool bf_out = out_dtype == BF16;
  switch (in_dtype) {
    case F32:
      return dispatch_stride<float, float>(a, stride, res, st);
    case BF16:
      if (!bf_out) return dispatch_stride<__nv_bfloat16, float>(a, stride, res, st);
      // bf16 -> bf16 here only at stride 2 below 8 output channels; wider
      // convs run on the tensor cores (conv_tc.cu), stride-1 heads on the
      // thin form (conv_thin.cu)
      if (res || cout >= 8 || stride != 2) return static_cast<int>(cudaErrorInvalidValue);
      return launch<__nv_bfloat16, __nv_bfloat16, 2, 1, false>(a, st);
    case U8:
      if (!bf_out) return dispatch_stride<uint8_t, float>(a, stride, res, st);
      // u8 -> bf16 at stride 1 runs on the thin form (conv_thin.cu)
      if (stride != 2) return static_cast<int>(cudaErrorInvalidValue);
      return dispatch_form<uint8_t, __nv_bfloat16, 2>(a, res, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Plain C entry of the K x K form: one input part (pointer + 6 metadata
// values, see nct::fill_parts) of storage type dtype, which the output
// shares, F32 only (bf16: nct_conv_tc); (ksize, stride) in {1, 3, 5} x {1}
// or (4, 2); pad in [0, ksize - 1], output (ho, wo) = ((H, W) + 2 pad -
// ksize) / stride + 1. w: at stride 1 the forward conv's (cin, cout, ksize,
// ksize) as stored, read spatially flipped and in/out-transposed; at stride
// 2 (cout, cin, 4, 4).
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
  fill_parts(&a.x, x_ptr, x_meta, 1);
  a.B = B, a.H = H, a.W = W, a.cin = cin, a.ho = ho, a.wo = wo;
  a.cout = cout, a.pad = pad, a.w = w, a.out = static_cast<float*>(out);
  return kxk::run(a, kxk::plan(B, ho, wo, cout, stride), ksize, stride, static_cast<cudaStream_t>(stream));
}

extern "C" const char* nct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
