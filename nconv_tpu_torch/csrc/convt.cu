// K3: 4x4 stride-2 pad-1 transpose convolution + bias + optional ReLU in
// f32 (the bf16 form runs on the tensor cores, conv_tc.cu),
// torch.nn.ConvTranspose2d semantics, weight (cin, cout, 4, 4):
//
//   out[co, oy, ox] = sum over ci and taps with oy = 2*iy - 1 + ky,
//                     ox = 2*ix - 1 + kx of x[ci, iy, ix] * w[ci, co, ky, kx]
//
// written as a direct gather: output row oy takes ky in {(oy+1)%2, +2}, so
// each output pixel sums a 2x2 set of input taps per input channel. The
// input is a list of parts (UpCat's [depth | fusion] concat stays two
// tensors).
//
// Replaces the d2s_channels form of nconv_tpu/ops/pallas_conv.py:_kernel
// (reached through models/layers.py Basic2dTrans._phased_bhcw), which
// phase-stacks the output channels and interleaves them with selection
// matmuls; neither is needed where strided stores are native.
//
// Bound on the H100: each input value feeds 4 taps x Cout outputs, about
// 2*Cout FMAs per output byte at Cout 32-64, close to the f32 ridge. The
// simple design stages a (TH/2+2) x (TW/2+2) input tile and the weights of
// 16 input channels in shared memory and keeps COT output channels of a
// pixel in registers.
//
// Below, a second form: the 3x3/s2/p1 transposed conv with output_padding 1
// (no bias, f32; bf16 runs on the tensor cores, conv_tc.cu), the input
// gradient of a 3x3 stride-2 conv (nct_conv_transpose3x3s2): 2x2 output
// quads over all output channels a block, g and its weights staged by
// cp.async two stages deep (nct::t3).
#include "common.cuh"

namespace nct {

constexpr int T_TW = 32, T_TH = 8, T_CIC = 16, T_THREADS = T_TW * T_TH;

struct ConvTArgs {
  Part parts[MAX_PARTS];
  int nparts, B, H, W, cin, cout, relu;
  const float* w;     // (cin, cout, 4, 4)
  const float* bias;  // (cout) or null
  void* out;          // (B, cout, 2H, 2W), contiguous
};

template <typename Tin, typename Tout, int COT>
__global__ void __launch_bounds__(T_THREADS) convt_kernel(const ConvTArgs a) {
  constexpr int IH = T_TH / 2 + 2, IW = T_TW / 2 + 2;
  __shared__ float xs[T_CIC][IH][IW];
  __shared__ __align__(16) float ws[T_CIC * 16][COT];

  const int groups = (a.cout + COT - 1) / COT;
  const int b = blockIdx.z / groups, co0 = (blockIdx.z % groups) * COT;
  const int tx = threadIdx.x % T_TW, ty = threadIdx.x / T_TW;
  const int ox = blockIdx.x * T_TW + tx, oy = blockIdx.y * T_TH + ty;
  const int ho = 2 * a.H, wo = 2 * a.W;
  const int iy0 = blockIdx.y * (T_TH / 2) - 1, ix0 = blockIdx.x * (T_TW / 2) - 1;
  // taps: ky = kya + 2*dy reads input row (oy + 1 - ky) / 2 (always even)
  const int kya = (oy + 1) & 1, kxa = (ox + 1) & 1;
  int ly[2], lx[2];
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    ly[d] = (oy + 1 - kya - 2 * d) / 2 - iy0;
    lx[d] = (ox + 1 - kxa - 2 * d) / 2 - ix0;
  }

  float acc[COT];
#pragma unroll
  for (int j = 0; j < COT; ++j) acc[j] = 0.f;

  for (int c0 = 0; c0 < a.cin; c0 += T_CIC) {
    __syncthreads();
    for (int i = threadIdx.x; i < T_CIC * IH * IW; i += T_THREADS) {
      const int cc = i / (IH * IW), r = i % (IH * IW);
      const int yy = r / IW, xx = r % IW, c = c0 + cc;
      xs[cc][yy][xx] = c < a.cin ? load_parts<Tin>(a.parts, a.nparts, b, c,
                                                   iy0 + yy, ix0 + xx, a.H, a.W)
                                 : 0.f;
    }
    for (int i = threadIdx.x; i < T_CIC * 16 * COT; i += T_THREADS) {
      const int j = i % COT, t = i / COT, cc = t / 16, k = t % 16;
      const int co = co0 + j, c = c0 + cc;
      ws[t][j] = (co < a.cout && c < a.cin)
                     ? a.w[((long long)c * a.cout + co) * 16 + k]
                     : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int cc = 0; cc < T_CIC; ++cc) {
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          const float v = xs[cc][ly[dy]][lx[dx]];
          const float* wk = ws[cc * 16 + (kya + 2 * dy) * 4 + kxa + 2 * dx];
#pragma unroll
          for (int j = 0; j < COT; ++j) acc[j] = fmaf(v, wk[j], acc[j]);
        }
      }
    }
  }

  if (oy >= ho || ox >= wo) return;
  Tout* out = static_cast<Tout*>(a.out);
#pragma unroll
  for (int j = 0; j < COT; ++j) {
    const int co = co0 + j;
    if (co < a.cout) {
      float v = acc[j] + (a.bias ? a.bias[co] : 0.f);
      if (a.relu) v = fmaxf(v, 0.f);
      out[(((long long)b * a.cout + co) * ho + oy) * wo + ox] = from_f<Tout>(v);
    }
  }
}

template <typename Tin, typename Tout, int COT>
static int launch(const ConvTArgs& a, cudaStream_t st) {
  const dim3 grid((2 * a.W + T_TW - 1) / T_TW, (2 * a.H + T_TH - 1) / T_TH,
                  a.B * ((a.cout + COT - 1) / COT));
  void (*k)(const ConvTArgs) = convt_kernel<Tin, Tout, COT>;
  NCT_LAUNCH(k, grid, dim3(T_THREADS), 0, st, a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int dispatch_cot(const ConvTArgs& a, cudaStream_t st) {
  return a.cout >= 16 ? launch<T, T, 16>(a, st) : launch<T, T, 1>(a, st);
}

// ---------------------------------------------------------------------------
// 3x3/s2/p1 transposed conv, output_padding 1, no bias, weight (cin, cout,
// 3, 3) (the forward conv's OIHW kernel), f32 input and output (the mixed
// schedule's bf16 form runs on the tensor cores, conv_tc.cu's mode T3):
//
//   out[co, y, x] = sum over ci and taps with y = 2i - 1 + ky,
//                   x = 2j - 1 + kx of g[ci, i, j] * w[ci, co, ky, kx]
//
// the input cotangent (B, cout, 2h, 2w) of a 3x3 stride-2 pad-1 conv from
// its output cotangent g (B, cin, h, w). Replaces the d2s_channels form of
// nconv_tpu/ops/pallas_conv.py:_kernel that pallas_s2._s2_res_bwd
// (:115-136) runs on phase-stacked output channels. The 2x2 output quad of
// input pixel (i, j) takes 1, 2, 2 and 4 taps, the nine taps of the kernel
// once each:
//
//   (2i,   2j)   <- g[i, j] w11
//   (2i,   2j+1) <- g[i, j] w12 + g[i, j+1] w10
//   (2i+1, 2j)   <- g[i, j] w21 + g[i+1, j] w01
//   (2i+1, 2j+1) <- g[i, j] w22 + g[i, j+1] w20 + g[i+1, j] w02 + g[i+1, j+1] w00
//
// so no thread skips a tap and no warp diverges on the output parity.
//
// Bound on the H100: operations (9 x cout FMAs per g value, f32 CUDA cores).
// Design, output-stationary over all output channels:
//  * A block covers R rows x 32 columns of g (2R x 64 outputs) and all
//    output channels up to 64 (wider calls in balanced groups), so g is
//    staged once a call: warp (g row, slab of 16 channels), lane (pair of
//    quads, group of 8 channels). A thread holds PX = 2 consecutive quads x
//    CO = 8 channels: per input channel it loads 2 (PX + 1) g values and 9
//    weight rows of 8 as float4 broadcasts for 9 PX CO = 144 FMAs.
//  * g rows in chunks of 8 channels and their weights, as [cc * 9 + tap][co]
//    rows (common.cuh padded_row), staged by cp.async (16-byte copies where
//    g's rows allow) two stages deep: chunk c + 1's copies fly while chunk
//    c's FMAs run.
//  * Each thread writes its 2 PX = 4 contiguous outputs of a row as one
//    float4.
// A split of the 44x152 call's channels into more, smaller blocks, 4 x 4
// quad tiles, 16-channel chunks and 16-warp blocks all lost to this plan
// (runtime/plan_probe.py; PERF.md).
// ---------------------------------------------------------------------------

namespace t3 {

constexpr int QW = 32, PX = 2, CO = 8, PGW = QW / PX, CGW = 32 / PGW, SLAB = CGW * CO, CIC = 8, MOST = 64,
              MAX_WARPS = 8;
constexpr int GS = 36;  // a staged g row: the tile's 33 columns, in whole 16-byte vectors

struct Args {
  Part g;   // (B, cin, h, w), any strides
  int vec;  // g's rows staged as 16-byte vectors
  int B, h, w, cin, cout;
  int width, wst, ns, rows;  // output channels a group, a staged weight row (slabs x 16, padded_row), slabs, g rows a block
  const float* wt;           // (cin, cout, 3, 3)
  float* out;                // (B, cout, 2h, 2w), contiguous
};

// one stage: the g patch of CIC channels, then CIC x 9 weight rows
__host__ __device__ constexpr int gsz(int rows) { return CIC * (rows + 1) * GS; }
__host__ __device__ constexpr int stage_size(int rows, int wst) { return gsz(rows) + CIC * 9 * wst; }

__global__ void __launch_bounds__(32 * MAX_WARPS) convt3x3s2_kernel(const Args a) {
  NCT_DYN_SHARED(float, smem);
  const int nthr = blockDim.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slab = warp % a.ns, row = warp / a.ns, pg = lane % PGW, cg = lane / PGW;
  const int groups = (a.cout + a.width - 1) / a.width;
  const int b = blockIdx.z / groups, co0 = (blockIdx.z % groups) * a.width;
  const int co_end = co0 + a.width < a.cout ? co0 + a.width : a.cout;
  const int i0 = blockIdx.y * a.rows, j0 = blockIdx.x * QW, gr = a.rows + 1;
  const int stage_sz = stage_size(a.rows, a.wst);

  // input channels c0 .. c0 + CIC - 1 (up to cin) into stage buf
  auto stage = [&](int c0, int buf) {
    float* gs = smem + buf * stage_sz;
    float* ws = gs + gsz(a.rows);
    const int ncc = a.cin - c0 < CIC ? a.cin - c0 : CIC;
    const float* g = static_cast<const float*>(a.g.ptr);
    for (int u = warp; u < ncc * gr; u += nthr / 32) {
      const int c = c0 + u / gr, i = i0 + u % gr;
      const bool live = i < a.h;
      const float* src = g + (live ? b * a.g.sb + c * a.g.sc + i * a.g.sh : 0);
      float* drow = gs + u * GS;
      if (a.vec) {  // whole vectors, in or out of the image (w % 4 == 0)
        for (int v = lane; v < GS / 4; v += 32) {
          const int j = j0 + 4 * v;
          const bool in = live && j < a.w;
          cp_async16(smem_u32(drow + 4 * v), in ? src + j : src, in ? 16 : 0);
        }
      } else {
        for (int x = lane; x <= QW; x += 32) {
          const int j = j0 + x;
          const bool in = live && j < a.w;
          cp_async4(smem_u32(drow + x), in ? src + j * a.g.sw : src, in ? 4 : 0);
        }
      }
    }
    // w[c][co][tap]: an input channel's group of width x 9 is contiguous
    for (int cc = 0; cc < ncc; ++cc) {
      const float* wc = a.wt + (static_cast<long long>(c0 + cc) * a.cout + co0) * 9;
      for (int i = tid; i < a.wst * 9; i += nthr) {
        const int j = i / 9, t = i % 9;
        const bool in = co0 + j < co_end;
        cp_async4(smem_u32(ws + (cc * 9 + t) * a.wst + j), in ? wc + i : a.wt, in ? 4 : 0);
      }
    }
  };

  float acc[2][2][PX][CO];  // [output row parity][output column parity][quad][channel]
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int q = 0; q < PX; ++q)
#pragma unroll
        for (int k = 0; k < CO; ++k) acc[p][s][q][k] = 0.f;

  const int wcol = slab * SLAB + cg * CO;  // the thread's first channel in a weight row
  stage(0, 0);
  cp_async_commit();
  for (int c0 = 0; c0 < a.cin; c0 += CIC) {
    const int buf = (c0 / CIC) & 1;
    cp_async_wait_all();
    __syncthreads();  // chunk c0 staged; every warp is done with the previous chunk's stage
    if (c0 + CIC < a.cin) {
      stage(c0 + CIC, buf ^ 1);
      cp_async_commit();
    }
    const float* gs = smem + buf * stage_sz + row * GS + PX * pg;
    const float* ws = smem + buf * stage_sz + gsz(a.rows) + wcol;
    const int ncc = a.cin - c0 < CIC ? a.cin - c0 : CIC;
#pragma unroll 1
    for (int cc = 0; cc < ncc; ++cc) {
      float v[2][PX + 1];  // g rows i, i + 1 at columns j .. j + PX
#pragma unroll
      for (int d = 0; d < 2; ++d)
#pragma unroll
        for (int e = 0; e <= PX; ++e) v[d][e] = gs[(cc * gr + d) * GS + e];
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        // tap (ky, kx) feeds output (2i + py, 2j + px) from g[i + di][j + dj]:
        // py = 0 at ky = 1, else 1; di = 1 at ky = 0, else 0 (columns alike)
        const int ky = t / 3, kx = t % 3, py = ky != 1, px = kx != 1, di = ky == 0, dj = kx == 0;
        const float4* wr = reinterpret_cast<const float4*>(ws + (cc * 9 + t) * a.wst);
        float wv[CO];
#pragma unroll
        for (int k = 0; k < CO / 4; ++k) {
          const float4 w4 = wr[k];
          wv[4 * k] = w4.x, wv[4 * k + 1] = w4.y, wv[4 * k + 2] = w4.z, wv[4 * k + 3] = w4.w;
        }
#pragma unroll
        for (int q = 0; q < PX; ++q)
#pragma unroll
          for (int k = 0; k < CO; ++k) acc[py][px][q][k] = fmaf(v[di][q + dj], wv[k], acc[py][px][q][k]);
      }
    }
  }

  const int i = i0 + row, j = j0 + PX * pg;
  if (i >= a.h || j >= a.w) return;
  const int ho = 2 * a.h, wo = 2 * a.w;
  const bool vec_out = (wo & 3) == 0 && j + PX <= a.w;  // whole float4s
#pragma unroll
  for (int k = 0; k < CO; ++k) {
    const int co = co0 + wcol + k;
    if (co >= co_end) break;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      float* o = a.out + ((static_cast<long long>(b) * a.cout + co) * ho + 2 * i + p) * wo + 2 * j;
      if (vec_out) {
#pragma unroll
        for (int q = 0; q < PX; q += 2)
          *reinterpret_cast<float4*>(o + 2 * q) =
              float4{acc[p][0][q][k], acc[p][1][q][k], acc[p][0][q + 1][k], acc[p][1][q + 1][k]};
      } else {
#pragma unroll
        for (int q = 0; q < PX; ++q)
          if (j + q < a.w) o[2 * q] = acc[p][0][q][k], o[2 * q + 1] = acc[p][1][q][k];
      }
    }
  }
}

// The launch plan: groups of width output channels, ns slabs of 16 a group,
// rows g rows a block (ns x rows warps).
struct Plan {
  int width, ns, rows;
};

inline Plan plan_of(int cout, int groups, int rows) {
  const int width = (cout + groups - 1) / groups;
  return {width, (width + SLAB - 1) / SLAB, rows};
}

// Balanced groups of at most 64 channels, 8 warps a block.
inline Plan plan(int cout) {
  const int groups = (cout + MOST - 1) / MOST;
  return plan_of(cout, groups, MAX_WARPS / plan_of(cout, groups, 0).ns);
}

inline int run(Args& a, const Plan& p, cudaStream_t st) {
  if (p.rows < 1 || p.ns * p.rows > MAX_WARPS) return static_cast<int>(cudaErrorInvalidValue);
  a.width = p.width, a.ns = p.ns, a.rows = p.rows, a.wst = padded_row(p.ns * SLAB);
  const int threads = 32 * p.ns * p.rows;
  const size_t smem = 2 * sizeof(float) * stage_size(a.rows, a.wst);
  void (*k)(const Args) = convt3x3s2_kernel;
  int resident = 0;  // sets the kernel's shared-memory limit on this device
  if (const int e = resident_blocks(k, threads, smem, resident)) return e;
  const dim3 grid((a.w + QW - 1) / QW, (a.h + a.rows - 1) / a.rows, a.B * ((a.cout + a.width - 1) / a.width));
  NCT_LAUNCH(k, grid, dim3(threads), smem, st, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace t3

}  // namespace nct

// Plain C entry; input and output f32 (the bf16 form runs on the tensor
// cores, conv_tc.cu).
extern "C" int nct_conv_transpose4x4s2(const void* const* part_ptrs,
                                       const long long* part_meta, int nparts,
                                       int dtype, int B, int H, int W, int cin,
                                       int cout, const float* w,
                                       const float* bias, void* out, int relu,
                                       void* stream) {
  using namespace nct;
  if (nparts < 1 || nparts > MAX_PARTS)
    return static_cast<int>(cudaErrorInvalidValue);
  ConvTArgs a{};
  fill_parts(a.parts, part_ptrs, part_meta, nparts);
  a.nparts = nparts;
  a.B = B, a.H = H, a.W = W, a.cin = cin, a.cout = cout, a.relu = relu;
  a.w = w, a.bias = bias, a.out = out;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == F32) return dispatch_cot<float>(a, st);
  return static_cast<int>(cudaErrorInvalidValue);  // bf16: conv_tc.cu
}

// Plain C entry of the 3x3/s2 form (nct::t3): one input part (B, cin, h, w)
// (see nct::fill_parts) of storage type dtype, which must be F32 (bf16: mode
// 3 of nct_conv_tc), as the output (B, cout, 2h, 2w); weight (cin, cout, 3,
// 3) f32.
extern "C" int nct_conv_transpose3x3s2(const void* const* x_ptr,
                                       const long long* x_meta, int dtype,
                                       int B, int h, int w, int cin, int cout,
                                       const float* wt, void* out,
                                       void* stream) {
  using namespace nct;
  if (B < 1 || h < 1 || w < 1 || cin < 1 || cout < 1 || dtype != F32)
    return static_cast<int>(cudaErrorInvalidValue);
  t3::Args a{};
  fill_parts(&a.g, x_ptr, x_meta, 1);
  a.vec = w % 4 == 0 && vec_rows<4>(a.g);
  a.B = B, a.h = h, a.w = w, a.cin = cin, a.cout = cout, a.wt = wt, a.out = static_cast<float*>(out);
  return t3::run(a, t3::plan(cout), static_cast<cudaStream_t>(stream));
}
