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
// (no bias, f32; bf16 runs on the tensor cores, conv_tc.cu), the input gradient of a 3x3 stride-2
// conv (nct_conv_transpose3x3s2).
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
// (:123-136) runs on phase-stacked output channels. Here each thread owns
// the 2x2 output quad of one input pixel (i, j), whose four outputs take 1,
// 2, 2 and 4 taps, the nine taps of the kernel once each:
//
//   (2i,   2j)   <- g[i, j] w11
//   (2i,   2j+1) <- g[i, j] w12 + g[i, j+1] w10
//   (2i+1, 2j)   <- g[i, j] w21 + g[i+1, j] w01
//   (2i+1, 2j+1) <- g[i, j] w22 + g[i, j+1] w20 + g[i+1, j] w02 + g[i+1, j+1] w00
//
// so no thread skips a tap and no warp diverges on the output parity. A
// block stages a (TH+1) x (TW+1) tile of g for Q_CIC channels and their
// weights in shared memory and keeps 4 x COT outputs in registers. Bound:
// 9 * cout FMAs per input value read, f32 CUDA cores.
// ---------------------------------------------------------------------------

constexpr int Q_TW = 32, Q_TH = 8, Q_CIC = 16, Q_COT = 16, Q_THREADS = Q_TW * Q_TH;

struct ConvT3Args {
  Part x;  // (B, cin, h, w), any strides
  int B, h, w, cin, cout;
  const float* wt;  // (cin, cout, 3, 3)
  float* out;       // (B, cout, 2h, 2w), contiguous
};

__global__ void __launch_bounds__(Q_THREADS) convt3x3s2_kernel(const ConvT3Args a) {
  __shared__ float xs[Q_CIC][Q_TH + 1][Q_TW + 1];
  __shared__ __align__(16) float ws[Q_CIC * 9][Q_COT];

  const int groups = (a.cout + Q_COT - 1) / Q_COT;
  const int b = blockIdx.z / groups, co0 = (blockIdx.z % groups) * Q_COT;
  const int tx = threadIdx.x % Q_TW, ty = threadIdx.x / Q_TW;
  const int i0 = blockIdx.y * Q_TH, j0 = blockIdx.x * Q_TW;
  const int i = i0 + ty, j = j0 + tx;

  float acc[4][Q_COT];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int c = 0; c < Q_COT; ++c) acc[q][c] = 0.f;

  for (int c0 = 0; c0 < a.cin; c0 += Q_CIC) {
    __syncthreads();
    for (int t = threadIdx.x; t < Q_CIC * (Q_TH + 1) * (Q_TW + 1); t += Q_THREADS) {
      const int cc = t / ((Q_TH + 1) * (Q_TW + 1)), r = t % ((Q_TH + 1) * (Q_TW + 1));
      const int yy = r / (Q_TW + 1), xx = r % (Q_TW + 1), c = c0 + cc;
      xs[cc][yy][xx] = c < a.cin ? load_parts<float>(&a.x, 1, b, c, i0 + yy, j0 + xx, a.h, a.w)
                                 : 0.f;
    }
    for (int t = threadIdx.x; t < Q_CIC * 9 * Q_COT; t += Q_THREADS) {
      const int jj = t % Q_COT, u = t / Q_COT, cc = u / 9, k = u % 9;
      const int co = co0 + jj, c = c0 + cc;
      ws[u][jj] = (co < a.cout && c < a.cin) ? a.wt[((long long)c * a.cout + co) * 9 + k] : 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int cc = 0; cc < Q_CIC; ++cc) {
      const float v00 = xs[cc][ty][tx], v01 = xs[cc][ty][tx + 1];
      const float v10 = xs[cc][ty + 1][tx], v11 = xs[cc][ty + 1][tx + 1];
      const float* wk = ws[cc * 9];  // tap k = ky * 3 + kx at wk[k * Q_COT + c]
#pragma unroll
      for (int c = 0; c < Q_COT; ++c) {
        const float w00 = wk[0 * Q_COT + c], w01 = wk[1 * Q_COT + c], w02 = wk[2 * Q_COT + c];
        const float w10 = wk[3 * Q_COT + c], w11 = wk[4 * Q_COT + c], w12 = wk[5 * Q_COT + c];
        const float w20 = wk[6 * Q_COT + c], w21 = wk[7 * Q_COT + c], w22 = wk[8 * Q_COT + c];
        acc[0][c] = fmaf(v00, w11, acc[0][c]);
        acc[1][c] = fmaf(v01, w10, fmaf(v00, w12, acc[1][c]));
        acc[2][c] = fmaf(v10, w01, fmaf(v00, w21, acc[2][c]));
        acc[3][c] = fmaf(v11, w00, fmaf(v10, w02, fmaf(v01, w20, fmaf(v00, w22, acc[3][c]))));
      }
    }
  }

  if (i >= a.h || j >= a.w) return;
  const int ho = 2 * a.h, wo = 2 * a.w;
#pragma unroll
  for (int c = 0; c < Q_COT; ++c) {
    const int co = co0 + c;
    if (co < a.cout) {
      float* o = a.out + (((long long)b * a.cout + co) * ho + 2 * i) * wo + 2 * j;
      o[0] = acc[0][c];
      o[1] = acc[1][c];
      o[wo] = acc[2][c];
      o[wo + 1] = acc[3][c];
    }
  }
}

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

// Plain C entry of the 3x3/s2 form: one input part (B, cin, h, w) (see
// nct::fill_parts) of storage type dtype, which must be F32 (bf16: mode 3 of
// nct_conv_tc), as the output (B, cout, 2h, 2w); weight (cin, cout, 3, 3) f32.
extern "C" int nct_conv_transpose3x3s2(const void* const* x_ptr,
                                       const long long* x_meta, int dtype,
                                       int B, int h, int w, int cin, int cout,
                                       const float* wt, void* out,
                                       void* stream) {
  using namespace nct;
  if (B < 1 || h < 1 || w < 1 || cin < 1 || cout < 1 || dtype != F32)
    return static_cast<int>(cudaErrorInvalidValue);
  ConvT3Args a{};
  fill_parts(&a.x, x_ptr, x_meta, 1);
  a.B = B, a.h = h, a.w = w, a.cin = cin, a.cout = cout, a.wt = wt, a.out = static_cast<float*>(out);
  const dim3 grid((w + Q_TW - 1) / Q_TW, (h + Q_TH - 1) / Q_TH,
                  B * ((cout + Q_COT - 1) / Q_COT));
  void (*k)(const ConvT3Args) = convt3x3s2_kernel;
  NCT_LAUNCH(k, grid, dim3(Q_THREADS), 0, static_cast<cudaStream_t>(stream), a);
  return static_cast<int>(cudaGetLastError());
}
