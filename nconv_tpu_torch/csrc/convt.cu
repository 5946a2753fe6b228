// K3: 4x4 stride-2 pad-1 transpose convolution + bias + optional ReLU,
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

}  // namespace nct

// Plain C entry; input and output share one storage type (F32 or BF16).
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
  if (dtype == BF16) return dispatch_cot<__nv_bfloat16>(a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
