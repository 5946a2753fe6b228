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
//    (pallas_conv.py:797);
//  * stride 2, K = 4, pad 1: the input gradient of the 4x4/s2/p1 transpose
//    conv, a plain strided conv of its output cotangent with the transpose
//    conv's (cin, cout, 4, 4) weight read as OIHW (no flip), which the TPU
//    ran as a row-pair lane_stride2 conv (pallas_s2.py:_ct_bwd, :228-248).
// K and S are template parameters, so the tap loops stay unrolled. Same
// staging as the 3x3 form: an input tile of K_CIC channels with its halo and
// the matching weights in shared memory, COT output channels of one pixel
// per thread in registers. The input is one part read through its strides,
// so a crop is a view. Storage type T: f32 only (the mixed schedule's bf16
// forms are modes of conv_tc.cu).
// ---------------------------------------------------------------------------

constexpr int K_TW = 32, K_TH = 4, K_CIC = 8, K_THREADS = K_TW * K_TH;

struct ConvKArgs {
  Part x;  // (B, cin, H, W), any strides
  int B, H, W, cin, ho, wo, cout, pad;
  const float* w;  // (cout, cin, K, K)
  void* out;       // (B, cout, ho, wo), contiguous, storage type T
};

template <typename T, int K, int S, int COT>
__global__ void __launch_bounds__(K_THREADS) convkxk_kernel(const ConvKArgs a) {
  constexpr int IW = (K_TW - 1) * S + K, IH = (K_TH - 1) * S + K;
  __shared__ float xs[K_CIC][IH][IW];
  __shared__ __align__(16) float ws[K_CIC * K * K][COT];

  const int groups = (a.cout + COT - 1) / COT;
  const int b = blockIdx.z / groups, co0 = (blockIdx.z % groups) * COT;
  const int tx = threadIdx.x % K_TW, ty = threadIdx.x / K_TW;
  const int ox = blockIdx.x * K_TW + tx, oy = blockIdx.y * K_TH + ty;
  const int ix0 = blockIdx.x * K_TW * S - a.pad, iy0 = blockIdx.y * K_TH * S - a.pad;

  float acc[COT];
#pragma unroll
  for (int j = 0; j < COT; ++j) acc[j] = 0.f;

  for (int c0 = 0; c0 < a.cin; c0 += K_CIC) {
    __syncthreads();
    for (int i = threadIdx.x; i < K_CIC * IH * IW; i += K_THREADS) {
      const int cc = i / (IH * IW), r = i % (IH * IW);
      const int yy = r / IW, xx = r % IW, c = c0 + cc;
      xs[cc][yy][xx] = c < a.cin ? load_parts<T>(&a.x, 1, b, c, iy0 + yy,
                                                 ix0 + xx, a.H, a.W)
                                 : 0.f;
    }
    for (int i = threadIdx.x; i < K_CIC * K * K * COT; i += K_THREADS) {
      const int j = i % COT, t = i / COT, cc = t / (K * K), k = t % (K * K);
      const int co = co0 + j, c = c0 + cc;
      ws[t][j] = (co < a.cout && c < a.cin)
                     ? a.w[((long long)co * a.cin + c) * K * K + k]
                     : 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int cc = 0; cc < K_CIC; ++cc) {
#pragma unroll
      for (int ky = 0; ky < K; ++ky) {
#pragma unroll
        for (int kx = 0; kx < K; ++kx) {
          const float v = xs[cc][ty * S + ky][tx * S + kx];
          const float* wk = ws[(cc * K + ky) * K + kx];
#pragma unroll
          for (int j = 0; j < COT; ++j) acc[j] = fmaf(v, wk[j], acc[j]);
        }
      }
    }
  }

  if (oy >= a.ho || ox >= a.wo) return;
  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int j = 0; j < COT; ++j) {
    const int co = co0 + j;
    if (co < a.cout)
      out[(((long long)b * a.cout + co) * a.ho + oy) * a.wo + ox] = from_f<T>(acc[j]);
  }
}

template <typename T, int K, int S, int COT>
static int launch_kxk(const ConvKArgs& a, cudaStream_t st) {
  const dim3 grid((a.wo + K_TW - 1) / K_TW, (a.ho + K_TH - 1) / K_TH,
                  a.B * ((a.cout + COT - 1) / COT));
  void (*k)(const ConvKArgs) = convkxk_kernel<T, K, S, COT>;
  NCT_LAUNCH(k, grid, dim3(K_THREADS), 0, st, a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int K, int S>
static int dispatch_kxk(const ConvKArgs& a, cudaStream_t st) {
  return a.cout >= 16 ? launch_kxk<T, K, S, 16>(a, st) : launch_kxk<T, K, S, 8>(a, st);
}

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
// ksize) / stride + 1.
extern "C" int nct_conv_kxk(const void* const* x_ptr, const long long* x_meta,
                            int dtype, int B, int H, int W, int cin, int ho,
                            int wo, int cout, int ksize, int stride, int pad,
                            const float* w, void* out, void* stream) {
  using namespace nct;
  if (pad < 0 || pad > ksize - 1 || stride < 1 ||
      H + 2 * pad < ksize || W + 2 * pad < ksize ||
      ho != (H + 2 * pad - ksize) / stride + 1 ||
      wo != (W + 2 * pad - ksize) / stride + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  ConvKArgs a{};
  fill_parts(&a.x, x_ptr, x_meta, 1);
  a.B = B, a.H = H, a.W = W, a.cin = cin, a.ho = ho, a.wo = wo;
  a.cout = cout, a.pad = pad, a.w = w, a.out = out;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == F32 && stride == 1) {
    switch (ksize) {
      case 1: return dispatch_kxk<float, 1, 1>(a, st);
      case 3: return dispatch_kxk<float, 3, 1>(a, st);
      case 5: return dispatch_kxk<float, 5, 1>(a, st);
    }
  } else if (dtype == F32 && stride == 2 && ksize == 4) {
    return dispatch_kxk<float, 4, 2>(a, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* nct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
