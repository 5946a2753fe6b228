// K1: fused normalized convolution (f32).
//
//   nomin = conv(d * c, w+),  denom = conv(c, w+)       one pass, shared taps
//   out   = nomin / (denom + eps) + bias,  conf = denom / sum(w+)
//
// with the data and confidence each given as up to two parts (the decoder's
// [skip | upsampled] concat never exists in device memory), a part stored at
// half resolution read as a 2x nearest upsample, an output crop folded into
// the geometry, and optionally the 2x2 max-pooled (out, conf) pair emitted
// from the same block (data and confidence pooled independently, as
// max_pool_pair does).
//
// Replaces nconv_tpu/ops/pallas_nconv_mxu.py:_kernel (its multi-part,
// lane_rep / row_shared upsample and pool_out forms).
//
// Bound on the H100: bytes. At 8 output channels a tap does 16 FMAs per
// input value pair, far below the card's ridge, so the kernel is limited by
// reading d and c and writing the outputs. The simple design reads each
// input value once per block into shared memory (product d*c formed on
// load), keeps nomin and denom for all output channels of a pixel in
// registers, and writes the pooled pair from shared memory, so the
// full-resolution outputs are never read back to be pooled.
#include "common.cuh"

namespace nct {

constexpr int N_TW = 32, N_TH = 4, N_CIC = 8, N_THREADS = N_TW * N_TH;

struct NConvArgs {
  Part dparts[2], cparts[2];
  int nparts, B, H, W, cin, ho, wo, pad;  // input (y, x) = (oy - pad + ky, ...)
  float eps;
  const float* w;     // (COUT, cin, KS, KS), already positive
  const float* bias;  // (COUT)
  const float* ksum;  // (COUT): sum of w over (cin, KS, KS)
  float *out, *conf;  // (B, COUT, ho, wo)
  float *pout, *pconf;  // (B, COUT, ho / 2, wo / 2) when pooling
};

template <int KS, int COUT, bool POOL>
__global__ void __launch_bounds__(N_THREADS) nconv_kernel(const NConvArgs a) {
  constexpr int IW = N_TW + KS - 1, IH = N_TH + KS - 1;
  __shared__ float xd[N_CIC][IH][IW];  // d * c
  __shared__ float xc[N_CIC][IH][IW];  // c
  __shared__ __align__(16) float ws[N_CIC * KS * KS][COUT];
  __shared__ float po[POOL ? COUT : 1][N_TH][N_TW];
  __shared__ float pc[POOL ? COUT : 1][N_TH][N_TW];

  const int b = blockIdx.z;
  const int tx = threadIdx.x % N_TW, ty = threadIdx.x / N_TW;
  const int ox = blockIdx.x * N_TW + tx, oy = blockIdx.y * N_TH + ty;
  const int ix0 = blockIdx.x * N_TW - a.pad, iy0 = blockIdx.y * N_TH - a.pad;

  float nom[COUT], den[COUT];
#pragma unroll
  for (int j = 0; j < COUT; ++j) nom[j] = den[j] = 0.f;

  for (int c0 = 0; c0 < a.cin; c0 += N_CIC) {
    __syncthreads();
    for (int i = threadIdx.x; i < N_CIC * IH * IW; i += N_THREADS) {
      const int cc = i / (IH * IW), r = i % (IH * IW);
      const int yy = r / IW, xx = r % IW, c = c0 + cc;
      float d = 0.f, cf = 0.f;
      if (c < a.cin) {
        d = load_parts<float>(a.dparts, a.nparts, b, c, iy0 + yy, ix0 + xx,
                              a.H, a.W);
        cf = load_parts<float>(a.cparts, a.nparts, b, c, iy0 + yy, ix0 + xx,
                               a.H, a.W);
      }
      xd[cc][yy][xx] = d * cf;
      xc[cc][yy][xx] = cf;
    }
    for (int i = threadIdx.x; i < N_CIC * KS * KS * COUT; i += N_THREADS) {
      const int j = i % COUT, t = i / COUT;
      const int cc = t / (KS * KS), k = t % (KS * KS), c = c0 + cc;
      ws[t][j] = c < a.cin ? a.w[((long long)j * a.cin + c) * KS * KS + k] : 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int cc = 0; cc < N_CIC; ++cc) {
#pragma unroll
      for (int ky = 0; ky < KS; ++ky) {
#pragma unroll
        for (int kx = 0; kx < KS; ++kx) {
          const float vd = xd[cc][ty + ky][tx + kx];
          const float vc = xc[cc][ty + ky][tx + kx];
          const float* wk = ws[(cc * KS + ky) * KS + kx];
#pragma unroll
          for (int j = 0; j < COUT; ++j) {
            nom[j] = fmaf(vd, wk[j], nom[j]);
            den[j] = fmaf(vc, wk[j], den[j]);
          }
        }
      }
    }
  }

  const bool valid = oy < a.ho && ox < a.wo;
#pragma unroll
  for (int j = 0; j < COUT; ++j) {
    const float o = nom[j] / (den[j] + a.eps) + a.bias[j];
    const float cf = den[j] / a.ksum[j];
    if (valid) {
      const long long i = (((long long)b * COUT + j) * a.ho + oy) * a.wo + ox;
      a.out[i] = o;
      a.conf[i] = cf;
    }
    if constexpr (POOL) {
      po[j][ty][tx] = o;
      pc[j][ty][tx] = cf;
    }
  }
  if constexpr (POOL) {
    // floor-mode 2x2/s2 pool; tiles start on even rows and columns, so
    // every window lies inside one block
    constexpr int PH = N_TH / 2, PW = N_TW / 2;
    const int pho = a.ho / 2, pwo = a.wo / 2;
    __syncthreads();
    for (int i = threadIdx.x; i < COUT * PH * PW; i += N_THREADS) {
      const int j = i / (PH * PW), r = i % (PH * PW);
      const int py = r / PW, px = r % PW;
      const int gy = blockIdx.y * PH + py, gx = blockIdx.x * PW + px;
      if (gy < pho && gx < pwo) {
        const int y = 2 * py, x = 2 * px;
        const long long o = (((long long)b * COUT + j) * pho + gy) * pwo + gx;
        a.pout[o] = fmaxf(fmaxf(po[j][y][x], po[j][y][x + 1]),
                          fmaxf(po[j][y + 1][x], po[j][y + 1][x + 1]));
        a.pconf[o] = fmaxf(fmaxf(pc[j][y][x], pc[j][y][x + 1]),
                           fmaxf(pc[j][y + 1][x], pc[j][y + 1][x + 1]));
      }
    }
  }
}

template <int KS, int COUT, bool POOL>
static int launch(const NConvArgs& a, cudaStream_t st) {
  const dim3 grid((a.wo + N_TW - 1) / N_TW, (a.ho + N_TH - 1) / N_TH, a.B);
  void (*k)(const NConvArgs) = nconv_kernel<KS, COUT, POOL>;
  NCT_LAUNCH(k, grid, dim3(N_THREADS), 0, st, a);
  return static_cast<int>(cudaGetLastError());
}

template <int KS, int COUT>
static int dispatch_pool(const NConvArgs& a, bool pool, cudaStream_t st) {
  return pool ? launch<KS, COUT, true>(a, st) : launch<KS, COUT, false>(a, st);
}

template <int KS>
static int dispatch_cout(const NConvArgs& a, int cout, bool pool,
                         cudaStream_t st) {
  if (cout == 8) return dispatch_pool<KS, 8>(a, pool, st);
  if (cout == 1) return dispatch_pool<KS, 1>(a, pool, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace nct

// Plain C entry. d_ptrs/c_ptrs: nparts data / confidence parts sharing one
// metadata block (see nct::fill_parts). ksize in {1, 3, 5}, cout in {1, 8}.
extern "C" int nct_nconv(const void* const* d_ptrs, const void* const* c_ptrs,
                         const long long* part_meta, int nparts, int B, int H,
                         int W, int cin, int ho, int wo, int cout, int ksize,
                         int pad, float eps, const float* w, const float* bias,
                         const float* ksum, float* out, float* conf,
                         float* pout, float* pconf, void* stream) {
  using namespace nct;
  if (nparts < 1 || nparts > 2) return static_cast<int>(cudaErrorInvalidValue);
  NConvArgs a{};
  fill_parts(a.dparts, d_ptrs, part_meta, nparts);
  fill_parts(a.cparts, c_ptrs, part_meta, nparts);
  a.nparts = nparts;
  a.B = B, a.H = H, a.W = W, a.cin = cin, a.ho = ho, a.wo = wo, a.pad = pad;
  a.eps = eps, a.w = w, a.bias = bias, a.ksum = ksum;
  a.out = out, a.conf = conf, a.pout = pout, a.pconf = pconf;
  const bool pool = pout != nullptr;
  auto st = static_cast<cudaStream_t>(stream);
  switch (ksize) {
    case 1: return dispatch_cout<1>(a, cout, pool, st);
    case 3: return dispatch_cout<3>(a, cout, pool, st);
    case 5: return dispatch_cout<5>(a, cout, pool, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
