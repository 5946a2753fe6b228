// K4: two chained 3x3 pad-1 conv + bias + ReLU stages with the intermediate
// kept in shared memory:  out = relu(conv(relu(conv(x, w1) + b1), w2) + b2).
//
// Replaces nconv_tpu/ops/pallas_chain.py:_chain_kernel (N = 2, the fusion
// stages' fuse_conv2 -> fuse_conv3) in f32; bf16 runs on the tensor cores
// (conv_chain_tc.cu).
//
// Bound on the H100: bytes at the block level. Two separate launches would
// write the intermediate (32-64 channels) to device memory and read it
// back; here each block computes the stage-1 tile with a 1-pixel halo for
// every intermediate channel into shared memory (zero outside the image,
// which is stage 2's padding), then stage 2 from it, so device memory sees
// only x and the output. The halo costs (TH+2)(TW+2)/(TH*TW) = 1.6x the
// stage-1 arithmetic. The intermediate is rounded to the storage type, as
// two separate convs would store it.
#include "common.cuh"

namespace nct {

constexpr int H_TW = 32, H_TH = 4, H_CIC = 8, H_COT = 16;
constexpr int H_THREADS = H_TW * H_TH;
constexpr int H_MH = H_TH + 2, H_MW = H_TW + 2, H_MPIX = H_MH * H_MW;
constexpr int H_IH = H_TH + 4, H_IW = H_TW + 4;
constexpr int H_MSTEPS = (H_MPIX + H_THREADS - 1) / H_THREADS;

struct ChainArgs {
  const void* x;  // (B, cin, H, W), contiguous
  int B, H, W, cin, cmid, cout;
  const float *w1, *b1;  // (cmid, cin, 3, 3), (cmid)
  const float *w2, *b2;  // (cout, cmid, 3, 3), (cout)
  void* out;             // (B, cout, H, W), contiguous
};

template <typename T>
__global__ void __launch_bounds__(H_THREADS) chain_kernel(const ChainArgs a) {
  NCT_DYN_SHARED(float, mid);  // (cmid, H_MPIX)
  __shared__ float xs[H_CIC][H_IH][H_IW];
  __shared__ __align__(16) float ws[H_CIC * 9][H_COT];

  const int b = blockIdx.z;
  const int tx = threadIdx.x % H_TW, ty = threadIdx.x / H_TW;
  const int ox0 = blockIdx.x * H_TW, oy0 = blockIdx.y * H_TH;
  const long long plane = (long long)a.H * a.W;
  const T* x = static_cast<const T*>(a.x) + (long long)b * a.cin * plane;

  // stage 1: intermediate pixel m sits at image (oy0 - 1 + m / MW, ox0 - 1 + m % MW)
  for (int g = 0; g < a.cmid; g += H_COT) {
    float acc[H_MSTEPS][H_COT];
#pragma unroll
    for (int s = 0; s < H_MSTEPS; ++s)
#pragma unroll
      for (int j = 0; j < H_COT; ++j) acc[s][j] = 0.f;
    for (int c0 = 0; c0 < a.cin; c0 += H_CIC) {
      __syncthreads();
      for (int i = threadIdx.x; i < H_CIC * H_IH * H_IW; i += H_THREADS) {
        const int cc = i / (H_IH * H_IW), r = i % (H_IH * H_IW);
        const int gy = oy0 - 2 + r / H_IW, gx = ox0 - 2 + r % H_IW;
        const int c = c0 + cc;
        xs[cc][r / H_IW][r % H_IW] =
            (c < a.cin && gy >= 0 && gy < a.H && gx >= 0 && gx < a.W)
                ? load_f<T>(x, c * plane + (long long)gy * a.W + gx)
                : 0.f;
      }
      for (int i = threadIdx.x; i < H_CIC * 9 * H_COT; i += H_THREADS) {
        const int j = i % H_COT, t = i / H_COT, cc = t / 9, k = t % 9;
        const int co = g + j, c = c0 + cc;
        ws[t][j] = (co < a.cmid && c < a.cin)
                       ? a.w1[((long long)co * a.cin + c) * 9 + k]
                       : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int s = 0; s < H_MSTEPS; ++s) {
        const int m = threadIdx.x + s * H_THREADS;
        if (m < H_MPIX) {
          const int my = m / H_MW, mx = m % H_MW;
#pragma unroll 2
          for (int cc = 0; cc < H_CIC; ++cc) {
#pragma unroll
            for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
              for (int kx = 0; kx < 3; ++kx) {
                const float v = xs[cc][my + ky][mx + kx];
                const float* wk = ws[cc * 9 + ky * 3 + kx];
#pragma unroll
                for (int j = 0; j < H_COT; ++j) acc[s][j] = fmaf(v, wk[j], acc[s][j]);
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int s = 0; s < H_MSTEPS; ++s) {
      const int m = threadIdx.x + s * H_THREADS;
      if (m < H_MPIX) {
        const int gy = oy0 - 1 + m / H_MW, gx = ox0 - 1 + m % H_MW;
        const bool inside = gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
#pragma unroll
        for (int j = 0; j < H_COT; ++j) {
          const int co = g + j;
          if (co < a.cmid)
            mid[co * H_MPIX + m] =
                inside ? round_as<T>(fmaxf(acc[s][j] + a.b1[co], 0.f)) : 0.f;
        }
      }
    }
  }

  // stage 2 from the shared intermediate (cmid is a multiple of H_CIC)
  const int oy = oy0 + ty, ox = ox0 + tx;
  T* out = static_cast<T*>(a.out) + (long long)b * a.cout * plane;
  for (int g = 0; g < a.cout; g += H_COT) {
    float acc[H_COT];
#pragma unroll
    for (int j = 0; j < H_COT; ++j) acc[j] = 0.f;
    for (int m0 = 0; m0 < a.cmid; m0 += H_CIC) {
      __syncthreads();
      for (int i = threadIdx.x; i < H_CIC * 9 * H_COT; i += H_THREADS) {
        const int j = i % H_COT, t = i / H_COT, cc = t / 9, k = t % 9;
        const int co = g + j;
        ws[t][j] = co < a.cout ? a.w2[((long long)co * a.cmid + m0 + cc) * 9 + k]
                               : 0.f;
      }
      __syncthreads();
#pragma unroll 2
      for (int cc = 0; cc < H_CIC; ++cc) {
        const float* mp = mid + (m0 + cc) * H_MPIX;
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            const float v = mp[(ty + ky) * H_MW + tx + kx];
            const float* wk = ws[cc * 9 + ky * 3 + kx];
#pragma unroll
            for (int j = 0; j < H_COT; ++j) acc[j] = fmaf(v, wk[j], acc[j]);
          }
        }
      }
    }
    if (oy < a.H && ox < a.W) {
#pragma unroll
      for (int j = 0; j < H_COT; ++j) {
        const int co = g + j;
        if (co < a.cout)
          out[co * plane + (long long)oy * a.W + ox] =
              from_f<T>(fmaxf(acc[j] + a.b2[co], 0.f));
      }
    }
  }
}

template <typename T>
static int launch(const ChainArgs& a, cudaStream_t st) {
  const size_t smem = sizeof(float) * a.cmid * H_MPIX;
  void (*k)(const ChainArgs) = chain_kernel<T>;
  int resident = 0;  // raises k's shared-memory limit, once per device
  if (const int e = resident_blocks(k, H_THREADS, smem, resident)) return e;
  const dim3 grid((a.W + H_TW - 1) / H_TW, (a.H + H_TH - 1) / H_TH, a.B);
  NCT_LAUNCH(k, grid, dim3(H_THREADS), smem, st, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace nct

// Plain C entry; f32 x, intermediate and output (the bf16 chain runs on the
// tensor cores, conv_chain_tc.cu). cmid must be a multiple of 8.
extern "C" int nct_conv_chain2(const void* x, int dtype, int B, int H, int W,
                               int cin, int cmid, int cout, const float* w1,
                               const float* b1, const float* w2,
                               const float* b2, void* out, void* stream) {
  using namespace nct;
  if (cmid % H_CIC != 0) return static_cast<int>(cudaErrorInvalidValue);
  ChainArgs a{x, B, H, W, cin, cmid, cout, w1, b1, w2, b2, out};
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == F32) return launch<float>(a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
