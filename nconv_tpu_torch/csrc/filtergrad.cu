// K5: weight cotangent of a stride-1 convolution (f32),
//
//   d_w[co, ci, dy, dx] = sum_{b, h, w} x_pad[b, ci, h + dy, w + dx] * g[b, co, h, w]
//
// with x_pad the input padded by pad_top / pad_left (the bottom and right
// pads are implied by the output size; x reads 0 outside the image).
//
// Replaces nconv_tpu/ops/pallas_conv.py:_filtergrad_kernel (reached through
// conv_filtergrad_pallas_bhcw). It computes the same function, not the TPU
// kernel's block-Toeplitz band gather or its masked fold, which exist to
// feed the MXU.
//
// Bound on the H100: operations. A layer has at most 8*16*9 or 8*8*25 =
// 1,600 outputs, each a sum over B*Ho*Wo (up to 3.4 M) products, so the
// work is ~1,600 FMAs per pixel pair read: far above the f32 ridge of the
// CUDA cores. The design keeps every product in registers: a block stages
// one band of g (all output channels) and the matching halo of x (K_CIC
// input channels) in shared memory; each thread owns one (ci, dy) pair and
// a set of (row, segment) work items, and slides a K-wide window of x along
// the segment, so a step reads 1 x value and COUT g values for K * COUT
// FMAs. A block walks F_BANDS bands down its column strip.
//
// Determinism: no atomics. Each block reduces its threads' sums in shared
// memory in a fixed order and writes one partial vector per (tile, channel
// chunk); a second kernel sums the partials of all tiles in a fixed order
// (fixed segments, then the segments in turn), so a run is bitwise
// repeatable for a given shape.
#include "common.cuh"

namespace nct {

constexpr int F_TR = 8, F_TW = 64, F_BANDS = 4, F_CIC = 8, F_SEG = 8;
constexpr int F_ITEMS = F_TR * (F_TW / F_SEG);  // (row, segment) items per band

template <int K>
struct FgShape {
  static constexpr int NPAIR = F_CIC * K;          // (ci, dy) pairs
  static constexpr int NSUB = 256 / NPAIR;         // threads per pair
  static constexpr int NT = NPAIR * NSUB;          // threads per block
  static constexpr int XH = F_TR + K - 1, XW = F_TW + K - 1;
  static constexpr int XS = F_CIC * XH * XW;       // staged x
};

struct FgArgs {
  const float* x;  // (B, cin, H, W), contiguous
  const float* g;  // (B, COUT, ho, wo), contiguous
  int cin, H, W, ho, wo, pad_top, pad_left;
  int tiles_y, tiles_x;  // column strips of F_TR * F_BANDS rows, F_TW columns
  long long n_out;       // COUT * cin * K * K
  float* part;           // (tiles, n_out): one partial sum per tile
};

template <int K, int COUT>
__global__ void __launch_bounds__(FgShape<K>::NT) filtergrad_kernel(const FgArgs a) {
  using S = FgShape<K>;
  constexpr int GS = COUT * F_TR * F_TW, RS = S::NT * K * COUT;
  constexpr int SMEM = (S::XS + GS > RS) ? S::XS + GS : RS;
  __shared__ float smem[SMEM];
  float* xs = smem;          // [F_CIC][XH][XW]
  float* gs = smem + S::XS;  // [COUT][F_TR][F_TW]

  const int tile = blockIdx.x, c0 = blockIdx.y * F_CIC;
  const int b = tile / (a.tiles_y * a.tiles_x), r = tile % (a.tiles_y * a.tiles_x);
  const int row0 = (r / a.tiles_x) * F_TR * F_BANDS, col0 = (r % a.tiles_x) * F_TW;
  const int t = threadIdx.x, pair = t % S::NPAIR, sub = t / S::NPAIR;
  const int cc = pair / K, dy = pair % K;

  float acc[K][COUT];
#pragma unroll
  for (int dx = 0; dx < K; ++dx)
#pragma unroll
    for (int co = 0; co < COUT; ++co) acc[dx][co] = 0.f;

  for (int band = 0; band < F_BANDS; ++band) {
    const int h0 = row0 + band * F_TR;
    if (h0 >= a.ho) break;  // the same for every thread of the block
    __syncthreads();
    for (int i = t; i < S::XS; i += S::NT) {
      const int c = i / (S::XH * S::XW), rr = i % (S::XH * S::XW);
      const int ci = c0 + c, y = h0 - a.pad_top + rr / S::XW;
      const int x = col0 - a.pad_left + rr % S::XW;
      xs[i] = (ci < a.cin && y >= 0 && y < a.H && x >= 0 && x < a.W)
                  ? a.x[(((long long)b * a.cin + ci) * a.H + y) * a.W + x]
                  : 0.f;
    }
    for (int i = t; i < GS; i += S::NT) {
      const int co = i / (F_TR * F_TW), rr = i % (F_TR * F_TW);
      const int y = h0 + rr / F_TW, x = col0 + rr % F_TW;
      gs[i] = (y < a.ho && x < a.wo)
                  ? a.g[(((long long)b * COUT + co) * a.ho + y) * a.wo + x]
                  : 0.f;
    }
    __syncthreads();
    for (int it = sub; it < F_ITEMS; it += S::NSUB) {
      const int yy = it / (F_TW / F_SEG), x0 = (it % (F_TW / F_SEG)) * F_SEG;
      const float* xr = xs + (cc * S::XH + yy + dy) * S::XW + x0;
      const float* gr = gs + yy * F_TW + x0;
      float win[K];
#pragma unroll
      for (int k = 0; k < K - 1; ++k) win[k] = xr[k];
#pragma unroll
      for (int s = 0; s < F_SEG; ++s) {
        win[K - 1] = xr[s + K - 1];
#pragma unroll
        for (int co = 0; co < COUT; ++co) {
          const float gv = gr[co * F_TR * F_TW + s];
#pragma unroll
          for (int dx = 0; dx < K; ++dx) acc[dx][co] = fmaf(win[dx], gv, acc[dx][co]);
        }
#pragma unroll
        for (int k = 0; k < K - 1; ++k) win[k] = win[k + 1];
      }
    }
  }

  // sum the NSUB threads of each pair in a fixed order
  __syncthreads();
  float* red = smem;  // [NSUB][NPAIR][K][COUT]
#pragma unroll
  for (int dx = 0; dx < K; ++dx)
#pragma unroll
    for (int co = 0; co < COUT; ++co)
      red[((sub * S::NPAIR + pair) * K + dx) * COUT + co] = acc[dx][co];
  __syncthreads();
  const int nci = min(F_CIC, a.cin - c0);
  for (int o = t; o < S::NPAIR * K * COUT; o += S::NT) {
    const int co = o % COUT, q = o / COUT, dx = q % K, p = q / K;
    float s = 0.f;
    for (int u = 0; u < S::NSUB; ++u) s += red[((u * S::NPAIR + p) * K + dx) * COUT + co];
    const int ci = p / K, py = p % K;
    if (ci < nci)
      a.part[tile * a.n_out + ((co * (long long)a.cin + c0 + ci) * K + py) * K + dx] = s;
  }
}

// Second pass: out[o] = sum over tiles of part[tile, o], in R_SEG fixed
// segments of consecutive tiles, then the segments in order.
constexpr int R_OUT = 32, R_SEG = 32;

__global__ void __launch_bounds__(R_OUT * R_SEG)
    filtergrad_reduce_kernel(const float* part, int tiles, long long n_out, float* out) {
  __shared__ float s[R_SEG][R_OUT + 1];
  const int lane = threadIdx.x % R_OUT, seg = threadIdx.x / R_OUT;
  const long long o = (long long)blockIdx.x * R_OUT + lane;
  const int per = (tiles + R_SEG - 1) / R_SEG;
  float acc = 0.f;
  if (o < n_out) {
    const int t1 = min(tiles, (seg + 1) * per);
    for (int t = seg * per; t < t1; ++t) acc += part[t * n_out + o];
  }
  s[seg][lane] = acc;
  __syncthreads();
  if (seg == 0 && o < n_out) {
    float v = 0.f;
    for (int u = 0; u < R_SEG; ++u) v += s[u][lane];
    out[o] = v;
  }
}

template <int K, int COUT>
static int launch(const FgArgs& a, int B, float* out, cudaStream_t st) {
  const int tiles = B * a.tiles_y * a.tiles_x;
  const dim3 grid(tiles, (a.cin + F_CIC - 1) / F_CIC);
  void (*k)(const FgArgs) = filtergrad_kernel<K, COUT>;
  NCT_LAUNCH(k, grid, dim3(FgShape<K>::NT), 0, st, a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 rgrid(static_cast<unsigned>((a.n_out + R_OUT - 1) / R_OUT));
  void (*rk)(const float*, int, long long, float*) = filtergrad_reduce_kernel;
  NCT_LAUNCH(rk, rgrid, dim3(R_OUT * R_SEG), 0, st, a.part, tiles, a.n_out, out);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
static int dispatch_cout(const FgArgs& a, int B, int cout, float* out, cudaStream_t st) {
  if (cout == 8) return launch<K, 8>(a, B, out, st);
  if (cout == 1) return launch<K, 1>(a, B, out, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace nct

// Number of tiles (rows of the partial buffer) for an output of (ho, wo)
// at batch B; the caller allocates part as (tiles, cout * cin * k * k).
extern "C" int nct_filtergrad_tiles(int B, int ho, int wo) {
  using namespace nct;
  return B * ((ho + F_TR * F_BANDS - 1) / (F_TR * F_BANDS)) * ((wo + F_TW - 1) / F_TW);
}

// Plain C entry. x (B, cin, H, W) and g (B, cout, ho, wo) contiguous f32;
// out (cout, cin, ksize, ksize) f32; ksize in {1, 3, 5}, cout in {1, 8}.
extern "C" int nct_filtergrad(const float* x, const float* g, int B, int cin,
                              int H, int W, int cout, int ho, int wo,
                              int ksize, int pad_top, int pad_left,
                              float* part, float* out, void* stream) {
  using namespace nct;
  if (pad_top < 0 || pad_left < 0 || ho + ksize - 1 < H + pad_top ||
      wo + ksize - 1 < W + pad_left)
    return static_cast<int>(cudaErrorInvalidValue);
  FgArgs a{};
  a.x = x, a.g = g, a.cin = cin, a.H = H, a.W = W, a.ho = ho, a.wo = wo;
  a.pad_top = pad_top, a.pad_left = pad_left;
  a.tiles_y = (ho + F_TR * F_BANDS - 1) / (F_TR * F_BANDS);
  a.tiles_x = (wo + F_TW - 1) / F_TW;
  a.n_out = (long long)cout * cin * ksize * ksize;
  a.part = part;
  auto st = static_cast<cudaStream_t>(stream);
  switch (ksize) {
    case 1: return dispatch_cout<1>(a, B, cout, out, st);
    case 3: return dispatch_cout<3>(a, B, cout, out, st);
    case 5: return dispatch_cout<5>(a, B, cout, out, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
