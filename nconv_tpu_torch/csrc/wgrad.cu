// K6: weight cotangent of a K x K convolution at stride S and pad P (f32 out),
//
//   d_w[m, ci, dy, dx] = sum_{b, i, j} x_pad[b, ci, S*i + dy, S*j + dx] * g[b, m, i, j]
//
// with x (B, cin, H, W) the conv's input read as 0 outside the image and g
// (B, M, Ho, Wo) its output cotangent; both are lists of parts (a logical
// channel concat read through each part's strides, so a concat's weight
// cotangent is one launch). Forms on the guided training path: 3x3 stride 1
// (every stride-1 conv), 3x3 stride 2 (the stacked encoder pairs) and 4x4
// stride 2 with the roles swapped for the 4x4/s2/p1 transpose conv: there x
// is the transpose conv's output cotangent and g its saved input, and d_w
// comes out in the ConvTranspose2d layout (cin, cout, 4, 4).
//
// Replaces nconv_tpu/ops/pallas_conv.py:_filtergrad_kernel (through
// conv_filtergrad_pallas_bhcw) where the guided backwards reach it:
// _conv2d_bhcw_bwd, _conv2d_bhcw_cat_bwd (one launch per part there) and
// pallas_s2._s2_res_bwd / _ct_bwd (a row-pair view against a lane-dilated
// operand there; strided reads here). K5 (filtergrad.cu) stays for step 1's
// 8-channel layers.
//
// Bound on the H100: operations. It is a GEMM, M = cout by N = cin*K*K,
// reduced over B*Ho*Wo pixels (up to 428k at 352x1216): 32-128 by 9-1152
// outputs, each a sum of 0.1-0.4 M products. The simple design tiles
// (m, n) at MT x 64 per block with a 16 x 16 thread grid, each thread an
// MR x 4 register tile (m = ty + 16 r, n = tx + 16 c), and splits the
// pixels into slices (split-K): per chunk of 32 pixels the block stages g
// (MT values a pixel) and the im2col of x (64 values a pixel) in shared
// memory, rows padded by one so the staging stores and the inner loop's
// reads are free of bank conflicts. Per pixel a thread reads MR + 4 values
// for 4 * MR FMAs.
//
// Determinism: no atomics. Each block writes its tile of one slice's
// partial sum; a second kernel sums the slices of each output in slice
// order, so a run is bitwise repeatable for a given shape.
//
// f32 g and x only: the mixed schedule's bf16 operands run on the tensor
// cores (wgrad_tc.cu).
#include "common.cuh"

namespace nct {

constexpr int W_NT = 64, W_PC = 32, W_THREADS = 256, W_MIN_PIX = 1024, W_BLOCKS = 1056;

struct WgArgs {
  Part g[MAX_PARTS];  // (B, M, ho, wo)
  Part x[MAX_PARTS];  // (B, cin, H, W)
  int ng, nx, M, N, H, W, ho, wo, pad;
  long long P, per;  // pixels B*ho*wo, pixels per slice (a multiple of W_PC)
  float* part;       // (slices, M, N)
};

template <int K, int S, int MR>
__global__ void __launch_bounds__(W_THREADS) wgrad_kernel(const WgArgs a) {
  constexpr int MT = 16 * MR, KK = K * K;
  __shared__ float gs[W_PC][MT + 1];
  __shared__ float xs[W_PC][W_NT + 1];

  const int n0 = blockIdx.x * W_NT, m0 = blockIdx.y * MT;
  const long long p_begin = blockIdx.z * a.per;
  const long long p_end = p_begin + a.per < a.P ? p_begin + a.per : a.P;
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  const int lane = t % W_PC, grp = t / W_PC;
  const int hw = a.ho * a.wo;

  float acc[MR][4];
#pragma unroll
  for (int r = 0; r < MR; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  for (long long p0 = p_begin; p0 < p_end; p0 += W_PC) {
    const long long p = p0 + lane;
    const bool valid = p < p_end;
    int b = 0, i = 0, j = 0;
    if (valid) {
      b = static_cast<int>(p / hw);
      const int r = static_cast<int>(p % hw);
      i = r / a.wo;
      j = r % a.wo;
    }
    __syncthreads();
    for (int m = grp; m < MT; m += W_THREADS / W_PC)
      gs[lane][m] = (valid && m0 + m < a.M)
                        ? load_parts<float>(a.g, a.ng, b, m0 + m, i, j, a.ho, a.wo)
                        : 0.f;
    for (int n = grp; n < W_NT; n += W_THREADS / W_PC) {
      const int nn = n0 + n;
      float v = 0.f;
      if (valid && nn < a.N) {
        const int ci = nn / KK, tap = nn % KK;
        v = load_parts<float>(a.x, a.nx, b, ci, S * i + tap / K - a.pad,
                          S * j + tap % K - a.pad, a.H, a.W);
      }
      xs[lane][n] = v;
    }
    __syncthreads();
#pragma unroll 4
    for (int q = 0; q < W_PC; ++q) {
      float gv[MR], xv[4];
#pragma unroll
      for (int r = 0; r < MR; ++r) gv[r] = gs[q][ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 4; ++c) xv[c] = xs[q][tx + 16 * c];
#pragma unroll
      for (int r = 0; r < MR; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(gv[r], xv[c], acc[r][c]);
    }
  }

  float* part = a.part + (long long)blockIdx.z * a.M * a.N;
#pragma unroll
  for (int r = 0; r < MR; ++r) {
    const int m = m0 + ty + 16 * r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + tx + 16 * c;
      if (m < a.M && n < a.N) part[(long long)m * a.N + n] = acc[r][c];
    }
  }
}

// Second pass: out[o] = sum of part[s, o] over the slices s in order.
__global__ void __launch_bounds__(256)
    wgrad_reduce_kernel(const float* part, int slices, long long n_out, float* out) {
  const long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= n_out) return;
  float s = 0.f;
  for (int z = 0; z < slices; ++z) s += part[z * n_out + o];
  out[o] = s;
}

// The launch plan, a function of the shape alone: the register-tile rows
// MR (M tile 16 * MR), and the pixel slices, enough blocks to fill the card
// a few times over while each slice keeps at least W_MIN_PIX pixels.
struct WgPlan {
  int mr, slices;
  long long per;
};

static WgPlan wgrad_plan(long long P, int M, int N) {
  WgPlan pl{};
  pl.mr = M >= 64 ? 4 : M > 16 ? 2 : 1;
  const long long tiles = (long long)((N + W_NT - 1) / W_NT) * ((M + 16 * pl.mr - 1) / (16 * pl.mr));
  long long s = (W_BLOCKS + tiles - 1) / tiles;
  const long long most = (P + W_MIN_PIX - 1) / W_MIN_PIX;
  s = s < most ? s : most;
  s = s < 1 ? 1 : s;
  pl.per = ((P + s - 1) / s + W_PC - 1) / W_PC * W_PC;
  pl.slices = static_cast<int>((P + pl.per - 1) / pl.per);
  return pl;
}

template <int K, int S, int MR>
static int launch(const WgArgs& a, int slices, float* out, cudaStream_t st) {
  const dim3 grid((a.N + W_NT - 1) / W_NT, (a.M + 16 * MR - 1) / (16 * MR), slices);
  void (*k)(const WgArgs) = wgrad_kernel<K, S, MR>;
  NCT_LAUNCH(k, grid, dim3(W_THREADS), 0, st, a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long n_out = (long long)a.M * a.N;
  const dim3 rgrid(static_cast<unsigned>((n_out + 255) / 256));
  void (*rk)(const float*, int, long long, float*) = wgrad_reduce_kernel;
  NCT_LAUNCH(rk, rgrid, dim3(256), 0, st, a.part, slices, n_out, out);
  return static_cast<int>(cudaGetLastError());
}

template <int K, int S>
static int dispatch_mr(const WgArgs& a, const WgPlan& pl, float* out, cudaStream_t st) {
  switch (pl.mr) {
    case 4: return launch<K, S, 4>(a, pl.slices, out, st);
    case 2: return launch<K, S, 2>(a, pl.slices, out, st);
    case 1: return launch<K, S, 1>(a, pl.slices, out, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

static int dispatch_form(const WgArgs& a, const WgPlan& pl, int ksize, int stride,
                         float* out, cudaStream_t st) {
  if (ksize == 3 && stride == 1) return dispatch_mr<3, 1>(a, pl, out, st);
  if (ksize == 3 && stride == 2) return dispatch_mr<3, 2>(a, pl, out, st);
  if (ksize == 4 && stride == 2) return dispatch_mr<4, 2>(a, pl, out, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace nct

// Rows of the partial-sum buffer for a weight cotangent of M x N outputs
// over B * ho * wo pixels; the caller allocates part as (slices, M, N).
extern "C" int nct_wgrad_slices(int B, int ho, int wo, int M, int N) {
  return nct::wgrad_plan((long long)B * ho * wo, M, N).slices;
}

// Plain C entry. g: ng parts (B, M, ho, wo); x: nx parts (B, cin, H, W)
// (pointers + 6 metadata values each, see nct::fill_parts), all of storage
// type dtype, which must be F32 (bf16: nct_wgrad_tc), any strides; (ksize, stride) in {(3, 1), (3, 2),
// (4, 2)}, pad in [0, ksize), (ho, wo) = ((H, W) + 2 pad - ksize) / stride +
// 1; out (M, cin, ksize, ksize) f32 contiguous.
extern "C" int nct_wgrad(const void* const* g_ptrs, const long long* g_meta, int ng,
                         const void* const* x_ptrs, const long long* x_meta, int nx,
                         int dtype, int B, int M, int cin, int H, int W, int ho, int wo,
                         int ksize, int stride, int pad, float* part, float* out,
                         void* stream) {
  using namespace nct;
  if (ng < 1 || ng > MAX_PARTS || nx < 1 || nx > MAX_PARTS || pad < 0 || pad >= ksize ||
      stride < 1 || H + 2 * pad < ksize || W + 2 * pad < ksize ||
      ho != (H + 2 * pad - ksize) / stride + 1 || wo != (W + 2 * pad - ksize) / stride + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  WgArgs a{};
  fill_parts(a.g, g_ptrs, g_meta, ng);
  fill_parts(a.x, x_ptrs, x_meta, nx);
  a.ng = ng, a.nx = nx, a.M = M, a.N = cin * ksize * ksize;
  a.H = H, a.W = W, a.ho = ho, a.wo = wo, a.pad = pad;
  a.P = (long long)B * ho * wo;
  const WgPlan pl = wgrad_plan(a.P, M, a.N);
  a.per = pl.per, a.part = part;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == F32) return dispatch_form(a, pl, ksize, stride, out, st);
  return static_cast<int>(cudaErrorInvalidValue);  // bf16: wgrad_tc.cu
}
