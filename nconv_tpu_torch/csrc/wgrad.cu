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
// Bound on the H100: operations for the wide calls, bytes for the thin ones.
// It is a GEMM, M = cout by N = cin*K*K, reduced over B*Ho*Wo pixels (up to
// 428k at 352x1216), in f32 FMAs on the CUDA cores (TF32 would round the
// operands). Design, a register-tiled SIMT GEMM that stages pixels, not an
// im2col:
//  * A block owns MT = MG * MR channels of g, CB channels of x (all K*K
//    taps) and a slice of pixel tiles of 4 rows x 32 output pixels. Per tile
//    it stages g as stored ([channel][pixel], 16-byte cp.async where a part's
//    rows allow) and x as the tile's input patch, ((4-1)S+K) x ((32-1)S+K) a
//    channel, by 4-byte cp.async with a zero fill outside the image, the
//    part looked up once a staged row. Every tap then reads the patch at a
//    shifted address: no im2col, no division in the inner loop.
//  * Warp (tile row, channel half); lane (m group mg, channel). A thread
//    walks its row's 32 pixels in registers: per pixel MR g values and the
//    K (S = 1) or 2K (S = 2) new columns of a K x K window that slides along
//    the row, for MR * K * K FMAs; g is read 4 pixels at a time as float4
//    where its stage rows allow (at MR = 8, K = 3: 72 FMAs per 5
//    shared-memory loads). Its m are mg + MG r, and the g rows and x channel
//    planes are padded so that a warp's loads at one pixel fall in distinct
//    banks or broadcast.
//  * Two stages: tile t + 1's copies fly while tile t's FMAs run.
//  * Tile shapes by plan: (MG, MR) = (8, 8) for M > 32 ((8, 5), tiles of
//    40, where that pads M less: the 33 and 65 of the [depth | fusion]
//    concats), (4, 8) for M <= 32, and for the thin, bandwidth-bound
//    calls (1, 1) for M = 1 (64 x channels a block) and (16, 2) where N <
//    45 (cin <= 4 at K = 3). Each beats the tiles it displaces on the calls
//    that take it (runtime/plan_probe.py).
//  * Slices come from the card's 132 SMs (about 4 blocks an SM) and take at
//    most 64 tiles, so an accumulator's chain is at most 2048 pixels.
//
// Determinism: no atomics. The four row warps' sums join in a fixed order
// in shared memory, each block writes its tile of one slice's partial sum,
// and a second kernel sums the slices of each output in slice order (eight
// warps over strided slices, then the eight in order), so a run is bitwise
// repeatable for a given shape.
//
// f32 g and x only: the mixed schedule's bf16 operands run on the tensor
// cores (wgrad_tc.cu).
#include "common.cuh"

namespace nct {
namespace wg {

constexpr int TH = 4, TW = 32, TP = TH * TW;  // a pixel tile: 4 rows of 32 output pixels
constexpr int THREADS = 256;                  // 8 warps: 4 tile rows x 2 channel halves
constexpr int TARGET = 132 * 4;               // blocks a call aims at: about 4 on each of 132 SMs
constexpr int MAX_TILES = 64;                 // tiles a slice takes at most: chains of 2048 pixels

struct Args {
  Part g[MAX_PARTS];  // (B, M, ho, wo)
  Part x[MAX_PARTS];  // (B, cin, H, W)
  int gvec[MAX_PARTS];  // 1: a g part's rows may be read as aligned 16-byte vectors
  int ng, nx, M, cin, H, W, ho, wo, pad;
  int tiles_x, tiles_img, tiles, per;  // pixel tiles of a row and an image, in all, and a slice's
  float* part;                         // (slices, M, cin * K * K)
};

// The smallest multiple of u, an odd number of times u, at least n: a plane
// stride that puts 32 / u planes read at one offset in distinct banks.
constexpr int odd_stride(int n, int u) { return ((n + u - 1) / u + ((n + u - 1) / u + 1) % 2) * u; }

template <int K, int S, int MG, int MR>
struct Geo {
  static constexpr int KK = K * K, CW = 32 / MG, CB = 2 * CW, MT = MG * MR;
  static constexpr int IH = (TH - 1) * S + K, IW = (TW - 1) * S + K;  // a tile's x patch
  static constexpr int GST = TP + (MG == 1 ? 4 : 32 / MG);            // g stage row (one channel)
  static constexpr bool GVEC = GST % 4 == 0;                          // its pieces 16-byte aligned
  static constexpr int CS = odd_stride(IH * IW, MG);                  // x stage plane (one channel)
  static constexpr int STAGE = MT * GST + CB * CS;                    // floats
  static constexpr int RED = (TH - 1) * MT * CB * KK;                 // rows 1-3's sums, floats
  static constexpr size_t SMEM = sizeof(float) * (2 * STAGE > RED ? 2 * STAGE : RED);
};

template <int K, int S, int MG, int MR>
__global__ void __launch_bounds__(THREADS) wgrad_kernel(const Args a) {
  using G = Geo<K, S, MG, MR>;
  NCT_DYN_SHARED(float, smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = warp % TH, half = warp / TH;
  const int mg = lane % MG, cx = half * G::CW + lane / MG;  // the thread's m group and x channel
  const int c0 = blockIdx.x * G::CB, m0 = blockIdx.y * G::MT;
  const int t_begin = blockIdx.z * a.per;
  const int t_end = t_begin + a.per < a.tiles ? t_begin + a.per : a.tiles;

  // tile t's g rows and x patch into stage buf; zero outside the image and
  // past the channels
  auto stage = [&](int t, int buf) {
    float* gs = smem + buf * G::STAGE;
    float* xs = gs + G::MT * G::GST;
    const int b = t / a.tiles_img, r = t % a.tiles_img;
    const int i0 = (r / a.tiles_x) * TH, j0 = (r % a.tiles_x) * TW;
    // g: rows (m, tile row), 8 lanes a row, 4 pixels a lane
    const int jj = 4 * (tid & 7);
    for (int u = tid >> 3; u < G::MT * TH; u += THREADS / 8) {
      const int m = u / TH, y = i0 + u % TH, x = j0 + jj;
      const uint32_t dst = smem_u32(gs + m * G::GST + (u % TH) * TW + jj);
      int c = m0 + m;
      const int n = c < a.M && y < a.ho && x < a.wo ? (a.wo - x < 4 ? a.wo - x : 4) : 0;
      if (n == 0) {
#pragma unroll
        for (int e = 0; e < 4; ++e) cp_async4(dst + 4 * e, a.g[0].ptr, 0);
        continue;
      }
      const int p = part_of(a.g, a.ng, c);
      const Part& q = a.g[p];
      const float* src = static_cast<const float*>(q.ptr) + b * q.sb + c * q.sc + y * q.sh;
      if (G::GVEC && a.gvec[p]) {
        cp_async16(dst, src + x, 4 * n);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) cp_async4(dst + 4 * e, e < n ? src + (x + e) * q.sw : src, e < n ? 4 : 0);
      }
    }
    // x: one patch row (channel, row) a warp at a time, the part looked up once a row
    const int y0 = S * i0 - a.pad, x0 = S * j0 - a.pad;
    for (int u = warp; u < G::CB * G::IH; u += THREADS / 32) {
      const int cc = u / G::IH, yy = u % G::IH, y = y0 + yy;
      float* drow = xs + cc * G::CS + yy * G::IW;
      int c = c0 + cc;
      const float* src = static_cast<const float*>(a.x[0].ptr);
      long long sw = 0;
      const bool live = c < a.cin && y >= 0 && y < a.H;
      if (live) {
        const Part& q = a.x[part_of(a.x, a.nx, c)];
        src = static_cast<const float*>(q.ptr) + b * q.sb + c * q.sc + y * q.sh;
        sw = q.sw;
      }
      for (int xx = lane; xx < G::IW; xx += 32) {
        const int x = x0 + xx;
        const bool in = live && x >= 0 && x < a.W;
        cp_async4(smem_u32(drow + xx), in ? src + x * sw : src, in ? 4 : 0);
      }
    }
  };

  float acc[MR][G::KK];
#pragma unroll
  for (int r = 0; r < MR; ++r)
#pragma unroll
    for (int k = 0; k < G::KK; ++k) acc[r][k] = 0.f;

  if (t_begin < t_end) stage(t_begin, 0);
  cp_async_commit();
  for (int t = t_begin; t < t_end; ++t) {
    const int buf = (t - t_begin) & 1;
    cp_async_wait_all();
    __syncthreads();  // tile t staged; every warp is done with tile t - 1's stage
    if (t + 1 < t_end) {  // tile t + 1's copies fly while tile t's FMAs run
      stage(t + 1, buf ^ 1);
      cp_async_commit();
    }
    const float* gr = smem + buf * G::STAGE + mg * G::GST + row * TW;
    const float* xr = smem + buf * G::STAGE + G::MT * G::GST + cx * G::CS + S * row * G::IW;
    float win[K][K];
    float4 g4[MR];
#pragma unroll
    for (int j = 0; j < TW; ++j) {
#pragma unroll
      for (int dy = 0; dy < K; ++dy)
#pragma unroll
        for (int dx = 0; dx < K; ++dx)
          if (j == 0 || dx >= K - S) win[dy][dx] = xr[dy * G::IW + S * j + dx];
      float gv[MR];
      if constexpr (G::GVEC) {  // g of 4 pixels a load, as float4
        if (j % 4 == 0)
#pragma unroll
          for (int r = 0; r < MR; ++r) g4[r] = *reinterpret_cast<const float4*>(gr + r * MG * G::GST + j);
#pragma unroll
        for (int r = 0; r < MR; ++r) gv[r] = j % 4 == 0 ? g4[r].x : j % 4 == 1 ? g4[r].y : j % 4 == 2 ? g4[r].z : g4[r].w;
      } else {
#pragma unroll
        for (int r = 0; r < MR; ++r) gv[r] = gr[r * MG * G::GST + j];
      }
#pragma unroll
      for (int r = 0; r < MR; ++r)
#pragma unroll
        for (int dy = 0; dy < K; ++dy)
#pragma unroll
          for (int dx = 0; dx < K; ++dx) acc[r][dy * K + dx] = fmaf(gv[r], win[dy][dx], acc[r][dy * K + dx]);
#pragma unroll
      for (int dy = 0; dy < K; ++dy)
#pragma unroll
        for (int dx = 0; dx < K - S; ++dx) win[dy][dx] = win[dy][dx + S];
    }
  }

  // rows 1-3 hand their sums to row 0, which adds them in row order and
  // writes the block's tile of this slice's partial sum
  cp_async_wait_all();
  __syncthreads();
  const int own = (mg * G::CB + cx) * G::KK;  // a thread's place in a row's block of sums
  if (row > 0) {
    float* red = smem + (row - 1) * G::MT * G::CB * G::KK + own;
#pragma unroll
    for (int r = 0; r < MR; ++r)
#pragma unroll
      for (int k = 0; k < G::KK; ++k) red[r * MG * G::CB * G::KK + k] = acc[r][k];
  }
  __syncthreads();
  if (row > 0 || c0 + cx >= a.cin) return;
  float* part = a.part + (blockIdx.z * static_cast<long long>(a.M) + m0 + mg) * a.cin * G::KK + (c0 + cx) * G::KK;
#pragma unroll
  for (int r = 0; r < MR; ++r) {
    if (m0 + mg + MG * r >= a.M) break;
#pragma unroll
    for (int k = 0; k < G::KK; ++k) {
      float s = acc[r][k];
#pragma unroll
      for (int w = 0; w < TH - 1; ++w) s += smem[(w * G::MT * G::CB + r * MG * G::CB) * G::KK + own + k];
      part[static_cast<long long>(r) * MG * a.cin * G::KK + k] = s;
    }
  }
}

// Second pass: out[o] = the sum over the slices z of part[z, o], in a fixed
// order: warp w of a block sums slices w, w + 8, ... in turn for 32 outputs
// (reads coalesced), then the eight warps' sums are added in warp order.
__global__ void __launch_bounds__(256) reduce_kernel(const float* part, int slices, long long n_out, float* out) {
  __shared__ float red[8][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long o = static_cast<long long>(blockIdx.x) * 32 + lane;
  float s = 0.f;
  if (o < n_out)
    for (int z = warp; z < slices; z += 8) s += part[z * n_out + o];
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && o < n_out) {
    float t = red[0][lane];
#pragma unroll
    for (int w = 1; w < 8; ++w) t += red[w][lane];
    out[o] = t;
  }
}

// The launch plan, a function of (B, ho, wo, M, N) alone, N = cin K K: the
// tile shape (MG, MR) and the pixel slices, about TARGET blocks in all while
// a slice takes at most MAX_TILES tiles.
struct Tile {
  int mg, mr;
};

struct Plan {
  Tile t;
  int tiles_x, tiles_img, tiles, per, slices;
};

inline Tile tile_of(int M, int N) {
  if (M == 1) return {1, 1};
  if (N < 45) return {16, 2};
  if (M <= 32) return {4, 8};
  return {8, (M + 39) / 40 * 40 < (M + 63) / 64 * 64 ? 5 : 8};  // 33, 65: tiles of 40
}

inline Plan plan(int B, int ho, int wo, int M, int N, Tile t) {
  Plan p{};
  p.t = t;
  const int cb = 64 / t.mg, mt = t.mg * t.mr;
  p.tiles_x = (wo + TW - 1) / TW;
  p.tiles_img = p.tiles_x * ((ho + TH - 1) / TH);
  p.tiles = B * p.tiles_img;
  const long long blocks = static_cast<long long>((N + 9 * cb - 1) / (9 * cb)) * ((M + mt - 1) / mt);
  long long s = (TARGET + blocks - 1) / blocks;
  s = s < p.tiles ? s : p.tiles;
  p.per = static_cast<int>((p.tiles + s - 1) / s);
  p.per = p.per < MAX_TILES ? p.per : MAX_TILES;
  p.slices = (p.tiles + p.per - 1) / p.per;
  return p;
}

template <int K, int S, int MG, int MR>
int launch(const Args& a, int slices, float* out, cudaStream_t st) {
  using G = Geo<K, S, MG, MR>;
  void (*k)(const Args) = wgrad_kernel<K, S, MG, MR>;
  int resident = 0;  // sets the kernel's shared-memory limit on this device
  if (const int e = resident_blocks(k, THREADS, G::SMEM, resident)) return e;
  const dim3 grid((a.cin + G::CB - 1) / G::CB, (a.M + G::MT - 1) / G::MT, slices);
  NCT_LAUNCH(k, grid, dim3(THREADS), G::SMEM, st, a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long n_out = static_cast<long long>(a.M) * a.cin * G::KK;
  void (*rk)(const float*, int, long long, float*) = reduce_kernel;
  NCT_LAUNCH(rk, dim3(static_cast<unsigned>((n_out + 31) / 32)), dim3(256), 0, st, a.part, slices, n_out, out);
  return static_cast<int>(cudaGetLastError());
}

template <int K, int S>
int dispatch_tile(const Args& a, Tile t, int slices, float* out, cudaStream_t st) {
  if (t.mg == 8 && t.mr == 8) return launch<K, S, 8, 8>(a, slices, out, st);
  if (t.mg == 8 && t.mr == 5) return launch<K, S, 8, 5>(a, slices, out, st);
  if (t.mg == 4 && t.mr == 8) return launch<K, S, 4, 8>(a, slices, out, st);
  if (t.mg == 1 && t.mr == 1) return launch<K, S, 1, 1>(a, slices, out, st);
  if (t.mg == 16 && t.mr == 2) return launch<K, S, 16, 2>(a, slices, out, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Takes plan p's pixel tiling into a and launches it on the form (ksize,
// stride); a.part holds p.slices rows.
inline int run(Args& a, const Plan& p, int ksize, int stride, float* out, cudaStream_t st) {
  a.tiles_x = p.tiles_x, a.tiles_img = p.tiles_img, a.tiles = p.tiles, a.per = p.per;
  if (ksize == 3 && stride == 1) return dispatch_tile<3, 1>(a, p.t, p.slices, out, st);
  if (ksize == 3 && stride == 2) return dispatch_tile<3, 2>(a, p.t, p.slices, out, st);
  if (ksize == 4 && stride == 2) return dispatch_tile<4, 2>(a, p.t, p.slices, out, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace wg
}  // namespace nct

// Rows of the partial-sum buffer for a weight cotangent of M x N outputs
// over B * ho * wo pixels; the caller allocates part as (slices, M, N).
extern "C" int nct_wgrad_slices(int B, int ho, int wo, int M, int N) {
  return nct::wg::plan(B, ho, wo, M, N, nct::wg::tile_of(M, N)).slices;
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
  using namespace nct::wg;
  if (ng < 1 || ng > MAX_PARTS || nx < 1 || nx > MAX_PARTS || B < 1 || M < 1 || cin < 1 || pad < 0 ||
      pad >= ksize || stride < 1 || H + 2 * pad < ksize || W + 2 * pad < ksize ||
      ho != (H + 2 * pad - ksize) / stride + 1 || wo != (W + 2 * pad - ksize) / stride + 1 || dtype != F32)
    return static_cast<int>(cudaErrorInvalidValue);  // bf16: wgrad_tc.cu
  Args a{};
  fill_parts(a.g, g_ptrs, g_meta, ng);
  fill_parts(a.x, x_ptrs, x_meta, nx);
  for (int i = 0; i < ng; ++i) a.gvec[i] = vec_rows<4>(a.g[i]);
  a.ng = ng, a.nx = nx, a.M = M, a.cin = cin, a.H = H, a.W = W, a.ho = ho, a.wo = wo, a.pad = pad;
  a.part = part;
  const int N = cin * ksize * ksize;
  return run(a, plan(B, ho, wo, M, N, tile_of(M, N)), ksize, stride, out, static_cast<cudaStream_t>(stream));
}
