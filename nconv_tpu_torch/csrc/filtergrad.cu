// K5: weight cotangent of a stride-1 convolution (f32), step 1's layers,
//
//   d_w[co, ci, dy, dx] = sum_{b, h, w} x_pad[b, ci, h + dy, w + dx] * g[b, co, h, w]
//
// with x_pad the input padded by pad_top / pad_left (the bottom and right
// pads are implied by the output size; x reads 0 outside the image), cout
// in {1, 8}, k in {1, 3, 5}.
//
// Replaces nconv_tpu/ops/pallas_conv.py:_filtergrad_kernel (reached through
// conv_filtergrad_pallas_bhcw). It computes the same function, not the TPU
// kernel's block-Toeplitz band gather or its masked fold, which exist to
// feed the MXU.
//
// Bound on the H100: operations, but for the 1x1 cout-1 head (bytes). A
// layer has at most 8 x 16 x 9 or 8 x 8 x 25 outputs, each a sum over
// B Ho Wo (up to 3.4 M) products. Two forms:
//  * T, tiled (nct::fg::filtergrad_kernel): a block owns up to 32 groups of
//    P input channels at one dy (the real (channel, dy) pairs only: nconv1's
//    one channel gives 5 groups, whose freed threads take more pixel
//    segments) and a slice of pixel tiles of 8 rows x 32 output pixels. Per
//    tile it stages g and x as the tile's input patch (16-byte cp.async
//    where the rows allow, a zero fill outside the image, which covers the
//    implied pads), two stages deep. A thread owns P (channel, dy) pairs x K
//    dx x COUT and slides its K-wide x window along a segment of its tile
//    row: at P = 2, K = 5 a pixel is 2 x loads and 8 g loads (broadcasts)
//    for 80 FMAs. g is staged as stored, 16-byte copies, where its rows are
//    whole vectors; else (nconv6's 1214-wide rows) pixel-major, [pixel][co]
//    by 4-byte copies, so that a pixel's 8 channels are 2 float4 loads.
//  * D, the 1x1 cout-1 head (nct::fg::dot_kernel): a dot product of each x
//    channel with the shifted g, streamed by 4-byte coalesced loads (its
//    rows, 1214 and 1218 wide, are not 16-byte aligned), 8 channels a
//    block.
// Slices fill the card once: as many blocks as it holds at a time (the
// form's occupancy on each SM, times the SMs), each at most MAX_TILES tiles
// (D: rows), so an accumulator's chain is bounded.
//
// Determinism: no atomics. A block sums its threads' partial sums in shared
// memory in a fixed order and writes one partial vector per slice; a second
// kernel sums the slices of each output in slice order, so a run is bitwise
// repeatable for a given shape.
#include "common.cuh"

namespace nct {
namespace fg {

constexpr int TH = 8, TW = 32, TP = TH * TW;  // a pixel tile: 8 rows of 32 output pixels
constexpr int MAX_GROUPS = 32;                // (P channels, dy) groups a block
constexpr int MAX_TILES = 64;
constexpr int XW = 44;    // a staged x row: from the 16-byte vector before the patch, 44 floats (against bank conflicts)
constexpr int D_THREADS = 256, D_CH = 8, D_MAX_ROWS = 64;  // the dot form: threads, channels and at most rows a block

// PM: g staged pixel-major, [tile row][pixel][co], by 4-byte copies; else
// as stored, [co][tile row][pixel], by 16-byte copies where its rows allow
template <int K, int COUT, bool PM>
struct Geo {
  static constexpr int XH = TH + K - 1;                 // a tile's x patch rows
  static constexpr int CS = XH * XW + 20;               // a staged channel plane (against bank conflicts)
  static constexpr int GRS = PM ? TW * COUT + 4 : TW + 4;  // a staged g row
  static constexpr int GS = PM ? TH * GRS : COUT * TH * GRS;
  static __host__ __device__ constexpr int stage(int cb) { return cb * CS + GS; }
};

struct Args {
  const float* x;  // (B, cin, H, W), contiguous
  const float* g;  // (B, COUT, ho, wo), contiguous
  int cin, H, W, ho, wo, pad_top, pad_left, vec, gvec;  // x's and g's rows as 16-byte vectors
  int cb, npg, nsub, seg;              // channels a block, (channel group, dy) groups, threads a group, segment
  int tiles_x, tiles_img, tiles, per;  // pixel tiles of a row and an image, in all, and a slice's (D: rows)
  long long n_out;                     // COUT cin K K
  float* part;                         // (slices, n_out)
};

template <int K, int COUT, int P, bool PM>
__global__ void __launch_bounds__(MAX_GROUPS * 8) filtergrad_kernel(const Args a) {
  using G = Geo<K, COUT, PM>;
  constexpr int PKC = P * K * COUT;
  NCT_DYN_SHARED(float, smem);
  const int nthr = blockDim.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = nthr >> 5;
  const int pg = tid % a.npg, sub = tid / a.npg, cg = pg / K, dy = pg % K;
  const int r = sub % TH, seg0 = (sub / TH) * a.seg;  // the thread's tile row and first column
  const int c0 = blockIdx.y * a.cb, nc = a.cin - c0 < a.cb ? a.cin - c0 : a.cb;
  const bool active = cg * P < nc;  // a group of real channels
  const int stage_sz = G::stage(a.cb);
  const int t_begin = blockIdx.x * a.per, t_end = t_begin + a.per < a.tiles ? t_begin + a.per : a.tiles;
  const int xoff4 = (a.pad_left + 3) / 4 * 4, xoff = xoff4 - a.pad_left;  // patch column 0 at stage column xoff

  // tile t's g (pixel-major) and x patch into stage buf; zero outside the images
  auto stage = [&](int t, int buf) {
    float* xs = smem + buf * stage_sz;
    float* gs = xs + a.cb * G::CS;
    const int b = t / a.tiles_img, rt = t % a.tiles_img;
    const int i0 = (rt / a.tiles_x) * TH, j0 = (rt % a.tiles_x) * TW;
    if constexpr (PM) {  // g: a warp copies 4 pixels x 8 channels (shared side: 32 consecutive words)
      for (int i = tid; i < TP * COUT; i += nthr) {
        const int co = (i >> 2) % COUT, px = (i / (4 * COUT)) * 4 + (i & 3);
        const int y = i0 + px / TW, x = j0 + px % TW;
        const bool in = y < a.ho && x < a.wo;
        const float* src = in ? a.g + ((static_cast<long long>(b) * COUT + co) * a.ho + y) * a.wo + x : a.g;
        cp_async4(smem_u32(gs + (px / TW) * G::GRS + (px % TW) * COUT + co), src, in ? 4 : 0);
      }
    } else {  // g rows (co, tile row) as stored
      const int v = a.gvec ? 4 : 1;
      for (int i = tid; i < COUT * TP / v; i += nthr) {
        const int row = i / (TW / v), x = j0 + (i % (TW / v)) * v, y = i0 + row % TH;
        const bool in = y < a.ho && x < a.wo;
        const float* src = in ? a.g + ((static_cast<long long>(b) * COUT + row / TH) * a.ho + y) * a.wo + x : a.g;
        float* dst = gs + row * G::GRS + x - j0;
        if (a.gvec)
          cp_async16(smem_u32(dst), src, in ? 16 : 0);
        else
          cp_async4(smem_u32(dst), src, in ? 4 : 0);
      }
    }
    // x: one patch row (channel, row) a warp at a time, whole warps only
    const int y0 = i0 - a.pad_top;
    if (warp < nw)
      for (int u = warp; u < nc * G::XH; u += nw) {
        const int cc = u / G::XH, yy = u % G::XH, y = y0 + yy;
        const bool live = y >= 0 && y < a.H;
        const float* src = a.x + (live ? ((static_cast<long long>(b) * a.cin + c0 + cc) * a.H + y) * a.W : 0);
        float* drow = xs + cc * G::CS + yy * XW;
        if (a.vec) {  // whole vectors, in or out of the image (W % 4 == 0)
          stage_row<4>(drow, src, j0 - xoff4, (xoff + TW + K - 1 + 3) / 4, a.W, live, lane);
        } else {
          for (int xx = lane; xx < TW + K - 1; xx += 32) {
            const int x = j0 - a.pad_left + xx;
            const bool in = live && x >= 0 && x < a.W;
            cp_async4(smem_u32(drow + xoff + xx), in ? src + x : src, in ? 4 : 0);
          }
        }
      }
  };

  float acc[P][K][COUT];
#pragma unroll
  for (int j = 0; j < P; ++j)
#pragma unroll
    for (int dx = 0; dx < K; ++dx)
#pragma unroll
      for (int co = 0; co < COUT; ++co) acc[j][dx][co] = 0.f;

  if (t_begin < t_end) stage(t_begin, 0);
  cp_async_commit();
  for (int t = t_begin; t < t_end; ++t) {
    const int buf = (t - t_begin) & 1;
    cp_async_wait_all();
    __syncthreads();  // tile t staged; every thread is done with tile t - 1's stage
    if (t + 1 < t_end) {  // tile t + 1's copies fly while tile t's FMAs run
      stage(t + 1, buf ^ 1);
      cp_async_commit();
    }
    if (!active) continue;
    const float* xr = smem + buf * stage_sz + cg * P * G::CS + (r + dy) * XW + xoff + seg0;
    const float* gr = smem + buf * stage_sz + a.cb * G::CS + r * G::GRS + seg0 * (PM ? COUT : 1);
    float win[P][K];  // the x window of each channel: columns x .. x + K - 1
#pragma unroll
    for (int j = 0; j < P; ++j)
#pragma unroll
      for (int k = 0; k < K - 1; ++k) win[j][k] = xr[j * G::CS + k];
#pragma unroll 1
    for (int c = 0; c < a.seg; c += 8) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
#pragma unroll
        for (int j = 0; j < P; ++j) win[j][K - 1] = xr[j * G::CS + c + e + K - 1];
        float gv[COUT];
        if constexpr (PM) {
          load_w<COUT>(gr + (c + e) * COUT, gv);
        } else {
#pragma unroll
          for (int co = 0; co < COUT; ++co) gv[co] = gr[co * TH * G::GRS + c + e];
        }
#pragma unroll
        for (int j = 0; j < P; ++j)
#pragma unroll
          for (int dx = 0; dx < K; ++dx)
#pragma unroll
            for (int co = 0; co < COUT; ++co) acc[j][dx][co] = fmaf(win[j][dx], gv[co], acc[j][dx][co]);
#pragma unroll
        for (int j = 0; j < P; ++j)
#pragma unroll
          for (int k = 0; k < K - 1; ++k) win[j][k] = win[j][k + 1];
      }
    }
  }

  // each group's nsub threads' sums, added in sub order
  cp_async_wait_all();
  __syncthreads();
  float* red = smem;  // [sub][group][P K COUT]
#pragma unroll
  for (int j = 0; j < P; ++j)
#pragma unroll
    for (int dx = 0; dx < K; ++dx)
#pragma unroll
      for (int co = 0; co < COUT; ++co) red[(sub * a.npg + pg) * PKC + (j * K + dx) * COUT + co] = acc[j][dx][co];
  __syncthreads();
  for (int o = tid; o < a.npg * PKC; o += nthr) {
    const int grp = o / PKC, q = o % PKC, cc = (grp / K) * P + q / (K * COUT);
    if (cc >= nc) continue;
    float s = 0.f;
    for (int u = 0; u < a.nsub; ++u) s += red[(u * a.npg + grp) * PKC + q];
    const int co = q % COUT, dx = (q / COUT) % K;
    a.part[blockIdx.x * a.n_out + ((co * static_cast<long long>(a.cin) + c0 + cc) * K + grp % K) * K + dx] = s;
  }
}

// The 1x1 cout-1 form: part[slice, c] = the sum over the slice's (b, y)
// rows of x[b, c, y, :] . g[b, 0, y + pad_top, pad_left:], 8 channels a
// block (blockIdx.y), the threads' sums added by a fixed tree.
__global__ void __launch_bounds__(D_THREADS) dot_kernel(const Args a) {
  __shared__ float red[D_CH][D_THREADS];
  const int tid = threadIdx.x, c0 = blockIdx.y * D_CH, nc = a.cin - c0 < D_CH ? a.cin - c0 : D_CH;
  const int r_begin = blockIdx.x * a.per, r_end = r_begin + a.per < a.tiles ? r_begin + a.per : a.tiles;
  const long long plane = static_cast<long long>(a.H) * a.W;
  float acc[D_CH];
#pragma unroll
  for (int c = 0; c < D_CH; ++c) acc[c] = 0.f;
  for (int rr = r_begin; rr < r_end; ++rr) {
    const int b = rr / a.H, y = rr % a.H;
    const float* gr = a.g + (static_cast<long long>(b) * a.ho + y + a.pad_top) * a.wo + a.pad_left;
    const float* xr = a.x + (static_cast<long long>(b) * a.cin + c0) * plane + static_cast<long long>(y) * a.W;
    for (int x = tid; x < a.W; x += D_THREADS) {
      const float gv = gr[x];
#pragma unroll
      for (int c = 0; c < D_CH; ++c)
        if (c < nc) acc[c] = fmaf(xr[c * plane + x], gv, acc[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < D_CH; ++c) red[c][tid] = acc[c];
  for (int h = D_THREADS / 2; h > 0; h /= 2) {
    __syncthreads();
    if (tid < h)
#pragma unroll
      for (int c = 0; c < D_CH; ++c) red[c][tid] += red[c][tid + h];
  }
  if (tid < nc) a.part[blockIdx.x * a.n_out + c0 + tid] = red[tid][0];
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

// The launch plan, a function of the shape and the card: the form (T
// tiled, D the 1x1 cout-1 dot), for T the channels a group (p) and a block
// (cb), the (group, dy) groups, the threads a group and their segment, g's
// staged layout (pm), and for both the slices: about waves x the blocks the
// card holds at a time, at most MAX_TILES tiles (D: D_MAX_ROWS rows) a
// slice.
struct Plan {
  char form;
  int p, pm, nb, cb, npg, nsub, seg, units, per, slices;
  int threads() const { return form == 'D' ? D_THREADS : npg * nsub; }
};

template <int K, int COUT, int P, bool PM>
size_t smem_of(const Plan& q) {
  const size_t red = sizeof(float) * q.threads() * P * K * COUT;
  const size_t stages = 2 * sizeof(float) * Geo<K, COUT, PM>::stage(q.cb);
  return red > stages ? red : stages;
}

// f.template run<K, COUT, P, PM>() for plan q's tiled kernel at (K, cout);
// cout 1 has one g layout
template <int K, int COUT, bool PM, class F>
int dispatch_p(const Plan& q, const F& f) {
  if (q.p == 2) return f.template run<K, COUT, 2, PM>();
  if (q.p == 1) return f.template run<K, COUT, 1, PM>();
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int K, class F>
int dispatch_g(const Plan& q, int cout, const F& f) {
  if (cout == 8) return q.pm ? dispatch_p<K, 8, true>(q, f) : dispatch_p<K, 8, false>(q, f);
  if (cout == 1) return dispatch_p<K, 1, false>(q, f);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <class F>
int dispatch(const Plan& q, int K, int cout, const F& f) {
  if (K == 1) return dispatch_g<1>(q, cout, f);
  if (K == 3) return dispatch_g<3>(q, cout, f);
  if (K == 5) return dispatch_g<5>(q, cout, f);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The blocks of q's tiled kernel that the current device holds at a time.
struct Resident {
  const Plan& q;
  int& n;
  template <int K, int COUT, int P, bool PM>
  int run() const {
    void (*k)(const Args) = filtergrad_kernel<K, COUT, P, PM>;
    return resident_blocks(k, q.threads(), smem_of<K, COUT, P, PM>(q), n);
  }
};

inline int plan_of(Plan& q, int B, int cin, int H, int ho, int wo, int cout, int K, char form, int p, int pm,
                   int waves) {
  q = Plan{};
  q.form = form;
  int most = MAX_TILES, blocks = 0, e = 0;
  if (form == 'D') {
    q.nb = (cin + D_CH - 1) / D_CH, q.units = B * H, most = D_MAX_ROWS;
    void (*k)(const Args) = dot_kernel;
    e = resident_blocks(k, D_THREADS, 0, blocks);
  } else {
    q.p = p, q.pm = pm;
    const int nb = (cin + p * (MAX_GROUPS / K) - 1) / (p * (MAX_GROUPS / K));
    q.cb = ((cin + nb - 1) / nb + p - 1) / p * p;
    q.nb = (cin + q.cb - 1) / q.cb;
    q.npg = q.cb / p * K;
    q.nsub = q.npg * 8 >= 128 ? 8 : q.npg * 16 >= 128 ? 16 : 32;  // 8 / 16 / 32 threads a group: segments of 32 / 16 / 8
    q.seg = TP / q.nsub;
    q.units = B * ((ho + TH - 1) / TH) * ((wo + TW - 1) / TW);
    e = dispatch(q, K, cout, Resident{q, blocks});
  }
  if (e) return e;
  long long s = (static_cast<long long>(blocks) * waves + q.nb - 1) / q.nb;
  s = s < 1 ? 1 : s < q.units ? s : q.units;
  q.per = static_cast<int>((q.units + s - 1) / s);
  q.per = q.per < most ? q.per : most;
  q.slices = (q.units + q.per - 1) / q.per;
  return 0;
}

// D for the 1x1 cout-1 head; T else, two channels a group where cin is
// even, g as stored where its rows are whole 16-byte vectors, else
// pixel-major; one wave of blocks.
inline int plan(Plan& q, int B, int cin, int H, int ho, int wo, int cout, int K) {
  if (K == 1 && cout == 1) return plan_of(q, B, cin, H, ho, wo, cout, K, 'D', 0, 0, 1);
  const int pm = wo % 4 != 0 || (static_cast<long long>(ho) * wo) % 4 != 0;
  return plan_of(q, B, cin, H, ho, wo, cout, K, 'T', cin % 2 == 0 ? 2 : 1, pm, 1);
}

inline int reduce(const Args& a, int slices, float* out, cudaStream_t st) {
  void (*rk)(const float*, int, long long, float*) = reduce_kernel;
  NCT_LAUNCH(rk, dim3(static_cast<unsigned>((a.n_out + 31) / 32)), dim3(256), 0, st, a.part, slices, a.n_out, out);
  return static_cast<int>(cudaGetLastError());
}

// Launches plan q's tiled kernel, then the reduction.
struct Launch {
  const Args& a;
  const Plan& q;
  float* out;
  cudaStream_t st;
  template <int K, int COUT, int P, bool PM>
  int run() const {
    int n = 0;  // sets the kernel's shared-memory limit on this device
    if (const int e = Resident{q, n}.run<K, COUT, P, PM>()) return e;
    void (*k)(const Args) = filtergrad_kernel<K, COUT, P, PM>;
    const size_t smem = smem_of<K, COUT, P, PM>(q);
    NCT_LAUNCH(k, dim3(q.slices, q.nb), dim3(q.threads()), smem, st, a);
    const cudaError_t e = cudaGetLastError();
    return e != cudaSuccess ? static_cast<int>(e) : reduce(a, q.slices, out, st);
  }
};

// Whether the entry takes the shape: x (B, cin, H, W), g (B, cout, ho, wo),
// ksize in {1, 3, 5}, cout in {1, 8}, pads not negative, implied ones too.
inline bool takes(int B, int cin, int H, int W, int cout, int ho, int wo, int ksize, int pad_top, int pad_left) {
  return B >= 1 && cin >= 1 && H >= 1 && W >= 1 && ho >= 1 && wo >= 1 && (ksize == 1 || ksize == 3 || ksize == 5) &&
         (cout == 1 || cout == 8) && pad_top >= 0 && pad_left >= 0 && ho + ksize - 1 >= H + pad_top &&
         wo + ksize - 1 >= W + pad_left;
}

// Launches plan q; a.part holds q.slices rows.
inline int run(const float* x, const float* g, int B, int cin, int H, int W, int cout, int ho, int wo, int ksize,
               int pad_top, int pad_left, float* part, float* out, const Plan& q, cudaStream_t st) {
  Args a{};
  a.x = x, a.g = g, a.cin = cin, a.H = H, a.W = W, a.ho = ho, a.wo = wo, a.pad_top = pad_top, a.pad_left = pad_left;
  a.vec = W % 4 == 0 && (static_cast<long long>(H) * W) % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  a.gvec = wo % 4 == 0 && (static_cast<long long>(ho) * wo) % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0;
  a.cb = q.cb, a.npg = q.npg, a.nsub = q.nsub, a.seg = q.seg, a.per = q.per, a.tiles = q.units;
  a.tiles_x = (wo + TW - 1) / TW, a.tiles_img = a.tiles_x * ((ho + TH - 1) / TH);
  a.n_out = static_cast<long long>(cout) * cin * ksize * ksize;
  a.part = part;
  if (q.form == 'D') {
    if (ksize != 1 || cout != 1) return static_cast<int>(cudaErrorInvalidValue);
    void (*k)(const Args) = dot_kernel;
    NCT_LAUNCH(k, dim3(q.slices, q.nb), dim3(D_THREADS), 0, st, a);
    const cudaError_t e = cudaGetLastError();
    return e != cudaSuccess ? static_cast<int>(e) : reduce(a, q.slices, out, st);
  }
  return dispatch(q, ksize, cout, Launch{a, q, out, st});
}

}  // namespace fg
}  // namespace nct

// Rows of the partial-sum buffer for x (B, cin, H, .) and g (B, cout, ho,
// wo) at ksize on the current device, or minus a CUDA error; the caller
// allocates part as (slices, cout * cin * k * k).
extern "C" int nct_filtergrad_slices(int B, int cin, int H, int ho, int wo, int cout, int ksize) {
  nct::fg::Plan q;
  const int e = nct::fg::plan(q, B, cin, H, ho, wo, cout, ksize);
  return e ? -e : q.slices;
}

// Plain C entry. x (B, cin, H, W) and g (B, cout, ho, wo) contiguous f32;
// out (cout, cin, ksize, ksize) f32; ksize in {1, 3, 5}, cout in {1, 8};
// part (nct_filtergrad_slices, cout * cin * ksize * ksize) f32.
extern "C" int nct_filtergrad(const float* x, const float* g, int B, int cin, int H, int W, int cout, int ho, int wo,
                              int ksize, int pad_top, int pad_left, float* part, float* out, void* stream) {
  using namespace nct;
  if (!fg::takes(B, cin, H, W, cout, ho, wo, ksize, pad_top, pad_left)) return static_cast<int>(cudaErrorInvalidValue);
  fg::Plan q;
  if (const int e = fg::plan(q, B, cin, H, ho, wo, cout, ksize)) return e;
  return fg::run(x, g, B, cin, H, W, cout, ho, wo, ksize, pad_top, pad_left, part, out, q,
                 static_cast<cudaStream_t>(stream));
}
