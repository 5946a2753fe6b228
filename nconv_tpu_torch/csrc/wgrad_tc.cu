// K6 in bf16 on the tensor cores (nct_wgrad_tc): the weight cotangent of a
// K x K convolution at stride S and pad P from bf16 operands, f32 out,
//
//   d_w[m, ci, dy, dx] = sum_{b, i, j} x_pad[b, ci, S*i + dy, S*j + dx] * g[b, m, i, j]
//
// with x (B, cin, H, W) the conv's input read as 0 outside the image and g
// (B, M, Ho, Wo) its output cotangent, both lists of parts read through their
// strides (a channel-offset view included). Forms: 3x3 stride 1, 3x3 stride 2
// and 4x4 stride 2 with the roles swapped for the 4x4/s2/p1 transpose conv
// (x its output cotangent, g its saved input, d_w in the ConvTranspose2d
// layout (cin, cout, 4, 4)). The f32 form stays on the CUDA cores (wgrad.cu):
// TF32 would round its operands.
//
// Replaces nconv_tpu/ops/pallas_conv.py:_filtergrad_kernel (:1093, through
// conv_filtergrad_pallas_bhcw) in the mixed schedule's guided backwards,
// which contract bf16 tiles on the MXU with f32 sums.
//
// Bound on the H100: a GEMM of M = cout (1-128) by N = cin*K*K (9-1152),
// contracted over B*Ho*Wo pixels (up to 428k at 352x1216): 2 M N FLOP per
// pixel against 2 (M + cin) bytes read, so bytes bound the narrow calls (the
// cout-1 heads, cin 1-3) and the bf16 rate the widest (M 64-128 over 64-128
// channels). Design:
//  * GEMM D[M, N] = G[M, P] X[P, N] with the pixel axis as the MMA's k:
//    mma.sync m16n8k16 bf16 -> f32 fed by ldmatrix from shared-memory
//    stages whose rows are padded to an odd multiple of 16 bytes, so each
//    8-row matrix is free of bank conflicts.
//  * A block owns 16 channels of x (all K*K taps: 2 n8 tiles a tap), up to
//    64 channels of g (m16 tiles, M padded to 16) and a slice of 4 x 32 pixel
//    tiles of the output grid, which it walks in a two-stage pipeline: while
//    the MMAs of tile t run, tile t + 1's loads are in flight.
//  * g keeps its NCHW order in shared memory ([channel][pixel], A read with
//    plain ldmatrix), so it is staged by cp.async in 16-byte pieces, zero
//    outside the image (element loads for a part whose rows are not 16-byte
//    aligned).
//  * x is staged channels-last ([pixel][channel], B read with
//    ldmatrix.trans), transposed on the way in from NCHW: a thread copies its
//    units (4 channels x 8 pixels) by cp.async into slots of its own as four
//    16-byte rows (element loads at the image's edges and for a part whose
//    rows are not 16-byte aligned; channels past the parts zero-filled) and,
//    once they have landed, stores them transposed. A tap (dy, dx) at stride
//    S is then a per-lane row address in the x stage: no im2col, no shifted
//    copies. At S = 2 the stage keeps its columns split by parity (even, then
//    odd), so a tap's 16 pixels are 16 consecutive rows and stay
//    conflict-free.
//  * Warp (m16 tile, tap row dy): per k16 step one A fragment and K B
//    fragments, 2K MMAs.
//  * The tensor cores' f32 sums truncate (a bias toward zero at every MMA),
//    so each accumulator's chain is one tile's 8 k16 steps (128 pixels); it
//    then joins the warp's running f32 total with one rounded add, and the
//    bias stays that of 8 MMAs, not of a slice's thousands.
//  * Split-K over the pixel tiles, as wgrad.cu: each block writes its tile of
//    one slice's partial sum, and a second kernel sums the slices of each
//    output in slice order. No atomics, and the plan is a function of the
//    shape alone, so a run is bitwise repeatable for a given shape.
#include "tc.cuh"

namespace nct {
namespace wtc {

using tc::quad_of;
using tc::row8;
using tc::Walk;

constexpr int TW = 32, TH = 4, TP = TH * TW;  // a pixel tile: 4 rows of 32, 8 k16 steps
constexpr int CB = 16;                        // x channels a block: two n8 tiles a tap
constexpr int XS = CB + 8;                    // x stage row (one pixel), bf16
constexpr int GS = TP + 8;                    // g stage row (one channel), bf16
constexpr int MB = 64;                        // g channels a block at most: 4 m16 tiles
constexpr int TARGET_THREADS = 132 * 768;     // threads a call aims at: 24 warps on each of 132 SMs
// (on the guided step's calls on the H100, twice as many threads or half as
// many, a third pipeline stage and two m16 tiles a warp were each slower or
// no faster)
constexpr int MIN_TILES = 2;                  // pixel tiles a slice keeps at least

struct Args {
  Part g[MAX_PARTS];  // (B, M, ho, wo)
  Part x[MAX_PARTS];  // (B, cin, H, W)
  int gvec[MAX_PARTS], xvec[MAX_PARTS];  // 1: a part's rows may be read as 16-byte vectors
  int ng, nx, M, cin, H, W, ho, wo, pad;
  int mb;                            // g channels staged by a block: 16 * MT
  int tiles_x, tiles_y, tiles, per;  // pixel tiles, and tiles per slice
  float* part;                       // (slices, M, K * K, cin)
};

template <int K, int S>
struct Geo {
  static constexpr int IH = (TH - 1) * S + K, IW = (TW - 1) * S + K;  // the x window of a tile
  // stage columns: at S = 2 split by parity, even columns first
  static constexpr int IWH = (IW + 1) / 2, IWS = S == 2 ? 2 * IWH : IW;
  // 8-pixel groups of a window row, loaded from x = S * j0 - 8 (aligned):
  // group gg, element e is window column 8 gg + e - 8 + pad (any pad < K)
  static constexpr int G = (IW + 15) / 8;
  static __device__ __forceinline__ int col(int c) { return S == 2 ? (c & 1) * IWH + (c >> 1) : c; }
};

// A block's slice of pixel tiles, its 16 x channels and its g channels. MT:
// m16 tiles of the block, one per warp row; the block has MT x K warps.
template <int K, int S, int MT>
__global__ void __launch_bounds__(32 * MT * K) wgrad_tc_kernel(const Args a) {
  using Gm = Geo<K, S>;
  constexpr int KK = K * K, NTH = 32 * MT * K, NT = 2 * K;
  constexpr int XU = (CB / 4) * Gm::IH * Gm::G;  // x units of a tile
  constexpr int MAXU = (XU + NTH - 1) / NTH;    // x units a thread loads a tile
  constexpr int XSZ = Gm::IH * Gm::IWS * XS;     // one x stage, bf16
  NCT_DYN_SHARED(unsigned char, smem);
  const int gsz = a.mb * GS;  // one g stage, bf16
  unsigned short* gs = reinterpret_cast<unsigned short*>(smem);  // [2][mb][GS]
  unsigned short* xs = gs + 2 * gsz;                             // [2][IH][IWS][XS]
  unsigned short* xr = xs + 2 * XSZ;  // [MAXU][NTH][4][8]: each thread's x units as loaded
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % MT, dy = warp / MT;  // the warp's m16 tile and tap row
  const int c0 = blockIdx.x * CB, m0 = blockIdx.y * a.mb;
  const int t_begin = blockIdx.z * a.per;
  const int t_end = t_begin + a.per < a.tiles ? t_begin + a.per : a.tiles;
  if (t_begin >= t_end) return;

  // ldmatrix lanes: matrix i = lane / 8, its row lane % 8. A (g, as stored
  // [m][pixel]): m lane % 8 + 8 (i & 1), pixel 8 (i >> 1). B (x, transposed
  // [pixel][channel]): pixel lane % 8 + 8 (i & 1), channel 8 (i >> 1); B
  // gives the k halves of n8 tile 0 in r[0], r[1], of n8 tile 1 (channels
  // 8-15) in r[2], r[3].
  const int r8 = lane & 7, mi = lane >> 3, bpix = r8 + 8 * (mi & 1);
  const uint32_t a_lane = smem_u32(gs) + ((16 * wm + r8 + 8 * (mi & 1)) * GS + 8 * (mi >> 1)) * 2;
  const uint32_t b_lane = smem_u32(xs) + 8 * (mi >> 1) * 2;

  // g tile t into stage buf: 16-byte chunks (channel m, tile row rr, 8-pixel
  // group gg), asynchronous where the part's rows allow, zero outside
  auto stage_g = [&](int t, int buf) {
    const int per_img = a.tiles_x * a.tiles_y, r = t % per_img, b = t / per_img;
    const int i0 = (r / a.tiles_x) * TH, j0 = (r % a.tiles_x) * TW;
    const uint32_t base = smem_u32(gs) + buf * gsz * 2;
    for (int u = tid; u < a.mb * TH * (TW / 8); u += NTH) {
      const int gg = u % (TW / 8), rr = (u / (TW / 8)) % TH, m = u / (TH * (TW / 8));
      const int y = i0 + rr, x = j0 + 8 * gg;
      const int off = m * GS + rr * TW + 8 * gg;
      int c = m0 + m;
      if (c >= a.M || y >= a.ho || x >= a.wo) {
        cp_async16(base + off * 2, a.g[0].ptr, 0);
        continue;
      }
      const int p = part_of(a.g, a.ng, c);
      const Part& q = a.g[p];
      const unsigned short* row = static_cast<const unsigned short*>(q.ptr) + b * q.sb + c * q.sc + y * q.sh;
      if (a.gvec[p])
        cp_async16(base + off * 2, row + x, 2 * (a.wo - x < 8 ? a.wo - x : 8));
      else
        *reinterpret_cast<uint4*>(gs + buf * gsz + off) = row8(q, 0, row, x, a.wo);
    }
  };
  // x tile t: unit = quad q (channels c0 + 4q ..) of 8 pixels (window row
  // lr, group gg), loaded by cp.async into the thread's own slots as four
  // 16-byte channel rows (element loads at the image's edges and for a part
  // whose rows are not 16-byte aligned), then stored transposed by the same
  // thread once they have landed
  auto load_x = [&](int t) {
    const int per_img = a.tiles_x * a.tiles_y, r = t % per_img, b = t / per_img;
    const int y0 = S * (r / a.tiles_x) * TH - a.pad, xa = S * (r % a.tiles_x) * TW - 8;
    Walk w(tid, NTH, CB / 4);
#pragma unroll
    for (int i = 0; i < MAXU; ++i, w.next()) {
      if (tid + i * NTH >= XU) continue;
      const int y = y0 + w.rest / Gm::G, x = xa + 8 * (w.rest % Gm::G);
      unsigned short* slot = xr + (i * NTH + tid) * 32;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        int c = c0 + 4 * w.q + k;
        if (c >= a.cin || y < 0 || y >= a.H || x + 8 <= 0 || x >= a.W) {
          cp_async16(smem_u32(slot + 8 * k), a.x[0].ptr, 0);
          continue;
        }
        const int p = part_of(a.x, a.nx, c);
        const Part& q = a.x[p];
        const unsigned short* row = static_cast<const unsigned short*>(q.ptr) + b * q.sb + c * q.sc + y * q.sh;
        if (a.xvec[p] && x >= 0 && x + 8 <= a.W)
          cp_async16(smem_u32(slot + 8 * k), row + x, 16);
        else
          *reinterpret_cast<uint4*>(slot + 8 * k) = row8(q, 0, row, x, a.W);
      }
    }
  };
  auto store_x = [&](int buf) {
    Walk w(tid, NTH, CB / 4);
#pragma unroll
    for (int i = 0; i < MAXU; ++i, w.next()) {
      if (tid + i * NTH >= XU) continue;
      const uint4* slot = reinterpret_cast<const uint4*>(xr + (i * NTH + tid) * 32);
      const uint4 v[4] = {slot[0], slot[1], slot[2], slot[3]};
      const int lr = w.rest / Gm::G, gg = w.rest % Gm::G;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int lc = 8 * gg + e - 8 + a.pad;
        if (lc >= 0 && lc < Gm::IW)
          *reinterpret_cast<uint2*>(xs + buf * XSZ + (lr * Gm::IWS + Gm::col(lc)) * XS + 4 * w.q) =
              quad_of(v, e);
      }
    }
  };

  float tot[NT][4], acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) tot[n][e] = acc[n][e] = 0.f;

  stage_g(t_begin, 0);
  load_x(t_begin);
  cp_async_commit();
  cp_async_wait_all();
  store_x(0);
  for (int t = t_begin; t < t_end; ++t) {
    const int buf = (t - t_begin) & 1;
    __syncthreads();  // tile t staged; every warp is done with tile t - 1's stages
    const bool next = t + 1 < t_end;
    if (next) {  // tile t + 1's loads fly while tile t's MMAs run
      stage_g(t + 1, buf ^ 1);
      load_x(t + 1);
      cp_async_commit();
    }
    const uint32_t ga = a_lane + buf * gsz * 2, xb = b_lane + buf * XSZ * 2;
#pragma unroll 2
    for (int ks = 0; ks < TP / 16; ++ks) {
      const int rr = ks / (TW / 16), ck = (ks % (TW / 16)) * 16;
      uint32_t fa[4];
      ldsm_x4(fa, ga + (rr * TW + ck) * 2);
#pragma unroll
      for (int dx = 0; dx < K; ++dx) {
        uint32_t fb[4];
        ldsm_x4_t(fb, xb + ((S * rr + dy) * Gm::IWS + Gm::col(S * (ck + bpix) + dx)) * XS * 2);
        mma_bf16(acc[2 * dx], fa, fb[0], fb[1]);
        mma_bf16(acc[2 * dx + 1], fa, fb[2], fb[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        tot[n][e] += acc[n][e];  // the chain's one rounded join
        acc[n][e] = 0.f;
      }
    if (next) {
      cp_async_wait_all();  // this thread's copies; the barrier above shows them to the others
      store_x(buf ^ 1);
    }
  }

  // D fragment: element e of n8 tile nt is (m: lane / 4 + 8 (e >> 1), channel:
  // 8 (nt & 1) + 2 (lane % 4) + (e & 1)) at tap (dy, nt >> 1); the partial
  // sum is laid out (M, K*K, cin), channels innermost as the fragments hold them
  float* part = a.part + blockIdx.z * static_cast<long long>(a.M) * KK * a.cin;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = m0 + 16 * wm + (lane >> 2) + 8 * (e >> 1);
      const int ch = c0 + 8 * (nt & 1) + 2 * (lane & 3) + (e & 1);
      if (m < a.M && ch < a.cin) part[(static_cast<long long>(m) * KK + dy * K + (nt >> 1)) * a.cin + ch] = tot[nt][e];
    }
}

// Second pass: out (M, cin, kk) = the sum of part (slices, M, kk, cin) over
// the slices in order, one partial element a thread (reads coalesced).
__global__ void __launch_bounds__(256) reduce_kernel(const float* part, int slices, int cin, int kk,
                                                     long long n_out, float* out) {
  const long long o = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (o >= n_out) return;
  float s = 0.f;
  for (int z = 0; z < slices; ++z) s += part[z * n_out + o];
  const long long ch = o % cin, tap = (o / cin) % kk, m = o / (static_cast<long long>(cin) * kk);
  out[(m * cin + ch) * kk + tap] = s;
}

// The launch plan, a function of the shape alone: g's channels in mblocks
// blocks of 16 * mt (M padded the least), x's in chunks of 16, and the pixel
// tiles in slices, about TARGET_THREADS threads in all (narrow blocks come
// more often, to keep enough loads in flight) while a slice keeps MIN_TILES
// tiles.
struct Plan {
  int mt, mblocks, nchunks, tiles_x, tiles_y, tiles, per, slices;
};

inline Plan plan(int B, int ho, int wo, int M, int cin, int k) {
  Plan p{};
  p.mblocks = (M + MB - 1) / MB;
  p.mt = (M + 16 * p.mblocks - 1) / (16 * p.mblocks);
  p.nchunks = (cin + CB - 1) / CB;
  p.tiles_x = (wo + TW - 1) / TW;
  p.tiles_y = (ho + TH - 1) / TH;
  p.tiles = B * p.tiles_x * p.tiles_y;
  const int blocks = TARGET_THREADS / (32 * p.mt * k);
  long long s = (blocks + p.nchunks * p.mblocks - 1) / (p.nchunks * p.mblocks);
  const long long most = (p.tiles + MIN_TILES - 1) / MIN_TILES;
  s = s < most ? s : most;
  s = s < 1 ? 1 : s;
  p.per = static_cast<int>((p.tiles + s - 1) / s);
  p.slices = (p.tiles + p.per - 1) / p.per;
  return p;
}

// two g and two x stages, and the x units as loaded
inline size_t smem_bytes(int k, int s, int mb, int threads) {
  const int ih = (TH - 1) * s + k, iw = (TW - 1) * s + k, iws = s == 2 ? 2 * ((iw + 1) / 2) : iw;
  const int units = (CB / 4) * ih * ((iw + 15) / 8), slots = (units + threads - 1) / threads * threads;
  return (2 * (static_cast<size_t>(mb) * GS + static_cast<size_t>(ih) * iws * XS) + 32 * static_cast<size_t>(slots)) *
         2;
}

template <int K, int S, int MT>
int launch(Args& a, const Plan& p, float* out, cudaStream_t st) {
  void (*k)(const Args) = wgrad_tc_kernel<K, S, MT>;
  const int threads = 32 * MT * K;
  const size_t smem = smem_bytes(K, S, a.mb, threads);
  int resident = 0;  // sets the kernel's shared-memory limit on this device
  if (const int e = resident_blocks(k, threads, smem, resident)) return e;
  NCT_LAUNCH(k, dim3(p.nchunks, p.mblocks, p.slices), dim3(threads), smem, st, a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long n_out = static_cast<long long>(a.M) * a.cin * K * K;
  void (*rk)(const float*, int, int, int, long long, float*) = reduce_kernel;
  NCT_LAUNCH(rk, dim3(static_cast<unsigned>((n_out + 255) / 256)), dim3(256), 0, st, a.part, p.slices, a.cin,
             K * K, n_out, out);
  return static_cast<int>(cudaGetLastError());
}

template <int K, int S>
int dispatch_mt(Args& a, const Plan& p, float* out, cudaStream_t st) {
  switch (p.mt) {
    case 1: return launch<K, S, 1>(a, p, out, st);
    case 2: return launch<K, S, 2>(a, p, out, st);
    case 3: return launch<K, S, 3>(a, p, out, st);
    case 4: return launch<K, S, 4>(a, p, out, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace wtc
}  // namespace nct

// Rows of the partial-sum buffer for a weight cotangent of M x (cin K K)
// outputs over B * ho * wo pixels, K = ksize; the caller allocates part as (slices, M,
// cin * K * K).
extern "C" int nct_wgrad_tc_slices(int B, int ho, int wo, int M, int cin, int ksize) {
  return nct::wtc::plan(B, ho, wo, M, cin, ksize).slices;
}

// Plain C entry. g: ng parts (B, M, ho, wo); x: nx parts (B, cin, H, W)
// (pointers + 6 metadata values each, see nct::fill_parts), all bf16, any
// strides; (ksize, stride) in {(3, 1), (3, 2), (4, 2)}, pad in [0, ksize),
// (ho, wo) = ((H, W) + 2 pad - ksize) / stride + 1; part (slices, M, cin *
// ksize^2) f32 scratch (laid out (slices, M, ksize^2, cin)); out (M, cin, ksize, ksize) f32 contiguous.
extern "C" int nct_wgrad_tc(const void* const* g_ptrs, const long long* g_meta, int ng,
                            const void* const* x_ptrs, const long long* x_meta, int nx, int B, int M,
                            int cin, int H, int W, int ho, int wo, int ksize, int stride, int pad,
                            float* part, float* out, void* stream) {
  using namespace nct;
  using namespace nct::wtc;
  if (ng < 1 || ng > MAX_PARTS || nx < 1 || nx > MAX_PARTS || B < 1 || M < 1 || cin < 1 || pad < 0 ||
      pad >= ksize || stride < 1 || H + 2 * pad < ksize || W + 2 * pad < ksize ||
      ho != (H + 2 * pad - ksize) / stride + 1 || wo != (W + 2 * pad - ksize) / stride + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  fill_parts(a.g, g_ptrs, g_meta, ng);
  fill_parts(a.x, x_ptrs, x_meta, nx);
  int mg = 0, cx = 0;
  for (int i = 0; i < ng; ++i) mg += a.g[i].c, a.gvec[i] = vec_rows<2>(a.g[i]);
  for (int i = 0; i < nx; ++i) cx += a.x[i].c, a.xvec[i] = vec_rows<2>(a.x[i]);
  for (int i = 0; i < ng; ++i)
    if (a.g[i].up2) return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < nx; ++i)
    if (a.x[i].up2) return static_cast<int>(cudaErrorInvalidValue);
  if (mg != M || cx != cin) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = plan(B, ho, wo, M, cin, ksize);
  a.ng = ng, a.nx = nx, a.M = M, a.cin = cin, a.H = H, a.W = W, a.ho = ho, a.wo = wo, a.pad = pad;
  a.mb = 16 * p.mt;
  a.tiles_x = p.tiles_x, a.tiles_y = p.tiles_y, a.tiles = p.tiles, a.per = p.per;
  a.part = part;
  auto st = static_cast<cudaStream_t>(stream);
  if (ksize == 3 && stride == 1) return dispatch_mt<3, 1>(a, p, out, st);
  if (ksize == 3 && stride == 2) return dispatch_mt<3, 2>(a, p, out, st);
  if (ksize == 4 && stride == 2) return dispatch_mt<4, 2>(a, p, out, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
