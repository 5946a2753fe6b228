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
// Bound on the H100, by form (the step-1 net at 352x1216, B = 2):
//  * 5x5 and 3x3 at 8 output channels and 8 or 16 input channels (nconv2-6):
//    operations. A tap does 16 FMAs (nomin and denom of 8 channels) per
//    staged (d, c) pair: nconv2 does 5.5 GFLOP for 123 MB, 44 FLOP/B, above
//    the f32 ridge of 20.
//  * 1x1 (nconv7, 8 -> 1 with the crop) and cin 1 (nconv1, 1 -> 8, 5x5):
//    bytes. nconv7 reads 55 MB for 27 MFLOP; nconv1 writes 55 MB of out and
//    conf for 0.7 GFLOP.
// Design:
//  * Tiled form (every K; the plan's choice but for the unpooled 1x1): a
//    block covers ROWS x 32 output pixels, 8 pixel groups of 4 a row; a
//    thread holds 4 consecutive pixels x CO output channels x {nomin,
//    denom}. At 8 output channels CO = 2 (Q: four threads a pixel group, 16
//    accumulators, 44-48 registers, 32 warps an SM) in tiles of 8 rows (the
//    5x5 halo re-read 1.69x, against 2.25x at 32 x 4); at one, CO = 1 (T)
//    in tiles of 16. What holds the kernel back is warps in flight, not
//    loads per FMA: at 8 output channels, all of them a thread (128
//    registers, 16 warps an SM) lost to 4 (80 registers, 24 warps) by 10%,
//    4 to Q by 1-8% on every path, 8 pixels x 8 channels a thread (4 warps
//    an SM) by 1.6x, and Q in tiles of 4 rows to 8 (PERF.md); they went.
//  * The whole positive weight, [c][tap][cout] (at most 6.4 KB on the
//    step-1 net), is staged once a block; the channel loop stops at cin, so
//    nconv1 does the FMAs of one channel, not of 8.
//  * d and c come in chunks of 4 channels by cp.async, two stages deep: the
//    part of a staged row, and for an up2 part its half-resolution row, are
//    looked up once a row. A row starts `pad` columns before the tile, which
//    keeps every thread's reads 16-byte aligned (float4) and a
//    quarter-warp's on one 128-byte line; it is copied as 16-byte pieces
//    where its start is 16-byte aligned (pad 0), as 8-byte ones where
//    8-byte aligned (pad 2), else, and for an up2 part, element by element.
//  * Per input channel and kernel row a thread loads the 4 + K - 1 values of
//    d and of c its taps span (float4s), forms d * c once in registers, and
//    reuses them across the K taps of the row, each tap's CO weights read as
//    one broadcast: at K 5 and CO 2, 400 FMAs per 45 shared-memory loads.
//  * The pooled pair is formed from registers (horizontal pairs) and shared
//    memory (vertical pairs, through the stages' space), so the
//    full-resolution outputs are never read back; floor mode, and the tile
//    starts on even rows and columns, so every window lies in one block.
//  * Direct form for the unpooled 1x1 (nconv7): one output pixel a thread,
//    d and c read once each, 4-byte loads that a warp coalesces into whole
//    128-byte lines (nconv7 reads its input one column off its output, pad
//    1, so there is no 16-byte alignment to use); the weights from shared
//    memory. It beats the tiled form there by 1.3x.
//  * The epilogue is nomin / (denom + eps) + bias and denom / ksum, as the
//    plain version computes it. Each plan branch is timed against the tiles
//    it displaces by runtime/plan_probe.py (PERF.md).
#include "common.cuh"

namespace nct {
namespace nc {

// output columns a block; input channels a stage; most threads of a block
constexpr int TW = 32, CIC = 4, MAX_THREADS = 256;

struct Args {
  Part dparts[2], cparts[2];
  int nparts, B, H, W, cin, ho, wo, pad;  // input (y, x) = (oy - pad + ky, ...)
  float eps;
  const float* w;     // (COUT, cin, K, K), already positive
  const float* bias;  // (COUT)
  const float* ksum;  // (COUT): sum of w over (cin, K, K)
  float *out, *conf;    // (B, COUT, ho, wo)
  float *pout, *pconf;  // (B, COUT, ho / 2, wo / 2) when pooling
};

// a thread's PX consecutive pixels, PGW threads a row
constexpr int PX = 4, PGW = TW / PX;

// The tiled form by output channels: at 8, 2 of them a thread (Q) in tiles
// of 8 rows; at 1, all of it (T) in tiles of 16.
template <int COUT>
struct Tile {
  static constexpr char FORM = COUT == 8 ? 'Q' : 'T';
  static constexpr int CO = COUT == 8 ? 2 : COUT, ROWS = COUT == 8 ? 8 : 16, THREADS = PGW * COUT / CO * ROWS;
  static_assert(ROWS % 2 == 0 && THREADS <= MAX_THREADS, "even rows (pooling); a block's threads");
};

template <int K>
struct Geo {
  // a staged row: the tile's 32 + K - 1 input columns, 4-aligned; the
  // values a thread's taps span in it, and the float4s that cover them
  static constexpr int IW = TW + K - 1, IWS = (IW + 3) / 4 * 4, SEG = PX + K - 1, NV = (SEG + 3) / 4;
  static_assert(PX * (PGW - 1) + 4 * NV <= IWS, "a thread's float4s stay in its row");
  static __host__ __device__ constexpr int ih(int rows) { return rows + K - 1; }
  // one stage: CIC channels of d, then of c
  static __host__ __device__ constexpr int plane(int rows) { return ih(rows) * IWS; }
  static __host__ __device__ constexpr int stage(int rows) { return 2 * CIC * plane(rows); }
};

// floats of the staged weight, rounded up to whole float4s
__host__ __device__ inline int wsize(int cin, int kk, int cout) { return (cin * kk * cout + 3) / 4 * 4; }

// the whole weight into shared memory: ws[(c * KK + t) * COUT + j] = w[j][c][t]
template <int KK, int COUT>
__device__ __forceinline__ void stage_weights(const Args& a, float* ws) {
  for (int i = threadIdx.x; i < a.cin * KK * COUT; i += blockDim.x)
    cp_async4(smem_u32(ws + i), a.w + static_cast<long long>(i % COUT) * a.cin * KK + i / COUT, 4);
}

// Tile<COUT>::CO of the COUT output channels a thread (COUT / CO threads a
// pixel group), Tile<COUT>::ROWS output rows a block
template <int K, int COUT, bool POOL>
__global__ void __launch_bounds__(MAX_THREADS) nconv_kernel(const Args a) {
  using G = Geo<K>;
  constexpr int KK = K * K, CO = Tile<COUT>::CO, ROWS = Tile<COUT>::ROWS, NG = COUT / CO;
  NCT_DYN_SHARED(float, smem);  // the weight, then two stages
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int pg = tid % PGW, j0 = tid / PGW % NG * CO, row = tid / (PGW * NG);
  const int b = blockIdx.z, xb = blockIdx.x * TW, yb = blockIdx.y * ROWS;
  const int ix0 = xb - a.pad, iy0 = yb - a.pad;
  constexpr int ih = G::ih(ROWS), plane = G::plane(ROWS);
  float* ws = smem;
  float* stages = smem + wsize(a.cin, KK, COUT);

  // input channels c0 .. c0 + CIC - 1 (up to cin) of d and c into stage buf
  auto stage = [&](int c0, int buf) {
    float* xd = stages + buf * G::stage(ROWS);
    float* xc = xd + CIC * plane;
    const int ncc = a.cin - c0 < CIC ? a.cin - c0 : CIC;
    for (int u = warp; u < ncc * ih; u += nwarps) {
      int c = c0 + u / ih;
      const int y = iy0 + u % ih;
      const int p = part_of(a.dparts, a.nparts, c);
      const Part& q = a.dparts[p];  // d and c parts share their strides
      const bool live = y >= 0 && y < a.H;
      const long long base = live ? b * q.sb + c * q.sc + (q.up2 ? y >> 1 : y) * q.sh : 0;
      const float* sd = static_cast<const float*>(q.ptr) + base;
      const float* sc = static_cast<const float*>(a.cparts[p].ptr) + base;
      float* dd = xd + u * G::IWS;
      float* dc = xc + u * G::IWS;
      // a full-resolution row whose tile start is 16- or 8-byte aligned in
      // both tensors: whole vectors, each in or out of the image
      const uintptr_t at = (reinterpret_cast<uintptr_t>(sd) | reinterpret_cast<uintptr_t>(sc)) + 4u * ix0;
      const int vec = q.up2 || q.sw != 1 ? 1 : (at & 15) == 0 && (ix0 & 3) == 0 && (a.W & 3) == 0 ? 4
                                             : (at & 7) == 0 && (ix0 & 1) == 0 && (a.W & 1) == 0 ? 2 : 1;
      if (vec == 4) {
        stage_row<4>(dd, sd, ix0, G::IWS / 4, a.W, live, lane);
        stage_row<4>(dc, sc, ix0, G::IWS / 4, a.W, live, lane);
      } else if (vec == 2) {
        stage_row<2>(dd, sd, ix0, G::IWS / 2, a.W, live, lane);
        stage_row<2>(dc, sc, ix0, G::IWS / 2, a.W, live, lane);
      } else {
        for (int e = lane; e < G::IW; e += 32) {
          const int x = ix0 + e;
          const bool in = live && x >= 0 && x < a.W;
          const long long o = in ? (q.up2 ? x >> 1 : x) * q.sw : 0;
          cp_async4(smem_u32(dd + e), sd + o, in ? 4 : 0);
          cp_async4(smem_u32(dc + e), sc + o, in ? 4 : 0);
        }
      }
    }
  };

  float nom[PX][CO], den[PX][CO];
#pragma unroll
  for (int q = 0; q < PX; ++q)
#pragma unroll
    for (int j = 0; j < CO; ++j) nom[q][j] = den[q][j] = 0.f;

  stage_weights<KK, COUT>(a, ws);
  stage(0, 0);
  cp_async_commit();
  for (int c0 = 0; c0 < a.cin; c0 += CIC) {
    const int buf = (c0 / CIC) & 1;
    cp_async_wait_all();
    __syncthreads();  // chunk c0 staged; every warp is done with the other stage
    if (c0 + CIC < a.cin) {  // the next chunk's copies fly while this chunk's FMAs run
      stage(c0 + CIC, buf ^ 1);
      cp_async_commit();
    }
    const float* xd = stages + buf * G::stage(ROWS) + row * G::IWS + PX * pg;
    const float* xc = xd + CIC * plane;
    const int ncc = a.cin - c0 < CIC ? a.cin - c0 : CIC;
#pragma unroll 1
    for (int cc = 0; cc < ncc; ++cc) {
      const float* wc = ws + (c0 + cc) * KK * COUT + j0;
#pragma unroll
      for (int dy = 0; dy < K; ++dy) {
        float d[4 * G::NV], c[4 * G::NV];
#pragma unroll
        for (int v = 0; v < G::NV; ++v) {
          const float4 td = reinterpret_cast<const float4*>(xd + cc * plane + dy * G::IWS)[v];
          const float4 tc = reinterpret_cast<const float4*>(xc + cc * plane + dy * G::IWS)[v];
          d[4 * v] = td.x, d[4 * v + 1] = td.y, d[4 * v + 2] = td.z, d[4 * v + 3] = td.w;
          c[4 * v] = tc.x, c[4 * v + 1] = tc.y, c[4 * v + 2] = tc.z, c[4 * v + 3] = tc.w;
        }
        float dc[G::SEG];
#pragma unroll
        for (int e = 0; e < G::SEG; ++e) dc[e] = d[e] * c[e];
#pragma unroll
        for (int dx = 0; dx < K; ++dx) {
          float wv[CO];
          load_w<CO>(wc + (dy * K + dx) * COUT, wv);
#pragma unroll
          for (int q = 0; q < PX; ++q)
#pragma unroll
            for (int j = 0; j < CO; ++j) {
              nom[q][j] = fmaf(dc[q + dx], wv[j], nom[q][j]);
              den[q][j] = fmaf(c[q + dx], wv[j], den[q][j]);
            }
        }
      }
    }
  }

  // nom, den become out, conf
#pragma unroll
  for (int j = 0; j < CO; ++j) {
    const float bj = a.bias[j0 + j], kj = a.ksum[j0 + j];
#pragma unroll
    for (int q = 0; q < PX; ++q) {
      nom[q][j] = nom[q][j] / (den[q][j] + a.eps) + bj;
      den[q][j] = den[q][j] / kj;
    }
  }
  const int oy = yb + row, ox = xb + PX * pg;
  if (oy < a.ho) {
    const bool vec = (a.wo & 3) == 0 && ox + PX <= a.wo;
#pragma unroll
    for (int j = 0; j < CO; ++j) {
      const long long i = ((static_cast<long long>(b) * COUT + j0 + j) * a.ho + oy) * a.wo + ox;
      if (vec) {
        *reinterpret_cast<float4*>(a.out + i) = float4{nom[0][j], nom[1][j], nom[2][j], nom[3][j]};
        *reinterpret_cast<float4*>(a.conf + i) = float4{den[0][j], den[1][j], den[2][j], den[3][j]};
      } else {
#pragma unroll
        for (int q = 0; q < PX; ++q)
          if (ox + q < a.wo) a.out[i + q] = nom[q][j], a.conf[i + q] = den[q][j];
      }
    }
  }
  if constexpr (POOL) {
    // floor-mode 2x2/s2: an odd row's horizontal maxima go through shared
    // memory to the even row above it
    constexpr int HW = TW / 2;
    constexpr int hr = ROWS / 2;
    const int pho = a.ho / 2, pwo = a.wo / 2;
    float* hp = stages;  // [2][COUT][ROWS / 2][HW]
    __syncthreads();     // every warp is done with the stages
    if (row & 1) {
#pragma unroll
      for (int j = 0; j < CO; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = ((j0 + j) * hr + row / 2) * HW + 2 * pg + h;
          hp[i] = fmaxf(nom[2 * h][j], nom[2 * h + 1][j]);
          hp[COUT * hr * HW + i] = fmaxf(den[2 * h][j], den[2 * h + 1][j]);
        }
    }
    __syncthreads();
    const int py = yb / 2 + row / 2;
    if (!(row & 1) && py < pho) {
#pragma unroll
      for (int j = 0; j < CO; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int px = xb / 2 + 2 * pg + h;
          if (px >= pwo) continue;
          const int i = ((j0 + j) * hr + row / 2) * HW + 2 * pg + h;
          const long long o = ((static_cast<long long>(b) * COUT + j0 + j) * pho + py) * pwo + px;
          a.pout[o] = fmaxf(fmaxf(nom[2 * h][j], nom[2 * h + 1][j]), hp[i]);
          a.pconf[o] = fmaxf(fmaxf(den[2 * h][j], den[2 * h + 1][j]), hp[COUT * hr * HW + i]);
        }
    }
  }
}

// The unpooled 1x1 form: one output pixel a thread.
template <int COUT>
__global__ void __launch_bounds__(MAX_THREADS) nconv1x1_kernel(const Args a) {
  NCT_DYN_SHARED(float, ws);  // [c][COUT]
  stage_weights<1, COUT>(a, ws);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  const long long n = static_cast<long long>(a.B) * a.ho * a.wo;
  const long long i = static_cast<long long>(blockIdx.x) * MAX_THREADS + threadIdx.x;
  if (i >= n) return;
  const int ox = static_cast<int>(i % a.wo), oy = static_cast<int>(i / a.wo % a.ho);
  const int b = static_cast<int>(i / (static_cast<long long>(a.wo) * a.ho));
  const int y = oy - a.pad, x = ox - a.pad;
  float nom[COUT], den[COUT];
#pragma unroll
  for (int j = 0; j < COUT; ++j) nom[j] = den[j] = 0.f;
  if (y >= 0 && y < a.H && x >= 0 && x < a.W) {
    for (int c0 = 0; c0 < a.cin; ++c0) {
      int c = c0;
      const int p = part_of(a.dparts, a.nparts, c);
      const Part& q = a.dparts[p];
      const long long o = b * q.sb + c * q.sc + (q.up2 ? y >> 1 : y) * q.sh + (q.up2 ? x >> 1 : x) * q.sw;
      const float d = static_cast<const float*>(q.ptr)[o], cf = static_cast<const float*>(a.cparts[p].ptr)[o];
      const float dc = d * cf;
#pragma unroll
      for (int j = 0; j < COUT; ++j) {
        nom[j] = fmaf(dc, ws[c0 * COUT + j], nom[j]);
        den[j] = fmaf(cf, ws[c0 * COUT + j], den[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < COUT; ++j) {
    const long long o = ((static_cast<long long>(b) * COUT + j) * a.ho + oy) * a.wo + ox;
    a.out[o] = nom[j] / (den[j] + a.eps) + a.bias[j];
    a.conf[o] = den[j] / a.ksum[j];
  }
}

// The launch plan: the direct form (D) for an unpooled 1x1, else the
// tiled form of the output channels (Tile: Q at 8, T at 1).
inline char plan(int ksize, int cout, bool pool) {
  if (ksize == 1 && !pool) return 'D';
  return cout == 8 ? Tile<8>::FORM : Tile<1>::FORM;
}

template <int K, int COUT, bool POOL>
int launch_tiled(Args& a, cudaStream_t st) {
  using T = Tile<COUT>;
  void (*k)(const Args) = nconv_kernel<K, COUT, POOL>;
  const size_t smem = sizeof(float) * (wsize(a.cin, K * K, COUT) + 2 * Geo<K>::stage(T::ROWS));
  int resident = 0;  // sets the kernel's shared-memory limit on this device
  if (const int e = resident_blocks(k, T::THREADS, smem, resident)) return e;
  const dim3 grid((a.wo + TW - 1) / TW, (a.ho + T::ROWS - 1) / T::ROWS, a.B);
  NCT_LAUNCH(k, grid, dim3(T::THREADS), smem, st, a);
  return static_cast<int>(cudaGetLastError());
}

template <int COUT>
int launch_direct(Args& a, cudaStream_t st) {
  void (*k)(const Args) = nconv1x1_kernel<COUT>;
  const size_t smem = sizeof(float) * wsize(a.cin, 1, COUT);
  int resident = 0;
  if (const int e = resident_blocks(k, MAX_THREADS, smem, resident)) return e;
  const long long n = static_cast<long long>(a.B) * a.ho * a.wo;
  NCT_LAUNCH(k, dim3(static_cast<unsigned>((n + MAX_THREADS - 1) / MAX_THREADS)), dim3(MAX_THREADS), smem, st, a);
  return static_cast<int>(cudaGetLastError());
}

template <int K, int COUT>
int dispatch(Args& a, char form, bool pool, cudaStream_t st) {
  if (form == 'D') {
    if (K != 1 || pool) return static_cast<int>(cudaErrorInvalidValue);
    return launch_direct<COUT>(a, st);
  }
  if (form == Tile<COUT>::FORM)
    return pool ? launch_tiled<K, COUT, true>(a, st) : launch_tiled<K, COUT, false>(a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Launches form (the plan's, or another the probe times) at (ksize, cout).
inline int run(Args& a, char form, int ksize, int cout, bool pool, cudaStream_t st) {
  if (cout == 8) {
    switch (ksize) {
      case 1: return dispatch<1, 8>(a, form, pool, st);
      case 3: return dispatch<3, 8>(a, form, pool, st);
      case 5: return dispatch<5, 8>(a, form, pool, st);
    }
  } else if (cout == 1) {
    switch (ksize) {
      case 1: return dispatch<1, 1>(a, form, pool, st);
      case 3: return dispatch<3, 1>(a, form, pool, st);
      case 5: return dispatch<5, 1>(a, form, pool, st);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Host side: the Args of an entry call; false if it does not fit.
inline bool args_of(Args& a, const void* const* d_ptrs, const void* const* c_ptrs, const long long* part_meta,
                    int nparts, int B, int H, int W, int cin, int ho, int wo, int pad, float eps, const float* w,
                    const float* bias, const float* ksum, float* out, float* conf, float* pout, float* pconf) {
  if (nparts < 1 || nparts > 2 || B < 1 || cin < 1 || ho < 1 || wo < 1) return false;
  fill_parts(a.dparts, d_ptrs, part_meta, nparts);
  fill_parts(a.cparts, c_ptrs, part_meta, nparts);
  a.nparts = nparts;
  a.B = B, a.H = H, a.W = W, a.cin = cin, a.ho = ho, a.wo = wo, a.pad = pad;
  a.eps = eps, a.w = w, a.bias = bias, a.ksum = ksum;
  a.out = out, a.conf = conf, a.pout = pout, a.pconf = pconf;
  return true;
}

}  // namespace nc
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
  nc::Args a{};
  if (!nc::args_of(a, d_ptrs, c_ptrs, part_meta, nparts, B, H, W, cin, ho, wo, pad, eps, w, bias, ksum, out, conf,
                   pout, pconf))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool pool = pout != nullptr;
  return nc::run(a, nc::plan(ksize, cout, pool), ksize, cout, pool, static_cast<cudaStream_t>(stream));
}
