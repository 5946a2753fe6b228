// K4: two chained 3x3 pad-1 conv + bias + ReLU stages with the intermediate
// kept in shared memory:  out = relu(conv(relu(conv(x, w1) + b1), w2) + b2),
// f32 in and out, FMAs on the CUDA cores (no TF32).
//
// Replaces nconv_tpu/ops/pallas_chain.py:_chain_kernel (N = 2, the fusion
// stages' fuse_conv2 -> fuse_conv3) in f32; bf16 runs on the tensor cores
// (conv_chain_tc.cu).
//
// Bound on the H100: operations. The four chains of an f32 frame (B = 2,
// 352x1216) do 53.3 GFLOP for about 0.2 GB of x and output: 0.80 ms of FMAs
// against 0.06 ms of bytes. Fusion keeps the intermediate out of device
// memory, which is worth at most ~0.07 ms at the widest chain, so what it
// costs, the recompute of stage 1 on the halo, has to stay small. Design:
//  * A block covers TH rows x 30 columns of the output and all its
//    channels. Its stage-1 tile is the (TH + 2) x 32 intermediate pixels
//    those read, every intermediate channel, computed in one pass over x's
//    channels: chunks of CIC channels of x's (TH + 4) x 34 patch and their
//    w1 rows come by cp.async two stages deep (16-byte copies where x's rows
//    are 16-byte aligned; the image bounds tested once a staged row or
//    vector), so one chunk's copies fly while the previous chunk's FMAs run.
//    The halo costs (TH + 2) x 32 / (TH x 30) of the stage-1 FMAs: 1.33x at
//    TH = 8, 1.42x at TH = 6.
//  * Register tiles as in conv.cu's output-stationary kernel: a thread holds
//    PY rows x 4 consecutive pixels x C channels, a warp row spans 32
//    columns (8 pixel groups x 4 channel groups), so per input channel a
//    thread loads (PY + 2) x 6 staged values (as float2) once for all its
//    taps and, per tap, its C weights as broadcasts: at PY 5 and C 4, 720
//    FMAs per 30 shared-memory loads.
//  * relu(acc + b1), zero outside the image (stage 2's padding), goes to
//    dynamic shared memory as [cmid][TH + 2][32]. Stage 2 runs the same
//    register tiles over it, w2's rows streamed in chunks through the same
//    two-stage ring (the first flies while stage 1's last chunk computes),
//    then bias and ReLU. Columns 30 and 31 of a stage-2 row are computed and
//    not stored (6% of stage 2); their taps read the two values past the
//    end of their intermediate row: the next row's first two or, past the
//    last row, a zeroed guard of 4 floats, never the stages' space.
//  * cmid and cout run as 32 or 64 channels (zero weights past the real
//    ones, whose channels are neither kept nor stored); up to 64 each.
//  * Tiles (Cfg below), 8 warps each: S at TH = 8 (one block an SM at 64
//    channels, two at 32), T at TH = 6 (two blocks an SM at 64 channels:
//    more blocks for a small grid). The plan takes T where S's grid has
//    fewer blocks than SMs (the 44x152 chain of a frame), S elsewhere;
//    runtime/plan_probe.py times each against the other. Taller tiles
//    (TH = 14: 8 warps with up to 128 accumulators a thread, or 16 warps)
//    lost on every chain of a frame, by 5-60%, and S held to three blocks
//    an SM at 32 channels (4-channel chunks, 85 registers) by 7% (PERF.md);
//    they went.
#include "common.cuh"

namespace nct {
namespace ch {

// output columns a block; intermediate columns (one warp row); a thread's
// pixels; pixel groups and channel groups of a warp row; a staged x row
// (from the 4-aligned column at or before the patch's first, 34 + 0 or 2)
constexpr int TW = 30, MW = 32, PX = 4, PGW = 8, CGW = 4, IWS = 36, SMS = 132;

struct Args {
  const float* x;  // (B, cin, H, W), contiguous
  int B, H, W, cin, cmid, cout;
  int vec;               // x's rows as 16-byte vectors (W % 4 == 0, x 16-byte aligned)
  const float *w1, *b1;  // (cmid, cin, 3, 3), (cmid)
  const float *w2, *b2;  // (cout, cmid, 3, 3), (cout)
  float* out;            // (B, cout, H, W), contiguous
};

// Tile shapes: warps, intermediate rows, then (rows, channels) a thread in
// stage 1 and in stage 2, and input channels a chunk; by tile and width.
template <char T, int N>
struct Cfg;
template <>
struct Cfg<'S', 64> {
  static constexpr int NW = 8, MH = 10, PY1 = 5, C1 = 4, PY2 = 2, C2 = 8, CIC = 8;
};
template <>
struct Cfg<'S', 32> {
  static constexpr int NW = 8, MH = 10, PY1 = 5, C1 = 2, PY2 = 2, C2 = 4, CIC = 8;
};
template <>
struct Cfg<'T', 64> {
  static constexpr int NW = 8, MH = 8, PY1 = 4, C1 = 4, PY2 = 3, C2 = 4, CIC = 4;
};
template <>
struct Cfg<'T', 32> {
  static constexpr int NW = 8, MH = 8, PY1 = 4, C1 = 2, PY2 = 3, C2 = 2, CIC = 8;
};


template <class P, int N>
struct Geo : P {
  using P::C1, P::C2, P::CIC, P::MH, P::NW, P::PY1, P::PY2;
  static constexpr int TH = MH - 2, IH = MH + 2, NS1 = N / (CGW * C1), NS2 = N / (CGW * C2), WR = padded_row(N);
  static constexpr int XSZ = CIC * IH * IWS, S1 = XSZ + CIC * 9 * WR, S2 = CIC * 9 * WR;
  // the intermediate, then a guard of 4 floats (16-byte aligned stages)
  static constexpr int STAGE = S1 > S2 ? S1 : S2, MID = N * MH * MW + 4;
  static constexpr size_t SMEM = sizeof(float) * (MID + 2 * STAGE);
  static_assert(MH % PY1 == 0 && NS1 * (MH / PY1) == NW, "stage 1: NW warps of PY1 rows x 32 pixels x 4 C1 channels");
  static_assert(TH % PY2 == 0 && NS2 * (TH / PY2) == NW, "stage 2: NW warps of PY2 rows x 32 pixels x 4 C2 channels");
};

// acc += the 3x3 taps of ncc channels: src is the thread's first staged
// value (channel planes cs apart, rows rs apart, 8-byte aligned), ws its
// first weight (rows of a channel's 9 taps wr apart)
template <int PY, int C>
__device__ __forceinline__ void taps(const float* src, int cs, int rs, const float* ws, int wr, int ncc,
                                     float (&acc)[PY][PX][C]) {
#pragma unroll 1
  for (int cc = 0; cc < ncc; ++cc) {
    float seg[PY + 2][PX + 2];
#pragma unroll
    for (int r = 0; r < PY + 2; ++r)
#pragma unroll
      for (int e = 0; e < PX + 2; e += 2) {
        const float2 t = *reinterpret_cast<const float2*>(src + cc * cs + r * rs + e);
        seg[r][e] = t.x, seg[r][e + 1] = t.y;
      }
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        float wv[C];
        load_w<C>(ws + (cc * 9 + dy * 3 + dx) * wr, wv);
#pragma unroll
        for (int y = 0; y < PY; ++y)
#pragma unroll
          for (int q = 0; q < PX; ++q)
#pragma unroll
            for (int k = 0; k < C; ++k) acc[y][q][k] = fmaf(seg[dy + y][q + dx], wv[k], acc[y][q][k]);
      }
    }
  }
}

template <char T, int N>
__global__ void __launch_bounds__(32 * Cfg<T, N>::NW) chain_kernel(const Args a) {
  using G = Geo<Cfg<T, N>, N>;
  constexpr int PY1 = G::PY1, C1 = G::C1, PY2 = G::PY2, C2 = G::C2, CIC = G::CIC, MH = G::MH, IH = G::IH;
  NCT_DYN_SHARED(float, smem);  // mid [N][MH][MW], its guard, then two stages
  float* mid = smem;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pg = lane % PGW, cg = lane / PGW;
  const int b = blockIdx.z, ox0 = blockIdx.x * TW, oy0 = blockIdx.y * G::TH;
  const int xa = (ox0 - 2) & ~3, off = ox0 - 2 - xa;  // x's staged rows start at column xa; the patch at off
  const long long plane = static_cast<long long>(a.H) * a.W;
  const float* x = a.x + static_cast<long long>(b) * a.cin * plane;

  // x channels c0 .. (up to CIC) rows oy0 - 2 .. and their w1 rows
  // [cc * 9 + tap][j] into stage buf
  auto stage_x = [&](int c0, int buf) {
    float* xs = smem + G::MID + buf * G::STAGE;
    float* ws = xs + G::XSZ;
    const int ncc = a.cin - c0 < CIC ? a.cin - c0 : CIC;
    for (int u = warp; u < ncc * IH; u += G::NW) {
      const int y = oy0 - 2 + u % IH;
      const bool live = y >= 0 && y < a.H;
      const float* src = x + (c0 + u / IH) * plane + (live ? static_cast<long long>(y) * a.W : 0);
      if (a.vec)  // whole vectors, in or out of the image
        stage_row<4>(xs + u * IWS, src, xa, IWS / 4, a.W, live, lane);
      else
        stage_row<1>(xs + u * IWS, src, xa, IWS, a.W, live, lane);
    }
    for (int i = threadIdx.x; i < ncc * 9 * N; i += 32 * G::NW) {
      const int cc = i / (9 * N), r = i % (9 * N), j = r / 9, t = r % 9;
      const bool in = j < a.cmid;
      cp_async4(smem_u32(ws + (cc * 9 + t) * G::WR + j), in ? a.w1 + (static_cast<long long>(j) * a.cin + c0 + cc) * 9 + t : a.w1,
                in ? 4 : 0);
    }
  };
  // w2 rows [cc * 9 + tap][j] of intermediate channels m0 .. into stage buf
  auto stage_w2 = [&](int m0, int buf) {
    float* ws = smem + G::MID + buf * G::STAGE;
    const int ncc = a.cmid - m0 < CIC ? a.cmid - m0 : CIC;
    for (int i = threadIdx.x; i < ncc * 9 * N; i += 32 * G::NW) {
      const int cc = i / (9 * N), r = i % (9 * N), j = r / 9, t = r % 9;
      const bool in = j < a.cout;
      cp_async4(smem_u32(ws + (cc * 9 + t) * G::WR + j),
                in ? a.w2 + (static_cast<long long>(j) * a.cmid + m0 + cc) * 9 + t : a.w2, in ? 4 : 0);
    }
  };

  // stage 1: warp (row group, slab); intermediate pixel (my, mx) is image
  // (oy0 - 1 + my, ox0 - 1 + mx)
  const int s1 = warp % G::NS1, my0 = warp / G::NS1 * PY1, j0 = (s1 * CGW + cg) * C1;
  float acc1[PY1][PX][C1];
#pragma unroll
  for (int y = 0; y < PY1; ++y)
#pragma unroll
    for (int q = 0; q < PX; ++q)
#pragma unroll
      for (int k = 0; k < C1; ++k) acc1[y][q][k] = 0.f;
  const int n1 = (a.cin + CIC - 1) / CIC, n2 = (a.cmid + CIC - 1) / CIC;
  stage_x(0, 0);
  cp_async_commit();
  for (int s = 0; s < n1; ++s) {
    const int buf = s & 1;
    cp_async_wait_all();
    __syncthreads();  // chunk s staged; every warp is done with the other stage
    if (s + 1 < n1)
      stage_x((s + 1) * CIC, buf ^ 1);
    else
      stage_w2(0, buf ^ 1);  // stage 2's first chunk flies while the last one computes
    cp_async_commit();
    const float* xs = smem + G::MID + buf * G::STAGE;
    const int ncc = a.cin - s * CIC < CIC ? a.cin - s * CIC : CIC;
    taps<PY1, C1>(xs + my0 * IWS + off + PX * pg, IH * IWS, IWS, xs + G::XSZ + j0, G::WR, ncc, acc1);
  }
#pragma unroll
  for (int y = 0; y < PY1; ++y) {
    const int gy = oy0 - 1 + my0 + y;
#pragma unroll
    for (int k = 0; k < C1; ++k) {
      const int j = j0 + k;
      const float bj = j < a.cmid ? a.b1[j] : 0.f;
      float v[PX];
#pragma unroll
      for (int q = 0; q < PX; ++q) {
        const int gx = ox0 - 1 + PX * pg + q;
        const bool inside = j < a.cmid && gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
        v[q] = inside ? fmaxf(acc1[y][q][k] + bj, 0.f) : 0.f;
      }
      *reinterpret_cast<float4*>(mid + (j * MH + my0 + y) * MW + PX * pg) = float4{v[0], v[1], v[2], v[3]};
    }
  }
  if (tid < 4) mid[N * MH * MW + tid] = 0.f;  // the guard

  // stage 2 from the intermediate: warp (row group, slab)
  const int s2 = warp % G::NS2, y0 = warp / G::NS2 * PY2, co0 = (s2 * CGW + cg) * C2;
  float acc2[PY2][PX][C2];
#pragma unroll
  for (int y = 0; y < PY2; ++y)
#pragma unroll
    for (int q = 0; q < PX; ++q)
#pragma unroll
      for (int k = 0; k < C2; ++k) acc2[y][q][k] = 0.f;
  for (int s = 0; s < n2; ++s) {
    const int buf = (n1 + s) & 1;
    cp_async_wait_all();
    __syncthreads();  // w2 chunk s staged, the intermediate written
    if (s + 1 < n2) {
      stage_w2((s + 1) * CIC, buf ^ 1);
      cp_async_commit();
    }
    const int ncc = a.cmid - s * CIC < CIC ? a.cmid - s * CIC : CIC;
    taps<PY2, C2>(mid + s * CIC * MH * MW + y0 * MW + PX * pg, MH * MW, MW,
                  smem + G::MID + buf * G::STAGE + co0, G::WR, ncc, acc2);
  }

  const long long oplane = plane;
  float* out = a.out + static_cast<long long>(b) * a.cout * oplane;
#pragma unroll
  for (int y = 0; y < PY2; ++y) {
    const int oy = oy0 + y0 + y;
    if (oy >= a.H) break;
#pragma unroll
    for (int k = 0; k < C2; ++k) {
      const int co = co0 + k;
      if (co >= a.cout) break;
      const float bk = a.b2[co];
      float* o = out + co * oplane + static_cast<long long>(oy) * a.W + ox0 + PX * pg;
#pragma unroll
      for (int q = 0; q < PX; ++q)
        if (PX * pg + q < TW && ox0 + PX * pg + q < a.W) o[q] = fmaxf(acc2[y][q][k] + bk, 0.f);
    }
  }
}

// The launch plan: the tile, and the width (32 or 64) cmid and cout run as.
struct Plan {
  char tile;
  int width;
};

inline long long blocks_of(int B, int H, int W, int th) {
  return static_cast<long long>((W + TW - 1) / TW) * ((H + th - 1) / th) * B;
}

// T where S's grid has fewer blocks than the card has SMs (the 44x152
// chain of a frame at B = 2), else S.
inline Plan plan(int B, int H, int W, int cmid, int cout) {
  const int width = cmid <= 32 && cout <= 32 ? 32 : 64;
  return {blocks_of(B, H, W, Cfg<'S', 64>::MH - 2) < SMS ? 'T' : 'S', width};
}

template <char T, int N>
int launch(const Args& a, cudaStream_t st) {
  using G = Geo<Cfg<T, N>, N>;
  void (*k)(const Args) = chain_kernel<T, N>;
  int resident = 0;  // sets the kernel's shared-memory limit on this device
  if (const int e = resident_blocks(k, 32 * G::NW, G::SMEM, resident)) return e;
  const dim3 grid((a.W + TW - 1) / TW, (a.H + G::TH - 1) / G::TH, a.B);
  NCT_LAUNCH(k, grid, dim3(32 * G::NW), G::SMEM, st, a);
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int dispatch(const Args& a, char tile, cudaStream_t st) {
  switch (tile) {
    case 'S': return launch<'S', N>(a, st);
    case 'T': return launch<'T', N>(a, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Launches plan p.
inline int run(const Args& a, const Plan& p, cudaStream_t st) {
  if (a.cmid > p.width || a.cout > p.width) return static_cast<int>(cudaErrorInvalidValue);
  if (p.width == 32) return dispatch<32>(a, p.tile, st);
  if (p.width == 64) return dispatch<64>(a, p.tile, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Host side: the Args of an entry call; false if it does not fit (not f32,
// an empty shape, cmid or cout over 64).
inline bool args_of(Args& a, const void* x, int dtype, int B, int H, int W, int cin, int cmid, int cout,
                    const float* w1, const float* b1, const float* w2, const float* b2, void* out) {
  if (dtype != F32 || B < 1 || H < 1 || W < 1 || cin < 1 || cmid < 1 || cout < 1 || cmid > 64 || cout > 64)
    return false;
  a = Args{static_cast<const float*>(x), B, H, W, cin, cmid, cout, 0, w1, b1, w2, b2, static_cast<float*>(out)};
  a.vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  return true;
}

}  // namespace ch
}  // namespace nct

// Plain C entry; f32 x, intermediate and output (the bf16 chain runs on the
// tensor cores, conv_chain_tc.cu); cmid and cout up to 64.
extern "C" int nct_conv_chain2(const void* x, int dtype, int B, int H, int W, int cin, int cmid, int cout,
                               const float* w1, const float* b1, const float* w2, const float* b2, void* out,
                               void* stream) {
  using namespace nct;
  ch::Args a{};
  if (!ch::args_of(a, x, dtype, B, H, W, cin, cmid, cout, w1, b1, w2, b2, out))
    return static_cast<int>(cudaErrorInvalidValue);
  return ch::run(a, ch::plan(B, H, W, cmid, cout), static_cast<cudaStream_t>(stream));
}
