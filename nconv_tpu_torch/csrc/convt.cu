// K3: 4x4 stride-2 pad-1 transpose convolution + bias + optional ReLU in
// f32 (the bf16 form runs on the tensor cores, conv_tc.cu),
// torch.nn.ConvTranspose2d semantics, weight (cin, cout, 4, 4):
//
//   out[co, oy, ox] = sum over ci and taps with oy = 2*iy - 1 + ky,
//                     ox = 2*ix - 1 + kx of x[ci, iy, ix] * w[ci, co, ky, kx]
//
// The input is a list of parts (UpCat's [depth | fusion] concat stays two
// tensors). Replaces the d2s_channels form of
// nconv_tpu/ops/pallas_conv.py:_kernel (reached through models/layers.py
// Basic2dTrans._phased_bhcw), which phase-stacks the output channels and
// interleaves them with selection matmuls; neither is needed where strided
// stores are native.
//
// By output parity the 2x2 output quad of input pixel (m, n) takes each of
// the 16 taps once, from the 3x3 input neighbourhood:
//
//   (2m + p, 2n + q) <- x[m - 1 + dr][n - 1 + dc] w[ky][kx], ky in {1, 3}
//   at p = 0 and {0, 2} at p = 1 (kx alike by q), dr = 2 - (ky + 1) / 2
//
// so no thread skips a tap and no warp diverges on the output parity.
//
// Bound on the H100: operations (4 cin FMAs an output, f32 CUDA cores).
// Design, output-stationary (nct::t4, the family of nct::t3 below and of
// conv.cu's convkxk_kernel):
//  * A block covers R input rows x 32 quads (2R x 64 outputs) and a group
//    of at most 32 output channels (balanced groups: UpCat's 64 in two, so
//    x is staged twice a call): warp (input row, slab of 16 channels), lane
//    (pair of quads, group of CO = 8 channels), 8 warps. Per input channel
//    a thread loads 3 x 4 x values and 16 weight rows of 8 as float4
//    broadcasts for 16 x 2 x 8 = 256 FMAs. Its registers are held to two
//    blocks an SM (128).
//  * runtime/plan_probe.py timed this plan against groups of 64 (x staged
//    once), 4 quads a thread, registers for one block an SM, half the rows
//    a block and 16-warp blocks of twice the rows; each lost in sum over
//    the calls of an f32 frame and of an f32 guided step (PERF.md).
//  * The channel loop runs over the real channels, in chunks of 8 that may
//    straddle parts (the part looked up once a staged row). x rows (from 4
//    columns before the tile: 16-byte copies where a part's rows allow,
//    else 4-byte) and the weights, as [cc * 16 + tap][co] rows (common.cuh
//    padded_row), are staged by cp.async two stages deep: chunk c + 1's
//    copies fly while chunk c's FMAs run.
//  * Bias and ReLU in the epilogue; each thread writes its 4 contiguous
//    outputs of a row as a float4 where 2W % 4 == 0, else element by
//    element.
//
// Below, a second form: the 3x3/s2/p1 transposed conv with output_padding 1
// (no bias, f32; bf16 runs on the tensor cores, conv_tc.cu), the input
// gradient of a 3x3 stride-2 conv (nct_conv_transpose3x3s2): 2x2 output
// quads over all output channels a block, g and its weights staged by
// cp.async two stages deep (nct::t3).
#include "common.cuh"

namespace nct {

namespace t4 {

constexpr int QW = 32, PX = 2, CO = 8, PGW = QW / PX, SLAB = 32 / PGW * CO, CIC = 8, MOST = 32, MAX_WARPS = 8;
constexpr int XS = 40;  // a staged x row: columns j0 - 4 .. j0 + 35, whole 16-byte vectors (the tile reads j0 - 1 .. j0 + 32)

struct Args {
  Part parts[MAX_PARTS];  // the input's channel concat, all (B, H, W)
  int vec[MAX_PARTS];     // 1: the part's rows staged as 16-byte vectors
  int nparts, B, H, W, cin, cout, relu;
  int width, wst, ns, rows;  // output channels a group, a staged weight row (slabs x slab, padded_row), slabs, input rows a block
  const float* w;            // (cin, cout, 4, 4)
  const float* bias;         // (cout) or null
  float* out;                // (B, cout, 2H, 2W), contiguous
};

// one stage: the x rows of CIC channels (the block's rows and one above and
// below), then CIC x 16 weight rows
__host__ __device__ constexpr int xsz(int rows) { return CIC * (rows + 2) * XS; }
__host__ __device__ constexpr int stage_size(int rows, int wst) { return xsz(rows) + CIC * 16 * wst; }

__global__ void __launch_bounds__(32 * MAX_WARPS, 2) convt4x4s2_kernel(const Args a) {
  NCT_DYN_SHARED(float, smem);
  const int nthr = blockDim.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slab = warp % a.ns, row = warp / a.ns, pg = lane % PGW, cg = lane / PGW;
  const int groups = (a.cout + a.width - 1) / a.width;
  const int b = blockIdx.z / groups, co0 = (blockIdx.z % groups) * a.width;
  const int co_end = co0 + a.width < a.cout ? co0 + a.width : a.cout;
  const int i0 = blockIdx.y * a.rows, j0 = blockIdx.x * QW, xr = a.rows + 2;
  const int stage_sz = stage_size(a.rows, a.wst);

  // input channels c0 .. c0 + CIC - 1 (up to cin) into stage buf
  auto stage = [&](int c0, int buf) {
    float* xs = smem + buf * stage_sz;
    float* ws = xs + xsz(a.rows);
    const int ncc = a.cin - c0 < CIC ? a.cin - c0 : CIC;
    for (int u = warp; u < ncc * xr; u += nthr / 32) {
      int c = c0 + u / xr;
      const int y = i0 - 1 + u % xr, p = part_of(a.parts, a.nparts, c);
      const Part& q = a.parts[p];
      const bool live = y >= 0 && y < a.H;
      const float* src = static_cast<const float*>(q.ptr) + (live ? b * q.sb + c * q.sc + y * q.sh : 0);
      float* drow = xs + u * XS;
      if (a.vec[p]) {  // whole vectors, in or out of the image (W % 4 == 0)
        stage_row<4>(drow, src, j0 - 4, XS / 4, a.W, live, lane);
      } else {
        for (int x = lane; x < QW + 2; x += 32) {
          const int col = j0 - 1 + x;
          const bool in = live && col >= 0 && col < a.W;
          cp_async4(smem_u32(drow + 3 + x), in ? src + col * q.sw : src, in ? 4 : 0);
        }
      }
    }
    // w[c][co][tap]: an input channel's group of width x 16 is contiguous
    for (int cc = 0; cc < ncc; ++cc) {
      const float* wc = a.w + (static_cast<long long>(c0 + cc) * a.cout + co0) * 16;
      for (int i = tid; i < a.wst * 16; i += nthr) {
        const int j = i / 16, t = i % 16;
        const bool in = co0 + j < co_end;
        cp_async4(smem_u32(ws + (cc * 16 + t) * a.wst + j), in ? wc + i : a.w, in ? 4 : 0);
      }
    }
  };

  float acc[2][2][PX][CO];  // [output row parity][output column parity][quad][channel]
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int e = 0; e < PX; ++e)
#pragma unroll
        for (int k = 0; k < CO; ++k) acc[p][q][e][k] = 0.f;

  const int wcol = slab * SLAB + cg * CO;  // the thread's first channel in a weight row
  stage(0, 0);
  cp_async_commit();
  for (int c0 = 0; c0 < a.cin; c0 += CIC) {
    const int buf = (c0 / CIC) & 1;
    cp_async_wait_all();
    __syncthreads();  // chunk c0 staged; every warp is done with the previous chunk's stage
    if (c0 + CIC < a.cin) {
      stage(c0 + CIC, buf ^ 1);
      cp_async_commit();
    }
    const float* xs = smem + buf * stage_sz + row * XS + 3 + PX * pg;
    const float* ws = smem + buf * stage_sz + xsz(a.rows) + wcol;
    const int ncc = a.cin - c0 < CIC ? a.cin - c0 : CIC;
#pragma unroll 1
    for (int cc = 0; cc < ncc; ++cc) {
      float v[3][PX + 2];  // input rows i - 1 .. i + 1 at columns j - 1 .. j + PX
#pragma unroll
      for (int d = 0; d < 3; ++d)
#pragma unroll
        for (int e = 0; e < PX + 2; ++e) v[d][e] = xs[(cc * xr + d) * XS + e];
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        // tap (ky, kx) feeds output (2i + p, 2j + q) from x[i - 1 + dr][j - 1 + dc]
        const int ky = t / 4, kx = t % 4, p = 1 - (ky & 1), q = 1 - (kx & 1);
        const int dr = 2 - (ky + 1) / 2, dc = 2 - (kx + 1) / 2;
        float wv[CO];
        load_w<CO>(ws + (cc * 16 + t) * a.wst, wv);
#pragma unroll
        for (int e = 0; e < PX; ++e)
#pragma unroll
          for (int k = 0; k < CO; ++k) acc[p][q][e][k] = fmaf(v[dr][e + dc], wv[k], acc[p][q][e][k]);
      }
    }
  }

  const int i = i0 + row, j = j0 + PX * pg;
  if (i >= a.H || j >= a.W) return;
  const int ho = 2 * a.H, wo = 2 * a.W;
  const bool vec_out = (wo & 3) == 0 && j + PX <= a.W;  // whole float4s
#pragma unroll
  for (int k = 0; k < CO; ++k) {
    const int co = co0 + wcol + k;
    if (co >= co_end) break;
    const float bias = a.bias ? a.bias[co] : 0.f;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      float o[2 * PX];  // the row's 2 PX outputs, in order
#pragma unroll
      for (int e = 0; e < PX; ++e)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float r = acc[p][q][e][k] + bias;
          o[2 * e + q] = a.relu ? fmaxf(r, 0.f) : r;
        }
      float* dst = a.out + ((static_cast<long long>(b) * a.cout + co) * ho + 2 * i + p) * wo + 2 * j;
      if (vec_out) {
#pragma unroll
        for (int e = 0; e < PX / 2; ++e)
          reinterpret_cast<float4*>(dst)[e] = float4{o[4 * e], o[4 * e + 1], o[4 * e + 2], o[4 * e + 3]};
      } else {
#pragma unroll
        for (int e = 0; e < PX; ++e)
          if (j + e < a.W) dst[2 * e] = o[2 * e], dst[2 * e + 1] = o[2 * e + 1];
      }
    }
  }
}

// The launch plan: groups of width output channels, ns slabs a group,
// rows input rows a block (ns x rows warps).
struct Plan {
  int width, ns, rows;
};

inline Plan plan_of(int cout, int groups, int rows) {
  const int width = (cout + groups - 1) / groups;
  return {width, (width + SLAB - 1) / SLAB, rows};
}

// Balanced groups of at most 32 channels, 8 warps a block.
inline Plan plan(int cout) {
  const int groups = (cout + MOST - 1) / MOST;
  return plan_of(cout, groups, MAX_WARPS / plan_of(cout, groups, 1).ns);
}

inline int run(Args& a, const Plan& p, cudaStream_t st) {
  if (p.rows < 1 || p.ns * p.rows > MAX_WARPS) return static_cast<int>(cudaErrorInvalidValue);
  a.width = p.width, a.ns = p.ns, a.rows = p.rows, a.wst = padded_row(p.ns * SLAB);
  const int threads = 32 * a.ns * a.rows;
  const size_t smem = 2 * sizeof(float) * stage_size(a.rows, a.wst);
  void (*k)(const Args) = convt4x4s2_kernel;
  int resident = 0;  // sets the kernel's shared-memory limit on this device
  if (const int e = resident_blocks(k, threads, smem, resident)) return e;
  const dim3 grid((a.W + QW - 1) / QW, (a.H + a.rows - 1) / a.rows, a.B * ((a.cout + a.width - 1) / a.width));
  NCT_LAUNCH(k, grid, dim3(threads), smem, st, a);
  return static_cast<int>(cudaGetLastError());
}

// Host side: Args from the C entry's; false if the parts do not fit (an up2
// part, channels that do not sum to cin).
inline bool args_of(Args& a, const void* const* part_ptrs, const long long* part_meta, int nparts, int B, int H,
                    int W, int cin, int cout, const float* w, const float* bias, void* out, int relu) {
  if (nparts < 1 || nparts > MAX_PARTS || B < 1 || H < 1 || W < 1 || cin < 1 || cout < 1) return false;
  fill_parts(a.parts, part_ptrs, part_meta, nparts);
  int c = 0;
  for (int i = 0; i < nparts; ++i) {
    if (a.parts[i].up2) return false;  // no caller reads an upsampled part through K3
    c += a.parts[i].c;
    a.vec[i] = W % 4 == 0 && vec_rows<4>(a.parts[i]);
  }
  a.nparts = nparts, a.B = B, a.H = H, a.W = W, a.cin = cin, a.cout = cout, a.relu = relu;
  a.w = w, a.bias = bias, a.out = static_cast<float*>(out);
  return c == cin;
}

}  // namespace t4

// ---------------------------------------------------------------------------
// 3x3/s2/p1 transposed conv, output_padding 1, no bias, weight (cin, cout,
// 3, 3) (the forward conv's OIHW kernel), f32 input and output (the mixed
// schedule's bf16 form runs on the tensor cores, conv_tc.cu's mode T3):
//
//   out[co, y, x] = sum over ci and taps with y = 2i - 1 + ky,
//                   x = 2j - 1 + kx of g[ci, i, j] * w[ci, co, ky, kx]
//
// the input cotangent (B, cout, 2h, 2w) of a 3x3 stride-2 pad-1 conv from
// its output cotangent g (B, cin, h, w). Replaces the d2s_channels form of
// nconv_tpu/ops/pallas_conv.py:_kernel that pallas_s2._s2_res_bwd
// (:115-136) runs on phase-stacked output channels. The 2x2 output quad of
// input pixel (i, j) takes 1, 2, 2 and 4 taps, the nine taps of the kernel
// once each:
//
//   (2i,   2j)   <- g[i, j] w11
//   (2i,   2j+1) <- g[i, j] w12 + g[i, j+1] w10
//   (2i+1, 2j)   <- g[i, j] w21 + g[i+1, j] w01
//   (2i+1, 2j+1) <- g[i, j] w22 + g[i, j+1] w20 + g[i+1, j] w02 + g[i+1, j+1] w00
//
// so no thread skips a tap and no warp diverges on the output parity.
//
// Bound on the H100: operations (9 x cout FMAs per g value, f32 CUDA cores).
// Design, output-stationary over all output channels:
//  * A block covers R rows x 32 columns of g (2R x 64 outputs) and all
//    output channels up to 64 (wider calls in balanced groups), so g is
//    staged once a call: warp (g row, slab of 16 channels), lane (pair of
//    quads, group of 8 channels). A thread holds PX = 2 consecutive quads x
//    CO = 8 channels: per input channel it loads 2 (PX + 1) g values and 9
//    weight rows of 8 as float4 broadcasts for 9 PX CO = 144 FMAs.
//  * g rows in chunks of 8 channels and their weights, as [cc * 9 + tap][co]
//    rows (common.cuh padded_row), staged by cp.async (16-byte copies where
//    g's rows allow) two stages deep: chunk c + 1's copies fly while chunk
//    c's FMAs run.
//  * Each thread writes its 2 PX = 4 contiguous outputs of a row as one
//    float4.
// A split of the 44x152 call's channels into more, smaller blocks, 4 x 4
// quad tiles, 16-channel chunks and 16-warp blocks all lost to this plan
// (runtime/plan_probe.py; PERF.md).
// ---------------------------------------------------------------------------

namespace t3 {

constexpr int QW = 32, PX = 2, CO = 8, PGW = QW / PX, CGW = 32 / PGW, SLAB = CGW * CO, CIC = 8, MOST = 64,
              MAX_WARPS = 8;
constexpr int GS = 36;  // a staged g row: the tile's 33 columns, in whole 16-byte vectors

struct Args {
  Part g;   // (B, cin, h, w), any strides
  int vec;  // g's rows staged as 16-byte vectors
  int B, h, w, cin, cout;
  int width, wst, ns, rows;  // output channels a group, a staged weight row (slabs x 16, padded_row), slabs, g rows a block
  const float* wt;           // (cin, cout, 3, 3)
  float* out;                // (B, cout, 2h, 2w), contiguous
};

// one stage: the g patch of CIC channels, then CIC x 9 weight rows
__host__ __device__ constexpr int gsz(int rows) { return CIC * (rows + 1) * GS; }
__host__ __device__ constexpr int stage_size(int rows, int wst) { return gsz(rows) + CIC * 9 * wst; }

__global__ void __launch_bounds__(32 * MAX_WARPS) convt3x3s2_kernel(const Args a) {
  NCT_DYN_SHARED(float, smem);
  const int nthr = blockDim.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slab = warp % a.ns, row = warp / a.ns, pg = lane % PGW, cg = lane / PGW;
  const int groups = (a.cout + a.width - 1) / a.width;
  const int b = blockIdx.z / groups, co0 = (blockIdx.z % groups) * a.width;
  const int co_end = co0 + a.width < a.cout ? co0 + a.width : a.cout;
  const int i0 = blockIdx.y * a.rows, j0 = blockIdx.x * QW, gr = a.rows + 1;
  const int stage_sz = stage_size(a.rows, a.wst);

  // input channels c0 .. c0 + CIC - 1 (up to cin) into stage buf
  auto stage = [&](int c0, int buf) {
    float* gs = smem + buf * stage_sz;
    float* ws = gs + gsz(a.rows);
    const int ncc = a.cin - c0 < CIC ? a.cin - c0 : CIC;
    const float* g = static_cast<const float*>(a.g.ptr);
    for (int u = warp; u < ncc * gr; u += nthr / 32) {
      const int c = c0 + u / gr, i = i0 + u % gr;
      const bool live = i < a.h;
      const float* src = g + (live ? b * a.g.sb + c * a.g.sc + i * a.g.sh : 0);
      float* drow = gs + u * GS;
      if (a.vec) {  // whole vectors, in or out of the image (w % 4 == 0)
        for (int v = lane; v < GS / 4; v += 32) {
          const int j = j0 + 4 * v;
          const bool in = live && j < a.w;
          cp_async16(smem_u32(drow + 4 * v), in ? src + j : src, in ? 16 : 0);
        }
      } else {
        for (int x = lane; x <= QW; x += 32) {
          const int j = j0 + x;
          const bool in = live && j < a.w;
          cp_async4(smem_u32(drow + x), in ? src + j * a.g.sw : src, in ? 4 : 0);
        }
      }
    }
    // w[c][co][tap]: an input channel's group of width x 9 is contiguous
    for (int cc = 0; cc < ncc; ++cc) {
      const float* wc = a.wt + (static_cast<long long>(c0 + cc) * a.cout + co0) * 9;
      for (int i = tid; i < a.wst * 9; i += nthr) {
        const int j = i / 9, t = i % 9;
        const bool in = co0 + j < co_end;
        cp_async4(smem_u32(ws + (cc * 9 + t) * a.wst + j), in ? wc + i : a.wt, in ? 4 : 0);
      }
    }
  };

  float acc[2][2][PX][CO];  // [output row parity][output column parity][quad][channel]
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int q = 0; q < PX; ++q)
#pragma unroll
        for (int k = 0; k < CO; ++k) acc[p][s][q][k] = 0.f;

  const int wcol = slab * SLAB + cg * CO;  // the thread's first channel in a weight row
  stage(0, 0);
  cp_async_commit();
  for (int c0 = 0; c0 < a.cin; c0 += CIC) {
    const int buf = (c0 / CIC) & 1;
    cp_async_wait_all();
    __syncthreads();  // chunk c0 staged; every warp is done with the previous chunk's stage
    if (c0 + CIC < a.cin) {
      stage(c0 + CIC, buf ^ 1);
      cp_async_commit();
    }
    const float* gs = smem + buf * stage_sz + row * GS + PX * pg;
    const float* ws = smem + buf * stage_sz + gsz(a.rows) + wcol;
    const int ncc = a.cin - c0 < CIC ? a.cin - c0 : CIC;
#pragma unroll 1
    for (int cc = 0; cc < ncc; ++cc) {
      float v[2][PX + 1];  // g rows i, i + 1 at columns j .. j + PX
#pragma unroll
      for (int d = 0; d < 2; ++d)
#pragma unroll
        for (int e = 0; e <= PX; ++e) v[d][e] = gs[(cc * gr + d) * GS + e];
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        // tap (ky, kx) feeds output (2i + py, 2j + px) from g[i + di][j + dj]:
        // py = 0 at ky = 1, else 1; di = 1 at ky = 0, else 0 (columns alike)
        const int ky = t / 3, kx = t % 3, py = ky != 1, px = kx != 1, di = ky == 0, dj = kx == 0;
        const float4* wr = reinterpret_cast<const float4*>(ws + (cc * 9 + t) * a.wst);
        float wv[CO];
#pragma unroll
        for (int k = 0; k < CO / 4; ++k) {
          const float4 w4 = wr[k];
          wv[4 * k] = w4.x, wv[4 * k + 1] = w4.y, wv[4 * k + 2] = w4.z, wv[4 * k + 3] = w4.w;
        }
#pragma unroll
        for (int q = 0; q < PX; ++q)
#pragma unroll
          for (int k = 0; k < CO; ++k) acc[py][px][q][k] = fmaf(v[di][q + dj], wv[k], acc[py][px][q][k]);
      }
    }
  }

  const int i = i0 + row, j = j0 + PX * pg;
  if (i >= a.h || j >= a.w) return;
  const int ho = 2 * a.h, wo = 2 * a.w;
  const bool vec_out = (wo & 3) == 0 && j + PX <= a.w;  // whole float4s
#pragma unroll
  for (int k = 0; k < CO; ++k) {
    const int co = co0 + wcol + k;
    if (co >= co_end) break;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      float* o = a.out + ((static_cast<long long>(b) * a.cout + co) * ho + 2 * i + p) * wo + 2 * j;
      if (vec_out) {
#pragma unroll
        for (int q = 0; q < PX; q += 2)
          *reinterpret_cast<float4*>(o + 2 * q) =
              float4{acc[p][0][q][k], acc[p][1][q][k], acc[p][0][q + 1][k], acc[p][1][q + 1][k]};
      } else {
#pragma unroll
        for (int q = 0; q < PX; ++q)
          if (j + q < a.w) o[2 * q] = acc[p][0][q][k], o[2 * q + 1] = acc[p][1][q][k];
      }
    }
  }
}

// The launch plan: groups of width output channels, ns slabs of 16 a group,
// rows g rows a block (ns x rows warps).
struct Plan {
  int width, ns, rows;
};

inline Plan plan_of(int cout, int groups, int rows) {
  const int width = (cout + groups - 1) / groups;
  return {width, (width + SLAB - 1) / SLAB, rows};
}

// Balanced groups of at most 64 channels, 8 warps a block.
inline Plan plan(int cout) {
  const int groups = (cout + MOST - 1) / MOST;
  return plan_of(cout, groups, MAX_WARPS / plan_of(cout, groups, 0).ns);
}

inline int run(Args& a, const Plan& p, cudaStream_t st) {
  if (p.rows < 1 || p.ns * p.rows > MAX_WARPS) return static_cast<int>(cudaErrorInvalidValue);
  a.width = p.width, a.ns = p.ns, a.rows = p.rows, a.wst = padded_row(p.ns * SLAB);
  const int threads = 32 * p.ns * p.rows;
  const size_t smem = 2 * sizeof(float) * stage_size(a.rows, a.wst);
  void (*k)(const Args) = convt3x3s2_kernel;
  int resident = 0;  // sets the kernel's shared-memory limit on this device
  if (const int e = resident_blocks(k, threads, smem, resident)) return e;
  const dim3 grid((a.w + QW - 1) / QW, (a.h + a.rows - 1) / a.rows, a.B * ((a.cout + a.width - 1) / a.width));
  NCT_LAUNCH(k, grid, dim3(threads), smem, st, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace t3

}  // namespace nct

// Plain C entry (nct::t4); parts: n pointers + 6 n metadata (see
// nct::fill_parts), all (B, H, W), none read upsampled, of storage type
// dtype, which must be F32 (bf16: mode 2 of nct_conv_tc), as the output.
extern "C" int nct_conv_transpose4x4s2(const void* const* part_ptrs, const long long* part_meta, int nparts,
                                       int dtype, int B, int H, int W, int cin, int cout, const float* w,
                                       const float* bias, void* out, int relu, void* stream) {
  using namespace nct;
  t4::Args a{};
  if (dtype != F32 || !t4::args_of(a, part_ptrs, part_meta, nparts, B, H, W, cin, cout, w, bias, out, relu))
    return static_cast<int>(cudaErrorInvalidValue);
  return t4::run(a, t4::plan(cout), static_cast<cudaStream_t>(stream));
}

// Plain C entry of the 3x3/s2 form (nct::t3): one input part (B, cin, h, w)
// (see nct::fill_parts) of storage type dtype, which must be F32 (bf16: mode
// 3 of nct_conv_tc), as the output (B, cout, 2h, 2w); weight (cin, cout, 3,
// 3) f32.
extern "C" int nct_conv_transpose3x3s2(const void* const* x_ptr,
                                       const long long* x_meta, int dtype,
                                       int B, int h, int w, int cin, int cout,
                                       const float* wt, void* out,
                                       void* stream) {
  using namespace nct;
  if (B < 1 || h < 1 || w < 1 || cin < 1 || cout < 1 || dtype != F32)
    return static_cast<int>(cudaErrorInvalidValue);
  t3::Args a{};
  fill_parts(&a.g, x_ptr, x_meta, 1);
  a.vec = w % 4 == 0 && vec_rows<4>(a.g);
  a.B = B, a.h = h, a.w = w, a.cin = cin, a.cout = cout, a.wt = wt, a.out = static_cast<float*>(out);
  return t3::run(a, t3::plan(cout), static_cast<cudaStream_t>(stream));
}
