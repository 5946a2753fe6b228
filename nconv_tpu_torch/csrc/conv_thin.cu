// K2's thin forms on the CUDA cores (nct_conv_thin): the 3x3 pad-1 stride-1
// convs of the mixed schedule that are too narrow for the tensor cores, bf16
// out with f32 sums, the output rounded once:
//  * the uint8 frame's residual encoder: relu(conv3x3(x) + b) + conv1x1(x)
//    over at most 4 uint8 channels decoded as raw 0..255 values (an RGB
//    frame read through its NHWC strides), any number of output channels;
//  * the depth heads: bf16 parts -> fewer than 8 output channels (1 in the
//    guided net), optional bias and ReLU.
//
// Replaces nconv_tpu/ops/pallas_conv.py:_kernel (:128) in its uint8-decode
// residual form and its 1-channel head form, in bf16.
//
// Bound on the H100: bytes. A head reads 32-64 channels for each output
// value it writes (2 * 9 * cin FLOP over 2 * cin bytes); the encoder writes
// 32 bf16 channels for each 3-byte pixel it reads. A cout-1 product would
// waste 7/8 of an MMA tile, and cin = 3 padded to k16 13/16 of it, so both
// run on the CUDA cores, designed to stream each byte through once:
//  * head_kernel: a lane owns 8 adjacent output pixels (one 16-byte bf16
//    vector) of RB rows. For each input channel it loads the RB + 2 input
//    rows of its column strip as 16-byte vectors (the W halo comes from the
//    neighbouring lanes by warp shuffle) and adds each row into the up to 3
//    output rows it touches; the channel's 9 weights are shared-memory
//    broadcasts. So each input byte leaves device memory once per strip of
//    RB rows and feeds up to 24 FMAs per 2 bytes. The 8 warps of a block
//    share out the channels of the same pixels and add their sums in
//    shared memory: a head is a few small images, and one thread walking
//    all 32-64 channels in turn left too few loads in flight to stream.
//  * u8_kernel: the input is 3 bytes a pixel, the output 64, so the loads
//    matter little and the stores and FMAs a lot. A thread owns 8 adjacent
//    output pixels of one row: it decodes its 3 x 10-pixel window of each
//    channel once into registers, then runs every output channel from the
//    weights in shared memory (broadcast reads), storing each as one
//    16-byte vector, so a warp writes 512 contiguous bytes a channel.
#include "common.cuh"

namespace nct {
namespace thin {

constexpr int PX = 8;             // output pixels per thread, along W
constexpr int THREADS = 128;      // per block of the u8 form
constexpr int HEAD_THREADS = 256;  // per block of the head form: 8 warps, each a share of the channels
constexpr int RB = 4;             // output rows per head block
constexpr int MAX_CIN_U8 = 4;
constexpr int MAX_CIN_HEAD = 256;

struct Args {
  Part parts[MAX_PARTS];
  int vec[MAX_PARTS];  // 1: rows may be read as aligned 16-byte vectors
  int nparts, B, H, W, cin, cout, relu;
  const void* w;     // (cout, cin, 3, 3)
  const void* wsc;   // (cout, cin): 1x1 shortcut of the residual form, or null
  const void* bias;  // (cout) or null
  int w_bf16;        // their storage type: f32 (0) or bf16 (1)
  int round_w;       // 1: the weights are read rounded to bf16 (bf16 parts), else as stored
  unsigned short* out;  // (B, cout, H, W) bf16 bits, contiguous
  int out_vec;         // 1: output rows may be written as 16-byte vectors
  int xg, xgp;         // 8-pixel groups of a row, and rounded up to whole warps
};

// 8 bf16 from x of an image row of part q, as raw bits in a 16-byte vector,
// zero past W.
__device__ __forceinline__ uint4 row8(const Part& q, int vec, const unsigned short* row, int x, int W) {
  if (vec && x + PX <= W) return *reinterpret_cast<const uint4*>(row + x);
  uint32_t e[PX];
#pragma unroll
  for (int j = 0; j < PX; ++j) e[j] = x + j < W ? row[(x + j) * q.sw] : 0u;
  return make_uint4(e[0] | (e[1] << 16), e[2] | (e[3] << 16), e[4] | (e[5] << 16), e[6] | (e[7] << 16));
}

// Element i of weight p as the conv reads it: rounded to bf16 (nearest
// even) over bf16 parts, as the plain version and JAX's mixed schedule read
// it; as stored over uint8 parts.
__device__ __forceinline__ float weight(const Args& a, const void* p, long long i) {
  const float v = load_w(p, a.w_bf16, i);
  return a.round_w ? __bfloat162float(__float2bfloat16(v)) : v;
}

__device__ __forceinline__ float lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// Pixels x0 .. x0 + 7 of an output row, rounded to bf16: one 16-byte store
// where the row allows it, else element by element up to W.
__device__ __forceinline__ void store8(unsigned short* dst, const float (&v)[PX], bool vec, int x0, int W) {
  unsigned short o[PX];
#pragma unroll
  for (int j = 0; j < PX; ++j) o[j] = __bfloat16_as_ushort(__float2bfloat16(v[j]));
  if (vec && x0 + PX <= W) {
    *reinterpret_cast<uint4*>(dst) =
        make_uint4(o[0] | (o[1] << 16), o[2] | (o[3] << 16), o[4] | (o[5] << 16), o[6] | (o[7] << 16));
  } else {
    for (int j = 0; j < PX && x0 + j < W; ++j) dst[j] = o[j];
  }
}

// One channel plane's RB + 2 input rows of a lane's strip: 16-byte vectors
// of pixels x0 .. x0 + 7, and the one halo pixel its neighbouring lanes'
// vectors do not hold (lane 0: x0 - 1; lane 31: x0 + 8); raw bf16 bits,
// zero outside the image.
struct HeadRows {
  uint4 v[RB + 2];
  uint32_t edge[RB + 2];
  __device__ __forceinline__ void load(const Args& a, int c, int b, int y0, int x0, bool live, int edge_x) {
    int p = 0;
    while (p < a.nparts - 1 && c >= a.parts[p].c) c -= a.parts[p++].c;
    const Part& q = a.parts[p];
    const unsigned short* plane = static_cast<const unsigned short*>(q.ptr) + b * q.sb + c * q.sc;
#pragma unroll
    for (int i = 0; i < RB + 2; ++i) {
      const int y = y0 - 1 + i;
      const bool row_in = live && y >= 0 && y < a.H;
      v[i] = row_in ? row8(q, a.vec[p], plane + y * q.sh, x0, a.W) : make_uint4(0, 0, 0, 0);
      edge[i] = (row_in && edge_x >= 0 && edge_x < a.W) ? plane[y * q.sh + edge_x * q.sw] : 0u;
    }
  }
};

// One head output channel (blockIdx.y) of a block of RB rows x 256 pixels:
// lane l of every warp owns the 8 pixels of group 32 s + l (s: the block's
// segment of the row), and warp w sums the channels w, w + WARPS, ... of
// them, its next channel's rows loading while the current one's FMAs run.
// The warps' partial sums then add up in shared memory in a fixed order.
__global__ void __launch_bounds__(HEAD_THREADS, 2) head_kernel(const Args a) {
  constexpr int WARPS = HEAD_THREADS / 32;
  __shared__ float ws[MAX_CIN_HEAD * 9];
  __shared__ float red[WARPS][RB][PX][32];
  const int co = blockIdx.y;
  for (int i = threadIdx.x; i < a.cin * 9; i += HEAD_THREADS) ws[i] = weight(a, a.w, (long long)co * a.cin * 9 + i);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int segs = a.xgp / 32, strips = (a.H + RB - 1) / RB;
  const int seg = blockIdx.x % segs, strip = (blockIdx.x / segs) % strips, b = blockIdx.x / (segs * strips);
  const int xg = seg * 32 + lane, x0 = xg * PX, y0 = strip * RB;
  const bool live = xg < a.xg;
  // the halo pixel this lane loads itself: x0 - 1 (lane 0), x0 + 8 (lane 31)
  const int edge_x = lane == 0 ? x0 - 1 : lane == 31 ? x0 + PX : -1;

  float acc[RB][PX];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int j = 0; j < PX; ++j) acc[r][j] = 0.f;

  HeadRows cur, nxt;
  if (warp < a.cin) cur.load(a, warp, b, y0, x0, live, edge_x);
  for (int c = warp; c < a.cin; c += WARPS) {
    if (c + WARPS < a.cin) nxt.load(a, c + WARPS, b, y0, x0, live, edge_x);
    float wk[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) wk[t] = ws[c * 9 + t];
#pragma unroll
    for (int i = 0; i < RB + 2; ++i) {
      // pixels x0 - 1 .. x0 + 8 of input row y0 - 1 + i
      const uint4 v = cur.v[i];
      float e[PX + 2];
      e[1] = lo(v.x), e[2] = hi(v.x), e[3] = lo(v.y), e[4] = hi(v.y);
      e[5] = lo(v.z), e[6] = hi(v.z), e[7] = lo(v.w), e[8] = hi(v.w);
      e[0] = __shfl_up_sync(0xffffffffu, e[8], 1);
      e[9] = __shfl_down_sync(0xffffffffu, e[1], 1);
      if (lane == 0) e[0] = lo(cur.edge[i]);
      if (lane == 31) e[9] = lo(cur.edge[i]);
      // input row i feeds output row r = i - ky for ky in 0..2
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        const int r = i - ky;
        if (r < 0 || r >= RB) continue;
#pragma unroll
        for (int j = 0; j < PX; ++j)
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) acc[r][j] = fmaf(e[j + kx], wk[ky * 3 + kx], acc[r][j]);
      }
    }
    cur = nxt;
  }
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int j = 0; j < PX; ++j) red[warp][r][j][lane] = acc[r][j];
  __syncthreads();

  // thread t < RB x 32: row t / 32 of lane t % 32's pixels, the warps' sums in order
  const int r = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int gx = (seg * 32 + l) * PX;
  if (r >= RB || seg * 32 + l >= a.xg || y0 + r >= a.H) return;
  const float bias = a.bias ? load_w(a.bias, a.w_bf16, co) : 0.f;
  float o[PX];
#pragma unroll
  for (int j = 0; j < PX; ++j) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) v += red[w][r][j][l];
    v += bias;
    o[j] = a.relu ? fmaxf(v, 0.f) : v;
  }
  store8(a.out + ((static_cast<long long>(b) * a.cout + co) * a.H + y0 + r) * a.W + gx, o, a.out_vec, gx, a.W);
}

// Per output channel, in shared memory: 9 * CIN taps (c, ky, kx), CIN
// shortcut weights, the bias; padded to whole float4s.
template <int CIN>
struct U8Layout {
  static constexpr int SC = 9 * CIN, BIAS = 10 * CIN, STRIDE = (10 * CIN + 1 + 3) / 4 * 4;
};

template <int CIN, bool RES>
__global__ void __launch_bounds__(THREADS) u8_kernel(const Args a) {
  using L = U8Layout<CIN>;
  NCT_DYN_SHARED(float, ws);  // (cout, L::STRIDE)
  for (int i = threadIdx.x; i < a.cout * L::STRIDE; i += THREADS) {
    const int co = i / L::STRIDE, k = i % L::STRIDE;
    float v = 0.f;
    if (k < L::SC) v = weight(a, a.w, (long long)co * 9 * CIN + k);
    else if (k < L::BIAS) v = RES ? weight(a, a.wsc, (long long)co * CIN + k - L::SC) : 0.f;
    else if (k == L::BIAS) v = a.bias ? load_w(a.bias, a.w_bf16, co) : 0.f;
    ws[i] = v;
  }
  __syncthreads();

  const long long g = (long long)blockIdx.x * THREADS + threadIdx.x;
  const int xg = static_cast<int>(g % a.xg);
  const long long rest = g / a.xg;
  const int y = static_cast<int>(rest % a.H), b = static_cast<int>(rest / a.H);
  if (b >= a.B) return;
  const int x0 = xg * PX;

  // the window: channel c, input rows y - 1 .. y + 1, pixels x0 - 1 .. x0 + 8
  float win[CIN][3][PX + 2];
  {
    int p = 0, cc = 0;
#pragma unroll
    for (int c = 0; c < CIN; ++c, ++cc) {
      if (cc == a.parts[p].c) ++p, cc = 0;
      const Part& q = a.parts[p];
      const uint8_t* plane = static_cast<const uint8_t*>(q.ptr) + b * q.sb + cc * q.sc;
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        const int yy = y - 1 + r;
        const bool row_in = yy >= 0 && yy < a.H;
        const uint8_t* row = plane + (row_in ? yy : 0) * q.sh;
#pragma unroll
        for (int j = 0; j < PX + 2; ++j) {
          const int xx = x0 - 1 + j;
          win[c][r][j] = (row_in && xx >= 0 && xx < a.W) ? static_cast<float>(row[xx * q.sw]) : 0.f;
        }
      }
    }
  }

  unsigned short* out = a.out + ((long long)b * a.cout * a.H + y) * a.W + x0;
  const long long plane_out = (long long)a.H * a.W;
  for (int co = 0; co < a.cout; ++co) {
    const float* wc = ws + co * L::STRIDE;
    float acc[PX], accs[PX];
#pragma unroll
    for (int j = 0; j < PX; ++j) acc[j] = accs[j] = 0.f;
#pragma unroll
    for (int c = 0; c < CIN; ++c)
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float wv = wc[(c * 3 + ky) * 3 + kx];
#pragma unroll
          for (int j = 0; j < PX; ++j) acc[j] = fmaf(win[c][ky][j + kx], wv, acc[j]);
        }
    if constexpr (RES) {
#pragma unroll
      for (int c = 0; c < CIN; ++c) {
        const float wv = wc[L::SC + c];
#pragma unroll
        for (int j = 0; j < PX; ++j) accs[j] = fmaf(win[c][1][j + 1], wv, accs[j]);
      }
    }
    const float bias = wc[L::BIAS];
#pragma unroll
    for (int j = 0; j < PX; ++j) {
      acc[j] = a.relu ? fmaxf(acc[j] + bias, 0.f) : acc[j] + bias;
      if constexpr (RES) acc[j] += accs[j];
    }
    store8(out + co * plane_out, acc, a.out_vec, x0, a.W);
  }
}

template <int CIN, bool RES>
int launch_u8(const Args& a, cudaStream_t st) {
  void (*k)(const Args) = u8_kernel<CIN, RES>;
  const size_t smem = sizeof(float) * a.cout * U8Layout<CIN>::STRIDE;
  int resident = 0;  // raises k's shared-memory limit, once per device
  if (const int e = resident_blocks(k, THREADS, smem, resident)) return e;
  const long long threads = (long long)a.B * a.H * a.xg;
  NCT_LAUNCH(k, dim3(static_cast<unsigned>((threads + THREADS - 1) / THREADS)), dim3(THREADS), smem, st, a);
  return static_cast<int>(cudaGetLastError());
}

template <bool RES>
int dispatch_u8(const Args& a, cudaStream_t st) {
  switch (a.cin) {
    case 1: return launch_u8<1, RES>(a, st);
    case 2: return launch_u8<2, RES>(a, st);
    case 3: return launch_u8<3, RES>(a, st);
    case 4: return launch_u8<4, RES>(a, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace thin
}  // namespace nct

// Plain C entry. parts: n pointers + 6*n metadata (see nct::fill_parts), all
// of (B, H, W) and of in_dtype: U8 (at most 4 channels; wsc, (cout, cin),
// selects the residual form relu(conv + bias) + conv1x1, which takes relu = 1)
// or BF16 (fewer than 8 output channels, at most 256 input channels, no
// shortcut). w: (cout, cin, 3, 3), bias (cout) or null, with wsc all f32
// (w_dtype 0) or all bf16 (1); over bf16 parts the weights are read rounded
// to bf16, over uint8 parts as stored; the bias as stored. out: (B, cout, H,
// W) bf16, contiguous; stride 1, pad 1. Returns cudaErrorInvalidValue for
// any other call, else cudaGetLastError() after the launch.
extern "C" int nct_conv_thin(const void* const* part_ptrs, const long long* part_meta, int nparts,
                             int in_dtype, int B, int H, int W, int cin, int cout, const void* w,
                             const void* wsc, const void* bias, int w_dtype, void* out, int relu, void* stream) {
  using namespace nct;
  using namespace nct::thin;
  const bool res = wsc != nullptr;
  if (nparts < 1 || nparts > MAX_PARTS || B < 1 || H < 1 || W < 1 || cin < 1 || cout < 1 ||
      (in_dtype == U8 && (cin > MAX_CIN_U8 || (res && !relu))) ||
      (in_dtype == BF16 && (cout >= 8 || cin > MAX_CIN_HEAD || res)) || (in_dtype != U8 && in_dtype != BF16) ||
      (w_dtype != F32 && w_dtype != BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  fill_parts(a.parts, part_ptrs, part_meta, nparts);
  int total = 0;
  for (int i = 0; i < nparts; ++i) {
    const Part& p = a.parts[i];
    total += p.c;
    a.vec[i] = p.sw == 1 && reinterpret_cast<uintptr_t>(p.ptr) % 16 == 0 && p.sb % 8 == 0 && p.sc % 8 == 0 &&
               p.sh % 8 == 0;
    if (p.up2 || p.c < 1) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (total != cin) return static_cast<int>(cudaErrorInvalidValue);
  a.nparts = nparts;
  a.B = B, a.H = H, a.W = W, a.cin = cin, a.cout = cout, a.relu = relu;
  a.w = w, a.wsc = wsc, a.bias = bias, a.w_bf16 = w_dtype == BF16, a.round_w = in_dtype == BF16;
  a.out = static_cast<unsigned short*>(out);
  a.out_vec = reinterpret_cast<uintptr_t>(out) % 16 == 0 && W % PX == 0;
  a.xg = (W + PX - 1) / PX;
  a.xgp = (a.xg + 31) / 32 * 32;
  auto st = static_cast<cudaStream_t>(stream);
  if (in_dtype == U8) return res ? dispatch_u8<true>(a, st) : dispatch_u8<false>(a, st);
  const long long blocks = (long long)B * ((H + RB - 1) / RB) * (a.xgp / 32);
  NCT_LAUNCH(head_kernel, dim3(static_cast<unsigned>(blocks), cout), dim3(HEAD_THREADS), 0, st, a);
  return static_cast<int>(cudaGetLastError());
}
