// K2's thin forms (nct_conv_thin): the 3x3 pad-1 stride-1 convs of the mixed
// schedule that are too narrow for conv_tc.cu's forms, bf16 out with f32
// sums, the output rounded once:
//  * the uint8 frame's residual encoder: relu(conv3x3(x) + b) + conv1x1(x)
//    over at most 4 uint8 channels decoded as raw 0..255 values (an RGB
//    frame read through its NHWC strides), any number of output channels,
//    the weights read as stored (f32);
//  * the depth heads: bf16 parts -> fewer than 8 output channels (1 in the
//    guided net), the weights read rounded to bf16, optional bias and ReLU.
//
// Replaces nconv_tpu/ops/pallas_conv.py:_kernel (:128) in its uint8-decode
// residual form and its 1-channel head form, in bf16.
//
// Bound on the H100: bytes, both forms.
//  * The encoder writes 64 bytes (32 bf16 channels) for each 3-byte pixel it
//    reads: 57.4 MB a two-stream frame, 0.0171 ms at 3.35 TB/s. Its 60 FLOP
//    a pixel and output channel would take 0.0245 ms at the CUDA cores' f32
//    peak, above the byte bound, so it runs on the tensor cores
//    (u8_wg_kernel): a warpgroup a block, several blocks an SM, persistent;
//    each 64-pixel tile row one wgmma m64nNk16 tile (N: 32 or 64 output
//    channels a column group), K the (channel, ky, kx) products (27 at 3
//    channels, padded to 32). A is gathered into registers from the window
//    decoded to bf16 in shared memory (uint8 values are exact in bf16): a
//    lane's two GEMM rows are neighbouring pixels, so each register pair is
//    one aligned 4-byte read of the window or of its copy one pixel left.
//    B is the weights resident as three bf16 terms hi + mid + lo that sum
//    to each f32 value exactly (split3, common.cuh), so every product is the
//    f32 one; the shortcut a second accumulator over the centre tap (K = the
//    channels). The next tile's window loads into registers while a tile
//    computes. The epilogue (bias, ReLU, the shortcut, one rounding to
//    bf16) stores a lane's two pixels of a channel as one word into a
//    128-byte-swizzled stage, and one thread sends each tile row out by a
//    tensor store that runs under the next tile's work.
//  * A head reads 32-64 bf16 channels for each output value (9 FLOP a
//    byte): 77 MB of input over the frame's four heads. head_kernel streams
//    it once through shared memory: a producer warp lands CC = 2 channels of
//    a 32 x 128 tile's window at a time by one tensor copy (zeros outside
//    the image; 1.06 x the rows, 1.125 x the columns) into a ring of STAGES
//    mbarrier-guarded stages; 256 consumer threads each run the 9 taps of 4
//    pixels x 4 rows from shared memory on the CUDA cores, which bound the
//    large heads (their FMAs and bf16 unpacking, not the loads). Where the
//    tiles leave SMs idle (the small heads), a thread-block cluster of 2-8
//    blocks splits the channel chunks of a tile, and the partial sums add
//    up through distributed shared memory in rank order: no atomics, no
//    second pass, the same sums on every run; alone, a consumer stores its
//    outputs straight from its registers. Parts the tensor copies cannot
//    describe (rows not 16-byte aligned, a chunk across two parts) land by
//    the producer warp's loads.
#include <cooperative_groups.h>

#include "hopper.cuh"

namespace nct {
namespace thin {

constexpr int MAX_CIN_U8 = 4;
constexpr int MAX_CIN_HEAD = 256;

struct Args {
  CUtensorMap map[MAX_PARTS];  // the head form's parts for tensor copies: (W, H, C, B), boxes of BW x (TH + 2) x CC
  Part parts[MAX_PARTS];
  int nparts, B, H, W, cin, cout, relu;
  const void* w;     // (cout, cin, 3, 3)
  const void* wsc;   // (cout, cin): 1x1 shortcut of the residual form, or null
  const void* bias;  // (cout) or null
  int w_bf16;        // their storage type: f32 (0) or bf16 (1)
  unsigned short* out;  // (B, cout, H, W) bf16 bits, contiguous
  int out_vec;         // 1: output rows may be written as vectors (u8 form: 16 bytes; head form: 8)
  int tma;             // head form: 1, the parts land by tensor copies; 0, by the producer warp's loads
  CUtensorMap omap;    // u8 form: out for tensor stores, (W, H, cout, B), boxes of 64 pixels x N channels
  int out_tma;         // u8 form: 1, the output goes out by tensor stores
  int ks;              // head form: blocks of a cluster, each a share of the channel chunks
};

// -- the heads: a ring of channel chunks, the channel sum split across a cluster

// A block tile: TH rows of TW pixels; a consumer thread 4 adjacent pixels of
// 4 rows (32 column quads x 8 row groups). A stage holds CC channels of the
// tile's input window, rows y0 - 1 .. y0 + TH, columns x0 - 8 .. x0 + TW + 7
// (BW: the box starts on a 16-byte boundary; 1.125 x 1.06 the tile), bf16 as
// stored.
constexpr int TW = 128, TH = 32, CC = 2, BW = TW + 16, STAGES = 4;
constexpr int CONSUMERS = 256, HEAD_THREADS = CONSUMERS + 32;  // and one producer warp
constexpr int STAGE_EL = CC * (TH + 2) * BW;
constexpr int HEAD_BARS = 256;  // bytes before the stages: full[STAGES], empty[STAGES]; 128-byte aligned stages
constexpr int SMS = 132;        // the H100's

// Shared memory of head_kernel<CO>, in bytes: barriers, stages, the partial
// sums (CO x TH x TW f32, read by the cluster), the weights of the block's
// channels ([channel][tap][CO] f32).
__host__ __device__ constexpr size_t head_red() { return HEAD_BARS + STAGES * STAGE_EL * 2; }
__host__ __device__ constexpr size_t head_ws(int co) { return head_red() + static_cast<size_t>(co) * TH * TW * 4; }
__host__ __device__ constexpr size_t head_smem(int co, int chans) {
  return head_ws(co) + static_cast<size_t>(chans) * 9 * co * 4;
}

// Element i of weight p as the conv reads it: rounded to bf16 (nearest
// even), as the plain version and JAX's mixed schedule read it over bf16
// parts.
__device__ __forceinline__ float rounded_w(const Args& a, const void* p, long long i) {
  return __bfloat162float(__float2bfloat16(load_w(p, a.w_bf16, i)));
}

__device__ __forceinline__ float lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

__device__ __forceinline__ float head_out(const Args& a, float v, int co) {
  v += a.bias ? load_w(a.bias, a.w_bf16, co) : 0.f;
  return a.relu ? fmaxf(v, 0.f) : v;
}

// CO (1, 2, 4 or 8: cout padded) output channels of one tile, the channel
// chunks of cluster rank blockIdx.x % ks: the producer warp lands chunk after
// chunk into the ring (one tensor copy a chunk, or its lanes' loads), the
// consumers run the 9 taps of each channel from shared memory into
// registers. Alone (ks 1) a consumer stores its outputs; in a cluster every
// block writes its partial sums to shared memory and, after a cluster
// barrier, rank r sums every ks-th share of the tile's outputs over the ranks
// in order (distributed shared memory). The order of every sum is fixed by
// the shape, so a call is bitwise repeatable.
template <int CO>
__global__ void __launch_bounds__(HEAD_THREADS, CO <= 2 ? 2 : 1) head_kernel(const __grid_constant__ Args a) {
  namespace cg = cooperative_groups;
  NCT_DYN_SHARED(unsigned char, smem);
  const uint32_t bars = smem_u32(smem);
  const hop::Ring ring{bars, bars + 8 * STAGES, STAGES};
  unsigned short* stages = reinterpret_cast<unsigned short*>(smem + HEAD_BARS);
  float* red = reinterpret_cast<float*>(smem + head_red());
  float* ws = reinterpret_cast<float*>(smem + head_ws(CO));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ks = a.ks, rank = blockIdx.x % ks, tile = blockIdx.x / ks;
  const int tiles_x = (a.W + TW - 1) / TW, tiles_y = (a.H + TH - 1) / TH;
  const int b = tile / (tiles_x * tiles_y), rt = tile % (tiles_x * tiles_y);
  const int y0 = (rt / tiles_x) * TH, x0 = (rt % tiles_x) * TW;
  const int nchunks = (a.cin + CC - 1) / CC, per = (nchunks + ks - 1) / ks;
  const int lo_c = rank * per, n = max(0, min(nchunks, lo_c + per) - lo_c);  // this rank's chunks
  const int c_lo = lo_c * CC, c_hi = min(a.cin, (lo_c + n) * CC);
  if (tid == 0) {
    ring.init(a.tma ? 1 : 32, CONSUMERS);
    hop::mbar_init_fence();
  }
  for (int i = tid; i < (c_hi - c_lo) * 9 * CO; i += HEAD_THREADS) {
    const int co = i % CO, ct = i / CO;  // ct: (channel - c_lo) * 9 + tap
    ws[i] = co < a.cout ? rounded_w(a, a.w, (static_cast<long long>(co) * a.cin + c_lo) * 9 + ct) : 0.f;
  }
  __syncthreads();

  const int cq = tid & 31, rg = tid >> 5;  // a consumer's column quad and row group
  float acc[CO][4][4];
  if (warp == CONSUMERS / 32) {
    // -- the producer warp: chunk i into stage i % STAGES
    for (int i = 0; i < n; ++i) {
      const int c0 = (lo_c + i) * CC;
      unsigned short* st = stages + ring.stage(i) * STAGE_EL;
      if (a.tma) {
        if (lane == 0) {
          ring.acquire(i);
          int p = 0, cc = c0;
          while (p < a.nparts - 1 && cc >= a.parts[p].c) cc -= a.parts[p++].c;  // chunks do not straddle parts
          const uint32_t full = ring.full + 8 * ring.stage(i);
          hop::mbar_arrive_tx(full, STAGE_EL * 2);
          hop::tma_load_4d(smem_u32(st), &a.map[p], x0 - 8, y0 - 1, cc, b, full);
        }
      } else {
        ring.acquire(i);
        for (int e = lane; e < STAGE_EL; e += 32) {
          const int col = e % BW, row = (e / BW) % (TH + 2), c = c0 + e / (BW * (TH + 2));
          const int y = y0 - 1 + row, x = x0 - 8 + col;
          unsigned short v = 0;
          if (c < a.cin && y >= 0 && y < a.H && x >= 0 && x < a.W) {
            int cc = c;
            const Part& q = a.parts[part_of(a.parts, a.nparts, cc)];
            v = static_cast<const unsigned short*>(q.ptr)[b * q.sb + cc * q.sc + y * q.sh + x * q.sw];
          }
          st[e] = v;
        }
        ring.publish(i);
      }
    }
  } else {
    // -- consumer: pixels x0 + 4 cq + j of rows y0 + 4 rg + r; their window
    // columns 4 cq + 7 .. 4 cq + 12 of the box, read as three 4-value
    // vectors from 4 cq + 4
#pragma unroll
    for (int co = 0; co < CO; ++co)
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[co][r][j] = 0.f;
    for (int i = 0; i < n; ++i) {
      ring.take(i);
      const unsigned short* st = stages + ring.stage(i) * STAGE_EL + 4 * rg * BW + 4 * cq + 4;
      const int c0 = (lo_c + i) * CC;
#pragma unroll 1
      for (int cc = 0; cc < CC && c0 + cc < a.cin; ++cc) {
        const float* wk = ws + (c0 + cc - c_lo) * 9 * CO;
#pragma unroll
        for (int rr = 0; rr < 6; ++rr) {
          const uint2* row = reinterpret_cast<const uint2*>(st + (cc * (TH + 2) + rr) * BW);
          const uint2 u0 = row[0], u1 = row[1], u2 = row[2];
          // columns 4 cq + 4 .. 4 cq + 15; pixel j reads e[3 + j + kx]
          const float e[12] = {lo(u0.x), hi(u0.x), lo(u0.y), hi(u0.y), lo(u1.x), hi(u1.x),
                               lo(u1.y), hi(u1.y), lo(u2.x), hi(u2.x), lo(u2.y), hi(u2.y)};
          // input row rr feeds output row r = rr - ky
#pragma unroll
          for (int ky = 0; ky < 3; ++ky) {
            const int r = rr - ky;
            if (r < 0 || r >= 4) continue;
#pragma unroll
            for (int kx = 0; kx < 3; ++kx)
#pragma unroll
              for (int co = 0; co < CO; ++co) {
                const float wv = wk[(ky * 3 + kx) * CO + co];
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[co][r][j] = fmaf(e[3 + j + kx], wv, acc[co][r][j]);
              }
          }
        }
      }
      ring.release(i);
    }
    if (ks == 1) {
      // alone: the outputs straight from the registers
#pragma unroll
      for (int co = 0; co < CO; ++co) {
        if (co >= a.cout) break;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int y = y0 + 4 * rg + r, x = x0 + 4 * cq;
          if (y >= a.H || x >= a.W) continue;
          unsigned short o[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) o[j] = __bfloat16_as_ushort(__float2bfloat16(head_out(a, acc[co][r][j], co)));
          unsigned short* dst = a.out + ((static_cast<long long>(b) * a.cout + co) * a.H + y) * a.W + x;
          if (a.out_vec && x + 4 <= a.W)
            *reinterpret_cast<uint2*>(dst) = make_uint2(o[0] | o[1] << 16, o[2] | o[3] << 16);
          else
            for (int j = 0; j < 4 && x + j < a.W; ++j) dst[j] = o[j];
        }
      }
      return;
    }
#pragma unroll
    for (int co = 0; co < CO; ++co)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        *reinterpret_cast<float4*>(red + (co * TH + 4 * rg + r) * TW + 4 * cq) =
            make_float4(acc[co][r][0], acc[co][r][1], acc[co][r][2], acc[co][r][3]);
  }
  if (ks == 1) return;

  // -- the cluster's partial sums, in rank order; rank r the outputs
  // r * CONSUMERS + tid, + ks * CONSUMERS, ...
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (tid < CONSUMERS) {
    const float* parts[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) parts[k] = k < ks ? cluster.map_shared_rank(red, k) : nullptr;
    for (int e = rank * CONSUMERS + tid; e < CO * TH * TW; e += ks * CONSUMERS) {
      const int co = e / (TH * TW), yy = (e / TW) % TH, xx = e % TW;
      const int y = y0 + yy, x = x0 + xx;
      if (co >= a.cout || y >= a.H || x >= a.W) continue;
      float v = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (k < ks) v += parts[k][e];
      a.out[((static_cast<long long>(b) * a.cout + co) * a.H + y) * a.W + x] =
          __bfloat16_as_ushort(__float2bfloat16(head_out(a, v, co)));
    }
  }
  cluster.sync();  // no block leaves while another reads its partial sums
}

// Tensor copies where every part's rows are aligned 16-byte vectors and no
// chunk straddles two parts; a map a part.
inline int head_maps(Args& a) {
  a.tma = 1;
  for (int i = 0; i < a.nparts; ++i) a.tma &= vec_rows<2>(a.parts[i]) && (i == a.nparts - 1 || a.parts[i].c % CC == 0);
  for (int i = 0; a.tma && i < a.nparts; ++i) {
    const Part& q = a.parts[i];
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(a.W), static_cast<cuuint64_t>(a.H),
                                static_cast<cuuint64_t>(q.c), static_cast<cuuint64_t>(a.B)};
    const cuuint64_t strides[3] = {static_cast<cuuint64_t>(q.sh) * 2, static_cast<cuuint64_t>(q.sc) * 2,
                                   static_cast<cuuint64_t>(q.sb) * 2};
    const cuuint32_t box[4] = {BW, TH + 2, CC, 1};
    if (const int e = hop::tensor_map(&a.map[i], q.ptr, 4, dims, strides, box)) return e;
  }
  return 0;
}

template <int CO>
int launch_head(Args& a, cudaStream_t st) {
  void (*k)(const Args) = head_kernel<CO>;
  const int tiles = a.B * ((a.H + TH - 1) / TH) * ((a.W + TW - 1) / TW);
  const int nchunks = (a.cin + CC - 1) / CC;
  // a cluster splits a tile's chunks where the tiles fill at most half the
  // SMs: the most ranks (up to 8, two chunks each at least) that keep the
  // blocks within two an SM (past half the SMs a split lost to whole tiles
  // on the H100: the bf16 step's 352x1216 head, 110 tiles)
  a.ks = 1;
  if (2 * tiles <= SMS)
    while (a.ks < 8 && 4 * a.ks <= nchunks && 2 * a.ks * tiles <= 2 * SMS) a.ks *= 2;
  const int per = (nchunks + a.ks - 1) / a.ks;
  const size_t smem = head_smem(CO, per * CC);
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  int resident = 0;  // raises k's shared-memory limit, once per device
  if (const int e = resident_blocks(k, HEAD_THREADS, smem, resident)) return e;
  if (const int e = head_maps(a)) return e;
  a.out_vec = reinterpret_cast<uintptr_t>(a.out) % 8 == 0 && a.W % 4 == 0;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(static_cast<unsigned>(tiles * a.ks));
  cfg.blockDim = dim3(HEAD_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.ks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, k, a);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// -- the uint8 encoder on the tensor cores

// A block tile: TR rows of TX = 64 pixels, each row one m64 GEMM tile: warp
// w of the warpgroup its pixels 16 w .. 16 w + 15, GEMM rows l / 4 and
// l / 4 + 8 of lane l the adjacent pixels 16 w + 2 (l / 4) and + 1, so a
// lane's two outputs of a channel are one bf16 pair. The window of decoded
// input in shared memory: channel-major planes of TR + 2 rows of WS bf16,
// pixel j of a row at x0 - 1 + j (66 used). The output stage: per tile row,
// N channel rows of 64 pixels (128 bytes) in the 128-byte swizzle (16-byte
// piece p of channel row c at p ^ (c % 8)), which the tensor store reads
// and which keeps the epilogue's pair stores conflict-free.
constexpr int TX = 64, TR = 4, WS = TX + 8;

template <int CIN>
struct U8Geo {
  static constexpr int KM = (9 * CIN + 15) / 16 * 16;  // the conv's K, (channel, ky, kx), padded
  static constexpr int STEPS = KM / 16;
  static constexpr int PLANE = (TR + 2) * WS;
};

// Shared memory of u8_wg_kernel, in bytes: three bf16 terms of the weights
// (each a K-major block of N columns x KM), of the shortcut (N x 16), the
// bias (N f32), the window and its copy one pixel left (so that any two
// neighbouring pixels are one aligned 4-byte read), zeros for the padding's
// reads at every tile row, the output
// stage (1024-byte aligned at run time: the swizzle's period; TOTAL holds
// the slack).
template <int CIN, int N, bool RES>
struct U8Layout {
  using G = U8Geo<CIN>;
  static constexpr int BM = 0, BS = BM + 3 * N * G::KM * 2, BIAS = BS + (RES ? 3 * N * 16 * 2 : 0);
  static constexpr int WIN = BIAS + N * 4, WINS = WIN + CIN * G::PLANE * 2, ZERO = WINS + CIN * G::PLANE * 2;
  static constexpr int ST = ZERO + 2 * TR * WS + 16, ROW = N * 128;
  static constexpr int TOTAL = ST + 1024 + TR * ROW;
};

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// byte offset of pixels p .. in channel row c of a tile row's stage
__host__ __device__ constexpr int swz(int c, int p) { return c * 128 + ((((p >> 3) ^ c) & 7) << 4) + (p & 7) * 2; }

// relu(conv3x3(x) + bias) (+ conv1x1(x)) of N output channels (columns
// blockIdx.y * N ..) over uint8 channels, by one warpgroup: per tile row,
// D (64 pixels x N) = A (64 x KM, the decoded window gathered into registers
// by (channel, ky, kx)) x the weights' three bf16 terms, lo, mid, hi, one
// chain of wgmmas; the shortcut a second accumulator over the centre tap
// (K = the channels, padded to 16). u8 values are exact in bf16 and the terms
// sum to the f32 weight, so every product is the f32 one and only the f32
// sums differ from the CUDA cores' order. The stage goes out by one tensor
// store a tile row, issued by one thread and left to run under the next
// tile's work (or, where the output's rows are not 16-byte multiples, by
// the threads' vector stores). Blocks are persistent over the tiles of their
// column group.
template <int CIN, int N, bool RES>
__global__ void __launch_bounds__(128) u8_wg_kernel(const __grid_constant__ Args a) {
  using G = U8Geo<CIN>;
  using L = U8Layout<CIN, N, RES>;
  constexpr int KM = G::KM, STEPS = G::STEPS, R = N / 2;
  NCT_DYN_SHARED(unsigned char, smem);
  unsigned short* bm = reinterpret_cast<unsigned short*>(smem + L::BM);
  unsigned short* bsc = reinterpret_cast<unsigned short*>(smem + L::BS);
  float* bias = reinterpret_cast<float*>(smem + L::BIAS);
  unsigned short* win = reinterpret_cast<unsigned short*>(smem + L::WIN);
  unsigned short* wins = reinterpret_cast<unsigned short*>(smem + L::WINS);  // wins[e] = win[e + 1]
  const uint32_t st0 = (smem_u32(smem + L::ST) + 1023) & ~1023u;  // tile row r's stage at st0 + r ROW
  unsigned char* st = smem + (st0 - smem_u32(smem));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2, q = lane & 3;
  const int cbase = blockIdx.y * N, ncol = min(N, a.cout - cbase);

  // -- the weights' terms (K-major, k = (c, ky, kx) as OIHW stores them), the
  // shortcut's (k = c), the bias: once per block
  for (int i = tid; i < N * KM; i += 128) {
    const int n = i / KM, k = i % KM;
    unsigned short t[3] = {0, 0, 0};
    if (n < ncol && k < 9 * CIN) split3(load_w(a.w, a.w_bf16, static_cast<long long>(cbase + n) * 9 * CIN + k), t);
#pragma unroll
    for (int j = 0; j < 3; ++j) bm[j * N * KM + hop::kmajor(n, k, N)] = t[j];
  }
  if constexpr (RES) {
    for (int i = tid; i < N * 16; i += 128) {
      const int n = i / 16, k = i % 16;
      unsigned short t[3] = {0, 0, 0};
      if (n < ncol && k < CIN) split3(load_w(a.wsc, a.w_bf16, static_cast<long long>(cbase + n) * CIN + k), t);
#pragma unroll
      for (int j = 0; j < 3; ++j) bsc[j * N * 16 + hop::kmajor(n, k, N)] = t[j];
    }
  }
  for (int i = tid; i < N; i += 128) bias[i] = a.bias && i < ncol ? load_w(a.bias, a.w_bf16, cbase + i) : 0.f;
  for (int i = tid; i < (2 * TR * WS + 16) / 4; i += 128) reinterpret_cast<uint32_t*>(smem + L::ZERO)[i] = 0u;
  hop::fence_async_shared();  // the terms, written by threads, are read by wgmma

  const int m0 = 16 * warp + 2 * gid;  // the lane's pixels m0 (GEMM row gid) and m0 + 1 (row gid + 8)
  // -- the lane's A columns: for k16 step s, columns 16 s + 2 q + {0, 1, 8,
  // 9}; the shortcut's 2 q + {0, 1}. Each the byte address, at tile row 0,
  // of the 4-byte read of pixels m0 and m0 + 1 at that column's window
  // element (in the window where the element is even, in its copy one to
  // the left where odd); padding reads zeros.
  const uint32_t sbase = smem_u32(smem);
  const auto at = [&](int k, bool live) -> uint32_t {
    const int c = k / 9, tap = k % 9, o = c * G::PLANE + (tap / 3) * WS + tap % 3 + m0;
    if (!live) return sbase + L::ZERO;
    return o & 1 ? sbase + L::WINS + 2 * (o - 1) : sbase + L::WIN + 2 * o;
  };
  uint32_t off[STEPS][4], offs[2];
#pragma unroll
  for (int s = 0; s < STEPS; ++s)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = 16 * s + 2 * q + (j & 1) + 8 * (j >> 1);
      off[s][j] = at(k, k < 9 * CIN);
    }
#pragma unroll
  for (int j = 0; j < 2; ++j) offs[j] = at(9 * (2 * q + j) + 4, 2 * q + j < CIN);  // (c, 1, 1): the centre tap
  const uint64_t dm = hop::kmajor_desc(smem_u32(bm), N), ds = hop::kmajor_desc(smem_u32(bsc), N);
  const uint32_t term_m = N * KM * 2, term_s = N * 16 * 2;  // bytes between the terms' blocks

  // the channels' planes, resolved once; a thread's share of a window
  const uint8_t* plane[CIN];
  long long psb[CIN], psh[CIN], psw[CIN];
#pragma unroll
  for (int c = 0; c < CIN; ++c) {
    int p = 0, cc = c;
    while (p < a.nparts - 1 && cc >= a.parts[p].c) cc -= a.parts[p++].c;
    const Part& pt = a.parts[p];
    plane[c] = static_cast<const uint8_t*>(pt.ptr) + cc * pt.sc;
    psb[c] = pt.sb, psh[c] = pt.sh, psw[c] = pt.sw;
  }
  const int tiles_x = (a.W + TX - 1) / TX, tiles_y = (a.H + TR - 1) / TR;
  const int tiles = a.B * tiles_x * tiles_y;
  // -- the window of tile t: rows y0 - 1 .. y0 + TR, pixels x0 - 1 .. x0 + 64,
  // zero outside the image; element tid + 128 k of each channel a thread's,
  // loaded into registers a tile ahead (all loads in flight at once), then
  // decoded to bf16 (exact) into shared memory
  constexpr int WN = (TR + 2) * (TX + 2), WPT = (WN + 127) / 128;
  uint32_t pre[CIN][WPT];
  const auto fetch = [&](int t) {
    const int b = t / (tiles_x * tiles_y), r0 = t % (tiles_x * tiles_y);
    const int y0 = (r0 / tiles_x) * TR, x0 = (r0 % tiles_x) * TX;
#pragma unroll
    for (int k = 0; k < WPT; ++k) {
      const int i = tid + 128 * k, y = y0 - 1 + i / (TX + 2), x = x0 - 1 + i % (TX + 2);
      const bool in = t < tiles && i < WN && y >= 0 && y < a.H && x >= 0 && x < a.W;
#pragma unroll
      for (int c = 0; c < CIN; ++c) pre[c][k] = in ? plane[c][b * psb[c] + y * psh[c] + x * psw[c]] : 0u;
    }
  };
  fetch(blockIdx.x);
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int b = t / (tiles_x * tiles_y), r0 = t % (tiles_x * tiles_y);
    const int y0 = (r0 / tiles_x) * TR, x0 = (r0 % tiles_x) * TX;
    if (a.out_tma && tid == 0) hop::bulk_wait_read<0>();  // the previous tile's stores have read the stage
    __syncthreads();  // and its window is read
#pragma unroll
    for (int k = 0; k < WPT; ++k) {
      const int i = tid + 128 * k;
      if (i >= WN) continue;
      const int j = i % (TX + 2), e = (i / (TX + 2)) * WS + j;
#pragma unroll
      for (int c = 0; c < CIN; ++c) {
        const unsigned short v = static_cast<unsigned short>(__float_as_uint(static_cast<float>(pre[c][k])) >> 16);
        win[c * G::PLANE + e] = v;
        if (j) wins[c * G::PLANE + e - 1] = v;
      }
    }
    __syncthreads();
    fetch(t + gridDim.x);  // the next tile's, in flight while this one computes

    for (int r = 0; r < TR; ++r) {
      // a read gives a column's value at pixels m0 (low half) and m0 + 1:
      // GEMM row gid's register takes the low halves of two columns, row
      // gid + 8's the high halves
      const uint32_t rb = 2 * r * WS;
      const auto ld = [&](uint32_t addr) { return lds32(addr + rb); };
      uint32_t am[STEPS][4], as[4];
#pragma unroll
      for (int s = 0; s < STEPS; ++s) {
        const uint32_t u0 = ld(off[s][0]), u1 = ld(off[s][1]), u2 = ld(off[s][2]), u3 = ld(off[s][3]);
        am[s][0] = __byte_perm(u0, u1, 0x5410), am[s][1] = __byte_perm(u0, u1, 0x7632);
        am[s][2] = __byte_perm(u2, u3, 0x5410), am[s][3] = __byte_perm(u2, u3, 0x7632);
      }
      {
        const uint32_t u0 = ld(offs[0]), u1 = ld(offs[1]);
        as[0] = __byte_perm(u0, u1, 0x5410), as[1] = __byte_perm(u0, u1, 0x7632);
      }
      as[2] = as[3] = 0u;
      float acc[R], accs[RES ? R : 1];
      hop::wgmma_fence();
      // lo, mid, hi: the small terms first
      hop::wgmma_rs0<N>(acc, am[0], hop::desc_at(dm, 2 * term_m));
#pragma unroll
      for (int s = 1; s < STEPS; ++s) hop::wgmma_rs<N>(acc, am[s], hop::kstep(hop::desc_at(dm, 2 * term_m), N, s));
#pragma unroll
      for (int j = 1; j >= 0; --j)
#pragma unroll
        for (int s = 0; s < STEPS; ++s) hop::wgmma_rs<N>(acc, am[s], hop::kstep(hop::desc_at(dm, j * term_m), N, s));
      if constexpr (RES) {
        hop::wgmma_rs0<N>(accs, as, hop::desc_at(ds, 2 * term_s));
        hop::wgmma_rs<N>(accs, as, hop::desc_at(ds, term_s));
        hop::wgmma_rs<N>(accs, as, ds);
      }
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_regs(acc);
      if constexpr (RES) hop::fence_regs(accs);
      // bias, ReLU, the shortcut, bf16: element 4 j + e is pixel m0 + e / 2,
      // column 8 j + 2 q + e % 2; a column's two pixels one 4-byte store
      const uint32_t str = st0 + r * L::ROW;
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * q + e;
          float v0 = acc[4 * j + e] + bias[col], v1 = acc[4 * j + 2 + e] + bias[col];
          if (a.relu) v0 = fmaxf(v0, 0.f), v1 = fmaxf(v1, 0.f);
          if constexpr (RES) v0 += accs[4 * j + e], v1 += accs[4 * j + 2 + e];
          const __nv_bfloat162 pr = __floats2bfloat162_rn(v0, v1);
          *reinterpret_cast<uint32_t*>(st + (str - st0) + swz(col, m0)) = *reinterpret_cast<const uint32_t*>(&pr);
        }
    }
    if (a.out_tma) {
      hop::fence_async_shared();  // the stage, written by threads, is read by the tensor stores
      __syncthreads();
      if (tid == 0) {
        for (int r = 0; r < TR; ++r) hop::tma_store_4d(&a.omap, x0, y0 + r, cbase, b, st0 + r * L::ROW);
        hop::bulk_commit();
      }
      continue;
    }
    __syncthreads();
    // -- without tensor stores: 16-byte vectors of 8 pixels where the output allows
    for (int i = tid; i < ncol * TR * (TX / 8); i += 128) {
      const int vx = i % (TX / 8), rr = (i / (TX / 8)) % TR, col = i / (TR * (TX / 8));
      const int oy = y0 + rr, ox = x0 + 8 * vx;
      if (oy >= a.H || ox >= a.W) continue;
      const uint4 v = *reinterpret_cast<const uint4*>(st + rr * L::ROW + swz(col, 8 * vx));
      unsigned short* dst = a.out + ((static_cast<long long>(b) * a.cout + cbase + col) * a.H + oy) * a.W + ox;
      if (a.out_vec && ox + 8 <= a.W) {
        *reinterpret_cast<uint4*>(dst) = v;
      } else {
        const unsigned short* e = reinterpret_cast<const unsigned short*>(&v);
        for (int j = 0; j < 8 && ox + j < a.W; ++j) dst[j] = e[j];
      }
    }
  }
  if (a.out_tma && tid == 0) hop::bulk_wait_all();  // the stage outlives the block's last stores
}

template <int CIN, int N, bool RES>
int launch_u8(Args& a, cudaStream_t st) {
  void (*k)(const Args) = u8_wg_kernel<CIN, N, RES>;
  constexpr size_t smem = U8Layout<CIN, N, RES>::TOTAL;
  int resident = 0;  // raises k's shared-memory limit, once per device
  if (const int e = resident_blocks(k, 128, smem, resident)) return e;
  if (a.out_tma) {
    // out as (W, H, cout, B), boxes of one tile row: 64 pixels x N channels, 128-byte swizzle
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(a.W), static_cast<cuuint64_t>(a.H),
                                static_cast<cuuint64_t>(a.cout), static_cast<cuuint64_t>(a.B)};
    const cuuint64_t strides[3] = {static_cast<cuuint64_t>(a.W) * 2, static_cast<cuuint64_t>(a.H) * a.W * 2,
                                   static_cast<cuuint64_t>(a.cout) * a.H * a.W * 2};
    const cuuint32_t box[4] = {TX, 1, N, 1};
    if (const int e = hop::tensor_map(&a.omap, a.out, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B)) return e;
  }
  const int groups = (a.cout + N - 1) / N;
  const long long tiles = static_cast<long long>(a.B) * ((a.H + TR - 1) / TR) * ((a.W + TX - 1) / TX);
  const int fit = resident / groups > 1 ? resident / groups : 1;
  NCT_LAUNCH(k, dim3(static_cast<unsigned>(tiles < fit ? tiles : fit), groups), dim3(128), smem, st, a);
  return static_cast<int>(cudaGetLastError());
}

template <int CIN, bool RES>
int launch_u8_n(Args& a, cudaStream_t st) {
  return a.cout <= 32 ? launch_u8<CIN, 32, RES>(a, st) : launch_u8<CIN, 64, RES>(a, st);
}

template <bool RES>
int dispatch_u8(Args& a, cudaStream_t st) {
  switch (a.cin) {
    case 1: return launch_u8_n<1, RES>(a, st);
    case 2: return launch_u8_n<2, RES>(a, st);
    case 3: return launch_u8_n<3, RES>(a, st);
    case 4: return launch_u8_n<4, RES>(a, st);
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
    if (p.up2 || p.c < 1) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (total != cin) return static_cast<int>(cudaErrorInvalidValue);
  a.nparts = nparts;
  a.B = B, a.H = H, a.W = W, a.cin = cin, a.cout = cout, a.relu = relu;
  a.w = w, a.wsc = wsc, a.bias = bias, a.w_bf16 = w_dtype == BF16;
  a.out = static_cast<unsigned short*>(out);
  a.out_vec = reinterpret_cast<uintptr_t>(out) % 16 == 0 && W % 8 == 0;
  a.out_tma = in_dtype == U8 && a.out_vec;
  auto st = static_cast<cudaStream_t>(stream);
  if (in_dtype == U8) return res ? dispatch_u8<true>(a, st) : dispatch_u8<false>(a, st);
  switch (cout) {
    case 1: return launch_head<1>(a, st);
    case 2: return launch_head<2>(a, st);
    case 3:
    case 4: return launch_head<4>(a, st);
    default: return launch_head<8>(a, st);
  }
}
