// K4 in bf16 on the tensor cores (nct_conv_chain_tc): two chained 3x3 pad-1
// conv + bias + ReLU stages, out = relu(conv(relu(conv(x, w1) + b1), w2) +
// b2), with the intermediate kept in shared memory, bf16 in and out with f32
// sums. The f32 chain stays on the CUDA cores (chain.cu).
//
// Replaces nconv_tpu/ops/pallas_chain.py:_chain_kernel (:169) in its bf16
// two-stage form (the mixed schedule's fuse_conv2 -> fuse_conv3).
//
// Bound on the H100: at 32-64 channels each stage does 2 * 9 * cmid FLOP
// per byte-pair it reads, near the card's bf16 ridge, so both the bytes and
// the tensor-core issue count; two separate convs would add the intermediate's
// write and read (2 x 57 MB at full resolution and 32 channels). Per tile of
// TH x TW = 8 x 16 output pixels, on conv_tc.cu's Hopper mainloop (the input
// staged channels-last, transposed on the way in from NCHW; wgmma m64nNk16
// with A from registers by ldmatrix and B from the resident weights through
// descriptors; per-tap partial sums, each started afresh and joined to the
// total with one rounded add; persistent blocks):
//  1. a producer warpgroup stages the input tile with a 2-pixel halo,
//     channels-last bf16, zero outside the image, into a ring of two stages
//     (one where the 64-channel weights leave no room), each guarded by a
//     pair of mbarriers;
//  2. stage 1 as a GEMM over the intermediate tile with its 1-pixel halo,
//     (TH + 2) x (TW + 2) pixels taken 64 at a time in row-major order (an
//     A row is any pixel, by its lane's ldmatrix address, so the 18-wide
//     rows waste no GEMM rows but the last tile's), a tap's three m-tiles
//     issued as one group where registers allow, so a tap waits once, not
//     three times; after its last read of the input stage the consumer
//     hands it back;
//  3. bias, ReLU, one rounding to bf16 and zero outside the image (stage 2's
//     padding) into shared memory, channels-last;
//  4. stage 2 as a GEMM from shared memory by every output channel;
//  5. the epilogue as conv_tc's: bias, ReLU, bf16, staged (one stage per
//     consumer) so the NCHW stores are 16-byte vectors.
// Two consumer warpgroups, in one of two forms. At cmid and cout 32 and
// cin <= 64 (the frame's full-resolution chains) each owns every other
// tile of the block, both stages at full width, with its own input stage,
// intermediate and output stage: the two consumers' tap latencies overlap
// and they never wait for each other (at these widths a tap's time is
// mostly the wgmma's latency; sharing tiles, the frame's two 32-channel
// chains took 1.19x and 1.16x as long on the H100).
// Otherwise they share a tile: stage 1 half the intermediate channels each,
// stage 2 4 output rows each, meeting at a named barrier twice a tile (the
// intermediate whole; the intermediate read). setmaxnreg leaves the
// producer 104 registers and gives the consumers 200. Both
// stages' weights stay resident (2 x 9 x 64 x 64 bf16 = 147 KB at 64
// channels, K-major without padding): stage 1 computes 180 intermediate
// pixels (192 GEMM rows) for 128 outputs, a halo recompute of 1.41x (1.5x
// in GEMM rows) on stage 1 and none on stage 2.
#include "hopper.cuh"

namespace nct {
namespace chain_tc {

constexpr int TH = 8, TW = 16;            // output tile
constexpr int MH = TH + 2, MW = TW + 2;   // intermediate tile
constexpr int MP = MH * MW;               // its pixels
constexpr int IH = TH + 4, IW = TW + 4;   // input tile
constexpr int G = 4;                      // 8-pixel groups loaded per input row, from ox0 - 8
constexpr int THREADS = 384;              // a producer and two consumer warpgroups
// registers a thread: 168 at launch (one block an SM); setmaxnreg leaves the
// producer 104 and gives the consumers 200 (stage 1's three m-tiles, stage
// 2's two partial sums)
constexpr int LREG = 168, PREG = 104, CREG = 200;
static_assert(128 * (PREG + 2 * CREG) <= THREADS * LREG, "the consumers' registers come from the producer's");
constexpr int MT1 = 3;                    // stage-1 m64 tiles: 192 >= MP GEMM rows
constexpr int OS = 4 * TW + 8;            // a consumer's output stage: 4 rows per column, padded
constexpr int KMAX2 = 4;                  // k16 steps a stage-2 tap, at most: cmid <= 64
static_assert(MT1 * 64 >= MP, "stage-1 m-tiles cover the intermediate tile");

struct Args {
  const unsigned short* x;  // (B, cin, H, W) bf16 bits, contiguous
  int B, H, W, cin, cmid, cout;
  int kc1;           // cin rounded up to 16
  int cmidp, coutp;  // cmid and cout rounded up to 32 or 64: zero weights past them
  int cps1, cps2;    // shared-memory row, bf16, of an input pixel (kc1 + 8), a mid pixel (cmidp + 8)
  const void *w1, *b1, *w2, *b2;  // (cmid, cin, 3, 3), (cmid), (cout, cmid, 3, 3), (cout)
  int w_bf16;                      // their storage type: f32 (0) or bf16 (1)
  unsigned short* out;             // (B, cout, H, W) bf16 bits, contiguous
  int vec;                         // 1: x's rows may be read as aligned 16-byte vectors
  int out_vec;                     // 1: out's rows may be written as 16-byte vectors
  int tiles_x, tiles_y, tiles;
  int stages;                      // input stages in the ring: 2 where they fit, else 1
};

// A solo consumer's output stage: the tile's 8 rows per column, padded
constexpr int OS8 = TH * TW + 8;

struct Smem {  // byte offsets into the dynamic shared memory (cmid, cout: padded)
  size_t w1, w2, b1, b2, bars, in, in_bytes, mid, mid_bytes, out, out_bytes, total;
  // solo: each consumer its own intermediate and a whole tile's output stage
  __host__ __device__ Smem(int kc1, int cmid, int cout, int cps1, int cps2, int stages, bool solo) {
    w1 = 0;                                    // 9 K-major blocks of cmid columns x kc1
    w2 = w1 + size_t(9) * cmid * kc1 * 2;      // 9 K-major blocks of cout columns x cmid
    b1 = w2 + size_t(9) * cout * cmid * 2;
    b2 = b1 + size_t(cmid) * 4;
    bars = b2 + size_t(cout) * 4;              // full[2], empty[2]
    in = bars + 32;                            // the input stages
    in_bytes = (size_t(IH) * IW * cps1 * 2 + 15) / 16 * 16;
    mid = in + stages * in_bytes;
    mid_bytes = size_t(MT1) * 64 * cps2 * 2;
    out = mid + (solo ? 2 : 1) * mid_bytes;
    out_bytes = size_t(cout) * (solo ? OS8 : OS) * 2;
    total = out + 2 * out_bytes;
  }
};

// Four channels (c0 .. c0 + 3) x 8 pixels from x of input-tile row yy and
// 8-pixel group g of the tile at (b, oy0, ox0), as four 16-byte rows; zero
// outside the image and past cin.
__device__ __forceinline__ void load_unit(const Args& a, int b, int oy0, int ox0, int q, int g, int yy,
                                          uint4 (&v)[4]) {
  const int y = oy0 - 2 + yy, x = ox0 - 8 + 8 * g, c0 = 4 * q;
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = make_uint4(0, 0, 0, 0);
  if (c0 >= a.cin || y < 0 || y >= a.H || x + 8 <= 0 || x >= a.W) return;
  const long long plane = static_cast<long long>(a.H) * a.W;
  const unsigned short* row = a.x + (static_cast<long long>(b) * a.cin + c0) * plane + static_cast<long long>(y) * a.W;
  const bool whole = a.vec && x >= 0 && x + 8 <= a.W;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (c0 + k >= a.cin) break;
    const unsigned short* r = row + k * plane;
    if (whole) {
      v[k] = *reinterpret_cast<const uint4*>(r + x);
    } else {
      uint32_t e[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] = (x + j >= 0 && x + j < a.W) ? r[x + j] : 0u;
      v[k] = make_uint4(e[0] | (e[1] << 16), e[2] | (e[3] << 16), e[4] | (e[5] << 16), e[6] | (e[7] << 16));
    }
  }
}

// The unit's pixels that fall in the tile (columns 8 g + j - 6), as
// channel-quads of the input tile's rows.
__device__ __forceinline__ void store_unit(const Args& a, unsigned short* in, int q, int g, int yy,
                                           const uint4 (&v)[4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int xx = 8 * g + j - 6;
    if (xx < 0 || xx >= IW) continue;
    *reinterpret_cast<uint2*>(in + (yy * IW + xx) * a.cps1 + 4 * q) = tc::quad_of(v, j);
  }
}

__device__ __forceinline__ void tile_origin(const Args& a, int t, int& b, int& oy0, int& ox0) {
  const int per = a.tiles_x * a.tiles_y, r = t % per;
  b = t / per;
  oy0 = (r / a.tiles_x) * TH;
  ox0 = (r % a.tiles_x) * TW;
}

// The producer warpgroup's copy of one input tile: its 128 threads over
// the units, group fastest (neighbouring threads read neighbouring 16-byte
// pieces of a channel row), four units' loads in flight a thread.
__device__ __forceinline__ void stage_tile(const Args& a, unsigned short* in, int b, int oy0, int ox0, int ptid) {
  constexpr int U = 4;
  const int nq = a.kc1 / 4, units = IH * G * nq;
  tc::Walk w(ptid, 128, G * nq);  // q: group + G x quad, rest: tile row
  for (int base = ptid; base < units; base += 128 * U) {
    uint4 v[U][4];
    tc::Walk wu[U];
#pragma unroll
    for (int j = 0; j < U; ++j, w.next()) {
      wu[j] = w;
      if (base + 128 * j < units) load_unit(a, b, oy0, ox0, w.q / G, w.q % G, w.rest, v[j]);
    }
#pragma unroll
    for (int j = 0; j < U; ++j)
      if (base + 128 * j < units) store_unit(a, in, wu[j].q / G, wu[j].q % G, wu[j].rest, v[j]);
  }
}

// SOLO: each consumer warpgroup a tile of its own (cmid, cout 32, cin <= 64:
// two stages, one a consumer; the block's tiles alternate between them),
// both stages at full width, its own intermediate and output stage, so the
// two consumers' tap latencies overlap instead of meeting at barriers. Else
// both consumers share a tile: N1 = cmidp / 2 (a consumer's stage-1
// columns), N2 = coutp (stage 2, 4 output rows each). KB: the k16 steps of
// a stage-1 tap held at most, 4 (cin <= 64) or 8 (cin <= 128). Within a
// consumer's 200 registers (ptxas spilled and serialized the wgmmas of the
// forms past them): the stage-1 m-tiles of a tap as one group in the solo
// form and at N1 16 and KB 4, else one m-tile at a time, two taps in flight
// unless N1 is 32 at KB 8; the shared stage 2 two taps in flight at N2 32,
// one at 64; the solo stage 2 its two m-tiles as one group. One block an
// SM: the 64-channel weights fill its shared memory.
template <int N1, int N2, int KB, bool SOLO>
__global__ void __launch_bounds__(THREADS, 1) chain_tc_kernel(const Args a) {
  NCT_DYN_SHARED(unsigned char, smem);
  const Smem sm(a.kc1, a.cmidp, a.coutp, a.cps1, a.cps2, a.stages, SOLO);
  unsigned short* w1s = reinterpret_cast<unsigned short*>(smem + sm.w1);
  unsigned short* w2s = reinterpret_cast<unsigned short*>(smem + sm.w2);
  float* b1s = reinterpret_cast<float*>(smem + sm.b1);
  float* b2s = reinterpret_cast<float*>(smem + sm.b2);
  const uint32_t bars = smem_u32(smem + sm.bars);
  const hop::Ring ring{bars, bars + 16, a.stages};
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // -- weights (rounded to bf16, K-major) and biases, once per block: zero,
  // then scatter each stored row of 9 taps into its blocks
  for (int i = tid; i < static_cast<int>(sm.b1 / 16); i += THREADS)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  if (tid == 0) {
    ring.init(128, SOLO ? 128 : 256);
    hop::mbar_init_fence();
  }
  __syncthreads();
  for (int i = tid; i < a.cmidp; i += THREADS) b1s[i] = i < a.cmid ? load_w(a.b1, a.w_bf16, i) : 0.f;
  for (int i = tid; i < a.coutp; i += THREADS) b2s[i] = i < a.cout ? load_w(a.b2, a.w_bf16, i) : 0.f;
  auto put = [&](unsigned short* ws, int kc, int np, int tap, int co, int k, const void* src, long long i) {
    ws[tap * np * kc + hop::kmajor(co, k, np)] = __bfloat16_as_ushort(__float2bfloat16(load_w(src, a.w_bf16, i)));
  };
  {
    tc::Walk w(tid, THREADS, a.cin);  // q: input channel, rest: output channel
    for (int rr = tid; rr < a.cmid * a.cin; rr += THREADS, w.next())
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) put(w1s, a.kc1, a.cmidp, tap, w.rest, w.q, a.w1, 9LL * rr + tap);
  }
  {
    tc::Walk w(tid, THREADS, a.cmid);
    for (int rr = tid; rr < a.cout * a.cmid; rr += THREADS, w.next())
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) put(w2s, a.cmidp, a.coutp, tap, w.rest, w.q, a.w2, 9LL * rr + tap);
  }
  hop::fence_async_shared();  // the weights, written by threads, are read by wgmma
  __syncthreads();

  if (warp < 4) {
    // -- the producer warpgroup: each tile's input, once stage 1 of the
    // tile `stages` before has read the stage
    hop::setmaxnreg_dec<PREG>();
    int i = 0;
    for (int t = blockIdx.x; t < a.tiles; t += gridDim.x, ++i) {
      int b, oy0, ox0;
      tile_origin(a, t, b, oy0, ox0);
      ring.acquire(i);
      stage_tile(a, reinterpret_cast<unsigned short*>(smem + sm.in + ring.stage(i) * sm.in_bytes), b, oy0, ox0,
                 tid);
      ring.publish(i);
    }
    return;
  }

  // -- consumer warpgroup c, warp w: rows 16 w .. 16 w + 15 of each m64 tile
  hop::setmaxnreg_inc<CREG>();
  const int c = (warp >> 2) - 1, w = warp & 3, ctid = tid - 128 * (c + 1);
  const int q = lane & 15, gid = lane >> 2, cq = (lane & 3) * 2;
  const uint32_t rowb1 = a.cps1 * 2, rowb2 = a.cps2 * 2;
  const uint32_t lk = (lane >> 4) * 16;  // the lane's channel half of an ldmatrix row
  const uint64_t bd2 = hop::kmajor_desc(smem_u32(w2s), a.coutp);
  const uint32_t slot1 = a.cmidp * a.kc1 * 2, slot2 = a.coutp * a.cmidp * 2;
  const int k1 = a.kc1 / 16, k2 = a.cmidp / 16;
  // the consumer's stage-1 columns [col1, col1 + N1): N1 / 8 core-matrix row
  // groups of 128 bytes from the first
  const int col1 = SOLO ? 0 : c * N1;
  const uint64_t bd1 = hop::desc_at(hop::kmajor_desc(smem_u32(w1s), a.cmidp), col1 * 16);
  unsigned short* mid = reinterpret_cast<unsigned short*>(smem + sm.mid + (SOLO ? c : 0) * sm.mid_bytes);
  unsigned short* st = reinterpret_cast<unsigned short*>(smem + sm.out + c * sm.out_bytes);
  // stage 1's A row of m-tile m: intermediate pixel p; rows past the tile
  // read its last pixel and are never stored
  const auto am1 = [&](int m) {
    const int p = min(m * 64 + 16 * w + q, MP - 1);
    return ((p / MW) * IW + p % MW) * rowb1 + lk;
  };
  uint32_t a1[MT1];
#pragma unroll
  for (int m = 0; m < MT1; ++m) a1[m] = am1(m);
  const auto tap1 = [&](int tp) { return ((tp / 3) * IW + tp % 3) * rowb1; };
  const auto desc1 = [&](int tp) { return hop::desc_at(bd1, tp * slot1); };
  // stage 2's A row: intermediate pixel (row 4 m + w + ky, column q + kx)
  const uint32_t am2 = smem_u32(mid) + ((SOLO ? w : 4 * c + w) * MW + q) * rowb2 + lk;
  const auto tap2 = [&](int tp) { return ((tp / 3) * MW + tp % 3) * rowb2; };
  const auto desc2 = [&](int tp) { return hop::desc_at(bd2, tp * slot2); };
  // m-tile m of stage 1 into the intermediate: bias, ReLU, one rounding to
  // bf16, zero outside the image
  const auto to_mid = [&](int m, const float (&acc)[N1 / 2], int oy0, int ox0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = m * 64 + 16 * w + gid + 8 * h;
      if (p >= MP) continue;
      const int gy = oy0 - 1 + p / MW, gx = ox0 - 1 + p % MW;
      const bool inside = gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
#pragma unroll
      for (int j = 0; j < N1 / 8; ++j) {
        const int col = col1 + 8 * j + cq;
        uint32_t pair = 0;
        if (inside) {
          const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16(fmaxf(acc[4 * j + 2 * h] + b1s[col], 0.f)));
          const uint32_t hi =
              __bfloat16_as_ushort(__float2bfloat16(fmaxf(acc[4 * j + 2 * h + 1] + b1s[col + 1], 0.f)));
          pair = lo | (hi << 16);
        }
        *reinterpret_cast<uint32_t*>(mid + p * a.cps2 + col) = pair;
      }
    }
  };
  // output row r of the tile, stage-2 accumulators: bias, ReLU, bf16 into
  // the consumer's output stage (rows of TW per column, os apart)
  const auto to_stage = [&](int r, const float (&acc)[N2 / 2], int os) {
#pragma unroll
    for (int j = 0; j < N2 / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + cq + (e & 1), x = gid + 8 * (e >> 1);
        st[col * os + r * TW + x] = __bfloat16_as_ushort(__float2bfloat16(fmaxf(acc[4 * j + e] + b2s[col], 0.f)));
      }
  };
  // the stage's nr rows out, from output row oy0 + r0, by the consumer's threads
  const auto store_rows = [&](int b, int oy0, int ox0, int r0, int nr, int os) {
    constexpr int VPR = TW / 8;  // 16-byte vectors per stage row
    for (int k = ctid; k < a.cout * nr * VPR; k += 128) {
      const int vx = k % VPR, rr = (k / VPR) % nr, co = k / (VPR * nr);
      const int oy = oy0 + r0 + rr, ox = ox0 + vx * 8;
      if (oy >= a.H || ox >= a.W) continue;
      const uint4 v = *reinterpret_cast<const uint4*>(st + co * os + rr * TW + vx * 8);
      unsigned short* dst = a.out + ((static_cast<long long>(b) * a.cout + co) * a.H + oy) * a.W + ox;
      if (a.out_vec && ox + 8 <= a.W) {
        *reinterpret_cast<uint4*>(dst) = v;
      } else {
        const unsigned short* e = reinterpret_cast<const unsigned short*>(&v);
        for (int j = 0; j < 8 && ox + j < a.W; ++j) dst[j] = e[j];
      }
    }
  };

  if constexpr (SOLO) {
    // the block's tiles i = c, c + 2, ...: stage c of the ring. Both
    // consumers run the same turns (the count is the block's): one without a
    // tile on the last turn still issues its wgmmas, on its own stage and
    // intermediate, and skips only the barriers and the stores (ptxas
    // serializes every wgmma of a kernel where a warp-dependent branch skips
    // one)
    const int nb = (a.tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
    for (int k = 0; 2 * k < nb; ++k) {
      const int i = 2 * k + c;
      const bool have = i < nb;
      int b = 0, oy0 = 0, ox0 = 0;
      if (have) {
        tile_origin(a, blockIdx.x + i * gridDim.x, b, oy0, ox0);
        ring.take(i);
      }
      const uint32_t in = smem_u32(smem + sm.in + c * sm.in_bytes);
      {
        float acc1[MT1][N1 / 2];
        hop::gemm_taps_mt<N1, KB, MT1>(
            acc1, 9, k1, a.cmidp, [&](int m, int tp) { return in + a1[m] + tap1(tp); }, desc1, [&] {
              if (have) ring.release(i);
            });
#pragma unroll
        for (int m = 0; m < MT1; ++m) to_mid(m, acc1[m], oy0, ox0);
      }
      hop::named_sync(1 + c, 128);  // the intermediate is whole
      float acc2[2][N2 / 2];
      hop::gemm_taps_mt<N2, KMAX2, 2>(
          acc2, 9, k2, a.coutp, [&](int m, int tp) { return am2 + 4 * m * MW * rowb2 + tap2(tp); }, desc2, [] {});
#pragma unroll
      for (int m = 0; m < 2; ++m) to_stage(4 * m + w, acc2[m], OS8);
      hop::named_sync(1 + c, 128);  // the stage is whole; the intermediate is read
      if (have) store_rows(b, oy0, ox0, 0, TH, OS8);
      hop::named_sync(1 + c, 128);  // the stage is read out
    }
    return;
  }

  float acc2[N2 / 2];
  int i = 0;
  for (int t = blockIdx.x; t < a.tiles; t += gridDim.x, ++i) {
    int b, oy0, ox0;
    tile_origin(a, t, b, oy0, ox0);
    ring.take(i);
    const uint32_t in = smem_u32(smem + sm.in + ring.stage(i) * sm.in_bytes);
    // -- stage 1: the intermediate tile from the input tile
    const auto release = [&] { ring.release(i); };  // the input stage is read: the next tile may load
    if constexpr (KB == 4 && N1 == 16) {
      // the three m-tiles of a tap as one group
      float acc1[MT1][N1 / 2];
      hop::gemm_taps_mt<N1, KB, MT1>(
          acc1, 9, k1, a.cmidp, [&](int m, int tp) { return in + a1[m] + tap1(tp); }, desc1, release);
#pragma unroll
      for (int m = 0; m < MT1; ++m) to_mid(m, acc1[m], oy0, ox0);
    } else {
#pragma unroll 1
      for (int m = 0; m < MT1; ++m) {
        float acc1[N1 / 2];
        const uint32_t base = in + am1(m);
        hop::gemm_taps<N1, KB, (N1 == 16 || KB == 4)>(
            acc1, 9, k1, a.cmidp, [&](int tp) { return base + tap1(tp); }, desc1, [&] {
              if (m == MT1 - 1) release();
            });
        to_mid(m, acc1, oy0, ox0);
      }
    }
    hop::named_sync(3, 256);  // the intermediate is whole

    // -- stage 2: the output tile from the intermediate
    hop::gemm_taps<N2, KMAX2, N2 == 32>(acc2, 9, k2, a.coutp, [&](int tp) { return am2 + tap2(tp); }, desc2, [] {});
    hop::named_sync(3, 256);  // every consumer is done with the intermediate

    // -- epilogue: bias, ReLU, bf16 into the consumer's stage, then its rows
    to_stage(w, acc2, OS);
    hop::named_sync(1 + c, 128);
    store_rows(b, oy0, ox0, 4 * c, 4, OS);
    hop::named_sync(1 + c, 128);  // the stage is read out
  }
}

template <int N1, int N2, int KB, bool SOLO = false>
int launch(Args& a, size_t smem, cudaStream_t st) {
  void (*k)(const Args) = chain_tc_kernel<N1, N2, KB, SOLO>;
  static const bool regs = hop::reg_plan_fits(k, THREADS, 1, PREG, 2, CREG);
  if (!regs) return static_cast<int>(cudaErrorInvalidConfiguration);
  int resident = 0;
  if (const int e = resident_blocks(k, THREADS, smem, resident)) return e;
  const int grid = a.tiles < resident ? a.tiles : resident;
  NCT_LAUNCH(k, dim3(grid), dim3(THREADS), smem, st, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace chain_tc
}  // namespace nct

// Plain C entry. x: (B, cin, H, W) bf16, contiguous; w1 (cmid, cin, 3, 3),
// b1 (cmid), w2 (cout, cmid, 3, 3), b2 (cout), all f32 (w_dtype 0) or all
// bf16 (1), the weights rounded to bf16 as they are staged; out (B, cout, H,
// W) bf16, contiguous. Takes cmid and cout up to 64 (run as 32 or 64
// columns) and cin up to 128 where both stages' weights and the tiles fit
// in shared memory (80 at 64 channels); returns cudaErrorInvalidValue for
// any other call, else cudaGetLastError() after the launch.
extern "C" int nct_conv_chain_tc(const void* x, int B, int H, int W, int cin, int cmid, int cout, const void* w1,
                                 const void* b1, const void* w2, const void* b2, int w_dtype, void* out,
                                 void* stream) {
  using namespace nct;
  using namespace nct::chain_tc;
  if (B < 1 || H < 1 || W < 1 || cin < 1 || cin > 128 || cmid < 1 || cmid > 64 || cout < 1 || cout > 64 ||
      (w_dtype != F32 && w_dtype != BF16) || !b1 || !b2)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.x = static_cast<const unsigned short*>(x);
  a.B = B, a.H = H, a.W = W, a.cin = cin, a.cmid = cmid, a.cout = cout;
  a.kc1 = (cin + 15) / 16 * 16;
  a.cmidp = cmid <= 32 ? 32 : 64;
  a.coutp = cout <= 32 ? 32 : 64;
  a.cps1 = a.kc1 + 8;
  a.cps2 = a.cmidp + 8;
  a.w1 = w1, a.b1 = b1, a.w2 = w2, a.b2 = b2, a.w_bf16 = w_dtype == BF16;
  a.out = static_cast<unsigned short*>(out);
  a.vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && W % 8 == 0;
  a.out_vec = reinterpret_cast<uintptr_t>(out) % 16 == 0 && W % 8 == 0;
  a.tiles_x = (W + TW - 1) / TW;
  a.tiles_y = (H + TH - 1) / TH;
  a.tiles = B * a.tiles_x * a.tiles_y;
  auto st = static_cast<cudaStream_t>(stream);
  if (a.kc1 <= 64 && a.cmidp == 32 && a.coutp == 32) {  // solo consumers, two stages (at most 173 KB)
    a.stages = 2;
    return launch<32, 32, 4, true>(a, Smem(a.kc1, 32, 32, a.cps1, a.cps2, 2, true).total, st);
  }
  a.stages = Smem(a.kc1, a.cmidp, a.coutp, a.cps1, a.cps2, 2, false).total <= MAX_SMEM ? 2 : 1;
  const size_t smem = Smem(a.kc1, a.cmidp, a.coutp, a.cps1, a.cps2, a.stages, false).total;
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  if (a.kc1 <= 64) {
    if (a.cmidp == 64) return a.coutp == 64 ? launch<32, 64, 4>(a, smem, st) : launch<32, 32, 4>(a, smem, st);
    return launch<16, 64, 4>(a, smem, st);
  }
  if (a.cmidp == 64) return a.coutp == 64 ? launch<32, 64, 8>(a, smem, st) : launch<32, 32, 8>(a, smem, st);
  return a.coutp == 64 ? launch<16, 64, 8>(a, smem, st) : launch<16, 32, 8>(a, smem, st);
}
