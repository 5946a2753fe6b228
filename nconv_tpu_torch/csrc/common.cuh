// Shared pieces of the port's hand-written Hopper kernels (sm_90a).
//
// Every kernel reads its input as a list of "parts": a logical channel
// concat whose pieces stay separate tensors in device memory, each with its
// own element strides (so an NHWC uint8 frame and an NCHW activation are
// read by the same loader), and optionally stored at half resolution and
// read as a 2x nearest upsample. Outputs are NCHW contiguous. Arithmetic is
// f32 throughout; bf16 and uint8 are storage types only.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <vector>

// Kernel launch through a function pointer; a build may predefine it to run
// the kernels elsewhere than on the card.
#ifndef NCT_LAUNCH
#define NCT_LAUNCH(kernel, grid, block, smem, stream, ...) \
  kernel<<<grid, block, smem, stream>>>(__VA_ARGS__)
#endif

#ifndef NCT_DYN_SHARED
#define NCT_DYN_SHARED(T, name) extern __shared__ __align__(16) T name[]
#endif

// cp.async and the shared-space addresses it takes; a build may predefine
// NCT_CP_ASYNC and supply its own (host_emu.h does).
#ifndef NCT_CP_ASYNC
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global src to shared dst (a shared-space address), of which
// the first src_bytes are read and the rest zero-filled; asynchronous until
// cp_async_wait_all.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes));
}
// 8 bytes from global src to shared dst, src_bytes (8 or 0) of them read and
// the rest zero-filled.
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes));
}
// 4 bytes from global src to shared dst, src_bytes (4 or 0) of them read and
// the rest zero-filled; the f32 kernels' element copies.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }
#endif

namespace nct {

enum DType : int { F32 = 0, BF16 = 1, U8 = 2 };

constexpr int MAX_PARTS = 4;

struct Part {
  const void* ptr;
  int c;    // channels of this part
  int up2;  // 1: stored at (H/2, W/2), read as a 2x nearest upsample
  long long sb, sc, sh, sw;  // element strides of (batch, channel, row, col)
};

template <typename T>
__device__ __forceinline__ float load_f(const T* p, long long i);
template <>
__device__ __forceinline__ float load_f<float>(const float* p, long long i) {
  return p[i];
}
template <>
__device__ __forceinline__ float load_f<__nv_bfloat16>(const __nv_bfloat16* p,
                                                       long long i) {
  return __bfloat162float(p[i]);
}
template <>
__device__ __forceinline__ float load_f<uint8_t>(const uint8_t* p, long long i) {
  return static_cast<float>(p[i]);  // raw 0..255, no scaling
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

// A weight or bias element stored as f32 (bf16 = 0) or bf16 (bf16 = 1), as f32.
__device__ __forceinline__ float load_w(const void* p, int bf16, long long i) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// The value an f32 takes after a round trip through storage type T.
template <typename T>
__device__ __forceinline__ float round_as(float v) {
  T t = from_f<T>(v);
  return load_f<T>(&t, 0);
}

// C consecutive floats of shared memory (a staged weight row's C output
// channels) into registers: float4s, a float2 or one value, p aligned to
// match; every thread of a warp reads the same row, so each is a broadcast.
template <int C>
__device__ __forceinline__ void load_w(const float* p, float (&v)[C]) {
  static_assert(C % 4 == 0 || C <= 2, "float4s, a float2 or one value");
  if constexpr (C % 4 == 0) {
#pragma unroll
    for (int k = 0; k < C / 4; ++k) {
      const float4 t = reinterpret_cast<const float4*>(p)[k];
      v[4 * k] = t.x, v[4 * k + 1] = t.y, v[4 * k + 2] = t.z, v[4 * k + 3] = t.w;
    }
  } else if constexpr (C == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x, v[1] = t.y;
  } else {
    v[0] = p[0];
  }
}

// A warp's copies of one contiguous f32 row into shared memory: n vectors of
// V floats (16-, 8- or 4-byte cp.async), vector i from src[x0 + V * i] to
// dst[V * i], lane by lane. A vector inside [0, W) of a live row is read,
// any other zero-filled; x0 and W are multiples of V, so none straddles the
// image's edge, and the bounds are tested once a vector, not once a value.
template <int V>
__device__ __forceinline__ void stage_row(float* dst, const float* src, int x0, int n, int W, bool live,
                                          int lane) {
  static_assert(V == 4 || V == 2 || V == 1, "16-, 8- or 4-byte copies");
  for (int i = lane; i < n; i += 32) {
    const int x = x0 + V * i;
    const bool in = live && x >= 0 && x < W;
    const float* s = in ? src + x : src;
    if constexpr (V == 4)
      cp_async16(smem_u32(dst + 4 * i), s, in ? 16 : 0);
    else if constexpr (V == 2)
      cp_async8(smem_u32(dst + 2 * i), s, in ? 8 : 0);
    else
      cp_async4(smem_u32(dst + i), s, in ? 4 : 0);
  }
}

// Logical channel c of batch b at logical pixel (y, x); 0 outside the
// (H, W) image, which is the zero padding of every conv here.
template <typename T>
__device__ __forceinline__ float load_parts(const Part* parts, int nparts,
                                            int b, int c, int y, int x, int H,
                                            int W) {
  if (y < 0 || y >= H || x < 0 || x >= W) return 0.f;
  int p = 0;
  while (p < nparts - 1 && c >= parts[p].c) {
    c -= parts[p].c;
    ++p;
  }
  const Part& q = parts[p];
  if (q.up2) {
    y >>= 1;
    x >>= 1;
  }
  return load_f<T>(static_cast<const T*>(q.ptr),
                   b * q.sb + c * q.sc + y * q.sh + x * q.sw);
}

// The part of a list of np holding logical channel c; c becomes its index
// in that part.
__device__ __forceinline__ int part_of(const Part* parts, int np, int& c) {
  int p = 0;
  while (p < np - 1 && c >= parts[p].c) c -= parts[p++].c;
  return p;
}

constexpr size_t MAX_SMEM = 232448;  // 227 KB, a block's most on sm_90

// Host side: blocks of kernel k that fit on the current device at (threads,
// smem), after raising k's dynamic shared-memory limit there to all that its
// static shared memory leaves of MAX_SMEM (so one setting serves every smem
// a kernel is launched with). The attribute and the occupancy belong to a
// device, so both are set and queried once per (device, kernel, threads,
// smem); the caller launches with the tensors' device current
// (kernels.launch on the Python side).
template <class K>
int resident_blocks(K k, int threads, size_t smem, int& blocks) {
  struct Entry {
    int dev;
    K k;
    int threads;
    size_t smem;
    int blocks;
  };
  static std::mutex mu;
  static std::vector<Entry> seen;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  std::lock_guard<std::mutex> lock(mu);
  for (const Entry& s : seen)
    if (s.dev == dev && s.k == k && s.threads == threads && s.smem == smem) return blocks = s.blocks, 0;
  int sms = 0, per_sm = 0;
  cudaFuncAttributes fa{};
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, k);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(MAX_SMEM - fa.sharedSizeBytes));
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, threads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  seen.push_back({dev, k, threads, smem, blocks = per_sm * sms});
  return 0;
}

// Host side: copy n part descriptors from the flat arrays of the C ABI
// (ptrs[i]; meta[6*i ..] = c, up2, sb, sc, sh, sw).
inline void fill_parts(Part* dst, const void* const* ptrs,
                       const long long* meta, int n) {
  for (int i = 0; i < n; ++i) {
    const long long* m = meta + 6 * i;
    dst[i].ptr = ptrs[i];
    dst[i].c = static_cast<int>(m[0]);
    dst[i].up2 = static_cast<int>(m[1]);
    dst[i].sb = m[2];
    dst[i].sc = m[3];
    dst[i].sh = m[4];
    dst[i].sw = m[5];
  }
}

// Host side: the stride of a staged [channel x tap][output channel] weight
// row of n floats. The copies that transpose the weights into it write a
// channel's taps n floats apart: at n a multiple of 32 all on one bank, so
// such a row is 4 floats longer (still 16-byte aligned for float4 reads).
constexpr int padded_row(int n) { return n % 32 ? n : n + 4; }

// Host side: whether a part's rows of BYTES-byte elements may be read as
// aligned 16-byte vectors.
template <int BYTES>
inline int vec_rows(const Part& p) {
  constexpr int E = 16 / BYTES;
  return p.sw == 1 && reinterpret_cast<uintptr_t>(p.ptr) % 16 == 0 && p.sb % E == 0 && p.sc % E == 0 &&
         p.sh % E == 0;
}

}  // namespace nct
