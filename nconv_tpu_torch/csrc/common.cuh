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

// Kernel launch through a function pointer; a build may predefine it to run
// the kernels elsewhere than on the card.
#ifndef NCT_LAUNCH
#define NCT_LAUNCH(kernel, grid, block, smem, stream, ...) \
  kernel<<<grid, block, smem, stream>>>(__VA_ARGS__)
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

// The value an f32 takes after a round trip through storage type T.
template <typename T>
__device__ __forceinline__ float round_as(float v) {
  T t = from_f<T>(v);
  return load_f<T>(&t, 0);
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

}  // namespace nct
