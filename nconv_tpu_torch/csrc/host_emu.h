// A host emulation of the CUDA launch model, so that the kernels of this
// directory compile with a C++20 host compiler and run on the CPU:
//
//   g++ -x c++ -std=c++20 -O1 -shared -fPIC -I <dir of empty cuda_runtime.h
//       and cuda_bf16.h> -include host_emu.h wgrad.cu conv.cu convt.cu -o emu.so
//
// The tests use it (tests/test_torch_host_emu.py: wgrad.cu, conv.cu,
// convt.cu; tests/test_torch_host_emu_nconv_chain.py: nconv.cu, chain.cu)
// to hold the f32 CUDA-core kernels to their plain versions without a card;
// nvcc never includes it and the package never loads what it builds.
//
// What it models:
//  * a launch runs its blocks one after another on one host thread, each
//    CUDA thread a fiber (ucontext) with its own stack;
//  * __syncthreads returns a fiber to its block's scheduler, which resumes
//    every fiber once all live ones have arrived; a fiber whose kernel
//    returns early leaves the block;
//  * __shared__ arrays are static storage (blocks run in turn), and the
//    dynamic shared memory is one buffer a block, poisoned with 0xFF bytes
//    (an f32 NaN) first, so a sum that reads a word never staged shows;
//  * cp.async (4, 8 and 16 bytes) is a synchronous copy of src_bytes with the
//    rest zero-filled, into the block's dynamic shared memory (smem_u32
//    gives an offset in it);
//  * the device queries and attributes answer for one card of 132 SMs.
// It does not model warps (no shuffles, no ldmatrix, no mma): the
// tensor-core kernels need more than this.
#pragma once

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <memory>
#include <ucontext.h>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
struct alignas(16) float4 {
  float x, y, z, w;
};
struct alignas(8) float2 {
  float x, y;
};
struct alignas(16) uint4 {
  uint32_t x, y, z, w;
};
struct alignas(8) uint2 {
  uint32_t x, y;
};
inline uint4 make_uint4(uint32_t x, uint32_t y, uint32_t z, uint32_t w) { return {x, y, z, w}; }
inline uint2 make_uint2(uint32_t x, uint32_t y) { return {x, y}; }
inline uint32_t __byte_perm(uint32_t x, uint32_t y, uint32_t s) {
  const uint64_t v = (static_cast<uint64_t>(y) << 32) | x;
  uint32_t r = 0;
  for (int i = 0; i < 4; ++i) r |= static_cast<uint32_t>((v >> (8 * ((s >> (4 * i)) & 7))) & 0xff) << (8 * i);
  return r;
}
using std::max;
using std::min;

struct __nv_bfloat16 {
  unsigned short bits;
};
inline float __bfloat162float(__nv_bfloat16 h) {
  const uint32_t u = static_cast<uint32_t>(h.bits) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16(float f) {  // round to nearest even
  uint32_t u;
  std::memcpy(&u, &f, 4);
  u += 0x7fff + ((u >> 16) & 1);
  return {static_cast<unsigned short>(u >> 16)};
}

// --- the runtime API the sources call -------------------------------------
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidConfiguration = 9 };
typedef void* cudaStream_t;
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
struct cudaFuncAttributes {
  size_t sharedSizeBytes = 0;
};
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t e) { return e == cudaSuccess ? "no error" : "emulated error"; }
inline cudaError_t cudaGetDevice(int* d) { return *d = 0, cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) { return *v = 132, cudaSuccess; }
template <class K>
cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* a, K) { return *a = {}, cudaSuccess; }
template <class K>
cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) { return cudaSuccess; }
template <class K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) { return *n = 1, cudaSuccess; }

// --- the launch model -----------------------------------------------------
// One host thread runs a launch: each block's CUDA threads are fibers
// (ucontext) run in turn, and __syncthreads hands control back to the
// block's scheduler, which resumes every live fiber once all have arrived;
// a fiber that returns leaves the block. On one host thread the emulation
// does not depend on how many cores the machine gives it.
namespace nct_emu {
inline dim3 tidx, bidx, bdim, gdim;
inline unsigned char* dyn = nullptr;  // the running block's dynamic shared memory
inline ucontext_t sched;
inline ucontext_t* running = nullptr;
inline std::function<void()>* entry = nullptr;

inline void trampoline() { (*entry)(); }

template <class... P, class... A>
void launch(void (*k)(P...), dim3 grid, dim3 block, size_t smem, A&&... args) {
  constexpr size_t STACK = 256 * 1024;
  const unsigned n = block.x * block.y * block.z;
  std::vector<unsigned char> buf(smem + 16);
  std::vector<ucontext_t> ctx(n);
  std::vector<std::vector<unsigned char>> stacks(n, std::vector<unsigned char>(STACK));
  std::vector<char> done(n);
  bdim = block, gdim = grid;
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        std::fill(buf.begin(), buf.end(), 0xFF);
        dyn = buf.data();
        bidx = dim3(bx, by, bz);
        std::fill(done.begin(), done.end(), 0);
        unsigned cur = 0;
        std::function<void()> body = [&] {
          k(args...);
          done[cur] = 1;
        };
        entry = &body;
        for (unsigned t = 0; t < n; ++t) {
          getcontext(&ctx[t]);
          ctx[t].uc_stack.ss_sp = stacks[t].data();
          ctx[t].uc_stack.ss_size = STACK;
          ctx[t].uc_link = &sched;
          makecontext(&ctx[t], trampoline, 0);
        }
        for (unsigned live = n; live > 0;) {  // one round: every live fiber up to its next barrier
          live = 0;
          for (cur = 0; cur < n; ++cur) {
            if (done[cur]) continue;
            tidx = dim3(cur % block.x, (cur / block.x) % block.y, cur / (block.x * block.y));
            running = &ctx[cur];
            swapcontext(&sched, &ctx[cur]);
            live += !done[cur];
          }
        }
      }
}
}  // namespace nct_emu

#define threadIdx (nct_emu::tidx)
#define blockIdx (nct_emu::bidx)
#define blockDim (nct_emu::bdim)
#define gridDim (nct_emu::gdim)
inline void __syncthreads() { swapcontext(nct_emu::running, &nct_emu::sched); }

#define NCT_LAUNCH(kernel, grid, block, smem, stream, ...) nct_emu::launch(kernel, grid, block, smem, __VA_ARGS__)
#define NCT_DYN_SHARED(T, name) T* name = reinterpret_cast<T*>(nct_emu::dyn)

// --- cp.async and shared addresses (common.cuh's) --------------------------
#define NCT_CP_ASYNC
inline uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(static_cast<const unsigned char*>(p) - nct_emu::dyn);
}
inline void cp_async_n(uint32_t dst, const void* src, int n, int src_bytes) {
  unsigned char* d = nct_emu::dyn + dst;
  std::memcpy(d, src, static_cast<size_t>(src_bytes));
  std::memset(d + src_bytes, 0, static_cast<size_t>(n - src_bytes));
}
inline void cp_async4(uint32_t dst, const void* src, int src_bytes) { cp_async_n(dst, src, 4, src_bytes); }
inline void cp_async8(uint32_t dst, const void* src, int src_bytes) { cp_async_n(dst, src, 8, src_bytes); }
inline void cp_async16(uint32_t dst, const void* src, int src_bytes) { cp_async_n(dst, src, 16, src_bytes); }
inline void cp_async_commit() {}
inline void cp_async_wait_all() {}
