// CPU stand-in for <cuda_runtime.h>, for checking the logic of the port's
// CUDA kernels on a machine without nvcc (tests/test_torch_kernel_emulation.py).
// A block runs as std::threads (256 for the kernels built on tiles.cuh; any
// count up to EMU_MAX_THREADS), __syncthreads is a std::barrier, warp
// shuffles go through a buffer, and blocks run one after another. It checks
// indexing, masking and barriers; it says nothing about speed.
//
// A harness either spawns a block's threads itself and calls the kernel
// (after emu_block_begin), or registers the kernel in g_emu_kernels and
// calls the kernel's C launcher: cudaLaunchKernel then runs the grid, so the
// launcher's own arguments, grid and block size are checked too.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <functional>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>
using std::max;
using std::min;
#define __global__
#define __device__
#define __host__
#define __shared__
#define __grid_constant__
#define __launch_bounds__(...)
#define __restrict__
#ifndef EMU_MAX_THREADS
#define EMU_MAX_THREADS 384
#endif
struct float4 { float x, y, z, w; };
// bf16 as 16 bits of storage; conversions as the card's intrinsics do them
// (float -> bf16 rounds to nearest even, NaN stays NaN).
struct __nv_bfloat16 { uint16_t x; };
inline float __bfloat162float(__nv_bfloat16 h) {
  const uint32_t u = static_cast<uint32_t>(h.x) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {static_cast<uint16_t>((u >> 16) | 0x40u)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {static_cast<uint16_t>(u >> 16)};
}
inline float __uint_as_float(uint32_t u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline uint32_t __float_as_uint(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  return u;
}
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
struct uint3 { unsigned x, y, z; };
inline thread_local uint3 threadIdx;
inline uint3 blockIdx;
inline uint3 gridDim;
inline std::barrier<>* g_bar;
inline std::barrier<>* g_warp_bar[EMU_MAX_THREADS / 32];
inline std::barrier<>* g_group_bar[EMU_MAX_THREADS / 128];  // warpgroups of 128
inline float g_xchg[EMU_MAX_THREADS];
// Named barriers (bar.sync id, count) of the running block, by id.
inline std::mutex g_named_mu;
inline std::map<int, std::pair<std::unique_ptr<std::barrier<>>, int>> g_named;
inline void __syncthreads() { g_bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { g_warp_bar[threadIdx.x / 32]->arrive_and_wait(); }
// Lane src's v, for every lane of the warp (through the same buffer).
inline int __shfl_sync(unsigned, int v, int src) {
  int t = threadIdx.x, w = t / 32;
  g_xchg[t] = static_cast<float>(v);
  g_warp_bar[w]->arrive_and_wait();
  const int r = static_cast<int>(g_xchg[32 * w + src]);
  g_warp_bar[w]->arrive_and_wait();
  return r;
}
inline float __shfl_xor_sync(unsigned, float v, int o) {
  int t = threadIdx.x, w = t / 32;
  g_xchg[t] = v;
  g_warp_bar[w]->arrive_and_wait();
  float r = g_xchg[t ^ o];
  g_warp_bar[w]->arrive_and_wait();
  return r;
}

// The barriers of one block of `threads` threads: the block's, one per warp
// and one per whole warpgroup. Call before spawning the block's threads.
inline void emu_block_begin(unsigned threads) {
  static std::vector<std::unique_ptr<std::barrier<>>> owned;
  owned.clear();
  auto make = [](unsigned n) {
    owned.push_back(std::make_unique<std::barrier<>>(n));
    return owned.back().get();
  };
  g_named.clear();
  g_bar = make(threads);
  for (unsigned w = 0; w < EMU_MAX_THREADS / 32; ++w)
    g_warp_bar[w] = make(w * 32 < threads ? std::min(32u, threads - w * 32) : 32u);
  for (unsigned g = 0; g < EMU_MAX_THREADS / 128; ++g) g_group_bar[g] = make(128);
}

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
// SMs of the emulated card: few, so that a persistent grid walks several
// matrices per block.
inline int g_emu_sms = 2;
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return 0;
}
inline cudaError_t cudaDeviceGetAttribute(int* value, cudaDeviceAttr, int) {
  *value = g_emu_sms;
  return 0;
}
typedef void* cudaStream_t;
struct dim3 {
  unsigned x;
  dim3(unsigned x_) : x(x_) {}
};
// kernel -> how to call it from a cudaLaunchKernel argument array
inline std::map<const void*, std::function<void(void**)>> g_emu_kernels;
inline size_t g_emu_smem_limit = 232448;
inline cudaError_t cudaFuncSetAttribute(const void*, cudaFuncAttribute, int) { return 0; }
inline cudaError_t cudaLaunchKernel(const void* f, dim3 grid, dim3 block, void** args,
                                    size_t smem, cudaStream_t) {
  auto it = g_emu_kernels.find(f);
  if (it == g_emu_kernels.end()) return 0;  // a harness that calls the kernel itself
  if (block.x > EMU_MAX_THREADS || smem > g_emu_smem_limit) return cudaErrorInvalidValue;
  gridDim.x = grid.x;
  for (unsigned blk = 0; blk < grid.x; ++blk) {
    blockIdx.x = blk;
    emu_block_begin(block.x);
    std::vector<std::thread> threads;
    for (unsigned t = 0; t < block.x; ++t) {
      threads.emplace_back([&, t] {
        threadIdx.x = t;
        it->second(args);
      });
    }
    for (auto& t : threads) t.join();
  }
  return 0;
}
inline cudaError_t cudaGetLastError() { return 0; }
