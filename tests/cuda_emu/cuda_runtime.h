// CPU stand-in for <cuda_runtime.h>, for checking the logic of the port's
// CUDA kernels on a machine without nvcc (tests/test_torch_kernel_emulation.py).
// A block runs as 256 std::threads, __syncthreads is a std::barrier, warp
// shuffles go through a buffer, and blocks run one after another. It checks
// indexing, masking and barriers; it says nothing about speed.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
using std::max;
using std::min;
#define __global__
#define __device__
#define __host__
#define __shared__
#define __launch_bounds__(...)
#define __restrict__
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
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
struct uint3 { unsigned x, y, z; };
extern thread_local uint3 threadIdx;
extern uint3 blockIdx;
extern std::barrier<>* g_bar;
extern std::barrier<>* g_warp_bar[8];
extern float g_xchg[256];
inline void __syncthreads() { g_bar->arrive_and_wait(); }
inline float __shfl_xor_sync(unsigned, float v, int o) {
  int t = threadIdx.x, w = t / 32;
  g_xchg[t] = v;
  g_warp_bar[w]->arrive_and_wait();
  float r = g_xchg[t ^ o];
  g_warp_bar[w]->arrive_and_wait();
  return r;
}
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
typedef void* cudaStream_t;
struct dim3 { dim3(unsigned) {} };
inline cudaError_t cudaFuncSetAttribute(const void*, cudaFuncAttribute, int) { return 0; }
inline cudaError_t cudaLaunchKernel(const void*, dim3, dim3, void**, size_t, cudaStream_t) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
