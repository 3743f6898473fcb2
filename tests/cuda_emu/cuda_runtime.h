// CPU stand-in for <cuda_runtime.h>, for checking the logic of the port's
// CUDA kernels on a machine without nvcc (tests/test_torch_kernel_emulation.py).
// A block runs as std::threads (256 for the kernels built on tiles.cuh; any
// count up to EMU_MAX_THREADS), __syncthreads is a std::barrier, warp
// shuffles go through a buffer, and blocks run one after another, except
// the blocks of a thread block cluster (cudaLaunchKernelExC with a cluster
// dimension), which run at once, each with its own barriers and shared
// memory. It checks indexing, masking and barriers; it says nothing about
// speed.
//
// A harness either spawns a block's threads itself and calls the kernel
// (after emu_block_begin), or registers the kernel in g_emu_kernels and
// calls the kernel's C launcher: cudaLaunchKernel(ExC) then runs the grid,
// so the launcher's own arguments, grid and block size are checked too.
//
// The block a thread runs in is EmuCta: the one default block of the
// harnesses that run one block at a time (blockIdx, g_smem_base and the
// barriers below name its fields), or, for a thread of a cluster, the
// block that t_cta points to.
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
#define __forceinline__ inline
#define __host__
#define __shared__
#define __grid_constant__
#define __launch_bounds__(...)
#define __restrict__
#ifndef EMU_MAX_THREADS
#define EMU_MAX_THREADS 384
#endif
struct float4 { float x, y, z, w; };
struct float2 { float x, y; };
inline float2 make_float2(float a, float b) { return {a, b}; }
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
// A load through the read-only data cache: a plain load here.
template <typename T>
inline T __ldg(const T* p) { return *p; }
struct uint3 { unsigned x, y, z; };
inline thread_local uint3 threadIdx;
inline uint3 gridDim;
struct EmuCluster;
// One block's state: its index, its barriers (the block's, one per warp and
// one per warpgroup of 128), the warp-shuffle and register-A exchange
// buffers, its named barriers (bar.sync id, count) by id, its shared memory
// and, in a cluster, the cluster and its rank there.
struct EmuCta {
  uint3 idx{};
  std::barrier<>* bar = nullptr;
  std::barrier<>* warp_bar[EMU_MAX_THREADS / 32] = {};
  std::barrier<>* group_bar[EMU_MAX_THREADS / 128] = {};
  float xchg[EMU_MAX_THREADS] = {};
  uint32_t a_regs[EMU_MAX_THREADS][4] = {};
  // TF32 register-A operands of the products issued since a warpgroup's
  // last wait, by issue order (hopper.cuh's wgmma_tf32_rs)
  uint32_t a_slots[32][EMU_MAX_THREADS][4] = {};
  std::map<int, std::pair<std::unique_ptr<std::barrier<>>, int>> named;
  std::vector<std::unique_ptr<std::barrier<>>> owned;
  unsigned char* smem_base = nullptr;
  size_t smem_size = 0;
  EmuCluster* cluster = nullptr;
  unsigned rank = 0;
};
inline EmuCta g_cta;
inline thread_local EmuCta* t_cta = nullptr;
inline EmuCta& emu_cta() { return t_cta != nullptr ? *t_cta : g_cta; }
#define blockIdx (emu_cta().idx)
#define g_bar (emu_cta().bar)
#define g_warp_bar (emu_cta().warp_bar)
#define g_group_bar (emu_cta().group_bar)
#define g_xchg (emu_cta().xchg)
#define g_named (emu_cta().named)
#define g_smem_base (emu_cta().smem_base)
#define g_smem_size (emu_cta().smem_size)
inline std::mutex g_named_mu;
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
inline int __shfl_xor_sync(unsigned m, int v, int o) {  // the int's bits through the buffer
  float f;
  std::memcpy(&f, &v, sizeof f);
  f = __shfl_xor_sync(m, f, o);
  std::memcpy(&v, &f, sizeof v);
  return v;
}

// The barriers of block `cta` of `threads` threads: the block's, one per
// warp and one per whole warpgroup. Call before spawning its threads.
inline void emu_cta_begin(EmuCta& cta, unsigned threads) {
  cta.owned.clear();
  auto make = [&cta](unsigned n) {
    cta.owned.push_back(std::make_unique<std::barrier<>>(n));
    return cta.owned.back().get();
  };
  cta.named.clear();
  cta.bar = make(threads);
  for (unsigned w = 0; w < EMU_MAX_THREADS / 32; ++w)
    cta.warp_bar[w] = make(w * 32 < threads ? std::min(32u, threads - w * 32) : 32u);
  for (unsigned g = 0; g < EMU_MAX_THREADS / 128; ++g) cta.group_bar[g] = make(128);
}

// The same for the default block, which runs one block at a time.
inline void emu_block_begin(unsigned threads) { emu_cta_begin(g_cta, threads); }

// The blocks of one running cluster and the barrier of all their threads.
struct EmuCluster {
  std::unique_ptr<std::barrier<>> bar;
  std::vector<EmuCta*> ctas;
};

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute {
  cudaFuncAttributeMaxDynamicSharedMemorySize,
  cudaFuncAttributeNonPortableClusterSizeAllowed,
  cudaFuncAttributePreferredSharedMemoryCarveout
};
enum { cudaSharedmemCarveoutMaxShared = 100 };
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
  dim3(unsigned x_ = 1) : x(x_) {}
};
// kernel -> how to call it from a cudaLaunchKernel argument array
inline std::map<const void*, std::function<void(void**)>> g_emu_kernels;
inline size_t g_emu_smem_limit = 232448;
// Kernels allowed clusters past the portable 8 (up to 16, as on an H100).
inline std::map<const void*, bool> g_emu_nonportable;
inline cudaError_t cudaFuncSetAttribute(const void* f, cudaFuncAttribute attr, int value) {
  if (attr == cudaFuncAttributeNonPortableClusterSizeAllowed) g_emu_nonportable[f] = value != 0;
  return 0;
}
// The most CTAs a cluster of kernel f may have.
inline unsigned emu_max_cluster(const void* f) {
  auto it = g_emu_nonportable.find(f);
  return it != g_emu_nonportable.end() && it->second ? 16u : 8u;
}
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
// Blocks of `smem` bytes an SM of 228 KB holds, each reserving 1 KB.
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* blocks, const void*, int,
                                                                 size_t smem) {
  *blocks = static_cast<int>(233472 / (smem + 1024));
  return 0;
}

// cudaLaunchKernelExC with a cluster dimension: the grid runs one cluster
// at a time, its blocks at once, each on its own 1024-byte aligned shared
// memory of the launch's dynamic size; at most 8 blocks a cluster, 16 after
// cudaFuncAttributeNonPortableClusterSizeAllowed.
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchAttributeValue {
  struct { unsigned x, y, z; } clusterDim;
};
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  cudaLaunchAttributeValue val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
// Clusters the emulated card keeps resident: g_emu_sms, so that a persistent
// cluster grid walks several matrices per cluster.
inline cudaError_t cudaOccupancyMaxActiveClusters(int* clusters, const void* f,
                                                  const cudaLaunchConfig_t* cfg) {
  if (cfg->dynamicSmemBytes > g_emu_smem_limit) return cudaErrorInvalidValue;
  for (unsigned a = 0; a < cfg->numAttrs; ++a)
    if (cfg->attrs[a].id == cudaLaunchAttributeClusterDimension &&
        cfg->attrs[a].val.clusterDim.x > emu_max_cluster(f))
      return cudaErrorInvalidValue;
  *clusters = g_emu_sms;
  return 0;
}
inline cudaError_t cudaLaunchKernelExC(const cudaLaunchConfig_t* cfg, const void* f, void** args) {
  auto it = g_emu_kernels.find(f);
  if (it == g_emu_kernels.end()) return cudaErrorInvalidValue;
  unsigned cl = 1;
  for (unsigned a = 0; a < cfg->numAttrs; ++a)
    if (cfg->attrs[a].id == cudaLaunchAttributeClusterDimension) {
      const auto& d = cfg->attrs[a].val.clusterDim;
      if (d.y != 1 || d.z != 1) return cudaErrorInvalidValue;
      cl = d.x;
    }
  const unsigned threads = cfg->blockDim.x, grid = cfg->gridDim.x;
  if (threads > EMU_MAX_THREADS || cfg->dynamicSmemBytes > g_emu_smem_limit || cl < 1 ||
      cl > emu_max_cluster(f) || grid % cl != 0)
    return cudaErrorInvalidValue;
  gridDim.x = grid;
  for (unsigned first = 0; first < grid; first += cl) {
    EmuCluster cluster;
    cluster.bar = std::make_unique<std::barrier<>>(cl * threads);
    std::vector<std::unique_ptr<EmuCta>> ctas;
    std::vector<std::vector<unsigned char>> smem(cl);
    for (unsigned r = 0; r < cl; ++r) {
      ctas.push_back(std::make_unique<EmuCta>());
      EmuCta& cta = *ctas.back();
      emu_cta_begin(cta, threads);
      cta.idx.x = first + r;
      cta.rank = r;
      cta.cluster = &cluster;
      smem[r].assign(cfg->dynamicSmemBytes + 1024, 0xA5);  // not zero: a kernel must write first
      const uintptr_t base = reinterpret_cast<uintptr_t>(smem[r].data());
      cta.smem_base = smem[r].data() + ((1024 - base % 1024) % 1024);
      cta.smem_size = cfg->dynamicSmemBytes;
      cluster.ctas.push_back(&cta);
    }
    std::vector<std::thread> pool;
    for (unsigned r = 0; r < cl; ++r)
      for (unsigned t = 0; t < threads; ++t)
        pool.emplace_back([&, r, t] {
          t_cta = ctas[r].get();
          threadIdx.x = t;
          it->second(args);
        });
    for (auto& t : pool) t.join();
  }
  return 0;
}
