// Hopper (sm_90a) building blocks of the port's tensor-core kernels: the
// TMA tensor map and load, 1-D bulk copies, mbarriers, wgmma matrix descriptors and the
// wgmma products, and a thread block cluster's rank, barrier and
// distributed shared memory, each as one small function over inline PTX.
//
// The shared-memory tiles are 128-byte swizzled (CU_TENSOR_MAP_SWIZZLE_128B
// on the load, layout type B128 in the descriptor): a tile row is 128
// bytes, and the 16-byte chunk c of row r sits at chunk c ^ (r % 8) of its
// row, so tiles start on 1024-byte boundaries. Descriptor strides, in
// bytes (PTX ISA, "Matrix Descriptor Format"; CUTLASS's canonical GMMA
// layouts):
// * K-major operand (K contiguous, 64 of it in a row): SBO = the stride
//   of 8-row groups (1024 for a dense tile); LBO unused; a k16 step
//   advances the start address by 32 bytes inside the 128-byte row.
// * MN-major operand (MN contiguous): rows are K, 64 MN elements a row;
//   SBO = the stride of 8-row groups of K, LBO = the stride between
//   64-wide MN blocks; a k16 step advances the start by 16 rows.
//
// Accumulator layout of an m64nNk16 product, thread t of the warpgroup
// (warp w = t / 32, lane l): d[i] is row 16 w + l / 4 + 8 ((i / 2) % 2),
// column 8 (i / 4) + 2 (l % 4) + i % 2. A register A operand of m64k16
// holds, in four 32-bit registers of bf16 pairs (low half = lower column),
// rows 16 w + l / 4 (+ 8 in registers 1 and 3), columns 2 (l % 4) (+ 8 in
// registers 2 and 3): the accumulator's pairs 8 k .. 8 k + 7 of 8-column
// groups 2 k and 2 k + 1, in order, are the A operand of k-step k.
//
// TF32 products (m64nNk8, N = 32, 64 or 128, fp32 operands; a register A
// operand at N = 32, 64 or 128): a K-major
// tile row is 32 fp32 values, a k8 step advances the start address by 32 bytes, and a register
// A operand holds, in four 32-bit registers, rows 16 w + l / 4 (+ 8 in
// registers 1 and 3) and columns l % 4 (+ 4 in registers 2 and 3) of the
// 64 x 8 step (the fragment of mma.m16n8k8.tf32, one 16-row slab a warp).
//
// Guarded by REPRO_HOPPER_CUH (not #pragma once) so that a host-C++
// stand-in that defines the same guard can take its place.

#ifndef REPRO_HOPPER_CUH
#define REPRO_HOPPER_CUH

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace hopper {

// ----------------------------------------------------------------- host

// A 4-D tensor map over a dense tensor whose innermost dimension is
// dims[0]: strides[i] is the byte stride of dims[i + 1] (a multiple of 16),
// box the tile a load copies, 128-byte swizzled (or as `swizzle` says),
// zero past every edge. cuTensorMapEncodeTiled lives in libcuda; the
// runtime hands out its address, so that nothing links against libcuda.
// Returns 0, or a nonzero code: a cudaError_t, or 10000 + the CUresult of
// the encode.
inline int make_tma_map(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                        const uint64_t dims[4], const uint64_t strides[3], const uint32_t box[4],
                        CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return static_cast<int>(cudaErrorNotSupported);
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, type, 4, const_cast<void*>(base), dims, strides, box,
      unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : 10000 + static_cast<int>(res);
}

inline int make_tma_map_bf16(CUtensorMap* map, const void* base, const uint64_t dims[4],
                             const uint64_t strides[3], const uint32_t box[4]) {
  return make_tma_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, dims, strides, box);
}

// The same over fp32 (box[0] = 32: a 128-byte row).
inline int make_tma_map_f32(CUtensorMap* map, const void* base, const uint64_t dims[4],
                            const uint64_t strides[3], const uint32_t box[4]) {
  return make_tma_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, base, dims, strides, box);
}

// The same over fp32 without a swizzle: a box lands dense and row-major
// (box[0] a multiple of 4, up to 256; the destination 128-byte aligned).
inline int make_tma_map_f32_rows(CUtensorMap* map, const void* base, const uint64_t dims[4],
                                 const uint64_t strides[3], const uint32_t box[4]) {
  return make_tma_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, base, dims, strides, box,
                      CU_TENSOR_MAP_SWIZZLE_NONE);
}

// --------------------------------------------------------- shared memory

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Orders this thread's generic-proxy writes to shared memory before later
// async-proxy reads or writes of it (wgmma operands, TMA loads into it).
__device__ __forceinline__ void fence_proxy_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The same for every state space: global stores that a TMA load reads later.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}

// The block's dynamic shared memory `dyn` from its first 1024-byte boundary
// (the 128-byte swizzle's unit); the block asks for 1 KB more to pay for it.
__device__ __forceinline__ unsigned char* smem_align1024(unsigned char* dyn) {
  return dyn + ((1024u - (smem_u32(dyn) & 1023u)) & 1023u);
}

// Named barrier `id` (1-15; 0 is __syncthreads) over `count` threads, whole warps.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// --------------------------------------------------------------- mbarrier

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrives once and adds `bytes` to the transactions the phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// ---------------------------------------------------------------- cluster

// This block's rank in its thread block cluster.
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster: shared-memory writes before
// it are seen by every block's reads after it (release, then acquire).
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The shared::cluster address of `p` (this block's shared memory) in the
// block of rank `rank`, and an fp32 load from such an address.
__device__ __forceinline__ uint32_t map_peer(const void* p, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(smem_u32(p)), "r"(rank));
  return r;
}

__device__ __forceinline__ float ld_peer(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

// Four consecutive fp32 values at a 16-byte aligned shared::cluster address.
__device__ __forceinline__ float4 ld_peer4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// -------------------------------------------------------------- registers

// v, opaque to the optimizer: nothing computed from it is hoisted above
// this point (so that values a loop can recompute cheaply are not kept,
// and spilled, across it).
__device__ __forceinline__ int opaque(int v) {
  asm volatile("" : "+r"(v));
  return v;
}

__device__ __forceinline__ unsigned char* opaque(unsigned char* p) {
  asm volatile("" : "+l"(p));
  return p;
}

__device__ __forceinline__ size_t opaque_size(size_t v) {
  asm volatile("" : "+l"(v));
  return v;
}

// Moves registers between warpgroups (setmaxnreg): a warpgroup that only
// issues loads gives them up, the ones that hold accumulators take them.
// Every warp of the warpgroup runs it, on a path of its own to the end.
template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ------------------------------------------------------------------- TMA

// Copies the box at coordinates (c0, c1, c2, c3) of `map` to `dst` (1024-
// byte aligned; 128 without a swizzle) and completes its bytes on `bar`.
// One thread issues it.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// Copies `src` (1024-byte aligned) to the box at coordinates (c0, c1, c2,
// c3) of `map`; elements past the tensor's edges are not written. One
// thread issues it; commit, then wait before src is reused (.read) or the
// result is read back through TMA.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// 1-D bulk copies, no tensor map: `bytes` (a multiple of 16) from `src` to
// `dst`, both 16-byte aligned. The load completes its bytes on `bar`; the
// store joins the thread's bulk group (commit, then wait as for
// tma_store_4d). One thread issues each.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(reinterpret_cast<uint64_t>(dst)), "r"(smem_u32(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until at most N committed store groups still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Waits until at most N committed store groups are still incomplete.
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// ----------------------------------------------------------------- wgmma

// Descriptor of a 128-byte swizzled operand starting at `p`.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator or
// register-A operands across an asynchronous product's issue or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define HOPPER_D8(o)                                                                       \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]),              \
      "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])
#define HOPPER_D16 HOPPER_D8(0), HOPPER_D8(8)
#define HOPPER_D32 HOPPER_D16, HOPPER_D8(16), HOPPER_D8(24)
#define HOPPER_D64 HOPPER_D32, HOPPER_D8(32), HOPPER_D8(40), HOPPER_D8(48), HOPPER_D8(56)
#define HOPPER_R16 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define HOPPER_R32                                                                     \
  HOPPER_R16 ", "                                                                      \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define HOPPER_R64                                                                     \
  HOPPER_R32 ", "                                                                      \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "   \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"

// d (64 x 128, fp32) = A (64 x 16) B (16 x 128) [+ d when `accumulate`];
// A and B bf16, both K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_m64n128(float (&d)[64], uint64_t a, uint64_t b,
                                                 int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" HOPPER_R64 "}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : HOPPER_D64
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, fp32) += A (64 x 16, bf16 in registers) B (16 x 64); B bf16,
// MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[32], uint32_t a0, uint32_t a1,
                                            uint32_t a2, uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" HOPPER_R32 "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : HOPPER_D32
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

// The same at N = 128: two 64-wide MN blocks of B, LBO apart.
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[64], uint32_t a0, uint32_t a1,
                                            uint32_t a2, uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" HOPPER_R64 "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : HOPPER_D64
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

// d (64 x 64, fp32) = A (64 x 8) B (64 x 8)^T [+ d when `accumulate`]; A and
// B fp32 (read as TF32), both K-major in shared memory.
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[32], uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {" HOPPER_R32 "}, "
      "%32, %33, p, 1, 1;\n"
      "}\n"
      : HOPPER_D32
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64) (+)= -A B^T: A negated by the product's imm-scale-a.
__device__ __forceinline__ void wgmma_tf32_ss_neg(float (&d)[32], uint64_t a, uint64_t b,
                                                  int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {" HOPPER_R32 "}, "
      "%32, %33, p, -1, 1;\n"
      "}\n"
      : HOPPER_D32
      : "l"(a), "l"(b), "r"(accumulate));
}

// The same at N = 32 (d[16]) and N = 128 (d[64]): B's rows are the N side.
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[16], uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {" HOPPER_R16 "}, "
      "%16, %17, p, 1, 1;\n"
      "}\n"
      : HOPPER_D16
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[64], uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {" HOPPER_R64 "}, "
      "%64, %65, p, 1, 1;\n"
      "}\n"
      : HOPPER_D64
      : "l"(a), "l"(b), "r"(accumulate));
}

// The same with A in registers (the fragment in the header's comment).
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[32], uint32_t a0, uint32_t a1,
                                              uint32_t a2, uint32_t a3, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {" HOPPER_R32 "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : HOPPER_D32
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[16], uint32_t a0, uint32_t a1,
                                              uint32_t a2, uint32_t a3, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {" HOPPER_R16 "}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : HOPPER_D16
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(accumulate));
}

// The same at N = 128 (d[64]).
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[64], uint32_t a0, uint32_t a1,
                                              uint32_t a2, uint32_t a3, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {" HOPPER_R64 "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : HOPPER_D64
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(accumulate));
}

#undef HOPPER_D8
#undef HOPPER_D16
#undef HOPPER_D32
#undef HOPPER_D64
#undef HOPPER_R16
#undef HOPPER_R32
#undef HOPPER_R64

// ------------------------------------------------------------ bf16 pairs

// (lo, hi) rounded to nearest even into one register, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float bf16x2_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16x2_hi(uint32_t u) { return __uint_as_float(u & 0xFFFF0000u); }

}  // namespace hopper

#endif  // REPRO_HOPPER_CUH
