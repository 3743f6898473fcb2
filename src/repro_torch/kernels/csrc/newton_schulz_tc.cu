// Batched Newton-Schulz polar projection for Hopper (sm_90a) on the tensor
// cores: the feasibility watchdog's drift repair for p <= 64 stacks whose
// matrices do not fit one block whole (the trainer's q/k, 640 x (64, 960)).
//
// Replaces the Pallas TPU kernel src/repro/kernels/newton_schulz.py:37
// (newton_schulz, _ns_kernel :21), reached through kernels/ops.py:700
// (_ns_dispatch) from the watchdog's repair (core/api.py:1504), as the
// kernels of newton_schulz.cu do, with the same function per (p, n) matrix
// of a (B, p, n) fp32 stack:
//   f = max(||X||_F, 1e-30),  Y = X / f
//   iters times:  Y <- 1.5 Y - 0.5 (Y Y^T) Y
//   dist = ||Y Y^T - I||_F  (the repaired matrix's feasibility)
//
// Bound, at 640 x (64, 960) and 12 iterations: 48 p^2 n flops a matrix, the
// gram's half of them in two TF32 products (G = U + U^T, below) and the
// update's half in three, 120 p^2 n of TF32 work, 0.6101 ms at 495 TFLOP/s;
// X read once and Y written once, 0.0939 ms at 3.35 TB/s. Operations bound
// it.
//
// Design:
// * One matrix per thread block cluster of c CTAs: c is the least power of
//   two (at most 8) for which a CTA's share of the 64-column chunks fits
//   kNtChunks (9) tiles, c = 2 at n = 960 (8 and 7 chunks). Each CTA keeps its
//   chunks of Y in shared memory through every iteration, as 64 x 64 fp32
//   tiles in the 128-byte swizzle that the wgmma descriptors read (rows
//   past p and columns past n zero), so X is read once and Y written once:
//   2 HBM passes.
// * An iteration is one sweep over a CTA's chunks, which its two
//   warpgroups take in turns. A chunk's update needs (G Y)^T = Y^T G: Y^T is
//   the register A operand (a TF32 wgmma reads only K-major operands from
//   shared memory, and Y's tile is MN-major for this product), made with
//   its lo piece in registers; G's hi and lo tiles are the B operand. Y' =
//   1.5 Y - 0.5 G Y goes back over the tile. Then the tile's share of the
//   next gram, U += (Y_h / 2 + Y_l) Y_h^T: the halved hi piece and the lo
//   piece as register A operands against the tile itself (read as its hi
//   piece), so that G = U + U^T holds the three 3xTF32 terms in two
//   products. Each chunk's products start from zero and are added to fp32
//   sums in registers: the tensor cores' rounding toward zero acts on
//   64-column partials only.
// * The partial grams meet through distributed shared memory: each CTA
//   sums its U (warpgroup 1's sums, then warpgroup 0's added), publishes
//   its symmetric part P = U + U^T (64 x 64, row-major) in one of two
//   buffers; a cluster barrier; then every CTA forms G = sum_r P_r in rank
//   order, its own P from its shared memory and its partners' by 16-byte
//   loads (mapa, ld.shared::cluster.v4): the same bits in every CTA, G
//   exactly symmetric. (Scalar loads of U and U^T from every CTA, 64 a
//   thread, took 0.09 ms an iteration at 640 x (64, 960), on an H100.) The
//   buffers alternate between iterations, so a CTA's next writes never
//   meet a partner's reads of the last ones: one cluster barrier an
//   iteration. The Frobenius sum of squares is reduced the same way.
// * A (B,) byte mask gates each matrix: the CTAs of a cluster whose matrix
//   did not trip read the same byte and exit together, before any cluster
//   barrier, and leave the matrix and its distance untouched; an idle
//   launch does no other work. A CTA that reads its partners waits at a
//   last cluster barrier before it exits, so that no CTA leaves while a
//   partner may still read its shared memory.
// * fp32 accuracy as in fused_step_tc.cu: hi = tf32(x), lo = tf32(x - hi),
//   lo.lo dropped; an operand read from shared memory is its own hi (the
//   card drops its low 13 bits), its lo tf32(x - trunc(x)).
//
// * X is loaded 8 float4 a thread at a time, so that the loads of a CTA,
//   which has the SM to itself, overlap in HBM.
//
// Shared memory: the chunks' tiles (16 KB each), G hi and lo, the CTA's U
// (64 x 65: its transpose is read), the two published P and the reduction
// scratch. out may alias x: each CTA reads its columns before it writes
// them. The launcher returns cudaGetLastError().

#include "hopper.cuh"
#include "tf32_tile.cuh"
#include "tiles.cuh"

namespace {

constexpr int kNtP = kTcP;                 // rows of a tile: p <= 64
constexpr int kNtTile = kTcTileBytes;      // a 64-column chunk
constexpr int kNtChunk = kTcChunk;
constexpr int kNtChunks = 9;               // most chunks a CTA keeps
constexpr int kNtCluster = 8;              // the largest portable cluster
constexpr int kNtLd = kNtP + 1;            // row stride of the CTA's U, floats
constexpr int kNtPub = kNtP * kNtP;        // floats of a published P
constexpr int kNtLoads = 8;                // float4 loads of X in flight a thread
constexpr int kNtGroupBar = 1;             // named barriers 1, 2: one warpgroup each

static_assert(kThreads == 256, "two warpgroups: tiles.cuh's block_sum counts 8 warps");

// Byte offsets past a CTA's `chunks` tiles: G hi, G lo, U, the two
// published P, the reduction scratch (8 warps' sums, then the CTA's at [8]).
__host__ __device__ inline int nt_g_off(int chunks) { return chunks * kNtTile; }
__host__ __device__ inline int nt_u_off(int chunks) { return nt_g_off(chunks) + 2 * kNtTile; }
__host__ __device__ inline int nt_pub_off(int chunks) { return nt_u_off(chunks) + kNtP * kNtLd * 4; }
__host__ __device__ inline int nt_red_off(int chunks) { return nt_pub_off(chunks) + 2 * kNtPub * 4; }
__host__ __device__ inline int nt_smem_bytes(int chunks) { return nt_red_off(chunks) + 64 + 1024; }

// The cluster size for n: the least power of two, at most kNtCluster, that
// leaves a CTA at most kNtChunks chunks; 0 when none does.
__host__ __device__ inline int nt_cluster(int n) {
  const int nch = (n + kNtChunk - 1) / kNtChunk;
  for (int c = 1; c <= kNtCluster; c *= 2)
    if ((nch + c - 1) / c <= kNtChunks) return c;
  return 0;
}

// d = Y^T G over K = 64 rows (3xTF32, small terms first), Y^T the register
// operand whose element (m, k) is the tile's (k, m), G its hi and lo
// tiles; waits.
__device__ inline void update_product(float (&d)[32], unsigned char* tile, const unsigned char* gh,
                                      const unsigned char* gl) {
  const int t = threadIdx.x & 127, m0 = 16 * (t >> 5) + ((t & 31) >> 2), k0 = t & 3;
  uint32_t fh[8][4], fl[8][4];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float hi, lo;
      split(tc_at(tile, 8 * kk + k0 + 4 * (r >> 1), m0 + 8 * (r & 1)), hi, lo);
      fh[kk][r] = __float_as_uint(hi);
      fl[kk][r] = __float_as_uint(lo);
    }
  }
  hopper::fence_regs(d);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    hopper::fence_regs(fh[kk]);
    hopper::fence_regs(fl[kk]);
  }
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    hopper::wgmma_tf32_rs(d, fh[kk][0], fh[kk][1], fh[kk][2], fh[kk][3], tc_desc(gl, kk), kk > 0);
    hopper::wgmma_tf32_rs(d, fl[kk][0], fl[kk][1], fl[kk][2], fl[kk][3], tc_desc(gh, kk), 1);
  }
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    hopper::wgmma_tf32_rs(d, fh[kk][0], fh[kk][1], fh[kk][2], fh[kk][3], tc_desc(gh, kk), 1);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(d);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    hopper::fence_regs(fh[kk]);
    hopper::fence_regs(fl[kk]);
  }
}

// u = (Y_h / 2 + Y_l) Y_h^T over the tile's 64 columns: the register A
// operand (element (m, k) the tile's (m, k)), lo pieces first, against the
// tile itself; waits.
__device__ inline void gram_product(float (&u)[32], unsigned char* tile) {
  const int t = threadIdx.x & 127, m0 = 16 * (t >> 5) + ((t & 31) >> 2), k0 = t & 3;
  uint32_t fh[8][4], fl[8][4];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float v = tc_at(tile, m0 + 8 * (r & 1), 8 * kk + k0 + 4 * (r >> 1));
      fh[kk][r] = __float_as_uint(0.5f * tf32_trunc(v));
      fl[kk][r] = __float_as_uint(trunc_lo(v));
    }
  }
  hopper::fence_regs(u);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    hopper::fence_regs(fh[kk]);
    hopper::fence_regs(fl[kk]);
  }
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    hopper::wgmma_tf32_rs(u, fl[kk][0], fl[kk][1], fl[kk][2], fl[kk][3], tc_desc(tile, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    hopper::wgmma_tf32_rs(u, fh[kk][0], fh[kk][1], fh[kk][2], fh[kk][3], tc_desc(tile, kk), 1);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(u);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    hopper::fence_regs(fh[kk]);
    hopper::fence_regs(fl[kk]);
  }
}

// Element j of quad q of thread t's share of a 64 x 64 gram: row (t + 256
// q) / 16, column 4 ((t + 256 q) % 16) + j.
__device__ inline int quad_row(int t, int q) { return (t + kThreads * q) >> 4; }
__device__ inline int quad_col(int t, int q) { return 4 * ((t + kThreads * q) & 15); }

// The cluster's gram G = sum_r P_r, P_r = U_r + U_r^T, from this
// warpgroup's sums u (the accumulator layout): the CTA's U into `us`
// (warpgroup 1's, then warpgroup 0's added), its P into `pub`, a cluster
// barrier (after which every warpgroup is done with the last G), then
// every CTA's P in rank order. Thread t's quads of G are returned in g
// (g[4 q + j]) and, when gh is given, written hi and lo into the tiles gh
// and gl.
__device__ void cluster_gram(const float (&u)[32], float* us, float* pub, int c, int rank,
                             float (&g)[16], unsigned char* gh, unsigned char* gl) {
  const int tid = threadIdx.x, wt = tid & 127;
  if (tid >= 128) {
#pragma unroll
    for (int i = 0; i < 32; ++i) us[acc_row(wt, i) * kNtLd + acc_col(wt, i)] = u[i];
  }
  __syncthreads();
  if (tid < 128) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float& s = us[acc_row(wt, i) * kNtLd + acc_col(wt, i)];
      s = s + u[i];
    }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = quad_row(tid, q), c0 = quad_col(tid, q);
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = us[r * kNtLd + c0 + j] + us[(c0 + j) * kNtLd + r];
    *reinterpret_cast<float4*>(pub + r * kNtP + c0) = make_float4(v[0], v[1], v[2], v[3]);
  }
  hopper::cluster_sync();
  float4 sum[4];
  for (int k = 0; k < c; ++k) {  // every CTA's P in rank order, four loads in flight
    float4 v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float* at = pub + quad_row(tid, q) * kNtP + quad_col(tid, q);
      v[q] = k == rank ? *reinterpret_cast<const float4*>(at)
                       : hopper::ld_peer4(hopper::map_peer(at, k));
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (k == 0) {
        sum[q] = v[q];
      } else {
        sum[q].x += v[q].x;
        sum[q].y += v[q].y;
        sum[q].z += v[q].z;
        sum[q].w += v[q].w;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float v[4] = {sum[q].x, sum[q].y, sum[q].z, sum[q].w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      g[4 * q + j] = v[j];
      if (gh != nullptr) {
        const int r = quad_row(tid, q), cc = quad_col(tid, q) + j;
        split(v[j], tc_at(gh, r, cc), tc_at(gl, r, cc));
      }
    }
  }
  hopper::fence_proxy_async_smem();  // G's tiles are the next sweep's wgmma operands
  __syncthreads();
}

// One cluster of c CTAs per matrix b = blockIdx.x / c; grid B c.
__global__ void __launch_bounds__(kThreads, 1)
ns_tc_kernel(const float* x, float* out, const unsigned char* mask, float* dist, int p, int n,
             int iters, int c, int vec) {
  extern __shared__ unsigned char ns_tc_smem[];
  const int b = blockIdx.x / c;
  if (mask != nullptr && mask[b] == 0) return;  // the whole cluster, before any barrier
  unsigned char* sm = hopper::smem_align1024(ns_tc_smem);
  const int rank = static_cast<int>(hopper::cluster_rank());
  const int nch = (n + kNtChunk - 1) / kNtChunk, most = (nch + c - 1) / c;
  const int c_lo = rank * nch / c, cnt = (rank + 1) * nch / c - c_lo;  // this CTA's chunks
  unsigned char* gh = sm + nt_g_off(most);
  unsigned char* gl = gh + kNtTile;
  float* us = reinterpret_cast<float*>(sm + nt_u_off(most));
  float* pub = reinterpret_cast<float*>(sm + nt_pub_off(most));
  float* red = reinterpret_cast<float*>(sm + nt_red_off(most));
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127;
  const size_t off = static_cast<size_t>(b) * p * n;

  // X's columns into the tiles (zero past p and n), and ||X||_F^2 over the
  // cluster.
  float sq = 0.f;
  const int quads = cnt * kNtP * 16;
  for (int u0 = tid; u0 < quads; u0 += kNtLoads * kThreads) {
    float v[kNtLoads][4];
#pragma unroll
    for (int k = 0; k < kNtLoads; ++k) {
      const int u = u0 + k * kThreads, j = u / (kNtP * 16), row = (u >> 4) & 63;
#pragma unroll
      for (int e = 0; e < 4; ++e) v[k][e] = 0.f;
      if (u < quads && row < p)
        gload4(v[k], x + off + static_cast<size_t>(row) * n, (c_lo + j) * kNtChunk + 4 * (u & 15),
               n, vec);
    }
#pragma unroll
    for (int k = 0; k < kNtLoads; ++k) {
      const int u = u0 + k * kThreads, j = u / (kNtP * 16), row = (u >> 4) & 63;
      if (u >= quads) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) sq = fmaf(v[k][e], v[k][e], sq);
      *reinterpret_cast<float4*>(sm + j * kNtTile + tc_off(row, 4 * (u & 15))) =
          make_float4(v[k][0], v[k][1], v[k][2], v[k][3]);
    }
  }
  const float cta_sq = block_sum(sq, red);
  if (tid == 0) red[8] = cta_sq;
  hopper::cluster_sync();
  float tot = 0.f;
  for (int k = 0; k < c; ++k) tot += hopper::ld_peer(hopper::map_peer(red + 8, k));
  const float f = fmaxf(sqrtf(tot), 1e-30f);
  for (int u = tid; u < cnt * kNtP * 16; u += kThreads) {  // the elements this thread loaded
    const int j = u / (kNtP * 16), row = (u >> 4) & 63, col = 4 * (u & 15);
    float4* y = reinterpret_cast<float4*>(sm + j * kNtTile + tc_off(row, col));
    const float4 v = *y;
    *y = make_float4(v.x / f, v.y / f, v.z / f, v.w / f);
  }
  hopper::fence_proxy_async_smem();
  __syncthreads();

  // G of Y_0, then one sweep an iteration: each chunk updated from G and its
  // share of the next gram summed (not after the last unless dist is asked).
  float u[32], g[16];
#pragma unroll
  for (int i = 0; i < 32; ++i) u[i] = 0.f;
  for (int j = wg; j < cnt; j += 2) {
    float pu[32];
    gram_product(pu, sm + j * kNtTile);
#pragma unroll
    for (int i = 0; i < 32; ++i) u[i] += pu[i];
  }
  cluster_gram(u, us, pub, c, rank, g, gh, gl);
  for (int it = 0; it < iters; ++it) {
    const bool last = it + 1 == iters, gram = !last || dist != nullptr;
#pragma unroll
    for (int i = 0; i < 32; ++i) u[i] = 0.f;
    for (int j = wg; j < cnt; j += 2) {
      unsigned char* tile = sm + j * kNtTile;
      float d[32];  // (G Y)^T: element (m, row) is (G Y)'s (row, m)
      update_product(d, tile, gh, gl);
      hopper::named_sync(kNtGroupBar + wg, 128);  // every warp has read the tile
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float& y = tc_at(tile, acc_col(wt, i), acc_row(wt, i));
        y = 1.5f * y - 0.5f * d[i];
      }
      if (!gram) continue;
      hopper::fence_proxy_async_smem();
      hopper::named_sync(kNtGroupBar + wg, 128);  // Y' is the gram's operand
      float pu[32];
      gram_product(pu, tile);
#pragma unroll
      for (int i = 0; i < 32; ++i) u[i] += pu[i];
    }
    if (gram) cluster_gram(u, us, pub + ((it + 1) & 1) * kNtPub, c, rank, g, last ? nullptr : gh, gl);
  }

  if (dist != nullptr) {  // ||G - I||_F over the p x p block, from the last G
    float acc = 0.f;
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int r = quad_row(tid, q / 4), cc = quad_col(tid, q / 4) + q % 4;
      const float w = g[q] - (r == cc ? 1.f : 0.f);
      if (r < p && cc < p) acc = fmaf(w, w, acc);
    }
    const float tot2 = block_sum(acc, red);
    if (rank == 0 && tid == 0) dist[b] = sqrtf(tot2);
  }
  __syncthreads();  // every warpgroup's last Y is in its tiles
  for (int u2 = tid; u2 < cnt * kNtP * 16; u2 += kThreads) {
    const int j = u2 / (kNtP * 16), row = (u2 >> 4) & 63, col = 4 * (u2 & 15);
    if (row >= p) continue;
    const float4 v4 = *reinterpret_cast<const float4*>(sm + j * kNtTile + tc_off(row, col));
    const float v[4] = {v4.x, v4.y, v4.z, v4.w};
    gstore4(out + off + static_cast<size_t>(row) * n, (c_lo + j) * kNtChunk + col, n, vec, v);
  }
  hopper::cluster_sync();  // no CTA leaves while a partner may read its buffers
}

}  // namespace

extern "C" {

// The cluster size for n (0: n too wide) and one CTA's shared memory
// (ops.py mirrors both).
int ns_tc_cluster(int n) { return n < 1 ? 0 : nt_cluster(n); }

int ns_tc_smem_bytes(int n) {
  const int c = ns_tc_cluster(n);
  return c == 0 ? 0 : nt_smem_bytes(((n + kNtChunk - 1) / kNtChunk + c - 1) / c);
}

// x, out: (B, p, n) fp32, p <= 64, n up to kNtCluster x kNtChunks x 64
// (out may be x); mask: (B,) bytes or null (every matrix); dist: (B,) fp32
// written for the matrices processed, or null.
int newton_schulz_tc(const float* x, float* out, const unsigned char* mask, float* dist, int B,
                     int p, int n, int iters, cudaStream_t stream) {
  int c = ns_tc_cluster(n);
  if (B < 0 || p < 1 || p > kNtP || c == 0 || iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = ns_tc_smem_bytes(n);
  const void* kernel = reinterpret_cast<const void*>(ns_tc_kernel);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B > 0) {
    const void* ptrs[2] = {x, out};
    int vec = vector_ok(n, ptrs, 2);
    void* args[] = {&x, &out, &mask, &dist, &p, &n, &iters, &c, &vec};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = c;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(B * c);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelExC(&cfg, kernel, args);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
