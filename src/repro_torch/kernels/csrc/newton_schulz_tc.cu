// Batched Newton-Schulz polar projection for Hopper (sm_90a) on the tensor
// cores: the feasibility watchdog's drift repair for p <= 64 stacks whose
// matrices do not fit one block whole (the trainer's q/k, 640 x (64, 960)),
// and, in the second part of this file (ns_tc128_kernel), for 64 < p <= 128
// (internlm2-1.8b's q/k, 576 x (128, 2048)), and in the third
// (ns_stream_kernel) for the same p past n = 2048 (starcoder2-15b's q/k,
// 2080 x (128, 6144)).
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

#include <mutex>
#include <vector>

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

// ---------------------------------------------------------------------------
// The same function for 64 < p <= 128 (internlm2-1.8b's q/k, 576 x (128,
// 2048)): ns_tc128_kernel. Bound at that shape, 12 iterations: 10 p^2 n of
// TF32 work an iteration as counted above, 4.685 ms at 495 TFLOP/s; two HBM
// passes 0.36 ms. Operations bound it.
//
// Why not a second instance of ns_tc_kernel: at p = 128 a 64-column chunk
// (128 rows) is 32 KB and G's hi and lo tiles are 128 KB, so with every
// CTA reading every partner's whole P (64 KB each) and keeping G beside Y,
// a cluster of 8 would need 128 KB of Y a CTA beside G: over the 227 KB of
// a block. This kernel's layout:
// * Clusters of up to 16 CTAs (non-portable,
//   cudaFuncAttributeNonPortableClusterSizeAllowed), at most two 64-column
//   chunks a CTA, one for each warpgroup: n <= 2048 at 16. Shared memory:
//   the chunks (64 KB), G hi and lo (128 KB), the CTA's slice of the summed
//   gram (64 KB / c), 196 KB at (128, 2048).
// * An iteration: each warpgroup updates its chunk, D = Y^T G, m64n128k8
//   products over K = p rounded up to 32 (rows past p are zero), four k8
//   steps a group, each group's 3xTF32 products from zero and added to fp32
//   sums in registers; then both warpgroups take the gram over both chunks,
//   warpgroup w rows 64 w .. 64 w + 63 of U = (Y_h / 2 + Y_l) Y_h^T
//   (m64n128k8 against the chunk itself), each chunk's products from zero.
// * The gram meets in four steps, G's own space reused for the exchange:
//   U into G lo's 64 KB (row-major, 16-byte quads swizzled by row, so that
//   the transposed reads and the accumulators' stores hit distinct banks),
//   P = U + U^T into G hi's; a cluster barrier; reduce-scatter, CTA r
//   summing rows r R .. r R + R - 1 (R = 128 / c) of every CTA's P by
//   16-byte DSMEM loads, eight in flight, into its slice; a second cluster
//   barrier; every CTA gathers the c slices and writes G hi and lo. Each
//   CTA reads 64 KB of partners' P and 64 KB of slices an iteration, not c
//   x 64 KB; each slice is summed by one CTA, so every CTA gets the same
//   bits (G symmetric to rounding). Both steps stagger the partners they
//   read, a warp's lanes together: an SM that every partner reads at once
//   serves them in turn. On an H100 at 576 x (128, 2048) the gather's
//   stagger took 1.0 ms off the kernel and the reduce's 1.0 ms more; the
//   reduce's lanes each on another partner, which scatters a warp's loads
//   over the cluster, lost 0.7 ms. The slice is written again only after
//   the next iteration's first barrier, which every partner passes after
//   its gather.
// * A persistent grid of min(B, clusters resident) clusters walks the
//   stack. The CTAs of a cluster read the same mask byte and skip a matrix
//   that did not trip without a barrier, so the idle repair reads B bytes;
//   a matrix they do process ends in a cluster barrier, after which no
//   partner reads the CTA's slice or norm from it.
// out may alias x: a CTA reads its columns before it writes them.

constexpr int kN8P = 128;                  // rows of a tile
constexpr int kN8Box = kN8P * 128;         // 128 rows x 32 fp32 columns
constexpr int kN8Tile = 2 * kN8Box;        // a 64-column chunk
constexpr int kN8G = 4 * kN8Box;           // a 128 x 128 operand (G hi, G lo)
constexpr int kN8Chunks = 2;               // chunks a CTA keeps: one a warpgroup
constexpr int kN8MinCluster = 2;           // the slice (64 KB / c) fits from c = 2
constexpr int kN8Cluster = 16;             // non-portable above 8

// Byte offsets past a CTA's `chunks` tiles: G hi, G lo, the slice, the
// reduction scratch.
__host__ __device__ inline int n8_g_off(int chunks) { return chunks * kN8Tile; }
__host__ __device__ inline int n8_slice_off(int chunks) { return n8_g_off(chunks) + 2 * kN8G; }
__host__ __device__ inline int n8_red_off(int chunks, int c) {
  return n8_slice_off(chunks) + kN8G / c;
}
__host__ __device__ inline int n8_smem_bytes(int chunks, int c) {
  return n8_red_off(chunks, c) + 64 + 1024;
}

// The cluster size for n: the least power of two from kN8MinCluster to
// kN8Cluster that leaves a CTA at most kN8Chunks chunks; 0 when none does.
__host__ __device__ inline int n8_cluster(int n) {
  const int nch = (n + kNtChunk - 1) / kNtChunk;
  for (int c = kN8MinCluster; c <= kN8Cluster; c *= 2)
    if ((nch + c - 1) / c <= kN8Chunks) return c;
  return 0;
}

// Byte offset of element (row, col) of a 128-row tile (two or four 128 x
// 32 boxes, 128-byte swizzled), and its descriptor at k8 step kk.
__device__ inline int n8_off(int row, int col) {
  return (col >> 5) * kN8Box + row * 128 + ((((col & 31) >> 2) ^ (row & 7)) << 4) +
         ((col & 3) << 2);
}

__device__ inline float& n8_at(unsigned char* tile, int row, int col) {
  return *reinterpret_cast<float*>(tile + n8_off(row, col));
}

__device__ inline uint64_t n8_desc(const unsigned char* tile, int kk) {
  return hopper::sw128_desc(tile + (kk >> 2) * kN8Box + (kk & 3) * 32, 16, 1024);
}

// Index of U's element (r, c) in the exchange's row-major 128 x 128 buffer:
// quad c / 4 of row r swizzled by r / 4 (eight lanes reading quad j of rows
// 4 j + e hit eight bank groups) and by r % 4 (the accumulator's four rows
// a phase of 64-bit stores writes, too).
__device__ inline int n8_u(int r, int c) {
  return r * kN8P + ((((c >> 2) ^ (r >> 2) ^ ((r & 3) << 1)) & 31) << 2) + (c & 3);
}

// The twelve products of k8 steps 4 h .. 4 h + 3 of d = Y^T G into acc
// (3xTF32, small terms first; from zero when `zero`), the fragments fh and
// fl Y^T's hi and lo pieces; waits.
template <int NR>
__device__ __forceinline__ void n8_update_issue(float (&acc)[NR], uint32_t (&fh)[4][4],
                                                uint32_t (&fl)[4][4], const unsigned char* gh,
                                                const unsigned char* gl, int h, bool zero) {
  hopper::fence_regs(acc);
#pragma unroll
  for (int k4 = 0; k4 < 4; ++k4) {
    hopper::fence_regs(fh[k4]);
    hopper::fence_regs(fl[k4]);
  }
  hopper::wgmma_fence();
#pragma unroll
  for (int k4 = 0; k4 < 4; ++k4) {
    const int kk = 4 * h + k4;
    hopper::wgmma_tf32_rs(acc, fh[k4][0], fh[k4][1], fh[k4][2], fh[k4][3], n8_desc(gl, kk),
                          !zero || k4 > 0);
    hopper::wgmma_tf32_rs(acc, fl[k4][0], fl[k4][1], fl[k4][2], fl[k4][3], n8_desc(gh, kk), 1);
  }
#pragma unroll
  for (int k4 = 0; k4 < 4; ++k4)
    hopper::wgmma_tf32_rs(acc, fh[k4][0], fh[k4][1], fh[k4][2], fh[k4][3],
                          n8_desc(gh, 4 * h + k4), 1);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);
#pragma unroll
  for (int k4 = 0; k4 < 4; ++k4) {
    hopper::fence_regs(fh[k4]);
    hopper::fence_regs(fl[k4]);
  }
}

// d = Y^T G over the first `groups` 32-row slabs, Y^T the register A
// operand whose element (m, k) is the tile's (k, m), G's hi and lo rows
// from gh and gl on (2 NR of them: the product's N); t is the thread's
// index in its warpgroup. kPartials: each group's products start from zero
// and are added to fp32 sums in registers (ns_tc128_kernel, where the
// partials' registers are free); else every product goes into d itself;
// waits.
template <int NR, bool kPartials>
__device__ __forceinline__ void n8_update_product(float (&d)[NR], unsigned char* tile,
                                                  const unsigned char* gh,
                                                  const unsigned char* gl, int groups, int t) {
  const int m0 = 16 * (t >> 5) + ((t & 31) >> 2), k0 = t & 3;
  if (kPartials) {
#pragma unroll
    for (int i = 0; i < NR; ++i) d[i] = 0.f;
  }
  for (int h = 0; h < groups; ++h) {
    uint32_t fh[4][4], fl[4][4];
#pragma unroll
    for (int k4 = 0; k4 < 4; ++k4) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float hi, lo;
        split(n8_at(tile, 32 * h + 8 * k4 + k0 + 4 * (r >> 1), m0 + 8 * (r & 1)), hi, lo);
        fh[k4][r] = __float_as_uint(hi);
        fl[k4][r] = __float_as_uint(lo);
      }
    }
    if constexpr (kPartials) {
      float pd[NR];
      n8_update_issue(pd, fh, fl, gh, gl, h, true);
#pragma unroll
      for (int i = 0; i < NR; ++i) d[i] += pd[i];
    } else {
      n8_update_issue(d, fh, fl, gh, gl, h, h == 0);
    }
  }
}

// The warpgroup's chunk updated in place: Y' = 1.5 Y - 0.5 G Y, through d =
// Y^T G over all 128 columns of G.
__device__ void n8_update(unsigned char* tile, const unsigned char* gh, const unsigned char* gl,
                          int groups) {
  const int t = threadIdx.x & 127;
  float d[64];
  n8_update_product<64, true>(d, tile, gh, gl, groups, t);
  hopper::named_sync(kNtGroupBar + (threadIdx.x >> 7), 128);  // every warp has read the tile
#pragma unroll
  for (int i = 0; i < 64; ++i) {  // d's element (m, row) is (G Y)'s (row, m)
    float& y = n8_at(tile, acc_col(t, i), acc_row(t, i));
    y = 1.5f * y - 0.5f * d[i];
  }
}

// u += warpgroup tid / 128's rows of the chunk's share of U, one 64-column
// half at a time (m64n64k8 against the chunk's rows 64 nh on), each half's
// products from zero: 32 registers of partial sums, not 64, beside u
// (ns_stream_kernel keeps u across its chunk loop); waits.
__device__ __forceinline__ void n8_gram_add(float (&u)[64], unsigned char* tile, int tid) {
  const int t = tid & 127, m0 = 64 * (tid >> 7) + 16 * (t >> 5) + ((t & 31) >> 2);
  const int k0 = t & 3;
#pragma unroll
  for (int nh = 0; nh < 2; ++nh) {
    const unsigned char* rows = tile + nh * 64 * 128;
    float pu[32];
    for (int h = 0; h < 2; ++h) {
      uint32_t fh[4][4], fl[4][4];
#pragma unroll
      for (int k4 = 0; k4 < 4; ++k4) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float v = n8_at(tile, m0 + 8 * (r & 1), 32 * h + 8 * k4 + k0 + 4 * (r >> 1));
          fh[k4][r] = __float_as_uint(0.5f * tf32_trunc(v));
          fl[k4][r] = __float_as_uint(trunc_lo(v));
        }
      }
      hopper::fence_regs(pu);
#pragma unroll
      for (int k4 = 0; k4 < 4; ++k4) {
        hopper::fence_regs(fh[k4]);
        hopper::fence_regs(fl[k4]);
      }
      hopper::wgmma_fence();
#pragma unroll
      for (int k4 = 0; k4 < 4; ++k4)
        hopper::wgmma_tf32_rs(pu, fl[k4][0], fl[k4][1], fl[k4][2], fl[k4][3],
                              n8_desc(rows, 4 * h + k4), h > 0 || k4 > 0);
#pragma unroll
      for (int k4 = 0; k4 < 4; ++k4)
        hopper::wgmma_tf32_rs(pu, fh[k4][0], fh[k4][1], fh[k4][2], fh[k4][3],
                              n8_desc(rows, 4 * h + k4), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(pu);
#pragma unroll
      for (int k4 = 0; k4 < 4; ++k4) {
        hopper::fence_regs(fh[k4]);
        hopper::fence_regs(fl[k4]);
      }
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) u[32 * nh + i] += pu[i];
  }
}

// u = this warpgroup's rows 64 w .. 64 w + 63 of U = (Y_h / 2 + Y_l) Y_h^T
// over the CTA's `cnt` chunks, each chunk's products from zero.
__device__ void n8_gram(float (&u)[64], unsigned char* sm, int cnt) {
  const int t = threadIdx.x & 127, m0 = 64 * (threadIdx.x >> 7) + 16 * (t >> 5) + ((t & 31) >> 2);
  const int k0 = t & 3;
#pragma unroll
  for (int i = 0; i < 64; ++i) u[i] = 0.f;
  for (int j = 0; j < cnt; ++j) {
    unsigned char* tile = sm + j * kN8Tile;
    float pu[64];
    for (int h = 0; h < 2; ++h) {
      uint32_t fh[4][4], fl[4][4];
#pragma unroll
      for (int k4 = 0; k4 < 4; ++k4) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float v = n8_at(tile, m0 + 8 * (r & 1), 32 * h + 8 * k4 + k0 + 4 * (r >> 1));
          fh[k4][r] = __float_as_uint(0.5f * tf32_trunc(v));
          fl[k4][r] = __float_as_uint(trunc_lo(v));
        }
      }
      hopper::fence_regs(pu);
#pragma unroll
      for (int k4 = 0; k4 < 4; ++k4) {
        hopper::fence_regs(fh[k4]);
        hopper::fence_regs(fl[k4]);
      }
      hopper::wgmma_fence();
#pragma unroll
      for (int k4 = 0; k4 < 4; ++k4)
        hopper::wgmma_tf32_rs(pu, fl[k4][0], fl[k4][1], fl[k4][2], fl[k4][3],
                              n8_desc(tile, 4 * h + k4), h > 0 || k4 > 0);
#pragma unroll
      for (int k4 = 0; k4 < 4; ++k4)
        hopper::wgmma_tf32_rs(pu, fh[k4][0], fh[k4][1], fh[k4][2], fh[k4][3],
                              n8_desc(tile, 4 * h + k4), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(pu);
#pragma unroll
      for (int k4 = 0; k4 < 4; ++k4) {
        hopper::fence_regs(fh[k4]);
        hopper::fence_regs(fl[k4]);
      }
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) u[i] += pu[i];
  }
}

// The cluster's gram G = sum_r (U_r + U_r^T) from the warpgroups' rows u
// of this CTA's U, as the header above says: written hi and lo into gh and
// gl when `write`, and with `dist` (rank 0 alone) ||G - I||_F over the p x p
// block into *dist. kStream (ns_stream_kernel, one CTA a matrix, so slice,
// c and rank go unused) adds two things. P, which is G, goes from its
// row-major place in gh to gl's swizzled one, from which each thread writes
// its own quads hi and lo, with no cluster barrier and no DSMEM read. The
// prescale (`prescale`): u is then the gram of X itself, f = max(sqrt of
// its trace, 1e-30), and G becomes G / f / f, the gram of X / f. Returns f
// (1 without the prescale).
template <bool kStream>
__device__ float n8_exchange(const float (&u)[64], unsigned char* gh, unsigned char* gl,
                             float* slice, float* red, int c, int rank, int p, bool write,
                             float* dist, bool prescale = false) {
  const int tid = threadIdx.x, wt = tid & 127, r0 = 64 * (tid >> 7);
  float* us = reinterpret_cast<float*>(gl);
  float* pub = reinterpret_cast<float*>(gh);
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int r = r0 + acc_row(wt, i), cc = acc_col(wt, i);
    *reinterpret_cast<float2*>(us + n8_u(r, cc)) = make_float2(u[i], u[i + 1]);
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < 4; ++q) {  // 4 x 4 blocks: P(bi, bj) = U(bi, bj) + U(bj, bi)^T
    const int blk = tid + kThreads * q, bi = blk >> 5, bj = blk & 31;
    float4 a[4], b[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      a[e] = *reinterpret_cast<const float4*>(us + n8_u(4 * bi + e, 4 * bj));
      b[e] = *reinterpret_cast<const float4*>(us + n8_u(4 * bj + e, 4 * bi));
    }
    const float bt[4][4] = {{b[0].x, b[1].x, b[2].x, b[3].x},
                            {b[0].y, b[1].y, b[2].y, b[3].y},
                            {b[0].z, b[1].z, b[2].z, b[3].z},
                            {b[0].w, b[1].w, b[2].w, b[3].w}};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      *reinterpret_cast<float4*>(pub + (4 * bi + e) * kN8P + 4 * bj) =
          make_float4(a[e].x + bt[e][0], a[e].y + bt[e][1], a[e].z + bt[e][2], a[e].w + bt[e][3]);
  }
  const int rows = kN8P / c, quads = rows * (kN8P / 4);
  float tr = 0.f;  // the prescale's trace, this thread's share
  if (kStream) {
    __syncthreads();  // every quad of P is written
    // The quads that this thread gathers below, into gl (U is spent).
#pragma unroll
    for (int s = 0; s < 16; ++s) {
      const int row = (tid >> 5) + 8 * s, col = 4 * (tid & 31);
      const float4 v = *reinterpret_cast<const float4*>(pub + row * kN8P + col);
      *reinterpret_cast<float4*>(gl + n8_off(row, col)) = v;
      const float e4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (row == col + e) tr += e4[e];
    }
  } else {
    hopper::cluster_sync();  // every CTA's P is published
    for (int qi = tid; qi < quads; qi += kThreads) {  // this CTA's slice
      const float* at = pub + (rank * rows + (qi >> 5)) * kN8P + 4 * (qi & 31);
      // The partners from (rank + row) mod c on, the same for a warp's
      // lanes (its loads go to one SM at a time) and different for the warps
      // and the CTAs; eight loads in flight, then their sum.
      const int first = rank + (qi >> 5);
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int j0 = 0; j0 < kN8Cluster; j0 += 8) {
        float4 v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int k = (first + j0 + j) & (c - 1);
          if (j0 + j < c)
            v[j] = k == rank ? *reinterpret_cast<const float4*>(at)
                             : hopper::ld_peer4(hopper::map_peer(at, k));
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (j0 + j < c) {
            sum.x += v[j].x;
            sum.y += v[j].y;
            sum.z += v[j].z;
            sum.w += v[j].w;
          }
        }
      }
      *reinterpret_cast<float4*>(slice + (qi >> 5) * kN8P + 4 * (qi & 31)) = sum;
    }
  }
  float f = 1.f;
  if (kStream && prescale) f = fmaxf(sqrtf(block_sum(tr, red)), 1e-30f);
  if (kStream)
    __syncthreads();  // every quad of P is read: gh takes G's hi pieces
  else
    hopper::cluster_sync();  // every slice is summed; no CTA reads P any more
  if (write || dist != nullptr) {
    // Thread t's 16 quads, column 4 (t % 32) of rows t / 32 + 8 s, s in
    // turn from s = t / 32 + rank 16 / c on, so that the warps of a CTA, and
    // the CTAs, read different owners at once; eight in flight at a time.
    constexpr int kHalf = kN8P * kN8P / 4 / kThreads / 2;
    const int turn = (tid >> 5) + rank * (rows >> 3);
    float acc = 0.f;
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {
      float4 g4[kHalf];
#pragma unroll
      for (int s = 0; s < kHalf; ++s) {
        const int row = (tid >> 5) + 8 * ((turn + s + kHalf * h) & 15);
        if (kStream) {
          g4[s] = *reinterpret_cast<const float4*>(gl + n8_off(row, 4 * (tid & 31)));
        } else {
          const int owner = row / rows;
          const float* at = slice + (row - owner * rows) * kN8P + 4 * (tid & 31);
          g4[s] = owner == rank ? *reinterpret_cast<const float4*>(at)
                                : hopper::ld_peer4(hopper::map_peer(at, owner));
        }
      }
#pragma unroll
      for (int s = 0; s < kHalf; ++s) {
        const int row = (tid >> 5) + 8 * ((turn + s + kHalf * h) & 15), col = 4 * (tid & 31);
        float v[4] = {g4[s].x, g4[s].y, g4[s].z, g4[s].w};
        if (kStream && prescale) {
#pragma unroll
          for (int e = 0; e < 4; ++e) v[e] = v[e] / f / f;
        }
        if (write) {
          float hi[4], lo[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) split(v[e], hi[e], lo[e]);
          *reinterpret_cast<float4*>(gh + n8_off(row, col)) = make_float4(hi[0], hi[1], hi[2], hi[3]);
          *reinterpret_cast<float4*>(gl + n8_off(row, col)) = make_float4(lo[0], lo[1], lo[2], lo[3]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float w = v[e] - (row == col + e ? 1.f : 0.f);
          if (row < p && col + e < p) acc = fmaf(w, w, acc);
        }
      }
    }
    if (dist != nullptr) {
      const float tot = block_sum(acc, red);
      if (tid == 0) *dist = sqrtf(tot);
    }
  }
  hopper::fence_proxy_async_smem();  // G's tiles are the next sweep's wgmma operands
  __syncthreads();
  return f;
}

// A persistent grid of clusters of c CTAs (grid a multiple of c), cluster
// blockIdx.x / c taking matrices blockIdx.x / c, + gridDim.x / c, ...
__global__ void __launch_bounds__(kThreads, 1)
ns_tc128_kernel(const float* x, float* out, const unsigned char* mask, float* dist, int B, int p,
                int n, int iters, int c, int vec) {
  extern __shared__ unsigned char ns_tc_smem[];
  unsigned char* sm = hopper::smem_align1024(ns_tc_smem);
  const int rank = static_cast<int>(hopper::cluster_rank());
  const int nch = (n + kNtChunk - 1) / kNtChunk, most = (nch + c - 1) / c;
  const int c_lo = rank * nch / c, cnt = (rank + 1) * nch / c - c_lo;  // this CTA's chunks
  unsigned char* gh = sm + n8_g_off(most);
  unsigned char* gl = gh + kN8G;
  float* slice = reinterpret_cast<float*>(sm + n8_slice_off(most));
  float* red = reinterpret_cast<float*>(sm + n8_red_off(most, c));
  const int tid = threadIdx.x, wg = tid >> 7;
  const int groups = (p + 31) / 32, quads = cnt * kN8P * 16;

  for (int b = blockIdx.x / c; b < B; b += gridDim.x / c) {
    if (mask != nullptr && mask[b] == 0) continue;  // the whole cluster, before any barrier
    const size_t off = static_cast<size_t>(b) * p * n;

    // X's columns into the tiles (zero past p and n), ||X||_F^2 over the
    // cluster.
    float sq = 0.f;
    for (int u0 = tid; u0 < quads; u0 += kNtLoads * kThreads) {
      float v[kNtLoads][4];
#pragma unroll
      for (int k = 0; k < kNtLoads; ++k) {
        const int u = u0 + k * kThreads, j = u / (kN8P * 16), row = (u >> 4) & (kN8P - 1);
#pragma unroll
        for (int e = 0; e < 4; ++e) v[k][e] = 0.f;
        if (u < quads && row < p)
          gload4(v[k], x + off + static_cast<size_t>(row) * n,
                 (c_lo + j) * kNtChunk + 4 * (u & 15), n, vec);
      }
#pragma unroll
      for (int k = 0; k < kNtLoads; ++k) {
        const int u = u0 + k * kThreads, j = u / (kN8P * 16), row = (u >> 4) & (kN8P - 1);
        if (u >= quads) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) sq = fmaf(v[k][e], v[k][e], sq);
        *reinterpret_cast<float4*>(sm + j * kN8Tile + n8_off(row, 4 * (u & 15))) =
            make_float4(v[k][0], v[k][1], v[k][2], v[k][3]);
      }
    }
    const float cta_sq = block_sum(sq, red);
    if (tid == 0) red[8] = cta_sq;
    hopper::cluster_sync();
    float tot = 0.f;
    for (int k = 0; k < c; ++k) tot += hopper::ld_peer(hopper::map_peer(red + 8, k));
    const float f = fmaxf(sqrtf(tot), 1e-30f);
    for (int u = tid; u < quads; u += kThreads) {  // the elements this thread loaded
      const int j = u / (kN8P * 16), row = (u >> 4) & (kN8P - 1);
      float4* y = reinterpret_cast<float4*>(sm + j * kN8Tile + n8_off(row, 4 * (u & 15)));
      const float4 v = *y;
      *y = make_float4(v.x / f, v.y / f, v.z / f, v.w / f);
    }
    hopper::fence_proxy_async_smem();
    __syncthreads();

    // G of Y_0, then an update and (but after the last, unless dist is
    // asked) a gram an iteration.
    float* dst = rank == 0 && dist != nullptr ? dist + b : nullptr;
    float u[64];
    if (iters > 0 || dist != nullptr) {
      n8_gram(u, sm, cnt);
      n8_exchange<false>(u, gh, gl, slice, red, c, rank, p, iters > 0,
                         iters == 0 ? dst : nullptr);
    }
    for (int it = 0; it < iters; ++it) {
      const bool last = it + 1 == iters;
      if (wg < cnt) n8_update(sm + wg * kN8Tile, gh, gl, groups);
      hopper::fence_proxy_async_smem();
      __syncthreads();  // every chunk's Y' is the gram's operand
      if (last && dist == nullptr) break;
      n8_gram(u, sm, cnt);
      n8_exchange<false>(u, gh, gl, slice, red, c, rank, p, !last, last ? dst : nullptr);
    }

    for (int u2 = tid; u2 < quads; u2 += kThreads) {
      const int j = u2 / (kN8P * 16), row = (u2 >> 4) & (kN8P - 1), col = 4 * (u2 & 15);
      if (row >= p) continue;
      const float4 v4 = *reinterpret_cast<const float4*>(sm + j * kN8Tile + n8_off(row, col));
      const float v[4] = {v4.x, v4.y, v4.z, v4.w};
      gstore4(out + off + static_cast<size_t>(row) * n, (c_lo + j) * kNtChunk + col, n, vec, v);
    }
    hopper::cluster_sync();  // no partner reads this CTA's slice or norm any more
  }
}

// The launch's shared memory, and clusters past the portable 8.
cudaError_t n8_attributes(const void* kernel, int smem, int c) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && c > 8)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

// ---------------------------------------------------------------------------
// Row 9s: the same function for 64 < p <= 128 past n = 2048, at n % 4 ==
// 0 (starcoder2-15b's, granite-20b's and mixtral-8x22b's q/k, (128, 6144)):
// ns_stream_kernel. Y is too wide for a cluster to hold (at n = 6144 a CTA of
// 16 would need 192 KB of it beside G's 128 KB), so it streams: each
// iteration a CTA reads the matrix's chunks of Y from HBM (or L2) once and
// writes them back once.
//
// Bound at 2080 x (128, 6144), 12 iterations: 10 p^2 n of TF32 work an
// iteration as counted above, 50.76 ms at 495 TFLOP/s (row 9's fp32 CUDA-
// core bound 112.50 ms); bytes 3.91 ms for 2 HBM passes, 48.83 ms for the 25
// that 13 reads and 12 writes of Y make when no sweep hits L2 (one matrix an
// SM keeps 413 MB in flight, so none does). Operations bound it.
//
// Design:
// * One matrix a CTA, a persistent grid of one CTA an SM walking the stack
//   (b = blockIdx.x, + gridDim.x, ...). Clusters of 2 to 16 CTAs a matrix,
//   each streaming a share of the chunks and summing the gram over DSMEM as
//   ns_tc128_kernel does, read no faster at the configurations' n
//   (the readings beside ops.NS_STREAM_STAGES).
// * The chunks stream through a ring of kNsStages 32 KB stages, each a
//   128 x 64 fp32 chunk TMA-loaded as two 128 x 32 boxes in the 128-byte
//   swizzle the wgmma descriptors read (rows past p and columns past n
//   zero-filled), with a full and an empty mbarrier. Thread 0 is the ring's
//   producer (NsRing): at the start of each chunk it waits until every warp
//   has released the chunk before (its empty barrier) and that chunk's TMA
//   store has left the stage, then loads the chunk kNsStages - 1 ahead into
//   it. (A producer warp of its own would have to join every block barrier
//   of the exchange; the stage frees no sooner for it.)
// * Sweeps: a matrix takes iters + 1 (2 at iters = 0). Sweep 0 reads X and
//   sums its gram alone; the exchange then takes f from the gram's trace
//   and scales G by 1 / f^2, so that X is not read an extra time for its
//   norm (as large_p.cu's route does). Sweep 1 reads X again and divides
//   each chunk by f in place (Y_0 = X / f, as the plain version rounds
//   it); the sweeps after it read `out`. A sweep from 1 on updates each
//   chunk in its stage from the previous iterate's complete G, Y' = 1.5 Y
//   - 0.5 G Y, both warpgroups on every chunk: warpgroup w forms rows 64 w
//   .. 64 w + 63 of G Y (m64n64k8, Y^T the register operand, G's rows 64 w
//   on the B side), and after a barrier writes them over the chunk. A TMA
//   store sends the chunk to `out`, while the warpgroups add its share of
//   the next gram to their rows of U (n8_gram_add). One read and one write
//   of Y an iteration, and no second sweep for the gram.
// * Registers: U's 64 sums a thread stay live through every chunk, so the
//   chunk's gram is taken one 64-column half at a time (32 partial sums,
//   not 64), the update's products go straight into its 32 sums (no
//   partials: 48 products a sum, where 9tc's take 24), and the operand
//   addresses come from an opaque thread index each chunk rather than being
//   kept across the loop. On an H100 at 2080 x (128, 6144), without the
//   three the kernel spilled 1120 bytes and read 164.34 ms; with the last
//   two 728 bytes, 137.68 ms; with all three it keeps 252 registers, spills
//   none and reads 111.99 ms.
// * The exchange after each sweep is ns_tc128_kernel's (n8_exchange), local
//   to the CTA: no cluster barrier, no DSMEM read.
// * A load from `out` reads what a TMA store of the sweep before wrote:
//   thread 0 waits for its stores to complete (cp.async.bulk.wait_group)
//   before such a load whenever one of them may still be in flight, once
//   a sweep. The ring must not reach into the next sweep's copy of a chunk
//   before this sweep has stored it, so a matrix needs at least kNsStages
//   chunks (n > 128).
// * The mask: a CTA, and thread 0's loads, skip a matrix that did not trip;
//   an idle launch reads B mask bytes.
// Shared memory: the ring, G hi and lo (64 KB each), the reduction scratch
// and the mbarriers; out may alias x (a chunk is read before it is written,
// and X is read only in sweeps 0 and 1).

constexpr int kNsStages = 3;
constexpr int kNsSmemBytes = kNsStages * kN8Tile + 2 * kN8G + 64 + 16 * kNsStages + 1024;
static_assert(kNsSmemBytes <= kSmemLimit, "the ring, G and the scratch fit a block");

// Where the ring's producer stands: chunk k of sweep s of matrix b, the
// matrices of this CTA that the mask keeps, in order.
struct NsCursor {
  int b, s, k;
  __device__ void skip(const unsigned char* mask, int B, int stride) {
    while (b < B && mask != nullptr && mask[b] == 0) b += stride;
  }
  __device__ void next(const unsigned char* mask, int B, int stride, int sweeps, int nch) {
    if (++k < nch) return;
    k = 0;
    if (++s < sweeps) return;
    s = 0;
    b += stride;
    skip(mask, B, stride);
  }
};

// The ring's producer, thread 0 of a CTA: where its loads stand (ld), and
// the items whose TMA stores are known complete (those before `stored`).
struct NsRing {
  const CUtensorMap* tm_x;
  const CUtensorMap* tm_out;
  unsigned char* sm;
  uint64_t* full;
  uint64_t* empty;
  const unsigned char* mask;
  int B, stride, sweeps, nch;
  NsCursor ld;
  int stored;

  // Chunk ld.k of sweep ld.s of matrix ld.b into stage st (sweeps 0 and 1
  // read X, the later ones out).
  __device__ void load(int st) {
    const CUtensorMap* map = ld.s < 2 ? tm_x : tm_out;
    unsigned char* stage = sm + st * kN8Tile;
    const int col = ld.k * kNtChunk;
    hopper::mbar_expect_tx(&full[st], kN8Tile);
    hopper::tma_load_4d(stage, map, &full[st], col, 0, ld.b, 0);
    hopper::tma_load_4d(stage + kN8Box, map, &full[st], col + 32, 0, ld.b, 0);
    ld.next(mask, B, stride, sweeps, nch);
  }

  __device__ void start() {
    ld.skip(mask, B, stride);
    for (int st = 0; st < kNsStages && ld.b < B; ++st) load(st);
  }

  // At the start of chunk `item` (> 0): the stage of the chunk before takes
  // the chunk kNsStages - 1 ahead, once every warp has released it and its
  // TMA store has left it.
  __device__ void refill(int item) {
    if (ld.b >= B) return;
    const int prev = (item - 1) % kNsStages;
    hopper::mbar_wait(&empty[prev], ((item - 1) / kNsStages) & 1);
    hopper::bulk_wait_read<0>();
    // A load from out reads the store of the same chunk a sweep before (nch
    // items back), which must be complete.
    if (ld.s >= 2 && item - 1 + kNsStages - nch > stored) {
      hopper::bulk_wait<0>();
      hopper::fence_proxy_async();
      stored = item - 1;
    }
    load(prev);
  }
};

__global__ void __launch_bounds__(kThreads, 1)
ns_stream_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_out,
                 const unsigned char* mask, float* dist, int B, int p, int n, int iters) {
  extern __shared__ unsigned char ns_tc_smem[];
  unsigned char* sm = hopper::smem_align1024(ns_tc_smem);
  const int nch = (n + kNtChunk - 1) / kNtChunk;
  unsigned char* gh = sm + kNsStages * kN8Tile;
  unsigned char* gl = gh + kN8G;
  float* red = reinterpret_cast<float*>(gl + kN8G);
  uint64_t* full = reinterpret_cast<uint64_t*>(red + 16);
  uint64_t* empty = full + kNsStages;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int groups = (p + 31) / 32, stride = gridDim.x;
  const int sweeps = (iters > 0 ? iters : 1) + 1;

  if (tid == 0) {
    for (int st = 0; st < kNsStages; ++st) {
      hopper::mbar_init(&full[st], 1);
      hopper::mbar_init(&empty[st], kThreads / 32);  // one arrival a warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  NsRing ring{&tm_x, &tm_out, sm, full, empty, mask, B, stride, sweeps, nch,
              {static_cast<int>(blockIdx.x), 0, 0}, -1};
  if (tid == 0) ring.start();

  int item = 0;  // the chunks this CTA has taken, over the launch
  for (int b = blockIdx.x; b < B; b += stride) {
    if (mask != nullptr && mask[b] == 0) continue;
    float* dst = dist != nullptr ? dist + b : nullptr;
    float f = 1.f;
    for (int s = 0; s < sweeps; ++s) {
      const bool update = s > 0 && iters > 0;
      // the gram of this sweep's output: X's (the prescale), then every
      // iterate's but the last's, unless the distance is asked
      const bool gram = s == 0 || (update && (s < iters || dist != nullptr));
      float u[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) u[i] = 0.f;
      for (int k = 0; k < nch; ++k, ++item) {
        const int st = item % kNsStages;
        if (tid == 0 && item > 0) ring.refill(item);
        hopper::mbar_wait(&full[st], (item / kNsStages) & 1);
        unsigned char* tile = sm + st * kN8Tile;
        // the thread's index, opaque: every operand address derived from it
        // is formed again each chunk, not kept in registers across the loop
        const int me = hopper::opaque(tid), mt = me & 127;
        if (s == 0) {
          n8_gram_add(u, tile, me);
        } else {
          if (s == 1) {  // Y_0 = X / f, in place
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int q = me + kThreads * j, row = q >> 4, col = 4 * (q & 15);
              float4* y = reinterpret_cast<float4*>(tile + n8_off(row, col));
              const float4 v = *y;
              *y = make_float4(v.x / f, v.y / f, v.z / f, v.w / f);
            }
            __syncthreads();
          }
          if (update) {
            float d[32];  // element (m, r) is (G Y)'s (64 wg + r, m)
            n8_update_product<32, false>(d, tile, gh + 64 * wg * 128, gl + 64 * wg * 128,
                                         groups, mt);
            __syncthreads();  // both warpgroups have read the chunk
#pragma unroll
            for (int i = 0; i < 32; ++i) {
              float& y = n8_at(tile, 64 * wg + acc_col(mt, i), acc_row(mt, i));
              y = 1.5f * y - 0.5f * d[i];
            }
          }
          hopper::fence_proxy_async_smem();  // Y' is the TMA store's and the gram's operand
          __syncthreads();
          if (tid == 0) {
            const int col = k * kNtChunk;
            hopper::tma_store_4d(&tm_out, tile, col, 0, b, 0);
            hopper::tma_store_4d(&tm_out, tile + kN8Box, col + 32, 0, b, 0);
            hopper::bulk_commit();
          }
          if (gram) n8_gram_add(u, tile, me);
        }
        __syncwarp();
        if ((tid & 31) == 0) hopper::mbar_arrive(&empty[st]);
      }
      if (gram) {
        const bool last = s + 1 == sweeps;
        // G for the next sweep's update; the distance from the last G
        // (X / f's at iters = 0)
        const float fs = n8_exchange<true>(u, gh, gl, nullptr, red, 1, 0, p, !last && iters > 0,
                                           iters == 0 || last ? dst : nullptr, s == 0);
        if (s == 0) f = fs;
      }
    }
  }
  if (tid == 0) hopper::bulk_wait<0>();  // every store is complete before the CTA leaves
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

// The cluster size of newton_schulz_tc128 for n (0: n too wide) and one
// CTA's shared memory (ops.py mirrors both).
int ns_tc128_cluster(int n) { return n < 1 ? 0 : n8_cluster(n); }

int ns_tc128_smem_bytes(int n) {
  const int c = ns_tc128_cluster(n);
  return c == 0 ? 0 : n8_smem_bytes(((n + kNtChunk - 1) / kNtChunk + c - 1) / c, c);
}

// The clusters the card keeps resident at once at n, the persistent grid's
// width; -1 for an n the kernel does not take, or minus the CUDA error of
// the query. Under a lock, once a device: the kernel's attributes, for
// its largest shared memory (the function keeps one value for every
// launch) and clusters of 16; once a (device, c, smem): the count. A
// launch after the first costs a lookup.
int ns_tc128_max_clusters(int n) {
  const int c = ns_tc128_cluster(n), smem = ns_tc128_smem_bytes(n);
  if (smem == 0) return -1;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -static_cast<int>(err);
  struct Known {
    int dev, c, smem, clusters;  // c = 0: the device's attributes are set
  };
  static std::mutex lock;
  static std::vector<Known> known;
  const std::lock_guard<std::mutex> hold(lock);
  bool ready = false;
  for (const Known& k : known) {
    if (k.dev == dev && k.c == c && k.smem == smem) return k.clusters;
    ready |= k.dev == dev && k.c == 0;
  }
  const void* kernel = reinterpret_cast<const void*>(ns_tc128_kernel);
  if (!ready) {
    err = n8_attributes(kernel, n8_smem_bytes(kN8Chunks, kN8MinCluster), kN8Cluster);
    if (err != cudaSuccess) return -static_cast<int>(err);
    known.push_back({dev, 0, 0, 0});
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return -static_cast<int>(err);
  known.push_back({dev, c, smem, clusters});
  return clusters;
}

// x, out: (B, p, n) fp32, p <= 128, n <= kN8Cluster x kN8Chunks x 64 (out
// may be x); mask and dist as newton_schulz_tc's. A persistent grid of at
// most ns_tc128_max_clusters clusters of ns_tc128_cluster(n) CTAs.
int newton_schulz_tc128(const float* x, float* out, const unsigned char* mask, float* dist,
                        int B, int p, int n, int iters, cudaStream_t stream) {
  int c = ns_tc128_cluster(n);
  const int smem = ns_tc128_smem_bytes(n);
  if (B < 0 || p < 1 || p > kN8P || smem == 0 || iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int clusters = ns_tc128_max_clusters(n);
  if (clusters < 0) return -clusters;
  if (clusters == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0) {
    const void* kernel = reinterpret_cast<const void*>(ns_tc128_kernel);
    const void* ptrs[2] = {x, out};
    int vec = vector_ok(n, ptrs, 2);
    void* args[] = {&x, &out, &mask, &dist, &B, &p, &n, &iters, &c, &vec};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = c;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((B < clusters ? B : clusters) * c);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelExC(&cfg, kernel, args);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// Row 9s's shared memory a CTA (ops.py mirrors it).
int ns_stream_smem_bytes() { return kNsSmemBytes; }

// The CTAs of newton_schulz_stream the card keeps resident at once, each a
// cluster of one: one an SM (the ring and G take 225 KB of its 227), the
// persistent grid's width; or minus the CUDA error of the query.
int ns_stream_max_clusters() {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return err == cudaSuccess ? sms : -static_cast<int>(err);
}

// x, out: (B, p, n) fp32, p <= 128, n % 4 == 0 and at least kNsStages
// chunks (n > 128), both 16-byte aligned (TMA's row stride), out may be x;
// mask and dist as newton_schulz_tc's. A persistent grid of at most
// ns_stream_max_clusters CTAs.
int newton_schulz_stream(const float* x, float* out, const unsigned char* mask, float* dist, int B,
                         int p, int n, int iters, cudaStream_t stream) {
  const void* ptrs[2] = {x, out};
  if (B < 0 || p < 1 || p > kN8P || n < 1 || iters < 0 ||
      (n + kNtChunk - 1) / kNtChunk < kNsStages || !vector_ok(n, ptrs, 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const int sms = ns_stream_max_clusters();
  if (sms < 0) return -sms;
  const void* kernel = reinterpret_cast<const void*>(ns_stream_kernel);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kNsSmemBytes);
  if (err != cudaSuccess || B == 0) return static_cast<int>(err);
  // 4-D maps over (n, p, B, 1), 128 x 32 boxes: rows past p read as zero
  // and are not written
  CUtensorMap maps[2];
  const uint64_t e = sizeof(float), mat = static_cast<uint64_t>(p) * n;
  const uint64_t dims[4] = {static_cast<uint64_t>(n), static_cast<uint64_t>(p),
                            static_cast<uint64_t>(B), 1};
  const uint64_t strides[3] = {n * e, mat * e, B * mat * e};
  const uint32_t box[4] = {32, kN8P, 1, 1};
  for (int i = 0; i < 2; ++i) {
    const int terr = hopper::make_tma_map_f32(&maps[i], ptrs[i], dims, strides, box);
    if (terr != 0) return terr;
  }
  void* args[] = {&maps[0], &maps[1], &mask, &dist, &B, &p, &n, &iters};
  err = cudaLaunchKernel(kernel, dim3(B < sms ? B : sms), dim3(kThreads), args, kNsSmemBytes,
                         stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
