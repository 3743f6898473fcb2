// Batched Newton-Schulz polar projection for Hopper (sm_90a), plain fp32
// CUDA C++: the feasibility watchdog's drift repair.
//
// Replaces the Pallas TPU kernel src/repro/kernels/newton_schulz.py:37
// (newton_schulz, _ns_kernel :21), reached through kernels/ops.py:700
// (_ns_dispatch) from the watchdog's repair (core/api.py:1504).
//
// Per (p, n) matrix of a (B, p, n) fp32 stack:
//   f = max(||X||_F, 1e-30),  Y = X / f
//   iters times:  Y <- 1.5 Y - 0.5 (Y Y^T) Y
//   dist = ||Y Y^T - I||_F  (the repaired matrix's feasibility)
//
// What differs from the TPU kernel:
// * One CTA per matrix. The whole kernel keeps Y in shared memory across
//   all iterations (one HBM read, one write) where (p, n) fits, as the
//   TPU kernel keeps it in VMEM. A (64, 960) matrix (245,760 B) does not
//   fit one block's 227 KB, so the tiled kernel keeps Y in the output
//   buffer (L2-resident per CTA) and sweeps its column tiles once per
//   iteration: each tile is updated in place from the complete gram G of
//   the previous iterate, and the new tile's gram is accumulated into a
//   second (p, p) buffer on the way, so the gram of the next iterate needs
//   no sweep of its own. The last iteration's gram gives dist.
// * A (B,) byte mask gates each matrix: a CTA whose matrix did not trip
//   (mask 0) exits at once and leaves its matrix and distance untouched,
//   so the repair needs no host sync and no copy of the stack.
// * Ragged p and n are masked in the kernel (rows past p are zero in the
//   tiles, columns past n load as zero and are not stored); nothing is
//   padded.
//
// Bound: 3 p^2 n flops per matrix per iteration (the symmetric gram Y Y^T
// p^2 n, G Y 2 p^2 n), so 36 p^2 n at 12 iterations against 8 p n bytes
// moved (X read once, Y written once): 4.5 p flop/byte, above the fp32
// ridge of 20 for p >= 5.
// Operations bound it; the products are the IEEE fp32 register blocks of
// tiles.cuh on the CUDA cores (no TF32, no fast math).
//
// out may alias x. Every launcher returns cudaGetLastError().

#include "tiles.cuh"

namespace {

constexpr int kNsWholeBlocksPerSm = 4;
constexpr int kNsTiledBlocksPerSm = 3;

// sqrt(sum_{i,j < p} (G[i, j] - delta_ij)^2) of a gram stored [j * P4 + i].
__device__ float gram_distance(const float* G, int p, int P4, float* red) {
  float s = 0.f;
  for (int e = threadIdx.x; e < p * p; e += kThreads) {
    const int i = e % p, j = e / p;
    const float d = G[j * P4 + i] - (i == j ? 1.f : 0.f);
    s = fmaf(d, d, s);
  }
  return sqrtf(block_sum(s, red));
}

// Columns [t0, t0 + cols) of the matrix at `off` into the k-major tile YT,
// divided by f, zero past n (rows past p are never written).
__device__ void load_scaled(float* YT, int ld, const float* src, size_t off,
                            int p, int n, int t0, int cols, float f,
                            bool scale, bool vec) {
  for (int u = threadIdx.x; u < p * (cols / 4); u += kThreads) {
    const int i = u % p, kk = 4 * (u / p);
    float v[4];
    gload4(v, src + off + static_cast<size_t>(i) * n, t0 + kk, n, vec);
#pragma unroll
    for (int c = 0; c < 4; ++c) YT[(kk + c) * ld + i] = scale ? v[c] / f : v[c];
  }
}

// ---------------------------------------------------------------- whole
//
// Y resident in shared memory (k-major, all n columns). Each iteration
// forms G = Y Y^T, then writes 1.5 Y - 0.5 G Y over Y a group of column
// quads at a time (a column of the new Y reads only the same column of Y).

__global__ void __launch_bounds__(kThreads, kNsWholeBlocksPerSm)
ns_whole_kernel(const float* x, float* out, const unsigned char* mask,
                float* dist, int p, int n, int iters, int vec) {
  const int b = blockIdx.x;
  if (mask != nullptr && mask[b] == 0) return;
  extern __shared__ float4 ns_whole_sm[];
  const int P4 = round4(p), N4 = round4(n), ld = tile_ld(P4);
  float* YT = reinterpret_cast<float*>(ns_whole_sm);  // [k * ld + i]
  float* G = YT + N4 * ld;                            // [j * P4 + i]
  float* red = G + P4 * P4;
  const size_t off = static_cast<size_t>(b) * p * n;

  for (int e = threadIdx.x; e < N4 * ld; e += kThreads) YT[e] = 0.f;
  __syncthreads();
  load_scaled(YT, ld, x, off, p, n, 0, N4, 1.f, false, vec);
  __syncthreads();
  float s = 0.f;
  for (int e = threadIdx.x; e < N4 * ld; e += kThreads) s = fmaf(YT[e], YT[e], s);
  const float f = fmaxf(sqrtf(block_sum(s, red)), 1e-30f);
  for (int e = threadIdx.x; e < N4 * ld; e += kThreads) YT[e] = YT[e] / f;
  __syncthreads();

  const int ni = P4 / 4, quads = kThreads / ni;
  for (int it = 0; it < iters; ++it) {
    gram_tile<false>(G, nullptr, YT, YT, nullptr, ld, P4, N4, false);
    __syncthreads();
    for (int q0 = 0; q0 < N4 / 4; q0 += quads) {
      const int i0 = 4 * (threadIdx.x % ni), k0 = 4 * (q0 + threadIdx.x / ni);
      const bool act = static_cast<int>(threadIdx.x) < quads * ni && k0 < N4;
      float acc[4][4] = {};
      float4 y[4];
      if (act) {
        prod_block(G, YT, P4, ld, i0, k0, acc);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float4 v = lds4(YT + (k0 + c) * ld + i0);
          y[c] = make_float4(1.5f * v.x - 0.5f * acc[0][c], 1.5f * v.y - 0.5f * acc[1][c],
                             1.5f * v.z - 0.5f * acc[2][c], 1.5f * v.w - 0.5f * acc[3][c]);
        }
      }
      __syncthreads();
      if (act) {
#pragma unroll
        for (int c = 0; c < 4; ++c) *reinterpret_cast<float4*>(YT + (k0 + c) * ld + i0) = y[c];
      }
    }
    __syncthreads();
  }
  if (dist != nullptr) {
    gram_tile<false>(G, nullptr, YT, YT, nullptr, ld, P4, N4, false);
    __syncthreads();
    const float d = gram_distance(G, p, P4, red);
    if (threadIdx.x == 0) dist[b] = d;
  }
  for (int u = threadIdx.x; u < p * (N4 / 4); u += kThreads) {
    const int i = u % p, kk = 4 * (u / p);
    const float v[4] = {YT[kk * ld + i], YT[(kk + 1) * ld + i], YT[(kk + 2) * ld + i],
                        YT[(kk + 3) * ld + i]};
    gstore4(out + off + static_cast<size_t>(i) * n, kk, n, vec, v);
  }
}

// ---------------------------------------------------------------- tiled
//
// Y lives in `out`. Sweep 1 sums X^2 for f, sweep 2 accumulates G of
// X / f; then one sweep per iteration: for each tile, Y_tile (from x / f
// on the first iteration, from out after) -> N_tile = 1.5 Y - 0.5 G Y,
// stored to out and accumulated into the next gram Gn. Tiles past the
// current one still hold the previous iterate, and each N_tile depends
// only on G and on its own Y_tile, so the sweep is safe in place.

__global__ void __launch_bounds__(kThreads, kNsTiledBlocksPerSm)
ns_tiled_kernel(const float* x, float* out, const unsigned char* mask,
                float* dist, int p, int n, int iters, int tile_n, int vec) {
  const int b = blockIdx.x;
  if (mask != nullptr && mask[b] == 0) return;
  extern __shared__ float4 ns_tiled_sm[];
  const int P4 = round4(p), ld = tile_ld(P4), ni = P4 / 4, nq = tile_n / 4;
  float* Gc = reinterpret_cast<float*>(ns_tiled_sm);  // [j * P4 + i]
  float* Gn = Gc + P4 * P4;
  float* YT = Gn + P4 * P4;  // [k * ld + i]
  float* NT = YT + tile_n * ld;
  float* red = NT + tile_n * ld;
  const size_t off = static_cast<size_t>(b) * p * n;

  // Rows p..P4 of both tiles stay zero: loads and N_tile never write them
  // non-zero (G is zero there too).
  for (int e = threadIdx.x; e < 2 * tile_n * ld; e += kThreads) YT[e] = 0.f;
  float s = 0.f;
  for (int e = threadIdx.x; e < p * n; e += kThreads) {
    const float v = x[off + e];
    s = fmaf(v, v, s);
  }
  const float f = fmaxf(sqrtf(block_sum(s, red)), 1e-30f);  // syncs
  for (int t0 = 0; t0 < n; t0 += tile_n) {
    load_scaled(YT, ld, x, off, p, n, t0, tile_n, f, true, vec);
    __syncthreads();
    gram_tile<false>(Gc, nullptr, YT, YT, nullptr, ld, P4, tile_n, t0 > 0);
    __syncthreads();
  }
  for (int it = 0; it < iters; ++it) {
    const float* src = it == 0 ? x : out;
    for (int t0 = 0; t0 < n; t0 += tile_n) {
      load_scaled(YT, ld, src, off, p, n, t0, tile_n, f, it == 0, vec);
      __syncthreads();
      for (int blk = threadIdx.x; blk < ni * nq; blk += kThreads) {
        const int i0 = 4 * (blk % ni), k0 = 4 * (blk / ni);
        float acc[4][4] = {};
        prod_block(Gc, YT, P4, ld, i0, k0, acc);
        float o[4][4];  // o[r][c] = N[i0 + r, t0 + k0 + c]
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float v[4];
          load4(v, lds4(YT + (k0 + c) * ld + i0));
#pragma unroll
          for (int r = 0; r < 4; ++r) o[r][c] = 1.5f * v[r] - 0.5f * acc[r][c];
          *reinterpret_cast<float4*>(NT + (k0 + c) * ld + i0) =
              make_float4(o[0][c], o[1][c], o[2][c], o[3][c]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (i0 + r < p)
            gstore4(out + off + static_cast<size_t>(i0 + r) * n, t0 + k0, n, vec, o[r]);
        }
      }
      __syncthreads();
      gram_tile<false>(Gn, nullptr, NT, NT, nullptr, ld, P4, tile_n, t0 > 0);
      __syncthreads();
    }
    float* t = Gc;
    Gc = Gn;
    Gn = t;
  }
  if (dist != nullptr) {
    const float d = gram_distance(Gc, p, P4, red);
    if (threadIdx.x == 0) dist[b] = d;
  }
}

}  // namespace

extern "C" {

// Shared memory of one block of each kernel (ops.py mirrors these).
int ns_whole_smem_bytes(int p, int n) {
  const int P4 = round4(p);
  return 4 * (round4(n) * tile_ld(P4) + P4 * P4 + kWarps);
}

int ns_tiled_smem_bytes(int p, int tile_n) {
  const int P4 = round4(p);
  return 4 * (2 * P4 * P4 + 2 * tile_n * tile_ld(P4) + kWarps);
}

// x, out: (B, p, n) fp32 (out may be x); mask: (B,) bytes or null (every
// matrix); dist: (B,) fp32 written for the matrices processed, or null.
int newton_schulz_whole(const float* x, float* out, const unsigned char* mask,
                        float* dist, int B, int p, int n, int iters,
                        cudaStream_t stream) {
  const void* ptrs[2] = {x, out};
  int vec = vector_ok(n, ptrs, 2);
  void* args[] = {&x, &out, &mask, &dist, &p, &n, &iters, &vec};
  return launch(reinterpret_cast<const void*>(ns_whole_kernel),
                ns_whole_smem_bytes(p, n), B, stream, args);
}

int newton_schulz_tiled(const float* x, float* out, const unsigned char* mask,
                        float* dist, int B, int p, int n, int iters, int tile_n,
                        cudaStream_t stream) {
  if (tile_n <= 0 || tile_n % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[2] = {x, out};
  int vec = vector_ok(n, ptrs, 2);
  void* args[] = {&x, &out, &mask, &dist, &p, &n, &iters, &tile_n, &vec};
  return launch(reinterpret_cast<const void*>(ns_tiled_kernel),
                ns_tiled_smem_bytes(p, tile_n), B, stream, args);
}

}  // extern "C"
