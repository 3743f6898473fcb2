// Fused POGO group step for Hopper (sm_90a), plain fp32 CUDA C++.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/fused_step.py:
//   fused_step_whole  <- _fused_whole_kernel (POGO branch)
//   fused_step_tiled  <- _t1_kernel + _t2_pogo_kernel + pogo_update._phase3_kernel
//                        and the (p, p) telemetry products left to XLA there.
//
// One CTA owns one (p, n) matrix of the (B, p, n) stack and does, in order:
//   base stage   none | trace (+nesterov) | vadam: mu' (and nu') written once
//   grams        A = X X^T, B = X Geu^T                      (fp32, in smem)
//   leap         M = X - eta s 1/2 (A Geu - B X)             (column-local)
//   land gram    C = M M^T
//   land         X' = (1 + lam) M - lam C M                  (written once)
//   telemetry    dist = ||(1+lam)^2 C - 2 lam (1+lam) C^2 + lam^2 C^3 - I_pv||_F
// Geu is the unscaled transformed gradient (trace: the momentum output;
// vadam: the first moment) and s its per-matrix scale (post_scale, and the
// vadam normalisation, which commutes with the linear direction map).
//
// Bound: six p x p x n products (12 p^2 n flops) against 5 HBM passes of
// 4 p n bytes, i.e. 0.6 p flop/byte. The fp32 ridge of an H100 SXM (67
// TFLOP/s over 3.35 TB/s) is 20 flop/byte, so p = 16 stacks are bound by
// bytes and p = 64 stacks by fp32 operations. Every product is IEEE fp32
// on the CUDA cores (no TF32, no wgmma), run from k-major shared-memory
// tiles (T[k * ld + i], P4 = p rounded up to 4, ld = P4 or P4 + 4, rows
// past p zero) in 4 x 4 register blocks fed by float4 loads: two 16-byte
// loads per 16 FMAs in the grams, eight per 64 in the (p, p) x (p, cols)
// products, each load conflict-free or a broadcast. The whole kernel reads
// X, g, mu once and writes X', mu' once; the tiled kernel sweeps n three
// times and parks M in x_out between the last two. Tensor cores (3xTF32)
// and TMA are later work.
//
// Scalars ride a device vector scal[8] = [eta, lam, post_scale, h0..h4]
// with h = (decay) for trace and (b1, b2, eps, c1, c2) for vadam, as
// kernels/fused_step.py packs it. Every launcher returns cudaGetLastError().
// Outputs may alias inputs (x_out == x, mu_out == mu, nu_out == nu): each
// CTA owns its matrix and never reads an element after writing it, other
// than the mu' and (tiled) the M it wrote itself.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemLimit = 232448;  // 227 KB: most dynamic smem a block may use
// Blocks per SM each kernel's register budget allows (ops.py mirrors the
// tiled one): 4 caps the whole kernel at 64 registers, 3 the tiled one at
// 85, both without spills. The whole kernel waits on HBM and the tiled one
// on its barriers, so more resident blocks hide more of both.
constexpr int kWholeBlocksPerSm = 4;
constexpr int kTiledBlocksPerSm = 3;

enum BaseKind { kNone = 0, kTrace = 1, kVAdam = 2 };

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

// Row stride of a k-major tile: P4, plus 4 when P4 / 4 is even, so that
// eight lanes reading float4s from eight consecutive rows hit eight
// distinct bank groups.
__host__ __device__ inline int tile_ld(int P4) {
  return (P4 / 4) % 2 == 0 ? P4 + 4 : P4;
}

// Deterministic block-wide sum; every thread gets the total.
__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // red may still be read by an earlier call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
  for (int w = 0; w < kWarps; ++w) t += red[w];
  return t;
}

__device__ inline void load4(float v[4], const float4 t) {
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ inline float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Four consecutive elements src[k .. k+3] of a row, zero past n.
__device__ inline void gload4(float v[4], const float* src, int k, int n,
                              bool vec) {
  if (vec && k + 3 < n) {
    load4(v, *reinterpret_cast<const float4*>(src + k));
  } else {
    for (int c = 0; c < 4; ++c) v[c] = k + c < n ? src[k + c] : 0.f;
  }
}

__device__ inline void gstore4(float* dst, int k, int n, bool vec,
                               const float v[4]) {
  if (vec && k + 3 < n) {
    *reinterpret_cast<float4*>(dst + k) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    for (int c = 0; c < 4 && k + c < n; ++c) dst[k + c] = v[c];
  }
}

// Loads columns [t0, t0 + cols) of the matrix at `off` into the k-major
// tiles XT (X) and GT (Geu), zero past n, running the base stage on the
// way: mu' is written to HBM and sq accumulates the raw gradient's
// squares (vadam).
__device__ void stage_moments(float* XT, float* GT, int ld, const float* x,
                              const float* g, const float* mu, float* mu_out,
                              size_t off, int p, int n, int t0, int cols,
                              int base_kind, int nesterov, float h0, bool vec,
                              float& sq) {
  for (int u = threadIdx.x; u < p * (cols / 4); u += kThreads) {
    const int i = u % p, kk = 4 * (u / p);
    const size_t row = off + static_cast<size_t>(i) * n;
    float xv[4], gv[4];
    gload4(xv, x + row, t0 + kk, n, vec);
    gload4(gv, g + row, t0 + kk, n, vec);
    if (base_kind != kNone) {
      float mv[4], m2[4];
      gload4(mv, mu + row, t0 + kk, n, vec);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (base_kind == kTrace) {
          m2[c] = h0 * mv[c] + gv[c];
        } else {
          m2[c] = h0 * mv[c] + (1.f - h0) * gv[c];
          sq = fmaf(gv[c], gv[c], sq);
        }
      }
      gstore4(mu_out + row, t0 + kk, n, vec, m2);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        gv[c] = (base_kind == kTrace && nesterov) ? h0 * m2[c] + gv[c] : m2[c];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      XT[(kk + c) * ld + i] = xv[c];
      GT[(kk + c) * ld + i] = gv[c];
    }
  }
}

// out1[j * P4 + i] (+)= sum_{k < kc} UT[k, i] V1T[k, j] (and out2 with
// V2T), from k-major tiles of row stride ld, in 4 x 4 blocks. When there
// are fewer blocks than threads, S lanes of one warp split a block's k
// range and add their sums with a fixed butterfly of shuffles, so the
// result is deterministic. A block always lands on the same thread, so
// column tiles accumulate without races.
template <bool kTwo>
__device__ void gram_tile(float* out1, float* out2, const float* UT,
                          const float* V1T, const float* V2T, int ld, int P4,
                          int kc, bool accumulate) {
  const int nb = P4 / 4, nblk = nb * nb;
  int S = 1;
  while (S < 32 && nblk * S * 2 <= kThreads) S *= 2;
  const int work = nblk * S;
  for (int base = 0; base < work; base += kThreads) {  // same trip count for all
    const int idx = base + threadIdx.x;
    const int s = idx % S, blk = idx / S;
    const bool act = idx < work;
    const int i0 = 4 * (blk % nb), j0 = 4 * (blk / nb);
    float a1[4][4] = {}, a2[4][4] = {};
    for (int k = s; act && k < kc; k += S) {
      float u[4], v[4];
      load4(u, lds4(UT + k * ld + i0));
      load4(v, lds4(V1T + k * ld + j0));
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) a1[r][c] = fmaf(u[r], v[c], a1[r][c]);
      if (kTwo) {
        load4(v, lds4(V2T + k * ld + j0));
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) a2[r][c] = fmaf(u[r], v[c], a2[r][c]);
      }
    }
    for (int o = S / 2; o > 0; o >>= 1) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          a1[r][c] += __shfl_xor_sync(0xffffffffu, a1[r][c], o);
          if (kTwo) a2[r][c] += __shfl_xor_sync(0xffffffffu, a2[r][c], o);
        }
    }
    if (!act || s != 0) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float* o1 = out1 + (j0 + c) * P4 + i0;
      float* o2 = kTwo ? out2 + (j0 + c) * P4 + i0 : nullptr;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        o1[r] = accumulate ? o1[r] + a1[r][c] : a1[r][c];
        if (kTwo) o2[r] = accumulate ? o2[r] + a2[r][c] : a2[r][c];
      }
    }
  }
}

// acc[r][c] += sum_j P[i0 + r, j] Y[j, k0 + c] with PT[j * P4 + i] = P[i, j]
// and the k-major tile YT[k * ld + j] = Y[j, k].
__device__ inline void prod_block(const float* PT, const float* YT, int P4,
                                  int ld, int i0, int k0, float acc[4][4]) {
  for (int j = 0; j < P4; j += 4) {
    float pm[4][4], ym[4][4];  // pm[q][r] = P[i0+r, j+q]; ym[c][q] = Y[j+q, k0+c]
#pragma unroll
    for (int q = 0; q < 4; ++q) load4(pm[q], lds4(PT + (j + q) * P4 + i0));
#pragma unroll
    for (int c = 0; c < 4; ++c) load4(ym[c], lds4(YT + (k0 + c) * ld + j));
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(pm[q][r], ym[c][q], acc[r][c]);
  }
}

// m[c] = column k0 + c, rows i0..i0+3 of M = X - coef 1/2 (A Geu - B X),
// with the grams stored as A[j * P4 + i] = A[i, j], BT[j * P4 + i] = B[i, j].
__device__ inline void leap_block(const float* A, const float* BT,
                                  const float* XT, const float* GT, int P4,
                                  int ld, int i0, int k0, float coef,
                                  float4 m[4]) {
  float ag[4][4] = {}, bx[4][4] = {};
  prod_block(A, GT, P4, ld, i0, k0, ag);
  prod_block(BT, XT, P4, ld, i0, k0, bx);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float xv[4];
    load4(xv, lds4(XT + (k0 + c) * ld + i0));
    m[c].x = xv[0] - coef * (0.5f * (ag[0][c] - bx[0][c]));
    m[c].y = xv[1] - coef * (0.5f * (ag[1][c] - bx[1][c]));
    m[c].z = xv[2] - coef * (0.5f * (ag[2][c] - bx[2][c]));
    m[c].w = xv[3] - coef * (0.5f * (ag[3][c] - bx[3][c]));
  }
}

// X' = (1 + lam) M - lam C M for columns [t0, t0 + cols), from the k-major
// M tile, written to HBM row by row.
__device__ void land_store(const float* C, const float* MT, int P4, int ld,
                           int p, int n, int t0, int cols, float lam,
                           float* x_out, size_t off, bool vec) {
  const int ni = P4 / 4;
  for (int blk = threadIdx.x; blk < ni * (cols / 4); blk += kThreads) {
    const int i0 = 4 * (blk % ni), k0 = 4 * (blk / ni);
    float cm[4][4] = {};
    prod_block(C, MT, P4, ld, i0, k0, cm);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (i0 + r >= p) break;
      float o[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        o[c] = (1.f + lam) * MT[(k0 + c) * ld + i0 + r] - lam * cm[r][c];
      gstore4(x_out + off + static_cast<size_t>(i0 + r) * n, t0 + k0, n, vec, o);
    }
  }
}

// dist = ||(1+lam)^2 C - 2 lam (1+lam) C^2 + lam^2 C^3 - I_pv||_F, with
// C^2 built in the scratch (p, p) buffer C2 (C is symmetric, stride ld).
// Thread 0 stores it.
__device__ void telemetry(const float* C, float* C2, int ld, int p, int pv,
                          float lam, float* red, float* dist_out) {
  for (int e = threadIdx.x; e < p * p; e += kThreads) {
    const int i = e / p, j = e - i * p;
    float s = 0.f;
    for (int l = 0; l < p; ++l) s = fmaf(C[i * ld + l], C[l * ld + j], s);
    C2[i * ld + j] = s;
  }
  __syncthreads();
  const float k1 = (1.f + lam) * (1.f + lam);
  const float k2 = 2.f * lam * (1.f + lam);
  const float k3 = lam * lam;
  float acc = 0.f;
  for (int e = threadIdx.x; e < p * p; e += kThreads) {
    const int i = e / p, j = e - i * p;
    float c3 = 0.f;
    for (int l = 0; l < p; ++l) c3 = fmaf(C2[i * ld + l], C[l * ld + j], c3);
    const float w = k1 * C[i * ld + j] - k2 * C2[i * ld + j] + k3 * c3;
    const float r = w - ((i == j && i < pv) ? 1.f : 0.f);
    acc = fmaf(r, r, acc);
  }
  const float tot = block_sum(acc, red);
  if (threadIdx.x == 0) *dist_out = sqrtf(tot);
}

// The per-matrix scale s of Geu: post_scale, and for vadam the
// bias-corrected scalar second moment (nu' written by thread 0).
__device__ float base_scale(int base_kind, const float* scal, float nu0,
                            float sq, float* nu_out, float* red) {
  const float ps = scal[2];
  if (base_kind != kVAdam) return ps;
  const float tot = block_sum(sq, red);
  const float b2 = scal[4], eps = scal[5], c1 = scal[6], c2 = scal[7];
  const float nu2 = b2 * nu0 + (1.f - b2) * tot;
  if (threadIdx.x == 0) *nu_out = nu2;
  return (ps / c1) / (sqrtf(nu2 / c2) + eps);
}

// ---------------------------------------------------------------- whole
//
// X and Geu stay resident (k-major, all n columns); M overwrites X a group
// of whole column-quads at a time, since M[:, k] reads only column k of X
// and Geu.

__global__ void __launch_bounds__(kThreads, kWholeBlocksPerSm)
fused_whole_kernel(const float* x, const float* g, const float* mu,
                   const float* nu, const float* scal, const int* pv,
                   float* x_out, float* mu_out, float* nu_out, float* dist,
                   int p, int n, int base_kind, int nesterov, int vec) {
  extern __shared__ float4 whole_sm[];
  const int b = blockIdx.x;
  const int P4 = round4(p), N4 = round4(n), ni = P4 / 4, ld = tile_ld(P4);
  float* XT = reinterpret_cast<float*>(whole_sm);  // [k * ld + i]
  float* GT = XT + N4 * ld;
  float* A = GT + N4 * ld;  // (p, p) grams, [j * P4 + i]
  float* BT = A + P4 * P4;
  float* C = BT + P4 * P4;
  float* red = C + P4 * P4;
  const size_t off = static_cast<size_t>(b) * p * n;
  const float eta = scal[0], lam = scal[1], h0 = scal[3];
  const float nu0 = base_kind == kVAdam ? nu[b] : 0.f;

  // Rows p..P4 stay zero, so every product is exact on them.
  for (int e = threadIdx.x; e < 2 * N4 * ld; e += kThreads) XT[e] = 0.f;
  __syncthreads();
  float sq = 0.f;
  stage_moments(XT, GT, ld, x, g, mu, mu_out, off, p, n, 0, N4, base_kind,
                nesterov, h0, vec, sq);
  const float coef = eta * base_scale(base_kind, scal, nu0, sq, nu_out + b, red);
  __syncthreads();

  gram_tile<true>(A, BT, XT, XT, GT, ld, P4, n, false);
  __syncthreads();

  const int quads = kThreads / ni;  // whole column-quads per pass
  for (int q0 = 0; q0 < N4 / 4; q0 += quads) {
    const int blk = threadIdx.x;
    const int i0 = 4 * (blk % ni), k0 = 4 * (q0 + blk / ni);
    const bool act = blk < quads * ni && k0 < N4;
    float4 m[4];
    if (act) leap_block(A, BT, XT, GT, P4, ld, i0, k0, coef, m);
    __syncthreads();
    if (act) {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        *reinterpret_cast<float4*>(XT + (k0 + c) * ld + i0) = m[c];
    }
  }
  __syncthreads();

  gram_tile<false>(C, nullptr, XT, XT, nullptr, ld, P4, n, false);
  __syncthreads();
  land_store(C, XT, P4, ld, p, n, 0, N4, lam, x_out, off, vec);
  telemetry(C, A, P4, p, pv != nullptr ? pv[b] : p, lam, red, dist + b);
}

// ---------------------------------------------------------------- tiled
//
// Three sweeps over tile_n-wide column tiles, the (p, p) grams resident:
// moments + A, B; then M (stored in x_out) + C; then X' from the stored M.

__global__ void __launch_bounds__(kThreads, kTiledBlocksPerSm)
fused_tiled_kernel(const float* x, const float* g, const float* mu,
                   const float* nu, const float* scal, const int* pv,
                   float* x_out, float* mu_out, float* nu_out, float* dist,
                   int p, int n, int base_kind, int nesterov, int tile_n,
                   int vec) {
  extern __shared__ float4 tiled_sm[];
  const int b = blockIdx.x;
  const int P4 = round4(p), ni = P4 / 4, nq = tile_n / 4, ld = tile_ld(P4);
  float* A = reinterpret_cast<float*>(tiled_sm);  // (p, p) grams, [j * P4 + i]
  float* BT = A + P4 * P4;
  float* C = BT + P4 * P4;
  float* XT = C + P4 * P4;  // k-major tiles, [k * ld + i]
  float* GT = XT + tile_n * ld;
  float* MT = GT + tile_n * ld;
  float* red = MT + tile_n * ld;
  const size_t off = static_cast<size_t>(b) * p * n;
  const float eta = scal[0], lam = scal[1], h0 = scal[3];
  const float nu0 = base_kind == kVAdam ? nu[b] : 0.f;

  for (int e = threadIdx.x; e < 3 * tile_n * ld; e += kThreads) XT[e] = 0.f;
  __syncthreads();

  float sq = 0.f;
  for (int t0 = 0; t0 < n; t0 += tile_n) {
    stage_moments(XT, GT, ld, x, g, mu, mu_out, off, p, n, t0, tile_n,
                  base_kind, nesterov, h0, vec, sq);
    __syncthreads();
    gram_tile<true>(A, BT, XT, XT, GT, ld, P4, min(tile_n, n - t0), t0 > 0);
    __syncthreads();
  }
  const float coef = eta * base_scale(base_kind, scal, nu0, sq, nu_out + b, red);

  // Sweep 2 rebuilds each tile's Geu from mu' (or g), makes M, and stores
  // it in x_out as scratch; sweep 3 reads M back and writes X' over it.
  // Storing M moves the same HBM bytes as recomputing it in sweep 3 (a
  // write and a read instead of two reads) and saves 4 p^2 n flops.
  for (int t0 = 0; t0 < n; t0 += tile_n) {
    for (int u = threadIdx.x; u < p * nq; u += kThreads) {
      const int i = u % p, kk = 4 * (u / p);
      const size_t row = off + static_cast<size_t>(i) * n;
      float xv[4], gv[4];
      gload4(xv, x + row, t0 + kk, n, vec);
      if (base_kind == kNone) {
        gload4(gv, g + row, t0 + kk, n, vec);
      } else {
        gload4(gv, mu_out + row, t0 + kk, n, vec);
        if (base_kind == kTrace && nesterov) {
          float g4[4];
          gload4(g4, g + row, t0 + kk, n, vec);
#pragma unroll
          for (int c = 0; c < 4; ++c) gv[c] = h0 * gv[c] + g4[c];
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        XT[(kk + c) * ld + i] = xv[c];
        GT[(kk + c) * ld + i] = gv[c];
      }
    }
    __syncthreads();
    for (int blk = threadIdx.x; blk < ni * nq; blk += kThreads) {
      const int i0 = 4 * (blk % ni), k0 = 4 * (blk / ni);
      float4 m[4];
      leap_block(A, BT, XT, GT, P4, ld, i0, k0, coef, m);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        *reinterpret_cast<float4*>(MT + (k0 + c) * ld + i0) = m[c];
      const float rows[4][4] = {{m[0].x, m[1].x, m[2].x, m[3].x},
                                {m[0].y, m[1].y, m[2].y, m[3].y},
                                {m[0].z, m[1].z, m[2].z, m[3].z},
                                {m[0].w, m[1].w, m[2].w, m[3].w}};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (i0 + r < p)
          gstore4(x_out + off + static_cast<size_t>(i0 + r) * n, t0 + k0, n,
                  vec, rows[r]);
      }
    }
    __syncthreads();
    gram_tile<false>(C, nullptr, MT, MT, nullptr, ld, P4, min(tile_n, n - t0),
                     t0 > 0);
    __syncthreads();
  }
  for (int t0 = 0; t0 < n; t0 += tile_n) {
    for (int u = threadIdx.x; u < p * nq; u += kThreads) {
      const int i = u % p, kk = 4 * (u / p);
      float mv[4];
      gload4(mv, x_out + off + static_cast<size_t>(i) * n, t0 + kk, n, vec);
#pragma unroll
      for (int c = 0; c < 4; ++c) MT[(kk + c) * ld + i] = mv[c];
    }
    __syncthreads();
    land_store(C, MT, P4, ld, p, n, t0, tile_n, lam, x_out, off, vec);
    __syncthreads();
  }
  telemetry(C, A, P4, p, pv != nullptr ? pv[b] : p, lam, red, dist + b);
}

int launch(const void* kernel, int smem, int B, cudaStream_t stream,
           void** args) {
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B > 0) {
    err = cudaLaunchKernel(kernel, dim3(B), dim3(kThreads), args, smem, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// float4 global access needs n % 4 == 0 and 16-byte aligned rows.
int vector_ok(int n, const void* const* ptrs, int count) {
  int vec = n % 4 == 0;
  for (int i = 0; i < count; ++i)
    vec &= reinterpret_cast<uintptr_t>(ptrs[i]) % 16 == 0;
  return vec;
}

}  // namespace

extern "C" {

// Dynamic shared memory of one CTA, in bytes (ops.py mirrors both).
int fused_whole_smem_bytes(int p, int n) {
  const int p4 = round4(p);
  return static_cast<int>(sizeof(float)) *
         (2 * round4(n) * tile_ld(p4) + 3 * p4 * p4 + kWarps);
}

int fused_tiled_smem_bytes(int p, int tile_n) {
  const int p4 = round4(p);
  return static_cast<int>(sizeof(float)) *
         (3 * p4 * p4 + 3 * tile_n * tile_ld(p4) + kWarps);
}

int fused_step_whole(const float* x, const float* g, const float* mu,
                     const float* nu, const float* scal, const int* pv,
                     float* x_out, float* mu_out, float* nu_out, float* dist,
                     int B, int p, int n, int base_kind, int nesterov,
                     void* stream) {
  if (p < 1 || n < 1 || round4(p) / 4 > kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* rows[] = {x, g, mu, x_out, mu_out};
  int vec = vector_ok(n, rows, 5);
  void* args[] = {&x, &g, &mu, &nu, &scal, &pv, &x_out, &mu_out, &nu_out,
                  &dist, &p, &n, &base_kind, &nesterov, &vec};
  return launch(reinterpret_cast<const void*>(fused_whole_kernel),
                fused_whole_smem_bytes(p, n), B,
                static_cast<cudaStream_t>(stream), args);
}

int fused_step_tiled(const float* x, const float* g, const float* mu,
                     const float* nu, const float* scal, const int* pv,
                     float* x_out, float* mu_out, float* nu_out, float* dist,
                     int B, int p, int n, int base_kind, int nesterov,
                     int tile_n, void* stream) {
  if (p < 1 || n < 1 || tile_n < 4 || tile_n % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* rows[] = {x, g, mu, x_out, mu_out};
  int vec = vector_ok(n, rows, 5);
  void* args[] = {&x, &g, &mu, &nu, &scal, &pv, &x_out, &mu_out, &nu_out,
                  &dist, &p, &n, &base_kind, &nesterov, &tile_n, &vec};
  return launch(reinterpret_cast<const void*>(fused_tiled_kernel),
                fused_tiled_smem_bytes(p, tile_n), B,
                static_cast<cudaStream_t>(stream), args);
}

}  // extern "C"
