// Shared building blocks of the port's Stiefel kernels (fused_step.cu,
// two_stage.cu): one CTA of kThreads threads owns one (p, n) matrix of a
// (B, p, n) fp32 stack and runs every product as IEEE fp32 FMAs on the
// CUDA cores, from k-major shared-memory tiles (T[k * ld + i], P4 = p
// rounded up to 4, ld = tile_ld(P4), rows past p zero) in 4 x 4 register
// blocks fed by float4 loads. The ragged n-edge is masked here: global
// loads give zero past n and stores stop at n.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemLimit = 232448;  // 227 KB: most dynamic smem a block may use

enum BaseKind { kNone = 0, kTrace = 1, kVAdam = 2 };
enum Method { kPogo = 0, kLanding = 1 };

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
// squares (vadam). With kNone, GT is g as it is and mu is not touched.
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
// kLand gives Landing's fixed step instead,
// X' = X - (coef 1/2 (A Geu - B X) + el (A X - X)), with el = eta lam.
template <bool kLand>
__device__ inline void leap_block(const float* A, const float* BT,
                                  const float* XT, const float* GT, int P4,
                                  int ld, int i0, int k0, float coef,
                                  float el, float4 m[4]) {
  float ag[4][4] = {}, bx[4][4] = {};
  prod_block(A, GT, P4, ld, i0, k0, ag);
  prod_block(BT, XT, P4, ld, i0, k0, bx);
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) ag[r][c] = coef * (0.5f * (ag[r][c] - bx[r][c]));
  if (kLand) {  // bx becomes A X
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) bx[r][c] = 0.f;
    prod_block(A, XT, P4, ld, i0, k0, bx);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float xv[4], o[4];
    load4(xv, lds4(XT + (k0 + c) * ld + i0));
#pragma unroll
    for (int r = 0; r < 4; ++r)
      o[r] = kLand ? xv[r] - (ag[r][c] + el * (bx[r][c] - xv[r]))
                   : xv[r] - ag[r][c];
    m[c] = make_float4(o[0], o[1], o[2], o[3]);
  }
}

// Whole-matrix leap: M = X - coef 1/2 (A Geu - B X) (or Landing's X',
// kLand) written over the resident X (N4 columns), a group of whole
// column-quads at a time, since M[:, k] reads only column k of X and Geu.
// Every thread must call it.
template <bool kLand = false>
__device__ void leap_over_x(const float* A, const float* BT, float* XT,
                            const float* GT, int P4, int ld, int N4,
                            float coef, float el = 0.f) {
  const int ni = P4 / 4;
  const int quads = kThreads / ni;  // whole column-quads per pass
  for (int q0 = 0; q0 < N4 / 4; q0 += quads) {
    const int blk = threadIdx.x;
    const int i0 = 4 * (blk % ni), k0 = 4 * (q0 + blk / ni);
    const bool act = blk < quads * ni && k0 < N4;
    float4 m[4];
    if (act) leap_block<kLand>(A, BT, XT, GT, P4, ld, i0, k0, coef, el, m);
    __syncthreads();
    if (act) {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        *reinterpret_cast<float4*>(XT + (k0 + c) * ld + i0) = m[c];
    }
  }
}

// Tiled leap: M (or Landing's X', kLand) for the tile's columns
// [t0, t0 + 4 nq) into the k-major tile MT, and stored row by row in
// x_out (columns past n are not stored).
template <bool kLand = false>
__device__ void leap_tile(const float* A, const float* BT, const float* XT,
                          const float* GT, float* MT, int P4, int ld, int p,
                          int n, int t0, int nq, float coef, float* x_out,
                          size_t off, bool vec, float el = 0.f) {
  const int ni = P4 / 4;
  for (int blk = threadIdx.x; blk < ni * nq; blk += kThreads) {
    const int i0 = 4 * (blk % ni), k0 = 4 * (blk / ni);
    float4 m[4];
    leap_block<kLand>(A, BT, XT, GT, P4, ld, i0, k0, coef, el, m);
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
}

// Columns [t0, t0 + cols) of the k-major tile T (rows below p) to HBM.
__device__ void store_tile(const float* T, int ld, int p, int n, int t0,
                           int cols, float* out, size_t off, bool vec) {
  for (int u = threadIdx.x; u < p * (cols / 4); u += kThreads) {
    const int i = u % p, kk = 4 * (u / p);
    float v[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = T[(kk + c) * ld + i];
    gstore4(out + off + static_cast<size_t>(i) * n, t0 + kk, n, vec, v);
  }
}

// dist = ||W - I_pv||_F of a symmetric (p, p) gram of stride P4. Thread 0
// stores it; every thread must call it.
__device__ void residual_dist(const float* W, int P4, int p, int pv,
                              float* red, float* dist_out) {
  float acc = 0.f;
  for (int e = threadIdx.x; e < p * p; e += kThreads) {
    const int i = e / p, j = e - i * p;
    const float r = W[i * P4 + j] - ((i == j && i < pv) ? 1.f : 0.f);
    acc = fmaf(r, r, acc);
  }
  const float tot = block_sum(acc, red);
  if (threadIdx.x == 0) *dist_out = sqrtf(tot);
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

// Tiled land: for each tile, read back the M parked in x_out into MT and
// write X' over it. Every thread must call it.
__device__ void land_tiles(const float* C, float* MT, int P4, int ld, int p,
                           int n, int tile_n, float lam, float* x_out,
                           size_t off, bool vec) {
  const int nq = tile_n / 4;
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
}

int launch(const void* kernel, int smem, int B, cudaStream_t stream,
           void** args, int threads = kThreads) {
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B > 0) {
    err = cudaLaunchKernel(kernel, dim3(B), dim3(threads), args, smem, stream);
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
