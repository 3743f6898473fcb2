// Fused POGO and Landing group steps for Hopper (sm_90a), plain fp32 CUDA C++.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/fused_step.py:
//   fused_step_whole          <- _fused_whole_kernel (POGO branch, :155-163)
//   fused_step_whole_landing  <- _fused_whole_kernel (Landing branch, :164-168)
//   fused_step_tiled          <- _t1_kernel + _t2_pogo_kernel + pogo_update._phase3_kernel
//                                and the (p, p) telemetry products left to XLA there.
//   fused_step_tiled_landing  <- _t1_kernel + _t2_landing_kernel (:559), via
//                                fused_step_tiled (:608, Landing branch :701)
//
// One CTA owns one (p, n) matrix of the (B, p, n) stack and does, in order:
//   base stage   none | trace (+nesterov) | vadam: mu' (and nu') written once
//   grams        A = X X^T, B = X Geu^T                      (fp32, in smem)
// then POGO:
//   leap         M = X - eta s 1/2 (A Geu - B X)             (column-local)
//   land gram    C = M M^T
//   land         X' = (1 + lam) M - lam C M                  (written once)
//   telemetry    dist = ||(1+lam)^2 C - 2 lam (1+lam) C^2 + lam^2 C^3 - I_pv||_F
// or Landing's fixed step:
//   step         X' = X - eta (s 1/2 (A Geu - B X) + lam (A X - X))
//                                              (column-local, written once)
//   telemetry    dist = ||W - I_pv||_F, W = X' X'^T summed as X' is made
// Geu is the unscaled transformed gradient (trace: the momentum output;
// vadam: the first moment) and s its per-matrix scale (post_scale, and the
// vadam normalisation, which commutes with the linear direction map).
//
// Bound: six p x p x n products (12 p^2 n flops; Landing's A X replaces
// POGO's C M) against 5 HBM passes of
// 4 p n bytes, i.e. 0.6 p flop/byte. The fp32 ridge of an H100 SXM (67
// TFLOP/s over 3.35 TB/s) is 20 flop/byte, so p = 16 stacks are bound by
// bytes and p = 64 stacks by fp32 operations. Every product is IEEE fp32
// on the CUDA cores (no TF32, no wgmma), run by the blocks of tiles.cuh
// from k-major shared-memory tiles (T[k * ld + i], P4 = p rounded up to
// 4, ld = P4 or P4 + 4, rows past p zero) in 4 x 4 register blocks fed
// by float4 loads: two 16-byte loads per 16 FMAs in the grams, eight per
// 64 in the (p, p) x (p, cols) products, each load conflict-free or a
// broadcast. The whole kernel reads X, g, mu once and writes X', mu'
// once; the tiled POGO kernel sweeps n three times and parks M in x_out
// between the last two, the tiled Landing kernel sweeps twice (X' is
// final in its second sweep). For 32 <= p <= 64 the planner sends the
// tiled shapes to fused_step_tc.cu (3xTF32 on the tensor cores, TMA-fed);
// the tiled kernels here take p < 32 and p > 64.
//
// Scalars ride a device vector scal[8] = [eta, lam, post_scale, h0..h4]
// with h = (decay) for trace and (b1, b2, eps, c1, c2) for vadam, as
// kernels/fused_step.py packs it. Every launcher returns cudaGetLastError().
// Outputs may alias inputs (x_out == x, mu_out == mu, nu_out == nu): each
// CTA owns its matrix and never reads an element after writing it, other
// than the mu' and (tiled) the M it wrote itself.

#include "tiles.cuh"

namespace {

// Blocks per SM each kernel's register budget allows (ops.py mirrors the
// tiled one): 4 caps the whole kernel at 64 registers, 3 the tiled one at
// 85, both without spills. The whole kernel waits on HBM and the tiled one
// on its barriers, so more resident blocks hide more of both.
constexpr int kWholeBlocksPerSm = 4;
constexpr int kTiledBlocksPerSm = 3;

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

template <int kMethod>
__device__ inline void fused_whole(
    const float* x, const float* g, const float* mu, const float* nu,
    const float* scal, const int* pv, float* x_out, float* mu_out,
    float* nu_out, float* dist, int p, int n, int base_kind, int nesterov,
    int vec) {
  extern __shared__ float4 whole_sm[];
  const int b = blockIdx.x;
  const int P4 = round4(p), N4 = round4(n), ld = tile_ld(P4);
  float* XT = reinterpret_cast<float*>(whole_sm);  // [k * ld + i]
  float* GT = XT + N4 * ld;
  float* A = GT + N4 * ld;  // (p, p) grams, [j * P4 + i]
  float* BT = A + P4 * P4;
  float* C = BT + P4 * P4;  // POGO's C, Landing's W
  float* red = C + P4 * P4;
  const size_t off = static_cast<size_t>(b) * p * n;
  const float eta = scal[0], lam = scal[1], h0 = scal[3];
  const float nu0 = base_kind == kVAdam ? nu[b] : 0.f;
  const int pvb = pv != nullptr ? pv[b] : p;

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

  leap_over_x<kMethod == kLanding>(A, BT, XT, GT, P4, ld, N4, coef, eta * lam);
  __syncthreads();

  gram_tile<false>(C, nullptr, XT, XT, nullptr, ld, P4, n, false);
  __syncthreads();
  if (kMethod == kLanding) {  // X' is resident: store it, measure W = C
    store_tile(XT, ld, p, n, 0, N4, x_out, off, vec);
    residual_dist(C, P4, p, pvb, red, dist + b);
    return;
  }
  land_store(C, XT, P4, ld, p, n, 0, N4, lam, x_out, off, vec);
  telemetry(C, A, P4, p, pvb, lam, red, dist + b);
}

#define FUSED_ARGS                                                          \
  const float *x, const float *g, const float *mu, const float *nu,         \
      const float *scal, const int *pv, float *x_out, float *mu_out,        \
      float *nu_out, float *dist, int p, int n, int base_kind, int nesterov

__global__ void __launch_bounds__(kThreads, kWholeBlocksPerSm)
fused_whole_kernel(FUSED_ARGS, int vec) {
  fused_whole<kPogo>(x, g, mu, nu, scal, pv, x_out, mu_out, nu_out, dist, p,
                     n, base_kind, nesterov, vec);
}

__global__ void __launch_bounds__(kThreads, kWholeBlocksPerSm)
fused_whole_landing_kernel(FUSED_ARGS, int vec) {
  fused_whole<kLanding>(x, g, mu, nu, scal, pv, x_out, mu_out, nu_out, dist,
                        p, n, base_kind, nesterov, vec);
}

// ---------------------------------------------------------------- tiled
//
// Sweeps over tile_n-wide column tiles, the (p, p) grams resident:
// moments + A, B; then POGO's M (stored in x_out) + C and X' from the
// stored M, or Landing's X' + W.

template <int kMethod>
__device__ inline void fused_tiled(
    const float* x, const float* g, const float* mu, const float* nu,
    const float* scal, const int* pv, float* x_out, float* mu_out,
    float* nu_out, float* dist, int p, int n, int base_kind, int nesterov,
    int tile_n, int vec) {
  extern __shared__ float4 tiled_sm[];
  const int b = blockIdx.x;
  const int P4 = round4(p), nq = tile_n / 4, ld = tile_ld(P4);
  float* A = reinterpret_cast<float*>(tiled_sm);  // (p, p) grams, [j * P4 + i]
  float* BT = A + P4 * P4;
  float* C = BT + P4 * P4;  // POGO's C, Landing's W
  float* XT = C + P4 * P4;  // k-major tiles, [k * ld + i]
  float* GT = XT + tile_n * ld;
  float* MT = GT + tile_n * ld;  // POGO's M, Landing's X'
  float* red = MT + tile_n * ld;
  const size_t off = static_cast<size_t>(b) * p * n;
  const float eta = scal[0], lam = scal[1], h0 = scal[3];
  const float nu0 = base_kind == kVAdam ? nu[b] : 0.f;
  const int pvb = pv != nullptr ? pv[b] : p;

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

  // Sweep 2 rebuilds each tile's Geu from mu' (or g). POGO makes M, stores
  // it in x_out as scratch and accumulates C; sweep 3 reads M back and
  // writes X' over it. Storing M moves the same HBM bytes as recomputing
  // it in sweep 3 (a write and a read instead of two reads) and saves
  // 4 p^2 n flops. Landing's sweep 2 writes the final X' and accumulates W.
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
    leap_tile<kMethod == kLanding>(A, BT, XT, GT, MT, P4, ld, p, n, t0, nq,
                                   coef, x_out, off, vec, eta * lam);
    __syncthreads();
    gram_tile<false>(C, nullptr, MT, MT, nullptr, ld, P4, min(tile_n, n - t0),
                     t0 > 0);
    __syncthreads();
  }
  if (kMethod == kLanding) {
    residual_dist(C, P4, p, pvb, red, dist + b);
    return;
  }
  land_tiles(C, MT, P4, ld, p, n, tile_n, lam, x_out, off, vec);
  telemetry(C, A, P4, p, pvb, lam, red, dist + b);
}

__global__ void __launch_bounds__(kThreads, kTiledBlocksPerSm)
fused_tiled_kernel(FUSED_ARGS, int tile_n, int vec) {
  fused_tiled<kPogo>(x, g, mu, nu, scal, pv, x_out, mu_out, nu_out, dist, p,
                     n, base_kind, nesterov, tile_n, vec);
}

__global__ void __launch_bounds__(kThreads, kTiledBlocksPerSm)
fused_tiled_landing_kernel(FUSED_ARGS, int tile_n, int vec) {
  fused_tiled<kLanding>(x, g, mu, nu, scal, pv, x_out, mu_out, nu_out, dist,
                        p, n, base_kind, nesterov, tile_n, vec);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one CTA, in bytes (ops.py mirrors both); the
// Landing branches use the same buffers (W where POGO keeps C, X' where
// it keeps M).
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

// method: 0 POGO, 1 Landing (the fixed step).
int fused_step_whole(const float* x, const float* g, const float* mu,
                     const float* nu, const float* scal, const int* pv,
                     float* x_out, float* mu_out, float* nu_out, float* dist,
                     int B, int p, int n, int base_kind, int nesterov,
                     int method, void* stream) {
  if (p < 1 || n < 1 || round4(p) / 4 > kThreads ||
      (method != kPogo && method != kLanding)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* rows[] = {x, g, mu, x_out, mu_out};
  int vec = vector_ok(n, rows, 5);
  void* args[] = {&x, &g, &mu, &nu, &scal, &pv, &x_out, &mu_out, &nu_out,
                  &dist, &p, &n, &base_kind, &nesterov, &vec};
  const void* kernel = method == kLanding
      ? reinterpret_cast<const void*>(fused_whole_landing_kernel)
      : reinterpret_cast<const void*>(fused_whole_kernel);
  return launch(kernel, fused_whole_smem_bytes(p, n), B,
                static_cast<cudaStream_t>(stream), args);
}

int fused_step_tiled(const float* x, const float* g, const float* mu,
                     const float* nu, const float* scal, const int* pv,
                     float* x_out, float* mu_out, float* nu_out, float* dist,
                     int B, int p, int n, int base_kind, int nesterov,
                     int method, int tile_n, void* stream) {
  if (p < 1 || n < 1 || tile_n < 4 || tile_n % 4 != 0 ||
      (method != kPogo && method != kLanding)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* rows[] = {x, g, mu, x_out, mu_out};
  int vec = vector_ok(n, rows, 5);
  void* args[] = {&x, &g, &mu, &nu, &scal, &pv, &x_out, &mu_out, &nu_out,
                  &dist, &p, &n, &base_kind, &nesterov, &tile_n, &vec};
  const void* kernel = method == kLanding
      ? reinterpret_cast<const void*>(fused_tiled_landing_kernel)
      : reinterpret_cast<const void*>(fused_tiled_kernel);
  return launch(kernel, fused_tiled_smem_bytes(p, tile_n), B,
                static_cast<cudaStream_t>(stream), args);
}

}  // extern "C"
