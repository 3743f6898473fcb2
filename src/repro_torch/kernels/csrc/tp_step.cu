// Tensor-parallel fused group step for Hopper (sm_90a), plain fp32 CUDA C++.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/fused_step.py:
//   tp_gram   <- tp_gram_whole  (:304, body _tp_gram_kernel :266)
//   tp_apply  <- tp_apply_whole (:417, body _tp_apply_kernel :360)
//
// The TP schedule splits each (p, n) matrix of a (B, p, n) stack over n;
// a rank holds (B_local, p, n_local) columns. The step reads the matrix
// only through three (p, p) grams, each a sum over columns:
//   tp_gram   base moments on the rank's columns (mu' written once), the
//             gram operand Gb (post_scale * Geu; vadam: the UNSCALED first
//             moment, its per-matrix scalar needs the full sum g^2) written
//             once, and the payload row [A | B | S (| sum g^2)] of
//             A = X X^T, B = X Gb^T, S = Gb Gb^T over the rank's columns.
// One all-reduce of the (B, K) payloads over the TP group (outside the
// kernels) gives every rank the full grams; then
//   tp_apply  scales B, S and Gb by vadam's scalar scl (and scl^2),
//             forms R R^T = 1/4 (A S A - A B^T B^T - B B A + B A B^T) and
//             POGO:    C = A + eta^2 R R^T, M = X - eta 1/2 (A Geff - B X),
//                      X' = (1 + lam) M - lam C M,
//                      dist from (1+lam)^2 C - 2 lam (1+lam) C^2 + lam^2 C^3;
//             Landing: X' = X - eta (R + lam (A X - X)), dist from
//                      A - 2 eta lam (A^2 - A) + eta^2 F F^T with
//                      F F^T = R R^T + lam (R N^T + N R^T)
//                              + lam^2 (A^3 - 2 A^2 + A),
//                      R N^T = (R X^T) A - R X^T, R X^T = 1/2 (A B^T - B A),
//             so dist depends on the replicated payload only and is the
//             same on every rank. X' is written over the rank's columns.
//
// The TPU kernels keep a rank's whole (p, n_local) block in VMEM and fall
// back to jnp when it does not fit. One H100 block has 227 KB: a SmolLM
// shard at width 2, (64, 480), is 245 KB for X and Gb alone. So both
// kernels sweep n_local in tile_n-wide column tiles (one CTA per matrix,
// as the fused kernels do): exact, since the grams are sums over columns
// and the apply stage is column-local once the grams are known. No
// fallback.
//
// Bound (per matrix, 4 p n bytes a pass): tp_gram reads X, g, mu and
// writes mu', Gb (5 passes) for three p x p x n products (6 p^2 n
// flops); tp_apply reads X, Gb and writes X' (3 passes) for three
// products (6 p^2 n) plus ~10 (p, p) x (p, p) products (20 p^3). At
// p = 64 both are bound by fp32 operations on an H100 SXM, at p = 16 by
// bytes. The (p, n) products are the register blocks of tiles.cuh (IEEE
// fp32, no TF32); the (p, p) products run one output element per thread
// step from shared memory.
//
// Grams live in shared memory column-major, M[i, j] at [j * P4 + i] (the
// convention of tiles.cuh), zero past p. The payload is row-major per
// matrix: payload[b * K + i * p + j] = A[i, j], then B, then S.
// Scalars ride a device vector scal[8] = [eta, lam, post_scale, h0, ...]
// (h0: trace's decay or vadam's b1). Every launcher returns
// cudaGetLastError(). x_out may alias x and mu_out mu: each CTA owns its
// matrix and reads a tile's columns before writing them.

#include "tiles.cuh"

namespace {

// Blocks per SM the register budget allows (ops.py mirrors it): 2 caps
// both kernels at 128 registers.
constexpr int kTpBlocksPerSm = 2;

// out (+)= alpha P Q' for (p, p) matrices in shared memory, column-major
// with stride P4, Q' = Q or Q^T. One output element per thread step:
// consecutive threads take consecutive rows (conflict-free reads of P,
// broadcast reads of Q). out must not alias P or Q. Every thread must
// call it; it does not synchronise.
__device__ void pp_mul(float* out, const float* P, const float* Q, bool tQ,
                       int P4, int p, float alpha, bool accumulate) {
  for (int e = threadIdx.x; e < p * p; e += kThreads) {
    const int i = e % p, j = e / p;
    float s = 0.f;
    for (int l = 0; l < p; ++l) {
      const float q = tQ ? Q[l * P4 + j] : Q[j * P4 + l];
      s = fmaf(P[l * P4 + i], q, s);
    }
    out[j * P4 + i] = accumulate ? out[j * P4 + i] + alpha * s : alpha * s;
  }
}

// ------------------------------------------------------------------ gram

__global__ void __launch_bounds__(kThreads, kTpBlocksPerSm)
tp_gram_kernel(const float* x, const float* g, const float* mu,
               const float* scal, float* payload, float* gb, float* mu_out,
               int p, int n, int K, int base_kind, int nesterov, int tile_n,
               int vec) {
  extern __shared__ float4 tp_gram_sm[];
  const int b = blockIdx.x;
  const int P4 = round4(p), ld = tile_ld(P4);
  float* A = reinterpret_cast<float*>(tp_gram_sm);  // (p, p), [j * P4 + i]
  float* BT = A + P4 * P4;
  float* S = BT + P4 * P4;
  float* XT = S + P4 * P4;  // k-major tiles, [k * ld + i]
  float* GT = XT + tile_n * ld;
  float* red = GT + tile_n * ld;
  const size_t off = static_cast<size_t>(b) * p * n;
  const float ps = scal[2], h0 = scal[3];
  const bool scale = base_kind != kVAdam && ps != 1.f;

  for (int e = threadIdx.x; e < 2 * tile_n * ld; e += kThreads) XT[e] = 0.f;
  __syncthreads();
  float sq = 0.f;
  for (int t0 = 0; t0 < n; t0 += tile_n) {
    stage_moments(XT, GT, ld, x, g, mu, mu_out, off, p, n, t0, tile_n,
                  base_kind, nesterov, h0, vec, sq);
    __syncthreads();
    if (scale) {
      for (int e = threadIdx.x; e < tile_n * ld; e += kThreads) GT[e] *= ps;
      __syncthreads();
    }
    const int kc = min(tile_n, n - t0);
    store_tile(GT, ld, p, n, t0, tile_n, gb, off, vec);
    gram_tile<true>(A, BT, XT, XT, GT, ld, P4, kc, t0 > 0);
    gram_tile<false>(S, nullptr, GT, GT, nullptr, ld, P4, kc, t0 > 0);
    __syncthreads();
  }
  float* row = payload + static_cast<size_t>(b) * K;
  const int pp = p * p;
  for (int e = threadIdx.x; e < pp; e += kThreads) {
    const int i = e / p, j = e - i * p;
    row[e] = A[j * P4 + i];
    row[pp + e] = BT[j * P4 + i];
    row[2 * pp + e] = S[j * P4 + i];
  }
  if (base_kind == kVAdam) {
    const float tot = block_sum(sq, red);
    if (threadIdx.x == 0) row[3 * pp] = tot;
  }
}

// ----------------------------------------------------------------- apply

// Loads columns [t0, t0 + tile_n) of X and s * Gb into the k-major tiles.
__device__ void load_tiles(float* XT, float* GT, int ld, const float* x,
                           const float* gb, size_t off, int p, int n, int t0,
                           int tile_n, float s, bool vec) {
  for (int u = threadIdx.x; u < p * (tile_n / 4); u += kThreads) {
    const int i = u % p, kk = 4 * (u / p);
    const size_t row = off + static_cast<size_t>(i) * n;
    float xv[4], gv[4];
    gload4(xv, x + row, t0 + kk, n, vec);
    gload4(gv, gb + row, t0 + kk, n, vec);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      XT[(kk + c) * ld + i] = xv[c];
      GT[(kk + c) * ld + i] = s * gv[c];
    }
  }
}

__global__ void __launch_bounds__(kThreads, kTpBlocksPerSm)
tp_apply_kernel(const float* x, const float* gb, const float* payload,
                const float* scl, const float* scal, const int* pv,
                float* x_out, float* dist, int p, int n, int K, int method,
                int tile_n, int vec) {
  extern __shared__ float4 tp_apply_sm[];
  const int b = blockIdx.x;
  const int P4 = round4(p), nq = tile_n / 4, ld = tile_ld(P4);
  const int G = P4 * P4;
  float* A = reinterpret_cast<float*>(tp_apply_sm);  // (p, p), [j * P4 + i]
  float* BT = A + G;  // B, scaled
  float* G2 = BT + G;  // S (scaled); then POGO's C, Landing's R N^T and A^2
  float* G3 = G2 + G;  // scratch products
  float* G4 = G3 + G;  // R R^T (unscaled by 1/4), then W
  float* XT = G4 + G;  // k-major tiles, [k * ld + i]
  float* GT = XT + tile_n * ld;
  float* MT = GT + tile_n * ld;
  float* red = MT + tile_n * ld;
  const size_t off = static_cast<size_t>(b) * p * n;
  const float eta = scal[0], lam = scal[1];
  const float s = scl != nullptr ? scl[b] : 1.f;
  const int pvb = pv != nullptr ? pv[b] : p;
  const int pp = p * p;

  // Grams and tiles zero past p (and past n), so every product is exact.
  for (int e = threadIdx.x; e < 5 * G + 3 * tile_n * ld; e += kThreads) A[e] = 0.f;
  __syncthreads();
  const float* row = payload + static_cast<size_t>(b) * K;
  for (int e = threadIdx.x; e < pp; e += kThreads) {
    const int i = e / p, j = e - i * p;
    A[j * P4 + i] = row[e];
    BT[j * P4 + i] = s * row[pp + e];
    G2[j * P4 + i] = (s * s) * row[2 * pp + e];
  }
  __syncthreads();

  // R R^T, without its 1/4, into G4.
  pp_mul(G3, A, G2, false, P4, p, 1.f, false);  // A S
  __syncthreads();
  pp_mul(G4, G3, A, false, P4, p, 1.f, false);  // A S A
  __syncthreads();
  pp_mul(G3, A, BT, true, P4, p, 1.f, false);  // A B^T
  __syncthreads();
  pp_mul(G4, G3, BT, true, P4, p, -1.f, true);  // - A B^T B^T
  __syncthreads();
  pp_mul(G3, BT, BT, false, P4, p, 1.f, false);  // B B
  __syncthreads();
  pp_mul(G4, G3, A, false, P4, p, -1.f, true);  // - B B A
  __syncthreads();
  pp_mul(G3, BT, A, false, P4, p, 1.f, false);  // B A
  __syncthreads();
  pp_mul(G4, G3, BT, true, P4, p, 1.f, true);  // + B A B^T
  __syncthreads();

  if (method == kPogo) {
    for (int e = threadIdx.x; e < G; e += kThreads)
      G2[e] = A[e] + (eta * eta) * (0.25f * G4[e]);  // C = M M^T
    __syncthreads();
    pp_mul(G3, G2, G2, false, P4, p, 1.f, false);  // C^2
    __syncthreads();
    pp_mul(G4, G3, G2, false, P4, p, 1.f, false);  // C^3
    __syncthreads();
    const float k1 = (1.f + lam) * (1.f + lam);
    const float k2 = 2.f * lam * (1.f + lam);
    const float k3 = lam * lam;
    for (int e = threadIdx.x; e < G; e += kThreads)
      G4[e] = k1 * G2[e] - k2 * G3[e] + k3 * G4[e];
  } else {
    pp_mul(G3, A, BT, true, P4, p, 1.f, false);  // A B^T
    __syncthreads();
    pp_mul(G3, BT, A, false, P4, p, -1.f, true);  // - B A
    __syncthreads();
    for (int e = threadIdx.x; e < G; e += kThreads) G3[e] *= 0.5f;  // R X^T
    __syncthreads();
    pp_mul(G2, G3, A, false, P4, p, 1.f, false);  // (R X^T) A
    __syncthreads();
    for (int e = threadIdx.x; e < G; e += kThreads) G2[e] -= G3[e];  // R N^T
    __syncthreads();
    for (int e = threadIdx.x; e < pp; e += kThreads) {
      const int i = e % p, j = e / p;  // R R^T + lam (R N^T + N R^T)
      G4[j * P4 + i] = 0.25f * G4[j * P4 + i] +
                       lam * (G2[j * P4 + i] + G2[i * P4 + j]);
    }
    __syncthreads();
    pp_mul(G2, A, A, false, P4, p, 1.f, false);  // A^2
    __syncthreads();
    pp_mul(G3, G2, A, false, P4, p, 1.f, false);  // A^3
    __syncthreads();
    for (int e = threadIdx.x; e < G; e += kThreads) {
      const float nn = G3[e] - 2.f * G2[e] + A[e];  // N N^T
      G4[e] = A[e] - 2.f * eta * lam * (G2[e] - A[e]) +
              (eta * eta) * (G4[e] + (lam * lam) * nn);
    }
  }
  __syncthreads();
  residual_dist(G4, P4, p, pvb, red, dist + b);

  // The rank's columns of X', tile by tile.
  const int ni = P4 / 4;
  for (int t0 = 0; t0 < n; t0 += tile_n) {
    load_tiles(XT, GT, ld, x, gb, off, p, n, t0, tile_n, s, vec);
    __syncthreads();
    if (method == kLanding) {
      leap_tile<true>(A, BT, XT, GT, MT, P4, ld, p, n, t0, nq, eta, x_out,
                      off, vec, eta * lam);
    } else {
      for (int blk = threadIdx.x; blk < ni * nq; blk += kThreads) {
        const int i0 = 4 * (blk % ni), k0 = 4 * (blk / ni);
        float4 m[4];
        leap_block<false>(A, BT, XT, GT, P4, ld, i0, k0, eta, 0.f, m);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          *reinterpret_cast<float4*>(MT + (k0 + c) * ld + i0) = m[c];
      }
      __syncthreads();
      land_store(G2, MT, P4, ld, p, n, t0, tile_n, lam, x_out, off, vec);
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of one CTA, in bytes (ops.py mirrors both).
int tp_gram_smem_bytes(int p, int tile_n) {
  const int p4 = round4(p);
  return static_cast<int>(sizeof(float)) *
         (3 * p4 * p4 + 2 * tile_n * tile_ld(p4) + kWarps);
}

int tp_apply_smem_bytes(int p, int tile_n) {
  const int p4 = round4(p);
  return static_cast<int>(sizeof(float)) *
         (5 * p4 * p4 + 3 * tile_n * tile_ld(p4) + kWarps);
}

int tp_gram(const float* x, const float* g, const float* mu,
            const float* scal, float* payload, float* gb, float* mu_out,
            int B, int p, int n, int base_kind, int nesterov, int tile_n,
            void* stream) {
  if (p < 1 || n < 1 || tile_n < 4 || tile_n % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int K = 3 * p * p + (base_kind == kVAdam ? 1 : 0);
  const void* rows[] = {x, g, mu, gb, mu_out};
  int vec = vector_ok(n, rows, 5);
  void* args[] = {&x, &g, &mu, &scal, &payload, &gb, &mu_out, &p, &n, &K,
                  &base_kind, &nesterov, &tile_n, &vec};
  return launch(reinterpret_cast<const void*>(tp_gram_kernel),
                tp_gram_smem_bytes(p, tile_n), B,
                static_cast<cudaStream_t>(stream), args);
}

// method: 0 POGO, 1 Landing. K is the payload's row stride.
int tp_apply(const float* x, const float* gb, const float* payload,
             const float* scl, const float* scal, const int* pv,
             float* x_out, float* dist, int B, int p, int n, int K,
             int method, int tile_n, void* stream) {
  if (p < 1 || n < 1 || tile_n < 4 || tile_n % 4 != 0 || K < 3 * p * p ||
      (method != kPogo && method != kLanding)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* rows[] = {x, gb, x_out};
  int vec = vector_ok(n, rows, 3);
  void* args[] = {&x, &gb, &payload, &scl, &scal, &pv, &x_out, &dist,
                  &p, &n, &K, &method, &tile_n, &vec};
  return launch(reinterpret_cast<const void*>(tp_apply_kernel),
                tp_apply_smem_bytes(p, tile_n), B,
                static_cast<cudaStream_t>(stream), args);
}

}  // extern "C"
