// Kernels of the two-stage group step for Hopper (sm_90a), plain fp32
// CUDA C++. The base optimizer runs before them, in PyTorch; they take
// the transformed gradient G and the stack X.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/:
//   pogo_update_whole    <- pogo_update.py:64  (_pogo_whole_kernel :47)
//   pogo_update_tiled    <- pogo_update.py:143 (_phase1/2/3_kernel :91/:110/:133)
//   landing_field_whole  <- landing_field.py:42 (_landing_kernel :26)
//   landing_field_tiled  <- landing_field.py:79 (pogo_update._phase1_kernel
//                                                + _field_tile_kernel :65)
//
// One CTA owns one (p, n) matrix of the (B, p, n) stack:
//   grams  A = X X^T, B = X G^T                            (fp32, in smem)
//   POGO   M = X - eta 1/2 (A G - B X), C = M M^T,
//          X' = (1 + lam) M - lam C M                      (written once)
//   field  Lambda = 1/2 (A G - B X) + lam (A X - X)        (written once)
// The tiled kernels sweep tile_n-wide column tiles instead of the TPU's
// sequential grid axis: sweep 1 accumulates A and B; POGO's sweep 2 forms
// M, parks it in the output and accumulates C, and sweep 3 reads M back
// and writes X' over it; the field's sweep 2 writes Lambda. One launch per
// group, no inter-CTA synchronisation.
//
// Bound: both read X and G and write one (p, n) result: 3 HBM passes of
// 4 p n bytes. POGO needs six p x p x n products (12 p^2 n flops), the
// field four (8 p^2 n: its B X and A X share one product, which this
// kernel does as two), i.e. p and 2/3 p flop/byte against the fp32
// ridge of 20 (67 TFLOP/s over 3.35 TB/s): p = 16 stacks are bound by
// bytes, p = 64 stacks by fp32 operations. The products are the register
// blocks of tiles.cuh (IEEE fp32 FMAs, no TF32, no fast math), the same
// as the fused kernels'.
//
// Scalars ride a device vector scal[2] = [eta, lam] (the field reads only
// lam), so a learning rate held on the card needs no host sync. Every
// launcher returns cudaGetLastError(). out may alias x: each CTA reads
// its matrix's X before writing that column range (whole: all of it;
// tiled: tile by tile), and G must not alias out.

#include "tiles.cuh"

namespace {

// Blocks per SM the register budget allows (ops.py mirrors the tiled
// one), as for the fused kernels: 4 caps the whole kernels at 64
// registers, 3 the tiled ones at 85.
constexpr int kWholeBlocksPerSm = 4;
constexpr int kTiledBlocksPerSm = 3;

// (p, p) grams each method keeps in shared memory: A, B (and POGO's C).
// The tiled kernels keep as many column tiles: X, G (and POGO's M).
__host__ __device__ inline int n_grams(int method) {
  return method == kPogo ? 3 : 2;
}

// Rows i0..i0+3 (those below p), columns t0 + k0 .. t0 + k0 + 3 of
// Lambda = 1/2 (A G - B X) + lam (A X - X), written to HBM.
__device__ inline void field_block(const float* A, const float* BT,
                                   const float* XT, const float* GT, int P4,
                                   int ld, int p, int n, int i0, int k0,
                                   int t0, float lam, float* out, size_t off,
                                   bool vec) {
  float ag[4][4] = {}, bx[4][4] = {};
  prod_block(A, GT, P4, ld, i0, k0, ag);
  prod_block(BT, XT, P4, ld, i0, k0, bx);
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) bx[r][c] = 0.5f * (ag[r][c] - bx[r][c]);
  float ax[4][4] = {};
  prod_block(A, XT, P4, ld, i0, k0, ax);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (i0 + r >= p) break;
    float o[4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      o[c] = bx[r][c] + lam * (ax[r][c] - XT[(k0 + c) * ld + i0 + r]);
    gstore4(out + off + static_cast<size_t>(i0 + r) * n, t0 + k0, n, vec, o);
  }
}

// Lambda for the tile's columns [t0, t0 + 4 nq) from the resident X, G
// tiles and the grams.
__device__ void field_tile(const float* A, const float* BT, const float* XT,
                           const float* GT, int P4, int ld, int p, int n,
                           int t0, int nq, float lam, float* out, size_t off,
                           bool vec) {
  const int ni = P4 / 4;
  for (int blk = threadIdx.x; blk < ni * nq; blk += kThreads) {
    field_block(A, BT, XT, GT, P4, ld, p, n, 4 * (blk % ni), 4 * (blk / ni),
                t0, lam, out, off, vec);
  }
}

// ---------------------------------------------------------------- whole
//
// X and G stay resident (k-major, all n columns). POGO writes M over X,
// then C and X'; the field is written straight from X, G and the grams.

template <int kMethod>
__global__ void __launch_bounds__(kThreads, kWholeBlocksPerSm)
two_stage_whole_kernel(const float* x, const float* g, const float* scal,
                       float* out, int p, int n, int vec) {
  extern __shared__ float4 ts_whole_sm[];
  const int b = blockIdx.x;
  const int P4 = round4(p), N4 = round4(n), ld = tile_ld(P4);
  float* XT = reinterpret_cast<float*>(ts_whole_sm);  // [k * ld + i]
  float* GT = XT + N4 * ld;
  float* A = GT + N4 * ld;  // (p, p) grams, [j * P4 + i]
  float* BT = A + P4 * P4;
  float* C = BT + P4 * P4;  // POGO only
  const size_t off = static_cast<size_t>(b) * p * n;
  const float eta = scal[0], lam = scal[1];

  // Rows p..P4 stay zero, so every product is exact on them.
  for (int e = threadIdx.x; e < 2 * N4 * ld; e += kThreads) XT[e] = 0.f;
  __syncthreads();
  float sq = 0.f;
  stage_moments(XT, GT, ld, x, g, nullptr, nullptr, off, p, n, 0, N4, kNone,
                0, 0.f, vec, sq);
  __syncthreads();
  gram_tile<true>(A, BT, XT, XT, GT, ld, P4, n, false);
  __syncthreads();

  if (kMethod == kLanding) {
    field_tile(A, BT, XT, GT, P4, ld, p, n, 0, N4 / 4, lam, out, off, vec);
    return;
  }
  leap_over_x(A, BT, XT, GT, P4, ld, N4, eta);
  __syncthreads();
  gram_tile<false>(C, nullptr, XT, XT, nullptr, ld, P4, n, false);
  __syncthreads();
  land_store(C, XT, P4, ld, p, n, 0, N4, lam, out, off, vec);
}

// ---------------------------------------------------------------- tiled

template <int kMethod>
__global__ void __launch_bounds__(kThreads, kTiledBlocksPerSm)
two_stage_tiled_kernel(const float* x, const float* g, const float* scal,
                       float* out, int p, int n, int tile_n, int vec) {
  extern __shared__ float4 ts_tiled_sm[];
  const int b = blockIdx.x;
  const int P4 = round4(p), nq = tile_n / 4, ld = tile_ld(P4);
  const int grams = n_grams(kMethod);
  float* A = reinterpret_cast<float*>(ts_tiled_sm);  // (p, p) grams, [j * P4 + i]
  float* BT = A + P4 * P4;
  float* C = BT + P4 * P4;  // POGO only
  float* XT = A + grams * P4 * P4;  // k-major tiles, [k * ld + i]
  float* GT = XT + tile_n * ld;
  float* MT = GT + tile_n * ld;  // POGO only
  const size_t off = static_cast<size_t>(b) * p * n;
  const float eta = scal[0], lam = scal[1];

  for (int e = threadIdx.x; e < grams * tile_n * ld; e += kThreads) XT[e] = 0.f;
  __syncthreads();

  float sq = 0.f;
  for (int t0 = 0; t0 < n; t0 += tile_n) {  // sweep 1: A, B
    stage_moments(XT, GT, ld, x, g, nullptr, nullptr, off, p, n, t0, tile_n,
                  kNone, 0, 0.f, vec, sq);
    __syncthreads();
    gram_tile<true>(A, BT, XT, XT, GT, ld, P4, min(tile_n, n - t0), t0 > 0);
    __syncthreads();
  }
  for (int t0 = 0; t0 < n; t0 += tile_n) {  // sweep 2: M and C, or Lambda
    stage_moments(XT, GT, ld, x, g, nullptr, nullptr, off, p, n, t0, tile_n,
                  kNone, 0, 0.f, vec, sq);
    __syncthreads();
    if (kMethod == kLanding) {
      field_tile(A, BT, XT, GT, P4, ld, p, n, t0, nq, lam, out, off, vec);
    } else {
      leap_tile(A, BT, XT, GT, MT, P4, ld, p, n, t0, nq, eta, out, off, vec);
      __syncthreads();
      gram_tile<false>(C, nullptr, MT, MT, nullptr, ld, P4,
                       min(tile_n, n - t0), t0 > 0);
    }
    __syncthreads();
  }
  if (kMethod == kPogo) land_tiles(C, MT, P4, ld, p, n, tile_n, lam, out, off, vec);
}

int check_shape(int p, int n) {
  return p < 1 || n < 1 || round4(p) / 4 > kThreads;
}

}  // namespace

extern "C" {

// Dynamic shared memory of one CTA, in bytes (ops.py mirrors both):
// X and G (whole: all columns; tiled: one tile each, and POGO's M tile)
// and the grams.
int two_stage_whole_smem_bytes(int method, int p, int n) {
  const int p4 = round4(p);
  return static_cast<int>(sizeof(float)) *
         (2 * round4(n) * tile_ld(p4) + n_grams(method) * p4 * p4);
}

int two_stage_tiled_smem_bytes(int method, int p, int tile_n) {
  const int p4 = round4(p);
  return static_cast<int>(sizeof(float)) *
         n_grams(method) * (p4 * p4 + tile_n * tile_ld(p4));
}

#define TWO_STAGE_WHOLE(name, method)                                         \
  int name(const float* x, const float* g, const float* scal, float* out,    \
           int B, int p, int n, void* stream) {                               \
    if (check_shape(p, n)) return static_cast<int>(cudaErrorInvalidValue);    \
    const void* rows[] = {x, g, out};                                         \
    int vec = vector_ok(n, rows, 3);                                          \
    void* args[] = {&x, &g, &scal, &out, &p, &n, &vec};                       \
    return launch(                                                            \
        reinterpret_cast<const void*>(two_stage_whole_kernel<method>),        \
        two_stage_whole_smem_bytes(method, p, n), B,                          \
        static_cast<cudaStream_t>(stream), args);                             \
  }

#define TWO_STAGE_TILED(name, method)                                         \
  int name(const float* x, const float* g, const float* scal, float* out,    \
           int B, int p, int n, int tile_n, void* stream) {                   \
    if (check_shape(p, n) || tile_n < 4 || tile_n % 4 != 0)                   \
      return static_cast<int>(cudaErrorInvalidValue);                         \
    const void* rows[] = {x, g, out};                                         \
    int vec = vector_ok(n, rows, 3);                                          \
    void* args[] = {&x, &g, &scal, &out, &p, &n, &tile_n, &vec};              \
    return launch(                                                            \
        reinterpret_cast<const void*>(two_stage_tiled_kernel<method>),        \
        two_stage_tiled_smem_bytes(method, p, tile_n), B,                     \
        static_cast<cudaStream_t>(stream), args);                             \
  }

TWO_STAGE_WHOLE(pogo_update_whole, kPogo)
TWO_STAGE_TILED(pogo_update_tiled, kPogo)
TWO_STAGE_WHOLE(landing_field_whole, kLanding)
TWO_STAGE_TILED(landing_field_tiled, kLanding)

}  // extern "C"
