// Kernels of the group step for p > 128 on Hopper (sm_90a): on the tensor
// cores (3xTF32 wgmma fed by TMA, the second half of this file) where n %
// 4 == 0, and in plain fp32 on the CUDA cores (the first half) where a
// row stride TMA cannot take (n % 4 != 0).
//
// Replaces, for p > 128 (kernels/ops.py plans them "large_tc" or "large":
// the grams and tiles of one matrix outgrow a block's shared memory there,
// and where the field's and Newton-Schulz's CUDA-core tiled kernels still
// fit, at p = 129-160, this route beat them on the card), the Pallas TPU
// kernels of src/repro/kernels/:
//   fused_step_large(_tc)(_landing) <- fused_step.py:608 fused_step_tiled
//                                      (_t1_kernel :476, _t2_pogo_kernel
//                                      :530, _t2_landing_kernel :559 and
//                                      pogo_update._phase3_kernel :133)
//   pogo_update_large(_tc)          <- pogo_update.py:143 pogo_update_tiled
//                                      (_phase1/2/3_kernel :91/:110/:133)
//   landing_field_large(_tc)        <- landing_field.py:79
//                                      landing_field_tiled
//                                      (pogo_update._phase1_kernel +
//                                      _field_tile_kernel :65)
//   newton_schulz_large(_tc)        <- newton_schulz.py:37 newton_schulz
//                                      (_ns_kernel :21)
//
// At p = 256 one fp32 (p, p) gram is 256 KB, more than a block's 227 KB,
// so no block holds a matrix's grams as the kernels of fused_step.cu,
// two_stage.cu and newton_schulz.cu do. The TPU's tiled kernels already
// run in phases with (p, p) accumulators between them. Here each phase is
// a launch, the (p, p) operands live in HBM (and mostly in L2), and two
// kernel families do all the work (kernels/large_p.py strings them
// together; the CUDA cores' first):
//
//   gram   O[b] = L[b] R[b]^T over n, as (Pp, Pp) fp32 (Pp = p rounded up
//          to 64, zero past p): 64 x 64 output tiles, 256 threads of 4 x 4
//          outputs, 32-column chunks of n staged k-major in shared memory.
//          A gram with few B x tiles splits n into slices, so that B x
//          tiles x slices fills the card; gram_reduce_kernel then sums the
//          slices' partials in a fixed order (never by atomics), so that
//          launches repeat bit for bit. Phase 1's form (kMoments) takes
//          A = X X^T and BT = Geu X^T (B^T, with B = X Geu^T) in one pass
//          and runs the base stage on the way: mu' is written by the
//          blocks of tile column 0 alone, vadam's sum of g^2 goes to one
//          slot a block. A self gram (C = M M^T, Landing's W, Newton-
//          Schulz's Y Y^T) computes the tiles on and above the diagonal
//          and mirrors them.
//   apply  out = f(base, P_1 Y_1, ..., P_k Y_k), k <= 3: the (p, p)
//          operands read k-major (P[i, j] at P^T[j, i]: the symmetric
//          grams, and BT for B), K = p streamed from L2 in 32-row chunks,
//          64 x 64 output tiles. M = X - eta s 1/2 (A Geu - B X) (kLeap),
//          POGO's land (1 + lam) M - lam C M (kLand), Landing's fixed step
//          X - eta (s R + lam (A X - X)) (kLandStep), the field R + lam
//          (A X - X) (kField) and Newton-Schulz's 1.5 Y - 0.5 (Y Y^T) Y
//          (kNs; its first iteration reads the Frobenius prescale off the
//          trace of the first gram, f^2 = tr X X^T).
//
// An apply block reads every row of its column tile of each Y operand, so
// its output must alias none of them: POGO's M goes to a scratch, Landing
// writes X' in place through one, and Newton-Schulz ping-pongs between its
// output and a scratch. The gram of phase 1 reads mu while the blocks of
// tile column 0 write mu', so mu' never goes over mu in place either.
//
// Bound: the p x p x n products a step needs, 2 p^2 n flops each and a
// symmetric gram half that: 10 p^2 n (POGO), 8 (fused Landing), 7 (the
// field), 3 a Newton-Schulz iteration, against at most 5 HBM passes of
// 4 p n bytes: 0.4 p flop/byte or more, so at every p here (>= 129) fp32
// operations bound it (67 TFLOP/s against 3.35 TB/s: a ridge of 20).
// O-ViT's 18 x (1024, 1024) launches thousands of blocks; CNN's 3 x (256,
// 2304) launches a few hundred, and its launches are short. IEEE fp32
// FMAs, no TF32, no fast math. The per-matrix scalars (eta, lam, vadam's
// s) are read on the card, so nothing waits for the host. Every launcher
// returns cudaGetLastError(). Newton-Schulz's iterations are issued by one
// C call on either route (large_newton_schulz, large_tc_newton_schulz), so
// a repair whose mask clears every matrix costs its launches alone.

#include "hopper.cuh"
#include "tf32_tile.cuh"
#include "tiles.cuh"

namespace {

constexpr int kT = 64;  // an output tile is kT x kT
constexpr int kK = 32;  // K chunk staged in shared memory
constexpr int kTile = kT * kT;

// kIdentity: the tensor-core apply alone (the gram identity's norm)
enum ApplyOp { kLeap = 0, kLand = 1, kLandStep = 2, kField = 3, kNs = 4, kIdentity = 5 };

__host__ __device__ inline int n_tiles(int p) { return (p + kT - 1) / kT; }
__host__ __device__ inline int padded(int p) { return n_tiles(p) * kT; }

// Output tiles of a gram: all nt x nt (phase 1), or those with tj >= ti
// (a self gram, mirrored).
__host__ __device__ inline int gram_tiles(int p, bool full) {
  const int nt = n_tiles(p);
  return full ? nt * nt : nt * (nt + 1) / 2;
}

__device__ inline void tile_of(int t, int nt, bool full, int& ti, int& tj) {
  if (full) {
    ti = t / nt;
    tj = t % nt;
    return;
  }
  ti = 0;
  while (t >= nt - ti) {
    t -= nt - ti;
    ++ti;
  }
  tj = ti + t;
}

// src[row, k .. k+7] of a (p, n) matrix, zero past row p or column ke.
__device__ inline void gload8(float v[8], const float* src, int row, int p,
                              int n, int k, int ke, bool vec) {
  if (row >= p) {
#pragma unroll
    for (int c = 0; c < 8; ++c) v[c] = 0.f;
    return;
  }
  const float* r = src + static_cast<size_t>(row) * n;
  if (vec && k + 7 < ke) {
    load4(v, *reinterpret_cast<const float4*>(r + k));
    load4(v + 4, *reinterpret_cast<const float4*>(r + k + 4));
  } else {
#pragma unroll
    for (int c = 0; c < 8; ++c) v[c] = k + c < ke ? r[k + c] : 0.f;
  }
}

__device__ inline void gstore8(float* dst, int k, int ke, bool vec,
                               const float v[8]) {
  if (vec && k + 7 < ke) {
    *reinterpret_cast<float4*>(dst + k) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(dst + k + 4) = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    for (int c = 0; c < 8 && k + c < ke; ++c) dst[k + c] = v[c];
  }
}

__device__ inline void sstore8(float* dst, const float v[8]) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

// acc[r][c] += u[r] w[c]
__device__ inline void outer4(float acc[4][4], const float4 u4, const float4 w4) {
  float u[4], w[4];
  load4(u, u4);
  load4(w, w4);
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(u[r], w[c], acc[r][c]);
}

// ---------------------------------------------------------------- gram

struct GramArgs {
  const float* x;             // (B, p, n): the self gram's rows, phase 1's X
  const float* g;             // phase 1: the gradient
  const float* mu;            // phase 1, trace / vadam: the first moment
  float* mu_out;              // phase 1, trace / vadam: mu' (never mu)
  const float* scal;          // phase 1: [eta, lam, post_scale, h0, ...]
  float* sq;                  // phase 1, vadam: (B, nt * slices) sums of g^2
  const unsigned char* mask;  // skip the matrices it clears (null: none)
  float* out0;                // (B, Pp, Pp): A, or the self gram
  float* out1;                // phase 1: BT
  float* part;                // slices > 1: (B, tiles, slices, outs, kTile)
  int p, n, slices, slice_len, base_kind, nesterov, vec;
};

// One (tile, n-slice) of a gram. kMoments: phase 1, A[ti, tj] = X_ti
// X_tj^T and BT[ti, tj] = Geu_ti X_tj^T with Geu formed from g and mu on
// the way; else the self gram X_ti X_tj^T for tj >= ti.
template <bool kMoments>
__global__ void __launch_bounds__(kThreads) gram_kernel(GramArgs a) {
  extern __shared__ float4 large_gram_sm[];
  float(*ls)[kT] = reinterpret_cast<float(*)[kT]>(large_gram_sm);  // [k][i]: L rows
  float(*rs)[kT] = ls + kK;                                        // R rows
  float(*es)[kT] = rs + kK;                                        // phase 1: Geu rows
  float* red = reinterpret_cast<float*>(es + (kMoments ? kK : 0));
  const int nt = n_tiles(a.p), tiles = gram_tiles(a.p, kMoments), Pp = nt * kT;
  int blk = blockIdx.x;
  const int s = blk % a.slices;
  blk /= a.slices;
  const int t = blk % tiles, b = blk / tiles;
  if (a.mask != nullptr && a.mask[b] == 0) return;
  int ti, tj;
  tile_of(t, nt, kMoments, ti, tj);
  const int i0 = ti * kT, j0 = tj * kT;
  const size_t off = static_cast<size_t>(b) * a.p * a.n;
  const int kb = s * a.slice_len, ke = min(a.n, kb + a.slice_len);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  // The loader: row lrow of the tile, columns lk .. lk+7 of the chunk.
  const int lrow = threadIdx.x % kT, lk = 8 * (threadIdx.x / kT);
  const bool vec = a.vec != 0;
  const int base = kMoments ? a.base_kind : kNone;
  const float h0 = base != kNone ? a.scal[3] : 0.f;
  const bool owner = kMoments && tj == 0;  // writes mu' and sums g^2 for rows ti
  float acc[4][4] = {}, acc_e[4][4] = {};
  float sq = 0.f;
  for (int k0 = kb; k0 < ke; k0 += kK) {
    float v[8];
    gload8(v, a.x + off, i0 + lrow, a.p, a.n, k0 + lk, ke, vec);
#pragma unroll
    for (int c = 0; c < 8; ++c) ls[lk + c][lrow] = v[c];
    gload8(v, a.x + off, j0 + lrow, a.p, a.n, k0 + lk, ke, vec);
#pragma unroll
    for (int c = 0; c < 8; ++c) rs[lk + c][lrow] = v[c];
    if (kMoments) {
      float gv[8];
      gload8(gv, a.g + off, i0 + lrow, a.p, a.n, k0 + lk, ke, vec);
      if (base != kNone) {
        float mv[8], m2[8];
        gload8(mv, a.mu + off, i0 + lrow, a.p, a.n, k0 + lk, ke, vec);
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          if (base == kTrace) {
            m2[c] = fmaf(h0, mv[c], gv[c]);
          } else {
            m2[c] = fmaf(h0, mv[c], (1.f - h0) * gv[c]);
            sq = fmaf(gv[c], gv[c], sq);
          }
        }
        if (owner && i0 + lrow < a.p)
          gstore8(a.mu_out + off + static_cast<size_t>(i0 + lrow) * a.n, k0 + lk, ke,
                  vec, m2);
#pragma unroll
        for (int c = 0; c < 8; ++c)
          gv[c] = (base == kTrace && a.nesterov) ? fmaf(h0, m2[c], gv[c]) : m2[c];
      }
#pragma unroll
      for (int c = 0; c < 8; ++c) es[lk + c][lrow] = gv[c];
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kK; ++k) {
      const float4 w = lds4(&rs[k][4 * tx]);
      outer4(acc, lds4(&ls[k][4 * ty]), w);
      if (kMoments) outer4(acc_e, lds4(&es[k][4 * ty]), w);
    }
    __syncthreads();
  }

  const int outs = kMoments ? 2 : 1;
  if (a.slices == 1) {
    const size_t go = static_cast<size_t>(b) * Pp * Pp;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const size_t at = go + static_cast<size_t>(i0 + 4 * ty + r) * Pp + j0 + 4 * tx;
      *reinterpret_cast<float4*>(a.out0 + at) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      if (kMoments)
        *reinterpret_cast<float4*>(a.out1 + at) =
            make_float4(acc_e[r][0], acc_e[r][1], acc_e[r][2], acc_e[r][3]);
    }
    if (!kMoments && ti != tj) {  // the mirror tile
#pragma unroll
      for (int c = 0; c < 4; ++c)
        *reinterpret_cast<float4*>(
            a.out0 + go + static_cast<size_t>(j0 + 4 * tx + c) * Pp + i0 + 4 * ty) =
            make_float4(acc[0][c], acc[1][c], acc[2][c], acc[3][c]);
    }
  } else {
    float* dst = a.part + (static_cast<size_t>(b * tiles + t) * a.slices + s) * outs * kTile;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int at = (4 * ty + r) * kT + 4 * tx;
      *reinterpret_cast<float4*>(dst + at) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      if (kMoments)
        *reinterpret_cast<float4*>(dst + kTile + at) =
            make_float4(acc_e[r][0], acc_e[r][1], acc_e[r][2], acc_e[r][3]);
    }
  }
  if (kMoments && base == kVAdam && owner) {
    const float tot = block_sum(sq, red);
    if (threadIdx.x == 0) a.sq[b * nt * a.slices + ti * a.slices + s] = tot;
  }
}

struct ReduceArgs {
  const float* part;
  const unsigned char* mask;
  float* out0;
  float* out1;
  int p, slices, moments;
};

// One output tile: its slices' partials summed in slice order, stored (and
// mirrored, for a self gram).
__global__ void __launch_bounds__(kThreads) gram_reduce_kernel(ReduceArgs a) {
  const bool full = a.moments != 0;
  const int nt = n_tiles(a.p), tiles = gram_tiles(a.p, full), Pp = nt * kT;
  const int t = blockIdx.x % tiles, b = blockIdx.x / tiles;
  if (a.mask != nullptr && a.mask[b] == 0) return;
  int ti, tj;
  tile_of(t, nt, full, ti, tj);
  const int i0 = ti * kT, j0 = tj * kT;
  const int outs = full ? 2 : 1;
  const size_t go = static_cast<size_t>(b) * Pp * Pp;
  for (int o = 0; o < outs; ++o) {
    float* out = (o ? a.out1 : a.out0) + go;
    const float* src = a.part + (static_cast<size_t>(b * tiles + t) * a.slices * outs + o) * kTile;
    for (int e = threadIdx.x; e < kTile / 4; e += kThreads) {
      const int r = e / (kT / 4), c = 4 * (e % (kT / 4));
      float4 v = *reinterpret_cast<const float4*>(src + r * kT + c);
      for (int sl = 1; sl < a.slices; ++sl) {
        const float4 w =
            *reinterpret_cast<const float4*>(src + static_cast<size_t>(sl) * outs * kTile + r * kT + c);
        v.x += w.x;
        v.y += w.y;
        v.z += w.z;
        v.w += w.w;
      }
      *reinterpret_cast<float4*>(out + static_cast<size_t>(i0 + r) * Pp + j0 + c) = v;
      if (!full && ti != tj) {
        out[static_cast<size_t>(j0 + c) * Pp + i0 + r] = v.x;
        out[static_cast<size_t>(j0 + c + 1) * Pp + i0 + r] = v.y;
        out[static_cast<size_t>(j0 + c + 2) * Pp + i0 + r] = v.z;
        out[static_cast<size_t>(j0 + c + 3) * Pp + i0 + r] = v.w;
      }
    }
  }
}

// ---------------------------------------------------------------- apply

struct ApplyArgs {
  const float* pa;            // (B, Pp, Pp), pa[k, i] = P[i, k]: A, C or Y Y^T
  const float* pb;            // kLeap, kLandStep, kField: BT (B X's B)
  const float* ya;            // the Y of pa's product: Geu's source, M or Y
  const float* yg;            // nesterov: the gradient, Geu = h0 ya + yg
  const float* x;             // kLeap, kLandStep, kField: X, the Y of B X
                              // and A X, and the base
  const float* scal;          // [eta, lam, post_scale, h0, ...] (kNs: null)
  const float* scol;          // vadam's per-matrix s, else null (post_scale)
  const unsigned char* mask;  // skip the matrices it clears (null: none)
  float* out;                 // (B, p, n), aliasing no Y operand
  int p, n, vec, first;
};

template <int kOp>
__global__ void __launch_bounds__(kThreads) apply_kernel(ApplyArgs a) {
  constexpr bool kB = kOp == kLeap || kOp == kLandStep || kOp == kField;  // B X
  constexpr bool kAx = kOp == kLandStep || kOp == kField;                 // A X
  extern __shared__ float4 large_apply_sm[];
  float(*pas)[kT] = reinterpret_cast<float(*)[kT]>(large_apply_sm);  // [k][i] of P
  float(*pbs)[kT] = pas + kK;
  float(*yas)[kT] = pbs + kK;  // [k][c] of Y
  float(*xs)[kT] = yas + kK;
  float* red = reinterpret_cast<float*>(xs + kK);
  const int nt = n_tiles(a.p), Pp = nt * kT, nc = (a.n + kT - 1) / kT;
  int blk = blockIdx.x;
  const int tc = blk % nc;
  blk /= nc;
  const int ti = blk % nt, b = blk / nt;
  if (a.mask != nullptr && a.mask[b] == 0) return;
  const int i0 = ti * kT, c0 = tc * kT;
  const size_t off = static_cast<size_t>(b) * a.p * a.n;
  const size_t go = static_cast<size_t>(b) * Pp * Pp;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  // The loader: row lk of the chunk, columns l8 .. l8+7 of the tile.
  const int lk = threadIdx.x / 8, l8 = 8 * (threadIdx.x % 8);
  const bool vec = a.vec != 0;
  const float h0 = a.yg != nullptr ? a.scal[3] : 0.f;
  float acc1[4][4] = {}, acc2[4][4] = {}, acc3[4][4] = {};
  for (int k0 = 0; k0 < a.p; k0 += kK) {
    const size_t prow = go + static_cast<size_t>(k0 + lk) * Pp + i0 + l8;
    float v[8];
    load4(v, *reinterpret_cast<const float4*>(a.pa + prow));
    load4(v + 4, *reinterpret_cast<const float4*>(a.pa + prow + 4));
    sstore8(&pas[lk][l8], v);
    if (kB) {
      load4(v, *reinterpret_cast<const float4*>(a.pb + prow));
      load4(v + 4, *reinterpret_cast<const float4*>(a.pb + prow + 4));
      sstore8(&pbs[lk][l8], v);
    }
    gload8(v, a.ya + off, k0 + lk, a.p, a.n, c0 + l8, a.n, vec);
    if (a.yg != nullptr) {
      float w[8];
      gload8(w, a.yg + off, k0 + lk, a.p, a.n, c0 + l8, a.n, vec);
#pragma unroll
      for (int c = 0; c < 8; ++c) v[c] = fmaf(h0, v[c], w[c]);
    }
    sstore8(&yas[lk][l8], v);
    if (kB) {
      gload8(v, a.x + off, k0 + lk, a.p, a.n, c0 + l8, a.n, vec);
      sstore8(&xs[lk][l8], v);
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kK; ++k) {
      const float4 u = lds4(&pas[k][4 * ty]);
      outer4(acc1, u, lds4(&yas[k][4 * tx]));
      if (kB) {
        const float4 xv = lds4(&xs[k][4 * tx]);
        outer4(acc2, lds4(&pbs[k][4 * ty]), xv);
        if (kAx) outer4(acc3, u, xv);
      }
    }
    __syncthreads();
  }

  const float eta = kOp == kNs ? 0.f : a.scal[0];
  const float lam = kOp == kNs ? 0.f : a.scal[1];
  const float s = kOp == kNs ? 0.f : a.scol != nullptr ? a.scol[b] : a.scal[2];
  float f = 1.f, f3 = 1.f;
  if (kOp == kNs && a.first) {  // the Frobenius prescale: f^2 = tr X X^T
    float tr = 0.f;
    for (int i = threadIdx.x; i < a.p; i += kThreads)
      tr += a.pa[go + static_cast<size_t>(i) * Pp + i];
    f = fmaxf(sqrtf(block_sum(tr, red)), 1e-30f);
    f3 = f * f * f;
  }
  const float* base = (kOp == kLand || kOp == kNs) ? a.ya : a.x;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + 4 * ty + r;
    if (i >= a.p) break;
    const size_t row = off + static_cast<size_t>(i) * a.n;
    float xv[4], o[4];
    gload4(xv, base + row, c0 + 4 * tx, a.n, vec);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float rr = 0.5f * (acc1[r][c] - acc2[r][c]);  // R (kLeap, kLandStep, kField)
      if (kOp == kLeap) {
        o[c] = xv[c] - eta * s * rr;
      } else if (kOp == kLandStep) {
        o[c] = xv[c] - eta * (s * rr + lam * (acc3[r][c] - xv[c]));
      } else if (kOp == kField) {
        o[c] = rr + lam * (acc3[r][c] - xv[c]);
      } else if (kOp == kLand) {
        o[c] = (1.f + lam) * xv[c] - lam * acc1[r][c];
      } else if (a.first) {
        o[c] = 1.5f * (xv[c] / f) - 0.5f * (acc1[r][c] / f3);
      } else {
        o[c] = 1.5f * xv[c] - 0.5f * acc1[r][c];
      }
    }
    gstore4(a.out + row, c0 + 4 * tx, a.n, vec, o);
  }
}

int check_shape(int p, int n) { return p < 1 || n < 1; }

// ======================================================= the tensor cores
//
// The same functions on the tensor cores, 3xTF32 wgmma fed by TMA, for n %
// 4 == 0. Their (p, p) operands are stored (B, Pq, Pq), Pq = p rounded up
// to 128, zero past p, and written by the gram already split: hi (the
// value itself: the tensor cores read its top 19 bits) and lo = tf32(v -
// trunc(v)), so that the many apply blocks that read an operand split none
// of it. Every kernel is persistent (a block a SM walks the work items; a
// masked-off matrix costs a mask read) with a producer warpgroup, one lane
// of which keeps TMA loads in flight on a ring of full / empty mbarriers,
// and two consumer warpgroups (setmaxnreg 24 / 240: 24 + 2 x 240 = 3 x
// 168); a consumer warp waits for every slot it releases.
//
//   gram   O[b] = X[b] R[b]^T over 32-column chunks of n: a block is 128 x
//          128 outputs, rows 64 h .. for consumer warpgroup h (X's unit h,
//          the wgmma M side, hi and lo as register fragments) by all 128
//          columns (R's two units, the N side: X itself for a self gram,
//          G for a cross gram), each warpgroup writing its own lo tile of
//          R, then lo(X) hi(R) + hi(X) lo(R) + hi(X) hi(R) from zero, the
//          chunk's partial added to fp32 sums in registers. A self gram
//          (E_A = X X^T - I, POGO's C, Landing's W, Newton-Schulz's Y Y^T,
//          E^2 of POGO's distance) computes the blocks on and above the
//          diagonal and mirrors them; with eye it stores E = G - I, and it
//          can sum its distance's squares, ||E + I_p - I_pv||_F^2, in the
//          epilogue. A cross gram is phase 1's B = X Geu^T (B itself, not
//          B^T: the apply reads its rows K-major). n-slices and their
//          fixed-order sum as above (gram_reduce_tc_kernel). Phase 1's
//          base stage (mu', nesterov's Geu, vadam's sums of g^2) is its own
//          elementwise launch (base_stage_kernel), before the grams.
//   apply  out = base + sum_j P_j V_j over K = p in 32-row chunks: a block
//          is 128 output rows (the (p, p) operand's rows, the K-major N
//          side) by 128 columns, 64 a warpgroup, the wgmma M side as
//          register fragments read from the chunk's TMA tiles of the Y
//          operands (V_j = a_j Geu + b_j X, the per-matrix scalars folded
//          in before the split; P_1's products run while P_2's fragments
//          are built). Every output is its base plus a small correction,
//          so that only the correction passes through the tensor cores:
//            leap       M  = X - c/2 Geu + E_A (-c/2 Geu) + B (c/2 X)
//            land_step  X' = X - c/2 Geu + E_A (-c/2 Geu - eta lam X) + B (c/2 X)
//            field      L  = G/2 + E_A (G/2 + lam X) + B (-X/2)
//            land       X' = M + E_C (-lam M)
//            ns         Y' = Y + E (-Y/2); the first iteration
//                       (1.5/f) X + G (-0.5/f^3 X), f^2 = tr G = ||X||_F^2
//            identity   POGO's distance: the squares of (1 - 2 lam) E +
//                       (lam^2 - 2 lam) E^2 + E (lam^2 E^2) (X' X'^T - I
//                       by the gram identity in E = C - I), summed
//          with c = eta s (s the Geu scale, vadam's per-matrix scol).
//
// 3xTF32 (fused_step_tc.cu's conventions): hi/lo splits by integer
// rounding, small terms first, lo.lo dropped, a tile that holds x itself
// is its own hi, and each 32-wide chunk's products start from zero, so
// the tensor cores' truncating accumulation acts on one chunk's partial.
// Bound at O-ViT's 18 x (1024, 1024): the 3xTF32 products of a fused POGO
// step, 30 p^2 n a matrix, 1.1714 ms at 495 TFLOP/s; the grams and applies
// move the (p, p) operands through L2 (an apply block reads a 128-row
// strip of each, hi and lo, and 128 columns of each Y).

constexpr int kQ = 32;             // a chunk: 32 columns of n (gram) or rows of Y (apply)
constexpr int kQHalf = 8192;       // a box of 64 rows x 32 fp32 columns, 128-byte swizzled
constexpr int kQSlot = 16384;      // a ring slot: 128 rows x 32, or 32 x 128 (four 32 x 32 boxes)
constexpr int kQBox32 = 4096;      // a box of 32 rows x 32 columns
constexpr int kQConsumers = 256;   // two warpgroups
constexpr int kQThreads = kQConsumers + 128;  // and the producer's
constexpr int kQProducerRegs = 24, kQConsumerRegs = 240;
constexpr int kGUnits = 20;        // the gram's ring of 64-row units: 5 chunks of 4 (a multiple of 4)
constexpr int kGLoOff = kGUnits * kQHalf;      // R's lo pieces, 16 KB a consumer warpgroup
constexpr int kGRedOff = kGLoOff + 4 * kQHalf;
constexpr int kGBarOff = kGRedOff + 64;
constexpr int kGSmemBytes = kGBarOff + 16 * kGUnits + 1024;  // + room to align
constexpr int kASlots = 13;        // the apply's ring: 2 chunks of the leap, 4 of the land
constexpr int kARedOff = kASlots * kQSlot;
constexpr int kABarOff = kARedOff + 64;
constexpr int kASmemBytes = kABarOff + 16 * kASlots + 1024;
constexpr int kQPart = 128 * 128;  // a gram block's partial
constexpr int kDsqSlots = 8;       // a gram block's parts of a distance (and of its sum launch)

__host__ __device__ inline int tc_padded(int p) { return (p + 127) / 128 * 128; }

// Blocks of a gram of one matrix, 128 x 128 each (gram_block): all of a
// cross gram's, or a self gram's on and above the diagonal (U >= T).
__host__ __device__ inline int tc_gram_blocks(int p, bool cross) {
  const int nb = tc_padded(p) / 128;
  return cross ? nb * nb : nb * (nb + 1) / 2;
}

__device__ inline void tc_block_of(int t, int nb, bool cross, int& T, int& U) {
  if (cross) {
    T = t / nb;
    U = t % nb;
    return;
  }
  T = 0;
  while (t >= nb - T) {
    t -= nb - T;
    ++T;
  }
  U = T + t;
}

// Byte offset of (row, col < 32) in a 128-byte swizzled box, and of (k,
// c < 128) in a slot of four 32 x 32 boxes.
__device__ inline int qoff(int row, int col) {
  return row * 128 + ((((col >> 2) ^ (row & 7)) << 4) | ((col & 3) << 2));
}
__device__ inline int yoff(int k, int c) { return (c >> 5) * kQBox32 + qoff(k, c & 31); }
__device__ inline float qat(const unsigned char* tile, int off) {
  return *reinterpret_cast<const float*>(tile + off);
}

// Descriptor of k8 step kk (< 4) of a K-major tile of 32 columns (any rows).
__device__ inline uint64_t qdesc(const unsigned char* tile, int kk) {
  return hopper::sw128_desc(tile + kk * 32, 16, 1024);
}

// The ring as the producer and the consumers see it: slot tt's buffer
// once free (producer) or full (consumers), and its release by every
// consumer warp.
__device__ inline unsigned char* slot_acquire(unsigned char* ring, uint64_t* empty, int tt,
                                              int slots, int bytes = kQSlot) {
  const int s = tt % slots;
  if (tt >= slots) hopper::mbar_wait(empty + s, (tt / slots - 1) & 1);
  return ring + s * bytes;
}

__device__ inline unsigned char* slot_full(unsigned char* ring, uint64_t* full, int tt, int slots,
                                           int bytes = kQSlot) {
  hopper::mbar_wait(full + tt % slots, (tt / slots) & 1);
  return ring + (tt % slots) * bytes;
}

__device__ inline void slots_release(uint64_t* empty, int tt, int count, int slots) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0)
    for (int o = 0; o < count; ++o) hopper::mbar_arrive(empty + (tt + o) % slots);
}

__device__ inline void ring_init(uint64_t* full, int slots) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < slots; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(full + slots + s, kQConsumers / 32);  // one arrival a consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
}

// Sum over consumer warpgroup h (all its threads call it), fixed order.
__device__ float qwg_sum(float v, float* red, int h) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  hopper::named_sync(1 + h, 128);  // red may still be read
  if ((threadIdx.x & 31) == 0) red[4 * h + ((threadIdx.x & 127) >> 5)] = v;
  hopper::named_sync(1 + h, 128);
  return (red[4 * h] + red[4 * h + 1]) + (red[4 * h + 2] + red[4 * h + 3]);
}

// ------------------------------------------------------------ gram (tc)

// Work item blk of a gram launch: matrix b, block t = (T, U), n-slice s and
// its columns [kb, ke). A block is 128 x 128 outputs, rows 128 T + 64 h ..
// for consumer warpgroup h (the wgmma M side: L's unit h, X's rows) by all
// 128 columns (the N side: R's two units, rows 128 U .. of X, or of G in a
// cross gram); a self gram computes the blocks with U >= T and mirrors
// those with U > T.
struct GramBlock {
  int b, t, T, U, s, kb, ke;
};

__device__ inline GramBlock gram_block(int blk, int slices, int blocks, int nb, bool cross,
                                       int slice_len, int n) {
  GramBlock w;
  w.s = blk % slices;
  blk /= slices;
  w.b = blk / blocks;
  w.t = blk % blocks;
  tc_block_of(w.t, nb, cross, w.T, w.U);
  w.kb = w.s * slice_len;
  w.ke = min(n, w.kb + slice_len);
  return w;
}

struct GramTcArgs {
  CUtensorMap mx, mg;         // X and a cross gram's G: boxes of 64 rows x 32 columns of (B, p, n)
  const unsigned char* mask;  // skip the matrices it clears (null: none)
  const int* pv;              // dsq: valid-row counts (null: p)
  float* out;                 // (B, Pq, Pq): X X^T (minus I with eye) or X G^T, zero past p
  float* lo;                  // its lo pieces, or null
  float* part;                // slices > 1: (B, blocks, slices, 128 x 128)
  float* dsq;                 // a self gram's ||out + I_p - I_pv||_F^2 in (B, blocks,
                              // kDsqSlots) parts, or null
  int B, p, n, slices, slice_len, eye;
};

// The value stored at (gi, gj) from its sum: zero past p (a unit that
// starts past p is not loaded), minus the identity with eye.
__device__ inline float gram_value(float sum, int gi, int gj, int p, int eye) {
  if (gi >= p || gj >= p) return 0.f;
  return eye && gi == gj ? sum - 1.f : sum;
}

template <bool kCross>
__global__ void __launch_bounds__(kQThreads, 1) gram_tc_kernel(const __grid_constant__ GramTcArgs a) {
  extern __shared__ unsigned char large_tc_smem[];
  unsigned char* ring = hopper::smem_align1024(large_tc_smem);
  float* red = reinterpret_cast<float*>(ring + kGRedOff);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kGBarOff);
  uint64_t* empty = full + kGUnits;
  const int Pp = tc_padded(a.p), nb = Pp / 128, blocks = tc_gram_blocks(a.p, kCross);
  const int total = a.B * blocks * a.slices;
  constexpr int ops = 4;  // units a chunk: L_0, L_1, R_0, R_1
  const int tid = threadIdx.x;
  ring_init(full, kGUnits);

  if (tid >= kQConsumers) {  // the producer's warpgroup: one lane loads
    hopper::reg_dealloc<kQProducerRegs>();
    if (tid != kQConsumers) return;
    int tt = 0;
    for (int blk = blockIdx.x; blk < total; blk += gridDim.x) {
      const GramBlock w = gram_block(blk, a.slices, blocks, nb, kCross, a.slice_len, a.n);
      if (a.mask != nullptr && a.mask[w.b] == 0) continue;
      for (int k0 = w.kb; k0 < w.ke; k0 += kQ) {
        for (int u = 0; u < ops; ++u, ++tt) {
          unsigned char* st = slot_acquire(ring, empty, tt, kGUnits, kQHalf);
          uint64_t* bar = full + tt % kGUnits;
          const int row = 128 * (u < 2 ? w.T : w.U) + 64 * (u & 1);
          hopper::mbar_expect_tx(bar, row < a.p ? kQHalf : 0);
          if (row < a.p)
            hopper::tma_load_4d(st, kCross && u >= 2 ? &a.mg : &a.mx, bar, k0, row, w.b, 0);
        }
      }
    }
    return;
  }

  // ------------------------------------------- the two consumer warpgroups
  hopper::reg_alloc<kQConsumerRegs>();
  const int h = __shfl_sync(0xffffffffu, tid >> 7, 0), lt = tid & 127;
  unsigned char* lo_r = ring + kGLoOff + h * 2 * kQHalf;  // R's lo pieces, 128 rows
  const int m0 = 16 * (lt >> 5) + ((lt & 31) >> 2), kq = lt & 3;  // L's fragment
  int tt = 0;
  for (int blk = blockIdx.x; blk < total; blk += gridDim.x) {
    const GramBlock w = gram_block(blk, a.slices, blocks, nb, kCross, a.slice_len, a.n);
    const int b = w.b;
    if (a.mask != nullptr && a.mask[b] == 0) continue;
    const int i0 = 128 * w.T + 64 * h, j0 = 128 * w.U;
    const bool live = i0 < a.p;
    float sum[64], part[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) sum[i] = 0.f;
    for (int k0 = w.kb; k0 < w.ke; k0 += kQ, tt += ops) {
      // every unit this warpgroup releases, waited for (a unit released
      // unwaited could count toward the phase of the fill before it); a
      // chunk's four units are contiguous (kGUnits is a multiple of 4)
      for (int u = 0; u < ops; ++u) slot_full(ring, full, tt + u, kGUnits, kQHalf);
      const unsigned char* tl = ring + (tt + h) % kGUnits * kQHalf;
      const unsigned char* tr = ring + (tt + 2) % kGUnits * kQHalf;
      if (live) {
        // R's lo pieces, elementwise in the swizzled layout, 16 bytes a
        // thread at a time (each warpgroup keeps its own)
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int o16 = 16 * (lt + 128 * u);
          float v[4];
          load4(v, *reinterpret_cast<const float4*>(tr + o16));
#pragma unroll
          for (int e = 0; e < 4; ++e) v[e] = trunc_lo(v[e]);
          *reinterpret_cast<float4*>(lo_r + o16) = make_float4(v[0], v[1], v[2], v[3]);
        }
        // L's hi (its own) and lo, the register A operands of each k8 step:
        // the products then read only R's tiles from shared memory
        uint32_t fh[4][4], fl[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float v = qat(tl, qoff(m0 + 8 * (r & 1), 8 * kk + kq + 4 * (r >> 1)));
            fh[kk][r] = __float_as_uint(v);
            fl[kk][r] = __float_as_uint(trunc_lo(v));
          }
        hopper::fence_proxy_async_smem();  // the lo tile, before wgmma reads it
        hopper::named_sync(1 + h, 128);
        hopper::fence_regs(part);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          hopper::fence_regs(fh[kk]);
          hopper::fence_regs(fl[kk]);
        }
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          hopper::wgmma_tf32_rs(part, fl[kk][0], fl[kk][1], fl[kk][2], fl[kk][3], qdesc(tr, kk),
                                kk > 0);
          hopper::wgmma_tf32_rs(part, fh[kk][0], fh[kk][1], fh[kk][2], fh[kk][3],
                                qdesc(lo_r, kk), 1);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hopper::wgmma_tf32_rs(part, fh[kk][0], fh[kk][1], fh[kk][2], fh[kk][3], qdesc(tr, kk),
                                1);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(part);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          hopper::fence_regs(fh[kk]);
          hopper::fence_regs(fl[kk]);
        }
#pragma unroll
        for (int i = 0; i < 64; ++i) sum[i] += part[i];
        hopper::named_sync(1 + h, 128);  // every warp's products are done with the lo tile
      }
      slots_release(empty, tt, ops, kGUnits);
    }

    if (a.slices > 1) {
      float* dst = a.part + (static_cast<size_t>(b * blocks + w.t) * a.slices + w.s) * kQPart +
                   h * (kQPart / 2);
#pragma unroll
      for (int i = 0; i < 64; ++i) dst[acc_row(lt, i) * 128 + acc_col(lt, i)] = live ? sum[i] : 0.f;
      continue;
    }
    // the tile's rows r0, r0 + 8 and columns c0 + 8 q (+ 1) of each thread,
    // from two base offsets (an offset an element makes ptxas spill)
    const int r0 = 16 * (lt >> 5) + ((lt & 31) >> 2), c0 = 2 * (lt & 3);
    const size_t go = static_cast<size_t>(b) * Pp * Pp;
    const size_t ob = hopper::opaque_size(go + static_cast<size_t>(i0 + r0) * Pp + j0 + c0);
    const size_t mb = hopper::opaque_size(go + static_cast<size_t>(j0 + c0) * Pp + i0 + r0);
    const bool mirror = !kCross && w.U > w.T;
    const int pvb = a.pv != nullptr ? a.pv[b] : a.p;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int rr = 8 * ((i >> 1) & 1), cc = 8 * (i >> 2) + (i & 1);
      const int gi = i0 + r0 + rr, gj = j0 + c0 + cc;
      const float v = gram_value(live ? sum[i] : 0.f, gi, gj, a.p, a.eye);
      const size_t at = ob + static_cast<size_t>(rr) * Pp + cc;
      a.out[at] = v;
      if (a.lo != nullptr) a.lo[at] = trunc_lo(v);
      const float d = v + (gi == gj && gi >= pvb && gi < a.p ? 1.f : 0.f);
      sq = fmaf(mirror ? 2.f * d : d, d, sq);
      if (mirror) {
        const size_t mt = mb + static_cast<size_t>(cc) * Pp + rr;
        a.out[mt] = v;
        if (a.lo != nullptr) a.lo[mt] = trunc_lo(v);
      }
    }
    if (a.dsq != nullptr) {  // slots 4 h .. 4 h + 3 of the block's kDsqSlots
      const float tot = qwg_sum(sq, red, h);
      if (lt < 4)
        a.dsq[(static_cast<size_t>(b) * blocks + w.t) * kDsqSlots + 4 * h + lt] = lt ? 0.f : tot;
    }
  }
}

struct ReduceTcArgs {
  const float* part;
  const unsigned char* mask;
  const int* pv;
  float* out;
  float* lo;
  float* dsq;
  int p, slices, cross, eye;
};

// One eighth (kDsqSlots) of a gram block: its slices' partials summed in
// slice order, then stored as gram_tc_kernel stores them (the identity,
// the lo pieces, the mirror, the distance's part in the block's slot r).
__global__ void __launch_bounds__(kThreads) gram_reduce_tc_kernel(ReduceTcArgs a) {
  extern __shared__ float4 large_gram_sm[];
  float* red = reinterpret_cast<float*>(large_gram_sm);
  const bool cross = a.cross != 0;
  const int Pp = tc_padded(a.p), nb = Pp / 128, blocks = tc_gram_blocks(a.p, cross);
  const int r = blockIdx.x % kDsqSlots, t = blockIdx.x / kDsqSlots % blocks;
  const int b = blockIdx.x / kDsqSlots / blocks;
  if (a.mask != nullptr && a.mask[b] == 0) return;
  int T, U;
  tc_block_of(t, nb, cross, T, U);
  const bool mirror = !cross && U > T;
  const int pvb = a.pv != nullptr ? a.pv[b] : a.p;
  const size_t go = static_cast<size_t>(b) * Pp * Pp;
  const float* src = a.part + static_cast<size_t>(b * blocks + t) * a.slices * kQPart;
  constexpr int kPart = kQPart / kDsqSlots;
  float sq = 0.f;
  for (int e = r * kPart + threadIdx.x; e < (r + 1) * kPart; e += kThreads) {
    float v = src[e];
    for (int sl = 1; sl < a.slices; ++sl) v += src[static_cast<size_t>(sl) * kQPart + e];
    const int gi = 128 * T + (e >> 7), gj = 128 * U + (e & 127);
    v = gram_value(v, gi, gj, a.p, a.eye);
    const size_t at = go + static_cast<size_t>(gi) * Pp + gj;
    a.out[at] = v;
    if (a.lo != nullptr) a.lo[at] = trunc_lo(v);
    const float d = v + (gi == gj && gi >= pvb && gi < a.p ? 1.f : 0.f);
    sq = fmaf(mirror ? 2.f * d : d, d, sq);
    if (mirror) {
      const size_t mt = go + static_cast<size_t>(gj) * Pp + gi;
      a.out[mt] = v;
      if (a.lo != nullptr) a.lo[mt] = trunc_lo(v);
    }
  }
  if (a.dsq != nullptr) {
    const float tot = block_sum(sq, red);
    if (threadIdx.x == 0) a.dsq[(static_cast<size_t>(b) * blocks + t) * kDsqSlots + r] = tot;
  }
}

// The base stage of phase 1 on the tensor-core route, elementwise over
// 16-byte groups of a (B, p, n) stack (n % 4 == 0): mu' = h0 mu + g
// (trace) or h0 mu + (1 - h0) g (vadam), written to mu_out; with nesterov
// Geu = h0 mu' + g to geu; vadam's per-block sums of g^2 to sq (B,
// blocks), summed in a fixed order. The grams then read Geu (mu', g or
// geu) as they read X.
struct BaseArgs {
  const float* g;
  const float* mu;
  const float* scal;
  float* mu_out;
  float* geu;  // nesterov, else null
  float* sq;   // vadam, else null
  int p, n, base_kind, blocks;
};

__global__ void __launch_bounds__(kThreads) base_stage_kernel(BaseArgs a) {
  extern __shared__ float4 large_gram_sm[];
  float* red = reinterpret_cast<float*>(large_gram_sm);
  const int b = blockIdx.x / a.blocks, k = blockIdx.x % a.blocks;
  const size_t off = static_cast<size_t>(b) * a.p * a.n;
  const size_t quads = static_cast<size_t>(a.p) * a.n / 4;
  const float h0 = a.scal[3];
  const float4* g4 = reinterpret_cast<const float4*>(a.g + off);
  const float4* m4 = reinterpret_cast<const float4*>(a.mu + off);
  float sq = 0.f;
  for (size_t u = static_cast<size_t>(k) * kThreads + threadIdx.x; u < quads;
       u += static_cast<size_t>(a.blocks) * kThreads) {
    float gv[4], mv[4], m2[4];
    load4(gv, g4[u]);
    load4(mv, m4[u]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (a.base_kind == kTrace) {
        m2[e] = fmaf(h0, mv[e], gv[e]);
      } else {
        m2[e] = fmaf(h0, mv[e], (1.f - h0) * gv[e]);
        sq = fmaf(gv[e], gv[e], sq);
      }
    }
    reinterpret_cast<float4*>(a.mu_out + off)[u] = make_float4(m2[0], m2[1], m2[2], m2[3]);
    if (a.geu != nullptr)
      reinterpret_cast<float4*>(a.geu + off)[u] =
          make_float4(fmaf(h0, m2[0], gv[0]), fmaf(h0, m2[1], gv[1]), fmaf(h0, m2[2], gv[2]),
                      fmaf(h0, m2[3], gv[3]));
  }
  if (a.sq != nullptr) {
    const float tot = block_sum(sq, red);
    if (threadIdx.x == 0) a.sq[blockIdx.x] = tot;
  }
}

// ----------------------------------------------------------- apply (tc)

struct ApplyTcArgs {
  CUtensorMap mp[4];          // P1 hi, P1 lo, P2 hi, P2 lo: boxes of 128 rows x 32 of (B, Pq, Pq)
  CUtensorMap my[2];          // ya, x: boxes of 32 rows x 32 columns of (B, p, n)
  const float* ya;            // Geu (mu', g or base_stage's), M or Y: the Y of P1 and the base
  const float* x;             // kTwo: X, the Y of B and of lam's term, and the base
  const float* pa;            // Newton-Schulz's first iteration: G, for its trace
  const float* scal;          // [eta, lam, post_scale, h0, ...] (ns: null)
  const float* scol;          // vadam's per-matrix s, else null (post_scale)
  const unsigned char* mask;  // skip the matrices it clears (null: none)
  float* out;                 // (B, p, n), aliasing no Y operand; kIdentity: (B, items, 2)
                              // sums of squares, a consumer warpgroup's of a block each
  const int* pv;              // kIdentity: valid-row counts (null: rows, all)
  int B, p, n, op, first, rows;  // rows: kIdentity's matrices' own p
};

// A chunk's register A fragments (V's hi and lo) of sum_k P[i, k] V[k, c]
// (M side: c, the warpgroup's 64 columns; K: the chunk's 32 rows).
template <typename Val>
__device__ inline void v_fragments(uint32_t (&fh)[4][4], uint32_t (&fl)[4][4], Val val) {
  const int lt = threadIdx.x & 127, m0 = 16 * (lt >> 5) + ((lt & 31) >> 2), kq = lt & 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float hi, lo;
      split(val(8 * kk + kq + 4 * (r >> 1), m0 + 8 * (r & 1)), hi, lo);
      fh[kk][r] = __float_as_uint(hi);
      fl[kk][r] = __float_as_uint(lo);
    }
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    hopper::fence_regs(fh[kk]);
    hopper::fence_regs(fl[kk]);
  }
}

// Issues d (+)= P V over the chunk (N side: the block's 128 rows i of P's
// hi and lo tiles), small terms first; the caller commits and waits.
__device__ inline void p_products(float (&d)[64], const uint32_t (&fh)[4][4],
                                  const uint32_t (&fl)[4][4], const unsigned char* ph,
                                  const unsigned char* pl, int accumulate) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    hopper::wgmma_tf32_rs(d, fh[kk][0], fh[kk][1], fh[kk][2], fh[kk][3], qdesc(pl, kk),
                          accumulate || kk > 0);
    hopper::wgmma_tf32_rs(d, fl[kk][0], fl[kk][1], fl[kk][2], fl[kk][3], qdesc(ph, kk), 1);
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    hopper::wgmma_tf32_rs(d, fh[kk][0], fh[kk][1], fh[kk][2], fh[kk][3], qdesc(ph, kk), 1);
}

// kTwo: two (p, p) operands (E_A and B: the leap, Landing's step, the
// field); else one (E_C: the land; G or E: Newton-Schulz).
template <bool kTwo>
__global__ void __launch_bounds__(kQThreads, 1) apply_tc_kernel(const __grid_constant__ ApplyTcArgs a) {
  extern __shared__ unsigned char large_tc_smem[];
  unsigned char* ring = hopper::smem_align1024(large_tc_smem);
  float* red = reinterpret_cast<float*>(ring + kARedOff);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kABarOff);
  uint64_t* empty = full + kASlots;
  const int Pp = tc_padded(a.p), ni = Pp / 128, nc = (a.n + 127) / 128;
  const int total = a.B * ni * nc;  // items: a matrix, a 128-row block, a 128-column block
  constexpr int np = kTwo ? 4 : 2;  // P slots a chunk, then ya [, x]
  constexpr int ops = np + 1 + kTwo;
  const int tid = threadIdx.x;
  ring_init(full, kASlots);

  if (tid >= kQConsumers) {  // the producer's warpgroup: one lane loads
    hopper::reg_dealloc<kQProducerRegs>();
    if (tid != kQConsumers) return;
    int tt = 0;
    for (int blk = blockIdx.x; blk < total; blk += gridDim.x) {
      const int tc = blk % nc, ti = (blk / nc) % ni, b = blk / (nc * ni);
      if (a.mask != nullptr && a.mask[b] == 0) continue;
      const int i0 = 128 * ti, c0 = 128 * tc;
      int boxes = 0;  // Y boxes of a chunk inside n
      for (int u = 0; u < 4; ++u) boxes += c0 + 32 * u < a.n;
      for (int k0 = 0; k0 < a.p; k0 += kQ) {
        for (int o = 0; o < ops; ++o, ++tt) {
          unsigned char* st = slot_acquire(ring, empty, tt, kASlots);
          uint64_t* bar = full + tt % kASlots;
          if (o < np) {
            hopper::mbar_expect_tx(bar, kQSlot);
            hopper::tma_load_4d(st, &a.mp[o], bar, k0, i0, b, 0);
            continue;
          }
          hopper::mbar_expect_tx(bar, boxes * kQBox32);
          for (int u = 0; u < boxes; ++u)
            hopper::tma_load_4d(st + u * kQBox32, &a.my[o - np], bar, c0 + 32 * u, k0, b, 0);
        }
      }
    }
    return;
  }

  // ------------------------------------------- the two consumer warpgroups
  hopper::reg_alloc<kQConsumerRegs>();
  const int h = __shfl_sync(0xffffffffu, tid >> 7, 0), lt = tid & 127;
  int tt = 0;
  for (int blk = blockIdx.x; blk < total; blk += gridDim.x) {
    const int tc = blk % nc, ti = (blk / nc) % ni, b = blk / (nc * ni);
    if (a.mask != nullptr && a.mask[b] == 0) continue;
    const int i0 = 128 * ti, c0 = 128 * tc;
    const bool live = c0 + 64 * h < a.n;
    // out = ea Geu + ex X + P1 (a1 Geu + b1 X) [+ P2 (b2 X)]
    float a1 = 1.f, b1 = 0.f, b2 = 0.f, ea = 1.f, ex = 0.f;
    if (a.op == kNs) {
      a1 = -0.5f;
      if (a.first && live) {  // the Frobenius prescale: f^2 = tr X X^T
        float tr = 0.f;
        for (int i = lt; i < a.p; i += 128)
          tr += a.pa[static_cast<size_t>(b) * Pp * Pp + static_cast<size_t>(i) * Pp + i];
        const float f = fmaxf(sqrtf(qwg_sum(tr, red, h)), 1e-30f);
        a1 = -0.5f / (f * f * f);
        ea = 1.5f / f;
      }
    } else {
      const float eta = a.scal[0], lam = a.scal[1];
      const float c = eta * (a.scol != nullptr ? a.scol[b] : a.scal[2]);
      if (a.op == kLand) {
        a1 = -lam;
      } else if (a.op == kIdentity) {  // R = (1 - 2 lam) E + (lam^2 - 2 lam) E^2 + E (lam^2 E^2)
        a1 = lam * lam, ea = lam * lam - 2.f * lam, ex = 1.f - 2.f * lam;
      } else if (a.op == kField) {
        a1 = 0.5f, b1 = lam, b2 = -0.5f, ea = 0.5f;
      } else {  // kLeap, kLandStep
        a1 = -0.5f * c, b2 = 0.5f * c, ea = -0.5f * c, ex = 1.f;
        if (a.op == kLandStep) b1 = -eta * lam;
      }
    }
    float sum[64], part[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) sum[i] = 0.f;
    for (int k0 = 0; k0 < a.p; k0 += kQ, tt += ops) {
      const unsigned char* p1h = slot_full(ring, full, tt, kASlots);
      const unsigned char* p1l = slot_full(ring, full, tt + 1, kASlots);
      const unsigned char* p2h = kTwo ? slot_full(ring, full, tt + 2, kASlots) : nullptr;
      const unsigned char* p2l = kTwo ? slot_full(ring, full, tt + 3, kASlots) : nullptr;
      const unsigned char* ty = slot_full(ring, full, tt + np, kASlots);
      const unsigned char* txx = kTwo ? slot_full(ring, full, tt + np + 1, kASlots) : nullptr;
      if (live) {
        // P1's products run while P2's fragments are built
        const int cw = 64 * h;
        uint32_t f1h[4][4], f1l[4][4], f2h[4][4], f2l[4][4];
        hopper::fence_regs(part);
        v_fragments(f1h, f1l, [&](int k, int m) {
          const int o = yoff(k, cw + m);
          float v = a1 * qat(ty, o);
          if (kTwo) v = fmaf(b1, qat(txx, o), v);
          return v;
        });
        p_products(part, f1h, f1l, p1h, p1l, 0);
        if (kTwo) {
          v_fragments(f2h, f2l, [&](int k, int m) { return b2 * qat(txx, yoff(k, cw + m)); });
          p_products(part, f2h, f2l, p2h, p2l, 1);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(part);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          hopper::fence_regs(f1h[kk]);
          hopper::fence_regs(f1l[kk]);
          if (kTwo) {
            hopper::fence_regs(f2h[kk]);
            hopper::fence_regs(f2l[kk]);
          }
        }
#pragma unroll
        for (int i = 0; i < 64; ++i) sum[i] += part[i];
      }
      slots_release(empty, tt, ops, kASlots);
    }
    const bool ident = !kTwo && a.op == kIdentity;
    if (!live && !ident) continue;
    const size_t off = static_cast<size_t>(b) * a.p * a.n;
    const int pvb = ident && a.pv != nullptr ? a.pv[b] : a.rows;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int c = c0 + 64 * h + acc_row(lt, i), gi = i0 + acc_col(lt, i);
      if (!live || gi >= a.p || c >= a.n) continue;
      const size_t at = off + static_cast<size_t>(gi) * a.n + c;
      float v = ea * a.ya[at];
      if (ex != 0.f) v = fmaf(ex, a.x[at], v);
      v += sum[i];
      if (!ident) {
        a.out[at] = v;
        continue;
      }
      if (gi == c && gi >= pvb && gi < a.rows) v += 1.f;  // I_p - I_pv
      sq = fmaf(v, v, sq);
    }
    if (ident) {
      const float tot = qwg_sum(sq, red, h);
      if (lt == 0) a.out[2 * static_cast<size_t>(blk) + h] = tot;
    }
  }
}

// Tensor maps of a (B, rows, cols) fp32 stack: boxes of box_rows x 32.
int tc_map(CUtensorMap* map, const float* base, int B, int rows, int cols, int box_rows) {
  const uint64_t e = sizeof(float), r = rows, c = cols;
  const uint64_t dims[4] = {c, r, static_cast<uint64_t>(B > 0 ? B : 1), 1};
  const uint64_t strides[3] = {c * e, r * c * e, dims[2] * r * c * e};
  const uint32_t box[4] = {32, static_cast<uint32_t>(box_rows), 1, 1};
  return hopper::make_tma_map_f32(map, base, dims, strides, box);
}

bool tc_aligned(int n, const void* const* ptrs, int count) {
  return n % 4 == 0 && vector_ok(n, ptrs, count);
}

// The SMs of the current device: a persistent launch's grid.
int sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return static_cast<int>(err);
}

// A gram (and, with slices, its sum) over args.B matrices: one persistent
// block a SM walks the (matrix, block, slice) items.
int gram_tc_launch(GramTcArgs& args, bool cross, int sms, cudaStream_t stream) {
  const int blocks = tc_gram_blocks(args.p, cross);
  const int total = args.B * blocks * args.slices;
  void* kargs[] = {&args};
  const void* kernel = cross ? reinterpret_cast<const void*>(gram_tc_kernel<true>)
                             : reinterpret_cast<const void*>(gram_tc_kernel<false>);
  int err = launch(kernel, kGSmemBytes, min(total, sms), stream, kargs, kQThreads);
  if (err != 0 || args.slices == 1) return err;
  ReduceTcArgs r{args.part, args.mask, args.pv, args.out, args.lo,
                 args.dsq,  args.p,    args.slices, cross, args.eye};
  void* rargs[] = {&r};
  return launch(reinterpret_cast<const void*>(gram_reduce_tc_kernel), sizeof(float) * kWarps,
                args.B * blocks * kDsqSlots, stream, rargs);
}

int apply_tc_launch(ApplyTcArgs& args, int sms, cudaStream_t stream) {
  const bool two = args.op == kLeap || args.op == kLandStep || args.op == kField;
  void* kargs[] = {&args};
  const void* kernel = two ? reinterpret_cast<const void*>(apply_tc_kernel<true>)
                           : reinterpret_cast<const void*>(apply_tc_kernel<false>);
  const int total = args.B * (tc_padded(args.p) / 128) * ((args.n + 127) / 128);
  return launch(kernel, kASmemBytes, min(total, sms), stream, kargs, kQThreads);
}

bool slices_ok(int n, int slices, int slice_len) {
  return slices >= 1 && slice_len >= kQ && slice_len % kQ == 0 &&
         static_cast<long long>(slices - 1) * slice_len < n &&
         static_cast<long long>(slices) * slice_len >= n;
}

}  // namespace

extern "C" {

// Row stride (and row count) of a stored gram: p rounded up to 64.
int large_padded(int p) { return padded(p); }

// Output tiles of a gram: phase 1's (moments 1) or a self gram's.
int large_gram_tiles(int p, int moments) { return gram_tiles(p, moments != 0); }

// Phase 1 (moments 1: A into out0, BT into out1, the base stage with mu'
// into mu_out and vadam's partial sums into sq) or a self gram of x (into
// out0), over `slices` n-slices of slice_len columns; with slices > 1 the
// partials go to part and a second launch sums them.
int large_gram(const float* x, const float* g, const float* mu, float* mu_out,
               const float* scal, float* sq, const unsigned char* mask, float* out0,
               float* out1, float* part, int B, int p, int n, int slices, int slice_len,
               int moments, int base_kind, int nesterov, void* stream) {
  if (check_shape(p, n) || slices < 1 || slice_len < kK || slice_len % kK != 0 ||
      static_cast<long long>(slices - 1) * slice_len >= n ||
      static_cast<long long>(slices) * slice_len < n || (slices > 1 && part == nullptr) ||
      (moments && (g == nullptr || scal == nullptr)) ||
      (moments && base_kind != kNone && (mu == nullptr || mu_out == nullptr)) ||
      (moments && base_kind == kVAdam && sq == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* rows[] = {x, g, mu, mu_out};
  const int vec = vector_ok(n, rows, 4);
  GramArgs args{x,    g,     mu,   mu_out, scal, sq,     mask,      out0,      out1,
                part, p,     n,    slices, slice_len, base_kind, nesterov, vec};
  void* kargs[] = {&args};
  const int tiles = gram_tiles(p, moments != 0);
  const int smem =
      static_cast<int>(sizeof(float)) * ((moments ? 3 : 2) * kK * kT + kWarps);
  const void* kernel = moments ? reinterpret_cast<const void*>(gram_kernel<true>)
                               : reinterpret_cast<const void*>(gram_kernel<false>);
  int err = launch(kernel, smem, B * tiles * slices, static_cast<cudaStream_t>(stream), kargs);
  if (err != 0 || slices == 1) return err;
  ReduceArgs r{part, mask, out0, out1, p, slices, moments};
  void* rargs[] = {&r};
  return launch(reinterpret_cast<const void*>(gram_reduce_kernel), 0, B * tiles,
                static_cast<cudaStream_t>(stream), rargs);
}

// out = op(...) (ApplyOp) of a (B, p, n) stack; first 1 marks Newton-
// Schulz's first iteration (ya = X, pa = X X^T).
int large_apply(int op, const float* pa, const float* pb, const float* ya, const float* yg,
                const float* x, const float* scal, const float* scol,
                const unsigned char* mask, float* out, int B, int p, int n, int first,
                void* stream) {
  const bool two = op == kLeap || op == kLandStep || op == kField;
  if (check_shape(p, n) || op < kLeap || op > kNs || pa == nullptr || ya == nullptr ||
      (op != kNs && scal == nullptr) || out == nullptr ||
      (two && (pb == nullptr || x == nullptr)) || (yg != nullptr && scal == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* kernels[] = {reinterpret_cast<const void*>(apply_kernel<kLeap>),
                           reinterpret_cast<const void*>(apply_kernel<kLand>),
                           reinterpret_cast<const void*>(apply_kernel<kLandStep>),
                           reinterpret_cast<const void*>(apply_kernel<kField>),
                           reinterpret_cast<const void*>(apply_kernel<kNs>)};
  const void* rows[] = {ya, yg, x, out};
  const int vec = vector_ok(n, rows, 4);
  ApplyArgs args{pa, pb, ya, yg, x, scal, scol, mask, out, p, n, vec, first};
  void* kargs[] = {&args};
  const int smem = static_cast<int>(sizeof(float)) * (4 * kK * kT + kWarps);
  const int blocks = B * n_tiles(p) * ((n + kT - 1) / kT);
  return launch(kernels[op], smem, blocks, static_cast<cudaStream_t>(stream), kargs);
}

// Pq: the row stride (and row count) of a stored tensor-core gram.
int large_tc_padded(int p) { return tc_padded(p); }

// Blocks of a tensor-core gram (each 128 x 128): a cross gram's (cross 1)
// or a self gram's.
int large_tc_gram_blocks(int p, int cross) { return tc_gram_blocks(p, cross != 0); }

// large_gram on the tensor cores, n % 4 == 0 and 16-byte aligned rows
// (TMA), else cudaErrorInvalidValue: the self gram X X^T (minus the
// identity with eye; with dsq also its distance's sums of squares,
// ||out + I_p - I_pv||_F^2 in (B, blocks, 8) parts, pv valid-row counts or
// null), or with g the cross gram X G^T (phase 1's B, G the Geu that
// large_base_stage made, or g itself). Into out / lo (lo may be null),
// (B, Pq, Pq), zero past p.
int large_tc_gram(const float* x, const float* g, const unsigned char* mask, const int* pv,
                  float* out, float* lo, float* part, float* dsq, int B, int p, int n,
                  int slices, int slice_len, int eye, void* stream) {
  const bool cross = g != nullptr;
  const void* rows[] = {x, cross ? g : x};
  if (check_shape(p, n) || !tc_aligned(n, rows, 2) || !slices_ok(n, slices, slice_len) ||
      out == nullptr || (slices > 1 && part == nullptr) || (cross && (dsq != nullptr || eye)))
    return static_cast<int>(cudaErrorInvalidValue);
  GramTcArgs args{};
  int err = tc_map(&args.mx, x, B, p, n, 64);
  if (err == 0 && cross) err = tc_map(&args.mg, g, B, p, n, 64);
  int sms = 0;
  if (err == 0) err = sm_count(&sms);
  if (err != 0) return err;
  args.mask = mask;
  args.pv = pv;
  args.out = out;
  args.lo = lo;
  args.part = part;
  args.dsq = dsq;
  args.B = B;
  args.p = p;
  args.n = n;
  args.slices = slices;
  args.slice_len = slice_len;
  args.eye = eye;
  return gram_tc_launch(args, cross, sms, static_cast<cudaStream_t>(stream));
}

// Blocks a matrix of large_base_stage: enough 256-thread blocks that the
// card is full at a few matrices, none with less than 4 float4 a thread.
int large_base_blocks(int p, int n) {
  const long long quads = static_cast<long long>(p) * n / 4;
  const long long want = (quads + 4 * kThreads - 1) / (4 * kThreads);
  return static_cast<int>(want < 1 ? 1 : want > 32 ? 32 : want);
}

// Phase 1's base stage for the tensor-core route (base_stage_kernel):
// mu' into mu_out (never mu), nesterov's Geu into geu (else null), vadam's
// sums of g^2 into sq, (B, large_base_blocks(p, n)) (else null).
int large_base_stage(const float* g, const float* mu, const float* scal, float* mu_out,
                     float* geu, float* sq, int B, int p, int n, int base_kind, void* stream) {
  const void* rows[] = {g, mu, mu_out, geu != nullptr ? geu : mu_out};
  if (check_shape(p, n) || !tc_aligned(n, rows, 4) || scal == nullptr ||
      (base_kind != kTrace && base_kind != kVAdam) || (base_kind == kVAdam && sq == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  BaseArgs args{g, mu, scal, mu_out, geu, sq, p, n, base_kind, large_base_blocks(p, n)};
  void* kargs[] = {&args};
  return launch(reinterpret_cast<const void*>(base_stage_kernel), sizeof(float) * kWarps,
                B * args.blocks, static_cast<cudaStream_t>(stream), kargs);
}

// large_apply on the tensor cores: pa / pa_lo (E_A, E_C or E as the gram
// stored them) and, for the leap, Landing's step and the field, pb / pb_lo
// (B); ya the Y of pa's product (Geu, M or Y) and x the Y of B and of
// lam's term; n % 4 == 0, as large_tc_gram. kIdentity: POGO's distance
// from E = C - I (pa; its matrices' own p is rows, pv their valid-row
// counts or null), the stack being E^2 (ya) and E (x), both (B, Pq, Pq):
// out receives, for each (matrix, block, consumer warpgroup), its sum of
// squares of X' X'^T - I_pv = (1 - 2 lam) E + (lam^2 - 2 lam) E^2 + lam^2
// E^3 (B x large_tc_apply_items(p, n) x 2).
int large_tc_apply(int op, const float* pa, const float* pa_lo, const float* pb,
                   const float* pb_lo, const float* ya, const float* x, const float* scal,
                   const float* scol, const unsigned char* mask, const int* pv, float* out,
                   int B, int p, int n, int rows, void* stream) {
  const bool two = op == kLeap || op == kLandStep || op == kField;
  const void* ptrs[] = {ya, x != nullptr ? x : ya, out};
  if (check_shape(p, n) || op < kLeap || op > kIdentity || op == kNs || pa == nullptr ||
      pa_lo == nullptr || ya == nullptr || out == nullptr || !tc_aligned(n, ptrs, 3) ||
      scal == nullptr || (two && (pb == nullptr || pb_lo == nullptr || x == nullptr)) ||
      (op == kIdentity && (x == nullptr || rows < 1 || rows > p)))
    return static_cast<int>(cudaErrorInvalidValue);
  ApplyTcArgs args{};
  const int Pp = tc_padded(p);
  const float* ps[4] = {pa, pa_lo, pb, pb_lo};
  int err = 0;
  for (int i = 0; i < (two ? 4 : 2) && err == 0; ++i) err = tc_map(&args.mp[i], ps[i], B, Pp, Pp, 128);
  if (err == 0) err = tc_map(&args.my[0], ya, B, p, n, 32);
  if (err == 0 && two) err = tc_map(&args.my[1], x, B, p, n, 32);
  int sms = 0;
  if (err == 0) err = sm_count(&sms);
  if (err != 0) return err;
  args.ya = ya;
  args.x = x;
  args.pa = pa;
  args.scal = scal;
  args.scol = scol;
  args.mask = mask;
  args.out = out;
  args.pv = pv;
  args.B = B;
  args.p = p;
  args.n = n;
  args.op = op;
  args.rows = rows;
  return apply_tc_launch(args, sms, static_cast<cudaStream_t>(stream));
}

// Blocks of a tensor-core apply of one matrix.
int large_tc_apply_items(int p, int n) { return tc_padded(p) / 128 * ((n + 127) / 128); }

// `iters` Newton-Schulz iterations of the (B, p, n) stack src into out on
// the tensor cores, all launched from here: each a self gram into hi / lo
// (G itself for the first iteration, whose apply reads the Frobenius
// prescale off its trace, then E = Y Y^T - I) and an apply, ping-ponging
// between out and tmp so that the last lands in out (iteration k writes
// out when iters - k is even; src may be tmp, the caller's copy of x when
// out is x and iters is odd). The matrices that mask clears are neither
// read nor written.
int large_tc_newton_schulz(const float* src, float* out, float* tmp, float* hi, float* lo,
                           float* part, const unsigned char* mask, int B, int p, int n,
                           int iters, int slices, int slice_len, void* stream) {
  const void* rows[] = {src, out, tmp, hi};
  if (check_shape(p, n) || iters < 1 || !tc_aligned(n, rows, 4) || lo == nullptr ||
      !slices_ok(n, slices, slice_len) || (slices > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* ys[3] = {src, out, tmp};
  CUtensorMap m64[3], m32[3];
  GramTcArgs gram{};
  ApplyTcArgs apply{};
  const int Pp = tc_padded(p);
  int err = tc_map(&apply.mp[0], hi, B, Pp, Pp, 128);
  if (err == 0) err = tc_map(&apply.mp[1], lo, B, Pp, Pp, 128);
  for (int i = 0; i < 3 && err == 0; ++i) {
    err = tc_map(&m64[i], ys[i], B, p, n, 64);
    if (err == 0) err = tc_map(&m32[i], ys[i], B, p, n, 32);
  }
  int sms = 0;
  if (err == 0) err = sm_count(&sms);
  if (err != 0) return err;
  gram.mask = apply.mask = mask;
  gram.B = apply.B = B;
  gram.out = hi;
  gram.lo = lo;
  gram.part = part;
  gram.p = apply.p = p;
  gram.n = apply.n = n;
  gram.slices = slices;
  gram.slice_len = slice_len;
  apply.pa = hi;
  apply.op = kNs;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int at = 0;  // src, out, tmp: which holds the iterate
  for (int k = 1; k <= iters && err == 0; ++k) {
    const int to = (iters - k) % 2 == 0 ? 1 : 2;
    gram.mx = m64[at];
    gram.eye = k > 1;
    err = gram_tc_launch(gram, false, sms, st);  // a self gram
    if (err != 0) break;
    apply.my[0] = m32[at];
    apply.ya = ys[at];
    apply.out = to == 1 ? out : tmp;
    apply.first = k == 1;
    err = apply_tc_launch(apply, sms, st);
    at = to;
  }
  return err;
}

// The same on the CUDA cores (large_gram and large_apply), gram (B, Pp,
// Pp) with Pp = large_padded(p).
int large_newton_schulz(const float* src, float* out, float* tmp, float* gram, float* part,
                        const unsigned char* mask, int B, int p, int n, int iters, int slices,
                        int slice_len, void* stream) {
  if (iters < 1 || out == nullptr || tmp == nullptr || gram == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* cur = src;
  int err = 0;
  for (int k = 1; k <= iters && err == 0; ++k) {
    float* dst = (iters - k) % 2 == 0 ? out : tmp;
    err = large_gram(cur, nullptr, nullptr, nullptr, nullptr, nullptr, mask, gram, nullptr,
                     part, B, p, n, slices, slice_len, 0, kNone, 0, stream);
    if (err == 0)
      err = large_apply(kNs, gram, nullptr, cur, nullptr, nullptr, nullptr, nullptr, mask, dst,
                        B, p, n, k == 1, stream);
    cur = dst;
  }
  return err;
}

}  // extern "C"
