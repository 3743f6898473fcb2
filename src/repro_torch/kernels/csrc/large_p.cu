// Kernels of the group step for p > 128 on Hopper (sm_90a), plain fp32
// CUDA C++ on the CUDA cores.
//
// Replaces, for p > 128 (kernels/ops.py plans them "large": the grams and
// tiles of one matrix outgrow a block's shared memory there, and where the
// field's and Newton-Schulz's CUDA-core tiled kernels still fit, at p =
// 129-160, this route beat them on the card), the Pallas TPU kernels of
// src/repro/kernels/:
//   fused_step_large(_landing) <- fused_step.py:608 fused_step_tiled
//                                 (_t1_kernel :476, _t2_pogo_kernel :530,
//                                 _t2_landing_kernel :559 and
//                                 pogo_update._phase3_kernel :133)
//   pogo_update_large          <- pogo_update.py:143 pogo_update_tiled
//                                 (_phase1/2/3_kernel :91/:110/:133)
//   landing_field_large        <- landing_field.py:79 landing_field_tiled
//                                 (pogo_update._phase1_kernel +
//                                 _field_tile_kernel :65)
//   newton_schulz_large        <- newton_schulz.py:37 newton_schulz
//                                 (_ns_kernel :21)
//
// At p = 256 one fp32 (p, p) gram is 256 KB, more than a block's 227 KB,
// so no block holds a matrix's grams as the kernels of fused_step.cu,
// two_stage.cu and newton_schulz.cu do. The TPU's tiled kernels already
// run in phases with (p, p) accumulators between them. Here each phase is
// a launch, the (p, p) operands live in HBM (and mostly in L2), and two
// kernel families do all the work (kernels/large_p.py strings them
// together):
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
// returns cudaGetLastError().

#include "tiles.cuh"

namespace {

constexpr int kT = 64;  // an output tile is kT x kT
constexpr int kK = 32;  // K chunk staged in shared memory
constexpr int kTile = kT * kT;

enum ApplyOp { kLeap = 0, kLand = 1, kLandStep = 2, kField = 3, kNs = 4 };

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

}  // extern "C"
