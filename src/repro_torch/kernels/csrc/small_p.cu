// The fused step (POGO and Landing) and the two-stage POGO update and
// landing field for small p on Hopper (sm_90a; the planner takes all four
// to p = 24): one (p, n) matrix per thread block cluster, held whole in the
// cluster's shared memory, IEEE fp32 on the CUDA cores. Newton-Schulz for
// p < 32 (small_p_ns_kernel, row 9cl) shares the layout; its notes are
// at its kernel, at the end of this file.
//
// Replaces the Pallas TPU kernels
//   fused_step_cluster   <- src/repro/kernels/fused_step.py:608 fused_step_tiled
//                           (_t1_kernel :476; POGO: _t2_pogo_kernel :530,
//                           pogo_update._phase3_kernel :133; Landing, method 1:
//                           _t2_landing_kernel :559, its branch :701)
//   pogo_update_cluster  <- src/repro/kernels/pogo_update.py:143 pogo_update_tiled
//                           (_phase1/2/3_kernel :91/:110/:133)
//   landing_field_cluster <- src/repro/kernels/landing_field.py:79 landing_field_tiled
//                           (pogo_update._phase1_kernel, _field_tile_kernel :65)
// with the functions of fused_step.cu's fused_step_tiled and two_stage.cu's
// pogo_update_tiled and landing_field_tiled: base stage (none | trace
// (+nesterov) | vadam), A = X X^T, B = X Geu^T, then
//   POGO     M = X - coef/2 (A Geu - B X), C = M M^T, X' = (1 + lam) M -
//            lam C M, and (fused) the distance from C by the gram identity,
//            as fused_step.cu's telemetry forms it;
//   Landing  X' = X - (coef/2 (A Geu - B X) + eta lam (A X - X)), W = X' X'^T
//            and dist = ||W - I_pv||_F, as fused_step.cu forms it;
//   field    Lambda = 1/2 (A G - B X) + lam (A X - X).
//
// Bound: 12 p^2 n flops a matrix (the field 10) against 5
// HBM passes of 4 p n bytes (the fused step: X, g, mu read, mu', X' written)
// or 3 (the update and the field: X, G read, one result written), at most
// p flop/byte: at p = 10 far below the fp32 ridge of 20 (67 TFLOP/s over
// 3.35 TB/s), so bytes bound all four. The CUDA-core tiled kernels sweep n
// three times (POGO: 9 and 7 passes) or twice (Landing and the field: 7 and
// 5) with one synchronous 64-column tile in flight a CTA; these read each
// operand once and write each result once.
//
// Design:
// * A cluster of c CTAs (2, 4 or 8) a matrix, persistent over the stack
//   (matrix b = cluster id, stepping by the number of clusters). CTA r holds
//   columns [r nc, (r + 1) nc) of X and of Geu as `nbox` row-major (p, W)
//   boxes (W <= 256 columns, W % 4 == 0, nc = nbox W), each loaded by one
//   TMA copy (no swizzle, zero past n) onto its own mbarrier, all issued up
//   front, so that the grams start on the first box while the others land.
// * The base stage (the fused step) runs on each box as it lands: mu read
//   by float4 loads (for p <= 12 the next box's while this box's products
//   run), mu' stored, Geu written over g in the box.
// * Grams: A (its blocks on and above the diagonal, mirrored) and B in 4 x 4
//   register blocks, each block's k range split over S lanes (a power of two)
//   and summed by a fixed butterfly (and, past a warp, in warp order). Each
//   CTA publishes its partial (PB, PB) grams (PB = p rounded up to 4, zero
//   past p); after a cluster barrier every CTA sums all c partials in rank
//   order, its own and its peers' through distributed shared memory
//   (mapa, ld.shared::cluster.v4): the same bits in every CTA. vadam's sum
//   of squares meets the same way.
// * Column-local rounds give a thread KC whole columns (all p rows in
//   registers; rows in a rolled loop from PB = 20) and read the (p, p)
//   operands as broadcast float4 rows. They run box by box in rounds of
//   kThreads column groups, and each box a round has finished takes the
//   next matrix's data, so that its loads run under this one's products:
//   POGO's leap (M over X; Geu's box takes the next g) and land (X' to HBM;
//   M's box takes the next X); Landing's step (X' to HBM and over X; Geu's
//   box takes the next g), after which W's partial runs over the X' boxes
//   and they take the next X; the field's one round (Lambda to HBM; both
//   boxes take the next X and g). W's partial summed box by box inside
//   Landing's rounds, each box then refilled at once, gives the same bits
//   but was no faster (1.0909 against 1.0731 ms at 1048 x (10, 10000) in
//   one call on an H100) and spilled at PB = 8 and 16 (its 16 running sums
//   beside the round's registers).
// * Published grams: a CTA never writes a partial a peer may still read.
//   POGO and Landing publish two grams a matrix (A and B; C or W), each
//   read by the peers between the cluster barrier after it and their
//   arrival at the next one, before which no CTA publishes that gram again.
//   The field has one barrier a matrix, so it alternates two sets by the
//   matrix's parity (A and B, then the free C and C^2 slots): set s, read by
//   the peers after matrix k's barrier and before they arrive at k + 1's,
//   is written again at k + 2, after that barrier. A last cluster barrier
//   keeps every CTA resident while a peer may read its shared memory.
// * Two CTAs an SM where the slices allow (small_p_cluster), so that one
//   CTA's products run while the other waits: at the paper's (10, 10000) a
//   cluster of 8 with two CTAs an SM beat one of 4 with one (readings in
//   kernels/ops.py), and so did it two sets of slices in one CTA an SM,
//   the next matrix loaded a whole matrix ahead (1.7026 / 1.2062 ms fused /
//   update against 1.1815 / 0.8718 in one call on an H100).
//
// Shared memory: the X and Geu slices (2 nbox slots of p W floats, each slot
// rounded up to 128 bytes), the published and summed (PB, PB) grams (POGO's
// C, Landing's W) and a scratch for the distance, a zero row (rows past p
// read it), the warps' partials, the reduction scratch and 2 nbox mbarriers.
// Outputs may alias inputs (x_out == x, mu_out == mu, nu_out == nu): X is
// resident before X' is written, mu is read before mu' is written by the
// same thread, and nu is read before the cluster barrier after which rank 0
// writes nu'. Every launcher returns cudaGetLastError(); a refused launch is
// its error.

#include <mutex>
#include <vector>

#include "hopper.cuh"
#include "tiles.cuh"

namespace {

// The route takes p <= CLUSTER_MAX_P (kernels/ops.py); the kernels take
// p <= 32, so that the readings that set the route's top end reach past it.
constexpr int kSpMaxP = 32;
constexpr int kSpMaxCluster = 8;    // the largest portable cluster
constexpr int kSpBoxCols = 256;     // most columns a TMA box takes
constexpr int kSpMaxBoxes = 64;     // most boxes a CTA holds
constexpr int kSpSmSmem = 233472;   // an SM's shared memory, 1 KB of it reserved a CTA

// The kernel's four entries: the fused step's two methods (Method's values)
// and the two-stage POGO update and landing field.
enum SpMode { kSpPogo = kPogo, kSpLanding = kLanding, kSpUpdate = 2, kSpField = 3 };

// Whole columns a thread takes in the column-local phases: its p x KC
// values of X and Geu stay in registers (128 a thread at two CTAs an SM,
// which the register cap allows up to PB = 28).
__host__ __device__ constexpr int sp_cols(int PB) { return PB <= 8 ? 4 : PB <= 16 ? 2 : 1; }

// Whether the column-local phases keep their row loop rolled (their PB x KC
// values and the unrolled rows' temporaries overflow 128 registers).
__host__ __device__ constexpr bool sp_rolled(int PB) { return PB >= 20; }

// Lanes that split one 4 x 4 gram block's k range: the largest power of two
// with items x lanes <= kThreads.
__host__ __device__ constexpr int sp_lanes(int items) {
  int s = 1;
  while (s < kThreads && 2 * s * items <= kThreads) s *= 2;
  return s;
}

struct SpLayout {
  int W;     // columns of a box
  int nbox;  // boxes a CTA
  int nc;    // columns a CTA, nbox W
  int sbox;  // bytes of a box's slot, p W floats rounded up to 128 bytes
};

__host__ __device__ inline SpLayout sp_layout(int p, int n, int c) {
  SpLayout L;
  const int cols = (n + c - 1) / c;
  L.nbox = (cols + kSpBoxCols - 1) / kSpBoxCols;
  L.W = round4((cols + L.nbox - 1) / L.nbox);
  L.nc = L.nbox * L.W;
  L.sbox = (p * L.W * 4 + 127) / 128 * 128;
  return L;
}

// Floats past the slices: the published A, B, C, the summed A, B, C, the
// distance's C^2 (PB^2 each), the zero row, the warps' partials and the
// reduction scratch (its [8] the published sum of squares).
__host__ __device__ inline int sp_extra_floats(int PB) {
  return 7 * PB * PB + kSpBoxCols + kWarps * 16 + 16;
}

__host__ __device__ inline int sp_smem_bytes(int p, int n, int c) {
  const SpLayout L = sp_layout(p, n, c);
  return 2 * L.nbox * L.sbox + 4 * sp_extra_floats(round4(p)) + 16 * L.nbox + 1024;
}

// The least c in {2, 4, 8} whose CTA (`bytes(p, n, c)` of shared memory)
// leaves an SM room for a second one (where the kernel's registers allow
// `most` CTAs an SM, two), so that one CTA's loads run under the other's
// products; else the least whose slices fit a CTA; 0 when none does.
inline int sp_least_cluster(int p, int n, int (*bytes)(int, int, int), int most = 2) {
  for (int ctas = most; ctas >= 1; --ctas)
    for (int c = 2; c <= kSpMaxCluster; c *= 2) {
      const int smem = bytes(p, n, c);
      if (sp_layout(p, n, c).nbox <= kSpMaxBoxes && smem <= kSmemLimit &&
          ctas * (smem + 1024) <= kSpSmSmem)
        return c;
    }
  return 0;
}

// The four entries' cluster size for (p, n) (at 1048 x (10, 10000) on an
// H100, ms fused POGO / POGO update: c = 8, two CTAs an SM, 1.2307 /
// 0.9033; c = 4, one, 1.5050 / 1.0695).
inline int sp_cluster(int p, int n) { return sp_least_cluster(p, n, sp_smem_bytes); }

// KC consecutive floats from / to shared or global memory (16-, 8- or
// 4-byte aligned).
template <int KC>
__device__ inline void ld_cols(float (&v)[KC], const float* s) {
  if constexpr (KC == 4) {
    load4(v, *reinterpret_cast<const float4*>(s));
  } else if constexpr (KC == 2) {
    const float2 t = *reinterpret_cast<const float2*>(s);
    v[0] = t.x;
    v[1] = t.y;
  } else {
    v[0] = *s;
  }
}

template <int KC>
__device__ inline void st_cols(float* d, const float (&v)[KC]) {
  if constexpr (KC == 4) {
    *reinterpret_cast<float4*>(d) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (KC == 2) {
    *reinterpret_cast<float2*>(d) = make_float2(v[0], v[1]);
  } else {
    *d = v[0];
  }
}

// Block (bi, bj), bi <= bj, the item-th of the blocks on and above the
// diagonal of an nb x nb grid of 4 x 4 blocks, row by row.
__device__ inline void sym_block(int item, int nb, int& bi, int& bj) {
  bi = 0;
  while (item >= nb - bi) {
    item -= nb - bi;
    ++bi;
  }
  bj = bi + item;
}

// acc[4 r + c] += sum_k U[4 bi + r, k] V[4 bj + c, k] over the column quads
// s, s + S, ... of one row-major (p, W) box; rows past p read the zero row.
__device__ inline void gram_quads(float (&acc)[16], const float* U, const float* V, int bi,
                                  int bj, int p, int W, const float* zrow, int s, int S) {
  const float* u[4];
  const float* v[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    u[r] = 4 * bi + r < p ? U + (4 * bi + r) * W : zrow;
    v[r] = 4 * bj + r < p ? V + (4 * bj + r) * W : zrow;
  }
  for (int q = s; q < W / 4; q += S) {
    float a[4][4], b[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      load4(a[r], lds4(u[r] + 4 * q));
      load4(b[r], lds4(v[r] + 4 * q));
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[4 * r + c] = fmaf(a[r][e], b[c][e], acc[4 * r + c]);
  }
}

// The items' sums over their S lanes (a butterfly inside the warp, then an
// item's warps in order through `part`), written by its lane 0 to the
// row-major (PB, PB) `pub` of its gram, zero past p; a symmetric item also
// at its transposed place. Every thread calls it.
template <int S>
__device__ inline void publish(float (&acc)[16], bool act, bool cross, int bi, int bj, int p,
                               int PB, float* sym, float* crs, float* part) {
  constexpr int L = S < 32 ? S : 32;
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1)
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
  const int tid = threadIdx.x;
  if (S > 32) {
    const int w = tid >> 5;
    if ((tid & 31) == 0)
#pragma unroll
      for (int e = 0; e < 16; ++e) part[16 * w + e] = acc[e];
    __syncthreads();
    if (tid % S == 0)
      for (int k = 1; k < S / 32; ++k)
#pragma unroll
        for (int e = 0; e < 16; ++e) acc[e] += part[16 * (w + k) + e];
  }
  if (!act || tid % S != 0) return;
  // Formed here, not hoisted to the kernel's start and spilled (PB = 24).
  bi = hopper::opaque(bi);
  bj = hopper::opaque(bj);
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = 4 * bi + r, j = 4 * bj + c;
      const float v = i < p && j < p ? acc[4 * r + c] : 0.f;
      if (cross) {
        crs[i * PB + j] = v;
      } else {
        sym[i * PB + j] = v;
        sym[j * PB + i] = v;
      }
    }
}

// out = the sum of every CTA's `pub` (count floats, count % 4 == 0) in rank
// order: its own from its shared memory, its peers' through mapa.
__device__ inline void cluster_sum(const float* pub, float* out, int count, int c, int rank) {
  for (int e = 4 * threadIdx.x; e < count; e += 4 * kThreads) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < c; ++k) {
      const float4 v = k == rank ? lds4(pub + e) : hopper::ld_peer4(hopper::map_peer(pub + e, k));
      if (k == 0) {
        s = v;
      } else {
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
    }
    *reinterpret_cast<float4*>(out + e) = s;
  }
}

// The base stage on one box of g (row-major (p, W), global columns col0 ..),
// in two halves so that the box's mu loads fly under the products of the
// box before it: stage_load reads the thread's quads of mu (KQ at most) into
// registers; stage_finish forms mu' = h0 mu + g (trace) or h0 mu + (1 - h0)
// g (vadam, whose squares of g go to sq), stores it to mu_out, and writes
// Geu (mu', or h0 mu' + g with nesterov) over g in the box. Columns past n
// stay zero.
template <int KQ>
__device__ inline void stage_load(float4 (&mq)[KQ], const float* mu, size_t off, int p, int n,
                                  int col0, int W) {
  const int wq = W / 4;
#pragma unroll
  for (int k = 0; k < KQ; ++k) {
    const int u = threadIdx.x + k * kThreads, i = u / wq, col = col0 + 4 * (u - i * wq);
    if (u < p * wq && col < n)
      mq[k] = *reinterpret_cast<const float4*>(mu + off + static_cast<size_t>(i) * n + col);
  }
}

// One quad: mu' from mu (mv) and g (over which Geu goes) at row i, column
// col.
__device__ __forceinline__ void stage_quad(const float4 mv4, float4* gp, float* mu_out,
                                           size_t at, int base_kind, int nesterov, float h0,
                                           float& sq) {
  float gv[4], mv[4], m2[4], ge[4];
  load4(gv, *gp);
  load4(mv, mv4);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (base_kind == kTrace) {
      m2[e] = h0 * mv[e] + gv[e];
    } else {
      m2[e] = h0 * mv[e] + (1.f - h0) * gv[e];
      sq = fmaf(gv[e], gv[e], sq);
    }
    ge[e] = (base_kind == kTrace && nesterov) ? h0 * m2[e] + gv[e] : m2[e];
  }
  *reinterpret_cast<float4*>(mu_out + at) = make_float4(m2[0], m2[1], m2[2], m2[3]);
  *gp = make_float4(ge[0], ge[1], ge[2], ge[3]);
}

template <int KQ>
__device__ inline void stage_finish(const float4 (&mq)[KQ], float* G, float* mu_out, size_t off,
                                    int p, int n, int col0, int W, int base_kind, int nesterov,
                                    float h0, float& sq) {
  const int wq = W / 4;
#pragma unroll
  for (int k = 0; k < KQ; ++k) {
    const int u = threadIdx.x + k * kThreads, i = u / wq, q = u - i * wq, col = col0 + 4 * q;
    if (u >= p * wq || col >= n) continue;
    stage_quad(mq[k], reinterpret_cast<float4*>(G + i * W + 4 * q), mu_out,
               off + static_cast<size_t>(i) * n + col, base_kind, nesterov, h0, sq);
  }
}

// The same in one pass, each quad's mu loaded where it is used (for large
// p, whose quads would not stay in registers under the products).
__device__ inline void stage_box(float* G, const float* mu, float* mu_out, size_t off, int p,
                                 int n, int col0, int W, int base_kind, int nesterov, float h0,
                                 float& sq) {
  const int wq = W / 4;
  for (int u = threadIdx.x; u < p * wq; u += kThreads) {
    const int i = u / wq, q = u - i * wq, col = col0 + 4 * q;
    if (col >= n) continue;
    const size_t at = off + static_cast<size_t>(i) * n + col;
    stage_quad(*reinterpret_cast<const float4*>(mu + at),
               reinterpret_cast<float4*>(G + i * W + 4 * q), mu_out, at, base_kind, nesterov,
               h0, sq);
  }
}

// One group of KC whole columns (xb, gb: its first column in the boxes of X
// and Geu; A, Bm row-major (PB, PB)), its rows to `out` (row stride n):
//   POGO (kSpPogo, kSpUpdate)  M = X - coef/2 (A Geu - B X), over X;
//   kSpLanding                 X' = X - (coef/2 (A Geu - B X) + el (A X - X)),
//                              over X and to out;
//   kSpField                   Lambda = 1/2 (A G - B X) + el (A X - X), to out.
template <int PB, int KC, int kMode>
__device__ __forceinline__ void direction_group(float* xb, const float* gb, const float* A,
                                                const float* Bm, float coef, float el, int p,
                                                int n, int W, float* out, const float* zrow) {
  constexpr bool kNormal = kMode == kSpLanding || kMode == kSpField;  // Landing's A X - X
  float xr[PB][KC], gr[PB][KC];
#pragma unroll
  for (int i = 0; i < PB; ++i) {
    ld_cols(xr[i], i < p ? xb + i * W : zrow);
    ld_cols(gr[i], i < p ? gb + i * W : zrow);
  }
  // Rows in a loop the compiler keeps rolled from PB = 20 (sp_rolled), X's
  // row re-read from shared memory before the result is written over it.
#pragma unroll
  for (int r = 0; r < (sp_rolled(PB) ? 1 : PB); ++r)
  for (int i = r; i < (sp_rolled(PB) ? p : r + 1); ++i) {
    if (i >= p) continue;
    float ag[KC] = {}, bx[KC] = {}, ax[KC] = {};
#pragma unroll
    for (int j4 = 0; j4 < PB / 4; ++j4) {
      float av[4], bv[4];
      load4(av, lds4(A + i * PB + 4 * j4));
      load4(bv, lds4(Bm + i * PB + 4 * j4));
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          ag[c] = fmaf(av[q], gr[4 * j4 + q][c], ag[c]);
          bx[c] = fmaf(bv[q], xr[4 * j4 + q][c], bx[c]);
          if (kNormal) ax[c] = fmaf(av[q], xr[4 * j4 + q][c], ax[c]);
        }
    }
    float xi[KC], o[KC];
    if constexpr (sp_rolled(PB)) {
      ld_cols(xi, xb + i * W);
    } else {
#pragma unroll
      for (int c = 0; c < KC; ++c) xi[c] = xr[i][c];
    }
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      if (kMode == kSpLanding)
        o[c] = xi[c] - (coef * (0.5f * (ag[c] - bx[c])) + el * (ax[c] - xi[c]));
      else if (kMode == kSpField)
        o[c] = 0.5f * (ag[c] - bx[c]) + el * (ax[c] - xi[c]);
      else
        o[c] = xi[c] - coef * (0.5f * (ag[c] - bx[c]));
    }
    if (kMode != kSpField) st_cols(xb + i * W, o);
    if (kNormal) st_cols(out + static_cast<size_t>(i) * n, o);
  }
}

// X' = (1 + lam) M - lam C M for one group of KC whole columns (mb: its
// first column in M's boxes), stored to HBM at `out` (its first element,
// row stride n); C row-major (PB, PB).
template <int PB, int KC>
__device__ __forceinline__ void land_group(const float* mb, const float* C, float lam, int p,
                                           int n, int W, float* out, const float* zrow) {
  float m[PB][KC];
#pragma unroll
  for (int i = 0; i < PB; ++i) ld_cols(m[i], i < p ? mb + i * W : zrow);
#pragma unroll
  for (int r = 0; r < (sp_rolled(PB) ? 1 : PB); ++r)
  for (int i = r; i < (sp_rolled(PB) ? p : r + 1); ++i) {
    if (i >= p) continue;
    float cm[KC] = {};
#pragma unroll
    for (int j4 = 0; j4 < PB / 4; ++j4) {
      float cv[4];
      load4(cv, lds4(C + i * PB + 4 * j4));
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int c = 0; c < KC; ++c) cm[c] = fmaf(cv[q], m[4 * j4 + q][c], cm[c]);
    }
    float mi[KC], o[KC];
    if constexpr (sp_rolled(PB)) {
      ld_cols(mi, mb + i * W);
    } else {
#pragma unroll
      for (int c = 0; c < KC; ++c) mi[c] = m[i][c];
    }
#pragma unroll
    for (int c = 0; c < KC; ++c) o[c] = (1.f + lam) * mi[c] - lam * cm[c];
    st_cols(out + static_cast<size_t>(i) * n, o);
  }
}

// A column-local phase over the CTA's live boxes, box by box in rounds of
// kThreads groups of KC columns: kMode's direction_group, or (kLand) POGO's
// land. After each round every thread calls done(from, to) with the boxes
// [from, to) it finished, at one call site: done's barriers are .aligned,
// so no warp may reach them from two places.
template <int PB, int KC, int kMode, bool kLand, class Done>
__device__ __forceinline__ void column_rounds(float* XS, const float* GS, const float* P,
                                              const float* Q, float coef, float el, int p,
                                              int n, int W, int sboxf, int live, int col_lo,
                                              float* out, const float* zrow, Done done) {
  const int per = W / KC, total = live * per;
  int finished = 0;
  for (int u0 = 0; u0 < total; u0 += kThreads) {
    const int u = u0 + threadIdx.x, j = u / per, cb = (u - j * per) * KC;
    const int col = col_lo + j * W + cb;
    if (u < total && col < n) {
      if (kLand)
        land_group<PB, KC>(XS + j * sboxf + cb, P, el, p, n, W, out + col, zrow);
      else
        direction_group<PB, KC, kMode>(XS + j * sboxf + cb, GS + j * sboxf + cb, P, Q, coef,
                                       el, p, n, W, out + col, zrow);
    }
    const int now = min(total, u0 + kThreads) / per;
    done(finished, now);
    finished = now;
  }
}

// dist = ||(1+lam)^2 C - 2 lam (1+lam) C^2 + lam^2 C^3 - I_pv||_F (fused_step.cu's
// telemetry), C row-major (PB, PB), C^2 built in C2, by one warp (lane 0
// stores it) while the other warps go on to the land.
__device__ void sp_telemetry(const float* C, float* C2, int PB, int p, int pv, float lam,
                             float* dist_out) {
  const int lane = threadIdx.x & 31;
  for (int e = lane; e < p * p; e += 32) {
    const int i = e / p, j = e - i * p;
    float s = 0.f;
    for (int l = 0; l < p; ++l) s = fmaf(C[i * PB + l], C[l * PB + j], s);
    C2[i * PB + j] = s;
  }
  __syncwarp();
  const float k1 = (1.f + lam) * (1.f + lam);
  const float k2 = 2.f * lam * (1.f + lam);
  const float k3 = lam * lam;
  float acc = 0.f;
  for (int e = lane; e < p * p; e += 32) {
    const int i = e / p, j = e - i * p;
    float c3 = 0.f;
    for (int l = 0; l < p; ++l) c3 = fmaf(C2[i * PB + l], C[l * PB + j], c3);
    const float w = k1 * C[i * PB + j] - k2 * C2[i * PB + j] + k3 * c3;
    const float r = w - ((i == j && i < pv) ? 1.f : 0.f);
    acc = fmaf(r, r, acc);
  }
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) *dist_out = sqrtf(acc);
}

// dist = ||W - I_pv||_F (fused_step.cu's residual_dist), W row-major (PB,
// PB), by one warp (lane 0 stores it).
__device__ void sp_residual(const float* Wm, int PB, int p, int pv, float* dist_out) {
  const int lane = threadIdx.x & 31;
  float acc = 0.f;
  for (int e = lane; e < p * p; e += 32) {
    const int i = e / p, j = e - i * p;
    const float r = Wm[i * PB + j] - ((i == j && i < pv) ? 1.f : 0.f);
    acc = fmaf(r, r, acc);
  }
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) *dist_out = sqrtf(acc);
}

// One cluster of c CTAs a matrix; grid (clusters) x c. kMode: the entry
// (the two-stage ones, kSpUpdate and kSpField: no base stage, no distance;
// the update's coef is eta).
template <int PB, int kMode>
__global__ void __launch_bounds__(kThreads, PB <= 28 ? 2 : 1)
small_p_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_g,
               const float* mu, const float* nu, const float* scal, const int* pv, float* x_out,
               float* mu_out, float* nu_out, float* dist, int B, int p, int n, int base_kind,
               int nesterov, int c) {
  extern __shared__ unsigned char small_p_smem[];
  constexpr int KC = sp_cols(PB), nb = PB / 4, nA = nb * (nb + 1) / 2;
  constexpr int KQ = (PB * kSpBoxCols / 4 + kThreads - 1) / kThreads;  // mu quads a box
  constexpr bool kAhead = KQ <= 3;  // the next box's mu in registers under the products
  constexpr int S1 = sp_lanes(nA + nb * nb), S2 = sp_lanes(nA);
  constexpr bool kTwoStage = kMode == kSpUpdate || kMode == kSpField;
  unsigned char* sm = hopper::smem_align1024(small_p_smem);
  const SpLayout L = sp_layout(p, n, c);
  const int W = L.W, sboxf = L.sbox / 4, tid = threadIdx.x;
  const int rank = static_cast<int>(hopper::cluster_rank());
  const int col_lo = rank * L.nc;
  const int live = col_lo >= n ? 0 : min(L.nbox, (n - col_lo + W - 1) / W);  // boxes before n
  float* XS = reinterpret_cast<float*>(sm);
  float* GS = XS + L.nbox * sboxf;
  float* pubA = GS + L.nbox * sboxf;  // pubA, pubB, pubC, then the sums A, B, C
  float* pubB = pubA + PB * PB;
  float* pubC = pubB + PB * PB;
  float* Ag = pubC + PB * PB;
  float* Bg = Ag + PB * PB;
  float* Cg = Bg + PB * PB;
  float* C2 = Cg + PB * PB;
  float* zrow = C2 + PB * PB;
  float* part = zrow + kSpBoxCols;
  float* red = part + kWarps * 16;
  uint64_t* bar_x = reinterpret_cast<uint64_t*>(red + 16);
  uint64_t* bar_g = bar_x + L.nbox;
  const uint32_t box_bytes = static_cast<uint32_t>(p * W * 4);
  const int cl = blockIdx.x / c, ncl = gridDim.x / c;
  const float lam = scal[1], h0 = scal[3];
  const CUtensorMap* const map_x = &tm_x;  // closures copy these, never the maps
  const CUtensorMap* const map_g = &tm_g;

  // This thread's gram blocks: A's on and above the diagonal, then B's
  // (phase 1, S1 lanes each); C's or W's (phase 3, S2 lanes each).
  const int it1 = tid / S1, s1 = tid % S1, it2 = tid / S2, s2 = tid % S2;
  const bool act1 = it1 < nA + nb * nb, cross1 = it1 >= nA, act2 = it2 < nA;
  int bi1 = 0, bj1 = 0, bi2 = 0, bj2 = 0;
  if (act1 && !cross1) sym_block(it1, nb, bi1, bj1);
  if (act1 && cross1) {
    bi1 = (it1 - nA) / nb;
    bj1 = (it1 - nA) % nb;
  }
  if (act2) sym_block(it2, nb, bi2, bj2);

  if (tid == 0) {
    for (int j = 0; j < 2 * L.nbox; ++j) hopper::mbar_init(bar_x + j, 1);
    hopper::mbar_fence_init();
  }
  for (int e = tid; e < kSpBoxCols; e += kThreads) zrow[e] = 0.f;
  __syncthreads();

  // Boxes [j0, j1) of matrix b's X (or g) into their slots, each on its
  // mbarrier (thread 0). Closures take copies, so that nothing of the
  // kernel's lives in local memory for them.
  auto issue = [=](const CUtensorMap* map, float* slice, uint64_t* bars, int b, int j0, int j1) {
    for (int j = j0; j < j1; ++j) {
      hopper::mbar_expect_tx(bars + j, box_bytes);
      hopper::tma_load_4d(slice + j * sboxf, map, bars + j, col_lo + j * W, 0, b, 0);
    }
  };
  if (tid == 0 && cl < B) {
    issue(map_x, XS, bar_x, cl, 0, live);
    issue(map_g, GS, bar_g, cl, 0, live);
  }

  int it = 0;
  for (int b = cl; b < B; b += ncl, ++it) {
    const uint32_t ph = it & 1;
    const bool next = b + ncl < B;
    const size_t off = static_cast<size_t>(b) * p * n;
    const bool vadam = !kTwoStage && base_kind == kVAdam;
    const float nu0 = vadam ? nu[b] : 0.f;

    // 1. Each box as it lands: the base stage (the next box's mu loads
    // issued before this box's products), then its share of A and B.
    const bool moments = !kTwoStage && base_kind != kNone;
    float acc[16] = {};
    float sq = 0.f;
    float4 mq[KQ];
    if constexpr (kAhead)
      if (moments && live > 0) stage_load(mq, mu, off, p, n, col_lo, W);
    for (int j = 0; j < live; ++j) {
      hopper::mbar_wait(bar_x + j, ph);
      hopper::mbar_wait(bar_g + j, ph);
      if (moments) {
        if constexpr (kAhead)
          stage_finish(mq, GS + j * sboxf, mu_out, off, p, n, col_lo + j * W, W, base_kind,
                       nesterov, h0, sq);
        else
          stage_box(GS + j * sboxf, mu, mu_out, off, p, n, col_lo + j * W, W, base_kind,
                    nesterov, h0, sq);
      }
      __syncthreads();
      if constexpr (kAhead)
        if (moments && j + 1 < live) stage_load(mq, mu, off, p, n, col_lo + (j + 1) * W, W);
      if (act1)
        gram_quads(acc, XS + j * sboxf, (cross1 ? GS : XS) + j * sboxf, bi1, bj1, p, W, zrow, s1,
                   S1);
    }
    // The field's odd matrices publish into the C and C^2 slots (the
    // design's rule for published grams).
    float* const pub = kMode == kSpField && (it & 1) ? Cg : pubA;
    publish<S1>(acc, act1, cross1, bi1, bj1, p, PB, pub, pub + PB * PB, part);
    if (vadam) {
      const float cta_sq = block_sum(sq, red);
      if (tid == 0) red[8] = cta_sq;
    }
    hopper::cluster_sync();
    cluster_sum(pub, Ag, 2 * PB * PB, c, rank);  // A and B
    float coef = scal[0];
    if (vadam) {
      float tot = 0.f;
      for (int k = 0; k < c; ++k)
        tot += k == rank ? red[8] : hopper::ld_peer(hopper::map_peer(red + 8, k));
      const float b2 = scal[4], eps = scal[5], c1 = scal[6], c2 = scal[7];
      const float nu2 = b2 * nu0 + (1.f - b2) * tot;
      if (rank == 0 && tid == 0) nu_out[b] = nu2;
      coef = scal[0] * ((scal[2] / c1) / (sqrtf(nu2 / c2) + eps));
    } else if (!kTwoStage) {
      coef = scal[0] * scal[2];
    }
    __syncthreads();

    // Each box of `slice` a round has finished takes the next matrix's.
    auto refill = [=](const CUtensorMap* map, float* slice, uint64_t* bars) {
      return [=](int from, int to) {
        hopper::fence_proxy_async_smem();
        __syncthreads();
        if (tid == 0 && next) issue(map, slice, bars, b + ncl, from, to);
      };
    };
    if constexpr (kMode == kSpField) {
      // 2. The field to HBM; each box of X and G it has finished takes the
      // next matrix's X and g.
      column_rounds<PB, KC, kMode, false>(
          XS, GS, Ag, Bg, 1.f, lam, p, n, W, sboxf, live, col_lo, x_out + off, zrow,
          [=](int from, int to) {
            __syncthreads();
            if (tid == 0 && next) {
              issue(map_x, XS, bar_x, b + ncl, from, to);
              issue(map_g, GS, bar_g, b + ncl, from, to);
            }
          });
    } else {
      // 2. POGO's leap (M over X) or Landing's step (X' over X and to HBM);
      // each box of Geu it has finished takes the next matrix's g.
      const float el = kMode == kSpLanding ? scal[0] * lam : lam;
      column_rounds<PB, KC, kMode, false>(XS, GS, Ag, Bg, coef, el, p, n, W, sboxf, live,
                                          col_lo, x_out + off, zrow, refill(map_g, GS, bar_g));

      // 3. C = M M^T, or W = X' X'^T, after which Landing's X' boxes take
      // the next matrix's X.
      float accc[16] = {};
      if (act2)
        for (int j = 0; j < live; ++j)
          gram_quads(accc, XS + j * sboxf, XS + j * sboxf, bi2, bj2, p, W, zrow, s2, S2);
      if constexpr (kMode == kSpLanding) {
        __syncthreads();
        if (tid == 0 && next) issue(map_x, XS, bar_x, b + ncl, 0, live);
      }
      publish<S2>(accc, act2, false, bi2, bj2, p, PB, pubC, nullptr, part);
      hopper::cluster_sync();
      cluster_sum(pubC, Cg, PB * PB, c, rank);
      __syncthreads();
      const int pvb = pv != nullptr ? pv[b] : p;
      if (kMode == kSpPogo && rank == 0 && tid < 32)
        sp_telemetry(Cg, C2, PB, p, pvb, lam, dist + b);
      if (kMode == kSpLanding && rank == 0 && tid < 32) sp_residual(Cg, PB, p, pvb, dist + b);

      // 4. POGO's land to HBM; each box of M it has finished takes the next
      // matrix's X.
      if constexpr (kMode != kSpLanding)
        column_rounds<PB, KC, kMode, true>(XS, GS, Cg, nullptr, coef, lam, p, n, W, sboxf,
                                           live, col_lo, x_out + off, zrow,
                                           refill(map_x, XS, bar_x));
    }
  }
  hopper::cluster_sync();  // no CTA leaves while a peer may read its shared memory
}

template <int kMode>
const void* sp_kernel(int PB) {
  using K = const void*;
  switch (PB) {
    case 4: return K(small_p_kernel<4, kMode>);
    case 8: return K(small_p_kernel<8, kMode>);
    case 12: return K(small_p_kernel<12, kMode>);
    case 16: return K(small_p_kernel<16, kMode>);
    case 20: return K(small_p_kernel<20, kMode>);
    case 24: return K(small_p_kernel<24, kMode>);
    case 28: return K(small_p_kernel<28, kMode>);
    case 32: return K(small_p_kernel<32, kMode>);
    default: return nullptr;
  }
}

// A launch of ctas CTAs in clusters of c, smem bytes of dynamic shared
// memory each (attr, the cluster's shape, outlives the configuration).
cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr, int c, int smem, int ctas,
                                  void* stream) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The clusters of c CTAs, smem bytes each, the card keeps resident at once
// for kernel, or minus a CUDA error. Under a lock: once a (device, kernel),
// the kernel's shared-memory limit, set at kSmemLimit (one value a
// function, whatever a launch asks); once a (device, kernel, c, smem), the
// count. A launch after the first costs a lookup, so that the watchdog's
// idle repair stays cheap.
int resident_clusters(const void* kernel, int c, int smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -static_cast<int>(err);
  struct Known {
    int dev;
    const void* kernel;
    int c, smem, clusters;  // c = 0: the limit is set
  };
  static std::mutex lock;
  static std::vector<Known> known;
  const std::lock_guard<std::mutex> hold(lock);
  bool ready = false;
  for (const Known& k : known) {
    if (k.dev == dev && k.kernel == kernel && k.c == c && k.smem == smem) return k.clusters;
    ready |= k.dev == dev && k.kernel == kernel && k.c == 0;
  }
  if (!ready) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return -static_cast<int>(err);
    known.push_back({dev, kernel, 0, 0, 0});
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(&attr, c, smem, c, nullptr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return -static_cast<int>(err);
  known.push_back({dev, kernel, c, smem, clusters});
  return clusters;
}

// A tensor map over a (B, p, n) fp32 stack as (n, p, B, 1), a (W, p) box.
int rows_map(CUtensorMap* map, const float* src, int B, int p, int n, int W) {
  const uint64_t e = sizeof(float);
  const uint64_t dims[4] = {static_cast<uint64_t>(n), static_cast<uint64_t>(p),
                            static_cast<uint64_t>(B), 1};
  const uint64_t strides[3] = {n * e, p * n * e, B * p * n * e};
  const uint32_t box[4] = {static_cast<uint32_t>(W), static_cast<uint32_t>(p), 1, 1};
  return hopper::make_tma_map_f32_rows(map, src, dims, strides, box);
}

// kernel on the persistent grid: as many clusters of c CTAs as the card
// keeps resident, at most B (> 0).
int cluster_launch(const void* kernel, int c, int smem, int B, void** args, void* stream) {
  const int clusters = resident_clusters(kernel, c, smem);
  if (clusters < 0) return -clusters;
  if (clusters == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(&attr, c, smem, (B < clusters ? B : clusters) * c, stream);
  const cudaError_t err = cudaLaunchKernelExC(&cfg, kernel, args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Tensor maps over X and g and the cluster launch.
int sp_launch(int mode, const float* x, const float* g, const float* mu, const float* nu,
              const float* scal, const int* pv, float* x_out, float* mu_out, float* nu_out,
              float* dist, int B, int p, int n, int base_kind, int nesterov, int c,
              void* stream) {
  if (B < 0 || p < 1 || p > kSpMaxP || n < 4 || n % 4 != 0 ||
      (c != 2 && c != 4 && c != 8) || base_kind < kNone || base_kind > kVAdam)
    return static_cast<int>(cudaErrorInvalidValue);
  const SpLayout L = sp_layout(p, n, c);
  const int smem = sp_smem_bytes(p, n, c);
  const bool moments = base_kind != kNone;
  const void* rows[] = {x, g, x_out, moments ? mu : x, moments ? mu_out : x};
  if (L.nbox > kSpMaxBoxes || smem > kSmemLimit || !vector_ok(n, rows, 5))
    return static_cast<int>(cudaErrorInvalidValue);
  const int PB = round4(p);
  const void* kernel = mode == kSpPogo      ? sp_kernel<kSpPogo>(PB)
                       : mode == kSpLanding ? sp_kernel<kSpLanding>(PB)
                       : mode == kSpUpdate  ? sp_kernel<kSpUpdate>(PB)
                                            : sp_kernel<kSpField>(PB);
  if (B == 0) return static_cast<int>(cudaGetLastError());
  CUtensorMap maps[2] = {};
  const float* srcs[2] = {x, g};
  for (int i = 0; i < 2; ++i) {
    const int merr = rows_map(&maps[i], srcs[i], B, p, n, L.W);
    if (merr != 0) return merr;
  }
  void* args[] = {&maps[0], &maps[1], &mu, &nu, &scal, &pv, &x_out, &mu_out, &nu_out, &dist,
                  &B, &p, &n, &base_kind, &nesterov, &c};
  return cluster_launch(kernel, c, smem, B, args, stream);
}

// ---------------------------------------------------------------------------
// Newton-Schulz for p < 32 (row 9cl): small_p_ns_kernel, a sibling of
// small_p_kernel on its layout, that holds one matrix's Y in a cluster's
// shared memory through every iteration.
//
// Replaces src/repro/kernels/newton_schulz.py:37 (newton_schulz, _ns_kernel
// :21), reached through kernels/ops.py:700 (_ns_dispatch) from the
// watchdog's repair, as newton_schulz.cu's kernels do, with their function
// per (p, n) matrix of a (B, p, n) fp32 stack:
//   f = max(||X||_F, 1e-30),  Y = X / f
//   iters times:  Y <- 1.5 Y - 0.5 (Y Y^T) Y
//   dist = ||Y Y^T - I||_F
// and their (B,) byte mask: a matrix whose byte is 0, and its distance,
// stay as they were.
//
// Bound: 3 p^2 n flops an iteration (the symmetric gram p^2 n, G Y 2 p^2 n)
// against X read once and Y written once: at 1048 x (10, 10000) and 12
// iterations 0.5631 ms of fp32 operations against 0.2503 of bytes.
// Operations bound it. newton_schulz.cu's tiled kernel (row 9) sweeps Y
// through the output buffer in every iteration, one 64-column tile in
// flight a CTA.
//
// Design:
// * small_p_kernel's layout with Y's slots alone: CTA r of a cluster of c
//   holds columns [r nc, (r + 1) nc) of the matrix as row-major (p, W)
//   boxes, each TMA-loaded once onto its own mbarrier; a persistent grid of
//   clusters walks the stack. Y never goes to HBM between iterations.
// * 13 grams a matrix (12 with no distance): X X^T, whose trace is
//   ||X||_F^2 (the prescale; the gram then scaled by 1 / f^2 is Y_0's, as
//   csrc/large_p.cu's Newton-Schulz reads it), then each iterate's. A
//   thread sums a pair of 4 x 4 blocks that share a block row (the
//   diagonal block's rows loaded once, its upper half alone) over its
//   column quads of all the boxes in one loop (ns_gram_pair; the pairs
//   cover each block on or above the diagonal, or its mirror, once:
//   ns_item), the lanes meet (publish), and the CTAs' partials are summed
//   in rank order with every peer's load in flight (ns_sum): one cluster
//   barrier a gram. On an H100 at 1048 x (10, 10000) (ms, builds in turns,
//   benchmarks_torch/small_p_readings.py --ns --source): a 4 x 4 block a
//   thread 3.4920; the pairs, 4 columns a thread and the peers' loads in
//   flight 3.3691; the upper half and one loop over the boxes 3.0962,
//   unrolled twice 3.0179. Meeting the lanes' sums by halving (31
//   shuffles for 32 sums, not 160) lost, 3.2109 against 3.0171: its
//   levels are serial.
//   The published sets alternate by the gram's parity, counted over the
//   launch: set s, read by the peers after gram k's barrier and before
//   they arrive at gram k + 1's, is written again at k + 2, after that
//   barrier.
// * The update is a column round as small_p_kernel's land: a thread's KC
//   whole columns (ns_cols) with every row in registers (X / f in the
//   first), G read
//   as broadcast rows, Y' written over its columns; the last iterate also
//   to HBM. The last gram gives the distance (sp_residual, rank 0's first
//   warp). Then the boxes take the next matrix's loads (with no distance,
//   each box as the last round has finished it).
// * The mask: every CTA of a cluster reads the same bytes and skips a
//   masked-off matrix, issuing no load and no barrier for it; the CTA reads
//   the next kThreads of its cluster's bytes at once, so that an idle
//   launch (every matrix masked off) waits for one load, not for B /
//   clusters loads in a row.
//
// Shared memory: Y's slots (a slot of p W floats a box, rounded up to 128
// bytes), two sets of published (PB, PB) grams, the summed gram, a zero
// row, the warps' partials and an mbarrier a box. out may alias x: a CTA
// reads its columns before it writes them, and writes only its own.

// Floats past Y's slots: the two published sets and the summed gram (PB^2
// each), the zero row and the warps' partials.
__host__ __device__ inline int ns_extra_floats(int PB) {
  return 3 * PB * PB + kSpBoxCols + kWarps * 16;
}

__host__ __device__ inline int ns_smem_bytes(int p, int n, int c) {
  const SpLayout L = sp_layout(p, n, c);
  return L.nbox * L.sbox + 4 * ns_extra_floats(round4(p)) + 8 * L.nbox + 1024;
}

// Whole columns a thread takes in Newton-Schulz's rounds: Y alone is in
// registers, so twice small_p_kernel's sp_cols.
__host__ __device__ constexpr int ns_cols(int PB) { return PB <= 16 ? 4 : 2; }

// The CTAs an SM the Newton-Schulz kernel's registers are capped for: two
// to PB = 12; past it the gram's off-diagonal pairs (two blocks' rows and
// sums) spilled at 128 registers (PB = 16-28 on an H100), so one.
__host__ __device__ constexpr int ns_ctas_per_sm(int PB) { return PB <= 12 ? 2 : 1; }

// Blocks of block row bi in the circulant cover of an nb x nb grid of 4 x 4
// blocks: (bi, (bi + d) % nb) for d < ns_row_blocks(nb, bi) covers every
// block on and above the diagonal, or its mirror, once.
__host__ __device__ constexpr int ns_row_blocks(int nb, int bi) {
  return nb % 2 ? (nb + 1) / 2 : bi < nb / 2 ? nb / 2 + 1 : nb / 2;
}

// The gram's items (a thread's share): each row's blocks in pairs that
// share the row's four rows, the nb pairs holding a diagonal block first.
__host__ __device__ constexpr int ns_items(int nb) {
  int t = 0;
  for (int bi = 0; bi < nb; ++bi) t += (ns_row_blocks(nb, bi) + 1) / 2;
  return t;
}

// Item `item`'s block row bi and its blocks' columns bj1, bj2 (-1: none).
__device__ inline void ns_item(int item, int nb, int& bi, int& bj1, int& bj2) {
  if (item < nb) {
    bi = bj1 = item;
    bj2 = ns_row_blocks(nb, item) > 1 ? (item + 1) % nb : -1;
    return;
  }
  item -= nb;
  for (bi = 0; bi < nb - 1 && item >= (ns_row_blocks(nb, bi) - 1) / 2; ++bi)
    item -= (ns_row_blocks(nb, bi) - 1) / 2;
  const int d = 2 * item + 2;
  bj1 = (bi + d) % nb;
  bj2 = d + 1 < ns_row_blocks(nb, bi) ? (bi + d + 1) % nb : -1;
}

// acc[16 k + 4 r + c] += sum_q Y[4 bi + r, q] Y[4 bj_k + c, q] (k = 0, 1)
// over the column quads s, s + S, ... of `boxes` row-major (p, W) boxes
// sboxf floats apart, counted box after box; rows past p and a missing
// block (bj = -1) read the zero row. With kDiag (bj_0 = bi) the first
// block's rows are loaded once and only its entries r <= c are summed
// (ns_meet mirrors them). The second block's rows reuse the first's
// registers.
template <bool kDiag>
__device__ inline void ns_gram_pair(float (&acc)[32], const float* Y, int sboxf, int boxes,
                                    int bi, int bj1, int bj2, int p, int W, const float* zrow,
                                    int s, int S) {
  const float* u[4];
  const float* v[4];
  const float* w[4];
  int mu = 0, mv = 0, mw = 0;  // bit r: row r of the block lies in the boxes
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    u[r] = 4 * bi + r < p ? Y + (4 * bi + r) * W : zrow;
    v[r] = 4 * bj1 + r < p ? Y + (4 * bj1 + r) * W : zrow;
    w[r] = bj2 >= 0 && 4 * bj2 + r < p ? Y + (4 * bj2 + r) * W : zrow;
    mu |= (4 * bi + r < p) << r;
    mv |= (4 * bj1 + r < p) << r;
    mw |= (bj2 >= 0 && 4 * bj2 + r < p) << r;
  }
  const int wq = W / 4;
  int box = 0, q = s;
  while (q >= wq) {
    q -= wq;
    ++box;
  }
#pragma unroll 2
  for (; box < boxes;) {
    const int at = 4 * q, bat = box * sboxf + at;  // the zero row takes no box offset
    float a[4][4], b[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) load4(a[r], lds4(u[r] + (mu >> r & 1 ? bat : at)));
    if (kDiag) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = r; k < 4; ++k)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[4 * r + k] = fmaf(a[r][e], a[k][e], acc[4 * r + k]);
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) load4(b[r], lds4(v[r] + (mv >> r & 1 ? bat : at)));
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[4 * r + k] = fmaf(a[r][e], b[k][e], acc[4 * r + k]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) load4(b[r], lds4(w[r] + (mw >> r & 1 ? bat : at)));
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[16 + 4 * r + k] = fmaf(a[r][e], b[k][e], acc[16 + 4 * r + k]);
    for (q += S; q >= wq; q -= wq) ++box;
  }
}

// out = the sum of every CTA's `pub` (count floats, count % 4 == 0) in rank
// order, as cluster_sum adds them (the same bits), a thread's c loads in
// flight at once.
__device__ inline void ns_sum(const float* pub, float* out, int count, int c, int rank) {
  for (int e = 4 * threadIdx.x; e < count; e += 4 * kThreads) {
    float4 v[kSpMaxCluster];
#pragma unroll
    for (int k = 0; k < kSpMaxCluster; ++k)
      if (k < c)
        v[k] = k == rank ? lds4(pub + e) : hopper::ld_peer4(hopper::map_peer(pub + e, k));
    float4 t = v[0];
#pragma unroll
    for (int k = 1; k < kSpMaxCluster; ++k)
      if (k < c) {
        t.x += v[k].x;
        t.y += v[k].y;
        t.z += v[k].z;
        t.w += v[k].w;
      }
    *reinterpret_cast<float4*>(out + e) = t;
  }
}

// One group of KC whole columns of Y (yb: its first column in the boxes; G
// row-major (PB, PB)): Y' = 1.5 Y - 0.5 G Y (Y as it is with `apply`
// false), each row over the boxes (`keep`) and to HBM at `hbm` (its first
// element, row stride n; null: not there). With `first` the boxes hold X,
// read as X / f.
template <int PB, int KC>
__device__ __forceinline__ void ns_group(float* yb, const float* G, bool first, float f,
                                         bool apply, bool keep, int p, int n, int W, float* hbm,
                                         const float* zrow) {
  float y[PB][KC];
#pragma unroll
  for (int i = 0; i < PB; ++i) {
    ld_cols(y[i], i < p ? yb + i * W : zrow);
    if (first)
#pragma unroll
      for (int c = 0; c < KC; ++c) y[i][c] = y[i][c] / f;
  }
#pragma unroll
  for (int r = 0; r < (sp_rolled(PB) ? 1 : PB); ++r)
  for (int i = r; i < (sp_rolled(PB) ? p : r + 1); ++i) {
    if (i >= p) continue;
    float gy[KC] = {};
    if (apply)
#pragma unroll
      for (int j4 = 0; j4 < PB / 4; ++j4) {
        float gv[4];
        load4(gv, lds4(G + i * PB + 4 * j4));
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int c = 0; c < KC; ++c) gy[c] = fmaf(gv[q], y[4 * j4 + q][c], gy[c]);
      }
    float yi[KC], o[KC];
    if constexpr (sp_rolled(PB)) {
      ld_cols(yi, yb + i * W);
      if (first)
#pragma unroll
        for (int c = 0; c < KC; ++c) yi[c] = yi[c] / f;
    } else {
#pragma unroll
      for (int c = 0; c < KC; ++c) yi[c] = y[i][c];
    }
#pragma unroll
    for (int c = 0; c < KC; ++c) o[c] = apply ? 1.5f * yi[c] - 0.5f * gy[c] : yi[c];
    if (keep) st_cols(yb + i * W, o);
    if (hbm != nullptr) st_cols(hbm + static_cast<size_t>(i) * n, o);
  }
}

// This thread's share of the gram (its item's blocks (bi, bj1) and (bi,
// bj2)) over `boxes` boxes from Y, added to acc.
__device__ __forceinline__ void ns_box_gram(float (&acc)[32], const float* Y, int sboxf,
                                            int boxes, bool act, int bi, int bj1, int bj2, int p,
                                            int W, const float* zrow, int s, int S) {
  if (!act) return;
  if (bj1 == bi)
    ns_gram_pair<true>(acc, Y, sboxf, boxes, bi, bj1, bj2, p, W, zrow, s, S);
  else
    ns_gram_pair<false>(acc, Y, sboxf, boxes, bi, bj1, bj2, p, W, zrow, s, S);
}

// The CTA's gram partial (acc, S lanes an item) published into `set`, a
// cluster barrier, and the cluster's sum into G (the same bits in every
// CTA).
template <int S>
__device__ __forceinline__ void ns_meet(const float (&acc)[32], bool act, int bi, int bj1,
                                        int bj2, int p, int PB, float* set, float* G,
                                        float* part, int c, int rank) {
  float acc0[16], acc1[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    acc0[e] = acc[e];
    acc1[e] = acc[16 + e];
  }
  if (bj1 == bi)  // the diagonal block's sums below its diagonal: their mirrors
#pragma unroll
    for (int r = 1; r < 4; ++r)
#pragma unroll
      for (int k = 0; k < r; ++k) acc0[4 * r + k] = acc0[4 * k + r];
  publish<S>(acc0, act, false, bi, bj1, p, PB, set, nullptr, part);
  if (S > 32) __syncthreads();  // every warp's partials of the first block are read
  publish<S>(acc1, act && bj2 >= 0, false, bi, bj2 < 0 ? 0 : bj2, p, PB, set, nullptr, part);
  hopper::cluster_sync();
  ns_sum(set, G, PB * PB, c, rank);
  __syncthreads();
}

// One cluster of c CTAs a matrix; grid (clusters) x c.
template <int PB>
__global__ void __launch_bounds__(kThreads, ns_ctas_per_sm(PB))
small_p_ns_kernel(const __grid_constant__ CUtensorMap tm_x, float* out,
                  const unsigned char* mask, float* dist, int B, int p, int n, int iters,
                  int c) {
  extern __shared__ unsigned char small_p_smem[];
  constexpr int KC = ns_cols(PB), nb = PB / 4, S = sp_lanes(ns_items(nb));
  unsigned char* sm = hopper::smem_align1024(small_p_smem);
  const SpLayout L = sp_layout(p, n, c);
  const int W = L.W, sboxf = L.sbox / 4, tid = threadIdx.x;
  const int rank = static_cast<int>(hopper::cluster_rank());
  const int col_lo = rank * L.nc;
  const int live = col_lo >= n ? 0 : min(L.nbox, (n - col_lo + W - 1) / W);  // boxes before n
  float* YS = reinterpret_cast<float*>(sm);
  float* pub = YS + L.nbox * sboxf;  // two published sets, then the summed gram
  float* Gs = pub + 2 * PB * PB;
  float* zrow = Gs + PB * PB;
  float* part = zrow + kSpBoxCols;
  uint64_t* bar = reinterpret_cast<uint64_t*>(part + kWarps * 16);
  const uint32_t box_bytes = static_cast<uint32_t>(p * W * 4);
  const int cl = blockIdx.x / c, ncl = gridDim.x / c;
  const CUtensorMap* const map = &tm_x;  // closures copy this, never the map
  const int rounds = iters > 0 ? iters : 1;  // iters = 0: one round storing X / f

  // This thread's gram item, S lanes each.
  const int item = tid / S, s = tid % S;
  const bool act = item < ns_items(nb);
  int bi = 0, bj1 = 0, bj2 = -1;
  if (act) ns_item(item, nb, bi, bj1, bj2);

  if (tid == 0) {
    for (int j = 0; j < L.nbox; ++j) hopper::mbar_init(bar + j, 1);
    hopper::mbar_fence_init();
  }
  for (int e = tid; e < kSpBoxCols; e += kThreads) zrow[e] = 0.f;
  __syncthreads();

  // The first matrix at or after b (stepping by the clusters) that the mask
  // keeps; B when none. Every thread calls it: the CTA reads kThreads of
  // the mask's bytes at once, and each warp's least kept index meets the
  // others' in `red` (the warps' partials, free between grams).
  int* const red = reinterpret_cast<int*>(part);
  auto kept = [=](int b) {
    if (mask == nullptr) return min(b, B);
    for (; b < B; b += kThreads * ncl) {
      const int mine = b + tid * ncl;
      int first = mine < B && mask[mine] != 0 ? mine : B;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) first = min(first, __shfl_xor_sync(~0u, first, o));
      if (tid % 32 == 0) red[tid / 32] = first;
      __syncthreads();
      first = B;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) first = min(first, red[w]);
      __syncthreads();  // every thread has read red
      if (first < B) return first;
    }
    return B;
  };
  // Boxes [j0, j1) of matrix b into their slots, each on its mbarrier.
  auto issue = [=](int b, int j0, int j1) {
    for (int j = j0; j < j1; ++j) {
      hopper::mbar_expect_tx(bar + j, box_bytes);
      hopper::tma_load_4d(YS + j * sboxf, map, bar + j, col_lo + j * W, 0, b, 0);
    }
  };
  uint32_t gk = 0;  // grams met so far: their published set alternates

  int b = kept(cl);
  if (tid == 0 && b < B) issue(b, 0, live);
  for (int it = 0; b < B; ++it) {
    const uint32_t ph = it & 1;
    const int bn = kept(b + ncl);
    float* const yout = out + static_cast<size_t>(b) * p * n;

    // 1. X X^T, each box as it lands; f from its trace, and G of Y_0.
    float acc[32] = {};
    for (int j = 0; j < live; ++j) {
      hopper::mbar_wait(bar + j, ph);
      ns_box_gram(acc, YS + j * sboxf, sboxf, 1, act, bi, bj1, bj2, p, W, zrow, s, S);
    }
    ns_meet<S>(acc, act, bi, bj1, bj2, p, PB, pub + (gk++ & 1) * PB * PB, Gs, part, c, rank);
    float tr = 0.f;
    for (int i = 0; i < p; ++i) tr += Gs[i * PB + i];
    const float f = fmaxf(sqrtf(tr), 1e-30f);
    __syncthreads();  // every thread has read the diagonal
    for (int e = tid; e < PB * PB; e += kThreads) Gs[e] = Gs[e] / f / f;
    __syncthreads();

    // 2. An update round over the boxes an iteration, then the new
    // iterate's gram (after the last only for the distance).
    for (int k = 0; k < rounds; ++k) {
      const bool last = k + 1 == rounds;
      const bool gram = !last || (dist != nullptr && iters > 0);
      const int per = W / KC, total = live * per;
      int finished = 0;
      for (int u0 = 0; u0 < total; u0 += kThreads) {
        const int u = u0 + tid, j = u / per, cb = (u - j * per) * KC;
        const int col = col_lo + j * W + cb;
        if (u < total && col < n)
          ns_group<PB, KC>(YS + j * sboxf + cb, Gs, k == 0, f, iters > 0, gram, p, n, W,
                           last ? yout + col : nullptr, zrow);
        if (!gram) {  // each finished box takes the next matrix's load
          const int now = min(total, u0 + kThreads) / per;
          hopper::fence_proxy_async_smem();
          __syncthreads();
          if (tid == 0 && bn < B) issue(bn, finished, now);
          finished = now;
        }
      }
      if (!gram) break;
      __syncthreads();  // Y' is the gram's operand
      float accy[32] = {};
      ns_box_gram(accy, YS, sboxf, live, act, bi, bj1, bj2, p, W, zrow, s, S);
      if (last) {  // the boxes take the next matrix's loads
        hopper::fence_proxy_async_smem();
        __syncthreads();
        if (tid == 0 && bn < B) issue(bn, 0, live);
      }
      ns_meet<S>(accy, act, bi, bj1, bj2, p, PB, pub + (gk++ & 1) * PB * PB, Gs, part, c, rank);
    }
    if (dist != nullptr && rank == 0 && tid < 32) sp_residual(Gs, PB, p, p, dist + b);
    b = bn;
  }
  hopper::cluster_sync();  // no CTA leaves while a peer may read its shared memory
}

const void* ns_kernel(int PB) {
  using K = const void*;
  switch (PB) {
    case 4: return K(small_p_ns_kernel<4>);
    case 8: return K(small_p_ns_kernel<8>);
    case 12: return K(small_p_ns_kernel<12>);
    case 16: return K(small_p_ns_kernel<16>);
    case 20: return K(small_p_ns_kernel<20>);
    case 24: return K(small_p_ns_kernel<24>);
    case 28: return K(small_p_ns_kernel<28>);
    case 32: return K(small_p_ns_kernel<32>);
    default: return nullptr;
  }
}

// A tensor map over x and the cluster launch.
int ns_launch(const float* x, float* out, const unsigned char* mask, float* dist, int B, int p,
              int n, int iters, int c, void* stream) {
  if (B < 0 || p < 1 || p > kSpMaxP || n < 4 || n % 4 != 0 || iters < 0 ||
      (c != 2 && c != 4 && c != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const SpLayout L = sp_layout(p, n, c);
  const int smem = ns_smem_bytes(p, n, c);
  const void* rows[] = {x, out};
  if (L.nbox > kSpMaxBoxes || smem > kSmemLimit || !vector_ok(n, rows, 2))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaGetLastError());
  CUtensorMap map = {};
  const int merr = rows_map(&map, x, B, p, n, L.W);
  if (merr != 0) return merr;
  void* args[] = {&map, &out, &mask, &dist, &B, &p, &n, &iters, &c};
  return cluster_launch(ns_kernel(round4(p)), c, smem, B, args, stream);
}

}  // namespace

extern "C" {

// The cluster size the entries below take for (p, n) (0: none fits) and one
// CTA's dynamic shared memory at cluster size c (ops.py mirrors both).
int small_p_cluster(int p, int n) {
  return p < 1 || p > kSpMaxP || n < 4 || n % 4 != 0 ? 0 : sp_cluster(p, n);
}

int small_p_smem_bytes(int p, int n, int c) { return sp_smem_bytes(p, n, c); }

// The fused step, method 0 POGO or 1 Landing: fused_step_tiled's arguments
// without tile_n, p <= 32, n % 4 == 0, every operand 16-byte aligned; c CTAs
// a cluster, 0 for small_p_cluster(p, n).
int fused_step_cluster(const float* x, const float* g, const float* mu, const float* nu,
                       const float* scal, const int* pv, float* x_out, float* mu_out,
                       float* nu_out, float* dist, int B, int p, int n, int base_kind,
                       int nesterov, int method, int c, void* stream) {
  if (method != kPogo && method != kLanding) return static_cast<int>(cudaErrorInvalidValue);
  return sp_launch(method, x, g, mu, nu, scal, pv, x_out, mu_out, nu_out, dist, B, p, n,
                   base_kind, nesterov, c ? c : small_p_cluster(p, n), stream);
}

// The two-stage POGO update X' = (1 + lam) M - lam (M M^T) M, M = X - eta/2
// (A G - B X), into out (which may be x, never g); scal = [eta, lam, ...];
// c as above.
int pogo_update_cluster(const float* x, const float* g, const float* scal, float* out, int B,
                        int p, int n, int c, void* stream) {
  return sp_launch(kSpUpdate, x, g, nullptr, nullptr, scal, nullptr, out, nullptr, nullptr,
                   nullptr, B, p, n, kNone, 0, c ? c : small_p_cluster(p, n), stream);
}

// Landing's field Lambda = 1/2 (A G - B X) + lam (A X - X) into out (which
// may be x, never g); scal = [eta (unused), lam, ...]; c as above.
int landing_field_cluster(const float* x, const float* g, const float* scal, float* out, int B,
                          int p, int n, int c, void* stream) {
  return sp_launch(kSpField, x, g, nullptr, nullptr, scal, nullptr, out, nullptr, nullptr,
                   nullptr, B, p, n, kNone, 0, c ? c : small_p_cluster(p, n), stream);
}

// Newton-Schulz's cluster size for (p, n) (0: none holds Y) and one CTA's
// dynamic shared memory at cluster size c (ops.py mirrors both): as
// small_p_cluster's, counting Y's slots alone.
int ns_cluster_smem_bytes(int p, int n, int c) { return ns_smem_bytes(p, n, c); }

int ns_cluster(int p, int n) {
  return p < 1 || p > kSpMaxP || n < 4 || n % 4 != 0
             ? 0
             : sp_least_cluster(p, n, ns_smem_bytes, ns_ctas_per_sm(round4(p)));
}

// The clusters of c CTAs the card keeps resident at once for
// newton_schulz_cluster at (p, n), the persistent grid's width; -1 where the
// kernel does not take (p, n, c), or minus the CUDA error of the query.
int ns_cluster_max_clusters(int p, int n, int c) {
  if (p < 1 || p > kSpMaxP || n < 4 || n % 4 != 0 || (c != 2 && c != 4 && c != 8) ||
      ns_smem_bytes(p, n, c) > kSmemLimit || sp_layout(p, n, c).nbox > kSpMaxBoxes)
    return -1;
  return resident_clusters(ns_kernel(round4(p)), c, ns_smem_bytes(p, n, c));
}

// x, out: (B, p, n) fp32, p <= 32, n % 4 == 0, both 16-byte aligned (out
// may be x); mask: (B,) bytes or null (every matrix); dist: (B,) fp32
// written for the matrices processed, or null. Clusters of ns_cluster(p,
// n) CTAs, or (the _c entry) of c.
int newton_schulz_cluster_c(const float* x, float* out, const unsigned char* mask, float* dist,
                            int B, int p, int n, int iters, int c, void* stream) {
  return ns_launch(x, out, mask, dist, B, p, n, iters, c, stream);
}

int newton_schulz_cluster(const float* x, float* out, const unsigned char* mask, float* dist,
                          int B, int p, int n, int iters, void* stream) {
  return ns_launch(x, out, mask, dist, B, p, n, iters, ns_cluster(p, n), stream);
}

}  // extern "C"
