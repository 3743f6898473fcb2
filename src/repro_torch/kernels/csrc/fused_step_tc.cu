// Tiled fused POGO and Landing group steps for Hopper (sm_90a) on the
// tensor cores: 3xTF32 wgmma products fed by a TMA ring, for p <= 64 and
// (the wide kernel, below fused_tc_kernel) 64 < p <= 128; and, from the
// same kernels with no base stage and no telemetry, the two-stage POGO
// update and landing field (p <= 128).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/:
//   fused_step_tiled_tc          <- fused_step.py:608 fused_step_tiled:
//                                   _t1_kernel (:476), _t2_pogo_kernel (:530),
//                                   pogo_update._phase3_kernel (:133) and the
//                                   (p, p) telemetry products left to XLA there
//   fused_step_tiled_tc_landing  <- _t1_kernel + _t2_landing_kernel (:559),
//                                   via fused_step_tiled's Landing branch (:701)
//   pogo_update_tiled_tc         <- pogo_update.py:143 pogo_update_tiled
//                                   (_phase1/2/3_kernel :91/:110/:133): three
//                                   sweeps, 7 HBM passes
//   landing_field_tiled_tc       <- landing_field.py:79 landing_field_tiled
//                                   (_phase1_kernel + _field_tile_kernel :65):
//                                   two sweeps, 5 HBM passes
//   fused_step_tiled_tc128(_landing), pogo_update_tiled_tc128,
//   landing_field_tiled_tc128    <- the same TPU kernels for 64 < p <= 128
//                                   (fused_tc_wide_kernel)
// It computes what kernels/ref.py::fused_group_step_ref computes, and what
// the CUDA-core kernels of fused_step.cu compute (their header has the
// algebra): the base stage none | trace (+nesterov) | vadam with mu' and
// nu' written once; A = X X^T and B = X Geu^T; then POGO's leap, land gram
// C = M M^T, land and gram-identity distance, or Landing's fixed step and
// the distance from the direct gram of X'.
//
// Bound, at SmolLM-360M's 640 x (64, 960): the function moves 5 HBM passes
// of 4 p n bytes a matrix (read X, g, mu; write X', mu'), 0.2348 ms at
// 3.35 TB/s; its six p x p x n products are 30.2 GFLOP, three TF32
// products each here (90.6 GFLOP, 0.1830 ms at 495 TFLOP/s). The three
// sweeps below move 9 passes (POGO) or 7 (Landing): 0.4226 and 0.3287 ms.
// At internlm2-1.8b's 576 x (128, 2048) (the wide kernel): 5 passes
// 0.9015 ms, the 3xTF32 products 695.8 GFLOP, 1.4056 ms, which bound it;
// its schedule moves 11.5 passes (POGO, 2.0752 ms), 10 (Landing), 9.5
// (the two-stage update) or 7 (the field, 1.2620 ms: its 3xTF32 work, 8
// p^2 n x 3 = 0.9371 ms, and its 3 passes, 0.5409, bound it).
//
// Design:
// * fp32 accuracy on the tensor cores: an operand x is split as hi =
//   tf32(x), lo = tf32(x - hi); a product sums hi.lo and lo.hi, then
//   hi.hi (small terms first), dropping lo.lo (2^-22 relative). The card
//   reads an fp32 operand with its low 13 bits dropped (tf32_probe), so a
//   tile that holds x itself (X and Geu in sweep 1, M in sweep 2) is its
//   own hi, trunc(x), and only lo = tf32(x - trunc(x)) is written (lo.lo
//   then 2^-20 relative). Each chunk's products start from zero and are
//   added to fp32 sums in registers, so the tensor cores' accumulation
//   rounding (toward zero) acts on 64-column partials only. The leap and
//   the land are written as X plus a small correction, M = X + D and
//   X' = M - lam (C - I) M, so that only the correction passes through
//   the tensor cores; the telemetry is the gram identity expanded in
//   E = C - I:
//   X' X'^T - I = (1 - 2 lam) E + (lam^2 - 2 lam) E^2 + lam^2 E^3.
// * TF32 wgmma takes K-major shared-memory operands only. The grams (K =
//   the columns) read row-major X, Geu and M tiles as they are. The leap
//   and the land run transposed, one 64-column chunk as the wgmma M side:
//   M^T = X^T + Geu^T P + X^T Q and X'^T = M^T - lam M^T E, with Geu^T,
//   X^T and M^T register A operands read from the tile, and the (p, p)
//   operands P = -(c/2) A, Q = (c/2) B^T [- eta lam (A - I) for Landing]
//   (c = eta s, s the Geu scale) and E written by the kernel, hi and lo,
//   in the layout the descriptor wants. M goes back through its tile (for
//   the C gram and the store).
// * One CTA per SM, persistent over the matrices (b = blockIdx.x, +
//   gridDim.x, ...): a producer warpgroup, one lane of which keeps a ring
//   of kTcSlots operand tiles (a 64-column chunk of X, g, mu, mu' or M: two
//   TMA boxes of 64 rows x 32 fp32 columns, 128-byte swizzled, rows past p
//   and columns past n zero-filled) in flight on mbarriers, across sweeps
//   and into the next matrix; a chunk takes as many slots as it has
//   operands, so the ring holds two chunks ahead in sweep 1 (X, g, mu),
//   three in sweep 2 (X, mu') and six in sweep 3 (M). One consumer
//   warpgroup runs the base stage, the splits, the wgmma and the stores.
//   mu', M and X' are written into the tile they came from and leave
//   through TMA stores (plain stores on the plain-load path). Where
//   n % 4 != 0 (a row stride TMA cannot take) the whole producer
//   warpgroup loads the tiles with plain loads instead. A sweep that reads
//   what the previous one wrote (mu', then M) starts loading once the
//   consumer has signalled the end of that sweep.
// * Sweeps, each over 64-column chunks: (1) the moments, mu' stored, the
//   lo tiles of X and Geu, A and B; (2) POGO's M (stored in x_out) and C,
//   or Landing's X' (final) and W = C; then the (p, p) tail on the tensor
//   cores, E^2 and E^3 (POGO) or W - I (Landing), summed in a fixed
//   order; (3) POGO's land from the M read back.
// * The splits round by integer operations, which the card ran faster
//   than cvt.rna.tf32.f32.
// * Registers: two warpgroups of 256 threads may hold 255 registers a
//   thread, so nothing is moved with setmaxnreg. Two consumer warpgroups
//   taking chunks in turns ran 3-6% faster on the card, but need 232
//   registers each, which leaves the producer's warpgroup 40 (a block of
//   384 threads is launched at 168) and makes it spill.
//
// Shared memory: the ring (6 x 16 KB), two lo tiles (32 KB), four (p, p)
// operand tiles (64 KB), the reduction scratch and the barriers. Scalars
// ride scal[8] = [eta, lam, post_scale, h0..h4] as in fused_step.cu.
// Outputs may alias inputs (x_out == x, mu_out == mu, nu_out == nu). The
// launcher returns cudaGetLastError(), or a tensor map's error.

#include "hopper.cuh"
#include "tf32_tile.cuh"
#include "tiles.cuh"

namespace {

constexpr int kTcOps = 3;                         // most operand tiles of a chunk
constexpr int kTcSlots = 6;                       // operand tiles in the ring
constexpr int kTcConsumers = 128;                 // one warpgroup
constexpr int kTcThreads = kTcConsumers + 128;    // and the producer's
constexpr int kTcLoOff = kTcSlots * kTcTileBytes;
constexpr int kTcGramOff = kTcLoOff + 2 * kTcTileBytes;
constexpr int kTcRedOff = kTcGramOff + 4 * kTcTileBytes;
constexpr int kTcBarOff = kTcRedOff + 64;
constexpr int kTcBars = 2 * kTcSlots + 1;         // full, empty, end of sweep
constexpr int kTcSmemBytes = kTcBarOff + 8 * kTcBars + 1024;  // + room to align
constexpr int kConsumerBar = 1, kProducerBar = 2;  // named barriers

// Sum over the consumer warpgroup, the same on every consumer thread, in
// a fixed order.
__device__ float wg_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  hopper::named_sync(kConsumerBar, kTcConsumers);  // red may still be read
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  hopper::named_sync(kConsumerBar, kTcConsumers);
  return (red[0] + red[1]) + (red[2] + red[3]);
}

// Issues d = A B^T over K = 64 from the hi/lo smem tiles of A and B
// (3xTF32, small terms first); the caller fences, commits and waits.
__device__ inline void gram_issue(float (&d)[32], const unsigned char* ah,
                                  const unsigned char* al, const unsigned char* bh,
                                  const unsigned char* bl) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    hopper::wgmma_tf32_ss(d, tc_desc(ah, kk), tc_desc(bl, kk), kk > 0);
    hopper::wgmma_tf32_ss(d, tc_desc(al, kk), tc_desc(bh, kk), 1);
  }
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    hopper::wgmma_tf32_ss(d, tc_desc(ah, kk), tc_desc(bh, kk), 1);
}

// d = A B^T as gram_issue, waited for.
__device__ inline void gram_tc(float (&d)[32], const unsigned char* ah, const unsigned char* al,
                               const unsigned char* bh, const unsigned char* bl) {
  hopper::fence_regs(d);
  hopper::wgmma_fence();
  gram_issue(d, ah, al, bh, bl);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(d);
}

// d (+)= T^T B, T^T the (64 chunk columns, K = 64 rows) register operand
// whose element (m, k) is val(k, m), B the hi/lo smem tiles; waits.
template <typename Val>
__device__ inline void product_t(float (&d)[32], Val val, const unsigned char* bh,
                                 const unsigned char* bl, int accumulate) {
  const int t = threadIdx.x, m0 = 16 * (t >> 5) + ((t & 31) >> 2), k0 = t & 3;
  uint32_t fh[8][4], fl[8][4];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float hi, lo;
      split(val(8 * kk + k0 + 4 * (r >> 1), m0 + 8 * (r & 1)), hi, lo);
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
    hopper::wgmma_tf32_rs(d, fh[kk][0], fh[kk][1], fh[kk][2], fh[kk][3], tc_desc(bl, kk),
                          accumulate || kk > 0);
    hopper::wgmma_tf32_rs(d, fl[kk][0], fl[kk][1], fl[kk][2], fl[kk][3], tc_desc(bh, kk), 1);
  }
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    hopper::wgmma_tf32_rs(d, fh[kk][0], fh[kk][1], fh[kk][2], fh[kk][3], tc_desc(bh, kk), 1);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(d);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    hopper::fence_regs(fh[kk]);
    hopper::fence_regs(fl[kk]);
  }
}

// Writes v (the accumulator layout) into the hi/lo tiles at (row, col).
__device__ inline void store_split(const float (&v)[32], unsigned char* hi_t, unsigned char* lo_t) {
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    float hi, lo;
    split(v[i], hi, lo);
    tc_at(hi_t, acc_row(t, i), acc_col(t, i)) = hi;
    tc_at(lo_t, acc_row(t, i), acc_col(t, i)) = lo;
  }
}

// The consumer's view of the ring: operand tile `tt` of the sequence the
// producer loads, waited for, and its release once every warp is done.
__device__ inline unsigned char* tile_wait(unsigned char* ring, uint64_t* full, int tt) {
  hopper::mbar_wait(full + tt % kTcSlots, (tt / kTcSlots) & 1);
  return ring + (tt % kTcSlots) * kTcTileBytes;
}

__device__ inline void tiles_release(uint64_t* empty, int tt, int count) {
  if ((threadIdx.x & 31) == 0)
    for (int o = 0; o < count; ++o) hopper::mbar_arrive(empty + (tt + o) % kTcSlots);
}

// Chunk c of matrix b from a tile to HBM through TMA (its two boxes), one
// thread; rows past p and columns past n are clipped. Committed here; the
// caller waits before the tile is reused.
__device__ inline void tile_store(const CUtensorMap* map, const unsigned char* tile, int c, int b) {
  for (int bx = 0; bx < 2; ++bx)
    hopper::tma_store_4d(map, tile + bx * kTcBoxBytes, c * kTcChunk + 32 * bx, 0, b, 0);
  hopper::bulk_commit();
}

// Makes the consumers' shared-memory writes visible to the next wgmma.
__device__ inline void publish_smem() {
  hopper::fence_proxy_async_smem();
  hopper::named_sync(kConsumerBar, kTcConsumers);
}

// One 64-column chunk of a row-major (rows, n) matrix into a tile by plain
// loads over the producer warpgroup (thread pt of 128), zero past rows and n.
__device__ inline void load_tile_plain(unsigned char* tile, const float* src, int rows, int n,
                                       int c0, int pt) {
  for (int u = pt; u < kTcP * kTcChunk; u += 128) {
    const int row = u >> 6, col = u & 63;
    const float v = row < rows && c0 + col < n ? src[static_cast<size_t>(row) * n + c0 + col] : 0.f;
    tc_at(tile, row, col) = v;
  }
}

// kTwoStage: the two-stage kernels of two_stage.cu's two functions, from
// the same sweeps with no base stage and no telemetry. POGO
// (pogo_update_tc) writes X' = M - lam (C - I) M over M parked in x_out;
// the field (landing_field_tc, kMethod == kLanding) writes Lambda alone
// in sweep 2, as eta = -1 in Landing's step with the (1/2) G term of
// P = A/2 added in fp32: Lambda^T = G^T/2 + G^T (E_A/2) + X^T Q, Q =
// -B^T/2 + lam E_A, E_A = A - I. Neither reads mu, nu or pv, nor writes
// dist.
template <int kMethod, bool kTwoStage = false>
__global__ void __launch_bounds__(kTcThreads, 1)
fused_tc_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_g,
                const __grid_constant__ CUtensorMap tm_mu,
                const __grid_constant__ CUtensorMap tm_mu_out,
                const __grid_constant__ CUtensorMap tm_x_out, const float* x, const float* g,
                const float* mu, const float* nu, const float* scal, const int* pv, float* x_out,
                float* mu_out, float* nu_out, float* dist, int B, int p, int n, int base_kind,
                int nesterov, int tma, int vec) {
  extern __shared__ unsigned char fused_tc_smem[];
  const uint32_t pad = (1024u - (hopper::smem_u32(fused_tc_smem) & 1023u)) & 1023u;
  unsigned char* ring = fused_tc_smem + pad;
  unsigned char* lo0 = ring + kTcLoOff;  // X lo | M lo
  unsigned char* lo1 = lo0 + kTcTileBytes;  // Geu lo
  unsigned char* gram = ring + kTcGramOff;  // P hi, P lo, Q hi, Q lo | E hi, E lo, E^2 hi, E^2 lo
  float* red = reinterpret_cast<float*>(ring + kTcRedOff);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kTcBarOff);
  uint64_t* empty = full + kTcSlots;
  uint64_t* swept = empty + kTcSlots;
  constexpr bool kField = kTwoStage && kMethod == kLanding;
  if (kTwoStage) base_kind = kNone, nesterov = 0;
  const int tid = threadIdx.x;
  const int nc = (n + kTcChunk - 1) / kTcChunk;
  const int sweeps = kMethod == kPogo ? 3 : 2;
  const bool nest = base_kind == kTrace && nesterov;

  if (tid == 0) {
    for (int s = 0; s < kTcSlots; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, kTcConsumers / 32);  // one arrival per consumer warp
    }
    hopper::mbar_init(swept, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kTcConsumers) {  // the producer's warpgroup
    const int pt = tid - kTcConsumers;
    if (tma && pt != 0) return;  // one lane issues every TMA load
    int tt = 0, waits = 0;  // tiles issued, end-of-sweep waits
    for (int b = blockIdx.x; b < B; b += gridDim.x) {
      for (int sw = 0; sw < sweeps; ++sw) {
        // mu', then M, are in HBM; order that before these TMA reads (the
        // two-stage sweep 2 reads X and G, which nothing writes: no wait)
        if (sw == 2 || (sw == 1 && !kTwoStage)) {
          hopper::mbar_wait(swept, waits++ & 1);
          hopper::fence_proxy_async();
        }
        // the operands of this sweep's stages
        const CUtensorMap* maps[kTcOps];
        const float* srcs[kTcOps];
        int ops = 0;
        if (sw < 2) {
          maps[ops] = &tm_x;
          srcs[ops++] = x;
        }
        if (sw == 0) {
          maps[ops] = &tm_g;
          srcs[ops++] = g;
          if (base_kind != kNone) {
            maps[ops] = &tm_mu;
            srcs[ops++] = mu;
          }
        } else if (sw == 1) {
          maps[ops] = base_kind == kNone ? &tm_g : &tm_mu_out;
          srcs[ops++] = base_kind == kNone ? g : mu_out;
          if (nest) {
            maps[ops] = &tm_g;
            srcs[ops++] = g;
          }
        } else {
          maps[ops] = &tm_x_out;
          srcs[ops++] = x_out;
        }
        for (int c = 0; c < nc; ++c) {
          for (int o = 0; o < ops; ++o, ++tt) {
            const int s = tt % kTcSlots;
            if (tt >= kTcSlots) hopper::mbar_wait(empty + s, (tt / kTcSlots - 1) & 1);
            unsigned char* st = ring + s * kTcTileBytes;
            if (tma) {
              hopper::mbar_expect_tx(full + s, kTcTileBytes);
              for (int bx = 0; bx < 2; ++bx)
                hopper::tma_load_4d(st + bx * kTcBoxBytes, maps[o], full + s,
                                    c * kTcChunk + 32 * bx, 0, b, 0);
            } else {
              load_tile_plain(st, srcs[o] + static_cast<size_t>(b) * p * n, p, n, c * kTcChunk,
                              pt);
              hopper::named_sync(kProducerBar, 128);
              if (pt == 0) hopper::mbar_arrive(full + s);
            }
          }
        }
      }
    }
    return;
  }

  // ------------------------------------------------- the consumer warpgroup
  const float eta = scal[0], lam = scal[1], h0 = scal[3];
  const int ops1 = base_kind != kNone ? 3 : 2, ops2 = nest ? 3 : 2;  // tiles a chunk
  int tt = 0;  // operand tiles consumed
  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const size_t off = static_cast<size_t>(b) * p * n;
    const float nu0 = base_kind == kVAdam ? nu[b] : 0.f;
    const int pvb = pv != nullptr ? pv[b] : p;

    // Sweep 1: moments, mu' stored, X and Geu with their lo tiles (each is
    // its own hi: X, g, mu' or Geu written over g), A += X X^T, B += X Geu^T.
    float a_sum[32], b_sum[32], part[32], part2[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) a_sum[i] = b_sum[i] = 0.f;
    float sq = 0.f;
    for (int c = 0; c < nc; ++c, tt += ops1) {
      unsigned char* tx = tile_wait(ring, full, tt);
      unsigned char* tg = tile_wait(ring, full, tt + 1);
      unsigned char* tm = base_kind != kNone ? tile_wait(ring, full, tt + 2) : nullptr;
      for (int u = tid; u < kTcP * kTcChunk / 4; u += kTcConsumers) {
        const int row = u >> 4, col = 4 * (u & 15);
        float4* px = reinterpret_cast<float4*>(tx + tc_off(row, col));
        float4* pg = reinterpret_cast<float4*>(tg + tc_off(row, col));
        float xv[4], gv[4], hv[4];
        load4(xv, *px);
        load4(gv, *pg);
        if (base_kind != kNone) {
          float mv[4], m2[4];
          load4(mv, *reinterpret_cast<const float4*>(tm + tc_off(row, col)));
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (base_kind == kTrace) {
              m2[e] = h0 * mv[e] + gv[e];
            } else {
              m2[e] = h0 * mv[e] + (1.f - h0) * gv[e];
              sq = fmaf(gv[e], gv[e], sq);
            }
          }
          // in place: stored by TMA below, and Geu's hi unless nesterov
          *reinterpret_cast<float4*>(tm + tc_off(row, col)) = make_float4(m2[0], m2[1], m2[2], m2[3]);
          const int gc = c * kTcChunk + col;
          if (!tma && row < p && gc < n)
            gstore4(mu_out + off + static_cast<size_t>(row) * n, gc, n, vec, m2);
#pragma unroll
          for (int e = 0; e < 4; ++e) gv[e] = nest ? h0 * m2[e] + gv[e] : m2[e];
          if (nest) *pg = make_float4(gv[0], gv[1], gv[2], gv[3]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) hv[e] = trunc_lo(xv[e]);
        *reinterpret_cast<float4*>(lo0 + tc_off(row, col)) = make_float4(hv[0], hv[1], hv[2], hv[3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) hv[e] = trunc_lo(gv[e]);
        *reinterpret_cast<float4*>(lo1 + tc_off(row, col)) = make_float4(hv[0], hv[1], hv[2], hv[3]);
      }
      publish_smem();
      if (tma && tm != nullptr && tid == 0) tile_store(&tm_mu_out, tm, c, b);
      hopper::fence_regs(part);
      hopper::fence_regs(part2);
      hopper::wgmma_fence();
      gram_issue(part, tx, lo0, tx, lo0);
      gram_issue(part2, tx, lo0, base_kind == kNone || nest ? tg : tm, lo1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(part);
      hopper::fence_regs(part2);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        a_sum[i] += part[i];
        b_sum[i] += part2[i];
      }
      if (tma && tid == 0) hopper::bulk_wait_read<0>();  // mu' has left its tile
      hopper::named_sync(kConsumerBar, kTcConsumers);  // every warp is done with the tiles
      tiles_release(empty, tt, ops1);
    }
    if (!kTwoStage) {
      if (tid == 0) hopper::bulk_wait<0>();
      hopper::fence_proxy_async();  // mu' is read back by TMA in sweep 2
      hopper::named_sync(kConsumerBar, kTcConsumers);
      if (tid == 0) hopper::mbar_arrive(swept);
    }

    // The Geu scale s (vadam: nu' from the gradient's squares), then the
    // leap's (p, p) operands P = -(c/2) A and Q = (c/2) B^T [- eta lam (A - I)]
    // (the field: P = E_A/2, Q = -B^T/2 + lam E_A).
    float coef = eta * scal[2];
    if (base_kind == kVAdam) {
      const float tot = wg_sum(sq, red);
      const float b2 = scal[4], eps = scal[5], c1 = scal[6], c2 = scal[7];
      const float nu2 = b2 * nu0 + (1.f - b2) * tot;
      if (tid == 0) nu_out[b] = nu2;
      coef = eta * ((scal[2] / c1) / (sqrtf(nu2 / c2) + eps));
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = acc_row(tid, i), cc = acc_col(tid, i);
      const float ea = a_sum[i] - (r == cc && r < p ? 1.f : 0.f);
      if (kField) {
        part[i] = 0.5f * ea;
        part2[i] = -0.5f * b_sum[i] + lam * ea;
        continue;
      }
      part[i] = -0.5f * coef * a_sum[i];
      part2[i] = 0.5f * coef * b_sum[i];
      if (kMethod == kLanding) part2[i] -= eta * lam * ea;
    }
    store_split(part, gram, gram + kTcTileBytes);
    store_split(part2, gram + 2 * kTcTileBytes, gram + 3 * kTcTileBytes);
    publish_smem();

    // Sweep 2: M = X + D, D^T = Geu^T P + X^T Q (POGO's M, stored in x_out;
    // Landing's X', final), written over X, its own hi, and C += M M^T
    // (the field: Lambda = G/2 + D written over X, no gram).
    float c_sum[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) c_sum[i] = 0.f;
    for (int c = 0; c < nc; ++c, tt += ops2) {
      unsigned char* tx = tile_wait(ring, full, tt);
      unsigned char* t1 = tile_wait(ring, full, tt + 1);
      unsigned char* t2 = nest ? tile_wait(ring, full, tt + 2) : nullptr;
      product_t(
          part,
          [&](int k, int m) {
            const float v = tc_at(t1, k, m);
            return nest ? h0 * v + tc_at(t2, k, m) : v;
          },
          gram, gram + kTcTileBytes, 0);
      product_t(part, [&](int k, int m) { return tc_at(tx, k, m); }, gram + 2 * kTcTileBytes,
                gram + 3 * kTcTileBytes, 1);
      hopper::named_sync(kConsumerBar, kTcConsumers);  // the M tiles are free again
      const int c0 = c * kTcChunk;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int m = acc_row(tid, i), row = acc_col(tid, i);
        float& xm = tc_at(tx, row, m);
        const float v = (kField ? 0.5f * tc_at(t1, row, m) : xm) + part[i];
        xm = v;  // in place: stored by TMA below, and M's hi for the C gram
        if (!kField) tc_at(lo0, row, m) = trunc_lo(v);
        if (!tma && row < p && c0 + m < n) x_out[off + static_cast<size_t>(row) * n + c0 + m] = v;
      }
      publish_smem();
      if (tma && tid == 0) tile_store(&tm_x_out, tx, c, b);
      if (!kField) {
        gram_tc(part2, tx, lo0, tx, lo0);
#pragma unroll
        for (int i = 0; i < 32; ++i) c_sum[i] += part2[i];
      }
      if (tma && tid == 0) hopper::bulk_wait_read<0>();  // M has left its tile
      hopper::named_sync(kConsumerBar, kTcConsumers);  // every warp is done with the tiles
      tiles_release(empty, tt, ops2);
    }
    hopper::named_sync(kConsumerBar, kTcConsumers);  // the M tiles are free again

    if (kField) continue;
    if (kMethod == kLanding) {  // W = X' X'^T: dist = ||W - I_pv||_F
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = acc_row(tid, i), cc = acc_col(tid, i);
        const float w = c_sum[i] - (r == cc && r < pvb ? 1.f : 0.f);
        acc = fmaf(w, w, acc);
      }
      const float tot = wg_sum(acc, red);
      if (tid == 0) dist[b] = sqrtf(tot);
      continue;
    }
    if (tid == 0) hopper::bulk_wait<0>();
    hopper::fence_proxy_async();  // M is read back by TMA in sweep 3
    hopper::named_sync(kConsumerBar, kTcConsumers);
    if (tid == 0) hopper::mbar_arrive(swept);

    // The (p, p) tail: E = C - I (rows below p), E^2, E^3 on the tensor
    // cores, and dist = ||(1 - 2 lam) E + (lam^2 - 2 lam) E^2 + lam^2 E^3
    // + (I_p - I_pv)||_F (X' X'^T - I_pv by the gram identity).
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = acc_row(tid, i), cc = acc_col(tid, i);
      c_sum[i] -= r == cc && r < p ? 1.f : 0.f;
    }
    store_split(c_sum, gram, gram + kTcTileBytes);
    publish_smem();
    if (!kTwoStage) {  // the telemetry (the two-stage update writes none)
      gram_tc(part, gram, gram + kTcTileBytes, gram, gram + kTcTileBytes);  // E^2 (E symmetric)
      store_split(part, gram + 2 * kTcTileBytes, gram + 3 * kTcTileBytes);
      publish_smem();
      gram_tc(part2, gram, gram + kTcTileBytes, gram + 2 * kTcTileBytes, gram + 3 * kTcTileBytes);
      const float k1 = 1.f - 2.f * lam, k2 = lam * lam - 2.f * lam, k3 = lam * lam;
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = acc_row(tid, i), cc = acc_col(tid, i);
        const float w = k1 * c_sum[i] + k2 * part[i] + k3 * part2[i] +
                        (r == cc && r >= pvb && r < p ? 1.f : 0.f);
        acc = fmaf(w, w, acc);
      }
      const float tot = wg_sum(acc, red);
      if (tid == 0) dist[b] = sqrtf(tot);
    }

    // Sweep 3: X' = M - lam D, D^T = M^T E, from the M read back.
    for (int c = 0; c < nc; ++c, ++tt) {
      unsigned char* tmt = tile_wait(ring, full, tt);
      product_t(part, [&](int k, int m) { return tc_at(tmt, k, m); }, gram, gram + kTcTileBytes,
                0);
      const int c0 = c * kTcChunk;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int m = acc_row(tid, i), row = acc_col(tid, i);
        float& mm = tc_at(tmt, row, m);
        const float v = mm - lam * part[i];
        if (tma)  // in place, stored by TMA below
          mm = v;
        else if (row < p && c0 + m < n)
          x_out[off + static_cast<size_t>(row) * n + c0 + m] = v;
      }
      publish_smem();  // also: every warp has read the tile
      if (tma && tid == 0) {
        tile_store(&tm_x_out, tmt, c, b);
        hopper::bulk_wait_read<0>();
      }
      tiles_release(empty, tt, 1);
    }
  }
  if (tid == 0) hopper::bulk_wait<0>();  // Landing's X' and the last X'
}

// ------------------------------------------------ the wide kernel: p <= 128
//
// One matrix is two 64-row halves. Every operand chunk is a pair of ring
// slots, each a 128-row box of 32 fp32 columns (rows 64..127 start at
// kWHalf), and the (p, p) operands are 64 x 64 blocks. Two consumer
// warpgroups (wg 0 and 1) and a producer warpgroup; setmaxnreg gives the
// consumers 240 registers a thread (224 on the plain-load path).
// * Sweep 1 runs over 32-column chunks (one slot an operand, so the ring
//   holds two chunks of X, g and mu): the base stage, mu' stored, the lo
//   boxes of X and Geu in S, and warpgroup wg's rows of X X^T and Geu X^T
//   (wg's rows of A, and B's columns wg) as m64n64 products, one half of
//   X at a time.
// * Sweep 2 runs twice, once per output half h: the half-h slabs of the
//   leap's operands (P's rows h, Q's rows h: 4 x 32 KB, hi and lo) fill
//   S, and the full P and Q (256 KB) never need to be resident. Warpgroup
//   wg writes the 32 rows 64 h + 32 wg .. of M = X + D (m64n32 products
//   over K = p, from the chunk's X and Geu in registers), then the gram
//   C's rows of half h: C00 in pass 0, C10 and C11 in pass 1 from M's
//   rows 0..63 read back. X's rows are the K side of both passes, so M's
//   rows 0..63 cannot go over X before pass 1 is done with them: they are
//   parked in `park` (a scratch of 64 n + kWKeep floats a block, one
//   matrix at a time; past the rows, each thread keeps its blocks of A
//   and B for pass 1's slab and, through pass 1, its columns of C00,
//   which would otherwise hold 80 registers a thread), and Landing's X'
//   rows 0..63 are copied to x_out in pass 1.
// * The tail: E = C - I (128 x 128, hi and lo, in S), and for the
//   telemetry E^2 (m64n128 from S) and E^3, whose A operand E^2 is staged
//   in the idle ring, by warpgroup 0, half the rows at a time (its E^2 then
//   E^3 products hold 64 registers, not 128). Sweep 3 (POGO's land)
//   reads M (rows 0..63 from park, 64..127 from x_out) and writes X' =
//   M - lam M E, warpgroup wg its rows 64 wg ...
// * Scattered accumulator writes (the slabs, E, M, X') go through acc_at,
//   which holds four base addresses a thread, not one an element: with
//   one an element ptxas spilled. The plain-load path stores M and X'
//   from the tiles, row by row.
// * The field (kTwoStage, kLanding) runs sweep 1 and both passes of sweep
//   2 and stops: it writes Lambda = G / 2 + D (slabs P = E_A / 2, Q^T =
//   -B / 2 + lam E_A) over X's rows of the pass, straight to out, which is
//   never x or g, so no row is parked and pass 1 waits for nothing. Its
//   park holds the kept blocks of A and B alone (kWKeep floats a block):
//   64 registers a thread would otherwise live through pass 0.
// HBM passes: 11.5 for the fused POGO step (sweep 1: 4; pass 0: 2.5; pass
// 1: 3; sweep 3: 2), 10 for Landing, 9.5 for the POGO update, 7 for the
// field (sweep 1: X, G; each pass: X, G and half of Lambda).
//
// Shared memory: the ring (6 x 16 KB) and S (128 KB: sweep 1's lo boxes,
// then one pass's slabs, then E), the reduction scratch and the barriers.

constexpr int kWP = 128;                          // rows of the wide tile: p <= 128
constexpr int kWBox = kWP * 128;                  // a ring slot: 128 rows x 32 fp32 columns
constexpr int kWHalf = kWBox / 2;                 // rows 64..127 of a box
constexpr int kWSlots = 6;
constexpr int kWConsumers = 256;                  // two warpgroups
constexpr int kWThreads = kWConsumers + 128;      // and the producer's
// Registers a thread: a 384-thread block is launched at 168 (64,512 in
// all), and setmaxnreg moves them to the consumers: the producer's
// warpgroup keeps 24 where one lane issues TMA loads, 56 where the whole
// warpgroup loads (24 + 2 x 240 = 56 + 2 x 224 = 3 x 168).
template <bool kTma>
constexpr int kWProducerRegs = kTma ? 24 : 56;
template <bool kTma>
constexpr int kWConsumerRegs = kTma ? 240 : 224;
// Past the parked rows, each block keeps its warpgroups' blocks of A and B
// for pass 1's slab (2 x 32 floats a consumer thread) and, through pass 1,
// its columns of C00 (16) in `park`.
constexpr int kWKeep = 80 * kWConsumers;
// k8 steps of a register operand's fragments live at once in wproduct_t.
constexpr int kWFragSteps = 4;
constexpr int kWSOff = kWSlots * kWBox;           // S: 8 boxes
constexpr int kWPiece = 2 * kWBox;                // a slab piece: 64 rows x 128 columns
constexpr int kWELo = 4 * kWBox;                  // E's lo piece, after its hi
constexpr int kWRedOff = kWSOff + 8 * kWBox;
constexpr int kWBarOff = kWRedOff + 64;
constexpr int kWSmemBytes = kWBarOff + 8 * (2 * kWSlots + 1) + 1024;  // + room to align
constexpr int kWideBar = 3, kGroupBar = 4;        // named barriers: 256 consumers; one warpgroup

// Byte offset of element (row, col & 31) in a box of 128-byte rows.
__host__ __device__ inline int box_off(int row, int col) {
  return row * 128 + ((((col & 31) >> 2) ^ (row & 7)) << 4) + ((col & 3) << 2);
}

// A 64-column chunk of one operand: its two column boxes, anywhere in the ring.
struct Op {
  unsigned char* b[2];
};

__device__ inline float& op_at(const Op& o, int row, int col) {
  return *reinterpret_cast<float*>((col < 32 ? o.b[0] : o.b[1]) + box_off(row, col));
}

__device__ inline uint64_t kdesc(const unsigned char* p) { return hopper::sw128_desc(p, 16, 1024); }

// d = A B^T over kSteps k8 steps (3xTF32, small terms first), waited for;
// a(kk, lo) and b(kk, lo) are the descriptors of step kk of the hi (lo =
// 0) or lo (1) piece.
template <int kSteps, int NR, typename AD, typename BD>
__device__ inline void wgram(float (&d)[NR], AD a, BD b) {
  hopper::fence_regs(d);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    hopper::wgmma_tf32_ss(d, a(kk, 0), b(kk, 1), kk > 0);
    hopper::wgmma_tf32_ss(d, a(kk, 1), b(kk, 0), 1);
  }
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) hopper::wgmma_tf32_ss(d, a(kk, 0), b(kk, 0), 1);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(d);
}

// d (+)= T^T B over K = 64, T^T the register operand whose element (m, k)
// is val(k, m), B's descriptors b(kk, lo); waits. product_t for a
// warpgroup of the wide kernel, in batches of kWFragSteps k8 steps (each
// batch's small terms, then its hi.hi terms), so that only a batch's
// fragments are live.
template <int NR, typename Val, typename BD>
__device__ inline void wproduct_t(float (&d)[NR], Val val, BD b, int accumulate) {
  const int t = threadIdx.x & 127, m0 = 16 * (t >> 5) + ((t & 31) >> 2), k0 = t & 3;
#pragma unroll
  for (int k8 = 0; k8 < 8; k8 += kWFragSteps) {
    uint32_t fh[kWFragSteps][4], fl[kWFragSteps][4];
#pragma unroll
    for (int kk = 0; kk < kWFragSteps; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float hi, lo;
        split(val(8 * (k8 + kk) + k0 + 4 * (r >> 1), m0 + 8 * (r & 1)), hi, lo);
        fh[kk][r] = __float_as_uint(hi);
        fl[kk][r] = __float_as_uint(lo);
      }
    }
    hopper::fence_regs(d);
#pragma unroll
    for (int kk = 0; kk < kWFragSteps; ++kk) {
      hopper::fence_regs(fh[kk]);
      hopper::fence_regs(fl[kk]);
    }
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWFragSteps; ++kk) {
      hopper::wgmma_tf32_rs(d, fh[kk][0], fh[kk][1], fh[kk][2], fh[kk][3], b(k8 + kk, 1),
                            accumulate || k8 + kk > 0);
      hopper::wgmma_tf32_rs(d, fl[kk][0], fl[kk][1], fl[kk][2], fl[kk][3], b(k8 + kk, 0), 1);
    }
#pragma unroll
    for (int kk = 0; kk < kWFragSteps; ++kk)
      hopper::wgmma_tf32_rs(d, fh[kk][0], fh[kk][1], fh[kk][2], fh[kk][3], b(k8 + kk, 0), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(d);
#pragma unroll
    for (int kk = 0; kk < kWFragSteps; ++kk) {
      hopper::fence_regs(fh[kk]);
      hopper::fence_regs(fl[kk]);
    }
  }
}

// Sum over both consumer warpgroups, the same on every consumer thread, in
// a fixed order.
__device__ float wide_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  hopper::named_sync(kWideBar, kWConsumers);  // red may still be read
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  hopper::named_sync(kWideBar, kWConsumers);
  return ((red[0] + red[1]) + (red[2] + red[3])) + ((red[4] + red[5]) + (red[6] + red[7]));
}

__device__ inline void wide_publish() {
  hopper::fence_proxy_async_smem();
  hopper::named_sync(kWideBar, kWConsumers);
}

__device__ inline unsigned char* wslot(unsigned char* ring, uint64_t* full, int tt) {
  hopper::mbar_wait(full + tt % kWSlots, (tt / kWSlots) & 1);
  return ring + (tt % kWSlots) * kWBox;
}

// Releases `count` slots from tt on, once every lane of the warp is done
// with them (lanes may diverge: the plain stores read the slots unevenly).
__device__ inline void wrelease(uint64_t* empty, int tt, int count) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0)
    for (int o = 0; o < count; ++o) hopper::mbar_arrive(empty + (tt + o) % kWSlots);
}

// Rows r0 .. r0 + 63 and columns c0 .. c0 + 31 of a row-major (rows, n)
// matrix into 64 rows of a box by plain loads over the producer warpgroup
// (thread pt of 128), zero past `rows` and n.
__device__ inline void load_half_plain(unsigned char* dst, const float* src, int rows, int n,
                                       int r0, int c0, int pt) {
#pragma unroll 2
  for (int u = pt; u < 64 * 32; u += 128) {
    const int r = u >> 5, col = u & 31, row = r0 + r;
    const float v = row < rows && c0 + col < n ? src[static_cast<size_t>(row) * n + c0 + col] : 0.f;
    *reinterpret_cast<float*>(dst + box_off(r, col)) = v;
  }
}

// Calls f(i, r, c, off) for this thread's accumulator elements i of an
// m64nN product (NR = N / 2), at rows r = r0 + acc_row and columns c = c1 +
// acc_col (r0, c1 multiples of 8), off the byte offset of element (r, c),
// or (kT) of (c, r), in an array of 32-column boxes kBox bytes apart.
// Element 4 j + q lies at the q-th of four bases plus a constant of j, so
// that the unrolled loop holds no address per element. Transposed, column c
// = c0 + 8 j is row c0 + 8 j: 1024 j further. In place, it is 16-byte chunk
// 2 (j & 3) + k of box j / 4 (k = (c0 & 31) / 4), which row r's swizzle XORs
// with r & 7 = 2 u + (r & 1): the chunk's high bits with u, its low bit with
// r & 1.
template <int NR, bool kT, int kBox, typename F>
__device__ inline void acc_at(int r0, int c1, F f) {
  const int t = threadIdx.x & 127;
  const int u = (((t & 31) >> 2) & 7) >> 1;  // r & 7 is (t & 31) / 4 & 7 whatever q
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = r0 + 16 * (t >> 5) + ((t & 31) >> 2) + 8 * (q >> 1);
    const int c0 = c1 + 2 * (t & 3) + (q & 1);
    const int base = kT ? (r >> 5) * kBox + box_off(c0, r)
                        : (c0 >> 5) * kBox + r * 128 +
                              (((((c0 & 31) >> 2) & 1) ^ (r & 1)) << 4) + ((c0 & 3) << 2);
#pragma unroll
    for (int j = 0; j < NR / 4; ++j)
      f(4 * j + q, r, c0 + 8 * j, base + (kT ? 1024 * j : (j >> 2) * kBox + (((j & 3) ^ u) << 5)));
  }
}

__device__ inline void put_split(unsigned char* at, int lo_off, float v) {
  float hi, lo;
  split(v, hi, lo);
  *reinterpret_cast<float*>(at) = hi;
  *reinterpret_cast<float*>(at + lo_off) = lo;
}

// Rows r0 .. r0 + rows - 1 of a chunk's tile o (cols columns: 64, or 32
// for one box) to the row-major (., n) matrix dst at column c0, over the
// consumer warpgroups (the plain-load path's stores), rows past `valid`
// and columns past n skipped.
__device__ inline void store_rows_plain(const Op& o, int r0, int rows, float* dst, int valid,
                                        int n, int c0, int cols = 64) {
#pragma unroll 1
  for (int u = threadIdx.x; u < rows * cols; u += kWConsumers) {
    const int r = u / cols, col = u % cols;
    if (r < valid && c0 + col < n)
      dst[static_cast<size_t>(r) * n + c0 + col] = op_at(o, r0 + r, col);
  }
}

// Writes the slab of output half H into S: rows 64 H .. 64 H + 63 of P =
// -(c/2) A and of Q^T = (c/2) B [- eta lam (A - I)] (kField: P = E_A / 2,
// Q^T = -B / 2 + lam E_A, E_A = A - I), hi and lo, from this warpgroup's
// blocks (wg, H) of A (a(i)) and (H, wg)^T of B (bv(i)), i in the
// accumulator layout, each at its transposed place; as B operands the
// slab's rows are N, its 128 columns K (64-row boxes).
template <int H, int kMethod, bool kField, typename AV, typename BV>
__device__ inline void write_slab(AV a, BV bv, unsigned char* s, int wg, int p, float coef,
                                  float eta, float lam) {
  // the field's diagonal tests stay here: hoisted out of the matrix loop,
  // they took 40 registers through it and spilled
  const int pf = kField ? hopper::opaque(p) : p;
  acc_at<32, true, kWHalf>(64 * wg, 0, [&](int i, int r, int c, int off) {
    const float av = a(i);
    if (kField) {  // A's (r, 64 H + c): slab row c, column r
      const float ea = av - (r == 64 * H + c && r < pf ? 1.f : 0.f);
      put_split(s + off, kWPiece, 0.5f * ea);
      put_split(s + 2 * kWPiece + off, kWPiece, -0.5f * bv(i) + lam * ea);
      return;
    }
    float qv = 0.5f * coef * bv(i);  // A's (r, 64 H + c): slab row c, column r
    if (kMethod == kLanding) qv -= eta * lam * (av - (r == 64 * H + c && r < p ? 1.f : 0.f));
    put_split(s + off, kWPiece, -0.5f * coef * av);
    put_split(s + 2 * kWPiece + off, kWPiece, qv);
  });
}

// E = C - I (below p) into S, hi and lo, from this thread's accumulator
// elements v(i) of C's block at (r0, c1) of an m64nN product, at their
// transposed place (kT) or in place.
template <int NR, bool kT, typename V>
__device__ inline void put_e(unsigned char* s, int r0, int c1, int p, V v) {
  acc_at<NR, kT, kWBox>(r0, c1, [&](int i, int r, int c, int off) {
    put_split(s + off, kWELo, v(i) - (r == c && r < p ? 1.f : 0.f));
  });
}

// hi + lo of a value stored by put_split.
__device__ inline float load_split(const unsigned char* at, int lo_off) {
  return *reinterpret_cast<const float*>(at) + *reinterpret_cast<const float*>(at + lo_off);
}

// The wide kernel's producer: every slot of every sweep of this block's
// matrices, in the order the consumers take them, through TMA (kTma: one
// lane) or plain loads (the whole warpgroup, thread pt); pk is this block's
// park. Two instances, so that neither keeps the other's operands live.
template <bool kTma, int kMethod, bool kTwoStage>
__device__ inline void wide_produce(const CUtensorMap& tm_x, const CUtensorMap& tm_g,
                                    const CUtensorMap& tm_mu, const CUtensorMap& tm_mu_out,
                                    const CUtensorMap& tm_x_out, const CUtensorMap& tm_park,
                                    const float* x, const float* g, const float* mu,
                                    const float* mu_out, const float* x_out, const float* pk,
                                    unsigned char* ring, int B, int p, int n, int base_kind,
                                    bool nest, int pt) {
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kWBarOff);
  uint64_t* empty = full + kWSlots;
  uint64_t* swept = empty + kWSlots;
  constexpr bool kField = kTwoStage && kMethod == kLanding;
  const int nc1 = (n + 31) / 32, nc2 = (n + 63) / 64;
  int q = 0, round = 0, waits = 0;  // the next slot, its use, end-of-sweep waits
  // One slot: rows 0..63 of (map0 / src0, rows0 valid rows) at column c0
  // and rows r1 .. r1 + 63 of (map1 / src1) at column c1.
  auto issue = [&](const CUtensorMap& map0, const float* src0, int rows0, int c0, int bc0,
                   const CUtensorMap& map1, const float* src1, int rows1, int r1, int c1,
                   int bc1) {
    if (round > 0) hopper::mbar_wait(empty + q, (round - 1) & 1);
    unsigned char* st = ring + q * kWBox;
    if (kTma) {
      hopper::mbar_expect_tx(full + q, kWBox);
      hopper::tma_load_4d(st, &map0, full + q, c0, 0, bc0, 0);
      hopper::tma_load_4d(st + kWHalf, &map1, full + q, c1, r1, bc1, 0);
    } else {
      load_half_plain(st, src0, rows0, n, 0, c0, pt);
      load_half_plain(st + kWHalf, src1, rows1, n, r1, c1, pt);
      hopper::named_sync(kProducerBar, 128);
      if (pt == 0) hopper::mbar_arrive(full + q);
    }
    if (++q == kWSlots) q = 0, ++round;
  };
  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const size_t off = static_cast<size_t>(b) * p * n;
    auto box = [&](const CUtensorMap& map, const float* src, int c0) {  // 128 rows of a stack
      issue(map, src + off, p, c0, b, map, src + off, p, 64, c0, b);
    };
    for (int c = 0; c < nc1; ++c) {  // sweep 1: X, g (, mu), one box each
      box(tm_x, x, 32 * c);
      box(tm_g, g, 32 * c);
      if (base_kind != kNone) box(tm_mu, mu, 32 * c);
    }
    for (int h = 0; h < 2; ++h) {  // sweep 2: [g,] X, Geu's source [, M's rows 0..63]
      // mu' (pass 0) and the parked rows (pass 1) are in HBM; order that
      // before these TMA reads (the two-stage pass 0 reads X and G only,
      // the field both passes)
      if (!kField && (h == 1 || !kTwoStage)) {
        hopper::mbar_wait(swept, waits++ & 1);
        hopper::fence_proxy_async();
      }
      for (int c = 0; c < nc2; ++c) {
        if (nest)
          for (int bx = 0; bx < 2; ++bx) box(tm_g, g, 64 * c + 32 * bx);
        for (int bx = 0; bx < 2; ++bx) box(tm_x, x, 64 * c + 32 * bx);
        for (int bx = 0; bx < 2; ++bx) {
          if (base_kind == kNone)
            box(tm_g, g, 64 * c + 32 * bx);
          else
            box(tm_mu_out, mu_out, 64 * c + 32 * bx);
        }
        if (h == 1 && !kField)  // a 64-row tile: column box bx at kWHalf bx
          issue(tm_park, pk, 64, 64 * c, blockIdx.x, tm_park, pk, 64, 0, 64 * c + 32,
                blockIdx.x);
      }
    }
    if (kMethod == kPogo) {  // sweep 3: M, rows 0..63 parked, 64.. in x_out
      hopper::mbar_wait(swept, waits++ & 1);
      hopper::fence_proxy_async();
      for (int c = 0; c < nc2; ++c)
        for (int bx = 0; bx < 2; ++bx)
          issue(tm_park, pk, 64, 64 * c + 32 * bx, blockIdx.x, tm_x_out, x_out + off, p, 64,
                64 * c + 32 * bx, b);
    }
  }
}

// kTma: TMA loads and stores (n % 4 == 0 and aligned operands), else the
// producer warpgroup's plain loads and the consumers' plain stores; two
// instances, so that neither carries the other's code and registers.
template <int kMethod, bool kTwoStage, bool kTma>
__global__ void __launch_bounds__(kWThreads, 1)
fused_tc_wide_kernel(const __grid_constant__ CUtensorMap tm_x,
                     const __grid_constant__ CUtensorMap tm_g,
                     const __grid_constant__ CUtensorMap tm_mu,
                     const __grid_constant__ CUtensorMap tm_mu_out,
                     const __grid_constant__ CUtensorMap tm_x_out,
                     const __grid_constant__ CUtensorMap tm_park, const float* x, const float* g,
                     const float* mu, const float* nu, const float* scal, const int* pv,
                     float* x_out, float* mu_out, float* nu_out, float* dist, float* park, int B,
                     int p, int n, int base_kind, int nesterov) {
  constexpr bool tma = kTma;
  // the plain-load path holds Geu X^T's sums in shared memory: its
  // consumers have 16 registers fewer
  constexpr bool kTbSmem = !kTma;
  extern __shared__ unsigned char fused_tc_smem[];
  const uint32_t pad = (1024u - (hopper::smem_u32(fused_tc_smem) & 1023u)) & 1023u;
  unsigned char* ring = fused_tc_smem + pad;
  unsigned char* s = ring + kWSOff;
  float* red = reinterpret_cast<float*>(ring + kWRedOff);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kWBarOff);
  uint64_t* empty = full + kWSlots;
  uint64_t* swept = empty + kWSlots;
  constexpr bool kField = kTwoStage && kMethod == kLanding;
  if (kTwoStage) base_kind = kNone, nesterov = 0;
  const int tid = threadIdx.x;
  const int nc1 = (n + 31) / 32, nc2 = (n + 63) / 64;
  const bool nest = base_kind == kTrace && nesterov;
  // the field parks no rows: its park is the kept blocks alone
  const size_t park_off = kField ? static_cast<size_t>(blockIdx.x) * kWKeep
                                 : static_cast<size_t>(blockIdx.x) * (64 * n + kWKeep);

  if (tid == 0) {
    for (int q = 0; q < kWSlots; ++q) {
      hopper::mbar_init(full + q, 1);
      hopper::mbar_init(empty + q, kWConsumers / 32);  // one arrival per consumer warp
    }
    hopper::mbar_init(swept, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kWConsumers) {  // the producer's warpgroup
    hopper::reg_dealloc<kWProducerRegs<kTma>>();
    const int pt = tid - kWConsumers;
    if (!kTma || pt == 0)  // TMA: one lane issues every load
      wide_produce<kTma, kMethod, kTwoStage>(tm_x, tm_g, tm_mu, tm_mu_out, tm_x_out, tm_park, x, g,
                                             mu, mu_out, x_out, park + park_off, ring, B, p, n,
                                             base_kind, nest, pt);
    return;
  }

  // ------------------------------------------- the two consumer warpgroups
  hopper::reg_alloc<kWConsumerRegs<kTma>>();
  // the warpgroup, from lane 0, so that the compiler sees it warp-uniform
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0), wt = tid & 127;
  const float eta = scal[0], lam = scal[1], h0 = scal[3];
  const int ops1 = base_kind != kNone ? 3 : 2;  // sweep 1's slots a chunk
  float* pk = park + park_off;
  int tt = 0;  // slots consumed
  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const size_t off = static_cast<size_t>(b) * p * n;
    const float nu0 = base_kind == kVAdam ? nu[b] : 0.f;
    const int pvb = pv != nullptr ? pv[b] : p;

    // Sweep 1 (32-column chunks): moments, mu' stored, the lo boxes of X
    // and Geu (S's boxes 0 and 1), ta = X_wg X^T (A's rows wg), tb =
    // Geu_wg X^T (B's columns wg, transposed; kTbSmem: summed in S's boxes
    // 2..5, element i of consumer thread tid at float 256 i + tid).
    float ta[64], tb[kTbSmem ? 1 : 64];
    float* tbs = reinterpret_cast<float*>(s + 2 * kWBox) + tid;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      ta[i] = 0.f;
      if (kTbSmem)
        tbs[kWConsumers * i] = 0.f;
      else
        tb[i] = 0.f;
    }
    float sq = 0.f;
    for (int c = 0; c < nc1; ++c, tt += ops1) {
      unsigned char* tx = wslot(ring, full, tt);
      unsigned char* tg = wslot(ring, full, tt + 1);
      unsigned char* tm = base_kind != kNone ? wslot(ring, full, tt + 2) : nullptr;
      for (int u = tid; u < kWP * 8; u += kWConsumers) {
        const int row = u >> 3, col = 4 * (u & 7), o = box_off(row, col);
        float4* px = reinterpret_cast<float4*>(tx + o);
        float4* pg = reinterpret_cast<float4*>(tg + o);
        float xv[4], gv[4], hv[4];
        load4(xv, *px);
        load4(gv, *pg);
        if (base_kind != kNone) {
          float mv[4], m2[4];
          load4(mv, *reinterpret_cast<const float4*>(tm + o));
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (base_kind == kTrace) {
              m2[e] = h0 * mv[e] + gv[e];
            } else {
              m2[e] = h0 * mv[e] + (1.f - h0) * gv[e];
              sq = fmaf(gv[e], gv[e], sq);
            }
          }
          // in place: stored below, and Geu's hi unless nesterov
          *reinterpret_cast<float4*>(tm + o) = make_float4(m2[0], m2[1], m2[2], m2[3]);
#pragma unroll
          for (int e = 0; e < 4; ++e) gv[e] = nest ? h0 * m2[e] + gv[e] : m2[e];
          if (nest) *pg = make_float4(gv[0], gv[1], gv[2], gv[3]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) hv[e] = trunc_lo(xv[e]);
        *reinterpret_cast<float4*>(s + o) = make_float4(hv[0], hv[1], hv[2], hv[3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) hv[e] = trunc_lo(gv[e]);
        *reinterpret_cast<float4*>(s + kWBox + o) = make_float4(hv[0], hv[1], hv[2], hv[3]);
      }
      wide_publish();
      if (!tma && tm != nullptr)  // mu', one box
        store_rows_plain(Op{{tm, tm}}, 0, kWP, mu_out + off, p, n, 32 * c, 32);
      if (tma && tm != nullptr && tid == 0) {
        hopper::tma_store_4d(&tm_mu_out, tm, 32 * c, 0, b, 0);
        hopper::tma_store_4d(&tm_mu_out, tm + kWHalf, 32 * c, 64, b, 0);
        hopper::bulk_commit();
      }
      const unsigned char* ga = base_kind == kNone || nest ? tg : tm;
      auto xa = [&](int kk, int lo) { return kdesc((lo ? s : tx) + wg * kWHalf + kk * 32); };
      auto ea = [&](int kk, int lo) {
        return kdesc((lo ? s + kWBox : ga) + wg * kWHalf + kk * 32);
      };
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {  // one 64-row half of X at a time (m64n64)
        auto xs = [&](int kk, int lo) { return kdesc((lo ? s : tx) + hh * kWHalf + kk * 32); };
        float part[32];
        wgram<4>(part, xa, xs);
#pragma unroll
        for (int i = 0; i < 32; ++i) ta[32 * hh + i] += part[i];
        wgram<4>(part, ea, xs);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          if (kTbSmem)
            tbs[kWConsumers * (32 * hh + i)] += part[i];
          else
            tb[32 * hh + i] += part[i];
        }
      }
      if (tma && tid == 0) hopper::bulk_wait_read<0>();  // mu' has left its box
      hopper::named_sync(kWideBar, kWConsumers);  // every warp is done with the boxes
      wrelease(empty, tt, ops1);
    }
    if (!kTwoStage) {
      if (tid == 0) hopper::bulk_wait<0>();
      hopper::fence_proxy_async();  // mu' is read back by TMA in sweep 2
      hopper::named_sync(kWideBar, kWConsumers);
      if (tid == 0) hopper::mbar_arrive(swept);
    }

    // The Geu scale s (vadam: nu' from the gradient's squares); the blocks
    // of pass 1's slab kept in park; then the slabs of output half 0.
    float coef = eta * scal[2];
    if (base_kind == kVAdam) {
      const float tot = wide_sum(sq, red);
      const float b2 = scal[4], eps = scal[5], c1 = scal[6], c2 = scal[7];
      const float nu2 = b2 * nu0 + (1.f - b2) * tot;
      if (tid == 0) nu_out[b] = nu2;
      coef = eta * ((scal[2] / c1) / (sqrtf(nu2 / c2) + eps));
    }
    float* keep = kField ? pk + tid : pk + static_cast<size_t>(64) * n + tid;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      keep[kWConsumers * i] = ta[32 + i];
      keep[kWConsumers * (32 + i)] = kTbSmem ? tbs[kWConsumers * (32 + i)] : tb[32 + i];
    }
    if (kTbSmem) {
      float tb0[32];  // S's sums, read before the slab goes over them
#pragma unroll
      for (int i = 0; i < 32; ++i) tb0[i] = tbs[kWConsumers * i];
      hopper::named_sync(kWideBar, kWConsumers);
      write_slab<0, kMethod, kField>([&](int i) { return ta[i]; }, [&](int i) { return tb0[i]; },
                                     s, wg, p, coef, eta, lam);
    } else {
      write_slab<0, kMethod, kField>([&](int i) { return ta[i]; }, [&](int i) { return tb[i]; },
                                     s, wg, p, coef, eta, lam);
    }
    wide_publish();

    // Sweep 2, once per output half h: M = X + D, D^T = Geu^T P + X^T Q
    // (POGO's M; Landing's X', final), this warpgroup's 32 rows 64 h +
    // 32 wg .., written over X (its own hi) with their lo over Geu's rows
    // 0..63; M's rows 0..63 parked (pass 0) and read back (pass 1, their
    // lo over Geu's rows 64..127); C00 (pass 0, columns 32 wg ..) and C1wg
    // = M_1 M_wg^T (pass 1).
    float c00[16], c1[32];
#pragma unroll
    for (int i = 0; i < 16; ++i) c00[i] = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (h == 1) {
#pragma unroll
        for (int i = 0; i < 32; ++i) c1[i] = 0.f;
        write_slab<1, kMethod, kField>([&](int i) { return keep[kWConsumers * i]; },
                                       [&](int i) { return keep[kWConsumers * (32 + i)]; }, s,
                                       wg, p, coef, eta, lam);
        wide_publish();
      }
      for (int c = 0; c < nc2; ++c) {
        const int c0 = 64 * c, t0 = tt;
        Op go{};
        if (nest) {
          go.b[0] = wslot(ring, full, tt);
          go.b[1] = wslot(ring, full, tt + 1);
          tt += 2;
        }
        const Op xo{{wslot(ring, full, tt), wslot(ring, full, tt + 1)}};
        const Op so{{wslot(ring, full, tt + 2), wslot(ring, full, tt + 3)}};
        tt += 4;
        if (nest) {  // Geu = h0 mu' + g over mu'; then g's slots are free
          for (int u = tid; u < kWP * 16; u += kWConsumers) {
            const int row = u >> 4, col = 4 * (u & 15), o = box_off(row, col);
            float4* pm = reinterpret_cast<float4*>(so.b[col >> 5] + o);
            const float4 gq = *reinterpret_cast<const float4*>(go.b[col >> 5] + o);
            const float4 mq = *pm;
            *pm = make_float4(h0 * mq.x + gq.x, h0 * mq.y + gq.y, h0 * mq.z + gq.z,
                              h0 * mq.w + gq.w);
          }
          hopper::named_sync(kWideBar, kWConsumers);
          wrelease(empty, t0, 2);
        }
        float d[16];
        // this warpgroup's 32 rows of the slabs (the field: its descriptors
        // made in this loop, not hoisted out of it and spilled)
        const unsigned char* slab =
            kField ? hopper::opaque(s + wg * 32 * 128) : s + wg * 32 * 128;
#pragma unroll
        for (int kh = 0; kh < 2; ++kh)
          wproduct_t(
              d, [&](int k, int m) { return op_at(so, 64 * kh + k, m); },
              [&](int kk, int lo) {
                return kdesc(slab + lo * kWPiece + (2 * kh + (kk >> 2)) * kWHalf + (kk & 3) * 32);
              },
              kh);
#pragma unroll
        for (int kh = 0; kh < 2; ++kh)
          wproduct_t(
              d, [&](int k, int m) { return op_at(xo, 64 * kh + k, m); },
              [&](int kk, int lo) {
                return kdesc(slab + (2 + lo) * kWPiece + (2 * kh + (kk >> 2)) * kWHalf +
                             (kk & 3) * 32);
              },
              1);
        hopper::named_sync(kWideBar, kWConsumers);  // every product has read X and Geu
        // accumulator (m, rr) is M's (64 h + rr, m), column m in box m / 32 =
        // the thread's warp / 2
        unsigned char* xb = xo.b[(wt >> 6) & 1] + h * kWHalf;
        unsigned char* sb = so.b[(wt >> 6) & 1];
        acc_at<16, true, 0>(0, 32 * wg, [&](int i, int, int, int o) {
          float& xm = *reinterpret_cast<float*>(xb + o);
          if (kField) {  // Lambda = G / 2 + D over X, stored below
            xm = 0.5f * *reinterpret_cast<const float*>(sb + h * kWHalf + o) + d[i];
            return;
          }
          const float v = xm + d[i];
          xm = v;  // in place: stored below, and M's hi for the C gram
          *reinterpret_cast<float*>(sb + o) = trunc_lo(v);
        });
        Op mo{};  // pass 1: M's rows 0..63, a 64-row tile
        if (h == 1 && !kField) {
          mo.b[0] = wslot(ring, full, tt);
          mo.b[1] = mo.b[0] + kWHalf;
          ++tt;
          for (int u = tid; u < 64 * 64; u += kWConsumers) {
            const int r = u >> 6, col = u & 63;
            op_at(so, 64 + r, col) = trunc_lo(op_at(mo, r, col));
          }
        }
        wide_publish();
        if (!tma) {
          if (kField)  // Lambda's rows 64 h .., straight to out
            store_rows_plain(xo, 64 * h, 64, x_out + off + static_cast<size_t>(64 * h) * n,
                             p - 64 * h, n, c0);
          else if (h == 0)
            store_rows_plain(xo, 0, 64, pk, 64, n, c0);
          else
            store_rows_plain(xo, 64, 64, x_out + off + static_cast<size_t>(64) * n, p - 64, n, c0);
          if (kMethod == kLanding && !kField && h == 1)  // X' rows 0..63, final
            store_rows_plain(mo, 0, 64, x_out + off, 64, n, c0);
        }
        if (tma && tid == 0) {
          for (int bx = 0; bx < 2; ++bx) {
            if (kField)
              hopper::tma_store_4d(&tm_x_out, xo.b[bx] + h * kWHalf, c0 + 32 * bx, 64 * h, b, 0);
            else if (h == 0)
              hopper::tma_store_4d(&tm_park, xo.b[bx], c0 + 32 * bx, 0, blockIdx.x, 0);
            else
              hopper::tma_store_4d(&tm_x_out, xo.b[bx] + kWHalf, c0 + 32 * bx, 64, b, 0);
            if (kMethod == kLanding && !kField && h == 1)
              hopper::tma_store_4d(&tm_x_out, mo.b[bx], c0 + 32 * bx, 0, b, 0);
          }
          hopper::bulk_commit();
        }
        if (kField) {  // no gram
        } else if (h == 0) {  // C00's columns 32 wg ..: M_0 M_0^T
          float part[16];
          wgram<8>(
              part,
              [&](int kk, int lo) { return kdesc((lo ? so : xo).b[kk >> 2] + (kk & 3) * 32); },
              [&](int kk, int lo) {
                return kdesc((lo ? so : xo).b[kk >> 2] + wg * 32 * 128 + (kk & 3) * 32);
              });
#pragma unroll
          for (int i = 0; i < 16; ++i) c00[i] += part[i];
        } else {  // C1wg = M_1 M_wg^T
          float part[32];
          auto m1 = [&](int kk, int lo) {
            return kdesc((lo ? so.b[kk >> 2] : xo.b[kk >> 2] + kWHalf) + (kk & 3) * 32);
          };
          auto m0 = [&](int kk, int lo) {
            return kdesc((lo ? so.b[kk >> 2] + kWHalf : mo.b[kk >> 2]) + (kk & 3) * 32);
          };
          if (wg == 0)
            wgram<8>(part, m1, m0);
          else
            wgram<8>(part, m1, m1);
#pragma unroll
          for (int i = 0; i < 32; ++i) c1[i] += part[i];
        }
        if (tma && tid == 0) hopper::bulk_wait_read<0>();  // M has left its boxes
        hopper::named_sync(kWideBar, kWConsumers);  // every warp is done with the slots
        wrelease(empty, nest ? t0 + 2 : t0, kField ? 4 : 4 + h);
      }
      if (h == 0 && !kField) {  // M's rows 0..63 are read back by TMA in pass 1
#pragma unroll
        for (int i = 0; i < 16; ++i) keep[kWConsumers * (64 + i)] = c00[i];  // C00 waits
        if (tid == 0) hopper::bulk_wait<0>();
        hopper::fence_proxy_async();
        hopper::named_sync(kWideBar, kWConsumers);
        if (tid == 0) hopper::mbar_arrive(swept);
      }
    }

    if (kField) continue;
    if (kMethod == kLanding) {  // W = X' X'^T: dist = ||W - I_pv||_F, W01 = W10^T
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int r = acc_row(wt, i), cc = 32 * wg + acc_col(wt, i);
        const float w = keep[kWConsumers * (64 + i)] - (r == cc && r < pvb ? 1.f : 0.f);
        acc = fmaf(w, w, acc);
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = 64 + acc_row(wt, i), cc = 64 * wg + acc_col(wt, i);
        const float w = c1[i] - (r == cc && r < pvb ? 1.f : 0.f);
        acc = fmaf(wg == 0 ? 2.f * w : w, w, acc);
      }
      const float tot = wide_sum(acc, red);
      if (tid == 0) dist[b] = sqrtf(tot);
      continue;
    }

    // The (p, p) tail: E = C - I (rows below p) into S, hi and lo, E01 =
    // E10^T; then E^2 and E^3 on the tensor cores and dist = ||(1 - 2 lam) E
    // + (lam^2 - 2 lam) E^2 + lam^2 E^3 + (I_p - I_pv)||_F.
    if (tid == 0) hopper::bulk_wait<0>();  // M's rows 64.. in x_out, read back in sweep 3
    // E00 (symmetric: each warpgroup's columns, transposed), E01 = C10^T, and
    // E10 and E11 in place
    put_e<16, true>(s, 0, 32 * wg, p, [&](int i) { return keep[kWConsumers * (64 + i)]; });
    if (wg == 0) put_e<32, true>(s, 64, 0, p, [&](int i) { return c1[i]; });
    put_e<32, false>(s, 64, 64 * wg, p, [&](int i) { return c1[i]; });
    wide_publish();
    auto e_all = [&](int kk, int lo) {
      return kdesc(s + lo * kWELo + (kk >> 2) * kWBox + (kk & 3) * 32);
    };
    if (!kTwoStage) {  // the telemetry (the two-stage update writes none)
      // Warpgroup 0 alone, one half hh of the rows at a time, so that E^2
      // and E^3 are never live together: E^2's rows hh staged in the idle
      // ring (slots 0..3, box kb: hi in rows 0..63, lo in 64..127), then
      // E^3's (slots 4 and 5, box kb in rows 64 (kb & 1).., fp32), and the
      // sum of squares read from shared memory.
      const float k1 = 1.f - 2.f * lam, k2 = lam * lam - 2.f * lam, k3 = lam * lam;
      unsigned char* e3s = ring + 4 * kWBox;
      float acc = 0.f;
      if (wg == 0) {
        for (int hh = 0; hh < 2; ++hh) {
          {
            float e2[64];
            wgram<16>(e2,
                      [&](int kk, int lo) {
                        return kdesc(s + lo * kWELo + (kk >> 2) * kWBox + hh * kWHalf +
                                     (kk & 3) * 32);
                      },
                      e_all);
            hopper::named_sync(kGroupBar, 128);  // the last rows' sums have read the ring
            acc_at<64, false, kWBox>(0, 0, [&](int i, int, int, int off) {
              put_split(ring + off, kWHalf, e2[i]);
            });
          }
          hopper::fence_proxy_async_smem();
          hopper::named_sync(kGroupBar, 128);
          {
            float e3[64];
            wgram<16>(e3,
                      [&](int kk, int lo) {
                        return kdesc(ring + (kk >> 2) * kWBox + lo * kWHalf + (kk & 3) * 32);
                      },
                      e_all);
            acc_at<64, false, kWHalf>(0, 0, [&](int i, int, int, int off) {
              *reinterpret_cast<float*>(e3s + off) = e3[i];
            });
          }
          hopper::named_sync(kGroupBar, 128);
          for (int u = wt; u < 64 * kWP; u += 128) {
            const int r = u >> 7, c = u & 127, rr = 64 * hh + r;
            const int o = (c >> 5) * kWBox + box_off(r, c);
            const float w = k1 * load_split(s + hh * kWHalf + o, kWELo) +
                            k2 * load_split(ring + o, kWHalf) +
                            k3 * *reinterpret_cast<const float*>(e3s + (c >> 5) * kWHalf +
                                                                 box_off(r, c)) +
                            (rr == c && rr >= pvb && rr < p ? 1.f : 0.f);
            acc = fmaf(w, w, acc);
          }
        }
      }
      const float tot = wide_sum(acc, red);  // also: the ring is free again
      if (tid == 0) dist[b] = sqrtf(tot);
    }
    hopper::fence_proxy_async();
    hopper::named_sync(kWideBar, kWConsumers);
    if (tid == 0) hopper::mbar_arrive(swept);

    // Sweep 3: X' = M - lam D, D^T = M^T E, this warpgroup's rows 64 wg ..
    for (int c = 0; c < nc2; ++c, tt += 2) {
      const Op mo{{wslot(ring, full, tt), wslot(ring, full, tt + 1)}};
      float d[32];
#pragma unroll
      for (int kh = 0; kh < 2; ++kh)
        wproduct_t(
            d, [&](int k, int m) { return op_at(mo, 64 * kh + k, m); },
            [&](int kk, int lo) {
              return kdesc(s + lo * kWELo + (2 * kh + (kk >> 2)) * kWBox + wg * kWHalf +
                           (kk & 3) * 32);
            },
            kh);
      hopper::named_sync(kWideBar, kWConsumers);  // every product has read M
      const int c0 = 64 * c;
      unsigned char* mb = mo.b[(wt >> 6) & 1];  // accumulator (m, row): M's (row, m)
      acc_at<32, true, 0>(0, 64 * wg, [&](int i, int, int, int o) {
        float& mm = *reinterpret_cast<float*>(mb + o);
        mm -= lam * d[i];  // in place, stored below
      });
      wide_publish();
      if (!tma) store_rows_plain(mo, 0, kWP, x_out + off, p, n, c0);
      if (tma && tid == 0) {
        for (int bx = 0; bx < 2; ++bx)
          for (int hf = 0; hf < 2; ++hf)
            hopper::tma_store_4d(&tm_x_out, mo.b[bx] + hf * kWHalf, c0 + 32 * bx, 64 * hf, b, 0);
        hopper::bulk_commit();
        hopper::bulk_wait_read<0>();
      }
      wrelease(empty, tt, 2);
    }
  }
  if (tid == 0) hopper::bulk_wait<0>();  // the last X'
}

// One wgmma m64n64k8 .tf32 on raw fp32 inputs: d (64 x 64) = a (64 x 8)
// b (64 x 8)^T, a from shared memory or (a_regs) from registers in the
// fragment layout of hopper.cuh. It reads how the card treats an operand's
// low 13 bits and rounds its accumulation, and checks the fragment layout.
__global__ void __launch_bounds__(128, 1)
tf32_probe_kernel(const float* a, const float* b, float* d, int a_regs) {
  extern __shared__ unsigned char tf32_probe_smem[];
  const uint32_t pad = (1024u - (hopper::smem_u32(tf32_probe_smem) & 1023u)) & 1023u;
  unsigned char* sa = tf32_probe_smem + pad;
  unsigned char* sb = sa + kTcTileBytes;
  const int t = threadIdx.x;
  for (int e = t; e < kTcP * kTcChunk; e += 128) {
    const int row = e >> 6, k = e & 63;
    tc_at(sa, row, k) = k < 8 ? a[row * 8 + k] : 0.f;
    tc_at(sb, row, k) = k < 8 ? b[row * 8 + k] : 0.f;
  }
  hopper::fence_proxy_async_smem();
  __syncthreads();
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  const int m0 = 16 * (t >> 5) + ((t & 31) >> 2), k0 = t & 3;
  uint32_t f[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) f[r] = __float_as_uint(a[(m0 + 8 * (r & 1)) * 8 + k0 + 4 * (r >> 1)]);
  hopper::fence_regs(acc);
  hopper::fence_regs(f);
  hopper::wgmma_fence();
  if (a_regs)
    hopper::wgmma_tf32_rs(acc, f[0], f[1], f[2], f[3], tc_desc(sb, 0), 0);
  else
    hopper::wgmma_tf32_ss(acc, tc_desc(sa, 0), tc_desc(sb, 0), 0);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);
  hopper::fence_regs(f);
#pragma unroll
  for (int i = 0; i < 32; ++i) d[acc_row(t, i) * 64 + acc_col(t, i)] = acc[i];
}

// The tensor maps of every operand (when TMA can take the rows), the
// persistent grid of one CTA per SM (at most B), and the launch: the kernel
// for p <= 64, or (p > 64) the wide one, its TMA instance `kernel` or its
// plain-load instance `wide_plain`, whose park holds 64 n + kWKeep floats a
// block (park_rows), or (the field) kWKeep.
int launch_tc(const void* kernel, const void* wide_plain, const float* x, const float* g,
              const float* mu, const float* nu, const float* scal, const int* pv, float* x_out,
              float* mu_out, float* nu_out, float* dist, float* park, int B, int p, int n,
              int base_kind, int nesterov, void* stream, bool park_rows = true) {
  const bool wide = p > kTcP;
  const void* rows[] = {x, g, x_out, base_kind != kNone ? mu : x,
                        base_kind != kNone ? mu_out : x_out, wide ? park : x};
  int vec = vector_ok(n, rows, 6);
  int tma = vec;
  int sms = 0, dev = 0;
  cudaError_t cerr = cudaGetDevice(&dev);
  if (cerr == cudaSuccess) cerr = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const int grid = B < sms ? B : sms;
  CUtensorMap maps[6] = {};  // x, g, mu, mu_out, x_out, park
  if (tma) {
    const uint64_t e = sizeof(float);
    const uint32_t box[4] = {32, kTcP, 1, 1};
    const float* srcs[6] = {x, g, mu, mu_out, x_out, wide && park_rows ? park : nullptr};
    for (int i = 0; i < 6; ++i) {
      if (srcs[i] == nullptr) continue;
      // the park: 64 rows a block, then its kept blocks
      const uint64_t rows_i = i == 5 ? 64 : p, mats = i == 5 ? grid : B;
      const uint64_t mat = i == 5 ? 64 * static_cast<uint64_t>(n) + kWKeep : rows_i * n;
      const uint64_t dims[4] = {static_cast<uint64_t>(n), rows_i, mats > 0 ? mats : 1, 1};
      const uint64_t strides[3] = {n * e, mat * e, dims[2] * mat * e};
      const int err = hopper::make_tma_map_f32(&maps[i], srcs[i], dims, strides, box);
      if (err != 0) return err;
    }
  }
  if (!wide) {
    void* args[] = {&maps[0], &maps[1], &maps[2], &maps[3], &maps[4], &x, &g, &mu, &nu, &scal,
                    &pv, &x_out, &mu_out, &nu_out, &dist, &B, &p, &n, &base_kind, &nesterov,
                    &tma, &vec};
    return launch(kernel, kTcSmemBytes, grid, static_cast<cudaStream_t>(stream), args, kTcThreads);
  }
  void* args[] = {&maps[0], &maps[1], &maps[2], &maps[3], &maps[4], &maps[5], &x, &g, &mu, &nu,
                  &scal, &pv, &x_out, &mu_out, &nu_out, &dist, &park, &B, &p, &n, &base_kind,
                  &nesterov};
  return launch(tma ? kernel : wide_plain, kWSmemBytes, grid, static_cast<cudaStream_t>(stream),
                args, kWThreads);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one CTA at p, in bytes (ops.py mirrors it).
int fused_tc_smem_bytes(int p) { return p > kTcP ? kWSmemBytes : kTcSmemBytes; }

// Floats of the wide kernel's park a block (min(B, SMs) blocks): M's rows
// 0..63, then the kept blocks of A and B (fused_step.park mirrors it); the
// field's park holds the kept blocks alone (kWKeep floats, rows = 0).
int fused_tc_park_floats(int n) { return 64 * n + kWKeep; }

// method: 0 POGO, 1 Landing (the fixed step). p <= 128 (p > 64: the wide
// kernel, which needs park, min(B, SMs) x fused_tc_park_floats(n)); any n.
// TMA loads when n % 4 == 0 and every operand is 16-byte aligned, plain
// loads by the producer warpgroup otherwise.
int fused_step_tc(const float* x, const float* g, const float* mu, const float* nu,
                  const float* scal, const int* pv, float* x_out, float* mu_out, float* nu_out,
                  float* dist, int B, int p, int n, int base_kind, int nesterov, int method,
                  float* park, void* stream) {
  if (B < 0 || p < 1 || p > kWP || n < 1 || (method != kPogo && method != kLanding) ||
      base_kind < kNone || base_kind > kVAdam || (p > kTcP && park == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool landing = method == kLanding, wide = p > kTcP;
  using K = const void*;
  const K kernel = wide ? (landing ? K(fused_tc_wide_kernel<kLanding, false, true>)
                                   : K(fused_tc_wide_kernel<kPogo, false, true>))
                        : (landing ? K(fused_tc_kernel<kLanding>) : K(fused_tc_kernel<kPogo>));
  const K plain = landing ? K(fused_tc_wide_kernel<kLanding, false, false>)
                          : K(fused_tc_wide_kernel<kPogo, false, false>);
  return launch_tc(kernel, plain, x, g, mu, nu, scal, pv, x_out, mu_out, nu_out, dist, park, B,
                   p, n, base_kind, nesterov, stream);
}

// The two-stage POGO update X' = (1 + lam) M - lam (M M^T) M, M = X -
// eta/2 (A G - B X), into out (which may be x, never g), and Landing's
// field Lambda = 1/2 (A G - B X) + lam (A X - X) into out (never x or g),
// as two_stage.cu's pogo_update_tiled and landing_field_tiled compute
// them; scal[8] = [eta, lam, 1, 0...] (the field reads lam alone). Both
// take p <= 128 (p > 64: the wide kernel and its park, min(B, SMs) blocks
// of fused_tc_park_floats(n) floats for the update, of kWKeep for the
// field); any n; TMA or plain loads as fused_step_tc.
int pogo_update_tc(const float* x, const float* g, const float* scal, float* out, int B, int p,
                   int n, float* park, void* stream) {
  if (B < 0 || p < 1 || p > kWP || n < 1 || (p > kTcP && park == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  using K = const void*;
  const K kernel = p > kTcP ? K(fused_tc_wide_kernel<kPogo, true, true>)
                            : K(fused_tc_kernel<kPogo, true>);
  return launch_tc(kernel, K(fused_tc_wide_kernel<kPogo, true, false>), x, g, nullptr, nullptr,
                   scal, nullptr, out, nullptr, nullptr, nullptr, park, B, p, n, kNone, 0,
                   stream);
}

int landing_field_tc(const float* x, const float* g, const float* scal, float* out, int B,
                     int p, int n, float* park, void* stream) {
  if (B < 0 || p < 1 || p > kWP || n < 1 || (p > kTcP && park == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  using K = const void*;
  const K kernel = p > kTcP ? K(fused_tc_wide_kernel<kLanding, true, true>)
                            : K(fused_tc_kernel<kLanding, true>);
  return launch_tc(kernel, K(fused_tc_wide_kernel<kLanding, true, false>), x, g, nullptr,
                   nullptr, scal, nullptr, out, nullptr, nullptr, nullptr, park, B, p, n, kNone,
                   0, stream, false);
}

// d (64, 64) = a (64, 8) b (64, 8)^T through one TF32 wgmma (a_regs: A from
// registers); row-major fp32 device arrays.
int tf32_probe(const float* a, const float* b, float* d, int a_regs, void* stream) {
  void* args[] = {&a, &b, &d, &a_regs};
  return launch(reinterpret_cast<const void*>(tf32_probe_kernel), 2 * kTcTileBytes + 1024, 1,
                static_cast<cudaStream_t>(stream), args, 128);
}

}  // extern "C"
