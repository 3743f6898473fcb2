// Tiled fused POGO and Landing group steps for Hopper (sm_90a) on the
// tensor cores: 3xTF32 wgmma products fed by a TMA ring, for p <= 64; and,
// from the same kernel with no base stage and no telemetry, the two-stage
// POGO update and landing field.
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
#include "tiles.cuh"

namespace {

constexpr int kTcP = 64;                          // rows of a tile: p <= 64
constexpr int kTcBoxBytes = kTcP * 128;           // 64 rows x 32 fp32 columns
constexpr int kTcTileBytes = 2 * kTcBoxBytes;     // a 64-column chunk of one operand
constexpr int kTcChunk = 64;
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

// Byte offset of element (row, col) of a 64 x 64 fp32 tile: two 64 x 32
// boxes, 128-byte swizzled, as TMA writes them and the descriptors read.
__host__ __device__ inline int tc_off(int row, int col) {
  return (col >> 5) * kTcBoxBytes + row * 128 + ((((col & 31) >> 2) ^ (row & 7)) << 4) +
         ((col & 3) << 2);
}

__device__ inline float& tc_at(unsigned char* tile, int row, int col) {
  return *reinterpret_cast<float*>(tile + tc_off(row, col));
}

// Descriptor of k8 step kk (K = 64, kk < 8) of a K-major tile.
__device__ inline uint64_t tc_desc(const unsigned char* tile, int kk) {
  return hopper::sw128_desc(tile + (kk >> 2) * kTcBoxBytes + (kk & 3) * 32, 16, 1024);
}

// Row and column of accumulator element i of consumer thread t.
__device__ inline int acc_row(int t, int i) { return 16 * (t >> 5) + ((t & 31) >> 2) + 8 * ((i >> 1) & 1); }
__device__ inline int acc_col(int t, int i) { return 8 * (i >> 2) + 2 * (t & 3) + (i & 1); }

// v rounded to TF32 (to nearest, ties away from zero, as cvt.rna.tf32.f32
// rounds) by integer operations, which issue at full rate; the low 13 bits
// of the result are zero. A NaN stays NaN or, for payloads at the top of
// the range, becomes a zero whose lo piece is the NaN.
__device__ inline float tf32_round(float v) {
  return __uint_as_float((__float_as_uint(v) + 0x1000u) & 0xFFFFE000u);
}

__device__ inline void split(float v, float& hi, float& lo) {
  hi = tf32_round(v);
  lo = tf32_round(v - hi);
}

// lo of v when the tensor cores read v itself as hi (its low 13 bits dropped).
__device__ inline float trunc_lo(float v) {
  return tf32_round(v - __uint_as_float(__float_as_uint(v) & 0xFFFFE000u));
}

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
// persistent grid of one CTA per SM (at most B), and the launch.
int launch_tc(const void* kernel, const float* x, const float* g, const float* mu,
              const float* nu, const float* scal, const int* pv, float* x_out, float* mu_out,
              float* nu_out, float* dist, int B, int p, int n, int base_kind, int nesterov,
              void* stream) {
  const void* rows[] = {x, g, x_out, base_kind != kNone ? mu : x,
                        base_kind != kNone ? mu_out : x_out};
  int vec = vector_ok(n, rows, 5);
  int tma = vec;
  CUtensorMap maps[5] = {};  // x, g, mu, mu_out, x_out
  if (tma) {
    const uint64_t e = sizeof(float);
    const uint64_t dims[4] = {static_cast<uint64_t>(n), static_cast<uint64_t>(p),
                              static_cast<uint64_t>(B > 0 ? B : 1), 1};
    const uint64_t strides[3] = {n * e, dims[1] * n * e, dims[2] * dims[1] * n * e};
    const uint32_t box[4] = {32, kTcP, 1, 1};
    const float* srcs[5] = {x, g, mu, mu_out, x_out};
    for (int i = 0; i < 5; ++i) {
      if (srcs[i] == nullptr) continue;
      const int err = hopper::make_tma_map_f32(&maps[i], srcs[i], dims, strides, box);
      if (err != 0) return err;
    }
  }
  int sms = 0, dev = 0;
  cudaError_t cerr = cudaGetDevice(&dev);
  if (cerr == cudaSuccess) cerr = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const int grid = B < sms ? B : sms;
  void* args[] = {&maps[0], &maps[1], &maps[2], &maps[3], &maps[4], &x, &g, &mu, &nu, &scal,
                  &pv, &x_out, &mu_out, &nu_out, &dist, &B, &p, &n, &base_kind, &nesterov,
                  &tma, &vec};
  return launch(kernel, kTcSmemBytes, grid, static_cast<cudaStream_t>(stream), args, kTcThreads);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one CTA, in bytes (ops.py mirrors it).
int fused_tc_smem_bytes() { return kTcSmemBytes; }

// method: 0 POGO, 1 Landing (the fixed step). p <= 64; any n. TMA loads
// when n % 4 == 0 and every operand is 16-byte aligned, plain loads by the
// producer warpgroup otherwise.
int fused_step_tc(const float* x, const float* g, const float* mu, const float* nu,
                  const float* scal, const int* pv, float* x_out, float* mu_out, float* nu_out,
                  float* dist, int B, int p, int n, int base_kind, int nesterov, int method,
                  void* stream) {
  if (B < 0 || p < 1 || p > kTcP || n < 1 || (method != kPogo && method != kLanding) ||
      base_kind < kNone || base_kind > kVAdam)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel = method == kLanding
      ? reinterpret_cast<const void*>(fused_tc_kernel<kLanding>)
      : reinterpret_cast<const void*>(fused_tc_kernel<kPogo>);
  return launch_tc(kernel, x, g, mu, nu, scal, pv, x_out, mu_out, nu_out, dist, B, p, n,
                   base_kind, nesterov, stream);
}

// The two-stage POGO update X' = (1 + lam) M - lam (M M^T) M, M = X -
// eta/2 (A G - B X), into out (which may be x, never g), and Landing's
// field Lambda = 1/2 (A G - B X) + lam (A X - X) into out (never x or g),
// as two_stage.cu's pogo_update_tiled and landing_field_tiled compute
// them; scal[8] = [eta, lam, 1, 0...] (the field reads lam alone). p <=
// 64; any n; TMA or plain loads as fused_step_tc.
int pogo_update_tc(const float* x, const float* g, const float* scal, float* out, int B, int p,
                   int n, void* stream) {
  if (B < 0 || p < 1 || p > kTcP || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_tc(reinterpret_cast<const void*>(fused_tc_kernel<kPogo, true>), x, g, nullptr,
                   nullptr, scal, nullptr, out, nullptr, nullptr, nullptr, B, p, n, kNone, 0,
                   stream);
}

int landing_field_tc(const float* x, const float* g, const float* scal, float* out, int B,
                     int p, int n, void* stream) {
  if (B < 0 || p < 1 || p > kTcP || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_tc(reinterpret_cast<const void*>(fused_tc_kernel<kLanding, true>), x, g,
                   nullptr, nullptr, scal, nullptr, out, nullptr, nullptr, nullptr, B, p, n,
                   kNone, 0, stream);
}

// d (64, 64) = a (64, 8) b (64, 8)^T through one TF32 wgmma (a_regs: A from
// registers); row-major fp32 device arrays.
int tf32_probe(const float* a, const float* b, float* d, int a_regs, void* stream) {
  void* args[] = {&a, &b, &d, &a_regs};
  return launch(reinterpret_cast<const void*>(tf32_probe_kernel), 2 * kTcTileBytes + 1024, 1,
                static_cast<cudaStream_t>(stream), args, 128);
}

}  // extern "C"
