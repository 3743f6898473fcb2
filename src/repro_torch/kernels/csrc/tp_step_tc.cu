// Tensor-parallel fused group step for Hopper (sm_90a) on the tensor cores:
// 3xTF32 wgmma products fed by a TMA ring, for p <= 64 at n % 4 == 0 (a row
// stride TMA can take).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/fused_step.py:
//   tp_gram_tc   <- tp_gram_whole  (:304, body _tp_gram_kernel :266)
//   tp_apply_tc  <- tp_apply_whole (:417, body _tp_apply_kernel :360)
// for the shapes ops.plan_tp_route gives them; tp_step.cu's CUDA-core
// kernels take the rest, and its header has the algebra. What each
// computes is ref.tp_partial_ref and ref.tp_apply_ref.
//
// Bound, at SmolLM-360M's q/k sharded over two ranks, 640 x (64, 480):
// tp_gram moves 5 HBM passes of 4 p n bytes a matrix (read X, g, mu; write
// mu', Gb) and the payload, 0.1268 ms at 3.35 TB/s; its grams are 5 p^2 n
// flops (A symmetric), three TF32 products each here (0.0381 ms at 495
// TFLOP/s). tp_apply reads X, Gb and the payload and writes X' (0.0798
// ms), for three p x p x n products and the (p, p) algebra (3xTF32: 0.0661
// ms for POGO).
//
// Design:
// * fp32 accuracy on the tensor cores as in fused_step_tc.cu: an operand x
//   is hi + lo, a product sums hi.lo and lo.hi, then hi.hi, dropping lo.lo.
//   A tile that holds x itself is its own hi (the card reads an fp32
//   operand with its low 13 bits dropped) and beside it only lo =
//   tf32(x - trunc(x)) is written. Each 64-column chunk's grams start from
//   zero and are added to fp32 sums in registers.
// * tp_gram: one persistent CTA per SM walks the matrices. One lane of the
//   producer warpgroup keeps a ring of kGramSlots operand tiles (a 64-column
//   chunk of X, g or mu: two TMA boxes of 64 rows x 32 fp32 columns,
//   128-byte swizzled, rows past p and columns past n zero-filled) in
//   flight on mbarriers, into the next matrix. Two consumer warpgroups take
//   the chunks in turns: each runs the base stage in the tiles (mu' over
//   mu's tile, Gb over g's tile, each stored by TMA), writes its lo tiles
//   of X and Gb, and adds the chunk's A = X X^T, B = X Gb^T and S = Gb Gb^T
//   to its sums. At a matrix's end warpgroup 1's sums are added to
//   warpgroup 0's (always in that order), which stores the payload row
//   [A | B | S (| sum g^2)], row-major.
// * tp_apply: two launches. tp_alg_kernel, one CTA (one warpgroup) a
//   matrix, two CTAs a SM, forms the (p, p) algebra from the payload on the
//   tensor cores (B and S scaled by vadam's scl and scl^2 first):
//     U = S A - B^T B^T,  V = A B^T - B A = 2 R X^T,
//     4 R R^T = U^T A - V B^T,
//   and the sweep's two operators, POGO's land folded into them: with
//   P = -(c/2) A and Q = (c/2) B (c = eta scl), M = X + P Gb + Q X and
//   X' = (I - lam E) M, E = C - I = (A - I) + eta^2 R R^T, so
//     X' = X + P' Gb + Q' X,  P' = (I - lam E) P,  Q' = (I - lam E) Q - lam E;
//   Landing's X' = X + P Gb + (Q - eta lam (A - I)) X as it stands. The
//   distance: POGO's from X' X'^T - I = (1 - 2 lam) E + (lam^2 - 2 lam) E^2
//   + lam^2 E^3 (the gram identity in E), Landing's from W - I = E_A - 2 eta
//   lam (E_A + E_A^2) + eta^2 (R R^T + lam/2 (V E_A + (V E_A)^T) + lam^2
//   (E_A^2 + E_A^3)), E_A = A - I: every term small near the manifold, pv
//   masking the identity's rows, and the same on every rank (the payload is
//   replicated). Its products take both operands from shared memory where
//   both are K-major (a difference through the negated-A product), one
//   from registers where it is read transposed. P' and Q' go to a (B, 2, p,
//   p) scratch. tp_apply_sweep_kernel then streams the rank's columns as
//   tp_gram does (X and Gb chunks, two consumer warpgroups in turns): with
//   P' and Q' resident in shared memory, hi and lo, it forms X'^T = X^T +
//   Gb^T P'^T + X^T Q'^T (register A operands read from the tiles) in the X
//   tile, stored by TMA.
//   The algebra is a launch of its own, not serialised in front of each
//   matrix's sweep: it needs seven (p, p) tiles of shared memory, and the
//   sweep's ring and operators fill a block's 227 KB, so one block cannot
//   run one matrix's algebra beside another's sweep.
// * The sweeps' operands are zero past p and n, so every product is exact
//   there and the TMA stores clip at the tensor's edges. x_out may be x and
//   mu_out mu: a chunk is stored only after it was loaded, and never
//   loaded again.
//
// Scalars ride scal[8] = [eta, lam, post_scale, h0, ...] as in tp_step.cu.
// Every launcher returns cudaGetLastError(), or a tensor map's error.

#include "hopper.cuh"
#include "tf32_tile.cuh"
#include "tiles.cuh"

namespace {

// The gram and the sweep: two consumer warpgroups taking chunks in turns
// (one overlaps its base stage or fragments, stores and barriers with the
// other's products) and the producer's; the algebra: one warpgroup.
constexpr int kTpConsumers = 128;                 // a warpgroup
constexpr int kWgConsumers = 256;
constexpr int kWgThreads = kWgConsumers + 128;
constexpr int kConsumerBar = 1;  // named barriers: 1 and 2 each warpgroup's, 3 both
constexpr int kBothBar = 3;

// tp_gram: the producer's warpgroup gives up registers to the consumers
// (24 + 2 x 240 = 3 x 168 a thread); the ring (three chunks of X, g and
// mu), each consumer warpgroup's lo tiles of X and Gb, the reduction
// scratch, the full and empty barriers.
constexpr int kGramProducerRegs = 24;
constexpr int kGramConsumerRegs = 240;
constexpr int kGramSlots = 9;
constexpr int kGramLoOff = kGramSlots * kTcTileBytes;
constexpr int kGramRedOff = kGramLoOff + 4 * kTcTileBytes;
constexpr int kGramBarOff = kGramRedOff + 64;
constexpr int kGramSmemBytes = kGramBarOff + 8 * 2 * kGramSlots + 1024;  // + room to align

// tp_apply's sweep: the ring (five chunks of X and Gb), the hi and lo
// tiles of its operators P' and Q', the barriers.
constexpr int kApplySlots = 10;
constexpr int kApplyOpOff = kApplySlots * kTcTileBytes;
constexpr int kApplyBarOff = kApplyOpOff + 4 * kTcTileBytes;
constexpr int kApplySmemBytes = kApplyBarOff + 8 * 2 * kApplySlots + 1024;

// tp_apply's algebra: seven (p, p) tiles (A, B and B^T with their lo
// pieces, and S; later U, V, E, E^2, the reduction scratch over the ones
// that are done), so that two blocks share an SM at the most shared
// memory an SM gives.
constexpr int kAlgThreads = 128;
constexpr int kAlgTiles = 7;
// Elements of the (p, p) operands a thread loads from HBM before it stores
// any: one round of load latency a batch, not one an element.
constexpr int kLoadBatch = 16;
constexpr int kAlgSmemBytes = kAlgTiles * kTcTileBytes + 1024;

// Sum over the algebra's warpgroup, the same on every thread, in a fixed
// order.
__device__ float wg_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  hopper::named_sync(kConsumerBar, kTpConsumers);  // red may still be read
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  hopper::named_sync(kConsumerBar, kTpConsumers);
  return (red[0] + red[1]) + (red[2] + red[3]);
}

// Makes the algebra's shared-memory writes visible to its next wgmma.
__device__ inline void publish_smem() {
  hopper::fence_proxy_async_smem();
  hopper::named_sync(kConsumerBar, kTpConsumers);
}

// Issues d (+)= s A B^T over K = 64 from the smem tiles of A (ah, the
// value itself or its hi, and al, its lo) and B (bh, bl), 3xTF32, small
// terms first; s = -1 with kNeg (the products' imm-scale-a). The caller
// fences, commits and waits.
template <bool kNeg = false>
__device__ inline void ss_issue(float (&d)[32], const unsigned char* ah, const unsigned char* al,
                                const unsigned char* bh, const unsigned char* bl, int accumulate) {
  auto mma = [&](uint64_t x, uint64_t y, int acc) {
    if (kNeg)
      hopper::wgmma_tf32_ss_neg(d, x, y, acc);
    else
      hopper::wgmma_tf32_ss(d, x, y, acc);
  };
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    mma(tc_desc(ah, kk), tc_desc(bl, kk), accumulate || kk > 0);
    mma(tc_desc(al, kk), tc_desc(bh, kk), 1);
  }
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) mma(tc_desc(ah, kk), tc_desc(bh, kk), 1);
}

// The register A operand a(m, k) over K = 64, split into hi and lo, in
// the m64k8 fragments of hopper.cuh's header (k8 step kk in fh[kk], fl[kk]).
template <typename Val>
__device__ inline void frags(uint32_t (&fh)[8][4], uint32_t (&fl)[8][4], Val a) {
  const int t = threadIdx.x & 127, m0 = 16 * (t >> 5) + ((t & 31) >> 2), k0 = t & 3;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float hi, lo;
      split(a(m0 + 8 * (r & 1), 8 * kk + k0 + 4 * (r >> 1)), hi, lo);
      fh[kk][r] = __float_as_uint(hi);
      fl[kk][r] = __float_as_uint(lo);
    }
  }
}

__device__ inline void fence_frags(uint32_t (&fh)[8][4], uint32_t (&fl)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    hopper::fence_regs(fh[kk]);
    hopper::fence_regs(fl[kk]);
  }
}

// Issues d (+)= a B^T over K = 64, a the register fragments of frags(), B
// the smem tiles bh and bl; 3xTF32, small terms first.
__device__ inline void rs_issue(float (&d)[32], const uint32_t (&fh)[8][4],
                                const uint32_t (&fl)[8][4], const unsigned char* bh,
                                const unsigned char* bl, int accumulate) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    hopper::wgmma_tf32_rs(d, fh[kk][0], fh[kk][1], fh[kk][2], fh[kk][3], tc_desc(bl, kk),
                          accumulate || kk > 0);
    hopper::wgmma_tf32_rs(d, fl[kk][0], fl[kk][1], fl[kk][2], fl[kk][3], tc_desc(bh, kk), 1);
  }
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    hopper::wgmma_tf32_rs(d, fh[kk][0], fh[kk][1], fh[kk][2], fh[kk][3], tc_desc(bh, kk), 1);
}

// d = A B^T over K = 64 from smem tiles (ss_issue), waited for.
__device__ inline void gram_tc(float (&d)[32], const unsigned char* ah, const unsigned char* al,
                               const unsigned char* bh, const unsigned char* bl) {
  hopper::fence_regs(d);
  hopper::wgmma_fence();
  ss_issue(d, ah, al, bh, bl, 0);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(d);
}

// d (+)= a B^T over K = 64, a(m, k) the register operand, waited for.
// Element i of d is (acc_row, acc_col).
template <typename Val>
__device__ inline void prod(float (&d)[32], Val a, const unsigned char* bh,
                            const unsigned char* bl, int accumulate) {
  uint32_t fh[8][4], fl[8][4];
  frags(fh, fl, a);
  hopper::fence_regs(d);
  fence_frags(fh, fl);
  hopper::wgmma_fence();
  rs_issue(d, fh, fl, bh, bl, accumulate);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(d);
  fence_frags(fh, fl);
}

// Operand tile `tt` of the sequence the producer loads, waited for, and
// the release of `count` tiles from tt once every consumer warp is done.
__device__ inline unsigned char* tile_wait(unsigned char* ring, uint64_t* full, int tt, int slots) {
  hopper::mbar_wait(full + tt % slots, (tt / slots) & 1);
  return ring + (tt % slots) * kTcTileBytes;
}

__device__ inline void tiles_release(uint64_t* empty, int tt, int count, int slots) {
  if ((threadIdx.x & 31) == 0)
    for (int o = 0; o < count; ++o) hopper::mbar_arrive(empty + (tt + o) % slots);
}

// The producer lane: `ops` operand tiles a 64-column chunk, every chunk of
// every matrix of this block, in the order the consumers take them.
__device__ inline void produce(const CUtensorMap* const* maps, int ops, unsigned char* ring,
                               uint64_t* full, uint64_t* empty, int slots, int B, int n) {
  const int nc = (n + kTcChunk - 1) / kTcChunk;
  int tt = 0;
  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    for (int c = 0; c < nc; ++c) {
      for (int o = 0; o < ops; ++o, ++tt) {
        const int s = tt % slots;
        if (tt >= slots) hopper::mbar_wait(empty + s, (tt / slots - 1) & 1);
        unsigned char* st = ring + s * kTcTileBytes;
        hopper::mbar_expect_tx(full + s, kTcTileBytes);
        for (int bx = 0; bx < 2; ++bx)
          hopper::tma_load_4d(st + bx * kTcBoxBytes, maps[o], full + s, c * kTcChunk + 32 * bx,
                              0, b, 0);
      }
    }
  }
}

__device__ inline void ring_init(uint64_t* full, uint64_t* empty, int slots) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < slots; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, kTpConsumers / 32);  // one arrival a warp of its warpgroup
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
}

// Chunk c of matrix b from a tile to HBM through TMA (its two boxes), one
// thread; committed here, the caller waits before the tile is reused.
__device__ inline void tile_store(const CUtensorMap* map, const unsigned char* tile, int c, int b) {
  for (int bx = 0; bx < 2; ++bx)
    hopper::tma_store_4d(map, tile + bx * kTcBoxBytes, c * kTcChunk + 32 * bx, 0, b, 0);
  hopper::bulk_commit();
}

// ------------------------------------------------------------------ gram

// One of a matrix's three sums (A, B or S) of warpgroup 1 added into
// warpgroup 0's through xch (16 KB), in the same place of each thread.
__device__ inline void add_wg1(float (&v)[32], float* xch, int wg, int lt) {
  hopper::named_sync(kBothBar, kWgConsumers);  // xch is free
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < 32; ++i) xch[i * 128 + lt] = v[i];
  }
  hopper::named_sync(kBothBar, kWgConsumers);
  if (wg == 0) {
#pragma unroll
    for (int i = 0; i < 32; ++i) v[i] += xch[i * 128 + lt];
  }
}

__global__ void __launch_bounds__(kWgThreads, 1)
tp_gram_tc_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_g,
                  const __grid_constant__ CUtensorMap tm_mu,
                  const __grid_constant__ CUtensorMap tm_gb,
                  const __grid_constant__ CUtensorMap tm_mu_out, const float* scal, float* payload,
                  int B, int p, int n, int K, int base_kind, int nesterov) {
  extern __shared__ unsigned char tp_gram_tc_smem[];
  unsigned char* ring = hopper::smem_align1024(tp_gram_tc_smem);
  float* red = reinterpret_cast<float*>(ring + kGramRedOff);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kGramBarOff);
  uint64_t* empty = full + kGramSlots;
  const int tid = threadIdx.x;
  const int ops = base_kind != kNone ? 3 : 2;  // tiles a chunk: X, g (, mu)
  ring_init(full, empty, kGramSlots);

  if (tid >= kWgConsumers) {  // the producer's warpgroup: one lane issues every load
    hopper::reg_dealloc<kGramProducerRegs>();
    if (tid == kWgConsumers) {
      const CUtensorMap* maps[3] = {&tm_x, &tm_g, &tm_mu};
      produce(maps, ops, ring, full, empty, kGramSlots, B, n);
    }
    return;
  }
  hopper::reg_alloc<kGramConsumerRegs>();

  // Warpgroup wg takes the chunks j of this block's sequence with j % 2 ==
  // wg, with lo tiles of its own; lt is the thread's place in its
  // warpgroup, bar its named barrier.
  const int wg = tid >> 7, lt = tid & 127, bar = kConsumerBar + wg;
  unsigned char* lo_x = ring + kGramLoOff + 2 * wg * kTcTileBytes;
  unsigned char* lo_g = lo_x + kTcTileBytes;
  float* xch = reinterpret_cast<float*>(ring + kGramLoOff + 2 * kTcTileBytes);  // wg 1's lo_x
  const float ps = scal[2], h0 = scal[3];
  const bool scale = base_kind != kVAdam && ps != 1.f;
  const bool nest = base_kind == kTrace && nesterov;
  const int nc = (n + kTcChunk - 1) / kTcChunk, pp = p * p;
  int j0 = 0;  // chunks of this block's earlier matrices
  for (int b = blockIdx.x; b < B; b += gridDim.x, j0 += nc) {
    float a_sum[32], b_sum[32], s_sum[32], part[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) a_sum[i] = b_sum[i] = s_sum[i] = 0.f;
    float sq = 0.f;
    for (int c = (j0 + wg) & 1; c < nc; c += 2) {
      const int tt = ops * (j0 + c);  // the chunk's X, g (and mu) tiles
      unsigned char* tx = tile_wait(ring, full, tt, kGramSlots);
      unsigned char* tg = tile_wait(ring, full, tt + 1, kGramSlots);
      unsigned char* tm = base_kind != kNone ? tile_wait(ring, full, tt + 2, kGramSlots) : nullptr;
      for (int u = lt; u < kTcP * kTcChunk / 4; u += 128) {
        const int row = u >> 4, col = 4 * (u & 15), off = tc_off(row, col);
        float xv[4], gv[4], hv[4];
        load4(xv, *reinterpret_cast<const float4*>(tx + off));
        load4(gv, *reinterpret_cast<const float4*>(tg + off));
        if (base_kind != kNone) {
          float mv[4];
          load4(mv, *reinterpret_cast<const float4*>(tm + off));
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float m2;
            if (base_kind == kTrace) {
              m2 = h0 * mv[e] + gv[e];
            } else {
              m2 = h0 * mv[e] + (1.f - h0) * gv[e];
              sq = fmaf(gv[e], gv[e], sq);
            }
            mv[e] = m2;
            gv[e] = nest ? h0 * m2 + gv[e] : m2;
          }
          *reinterpret_cast<float4*>(tm + off) = make_float4(mv[0], mv[1], mv[2], mv[3]);
        }
        if (scale) {
#pragma unroll
          for (int e = 0; e < 4; ++e) gv[e] *= ps;
        }
        *reinterpret_cast<float4*>(tg + off) = make_float4(gv[0], gv[1], gv[2], gv[3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) hv[e] = trunc_lo(xv[e]);
        *reinterpret_cast<float4*>(lo_x + off) = make_float4(hv[0], hv[1], hv[2], hv[3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) hv[e] = trunc_lo(gv[e]);
        *reinterpret_cast<float4*>(lo_g + off) = make_float4(hv[0], hv[1], hv[2], hv[3]);
      }
      hopper::fence_proxy_async_smem();
      hopper::named_sync(bar, 128);
      if (lt == 0) {  // Gb (and mu') leave from their tiles
        tile_store(&tm_gb, tg, c, b);
        if (tm != nullptr) tile_store(&tm_mu_out, tm, c, b);
      }
      gram_tc(part, tx, lo_x, tx, lo_x);
#pragma unroll
      for (int i = 0; i < 32; ++i) a_sum[i] += part[i];
      gram_tc(part, tx, lo_x, tg, lo_g);
#pragma unroll
      for (int i = 0; i < 32; ++i) b_sum[i] += part[i];
      gram_tc(part, tg, lo_g, tg, lo_g);
#pragma unroll
      for (int i = 0; i < 32; ++i) s_sum[i] += part[i];
      if (lt == 0) hopper::bulk_wait_read<0>();  // the stores have read their tiles
      hopper::named_sync(bar, 128);  // every warp is done with the tiles
      tiles_release(empty, tt, ops, kGramSlots);
    }
    // The matrix's sums: warpgroup 1's added to warpgroup 0's (in that
    // order, whatever the timing), which writes the payload row.
    add_wg1(a_sum, xch, wg, lt);
    add_wg1(b_sum, xch, wg, lt);
    add_wg1(s_sum, xch, wg, lt);
    hopper::named_sync(kBothBar, kWgConsumers);  // xch is read: wg 1's lo tiles are its own again
    float* row = payload + static_cast<size_t>(b) * K;
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = acc_row(lt, i), cc = acc_col(lt, i);
        if (r < p && cc < p) {
          row[r * p + cc] = a_sum[i];
          row[pp + r * p + cc] = b_sum[i];
          row[2 * pp + r * p + cc] = s_sum[i];
        }
      }
    }
    if (base_kind == kVAdam) {  // sum g^2 over both warpgroups, in a fixed order
      for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
      hopper::named_sync(kBothBar, kWgConsumers);  // red may still be read
      if ((tid & 31) == 0) red[tid >> 5] = sq;
      hopper::named_sync(kBothBar, kWgConsumers);
      if (tid == 0)
        row[3 * pp] = ((red[0] + red[1]) + (red[2] + red[3])) +
                      ((red[4] + red[5]) + (red[6] + red[7]));
    }
  }
  if (lt == 0) hopper::bulk_wait<0>();  // the last Gb and mu'
}

// --------------------------------------------------------------- algebra

// Writes v (and, with lo, its lo piece) at element (r, c) of a tile.
__device__ inline void put(unsigned char* t, unsigned char* lo, int r, int c, float v) {
  tc_at(t, r, c) = v;
  if (lo != nullptr) tc_at(lo, r, c) = trunc_lo(v);
}

// One matrix a CTA of one warpgroup: the sweep's operators P' and Q' (into
// ops, row-major (2, p, p) a matrix) and the distance, from the payload row
// (the header's algebra). Seven (p, p) tiles T[0..6] in the swizzled tile
// layout, zero past p, each a value (its own hi, or a register operand's
// source) or a lo piece; products from two smem tiles where both operands
// are K-major, with a register operand where one is read transposed.
template <int kMethod>
__global__ void __launch_bounds__(kAlgThreads)
tp_alg_kernel(const float* payload, const float* scl, const float* scal, const int* pv,
              float* ops, float* dist, int p, int K) {
  extern __shared__ unsigned char tp_alg_smem[];
  unsigned char* base = hopper::smem_align1024(tp_alg_smem);
  unsigned char* T[kAlgTiles];
  for (int i = 0; i < kAlgTiles; ++i) T[i] = base + i * kTcTileBytes;
  const int tid = threadIdx.x, b = blockIdx.x, pp = p * p;
  const float eta = scal[0], lam = scal[1];
  const float s = scl != nullptr ? scl[b] : 1.f, cf = eta * s;
  const int pvb = pv != nullptr ? pv[b] : p;
  const float* row = payload + static_cast<size_t>(b) * K;
  float* op_p = ops + static_cast<size_t>(b) * 2 * pp;  // P', then Q'
  float* op_q = op_p + pp;

  // A, B (scaled by s) and B^T with their lo pieces; S (scaled by s^2), a
  // register operand's source alone.
  for (int u0 = 0; u0 < kTcP * kTcP; u0 += kLoadBatch * kAlgThreads) {
    float v[3][kLoadBatch];  // a batch's loads in flight together
#pragma unroll
    for (int j = 0; j < kLoadBatch; ++j) {
      const int u = u0 + j * kAlgThreads + tid, r = u >> 6, c = u & 63;
      const bool in = r < p && c < p;
#pragma unroll
      for (int q = 0; q < 3; ++q) v[q][j] = in ? __ldg(row + q * pp + r * p + c) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kLoadBatch; ++j) {
      const int u = u0 + j * kAlgThreads + tid, r = u >> 6, c = u & 63;
      put(T[0], T[1], r, c, v[0][j]);
      put(T[2], T[3], r, c, s * v[1][j]);
      put(T[5], T[6], c, r, s * v[1][j]);
      put(T[4], nullptr, r, c, (s * s) * v[2][j]);
    }
  }
  publish_smem();

  float d1[32], d2[32], w[32];
  uint32_t fh[8][4], fl[8][4];
  // U = S A - B^T B^T (d1) and V = A B^T - B A = 2 R X^T (d2).
  frags(fh, fl, [&](int m, int k) { return tc_at(T[4], m, k); });
  hopper::fence_regs(d1);
  hopper::fence_regs(d2);
  fence_frags(fh, fl);
  hopper::wgmma_fence();
  rs_issue(d1, fh, fl, T[0], T[1], 0);
  ss_issue<true>(d1, T[5], T[6], T[2], T[3], 1);
  ss_issue(d2, T[0], T[1], T[2], T[3], 0);
  ss_issue<true>(d2, T[2], T[3], T[0], T[1], 1);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(d1);
  hopper::fence_regs(d2);
  fence_frags(fh, fl);
  hopper::named_sync(kConsumerBar, kAlgThreads);  // S and B^T are read: U and V go over them
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = acc_row(tid, i), c = acc_col(tid, i);
    put(T[4], nullptr, r, c, d1[i]);
    put(T[5], T[6], r, c, d2[i]);
  }
  publish_smem();

  // 4 R R^T = U^T A - V B^T (d1).
  frags(fh, fl, [&](int m, int k) { return tc_at(T[4], k, m); });
  hopper::fence_regs(d1);
  fence_frags(fh, fl);
  hopper::wgmma_fence();
  rs_issue(d1, fh, fl, T[0], T[1], 0);
  ss_issue<true>(d1, T[5], T[6], T[2], T[3], 1);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(d1);
  fence_frags(fh, fl);
  hopper::named_sync(kConsumerBar, kAlgThreads);  // U and A's lo are read

  const float e2 = 0.25f * (eta * eta);  // R R^T's coefficient
  if (kMethod == kPogo) {
    // E = C - I = (A - I) + eta^2 R R^T over U (and V's tile);
    // X' X'^T - I = (1 - 2 lam) E + (lam^2 - 2 lam) E^2 + lam^2 E^3.
    unsigned char *tE = T[4], *tEl = T[5];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = acc_row(tid, i), c = acc_col(tid, i);
      const float e = tc_at(T[0], r, c) - (r == c && r < p ? 1.f : 0.f) + e2 * d1[i];
      put(tE, tEl, r, c, e);
      w[i] = (1.f - 2.f * lam) * e;
    }
    publish_smem();
    // E^2 (d1) and E A (d2): P' = (I - lam E) P = -(c/2) (A - lam E A).
    hopper::fence_regs(d1);
    hopper::fence_regs(d2);
    hopper::wgmma_fence();
    ss_issue(d1, tE, tEl, tE, tEl, 0);
    ss_issue(d2, tE, tEl, T[0], T[1], 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(d1);
    hopper::fence_regs(d2);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = acc_row(tid, i), c = acc_col(tid, i);
      put(T[6], T[3], r, c, d1[i]);  // E^2 over V's and B's lo
      w[i] += (lam * lam - 2.f * lam) * d1[i];
      if (r < p && c < p) op_p[r * p + c] = -0.5f * cf * (tc_at(T[0], r, c) - lam * d2[i]);
    }
    publish_smem();
    // (E B)^T = B^T E (d1, B^T read from B's tile) and E^3 = E^2 E (d2):
    // Q' = (I - lam E) Q - lam E, Q = (eta/2) B.
    frags(fh, fl, [&](int m, int k) { return tc_at(T[2], k, m); });
    hopper::fence_regs(d1);
    hopper::fence_regs(d2);
    fence_frags(fh, fl);
    hopper::wgmma_fence();
    rs_issue(d1, fh, fl, tE, tEl, 0);
    ss_issue(d2, T[6], T[3], tE, tEl, 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(d1);
    hopper::fence_regs(d2);
    fence_frags(fh, fl);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int m = acc_row(tid, i), n = acc_col(tid, i);  // d1 holds (E B)(n, m)
      if (m < p && n < p)
        op_q[n * p + m] = 0.5f * eta * (tc_at(T[2], n, m) - lam * d1[i]) - lam * tc_at(tE, n, m);
      w[i] += (lam * lam) * d2[i];
    }
  } else {
    // P' = P, Q' = Q - eta lam (A - I); with E = A - I,
    // W - I = E - 2 eta lam (E + E^2) + eta^2 (R R^T + lam/2 (V E + (V E)^T)
    //         + lam^2 (E^2 + E^3)).
    unsigned char *tE = T[4], *tEl = T[1];
    const float el = eta * lam;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = acc_row(tid, i), c = acc_col(tid, i);
      const float a = tc_at(T[0], r, c), e = a - (r == c && r < p ? 1.f : 0.f);
      if (r < p && c < p) {
        op_p[r * p + c] = -0.5f * cf * a;
        op_q[r * p + c] = 0.5f * eta * tc_at(T[2], r, c) - el * e;
      }
      put(tE, tEl, r, c, e);
      w[i] = (1.f - 2.f * el) * e + e2 * d1[i];
    }
    publish_smem();
    // V E (d1) and E^2 (d2).
    hopper::fence_regs(d1);
    hopper::fence_regs(d2);
    hopper::wgmma_fence();
    ss_issue(d1, T[5], T[6], tE, tEl, 0);
    ss_issue(d2, tE, tEl, tE, tEl, 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(d1);
    hopper::fence_regs(d2);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = acc_row(tid, i), c = acc_col(tid, i);
      put(T[2], nullptr, r, c, d1[i]);  // V E over B
      put(T[0], T[3], r, c, d2[i]);     // E^2 over A and B's lo
      w[i] += ((eta * eta) * (lam * lam) - 2.f * el) * d2[i];
    }
    publish_smem();
    const float k = 0.5f * (eta * eta) * lam;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = acc_row(tid, i), c = acc_col(tid, i);
      w[i] += k * (tc_at(T[2], r, c) + tc_at(T[2], c, r));
    }
    gram_tc(d2, T[0], T[3], tE, tEl);  // E^3 = E^2 E
#pragma unroll
    for (int i = 0; i < 32; ++i) w[i] += (eta * eta) * (lam * lam) * d2[i];
  }
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = acc_row(tid, i), c = acc_col(tid, i);
    const float v = w[i] + (r == c && r >= pvb && r < p ? 1.f : 0.f);  // - I_pv, not - I_p
    acc = fmaf(v, v, acc);
  }
  // the reduction scratch over A's lo (POGO) or V (Landing), read no more
  const float tot = wg_sum(acc, reinterpret_cast<float*>(kMethod == kPogo ? T[1] : T[5]));
  if (tid == 0) dist[b] = sqrtf(tot);
}

// ----------------------------------------------------------------- sweep

// X' = X + P' Gb + Q' X on every chunk, the operators P' and Q' (ops,
// from tp_alg_kernel) resident in shared memory, hi and lo.
__global__ void __launch_bounds__(kWgThreads, 1)
tp_apply_sweep_kernel(const __grid_constant__ CUtensorMap tm_x,
                      const __grid_constant__ CUtensorMap tm_gb,
                      const __grid_constant__ CUtensorMap tm_x_out, const float* ops, int B,
                      int p, int n) {
  extern __shared__ unsigned char tp_apply_tc_smem[];
  unsigned char* ring = hopper::smem_align1024(tp_apply_tc_smem);
  unsigned char* op = ring + kApplyOpOff;  // P' hi, P' lo, Q' hi, Q' lo
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kApplyBarOff);
  uint64_t* empty = full + kApplySlots;
  const int tid = threadIdx.x;
  ring_init(full, empty, kApplySlots);

  if (tid >= kWgConsumers) {  // the producer's warpgroup: one lane issues every load
    if (tid == kWgConsumers) {
      const CUtensorMap* maps[2] = {&tm_x, &tm_gb};
      produce(maps, 2, ring, full, empty, kApplySlots, B, n);
    }
    return;
  }

  // Warpgroup wg takes the chunks j of this block's sequence with j % 2 ==
  // wg; lt is the thread's place in its warpgroup, bar its named barrier.
  const int wg = tid >> 7, lt = tid & 127, bar = kConsumerBar + wg;
  const int nc = (n + kTcChunk - 1) / kTcChunk, pp = p * p;
  int j0 = 0;  // chunks of this block's earlier matrices
  for (int b = blockIdx.x; b < B; b += gridDim.x, j0 += nc) {
    // P' and Q', hi and lo, once both warpgroups are done with the last
    // matrix's products.
    hopper::named_sync(kBothBar, kWgConsumers);
    const float* ob = ops + static_cast<size_t>(b) * 2 * pp;
    for (int u0 = 0; u0 < kTcP * kTcP; u0 += kLoadBatch * kWgConsumers) {
      float v[2][kLoadBatch];  // a batch's loads in flight together
#pragma unroll
      for (int j = 0; j < kLoadBatch; ++j) {
        const int u = u0 + j * kWgConsumers + tid, r = u >> 6, c = u & 63;
        const bool in = r < p && c < p;
        v[0][j] = in ? __ldg(ob + r * p + c) : 0.f;
        v[1][j] = in ? __ldg(ob + pp + r * p + c) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kLoadBatch; ++j) {
        const int u = u0 + j * kWgConsumers + tid, r = u >> 6, c = u & 63;
#pragma unroll
        for (int o = 0; o < 2; ++o) {
          float hi, lo;
          split(v[o][j], hi, lo);
          tc_at(op + 2 * o * kTcTileBytes, r, c) = hi;
          tc_at(op + (2 * o + 1) * kTcTileBytes, r, c) = lo;
        }
      }
    }
    hopper::fence_proxy_async_smem();
    hopper::named_sync(kBothBar, kWgConsumers);

    for (int c = (j0 + wg) & 1; c < nc; c += 2) {
      const int tt = 2 * (j0 + c);  // the chunk's X and Gb tiles
      unsigned char* tx = tile_wait(ring, full, tt, kApplySlots);
      unsigned char* tg = tile_wait(ring, full, tt + 1, kApplySlots);
      // D^T = Gb^T P'^T + X^T Q'^T: element (m, row) of the chunk's column m
      // (one product's fragments at a time: both at once outgrow the 168
      // registers a thread of a 384-thread block has)
      float d[32];
      prod(d, [&](int m, int k) { return tc_at(tg, k, m); }, op, op + kTcTileBytes, 0);
      prod(d, [&](int m, int k) { return tc_at(tx, k, m); }, op + 2 * kTcTileBytes,
           op + 3 * kTcTileBytes, 1);
      hopper::named_sync(bar, 128);  // every warp has read X
#pragma unroll
      for (int i = 0; i < 32; ++i) tc_at(tx, acc_col(lt, i), acc_row(lt, i)) += d[i];  // X'
      hopper::fence_proxy_async_smem();
      hopper::named_sync(bar, 128);
      if (lt == 0) {
        tile_store(&tm_x_out, tx, c, b);
        hopper::bulk_wait_read<0>();
      }
      hopper::named_sync(bar, 128);  // the store has read X'
      tiles_release(empty, tt, 2, kApplySlots);
    }
  }
  if (lt == 0) hopper::bulk_wait<0>();  // the last X'
}

// 4-D fp32 tensor maps over (n, rows, B, 1) stacks, a 64-row x 32-column
// box each; null sources are skipped.
int make_maps(CUtensorMap* maps, const float* const* srcs, int count, int B, int p, int n) {
  const uint64_t e = sizeof(float), mat = static_cast<uint64_t>(p) * n;
  const uint32_t box[4] = {32, kTcP, 1, 1};
  const uint64_t dims[4] = {static_cast<uint64_t>(n), static_cast<uint64_t>(p),
                            static_cast<uint64_t>(B > 0 ? B : 1), 1};
  const uint64_t strides[3] = {n * e, mat * e, dims[2] * mat * e};
  for (int i = 0; i < count; ++i) {
    if (srcs[i] == nullptr) continue;
    const int err = hopper::make_tma_map_f32(&maps[i], srcs[i], dims, strides, box);
    if (err != 0) return err;
  }
  return 0;
}

// One CTA per SM, at most B.
int persistent_grid(int B, int* grid) {
  int sms = 0, dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *grid = B < sms ? B : sms;
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one CTA of each kernel, in bytes (ops.py
// mirrors them).
int tp_gram_tc_smem_bytes() { return kGramSmemBytes; }
int tp_apply_tc_smem_bytes() { return kApplySmemBytes; }
int tp_alg_smem_bytes() { return kAlgSmemBytes; }

// Blocks of the algebra kernel (method 0 POGO, 1 Landing) an SM holds at
// once, by the runtime's occupancy calculator; -1 on an error.
int tp_alg_blocks_per_sm(int method) {
  const void* alg = method == kPogo ? reinterpret_cast<const void*>(tp_alg_kernel<kPogo>)
                                    : reinterpret_cast<const void*>(tp_alg_kernel<kLanding>);
  int blocks = 0;
  cudaError_t err = cudaFuncSetAttribute(alg, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kAlgSmemBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(alg, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, alg, kAlgThreads, kAlgSmemBytes);
  return err == cudaSuccess ? blocks : -1;
}

// tp_gram.cu's tp_gram on the tensor cores: p <= 64, n % 4 == 0, every
// operand 16-byte aligned (TMA), else cudaErrorInvalidValue.
int tp_gram_tc(const float* x, const float* g, const float* mu, const float* scal,
               float* payload, float* gb, float* mu_out, int B, int p, int n, int base_kind,
               int nesterov, void* stream) {
  const bool moments = base_kind != kNone;
  const void* rows[] = {x, g, gb, moments ? mu : x, moments ? mu_out : x};
  if (B < 0 || p < 1 || p > kTcP || n < 1 || base_kind < kNone || base_kind > kVAdam ||
      !vector_ok(n, rows, 5))
    return static_cast<int>(cudaErrorInvalidValue);
  int K = 3 * p * p + (base_kind == kVAdam ? 1 : 0), grid = 0;
  int err = persistent_grid(B, &grid);
  if (err != 0) return err;
  CUtensorMap maps[5] = {};  // x, g, mu, gb, mu_out
  const float* srcs[5] = {x, g, moments ? mu : nullptr, gb, moments ? mu_out : nullptr};
  err = make_maps(maps, srcs, 5, B, p, n);
  if (err != 0) return err;
  void* args[] = {&maps[0], &maps[1], &maps[2], &maps[3], &maps[4], &scal, &payload,
                  &B, &p, &n, &K, &base_kind, &nesterov};
  return launch(reinterpret_cast<const void*>(tp_gram_tc_kernel), kGramSmemBytes, grid,
                static_cast<cudaStream_t>(stream), args, kWgThreads);
}

// tp_step.cu's tp_apply on the tensor cores, two launches: the algebra
// (one CTA a matrix; it writes the sweep's operators into ops, B x 2 x p x
// p floats) and the sweep. method: 0 POGO, 1 Landing. K is the payload's
// row stride. Shapes and alignment as tp_gram_tc.
int tp_apply_tc(const float* x, const float* gb, const float* payload, const float* scl,
                const float* scal, const int* pv, float* x_out, float* dist, float* ops, int B,
                int p, int n, int K, int method, void* stream) {
  const void* rows[] = {x, gb, x_out};
  if (B < 0 || p < 1 || p > kTcP || n < 1 || K < 3 * p * p ||
      (method != kPogo && method != kLanding) || ops == nullptr || !vector_ok(n, rows, 3))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  void* alg_args[] = {&payload, &scl, &scal, &pv, &ops, &dist, &p, &K};
  const void* alg = method == kPogo ? reinterpret_cast<const void*>(tp_alg_kernel<kPogo>)
                                    : reinterpret_cast<const void*>(tp_alg_kernel<kLanding>);
  // the most shared memory an SM can give, so that two blocks share one
  int err = static_cast<int>(cudaFuncSetAttribute(
      alg, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared));
  if (err == 0) err = launch(alg, kAlgSmemBytes, B, st, alg_args, kAlgThreads);
  if (err != 0) return err;
  int grid = 0;
  err = persistent_grid(B, &grid);
  if (err != 0) return err;
  CUtensorMap maps[3] = {};  // x, gb, x_out
  const float* srcs[3] = {x, gb, x_out};
  err = make_maps(maps, srcs, 3, B, p, n);
  if (err != 0) return err;
  const float* ops_in = ops;
  void* args[] = {&maps[0], &maps[1], &maps[2], &ops_in, &B, &p, &n};
  return launch(reinterpret_cast<const void*>(tp_apply_sweep_kernel), kApplySmemBytes, grid, st,
                args, kWgThreads);
}

}  // extern "C"
