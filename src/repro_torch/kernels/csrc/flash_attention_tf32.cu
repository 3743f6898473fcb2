// Flash-attention forward for Hopper (sm_90a) on the TF32 tensor cores,
// 3xTF32, for fp32 inputs whose head dimension is a multiple of 4: the
// attention of the fp32 prefill and of every fp32 forward that needs no
// gradient. bf16 inputs take flash_attention_tc.cu; fp32 at hd % 4 != 0
// (rows TMA cannot address) the CUDA-core kernel, flash_attention.cu.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:88
// (flash_attention_fwd, body _flash_fwd_kernel :38), reached through
// kernels/ops.py:729 (flash_attention), for fp32 inputs.
//
// For batch b, query head h and query row i of q (B, Sq, H, hd), with the
// keys and values (B, Sk, KV, hd) of KV head h / (H / KV):
//   s_ij  = (q_i . k_j) * scale, NEG_INF unless j < Sk, j <= i (causal)
//           and j > i - window (window > 0), positions from 0
//   out_i = sum_j softmax_j(s_ij) v_j, in fp32
// The TPU kernel does every product in fp32 and keeps p in fp32 for p @ v,
// and so does this one: each product is three TF32 products, hi hi + hi lo
// + lo hi, summed in fp32 accumulators (hi = the top 19 bits of a value,
// lo = the TF32 rounding of what hi leaves), within ~2^-21 of fp32's.
//
// Design (one CTA per 128 query rows of one (b, h); 384 threads):
// * A producer warpgroup. Its first lane loads the Q tile once, then K and
//   V tiles of kKeys keys into a ring of kTfStages stages through TMA,
//   each completing on the stage's "full" mbarrier, and reuses a stage
//   once its "empty" mbarrier says both consumers are done with it. The
//   tensor maps are 4-D fp32, (hd, heads, S, B), so the KV head of a GQA
//   group is a coordinate: nothing is repeated. Loads past S or hd fill
//   with zero (nothing is padded in memory; zero columns add nothing to a
//   score and are not stored). hd is cut into 32-column boxes, 128 bytes
//   a row, 128-byte swizzled.
// * The producer warpgroup's other three warps turn each landed stage into
//   the pieces the products read (below), then arrive on its "ready"
//   mbarrier. The consumers wait for both "full" and "ready".
// * Two consumer warpgroups of 64 query rows each. S = QK^T on m64nKk8
//   TF32 wgmma: Q_raw K_lo and Q_lo K_raw, then Q_raw K_raw, Q_lo formed
//   once from the landed Q (beside it in shared memory up to hd = 64, in
//   registers past it). Online
//   softmax in registers on scores pre-scaled by log2(e) scale (exp2f),
//   masked only in tiles that Sk, the diagonal or the window edge crosses;
//   a row's max is reduced over its quad of lanes, its sum at the end.
//   Then the tile's P V as P_raw V^T_lo + P_raw V^T_hi, then P_lo V^T_hi:
//   wgmma with P in registers (the S accumulators themselves, then their
//   lo pieces in the same registers) and V^T K-major in shared memory, N =
//   hd rounded up to 32, 64 or 128, into accumulators of its own; O = O
//   alpha + PV in fp32.
// * Rounding: the tensor cores round each sum toward zero at the ulp of
//   the running sum (chip_smoke.py's TF32 probe), so a sum that takes
//   many products drifts toward zero (an H100 read 1.29e-5 against the
//   plain version at the prefill's shape with O summed there, 2.1e-6
//   without). S takes the small products first, and O's running sum over
//   the tiles is kept out of the tensor cores.
// * Registers: setmaxnreg moves them from the producer warpgroup (40 a
//   thread, enough for the transform's loops) to the consumers (232),
//   which hold S (then P), the tile's PV and O (and Q_lo past hd = 64)
//   without spilling.
// * Key tiles the mask empties for every row of the CTA are skipped: the
//   loop starts at the window's first key and stops at the causal limit.
//   That is exact: with the finite NEG_INF a row whose first tiles are all
//   masked carries exp2(0) = 1 garbage in O and l until its first real
//   key, where alpha = exp2(NEG_INF - m) = 0 wipes it. No -inf anywhere.
// * The grid runs the longest causal rows first: the block index's slow
//   part is the query block, from the last down.
//
// The trouble spots and what this design does about each:
// 1. TF32 wgmma has no transposed B (the PTX ISA allows the transpose only
//    for f16 / bf16), so V, landed (keys x hd) with hd contiguous, cannot
//    be PV's B operand, which must be K-major (keys contiguous). The
//    producer warpgroup's three idle warps transpose each landed V tile
//    into V^T and split it into hi and lo (two buffers), and form K's lo
//    beside K_raw, between the stage's "full" and its "ready": no HBM
//    traffic, and no consumer time. Each lane takes one key of 32, so a
//    warp reads 32 swizzled rows and writes one 128-byte V^T row a store.
// 2. The TF32 register-A fragment is not the accumulator's layout
//    (hopper.cuh's header): in an 8-key group lane l holds accumulator
//    keys 2 (l % 4) and 2 (l % 4) + 1, and the A operand of a k8 step
//    wants columns l % 4 and l % 4 + 4. The accumulators are passed as
//    they are (d[4g], d[4g + 2], d[4g + 1], d[4g + 3]), so A's column c
//    is key 2c (c < 4) or 2 (c - 4) + 1, and V^T stores key t of each
//    group of 8 at position t / 2 + 4 (t % 2) (tf_vt_pos) to match. PV
//    sums over the keys, so the permutation is exact and costs nothing.
// 3. Shared memory and registers at hd = 128: a stage holds five tiles
//    (K_raw, K_lo, V_raw, V^T_hi, V^T_lo), each kKeys x 32 NB fp32. The
//    tile is 64 keys up to hd = 64 (NB = 2: 80 KB a stage, 224 KB with Q
//    and Q_lo, 32 KB each) and 32 keys past it (NB = 4: 80 KB a stage,
//    224 KB with Q's 64 KB). There Q's lo lives in registers, formed
//    again from Q_raw each tile: 64 a thread beside S (16) and O (64)
//    while QK^T runs, the tile's PV (64) taking its place for PV. Up to
//    hd = 64 a consumer thread holds S, PV and O, 96 (NB = 2). Every
//    register-A piece held at once, and Q_lo kept across the tiles, made
//    ptxas serialize the wgmma (C7511) or spill.
// 4. One translation unit holds every flash source in the CPU emulator
//    (tests/cuda_emu/flash_harness.cpp): this file's names carry a kTf /
//    tf_ prefix, and flash_attention_tc.cu's box size is kBf16BoxBytes,
//    apart from tf32_tile.cuh's kTcBoxBytes.
//
// Bound, at SmolLM-360M's prefill, (B, S, H, KV, hd) = (4, 2048, 15, 5,
// 64) causal: 4 hd flops per kept (query, key) pair, 32.2 GFLOP, three
// times on the TF32 tensor cores, 0.1953 ms at 495 TFLOP/s (0.4810 ms for
// one pass at the CUDA cores' 67); 126 M exponentials, 0.0326 ms on the
// SFUs; 83.9 MB of q, k, v and output, 0.0250 ms. The operations bound it.
//
// The launcher returns cudaGetLastError(), or the tensor map's error.

#include "hopper.cuh"
#include "tf32_tile.cuh"
#include "tiles.cuh"

namespace {

constexpr int kTfRows = 128;                  // query rows of a CTA, 64 a consumer
constexpr int kTfBox = 32;                    // hd columns of a box: 128 bytes
constexpr int kTfQBoxBytes = kTfRows * 128;   // one box of the Q tile
constexpr int kTfStages = 2;
constexpr int kTfConsumers = 256;             // two warpgroups
constexpr int kTfThreads = kTfConsumers + 128;  // and the producer's warpgroup
constexpr int kTfTransformers = 96;           // the producer's warps 1-3
// Registers a thread: the block's 64 K split as setmaxnreg moves them (a
// block is launched at 65536 / 384 = 168; a producer-plus-two-consumer
// triple sums to 3 x 168 = 504).
constexpr int kTfProducerRegs = 40;
constexpr int kTfConsumerRegs = 232;
constexpr float kTfNegInf = -1073741824.0f;   // -2^30, models/attention.py NEG_INF

// 32-column boxes of hd: 1, 2 or 4 (hd 72-96 reads a zero-filled fourth).
__host__ __device__ constexpr int tf_boxes(int hd) { return hd <= 32 ? 1 : hd <= 64 ? 2 : 4; }

// Keys of a K/V tile.
__host__ __device__ constexpr int tf_keys(int nb) { return nb > 2 ? 32 : 64; }

// Bytes of one of a stage's five tiles: kKeys x 32 nb fp32.
__host__ __device__ constexpr int tf_tile_bytes(int nb) { return nb * tf_keys(nb) * 128; }

// Q's lo beside Q_raw in shared memory (to hd 64), or in registers.
__host__ __device__ constexpr bool tf_qlo_regs(int nb) { return nb > 2; }

// Shared memory of the Q tile (and its lo) and the stages.
__host__ __device__ constexpr int tf_smem_tiles(int nb) {
  return (tf_qlo_regs(nb) ? 1 : 2) * nb * kTfQBoxBytes + kTfStages * 5 * tf_tile_bytes(nb);
}

// Byte offset of element (row, col) of a tile stored as 32-column boxes of
// `rows` rows, 128-byte swizzled, as TMA writes them and the descriptors read.
__device__ inline int tf_off(int row, int col, int rows) {
  return (col >> 5) * rows * 128 + row * 128 + ((((col & 31) >> 2) ^ (row & 7)) << 4) +
         ((col & 3) << 2);
}

// V^T position of key t of a tile: in each group of 8 keys, the even keys
// first, then the odd ones (trouble spot 2 above).
__device__ inline int tf_vt_pos(int t) { return (t & ~7) | ((t & 7) >> 1) | ((t & 1) << 2); }

template <int NB>  // 32-column boxes of hd: 1, 2 or 4
__global__ void __launch_bounds__(kTfThreads, 1)
flash_tf32_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, float* __restrict__ out, int Sq,
                  int Sk, int H, int KV, int hd, int causal, int window, float scale_log2) {
  constexpr int kKeys = tf_keys(NB);
  constexpr int kTile = tf_tile_bytes(NB);
  constexpr int kKBox = kKeys * 128;          // one 32-column box of a K or V tile
  constexpr int kVtBox = NB * kTfBox * 128;   // 32 keys of V^T: 32 NB rows of 128 bytes
  extern __shared__ unsigned char flash_tf32_smem[];
  unsigned char* sq = hopper::smem_align1024(flash_tf32_smem);  // tiles on 1024-byte boundaries
  unsigned char* sql = sq + NB * kTfQBoxBytes;  // Q_lo, unless it is in registers
  unsigned char* stages = sq + (tf_qlo_regs(NB) ? 1 : 2) * NB * kTfQBoxBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(stages + kTfStages * 5 * kTile);
  uint64_t* full = q_full + 1;
  uint64_t* ready = full + kTfStages;
  uint64_t* empty = ready + kTfStages;
  // Stage s holds K_raw, K_lo, V_raw, V^T_hi, V^T_lo, in that order.
  auto tile = [stages](int s, int which) { return stages + (s * 5 + which) * kTile; };

  const int nq = (Sq + kTfRows - 1) / kTfRows;
  const int bhs = static_cast<int>(gridDim.x) / nq;
  const int bh = blockIdx.x % bhs;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x) / bhs) * kTfRows;  // long rows first
  const int b = bh / H, h = bh % H, kh = h / (H / KV);
  // Keys this CTA's rows may see: from the window's start for row q0 to
  // the causal limit of the last real row.
  int t_begin = 0, t_end = Sk;
  if (window > 0) t_begin = max(0, q0 - window + 1) / kKeys * kKeys;
  if (causal) t_end = min(t_end, min(Sq, q0 + kTfRows));
  const int ntiles = t_end > t_begin ? (t_end - t_begin + kKeys - 1) / kKeys : 0;
  const int tid = threadIdx.x, lane = tid % 32;

  if (tid == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kTfStages; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(ready + s, kTfTransformers / 32);  // one arrival per transform warp
      hopper::mbar_init(empty + s, kTfConsumers / 32);     // one arrival per consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kTfConsumers) {  // the producer's warpgroup
    hopper::reg_dealloc<kTfProducerRegs>();
    const int warp = (tid - kTfConsumers) / 32;
    if (warp == 0) {  // one lane issues every load
      if (lane == 0) {
        hopper::mbar_expect_tx(q_full, NB * kTfQBoxBytes);
        for (int c = 0; c < NB; ++c)
          hopper::tma_load_4d(sq + c * kTfQBoxBytes, &tq, q_full, c * kTfBox, h, q0, b);
        for (int n = 0; n < ntiles; ++n) {
          const int s = n % kTfStages, j0 = t_begin + n * kKeys;
          if (n >= kTfStages) hopper::mbar_wait(empty + s, (n / kTfStages - 1) & 1);
          hopper::mbar_expect_tx(full + s, 2 * kTile);
          for (int c = 0; c < NB; ++c) {
            hopper::tma_load_4d(tile(s, 0) + c * kKBox, &tk, full + s, c * kTfBox, kh, j0, b);
            hopper::tma_load_4d(tile(s, 2) + c * kKBox, &tv, full + s, c * kTfBox, kh, j0, b);
          }
        }
      }
      return;
    }
    // Warps 1-3: K's lo beside K_raw, V^T's hi and lo from V_raw.
    const int t3 = tid - kTfConsumers - 32;
    for (int n = 0; n < ntiles; ++n) {
      const int s = n % kTfStages;
      hopper::mbar_wait(full + s, (n / kTfStages) & 1);
      const float4* kraw = reinterpret_cast<const float4*>(tile(s, 0));
      float4* klo = reinterpret_cast<float4*>(tile(s, 1));
      for (int i = t3; i < kTile / 16; i += kTfTransformers) {  // same layout, chunk for chunk
        const float4 x = kraw[i];
        klo[i] = make_float4(trunc_lo(x.x), trunc_lo(x.y), trunc_lo(x.z), trunc_lo(x.w));
      }
      const unsigned char* vraw = tile(s, 2);
      unsigned char* vhi = tile(s, 3);
      unsigned char* vlo = tile(s, 4);
      // An item is four hd columns of 32 keys, a key a lane.
      for (int item = warp - 1; item < NB * 8 * (kKeys / 32); item += kTfTransformers / 32) {
        const int c4 = item % (NB * 8), t = item / (NB * 8) * 32 + lane;
        const float4 x = *reinterpret_cast<const float4*>(vraw + tf_off(t, 4 * c4, kKeys));
        const float xs[4] = {x.x, x.y, x.z, x.w};
        const int tp = tf_vt_pos(t);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float hi, lo;
          split(xs[j], hi, lo);
          const int off = tf_off(4 * c4 + j, tp, NB * kTfBox);
          *reinterpret_cast<float*>(vhi + off) = hi;
          *reinterpret_cast<float*>(vlo + off) = lo;
        }
      }
      hopper::fence_proxy_async_smem();  // the products read them through the async proxy
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(ready + s);
    }
    return;
  }

  hopper::reg_alloc<kTfConsumerRegs>();
  const int wg = tid / 128, w = (tid % 128) / 32;
  const int row_lo = q0 + wg * 64;            // the warpgroup's first row
  const int r0 = row_lo + 16 * w + lane / 4;  // the thread's rows r0, r0 + 8
  float o[NB * 16];
#pragma unroll
  for (int i = 0; i < NB * 16; ++i) o[i] = 0.f;
  float m[2] = {kTfNegInf, kTfNegInf}, l[2] = {0.f, 0.f};

  hopper::mbar_wait(q_full, 0);
  if constexpr (!tf_qlo_regs(NB)) {
    // Q's lo beside Q_raw, same layout: the warpgroup's 64 rows of each box.
    for (int i = tid % 128; i < NB * 512; i += 128) {
      const int at = i / 512 * kTfQBoxBytes + wg * 64 * 128 + i % 512 * 16;
      const float4 x = *reinterpret_cast<const float4*>(sq + at);
      *reinterpret_cast<float4*>(sql + at) =
          make_float4(trunc_lo(x.x), trunc_lo(x.y), trunc_lo(x.z), trunc_lo(x.w));
    }
    hopper::fence_proxy_async_smem();  // the products read it through the async proxy
    hopper::named_sync(1 + wg, 128);
  }

  for (int n = 0; n < ntiles; ++n) {
    const int s = n % kTfStages, j0 = t_begin + n * kKeys;
    const unsigned char* kr = tile(s, 0);
    const unsigned char* kl = tile(s, 1);
    const unsigned char* vh = tile(s, 3);
    const unsigned char* vl = tile(s, 4);
    hopper::mbar_wait(full + s, (n / kTfStages) & 1);
    hopper::mbar_wait(ready + s, (n / kTfStages) & 1);

    uint32_t qlo[tf_qlo_regs(NB) ? NB * 4 : 1][4];
    if constexpr (tf_qlo_regs(NB)) {
      // Q's lo in the register-A fragment of each k8 step (rows r0, + 8 in
      // registers 1 and 3; columns 8 kk + l % 4, + 4 in registers 2 and
      // 3), formed again each tile: kept across the tiles, it spills, and
      // so do its 64 addresses if the loop keeps them (hopper::opaque).
      const unsigned char* qrow = hopper::opaque(sq + (r0 - q0) * 128 + lane % 4 * 4);
      const int swz = hopper::opaque(lane / 4);  // the row's swizzle: (r0 - q0) % 8
#pragma unroll
      for (int kk = 0; kk < NB * 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int at = kk / 4 * kTfQBoxBytes + (r & 1) * 8 * 128 +
                         (((kk % 4 * 2 + r / 2) ^ swz) << 4);
          qlo[kk][r] = __float_as_uint(trunc_lo(*reinterpret_cast<const float*>(qrow + at)));
        }
    }
    float sc[kKeys / 2];
    // The small products first, then Q_raw K_raw: the tensor cores round
    // each sum toward zero, at the ulp of the running sum, so the large
    // products then take 2 hd / 8 such roundings of S, not 3 hd / 8.
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NB * 4; ++kk) {
      const int box = kk >> 2, col = (kk & 3) * 32;
      const uint64_t dq = hopper::sw128_desc(sq + box * kTfQBoxBytes + wg * 64 * 128 + col, 16, 1024);
      const uint64_t dk = hopper::sw128_desc(kr + box * kKBox + col, 16, 1024);
      const uint64_t dkl = hopper::sw128_desc(kl + box * kKBox + col, 16, 1024);
      hopper::wgmma_tf32_ss(sc, dq, dkl, kk > 0);
      if constexpr (tf_qlo_regs(NB))
        hopper::wgmma_tf32_rs(sc, qlo[kk][0], qlo[kk][1], qlo[kk][2], qlo[kk][3], dk, 1);
      else
        hopper::wgmma_tf32_ss(
            sc, hopper::sw128_desc(sql + box * kTfQBoxBytes + wg * 64 * 128 + col, 16, 1024),
            dk, 1);
    }
#pragma unroll
    for (int kk = 0; kk < NB * 4; ++kk) {
      const int box = kk >> 2, col = (kk & 3) * 32;
      const uint64_t dq = hopper::sw128_desc(sq + box * kTfQBoxBytes + wg * 64 * 128 + col, 16, 1024);
      const uint64_t dk = hopper::sw128_desc(kr + box * kKBox + col, 16, 1024);
      hopper::wgmma_tf32_ss(sc, dq, dk, 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);

    // Online softmax in log2 units; a row's kKeys scores live in one quad.
    const bool edge = j0 + kKeys > Sk || (causal && j0 + kKeys - 1 > row_lo) ||
                      (window > 0 && j0 <= row_lo + 63 - window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < kKeys / 2; ++i) {
      float x = sc[i] * scale_log2;
      if (edge) {
        const int row = r0 + 8 * (i / 2 % 2);
        const int kj = j0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
        const bool ok = kj < Sk && (!causal || kj <= row) && (window <= 0 || kj > row - window);
        x = ok ? x : kTfNegInf;
      }
      sc[i] = x;
      mx[i / 2 % 2] = fmaxf(mx[i / 2 % 2], x);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < kKeys / 2; ++i) {
      const int r = i / 2 % 2;
      const float p = exp2f(sc[i] - m[r]);
      l[r] += p;
      sc[i] = p;
    }
    // This tile's P V in accumulators of its own: P_raw V^T_lo + P_raw
    // V^T_hi, then P_lo V^T_hi with P_lo formed in P_raw's registers once
    // their products are done (both pieces held at once made ptxas
    // serialize the wgmma). O = O alpha + PV in fp32, rounded to nearest:
    // O's running sum takes no truncating tensor-core sums.
    float pv[NB * 16];
#pragma unroll
    for (int i = 0; i < NB * 16; ++i) pv[i] = 0.f;  // dead across QK^T (an asm operand reads it)
    hopper::fence_regs(pv);
    hopper::fence_regs(sc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 8; ++kk) {
      const int at = (kk >> 2) * kVtBox + (kk & 3) * 32;
      const uint64_t dh = hopper::sw128_desc(vh + at, 16, 1024);
      const uint64_t dl = hopper::sw128_desc(vl + at, 16, 1024);
      const uint32_t h0 = __float_as_uint(sc[4 * kk]), h1 = __float_as_uint(sc[4 * kk + 2]);
      const uint32_t h2 = __float_as_uint(sc[4 * kk + 1]), h3 = __float_as_uint(sc[4 * kk + 3]);
      hopper::wgmma_tf32_rs(pv, h0, h1, h2, h3, dl, 1);
      hopper::wgmma_tf32_rs(pv, h0, h1, h2, h3, dh, 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);
#pragma unroll
    for (int i = 0; i < kKeys / 2; ++i) sc[i] = trunc_lo(sc[i]);
    hopper::fence_regs(sc);
    hopper::fence_regs(pv);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 8; ++kk) {
      const uint64_t dh = hopper::sw128_desc(vh + (kk >> 2) * kVtBox + (kk & 3) * 32, 16, 1024);
      hopper::wgmma_tf32_rs(pv, __float_as_uint(sc[4 * kk]), __float_as_uint(sc[4 * kk + 2]),
                            __float_as_uint(sc[4 * kk + 1]), __float_as_uint(sc[4 * kk + 3]),
                            dh, 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(pv);
    if (lane == 0) hopper::mbar_arrive(empty + s);  // this warp is done with stage s
#pragma unroll
    for (int i = 0; i < NB * 16; ++i) o[i] = fmaf(o[i], alpha[i / 2 % 2], pv[i]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = r0 + 8 * r;
    if (row >= Sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
    float* dst = out + (static_cast<size_t>(b) * Sq + row) * H * hd + h * hd;
#pragma unroll
    for (int i = 2 * r; i < NB * 16; i += 4) {
      const int col = 8 * (i / 4) + 2 * (lane % 4);  // even, and hd % 4 == 0
      if (col < hd) *reinterpret_cast<float2*>(dst + col) = make_float2(o[i] / den, o[i + 1] / den);
    }
  }
}

}  // namespace

extern "C" {

// Shared memory of one CTA at head dimension hd: the tiles, the barriers
// and room to align the tiles to 1024 bytes.
int flash_attention_tf32_smem_bytes(int hd) {
  return tf_smem_tiles(tf_boxes(hd)) + 8 * (1 + 3 * kTfStages) + 1024;
}

// q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd); out: (B, Sq, H, hd); fp32, all
// contiguous, q, k and v 16-byte aligned; hd a multiple of 4, at most 128.
// window <= 0 means no window; scale multiplies the scores (hd^-0.5).
int flash_attention_tf32_fwd(const void* q, const void* k, const void* v, void* out, int B,
                             int Sq, int Sk, int H, int KV, int hd, int causal, int window,
                             float scale, cudaStream_t stream) {
  if (B < 0 || Sq < 0 || Sk < 1 || hd < 4 || hd > 4 * kTfBox || hd % 4 != 0 || KV < 1 ||
      H < 1 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = B * H * ((Sq + kTfRows - 1) / kTfRows);
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  const int nb = tf_boxes(hd);
  const uint64_t e = 4;  // bytes of an fp32
  const uint64_t qdims[4] = {static_cast<uint64_t>(hd), static_cast<uint64_t>(H),
                             static_cast<uint64_t>(Sq), static_cast<uint64_t>(B)};
  const uint64_t kdims[4] = {static_cast<uint64_t>(hd), static_cast<uint64_t>(KV),
                             static_cast<uint64_t>(Sk), static_cast<uint64_t>(B)};
  const uint64_t qstrides[3] = {hd * e, H * hd * e, qdims[2] * H * hd * e};
  const uint64_t kstrides[3] = {hd * e, KV * hd * e, kdims[2] * KV * hd * e};
  const uint32_t qbox[4] = {kTfBox, 1, kTfRows, 1};
  const uint32_t kbox[4] = {kTfBox, 1, static_cast<uint32_t>(tf_keys(nb)), 1};
  CUtensorMap tq, tk, tv;
  int err = hopper::make_tma_map_f32(&tq, q, qdims, qstrides, qbox);
  if (err == 0) err = hopper::make_tma_map_f32(&tk, k, kdims, kstrides, kbox);
  if (err == 0) err = hopper::make_tma_map_f32(&tv, v, kdims, kstrides, kbox);
  if (err != 0) return err;
  float scale_log2 = static_cast<float>(static_cast<double>(scale) * 1.4426950408889634);
  void* args[] = {&tq, &tk, &tv, &out, &Sq, &Sk, &H, &KV, &hd, &causal, &window, &scale_log2};
  const void* kernel = nb == 1   ? reinterpret_cast<const void*>(flash_tf32_kernel<1>)
                       : nb == 2 ? reinterpret_cast<const void*>(flash_tf32_kernel<2>)
                                 : reinterpret_cast<const void*>(flash_tf32_kernel<4>);
  return launch(kernel, flash_attention_tf32_smem_bytes(hd), blocks, stream, args, kTfThreads);
}

}  // extern "C"
