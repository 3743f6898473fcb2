// Flash-attention forward for Hopper (sm_90a) on the bf16 tensor cores:
// the attention of the prefill and of every forward that needs no
// gradient, for bf16 inputs (fp32 inputs take flash_attention.cu).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:88
// (flash_attention_fwd, body _flash_fwd_kernel :38), reached through
// kernels/ops.py:729 (flash_attention).
//
// For batch b, query head h and query row i of q (B, Sq, H, hd), with the
// keys and values (B, Sk, KV, hd) of KV head h / (H / KV):
//   s_ij  = (q_i . k_j) * scale, NEG_INF unless j < Sk, j <= i (causal)
//           and j > i - window (window > 0), positions from 0
//   out_i = sum_j softmax_j(s_ij) v_j, rounded once to bf16
// The TPU kernel keeps p in fp32 for p @ v, and so does this one: p =
// p_hi + p_mid + p_lo, each the bf16 rounding of what the pieces before it
// leave (the 24 bits of the fp32 p), and PV runs three times on the tensor
// cores. Every product of bf16 values is exact in the fp32 accumulators
// (QK^T and the three PV), so the output agrees with the fp32 plain
// version to one output ulp per element, as the TPU kernel's does. One
// bf16 p moves p by up to 2^-9 and misses that on ~6% of the outputs at
// the prefill's shapes; two pieces (2^-17) miss it on an output or two
// near zero in a few million, where atol 1e-6 is the limit
// (benchmarks_torch/split_p_readings.py).
//
// Design (one CTA per 128 query rows of one (b, h); 384 threads):
// * A producer warpgroup, one lane of which loads the Q tile, then K and V
//   tiles of 128 keys into a ring of kTcStages stages through TMA, each
//   completing on the stage's "full" mbarrier; it reuses a stage once its
//   "empty" mbarrier says both consumers are done with it. The tensor maps
//   are 4-D, (hd, heads, S, B), so the KV head of a GQA group is a
//   coordinate: nothing is repeated. Loads past S or hd fill with zero (no
//   padding in memory; zero columns add nothing to a score and are not
//   stored), and hd is cut into 64-column boxes, 128 bytes a row,
//   128-byte swizzled.
// * Two consumer warpgroups of 64 rows each. S = QK^T: wgmma m64n128k16,
//   Q and K both K-major in shared memory, fp32 accumulators, 4 k-steps
//   per 64-column box. Online softmax in registers on scores pre-scaled
//   by log2(e) scale (exp2f), masked only in tiles that Sk, the diagonal
//   or the window edge crosses; a row's max is reduced over its quad of
//   lanes, its sum at the end. Then O += P_hi V + P_mid V + P_lo V: wgmma
//   with P in registers (the accumulator's layout is the A operand's,
//   converted in place) and V MN-major in shared memory, N = 64 or 128.
// * Registers: a block's are allocated for its threads rounded up to a
//   warpgroup, so the producer holds a whole warpgroup's worth anyway;
//   setmaxnreg hands all but 24 a thread of them to the consumers (240),
//   which hold S, O and the pieces of P without spilling.
// * Key tiles the mask empties for every row of the CTA are skipped: the
//   loop starts at the window's first key and stops at the causal limit.
//   That is exact: with the finite NEG_INF a row whose first tiles are all
//   masked carries exp2(0) = 1 garbage in O and l until its first real
//   key, where alpha = exp2(NEG_INF - m) = 0 wipes it. No -inf anywhere.
// * CTAs of long causal rows first (they take the most key tiles).
//
// Bound, at SmolLM-360M's prefill, (B, S, H, KV, hd) = (4, 2048, 15, 5,
// 64) causal: 4 hd flops per kept (query, key) pair, 32.2 GFLOP, against
// 41.9 MB of q, k, v and output. With PV issued three times the tensor
// cores do 64.4 GFLOP, 0.065 ms at 989 TFLOP/s; the 126 M exponentials take
// ~0.03 ms on the SFUs; bytes 0.0125 ms. The operations bound it.
//
// Shared memory at hd 128: Q 32 KB + 2 stages x (K 32 KB + V 32 KB).
// The launcher returns cudaGetLastError(), or the tensor map's error.

#include <cuda_bf16.h>

#include "hopper.cuh"
#include "tiles.cuh"

namespace {

constexpr int kTcRows = 128;                        // query rows of a CTA
constexpr int kTcKeys = 128;                        // keys of a K/V tile
constexpr int kTcBox = 64;                          // hd columns of a box: 128 bytes
constexpr int kBf16BoxBytes = kTcKeys * kTcBox * 2;   // 16 KB, a Q box too
constexpr int kTcStages = 2;
constexpr int kTcPieces = 3;                        // bf16 pieces of p for PV
constexpr int kTcConsumers = 256;                   // two warpgroups
constexpr int kTcThreads = kTcConsumers + 128;      // and the producer's warpgroup
// Registers a thread: the block's 64 K split as setmaxnreg moves them, the
// producer's warpgroup down to 24 and the consumers up to 240 (a block is
// launched at 65536 / 384 = 168, rounded down to 8).
constexpr int kTcProducerRegs = 24;
constexpr int kTcConsumerRegs = 240;
constexpr float kTcNegInf = -1073741824.0f;         // -2^30, models/attention.py NEG_INF

// Shared memory of one CTA with nb boxes of hd: the tiles, 1024-aligned,
// then the barriers.
__host__ __device__ constexpr int tc_tile_bytes(int nb) {
  return (1 + 2 * kTcStages) * nb * kBf16BoxBytes;
}

template <int NB>  // 64-column boxes of hd: 1 (hd <= 64) or 2
__global__ void __launch_bounds__(kTcThreads, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out,
                int Sq, int Sk, int H, int KV, int hd, int causal, int window,
                float scale_log2) {
  extern __shared__ unsigned char flash_tc_smem[];
  const uint32_t pad = (1024u - (hopper::smem_u32(flash_tc_smem) & 1023u)) & 1023u;
  unsigned char* sq = flash_tc_smem + pad;               // tiles on 1024-byte boundaries
  unsigned char* sk = sq + NB * kBf16BoxBytes;             // stage s at s * NB boxes
  unsigned char* sv = sk + kTcStages * NB * kBf16BoxBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sv + kTcStages * NB * kBf16BoxBytes);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kTcStages;

  const int nq = (Sq + kTcRows - 1) / kTcRows;
  const int bh = blockIdx.x / nq;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x % nq)) * kTcRows;  // long causal rows first
  const int b = bh / H, h = bh % H, kh = h / (H / KV);
  // Keys this CTA's rows may see: from the window's start for row q0 to
  // the causal limit of the last real row.
  int t_begin = 0, t_end = Sk;
  if (window > 0) t_begin = max(0, q0 - window + 1) / kTcKeys * kTcKeys;
  if (causal) t_end = min(t_end, min(Sq, q0 + kTcRows));
  const int ntiles = t_end > t_begin ? (t_end - t_begin + kTcKeys - 1) / kTcKeys : 0;
  const int tid = threadIdx.x;

  if (tid == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kTcStages; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, kTcConsumers / 32);  // one arrival per consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kTcConsumers) {  // the producer's warpgroup: one lane issues every load
    hopper::reg_dealloc<kTcProducerRegs>();
    if (tid == kTcConsumers) {
      hopper::mbar_expect_tx(q_full, NB * kBf16BoxBytes);
      for (int c = 0; c < NB; ++c)
        hopper::tma_load_4d(sq + c * kBf16BoxBytes, &tq, q_full, c * kTcBox, h, q0, b);
      for (int n = 0; n < ntiles; ++n) {
        const int s = n % kTcStages, j0 = t_begin + n * kTcKeys;
        if (n >= kTcStages) hopper::mbar_wait(empty + s, (n / kTcStages - 1) & 1);
        hopper::mbar_expect_tx(full + s, 2 * NB * kBf16BoxBytes);
        for (int c = 0; c < NB; ++c) {
          hopper::tma_load_4d(sk + (s * NB + c) * kBf16BoxBytes, &tk, full + s, c * kTcBox, kh,
                              j0, b);
          hopper::tma_load_4d(sv + (s * NB + c) * kBf16BoxBytes, &tv, full + s, c * kTcBox, kh,
                              j0, b);
        }
      }
    }
    return;
  }

  hopper::reg_alloc<kTcConsumerRegs>();
  const int wg = tid / 128, lane = tid % 32;
  const int row_lo = q0 + wg * 64;                           // the warpgroup's first row
  const int r0 = row_lo + (tid % 128) / 32 * 16 + lane / 4;  // the thread's rows r0, r0 + 8
  float o[NB * 32];
#pragma unroll
  for (int i = 0; i < NB * 32; ++i) o[i] = 0.f;
  float m[2] = {kTcNegInf, kTcNegInf}, l[2] = {0.f, 0.f};

  hopper::mbar_wait(q_full, 0);
  for (int n = 0; n < ntiles; ++n) {
    const int s = n % kTcStages, j0 = t_begin + n * kTcKeys;
    const unsigned char* ks = sk + s * NB * kBf16BoxBytes;
    const unsigned char* vs = sv + s * NB * kBf16BoxBytes;
    hopper::mbar_wait(full + s, (n / kTcStages) & 1);

    float sc[64];
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NB * 4; ++kk) {  // whole boxes: zero columns add nothing
      const int box = kk / 4 * kBf16BoxBytes, col = kk % 4 * 32;
      hopper::wgmma_ss_m64n128(
          sc, hopper::sw128_desc(sq + box + wg * 64 * 128 + col, 16, 1024),
          hopper::sw128_desc(ks + box + col, 16, 1024), kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);

    // Online softmax in log2 units; a row's 128 scores live in one quad.
    const bool edge = j0 + kTcKeys > Sk || (causal && j0 + kTcKeys - 1 > row_lo) ||
                      (window > 0 && j0 <= row_lo + 63 - window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      float x = sc[i] * scale_log2;
      if (edge) {
        const int row = r0 + 8 * (i / 2 % 2);
        const int kj = j0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
        const bool ok = kj < Sk && (!causal || kj <= row) && (window <= 0 || kj > row - window);
        x = ok ? x : kTcNegInf;
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
    // p = p_hi + p_mid + p_lo, each the bf16 rounding of what the pieces
    // before it leave, in the A operand's layout.
    uint32_t pp[kTcPieces][32];
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int r = i / 2 % 2;
      float p0 = exp2f(sc[i] - m[r]), p1 = exp2f(sc[i + 1] - m[r]);
      l[r] += p0 + p1;
#pragma unroll
      for (int c = 0; c < kTcPieces; ++c) {
        const uint32_t piece = hopper::pack_bf16x2(p0, p1);
        pp[c][i / 2] = piece;
        p0 -= hopper::bf16x2_lo(piece);
        p1 -= hopper::bf16x2_hi(piece);
      }
    }
#pragma unroll
    for (int i = 0; i < NB * 32; ++i) o[i] *= alpha[i / 2 % 2];

    hopper::fence_regs(o);
#pragma unroll
    for (int c = 0; c < kTcPieces; ++c) hopper::fence_regs(pp[c]);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTcKeys / 16; ++kk) {
      const uint64_t dv = hopper::sw128_desc(vs + kk * 16 * 128, kBf16BoxBytes, 1024);
#pragma unroll
      for (int c = 0; c < kTcPieces; ++c)
        hopper::wgmma_rs_tb(o, pp[c][4 * kk], pp[c][4 * kk + 1], pp[c][4 * kk + 2],
                            pp[c][4 * kk + 3], dv);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
    if (lane == 0) hopper::mbar_arrive(empty + s);  // this warp is done with stage s
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = r0 + 8 * r;
    if (row >= Sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* dst = out + (static_cast<size_t>(b) * Sq + row) * H * hd + h * hd;
#pragma unroll
    for (int i = 2 * r; i < NB * 32; i += 4) {
      const int col = 8 * (i / 4) + 2 * (lane % 4);
      if (col < hd) dst[col] = __float2bfloat16_rn(o[i] / den);
      if (col + 1 < hd) dst[col + 1] = __float2bfloat16_rn(o[i + 1] / den);
    }
  }
}

}  // namespace

extern "C" {

// Shared memory of one CTA at row length ld: the tiles, the barriers and
// room to align the tiles to 1024 bytes.
int flash_attention_tc_smem_bytes(int ld) {
  return tc_tile_bytes(ld > kTcBox ? 2 : 1) + 8 * (1 + 2 * kTcStages) + 1024;
}

// q: (B, Sq, H, ld); k, v: (B, Sk, KV, ld); out: (B, Sq, H, hd); bf16, all
// contiguous, q, k and v 16-byte aligned. ld (a multiple of 8, at most
// 128) is the rows' length in memory, hd <= ld the head dimension: the
// columns past hd must be zero. window <= 0 means no window; scale
// multiplies the scores (hd^-0.5).
int flash_attention_tc_fwd(const void* q, const void* k, const void* v, void* out, int B,
                           int Sq, int Sk, int H, int KV, int ld, int hd, int causal,
                           int window, float scale, cudaStream_t stream) {
  if (B < 0 || Sq < 0 || Sk < 1 || hd < 1 || hd > ld || ld > 2 * kTcBox || ld % 8 != 0 ||
      KV < 1 || H < 1 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = B * H * ((Sq + kTcRows - 1) / kTcRows);
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  const uint64_t e = 2;  // bytes of a bf16
  const uint64_t qdims[4] = {static_cast<uint64_t>(ld), static_cast<uint64_t>(H),
                             static_cast<uint64_t>(Sq), static_cast<uint64_t>(B)};
  const uint64_t kdims[4] = {static_cast<uint64_t>(ld), static_cast<uint64_t>(KV),
                             static_cast<uint64_t>(Sk), static_cast<uint64_t>(B)};
  const uint64_t qstrides[3] = {ld * e, H * ld * e, qdims[2] * H * ld * e};
  const uint64_t kstrides[3] = {ld * e, KV * ld * e, kdims[2] * KV * ld * e};
  const uint32_t box[4] = {kTcBox, 1, kTcRows, 1};  // kTcRows == kTcKeys
  CUtensorMap tq, tk, tv;
  int err = hopper::make_tma_map_bf16(&tq, q, qdims, qstrides, box);
  if (err == 0) err = hopper::make_tma_map_bf16(&tk, k, kdims, kstrides, box);
  if (err == 0) err = hopper::make_tma_map_bf16(&tv, v, kdims, kstrides, box);
  if (err != 0) return err;
  float scale_log2 = static_cast<float>(static_cast<double>(scale) * 1.4426950408889634);
  void* args[] = {&tq, &tk, &tv, &out, &Sq, &Sk, &H, &KV, &hd, &causal, &window, &scale_log2};
  const void* kernel = ld > kTcBox ? reinterpret_cast<const void*>(flash_tc_kernel<2>)
                                   : reinterpret_cast<const void*>(flash_tc_kernel<1>);
  return launch(kernel, flash_attention_tc_smem_bytes(ld), blocks, stream, args, kTcThreads);
}

}  // extern "C"
