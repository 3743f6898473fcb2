// Flash-attention forward for Hopper (sm_90a), plain fp32 CUDA C++, for
// fp32 inputs: the attention of every fp32 forward that needs no gradient.
// bf16 inputs take the tensor-core kernel, flash_attention_tc.cu.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:88
// (flash_attention_fwd, body _flash_fwd_kernel :38), reached through
// kernels/ops.py:729 (flash_attention).
//
// For batch b, query head h and query row i of q (B, Sq, H, hd), with the
// keys and values (B, Sk, KV, hd) of KV head h / (H / KV):
//   s_ij  = (q_i . k_j) * scale, NEG_INF unless j <= i
//           (causal) and j > i - window (window > 0), positions from 0
//   out_i = sum_j softmax_j(s_ij) v_j
// All of it in IEEE fp32, as in the TPU kernel: its p stays fp32 for p @ v.
//
// What differs from the TPU kernel:
// * One CTA per (query tile of kBq rows, batch x head). The TPU's
//   sequential third grid dimension over key blocks becomes a loop inside
//   the CTA, with the online-softmax state (acc, m, l) in registers.
// * GQA: a CTA reads its KV head directly; the JAX wrapper repeats K and
//   V per query head first (3x the K/V bytes at SmolLM's 15/5 heads).
// * Keys past Sk are masked: nothing is padded in memory, so Sk is the
//   true key length. The TPU wrapper pads the keys and masks with the
//   padded length, so its non-causal calls with S not a multiple of the
//   block weight the zero padding keys.
// * The key loop stops at the causal limit of the tile's last row and
//   starts at the window's first key of its first row, so tiles that the
//   mask empties for every row are skipped (half the work when causal).
//   That is exact: with the finite NEG_INF a row whose first tiles are
//   all masked carries exp(0) = 1 garbage in acc and l until its first
//   real key, where alpha = exp(NEG_INF - m) = 0 wipes it. No -inf is
//   used anywhere, so no row turns into NaN.
// * Nothing is padded in memory: query rows past Sq and keys past Sk load
//   as zero and are not stored; hd is any value up to kMaxHd.
//
// Bound: 4 Sq Sk hd flops per (batch, head), about half of them under the
// causal mask, against reading q, k and v once and writing the output
// once. At SmolLM-360M's prefill shape, (B, S, H, KV, hd) = (4, 2048, 15,
// 5, 64), that is ~32 GFLOP against ~84 MB in fp32: the fp32 operation
// rate bounds it (0.48 ms at 67 TFLOP/s). The products run as 4 x 4
// register blocks of IEEE fp32 FMAs on the CUDA cores, fed by float4
// shared-memory loads; expf, no fast math.
//
// The launcher returns cudaGetLastError().

#include "tiles.cuh"

namespace {

constexpr int kBq = 64;            // query rows of a CTA: 16 row groups of 4
constexpr int kBk = 64;            // keys of a tile: 16 column groups of 4
constexpr int kLd = 68;            // row stride of the k-major tiles (float4-aligned)
constexpr int kMaxHd = 128;        // two 64-wide output column chunks
constexpr int kFlashBlocksPerSm = 2;
constexpr float kNegInf = -1073741824.0f;  // -2^30, models/attention.py NEG_INF

// Output column chunks of 64: a thread owns columns cc * 64 + tx * 4 + j.
__host__ __device__ inline int chunks(int hd) { return (hd + 63) / 64; }

__global__ void __launch_bounds__(kThreads, kFlashBlocksPerSm)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int Sq, int Sk,
                 int H, int KV, int hd, int causal, int window,
                 float scale) {
  extern __shared__ float4 flash_sm[];
  float* sm = reinterpret_cast<float*>(flash_sm);
  const int nc = chunks(hd), ldv = 64 * nc;
  float* QT = sm;                 // [hd][kLd]: QT[d * kLd + r]
  float* KT = QT + hd * kLd;      // [hd][kLd]: KT[d * kLd + t]
  float* V = KT + hd * kLd;       // [kBk][ldv]: V[t * ldv + d], zero past hd
  float* PT = V + kBk * ldv;      // [kBk][kLd]: PT[t * kLd + r]

  const int nq = (Sq + kBq - 1) / kBq;
  const int bh = blockIdx.x / nq;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x % nq)) * kBq;  // long causal rows first
  const int b = bh / H, h = bh % H, kh = h / (H / KV);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  for (int e = tid; e < kBq * hd; e += kThreads) {
    const int r = e / hd, d = e - r * hd, qi = q0 + r;
    QT[d * kLd + r] =
        qi < Sq ? q[(static_cast<size_t>(b) * Sq + qi) * H * hd + h * hd + d] : 0.f;
  }
  for (int e = tid; e < kBk * ldv; e += kThreads) V[e] = 0.f;

  float acc[2][4][4], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int cc = 0; cc < 2; ++cc)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[cc][i][j] = 0.f;
  }

  // Keys this tile's rows may see: from the window's start for row q0 to
  // the causal limit of the last real row.
  int t_begin = 0, t_end = Sk;
  if (window > 0) t_begin = max(0, q0 - window + 1) / kBk * kBk;
  if (causal) t_end = min(t_end, min(Sq, q0 + kBq));

  for (int j0 = t_begin; j0 < t_end; j0 += kBk) {
    __syncthreads();  // the previous tile's KT, V and PT are consumed
    for (int e = tid; e < kBk * hd; e += kThreads) {
      const int t = e / hd, d = e - t * hd, kj = j0 + t;
      float kv = 0.f, vv = 0.f;
      if (kj < Sk) {
        const size_t off = (static_cast<size_t>(b) * Sk + kj) * KV * hd + kh * hd + d;
        kv = k[off];
        vv = v[off];
      }
      KT[d * kLd + t] = kv;
      V[t * ldv + d] = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float a[4], c[4];
      load4(a, lds4(QT + d * kLd + ty * 4));
      load4(c, lds4(KT + d * kLd + tx * 4));
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }

    // Online softmax per row; a row's 64 scores live in the 16 lanes of
    // one half-warp (same ty), reduced by xor shuffles within it.
    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = j0 + tx * 4 + j;
        const bool ok = kj < Sk && (!causal || kj <= qi) &&
                        (window <= 0 || kj > qi - window);
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      alpha[i] = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = l[i] * alpha[i] + sum;
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(PT + (tx * 4 + j) * kLd + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
#pragma unroll
    for (int cc = 0; cc < 2; ++cc)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[cc][i][j] *= alpha[i];
    __syncthreads();

    for (int t = 0; t < kBk; ++t) {
      float pr[4];
      load4(pr, lds4(PT + t * kLd + ty * 4));
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        if (cc < nc) {
          float vv[4];
          load4(vv, lds4(V + t * ldv + cc * 64 + tx * 4));
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[cc][i][j] = fmaf(pr[i], vv[j], acc[cc][i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* row = out + (static_cast<size_t>(b) * Sq + qi) * H * hd + h * hd;
#pragma unroll
    for (int cc = 0; cc < 2; ++cc)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = cc * 64 + tx * 4 + j;
        if (cc < nc && d < hd) row[d] = acc[cc][i][j] / den;
      }
  }
}

}  // namespace

extern "C" {

// Shared memory of one block (ops.py mirrors it): the k-major query and
// key tiles, the value tile (columns padded to whole 64-wide chunks) and
// the k-major probability tile.
int flash_attention_smem_bytes(int hd) {
  return 4 * (2 * hd * kLd + kBk * 64 * chunks(hd) + kBk * kLd);
}

// q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd); out: (B, Sq, H, hd); all
// contiguous fp32; window <= 0 means no window.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                        int B, int Sq, int Sk, int H, int KV, int hd,
                        int causal, int window, float scale,
                        cudaStream_t stream) {
  if (B < 0 || Sq < 0 || Sk < 0 || hd < 1 || hd > kMaxHd || KV < 1 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = B * H * ((Sq + kBq - 1) / kBq);
  void* args[] = {&q, &k, &v, &out, &Sq, &Sk, &H, &KV, &hd,
                  &causal, &window, &scale};
  return launch(reinterpret_cast<const void*>(flash_fwd_kernel),
                flash_attention_smem_bytes(hd), blocks, stream, args);
}

}  // extern "C"
