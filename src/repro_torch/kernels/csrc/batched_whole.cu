// The whole-matrix fused group step (POGO and Landing) and the two-stage
// POGO update for stacks of many tiny matrices, p <= n <= 4, on Hopper
// (sm_90a), IEEE fp32 on the CUDA cores.
//
// Replaces the Pallas TPU kernels
//   fused_step_batched          <- src/repro/kernels/fused_step.py:175 fused_step_whole,
//                                  _fused_whole_kernel :132 (POGO branch :155-163)
//   fused_step_batched_landing  <- the same kernel's Landing branch (:164-168)
//   pogo_update_batched         <- src/repro/kernels/pogo_update.py:64 pogo_update_whole
//                                  (_pogo_whole_kernel :47)
// as fused_step.cu's fused_step_whole and two_stage.cu's pogo_update_whole
// do for larger matrices, for the shapes ops.plan gives "batched": the
// paper's 218,624 orthogonal CNN kernels of 3 x 3 among them. The TPU
// kernels take block_b matrices a grid step, the axis meant for stacks of
// many small matrices; the kernels of fused_step.cu and two_stage.cu give a
// whole 256-thread CTA to each matrix, with plain loads and a barrier per
// phase, which at 3 x 3 leaves almost every thread idle.
//
// What bounds it: bytes. The fused step reads X, g, mu and writes X', mu'
// (5 HBM passes of 4 p n bytes a matrix, 3 without a moment) against about
// 12 p^2 n flops (the update: 3 passes), i.e. 0.6 p <= 2.4 flop a byte,
// under the fp32 ridge of an H100 (67 TFLOP/s over 3.35 TB/s, 20 flop a
// byte). So it keeps HBM busy and every product on the CUDA cores: no TF32
// and no wgmma (a 64-row wgmma tile would be 21x padding at p = 3), no fast
// math.
//
// Design.
// * A thread a matrix: X, g and mu (27 floats at 3 x 3) and every product
//   in registers, columns padded with zeros to 4.
// * Persistent CTAs of 256 threads walk groups of 256 consecutive matrices.
//   The stack is contiguous, so a group of X (of g, of mu) is one span of
//   256 p n floats: thread 0 issues one 1-D bulk copy a span (cp.async.bulk,
//   no tensor map, so n % 4 != 0 is fine) into a ring of three stages with
//   full and done mbarriers, two groups ahead, so that the next groups land
//   while this one computes. A thread reads its matrix from its row-major
//   slot in the stage (a stride of p n = 9 floats at 3 x 3 keeps the threads
//   off each other's banks) and writes X' and mu' over it; they leave by 1-D
//   bulk stores, and before a stage is refilled thread 0 waits for its
//   stores to have read it (bulk_wait_read). nu' and the distance (B floats
//   each) are stored directly. The tail group, and a stack that is a
//   misaligned view (spans not 16-byte aligned), go through the same ring
//   with plain loads and stores from HBM. The launch's scalars are read
//   into shared memory once.
// * Arithmetic as the kernels of fused_step.cu: the base stage (none |
//   trace (+nesterov) | vadam, whose per-matrix sum of squares the thread
//   sums), grams A = X X^T and B = X Geu^T, then the direction and leap as
//   one (p, 2p) x (2p, n) product, M = s X - ([coef/2 A, P2] [Geu; X]) with
//   P2 = -coef/2 B (POGO; s = 1) or eta lam A - coef/2 B (Landing; s = 1 +
//   eta lam); POGO's land gram C = M M^T, X' = (1 + lam) M - lam C M and the
//   distance from the identity X' X'^T = (1 + lam)^2 C - 2 lam (1 + lam) C^2
//   + lam^2 C^3; Landing's distance from the direct gram of X'. The update
//   is POGO's without the base stage and the distance.
// * On an H100 80GB HBM3 at 700 W (chip_smoke.py's phase_batched_whole),
//   218,624 x (3, 3), rotating through copies of the inputs past the 50 MB
//   L2: 15.20 / 14.41 / 9.28 us of device time a launch (fused POGO over
//   trace, fused Landing over trace, the update) against HBM bounds of
//   12.01 / 12.01 / 7.05 us, 1.20-1.32x; the whole kernels took 2.42-2.90 ms
//   a launch there. With the 23.6 MB of inputs warm in L2, where the HBM
//   bound does not limit it, 13.01 / 12.68 / 6.70 us. At 4 x 4 a CTA's
//   three stages take 147 KB, one CTA an SM: 53.27 us warm, 2.5x the bound
//   (benchmarks_torch/batched_readings.py --shapes).
//
// Scalars ride scal[8] = [eta, lam, post_scale, h0..h4] as in
// fused_step.cu (the update reads eta and lam). Every launcher returns
// cudaGetLastError(). Outputs may alias inputs (x_out == x, mu_out == mu,
// nu_out == nu): a group is read whole before any of it is written.

#include <mutex>

#include "hopper.cuh"
#include "tiles.cuh"

namespace {

enum BwMode { kBwPogo = 0, kBwLanding = 1, kBwUpdate = 2 };

// A CTA's threads, and the matrices of a group: one a thread.
constexpr int kBwThreads = 256;
constexpr int kBwWarps = kBwThreads / 32;
constexpr int kBwStages = 3;
// Ahead of the stages, in floats: the mbarriers (full and done, a stage
// each), then from kBwScalOffset the launch's eight scalars.
constexpr int kBwScalOffset = 16;
constexpr int kBwHeadFloats = 32;
// The largest n (and p): a matrix's operands held in registers, columns
// padded with zeros to it.
constexpr int kBwMaxN = 4;
// CTAs an SM the register cap allows (__launch_bounds__: 128 registers).
constexpr int kBwCtas = 2;

struct BwArgs {
  const float *x, *g, *mu, *nu, *scal;
  const int* pv;
  float *x_out, *mu_out, *nu_out, *dist;
  int B, p, n, base_kind, nesterov;
  int bulk;  // every full group through 1-D bulk copies
};

// Operands read a step, each staged: X, g and, with a moment, mu.
__host__ __device__ inline int bw_tensors(int mode, int base_kind) {
  return mode != kBwUpdate && base_kind != kNone ? 3 : 2;
}

__host__ __device__ inline int bw_smem_bytes(int tensors, int p, int n) {
  return 4 * (kBwHeadFloats + kBwStages * tensors * kBwThreads * p * n);
}

__device__ inline bool bw_bulk_group(const BwArgs& a, int grp) {
  return a.bulk && (grp + 1) * kBwThreads <= a.B;
}

// Thread 0: the loads of the CTA's t-th group into its stage (plain groups
// only mark the stage full: their threads read HBM themselves).
__device__ void bw_issue(const BwArgs& a, uint64_t* full, float* stages, int tensors, int t,
                         int groups) {
  const int grp = blockIdx.x + t * gridDim.x;
  if (grp >= groups) return;
  const int s = t % kBwStages;
  if (!bw_bulk_group(a, grp)) {
    hopper::mbar_arrive(&full[s]);
    return;
  }
  const int span = kBwThreads * a.p * a.n;
  const size_t off = static_cast<size_t>(grp) * span;
  const uint32_t bytes = static_cast<uint32_t>(span) * 4u;
  float* st = stages + s * tensors * span;
  hopper::mbar_expect_tx(&full[s], tensors * bytes);
  hopper::bulk_load(st, a.x + off, bytes, &full[s]);
  hopper::bulk_load(st + span, a.g + off, bytes, &full[s]);
  if (tensors == 3) hopper::bulk_load(st + 2 * span, a.mu + off, bytes, &full[s]);
}

// The per-matrix scale of Geu: post_scale, and for vadam the bias-corrected
// scalar second moment from nu and the sum of squares `sq` (nu' returned in
// *nu2).
__device__ inline float bw_scale(const BwArgs& a, const float* sc, float nu0, float sq,
                                float* nu2) {
  const float ps = sc[2];
  if (a.base_kind != kVAdam) return ps;
  const float b2 = sc[4], eps = sc[5], c1 = sc[6], c2 = sc[7];
  *nu2 = b2 * nu0 + (1.f - b2) * sq;
  return (ps / c1) / (sqrtf(*nu2 / c2) + eps);
}

// ------------------------------------------------------- a thread's matrix

// One matrix, (P, n), in registers; xs, gs, ms its row-major slots in the
// stage (read, then X' and mu' written over them), or, for a plain group,
// the matrix in HBM itself.
template <int kMode, int P>
__device__ void bw_thread_matrix(const BwArgs& a, const float* sc, int b, const float* xs,
                                 const float* gs, const float* ms, float* xo, float* mo) {
  constexpr int N = kBwMaxN;
  const int n = a.n;
  float x[P][N], g[P][N];
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < P; ++i)
#pragma unroll
    for (int k = 0; k < N; ++k) {
      x[i][k] = k < n ? xs[i * n + k] : 0.f;
      g[i][k] = k < n ? gs[i * n + k] : 0.f;
    }
  if (kMode != kBwUpdate && a.base_kind != kNone) {
    const float h0 = sc[3];
#pragma unroll
    for (int i = 0; i < P; ++i)
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float mv = k < n ? ms[i * n + k] : 0.f;
        float m2;
        if (a.base_kind == kTrace) {
          m2 = h0 * mv + g[i][k];
        } else {
          m2 = h0 * mv + (1.f - h0) * g[i][k];
          sq = fmaf(g[i][k], g[i][k], sq);
        }
        if (k < n) mo[i * n + k] = m2;
        g[i][k] = (a.base_kind == kTrace && a.nesterov) ? h0 * m2 + g[i][k] : m2;
      }
  }
  const float eta = sc[0], lam = sc[1];
  float nu2 = 0.f;
  const float nu0 = kMode != kBwUpdate && a.base_kind == kVAdam ? a.nu[b] : 0.f;
  const float coef = kMode == kBwUpdate ? eta : eta * bw_scale(a, sc, nu0, sq, &nu2);
  const float hc = 0.5f * coef, el = kMode == kBwLanding ? eta * lam : 0.f;
  float p1[P][P], p2[P][P];
#pragma unroll
  for (int i = 0; i < P; ++i)
#pragma unroll
    for (int j = 0; j < P; ++j) {
      float aa = 0.f, bb = 0.f;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        aa = fmaf(x[i][k], x[j][k], aa);
        bb = fmaf(x[i][k], g[j][k], bb);
      }
      p1[i][j] = hc * aa;
      p2[i][j] = kMode == kBwLanding ? el * aa - hc * bb : -hc * bb;
    }
  const float s0 = kMode == kBwLanding ? 1.f + el : 1.f;
  float mm[P][N];
#pragma unroll
  for (int i = 0; i < P; ++i)
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < P; ++j) acc = fmaf(p1[i][j], g[j][k], fmaf(p2[i][j], x[j][k], acc));
      mm[i][k] = s0 * x[i][k] - acc;
    }
  float c[P][P];  // POGO's C = M M^T, Landing's W = X' X'^T
#pragma unroll
  for (int i = 0; i < P; ++i)
#pragma unroll
    for (int j = 0; j < P; ++j) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < N; ++k) s = fmaf(mm[i][k], mm[j][k], s);
      c[i][j] = s;
    }
  if (kMode != kBwLanding) {  // X' = (1 + lam) M - lam C M, written over M
    float out[P][N];
#pragma unroll
    for (int i = 0; i < P; ++i)
#pragma unroll
      for (int k = 0; k < N; ++k) {
        float cm = 0.f;
#pragma unroll
        for (int j = 0; j < P; ++j) cm = fmaf(c[i][j], mm[j][k], cm);
        out[i][k] = (1.f + lam) * mm[i][k] - lam * cm;
      }
#pragma unroll
    for (int i = 0; i < P; ++i)
#pragma unroll
      for (int k = 0; k < N; ++k) mm[i][k] = out[i][k];
  }
#pragma unroll
  for (int i = 0; i < P; ++i)
#pragma unroll
    for (int k = 0; k < N; ++k)
      if (k < n) xo[i * n + k] = mm[i][k];
  if (kMode == kBwUpdate) return;
  if (a.base_kind == kVAdam) a.nu_out[b] = nu2;
  const int pvb = a.pv != nullptr ? a.pv[b] : P;
  float acc = 0.f;
  if (kMode == kBwPogo) {  // W = (1+lam)^2 C - 2 lam (1+lam) C^2 + lam^2 C^3
    const float k1 = (1.f + lam) * (1.f + lam), k2 = 2.f * lam * (1.f + lam), k3 = lam * lam;
    float c2[P][P];
#pragma unroll
    for (int i = 0; i < P; ++i)
#pragma unroll
      for (int j = 0; j < P; ++j) {
        float s = 0.f;
#pragma unroll
        for (int l = 0; l < P; ++l) s = fmaf(c[i][l], c[l][j], s);
        c2[i][j] = s;
      }
#pragma unroll
    for (int i = 0; i < P; ++i)
#pragma unroll
      for (int j = 0; j < P; ++j) {
        float c3 = 0.f;
#pragma unroll
        for (int l = 0; l < P; ++l) c3 = fmaf(c2[i][l], c[l][j], c3);
        const float w = k1 * c[i][j] - k2 * c2[i][j] + k3 * c3;
        const float r = w - ((i == j && i < pvb) ? 1.f : 0.f);
        acc = fmaf(r, r, acc);
      }
  } else {
#pragma unroll
    for (int i = 0; i < P; ++i)
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const float r = c[i][j] - ((i == j && i < pvb) ? 1.f : 0.f);
        acc = fmaf(r, r, acc);
      }
  }
  a.dist[b] = sqrtf(acc);
}

// ---------------------------------------------------------------- kernel

// kP: the matrices' rows, 1 to kBwMaxN.
template <int kMode, int kP>
__global__ void __launch_bounds__(kBwThreads, kBwCtas) batched_whole_kernel(const BwArgs a) {
  extern __shared__ float4 bw_smem[];
  float* sm = reinterpret_cast<float*>(bw_smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm);
  uint64_t* done = full + kBwStages;
  float* sc = sm + kBwScalOffset;  // the launch's scalars, read once
  const int pn = a.p * a.n, span = kBwThreads * pn;
  const int tensors = bw_tensors(kMode, a.base_kind);
  float* stages = sm + kBwHeadFloats;
  const int groups = (a.B + kBwThreads - 1) / kBwThreads;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kBwStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&done[s], kBwWarps);
    }
    hopper::mbar_fence_init();
  }
  if (threadIdx.x < (kMode == kBwUpdate ? 2 : 8)) sc[threadIdx.x] = a.scal[threadIdx.x];
  __syncthreads();  // the barriers and scalars, once a launch
  if (threadIdx.x == 0) {
    bw_issue(a, full, stages, tensors, 0, groups);
    bw_issue(a, full, stages, tensors, 1, groups);
  }
  for (int t = 0, grp = blockIdx.x; grp < groups; ++t, grp += gridDim.x) {
    const int s = t % kBwStages;
    const uint32_t par = (t / kBwStages) & 1;
    float* st = stages + s * tensors * span;
    const int first = grp * kBwThreads, b = first + static_cast<int>(threadIdx.x);
    const bool bulk = bw_bulk_group(a, grp);
    hopper::mbar_wait(&full[s], par);
    if (b < a.B) {
      if (bulk) {
        float* xs = st + threadIdx.x * pn;
        float* ms = xs + 2 * span;
        bw_thread_matrix<kMode, kP>(a, sc, b, xs, xs + span, ms, xs, ms);
      } else {
        const size_t off = static_cast<size_t>(b) * pn;
        bw_thread_matrix<kMode, kP>(a, sc, b, a.x + off, a.g + off, a.mu + off, a.x_out + off,
                                    a.mu_out + off);
      }
    }
    // X' and mu' in the stage, then to the bulk stores' proxy
    hopper::fence_proxy_async_smem();
    __syncwarp();
    if ((threadIdx.x & 31) == 0) hopper::mbar_arrive(&done[s]);
    if (threadIdx.x == 0) {
      hopper::mbar_wait(&done[s], par);
      if (bulk) {
        const size_t off = static_cast<size_t>(first) * pn;
        const uint32_t bytes = static_cast<uint32_t>(span) * 4u;
        hopper::bulk_store(a.x_out + off, st, bytes);
        if (tensors == 3) hopper::bulk_store(a.mu_out + off, st + 2 * span, bytes);
        hopper::bulk_commit();
        // the stage of group t + 2, the last group's, read by its stores
        // before it is refilled: all but this group's
        hopper::bulk_wait_read<1>();
      } else {
        hopper::bulk_wait_read<0>();
      }
      bw_issue(a, full, stages, tensors, t + 2, groups);
    }
  }
  if (threadIdx.x == 0) hopper::bulk_wait<0>();
}

template <int kMode, int kP>
const void* bw_kernel_p() {
  return reinterpret_cast<const void*>(batched_whole_kernel<kMode, kP>);
}

template <int kMode>
const void* bw_kernel(int p) {
  switch (p) {
    case 1: return bw_kernel_p<kMode, 1>();
    case 2: return bw_kernel_p<kMode, 2>();
    case 3: return bw_kernel_p<kMode, 3>();
    default: return bw_kernel_p<kMode, 4>();
  }
}

// Resident CTAs of `kernel` an SM at `smem` bytes, by the runtime's
// occupancy calculator, asked once a (kernel, smem) and kept.
int bw_blocks_per_sm(const void* kernel, int smem, int* blocks) {
  struct Seen {
    const void* kernel;
    int smem, blocks;
  };
  static Seen seen[64];
  static int count = 0;
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < count; ++i) {
    if (seen[i].kernel == kernel && seen[i].smem == smem) {
      *blocks = seen[i].blocks;
      return 0;
    }
  }
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, kBwThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (count < 64) seen[count++] = Seen{kernel, smem, *blocks};
  return 0;
}

int bw_launch(int mode, BwArgs a, void* stream) {
  if (a.B < 0 || a.p < 1 || a.p > a.n || a.n > kBwMaxN || a.base_kind < kNone ||
      a.base_kind > kVAdam)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tensors = bw_tensors(mode, a.base_kind);
  // a span is 256 p n floats, a multiple of 16 bytes: the bases decide
  const void* ptrs[] = {a.x, a.g, a.x_out, tensors == 3 ? a.mu : a.x,
                        tensors == 3 ? a.mu_out : a.x};
  a.bulk = 1;
  for (const void* q : ptrs) a.bulk &= reinterpret_cast<uintptr_t>(q) % 16 == 0;
  const void* kernel = mode == kBwPogo      ? bw_kernel<kBwPogo>(a.p)
                       : mode == kBwLanding ? bw_kernel<kBwLanding>(a.p)
                                            : bw_kernel<kBwUpdate>(a.p);
  const int smem = bw_smem_bytes(tensors, a.p, a.n);
  int blocks = 0, sms = 0, dev = 0;
  int err = bw_blocks_per_sm(kernel, smem, &blocks);
  if (err != 0) return err;
  cudaError_t cerr = cudaGetDevice(&dev);
  if (cerr == cudaSuccess) cerr = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const int groups = (a.B + kBwThreads - 1) / kBwThreads;
  const int resident = (blocks > 1 ? blocks : 1) * sms;
  const int grid = groups < resident ? groups : resident;
  void* args[] = {&a};
  return launch(kernel, smem, grid, static_cast<cudaStream_t>(stream), args, kBwThreads);
}

}  // namespace

extern "C" {

// method: 0 POGO, 1 Landing (the fixed step); fused_step_whole's signature.
// Returns cudaErrorInvalidValue unless p <= n <= 4.
int fused_step_batched(const float* x, const float* g, const float* mu, const float* nu,
                       const float* scal, const int* pv, float* x_out, float* mu_out,
                       float* nu_out, float* dist, int B, int p, int n, int base_kind,
                       int nesterov, int method, void* stream) {
  if (method != kPogo && method != kLanding) return static_cast<int>(cudaErrorInvalidValue);
  BwArgs a{x, g, mu, nu, scal, pv, x_out, mu_out, nu_out, dist, B, p, n, base_kind, nesterov, 0};
  return bw_launch(method == kLanding ? kBwLanding : kBwPogo, a, stream);
}

// pogo_update_whole's signature: scal = [eta, lam, ...]; out may be x.
int pogo_update_batched(const float* x, const float* g, const float* scal, float* out, int B,
                        int p, int n, void* stream) {
  BwArgs a{x, g, nullptr, nullptr, scal, nullptr, out, nullptr, nullptr, nullptr, B, p, n,
           kNone, 0, 0};
  return bw_launch(kBwUpdate, a, stream);
}

}  // extern "C"
