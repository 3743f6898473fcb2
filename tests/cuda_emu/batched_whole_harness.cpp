// Runs csrc/batched_whole.cu on the CPU through cuda_runtime.h and
// hopper.cuh here, by its C launchers: the persistent grid (on one
// emulated SM, so that a CTA walks several groups and reuses its stages),
// the ring of 1-D bulk copies, a thread a matrix. Usage:
//   batched_whole_harness DIR MODE B P N BASE NESTEROV HAS_PV INPLACE OFFSET
// MODE 0 fused POGO, 1 fused Landing (fused_step_batched), 2 the POGO update
// (pogo_update_batched). Reads DIR/{x,g,mu,nu,scal,pv}.bin and writes
// DIR/{x_out,mu_out,nu_out,dist}.bin. INPLACE 1 writes X' over x and mu'
// over mu; OFFSET floats shift every operand in its buffer (1: a view that is
// not 16-byte aligned, which takes plain loads).
#include <cuda_runtime.h>
#include <hopper.cuh>

#include <cstdio>
#include <cstdlib>
#include <vector>

namespace {
// The kernel's `extern __shared__` array (one block runs at a time).
alignas(1024) float4 bw_smem[232448 / 16];
}  // namespace

#include "batched_whole.cu"

static std::vector<float> read(const char* dir, const char* name, size_t count, size_t pad) {
  std::vector<float> v(count + pad, 0.f);
  char path[512];
  snprintf(path, sizeof path, "%s/%s.bin", dir, name);
  FILE* f = fopen(path, "rb");
  if (f == nullptr) return v;
  if (fread(v.data() + pad, sizeof(float), count, f) != count) std::fill(v.begin(), v.end(), 0.f);
  fclose(f);
  return v;
}

static void write(const char* dir, const char* name, const float* data, size_t count) {
  char path[512];
  snprintf(path, sizeof path, "%s/%s.bin", dir, name);
  FILE* f = fopen(path, "wb");
  fwrite(data, sizeof(float), count, f);
  fclose(f);
}

template <int M, int P>
static void register_one() {
  g_emu_kernels[bw_kernel_p<M, P>()] = [](void** a) {
    batched_whole_kernel<M, P>(*static_cast<BwArgs*>(a[0]));
  };
}

template <int M>
static void register_mode() {
  register_one<M, 1>();
  register_one<M, 2>();
  register_one<M, 3>();
  register_one<M, 4>();
}

int main(int argc, char** argv) {
  if (argc != 11) return 2;
  const char* dir = argv[1];
  const int mode = atoi(argv[2]), B = atoi(argv[3]), p = atoi(argv[4]), n = atoi(argv[5]);
  const int base = atoi(argv[6]), nesterov = atoi(argv[7]), has_pv = atoi(argv[8]);
  const int inplace = atoi(argv[9]), pad = atoi(argv[10]);
  const size_t total = static_cast<size_t>(B) * p * n;
  auto x = read(dir, "x", total, pad), g = read(dir, "g", total, pad);
  auto mu = read(dir, "mu", total, pad);
  auto nu = read(dir, "nu", B, 0), scal = read(dir, "scal", 8, 0), pvf = read(dir, "pv", B, 0);
  std::vector<int> pv(pvf.begin(), pvf.end());
  std::vector<float> x_out(total + pad), mu_out(total + pad), nu_out(B), dist(B);
  float* xo = inplace ? x.data() + pad : x_out.data() + pad;
  float* mo = inplace ? mu.data() + pad : mu_out.data() + pad;
  float* no = inplace ? nu.data() : nu_out.data();
  g_emu_sms = 1;
  g_smem_base = reinterpret_cast<unsigned char*>(bw_smem);
  g_smem_size = sizeof bw_smem;
  register_mode<kBwPogo>();
  register_mode<kBwLanding>();
  register_mode<kBwUpdate>();
  int err;
  if (mode == kBwUpdate) {
    err = pogo_update_batched(x.data() + pad, g.data() + pad, scal.data(), xo, B, p, n, nullptr);
  } else {
    const bool moments = base != kNone;
    err = fused_step_batched(x.data() + pad, g.data() + pad, moments ? mu.data() + pad : nullptr,
                             base == kVAdam ? nu.data() : nullptr, scal.data(),
                             has_pv ? pv.data() : nullptr, xo, moments ? mo : nullptr,
                             base == kVAdam ? no : nullptr, dist.data(), B, p, n, base, nesterov,
                             mode, nullptr);
  }
  if (err != 0) {
    fprintf(stderr, "launcher returned %d\n", err);
    return 3;
  }
  write(dir, "x_out", xo, total);
  write(dir, "mu_out", mo, total);
  write(dir, "nu_out", no, B);
  write(dir, "dist", dist.data(), B);
  return 0;
}
