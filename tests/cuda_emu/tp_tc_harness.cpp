// Runs the tensor-core TP kernels (tp_step_tc.cu) on the CPU through
// cuda_runtime.h and hopper.cuh here, by their C launchers: tensor maps,
// the persistent grid (g_emu_sms blocks), the algebra's one block a matrix.
// Usage: tp_tc_harness DIR MODE B P N K BASE NESTEROV METHOD HAS_SCL HAS_PV INPLACE
// MODE 0 (tp_gram_tc) reads DIR/{x,g,mu,scal}.bin and writes
// DIR/{payload,gb,mu_out}.bin; MODE 1 (tp_apply_tc) reads
// DIR/{x,gb,payload,scl,pv,scal}.bin and writes DIR/{x_out,dist}.bin.
// INPLACE 1 writes mu' over mu (MODE 0) or X' over x (MODE 1).
#include <cuda_runtime.h>
#include <hopper.cuh>

#include <cstdio>
#include <cstdlib>
#include <vector>

namespace {
// The kernels' `extern __shared__` arrays (one block runs at a time).
alignas(1024) unsigned char tp_gram_tc_smem[232448];
alignas(1024) unsigned char tp_alg_smem[232448];
alignas(1024) unsigned char tp_apply_tc_smem[232448];
}  // namespace

#include "tp_step_tc.cu"

static std::vector<float> read(const char* dir, const char* name, size_t count) {
  std::vector<float> v(count);
  char path[512];
  snprintf(path, sizeof path, "%s/%s.bin", dir, name);
  FILE* f = fopen(path, "rb");
  if (f == nullptr) return v;
  if (fread(v.data(), sizeof(float), count, f) != count) v.assign(count, 0.f);
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

template <int M>
static void register_alg() {
  g_emu_kernels[reinterpret_cast<const void*>(tp_alg_kernel<M>)] = [](void** a) {
    auto cf = [a](int n) { return *static_cast<const float**>(a[n]); };
    auto i = [a](int n) { return *static_cast<int*>(a[n]); };
    tp_alg_kernel<M>(cf(0), cf(1), cf(2), *static_cast<const int**>(a[3]),
                     *static_cast<float**>(a[4]), *static_cast<float**>(a[5]), i(6), i(7));
  };
}

static void register_kernels() {
  g_emu_kernels[reinterpret_cast<const void*>(tp_gram_tc_kernel)] = [](void** a) {
    auto map = [a](int n) { return *static_cast<CUtensorMap*>(a[n]); };
    auto i = [a](int n) { return *static_cast<int*>(a[n]); };
    tp_gram_tc_kernel(map(0), map(1), map(2), map(3), map(4), *static_cast<const float**>(a[5]),
                      *static_cast<float**>(a[6]), i(7), i(8), i(9), i(10), i(11), i(12));
  };
  register_alg<kPogo>();
  register_alg<kLanding>();
  g_emu_kernels[reinterpret_cast<const void*>(tp_apply_sweep_kernel)] = [](void** a) {
    auto map = [a](int n) { return *static_cast<CUtensorMap*>(a[n]); };
    auto cf = [a](int n) { return *static_cast<const float**>(a[n]); };
    auto i = [a](int n) { return *static_cast<int*>(a[n]); };
    tp_apply_sweep_kernel(map(0), map(1), map(2), cf(3), i(4), i(5), i(6));
  };
}

int main(int argc, char** argv) {
  if (argc != 13) return 2;
  const char* dir = argv[1];
  const int mode = atoi(argv[2]), B = atoi(argv[3]), p = atoi(argv[4]);
  const int n = atoi(argv[5]), K = atoi(argv[6]), base = atoi(argv[7]);
  const int nesterov = atoi(argv[8]), method = atoi(argv[9]);
  const int has_scl = atoi(argv[10]), has_pv = atoi(argv[11]), inplace = atoi(argv[12]);
  const size_t total = static_cast<size_t>(B) * p * n;
  auto x = read(dir, "x", total), scal = read(dir, "scal", 8);
  auto g = read(dir, "g", total), mu = read(dir, "mu", total);
  auto gb = read(dir, "gb", total), payload = read(dir, "payload", static_cast<size_t>(B) * K);
  auto scl = read(dir, "scl", B), pvf = read(dir, "pv", B);
  std::vector<int> pv(pvf.begin(), pvf.end());
  std::vector<float> out(total), mu_out(total), dist(B), ops(static_cast<size_t>(B) * 2 * p * p);
  float* muo = inplace ? mu.data() : mu_out.data();
  float* xo = inplace ? x.data() : out.data();
  g_smem_base = tp_gram_tc_smem;
  g_smem_size = sizeof tp_gram_tc_smem;
  register_kernels();
  if (mode == 0) {
    const int err = tp_gram_tc(x.data(), g.data(), base != kNone ? mu.data() : nullptr,
                               scal.data(), payload.data(), gb.data(),
                               base != kNone ? muo : nullptr, B, p, n, base, nesterov, nullptr);
    if (err != 0) {
      fprintf(stderr, "tp_gram_tc returned %d\n", err);
      return 3;
    }
    write(dir, "payload", payload.data(), static_cast<size_t>(B) * K);
    write(dir, "gb", gb.data(), total);
    write(dir, "mu_out", muo, total);
    return 0;
  }
  const int err = tp_apply_tc(x.data(), gb.data(), payload.data(), has_scl ? scl.data() : nullptr,
                              scal.data(), has_pv ? pv.data() : nullptr, xo, dist.data(),
                              ops.data(), B, p, n, K, method, nullptr);
  if (err != 0) {
    fprintf(stderr, "tp_apply_tc returned %d\n", err);
    return 3;
  }
  write(dir, "x_out", xo, total);
  write(dir, "dist", dist.data(), B);
  return 0;
}
