// Runs the tensor-core fused step (fused_step_tc.cu) on the CPU through
// cuda_runtime.h and hopper.cuh here, by its C launcher: tensor maps, the
// persistent grid (g_emu_sms blocks) and the block as on the card; p > 64
// runs the wide kernel, with a park of B x fused_tc_park_floats(n) floats
// (the field uses the first B x kWKeep of them).
// Usage: tc_harness DIR METHOD B P N BASE NESTEROV INPLACE HAS_PV
// reads DIR/{x,g,mu,nu,scal,pv}.bin (float32) and writes
// DIR/{x_out,mu_out,nu_out,dist}.bin. METHOD 0 = POGO, 1 = Landing (the
// fused step); 2 = pogo_update_tc, 3 = landing_field_tc (the two-stage
// entries: x, g and scal in, x_out out; BASE, NESTEROV and HAS_PV unused).
#include <cuda_runtime.h>
#include <hopper.cuh>

#include <cstdio>
#include <cstdlib>
#include <vector>

namespace {
// The kernels' `extern __shared__` arrays (one block runs at a time).
alignas(1024) unsigned char fused_tc_smem[232448];
alignas(1024) unsigned char tf32_probe_smem[232448];
}  // namespace

#include "fused_step_tc.cu"

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

template <int M, bool TS, bool TMA>
static void register_wide_kernel() {
  g_emu_kernels[reinterpret_cast<const void*>(fused_tc_wide_kernel<M, TS, TMA>)] = [](void** a) {
    auto map = [a](int n) { return *static_cast<CUtensorMap*>(a[n]); };
    auto cf = [a](int n) { return *static_cast<const float**>(a[n]); };
    auto f = [a](int n) { return *static_cast<float**>(a[n]); };
    auto i = [a](int n) { return *static_cast<int*>(a[n]); };
    fused_tc_wide_kernel<M, TS, TMA>(map(0), map(1), map(2), map(3), map(4), map(5), cf(6),
                                     cf(7), cf(8), cf(9), cf(10),
                                     *static_cast<const int**>(a[11]), f(12), f(13), f(14),
                                     f(15), f(16), i(17), i(18), i(19), i(20), i(21));
  };
}

template <int M, bool TS>
static void register_kernel() {
  g_emu_kernels[reinterpret_cast<const void*>(fused_tc_kernel<M, TS>)] = [](void** a) {
    auto map = [a](int n) { return *static_cast<CUtensorMap*>(a[n]); };
    auto cf = [a](int n) { return *static_cast<const float**>(a[n]); };
    auto f = [a](int n) { return *static_cast<float**>(a[n]); };
    auto i = [a](int n) { return *static_cast<int*>(a[n]); };
    fused_tc_kernel<M, TS>(map(0), map(1), map(2), map(3), map(4), cf(5), cf(6), cf(7), cf(8),
                       cf(9), *static_cast<const int**>(a[10]), f(11), f(12), f(13), f(14),
                       i(15), i(16), i(17), i(18), i(19), i(20), i(21));
  };
}

int main(int argc, char** argv) {
  if (argc != 10) return 2;
  const char* dir = argv[1];
  const int method = atoi(argv[2]), B = atoi(argv[3]), p = atoi(argv[4]);
  const int n = atoi(argv[5]), base = atoi(argv[6]), nesterov = atoi(argv[7]);
  const int inplace = atoi(argv[8]), has_pv = atoi(argv[9]);
  const size_t total = static_cast<size_t>(B) * p * n;
  auto x = read(dir, "x", total), g = read(dir, "g", total), mu = read(dir, "mu", total);
  auto nu = read(dir, "nu", B), scal = read(dir, "scal", 8), pvf = read(dir, "pv", B);
  std::vector<int> pv(pvf.begin(), pvf.end());
  std::vector<float> x_out(total), mu_out(total), nu_out(B), dist(B);
  float* xo = inplace ? x.data() : x_out.data();
  float* muo = inplace ? mu.data() : mu_out.data();
  float* nuo = inplace ? nu.data() : nu_out.data();
  g_smem_base = fused_tc_smem;
  g_smem_size = sizeof fused_tc_smem;
  register_kernel<kPogo, false>();
  register_kernel<kLanding, false>();
  register_kernel<kPogo, true>();
  register_kernel<kLanding, true>();
  register_wide_kernel<kPogo, false, true>();
  register_wide_kernel<kLanding, false, true>();
  register_wide_kernel<kPogo, true, true>();
  register_wide_kernel<kLanding, true, true>();
  register_wide_kernel<kPogo, false, false>();
  register_wide_kernel<kLanding, false, false>();
  register_wide_kernel<kPogo, true, false>();
  register_wide_kernel<kLanding, true, false>();
  std::vector<float> park(static_cast<size_t>(B) * fused_tc_park_floats(n));
  if (method >= 2) {
    const int err = method == 2
        ? pogo_update_tc(x.data(), g.data(), scal.data(), xo, B, p, n, park.data(), nullptr)
        : landing_field_tc(x.data(), g.data(), scal.data(), xo, B, p, n, park.data(), nullptr);
    if (err != 0) {
      fprintf(stderr, "two-stage entry returned %d\n", err);
      return 3;
    }
    write(dir, "x_out", xo, total);
    return 0;
  }
  const int err = fused_step_tc(x.data(), g.data(), base != kNone ? mu.data() : nullptr,
                                base == kVAdam ? nu.data() : nullptr, scal.data(),
                                has_pv ? pv.data() : nullptr, xo,
                                base != kNone ? muo : nullptr, base == kVAdam ? nuo : nullptr,
                                dist.data(), B, p, n, base, nesterov, method, park.data(),
                                nullptr);
  if (err != 0) {
    fprintf(stderr, "fused_step_tc returned %d\n", err);
    return 3;
  }
  write(dir, "x_out", xo, total);
  write(dir, "mu_out", muo, total);
  write(dir, "nu_out", nuo, B);
  write(dir, "dist", dist.data(), B);
  return 0;
}
