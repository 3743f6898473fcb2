// Runs the cluster kernels of small_p.cu on the CPU through cuda_runtime.h
// and hopper.cuh here, by their C launchers: tensor maps, the persistent
// cluster grid (g_emu_sms clusters walk the matrices), each cluster's CTAs
// at once with their own shared memory.
// Usage: small_p_harness DIR METHOD B P N BASE NESTEROV INPLACE HAS_PV C
// reads DIR/{x,g,mu,nu,scal,pv}.bin (float32) and writes
// DIR/{x_out,mu_out,nu_out,dist}.bin. METHOD 0 = fused_step_cluster (POGO),
// 1 = fused_step_cluster (Landing), 2 = pogo_update_cluster, 3 =
// landing_field_cluster (the last two: x, g and scal in, x_out out; BASE,
// NESTEROV and HAS_PV unused). C is the cluster size (0: the launcher's own,
// small_p_cluster). METHOD 4 = newton_schulz_cluster(_c): BASE is the
// iteration count, NESTEROV whether a distance is asked, HAS_PV whether
// DIR/mask.bin (1.0 or 0.0 a matrix) masks; x and dist in (and, out of
// place, out: the output buffer's contents before the launch), x_out and
// dist_out out; C 0 the launcher's own (ns_cluster).
#include <cuda_runtime.h>
#include <hopper.cuh>

#include <cstdio>
#include <cstdlib>
#include <vector>

namespace {
// The kernels' `extern __shared__` array: each block of a cluster takes its
// own (smem_align1024).
unsigned char small_p_smem[1];
}  // namespace

#include "small_p.cu"

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

template <int PB, int M>
static void register_kernel() {
  g_emu_kernels[reinterpret_cast<const void*>(small_p_kernel<PB, M>)] = [](void** a) {
    auto map = [a](int n) { return *static_cast<CUtensorMap*>(a[n]); };
    auto cf = [a](int n) { return *static_cast<const float**>(a[n]); };
    auto f = [a](int n) { return *static_cast<float**>(a[n]); };
    auto i = [a](int n) { return *static_cast<int*>(a[n]); };
    small_p_kernel<PB, M>(map(0), map(1), cf(2), cf(3), cf(4), *static_cast<const int**>(a[5]),
                          f(6), f(7), f(8), f(9), i(10), i(11), i(12), i(13), i(14), i(15));
  };
}

template <int PB>
static void register_ns_kernel() {
  g_emu_kernels[reinterpret_cast<const void*>(small_p_ns_kernel<PB>)] = [](void** a) {
    small_p_ns_kernel<PB>(*static_cast<CUtensorMap*>(a[0]), *static_cast<float**>(a[1]),
                          *static_cast<const unsigned char**>(a[2]), *static_cast<float**>(a[3]),
                          *static_cast<int*>(a[4]), *static_cast<int*>(a[5]),
                          *static_cast<int*>(a[6]), *static_cast<int*>(a[7]),
                          *static_cast<int*>(a[8]));
  };
}

template <int M>
static void register_kernels() {
  register_kernel<4, M>();
  register_kernel<8, M>();
  register_kernel<12, M>();
  register_kernel<16, M>();
  register_kernel<20, M>();
  register_kernel<24, M>();
  register_kernel<28, M>();
  register_kernel<32, M>();
}

int main(int argc, char** argv) {
  if (argc != 11) return 2;
  const char* dir = argv[1];
  const int method = atoi(argv[2]), B = atoi(argv[3]), p = atoi(argv[4]);
  const int n = atoi(argv[5]), base = atoi(argv[6]), nesterov = atoi(argv[7]);
  const int inplace = atoi(argv[8]), has_pv = atoi(argv[9]), c = atoi(argv[10]);
  const size_t total = static_cast<size_t>(B) * p * n;
  auto x = read(dir, "x", total), g = read(dir, "g", total), mu = read(dir, "mu", total);
  auto nu = read(dir, "nu", B), scal = read(dir, "scal", 8), pvf = read(dir, "pv", B);
  std::vector<int> pv(pvf.begin(), pvf.end());
  std::vector<float> x_out(total), mu_out(total), nu_out(B), dist(B);
  float* xo = inplace ? x.data() : x_out.data();
  float* muo = inplace ? mu.data() : mu_out.data();
  float* nuo = inplace ? nu.data() : nu_out.data();
  register_kernels<kSpPogo>();
  register_kernels<kSpLanding>();
  register_kernels<kSpUpdate>();
  register_kernels<kSpField>();
  register_ns_kernel<4>();
  register_ns_kernel<8>();
  register_ns_kernel<12>();
  register_ns_kernel<16>();
  register_ns_kernel<20>();
  register_ns_kernel<24>();
  register_ns_kernel<28>();
  register_ns_kernel<32>();
  int err;
  if (method == 4) {
    auto maskf = read(dir, "mask", B), dist_in = read(dir, "dist", B), out0 = read(dir, "out", total);
    std::vector<unsigned char> mask(maskf.begin(), maskf.end());
    if (!inplace) x_out = out0;
    float* yo = inplace ? x.data() : x_out.data();
    float* d = nesterov ? dist_in.data() : nullptr;
    const unsigned char* m = has_pv ? mask.data() : nullptr;
    err = c ? newton_schulz_cluster_c(x.data(), yo, m, d, B, p, n, base, c, nullptr)
            : newton_schulz_cluster(x.data(), yo, m, d, B, p, n, base, nullptr);
    if (err != 0) {
      fprintf(stderr, "newton_schulz_cluster returned %d\n", err);
      return 3;
    }
    write(dir, "x_out", yo, total);
    write(dir, "dist_out", dist_in.data(), B);
    return 0;
  }
  if (method == kSpUpdate) {
    err = pogo_update_cluster(x.data(), g.data(), scal.data(), xo, B, p, n, c, nullptr);
  } else if (method == kSpField) {
    err = landing_field_cluster(x.data(), g.data(), scal.data(), xo, B, p, n, c, nullptr);
  } else {
    const float* m = base != kNone ? mu.data() : nullptr;
    const float* v = base == kVAdam ? nu.data() : nullptr;
    float* mo = base != kNone ? muo : nullptr;
    float* vo = base == kVAdam ? nuo : nullptr;
    const int* pvp = has_pv ? pv.data() : nullptr;
    err = fused_step_cluster(x.data(), g.data(), m, v, scal.data(), pvp, xo, mo, vo, dist.data(),
                             B, p, n, base, nesterov, method, c, nullptr);
  }
  if (err != 0) {
    fprintf(stderr, "small_p launcher returned %d\n", err);
    return 3;
  }
  write(dir, "x_out", xo, total);
  write(dir, "mu_out", muo, total);
  write(dir, "nu_out", nuo, B);
  write(dir, "dist", dist.data(), B);
  return 0;
}
