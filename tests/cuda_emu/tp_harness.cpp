// Runs the kernels of tp_step.cu on the CPU through cuda_runtime.h here.
// Usage: tp_harness DIR MODE B P N K BASE NESTEROV METHOD TILE_N HAS_SCL HAS_PV INPLACE
// MODE 0 (tp_gram) reads DIR/{x,g,mu,scal}.bin and writes
// DIR/{payload,gb,mu_out}.bin; MODE 1 (tp_apply) reads
// DIR/{x,gb,payload,scl,pv,scal}.bin and writes DIR/{x_out,dist}.bin.
// INPLACE 1 writes mu' over mu (MODE 0) or X' over x (MODE 1).
#include <cuda_runtime.h>

#include <cstdio>
#include <cstdlib>
#include <thread>
#include <vector>

namespace {
// The kernels' `extern __shared__` arrays (one block runs at a time).
float4 tp_gram_sm[232448 / 16];
float4 tp_apply_sm[232448 / 16];
}  // namespace

#include "tp_step.cu"

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

int main(int argc, char** argv) {
  if (argc != 14) return 2;
  const char* dir = argv[1];
  const int mode = atoi(argv[2]), B = atoi(argv[3]), p = atoi(argv[4]);
  const int n = atoi(argv[5]), K = atoi(argv[6]), base = atoi(argv[7]);
  const int nesterov = atoi(argv[8]), method = atoi(argv[9]), tile_n = atoi(argv[10]);
  const int has_scl = atoi(argv[11]), has_pv = atoi(argv[12]), inplace = atoi(argv[13]);
  const size_t total = static_cast<size_t>(B) * p * n;
  auto x = read(dir, "x", total), scal = read(dir, "scal", 8);
  auto g = read(dir, "g", total), mu = read(dir, "mu", total);
  auto gb = read(dir, "gb", total), payload = read(dir, "payload", static_cast<size_t>(B) * K);
  auto scl = read(dir, "scl", B), pvf = read(dir, "pv", B);
  std::vector<int> pv(pvf.begin(), pvf.end());
  std::vector<float> out(total), mu_out(total), dist(B);
  float* muo = inplace ? mu.data() : mu_out.data();
  float* xo = inplace ? x.data() : out.data();
  const int vec = n % 4 == 0;
  emu_block_begin(kThreads);
  for (int b = 0; b < B; ++b) {
    blockIdx.x = b;
    std::vector<std::thread> threads;
    for (int t = 0; t < kThreads; ++t) {
      threads.emplace_back([&, t] {
        threadIdx.x = t;
        if (mode == 0) {
          tp_gram_kernel(x.data(), g.data(), mu.data(), scal.data(), payload.data(),
                         gb.data(), muo, p, n, K, base, nesterov, tile_n, vec);
        } else {
          tp_apply_kernel(x.data(), gb.data(), payload.data(),
                          has_scl ? scl.data() : nullptr, scal.data(),
                          has_pv ? pv.data() : nullptr, xo, dist.data(), p, n, K,
                          method, tile_n, vec);
        }
      });
    }
    for (auto& t : threads) t.join();
  }
  if (mode == 0) {
    write(dir, "payload", payload.data(), static_cast<size_t>(B) * K);
    write(dir, "gb", gb.data(), total);
    write(dir, "mu_out", muo, total);
  } else {
    write(dir, "x_out", xo, total);
    write(dir, "dist", dist.data(), B);
  }
  return 0;
}
