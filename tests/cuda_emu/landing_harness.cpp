// Runs the Landing kernels of fused_step.cu on the CPU through cuda_runtime.h
// here (harness.cpp runs the POGO ones).
// Usage: landing_harness DIR KIND B P N BASE NESTEROV TILE_N INPLACE HAS_PV
// reads DIR/{x,g,mu,nu,scal,pv}.bin (float32) and writes
// DIR/{x_out,mu_out,nu_out,dist}.bin. KIND 0 = whole, 1 = tiled.
#include <cuda_runtime.h>

#include <cstdio>
#include <cstdlib>
#include <thread>
#include <vector>

namespace {
// The kernels' `extern __shared__` arrays (one block runs at a time).
float4 whole_sm[232448 / 16];
float4 tiled_sm[232448 / 16];
}  // namespace

#include "fused_step.cu"

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
  if (argc != 11) return 2;
  const char* dir = argv[1];
  const int kind = atoi(argv[2]), B = atoi(argv[3]), p = atoi(argv[4]);
  const int n = atoi(argv[5]), base = atoi(argv[6]), nesterov = atoi(argv[7]);
  const int tile_n = atoi(argv[8]), inplace = atoi(argv[9]), has_pv = atoi(argv[10]);
  const size_t total = static_cast<size_t>(B) * p * n;
  auto x = read(dir, "x", total), g = read(dir, "g", total), mu = read(dir, "mu", total);
  auto nu = read(dir, "nu", B), scal = read(dir, "scal", 8), pvf = read(dir, "pv", B);
  std::vector<int> pv(pvf.begin(), pvf.end());
  std::vector<float> x_out(total), mu_out(total), nu_out(B), dist(B);
  float* xo = inplace ? x.data() : x_out.data();
  float* muo = inplace ? mu.data() : mu_out.data();
  float* nuo = inplace ? nu.data() : nu_out.data();
  const int vec = n % 4 == 0;
  emu_block_begin(kThreads);
  for (int b = 0; b < B; ++b) {
    blockIdx.x = b;
    std::vector<std::thread> threads;
    for (int t = 0; t < kThreads; ++t) {
      threads.emplace_back([&, t] {
        threadIdx.x = t;
        const int* pvp = has_pv ? pv.data() : nullptr;
        if (kind == 0) {
          fused_whole_landing_kernel(x.data(), g.data(), mu.data(), nu.data(), scal.data(), pvp,
                             xo, muo, nuo, dist.data(), p, n, base, nesterov, vec);
        } else {
          fused_tiled_landing_kernel(x.data(), g.data(), mu.data(), nu.data(), scal.data(), pvp,
                             xo, muo, nuo, dist.data(), p, n, base, nesterov, tile_n, vec);
        }
      });
    }
    for (auto& t : threads) t.join();
  }
  write(dir, "x_out", xo, total);
  write(dir, "mu_out", muo, total);
  write(dir, "nu_out", nuo, B);
  write(dir, "dist", dist.data(), B);
  return 0;
}
