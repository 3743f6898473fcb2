// Runs the kernels of newton_schulz.cu on the CPU through cuda_runtime.h here.
// Usage: ns_harness DIR KIND B P N ITERS TILE_N INPLACE MASKED
// reads DIR/{x,dist,mask}.bin (float32; mask 0/1 per matrix) and writes
// DIR/{out,dist_out}.bin. KIND 0 = whole, 1 = tiled. INPLACE 1 writes the
// output over x; MASKED 1 passes the mask (else every matrix runs).
#include <cuda_runtime.h>

#include <cstdio>
#include <cstdlib>
#include <thread>
#include <vector>

namespace {
// The kernels' `extern __shared__` arrays (one block runs at a time).
float4 ns_whole_sm[232448 / 16];
float4 ns_tiled_sm[232448 / 16];
}  // namespace

#include "newton_schulz.cu"

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
  if (argc != 10) return 2;
  const char* dir = argv[1];
  const int kind = atoi(argv[2]), B = atoi(argv[3]), p = atoi(argv[4]);
  const int n = atoi(argv[5]), iters = atoi(argv[6]), tile_n = atoi(argv[7]);
  const int inplace = atoi(argv[8]), masked = atoi(argv[9]);
  const size_t total = static_cast<size_t>(B) * p * n;
  auto x = read(dir, "x", total), dist = read(dir, "dist", B), maskf = read(dir, "mask", B);
  std::vector<unsigned char> mask(B);
  for (int b = 0; b < B; ++b) mask[b] = maskf[b] != 0.f;
  std::vector<float> out(total, -7.f);
  float* o = inplace ? x.data() : out.data();
  const unsigned char* m = masked ? mask.data() : nullptr;
  const int vec = n % 4 == 0;
  emu_block_begin(kThreads);
  for (int b = 0; b < B; ++b) {
    blockIdx.x = b;
    std::vector<std::thread> threads;
    for (int t = 0; t < kThreads; ++t) {
      threads.emplace_back([&, t] {
        threadIdx.x = t;
        if (kind == 0) {
          ns_whole_kernel(x.data(), o, m, dist.data(), p, n, iters, vec);
        } else {
          ns_tiled_kernel(x.data(), o, m, dist.data(), p, n, iters, tile_n, vec);
        }
      });
    }
    for (auto& t : threads) t.join();
  }
  write(dir, "out", o, total);
  write(dir, "dist_out", dist.data(), B);
  return 0;
}
