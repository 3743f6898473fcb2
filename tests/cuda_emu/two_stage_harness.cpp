// Runs the kernels of two_stage.cu on the CPU through cuda_runtime.h here.
// Usage: two_stage_harness DIR KIND METHOD B P N TILE_N INPLACE
// reads DIR/{x,g,scal}.bin (float32) and writes DIR/out.bin.
// KIND 0 = whole, 1 = tiled; METHOD 0 = POGO update, 1 = landing field.
// INPLACE 1 writes the output over x.
#include <cuda_runtime.h>

#include <cstdio>
#include <cstdlib>
#include <thread>
#include <vector>

namespace {
// The kernels' `extern __shared__` arrays (one block runs at a time).
float4 ts_whole_sm[232448 / 16];
float4 ts_tiled_sm[232448 / 16];
}  // namespace

#include "two_stage.cu"

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
  if (argc != 9) return 2;
  const char* dir = argv[1];
  const int kind = atoi(argv[2]), method = atoi(argv[3]), B = atoi(argv[4]);
  const int p = atoi(argv[5]), n = atoi(argv[6]), tile_n = atoi(argv[7]);
  const int inplace = atoi(argv[8]);
  const size_t total = static_cast<size_t>(B) * p * n;
  auto x = read(dir, "x", total), g = read(dir, "g", total), scal = read(dir, "scal", 2);
  std::vector<float> out(total);
  float* o = inplace ? x.data() : out.data();
  const int vec = n % 4 == 0;
  emu_block_begin(kThreads);
  for (int b = 0; b < B; ++b) {
    blockIdx.x = b;
    std::vector<std::thread> threads;
    for (int t = 0; t < kThreads; ++t) {
      threads.emplace_back([&, t] {
        threadIdx.x = t;
        if (kind == 0 && method == 0) {
          two_stage_whole_kernel<kPogo>(x.data(), g.data(), scal.data(), o, p, n, vec);
        } else if (kind == 0) {
          two_stage_whole_kernel<kLanding>(x.data(), g.data(), scal.data(), o, p, n, vec);
        } else if (method == 0) {
          two_stage_tiled_kernel<kPogo>(x.data(), g.data(), scal.data(), o, p, n, tile_n, vec);
        } else {
          two_stage_tiled_kernel<kLanding>(x.data(), g.data(), scal.data(), o, p, n, tile_n,
                                           vec);
        }
      });
    }
    for (auto& t : threads) t.join();
  }
  write(dir, "out", o, total);
  return 0;
}
