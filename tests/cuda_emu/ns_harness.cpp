// Runs the kernels of newton_schulz.cu and newton_schulz_tc.cu on the CPU
// through cuda_runtime.h and hopper.cuh here.
// Usage: ns_harness DIR KIND B P N ITERS TILE_N INPLACE MASKED
// reads DIR/{x,dist,mask}.bin (float32; mask 0/1 per matrix) and writes
// DIR/{out,dist_out}.bin. KIND 0 = whole, 1 = tiled (one block at a time),
// 2 = the tensor-core kernel through its C launcher (a cluster's blocks at
// once; TILE_N unused), 3 = the p <= 128 tensor-core kernel through its C
// launcher (a persistent grid of g_emu_sms clusters; TILE_N unused). INPLACE 1 writes the output over x; MASKED 1 passes
// the mask (else every matrix runs).
#include <cuda_runtime.h>
#include <hopper.cuh>

#include <cstdio>
#include <cstdlib>
#include <thread>
#include <vector>

namespace {
// The kernels' `extern __shared__` arrays (one block runs at a time); the
// tensor-core kernel's blocks take their own (smem_align1024).
float4 ns_whole_sm[232448 / 16];
float4 ns_tiled_sm[232448 / 16];
unsigned char ns_tc_smem[1];
}  // namespace

#include "newton_schulz.cu"
#include "newton_schulz_tc.cu"

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
  if (kind == 2) {
    g_emu_kernels[reinterpret_cast<const void*>(ns_tc_kernel)] = [](void** a) {
      auto i = [a](int k) { return *static_cast<int*>(a[k]); };
      ns_tc_kernel(*static_cast<const float**>(a[0]), *static_cast<float**>(a[1]),
                   *static_cast<const unsigned char**>(a[2]), *static_cast<float**>(a[3]), i(4),
                   i(5), i(6), i(7), i(8));
    };
    const int err = newton_schulz_tc(x.data(), o, m, dist.data(), B, p, n, iters, nullptr);
    if (err != 0) {
      fprintf(stderr, "newton_schulz_tc returned %d\n", err);
      return 3;
    }
    write(dir, "out", o, total);
    write(dir, "dist_out", dist.data(), B);
    return 0;
  }
  if (kind == 3) {
    g_emu_kernels[reinterpret_cast<const void*>(ns_tc128_kernel)] = [](void** a) {
      auto i = [a](int k) { return *static_cast<int*>(a[k]); };
      ns_tc128_kernel(*static_cast<const float**>(a[0]), *static_cast<float**>(a[1]),
                      *static_cast<const unsigned char**>(a[2]), *static_cast<float**>(a[3]),
                      i(4), i(5), i(6), i(7), i(8), i(9));
    };
    const int err = newton_schulz_tc128(x.data(), o, m, dist.data(), B, p, n, iters, nullptr);
    if (err != 0) {
      fprintf(stderr, "newton_schulz_tc128 returned %d\n", err);
      return 3;
    }
    write(dir, "out", o, total);
    write(dir, "dist_out", dist.data(), B);
    return 0;
  }
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
