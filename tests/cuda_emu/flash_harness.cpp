// Runs the kernel of flash_attention.cu on the CPU through cuda_runtime.h here.
// Usage: flash_harness DIR BF16 B SQ SK H KV HD CAUSAL WINDOW SCALE
// reads DIR/{q,k,v}.bin (float32; q (B, SQ, H, HD), k and v (B, SK, KV, HD))
// and writes DIR/out.bin (float32). BF16 1 rounds the inputs to bf16 (exact
// for values that are bf16 already) and runs the bf16 kernel, whose output
// is widened back to float32.
#include <cuda_runtime.h>

#include <cstdio>
#include <cstdlib>
#include <thread>
#include <vector>

namespace {
// The kernel's `extern __shared__` array (one block runs at a time).
float4 flash_sm[232448 / 16];
}  // namespace

#include "flash_attention.cu"

thread_local uint3 threadIdx;
uint3 blockIdx;
std::barrier<>* g_bar;
std::barrier<>* g_warp_bar[8];
float g_xchg[256];

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

template <typename T>
static void run(const std::vector<float>& qf, const std::vector<float>& kf,
                const std::vector<float>& vf, std::vector<float>& of, int B,
                int Sq, int Sk, int H, int KV, int hd, int causal,
                int window, float scale) {
  auto cast = [](const std::vector<float>& src) {
    std::vector<T> dst(src.size());
    for (size_t i = 0; i < src.size(); ++i) {
      if constexpr (sizeof(T) == 2) dst[i] = __float2bfloat16_rn(src[i]);
      else dst[i] = src[i];
    }
    return dst;
  };
  auto q = cast(qf), k = cast(kf), v = cast(vf);
  std::vector<T> out(of.size());
  const int blocks = B * H * ((Sq + kBq - 1) / kBq);
  for (int blk = 0; blk < blocks; ++blk) {
    blockIdx.x = blk;
    std::vector<std::thread> threads;
    for (int t = 0; t < kThreads; ++t) {
      threads.emplace_back([&, t] {
        threadIdx.x = t;
        flash_fwd_kernel<T>(q.data(), k.data(), v.data(), out.data(), Sq, Sk, H,
                            KV, hd, causal, window, scale);
      });
    }
    for (auto& t : threads) t.join();
  }
  for (size_t i = 0; i < of.size(); ++i) {
    if constexpr (sizeof(T) == 2) of[i] = __bfloat162float(out[i]);
    else of[i] = out[i];
  }
}

int main(int argc, char** argv) {
  if (argc != 12) return 2;
  const char* dir = argv[1];
  const int bf16 = atoi(argv[2]), B = atoi(argv[3]), Sq = atoi(argv[4]);
  const int Sk = atoi(argv[5]), H = atoi(argv[6]), KV = atoi(argv[7]);
  const int hd = atoi(argv[8]), causal = atoi(argv[9]), window = atoi(argv[10]);
  const float scale = static_cast<float>(atof(argv[11]));
  const size_t nq = static_cast<size_t>(B) * Sq * H * hd;
  const size_t nk = static_cast<size_t>(B) * Sk * KV * hd;
  auto q = read(dir, "q", nq), k = read(dir, "k", nk), v = read(dir, "v", nk);
  std::vector<float> out(nq, -7.f);
  g_bar = new std::barrier<>(kThreads);
  for (auto& w : g_warp_bar) w = new std::barrier<>(32);
  if (bf16) {
    run<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, H, KV, hd, causal, window, scale);
  } else {
    run<float>(q, k, v, out, B, Sq, Sk, H, KV, hd, causal, window, scale);
  }
  char path[512];
  snprintf(path, sizeof path, "%s/out.bin", dir);
  FILE* f = fopen(path, "wb");
  fwrite(out.data(), sizeof(float), nq, f);
  fclose(f);
  return 0;
}
