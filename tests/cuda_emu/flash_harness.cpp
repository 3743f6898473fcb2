// Runs the flash-attention kernels on the CPU through cuda_runtime.h and
// hopper.cuh here: fp32 through flash_attention.cu (the CUDA-core kernel,
// its blocks spawned here), bf16 through flash_attention_tc.cu's launcher
// and fp32 through flash_attention_tf32.cu's (the tensor-core kernels:
// tensor maps, grid and block as on the card).
// Usage: flash_harness DIR KIND B SQ SK H KV HD CAUSAL WINDOW SCALE
// reads DIR/{q,k,v}.bin (float32; q (B, SQ, H, HD), k and v (B, SK, KV, HD))
// and writes DIR/out.bin (float32). KIND 0 runs the CUDA-core kernel; 1 the
// bf16 kernel: it rounds the inputs to bf16 (exact for values that are bf16
// already), pads rows to a multiple of 8 columns with zeros as the wrapper
// does, and widens the bf16 output to float32; 2 the 3xTF32 kernel (HD a
// multiple of 4).
#include <cuda_runtime.h>
#include <hopper.cuh>

#include <cstdio>
#include <cstdlib>
#include <thread>
#include <vector>

namespace {
// The kernels' `extern __shared__` arrays (one block runs at a time).
float4 flash_sm[232448 / 16];
alignas(1024) unsigned char flash_tc_smem[232448];
unsigned char flash_tf32_smem[1];  // the tf32 kernel's name; smem_align1024 gives the block's
}  // namespace

#include "flash_attention.cu"
#include "flash_attention_tc.cu"
#include "flash_attention_tf32.cu"

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

static void run_fp32(const std::vector<float>& q, const std::vector<float>& k,
                     const std::vector<float>& v, std::vector<float>& out, int B, int Sq,
                     int Sk, int H, int KV, int hd, int causal, int window, float scale) {
  const int blocks = B * H * ((Sq + kBq - 1) / kBq);
  emu_block_begin(kThreads);
  for (int blk = 0; blk < blocks; ++blk) {
    blockIdx.x = blk;
    std::vector<std::thread> threads;
    for (int t = 0; t < kThreads; ++t) {
      threads.emplace_back([&, t] {
        threadIdx.x = t;
        flash_fwd_kernel(q.data(), k.data(), v.data(), out.data(), Sq, Sk, H, KV, hd, causal,
                         window, scale);
      });
    }
    for (auto& t : threads) t.join();
  }
}

template <int NB>
static void register_tc() {
  g_emu_kernels[reinterpret_cast<const void*>(flash_tc_kernel<NB>)] = [](void** a) {
    auto i = [a](int n) { return *static_cast<int*>(a[n]); };
    flash_tc_kernel<NB>(*static_cast<CUtensorMap*>(a[0]), *static_cast<CUtensorMap*>(a[1]),
                        *static_cast<CUtensorMap*>(a[2]),
                        static_cast<__nv_bfloat16*>(*static_cast<void**>(a[3])), i(4), i(5),
                        i(6), i(7), i(8), i(9), i(10), *static_cast<float*>(a[11]));
  };
}

static int run_bf16(const std::vector<float>& qf, const std::vector<float>& kf,
                    const std::vector<float>& vf, std::vector<float>& of, int B, int Sq,
                    int Sk, int H, int KV, int hd, int causal, int window, float scale) {
  const int ld = (hd + 7) / 8 * 8;
  auto cast = [hd, ld](const std::vector<float>& src) {  // rows of ld, zero past hd
    const size_t rows = src.size() / hd;
    std::vector<__nv_bfloat16> dst(rows * ld, __nv_bfloat16{0});
    for (size_t r = 0; r < rows; ++r)
      for (int d = 0; d < hd; ++d) dst[r * ld + d] = __float2bfloat16_rn(src[r * hd + d]);
    return dst;
  };
  auto q = cast(qf), k = cast(kf), v = cast(vf);
  std::vector<__nv_bfloat16> out(of.size(), __float2bfloat16_rn(-7.f));
  g_smem_base = flash_tc_smem;
  g_smem_size = sizeof flash_tc_smem;
  register_tc<1>();
  register_tc<2>();
  const int err = flash_attention_tc_fwd(q.data(), k.data(), v.data(), out.data(), B, Sq, Sk,
                                         H, KV, ld, hd, causal, window, scale, nullptr);
  for (size_t i = 0; i < of.size(); ++i) of[i] = __bfloat162float(out[i]);
  return err;
}

template <int NB>
static void register_tf32() {
  g_emu_kernels[reinterpret_cast<const void*>(flash_tf32_kernel<NB>)] = [](void** a) {
    auto i = [a](int n) { return *static_cast<int*>(a[n]); };
    flash_tf32_kernel<NB>(*static_cast<CUtensorMap*>(a[0]), *static_cast<CUtensorMap*>(a[1]),
                          *static_cast<CUtensorMap*>(a[2]),
                          static_cast<float*>(*static_cast<void**>(a[3])), i(4), i(5), i(6),
                          i(7), i(8), i(9), i(10), *static_cast<float*>(a[11]));
  };
}

static int run_tf32(const std::vector<float>& q, const std::vector<float>& k,
                    const std::vector<float>& v, std::vector<float>& out, int B, int Sq,
                    int Sk, int H, int KV, int hd, int causal, int window, float scale) {
  g_smem_base = flash_tc_smem;
  g_smem_size = sizeof flash_tc_smem;
  register_tf32<1>();
  register_tf32<2>();
  register_tf32<4>();
  return flash_attention_tf32_fwd(q.data(), k.data(), v.data(), out.data(), B, Sq, Sk, H, KV,
                                  hd, causal, window, scale, nullptr);
}

int main(int argc, char** argv) {
  if (argc != 12) return 2;
  const char* dir = argv[1];
  const int kind = atoi(argv[2]), B = atoi(argv[3]), Sq = atoi(argv[4]);
  const int Sk = atoi(argv[5]), H = atoi(argv[6]), KV = atoi(argv[7]);
  const int hd = atoi(argv[8]), causal = atoi(argv[9]), window = atoi(argv[10]);
  const float scale = static_cast<float>(atof(argv[11]));
  const size_t nq = static_cast<size_t>(B) * Sq * H * hd;
  const size_t nk = static_cast<size_t>(B) * Sk * KV * hd;
  auto q = read(dir, "q", nq), k = read(dir, "k", nk), v = read(dir, "v", nk);
  std::vector<float> out(nq, -7.f);
  if (kind == 1 || kind == 2) {
    const int err = (kind == 1 ? run_bf16 : run_tf32)(q, k, v, out, B, Sq, Sk, H, KV, hd,
                                                      causal, window, scale);
    if (err != 0) {
      fprintf(stderr, "the launcher of kind %d returned %d\n", kind, err);
      return 3;
    }
  } else {
    run_fp32(q, k, v, out, B, Sq, Sk, H, KV, hd, causal, window, scale);
  }
  char path[512];
  snprintf(path, sizeof path, "%s/out.bin", dir);
  FILE* f = fopen(path, "wb");
  fwrite(out.data(), sizeof(float), nq, f);
  fclose(f);
  return 0;
}
