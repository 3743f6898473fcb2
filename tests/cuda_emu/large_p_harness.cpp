// Builds src/repro_torch/kernels/csrc/large_p.cu into a shared library for
// the CPU, through cuda_runtime.h here: its C launchers (large_gram,
// large_apply, ...) keep their signatures, and their cudaLaunchKernel runs
// the kernels registered below, block after block, each at its launch's
// thread count (256, or 384 for the tensor-core kernels, whose TMA loads,
// mbarriers and wgmma run through hopper.cuh here).
// The tests load it with ctypes and hand it to repro_torch.kernels.large_p
// as a Runner, so the wrappers' phases run on CPU tensors end to end.
//
//   g++ -std=c++20 -O1 -pthread -shared -fPIC -Itests/cuda_emu \
//       -Isrc/repro_torch/kernels/csrc -o liblarge_p_emu.so large_p_harness.cpp
#include <cuda_runtime.h>
#include <hopper.cuh>

namespace {
// The kernels' `extern __shared__` arrays (one block runs at a time).
float4 large_gram_sm[232448 / 16];
float4 large_apply_sm[232448 / 16];
alignas(1024) unsigned char large_tc_smem[232448];
}  // namespace

#include "large_p.cu"

namespace {

template <typename Args, void (*kKernel)(Args)>
void enroll() {
  g_emu_kernels[reinterpret_cast<const void*>(kKernel)] = [](void** a) {
    kKernel(*static_cast<Args*>(a[0]));
  };
}

const bool g_enrolled = [] {
  g_smem_base = large_tc_smem;  // the tensor-core kernels' (smem_align1024)
  g_smem_size = sizeof large_tc_smem;
  enroll<GramArgs, gram_kernel<true>>();
  enroll<GramArgs, gram_kernel<false>>();
  enroll<ReduceArgs, gram_reduce_kernel>();
  enroll<ApplyArgs, apply_kernel<kLeap>>();
  enroll<ApplyArgs, apply_kernel<kLand>>();
  enroll<ApplyArgs, apply_kernel<kLandStep>>();
  enroll<ApplyArgs, apply_kernel<kField>>();
  enroll<ApplyArgs, apply_kernel<kNs>>();
  enroll<GramTcArgs, gram_tc_kernel<true>>();
  enroll<GramTcArgs, gram_tc_kernel<false>>();
  enroll<ReduceTcArgs, gram_reduce_tc_kernel>();
  enroll<BaseArgs, base_stage_kernel>();
  enroll<ApplyTcArgs, apply_tc_kernel<true>>();
  enroll<ApplyTcArgs, apply_tc_kernel<false>>();
  return true;
}();

}  // namespace
