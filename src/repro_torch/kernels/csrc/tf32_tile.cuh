// The 64 x 64 fp32 tiles of the port's 3xTF32 tensor-core kernels
// (fused_step_tc.cu, newton_schulz_tc.cu): their 128-byte swizzled layout
// and wgmma descriptors, the accumulator layout of an m64n64 product, and
// the TF32 hi / lo splits (hopper.cuh has the PTX underneath).

#pragma once

#include "hopper.cuh"

namespace {

constexpr int kTcP = 64;                          // rows of a tile: p <= 64
constexpr int kTcBoxBytes = kTcP * 128;           // 64 rows x 32 fp32 columns
constexpr int kTcTileBytes = 2 * kTcBoxBytes;     // a 64-column chunk of one operand
constexpr int kTcChunk = 64;

// Byte offset of element (row, col) of a 64 x 64 fp32 tile: two 64 x 32
// boxes, 128-byte swizzled, as TMA writes them and the descriptors read.
__host__ __device__ inline int tc_off(int row, int col) {
  return (col >> 5) * kTcBoxBytes + row * 128 + ((((col & 31) >> 2) ^ (row & 7)) << 4) +
         ((col & 3) << 2);
}

__device__ inline float& tc_at(unsigned char* tile, int row, int col) {
  return *reinterpret_cast<float*>(tile + tc_off(row, col));
}

// Descriptor of k8 step kk (K = 64, kk < 8) of a K-major tile.
__device__ inline uint64_t tc_desc(const unsigned char* tile, int kk) {
  return hopper::sw128_desc(tile + (kk >> 2) * kTcBoxBytes + (kk & 3) * 32, 16, 1024);
}

// Row and column of accumulator element i of consumer thread t.
__device__ inline int acc_row(int t, int i) { return 16 * (t >> 5) + ((t & 31) >> 2) + 8 * ((i >> 1) & 1); }
__device__ inline int acc_col(int t, int i) { return 8 * (i >> 2) + 2 * (t & 3) + (i & 1); }

// v rounded to TF32 (to nearest, ties away from zero, as cvt.rna.tf32.f32
// rounds) by integer operations, which issue at full rate; the low 13 bits
// of the result are zero. A NaN stays NaN or, for payloads at the top of
// the range, becomes a zero whose lo piece is the NaN.
__device__ inline float tf32_round(float v) {
  return __uint_as_float((__float_as_uint(v) + 0x1000u) & 0xFFFFE000u);
}

__device__ inline void split(float v, float& hi, float& lo) {
  hi = tf32_round(v);
  lo = tf32_round(v - hi);
}

// lo of v when the tensor cores read v itself as hi (its low 13 bits dropped).
__device__ inline float trunc_lo(float v) {
  return tf32_round(v - __uint_as_float(__float_as_uint(v) & 0xFFFFE000u));
}

// v with its low 13 bits dropped: v as the tensor cores read it.
__device__ inline float tf32_trunc(float v) { return __uint_as_float(__float_as_uint(v) & 0xFFFFE000u); }

}  // namespace
