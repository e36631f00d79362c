// Pieces shared by the flash attention kernels (flash_fwd.cu, flash_bwd.cu):
// the positional dropout hash, the bias's leading-index projection, warp
// reductions and bf16 packing.  The Hopper bodies' pieces are in
// flash_sm90.cuh.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr float kNegInf = -1e30f;   // as the TPU kernels' NEG_INF

// the positional hash of `_hash_bits` (flash_attention.py:238):
// multiplies wrap as uint32, shifts are arithmetic as on int32; true where
// a probability is kept under dropout (`drop_keep_mask` :262)
__device__ __forceinline__ bool drop_keep(int32_t seed, int32_t bh, int32_t qp,
                                          int32_t kp, int32_t threshold) {
  const uint32_t u = static_cast<uint32_t>(seed) +
                     static_cast<uint32_t>(bh) * 0x27D4EB2Fu +
                     static_cast<uint32_t>(qp) * 0x9E3779B9u +
                     static_cast<uint32_t>(kp) * 0x2545F491u;
  int32_t x = static_cast<int32_t>(u);
  x ^= x >> 15;
  x = static_cast<int32_t>(static_cast<uint32_t>(x) * 0x2C1B3C6Du);
  x ^= x >> 12;
  x = static_cast<int32_t>(static_cast<uint32_t>(x) * 0x297A2D39u);
  x ^= x >> 15;
  return (x & 0x7FFFFFFF) >= threshold;
}

// the positional hash's seed and offsets from a kernel's params (their
// `dropout` flag and `seed3`); zeros without dropout
struct Seeds {
  int32_t seed = 0, q_off = 0, k_off = 0;
  template <class Params>
  __device__ explicit Seeds(const Params& p) {
    if (p.dropout) {
      seed = p.seed3[0];
      q_off = p.seed3[1];
      k_off = p.seed3[2];
    }
  }
};

// which plane of the collapsed [lead, t, t] bias the grid's bh = batch * h +
// head reads (`_bias_spec` :384-405).  bias_mode: 1 [b*h], 2 [h], 3 [b],
// 4 [1] (0, no bias, never asks)
__device__ __forceinline__ int bias_lead(int bias_mode, int bh, int h) {
  return bias_mode == 1 ? bh : bias_mode == 2 ? bh % h
                           : bias_mode == 3 ? bh / h
                                            : 0;
}

__device__ __forceinline__ float shfl_max(float v, int width_mask) {
  for (int off = 1; off <= width_mask; off <<= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float shfl_sum(float v, int width_mask) {
  for (int off = 1; off <= width_mask; off <<= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// threads of the f32 bodies' blocks
constexpr int kThreads = 128;

}  // namespace flash
