// Pieces shared by the flash attention kernels (flash_fwd.cu, flash_bwd.cu):
// the positional dropout hash, the bias's leading-index projection, warp
// reductions, bf16 packing, and the mma.sync building blocks of K5's bf16
// body (ldmatrix, mma.sync m16n8k16, 64-row tile staging).  The Hopper
// bodies' pieces are in flash_sm90.cuh.
//
// Fragment layouts of mma.sync.m16n8k16.row.col (g = lane >> 2, c = lane & 3):
//   A 16x16:  a0 (row g, cols 2c..2c+1), a1 (row g+8, same cols),
//             a2 (row g, cols 2c+8..2c+9), a3 (row g+8, same cols);
//   B 16x8:   b0 (k 2c..2c+1, col g), b1 (k 2c+8..2c+9, col g);
//   C 16x8:   c0, c1 (row g, cols 2c, 2c+1), c2, c3 (row g+8, same cols).
// wgmma's accumulator and register-A layouts repeat these per warp
// (hopper.cuh), so an accumulator pair over 16 columns re-packs in
// registers as the A operand of a product over those 16 columns.

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// tile edge of the bf16 kernels (rows and keys alike) and their threads
constexpr int kTile16 = 64, kThreads = 128;

// rows [r0, r0 + 64) of a [t, D] bf16 head (row stride st elements) into
// sm[64][D + 8] (rows padded by 8: conflict-free ldmatrix), rows past t
// zero-filled; 16-byte loads
template <int D>
__device__ __forceinline__ void stage_rows_bf16(__nv_bfloat16* sm,
                                                const __nv_bfloat16* g,
                                                int r0, int t, long long st) {
  constexpr int LD = D + 8, CH = D / 8;
  for (int c = threadIdx.x; c < kTile16 * CH; c += kThreads) {
    const int r = c / CH, dc = (c % CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < t)
      val = *reinterpret_cast<const uint4*>(g + (r0 + r) * st + dc);
    *reinterpret_cast<uint4*>(sm + r * LD + dc) = val;
  }
}

// the A fragment of rows [row, row + 16) x cols [col, col + 16) of a staged
// [rows][D + 8] bf16 tile
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* sm, int row,
                                       int col) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(a, sm + (row + (lane & 15)) * (D + 8) + col + (lane >> 4) * 8);
}

// B = X^T for X staged as [n][k] rows: fragments of n rows [n0, n0 + 16),
// k cols [k0, k0 + 16); b[0], b[1] for n0..n0+7, b[2], b[3] for n0+8..
template <int D>
__device__ __forceinline__ void load_bt(uint32_t (&b)[4],
                                        const __nv_bfloat16* sm, int n0,
                                        int k0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(b, sm + (n0 + (lane & 7) + (lane >> 4) * 8) * (D + 8) + k0 +
                     ((lane >> 3) & 1) * 8);
}

}  // namespace flash
