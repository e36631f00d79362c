// Flash attention forward for Hopper (sm_90a): online-softmax attention
// that never writes the [t, t] score matrix to device memory.
//
// Replaces the TPU kernel `_fwd_kernel` / `_flash_fwd` in
// analytics_zoo_tpu/ops/pallas/flash_attention.py (pallas_call at :444)
// and computes everything that kernel computes: scores q.k * 1/sqrt(d)
// in f32, plus an additive f32 bias whose leading index follows the
// bias's broadcast over batch and heads (`_bias_spec` :384-405), a
// [b, t] key-validity mask, causal masking (key tiles past the diagonal
// are skipped, :316), masked scores at -1e30 with their probabilities
// zeroed, the running max / denominator / output of the online softmax,
// attention dropout from the positional hash (`_hash_bits` :238,
// `drop_keep_mask` :262: int32 arithmetic that wraps, `>>` arithmetic)
// applied after the denominator is summed, the denominator clipped at
// 1e-20 (a fully masked row gives zeros), and the pre-dropout logsumexp.
//
// Layouts: q, k, v are [b, t, h, d] views sharing the strides (sb, sh,
// st) in elements with unit stride in d, so the three thirds of a fused
// qkv projection are read in place; out is [b, t, h, d] contiguous; lse
// is [b*h, t] f32; kv_mask [b, t] int32; bias [lead, t, t] f32; seed3
// int32 [3] = (seed, q offset, k offset) of the dropout hash.  Any t.
//
// Bound.  At b = 32, h = 12, t = 512, d = 64 in bf16 the two products
// are 4 * b*h * t*t * d = 25.8 GFLOP with every key valid, about 26 us
// at 989 TFLOP/s, against about 30 us for the 101 MB of q, k, v and out
// (25 MB each) at 3.35 TB/s: the two bounds are close, and a kv_mask
// that skips padded keys leaves the bytes as the larger one.
//
// Design (simple first):
//   * one block per (b*h, tile of query rows); a loop over key tiles in
//     the block takes the place of the TPU's sequential k grid axis;
//   * bf16: 64 query rows, 4 warps of 16 rows; q fragments stay in
//     registers for the whole loop; each 64-key tile of K and V is staged
//     in shared memory (rows padded by 8: conflict-free ldmatrix);
//     S = Q K^T and O += P V on mma.sync.m16n8k16 with f32 accumulation;
//     the S accumulator is re-packed in registers as the bf16 A operand
//     of P V (the FlashAttention-2 layout trick), so P never leaves the
//     registers; running max, denominator and output stay in registers;
//   * f32: no TF32 (the TPU kernel takes Precision.HIGHEST for f32):
//     32 query rows, 4 warps of 8 rows, lanes over 32-key tiles for the
//     scores and over d for the output, FFMA throughout;
//   * head_dim 32, 64 or 128 (template); others are refused.

#include "flash_common.cuh"

namespace {

using flash::bias_lead;
using flash::drop_keep;
using flash::kNegInf;
using flash::ldmatrix_x4;
using flash::ldmatrix_x4_trans;
using flash::mma_bf16;
using flash::pack_bf16;
using flash::shfl_max;
using flash::shfl_sum;
using flash::stage_rows_bf16;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* kv_mask;
  const float* bias;
  const int32_t* seed3;
  void* out;
  float* lse;
  int b, h, t;
  long long sb, sh, st;
  int causal, bias_mode, dropout, drop_threshold;
  float drop_scale, scale;
};

// bias_mode: 0 none, 1 [b*h, t, t], 2 [h, t, t], 3 [b, t, t], 4 [1, t, t]
__device__ __forceinline__ const float* bias_plane(const Params& p, int bh) {
  if (p.bias_mode == 0) return nullptr;
  return p.bias +
         static_cast<long long>(bias_lead(p.bias_mode, bh, p.h)) * p.t * p.t;
}

// ---------------------------------------------------------------- bf16

constexpr int kBQ16 = flash::kTile16, kBK16 = flash::kTile16;

template <int D>
constexpr int smem_bf16() {
  return 3 * kBQ16 * (D + 8) * 2;
}

template <int D>
__global__ void __launch_bounds__(128) flash_fwd_bf16(Params p) {
  constexpr int LD = D + 8, KD = D / 16, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kBQ16 * LD;
  __nv_bfloat16* vs = ks + kBK16 * LD;
  __shared__ int kvalid[kBK16];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bh = blockIdx.y, bi = bh / p.h, hi = bh % p.h;
  const int q0 = blockIdx.x * kBQ16;
  const long long head = bi * p.sb + hi * p.sh;
  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) + head;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + head;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + head;

  stage_rows_bf16<D>(qs, qg, q0, p.t, p.st);
  __syncthreads();
  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
    ldmatrix_x4(qf[kk], qs + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                            (lane >> 4) * 8);

  float o[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  const int row0 = q0 + warp * 16 + (lane >> 2);   // and row0 + 8

  int n_kv = (p.t + kBK16 - 1) / kBK16;
  if (p.causal) n_kv = min(n_kv, (q0 + kBQ16 - 1) / kBK16 + 1);
  int32_t seed = 0, q_off = 0, k_off = 0;
  if (p.dropout) {
    seed = p.seed3[0];
    q_off = p.seed3[1];
    k_off = p.seed3[2];
  }
  const float* bplane = bias_plane(p, bh);

  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kBK16;
    __syncthreads();   // the previous tile is no longer read
    stage_rows_bf16<D>(ks, kg, k0, p.t, p.st);
    stage_rows_bf16<D>(vs, vg, k0, p.t, p.st);
    if (threadIdx.x < kBK16) {
      const int col = k0 + threadIdx.x;
      kvalid[threadIdx.x] =
          col < p.t &&
          (p.kv_mask == nullptr ||
           p.kv_mask[static_cast<long long>(bi) * p.t + col] != 0);
    }
    __syncthreads();

    // S = Q K^T: 8 tiles of 16 x 8 per warp
    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t kf[4];
        ldmatrix_x4(kf, ks + (jp * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                            kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * jp], qf[kk], kf[0], kf[1]);
        mma_bf16(s[2 * jp + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // scale, bias, masks; this thread's elements: rows row0 (e < 2) and
    // row0 + 8 (e >= 2), cols nt * 8 + (lane & 3) * 2 + (e & 1)
    uint32_t keep = 0;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1, row = row0 + hh * 8;
        const int cl = nt * 8 + (lane & 3) * 2 + (e & 1), col = k0 + cl;
        float x = s[nt][e] * p.scale;
        if (bplane != nullptr && row < p.t && col < p.t)
          x += bplane[static_cast<long long>(row) * p.t + col];
        const bool kp = kvalid[cl] && (!p.causal || col <= row);
        if (kp) keep |= 1u << (nt * 4 + e);
        x = kp ? x : kNegInf;
        s[nt][e] = x;
        mx[hh] = fmaxf(mx[hh], x);
      }
    }
    float m_new[2], alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      m_new[hh] = fmaxf(m_r[hh], shfl_max(mx[hh], 2));
      alpha[hh] = expf(m_r[hh] - m_new[hh]);
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1;
        float pv = (keep >> (nt * 4 + e)) & 1u ? expf(s[nt][e] - m_new[hh])
                                               : 0.f;
        rs[hh] += pv;   // the denominator sums undropped probabilities
        if (p.dropout) {
          const int row = row0 + hh * 8;
          const int col = k0 + nt * 8 + (lane & 3) * 2 + (e & 1);
          pv = drop_keep(seed, bh, q_off + row, k_off + col,
                         p.drop_threshold)
                   ? pv * p.drop_scale
                   : 0.f;
        }
        s[nt][e] = pv;
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l_r[hh] = l_r[hh] * alpha[hh] + shfl_sum(rs[hh], 2);
      m_r[hh] = m_new[hh];
    }
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      o[i][0] *= alpha[0];
      o[i][1] *= alpha[0];
      o[i][2] *= alpha[1];
      o[i][3] *= alpha[1];
    }

    // O += P V: P's accumulator layout is the A operand's, cast to bf16
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < KD; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(
            vf, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                    dp * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dp], a, vf[0], vf[1]);
        mma_bf16(o[2 * dp + 1], a, vf[2], vf[3]);
      }
    }
  }

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + hh * 8;
    if (row >= p.t) continue;
    const float l = fmaxf(l_r[hh], 1e-20f);
    __nv_bfloat16* orow =
        out + ((static_cast<long long>(bi) * p.t + row) * p.h + hi) * D;
#pragma unroll
    for (int i = 0; i < ND; ++i)
      *reinterpret_cast<__nv_bfloat162*>(orow + i * 8 + (lane & 3) * 2) =
          __floats2bfloat162_rn(o[i][hh * 2] / l, o[i][hh * 2 + 1] / l);
    if ((lane & 3) == 0)
      p.lse[static_cast<long long>(bh) * p.t + row] = m_r[hh] + logf(l);
  }
}

// ---------------------------------------------------------------- f32

constexpr int kBQ32 = 32, kBK32 = 32;

template <int D>
constexpr int smem_f32() {
  return (kBQ32 * D + kBK32 * (D + 1) + kBK32 * D + kBQ32 * kBK32) * 4;
}

template <int D>
__global__ void __launch_bounds__(128) flash_fwd_f32(Params p) {
  constexpr int E = D / 32;
  extern __shared__ float fsm[];
  float* qs = fsm;                      // [32][D]
  float* ks = qs + kBQ32 * D;           // [32][D + 1]: lane-indexed rows
  float* vs = ks + kBK32 * (D + 1);     // [32][D]
  float* ps = vs + kBK32 * D;           // [32][32]: warp w owns rows 8w..
  __shared__ int kvalid[kBK32];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bh = blockIdx.y, bi = bh / p.h, hi = bh % p.h;
  const int q0 = blockIdx.x * kBQ32;
  const long long head = bi * p.sb + hi * p.sh;
  const float* qg = static_cast<const float*>(p.q) + head;
  const float* kg = static_cast<const float*>(p.k) + head;
  const float* vg = static_cast<const float*>(p.v) + head;

  for (int i = threadIdx.x; i < kBQ32 * D; i += 128) {
    const int r = i / D, dd = i % D;
    qs[i] = q0 + r < p.t ? qg[(q0 + r) * p.st + dd] : 0.f;
  }

  float o[8][E];
  float m_r[8], l_r[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m_r[i] = kNegInf;
    l_r[i] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) o[i][e] = 0.f;
  }
  int n_kv = (p.t + kBK32 - 1) / kBK32;
  if (p.causal) n_kv = min(n_kv, (q0 + kBQ32 - 1) / kBK32 + 1);
  int32_t seed = 0, q_off = 0, k_off = 0;
  if (p.dropout) {
    seed = p.seed3[0];
    q_off = p.seed3[1];
    k_off = p.seed3[2];
  }
  const float* bplane = bias_plane(p, bh);

  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kBK32;
    __syncthreads();
    for (int i = threadIdx.x; i < kBK32 * D; i += 128) {
      const int r = i / D, dd = i % D;
      const bool in = k0 + r < p.t;
      ks[r * (D + 1) + dd] = in ? kg[(k0 + r) * p.st + dd] : 0.f;
      vs[i] = in ? vg[(k0 + r) * p.st + dd] : 0.f;
    }
    if (threadIdx.x < kBK32) {
      const int col = k0 + threadIdx.x;
      kvalid[threadIdx.x] =
          col < p.t &&
          (p.kv_mask == nullptr ||
           p.kv_mask[static_cast<long long>(bi) * p.t + col] != 0);
    }
    __syncthreads();

    // lane = key column; the warp's 8 rows
    float sc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) sc[i] = 0.f;
    for (int dd = 0; dd < D; ++dd) {
      const float kv = ks[lane * (D + 1) + dd];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        sc[i] = fmaf(qs[(warp * 8 + i) * D + dd], kv, sc[i]);
    }
    const int col = k0 + lane;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = q0 + warp * 8 + i;
      float x = sc[i] * p.scale;
      if (bplane != nullptr && row < p.t && col < p.t)
        x += bplane[static_cast<long long>(row) * p.t + col];
      const bool kp = kvalid[lane] && (!p.causal || col <= row);
      x = kp ? x : kNegInf;
      const float m_new = fmaxf(m_r[i], shfl_max(x, 16));
      const float alpha = expf(m_r[i] - m_new);
      float pv = kp ? expf(x - m_new) : 0.f;
      l_r[i] = l_r[i] * alpha + shfl_sum(pv, 16);
      m_r[i] = m_new;
      if (p.dropout)
        pv = drop_keep(seed, bh, q_off + row, k_off + col, p.drop_threshold)
                 ? pv * p.drop_scale
                 : 0.f;
      ps[(warp * 8 + i) * kBK32 + lane] = pv;
#pragma unroll
      for (int e = 0; e < E; ++e) o[i][e] *= alpha;
    }
    __syncwarp();
    // lane = output columns lane + 32 e
    for (int c = 0; c < kBK32; ++c) {
      float vv[E];
#pragma unroll
      for (int e = 0; e < E; ++e) vv[e] = vs[c * D + lane + 32 * e];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float pc = ps[(warp * 8 + i) * kBK32 + c];
#pragma unroll
        for (int e = 0; e < E; ++e) o[i][e] = fmaf(pc, vv[e], o[i][e]);
      }
    }
  }

  float* out = static_cast<float*>(p.out);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = q0 + warp * 8 + i;
    if (row >= p.t) continue;
    const float l = fmaxf(l_r[i], 1e-20f);
    float* orow = out + ((static_cast<long long>(bi) * p.t + row) * p.h + hi) * D;
#pragma unroll
    for (int e = 0; e < E; ++e) orow[lane + 32 * e] = o[i][e] / l;
    if (lane == 0)
      p.lse[static_cast<long long>(bh) * p.t + row] = m_r[i] + logf(l);
  }
}

template <int D>
int launch(const Params& p, int dtype, cudaStream_t st) {
  const int bh = p.b * p.h;
  if (dtype == 1) {
    const int smem = smem_bf16<D>();
    cudaFuncSetAttribute(flash_fwd_bf16<D>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    const dim3 grid((p.t + kBQ16 - 1) / kBQ16, bh);
    flash_fwd_bf16<D><<<grid, 128, smem, st>>>(p);
  } else {
    const int smem = smem_f32<D>();
    cudaFuncSetAttribute(flash_fwd_f32<D>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    const dim3 grid((p.t + kBQ32 - 1) / kBQ32, bh);
    flash_fwd_f32<D><<<grid, 128, smem, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// See the layouts above.  dtype: 0 = f32, 1 = bf16 (q, k, v and out);
// kv_mask, bias and seed3 may be null (bias_mode 0, dropout 0).
// Returns cudaGetLastError() after the launch; cudaErrorInvalidValue for
// a head_dim other than 32, 64 or 128, another dtype, or b*h > 65535.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const void* kv_mask, const void* bias,
                         const void* seed3, void* out, void* lse, int B,
                         int H, int T, int D, long long sb, long long sh,
                         long long st, int dtype, int causal, int bias_mode,
                         int dropout, int drop_threshold, float drop_scale,
                         float scale, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0) return 0;
  if ((dtype != 0 && dtype != 1) || static_cast<long long>(B) * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.kv_mask = static_cast<const int32_t*>(kv_mask);
  p.bias = static_cast<const float*>(bias);
  p.seed3 = static_cast<const int32_t*>(seed3);
  p.out = out;
  p.lse = static_cast<float*>(lse);
  p.b = B;
  p.h = H;
  p.t = T;
  p.sb = sb;
  p.sh = sh;
  p.st = st;
  p.causal = causal;
  p.bias_mode = bias_mode;
  p.dropout = dropout;
  p.drop_threshold = drop_threshold;
  p.drop_scale = drop_scale;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<32>(p, dtype, s);
    case 64: return launch<64>(p, dtype, s);
    case 128: return launch<128>(p, dtype, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
