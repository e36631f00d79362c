// Paged decode attention for Hopper (sm_90a): one new token per lane
// attends over its paged KV cache plus itself.
//
// Replaces the TPU kernel `_kernel` / `paged_decode_pallas` in
// analytics_zoo_tpu/ops/pallas/paged_attention.py (pallas_call at :223),
// and computes what it computes: q_len=1 attention over the lane's
// block table, an online softmax seeded with the new token's
// self-score (m = s_self, l = 1, o = new_v), positions at or past
// ctx_len masked, int8 pools dequantized on read by scaling score
// columns with k_scale and probability columns with v_scale, f32 out.
//
// Bound: memory.  The work reads each lane's ctx_len cached tokens
// once, K and V: sum over lanes of ctx_len * h * d * 2 * itemsize
// bytes (+ 8 B of scales per token for int8), against a few FLOPs per
// byte, so its least time is those bytes over 3.35 TB/s.
//
// Design (simple first):
//   * one thread block per (head, lane), four warps;
//   * the block reads its own block-table row and ctx_len from device
//     memory (no scalar prefetch on a GPU) and loops only over tokens
//     below ctx_len: unlike the TPU grid, masked blocks are not even
//     loaded;
//   * warp w takes tokens w, w+4, ...; its 32 threads hold d/32
//     elements of q, of the running output and of each K/V row, so one
//     token's row is one contiguous d * itemsize read (256 B at d=64
//     f32) and its score one warp-shuffle reduction;
//   * each warp keeps its own online-softmax state (m, l, o) in f32
//     registers; warp 0 is seeded with the self-score, the others with
//     m = NEG_INF, l = 0, o = 0, and the four states are merged through
//     shared memory at the end.  A lane with ctx_len = 0 returns
//     exactly new_v.
// Pool rows of one head are strided by h * d, so coalescing is per
// token.  Later work: several heads per block, cp.async/TMA staging of
// whole pool blocks, and a split over blocks for long contexts (at 8
// lanes * 12 heads this grid fills 96 of the card's 132 SMs).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr float kNegInf = -1e30f;   // as the TPU kernel's NEG_INF

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__device__ __forceinline__ float load_f32(const T* p) {
  return static_cast<float>(*p);
}

// EPL: elements of a head row per thread (head_dim = 32 * EPL).
// PoolT: float (f32 pool) or int8_t (int8 pool with per-slot scales).
template <int EPL, typename PoolT, bool kQuant>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const float* __restrict__ q,
                    const float* __restrict__ new_k,
                    const float* __restrict__ new_v,
                    const PoolT* __restrict__ k_pool,
                    const PoolT* __restrict__ v_pool,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int32_t* __restrict__ tables,
                    const int32_t* __restrict__ ctx_len,
                    float* __restrict__ out,
                    int n_head, int block_size, int max_blocks,
                    float scale) {
  constexpr int D = 32 * EPL;
  __shared__ float sm_m[kWarps];
  __shared__ float sm_l[kWarps];
  __shared__ float sm_o[kWarps][D];

  const int head = blockIdx.x;
  const int s = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int tid = threadIdx.x % 32;
  const long long lane_off =
      ((long long)s * n_head + head) * D + (long long)tid * EPL;

  float qv[EPL], o[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) qv[e] = q[lane_off + e];

  float m, l;
  if (warp == 0) {
    // the new token always attends to itself: seed with its score
    float part = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) part += qv[e] * new_k[lane_off + e];
    m = warp_sum(part) * scale;
    l = 1.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) o[e] = new_v[lane_off + e];
  } else {
    m = kNegInf;
    l = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) o[e] = 0.f;
  }

  int n = ctx_len[s];
  n = min(max(n, 0), max_blocks * block_size);
  const int32_t* table = tables + (long long)s * max_blocks;

  for (int j = warp; j < n; j += kWarps) {
    const long long slot =
        (long long)table[j / block_size] * block_size + j % block_size;
    const long long off = (slot * n_head + head) * D + (long long)tid * EPL;
    float part = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) part += qv[e] * load_f32(k_pool + off + e);
    float sc = warp_sum(part) * scale;
    if (kQuant) sc *= k_scale[slot];   // dequant folded into the score
    const float m_new = fmaxf(m, sc);
    const float alpha = expf(m - m_new);
    float p = expf(sc - m_new);
    l = l * alpha + p;
    if (kQuant) p *= v_scale[slot];    // ... and into the probability
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      o[e] = o[e] * alpha + p * load_f32(v_pool + off + e);
    m = m_new;
  }

  if (tid == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int e = 0; e < EPL; ++e) sm_o[warp][tid * EPL + e] = o[e];
  __syncthreads();

  if (warp == 0) {
    float mx = sm_m[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w]);
    float den = 0.f;
    float acc[EPL];
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[e] = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float a = expf(sm_m[w] - mx);
      den += sm_l[w] * a;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[e] += sm_o[w][tid * EPL + e] * a;
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) out[lane_off + e] = acc[e] / den;
  }
}

template <int EPL>
void launch(const void* q, const void* nk, const void* nv, const void* kp,
            const void* vp, const void* ks, const void* vs,
            const void* tables, const void* ctx_len, void* out, int S,
            int H, int BS, int MB, int quantized, float scale,
            cudaStream_t stream) {
  const dim3 grid(H, S);
  const dim3 block(kWarps * 32);
  if (quantized) {
    paged_decode_kernel<EPL, int8_t, true><<<grid, block, 0, stream>>>(
        (const float*)q, (const float*)nk, (const float*)nv,
        (const int8_t*)kp, (const int8_t*)vp, (const float*)ks,
        (const float*)vs, (const int32_t*)tables, (const int32_t*)ctx_len,
        (float*)out, H, BS, MB, scale);
  } else {
    paged_decode_kernel<EPL, float, false><<<grid, block, 0, stream>>>(
        (const float*)q, (const float*)nk, (const float*)nv,
        (const float*)kp, (const float*)vp, nullptr, nullptr,
        (const int32_t*)tables, (const int32_t*)ctx_len, (float*)out, H,
        BS, MB, scale);
  }
}

}  // namespace

// q, new_k, new_v, out: [S, H, D] f32; k_pool, v_pool: [NB, BS, H, D]
// f32 (quantized = 0) or int8 (quantized = 1, with k_scale, v_scale
// [NB, BS] f32); tables: [S, MB] int32; ctx_len: [S] int32.
// D must be 32, 64, 128 or 256.  Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for an unsupported D).
extern "C" int paged_decode(const void* q, const void* new_k,
                            const void* new_v, const void* k_pool,
                            const void* v_pool, const void* k_scale,
                            const void* v_scale, const void* tables,
                            const void* ctx_len, void* out, int S, int H,
                            int D, int BS, int MB, int quantized,
                            float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S <= 0 || H <= 0) return 0;
  switch (D) {
    case 32:
      launch<1>(q, new_k, new_v, k_pool, v_pool, k_scale, v_scale, tables,
                ctx_len, out, S, H, BS, MB, quantized, scale, st);
      break;
    case 64:
      launch<2>(q, new_k, new_v, k_pool, v_pool, k_scale, v_scale, tables,
                ctx_len, out, S, H, BS, MB, quantized, scale, st);
      break;
    case 128:
      launch<4>(q, new_k, new_v, k_pool, v_pool, k_scale, v_scale, tables,
                ctx_len, out, S, H, BS, MB, quantized, scale, st);
      break;
    case 256:
      launch<8>(q, new_k, new_v, k_pool, v_pool, k_scale, v_scale, tables,
                ctx_len, out, S, H, BS, MB, quantized, scale, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
