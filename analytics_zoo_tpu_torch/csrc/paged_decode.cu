// Paged decode attention for Hopper (sm_90a): one new token per lane
// attends over its paged KV cache plus itself.
//
// Replaces the TPU kernel `_kernel` / `paged_decode_pallas` in
// analytics_zoo_tpu/ops/pallas/paged_attention.py (pallas_call at :223),
// and computes what it computes: q_len=1 attention over the lane's
// block table, an online softmax seeded with the new token's
// self-score (m = s_self, l = 1, o = new_v), positions at or past
// ctx_len masked, the pool read in its own dtype (f32, f16, bf16, or
// int8 dequantized on read by scaling score columns with k_scale and
// probability columns with v_scale) and computed in f32, f32 out.
//
// Bound: memory.  The work reads each lane's ctx_len cached tokens
// once, K and V: sum over lanes of ctx_len * h * d * 2 * itemsize
// bytes (+ 8 B of scales per token for int8), against a few FLOPs per
// byte, so its least time is those bytes over 3.35 TB/s: a few
// microseconds for a decode step, so latency and the spread of the
// work over the card set the time.
//
// Design (body `split`, flash-decoding):
//   * the grid is (lanes, chunks of the block table), chunk-major; a
//     chunk is a fixed number of pool blocks, chosen on the host from the
//     lanes and the table's length alone so that the grid fills the card
//     (the host never reads ctx_len: a decode step does not sync).  A
//     chunk at or past its lane's ctx_len exits at once (chunk 0 always
//     runs);
//   * one block holds all heads: warp w is head w (h <= 32), its q in
//     registers (built for at most 512 threads, 128 registers a thread,
//     where h <= 16, else 1024 threads at 64).  A chunk's pool blocks are read in units of whole
//     tokens of one pool block (all heads: one contiguous run of
//     tokens * h * d * itemsize bytes, about 48 KB of K and V), each
//     moved by two plain bulk copies (cp.async.bulk, no tensor map)
//     into a 3-stage ring on mbarriers, issued by one thread a stage
//     ahead; the chunk's table entries and int8 scales are read into
//     shared memory first;
//   * a warp's 32 threads split into groups of lanes over one token's
//     head row (16 bytes a lane: 4 f32, 8 f16/bf16 or 16 int8 values),
//     so a pass scores 32 * 16 / (d * itemsize) tokens at once with a
//     shuffle reduction inside each group, and 2-4 passes are scored
//     before one max and one rescale (their scores are independent); each
//     group keeps its own online-softmax state (m, l, o) in f32, merged
//     across groups at the chunk's end, and the chunk writes (m, l, o) per
//     head to a workspace;
//   * the last chunk of a lane to finish (a per-lane counter, reset by
//     the merge) merges: the self token (m = s_self, l = 1, o = new_v)
//     and the chunks' partials, each weighted by exp(m - the largest m),
//     summed in a fixed order (chunk order for o), so the result is
//     deterministic and a lane with ctx_len 0 returns exactly new_v (its
//     one chunk holds m = -1e30, l = 0, o = 0: weight 0).  One launch per
//     call.
// What is left is latency: a chain of round trips to device memory or L2
// (ctx_len and the table, the first bulk copies, the partial's write and
// fence, the merge's reads) that a launch pays even when every lane holds
// a few tokens; chip_smoke.py times it as `floor_ms` (every lane at 16
// tokens) beside the decode scene, and PERF.md keeps both.
// Body `rows` (the first design, for what a bulk copy cannot take: h >
// 32 or a pool base not 16-byte aligned): one block of 4 warps per
// (head, lane), warps over tokens, a warp-shuffle reduction per score.

#include <cuda_fp16.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;   // as the TPU kernel's NEG_INF
constexpr int kStages = 3;          // the split body's ring of units

struct Params {
  const float* q;
  const float* new_k;
  const float* new_v;
  const void* k_pool;
  const void* v_pool;
  const float* k_scale;
  const float* v_scale;
  const int32_t* tables;
  const int32_t* ctx_len;
  float* out;
  float* part;   // [S, n_chunks, h, d + 2]: o, then m and l
  int* counts;   // [S], zero between launches
  int h, bs, mb, chunk_blocks, n_chunks, unit;
  float scale;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// a pool's element type: E values in 16 bytes, read as f32
template <typename T>
struct Pool;

template <>
struct Pool<float> {
  static constexpr int E = 4;
  __device__ static void load16(const unsigned char* p, float (&x)[E]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  }
  __device__ static float one(const float* p) { return *p; }
};

template <>
struct Pool<__half> {
  static constexpr int E = 8;
  __device__ static void load16(const unsigned char* p, float (&x)[E]) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __half2* h2 = reinterpret_cast<const __half2*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __half22float2(h2[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
  __device__ static float one(const __half* p) { return __half2float(*p); }
};

template <>
struct Pool<__nv_bfloat16> {
  static constexpr int E = 8;
  __device__ static void load16(const unsigned char* p, float (&x)[E]) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(b2[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
  __device__ static float one(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
};

template <>
struct Pool<int8_t> {
  static constexpr int E = 16;
  __device__ static void load16(const unsigned char* p, float (&x)[E]) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        x[4 * i + k] = static_cast<float>(
            static_cast<int32_t>(w[i] << (24 - 8 * k)) >> 24);
  }
  __device__ static float one(const int8_t* p) {
    return static_cast<float>(*p);
  }
};

// ------------------------------------------------------------- split body

// kMaxThreads: 512 (h <= 16: 128 registers a thread) or 1024 (h <= 32: 64)
template <int D, typename PoolT, bool kQuant, int kMaxThreads>
__global__ void __launch_bounds__(kMaxThreads, 1)
paged_decode_split(const Params p) {
  using P = Pool<PoolT>;
  constexpr int E = P::E;
  constexpr int ROW = D * static_cast<int>(sizeof(PoolT));   // a head row
  constexpr int CPL = ROW > 512 ? ROW / 512 : 1;   // 16-byte chunks a lane
  constexpr int LPT = ROW / (16 * CPL);            // lanes a token
  constexpr int TPP = 32 / LPT;                    // tokens a pass
  constexpr int EPL = CPL * E;                     // row values a lane
  constexpr int PB = E >= 16 ? 2 : 4;              // passes scored at once
  extern __shared__ unsigned char smem_raw[];

  // chunk-major: every lane's chunk c is dispatched before chunk c + 1
  const int s = blockIdx.x, c = blockIdx.y;
  const int head = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane / LPT, li = lane % LPT;
  const int chunk = p.chunk_blocks * p.bs;
  const int tok_bytes = p.h * ROW;   // one token's K (or V), all heads
  const int unit_bytes = p.unit * tok_bytes;
  // [kStages][K unit, V unit], 128-byte aligned for the bulk copies
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * 2 * unit_bytes);
  int* tbl = reinterpret_cast<int*>(full + kStages);   // the chunk's blocks
  float* ksc = reinterpret_cast<float*>(tbl + p.chunk_blocks);   // int8
  float* vsc = ksc + chunk;
  int* last_s = reinterpret_cast<int*>(kQuant ? vsc + chunk : ksc);

  // the ring's barriers, by a thread of warp 1 (warp 0's thread 0 reads
  // ctx_len and the table meanwhile); visible after the __syncthreads
  if (threadIdx.x == (blockDim.x > 32 ? 32 : 0)) {
    for (int st = 0; st < kStages; ++st) hopper::mbar_init(&full[st], 1);
    hopper::fence_barrier_init();
  }
  // every read that needs no other is started at once: this warp's
  // head's q at the lane's row values, the merge's q, new_k and new_v
  // (lanes over d; only the merging block reads them, off its path),
  // ctx_len and the chunk's table entries
  const long long lane_row = (static_cast<long long>(s) * p.h + head) * D;
  constexpr int EPM = D / 32;
  const long long at = lane_row + lane * EPM;
  float qv[EPL], o[EPL], sq[EPM], sk[EPM], nv[EPM];
#pragma unroll
  for (int cc = 0; cc < CPL; ++cc)
#pragma unroll
    for (int e = 0; e < E; ++e) {
      qv[cc * E + e] = p.q[lane_row + (cc * LPT + li) * E + e];
      o[cc * E + e] = 0.f;
    }
#pragma unroll
  for (int e = 0; e < EPM; ++e) {
    sq[e] = p.q[at + e];
    sk[e] = p.new_k[at + e];
    nv[e] = p.new_v[at + e];
  }
  const int pb0 = c * p.chunk_blocks;
  const int ctx = p.ctx_len[s];
  for (int i = threadIdx.x; i < min(p.chunk_blocks, p.mb - pb0);
       i += blockDim.x)
    tbl[i] = p.tables[static_cast<long long>(s) * p.mb + pb0 + i];
  const int n = min(max(ctx, 0), p.mb * p.bs);
  const int live = max(1, (n + chunk - 1) / chunk);
  if (c >= live) return;   // past the lane's context: nothing to read
  const int t0 = c * chunk, t1 = min(n, t0 + chunk);
  const int n_pb = t1 > t0 ? (t1 - 1) / p.bs - pb0 + 1 : 0;
  const int upb = (p.bs + p.unit - 1) / p.unit;   // units a pool block
  const int n_units =
      t1 > t0 ? (n_pb - 1) * upb + (t1 - 1) % p.bs / p.unit + 1 : 0;
  __syncthreads();

  // unit u: tokens [off, off + cnt) of the chunk's pool block u / upb
  auto issue = [&](int u) {
    const int st = u % kStages, pbl = u / upb, off = u % upb * p.unit;
    const int cnt = min(min(p.unit, p.bs - off), t1 - (pb0 + pbl) * p.bs - off);
    const long long src =
        (static_cast<long long>(tbl[pbl]) * p.bs + off) * tok_bytes;
    const uint32_t bytes = static_cast<uint32_t>(cnt * tok_bytes);
    unsigned char* dst = ring + st * 2 * unit_bytes;
    hopper::mbar_arrive_expect_tx(&full[st], 2 * bytes);
    hopper::bulk_load(dst, static_cast<const unsigned char*>(p.k_pool) + src,
                      bytes, &full[st]);
    hopper::bulk_load(dst + unit_bytes,
                      static_cast<const unsigned char*>(p.v_pool) + src, bytes,
                      &full[st]);
  };
  if (threadIdx.x == 0)
    for (int u = 0; u < min(kStages, n_units); ++u) issue(u);
  if (kQuant) {
    for (int i = threadIdx.x; i < t1 - t0; i += blockDim.x) {
      const long long slot =
          static_cast<long long>(tbl[i / p.bs]) * p.bs + i % p.bs;
      ksc[i] = p.k_scale[slot];
      vsc[i] = p.v_scale[slot];
    }
    __syncthreads();
  }

  float self_dot = 0.f;
#pragma unroll
  for (int e = 0; e < EPM; ++e) self_dot = fmaf(sq[e], sk[e], self_dot);
  const float s_self = warp_sum(self_dot) * p.scale;
  float m = kNegInf, l = 0.f;

  for (int u = 0; u < n_units; ++u) {
    const int st = u % kStages, pbl = u / upb, off = u % upb * p.unit;
    const int j0 = (pb0 + pbl) * p.bs + off - t0;   // in the chunk
    const int cnt = min(min(p.unit, p.bs - off), t1 - t0 - j0);
    hopper::mbar_wait(&full[st], (u / kStages) & 1);
    const unsigned char* kt = ring + st * 2 * unit_bytes + head * ROW;
    const unsigned char* vt = kt + unit_bytes;
    // PB passes at a time: their scores are independent (no softmax
    // recurrence between them), then one max and one rescale
    for (int jj = 0; jj < cnt; jj += TPP * PB) {
      float sc[PB];
#pragma unroll
      for (int b = 0; b < PB; ++b) {
        const int j = jj + b * TPP + g;
        const unsigned char* krow = kt + (j < cnt ? j : 0) * tok_bytes;
        float dot = 0.f;
#pragma unroll
        for (int cc = 0; cc < CPL; ++cc) {
          float x[E];
          P::load16(krow + (cc * LPT + li) * 16, x);
#pragma unroll
          for (int e = 0; e < E; ++e) dot = fmaf(qv[cc * E + e], x[e], dot);
        }
        sc[b] = dot;
      }
#pragma unroll
      for (int sh = LPT / 2; sh > 0; sh >>= 1)
#pragma unroll
        for (int b = 0; b < PB; ++b)
          sc[b] += __shfl_xor_sync(0xffffffffu, sc[b], sh);
      float m_new = m;
#pragma unroll
      for (int b = 0; b < PB; ++b) {
        const int j = jj + b * TPP + g;
        sc[b] *= p.scale;
        if (kQuant && j < cnt) sc[b] *= ksc[j0 + j];   // dequant: the score
        if (j < cnt) m_new = fmaxf(m_new, sc[b]);
      }
      const float alpha = expf(m - m_new);
#pragma unroll
      for (int e = 0; e < EPL; ++e) o[e] *= alpha;
      l *= alpha;
#pragma unroll
      for (int b = 0; b < PB; ++b) {
        const int j = jj + b * TPP + g;
        if (j >= cnt) continue;
        float pr = expf(sc[b] - m_new);
        l += pr;
        if (kQuant) pr *= vsc[j0 + j];   // ... and the probability
        const unsigned char* vrow = vt + j * tok_bytes;
#pragma unroll
        for (int cc = 0; cc < CPL; ++cc) {
          float x[E];
          P::load16(vrow + (cc * LPT + li) * 16, x);
#pragma unroll
          for (int e = 0; e < E; ++e)
            o[cc * E + e] = fmaf(pr, x[e], o[cc * E + e]);
        }
      }
      m = m_new;
    }
    __syncthreads();   // every warp is done with stage st
    if (threadIdx.x == 0 && u + kStages < n_units) issue(u + kStages);
  }

  // the token groups' states, merged across the warp
#pragma unroll
  for (int sh = LPT; sh < 32; sh <<= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, sh);
    const float lo = __shfl_xor_sync(0xffffffffu, l, sh);
    const float m_new = fmaxf(m, mo);
    const float a = expf(m - m_new), b = expf(mo - m_new);
    l = l * a + lo * b;
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      o[e] = o[e] * a + __shfl_xor_sync(0xffffffffu, o[e], sh) * b;
    m = m_new;
  }
  float* part =
      p.part + ((static_cast<long long>(s) * p.n_chunks + c) * p.h + head) *
                   (D + 2);
  if (g == 0)
#pragma unroll
    for (int cc = 0; cc < CPL; ++cc)
#pragma unroll
      for (int e = 0; e < E; ++e) part[(cc * LPT + li) * E + e] = o[cc * E + e];
  if (lane == 0) {
    part[D] = m;
    part[D + 1] = l;
  }
  // every thread's partial writes, then one fence and the count (the
  // fence is cumulative over the writes the barrier ordered before it)
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    *last_s = atomicAdd(&p.counts[s], 1) == live - 1;
  }
  __syncthreads();
  if (!*last_s) return;

  // the lane's last chunk merges, warp w over head w: the self token
  // (m = s_self, l = 1, o = new_v) and the chunks' states, each weighted
  // by exp(m - the largest m).  Lane j holds chunk j's (m, l) and weight
  // (32 chunks at a time), so the chunks' o loads do not wait on each
  // other (o summed in chunk order)
  __threadfence();
  const float* ph =
      p.part + (static_cast<long long>(s) * p.n_chunks * p.h + head) * (D + 2);
  const long long step = static_cast<long long>(p.h) * (D + 2);
  float mc = kNegInf, lc = 0.f;
  if (lane < live) {
    mc = __ldcg(ph + lane * step + D);
    lc = __ldcg(ph + lane * step + D + 1);
  }
  float mx = fmaxf(s_self, mc);
  for (int cc = lane + 32; cc < live; cc += 32)
    mx = fmaxf(mx, __ldcg(ph + cc * step + D));
#pragma unroll
  for (int sh = 16; sh > 0; sh >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, sh));
  const float wc = expf(mc - mx);
  float den = wc * lc;
  for (int cc = lane + 32; cc < live; cc += 32)
    den += expf(__ldcg(ph + cc * step + D) - mx) * __ldcg(ph + cc * step + D + 1);
  const float w_self = expf(s_self - mx);
  den = warp_sum(den) + w_self;
  float om[EPM];
#pragma unroll
  for (int e = 0; e < EPM; ++e) om[e] = nv[e] * w_self;
  for (int g0 = 0; g0 < live; g0 += 32) {
    const float wg = g0 == 0 ? wc
                     : lane + g0 < live
                         ? expf(__ldcg(ph + (g0 + lane) * step + D) - mx)
                         : 0.f;
    // R chunks a round, their loads all issued before any is used (a
    // loop with a runtime count would leave a remainder of one-by-one
    // loads, each a round trip to L2; 16 a round spill at 64 registers)
    constexpr int R = kMaxThreads <= 512 ? 16 : 8;
    for (int j0 = 0; j0 < min(32, live - g0); j0 += R) {
#pragma unroll
      for (int jj = 0; jj < R; ++jj) {
        const int j = j0 + jj;
        const float w = __shfl_sync(0xffffffffu, wg, j);
        if (g0 + j < live) {
          const float* pc = ph + (g0 + j) * step + lane * EPM;
#pragma unroll
          for (int e = 0; e < EPM; ++e) om[e] = fmaf(w, __ldcg(pc + e), om[e]);
        }
      }
    }
  }
#pragma unroll
  for (int e = 0; e < EPM; ++e) p.out[at + e] = om[e] / den;
  if (threadIdx.x == 0) p.counts[s] = 0;   // ready for the next launch
}

// -------------------------------------------------------------- rows body

constexpr int kWarps = 4;

// EPL: values of a head row per thread (head_dim = 32 * EPL)
template <int EPL, typename PoolT, bool kQuant>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_rows(const Params p) {
  using P = Pool<PoolT>;
  constexpr int D = 32 * EPL;
  __shared__ float sm_m[kWarps];
  __shared__ float sm_l[kWarps];
  __shared__ float sm_o[kWarps][D];
  const PoolT* k_pool = static_cast<const PoolT*>(p.k_pool);
  const PoolT* v_pool = static_cast<const PoolT*>(p.v_pool);

  const int head = blockIdx.x;
  const int s = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int tid = threadIdx.x % 32;
  const long long lane_off =
      (static_cast<long long>(s) * p.h + head) * D + static_cast<long long>(tid) * EPL;

  float qv[EPL], o[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) qv[e] = p.q[lane_off + e];

  float m, l;
  if (warp == 0) {
    // the new token always attends to itself: seed with its score
    float part = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) part += qv[e] * p.new_k[lane_off + e];
    m = warp_sum(part) * p.scale;
    l = 1.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) o[e] = p.new_v[lane_off + e];
  } else {
    m = kNegInf;
    l = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) o[e] = 0.f;
  }

  const int n = min(max(p.ctx_len[s], 0), p.mb * p.bs);
  const int32_t* table = p.tables + static_cast<long long>(s) * p.mb;

  for (int j = warp; j < n; j += kWarps) {
    const long long slot =
        static_cast<long long>(table[j / p.bs]) * p.bs + j % p.bs;
    const long long off = (slot * p.h + head) * D + static_cast<long long>(tid) * EPL;
    float part = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) part += qv[e] * P::one(k_pool + off + e);
    float sc = warp_sum(part) * p.scale;
    if (kQuant) sc *= p.k_scale[slot];   // dequant folded into the score
    const float m_new = fmaxf(m, sc);
    const float alpha = expf(m - m_new);
    float pr = expf(sc - m_new);
    l = l * alpha + pr;
    if (kQuant) pr *= p.v_scale[slot];   // ... and into the probability
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      o[e] = o[e] * alpha + pr * P::one(v_pool + off + e);
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
    for (int e = 0; e < EPL; ++e) p.out[lane_off + e] = acc[e] / den;
  }
}

// ----------------------------------------------------------------- launch

// bytes of the split body's dynamic shared memory
template <typename PoolT, bool kQuant>
int split_smem(const Params& p, int D) {
  const int unit_bytes = p.unit * p.h * D * static_cast<int>(sizeof(PoolT));
  // the ring (after up to 127 bytes of alignment), full[], the chunk's
  // table entries, its scales (room kept for int8 alone), the merge flag
  return 128 + kStages * 2 * unit_bytes + kStages * 8 + 4 * p.chunk_blocks +
         (kQuant ? 8 * p.chunk_blocks * p.bs : 0) + 4;
}

template <int D, typename PoolT, bool kQuant, int kMaxThreads>
int launch_split(const Params& p, int S, cudaStream_t st) {
  auto kernel = paged_decode_split<D, PoolT, kQuant, kMaxThreads>;
  static std::atomic<uint64_t> smem_set{0};
  const cudaError_t rc = hopper::allow_max_dynamic_smem(
      reinterpret_cast<const void*>(kernel), &smem_set);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  kernel<<<dim3(S, p.n_chunks), 32 * p.h, split_smem<PoolT, kQuant>(p, D),
           st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D, typename PoolT, bool kQuant>
int launch_rows(const Params& p, int S, cudaStream_t st) {
  paged_decode_rows<D / 32, PoolT, kQuant>
      <<<dim3(p.h, S), kWarps * 32, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D, typename PoolT, bool kQuant>
int launch(const Params& p, int S, int body, cudaStream_t st) {
  if (body == 1) return launch_rows<D, PoolT, kQuant>(p, S, st);
  return p.h <= 16 ? launch_split<D, PoolT, kQuant, 512>(p, S, st)
                   : launch_split<D, PoolT, kQuant, 1024>(p, S, st);
}

template <int D>
int launch_d(const Params& p, int S, int pool, int body, cudaStream_t st) {
  switch (pool) {
    case 0: return launch<D, float, false>(p, S, body, st);
    case 1: return launch<D, __half, false>(p, S, body, st);
    case 2: return launch<D, __nv_bfloat16, false>(p, S, body, st);
    case 3: return launch<D, int8_t, true>(p, S, body, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, new_k, new_v, out: [S, H, D] f32; k_pool, v_pool: [NB, BS, H, D] of
// `pool` 0 f32, 1 f16, 2 bf16 or 3 int8 (with k_scale, v_scale [NB, BS]
// f32); tables: [S, MB] int32; ctx_len: [S] int32.  body 0 (`split`):
// H <= 32 and both pools 16-byte aligned, chunks of chunk_blocks pool
// blocks (n_chunks of them cover MB), units of `unit` tokens; part: [S,
// n_chunks, H, D + 2] f32 scratch; counts: [S] int32, zero (the launch
// leaves it zero).  body 1 (`rows`): any H and alignment, part and counts
// unused.  D must be 32, 64, 128 or 256.  Returns cudaGetLastError() after
// the launch (cudaErrorInvalidValue for an unsupported D, pool or body).
extern "C" int paged_decode(const void* q, const void* new_k,
                            const void* new_v, const void* k_pool,
                            const void* v_pool, const void* k_scale,
                            const void* v_scale, const void* tables,
                            const void* ctx_len, void* out, void* part,
                            void* counts, int S, int H, int D, int BS, int MB,
                            int pool, int body, int chunk_blocks,
                            int n_chunks, int unit, float scale,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S <= 0 || H <= 0) return 0;
  if ((body != 0 && body != 1) || S > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (body == 0 &&
      (H > 32 || chunk_blocks <= 0 || unit <= 0 || n_chunks > 65535 ||
       static_cast<long long>(n_chunks) * chunk_blocks < MB ||
       ((reinterpret_cast<uintptr_t>(k_pool) |
         reinterpret_cast<uintptr_t>(v_pool)) & 15) != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const float*>(q);
  p.new_k = static_cast<const float*>(new_k);
  p.new_v = static_cast<const float*>(new_v);
  p.k_pool = k_pool;
  p.v_pool = v_pool;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.tables = static_cast<const int32_t*>(tables);
  p.ctx_len = static_cast<const int32_t*>(ctx_len);
  p.out = static_cast<float*>(out);
  p.part = static_cast<float*>(part);
  p.counts = static_cast<int*>(counts);
  p.h = H;
  p.bs = BS;
  p.mb = MB;
  p.chunk_blocks = chunk_blocks;
  p.n_chunks = n_chunks;
  p.unit = unit;
  p.scale = scale;
  switch (D) {
    case 32: return launch_d<32>(p, S, pool, body, st);
    case 64: return launch_d<64>(p, S, pool, body, st);
    case 128: return launch_d<128>(p, S, pool, body, st);
    case 256: return launch_d<256>(p, S, pool, body, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
