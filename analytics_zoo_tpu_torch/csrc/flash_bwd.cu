// Flash attention backward for Hopper (sm_90a): three kernels, one per
// gradient, each recomputing the probabilities from the forward's
// logsumexp so the [t, t] matrices never reach device memory.
//
// Replaces the TPU kernels of `_flash_bwd` in
// analytics_zoo_tpu/ops/pallas/flash_attention.py:
//   K4a `_bwd_dq_kernel` (pallas_call at :741):  dq = sum_k ds k * scale;
//   K4b `_bwd_dkv_kernel` (:825):  dk = sum_q ds^T q * scale, dv = sum_q
//        p~^T dO;
//   K5  `_bwd_dbias_kernel` (:807): dbias = sum over the bias's broadcast
//        replicas of ds, at the collapsed bias's [lead, t, t] shape;
// with p = exp(s - lse) recomputed as `_recompute_p` (:465) does (masked
// entries exactly 0: a fully masked row has lse near -1e30, where exp
// would give 1), dp = dO v^T, the forward's positional-hash dropout keep
// mask (bit for bit: the same (seed, bh = batch * h + head, q_off + q,
// k_off + k)) applied to dp and to p for dV (p~), and ds = p (dp - delta)
// with delta = rowsum(dO * O) - dlse computed outside.  As on the TPU,
// each gradient has its own pass, so no pass needs atomics and every
// gradient is deterministic; the dbias pass runs only when the bias needs
// a gradient.
//
// Layouts: q, k, v [b, t, h, d] views sharing the strides (sb, sh, st)
// with unit stride in d (the thirds of a fused qkv read in place); dO,
// dq, dk, dv [b, t, h, d] contiguous; lse, delta [b*h, t] f32; kv_mask
// [b, t] int32; bias [lead, t, t] f32 (leading index as the forward's
// bias_mode); dbias [lead, t, t] f32; seed3 int32 [3].  Any t; head_dim
// 32, 64 or 128.
//
// Bounds at b = 32, h = 12, t = 512, d = 64 in bf16 with every key valid:
// dQ does three products (S, dP, dQ), 6 b h t^2 d = 38.7 GFLOP, 39 us at
// 989 TFLOP/s, against 126 MB of q, k, v, dO, dq (25 MB each) and lse,
// delta, 38 us at 3.35 TB/s; dK/dV four products (S^T, dP^T, dV, dK), 52
// us; dbias at a [1, h, t, t] f32 bias two products (26 us) against the
// 101 MB of q, k, v, dO plus the bias read and its gradient written
// (25 MB), 38 us.  A kv_mask that pads keys leaves fewer products: on the
// fine-tune's traffic (11,403 of 16,384 keys valid) dQ's are 27 us, so
// bytes bound it.
//
// Design, the TPU grid's innermost sequential axis becomes a loop inside
// one block; every grid is 1-D, its x walking (b*h or the bias's lead
// planes) x tiles, so b*h may pass the 65535 of grid.y:
//   * dQ (bf16: the Hopper body `bwd_dq_sm90`): one block per (b*h, 128
//     queries), three warpgroups.  The block first packs its batch row's
//     kv_mask into bit words in shared memory (flash_sm90.cuh); a 64-key
//     tile with no valid key is neither loaded nor computed (exact: p =
//     0 at a masked key, so ds = 0 there; a fully padded row gives zero
//     dq).  One producer thread loads the block's Q, dO, lse and delta
//     once, then streams 64-key K and V tiles through a 3-stage ring, all
//     by TMA (the same tensor maps as dK/dV) on full / empty mbarriers.
//     Each consumer warpgroup owns 64 queries: S = Q K^T and dP = dO V^T
//     by wgmma m64n64k16 from shared memory (all K-major), then the
//     elementwise ds (one SFU exp2 in log2 space, masks, the hash
//     dropout, specialised per tile as dK/dV's) written straight into
//     bf16 A registers, then dQ += dS K by wgmma RS with K read MN-major.
//     The elementwise pass only reads the accumulators and every tile
//     waits for its products before the next tile's, so ptxas never
//     serialises the wgmmas (no C7515 / C7513 note in the -Xptxas -v
//     log); the two warpgroups share each stage, so one's products
//     overlap the other's elementwise pass.  Causal: key tiles past the
//     block's last query are never loaded.  dq times the scale goes out
//     through swizzled shared memory and a TMA store.  setmaxnreg gives
//     the consumers 232 registers and the producer 40; -Xptxas -v
//     (sm_90a): 168 registers at launch, no spill, at d = 32, 64 and
//     128.  One block an SM: at the 80 registers a thread of two blocks
//     an SM, S, dP, dQ and the A registers do not fit (they spilled, and
//     ptxas serialised the wgmmas, note C7512);
//   * dK/dV (bf16: the Hopper body `bwd_dkv_sm90`): one block per (b*h,
//     128 keys), three warpgroups.  The block first reads its keys'
//     kv_mask: when all 128 are padding it writes zero dk, dv rows and
//     returns (exact: p = 0 at a masked key, so ds = p~ = 0 there), and a
//     consumer warpgroup whose 64 keys are all padding computes nothing.
//     One producer thread loads the block's K and V once and then the Q,
//     dO tiles (64 queries) with their lse and delta into a 3-stage ring,
//     all by TMA (4-D tensor maps over (d, h, t, b) with the views'
//     strides, so the thirds of a fused qkv are read in place; 128- or
//     64-byte swizzle) completing on full/empty mbarriers.  Each consumer
//     warpgroup owns 64 keys and runs all four products as wgmma with f32
//     accumulators: S^T = K Q^T and dP^T = V dO^T from shared memory,
//     then, after the elementwise p~ and ds (one SFU exp2, masks, the
//     hash dropout), dV += p~^T dO and dK += ds^T Q with A from registers
//     (p~, ds rounded to bf16) and B the staged dO / Q read MN-major.  The
//     elementwise pass only reads the accumulators and writes the bf16 A
//     registers, and every tile issues the same products and waits for
//     them before the next tile's, so ptxas never serialises the wgmmas
//     (issuing the next tile's S^T, dP^T behind this tile's dV, dK made it
//     do so, and ran slower).  The two
//     warpgroups share each stage, so one's products overlap the other's
//     elementwise work, which is specialised per tile (crossing t or the
//     causal diagonal or not, bias, dropout); setmaxnreg gives them 240
//     registers and the producer 24.  Causal: query tiles before the
//     block's first key are never loaded.  At t = 512, d = 64 the
//     elementwise work (an exp per score, plus the hash under dropout: 32
//     scores a thread a stage) takes longer than the stage's products, so
//     the tensor cores are not what bounds this body;
//   * dbias (bf16: the Hopper body `bwd_dbias_sm90`): one block per (lead,
//     128 queries, 64 keys), three warpgroups.  The ring walks the bias's
//     broadcast replicas (bh = mul_l * lead + mul_r * rep), the TPU grid's
//     innermost axis: a producer warp reads each replica's kv_mask words
//     for the block's 64 keys (a replica whose keys are all padding is
//     neither loaded nor computed: exact, ds = 0 at a masked key) and one
//     of its threads loads the replica's Q, dO (128 rows), K, V (64 rows),
//     lse and delta by TMA into a 3-stage ring (2 at d = 128) on full /
//     empty mbarriers, with the replica's index and key words beside it;
//     a stage with no replica ends the walk.  Each consumer warpgroup owns
//     64 queries: S = Q K^T and dP = dO V^T by wgmma m64n64k16 from
//     shared memory, then ds (dK/dV's and dQ's elementwise math, the bias
//     from registers) summed over the replicas into an f32 register tile,
//     the bias tile read once per block.  The tile goes out with plain
//     stores from the accumulator layout (each warp store: 8 rows of 32
//     contiguous bytes).  A causal-dead block writes its zeros.  L2
//     traffic: each block streams 49 KB a replica at d = 64 (Q and dO
//     are read again by each of the t / 64 key tiles, K and V by each of
//     the t / 128 query blocks): 602 MB at b = 32, h = 12, t = 512 and a
//     [1, h, t, t] bias, against the 126 MB its bound counts;
//   * f32: no TF32 (the TPU kernels ask Precision.HIGHEST for f32): 32-row
//     tiles, 4 warps of 8 rows, lanes over 32 columns for the scores and
//     over d for the products, FFMA throughout.

#include "flash_sm90.cuh"

namespace {

using flash::bias_lead;
using flash::drop_keep;
using flash::kThreads;
using flash::Seeds;
using bf16 = __nv_bfloat16;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  const int32_t* kv_mask;
  const float* bias;
  const int32_t* seed3;
  void* dq;
  void* dk;
  void* dv;
  float* dbias;
  int b, h, t;
  long long sb, sh, st;
  int causal, bias_mode, dropout, drop_threshold;
  float drop_scale, scale;
  int reps, mul_l, mul_r;
};

__device__ __forceinline__ const float* bias_plane(const Params& p, int lead) {
  return p.bias + static_cast<long long>(lead) * p.t * p.t;
}

// rows of the dO head of (bi, hi): contiguous [b, t, h, d]
__device__ __forceinline__ long long dout_head(const Params& p, int bi,
                                               int hi, int d) {
  return (static_cast<long long>(bi) * p.t * p.h + hi) * d;
}

__device__ __forceinline__ bool key_valid(const Params& p, int bi, int col) {
  return col < p.t &&
         (p.kv_mask == nullptr ||
          p.kv_mask[static_cast<long long>(bi) * p.t + col] != 0);
}

// ds for one score: s the raw q.k product, dp the raw dO.v product;
// writes p~ (the dropped, rescaled probability dV uses) to *pd.  The
// bf16 Hopper bodies compute the same per tile in their own copies, with
// exp2 in log2 space: dK/dV's dkv90::grad_tile (keys as rows), dQ's
// dq90::ds_tile (queries as rows) and dbias's db90::ds_sum.  Each must
// only read its wgmma accumulators, because ptxas serialises the wgmmas
// when another instruction writes an accumulator.  A change here (or to
// K3's softmax, flash_fwd.cu) goes into all four.
__device__ __forceinline__ float grad_score(const Params& p, const Seeds& sd,
                                            const float* bplane, int bh,
                                            int row, int col, float s,
                                            float dp, float lse, float delta,
                                            float* pd) {
  float x = s * p.scale;
  if (bplane != nullptr) x += bplane[static_cast<long long>(row) * p.t + col];
  const float pv = expf(x - lse);
  float pdrop = pv;
  if (p.dropout) {
    const bool kd =
        drop_keep(sd.seed, bh, sd.q_off + row, sd.k_off + col, p.drop_threshold);
    pdrop = kd ? pv * p.drop_scale : 0.f;
    dp = kd ? dp * p.drop_scale : 0.f;
  }
  *pd = pdrop;
  return pv * (dp - delta);
}

// ---------------------------------------------------------------- bf16

// K4b, bf16: TMA + wgmma (see the design above)
namespace dkv90 {
constexpr int kKeys = 128;    // keys a block owns: 64 per consumer warpgroup
constexpr int kQ = flash90::kRows;   // queries a pipeline stage holds
constexpr int STAGES = 3;
constexpr int kThreads = 384;   // consumer warpgroups 0 and 1, producer 2

template <int D>
struct Cfg : flash90::Tile<D> {
  using T = flash90::Tile<D>;
  static constexpr int KV = 4 * T::TILE;   // K and V, 128 rows each
  // Q, dO, then lse and delta (64 f32 each), padded to the 1024-byte atom
  static constexpr int STAGE = 2 * T::TILE + 1024;
  static constexpr int SMEM = KV + STAGES * STAGE + 64 + 1024;
};

// a warp's 16 rows of a [64][D] accumulator, times `mul`, to rows
// r0 + 0..15 of a contiguous [b, t, h, D] bf16 tensor; rows past t dropped
template <int D>
__device__ __forceinline__ void store_acc(void* out, const Params& p, int bi,
                                          int hi, int r0,
                                          const float (&acc)[D / 2],
                                          float mul) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = r0 + (lane >> 2) + hh * 8;
    if (row >= p.t) continue;
    bf16* orow = static_cast<bf16*>(out) +
                 ((static_cast<long long>(bi) * p.t + row) * p.h + hi) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + (lane & 3) * 2) =
          __floats2bfloat162_rn(acc[4 * j + 2 * hh] * mul,
                                acc[4 * j + 2 * hh + 1] * mul);
  }
}
// p~ and ds of a warpgroup's [64 keys][64 queries] tile from the raw
// S^T (s) and dP^T (dp) accumulators, rounded to bf16 straight into the
// A operands of dV += p~^T dO (pa) and dK += dS^T Q (da): the
// accumulators are only read, so no instruction but a wgmma defines them
// (else ptxas serialises the wgmmas).  Each thread holds keys row0, row0
// + 8 and queries q0 + 8 j + 2 (lane % 4) + {0, 1}; the pair of column
// block j, key half hh is A register [j / 2][2 (j % 2) + hh].  EDGE: the
// tile crosses t or the causal diagonal (else every query is valid and
// after every key); BIAS, DROP as the call asks.
template <bool EDGE, bool BIAS, bool DROP>
__device__ __forceinline__ void grad_tile(const float (&s)[32],
                                          const float (&dp)[32],
                                          uint32_t (&pa)[4][4],
                                          uint32_t (&da)[4][4],
                                          const Params& p, const Seeds& sd,
                                          const float* bplane, int bh,
                                          int row0, const bool (&kval)[2],
                                          int q0, const float* lse_s,
                                          const float* delta_s,
                                          float scale2) {
  const int c2 = (threadIdx.x & 3) * 2;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int key = row0 + hh * 8;
      float pd[2], ds[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = 2 * hh + c, ql = j * 8 + c2 + c, q = q0 + ql;
        bool ok = kval[hh];
        if (EDGE) ok = ok && q < p.t && (!p.causal || key <= q);
        float x2 = s[4 * j + e] * scale2 - lse_s[ql] * flash90::kLog2e;
        if (BIAS && ok)
          x2 += bplane[static_cast<long long>(q) * p.t + key] *
                flash90::kLog2e;
        const float pv = ok ? flash90::exp2_approx(x2) : 0.f;
        float dpv = dp[4 * j + e];
        pd[c] = pv;
        if (DROP) {
          const bool kd = drop_keep(sd.seed, bh, sd.q_off + q, sd.k_off + key,
                                    p.drop_threshold);
          pd[c] = kd ? pv * p.drop_scale : 0.f;
          dpv = kd ? dpv * p.drop_scale : 0.f;
        }
        ds[c] = pv * (dpv - delta_s[ql]);
      }
      pa[j / 2][2 * (j % 2) + hh] = flash::pack_bf16(pd[0], pd[1]);
      da[j / 2][2 * (j % 2) + hh] = flash::pack_bf16(ds[0], ds[1]);
    }
  }
}

template <bool EDGE>
__device__ __forceinline__ void grad_tile_for(const float (&s)[32],
                                              const float (&dp)[32],
                                              uint32_t (&pa)[4][4],
                                              uint32_t (&da)[4][4],
                                              const Params& p, const Seeds& sd,
                                              const float* bplane, int bh,
                                              int row0, const bool (&kval)[2],
                                              int q0, const float* lse_s,
                                              const float* delta_s,
                                              float scale2) {
#define DKV_GRAD(BIAS, DROP)                                                 \
  grad_tile<EDGE, BIAS, DROP>(s, dp, pa, da, p, sd, bplane, bh, row0, kval, \
                              q0, lse_s, delta_s, scale2)
  if (p.dropout) {
    if (bplane != nullptr) DKV_GRAD(true, true); else DKV_GRAD(false, true);
  } else {
    if (bplane != nullptr) DKV_GRAD(true, false); else DKV_GRAD(false, false);
  }
#undef DKV_GRAD
}
}  // namespace dkv90

template <int D>
__global__ void __launch_bounds__(dkv90::kThreads, 1)
bwd_dkv_sm90(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv,
             const __grid_constant__ CUtensorMap tdo,
             const __grid_constant__ CUtensorMap tlse,
             const __grid_constant__ CUtensorMap tdelta, const Params p) {
  using C = dkv90::Cfg<D>;
  using dkv90::kKeys;
  using dkv90::kQ;
  using dkv90::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ks = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* vs = ks + 2 * C::TILE;
  unsigned char* stages = ks + C::KV;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(stages + STAGES * C::STAGE);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;
  __shared__ int live_s[2];   // warpgroup w's 64 keys hold a valid one

  // grid.x walks the key blocks of each head in turn
  const int n_k = (p.t + kKeys - 1) / kKeys;
  const int bh = blockIdx.x / n_k, bi = bh / p.h, hi = bh % p.h;
  const int k0 = blockIdx.x % n_k * kKeys;
  if (threadIdx.x < 2) live_s[threadIdx.x] = 0;
  __syncthreads();
  // padded-key skip: read the block's kv_mask before any load
  const bool valid = threadIdx.x < kKeys && key_valid(p, bi, k0 + threadIdx.x);
  const unsigned any = __ballot_sync(0xffffffffu, valid);
  if ((threadIdx.x & 31) == 0 && any != 0)
    atomicOr(&live_s[threadIdx.x / 64], 1);
  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);    // the producer's expect_tx arrival
      hopper::mbar_init(&empty[s], 8);   // lane 0 of each consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (!live_s[0] && !live_s[1]) {
    // every key is padding: p = 0 at a masked key, so ds = p~ = 0 and dk,
    // dv are exactly 0 on these rows
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int i = threadIdx.x; i < kKeys * D / 8; i += dkv90::kThreads) {
      const int r = k0 + i / (D / 8), c = i % (D / 8) * 8;
      if (r >= p.t) continue;
      const long long at =
          ((static_cast<long long>(bi) * p.t + r) * p.h + hi) * D + c;
      *reinterpret_cast<uint4*>(static_cast<bf16*>(p.dk) + at) = zero;
      *reinterpret_cast<uint4*>(static_cast<bf16*>(p.dv) + at) = zero;
    }
    return;
  }
  // causal: queries before the block's first key see none of its keys
  const int i0 = p.causal ? k0 / kQ : 0, n_q = (p.t + kQ - 1) / kQ;

  if (threadIdx.x >= 256) {   // producer: one thread issues every load
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      hopper::mbar_arrive_expect_tx(kv_full, C::KV);
      for (int w = 0; w < 2; ++w)
        for (int c = 0; c < C::NCH; ++c) {
          const int off = w * C::TILE + c * C::CHUNK;
          hopper::tma_load_4d(ks + off, &tk, kv_full, c * C::CW, hi,
                              k0 + w * 64, bi);
          hopper::tma_load_4d(vs + off, &tv, kv_full, c * C::CW, hi,
                              k0 + w * 64, bi);
        }
      int stage = 0;
      uint32_t phase = 0;
      for (int i = i0; i < n_q; ++i) {
        const int q0 = i * kQ;
        hopper::mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* st = stages + stage * C::STAGE;
        hopper::mbar_arrive_expect_tx(&full[stage], 2 * C::TILE + 2 * kQ * 4);
        for (int c = 0; c < C::NCH; ++c) {
          hopper::tma_load_4d(st + c * C::CHUNK, &tq, &full[stage],
                              c * C::CW, hi, q0, bi);
          hopper::tma_load_4d(st + C::TILE + c * C::CHUNK, &tdo, &full[stage],
                              c * C::CW, hi, q0, bi);
        }
        hopper::tma_load_1d(st + 2 * C::TILE, &tlse, &full[stage],
                            bh * p.t + q0);
        hopper::tma_load_1d(st + 2 * C::TILE + kQ * 4, &tdelta, &full[stage],
                            bh * p.t + q0);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {   // consumers: warpgroup wg owns keys k0 + 64 wg + [0, 64)
    hopper::setmaxnreg_inc<240>();
    const int wg = threadIdx.x / 128, warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    const bool live = live_s[wg] != 0;
    const int key0 = k0 + wg * 64;
    const int row0 = key0 + warp * 16 + (lane >> 2);   // and row0 + 8
    const bool kval[2] = {key_valid(p, bi, row0), key_valid(p, bi, row0 + 8)};
    const unsigned char* kt = ks + wg * C::TILE;
    const unsigned char* vt = vs + wg * C::TILE;
    const Seeds sd(p);
    const float* bplane =
        p.bias_mode ? bias_plane(p, bias_lead(p.bias_mode, bh, p.h)) : nullptr;
    const float scale2 = p.scale * flash90::kLog2e;
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

    int stage = 0;
    uint32_t phase = 0;
    if (!live) {
      // every key of this warpgroup is padding: its dk, dv rows stay 0;
      // it only releases the stages the other warpgroup reads
      for (int i = i0; i < n_q; ++i) {
        hopper::mbar_wait(&full[stage], phase);
        if (lane == 0) hopper::mbar_arrive(&empty[stage]);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    } else {
      // every tile issues the same products (a causal tile wholly before
      // these keys is masked to zeros, not skipped)
      hopper::mbar_wait(kv_full, 0);
      for (int i = i0; i < n_q; ++i) {
        const int q0 = i * kQ;
        hopper::mbar_wait(&full[stage], phase);
        const unsigned char* qt = stages + stage * C::STAGE;
        const float* lse_s = reinterpret_cast<const float*>(qt + 2 * C::TILE);
        const float* delta_s = lse_s + kQ;
        // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries, over D
        float s[32], dp[32];
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hopper::wgmma_ss_n64(s, flash90::kmajor<D>(kt, kk),
                               flash90::kmajor<D>(qt, kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hopper::wgmma_ss_n64(dp, flash90::kmajor<D>(vt, kk),
                               flash90::kmajor<D>(qt + C::TILE, kk), kk > 0);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(s);
        hopper::fence_regs(dp);
        // rows are keys, columns queries: p~ and ds into the A operands
        uint32_t pa[4][4], da[4][4];
        if (q0 + kQ > p.t || (p.causal && key0 + 63 > q0))
          dkv90::grad_tile_for<true>(s, dp, pa, da, p, sd, bplane, bh, row0,
                                     kval, q0, lse_s, delta_s, scale2);
        else
          dkv90::grad_tile_for<false>(s, dp, pa, da, p, sd, bplane, bh, row0,
                                      kval, q0, lse_s, delta_s, scale2);
        // dV += p~^T dO and dK += dS^T Q: A from registers, B the staged
        // dO / Q read MN-major, 16 queries a step
        hopper::wgmma_fence();
#pragma unroll
        for (int kq = 0; kq < 4; ++kq)
          hopper::wgmma_rs_tb<D>(dv, pa[kq],
                                 flash90::mnmajor<D>(qt + C::TILE, kq), 1);
#pragma unroll
        for (int kq = 0; kq < 4; ++kq)
          hopper::wgmma_rs_tb<D>(dk, da[kq], flash90::mnmajor<D>(qt, kq), 1);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(dv);
        hopper::fence_regs(dk);
        flash90::fence_a(pa);
        flash90::fence_a(da);
        if (lane == 0) hopper::mbar_arrive(&empty[stage]);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    dkv90::store_acc<D>(p.dk, p, bi, hi, key0 + warp * 16, dk, p.scale);
    dkv90::store_acc<D>(p.dv, p, bi, hi, key0 + warp * 16, dv, 1.f);
  }
}

// the tensor maps the Hopper bodies read: q, k, v (the views), dO
// (contiguous) and lse, delta (flattened [b*h, t])
struct BwdMaps {
  CUtensorMap q, k, v, dout, lse, delta;
};

template <int D>
bool bwd_maps(const Params& p, BwdMaps* m) {
  const uint64_t rows = static_cast<uint64_t>(p.b) * p.h * p.t;
  return flash90::head_map<D>(&m->q, p.q, p.b, p.h, p.t, p.sb, p.sh, p.st) &&
         flash90::head_map<D>(&m->k, p.k, p.b, p.h, p.t, p.sb, p.sh, p.st) &&
         flash90::head_map<D>(&m->v, p.v, p.b, p.h, p.t, p.sb, p.sh, p.st) &&
         flash90::dense_head_map<D>(&m->dout, p.dout, p.b, p.h, p.t) &&
         flash90::row_map(&m->lse, p.lse, rows) &&
         flash90::row_map(&m->delta, p.delta, rows);
}

// the launch of K4b's bf16 body: grid b*h * (t / 128 key blocks)
template <int D>
int launch_dkv_sm90(const Params& p, cudaStream_t st) {
  using C = dkv90::Cfg<D>;
  BwdMaps m;
  if (!bwd_maps<D>(p, &m)) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncSetAttribute(bwd_dkv_sm90<D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  const dim3 grid((p.t + dkv90::kKeys - 1) / dkv90::kKeys * p.b * p.h);
  bwd_dkv_sm90<D><<<grid, dkv90::kThreads, C::SMEM, st>>>(
      m.q, m.k, m.v, m.dout, m.lse, m.delta, p);
  return static_cast<int>(cudaGetLastError());
}

// K4a, bf16: TMA + wgmma (see the design above)
namespace dq90 {
constexpr int kQ = 128;              // query rows a block owns
constexpr int kK = flash90::kRows;   // keys a tile
constexpr int STAGES = 3;
constexpr int kThreads = 384;   // consumer warpgroups 0 and 1, producer 2

template <int D>
struct Cfg {
  static constexpr int TILE = flash90::Tile<D>::TILE;
  // Q (128 rows, then dq), dO (128 rows), lse and delta (128 f32 each,
  // padded to the 1024-byte atom)
  static constexpr int FIXED = 4 * TILE + 1024;
  static constexpr int STAGE = 2 * TILE;   // a K and a V tile
  // the ring, then q_full, full[], empty[], then the key words
  // (flash90::key_words_bytes(t) more, at launch); 1024 to align the base
  static constexpr int SMEM =
      FIXED + STAGES * STAGE + (1 + 2 * STAGES) * 8 + 1024;
};

// ds of a warpgroup's [64 queries][64 keys] tile from the raw S and dP
// accumulators, rounded to bf16 straight into the A operands of dQ += dS
// K: the accumulators are only read (else ptxas serialises the wgmmas).
// Each thread holds queries row0, row0 + 8 and keys k0 + 8 j + 2 (lane %
// 4) + {0, 1}; the pair of key block j, row half hh is A register [j /
// 2][2 (j % 2) + hh].  lse2 is the rows' lse times log2 e.  EDGE: a key
// of the tile is padding, or the tile crosses the causal diagonal or t;
// BIAS, DROP as the call asks.  The math of grad_score, in log2 space.
template <bool EDGE, bool BIAS, bool DROP>
__device__ __forceinline__ void ds_tile(const float (&s)[32],
                                        const float (&dp)[32],
                                        uint32_t (&da)[4][4], const Params& p,
                                        const Seeds& sd, const float* bplane,
                                        int bh, int row0, int k0,
                                        uint32_t mine, const float (&lse2)[2],
                                        const float (&dl)[2], float scale2) {
  const int c2 = (threadIdx.x & 3) * 2;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + 8 * hh;
      float ds[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = 2 * hh + c, col = k0 + 8 * j + c2 + c;
        bool ok = true;
        if (EDGE)
          ok = ((mine >> (2 * j + c)) & 1u) && row < p.t &&
               (!p.causal || col <= row);
        float x2 = s[4 * j + e] * scale2 - lse2[hh];
        if (BIAS && ok)
          x2 += bplane[static_cast<long long>(row) * p.t + col] *
                flash90::kLog2e;
        const float pv = ok ? flash90::exp2_approx(x2) : 0.f;
        float dpv = dp[4 * j + e];
        if (DROP)
          dpv = drop_keep(sd.seed, bh, sd.q_off + row, sd.k_off + col,
                          p.drop_threshold)
                    ? dpv * p.drop_scale
                    : 0.f;
        ds[c] = pv * (dpv - dl[hh]);
      }
      da[j / 2][2 * (j % 2) + hh] = flash::pack_bf16(ds[0], ds[1]);
    }
  }
}

template <bool EDGE>
__device__ __forceinline__ void ds_tile_for(
    const float (&s)[32], const float (&dp)[32], uint32_t (&da)[4][4],
    const Params& p, const Seeds& sd, const float* bplane, int bh, int row0,
    int k0, uint32_t mine, const float (&lse2)[2], const float (&dl)[2],
    float scale2) {
#define DQ_TILE(BIAS, DROP)                                                 \
  ds_tile<EDGE, BIAS, DROP>(s, dp, da, p, sd, bplane, bh, row0, k0, mine, \
                            lse2, dl, scale2)
  if (p.dropout) {
    if (bplane != nullptr) DQ_TILE(true, true); else DQ_TILE(false, true);
  } else {
    if (bplane != nullptr) DQ_TILE(true, false); else DQ_TILE(false, false);
  }
#undef DQ_TILE
}
}  // namespace dq90

template <int D>
__global__ void __launch_bounds__(dq90::kThreads, 1)
bwd_dq_sm90(const __grid_constant__ CUtensorMap tq,
            const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv,
            const __grid_constant__ CUtensorMap tdo,
            const __grid_constant__ CUtensorMap tlse,
            const __grid_constant__ CUtensorMap tdelta,
            const __grid_constant__ CUtensorMap tdq, const Params p) {
  using T = flash90::Tile<D>;
  using C = dq90::Cfg<D>;
  using dq90::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* dos = qs + 2 * T::TILE;
  float* rows = reinterpret_cast<float*>(dos + 2 * T::TILE);   // lse, delta
  unsigned char* ring = qs + C::FIXED;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + STAGES * C::STAGE);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;
  uint32_t* words = reinterpret_cast<uint32_t*>(empty + STAGES);

  // grid.x walks the query blocks of each head in turn
  const int n_q = (p.t + dq90::kQ - 1) / dq90::kQ;
  const int bh = blockIdx.x / n_q, bi = bh / p.h, hi = bh % p.h;
  const int q0 = blockIdx.x % n_q * dq90::kQ;
  // the producer thread sets up the barriers and starts the load of the
  // block's own rows, which overlaps the scan of the kv_mask below
  if (threadIdx.x == 256) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);    // the producer's expect_tx arrival
      hopper::mbar_init(&empty[s], 8);   // lane 0 of each consumer warp
    }
    hopper::fence_barrier_init();
    // the second half's rows start past t when t ends in the first
    const int halves = q0 + 64 < p.t ? 2 : 1;
    hopper::mbar_arrive_expect_tx(q_full,
                                  halves * (2 * T::TILE + 2 * 64 * 4));
    for (int w = 0; w < halves; ++w) {
      const int r0 = q0 + 64 * w;
      flash90::load_tile<D>(qs + w * T::TILE, &tq, q_full, bi, hi, r0);
      flash90::load_tile<D>(dos + w * T::TILE, &tdo, q_full, bi, hi, r0);
      hopper::tma_load_1d(rows + 64 * w, &tlse, q_full, bh * p.t + r0);
      hopper::tma_load_1d(rows + 128 + 64 * w, &tdelta, q_full,
                          bh * p.t + r0);
    }
  }
  flash90::key_words(words, p.kv_mask, bi, p.t);
  __syncthreads();
  int n_kv = (p.t + dq90::kK - 1) / dq90::kK;
  if (p.causal) n_kv = min(n_kv, (q0 + dq90::kQ - 1) / dq90::kK + 1);

  if (threadIdx.x >= 256) {   // producer: one thread issues every load
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int j = 0; j < n_kv; ++j) {
        if ((words[2 * j] | words[2 * j + 1]) == 0) continue;   // padding
        hopper::mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* st = ring + stage * C::STAGE;
        hopper::mbar_arrive_expect_tx(&full[stage], C::STAGE);
        flash90::load_tile<D>(st, &tk, &full[stage], bi, hi, j * dq90::kK);
        flash90::load_tile<D>(st + T::TILE, &tv, &full[stage], bi, hi,
                              j * dq90::kK);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {   // consumers: warpgroup wg owns queries q0 + 64 wg + [0, 64)
    hopper::setmaxnreg_inc<232>();
    const int wg = threadIdx.x / 128, warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    const int qw = q0 + 64 * wg;
    const bool live = qw < p.t;
    const int r = 64 * wg + warp * 16 + (lane >> 2);   // and r + 8
    const int row0 = q0 + r;
    unsigned char* qt = qs + wg * T::TILE;
    const unsigned char* dot = dos + wg * T::TILE;
    const Seeds sd(p);
    const float* bplane =
        p.bias_mode ? bias_plane(p, bias_lead(p.bias_mode, bh, p.h)) : nullptr;
    const float scale2 = p.scale * flash90::kLog2e;
    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

    hopper::mbar_wait(q_full, 0);
    const float lse2[2] = {rows[r] * flash90::kLog2e,
                           rows[r + 8] * flash90::kLog2e};
    const float dl[2] = {rows[128 + r], rows[128 + r + 8]};
    int stage = 0;
    uint32_t phase = 0;
    for (int j = 0; j < n_kv; ++j) {
      const uint32_t w0 = words[2 * j], w1 = words[2 * j + 1];
      if ((w0 | w1) == 0) continue;   // never loaded: ds = 0 on every key
      const int k0 = j * dq90::kK;
      hopper::mbar_wait(&full[stage], phase);
      if (live && !(p.causal && k0 > qw + 63)) {
        const unsigned char* kt = ring + stage * C::STAGE;
        const unsigned char* vt = kt + T::TILE;
        // S = Q K^T and dP = dO V^T: 64 queries x 64 keys, over D
        float s[32], dp[32];
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hopper::wgmma_ss_n64(s, flash90::kmajor<D>(qt, kk),
                               flash90::kmajor<D>(kt, kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hopper::wgmma_ss_n64(dp, flash90::kmajor<D>(dot, kk),
                               flash90::kmajor<D>(vt, kk), kk > 0);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(s);
        hopper::fence_regs(dp);
        const bool edge = (w0 & w1) != 0xffffffffu || qw + 64 > p.t ||
                          (p.causal && k0 + 63 > qw);
        const uint32_t mine = flash90::thread_bits(w0, w1);
        uint32_t da[4][4];
        if (edge)
          dq90::ds_tile_for<true>(s, dp, da, p, sd, bplane, bh, row0, k0,
                                  mine, lse2, dl, scale2);
        else
          dq90::ds_tile_for<false>(s, dp, da, p, sd, bplane, bh, row0, k0,
                                   mine, lse2, dl, scale2);
        // dQ += dS K: A from registers, B the staged K read MN-major, 16
        // keys a step
        hopper::wgmma_fence();
#pragma unroll
        for (int kq = 0; kq < 4; ++kq)
          hopper::wgmma_rs_tb<D>(dq, da[kq], flash90::mnmajor<D>(kt, kq), 1);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(dq);
        flash90::fence_a(da);
      }
      if (lane == 0) hopper::mbar_arrive(&empty[stage]);
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }

    // epilogue: dq times the scale, staged in the warpgroup's Q tile (no
    // longer read) and stored by TMA (rows past t dropped)
    const float mul[2] = {p.scale, p.scale};
    flash90::stage_acc<D>(qt, dq, mul);
    hopper::fence_proxy_async();
    hopper::named_sync(1 + wg, 128);
    if (threadIdx.x % 128 == 0 && live) {
      flash90::store_tile<D>(&tdq, qt, bi, hi, qw);
      hopper::bulk_commit();
      hopper::bulk_wait_read<0>();   // the tile stays until TMA has read it
    }
  }
}

// the launch of K4a's bf16 body: grid b*h * (t / 128 query blocks)
template <int D>
int launch_dq_sm90(const Params& p, cudaStream_t st) {
  BwdMaps m;
  CUtensorMap tdq;
  if (!bwd_maps<D>(p, &m) ||
      !flash90::dense_head_map<D>(&tdq, p.dq, p.b, p.h, p.t))
    return static_cast<int>(cudaErrorInvalidValue);
  // grows with t: the limit is the device's (see K3's launch_sm90)
  const int smem = dq90::Cfg<D>::SMEM + flash90::key_words_bytes(p.t);
  static std::atomic<uint64_t> smem_set{0};
  const cudaError_t rc = hopper::allow_max_dynamic_smem(
      reinterpret_cast<const void*>(bwd_dq_sm90<D>), &smem_set);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid((p.t + dq90::kQ - 1) / dq90::kQ * p.b * p.h);
  bwd_dq_sm90<D><<<grid, dq90::kThreads, smem, st>>>(
      m.q, m.k, m.v, m.dout, m.lse, m.delta, tdq, p);
  return static_cast<int>(cudaGetLastError());
}

// K5, bf16: TMA + wgmma (see the design above)
namespace db90 {
constexpr int kQ = 128;              // queries a block owns: 64 a warpgroup
constexpr int kK = flash90::kRows;   // keys a block owns
constexpr int kThreads = 384;   // consumer warpgroups 0 and 1, producer 2

template <int D>
struct Cfg {
  static constexpr int TILE = flash90::Tile<D>::TILE;
  static constexpr int STAGES = D == 128 ? 2 : 3;
  // one replica: Q and dO (two 64-row tiles each), K, V, then lse and
  // delta (128 f32 each: the 1024-byte atom)
  static constexpr int STAGE = 6 * TILE + 1024;
  // the ring, full[], empty[], each stage's (bh, key words); 1024 to
  // align the base
  static constexpr int SMEM = STAGES * STAGE + STAGES * (16 + 16) + 1024;
};

// ds of a warpgroup's [64 queries][64 keys] tile from the raw S and dP
// accumulators, added into the f32 dbias tile `acc` of the same layout
// (row row0 + 8 hh, key k0 + 8 j + 2 (lane % 4) + c at 4 j + 2 hh + c).
// bias2 holds the bias times log2 e in that layout; lse2 the rows' lse
// times log2 e.  The math of dq90::ds_tile (K4a), unrounded: EDGE a key
// is padding or the tile crosses t or the causal diagonal, DROP the hash
// dropout.  The accumulators are only read (else ptxas serialises the
// wgmmas).
template <bool EDGE, bool DROP>
__device__ __forceinline__ void ds_sum(const float (&s)[32],
                                       const float (&dp)[32],
                                       float (&acc)[32],
                                       const float (&bias2)[32],
                                       const Params& p, const Seeds& sd,
                                       int bh, int row0, int k0, uint32_t mine,
                                       const float (&lse2)[2],
                                       const float (&dl)[2], float scale2) {
  const int c2 = (threadIdx.x & 3) * 2;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hh = e >> 1, row = row0 + 8 * hh, col = k0 + 8 * j + c2 + (e & 1);
      bool ok = true;
      if (EDGE)
        ok = ((mine >> (2 * j + (e & 1))) & 1u) && row < p.t &&
             (!p.causal || col <= row);
      const float x2 = s[4 * j + e] * scale2 - lse2[hh] + bias2[4 * j + e];
      const float pv = ok ? flash90::exp2_approx(x2) : 0.f;
      float dpv = dp[4 * j + e];
      if (DROP)
        dpv = drop_keep(sd.seed, bh, sd.q_off + row, sd.k_off + col,
                        p.drop_threshold)
                  ? dpv * p.drop_scale
                  : 0.f;
      acc[4 * j + e] += pv * (dpv - dl[hh]);
    }
  }
}
}  // namespace db90

template <int D>
__global__ void __launch_bounds__(db90::kThreads, 1)
bwd_dbias_sm90(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const __grid_constant__ CUtensorMap tdo,
               const __grid_constant__ CUtensorMap tlse,
               const __grid_constant__ CUtensorMap tdelta, const Params p) {
  using T = flash90::Tile<D>;
  using C = db90::Cfg<D>;
  constexpr int STAGES = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * C::STAGE);
  uint64_t* empty = full + STAGES;
  int* meta = reinterpret_cast<int*>(empty + STAGES);   // [STAGES][4]

  // grid.x walks (lead, query block, key tile), key tiles fastest
  const int n_k = (p.t + db90::kK - 1) / db90::kK;
  const int n_q = (p.t + db90::kQ - 1) / db90::kQ;
  const int k0 = blockIdx.x % n_k * db90::kK;
  const int q0 = blockIdx.x / n_k % n_q * db90::kQ;
  const int lead = blockIdx.x / n_k / n_q;
  float* out = p.dbias + static_cast<long long>(lead) * p.t * p.t;
  if (p.causal && k0 > q0 + db90::kQ - 1) {
    // every key after every query: ds = 0, the tile's gradient is 0
    for (int i = threadIdx.x; i < db90::kQ * db90::kK; i += db90::kThreads) {
      const int row = q0 + i / db90::kK, col = k0 + i % db90::kK;
      if (row < p.t && col < p.t)
        out[static_cast<long long>(row) * p.t + col] = 0.f;
    }
    return;
  }
  if (threadIdx.x == 256) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);    // the producer's arrival
      hopper::mbar_init(&empty[s], 8);   // lane 0 of each consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {   // producer: warp 8 walks the replicas
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x < 288) {
      const int lane = threadIdx.x & 31;
      const int halves = q0 + 64 < p.t ? 2 : 1;
      const uint32_t bytes = halves * (2 * T::TILE + 2 * 64 * 4) + 2 * T::TILE;
      int stage = 0;
      uint32_t phase = 0;
      for (int rep = 0; rep < p.reps; ++rep) {
        const int bh = p.mul_l * lead + p.mul_r * rep, bi = bh / p.h,
                  hi = bh % p.h;
        const uint32_t w0 =
            __ballot_sync(0xffffffffu, key_valid(p, bi, k0 + lane));
        const uint32_t w1 =
            __ballot_sync(0xffffffffu, key_valid(p, bi, k0 + 32 + lane));
        // a key tile with no valid key is neither loaded nor computed
        // (exact: p = 0 at a masked key, so ds = 0 there)
        if ((w0 | w1) == 0) continue;
        if (lane == 0) {
          hopper::mbar_wait(&empty[stage], phase ^ 1);
          int* m = meta + 4 * stage;
          m[0] = bh;
          m[1] = static_cast<int>(w0);
          m[2] = static_cast<int>(w1);
          unsigned char* st = ring + stage * C::STAGE;
          float* rows = reinterpret_cast<float*>(st + 6 * T::TILE);
          hopper::mbar_arrive_expect_tx(&full[stage], bytes);
          for (int w = 0; w < halves; ++w) {
            const int r0 = q0 + 64 * w;
            flash90::load_tile<D>(st + w * T::TILE, &tq, &full[stage], bi, hi,
                                  r0);
            flash90::load_tile<D>(st + (2 + w) * T::TILE, &tdo, &full[stage],
                                  bi, hi, r0);
            hopper::tma_load_1d(rows + 64 * w, &tlse, &full[stage],
                                bh * p.t + r0);
            hopper::tma_load_1d(rows + 128 + 64 * w, &tdelta, &full[stage],
                                bh * p.t + r0);
          }
          flash90::load_tile<D>(st + 4 * T::TILE, &tk, &full[stage], bi, hi,
                                k0);
          flash90::load_tile<D>(st + 5 * T::TILE, &tv, &full[stage], bi, hi,
                                k0);
        }
        __syncwarp();
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      if (lane == 0) {   // the end: a stage with no replica
        hopper::mbar_wait(&empty[stage], phase ^ 1);
        meta[4 * stage] = -1;
        hopper::mbar_arrive(&full[stage]);
      }
    }
  } else {   // consumers: warpgroup wg owns queries q0 + 64 wg + [0, 64)
    hopper::setmaxnreg_inc<232>();
    const int wg = threadIdx.x / 128, warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31, c2 = (lane & 3) * 2;
    const int qw = q0 + 64 * wg;
    const bool live = qw < p.t && !(p.causal && k0 > qw + 63);
    const int r = 64 * wg + warp * 16 + (lane >> 2);   // and r + 8
    const int row0 = q0 + r;
    const Seeds sd(p);
    const float scale2 = p.scale * flash90::kLog2e;
    // the bias tile, read once for all replicas, times log2 e
    const float* bplane = bias_plane(p, lead);
    float acc[32], bias2[32];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + 8 * (e >> 1), col = k0 + 8 * j + c2 + (e & 1);
        acc[4 * j + e] = 0.f;
        bias2[4 * j + e] =
            row < p.t && col < p.t
                ? bplane[static_cast<long long>(row) * p.t + col] *
                      flash90::kLog2e
                : 0.f;
      }

    int stage = 0;
    uint32_t phase = 0;
    for (;;) {
      hopper::mbar_wait(&full[stage], phase);
      const int* m = meta + 4 * stage;
      const int bh = m[0];
      if (bh < 0) break;
      if (live) {
        const unsigned char* st = ring + stage * C::STAGE;
        const unsigned char* qt = st + wg * T::TILE;
        const unsigned char* dot = st + (2 + wg) * T::TILE;
        const unsigned char* kt = st + 4 * T::TILE;
        const unsigned char* vt = st + 5 * T::TILE;
        const float* rows = reinterpret_cast<const float*>(st + 6 * T::TILE);
        const uint32_t w0 = static_cast<uint32_t>(m[1]);
        const uint32_t w1 = static_cast<uint32_t>(m[2]);
        // S = Q K^T and dP = dO V^T: 64 queries x 64 keys, over D
        float s[32], dp[32];
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hopper::wgmma_ss_n64(s, flash90::kmajor<D>(qt, kk),
                               flash90::kmajor<D>(kt, kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hopper::wgmma_ss_n64(dp, flash90::kmajor<D>(dot, kk),
                               flash90::kmajor<D>(vt, kk), kk > 0);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(s);
        hopper::fence_regs(dp);
        const float lse2[2] = {rows[r] * flash90::kLog2e,
                               rows[r + 8] * flash90::kLog2e};
        const float dl[2] = {rows[128 + r], rows[128 + r + 8]};
        const bool edge = (w0 & w1) != 0xffffffffu || qw + 64 > p.t ||
                          (p.causal && k0 + 63 > qw);
        const uint32_t mine = flash90::thread_bits(w0, w1);
#define DB_SUM(EDGE, DROP)                                                    \
  db90::ds_sum<EDGE, DROP>(s, dp, acc, bias2, p, sd, bh, row0, k0, mine, lse2, \
                           dl, scale2)
        if (edge) {
          if (p.dropout) DB_SUM(true, true); else DB_SUM(true, false);
        } else {
          if (p.dropout) DB_SUM(false, true); else DB_SUM(false, false);
        }
#undef DB_SUM
      }
      if (lane == 0) hopper::mbar_arrive(&empty[stage]);
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    // the summed tile, straight from the accumulator layout: a warp's
    // store covers 8 rows of 32 contiguous bytes per column block
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + 8 * (e >> 1), col = k0 + 8 * j + c2 + (e & 1);
        if (row < p.t && col < p.t)
          out[static_cast<long long>(row) * p.t + col] = acc[4 * j + e];
      }
  }
}

// the launch of K5's bf16 body: grid lead * (t / 128 query blocks) * (t /
// 64 key tiles)
template <int D>
int launch_dbias_sm90(const Params& p, int lead, cudaStream_t st) {
  BwdMaps m;
  if (!bwd_maps<D>(p, &m)) return static_cast<int>(cudaErrorInvalidValue);
  static std::atomic<uint64_t> smem_set{0};
  const cudaError_t rc = hopper::allow_max_dynamic_smem(
      reinterpret_cast<const void*>(bwd_dbias_sm90<D>), &smem_set);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid((p.t + db90::kK - 1) / db90::kK *
                  ((p.t + db90::kQ - 1) / db90::kQ) * lead);
  bwd_dbias_sm90<D><<<grid, db90::kThreads, db90::Cfg<D>::SMEM, st>>>(
      m.q, m.k, m.v, m.dout, m.lse, m.delta, p);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- f32

constexpr int kT32 = 32;

// rows [r0, r0 + 32) of a [t, D] f32 head into sm[32][ld], zero past t
template <int D>
__device__ __forceinline__ void stage_rows_f32(float* sm, int ld,
                                               const float* g, int r0, int t,
                                               long long st) {
  for (int i = threadIdx.x; i < kT32 * D; i += kThreads) {
    const int r = i / D, dd = i % D;
    sm[r * ld + dd] = r0 + r < t ? g[(r0 + r) * st + dd] : 0.f;
  }
}

template <int D>
constexpr int smem_f32(int tiles_of_32) {
  return (2 * kT32 * D + 2 * kT32 * (D + 1) + tiles_of_32 * kT32 * kT32) * 4;
}

// one warp's [8][D] accumulator (lane + 32 e over d) to rows [r0, r0 + 8)
// of a contiguous [b, t, h, D] f32 tensor, times `mul`
template <int D>
__device__ __forceinline__ void store_rows_f32(void* out, const Params& p,
                                               int bi, int hi, int r0,
                                               float (*acc)[D / 32],
                                               float mul) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = r0 + i;
    if (row >= p.t) continue;
    float* orow = static_cast<float*>(out) +
                  ((static_cast<long long>(bi) * p.t + row) * p.h + hi) * D;
#pragma unroll
    for (int e = 0; e < D / 32; ++e) orow[lane + 32 * e] = acc[i][e] * mul;
  }
}

// sc[i] = x_i . ys[lane] and dc[i] = u_i . ws[lane] for the warp's 8 rows
// x_i, u_i of xs/us ([32][D]) against lane-indexed rows of ys/ws
// ([32][D + 1])
template <int D>
__device__ __forceinline__ void scores_f32(float (&sc)[8], float (&dc)[8],
                                           const float* xs, const float* us,
                                           const float* ys, const float* ws) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < 8; ++i) sc[i] = dc[i] = 0.f;
  for (int dd = 0; dd < D; ++dd) {
    const float y = ys[lane * (D + 1) + dd], w = ws[lane * (D + 1) + dd];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      sc[i] = fmaf(xs[(warp * 8 + i) * D + dd], y, sc[i]);
      dc[i] = fmaf(us[(warp * 8 + i) * D + dd], w, dc[i]);
    }
  }
}

// K4a, f32
template <int D>
__global__ void __launch_bounds__(kThreads) bwd_dq_f32(Params p) {
  constexpr int E = D / 32;
  extern __shared__ float fsm[];
  float* qs = fsm;                      // [32][D]
  float* dos = qs + kT32 * D;           // [32][D]
  float* ks = dos + kT32 * D;           // [32][D + 1]: lane-indexed rows
  float* vs = ks + kT32 * (D + 1);      // [32][D + 1]
  float* dss = vs + kT32 * (D + 1);     // [32][32]: warp w owns rows 8w..
  __shared__ int kvalid[kT32];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_q = (p.t + kT32 - 1) / kT32;
  const int bh = blockIdx.x / n_q, bi = bh / p.h, hi = bh % p.h;
  const int q0 = blockIdx.x % n_q * kT32;
  const long long head = bi * p.sb + hi * p.sh;
  const float* kg = static_cast<const float*>(p.k) + head;
  const float* vg = static_cast<const float*>(p.v) + head;
  stage_rows_f32<D>(qs, D, static_cast<const float*>(p.q) + head, q0, p.t,
                    p.st);
  stage_rows_f32<D>(dos, D,
                    static_cast<const float*>(p.dout) + dout_head(p, bi, hi, D),
                    q0, p.t, static_cast<long long>(p.h) * D);
  float lse_r[8], delta_r[8], dq[8][E];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = q0 + warp * 8 + i;
    const long long at = static_cast<long long>(bh) * p.t + row;
    lse_r[i] = row < p.t ? p.lse[at] : 0.f;
    delta_r[i] = row < p.t ? p.delta[at] : 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) dq[i][e] = 0.f;
  }
  const Seeds sd(p);
  const float* bplane =
      p.bias_mode ? bias_plane(p, bias_lead(p.bias_mode, bh, p.h)) : nullptr;

  int n_kv = (p.t + kT32 - 1) / kT32;
  if (p.causal) n_kv = min(n_kv, (q0 + kT32 - 1) / kT32 + 1);
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kT32;
    __syncthreads();
    stage_rows_f32<D>(ks, D + 1, kg, k0, p.t, p.st);
    stage_rows_f32<D>(vs, D + 1, vg, k0, p.t, p.st);
    if (threadIdx.x < kT32)
      kvalid[threadIdx.x] = key_valid(p, bi, k0 + threadIdx.x);
    __syncthreads();
    float sc[8], dc[8];
    scores_f32<D>(sc, dc, qs, dos, ks, vs);
    const int col = k0 + lane;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = q0 + warp * 8 + i;
      float pd, ds = 0.f;
      if (row < p.t && kvalid[lane] && (!p.causal || col <= row))
        ds = grad_score(p, sd, bplane, bh, row, col, sc[i], dc[i], lse_r[i],
                        delta_r[i], &pd);
      dss[(warp * 8 + i) * kT32 + lane] = ds;
    }
    __syncwarp();
    for (int c = 0; c < kT32; ++c) {   // dQ += dS K, lanes over d
      float kv[E];
#pragma unroll
      for (int e = 0; e < E; ++e) kv[e] = ks[c * (D + 1) + lane + 32 * e];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float d = dss[(warp * 8 + i) * kT32 + c];
#pragma unroll
        for (int e = 0; e < E; ++e) dq[i][e] = fmaf(d, kv[e], dq[i][e]);
      }
    }
  }
  store_rows_f32<D>(p.dq, p, bi, hi, q0 + warp * 8, dq, p.scale);
}

// K4b, f32
template <int D>
__global__ void __launch_bounds__(kThreads) bwd_dkv_f32(Params p) {
  constexpr int E = D / 32;
  extern __shared__ float fsm[];
  float* ks = fsm;                      // [32][D]: the block's keys
  float* vs = ks + kT32 * D;            // [32][D]
  float* qs = vs + kT32 * D;            // [32][D + 1]: lane-indexed queries
  float* dos = qs + kT32 * (D + 1);     // [32][D + 1]
  float* ps = dos + kT32 * (D + 1);     // [32][32] p~, warp w owns keys 8w..
  float* dss = ps + kT32 * kT32;        // [32][32] ds
  __shared__ float lse_s[kT32], delta_s[kT32];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_k = (p.t + kT32 - 1) / kT32;
  const int bh = blockIdx.x / n_k, bi = bh / p.h, hi = bh % p.h;
  const int k0 = blockIdx.x % n_k * kT32;
  const long long head = bi * p.sb + hi * p.sh;
  const float* qg = static_cast<const float*>(p.q) + head;
  const float* dog = static_cast<const float*>(p.dout) + dout_head(p, bi, hi, D);
  stage_rows_f32<D>(ks, D, static_cast<const float*>(p.k) + head, k0, p.t,
                    p.st);
  stage_rows_f32<D>(vs, D, static_cast<const float*>(p.v) + head, k0, p.t,
                    p.st);
  bool kval[8];
  float dk[8][E], dv[8][E];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    kval[i] = key_valid(p, bi, k0 + warp * 8 + i);
#pragma unroll
    for (int e = 0; e < E; ++e) dk[i][e] = dv[i][e] = 0.f;
  }
  const Seeds sd(p);
  const float* bplane =
      p.bias_mode ? bias_plane(p, bias_lead(p.bias_mode, bh, p.h)) : nullptr;

  const int n_q = (p.t + kT32 - 1) / kT32;
  for (int qi = p.causal ? k0 / kT32 : 0; qi < n_q; ++qi) {
    const int q0 = qi * kT32;
    __syncthreads();
    stage_rows_f32<D>(qs, D + 1, qg, q0, p.t, p.st);
    stage_rows_f32<D>(dos, D + 1, dog, q0, p.t, static_cast<long long>(p.h) * D);
    if (threadIdx.x < kT32) {
      const int q = q0 + threadIdx.x;
      const long long at = static_cast<long long>(bh) * p.t + q;
      lse_s[threadIdx.x] = q < p.t ? p.lse[at] : 0.f;
      delta_s[threadIdx.x] = q < p.t ? p.delta[at] : 0.f;
    }
    __syncthreads();
    float sc[8], dc[8];   // S^T and dP^T: the warp's keys against lane queries
    scores_f32<D>(sc, dc, ks, vs, qs, dos);
    const int q = q0 + lane;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int key = k0 + warp * 8 + i;
      float pd = 0.f, ds = 0.f;
      if (kval[i] && q < p.t && (!p.causal || key <= q))
        ds = grad_score(p, sd, bplane, bh, q, key, sc[i], dc[i], lse_s[lane],
                        delta_s[lane], &pd);
      ps[(warp * 8 + i) * kT32 + lane] = pd;
      dss[(warp * 8 + i) * kT32 + lane] = ds;
    }
    __syncwarp();
    for (int c = 0; c < kT32; ++c) {   // dV += p~^T dO, dK += dS^T Q
      float qv[E], ov[E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        qv[e] = qs[c * (D + 1) + lane + 32 * e];
        ov[e] = dos[c * (D + 1) + lane + 32 * e];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float pc = ps[(warp * 8 + i) * kT32 + c];
        const float dc_ = dss[(warp * 8 + i) * kT32 + c];
#pragma unroll
        for (int e = 0; e < E; ++e) {
          dv[i][e] = fmaf(pc, ov[e], dv[i][e]);
          dk[i][e] = fmaf(dc_, qv[e], dk[i][e]);
        }
      }
    }
  }
  store_rows_f32<D>(p.dk, p, bi, hi, k0 + warp * 8, dk, p.scale);
  store_rows_f32<D>(p.dv, p, bi, hi, k0 + warp * 8, dv, 1.f);
}

// K5, f32
template <int D>
__global__ void __launch_bounds__(kThreads) bwd_dbias_f32(Params p) {
  extern __shared__ float fsm[];
  float* qs = fsm;                      // [32][D]
  float* dos = qs + kT32 * D;           // [32][D]
  float* ks = dos + kT32 * D;           // [32][D + 1]
  float* vs = ks + kT32 * (D + 1);      // [32][D + 1]
  __shared__ int kvalid[kT32];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // grid.x walks (lead, query tile, key tile), key tiles fastest
  const int n_t = (p.t + kT32 - 1) / kT32;
  const int k0 = blockIdx.x % n_t * kT32, q0 = blockIdx.x / n_t % n_t * kT32;
  const int lead = blockIdx.x / n_t / n_t;
  const float* bplane = bias_plane(p, lead);
  const Seeds sd(p);
  const int col = k0 + lane;
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;

  if (!p.causal || k0 <= q0 + kT32 - 1) {
    for (int rep = 0; rep < p.reps; ++rep) {
      const int bh = p.mul_l * lead + p.mul_r * rep, bi = bh / p.h,
                hi = bh % p.h;
      const long long head = bi * p.sb + hi * p.sh;
      __syncthreads();
      stage_rows_f32<D>(qs, D, static_cast<const float*>(p.q) + head, q0, p.t,
                        p.st);
      stage_rows_f32<D>(dos, D,
                        static_cast<const float*>(p.dout) + dout_head(p, bi, hi, D),
                        q0, p.t, static_cast<long long>(p.h) * D);
      stage_rows_f32<D>(ks, D + 1, static_cast<const float*>(p.k) + head, k0,
                        p.t, p.st);
      stage_rows_f32<D>(vs, D + 1, static_cast<const float*>(p.v) + head, k0,
                        p.t, p.st);
      if (threadIdx.x < kT32)
        kvalid[threadIdx.x] = key_valid(p, bi, k0 + threadIdx.x);
      __syncthreads();
      float sc[8], dc[8];
      scores_f32<D>(sc, dc, qs, dos, ks, vs);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = q0 + warp * 8 + i;
        if (row < p.t && kvalid[lane] && (!p.causal || col <= row)) {
          const long long at = static_cast<long long>(bh) * p.t + row;
          float pd;
          acc[i] += grad_score(p, sd, bplane, bh, row, col, sc[i], dc[i],
                               p.lse[at], p.delta[at], &pd);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = q0 + warp * 8 + i;
    if (row < p.t && col < p.t)
      p.dbias[(static_cast<long long>(lead) * p.t + row) * p.t + col] = acc[i];
  }
}

// kind: 0 dQ (K4a), 1 dK/dV (K4b), 2 dbias (K5); grid per the design above
template <int D>
int launch(const Params& p, int kind, int dtype, int lead, cudaStream_t st) {
  const int bh = p.b * p.h;
  if (dtype == 1 && kind == 0) return launch_dq_sm90<D>(p, st);
  if (dtype == 1 && kind == 1) return launch_dkv_sm90<D>(p, st);
  if (dtype == 1) return launch_dbias_sm90<D>(p, lead, st);
  const int smem = smem_f32<D>(kind == 0 ? 1 : kind == 1 ? 2 : 0);
  void (*kernel)(Params) = kind == 0   ? bwd_dq_f32<D>
                           : kind == 1 ? bwd_dkv_f32<D>
                                       : bwd_dbias_f32<D>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  // one 1-D grid: (b*h or lead) x query tiles [x key tiles]
  const int n_tiles = (p.t + kT32 - 1) / kT32;
  const dim3 grid(kind == 2 ? n_tiles * n_tiles * lead : n_tiles * bh);
  kernel<<<grid, kThreads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// See the layouts above.  kind: 0 writes dq, 1 dk and dv, 2 dbias (lead
// planes; replica rep of plane l is bh = mul_l * l + mul_r * rep, reps of
// them).  dtype: 0 = f32, 1 = bf16 (q, k, v, dO and the gradients).
// kv_mask, bias and seed3 may be null (bias_mode 0, dropout 0); the dbias
// pass needs the bias.  Returns cudaGetLastError() after the launch;
// cudaErrorInvalidValue for a head_dim other than 32, 64 or 128, another
// dtype or kind, or b*h*t (rows of lse, indexed in 32 bits) or the dbias
// grid past 2^31.
extern "C" int flash_bwd(int kind, const void* q, const void* k,
                         const void* v, const void* dout, const void* lse,
                         const void* delta, const void* kv_mask,
                         const void* bias, const void* seed3, void* dq,
                         void* dk, void* dv, void* dbias, int B, int H, int T,
                         int D, long long sb, long long sh, long long st,
                         int dtype, int causal, int bias_mode, int dropout,
                         int drop_threshold, float drop_scale, float scale,
                         int lead, int reps, int mul_l, int mul_r,
                         void* stream) {
  if (B <= 0 || H <= 0 || T <= 0) return 0;
  const long long tiles32 = (T + 31) / 32;
  if ((dtype != 0 && dtype != 1) || kind < 0 || kind > 2 ||
      static_cast<long long>(B) * H * T > INT32_MAX ||
      (kind == 2 && (bias == nullptr || lead <= 0 ||
                     lead * tiles32 * tiles32 > INT32_MAX)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.kv_mask = static_cast<const int32_t*>(kv_mask);
  p.bias = static_cast<const float*>(bias);
  p.seed3 = static_cast<const int32_t*>(seed3);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.dbias = static_cast<float*>(dbias);
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
  p.reps = reps;
  p.mul_l = mul_l;
  p.mul_r = mul_r;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<32>(p, kind, dtype, lead, s);
    case 64: return launch<64>(p, kind, dtype, lead, s);
    case 128: return launch<128>(p, kind, dtype, lead, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
