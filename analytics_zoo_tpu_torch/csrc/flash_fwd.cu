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
// Bound.  The two products are 4 h d t flops per valid key of each batch
// row.  At b = 32, h = 12, t = 512, d = 64 in bf16 that is 25.8 GFLOP
// with every key valid (26 us at 989 TFLOP/s) and 18.0 GFLOP on the
// fine-tune's traffic (11,403 of 16,384 keys valid, 18 us), against 30
// us for the 101 MB of q, k, v and out at 3.35 TB/s: bytes bound it.
//
// bf16: `flash_fwd_sm90<D>`, TMA + wgmma (the bf16 body; every layout
// ops/kernels/flash_attention.py admits is one TMA takes):
//   * one block per (b*h, 128 query rows), three warpgroups: one
//     producer thread and two consumer warpgroups of 64 rows each.  At
//     d <= 64 two blocks share an SM (launched at 80 registers a thread;
//     setmaxnreg gives the consumers 104 and the producer 24), so one
//     block's loads, prologue and epilogue overlap the other's work: a
//     block holds only a few tiles at t = 512, and with one block an SM
//     the latency of its loads, not its products, took much of its time.
//     At d = 128 one block an SM, consumers 232, producer 40;
//   * the producer loads the block's Q once, then streams 64-key K and V
//     tiles through a 3-stage ring, all by TMA (4-D tensor maps over the
//     views' strides, flash_sm90.cuh; 128-byte swizzle, 64-byte at d =
//     32), completing on full / empty mbarriers;
//   * padded-key-tile skip: the kv_mask is per batch row, so every query
//     row of a block sees the same key validity.  The block first packs
//     its row of the mask into bit words in shared memory (the one read
//     of the mask); a 64-key tile with no valid key is neither loaded nor
//     computed.  Exact: such a tile leaves m, l and O unchanged (p = 0 at
//     every masked key), and a fully padded row still gives zeros and an
//     lse of -1e30.  Causal: tiles past the block's last row are never
//     loaded, and a warpgroup whose rows all precede a tile skips it;
//   * each consumer warpgroup: S = Q K^T by wgmma m64n64k16 from shared
//     memory, both K-major; the online softmax in registers in log2
//     space (scale * log2e folded into one FFMA, exp2 on the SFU's
//     ex2.approx.ftz; the running max in log2 units, turned into a
//     natural-log lse only for rows that saw a valid key, so a fully
//     masked row keeps -1e30 and not -1e30 ln 2); then the bias, the
//     causal edge and the hash dropout as the TPU kernel applies them,
//     specialised per tile (a tile whose keys are all valid and that no
//     edge crosses takes no per-element mask); P repacked from the S
//     accumulator straight into bf16 A registers; O += P V by wgmma RS,
//     V read MN-major;
//   * ptxas serialises the wgmmas (notes C7515, C7513 in the -Xptxas -v
//     log) when a non-wgmma instruction writes an accumulator while a
//     group is in flight.  The softmax only reads S, and O is rescaled
//     by alpha only after the tile's S product has been waited for,
//     which also waits for the tile before's P V.  The two warpgroups
//     share each stage, so one's products overlap the other's softmax;
//   * epilogue: O times 1 / max(l, 1e-20), as bf16 into the warpgroup's
//     own Q tile (swizzled, conflict-free writes) and out by one TMA
//     store; lse per row in natural log;
//   * registers and spills (-Xptxas -v, sm_90a): d = 32, 80 at
//     launch, no spill; d = 64, 80 at launch, 40 bytes of spill
//     stores and 44 of loads (the consumers' 104 registers are a few
//     short; recomputing the bias path's scores in place of holding them
//     spilled more and ran slower); d = 128, 168, no spill.  Shared
//     memory 2 + 6 tiles of 64 rows (64 KB at d = 64, 128 KB at d =
//     128) and t / 8 bytes of mask words.
// f32: no TF32 (the TPU kernel takes Precision.HIGHEST for f32): 32
// query rows, 4 warps of 8 rows, lanes over 32-key tiles for the scores
// and over d for the output, FFMA throughout.
// head_dim 32, 64 or 128 (template); others are refused.

#include "flash_sm90.cuh"

namespace {

using flash::bias_lead;
using flash::drop_keep;
using flash::kNegInf;
using flash::Seeds;
using flash::shfl_max;
using flash::shfl_sum;

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

namespace fwd90 {
constexpr int kQ = 128;                // query rows a block owns
constexpr int kK = flash90::kRows;     // keys a tile
constexpr int STAGES = 3;
constexpr int kThreads = 384;   // consumer warpgroups 0 and 1, producer 2

template <int D>
struct Cfg {
  // blocks an SM, and the registers setmaxnreg gives a consumer and a
  // producer thread: at d <= 64 two blocks share an SM, each with the
  // 80 x 384 registers of its launch (24 x 128 + 104 x 256 fit), so one
  // block's loads, prologue and epilogue overlap the other's products
  static constexpr int BLOCKS = D <= 64 ? 2 : 1;
  static constexpr int CONSUMER_REGS = D <= 64 ? 104 : 232;
  static constexpr int PRODUCER_REGS = D <= 64 ? 24 : 40;
  static constexpr int TILE = flash90::Tile<D>::TILE;
  static constexpr int Q = 2 * TILE;       // the 128 query rows, then out
  static constexpr int STAGE = 2 * TILE;   // a K and a V tile
  // the ring, then q_full, full[], empty[], then the key words
  // (flash90::key_words_bytes(t) more, at launch); 1024 to align the base
  static constexpr int SMEM =
      Q + STAGES * STAGE + (1 + 2 * STAGES) * 8 + 1024;
};

// one tile of the online softmax for a warpgroup's 64 rows x 64 keys:
// from the raw S accumulator (only read), the new running max m2 (log2
// units), the rescale alpha of the old O and l, l's per-thread partial
// sums, and P (dropped and rescaled) rounded to bf16 straight into the A
// operands of O += P V.  Each thread holds rows row0, row0 + 8 and keys
// k0 + 8 j + 2 (lane % 4) + {0, 1}; the pair of key block j, row half hh
// is A register [j / 2][2 (j % 2) + hh].  EDGE: a key of the tile is
// padding, or the tile crosses the causal diagonal or t (else every
// element is valid); BIAS, DROP as the call asks.
template <bool EDGE, bool BIAS, bool DROP>
__device__ __forceinline__ void softmax_tile(
    const float (&s)[32], uint32_t (&pa)[4][4], float (&m2)[2],
    float (&l)[2], float (&alpha)[2], const Params& p, const Seeds& sd,
    const float* bplane, int bh, int row0, int k0, uint32_t mine,
    float scale2) {
  const int c2 = (threadIdx.x & 3) * 2;
  auto valid = [&](int j, int c, int row, int col) {
    return !EDGE || (((mine >> (2 * j + c)) & 1u) && row < p.t &&
                     (!p.causal || col <= row));
  };
  float x[BIAS ? 32 : 1];   // scores in log2 units, -inf where masked
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hh = e >> 1, row = row0 + 8 * hh;
      const int col = k0 + 8 * j + c2 + (e & 1);
      const bool ok = valid(j, e & 1, row, col);
      float v = s[4 * j + e];
      if (BIAS) {
        v = ok ? fmaf(v, scale2,
                      bplane[static_cast<long long>(row) * p.t + col] *
                          flash90::kLog2e)
               : -INFINITY;
        x[4 * j + e] = v;
      } else if (EDGE) {
        v = ok ? v : -INFINITY;
      }
      mx[hh] = fmaxf(mx[hh], v);
    }
  }
  // scale2 > 0, so the max of the raw scores times scale2 is the max of
  // the scaled ones; a row with no valid key so far keeps m2 = -1e30
  float mn[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float v = shfl_max(mx[hh], 2);
    mn[hh] = fmaxf(m2[hh], BIAS ? v : v * scale2);
    alpha[hh] = flash90::exp2_approx(m2[hh] - mn[hh]);
    m2[hh] = mn[hh];
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + 8 * hh;
      float pd[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = 2 * hh + c, col = k0 + 8 * j + c2 + c;
        float pv;
        if (BIAS) {
          pv = flash90::exp2_approx(x[4 * j + e] - mn[hh]);   // 2^-inf = 0
        } else {
          pv = flash90::exp2_approx(fmaf(s[4 * j + e], scale2, -mn[hh]));
          if (EDGE) pv = valid(j, c, row, col) ? pv : 0.f;
        }
        rs[hh] += pv;   // the denominator sums undropped probabilities
        if (DROP)
          pv = drop_keep(sd.seed, bh, sd.q_off + row, sd.k_off + col,
                         p.drop_threshold)
                   ? pv * p.drop_scale
                   : 0.f;
        pd[c] = pv;
      }
      pa[j / 2][2 * (j % 2) + hh] = flash::pack_bf16(pd[0], pd[1]);
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * alpha[hh] + rs[hh];
}

template <bool EDGE>
__device__ __forceinline__ void softmax_for(
    const float (&s)[32], uint32_t (&pa)[4][4], float (&m2)[2],
    float (&l)[2], float (&alpha)[2], const Params& p, const Seeds& sd,
    const float* bplane, int bh, int row0, int k0, uint32_t mine,
    float scale2) {
#define FWD_TILE(BIAS, DROP)                                              \
  softmax_tile<EDGE, BIAS, DROP>(s, pa, m2, l, alpha, p, sd, bplane, bh, \
                                 row0, k0, mine, scale2)
  if (p.dropout) {
    if (bplane != nullptr) FWD_TILE(true, true); else FWD_TILE(false, true);
  } else {
    if (bplane != nullptr) FWD_TILE(true, false); else FWD_TILE(false, false);
  }
#undef FWD_TILE
}
}  // namespace fwd90

template <int D>
__global__ void __launch_bounds__(fwd90::kThreads, fwd90::Cfg<D>::BLOCKS)
flash_fwd_sm90(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const __grid_constant__ CUtensorMap tout, const Params p) {
  using T = flash90::Tile<D>;
  using C = fwd90::Cfg<D>;
  using fwd90::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* ring = qs + C::Q;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + STAGES * C::STAGE);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;
  uint32_t* words = reinterpret_cast<uint32_t*>(empty + STAGES);

  // grid.x walks the query blocks of each head in turn (b*h may pass
  // grid.y's 65535)
  const int n_q = (p.t + fwd90::kQ - 1) / fwd90::kQ;
  const int bh = blockIdx.x / n_q, bi = bh / p.h, hi = bh % p.h;
  const int q0 = blockIdx.x % n_q * fwd90::kQ;
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
    hopper::mbar_arrive_expect_tx(q_full, halves * T::TILE);
    for (int w = 0; w < halves; ++w)
      flash90::load_tile<D>(qs + w * T::TILE, &tq, q_full, bi, hi,
                            q0 + 64 * w);
  }
  flash90::key_words(words, p.kv_mask, bi, p.t);
  __syncthreads();
  int n_kv = (p.t + fwd90::kK - 1) / fwd90::kK;
  if (p.causal) n_kv = min(n_kv, (q0 + fwd90::kQ - 1) / fwd90::kK + 1);

  if (threadIdx.x >= 256) {   // producer: one thread issues every load
    hopper::setmaxnreg_dec<C::PRODUCER_REGS>();
    if (threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int j = 0; j < n_kv; ++j) {
        if ((words[2 * j] | words[2 * j + 1]) == 0) continue;   // padding
        hopper::mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* st = ring + stage * C::STAGE;
        hopper::mbar_arrive_expect_tx(&full[stage], C::STAGE);
        flash90::load_tile<D>(st, &tk, &full[stage], bi, hi, j * fwd90::kK);
        flash90::load_tile<D>(st + T::TILE, &tv, &full[stage], bi, hi,
                              j * fwd90::kK);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {   // consumers: warpgroup wg owns rows q0 + 64 wg + [0, 64)
    hopper::setmaxnreg_inc<C::CONSUMER_REGS>();
    const int wg = threadIdx.x / 128, warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    const int qw = q0 + 64 * wg;
    const bool live = qw < p.t;
    const int row0 = qw + warp * 16 + (lane >> 2);   // and row0 + 8
    unsigned char* qt = qs + wg * T::TILE;
    const Seeds sd(p);
    const float* bplane = bias_plane(p, bh);
    const float scale2 = p.scale * flash90::kLog2e;
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m2[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

    int stage = 0;
    uint32_t phase = 0;
    hopper::mbar_wait(q_full, 0);
    for (int j = 0; j < n_kv; ++j) {
      const uint32_t w0 = words[2 * j], w1 = words[2 * j + 1];
      if ((w0 | w1) == 0) continue;   // never loaded: the producer skips it
      const int k0 = j * fwd90::kK;
      hopper::mbar_wait(&full[stage], phase);
      if (live && !(p.causal && k0 > qw + 63)) {
        const unsigned char* kt = ring + stage * C::STAGE;
        const unsigned char* vt = kt + T::TILE;
        float s[32];
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hopper::wgmma_ss_n64(s, flash90::kmajor<D>(qt, kk),
                               flash90::kmajor<D>(kt, kk), kk > 0);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(s);
        const bool edge = (w0 & w1) != 0xffffffffu || qw + 64 > p.t ||
                          (p.causal && k0 + 63 > qw);
        const uint32_t mine = flash90::thread_bits(w0, w1);
        uint32_t pa[4][4];
        float alpha[2];
        if (edge)
          fwd90::softmax_for<true>(s, pa, m2, l, alpha, p, sd, bplane, bh,
                                   row0, k0, mine, scale2);
        else
          fwd90::softmax_for<false>(s, pa, m2, l, alpha, p, sd, bplane, bh,
                                    row0, k0, mine, scale2);
        // no wgmma is in flight here (this tile's S and the tile before's
        // P V have been waited for), so the rescale serialises nothing
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
        hopper::wgmma_fence();
#pragma unroll
        for (int kq = 0; kq < 4; ++kq)
          hopper::wgmma_rs_tb<D>(o, pa[kq], flash90::mnmajor<D>(vt, kq), 1);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(o);
        flash90::fence_a(pa);
      }
      if (lane == 0) hopper::mbar_arrive(&empty[stage]);
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }

    // epilogue: the warpgroup's Q tile is no longer read; stage O there
    // and store it by TMA (rows past t dropped)
    float lt[2], inv[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      lt[hh] = shfl_sum(l[hh], 2);
      inv[hh] = 1.f / fmaxf(lt[hh], 1e-20f);
    }
    flash90::stage_acc<D>(qt, o, inv);
    hopper::fence_proxy_async();
    hopper::named_sync(1 + wg, 128);
    if (threadIdx.x % 128 == 0 && live) {
      flash90::store_tile<D>(&tout, qt, bi, hi, qw);
      hopper::bulk_commit();
      hopper::bulk_wait_read<0>();   // the tile stays until TMA has read it
    }
    if ((lane & 3) == 0) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = row0 + 8 * hh;
        // a row that saw no valid key keeps the -1e30 of the TPU kernel
        // (-1e30 + log(1e-20) in f32); converting its m2 by ln 2 would not
        if (row < p.t)
          p.lse[static_cast<long long>(bh) * p.t + row] =
              m2[hh] == kNegInf
                  ? kNegInf
                  : m2[hh] * flash90::kLn2 + logf(fmaxf(lt[hh], 1e-20f));
      }
    }
  }
}

// the tensor maps of q, k, v and out, and the launch of the bf16 body:
// grid b*h * (t / 128 query blocks)
template <int D>
int launch_sm90(const Params& p, cudaStream_t st) {
  CUtensorMap tq, tk, tv, tout;
  if (!flash90::head_map<D>(&tq, p.q, p.b, p.h, p.t, p.sb, p.sh, p.st) ||
      !flash90::head_map<D>(&tk, p.k, p.b, p.h, p.t, p.sb, p.sh, p.st) ||
      !flash90::head_map<D>(&tv, p.v, p.b, p.h, p.t, p.sb, p.sh, p.st) ||
      !flash90::dense_head_map<D>(&tout, p.out, p.b, p.h, p.t))
    return static_cast<int>(cudaErrorInvalidValue);
  // the size grows with t, and launches at two t may come from two host
  // threads at once: the limit is the device's, not this launch's
  const int smem = fwd90::Cfg<D>::SMEM + flash90::key_words_bytes(p.t);
  static std::atomic<uint64_t> smem_set{0};
  const cudaError_t rc = hopper::allow_max_dynamic_smem(
      reinterpret_cast<const void*>(flash_fwd_sm90<D>), &smem_set);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid((p.t + fwd90::kQ - 1) / fwd90::kQ * p.b * p.h);
  flash_fwd_sm90<D><<<grid, fwd90::kThreads, smem, st>>>(tq, tk, tv, tout, p);
  return static_cast<int>(cudaGetLastError());
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
  const int n_q = (p.t + kBQ32 - 1) / kBQ32;
  const int bh = blockIdx.x / n_q, bi = bh / p.h, hi = bh % p.h;
  const int q0 = blockIdx.x % n_q * kBQ32;
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
  if (dtype == 1) return launch_sm90<D>(p, st);
  const int smem = smem_f32<D>();
  cudaFuncSetAttribute(flash_fwd_f32<D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((p.t + kBQ32 - 1) / kBQ32 * p.b * p.h);
  flash_fwd_f32<D><<<grid, 128, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// See the layouts above.  dtype: 0 = f32, 1 = bf16 (q, k, v and out);
// kv_mask, bias and seed3 may be null (bias_mode 0, dropout 0).
// Returns cudaGetLastError() after the launch; cudaErrorInvalidValue for
// a head_dim other than 32, 64 or 128, another dtype, b*h*t past 2^31
// (the bodies index rows of the [b*h, t] lse in 32 bits), or bf16 views
// whose tensor maps the driver refuses.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const void* kv_mask, const void* bias,
                         const void* seed3, void* out, void* lse, int B,
                         int H, int T, int D, long long sb, long long sh,
                         long long st, int dtype, int causal, int bias_mode,
                         int dropout, int drop_threshold, float drop_scale,
                         float scale, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0) return 0;
  if ((dtype != 0 && dtype != 1) ||
      static_cast<long long>(B) * H * T > INT32_MAX)
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
