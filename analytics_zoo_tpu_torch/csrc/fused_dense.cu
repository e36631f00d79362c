// Fused dense + bias + tanh-GELU for Hopper (sm_90a):
//     out = gelu_tanh(x @ w^T + b)
//
// Replaces the TPU kernel `_mm_kernel` / `_mm_fwd` in
// analytics_zoo_tpu/ops/pallas/fused_dense.py (pallas_call at :84) and
// computes what it computes: an f32-accumulated product, the bias added
// in f32, the tanh-form GELU in f32 (`_gelu_tanh` :42), then ONE cast to
// the output dtype.  The [m, n] pre-activation never reaches device
// memory: the epilogue runs on the accumulator registers before the
// single store, which is the point of the TPU kernel.
//
// Layouts: x [m, k] and w [n, k] (PyTorch's Linear weight, out x in),
// both row-major with unit stride in k; b [n]; out [m, n].  Any m, k
// and n: tiles on the ragged edges are zero-filled on load and masked on
// store, so no shape needs a divisor of the tile sizes.
//
// Bound.  bf16 at the serving shape m = 32*512, k = 768, n = 3072:
// 2*m*k*n = 77.3 GFLOP, about 78 us at 989 TFLOP/s, against about 39 us
// for the 131 MB it must move (x, w, b read once, out written once) at
// 3.35 TB/s: compute-bound, so the design aims at the tensor cores, and
// only wgmma reaches their full rate.
//
// Three bodies of one kernel; the caller (ops/kernels/fused_dense.py)
// picks one by dtype and layout and counts its launches per body:
//   * sm90 (bf16, k % 8 == 0, n % 8 == 0, 16-byte aligned x, w and out:
//     what TMA takes).  A persistent grid, one block per SM, walks 128 x
//     256 output tiles (n = 3072 is 12 of them).  One producer thread
//     issues the TMA loads, 64 deep in k (128-byte swizzle), into a ring
//     of 3 stages of 48 KB with full and empty mbarriers; two consumer
//     warpgroups each run wgmma m64n256k16 on 64 of the tile's rows from
//     shared memory into 128 f32 registers a thread, releasing a stage as
//     soon as the products that read it are done.  setmaxnreg gives the
//     consumers 232 registers and the producer 40.  The producer runs up to 3 stages ahead, so one
//     tile's epilogue overlaps the next tile's loads.  The epilogue writes
//     each warpgroup's 64 x 256 outputs as bf16 into shared memory
//     (128-byte swizzled: no bank conflicts from the accumulator layout)
//     and one thread stores them by TMA, which runs on behind the next
//     tile's products: stored straight from the accumulator layout (4
//     bytes a thread, 8 rows an instruction) the output took longer than
//     the products themselves.  What is left is the epilogue's GELU (two
//     SFU operations an element) while the tensor cores wait.  Ragged
//     edges: TMA fills rows and k past the edge with zeros on load and
//     drops them on store.  The epilogue takes 0.5 (1 + tanh u) as
//     1 / (1 + exp(-2u)), the same function with one exp and a fast
//     division instead of tanhf's longer sequence (it agrees with the
//     tanh form to about 1e-6, far inside one bf16 ulp).
//   * cp_async (bf16 shapes TMA cannot take: k or n % 8 != 0, or a base
//     that is not 16-byte aligned): 128 x 128 tiles, 8 warps of mma.sync
//     m16n8k16, x and w staged 32 deep in k through a two-stage cp.async
//     ring (16-byte copies where aligned, element loads on the edges).
//   * f32: 128 x 128 tile per block of 256 threads, 8 deep in k through
//     shared memory, each thread an 8 x 8 block of outputs by FFMA.  Never
//     TF32: the TPU kernel asks Precision.HIGHEST for f32, and a TF32
//     wgmma would change the numbers.
// Each epilogue applies + b, GELU and one cast to the f32 accumulator
// registers before the single store.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kSqrt2OverPi = 0.7978845608028654f;

__device__ __forceinline__ float gelu_tanh(float y) {
  return 0.5f * y * (1.0f + tanhf(kSqrt2OverPi * (y + 0.044715f * (y * y * y))));
}

// ------------------------------------------------------- bf16, cp.async

constexpr int BM = 128, BN = 128, BK = 32, PAD = 8, LDS = BK + PAD;
constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
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

// Stage rows [r0, r0 + 128) x cols [k0, k0 + 32) of a row-major
// [rows, k] bf16 matrix into sm[128][LDS]; out-of-range elements are 0.
// `vec` says every row start is 16-byte aligned (k % 8 == 0 and an
// aligned base), so a whole in-range 8-element chunk is one cp.async.
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* sm,
                                           const __nv_bfloat16* g, int rows,
                                           int k, int r0, int k0, bool vec) {
  // 128 rows x 4 chunks of 8 = 512 chunks, two per thread
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    const int c = threadIdx.x + it * kThreads;
    const int r = c >> 2, kc = (c & 3) * 8;
    __nv_bfloat16* dst = sm + r * LDS + kc;
    const int gr = r0 + r, gk = k0 + kc;
    if (vec && gr < rows && gk + 8 <= k) {
      cp_async16(dst, g + (long long)gr * k + gk);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = (gr < rows && gk + e < k) ? g[(long long)gr * k + gk + e]
                                           : __float2bfloat16(0.f);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
dense_gelu_bf16(const __nv_bfloat16* __restrict__ x,
                const __nv_bfloat16* __restrict__ w,
                const __nv_bfloat16* __restrict__ b,
                __nv_bfloat16* __restrict__ out, int m, int n, int k,
                int vec) {
  __shared__ __align__(16) __nv_bfloat16 xs[2][BM * LDS];
  __shared__ __align__(16) __nv_bfloat16 ws[2][BN * LDS];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp >> 2) * 64;   // warp's rows in the tile
  const int wn = (warp & 3) * 32;    // warp's cols in the tile
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int nk = (k + BK - 1) / BK;
  stage_bf16(xs[0], x, m, k, m0, 0, vec);
  stage_bf16(ws[0], w, n, k, n0, 0, vec);
  cp_async_commit();

  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    cp_async_wait_all();
    __syncthreads();   // tile kt landed; everyone is done with kt - 1
    if (kt + 1 < nk) {   // copy tile kt + 1 while tile kt is multiplied
      stage_bf16(xs[cur ^ 1], x, m, k, m0, (kt + 1) * BK, vec);
      stage_bf16(ws[cur ^ 1], w, n, k, n0, (kt + 1) * BK, vec);
    }
    cp_async_commit();
    const __nv_bfloat16* xt = xs[cur];
    const __nv_bfloat16* wt = ws[cur];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[4][4], bfr[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4(af[i], xt + (wm + i * 16 + (lane & 15)) * LDS + kk +
                               (lane >> 4) * 8);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp)
        ldmatrix_x4(bfr[jp], wt + (wn + jp * 16 + (lane & 7) +
                                   (lane >> 4) * 8) * LDS +
                                 kk + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(acc[i][j], af[i], bfr[j >> 1][(j & 1) * 2],
                   bfr[j >> 1][(j & 1) * 2 + 1]);
    }
  }

  // epilogue: + b, GELU, one cast, one store
  const bool pair_ok = (n & 1) == 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + wn + j * 8 + (lane & 3) * 2;
    const float b0 = col < n ? __bfloat162float(b[col]) : 0.f;
    const float b1 = col + 1 < n ? __bfloat162float(b[col + 1]) : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = m0 + wm + i * 16 + (lane >> 2) + hh * 8;
        if (row >= m) continue;
        const float y0 = gelu_tanh(acc[i][j][hh * 2] + b0);
        const float y1 = gelu_tanh(acc[i][j][hh * 2 + 1] + b1);
        __nv_bfloat16* o = out + (long long)row * n + col;
        if (pair_ok && col + 1 < n) {
          *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(y0, y1);
        } else {
          if (col < n) o[0] = __float2bfloat16(y0);
          if (col + 1 < n) o[1] = __float2bfloat16(y1);
        }
      }
    }
  }
}

// ---------------------------------------------------------------- bf16, sm90

namespace sm90 {
constexpr int BM = 128, BN = 256, BK = 64, STAGES = 3;
constexpr int A_BYTES = BM * BK * 2, B_BYTES = BN * BK * 2;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int kThreads = 384;   // consumer warpgroups 0 and 1, producer 2
// the output tile staged for its TMA store: per consumer warpgroup 4
// boxes of [64 rows][64 columns] bf16, 128-byte swizzled
constexpr int OUT_BOX = 64 * 64 * 2;
constexpr int OUT_BYTES = 2 * (BN / 64) * OUT_BOX;
constexpr int SMEM = STAGES * STAGE_BYTES + OUT_BYTES + 2 * STAGES * 8 + 1024;
// a 64-element (128-byte) row of a tile; 8 rows make the swizzle atom
constexpr uint32_t ROW = BK * 2, ATOM = 8 * ROW;

// 0.5 y (1 + tanh u) written as y / (1 + exp(-2u))
__device__ __forceinline__ float gelu_tanh_fast(float y) {
  const float u = kSqrt2OverPi * (y + 0.044715f * (y * y * y));
  return __fdividef(y, 1.0f + __expf(-2.0f * u));
}

__global__ void __launch_bounds__(kThreads, 1)
dense_gelu_sm90(const __grid_constant__ CUtensorMap tx,
                const __grid_constant__ CUtensorMap tw,
                const __grid_constant__ CUtensorMap tout,
                const __nv_bfloat16* __restrict__ b, int m, int n, int k) {
  extern __shared__ unsigned char smem_raw[];
  // TMA's 128-byte swizzle repeats every 1024 bytes: align the ring to it
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* outs = ring + STAGES * STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(outs + OUT_BYTES);
  uint64_t* empty = full + STAGES;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);    // the producer's expect_tx arrival
      hopper::mbar_init(&empty[s], 8);   // lane 0 of each consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  // tile t is m-tile t / n_tiles and n-tile t % n_tiles
  const int n_tiles = (n + BN - 1) / BN;
  const int tiles = (m + BM - 1) / BM * n_tiles;
  const int kb = (k + BK - 1) / BK;

  if (wg == 2) {   // producer: one thread keeps the ring full
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / n_tiles * BM, n0 = tile % n_tiles * BN;
        for (int kk = 0; kk < kb; ++kk) {
          hopper::mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* st = ring + stage * STAGE_BYTES;
          hopper::mbar_arrive_expect_tx(&full[stage], STAGE_BYTES);
          hopper::tma_load_2d(st, &tx, &full[stage], kk * BK, m0);
          hopper::tma_load_2d(st + A_BYTES, &tw, &full[stage], kk * BK, n0);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {   // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64)
    hopper::setmaxnreg_inc<232>();
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int layout = hopper::swizzle_layout(128);
    int stage = 0;
    uint32_t phase = 0;
    float acc[128];
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile / n_tiles * BM, n0 = tile % n_tiles * BN;
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.f;
      int prev = -1;
      for (int kk = 0; kk < kb; ++kk) {
        hopper::mbar_wait(&full[stage], phase);
        const unsigned char* st = ring + stage * STAGE_BYTES;
        hopper::wgmma_fence();
#pragma unroll
        for (int j = 0; j < BK / 16; ++j) {   // 16 deep per wgmma: 32 bytes
          const uint64_t da = hopper::make_desc(st + wg * 64 * ROW + j * 32,
                                                16, ATOM, layout);
          const uint64_t db = hopper::make_desc(st + A_BYTES + j * 32, 16,
                                                ATOM, layout);
          hopper::wgmma_ss_n256(acc, da, db, 1);
        }
        hopper::wgmma_commit();
        // the previous k-step's products have read their stage: free it
        hopper::wgmma_wait<1>();
        if (prev >= 0 && lane == 0) hopper::mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      if (prev >= 0 && lane == 0) hopper::mbar_arrive(&empty[prev]);

      // epilogue: + b, GELU, one cast, staged in shared memory and stored
      // by TMA, which runs on behind the next tile's products
      unsigned char* ot = outs + wg * (BN / 64) * OUT_BOX;
      const bool issuer = threadIdx.x % 128 == 0;
      if (issuer) hopper::bulk_wait_read<0>();   // the last store read ot
      hopper::named_sync(1 + wg, 128);
      const int g = lane >> 2, c = lane & 3;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + j * 8 + c * 2;
        const float b0 = col < n ? __bfloat162float(b[col]) : 0.f;
        const float b1 = col + 1 < n ? __bfloat162float(b[col + 1]) : 0.f;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = warp * 16 + g + hh * 8;   // r % 8 == g
          __nv_bfloat162 v = __floats2bfloat162_rn(
              gelu_tanh_fast(acc[4 * j + 2 * hh] + b0),
              gelu_tanh_fast(acc[4 * j + 2 * hh + 1] + b1));
          *reinterpret_cast<__nv_bfloat162*>(
              ot + j / 8 * OUT_BOX + r * 128 + ((j % 8) ^ g) * 16 + c * 4) = v;
        }
      }
      hopper::fence_proxy_async();
      hopper::named_sync(1 + wg, 128);
      if (issuer && m0 + wg * 64 < m) {
        for (int box = 0; box < BN / 64 && n0 + box * 64 < n; ++box)
          hopper::tma_store_2d(&tout, ot + box * OUT_BOX, n0 + box * 64,
                               m0 + wg * 64);
        hopper::bulk_commit();
      }
    }
    if (threadIdx.x % 128 == 0) hopper::bulk_wait<0>();
  }
}

// the tensor maps of x, w and out and the persistent launch
int launch(const void* x, const void* w, const void* b, void* out, int m,
           int n, int k, cudaStream_t st) {
  CUtensorMap tx, tw, tout;
  const uint64_t row_bytes[1] = {static_cast<uint64_t>(k) * 2};
  const uint64_t x_size[2] = {static_cast<uint64_t>(k),
                              static_cast<uint64_t>(m)};
  const uint64_t w_size[2] = {static_cast<uint64_t>(k),
                              static_cast<uint64_t>(n)};
  const uint32_t x_box[2] = {BK, BM}, w_box[2] = {BK, BN};
  const uint64_t out_size[2] = {static_cast<uint64_t>(n),
                                static_cast<uint64_t>(m)};
  const uint64_t out_row[1] = {static_cast<uint64_t>(n) * 2};
  const uint32_t out_box[2] = {64, 64};
  if (!hopper::make_tensor_map(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x,
                               x_size, row_bytes, x_box,
                               CU_TENSOR_MAP_SWIZZLE_128B) ||
      !hopper::make_tensor_map(&tw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w,
                               w_size, row_bytes, w_box,
                               CU_TENSOR_MAP_SWIZZLE_128B) ||
      !hopper::make_tensor_map(&tout, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, out,
                               out_size, out_row, out_box,
                               CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncSetAttribute(dense_gelu_sm90,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  // persistent: at most one block per SM, never a second wave
  const int tiles = (m + BM - 1) / BM * ((n + BN - 1) / BN);
  const int sms = hopper::sm_count();
  dense_gelu_sm90<<<tiles < sms ? tiles : sms, kThreads, SMEM, st>>>(
      tx, tw, tout, static_cast<const __nv_bfloat16*>(b), m, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90

// ---------------------------------------------------------------- f32

constexpr int FBM = 128, FBN = 128, FBK = 8;

__global__ void __launch_bounds__(kThreads)
dense_gelu_f32(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ b, float* __restrict__ out, int m,
               int n, int k) {
  __shared__ float xs[FBK][FBM];   // x tile, transposed: [k][row]
  __shared__ float ws[FBK][FBN];   // w tile, transposed: [k][col]
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int m0 = blockIdx.y * FBM, n0 = blockIdx.x * FBN;
  // thread owns rows ty + 16 i and cols tx + 16 j: smem reads are
  // broadcasts (x) and 16 consecutive words (w), free of conflicts
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += FBK) {
    // 128 rows x 8 k = 1024 elements of each tile, 4 per thread; the 8
    // threads of a row read its 8 consecutive k values
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int e = threadIdx.x + it * kThreads;
      const int r = e >> 3, kk = e & 7;
      const int gk = k0 + kk;
      xs[kk][r] = (m0 + r < m && gk < k) ? x[(long long)(m0 + r) * k + gk] : 0.f;
      ws[kk][r] = (n0 + r < n && gk < k) ? w[(long long)(n0 + r) * k + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FBK; ++kk) {
      float xv[8], wv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) xv[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) wv[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = n0 + tx + 16 * j;
    if (col >= n) continue;
    const float bj = b[col];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = m0 + ty + 16 * i;
      if (row < m) out[(long long)row * n + col] = gelu_tanh(acc[i][j] + bj);
    }
  }
}

}  // namespace

// x [m, k], w [n, k], b [n], out [m, n], all contiguous.  body: 0 = f32
// (FFMA), 1 = bf16 cp.async, 2 = bf16 sm90 (TMA + wgmma; k % 8 == 0,
// n % 8 == 0 and 16-byte aligned x, w and out, else
// cudaErrorInvalidValue).  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for another
// body).
extern "C" int fused_dense_gelu(const void* x, const void* w, const void* b,
                                void* out, int m, int n, int k, int body,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= 0 || n <= 0) return 0;
  const bool aligned = (k % 8 == 0) &&
                       (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(w) % 16 == 0);
  if (body == 2) {
    if (!aligned || n % 8 != 0 ||
        reinterpret_cast<uintptr_t>(out) % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    return sm90::launch(x, w, b, out, m, n, k, st);
  }
  if (body == 1) {
    const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
    dense_gelu_bf16<<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w),
        static_cast<const __nv_bfloat16*>(b),
        static_cast<__nv_bfloat16*>(out), m, n, k, aligned ? 1 : 0);
  } else if (body == 0) {
    const dim3 grid((n + FBN - 1) / FBN, (m + FBM - 1) / FBM);
    dense_gelu_f32<<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(b), static_cast<float*>(out), m, n, k);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
