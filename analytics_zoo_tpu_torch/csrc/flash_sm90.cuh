// Pieces the Hopper (sm_90a) flash-attention bodies share: K3's
// flash_fwd_sm90 (flash_fwd.cu), K4a's bwd_dq_sm90, K4b's bwd_dkv_sm90 and
// K5's bwd_dbias_sm90 (flash_bwd.cu).  Each body moves 64-row tiles of one head of a
// [b, t, h, d] bf16 view by TMA (4-D tensor maps over (d, h, t, b) with
// the view's strides, so the thirds of a fused qkv are read in place)
// into shared memory in the 128-byte swizzle (64 bf16 a row chunk; 64
// bytes at d = 32), and runs wgmma on them.  See hopper.cuh for the
// swizzled layout and the accumulator layout.

#pragma once

#include "flash_common.cuh"
#include "hopper.cuh"

namespace flash90 {

constexpr int kRows = 64;   // rows of a tile: a warpgroup's wgmma M
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// a 64-row tile of head_dim D, as TMA writes it
template <int D>
struct Tile {
  static constexpr int SW = D >= 64 ? 128 : 64;   // swizzle = a row chunk
  static constexpr int CW = SW / 2;               // bf16 columns a chunk
  static constexpr int NCH = D / CW;              // chunks a row
  static constexpr int CHUNK = kRows * SW;        // bytes of a 64-row chunk
  static constexpr int TILE = NCH * CHUNK;        // bytes of a 64-row tile
  static constexpr int LAYOUT = hopper::swizzle_layout(SW);
};

// K-major descriptor of the 16-column step kk of a 64-row tile
template <int D>
__device__ __forceinline__ uint64_t kmajor(const unsigned char* tile, int kk) {
  using T = Tile<D>;
  const int col = kk * 16;
  return hopper::make_desc(tile + col / T::CW * T::CHUNK + col % T::CW * 2, 16,
                           8 * T::SW, T::LAYOUT);
}

// MN-major descriptor of the 16-row step kq of a 64-row tile read as B
// [16 rows (K)][D (N)]
template <int D>
__device__ __forceinline__ uint64_t mnmajor(const unsigned char* tile, int kq) {
  using T = Tile<D>;
  return hopper::make_desc(tile + kq * 16 * T::SW, T::CHUNK, 8 * T::SW,
                           T::LAYOUT);
}

// 2^x by the SFU's ex2.approx (relative error about 2^-22; results below
// 2^-126 flush to 0, far under any probability the bf16 products can
// see; 2^-inf = 0).  CUDA's exp2f, exact in denormals, gave the same bits
// on the fine-tune's inputs at many more instructions, in the loops that
// bound these kernels.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// keep the A registers live until the products that read them are done
__device__ __forceinline__ void fence_a(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// the NCH boxes of the 64-row tile of head (bi, hi) from row r0, loaded
// into `dst` and completing on `bar` (rows past t filled with zeros)
template <int D>
__device__ __forceinline__ void load_tile(unsigned char* dst,
                                          const CUtensorMap* map,
                                          uint64_t* bar, int bi, int hi,
                                          int r0) {
  using T = Tile<D>;
#pragma unroll
  for (int c = 0; c < T::NCH; ++c)
    hopper::tma_load_4d(dst + c * T::CHUNK, map, bar, c * T::CW, hi, r0, bi);
}

// the tile at `src` stored to rows r0.. of head (bi, hi) (rows past t
// dropped), in one bulk group the caller commits
template <int D>
__device__ __forceinline__ void store_tile(const CUtensorMap* map,
                                           const unsigned char* src, int bi,
                                           int hi, int r0) {
  using T = Tile<D>;
#pragma unroll
  for (int c = 0; c < T::NCH; ++c)
    hopper::tma_store_4d(map, src + c * T::CHUNK, c * T::CW, hi, r0, bi);
}

// a warpgroup's [64][D] f32 accumulator, each row times mul[hh] (the
// thread's rows 16 w + g and that + 8), as bf16 into a 64-row tile in its
// swizzled layout, for a TMA store: 16-byte chunk u of row r goes to u ^
// (r % 8) (128-byte swizzle) or u ^ ((r / 2) % 4) (64-byte); a warp's 32
// four-byte writes fall in 32 banks
template <int D>
__device__ __forceinline__ void stage_acc(unsigned char* tile,
                                          const float (&acc)[D / 2],
                                          const float (&mul)[2]) {
  using T = Tile<D>;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, c4 = (lane & 3) * 4;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = warp * 16 + g + 8 * hh;
      const int col = j * 8, unit = col % T::CW / 8;
      const int swz = T::SW == 128 ? r % 8 : (r / 2) % 4;
      *reinterpret_cast<__nv_bfloat162*>(
          tile + col / T::CW * T::CHUNK + r * T::SW + (unit ^ swz) * 16 + c4) =
          __floats2bfloat162_rn(acc[4 * j + 2 * hh] * mul[hh],
                                acc[4 * j + 2 * hh + 1] * mul[hh]);
    }
  }
}

// the key validity of batch row bi as 32-bit words in shared memory, two
// per 64-key tile: bit l of word i is key 32 i + l (keys past t invalid;
// a null kv_mask makes every key before t valid).  Every warp of the
// block takes part; read after a __syncthreads.
__device__ __forceinline__ void key_words(uint32_t* words,
                                          const int32_t* kv_mask, int bi,
                                          int t) {
  const int lane = threadIdx.x & 31, warps = blockDim.x / 32;
  const int n = 2 * ((t + kRows - 1) / kRows);
  for (int i = threadIdx.x / 32; i < n; i += warps) {
    const int col = 32 * i + lane;
    const bool ok =
        col < t && (kv_mask == nullptr ||
                    kv_mask[static_cast<long long>(bi) * t + col] != 0);
    const uint32_t w = __ballot_sync(0xffffffffu, ok);
    if (lane == 0) words[i] = w;
  }
}

// bytes of key_words' array at t keys
inline int key_words_bytes(int t) { return 8 * ((t + kRows - 1) / kRows); }

// the validity of this thread's 16 columns 8 j + 2 (lane % 4) + e of a
// 64-key tile whose words are w[0], w[1]: bit 2 j + e
__device__ __forceinline__ uint32_t thread_bits(uint32_t w0, uint32_t w1) {
  const int c2 = (threadIdx.x & 3) * 2;
  uint32_t mine = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    mine |= (((j < 4 ? w0 : w1) >> ((j % 4) * 8 + c2)) & 3u) << (2 * j);
  return mine;
}

// ---------------------------------------------------------------- host

// a tensor map over (d, h, t, b) of a [b, t, h, d] bf16 view with strides
// (sb, sh, st) in elements (unit stride in d), in boxes of one head's
// [64 rows][CW columns] in the tile's swizzle.  False when the encoding
// is refused (strides not multiples of 16 bytes, unaligned base).
template <int D>
inline bool head_map(CUtensorMap* map, const void* base, int b, int h, int t,
                     long long sb, long long sh, long long st) {
  using T = Tile<D>;
  const uint64_t size[4] = {static_cast<uint64_t>(D), static_cast<uint64_t>(h),
                            static_cast<uint64_t>(t), static_cast<uint64_t>(b)};
  const uint64_t stride[3] = {static_cast<uint64_t>(sh) * 2,
                              static_cast<uint64_t>(st) * 2,
                              static_cast<uint64_t>(sb) * 2};
  const uint32_t box[4] = {T::CW, 1, kRows, 1};
  return hopper::make_tensor_map(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, size, stride, box,
      T::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B);
}

// the same over a contiguous [b, t, h, d] tensor
template <int D>
inline bool dense_head_map(CUtensorMap* map, const void* base, int b, int h,
                           int t) {
  return head_map<D>(map, base, b, h, t, static_cast<long long>(t) * h * D,
                     D, static_cast<long long>(h) * D);
}

// a map over n f32 (the [b*h, t] lse or delta, flattened) in boxes of 64
inline bool row_map(CUtensorMap* map, const void* base, uint64_t n) {
  const uint32_t box[1] = {kRows};
  return hopper::make_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, base,
                                 &n, nullptr, box, CU_TENSOR_MAP_SWIZZLE_NONE);
}

}  // namespace flash90
