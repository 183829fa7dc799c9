// Helpers that the flash-attention kernels (flash_attention.cu and
// flash_attention_f16.cu, K4-K6, through flash_mma.cuh) and the ring-step
// kernels (ring_attention.cu, K7-K9) share: the f32 tiles and products of
// the FMA builds, and the cp.async, ldmatrix, mma.sync and softmax
// helpers of the tensor-core builds, generic in the 2-byte element type
// (bf16, and f16 for K4-K6).  Each translation unit includes its own copy
// (an anonymous namespace); the units compile in parallel (ops/_build.py).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTile = 64;       // rows of a q tile and of a k tile
constexpr int kThreads = 256;   // 16 x 16 threads, 4 x 4 elements each
constexpr int kLdp = 80;        // row pitch of the [64][64] P / dS tiles
constexpr float kNegInf = -1e30f;

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ float to_f32<__half>(__half x) {
  return __half2float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

// p.astype(v.dtype) before P V: round to the input type and back.
template <typename T>
__device__ __forceinline__ float p_round(float x) {
  return to_f32<T>(from_f32<T>(x));
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// Max / sum over the 16 threads (tx) that share a row of a tile: they
// are the two half-warps of one warp.
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  }
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

// Rows [t0, t0 + 64) of one (batch, head) of a [B, T, H, D] tensor
// (`src` already offset to the batch and head) into a [64][DP + 4] f32
// tile, times `mul`; rows past T and columns past d are zero.
template <typename T, int DP>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const T* __restrict__ src,
                                          long long s_t, int t0, int t_len,
                                          int d, float mul) {
  constexpr int kLd = DP + 4;
  for (int idx = threadIdx.x; idx < kTile * DP; idx += kThreads) {
    const int r = idx / DP;
    const int c = idx - r * DP;
    const int t = t0 + r;
    float x = 0.0f;
    if (t < t_len && c < d) x = to_f32<T>(src[(long long)t * s_t + c]) * mul;
    dst[r * kLd + c] = x;
  }
}

// acc[i][j] = sum_c A[ty + 16 i][c] * (B[tx + 16 j][c] * b_mul) over the
// DP columns of two [64][DP + 4] tiles (S = Q K^T and its kin).
template <int DP, bool kScaleB>
__device__ __forceinline__ void dot_rows(const float* __restrict__ a_tile,
                                         const float* __restrict__ b_tile,
                                         float acc[4][4], float b_mul) {
  constexpr int kLd = DP + 4;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }
#pragma unroll 4
  for (int c = 0; c < DP; c += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = *reinterpret_cast<const float4*>(a_tile + (ty + 16 * i) * kLd + c);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b[j] = *reinterpret_cast<const float4*>(b_tile + (tx + 16 * j) * kLd + c);
      if (kScaleB) {
        b[j].x *= b_mul;
        b[j].y *= b_mul;
        b[j].z *= b_mul;
        b[j].w *= b_mul;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
      }
    }
  }
}

// acc[i][n][e] += sum_j P[ty + 16 i][j] * V[j][64 n + 4 tx + e]: a
// [64][64] tile (pitch kLdp) times a [64][DP + 4] tile (P V and its kin).
template <int DP>
__device__ __forceinline__ void acc_pv(const float* __restrict__ p_tile,
                                       const float* __restrict__ v_tile,
                                       float acc[4][DP / 64][4]) {
  constexpr int kLd = DP + 4;
  constexpr int kNc = DP / 64;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
#pragma unroll 2
  for (int j = 0; j < kTile; j += 4) {
    float4 p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      p[i] = *reinterpret_cast<const float4*>(p_tile + (ty + 16 * i) * kLdp + j);
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int n = 0; n < kNc; ++n) {
        const float4 v = *reinterpret_cast<const float4*>(
            v_tile + (j + jj) * kLd + 64 * n + 4 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pj = comp(p[i], jj);
          acc[i][n][0] = fmaf(pj, v.x, acc[i][n][0]);
          acc[i][n][1] = fmaf(pj, v.y, acc[i][n][1]);
          acc[i][n][2] = fmaf(pj, v.z, acc[i][n][2]);
          acc[i][n][3] = fmaf(pj, v.w, acc[i][n][3]);
        }
      }
    }
  }
}

// Rows of a [64][DP] register tile (rows ty + 16 i, columns 64 n + 4 tx +
// e) into a contiguous [B, T, H, D] tensor, times `mul`.
template <typename T, int DP>
__device__ __forceinline__ void store_rows(T* __restrict__ dst, long long o_st,
                                           int t0, int t_len, int d,
                                           const float acc[4][DP / 64][4],
                                           float mul) {
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty + 16 * i;
    if (t >= t_len) continue;
#pragma unroll
    for (int n = 0; n < DP / 64; ++n) {
      const int c = 64 * n + 4 * tx;
      if (c >= d) continue;  // d is a multiple of 8: 4 columns in or out
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dst[(long long)t * o_st + c + e] = from_f32<T>(acc[i][n][e] * mul);
      }
    }
  }
}

template <int DP>
constexpr int fwd_smem_bytes() {
  return (3 * kTile * (DP + 4) + kTile * kLdp) * 4;
}
// At DP = 256 four f32 tiles do not fit in a block's 232,448 bytes of
// shared memory (K5 would take 286,720, K6 307,712), so the backward
// kernels keep three: K5 stages V and then K in one buffer beside Q and
// dO, K6 stages Q, dO and Q again in one buffer beside K and V, and
// keeps one P / dS tile for both (share_tiles).
template <int DP>
__host__ __device__ constexpr bool share_tiles() {
  return DP > 128;
}
template <int DP>
constexpr int dq_smem_bytes() {
  return ((share_tiles<DP>() ? 3 : 4) * kTile * (DP + 4) + kTile * kLdp) * 4;
}
template <int DP>
constexpr int dkv_smem_bytes() {
  return share_tiles<DP>() ? (3 * kTile * (DP + 4) + kTile * kLdp + 2 * kTile) * 4
                           : (4 * kTile * (DP + 4) + 2 * kTile * kLdp + 2 * kTile) * 4;
}

__device__ __forceinline__ int n_tiles(int t_len) {
  return (t_len + kTile - 1) / kTile;
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// ---------------------------------------------------------------------
// The bf16 builds of K4-K9 and the f16 builds of K4-K6: the products on
// the tensor cores.
//
// mma.sync.m16n8k16 (bf16 or f16 operands, f32 accumulators) with
// ldmatrix from shared memory.  Four warps; each owns 16 rows of the
// block's 64-row tile (q rows in K4, K5, K7 and K8, key rows in K6 and
// K9), so a row's max and sums stay in the four lanes that hold it.
// Tiles are staged in the input's 2-byte type by cp.async
// (16 bytes a copy; a copy past T or past d has source size 0, which
// fills zeros) at a row pitch of DP + 8 elements, so the 8 rows an
// ldmatrix reads fall on distinct banks.  The loop's next tile is in
// flight while this one computes: one barrier per tile, two stages.
// Only these helpers and kernels differ from the FMA ones above.
// ---------------------------------------------------------------------

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;

template <int DP>
__host__ __device__ constexpr int mma_pitch() {
  return DP + 8;  // 2-byte elements per staged row: 16 bytes past DP
}
template <int DP>
__host__ __device__ constexpr int mma_tile_bytes() {
  return kTile * mma_pitch<DP>() * 2;
}
template <int DP>
__host__ __device__ constexpr int fwd_mma_smem_bytes() {
  return 5 * mma_tile_bytes<DP>();  // Q, two stages of K and V
}
template <int DP>
__host__ __device__ constexpr int dq_mma_smem_bytes() {
  return 6 * mma_tile_bytes<DP>();  // Q, dO, two stages of K and V
}
template <int DP>
__host__ __device__ constexpr int dkv_mma_smem_bytes() {
  return 6 * mma_tile_bytes<DP>() + 2 * 2 * kTile * 4;  // K, V, 2 x (Q, dO, lse, delta)
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zeros when !full (nothing is read then).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Four 8 x 8 matrices of 2-byte elements; lane i gives the address of a row of matrix
// i / 8.  _t transposes each matrix on the way.
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// Two 8 x 8 matrices of 2-byte elements, transposed; lanes 0-15 give the row
// addresses (matrix i / 8): the B fragment of one 8-column block.
__device__ __forceinline__ void ldsm_x2_t(uint32_t r[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// c += a b: a 16 x 16 (row), b 16 x 8 (col), bf16; c 16 x 8 f32.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The same product on f16 operands, f32 accumulators (never f16 ones).
__device__ __forceinline__ void mma_f16(float c[4], const uint32_t a[4], uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// mma_bf16 or mma_f16 by the element type T of the operands.
template <typename T>
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __half>::value) {
    mma_f16(c, a, b0, b1);
  } else {
    mma_bf16(c, a, b0, b1);
  }
}

// Two f32 as a bf16 pair (x in the low half), rounded to nearest.
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Two f32 as a pair of T (x in the low half), rounded to nearest.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float x, float y) {
  if constexpr (std::is_same<T, __half>::value) {
    const __half2 h = __floats2half2_rn(x, y);
    return *reinterpret_cast<const uint32_t*>(&h);
  } else {
    return pack_bf16(x, y);
  }
}

// x = hi + lo to about 16 significant bits: hi = bf16(x), lo = bf16(x -
// hi) (x - hi is exact in f32), each a bf16 pair as pack_bf16.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x - hf.x, y - hf.y);
}

// An f16 pair as two bf16 pairs, exactly: f16's 11 significant bits are
// bf16(x)'s 8 and a remainder of at most 3, and bf16 has f32's exponent
// range, so subnormal f16 values split exactly too.
__device__ __forceinline__ void split_f16(uint32_t x, uint32_t& hi, uint32_t& lo) {
  const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&x));
  split_bf16(f.x, f.y, hi, lo);
}

// The A fragment of a 16 x 16 tile from two 16 x 8 accumulator
// fragments side by side (FA2's register reuse: S's columns are the
// next product's k), rounded to T.
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void acc_to_a(const float c0[4], const float c1[4], uint32_t a[4]) {
  a[0] = pack2<T>(c0[0], c0[1]);
  a[1] = pack2<T>(c0[2], c0[3]);
  a[2] = pack2<T>(c1[0], c1[1]);
  a[3] = pack2<T>(c1[2], c1[3]);
}

__device__ __forceinline__ void acc_to_a_split(const float c0[4], const float c1[4],
                                               uint32_t hi[4], uint32_t lo[4]) {
  split_bf16(c0[0], c0[1], hi[0], lo[0]);
  split_bf16(c0[2], c0[3], hi[1], lo[1]);
  split_bf16(c1[0], c1[1], hi[2], lo[2]);
  split_bf16(c1[2], c1[3], hi[3], lo[3]);
}

// c += (hi + lo) b: an f32 A operand split by acc_to_a_split, times a B
// fragment of T.  A bf16 b: two bf16 products.  An f16 b is split
// exactly into two bf16 parts (split_f16) and takes three: hi b_hi, lo
// b_hi, hi b_lo (lo b_lo, under 2^-16 of the product, is dropped).  No
// operand is rounded to f16, whose range ends far above the gradients of
// a long batch (a hi/lo split in f16 would flush them to zero).
template <typename T>
__device__ __forceinline__ void mma_split(float c[4], const uint32_t hi[4], const uint32_t lo[4],
                                          uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __half>::value) {
    uint32_t b0_hi, b0_lo, b1_hi, b1_lo;
    split_f16(b0, b0_hi, b0_lo);
    split_f16(b1, b1_hi, b1_lo);
    mma_bf16(c, hi, b0_hi, b1_hi);
    mma_bf16(c, lo, b0_hi, b1_hi);
    mma_bf16(c, hi, b0_lo, b1_lo);
  } else {
    mma_bf16(c, hi, b0, b1);
    mma_bf16(c, lo, b0, b1);
  }
}

// Max / sum over the four lanes that hold one row of an accumulator.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Rows [t0, t0 + 64) of one (batch, head) of a [B, T, H, D] tensor of a
// 2-byte T (bf16, f16) into a [64][DP + 8] tile of T by cp.async; rows
// past T and columns past d are zero.  d is a multiple of 8: a 16-byte
// copy is all in or all out.  kThr threads of the block share the
// copies.  The caller commits.
template <int DP, int kThr = kMmaThreads, typename T>
__device__ __forceinline__ void mma_load_tile(T* dst, const T* __restrict__ src, long long s_t,
                                              int t0, int t_len, int d) {
  static_assert(sizeof(T) == 2, "2-byte elements");
  constexpr int kChunks = DP / 8;
  constexpr int kLd = mma_pitch<DP>();
#pragma unroll
  for (int idx = threadIdx.x; idx < kTile * kChunks; idx += kThr) {
    const int r = idx / kChunks;
    const int c = (idx - r * kChunks) * 8;
    const int t = t0 + r;
    const bool in = t < t_len && c < d;
    cp_async16(dst + r * kLd + c, in ? src + (long long)t * s_t + c : src, in);
  }
}

// 64 4-byte values of a row (lse, delta: [B, H, T] f32; positions: [T]
// int32) from t0; zeros past T.
template <typename T>
__device__ __forceinline__ void mma_load_rows(T* dst, const T* __restrict__ src, int t0,
                                              int t_len) {
  static_assert(sizeof(T) == 4, "4-byte rows");
  if (threadIdx.x < kTile) {
    const int t = t0 + threadIdx.x;
    cp_async4(dst + threadIdx.x, t < t_len ? src + t : src, t < t_len);
  }
}

// The NF 8-column fragments of a warp's 16-row slab of an f32
// accumulator tile that start at column c_base (this lane: rows r and r
// + 8, columns c_base + 8 n + 2 (lane % 4) + {0, 1}) into a contiguous
// [B, T, H, D] tensor of T (bf16, f16), times `mul`, in pairs of T.
template <int NF, typename T>
__device__ __forceinline__ void mma_store_cols(T* __restrict__ dst, long long o_st, int r,
                                               int t_len, int d, int c_base,
                                               const float acc[NF][4], float mul) {
  const int c0 = c_base + 2 * (threadIdx.x & 3);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = r + 8 * half;
    if (t >= t_len) continue;
#pragma unroll
    for (int n = 0; n < NF; ++n) {
      const int c = 8 * n + c0;
      if (c >= d) continue;
      *reinterpret_cast<uint32_t*>(dst + (long long)t * o_st + c) =
          pack2<T>(acc[n][2 * half] * mul, acc[n][2 * half + 1] * mul);
    }
  }
}

// The whole slab, all DP columns (K6's DP = 256 build stores half a slab
// per warp).
template <int DP, typename T>
__device__ __forceinline__ void mma_store_rows(T* __restrict__ dst, long long o_st, int r,
                                               int t_len, int d, const float acc[DP / 8][4],
                                               float mul) {
  mma_store_cols<DP / 8>(dst, o_st, r, t_len, d, 0, acc, mul);
}

// K6 and K9 at DP = 256: a pair of warps for each 16 key rows, which
// exchange their 16 x 16 fragments of P and dP^T through shared memory
// and meet at a barrier of the pair's 64 threads.
constexpr int kPairThreads = 2 * kMmaThreads;
constexpr int kXchFloats = 2 * 2 * 256;  // a pair's 2 buffers of P and dP^T, 16 x 16 each

__device__ __forceinline__ void pair_barrier(int pair) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + pair) : "memory");
}

// 16-byte alignment, as the tensor-core kernels' 16-byte copies need.
inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace
