// The tensor-core builds of K7-K9 (ring_fwd_mma_kernel,
// ring_dq_mma_kernel, ring_dkv_mma_kernel and, at DP = 256,
// ring_dkv_mma_pair_kernel) and their launchers, as templates on the
// 2-byte element type T of q, k and v.  ring_attention.cu instantiates
// them for bf16 and ring_attention_f16.cu for f16, so the two builds
// compile in parallel (ops/_build.py); the f16 launchers cross between
// the two units through edl_ring::*_f16 below.  The helpers and the
// position rules here are shared with the f32 FMA builds of
// ring_attention.cu.  What differs in f16 is K4-K6's f16 rules
// (flash_mma.cuh) applied to the ring step:
//
// - The products whose operands are both inputs run natively in f16: S =
//   Q K^T (K7, K8) and S^T = K Q^T (K9) from the unscaled q, dP = dO V^T
//   (K8) and dP^T = V dO^T (K9) on an f16 dO, and K7's P V with P
//   rounded to f16 per 64-key tile (JAX's p.astype(v.dtype)); f32
//   accumulators throughout.
// - The products with an f32 operand (dQ += dS K in K8; dV += P^T dO and
//   dK += dS^T Q in K9) split that operand into bf16 hi and lo, as the
//   bf16 builds do, and split the f16 tile exactly into two bf16 parts
//   (mma_split): three bf16 products.  At the LM's gradient scale (dO
//   near 1e-6) P's and dS's products lie far below f16's normal range
//   (6.1e-5), which bf16, with f32's exponent range, keeps.
// - Beside an f32 dO, which enters as three bf16 parts, the f16 V that
//   dP (dP^T) multiplies is split exactly into two bf16 parts, and every
//   part of dO meets both: six bf16 products where the bf16 build takes
//   three.

#pragma once

#include "flash_common.cuh"

namespace edl_ring {

// ---------------------------------------------------------------------
// K7-K9: one step of the context-parallel ring.
//
// Layout: the JAX functions' kernel layout [B, H, T, D].  q, k and v are
// read through their strides (q's apart from the K/V block's, since Tq
// and Tk may differ), so a transposed view of [B, T, H, D] activations
// goes in without a copy.  acc, dO, dq, dk and dv are contiguous [B, H,
// T, D] f32, lse and delta contiguous [B, H, Tq] f32 ([B, H, Tq, 1] in
// JAX), q_pos [Tq] and k_pos [Tk] int32.
//
// The causal mask is k_pos > q_pos, read from the position arrays, not
// derived from tile indices: a rotating block's positions depend on its
// source shard, and the zigzag layout's are not even affine.  A key tile
// whose smallest k_pos exceeds the q tile's largest q_pos is wholly
// masked and skipped (in K9: a q tile whose largest q_pos is below the k
// tile's smallest k_pos).  The Pallas kernels compute such tiles and
// mask every score; a masked score adds exactly 0, so the numbers agree.
// In K8 and K9 P is 0 where the key is masked, as exp(NEG_INF - lse) is
// for any finite lse, and in a row whose final lse is NEG_INF (a row that
// saw no key in the whole ring, which a causal ring never makes, since
// every query sees its own position): there the Pallas formula gives
// exp(0) = 1 to the masked keys of the tiles it computes, and these
// kernels and their plain versions give the row no gradient at all.
//
// K7's online softmax is the ring kernel's, which differs from K4's
// where a row has seen only masked keys: the max is clamped to 0
// (safe_m), the masked p and the correction are 0, so an all-masked row
// ends with l = 0 and lse_i = NEG_INF.  The combine with the carry
// follows the JAX order: lse_new = logaddexp(lse_c, lse_i), alpha =
// exp(lse_c - lse_new), beta = exp(lse_i - lse_new), acc = acc_c * alpha
// + (acc_i / l) * beta.  A row with l = 0 is not written: the Pallas
// formulas give the carry back there (alpha = 1, beta = 0), so a fully
// masked step leaves the carry bit-identical.  P is rounded to v's dtype
// before P V relative to the running max after each 64-key tile, as in
// K4.  K8 and K9 are K5 and K6 with the position mask and f32 outputs;
// the FMA builds multiply q by scale before Q K^T, the tensor-core
// builds S after it, and both dq and dk at the end.
//
// What bounds them: at the ring bench's unmasked step (B=4, H=8, Tq=Tk=
// 2048, D=128) K7 needs 4*B*H*Tq*Tk*D = 68.7 GFLOP, 0.069 ms at the bf16
// tensor-core peak, and moves 118 MB, 0.035 ms at the memory rate:
// operations bound K7 and K9 as they bound K4 and K6; K8, left with dQ's
// share, is bound about as much by its bytes, as K5 is.  The designs are
// theirs: the bf16 and f16 builds run on the tensor cores
// (ring_fwd_mma_kernel, K4's loop; ring_dq_mma_kernel, K5's;
// ring_dkv_mma_kernel, K6's), the f32 builds are f32 FMA on the CUDA
// cores (ring_attention.cu), whose 67 TFLOP/s is their ceiling.
// ---------------------------------------------------------------------

struct RingShape {
  int heads, tq, tk, d;
  long long q_sb, q_st, q_sh;     // strides of q (elements)
  long long kv_sb, kv_st, kv_sh;  // strides of k and v
  float scale;
  int causal;
};

// The f16 launchers, compiled in ring_attention_f16.cu for DP = 64, 128
// and 256; each returns cudaGetLastError() of its launch (the backward
// steps take dO's dtype code: 2 = float16, 0 = float32).
template <int DP>
cudaError_t fwd_f16(const void* q, const void* k, const void* v, float* acc, float* lse,
                    const int* q_pos, const int* k_pos, int batch, const RingShape& s,
                    cudaStream_t st);
template <int DP>
cudaError_t dq_f16(const void* q, const void* k, const void* v, const void* dout,
                   int dout_dtype, const float* lse, const float* delta, float* dq,
                   const int* q_pos, const int* k_pos, int batch, const RingShape& s,
                   cudaStream_t st);
template <int DP>
cudaError_t dkv_f16(const void* q, const void* k, const void* v, const void* dout,
                    int dout_dtype, const float* lse, const float* delta, float* dk, float* dv,
                    const int* q_pos, const int* k_pos, int batch, const RingShape& s,
                    cudaStream_t st);

}  // namespace edl_ring

namespace {

using edl_ring::RingShape;

// acc += step, elementwise in f32 (round to nearest).  K8 and K9 sum
// each step's products in a fresh fragment and add it so: the tensor
// cores' own f32 sums are not rounded to nearest, and a running sum
// carried through every mma of a 2048-row loop drifts past their f32
// outputs' tolerance.
__device__ __forceinline__ void add_frag(float acc[4], const float step[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += step[e];
}

// The NF 8-column fragments of a warp's 16-row slab of an f32
// accumulator that start at column c_base (as mma_store_cols) into
// contiguous f32 rows of width d (row r of dst at r * d), times `mul`,
// in float2 pairs: the ring's f32 dq, dk and dv.
template <int NF>
__device__ __forceinline__ void mma_store_cols_f32(float* __restrict__ dst, int r, int t_len,
                                                   int d, int c_base, const float acc[NF][4],
                                                   float mul) {
  const int c0 = c_base + 2 * (threadIdx.x & 3);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = r + 8 * half;
    if (t >= t_len) continue;
#pragma unroll
    for (int n = 0; n < NF; ++n) {
      const int c = 8 * n + c0;
      if (c >= d) continue;
      *reinterpret_cast<float2*>(dst + (long long)t * d + c) =
          make_float2(acc[n][2 * half] * mul, acc[n][2 * half + 1] * mul);
    }
  }
}

// The whole slab, all DP columns (K9's DP = 256 build stores half a slab
// per warp).
template <int DP>
__device__ __forceinline__ void mma_store_rows_f32(float* __restrict__ dst, int r, int t_len,
                                                   int d, const float acc[DP / 8][4], float mul) {
  mma_store_cols_f32<DP / 8>(dst, r, t_len, d, 0, acc, mul);
}

// Rows [t0, t0 + 64) of contiguous f32 rows of width d into kParts bf16
// tiles as mma_load_tile stages them (tile p at dst + p * 64 * (DP + 8)),
// x = sum of the parts: each part is bf16 of what the parts before it
// left (each remainder exact in f32); zeros past T and past d.  Plain
// loads and stores: the caller's next barrier publishes them.  One chunk
// in flight a thread: more spills K9's D=64 build, whose 64 accumulators
// are live across the call.  kThr threads of the block share the rows.
template <int DP, int kParts, int kThr = kMmaThreads, typename E>
__device__ __forceinline__ void mma_load_tile_split(E* dst, const float* __restrict__ src, int t0,
                                                    int t_len, int d) {
  static_assert(sizeof(E) == 2, "bf16 parts in a tile of 2-byte elements");
  constexpr int kChunks = DP / 8;
  constexpr int kLd = mma_pitch<DP>();
#pragma unroll 1
  for (int idx = threadIdx.x; idx < kTile * kChunks; idx += kThr) {
    const int r = idx / kChunks;
    const int c = (idx - r * kChunks) * 8;
    const int t = t0 + r;
    float4 x[2] = {make_float4(0.0f, 0.0f, 0.0f, 0.0f), make_float4(0.0f, 0.0f, 0.0f, 0.0f)};
    if (t < t_len && c < d) {
      const float4* p = reinterpret_cast<const float4*>(src + (long long)t * d + c);
      x[0] = __ldg(p);
      x[1] = __ldg(p + 1);
    }
#pragma unroll
    for (int part = 0; part < kParts; ++part) {
      uint32_t packed[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const __nv_bfloat162 h0 = __floats2bfloat162_rn(x[i].x, x[i].y);
        const __nv_bfloat162 h1 = __floats2bfloat162_rn(x[i].z, x[i].w);
        packed[2 * i] = *reinterpret_cast<const uint32_t*>(&h0);
        packed[2 * i + 1] = *reinterpret_cast<const uint32_t*>(&h1);
        const float2 f0 = __bfloat1622float2(h0), f1 = __bfloat1622float2(h1);
        x[i] = make_float4(x[i].x - f0.x, x[i].y - f0.y, x[i].z - f1.x, x[i].w - f1.y);
      }
      *reinterpret_cast<uint4*>(dst + part * kTile * kLd + r * kLd + c) =
          make_uint4(packed[0], packed[1], packed[2], packed[3]);
    }
  }
}

// The smallest (kMin) or largest position of rows [t0, t0 + 64) of `pos`
// (rows past t_len left out), reduced by threads 0-63 (warps 0 and 1)
// into red[0] and red[1]; the tile's positions go to pos_s when it is
// given.  The caller synchronises before reading either.
template <bool kMin>
__device__ __forceinline__ void tile_pos_extreme(const int* __restrict__ pos, int t0,
                                                 int t_len, int* red, int* pos_s) {
  if (threadIdx.x >= kTile) return;
  const int t = t0 + threadIdx.x;
  const bool in = t < t_len;
  const int p = in ? pos[t] : 0;
  if (pos_s != nullptr) pos_s[threadIdx.x] = p;
  int x = in ? p : (kMin ? INT_MAX : INT_MIN);
  x = kMin ? __reduce_min_sync(0xffffffffu, x) : __reduce_max_sync(0xffffffffu, x);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
}

__device__ __forceinline__ bool below_half_neg_inf(float x) { return x <= kNegInf * 0.5f; }

// ---------------------------------------------------------------------
// K7 on the tensor cores (bf16 and f16 inputs, T).  Block (q tile, head,
// batch), causal blocks heaviest first; warp w owns q rows 16 w .. 16 w +
// 15 and holds them as A fragments, as in flash_fwd_mma_kernel, whose
// loop this is: S = Q K^T by mma from the unscaled q, times `scale` in
// f32; P rounded to T per 64-key tile against the running max, l summing
// the unrounded p.  What the ring changes:
// - The mask is k_pos > q_pos: each lane reads q_pos of its rows r_lo
//   and r_lo + 8 once, and each K tile's 64 positions are staged in
//   shared memory beside it; columns past Tk are masked on their own
//   (Tq != Tk is allowed).
// - The online softmax is ring_fwd_kernel's (safe_m; p = 0 where s <=
//   NEG_INF / 2; the correction 0 while m <= NEG_INF / 2), so a row that
//   sees no key ends with l = 0 and leaves the carry bit for bit.
// - Wholly masked K tiles are skipped with the two-stage pipeline kept
//   full: a first pass writes each K tile's smallest position to shared
//   memory (the zigzag layout's positions are not affine, so the live
//   tiles are no prefix), and the loop walks and prefetches the live
//   tiles only.  A q tile with no live K tile returns at once.
// - The combine with the carry runs in the accumulators' layout, in
//   JAX's order: lse_i, lse_new = logaddexp, alpha, beta; acc_c is read
//   and written in place by the lane that holds each element, lse_c (read
//   at the start, before any lane of the quad writes it) by lane % 4 = 0.
// - At DP = 256 the warp's 16 rows of O take 128 registers a thread, so it
//   reads its Q fragments by ldmatrix at each 16-column step instead of
//   holding them, as K4 does there.
// ---------------------------------------------------------------------
template <int DP>
__host__ __device__ constexpr int ring_fwd_mma_smem_bytes(int n_k) {
  // Q, two stages of K, V and their positions, the q tile's max (2), each
  // K tile's smallest position.
  return fwd_mma_smem_bytes<DP>() + (2 * kTile + 2 + n_k) * 4;
}

template <typename T, int DP>
__global__ void __launch_bounds__(kMmaThreads)
    ring_fwd_mma_kernel(const T* __restrict__ q,
                        const T* __restrict__ k,
                        const T* __restrict__ v, float* __restrict__ acc_c,
                        float* __restrict__ lse_c, const int* __restrict__ q_pos,
                        const int* __restrict__ k_pos, RingShape s) {
  constexpr int kLd = mma_pitch<DP>();
  constexpr int kElems = kTile * kLd;
  constexpr int kN = DP / 8;
  constexpr bool kHoldQ = DP <= 128;  // Q's A fragments in registers
  extern __shared__ float4 smem4[];
  T* q_s = reinterpret_cast<T*>(smem4);
  T* k_s = q_s + kElems;      // two stages
  T* v_s = k_s + 2 * kElems;  // two stages
  int* kpos_s = reinterpret_cast<int*>(v_s + 2 * kElems);  // two stages
  int* red_s = kpos_s + 2 * kTile;
  int* kmin_s = red_s + 2;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_q = n_tiles(s.tq);
  const int qi = s.causal ? n_q - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qi * kTile;
  const long long row0 = ((long long)b * s.heads + h) * s.tq;
  const T* k_bh = k + b * s.kv_sb + h * s.kv_sh;
  const T* v_bh = v + b * s.kv_sb + h * s.kv_sh;
  const int n_k = n_tiles(s.tk);

  int q_max = INT_MAX;
  if (s.causal) {
    tile_pos_extreme<false>(q_pos, q0, s.tq, red_s, nullptr);
    for (int i = warp; i < n_k; i += kMmaWarps) {
      int x = INT_MAX;
#pragma unroll
      for (int c = lane; c < kTile; c += 32) {
        const int t = i * kTile + c;
        if (t < s.tk) x = min(x, k_pos[t]);
      }
      x = __reduce_min_sync(0xffffffffu, x);
      if (lane == 0) kmin_s[i] = x;
    }
    __syncthreads();
    q_max = max(red_s[0], red_s[1]);
  }
  // The first live K tile at or after i (every tile is live without the
  // causal mask); the same in every thread.
  auto next_live = [&](int i) {
    if (s.causal) {
      while (i < n_k && kmin_s[i] > q_max) ++i;
    }
    return i;
  };
  int kb = next_live(0);
  if (kb >= n_k) return;  // every key masked: the carry stays as it is

  mma_load_tile<DP>(q_s, q + b * s.q_sb + h * s.q_sh, s.q_st, q0, s.tq, s.d);
  mma_load_tile<DP>(k_s, k_bh, s.kv_st, kb * kTile, s.tk, s.d);
  mma_load_tile<DP>(v_s, v_bh, s.kv_st, kb * kTile, s.tk, s.d);
  mma_load_rows(kpos_s, k_pos, kb * kTile, s.tk);
  cp_async_commit();

  // This lane's rows of the tile: r_lo and r_lo + 8.
  const int r_lo = q0 + 16 * warp + (lane >> 2);
  int qp[2];
  float lse_in[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = r_lo + 8 * half;
    qp[half] = t < s.tq ? q_pos[t] : 0;
    lse_in[half] = t < s.tq ? lse_c[row0 + t] : 0.0f;
  }
  const int a_row = (16 * warp + (lane & 15)) * kLd + 8 * (lane >> 4);
  uint32_t qf[kHoldQ ? DP / 16 : 1][4];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f}, o[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  }

  for (int it = 0; kb < n_k; ++it) {
    // Tile kb has landed, and every warp is done with the previous live
    // tile, whose stage the next copy overwrites.
    cp_async_wait_all();
    __syncthreads();
    if constexpr (kHoldQ) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) ldsm_x4(qf[kk], q_s + a_row + 16 * kk);
      }
    }
    const int next = next_live(kb + 1);
    if (next < n_k) {
      const int stage = (it + 1) & 1;
      mma_load_tile<DP>(k_s + stage * kElems, k_bh, s.kv_st, next * kTile, s.tk, s.d);
      mma_load_tile<DP>(v_s + stage * kElems, v_bh, s.kv_st, next * kTile, s.tk, s.d);
      mma_load_rows(kpos_s + stage * kTile, k_pos, next * kTile, s.tk);
      cp_async_commit();
    }
    const T* ks = k_s + (it & 1) * kElems;
    const T* vs = v_s + (it & 1) * kElems;
    const int* kp = kpos_s + (it & 1) * kTile;

    float sc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t qa[4];
      if constexpr (kHoldQ) {
#pragma unroll
        for (int i = 0; i < 4; ++i) qa[i] = qf[kk][i];
      } else {
        ldsm_x4(qa, q_s + a_row + 16 * kk);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4];
        ldsm_x4(bk, ks + (16 * np + (lane & 7) + 8 * (lane >> 4)) * kLd + 16 * kk +
                        8 * ((lane >> 3) & 1));
        mma<T>(sc[2 * np], qa, bk[0], bk[1]);
        mma<T>(sc[2 * np + 1], qa, bk[2], bk[3]);
      }
    }

    const int k0 = kb * kTile;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * (lane & 3) + e;
          float x = sc[j][2 * half + e] * s.scale;
          if (k0 + col >= s.tk || (s.causal && kp[col] > qp[half])) x = kNegInf;
          sc[j][2 * half + e] = x;
          mx = fmaxf(mx, x);
        }
      }
      const float m_new = fmaxf(m[half], quad_max(mx));
      const float safe_m = below_half_neg_inf(m_new) ? 0.0f : m_new;
      const float corr = below_half_neg_inf(m[half]) ? 0.0f : expf(m[half] - safe_m);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = sc[j][2 * half + e];
          const float p = below_half_neg_inf(x) ? 0.0f : expf(x - safe_m);
          sc[j][2 * half + e] = p;
          rs += p;
        }
      }
      l[half] = l[half] * corr + quad_sum(rs);
      m[half] = m_new;
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        o[n][2 * half] *= corr;
        o[n][2 * half + 1] *= corr;
      }
    }

#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // 16 keys a step
      uint32_t pa[4];
      acc_to_a<T>(sc[2 * kk], sc[2 * kk + 1], pa);
#pragma unroll
      for (int np = 0; np < DP / 16; ++np) {
        uint32_t bv[4];
        ldsm_x4_t(bv, vs + (16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * kLd + 16 * np +
                          8 * (lane >> 4));
        mma<T>(o[2 * np], pa, bv[0], bv[1]);
        mma<T>(o[2 * np + 1], pa, bv[2], bv[3]);
      }
    }
    kb = next;
  }

  // The combine with the carry; a row that saw no key (l = 0) keeps it.
  const int c0 = 2 * (lane & 3);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = r_lo + 8 * half;
    if (t >= s.tq || l[half] == 0.0f) continue;
    const float lse_i = (below_half_neg_inf(m[half]) ? 0.0f : m[half]) + logf(l[half]);
    const float lc = lse_in[half];
    const float lse_new = fmaxf(lc, lse_i) + log1pf(expf(-fabsf(lc - lse_i)));
    const float safe = below_half_neg_inf(lse_new) ? 0.0f : lse_new;
    const float alpha = expf((below_half_neg_inf(lc) ? kNegInf : lc) - safe);
    const float beta = expf(lse_i - safe);
    float* row = acc_c + (row0 + t) * s.d;
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      const int c = 8 * n + c0;
      if (c >= s.d) continue;  // d is a multiple of 8: a fragment's columns in or out
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        row[c + e] = row[c + e] * alpha + (o[n][2 * half + e] / l[half]) * beta;
      }
    }
    if ((lane & 3) == 0) lse_c[row0 + t] = lse_new;
  }
}

// The tensor-core builds of K7 take 16-byte-aligned q, k, v and strides,
// q's and the K/V block's each (the wrapper copies a tensor that lacks
// them).
inline bool ring_mma_inputs_ok(const void* q, const void* k, const void* v,
                               const RingShape& s) {
  return aligned16(q) && aligned16(k) && aligned16(v) && s.q_sb % 8 == 0 &&
         s.q_st % 8 == 0 && s.q_sh % 8 == 0 && s.kv_sb % 8 == 0 && s.kv_st % 8 == 0 &&
         s.kv_sh % 8 == 0 && s.d % 8 == 0;
}

template <typename T, int DP>
cudaError_t launch_ring_fwd_mma(const void* q, const void* k, const void* v, float* acc,
                                float* lse, const int* q_pos, const int* k_pos, int batch,
                                const RingShape& s, cudaStream_t st) {
  if (!ring_mma_inputs_ok(q, k, v, s)) return cudaErrorMisalignedAddress;
  const int bytes = ring_fwd_mma_smem_bytes<DP>((s.tk + kTile - 1) / kTile);
  cudaError_t err = allow_smem(ring_fwd_mma_kernel<T, DP>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((s.tq + kTile - 1) / kTile, s.heads, batch);
  ring_fwd_mma_kernel<T, DP><<<grid, kMmaThreads, bytes, st>>>(
      (const T*)q, (const T*)k, (const T*)v, acc, lse, q_pos, k_pos, s);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------
// K8 and K9 on the tensor cores (bf16 or f16 q, k, v: T): K5's and K6's
// loops with the ring's rules, from the final lse and delta, f32 outputs.
//
// - S (K8) or S^T (K9) by mma from the unscaled q, times `scale` in
//   f32 (the reference computes q * scale first: a few f32 ulps of s).
//   P = exp(S - lse), 0 where k_pos > q_pos, past Tq or Tk, or where the
//   row's final lse is <= NEG_INF / 2 (a row that saw no key: P = 0, as
//   in the FMA builds and the plain versions).  dS = P (dP - delta) in
//   f32 registers.
// - The outputs are f32 and held to rtol 1e-5 plus 1e-5 of the largest
//   magnitude, where K5/K6's bf16 outputs are held to 2 bf16 ulps.  So
//   every operand the reference keeps in f32 enters the tensor cores as
//   a sum of bf16 parts, each part the bf16 of what the parts before it
//   left, with every cross product summed into one f32 accumulator: P
//   and dS in two parts (hi = bf16(x), lo = bf16(x - hi)), and dO, when
//   it comes as f32, in kF32DoParts = 3.  One bf16 rounding of any of
//   them misses the gate; with dO in two
//   parts the worst element reaches 0.56-0.88 of the gate at phase 13's
//   shapes, in three 0.36-0.44 (tests/torch_k89_split_margin.py;
//   tests/test_torch_flash_mma_rounding.py emulates these rules).
// - dQ, dK and dV sum each step's products (32 keys in K8, 16 queries in
//   K9) in a fresh fragment, added to the running sum in f32 (add_frag):
//   the tensor cores do not round their f32 sums to nearest, and a sum
//   carried through the 768 mma of one dV element over a 2048-row shard
//   (f32 dO) put dv past the gate on the card.
// - dO comes in q's type (kDoParts = 1), the CP path's gradient, staged
//   by cp.async like Q; or as f32, split into kF32DoParts bf16 tiles as
//   it is staged, by plain loads that the loop's barrier publishes.  dP
//   then takes one product per part (two beside f16 V, split exactly in
//   bf16 parts: to_bf16_parts) and K9's dV += P^T dO two per part.
// - f16 builds: the products with P or dS take the f16 tile split in two
//   bf16 parts too (mma_split), three products where bf16 takes two.
// - Wholly masked tiles are skipped with the two-stage pipeline kept
//   full, as in ring_fwd_mma_kernel: a first pass writes each K tile's
//   smallest position (K8) or each q tile's largest (K9) to shared
//   memory, and the loop walks and prefetches the live tiles only.  A
//   warp skips a step whose positions are all masked (its rows' largest
//   q_pos below the step's smallest k_pos), read from the positions, not
//   from a diagonal.  A block with no live tile stores zeros.
// ---------------------------------------------------------------------
// bf16 parts of an f32 dO in the tensor-core K8 and K9.
constexpr int kF32DoParts = 3;

// The element type of K8's and K9's dO tiles: T for a dO of q's type,
// bf16 for the parts of an f32 dO.
template <typename T, int kDoParts>
using DoElem = typename std::conditional<kDoParts == 1, T, __nv_bfloat16>::type;

// The bf16 parts whose sum a fragment of T is, exactly: the fragment
// itself in bf16, two parts in f16 (split_f16).
template <typename T>
__host__ __device__ constexpr int bf16_parts() {
  return std::is_same<T, __half>::value ? 2 : 1;
}

template <typename T>
__device__ __forceinline__ void to_bf16_parts(const uint32_t x[4],
                                              uint32_t parts[bf16_parts<T>()][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (bf16_parts<T>() == 2) {
      split_f16(x[i], parts[0][i], parts[1][i]);
    } else {
      parts[0][i] = x[i];
    }
  }
}

// Stages of the tiles that K8 (K and V) and K9 (Q and dO) prefetch: two,
// but one where two do not fit in a block, at DP = 256 with an f32 dO
// (K8 8 tiles, 270,336 B; K9 10 tiles, 337,920 B): that build loads the
// next tile set after the barrier that ends the current one.
template <int DP, int kDoParts>
__host__ __device__ constexpr int ring_stages() {
  return DP > 128 && kDoParts > 1 ? 1 : 2;
}

template <int DP, int kDoParts>
__host__ __device__ constexpr int ring_dq_mma_smem_bytes(int n_k) {
  // Q, dO (kDoParts tiles), the stages of K, V and their positions, the
  // q tile's max (2), each K tile's smallest position.
  constexpr int kStages = ring_stages<DP, kDoParts>();
  return (1 + kDoParts + 2 * kStages) * mma_tile_bytes<DP>() +
         (kStages * kTile + 2 + n_k) * 4;
}

template <int DP, int kDoParts>
__host__ __device__ constexpr int ring_dkv_mma_smem_bytes(int n_q) {
  // K, V, the stages of Q, dO (kDoParts tiles), lse, delta and q
  // positions, the k tile's min (2), each q tile's largest position; at
  // DP = 256 the pairs' exchange buffers (ring_dkv_mma_pair_kernel).
  constexpr int kStages = ring_stages<DP, kDoParts>();
  return (2 + kStages * (1 + kDoParts)) * mma_tile_bytes<DP>() +
         (3 * kStages * kTile + 2 + n_q) * 4 + (DP > 128 ? kMmaWarps * kXchFloats * 4 : 0);
}

// K8: block (q tile, head, batch); warp w owns q rows 16 w .. 16 w + 15
// and their rows of dQ, and takes each live K tile 32 keys at a time.
// Registers as in K5: at D = 64 the build on dO of T holds its Q and dO rows
// as A fragments; at D = 128 and 256 (64 and 128 dQ accumulators), and
// with an f32 dO, it reads them by ldmatrix at each 16-column step
// instead.  K/V are staged ring_stages deep.
template <typename T, int DP, int kDoParts>
__global__ void __launch_bounds__(kMmaThreads)
    ring_dq_mma_kernel(const T* __restrict__ q,
                       const T* __restrict__ k,
                       const T* __restrict__ v, const void* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       float* __restrict__ dq, const int* __restrict__ q_pos,
                       const int* __restrict__ k_pos, RingShape s) {
  constexpr int kLd = mma_pitch<DP>();
  constexpr int kElems = kTile * kLd;
  constexpr int kN = DP / 8;
  constexpr int kSteps = DP / 16;                    // 16-column steps of a q row
  constexpr bool kHold = DP <= 64 && kDoParts == 1;  // Q and dO fragments in registers
  constexpr int kStages = ring_stages<DP, kDoParts>();
  extern __shared__ float4 smem4[];
  T* q_s = reinterpret_cast<T*>(smem4);
  T* do_s = q_s + kElems;                            // kDoParts tiles
  T* k_s = do_s + kDoParts * kElems;                 // kStages stages
  T* v_s = k_s + kStages * kElems;                   // kStages stages
  int* kpos_s = reinterpret_cast<int*>(v_s + kStages * kElems);  // kStages stages
  int* red_s = kpos_s + kStages * kTile;
  int* kmin_s = red_s + 2;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * kTile;
  const long long row0 = ((long long)b * s.heads + h) * s.tq;
  const T* k_bh = k + b * s.kv_sb + h * s.kv_sh;
  const T* v_bh = v + b * s.kv_sb + h * s.kv_sh;
  const int n_k = n_tiles(s.tk);

  int q_max = INT_MAX;
  if (s.causal) {
    tile_pos_extreme<false>(q_pos, q0, s.tq, red_s, nullptr);
    for (int i = warp; i < n_k; i += kMmaWarps) {
      int x = INT_MAX;
#pragma unroll
      for (int c = lane; c < kTile; c += 32) {
        const int t = i * kTile + c;
        if (t < s.tk) x = min(x, k_pos[t]);
      }
      x = __reduce_min_sync(0xffffffffu, x);
      if (lane == 0) kmin_s[i] = x;
    }
    __syncthreads();
    q_max = max(red_s[0], red_s[1]);
  }
  // The first live K tile at or after i; the same in every thread.
  auto next_live = [&](int i) {
    if (s.causal) {
      while (i < n_k && kmin_s[i] > q_max) ++i;
    }
    return i;
  };
  int kb = next_live(0);
  if (kb < n_k) {
    mma_load_tile<DP>(q_s, q + b * s.q_sb + h * s.q_sh, s.q_st, q0, s.tq, s.d);
    if constexpr (kDoParts > 1) {
      mma_load_tile_split<DP, kDoParts>(do_s, static_cast<const float*>(dout) + row0 * s.d, q0,
                                        s.tq, s.d);
    } else {
      mma_load_tile<DP>(do_s, static_cast<const T*>(dout) + row0 * s.d, s.d, q0,
                        s.tq, s.d);
    }
    mma_load_tile<DP>(k_s, k_bh, s.kv_st, kb * kTile, s.tk, s.d);
    mma_load_tile<DP>(v_s, v_bh, s.kv_st, kb * kTile, s.tk, s.d);
    mma_load_rows(kpos_s, k_pos, kb * kTile, s.tk);
    cp_async_commit();
  }

  // This lane's rows of the tile: r_lo and r_lo + 8 (a row past Tq has no
  // position and is not stored).
  const int r_lo = q0 + 16 * warp + (lane >> 2);
  int qp[2];
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = r_lo + 8 * half;
    const bool in = t < s.tq;
    qp[half] = in ? q_pos[t] : INT_MIN;
    lse_r[half] = in ? lse[row0 + t] : 0.0f;
    delta_r[half] = in ? delta[row0 + t] : 0.0f;
  }
  const int warp_q_max = __reduce_max_sync(0xffffffffu, max(qp[0], qp[1]));
  const int a_row = (16 * warp + (lane & 15)) * kLd + 8 * (lane >> 4);
  uint32_t qf[kHold ? kSteps : 1][4], dof[kHold ? kSteps : 1][4];
  float acc[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  }

  for (int it = 0; kb < n_k; ++it) {
    // Tile kb has landed, and every warp is done with the previous live
    // tile, whose stage the next copy overwrites.
    cp_async_wait_all();
    __syncthreads();
    if constexpr (kHold) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk) {
          ldsm_x4(qf[kk], q_s + a_row + 16 * kk);
          ldsm_x4(dof[kk], do_s + a_row + 16 * kk);
        }
      }
    }
    const int next = next_live(kb + 1);
    auto load_kv = [&](int stage) {
      mma_load_tile<DP>(k_s + stage * kElems, k_bh, s.kv_st, next * kTile, s.tk, s.d);
      mma_load_tile<DP>(v_s + stage * kElems, v_bh, s.kv_st, next * kTile, s.tk, s.d);
      mma_load_rows(kpos_s + stage * kTile, k_pos, next * kTile, s.tk);
      cp_async_commit();
    };
    if constexpr (kStages == 2) {
      if (next < n_k) load_kv((it + 1) & 1);
    }
    const int stage = kStages == 2 ? (it & 1) : 0;
    const T* ks = k_s + stage * kElems;
    const T* vs = v_s + stage * kElems;
    const int* kp = kpos_s + stage * kTile;
    const int k0 = kb * kTile;

#pragma unroll 1
    for (int sub = 0; sub < kTile; sub += 32) {
      // All 32 keys after every row of this warp: adds 0.
      if (s.causal && __reduce_min_sync(0xffffffffu, kp[sub + lane]) > warp_q_max) continue;
      float sc[4][4], dp[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[j][e] = 0.0f;
          dp[j][e] = 0.0f;
        }
      }
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        uint32_t qa[4], da[4];
        if constexpr (kHold) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            qa[i] = qf[kk][i];
            da[i] = dof[kk][i];
          }
        } else {
          ldsm_x4(qa, q_s + a_row + 16 * kk);
          ldsm_x4(da, do_s + a_row + 16 * kk);
        }
        uint32_t dl[kDoParts > 1 ? kDoParts - 1 : 1][4];  // an f32 dO's other parts
#pragma unroll
        for (int part = 1; part < kDoParts; ++part) {
          ldsm_x4(dl[part - 1], do_s + part * kElems + a_row + 16 * kk);
        }
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bk[4], bv[4];
          const int b_off = (sub + 16 * np + (lane & 7) + 8 * (lane >> 4)) * kLd + 16 * kk +
                            8 * ((lane >> 3) & 1);
          ldsm_x4(bk, ks + b_off);
          ldsm_x4(bv, vs + b_off);
          mma<T>(sc[2 * np], qa, bk[0], bk[1]);
          mma<T>(sc[2 * np + 1], qa, bk[2], bk[3]);
          if constexpr (kDoParts == 1) {
            mma<T>(dp[2 * np], da, bv[0], bv[1]);
            mma<T>(dp[2 * np + 1], da, bv[2], bv[3]);
          } else {  // each bf16 part of dO against each of V
            uint32_t vp[bf16_parts<T>()][4];
            to_bf16_parts<T>(bv, vp);
#pragma unroll
            for (int part = 0; part < kDoParts; ++part) {
              const uint32_t* a = part == 0 ? da : dl[part > 0 ? part - 1 : 0];
#pragma unroll
              for (int vq = 0; vq < bf16_parts<T>(); ++vq) {
                mma_bf16(dp[2 * np], a, vp[vq][0], vp[vq][1]);
                mma_bf16(dp[2 * np + 1], a, vp[vq][2], vp[vq][3]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = sub + 8 * j + 2 * (lane & 3) + (e & 1);
          const int half = e >> 1;
          const bool dead = k0 + col >= s.tk || (s.causal && kp[col] > qp[half]) ||
                            below_half_neg_inf(lse_r[half]);
          const float p = dead ? 0.0f : expf(sc[j][e] * s.scale - lse_r[half]);
          dp[j][e] = p * (dp[j][e] - delta_r[half]);
        }
      }
      uint32_t ds_hi[2][4], ds_lo[2][4];  // 16 keys each
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        acc_to_a_split(dp[2 * kk], dp[2 * kk + 1], ds_hi[kk], ds_lo[kk]);
      }
#pragma unroll
      for (int np = 0; np < kSteps; ++np) {
        float dq_step[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          uint32_t bk[4];
          ldsm_x4_t(bk, ks + (sub + 16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * kLd +
                            16 * np + 8 * (lane >> 4));
          mma_split<T>(dq_step[0], ds_hi[kk], ds_lo[kk], bk[0], bk[1]);
          mma_split<T>(dq_step[1], ds_hi[kk], ds_lo[kk], bk[2], bk[3]);
        }
        add_frag(acc[2 * np], dq_step[0]);
        add_frag(acc[2 * np + 1], dq_step[1]);
      }
    }
    if constexpr (kStages == 1) {
      if (next < n_k) {
        __syncthreads();  // every warp is done with the one stage
        load_kv(0);
      }
    }
    kb = next;
  }
  mma_store_rows_f32<DP>(dq + row0 * s.d, r_lo, s.tq, s.d, acc, s.scale);
}

// K9: block (k tile, head, batch); warp w owns keys 16 w .. 16 w + 15 and
// their rows of dK and dV (2 DP / 8 x 4 f32 accumulators a lane: 64 at
// D = 64, 128 at D = 128), and takes each live q tile 16 queries at a
// time, which bounds S^T and dP^T to 8 registers each.  The next live q
// tile's Q, dO, lse, delta and positions are in flight while this one
// computes.
template <typename T, int DP, int kDoParts>
__global__ void __launch_bounds__(kMmaThreads)
    ring_dkv_mma_kernel(const T* __restrict__ q,
                        const T* __restrict__ k,
                        const T* __restrict__ v, const void* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dk, float* __restrict__ dv,
                        const int* __restrict__ q_pos, const int* __restrict__ k_pos,
                        RingShape s) {
  constexpr int kLd = mma_pitch<DP>();
  constexpr int kElems = kTile * kLd;
  constexpr int kN = DP / 8;
  extern __shared__ float4 smem4[];
  T* k_s = reinterpret_cast<T*>(smem4);
  T* v_s = k_s + kElems;
  T* q_s = v_s + kElems;       // two stages
  T* do_s = q_s + 2 * kElems;  // two stages of kDoParts tiles
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * kDoParts * kElems);  // two stages
  float* delta_s = lse_s + 2 * kTile;                                  // two stages
  int* qpos_s = reinterpret_cast<int*>(delta_s + 2 * kTile);           // two stages
  int* red_s = qpos_s + 2 * kTile;
  int* qmax_s = red_s + 2;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = blockIdx.x * kTile;
  const long long q_row0 = ((long long)b * s.heads + h) * s.tq;
  const long long k_row0 = ((long long)b * s.heads + h) * s.tk;
  const T* q_bh = q + b * s.q_sb + h * s.q_sh;
  const int n_q = n_tiles(s.tq);

  int k_min = INT_MIN;
  if (s.causal) {
    tile_pos_extreme<true>(k_pos, k0, s.tk, red_s, nullptr);
    for (int i = warp; i < n_q; i += kMmaWarps) {
      int x = INT_MIN;
#pragma unroll
      for (int c = lane; c < kTile; c += 32) {
        const int t = i * kTile + c;
        if (t < s.tq) x = max(x, q_pos[t]);
      }
      x = __reduce_max_sync(0xffffffffu, x);
      if (lane == 0) qmax_s[i] = x;
    }
    __syncthreads();
    k_min = min(red_s[0], red_s[1]);
  }
  // The first live q tile at or after i (one whose largest position
  // reaches this k tile's smallest); the same in every thread.
  auto next_live = [&](int i) {
    if (s.causal) {
      while (i < n_q && qmax_s[i] < k_min) ++i;
    }
    return i;
  };
  auto load_q_tile = [&](int stage, int qb) {
    const int t0 = qb * kTile;
    T* dos = do_s + stage * kDoParts * kElems;
    mma_load_tile<DP>(q_s + stage * kElems, q_bh, s.q_st, t0, s.tq, s.d);
    if constexpr (kDoParts > 1) {
      mma_load_tile_split<DP, kDoParts>(dos, static_cast<const float*>(dout) + q_row0 * s.d, t0,
                                        s.tq, s.d);
    } else {
      mma_load_tile<DP>(dos, static_cast<const T*>(dout) + q_row0 * s.d, s.d, t0,
                        s.tq, s.d);
    }
    mma_load_rows(lse_s + stage * kTile, lse + q_row0, t0, s.tq);
    mma_load_rows(delta_s + stage * kTile, delta + q_row0, t0, s.tq);
    mma_load_rows(qpos_s + stage * kTile, q_pos, t0, s.tq);
  };
  int qb = next_live(0);
  mma_load_tile<DP>(k_s, k + b * s.kv_sb + h * s.kv_sh, s.kv_st, k0, s.tk, s.d);
  mma_load_tile<DP>(v_s, v + b * s.kv_sb + h * s.kv_sh, s.kv_st, k0, s.tk, s.d);
  if (qb < n_q) load_q_tile(0, qb);
  cp_async_commit();

  // This lane's key rows: r_lo and r_lo + 8 (a key past Tk has no
  // position, masks every query and is not stored).
  const int k_lo = 16 * warp;
  const int r_lo = k0 + k_lo + (lane >> 2);
  int kp[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = r_lo + 8 * half;
    kp[half] = t < s.tk ? k_pos[t] : INT_MAX;
  }
  const int warp_k_min = __reduce_min_sync(0xffffffffu, min(kp[0], kp[1]));
  float dk_acc[kN][4], dv_acc[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk_acc[n][e] = 0.0f;
      dv_acc[n][e] = 0.0f;
    }
  }

  for (int it = 0; qb < n_q; ++it) {
    cp_async_wait_all();
    __syncthreads();
    const int next = next_live(qb + 1);
    if (next < n_q) {
      load_q_tile((it + 1) & 1, next);
      cp_async_commit();
    }
    const int stage = it & 1;
    const T* qs = q_s + stage * kElems;
    const T* dos = do_s + stage * kDoParts * kElems;
    const float* lses = lse_s + stage * kTile;
    const float* deltas = delta_s + stage * kTile;
    const int* qps = qpos_s + stage * kTile;
    const int q0 = qb * kTile;

#pragma unroll 1
    for (int sub = 0; sub < kTile; sub += 16) {
      // All 16 queries before every key of this warp: adds 0.
      if (s.causal && warp_k_min > __reduce_max_sync(0xffffffffu, qps[sub + (lane & 15)])) {
        continue;
      }
      float st[2][4], dpt[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          st[j][e] = 0.0f;
          dpt[j][e] = 0.0f;
        }
      }
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        uint32_t ka[4], va[4], bq[4], bo[4];
        const int a_off = (k_lo + (lane & 15)) * kLd + 16 * kk + 8 * (lane >> 4);
        const int b_off =
            (sub + (lane & 7) + 8 * (lane >> 4)) * kLd + 16 * kk + 8 * ((lane >> 3) & 1);
        ldsm_x4(ka, k_s + a_off);
        ldsm_x4(va, v_s + a_off);
        ldsm_x4(bq, qs + b_off);
        ldsm_x4(bo, dos + b_off);
        mma<T>(st[0], ka, bq[0], bq[1]);
        mma<T>(st[1], ka, bq[2], bq[3]);
        if constexpr (kDoParts == 1) {
          mma<T>(dpt[0], va, bo[0], bo[1]);
          mma<T>(dpt[1], va, bo[2], bo[3]);
        } else {  // each bf16 part of V against each of dO
          uint32_t vp[bf16_parts<T>()][4];
          to_bf16_parts<T>(va, vp);
#pragma unroll
          for (int part = 0; part < kDoParts; ++part) {
            if (part > 0) ldsm_x4(bo, dos + part * kElems + b_off);
#pragma unroll
            for (int vq = 0; vq < bf16_parts<T>(); ++vq) {
              mma_bf16(dpt[0], vp[vq], bo[0], bo[1]);
              mma_bf16(dpt[1], vp[vq], bo[2], bo[3]);
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = sub + 8 * j + 2 * (lane & 3) + (e & 1);
          const bool dead = q0 + col >= s.tq || (s.causal && kp[e >> 1] > qps[col]) ||
                            below_half_neg_inf(lses[col]);
          const float p = dead ? 0.0f : expf(st[j][e] * s.scale - lses[col]);
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - deltas[col]);
        }
      }
      uint32_t p_hi[4], p_lo[4], ds_hi[4], ds_lo[4];
      acc_to_a_split(st[0], st[1], p_hi, p_lo);
      acc_to_a_split(dpt[0], dpt[1], ds_hi, ds_lo);
      // 8 columns a step (ldmatrix.x2): with 16, as in K6, the D = 64
      // build spills at the 128 registers ptxas gives it.
#pragma unroll
      for (int nb = 0; nb < DP / 8; ++nb) {
        uint32_t bo[2], bq[2];
        const int b_off = (sub + (lane & 7) + 8 * ((lane >> 3) & 1)) * kLd + 8 * nb;
        float dv_step[4] = {};
#pragma unroll
        for (int part = 0; part < kDoParts; ++part) {  // each part of P times each of dO
          ldsm_x2_t(bo, dos + part * kElems + b_off);
          mma_split<DoElem<T, kDoParts>>(dv_step, p_hi, p_lo, bo[0], bo[1]);
        }
        add_frag(dv_acc[nb], dv_step);
        ldsm_x2_t(bq, qs + b_off);
        float dk_step[4] = {};
        mma_split<T>(dk_step, ds_hi, ds_lo, bq[0], bq[1]);
        add_frag(dk_acc[nb], dk_step);
      }
    }
    qb = next;
  }
  mma_store_rows_f32<DP>(dk + k_row0 * s.d, r_lo, s.tk, s.d, dk_acc, s.scale);
  mma_store_rows_f32<DP>(dv + k_row0 * s.d, r_lo, s.tk, s.d, dv_acc, 1.0f);
}

// ---------------------------------------------------------------------
// K9 on the tensor cores at DP = 256 (128 < d <= 256).  One warp cannot
// hold its 16 key rows of both dK and dV there (256 f32 a thread), so,
// as in flash_dkv_mma_pair_kernel, eight warps: a pair for each 16 key
// rows, each warp of a pair owning half of the D columns of those rows
// of dK and dV (128 accumulators).  Per 16 queries of the q tile, warp 0
// of the pair computes S^T = K Q^T and P (scaled, masked by position and
// by the final lse as ring_dkv_mma_kernel does), warp 1 dP^T = V dO^T
// (one product per part of dO); each writes its 16 x 16 f32 fragment to
// the pair's exchange buffer, a barrier of the pair's 64 threads
// follows, and both form dS = P (dP^T - delta) from both fragments.
// Then each adds P^T dO into its columns of dV and dS^T Q into its
// columns of dK, 8 columns a step, each step's products in a fresh
// fragment (add_frag), P and dS split hi/lo as in ring_dkv_mma_kernel.
// Every accumulator element gets the same products in the same order as
// in the four-warp build.  Both warps of a pair hold the same key rows,
// so they skip the same steps.  With an f32 dO one set of Q, dO, lse,
// delta and positions is staged (ring_stages).
// ---------------------------------------------------------------------
template <typename T, int DP, int kDoParts>
__global__ void __launch_bounds__(kPairThreads)
    ring_dkv_mma_pair_kernel(const T* __restrict__ q,
                             const T* __restrict__ k,
                             const T* __restrict__ v, const void* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             float* __restrict__ dk, float* __restrict__ dv,
                             const int* __restrict__ q_pos, const int* __restrict__ k_pos,
                             RingShape s) {
  constexpr int kLd = mma_pitch<DP>();
  constexpr int kElems = kTile * kLd;
  constexpr int kNh = DP / 16;  // 8-column fragments in a warp's half of D
  constexpr int kStages = ring_stages<DP, kDoParts>();
  extern __shared__ float4 smem4[];
  T* k_s = reinterpret_cast<T*>(smem4);
  T* v_s = k_s + kElems;
  T* q_s = v_s + kElems;             // kStages stages
  T* do_s = q_s + kStages * kElems;  // kStages stages of kDoParts tiles
  float* xch = reinterpret_cast<float*>(do_s + kStages * kDoParts * kElems);  // kMmaWarps pairs
  float* lse_s = xch + kMmaWarps * kXchFloats;                  // kStages stages
  float* delta_s = lse_s + kStages * kTile;                      // kStages stages
  int* qpos_s = reinterpret_cast<int*>(delta_s + kStages * kTile);  // kStages stages
  int* red_s = qpos_s + kStages * kTile;
  int* qmax_s = red_s + 2;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int pair = warp >> 1;  // key rows 16 pair .. 16 pair + 15
  const int role = warp & 1;   // 0: S^T and P, 1: dP^T; its half of the D columns
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = blockIdx.x * kTile;
  const long long q_row0 = ((long long)b * s.heads + h) * s.tq;
  const long long k_row0 = ((long long)b * s.heads + h) * s.tk;
  const T* q_bh = q + b * s.q_sb + h * s.q_sh;
  const int n_q = n_tiles(s.tq);

  int k_min = INT_MIN;
  if (s.causal) {
    tile_pos_extreme<true>(k_pos, k0, s.tk, red_s, nullptr);
    for (int i = warp; i < n_q; i += 2 * kMmaWarps) {
      int x = INT_MIN;
#pragma unroll
      for (int c = lane; c < kTile; c += 32) {
        const int t = i * kTile + c;
        if (t < s.tq) x = max(x, q_pos[t]);
      }
      x = __reduce_max_sync(0xffffffffu, x);
      if (lane == 0) qmax_s[i] = x;
    }
    __syncthreads();
    k_min = min(red_s[0], red_s[1]);
  }
  // The first live q tile at or after i; the same in every thread.
  auto next_live = [&](int i) {
    if (s.causal) {
      while (i < n_q && qmax_s[i] < k_min) ++i;
    }
    return i;
  };
  auto load_q_tile = [&](int stage, int qb) {
    const int t0 = qb * kTile;
    T* dos = do_s + stage * kDoParts * kElems;
    mma_load_tile<DP, kPairThreads>(q_s + stage * kElems, q_bh, s.q_st, t0, s.tq, s.d);
    if constexpr (kDoParts > 1) {
      mma_load_tile_split<DP, kDoParts, kPairThreads>(
          dos, static_cast<const float*>(dout) + q_row0 * s.d, t0, s.tq, s.d);
    } else {
      mma_load_tile<DP, kPairThreads>(dos, static_cast<const T*>(dout) + q_row0 * s.d,
                                      s.d, t0, s.tq, s.d);
    }
    mma_load_rows(lse_s + stage * kTile, lse + q_row0, t0, s.tq);
    mma_load_rows(delta_s + stage * kTile, delta + q_row0, t0, s.tq);
    mma_load_rows(qpos_s + stage * kTile, q_pos, t0, s.tq);
  };
  int qb = next_live(0);
  mma_load_tile<DP, kPairThreads>(k_s, k + b * s.kv_sb + h * s.kv_sh, s.kv_st, k0, s.tk, s.d);
  mma_load_tile<DP, kPairThreads>(v_s, v + b * s.kv_sb + h * s.kv_sh, s.kv_st, k0, s.tk, s.d);
  if (qb < n_q) load_q_tile(0, qb);
  cp_async_commit();

  // This lane's key rows: r_lo and r_lo + 8 (a key past Tk has no
  // position, masks every query and is not stored).
  const int k_lo = 16 * pair;
  const int r_lo = k0 + k_lo + (lane >> 2);
  const int c_half = role * (DP / 2);
  int kp[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = r_lo + 8 * half;
    kp[half] = t < s.tk ? k_pos[t] : INT_MAX;
  }
  const int warp_k_min = __reduce_min_sync(0xffffffffu, min(kp[0], kp[1]));
  // This warp's product: K and Q for S^T, V and dO for dP^T.
  const T* a_s = role == 0 ? k_s : v_s;
  float* xch_pair = xch + pair * kXchFloats;
  int n_xch = 0;  // exchanges so far: they alternate between the two buffers
  float dk_acc[kNh][4], dv_acc[kNh][4];
#pragma unroll
  for (int n = 0; n < kNh; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk_acc[n][e] = 0.0f;
      dv_acc[n][e] = 0.0f;
    }
  }

  for (int it = 0; qb < n_q; ++it) {
    cp_async_wait_all();
    __syncthreads();
    const int next = next_live(qb + 1);
    if constexpr (kStages == 2) {
      if (next < n_q) {
        load_q_tile((it + 1) & 1, next);
        cp_async_commit();
      }
    }
    const int stage = kStages == 2 ? (it & 1) : 0;
    const T* qs = q_s + stage * kElems;
    const T* dos = do_s + stage * kDoParts * kElems;
    const T* b_s = role == 0 ? qs : dos;
    const float* lses = lse_s + stage * kTile;
    const float* deltas = delta_s + stage * kTile;
    const int* qps = qpos_s + stage * kTile;
    const int q0 = qb * kTile;

#pragma unroll 1
    for (int sub = 0; sub < kTile; sub += 16) {
      // All 16 queries before every key of this pair: adds 0.
      if (s.causal && warp_k_min > __reduce_max_sync(0xffffffffu, qps[sub + (lane & 15)])) {
        continue;
      }
      float* xb = xch_pair + (n_xch & 1) * 512;
      ++n_xch;
      float x[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) x[j][e] = 0.0f;
      }
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        uint32_t a[4], bb[4];
        const int b_off =
            (sub + (lane & 7) + 8 * (lane >> 4)) * kLd + 16 * kk + 8 * ((lane >> 3) & 1);
        ldsm_x4(a, a_s + (k_lo + (lane & 15)) * kLd + 16 * kk + 8 * (lane >> 4));
        ldsm_x4(bb, b_s + b_off);
        if (kDoParts == 1 || bf16_parts<T>() == 1 || role == 0) {
          mma<T>(x[0], a, bb[0], bb[1]);
          mma<T>(x[1], a, bb[2], bb[3]);
          if (role == 1) {
#pragma unroll
            for (int part = 1; part < kDoParts; ++part) {  // an f32 dO's other parts
              ldsm_x4(bb, dos + part * kElems + b_off);
              mma_bf16(x[0], a, bb[0], bb[1]);
              mma_bf16(x[1], a, bb[2], bb[3]);
            }
          }
        } else {  // f16 V's two bf16 parts against each bf16 part of an f32 dO
          uint32_t vp[bf16_parts<T>()][4];
          to_bf16_parts<T>(a, vp);
#pragma unroll
          for (int part = 0; part < kDoParts; ++part) {
            if (part > 0) ldsm_x4(bb, dos + part * kElems + b_off);
#pragma unroll
            for (int vq = 0; vq < bf16_parts<T>(); ++vq) {
              mma_bf16(x[0], vp[vq], bb[0], bb[1]);
              mma_bf16(x[1], vp[vq], bb[2], bb[3]);
            }
          }
        }
      }
      if (role == 0) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = sub + 8 * j + 2 * (lane & 3) + (e & 1);
            const bool dead = q0 + col >= s.tq || (s.causal && kp[e >> 1] > qps[col]) ||
                              below_half_neg_inf(lses[col]);
            x[j][e] = dead ? 0.0f : expf(x[j][e] * s.scale - lses[col]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) xb[role * 256 + i * 32 + lane] = x[i >> 2][i & 3];
      pair_barrier(pair);
      float p[2][4], ds[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = sub + 8 * j + 2 * (lane & 3) + (e & 1);
          p[j][e] = xb[(4 * j + e) * 32 + lane];
          ds[j][e] = p[j][e] * (xb[256 + (4 * j + e) * 32 + lane] - deltas[col]);
        }
      }
      uint32_t p_hi[4], p_lo[4], ds_hi[4], ds_lo[4];
      acc_to_a_split(p[0], p[1], p_hi, p_lo);
      acc_to_a_split(ds[0], ds[1], ds_hi, ds_lo);
#pragma unroll
      for (int nb = 0; nb < kNh; ++nb) {
        uint32_t bo[2], bq[2];
        const int b_off = (sub + (lane & 7) + 8 * ((lane >> 3) & 1)) * kLd + c_half + 8 * nb;
        float dv_step[4] = {};
#pragma unroll
        for (int part = 0; part < kDoParts; ++part) {  // each part of P times each of dO
          ldsm_x2_t(bo, dos + part * kElems + b_off);
          mma_split<DoElem<T, kDoParts>>(dv_step, p_hi, p_lo, bo[0], bo[1]);
        }
        add_frag(dv_acc[nb], dv_step);
        ldsm_x2_t(bq, qs + b_off);
        float dk_step[4] = {};
        mma_split<T>(dk_step, ds_hi, ds_lo, bq[0], bq[1]);
        add_frag(dk_acc[nb], dk_step);
      }
    }
    if constexpr (kStages == 1) {
      if (next < n_q) {
        __syncthreads();  // every warp is done with the one stage
        load_q_tile(0, next);
        cp_async_commit();
      }
    }
    qb = next;
  }
  mma_store_cols_f32<kNh>(dk + k_row0 * s.d, r_lo, s.tk, s.d, c_half, dk_acc, s.scale);
  mma_store_cols_f32<kNh>(dv + k_row0 * s.d, r_lo, s.tk, s.d, c_half, dv_acc, 1.0f);
}

// The tensor-core builds of K8 and K9 take what K7's take and a
// 16-byte-aligned dO, of T or f32 (the wrapper copies one that lacks it).
template <typename T, int DP, int kDoParts>
cudaError_t launch_ring_dq_mma(const void* q, const void* k, const void* v, const void* dout,
                               const float* lse, const float* delta, float* dq,
                               const int* q_pos, const int* k_pos, int batch,
                               const RingShape& s, cudaStream_t st) {
  if (!ring_mma_inputs_ok(q, k, v, s) || !aligned16(dout)) return cudaErrorMisalignedAddress;
  const int bytes = ring_dq_mma_smem_bytes<DP, kDoParts>((s.tk + kTile - 1) / kTile);
  cudaError_t err = allow_smem(ring_dq_mma_kernel<T, DP, kDoParts>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((s.tq + kTile - 1) / kTile, s.heads, batch);
  ring_dq_mma_kernel<T, DP, kDoParts><<<grid, kMmaThreads, bytes, st>>>(
      (const T*)q, (const T*)k, (const T*)v, dout, lse,
      delta, dq, q_pos, k_pos, s);
  return cudaGetLastError();
}

template <typename T, int DP, int kDoParts>
cudaError_t launch_ring_dkv_mma(const void* q, const void* k, const void* v, const void* dout,
                                const float* lse, const float* delta, float* dk, float* dv,
                                const int* q_pos, const int* k_pos, int batch,
                                const RingShape& s, cudaStream_t st) {
  if (!ring_mma_inputs_ok(q, k, v, s) || !aligned16(dout)) return cudaErrorMisalignedAddress;
  const int bytes = ring_dkv_mma_smem_bytes<DP, kDoParts>((s.tq + kTile - 1) / kTile);
  const dim3 grid((s.tk + kTile - 1) / kTile, s.heads, batch);
  if constexpr (DP > 128) {  // two warps for each 16 key rows
    cudaError_t err = allow_smem(ring_dkv_mma_pair_kernel<T, DP, kDoParts>, bytes);
    if (err != cudaSuccess) return err;
    ring_dkv_mma_pair_kernel<T, DP, kDoParts><<<grid, kPairThreads, bytes, st>>>(
        (const T*)q, (const T*)k, (const T*)v, dout, lse,
        delta, dk, dv, q_pos, k_pos, s);
  } else {
    cudaError_t err = allow_smem(ring_dkv_mma_kernel<T, DP, kDoParts>, bytes);
    if (err != cudaSuccess) return err;
    ring_dkv_mma_kernel<T, DP, kDoParts><<<grid, kMmaThreads, bytes, st>>>(
        (const T*)q, (const T*)k, (const T*)v, dout, lse,
        delta, dk, dv, q_pos, k_pos, s);
  }
  return cudaGetLastError();
}

}  // namespace
