// The tensor-core builds of K4-K6 (flash_fwd_mma_kernel,
// flash_dq_mma_kernel, flash_dkv_mma_kernel and, at DP = 256,
// flash_dkv_mma_pair_kernel) and their launchers, as templates on the
// input's 2-byte element type T.  flash_attention.cu instantiates them
// for bf16 and flash_attention_f16.cu for f16, so the two builds compile
// in parallel (ops/_build.py); the f16 launchers cross between the two
// units through edl_flash::*_f16 below.  flash_attention.cu sets out the
// design and the roundings; what differs in f16:
//
// - The products whose operands are both inputs run natively in f16: S =
//   Q K^T, dP = dO V^T, and P V with P rounded to f16 (JAX's
//   p.astype(v.dtype)); f32 accumulators throughout.
// - The products with an f32 operand (dQ += dS K in K5; dV += P^T dO and
//   dK += dS^T Q in K6) split that operand into bf16 hi and lo, as the
//   bf16 builds do, and split the f16 tile operand exactly into two bf16
//   parts (mma_split): three bf16 products.  bf16 keeps f32's exponent
//   range, and at a long batch's gradient scale (|dO| near 1e-6, dS near
//   1e-9 and below) f16 has none left: its normal range ends at 6.1e-5
//   and its last subnormal is 6e-8, so an f16 hi/lo split of P or dS
//   would flush dQ and dK towards zero.

#pragma once

#include "flash_common.cuh"

namespace edl_flash {

struct Shape {
  int heads, t_len, d;
  long long in_sb, in_st, in_sh;  // strides of q, k, v (elements)
  float scale;
  int causal;
};

// The f16 launchers, compiled in flash_attention_f16.cu for DP = 64,
// 128 and 256; each returns cudaGetLastError() of its launch.
template <int DP>
cudaError_t fwd_f16(const void* q, const void* k, const void* v, void* out, float* lse,
                    int batch, const Shape& s, cudaStream_t st);
template <int DP>
cudaError_t dq_f16(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, void* dq, int batch, const Shape& s,
                   cudaStream_t st);
template <int DP>
cudaError_t dkv_f16(const void* q, const void* k, const void* v, const void* dout,
                    const float* lse, const float* delta, void* dk, void* dv, int batch,
                    const Shape& s, cudaStream_t st);

}  // namespace edl_flash

namespace {

using edl_flash::Shape;

// ---------------------------------------------------------------------
// K4 on the tensor cores.  Block (q tile, head, batch), as
// flash_fwd_kernel; warp w owns q rows 16 w .. 16 w + 15 and keeps them
// in registers as A fragments.  Per 64-key tile: S = Q K^T by mma from
// the unscaled q (the product of two bf16 or two f16 is exact in f32),
// times `scale` in f32; the online softmax of flash_fwd_kernel per 64
// keys (l sums the unrounded p); P rounded to T straight from S's
// accumulators into the A fragments of P V.  Registers: at DP = 256 a
// warp's 16 rows of O take 128 f32 a thread, so the warp reads its Q
// fragments from shared memory by ldmatrix at each 16-column step
// instead of holding them (64 more registers), as K5 does above D = 64.
// ---------------------------------------------------------------------
template <typename T, int DP>
__global__ void __launch_bounds__(kMmaThreads)
    flash_fwd_mma_kernel(const T* __restrict__ q,
                         const T* __restrict__ k,
                         const T* __restrict__ v,
                         T* __restrict__ out, float* __restrict__ lse, Shape s) {
  constexpr int kLd = mma_pitch<DP>();
  constexpr int kElems = kTile * kLd;
  constexpr int kN = DP / 8;  // 8-column fragments of a row of out
  constexpr bool kHoldQ = DP <= 128;  // Q's A fragments in registers
  extern __shared__ float4 smem4[];
  T* q_s = reinterpret_cast<T*>(smem4);
  T* k_s = q_s + kElems;      // two stages
  T* v_s = k_s + 2 * kElems;  // two stages
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_q = n_tiles(s.t_len);
  const int qi = s.causal ? n_q - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long in_off = b * s.in_sb + h * s.in_sh;
  const int q0 = qi * kTile;
  int n_k = n_tiles(s.t_len);
  if (s.causal) n_k = min(n_k, (q0 + kTile + kTile - 1) / kTile);

  mma_load_tile<DP>(q_s, q + in_off, s.in_st, q0, s.t_len, s.d);
  mma_load_tile<DP>(k_s, k + in_off, s.in_st, 0, s.t_len, s.d);
  mma_load_tile<DP>(v_s, v + in_off, s.in_st, 0, s.t_len, s.d);
  cp_async_commit();

  // This lane's rows of the tile: r_lo and r_lo + 8.
  const int r_lo = q0 + 16 * warp + (lane >> 2);
  const int a_row = (16 * warp + (lane & 15)) * kLd + 8 * (lane >> 4);
  uint32_t qf[kHoldQ ? DP / 16 : 1][4];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f}, o[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  }

  for (int kb = 0; kb < n_k; ++kb) {
    // Tile kb has landed, and every warp is done with tile kb - 1, whose
    // stage the next copy overwrites.
    cp_async_wait_all();
    __syncthreads();
    if constexpr (kHoldQ) {
      if (kb == 0) {
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) ldsm_x4(qf[kk], q_s + a_row + 16 * kk);
      }
    }
    if (kb + 1 < n_k) {
      const int stage = (kb + 1) & 1;
      mma_load_tile<DP>(k_s + stage * kElems, k + in_off, s.in_st, (kb + 1) * kTile, s.t_len,
                        s.d);
      mma_load_tile<DP>(v_s + stage * kElems, v + in_off, s.in_st, (kb + 1) * kTile, s.t_len,
                        s.d);
      cp_async_commit();
    }
    const T* ks = k_s + (kb & 1) * kElems;
    const T* vs = v_s + (kb & 1) * kElems;

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
      const int q_pos = r_lo + 8 * half;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k_pos = k0 + 8 * j + 2 * (lane & 3) + e;
          float x = sc[j][2 * half + e] * s.scale;
          if (k_pos >= s.t_len || (s.causal && k_pos > q_pos)) x = kNegInf;
          sc[j][2 * half + e] = x;
          mx = fmaxf(mx, x);
        }
      }
      const float m_new = fmaxf(m[half], quad_max(mx));
      const float corr = expf(m[half] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = expf(sc[j][2 * half + e] - m_new);
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
  }

  const long long o_st = (long long)s.heads * s.d;
  T* out_bh = out + (long long)b * s.t_len * o_st + (long long)h * s.d;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const float l_safe = l[half] == 0.0f ? 1.0f : l[half];
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      o[n][2 * half] = o[n][2 * half] / l_safe;
      o[n][2 * half + 1] = o[n][2 * half + 1] / l_safe;
    }
    const int t = r_lo + 8 * half;
    if ((lane & 3) == 0 && t < s.t_len) {
      lse[((long long)b * s.heads + h) * s.t_len + t] = m[half] + logf(l_safe);
    }
  }
  mma_store_rows<DP>(out_bh, o_st, r_lo, s.t_len, s.d, o, 1.0f);
}

// ---------------------------------------------------------------------
// K6 on the tensor cores.  Block (k tile, head, batch), as
// flash_dkv_kernel, looping over the q tiles from the causal first; the
// next q tile's Q, dO, lse and delta are in flight while this one
// computes.  Warp w owns keys 16 w .. 16 w + 15 and its rows of dK and
// dV; it takes the q tile 16 queries at a time (which bounds S^T and
// dP^T to 8 registers each) and skips the 16 whose queries all precede
// its keys under the causal mask.  S^T = K Q^T and dP^T = V dO^T by mma
// (exact products, f32 sums), S^T times `scale` in f32; P = exp(S^T -
// lse) and dS = P (dP^T - delta) in f32 registers.  dV += P^T dO and dK
// += dS^T Q take P and dS from those registers as A fragments, each
// split into hi = bf16(x) and lo = bf16(x - hi) and taken against dO
// and Q by mma_split: the reference keeps P and dS in f32, and one bf16
// rounding of them puts dk past the kernels' bf16 tolerance.
// ---------------------------------------------------------------------
template <typename T, int DP>
__global__ void __launch_bounds__(kMmaThreads)
    flash_dkv_mma_kernel(const T* __restrict__ q,
                         const T* __restrict__ k,
                         const T* __restrict__ v,
                         const T* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv,
                         Shape s) {
  constexpr int kLd = mma_pitch<DP>();
  constexpr int kElems = kTile * kLd;
  constexpr int kN = DP / 8;
  extern __shared__ float4 smem4[];
  T* k_s = reinterpret_cast<T*>(smem4);
  T* v_s = k_s + kElems;
  T* q_s = v_s + kElems;       // two stages
  T* do_s = q_s + 2 * kElems;  // two stages
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * kElems);  // two stages
  float* delta_s = lse_s + 2 * kTile;                          // two stages
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int kj = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long in_off = b * s.in_sb + h * s.in_sh;
  const long long o_st = (long long)s.heads * s.d;
  const long long o_off = (long long)b * s.t_len * o_st + (long long)h * s.d;
  const long long row_off = ((long long)b * s.heads + h) * s.t_len;
  const int k0 = kj * kTile;
  const int n_q = n_tiles(s.t_len);
  // Causal: q tiles wholly before this k tile see none of it.
  const int q_first = s.causal ? kj : 0;

  mma_load_tile<DP>(k_s, k + in_off, s.in_st, k0, s.t_len, s.d);
  mma_load_tile<DP>(v_s, v + in_off, s.in_st, k0, s.t_len, s.d);
  mma_load_tile<DP>(q_s, q + in_off, s.in_st, q_first * kTile, s.t_len, s.d);
  mma_load_tile<DP>(do_s, dout + o_off, o_st, q_first * kTile, s.t_len, s.d);
  mma_load_rows(lse_s, lse + row_off, q_first * kTile, s.t_len);
  mma_load_rows(delta_s, delta + row_off, q_first * kTile, s.t_len);
  cp_async_commit();

  // This lane's key rows: r_lo and r_lo + 8.
  const int k_lo = 16 * warp;
  const int r_lo = k0 + k_lo + (lane >> 2);
  float dk_acc[kN][4], dv_acc[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk_acc[n][e] = 0.0f;
      dv_acc[n][e] = 0.0f;
    }
  }

  for (int qb = q_first; qb < n_q; ++qb) {
    const int it = qb - q_first;
    cp_async_wait_all();
    __syncthreads();
    if (qb + 1 < n_q) {
      const int stage = (it + 1) & 1;
      const int t0 = (qb + 1) * kTile;
      mma_load_tile<DP>(q_s + stage * kElems, q + in_off, s.in_st, t0, s.t_len, s.d);
      mma_load_tile<DP>(do_s + stage * kElems, dout + o_off, o_st, t0, s.t_len, s.d);
      mma_load_rows(lse_s + stage * kTile, lse + row_off, t0, s.t_len);
      mma_load_rows(delta_s + stage * kTile, delta + row_off, t0, s.t_len);
      cp_async_commit();
    }
    const T* qs = q_s + (it & 1) * kElems;
    const T* dos = do_s + (it & 1) * kElems;
    const float* lses = lse_s + (it & 1) * kTile;
    const float* deltas = delta_s + (it & 1) * kTile;
    const int q0 = qb * kTile;

#pragma unroll 1
    for (int sub = 0; sub < kTile; sub += 16) {
      if (s.causal && k0 + k_lo > q0 + sub + 15) continue;  // all masked: adds 0
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
        mma<T>(dpt[0], va, bo[0], bo[1]);
        mma<T>(dpt[1], va, bo[2], bo[3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = sub + 8 * j + 2 * (lane & 3) + (e & 1);
          const int q_pos = q0 + col;
          const int k_pos = r_lo + 8 * (e >> 1);
          const float sv = (q_pos >= s.t_len || (s.causal && k_pos > q_pos))
                               ? kNegInf
                               : st[j][e] * s.scale;
          const float p = expf(sv - lses[col]);
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - deltas[col]);
        }
      }
      uint32_t p_hi[4], p_lo[4], ds_hi[4], ds_lo[4];
      acc_to_a_split(st[0], st[1], p_hi, p_lo);
      acc_to_a_split(dpt[0], dpt[1], ds_hi, ds_lo);
#pragma unroll
      for (int np = 0; np < DP / 16; ++np) {
        uint32_t bo[4], bq[4];
        const int b_off =
            (sub + (lane & 7) + 8 * ((lane >> 3) & 1)) * kLd + 16 * np + 8 * (lane >> 4);
        ldsm_x4_t(bo, dos + b_off);
        ldsm_x4_t(bq, qs + b_off);
        mma_split<T>(dv_acc[2 * np], p_hi, p_lo, bo[0], bo[1]);
        mma_split<T>(dv_acc[2 * np + 1], p_hi, p_lo, bo[2], bo[3]);
        mma_split<T>(dk_acc[2 * np], ds_hi, ds_lo, bq[0], bq[1]);
        mma_split<T>(dk_acc[2 * np + 1], ds_hi, ds_lo, bq[2], bq[3]);
      }
    }
  }
  mma_store_rows<DP>(dk + o_off, o_st, r_lo, s.t_len, s.d, dk_acc, s.scale);
  mma_store_rows<DP>(dv + o_off, o_st, r_lo, s.t_len, s.d, dv_acc, 1.0f);
}

// ---------------------------------------------------------------------
// K6 on the tensor cores at DP = 256 (128 < d <= 256).  One warp cannot
// hold its 16 key rows of both dK and dV there: 2 x 16 x 256 / 32 = 256
// f32 a thread, past the 255-register limit.  So eight warps, a pair for
// each 16 key rows, and each warp of a pair owns half of the D columns
// of those rows of dK and dV (128 accumulators).  Per 16 queries of the
// q tile the pair splits the two products over D between them, and not
// D itself: warp 0 of the pair computes S^T = K Q^T, scaled in f32 and
// masked, and P = exp(S^T - lse); warp 1 computes dP^T = V dO^T.  Each
// writes its 16 x 16 f32 fragment to the pair's exchange buffer (lane
// order, so neither side conflicts on a bank), a barrier of the pair's
// 64 threads follows, and both warps read both fragments back and form
// dS = P (dP^T - delta) in the same f32 operations as
// flash_dkv_mma_kernel.  Then each adds P^T dO into its columns of dV and
// dS^T Q into its columns of dK, P and dS split hi/lo as there.  Every
// accumulator element gets the same products in the same order as in
// the four-warp build: the split moves work between warps and changes
// no rounding.  The exchange buffers alternate between consecutive
// exchanges, so one barrier per exchange suffices: a warp overwrites a
// buffer only after the barrier that its partner reaches once done
// reading it.
// ---------------------------------------------------------------------
template <int DP>
__host__ __device__ constexpr int dkv_pair_smem_bytes() {
  // K, V, two stages of (Q, dO, lse, delta), the pairs' exchange buffers.
  return 6 * mma_tile_bytes<DP>() + 2 * 2 * kTile * 4 + kMmaWarps * kXchFloats * 4;
}

template <typename T, int DP>
__global__ void __launch_bounds__(kPairThreads)
    flash_dkv_mma_pair_kernel(const T* __restrict__ q,
                              const T* __restrict__ k,
                              const T* __restrict__ v,
                              const T* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              T* __restrict__ dk, T* __restrict__ dv,
                              Shape s) {
  constexpr int kLd = mma_pitch<DP>();
  constexpr int kElems = kTile * kLd;
  constexpr int kNh = DP / 16;  // 8-column fragments in a warp's half of D
  extern __shared__ float4 smem4[];
  T* k_s = reinterpret_cast<T*>(smem4);
  T* v_s = k_s + kElems;
  T* q_s = v_s + kElems;       // two stages
  T* do_s = q_s + 2 * kElems;  // two stages
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * kElems);  // two stages
  float* delta_s = lse_s + 2 * kTile;                          // two stages
  float* xch = delta_s + 2 * kTile;                            // kMmaWarps pairs
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int pair = warp >> 1;  // key rows 16 pair .. 16 pair + 15
  const int part = warp & 1;   // 0: S^T and P, 1: dP^T; its half of the D columns
  const int kj = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long in_off = b * s.in_sb + h * s.in_sh;
  const long long o_st = (long long)s.heads * s.d;
  const long long o_off = (long long)b * s.t_len * o_st + (long long)h * s.d;
  const long long row_off = ((long long)b * s.heads + h) * s.t_len;
  const int k0 = kj * kTile;
  const int n_q = n_tiles(s.t_len);
  const int q_first = s.causal ? kj : 0;

  mma_load_tile<DP, kPairThreads>(k_s, k + in_off, s.in_st, k0, s.t_len, s.d);
  mma_load_tile<DP, kPairThreads>(v_s, v + in_off, s.in_st, k0, s.t_len, s.d);
  mma_load_tile<DP, kPairThreads>(q_s, q + in_off, s.in_st, q_first * kTile, s.t_len, s.d);
  mma_load_tile<DP, kPairThreads>(do_s, dout + o_off, o_st, q_first * kTile, s.t_len, s.d);
  mma_load_rows(lse_s, lse + row_off, q_first * kTile, s.t_len);
  mma_load_rows(delta_s, delta + row_off, q_first * kTile, s.t_len);
  cp_async_commit();

  const int k_lo = 16 * pair;
  const int r_lo = k0 + k_lo + (lane >> 2);
  const int c_half = part * (DP / 2);
  // This warp's product: K and Q for S^T, V and dO for dP^T.
  const T* a_s = part == 0 ? k_s : v_s;
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

  for (int qb = q_first; qb < n_q; ++qb) {
    const int it = qb - q_first;
    cp_async_wait_all();
    __syncthreads();
    if (qb + 1 < n_q) {
      const int stage = (it + 1) & 1;
      const int t0 = (qb + 1) * kTile;
      mma_load_tile<DP, kPairThreads>(q_s + stage * kElems, q + in_off, s.in_st, t0, s.t_len,
                                      s.d);
      mma_load_tile<DP, kPairThreads>(do_s + stage * kElems, dout + o_off, o_st, t0, s.t_len,
                                      s.d);
      mma_load_rows(lse_s + stage * kTile, lse + row_off, t0, s.t_len);
      mma_load_rows(delta_s + stage * kTile, delta + row_off, t0, s.t_len);
      cp_async_commit();
    }
    const T* qs = q_s + (it & 1) * kElems;
    const T* dos = do_s + (it & 1) * kElems;
    const T* b_s = part == 0 ? qs : dos;
    const float* lses = lse_s + (it & 1) * kTile;
    const float* deltas = delta_s + (it & 1) * kTile;
    const int q0 = qb * kTile;

#pragma unroll 1
    for (int sub = 0; sub < kTile; sub += 16) {
      if (s.causal && k0 + k_lo > q0 + sub + 15) continue;  // all masked: adds 0
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
        ldsm_x4(a, a_s + (k_lo + (lane & 15)) * kLd + 16 * kk + 8 * (lane >> 4));
        ldsm_x4(bb, b_s + (sub + (lane & 7) + 8 * (lane >> 4)) * kLd + 16 * kk +
                        8 * ((lane >> 3) & 1));
        mma<T>(x[0], a, bb[0], bb[1]);
        mma<T>(x[1], a, bb[2], bb[3]);
      }
      if (part == 0) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = sub + 8 * j + 2 * (lane & 3) + (e & 1);
            const int q_pos = q0 + col;
            const int k_pos = r_lo + 8 * (e >> 1);
            const float sv = (q_pos >= s.t_len || (s.causal && k_pos > q_pos))
                                 ? kNegInf
                                 : x[j][e] * s.scale;
            x[j][e] = expf(sv - lses[col]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) xb[part * 256 + i * 32 + lane] = x[i >> 2][i & 3];
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
      for (int np = 0; np < DP / 32; ++np) {
        uint32_t bo[4], bq[4];
        const int b_off = (sub + (lane & 7) + 8 * ((lane >> 3) & 1)) * kLd + c_half + 16 * np +
                          8 * (lane >> 4);
        ldsm_x4_t(bo, dos + b_off);
        ldsm_x4_t(bq, qs + b_off);
        mma_split<T>(dv_acc[2 * np], p_hi, p_lo, bo[0], bo[1]);
        mma_split<T>(dv_acc[2 * np + 1], p_hi, p_lo, bo[2], bo[3]);
        mma_split<T>(dk_acc[2 * np], ds_hi, ds_lo, bq[0], bq[1]);
        mma_split<T>(dk_acc[2 * np + 1], ds_hi, ds_lo, bq[2], bq[3]);
      }
    }
  }
  mma_store_cols<kNh>(dk + o_off, o_st, r_lo, s.t_len, s.d, c_half, dk_acc, s.scale);
  mma_store_cols<kNh>(dv + o_off, o_st, r_lo, s.t_len, s.d, c_half, dv_acc, 1.0f);
}

// ---------------------------------------------------------------------
// K5 on the tensor cores.  Block (q tile, head, batch), as
// flash_dq_kernel, looping over the K/V tiles up to the causal diagonal;
// the next tile's K and V are in flight while this one computes (two
// stages, as in K4).  Warp w owns q rows 16 w .. 16 w + 15 and their
// rows of dQ; it takes a K/V tile 32 keys at a time (which bounds S and
// dP to 16 registers each) and skips the 32 whose keys all follow its
// rows under the causal mask.  S = Q K^T and dP = dO V^T by mma from the
// unscaled q and dO of T (exact products, f32 sums), S times
// `scale` in f32 and masked; P = exp(S - lse) and dS = P (dP - delta) in
// f32 registers.  dQ += dS K takes dS from those registers as A
// fragments split into hi = bf16(x) and lo = bf16(x - hi), taken against
// K by mma_split, with K through ldmatrix.trans as V in K4's P V: the
// reference keeps dS in f32, and one bf16 rounding of it puts dq past
// the kernels' bf16 tolerance.  Registers: at D = 64 the warp holds its
// Q and dO rows as A fragments; at D = 128, whose dQ takes 64
// accumulators, it reads them from shared memory by ldmatrix at each
// 16-column step instead.
// ---------------------------------------------------------------------
template <typename T, int DP>
__global__ void __launch_bounds__(kMmaThreads)
    flash_dq_mma_kernel(const T* __restrict__ q,
                        const T* __restrict__ k,
                        const T* __restrict__ v,
                        const T* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        T* __restrict__ dq, Shape s) {
  constexpr int kLd = mma_pitch<DP>();
  constexpr int kElems = kTile * kLd;
  constexpr int kN = DP / 8;
  constexpr int kSteps = DP / 16;    // 16-column steps of a q row
  constexpr bool kHold = DP <= 64;   // Q and dO fragments in registers
  extern __shared__ float4 smem4[];
  T* q_s = reinterpret_cast<T*>(smem4);
  T* do_s = q_s + kElems;
  T* k_s = do_s + kElems;     // two stages
  T* v_s = k_s + 2 * kElems;  // two stages
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_q = n_tiles(s.t_len);
  const int qi = s.causal ? n_q - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long in_off = b * s.in_sb + h * s.in_sh;
  const long long o_st = (long long)s.heads * s.d;
  const long long o_off = (long long)b * s.t_len * o_st + (long long)h * s.d;
  const long long row_off = ((long long)b * s.heads + h) * s.t_len;
  const int q0 = qi * kTile;
  int n_k = n_tiles(s.t_len);
  if (s.causal) n_k = min(n_k, qi + 1);

  mma_load_tile<DP>(q_s, q + in_off, s.in_st, q0, s.t_len, s.d);
  mma_load_tile<DP>(do_s, dout + o_off, o_st, q0, s.t_len, s.d);
  mma_load_tile<DP>(k_s, k + in_off, s.in_st, 0, s.t_len, s.d);
  mma_load_tile<DP>(v_s, v + in_off, s.in_st, 0, s.t_len, s.d);
  cp_async_commit();

  // This lane's rows of the tile: r_lo and r_lo + 8.
  const int r_lo = q0 + 16 * warp + (lane >> 2);
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = r_lo + 8 * half;
    lse_r[half] = t < s.t_len ? lse[row_off + t] : 0.0f;
    delta_r[half] = t < s.t_len ? delta[row_off + t] : 0.0f;
  }
  const int a_row = (16 * warp + (lane & 15)) * kLd + 8 * (lane >> 4);
  uint32_t qf[kHold ? kSteps : 1][4], dof[kHold ? kSteps : 1][4];
  float acc[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  }

  for (int kb = 0; kb < n_k; ++kb) {
    // Tile kb has landed, and every warp is done with tile kb - 1, whose
    // stage the next copy overwrites.
    cp_async_wait_all();
    __syncthreads();
    if constexpr (kHold) {
      if (kb == 0) {
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk) {
          ldsm_x4(qf[kk], q_s + a_row + 16 * kk);
          ldsm_x4(dof[kk], do_s + a_row + 16 * kk);
        }
      }
    }
    if (kb + 1 < n_k) {
      const int stage = (kb + 1) & 1;
      mma_load_tile<DP>(k_s + stage * kElems, k + in_off, s.in_st, (kb + 1) * kTile, s.t_len,
                        s.d);
      mma_load_tile<DP>(v_s + stage * kElems, v + in_off, s.in_st, (kb + 1) * kTile, s.t_len,
                        s.d);
      cp_async_commit();
    }
    const T* ks = k_s + (kb & 1) * kElems;
    const T* vs = v_s + (kb & 1) * kElems;
    const int k0 = kb * kTile;

#pragma unroll 1
    for (int sub = 0; sub < kTile; sub += 32) {
      if (s.causal && k0 + sub > q0 + 16 * warp + 15) continue;  // all masked: adds 0
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
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bk[4], bv[4];
          const int b_off = (sub + 16 * np + (lane & 7) + 8 * (lane >> 4)) * kLd + 16 * kk +
                            8 * ((lane >> 3) & 1);
          ldsm_x4(bk, ks + b_off);
          ldsm_x4(bv, vs + b_off);
          mma<T>(sc[2 * np], qa, bk[0], bk[1]);
          mma<T>(sc[2 * np + 1], qa, bk[2], bk[3]);
          mma<T>(dp[2 * np], da, bv[0], bv[1]);
          mma<T>(dp[2 * np + 1], da, bv[2], bv[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k_pos = k0 + sub + 8 * j + 2 * (lane & 3) + (e & 1);
          const int half = e >> 1;
          const float sv = (k_pos >= s.t_len || (s.causal && k_pos > r_lo + 8 * half))
                               ? kNegInf
                               : sc[j][e] * s.scale;
          const float p = expf(sv - lse_r[half]);
          dp[j][e] = p * (dp[j][e] - delta_r[half]);
        }
      }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {  // 16 keys a step
        uint32_t ds_hi[4], ds_lo[4];
        acc_to_a_split(dp[2 * kk], dp[2 * kk + 1], ds_hi, ds_lo);
#pragma unroll
        for (int np = 0; np < kSteps; ++np) {
          uint32_t bk[4];
          ldsm_x4_t(bk, ks + (sub + 16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * kLd +
                            16 * np + 8 * (lane >> 4));
          mma_split<T>(acc[2 * np], ds_hi, ds_lo, bk[0], bk[1]);
          mma_split<T>(acc[2 * np + 1], ds_hi, ds_lo, bk[2], bk[3]);
        }
      }
    }
  }
  mma_store_rows<DP>(dq + o_off, o_st, r_lo, s.t_len, s.d, acc, s.scale);
}

// The tensor-core builds of K4-K6 take 16-byte-aligned q, k, v, dO and strides
// (the wrapper copies a tensor that lacks them); dO, out, dq, dk and dv
// are contiguous.
inline bool mma_inputs_ok(const void* q, const void* k, const void* v, const Shape& s) {
  return aligned16(q) && aligned16(k) && aligned16(v) && s.in_sb % 8 == 0 &&
         s.in_st % 8 == 0 && s.in_sh % 8 == 0 && s.d % 8 == 0;
}

template <typename T, int DP>
cudaError_t launch_fwd_mma(const void* q, const void* k, const void* v, void* out, float* lse,
                           int batch, const Shape& s, cudaStream_t st) {
  if (!mma_inputs_ok(q, k, v, s)) return cudaErrorMisalignedAddress;
  constexpr int bytes = fwd_mma_smem_bytes<DP>();
  cudaError_t err = allow_smem(flash_fwd_mma_kernel<T, DP>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((s.t_len + kTile - 1) / kTile, s.heads, batch);
  flash_fwd_mma_kernel<T, DP><<<grid, kMmaThreads, bytes, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, lse, s);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_dq_mma(const void* q, const void* k, const void* v, const void* dout,
                          const float* lse, const float* delta, void* dq, int batch,
                          const Shape& s, cudaStream_t st) {
  if (!mma_inputs_ok(q, k, v, s) || !aligned16(dout)) return cudaErrorMisalignedAddress;
  constexpr int bytes = dq_mma_smem_bytes<DP>();
  cudaError_t err = allow_smem(flash_dq_mma_kernel<T, DP>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((s.t_len + kTile - 1) / kTile, s.heads, batch);
  flash_dq_mma_kernel<T, DP><<<grid, kMmaThreads, bytes, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, (T*)dq, s);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_dkv_mma(const void* q, const void* k, const void* v, const void* dout,
                           const float* lse, const float* delta, void* dk, void* dv,
                           int batch, const Shape& s, cudaStream_t st) {
  if (!mma_inputs_ok(q, k, v, s) || !aligned16(dout)) return cudaErrorMisalignedAddress;
  const dim3 grid((s.t_len + kTile - 1) / kTile, s.heads, batch);
  if constexpr (DP > 128) {  // two warps for each 16 key rows
    constexpr int bytes = dkv_pair_smem_bytes<DP>();
    cudaError_t err = allow_smem(flash_dkv_mma_pair_kernel<T, DP>, bytes);
    if (err != cudaSuccess) return err;
    flash_dkv_mma_pair_kernel<T, DP><<<grid, kPairThreads, bytes, st>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, (T*)dk,
        (T*)dv, s);
  } else {
    constexpr int bytes = dkv_mma_smem_bytes<DP>();
    cudaError_t err = allow_smem(flash_dkv_mma_kernel<T, DP>, bytes);
    if (err != cudaSuccess) return err;
    flash_dkv_mma_kernel<T, DP><<<grid, kMmaThreads, bytes, st>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, (T*)dk,
        (T*)dv, s);
  }
  return cudaGetLastError();
}

}  // namespace
