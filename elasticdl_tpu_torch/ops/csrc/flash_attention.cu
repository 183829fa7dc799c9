// Flash-attention kernels for Hopper (sm_90a), behind a plain C interface
// that ops/_build.py compiles with nvcc and binds with ctypes.
//
// Three kernels, each replacing one Pallas TPU kernel of
// elasticdl_tpu/ops/flash_attention.py:
//
//   edl_flash_fwd  <- _fwd_kernel (K4): online-softmax attention over the
//                     K/V blocks; writes out (q's dtype) and the row
//                     logsumexp lse = m + log(l) (f32).
//   edl_flash_dq   <- _dq_kernel (K5): dQ = scale * sum_k dS K, with
//                     P = exp(S - lse) and dS = P * (dP - delta).
//   edl_flash_dkv  <- _dkv_kernel (K6): dV = sum_q P^T dO and
//                     dK = scale * sum_q dS^T Q of one K block.
//
// The three kernels of one step of the context-parallel ring (K7-K9) are
// in ring_attention.cu; both files take their tiles, products and
// softmax helpers from flash_common.cuh, and compile in parallel.
//
// Layout.  q, k, v are read in the public [B, T, H, D] layout through
// their strides (batch, time, head; the last dimension contiguous), so
// the transposes to [B, H, T, D] that the JAX function makes around its
// kernels are skipped.  out, dO, dq, dk and dv are contiguous
// [B, T, H, D]; lse and delta are contiguous [B, H, T] f32.
//
// Roundings, those of the TPU kernels (the f32 FMA builds; the bf16
// tensor-core builds differ as set out below): q is upcast to f32 and
// multiplied by `scale` (already an f32) before Q K^T; every product and
// sum is f32; masked scores are NEG_INF = -1e30, not -inf; P is rounded
// to v's dtype before P V in the forward (p_round below); the output is
// divided by l (l == 0 -> 1) and cast to q's dtype.  The backward is f32
// throughout; dq and dk are multiplied by `scale` at the end, and
// dq/dk/dv are cast to the input dtype.
//
// A sequential grid becomes a loop inside the block.  The TPU kernels
// carry their accumulators in VMEM scratch across the inner grid axis
// (which a TPU runs in order).  Here each block owns one 64-row tile: a
// q tile in K4 and K5, which loop over the K/V tiles, and a k tile in
// K6, which loops over the q tiles.  Each output element has one owner,
// so there are no atomics and a rerun gives the same bits.  Causal tiles
// strictly above the diagonal are skipped, as on the TPU; causal blocks
// are launched heaviest first.  A ragged last tile (T not a multiple of
// 64) is loaded as zeros and its keys masked, so every T >= 1 runs.
//
// What bounds them: at the bench shape (B=16, H=8, T=2048, D=64, causal)
// the forward needs 4*B*H*T^2*D / 2 = 68.7 GFLOP and moves 135 MB: 0.069
// ms at the bf16 tensor-core peak against 0.040 ms at the memory rate,
// so operations bound K4 and K6 (given S, dP, dV and dK of the
// backward); K5, left with dQ's share, sits near its bytes.
//
// Two designs, chosen by the input dtype (EDL_FLASH_DISPATCH):
//
// - bf16 K4-K6 (flash_fwd_mma_kernel, flash_dq_mma_kernel,
//   flash_dkv_mma_kernel and at DP = 256 flash_dkv_mma_pair_kernel; the
//   LM's path), and K7-K9 after them (ring_attention.cu), run their
//   products on the tensor cores: mma.sync m16n8k16, bf16 operands, f32
//   sums, fed by ldmatrix from bf16 tiles that cp.async stages two deep.
//   Their ceiling is the 989 TFLOP/s bf16 peak; mma.sync, not wgmma, and
//   the f32 softmax between the products hold them well below it.  Three
//   numbers must not move: the MMA runs on the unscaled bf16 q and S is
//   scaled in f32 after it (rounding q * scale to bf16, inexact at D=128,
//   moves lse past 1e-4); P is rounded to bf16 per 64 keys against the
//   running max, as above, while l sums the unrounded p; and in K5 and
//   K6, whose reference keeps P and dS in f32, each is split into hi =
//   bf16(x) and lo = bf16(x - hi), two products into one f32 sum (x to
//   ~16 bits), because one bf16 rounding of them puts dq and dk past the
//   kernels' bf16 tolerance.  K8 and K9, whose outputs are f32, split
//   every f32 operand so (P, dS and an f32 dO) and keep every cross
//   product.
// - The f32 builds of K4-K9 are the first, simple design: tiles of 64 x
//   64 staged in shared memory as f32, every product an f32 FMA on the
//   CUDA cores (a register tile of 4 x 4 scores, or 4 rows x 4 columns of
//   the accumulator, per thread; float4 reads from shared memory without
//   bank conflicts), whose ceiling is the card's 67 TFLOP/s f32 rate.
//   f32 inputs keep it because their check (rtol 1e-5) is tighter than
//   bf16 or TF32 products can meet.  (K8 and K9 meet it in bf16 only
//   because their bf16 inputs are exact in the tensor cores and every f32
//   operand is split.)
//
// Builds by head_dim d: each kernel is built for a padded width DP of
// 64, 128 or 256 and takes every d up to it, the columns past d staged
// as zeros (the wrapper pads a d that is not a multiple of 8 with zero
// columns first).  At DP = 256 (128 < d <= 256, the head_dim of Gemma 2B's attention):
//
// - What bounds them: at [B=8, T=2048, H=8, D=256] bf16 causal, 0.139 ms
//   for K4 (137 GFLOP) and 0.278 ms for K6 (275 GFLOP) by operations at
//   the bf16 peak; K5 (69 GFLOP, 0.069 ms) moves 337 MB, 0.100 ms at the
//   memory rate, so bytes bound it.
// - Registers bound the tensor-core builds: a warp's 16 rows of O or dQ
//   in f32 take 128 registers a thread.  K4 and K5 read their Q (and dO)
//   A fragments by ldmatrix at each 16-column step instead of holding
//   them.  K6 would need 256 for dK and dV: flash_dkv_mma_pair_kernel
//   gives each 16 key rows a pair of warps, each owning half of the D
//   columns, and splits S^T and dP^T between the pair (below).
// - Shared memory bounds the f32 builds: four f32 tiles of 64 x 260 do
//   not fit in a block, so K5 and K6 share one tile buffer between two
//   operands and reload one of them (share_tiles).  The bf16 builds fit
//   (K4 168,960 B, K5 202,752 B, K6 220,160 B), one block to an SM.
//
// Every entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() so the Python wrapper can raise on a
// refused launch.

#include "flash_common.cuh"

namespace {

struct Shape {
  int heads, t_len, d;
  long long in_sb, in_st, in_sh;  // strides of q, k, v (elements)
  float scale;
  int causal;
};

// ---------------------------------------------------------------------
// K4: forward.  Block (q tile, head, batch); loops over the K/V tiles.
// ---------------------------------------------------------------------
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, Shape s) {
  constexpr int kLd = DP + 4;
  constexpr int kNc = DP / 64;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* k_s = q_s + kTile * kLd;
  float* v_s = k_s + kTile * kLd;
  float* p_s = v_s + kTile * kLd;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const int n_q = n_tiles(s.t_len);
  const int qi = s.causal ? n_q - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long in_off = b * s.in_sb + h * s.in_sh;
  const int q0 = qi * kTile;

  load_tile<T, DP>(q_s, q + in_off, s.in_st, q0, s.t_len, s.d, s.scale);
  int n_k = n_tiles(s.t_len);
  if (s.causal) n_k = min(n_k, (q0 + kTile + kTile - 1) / kTile);

  float m[4], l[4], acc[4][kNc][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int n = 0; n < kNc; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.0f;
    }
  }

  for (int kb = 0; kb < n_k; ++kb) {
    const int k0 = kb * kTile;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, DP>(k_s, k + in_off, s.in_st, k0, s.t_len, s.d, 1.0f);
    load_tile<T, DP>(v_s, v + in_off, s.in_st, k0, s.t_len, s.d, 1.0f);
    __syncthreads();
    float sc[4][4];
    dot_rows<DP, false>(q_s, k_s, sc, 1.0f);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k_pos = k0 + tx + 16 * j;
        if (k_pos >= s.t_len || (s.causal && k_pos > q_pos)) sc[i][j] = kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        rs += p;
        p_s[(ty + 16 * i) * kLdp + tx + 16 * j] = p_round<T>(p);
      }
      l[i] = l[i] * corr + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < kNc; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][n][e] *= corr;
      }
    }
    __syncthreads();
    acc_pv<DP>(p_s, v_s, acc);
  }

  const long long o_st = (long long)s.heads * s.d;
  T* out_bh = out + (long long)b * s.t_len * o_st + (long long)h * s.d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float l_safe = l[i] == 0.0f ? 1.0f : l[i];
#pragma unroll
    for (int n = 0; n < kNc; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = acc[i][n][e] / l_safe;
    }
    const int t = q0 + ty + 16 * i;
    if (tx == 0 && t < s.t_len) {
      lse[((long long)b * s.heads + h) * s.t_len + t] = m[i] + logf(l_safe);
    }
  }
  store_rows<T, DP>(out_bh, o_st, q0, s.t_len, s.d, acc, 1.0f);
}

// ---------------------------------------------------------------------
// K5: dQ.  Block (q tile, head, batch); loops over the K/V tiles.
// ---------------------------------------------------------------------
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    Shape s) {
  constexpr int kLd = DP + 4;
  constexpr int kNc = DP / 64;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* do_s = q_s + kTile * kLd;
  float* k_s = do_s + kTile * kLd;
  float* v_s = k_s + kTile * kLd;  // share_tiles: unused, V goes through k_s
  float* ds_s = share_tiles<DP>() ? v_s : v_s + kTile * kLd;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const int n_q = n_tiles(s.t_len);
  const int qi = s.causal ? n_q - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long in_off = b * s.in_sb + h * s.in_sh;
  const long long o_st = (long long)s.heads * s.d;
  const long long o_off = (long long)b * s.t_len * o_st + (long long)h * s.d;
  const long long row_off = ((long long)b * s.heads + h) * s.t_len;
  const int q0 = qi * kTile;

  load_tile<T, DP>(q_s, q + in_off, s.in_st, q0, s.t_len, s.d, s.scale);
  load_tile<T, DP>(do_s, dout + o_off, o_st, q0, s.t_len, s.d, 1.0f);
  float lse_r[4], delta_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    lse_r[i] = t < s.t_len ? lse[row_off + t] : 0.0f;
    delta_r[i] = t < s.t_len ? delta[row_off + t] : 0.0f;
  }
  int n_k = n_tiles(s.t_len);
  if (s.causal) n_k = min(n_k, (q0 + kTile + kTile - 1) / kTile);

  float acc[4][kNc][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int n = 0; n < kNc; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.0f;
    }
  }

  for (int kb = 0; kb < n_k; ++kb) {
    const int k0 = kb * kTile;
    __syncthreads();
    float sc[4][4], dp[4][4];
    if constexpr (share_tiles<DP>()) {  // V, then K, in the one buffer k_s
      load_tile<T, DP>(k_s, v + in_off, s.in_st, k0, s.t_len, s.d, 1.0f);
      __syncthreads();
      dot_rows<DP, false>(do_s, k_s, dp, 1.0f);
      __syncthreads();
      load_tile<T, DP>(k_s, k + in_off, s.in_st, k0, s.t_len, s.d, 1.0f);
      __syncthreads();
      dot_rows<DP, false>(q_s, k_s, sc, 1.0f);
    } else {
      load_tile<T, DP>(k_s, k + in_off, s.in_st, k0, s.t_len, s.d, 1.0f);
      load_tile<T, DP>(v_s, v + in_off, s.in_st, k0, s.t_len, s.d, 1.0f);
      __syncthreads();
      dot_rows<DP, false>(q_s, k_s, sc, 1.0f);
      dot_rows<DP, false>(do_s, v_s, dp, 1.0f);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k_pos = k0 + tx + 16 * j;
        const float sv =
            (k_pos >= s.t_len || (s.causal && k_pos > q_pos)) ? kNegInf : sc[i][j];
        const float p = expf(sv - lse_r[i]);
        ds_s[(ty + 16 * i) * kLdp + tx + 16 * j] = p * (dp[i][j] - delta_r[i]);
      }
    }
    __syncthreads();
    acc_pv<DP>(ds_s, k_s, acc);
  }
  store_rows<T, DP>(dq + o_off, o_st, q0, s.t_len, s.d, acc, s.scale);
}

// ---------------------------------------------------------------------
// K6: dK, dV.  Block (k tile, head, batch); loops over the q tiles.
// Scores are held transposed: rows are keys (ty), columns queries (tx).
// ---------------------------------------------------------------------
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, Shape s) {
  constexpr int kLd = DP + 4;
  constexpr int kNc = DP / 64;
  constexpr bool kShare = share_tiles<DP>();
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);
  float* v_s = k_s + kTile * kLd;
  float* q_s = v_s + kTile * kLd;
  float* do_s = kShare ? q_s : q_s + kTile * kLd;  // kShare: dO goes through q_s
  float* pt_s = do_s + kTile * kLd;
  float* dst_s = kShare ? pt_s : pt_s + kTile * kLdp;  // kShare: dS goes through pt_s
  float* lse_s = dst_s + kTile * kLdp;
  float* delta_s = lse_s + kTile;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const int kj = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long in_off = b * s.in_sb + h * s.in_sh;
  const long long o_st = (long long)s.heads * s.d;
  const long long o_off = (long long)b * s.t_len * o_st + (long long)h * s.d;
  const long long row_off = ((long long)b * s.heads + h) * s.t_len;
  const int k0 = kj * kTile;

  load_tile<T, DP>(k_s, k + in_off, s.in_st, k0, s.t_len, s.d, 1.0f);
  load_tile<T, DP>(v_s, v + in_off, s.in_st, k0, s.t_len, s.d, 1.0f);
  const int n_q = n_tiles(s.t_len);
  // Causal: q tiles wholly before this k tile see none of it.
  const int q_first = s.causal ? k0 / kTile : 0;

  float dk_acc[4][kNc][4], dv_acc[4][kNc][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int n = 0; n < kNc; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dk_acc[i][n][e] = 0.0f;
        dv_acc[i][n][e] = 0.0f;
      }
    }
  }

  for (int qb = q_first; qb < n_q; ++qb) {
    const int q0 = qb * kTile;
    __syncthreads();
    load_tile<T, DP>(q_s, q + in_off, s.in_st, q0, s.t_len, s.d, 1.0f);
    if constexpr (!kShare) load_tile<T, DP>(do_s, dout + o_off, o_st, q0, s.t_len, s.d, 1.0f);
    if (threadIdx.x < kTile) {
      const int t = q0 + threadIdx.x;
      lse_s[threadIdx.x] = t < s.t_len ? lse[row_off + t] : 0.0f;
      delta_s[threadIdx.x] = t < s.t_len ? delta[row_off + t] : 0.0f;
    }
    __syncthreads();
    float st[4][4], dpt[4][4];
    dot_rows<DP, true>(k_s, q_s, st, s.scale);  // k . (q * scale)
    if constexpr (kShare) {  // dO in Q's place
      __syncthreads();
      load_tile<T, DP>(do_s, dout + o_off, o_st, q0, s.t_len, s.d, 1.0f);
      __syncthreads();
    }
    dot_rows<DP, false>(v_s, do_s, dpt, 1.0f);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k_pos = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        const int q_pos = q0 + col;
        const float sv =
            (q_pos >= s.t_len || (s.causal && k_pos > q_pos)) ? kNegInf : st[i][j];
        const float p = expf(sv - lse_s[col]);
        pt_s[(ty + 16 * i) * kLdp + col] = p;
        dpt[i][j] = p * (dpt[i][j] - delta_s[col]);
        if constexpr (!kShare) dst_s[(ty + 16 * i) * kLdp + col] = dpt[i][j];
      }
    }
    __syncthreads();
    acc_pv<DP>(pt_s, do_s, dv_acc);
    if constexpr (kShare) {  // dS in P's place, Q again in dO's
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) dst_s[(ty + 16 * i) * kLdp + tx + 16 * j] = dpt[i][j];
      }
      load_tile<T, DP>(q_s, q + in_off, s.in_st, q0, s.t_len, s.d, 1.0f);
      __syncthreads();
    }
    acc_pv<DP>(dst_s, q_s, dk_acc);
  }
  store_rows<T, DP>(dk + o_off, o_st, k0, s.t_len, s.d, dk_acc, s.scale);
  store_rows<T, DP>(dv + o_off, o_st, k0, s.t_len, s.d, dv_acc, 1.0f);
}

// ---------------------------------------------------------------------
// K4 on the tensor cores.  Block (q tile, head, batch), as
// flash_fwd_kernel; warp w owns q rows 16 w .. 16 w + 15 and keeps them
// in registers as A fragments.  Per 64-key tile: S = Q K^T by mma from
// the unscaled bf16 q (the product of two bf16 is exact in f32), times
// `scale` in f32; the online softmax of flash_fwd_kernel per 64 keys (l
// sums the unrounded p); P rounded to bf16 straight from S's
// accumulators into the A fragments of P V.  Registers: at DP = 256 a
// warp's 16 rows of O take 128 f32 a thread, so the warp reads its Q
// fragments from shared memory by ldmatrix at each 16-column step
// instead of holding them (64 more registers), as K5 does above D = 64.
// ---------------------------------------------------------------------
template <int DP>
__global__ void __launch_bounds__(kMmaThreads)
    flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         __nv_bfloat16* __restrict__ out, float* __restrict__ lse, Shape s) {
  constexpr int kLd = mma_pitch<DP>();
  constexpr int kElems = kTile * kLd;
  constexpr int kN = DP / 8;  // 8-column fragments of a row of out
  constexpr bool kHoldQ = DP <= 128;  // Q's A fragments in registers
  extern __shared__ float4 smem4[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* k_s = q_s + kElems;      // two stages
  __nv_bfloat16* v_s = k_s + 2 * kElems;  // two stages
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
    const __nv_bfloat16* ks = k_s + (kb & 1) * kElems;
    const __nv_bfloat16* vs = v_s + (kb & 1) * kElems;

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
        mma_bf16(sc[2 * np], qa, bk[0], bk[1]);
        mma_bf16(sc[2 * np + 1], qa, bk[2], bk[3]);
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
      acc_to_a(sc[2 * kk], sc[2 * kk + 1], pa);
#pragma unroll
      for (int np = 0; np < DP / 16; ++np) {
        uint32_t bv[4];
        ldsm_x4_t(bv, vs + (16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * kLd + 16 * np +
                          8 * (lane >> 4));
        mma_bf16(o[2 * np], pa, bv[0], bv[1]);
        mma_bf16(o[2 * np + 1], pa, bv[2], bv[3]);
      }
    }
  }

  const long long o_st = (long long)s.heads * s.d;
  __nv_bfloat16* out_bh = out + (long long)b * s.t_len * o_st + (long long)h * s.d;
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
// split into hi = bf16(x) and lo = bf16(x - hi), two mma into one
// accumulator: the reference keeps P and dS in f32, and one bf16
// rounding of them puts dk past the kernels' bf16 tolerance.
// ---------------------------------------------------------------------
template <int DP>
__global__ void __launch_bounds__(kMmaThreads)
    flash_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                         Shape s) {
  constexpr int kLd = mma_pitch<DP>();
  constexpr int kElems = kTile * kLd;
  constexpr int kN = DP / 8;
  extern __shared__ float4 smem4[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* v_s = k_s + kElems;
  __nv_bfloat16* q_s = v_s + kElems;       // two stages
  __nv_bfloat16* do_s = q_s + 2 * kElems;  // two stages
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
    const __nv_bfloat16* qs = q_s + (it & 1) * kElems;
    const __nv_bfloat16* dos = do_s + (it & 1) * kElems;
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
        mma_bf16(st[0], ka, bq[0], bq[1]);
        mma_bf16(st[1], ka, bq[2], bq[3]);
        mma_bf16(dpt[0], va, bo[0], bo[1]);
        mma_bf16(dpt[1], va, bo[2], bo[3]);
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
        mma_bf16(dv_acc[2 * np], p_hi, bo[0], bo[1]);
        mma_bf16(dv_acc[2 * np], p_lo, bo[0], bo[1]);
        mma_bf16(dv_acc[2 * np + 1], p_hi, bo[2], bo[3]);
        mma_bf16(dv_acc[2 * np + 1], p_lo, bo[2], bo[3]);
        mma_bf16(dk_acc[2 * np], ds_hi, bq[0], bq[1]);
        mma_bf16(dk_acc[2 * np], ds_lo, bq[0], bq[1]);
        mma_bf16(dk_acc[2 * np + 1], ds_hi, bq[2], bq[3]);
        mma_bf16(dk_acc[2 * np + 1], ds_lo, bq[2], bq[3]);
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

template <int DP>
__global__ void __launch_bounds__(kPairThreads)
    flash_dkv_mma_pair_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              const __nv_bfloat16* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                              Shape s) {
  constexpr int kLd = mma_pitch<DP>();
  constexpr int kElems = kTile * kLd;
  constexpr int kNh = DP / 16;  // 8-column fragments in a warp's half of D
  extern __shared__ float4 smem4[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* v_s = k_s + kElems;
  __nv_bfloat16* q_s = v_s + kElems;       // two stages
  __nv_bfloat16* do_s = q_s + 2 * kElems;  // two stages
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
  const __nv_bfloat16* a_s = part == 0 ? k_s : v_s;
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
    const __nv_bfloat16* qs = q_s + (it & 1) * kElems;
    const __nv_bfloat16* dos = do_s + (it & 1) * kElems;
    const __nv_bfloat16* b_s = part == 0 ? qs : dos;
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
        mma_bf16(x[0], a, bb[0], bb[1]);
        mma_bf16(x[1], a, bb[2], bb[3]);
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
        mma_bf16(dv_acc[2 * np], p_hi, bo[0], bo[1]);
        mma_bf16(dv_acc[2 * np], p_lo, bo[0], bo[1]);
        mma_bf16(dv_acc[2 * np + 1], p_hi, bo[2], bo[3]);
        mma_bf16(dv_acc[2 * np + 1], p_lo, bo[2], bo[3]);
        mma_bf16(dk_acc[2 * np], ds_hi, bq[0], bq[1]);
        mma_bf16(dk_acc[2 * np], ds_lo, bq[0], bq[1]);
        mma_bf16(dk_acc[2 * np + 1], ds_hi, bq[2], bq[3]);
        mma_bf16(dk_acc[2 * np + 1], ds_lo, bq[2], bq[3]);
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
// unscaled bf16 q and the bf16 dO (exact products, f32 sums), S times
// `scale` in f32 and masked; P = exp(S - lse) and dS = P (dP - delta) in
// f32 registers.  dQ += dS K takes dS from those registers as A
// fragments split into hi = bf16(x) and lo = bf16(x - hi), two mma into
// one accumulator, with K through ldmatrix.trans as V in K4's P V: the
// reference keeps dS in f32, and one bf16 rounding of it puts dq past
// the kernels' bf16 tolerance.  Registers: at D = 64 the warp holds its
// Q and dO rows as A fragments; at D = 128, whose dQ takes 64
// accumulators, it reads them from shared memory by ldmatrix at each
// 16-column step instead.
// ---------------------------------------------------------------------
template <int DP>
__global__ void __launch_bounds__(kMmaThreads)
    flash_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dq, Shape s) {
  constexpr int kLd = mma_pitch<DP>();
  constexpr int kElems = kTile * kLd;
  constexpr int kN = DP / 8;
  constexpr int kSteps = DP / 16;    // 16-column steps of a q row
  constexpr bool kHold = DP <= 64;   // Q and dO fragments in registers
  extern __shared__ float4 smem4[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* do_s = q_s + kElems;
  __nv_bfloat16* k_s = do_s + kElems;     // two stages
  __nv_bfloat16* v_s = k_s + 2 * kElems;  // two stages
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
    const __nv_bfloat16* ks = k_s + (kb & 1) * kElems;
    const __nv_bfloat16* vs = v_s + (kb & 1) * kElems;
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
          mma_bf16(sc[2 * np], qa, bk[0], bk[1]);
          mma_bf16(sc[2 * np + 1], qa, bk[2], bk[3]);
          mma_bf16(dp[2 * np], da, bv[0], bv[1]);
          mma_bf16(dp[2 * np + 1], da, bv[2], bv[3]);
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
          mma_bf16(acc[2 * np], ds_hi, bk[0], bk[1]);
          mma_bf16(acc[2 * np], ds_lo, bk[0], bk[1]);
          mma_bf16(acc[2 * np + 1], ds_hi, bk[2], bk[3]);
          mma_bf16(acc[2 * np + 1], ds_lo, bk[2], bk[3]);
        }
      }
    }
  }
  mma_store_rows<DP>(dq + o_off, o_st, r_lo, s.t_len, s.d, acc, s.scale);
}

// The bf16 builds of K4-K6 take 16-byte-aligned q, k, v, dO and strides
// (the wrapper copies a tensor that lacks them); dO, out, dq, dk and dv
// are contiguous.
inline bool mma_inputs_ok(const void* q, const void* k, const void* v, const Shape& s) {
  return aligned16(q) && aligned16(k) && aligned16(v) && s.in_sb % 8 == 0 &&
         s.in_st % 8 == 0 && s.in_sh % 8 == 0 && s.d % 8 == 0;
}

template <int DP>
cudaError_t launch_fwd_mma(const void* q, const void* k, const void* v, void* out, float* lse,
                           int batch, const Shape& s, cudaStream_t st) {
  if (!mma_inputs_ok(q, k, v, s)) return cudaErrorMisalignedAddress;
  constexpr int bytes = fwd_mma_smem_bytes<DP>();
  cudaError_t err = allow_smem(flash_fwd_mma_kernel<DP>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((s.t_len + kTile - 1) / kTile, s.heads, batch);
  flash_fwd_mma_kernel<DP><<<grid, kMmaThreads, bytes, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)out, lse, s);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dq_mma(const void* q, const void* k, const void* v, const void* dout,
                          const float* lse, const float* delta, void* dq, int batch,
                          const Shape& s, cudaStream_t st) {
  if (!mma_inputs_ok(q, k, v, s) || !aligned16(dout)) return cudaErrorMisalignedAddress;
  constexpr int bytes = dq_mma_smem_bytes<DP>();
  cudaError_t err = allow_smem(flash_dq_mma_kernel<DP>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((s.t_len + kTile - 1) / kTile, s.heads, batch);
  flash_dq_mma_kernel<DP><<<grid, kMmaThreads, bytes, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const __nv_bfloat16*)dout, lse, delta, (__nv_bfloat16*)dq, s);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dkv_mma(const void* q, const void* k, const void* v, const void* dout,
                           const float* lse, const float* delta, void* dk, void* dv,
                           int batch, const Shape& s, cudaStream_t st) {
  if (!mma_inputs_ok(q, k, v, s) || !aligned16(dout)) return cudaErrorMisalignedAddress;
  const dim3 grid((s.t_len + kTile - 1) / kTile, s.heads, batch);
  if constexpr (DP > 128) {  // two warps for each 16 key rows
    constexpr int bytes = dkv_pair_smem_bytes<DP>();
    cudaError_t err = allow_smem(flash_dkv_mma_pair_kernel<DP>, bytes);
    if (err != cudaSuccess) return err;
    flash_dkv_mma_pair_kernel<DP><<<grid, kPairThreads, bytes, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
        (const __nv_bfloat16*)dout, lse, delta, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, s);
  } else {
    constexpr int bytes = dkv_mma_smem_bytes<DP>();
    cudaError_t err = allow_smem(flash_dkv_mma_kernel<DP>, bytes);
    if (err != cudaSuccess) return err;
    flash_dkv_mma_kernel<DP><<<grid, kMmaThreads, bytes, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
        (const __nv_bfloat16*)dout, lse, delta, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, s);
  }
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* out,
                       float* lse, int batch, const Shape& s, cudaStream_t st) {
  // bf16 runs on the tensor cores; f32 keeps the FMA kernel.
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return launch_fwd_mma<DP>(q, k, v, out, lse, batch, s, st);
  } else {
    constexpr int bytes = fwd_smem_bytes<DP>();
    cudaError_t err = allow_smem(flash_fwd_kernel<T, DP>, bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid((s.t_len + kTile - 1) / kTile, s.heads, batch);
    flash_fwd_kernel<T, DP><<<grid, kThreads, bytes, st>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)out, lse, s);
    return cudaGetLastError();
  }
}

template <typename T, int DP>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, int batch, const Shape& s, cudaStream_t st) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return launch_dq_mma<DP>(q, k, v, dout, lse, delta, dq, batch, s, st);
  } else {
    constexpr int bytes = dq_smem_bytes<DP>();
    cudaError_t err = allow_smem(flash_dq_kernel<T, DP>, bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid((s.t_len + kTile - 1) / kTile, s.heads, batch);
    flash_dq_kernel<T, DP><<<grid, kThreads, bytes, st>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
        (T*)dq, s);
    return cudaGetLastError();
  }
}

template <typename T, int DP>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       void* dk, void* dv, int batch, const Shape& s,
                       cudaStream_t st) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return launch_dkv_mma<DP>(q, k, v, dout, lse, delta, dk, dv, batch, s, st);
  } else {
    constexpr int bytes = dkv_smem_bytes<DP>();
    cudaError_t err = allow_smem(flash_dkv_kernel<T, DP>, bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid((s.t_len + kTile - 1) / kTile, s.heads, batch);
    flash_dkv_kernel<T, DP><<<grid, kThreads, bytes, st>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
        (T*)dk, (T*)dv, s);
    return cudaGetLastError();
  }
}

// dtype: 0 = float32, 1 = bfloat16.  K4-K6: head_dim d <= 64 runs the
// DP=64 build, 64 < d <= 128 the DP=128 one, 128 < d <= 256 the DP=256
// one (the wrapper pads d to a multiple of 8).
#define EDL_FLASH_DISPATCH(CALL)                                     \
  do {                                                               \
    if (d < 1 || d > 256 || t_len < 1 || heads < 1 || batch < 1)     \
      return (int)cudaErrorInvalidValue;                             \
    if (dtype == 1) {                                                \
      if (d <= 64) return (int)CALL(__nv_bfloat16, 64);              \
      if (d <= 128) return (int)CALL(__nv_bfloat16, 128);            \
      return (int)CALL(__nv_bfloat16, 256);                          \
    }                                                                \
    if (dtype == 0) {                                                \
      if (d <= 64) return (int)CALL(float, 64);                      \
      if (d <= 128) return (int)CALL(float, 128);                    \
      return (int)CALL(float, 256);                                  \
    }                                                                \
    return (int)cudaErrorInvalidValue;                               \
  } while (0)

}  // namespace

extern "C" {

int edl_flash_fwd(const void* q, const void* k, const void* v, void* out,
                  float* lse, int batch, int heads, int t_len, int d,
                  long long in_sb, long long in_st, long long in_sh,
                  float scale, int causal, int dtype, void* stream) {
  const Shape s{heads, t_len, d, in_sb, in_st, in_sh, scale, causal};
  const cudaStream_t st = (cudaStream_t)stream;
#define EDL_CALL(T, DP) launch_fwd<T, DP>(q, k, v, out, lse, batch, s, st)
  EDL_FLASH_DISPATCH(EDL_CALL);
#undef EDL_CALL
}

int edl_flash_dq(const void* q, const void* k, const void* v, const void* dout,
                 const float* lse, const float* delta, void* dq, int batch,
                 int heads, int t_len, int d, long long in_sb, long long in_st,
                 long long in_sh, float scale, int causal, int dtype,
                 void* stream) {
  const Shape s{heads, t_len, d, in_sb, in_st, in_sh, scale, causal};
  const cudaStream_t st = (cudaStream_t)stream;
#define EDL_CALL(T, DP) \
  launch_dq<T, DP>(q, k, v, dout, lse, delta, dq, batch, s, st)
  EDL_FLASH_DISPATCH(EDL_CALL);
#undef EDL_CALL
}

int edl_flash_dkv(const void* q, const void* k, const void* v, const void* dout,
                  const float* lse, const float* delta, void* dk, void* dv,
                  int batch, int heads, int t_len, int d, long long in_sb,
                  long long in_st, long long in_sh, float scale, int causal,
                  int dtype, void* stream) {
  const Shape s{heads, t_len, d, in_sb, in_st, in_sh, scale, causal};
  const cudaStream_t st = (cudaStream_t)stream;
#define EDL_CALL(T, DP) \
  launch_dkv<T, DP>(q, k, v, dout, lse, delta, dk, dv, batch, s, st)
  EDL_FLASH_DISPATCH(EDL_CALL);
#undef EDL_CALL
}

}  // extern "C"
