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
// The tensor-core builds of K4-K6 are templates in flash_mma.cuh, built
// here for bf16 and in flash_attention_f16.cu for f16.  The three kernels
// of one step of the context-parallel ring (K7-K9) are in
// ring_attention.cu.  All take their tiles, products and softmax helpers
// from flash_common.cuh, and the three units compile in parallel.
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
// - bf16 and f16 K4-K6 (flash_fwd_mma_kernel, flash_dq_mma_kernel,
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
//   product.  The f16 builds keep these rules with f16 operands and
//   split the f16 tile beside an f32 operand into two bf16 parts
//   (flash_mma.cuh says why).
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

#include "flash_mma.cuh"

namespace {

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

template <typename T, int DP>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* out,
                       float* lse, int batch, const Shape& s, cudaStream_t st) {
  // bf16 and f16 run on the tensor cores; f32 keeps the FMA kernel.
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return launch_fwd_mma<T, DP>(q, k, v, out, lse, batch, s, st);
  } else if constexpr (std::is_same<T, __half>::value) {
    return edl_flash::fwd_f16<DP>(q, k, v, out, lse, batch, s, st);
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
    return launch_dq_mma<T, DP>(q, k, v, dout, lse, delta, dq, batch, s, st);
  } else if constexpr (std::is_same<T, __half>::value) {
    return edl_flash::dq_f16<DP>(q, k, v, dout, lse, delta, dq, batch, s, st);
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
    return launch_dkv_mma<T, DP>(q, k, v, dout, lse, delta, dk, dv, batch, s, st);
  } else if constexpr (std::is_same<T, __half>::value) {
    return edl_flash::dkv_f16<DP>(q, k, v, dout, lse, delta, dk, dv, batch, s, st);
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

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  K4-K6: head_dim d <=
// 64 runs the DP=64 build, 64 < d <= 128 the DP=128 one, 128 < d <= 256
// the DP=256 one (the wrapper pads d to a multiple of 8).
#define EDL_FLASH_DISPATCH(CALL)                                     \
  do {                                                               \
    if (d < 1 || d > 256 || t_len < 1 || heads < 1 || batch < 1)     \
      return (int)cudaErrorInvalidValue;                             \
    if (dtype == 1) {                                                \
      if (d <= 64) return (int)CALL(__nv_bfloat16, 64);              \
      if (d <= 128) return (int)CALL(__nv_bfloat16, 128);            \
      return (int)CALL(__nv_bfloat16, 256);                          \
    }                                                                \
    if (dtype == 2) {                                                \
      if (d <= 64) return (int)CALL(__half, 64);                     \
      if (d <= 128) return (int)CALL(__half, 128);                   \
      return (int)CALL(__half, 256);                                 \
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
