// The ring-step kernels for Hopper (sm_90a): one step of the
// context-parallel ring (the local q shard against one rotating K/V
// block, causal masking from explicit position arrays), behind the plain
// C interface that ops/_build.py compiles with nvcc and binds with
// ctypes.  Each replaces a Pallas TPU kernel of
// elasticdl_tpu/ops/flash_attention.py:
//
//   edl_ring_fwd   <- _fwd_ring_carry_kernel (K7): the step's flash
//                     forward, combined in lse space with the running
//                     (acc, lse) carry, which it updates in place.
//   edl_ring_dq    <- _dq_ring_kernel (K8): the step's dQ contribution
//                     from the final lse and delta, f32.
//   edl_ring_dkv   <- _dkv_ring_kernel (K9): dK and dV of the rotating
//                     block against the local q shard, f32.
//
// Builds by dtype: f32 inputs run the FMA kernels of this unit; bf16
// and f16 inputs the tensor-core kernels of ring_mma.cuh, templates
// instantiated here for bf16 and in ring_attention_f16.cu for f16
// (reached through edl_ring::*_f16).  K8 and K9 read dO in q's type (the
// CP path's gradient) or as f32.  They reuse K4-K6's tiles and loops
// (flash_attention.cu, helpers in flash_common.cuh); ring_mma.cuh sets
// out the ring's rules and what differs in each build.
//
// Builds by head_dim d, as K4-K6's: DP = 64, 128 or 256, every d up to
// it, the columns past d staged as zeros (the wrapper pads a d that is
// not a multiple of 8 with zero columns first).  At DP = 256 (128 < d <=
// 256) registers and shared memory bound the builds as they bound K4-K6
// there, and the designs are K4-K6's:
//
// - K7 and K8 read their Q (and dO) A fragments by ldmatrix at each
//   16-column step, since a warp's 16 rows of the f32 accumulator take
//   128 registers a thread.
// - K9's dK and dV would take 256: ring_dkv_mma_pair_kernel gives each
//   16 key rows a pair of warps, each owning half of the D columns, with
//   S^T on one warp and dP^T on the other, exchanged through shared
//   memory; every sum keeps its order.
// - With an f32 dO (three bf16 tiles a q tile) the two-stage pipeline of
//   K/V (K8) or of Q and dO (K9) does not fit in a block's 232,448 bytes
//   (K8 270,336, K9 337,920): those two builds stage one tile set and
//   load the next one after the barrier that ends the current
//   (ring_stages).
// - The f32 builds of K8 and K9 share one tile buffer between two
//   operands, as K5 and K6 do (share_tiles).
//
// Every entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() so the Python wrapper can raise on a
// refused launch.

#include "ring_mma.cuh"

namespace {

// Extra shared memory of an FMA ring kernel: one tile's positions and
// four reduction slots.
constexpr int kRingSmemInts = kTile + 4;

// ---------------------------------------------------------------------
// K7: ring-step forward with the carry combine.  Block (q tile, head,
// batch); loops over the K/V block's tiles.
// ---------------------------------------------------------------------
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    ring_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, float* __restrict__ acc_c,
                    float* __restrict__ lse_c, const int* __restrict__ q_pos,
                    const int* __restrict__ k_pos, RingShape s) {
  constexpr int kLd = DP + 4;
  constexpr int kNc = DP / 64;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* k_s = q_s + kTile * kLd;
  float* v_s = k_s + kTile * kLd;
  float* p_s = v_s + kTile * kLd;
  int* kpos_s = reinterpret_cast<int*>(p_s + kTile * kLdp);
  int* red_s = kpos_s + kTile;  // [0, 1]: a key tile's min; [2, 3]: the q tile's max
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * kTile;
  const long long row0 = ((long long)b * s.heads + h) * s.tq;
  const T* k_bh = k + b * s.kv_sb + h * s.kv_sh;
  const T* v_bh = v + b * s.kv_sb + h * s.kv_sh;

  load_tile<T, DP>(q_s, q + b * s.q_sb + h * s.q_sh, s.q_st, q0, s.tq, s.d, s.scale);
  int qp[4];
  float lse_in[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    qp[i] = t < s.tq ? q_pos[t] : 0;
    lse_in[i] = t < s.tq ? lse_c[row0 + t] : 0.0f;
  }
  tile_pos_extreme<false>(q_pos, q0, s.tq, red_s + 2, nullptr);
  __syncthreads();
  const int q_max = max(red_s[2], red_s[3]);

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

  const int n_k = n_tiles(s.tk);
  for (int kb = 0; kb < n_k; ++kb) {
    const int k0 = kb * kTile;
    __syncthreads();  // the previous tile's readers are done
    if (s.causal) {
      tile_pos_extreme<true>(k_pos, k0, s.tk, red_s, kpos_s);
      __syncthreads();
      if (min(red_s[0], red_s[1]) > q_max) continue;  // every key masked
    }
    load_tile<T, DP>(k_s, k_bh, s.kv_st, k0, s.tk, s.d, 1.0f);
    load_tile<T, DP>(v_s, v_bh, s.kv_st, k0, s.tk, s.d, 1.0f);
    __syncthreads();
    float sc[4][4];
    dot_rows<DP, false>(q_s, k_s, sc, 1.0f);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        if (k0 + col >= s.tk || (s.causal && kpos_s[col] > qp[i])) sc[i][j] = kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float safe_m = below_half_neg_inf(m_new) ? 0.0f : m_new;
      const float corr = below_half_neg_inf(m[i]) ? 0.0f : expf(m[i] - safe_m);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = below_half_neg_inf(sc[i][j]) ? 0.0f : expf(sc[i][j] - safe_m);
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

  // The combine with the carry; a row that saw no key (l = 0) keeps it.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= s.tq || l[i] == 0.0f) continue;
    const float lse_i = (below_half_neg_inf(m[i]) ? 0.0f : m[i]) + logf(l[i]);
    const float lc = lse_in[i];
    const float lse_new = fmaxf(lc, lse_i) + log1pf(expf(-fabsf(lc - lse_i)));
    const float safe = below_half_neg_inf(lse_new) ? 0.0f : lse_new;
    const float alpha = expf((below_half_neg_inf(lc) ? kNegInf : lc) - safe);
    const float beta = expf(lse_i - safe);
    float* row = acc_c + (row0 + t) * s.d;
#pragma unroll
    for (int n = 0; n < kNc; ++n) {
      const int c = 64 * n + 4 * tx;
      if (c >= s.d) continue;  // d is a multiple of 8: 4 columns in or out
#pragma unroll
      for (int e = 0; e < 4; ++e) row[c + e] = row[c + e] * alpha + (acc[i][n][e] / l[i]) * beta;
    }
    if (tx == 0) lse_c[row0 + t] = lse_new;
  }
}

// ---------------------------------------------------------------------
// K8: ring-step dQ.  Block (q tile, head, batch); loops over the K/V
// block's tiles.
// ---------------------------------------------------------------------
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    ring_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   float* __restrict__ dq, const int* __restrict__ q_pos,
                   const int* __restrict__ k_pos, RingShape s) {
  constexpr int kLd = DP + 4;
  constexpr int kNc = DP / 64;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* do_s = q_s + kTile * kLd;
  float* k_s = do_s + kTile * kLd;
  float* v_s = k_s + kTile * kLd;  // share_tiles: unused, V goes through k_s
  float* ds_s = share_tiles<DP>() ? v_s : v_s + kTile * kLd;
  int* kpos_s = reinterpret_cast<int*>(ds_s + kTile * kLdp);
  int* red_s = kpos_s + kTile;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * kTile;
  const long long row0 = ((long long)b * s.heads + h) * s.tq;
  const T* k_bh = k + b * s.kv_sb + h * s.kv_sh;
  const T* v_bh = v + b * s.kv_sb + h * s.kv_sh;

  load_tile<T, DP>(q_s, q + b * s.q_sb + h * s.q_sh, s.q_st, q0, s.tq, s.d, s.scale);
  load_tile<float, DP>(do_s, dout + row0 * s.d, s.d, q0, s.tq, s.d, 1.0f);
  int qp[4];
  float lse_r[4], delta_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    qp[i] = t < s.tq ? q_pos[t] : 0;
    lse_r[i] = t < s.tq ? lse[row0 + t] : 0.0f;
    delta_r[i] = t < s.tq ? delta[row0 + t] : 0.0f;
  }
  tile_pos_extreme<false>(q_pos, q0, s.tq, red_s + 2, nullptr);
  __syncthreads();
  const int q_max = max(red_s[2], red_s[3]);

  float acc[4][kNc][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int n = 0; n < kNc; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.0f;
    }
  }

  const int n_k = n_tiles(s.tk);
  for (int kb = 0; kb < n_k; ++kb) {
    const int k0 = kb * kTile;
    __syncthreads();
    if (s.causal) {
      tile_pos_extreme<true>(k_pos, k0, s.tk, red_s, kpos_s);
      __syncthreads();
      if (min(red_s[0], red_s[1]) > q_max) continue;
    }
    float sc[4][4], dp[4][4];
    if constexpr (share_tiles<DP>()) {  // V, then K, in the one buffer k_s
      load_tile<T, DP>(k_s, v_bh, s.kv_st, k0, s.tk, s.d, 1.0f);
      __syncthreads();
      dot_rows<DP, false>(do_s, k_s, dp, 1.0f);
      __syncthreads();
      load_tile<T, DP>(k_s, k_bh, s.kv_st, k0, s.tk, s.d, 1.0f);
      __syncthreads();
      dot_rows<DP, false>(q_s, k_s, sc, 1.0f);
    } else {
      load_tile<T, DP>(k_s, k_bh, s.kv_st, k0, s.tk, s.d, 1.0f);
      load_tile<T, DP>(v_s, v_bh, s.kv_st, k0, s.tk, s.d, 1.0f);
      __syncthreads();
      dot_rows<DP, false>(q_s, k_s, sc, 1.0f);
      dot_rows<DP, false>(do_s, v_s, dp, 1.0f);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        const bool masked = k0 + col >= s.tk || (s.causal && kpos_s[col] > qp[i]) ||
                            below_half_neg_inf(lse_r[i]);
        const float p = masked ? 0.0f : expf(sc[i][j] - lse_r[i]);
        ds_s[(ty + 16 * i) * kLdp + col] = p * (dp[i][j] - delta_r[i]);
      }
    }
    __syncthreads();
    acc_pv<DP>(ds_s, k_s, acc);
  }
  store_rows<float, DP>(dq + row0 * s.d, s.d, q0, s.tq, s.d, acc, s.scale);
}

// ---------------------------------------------------------------------
// K9: ring-step dK, dV of the rotating block.  Block (k tile, head,
// batch); loops over the local q shard's tiles.  Scores are held
// transposed: rows are keys (ty), columns queries (tx).
// ---------------------------------------------------------------------
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    ring_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dk, float* __restrict__ dv,
                    const int* __restrict__ q_pos, const int* __restrict__ k_pos,
                    RingShape s) {
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
  int* qpos_s = reinterpret_cast<int*>(delta_s + kTile);
  int* red_s = qpos_s + kTile;  // [0, 1]: a q tile's max; [2, 3]: the k tile's min
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = blockIdx.x * kTile;
  const long long q_row0 = ((long long)b * s.heads + h) * s.tq;
  const long long k_row0 = ((long long)b * s.heads + h) * s.tk;
  const T* q_bh = q + b * s.q_sb + h * s.q_sh;

  load_tile<T, DP>(k_s, k + b * s.kv_sb + h * s.kv_sh, s.kv_st, k0, s.tk, s.d, 1.0f);
  load_tile<T, DP>(v_s, v + b * s.kv_sb + h * s.kv_sh, s.kv_st, k0, s.tk, s.d, 1.0f);
  int kp[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = k0 + ty + 16 * i;
    kp[i] = t < s.tk ? k_pos[t] : 0;
  }
  tile_pos_extreme<true>(k_pos, k0, s.tk, red_s + 2, nullptr);
  __syncthreads();
  const int k_min = min(red_s[2], red_s[3]);

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

  const int n_q = n_tiles(s.tq);
  for (int qb = 0; qb < n_q; ++qb) {
    const int q0 = qb * kTile;
    __syncthreads();
    if (s.causal) {
      tile_pos_extreme<false>(q_pos, q0, s.tq, red_s, qpos_s);
      __syncthreads();
      if (k_min > max(red_s[0], red_s[1])) continue;  // every query before every key
    }
    load_tile<T, DP>(q_s, q_bh, s.q_st, q0, s.tq, s.d, 1.0f);
    if constexpr (!kShare) {
      load_tile<float, DP>(do_s, dout + q_row0 * s.d, s.d, q0, s.tq, s.d, 1.0f);
    }
    if (threadIdx.x < kTile) {
      const int t = q0 + threadIdx.x;
      lse_s[threadIdx.x] = t < s.tq ? lse[q_row0 + t] : 0.0f;
      delta_s[threadIdx.x] = t < s.tq ? delta[q_row0 + t] : 0.0f;
    }
    __syncthreads();
    float st[4][4], dpt[4][4];
    dot_rows<DP, true>(k_s, q_s, st, s.scale);  // k . (q * scale)
    if constexpr (kShare) {  // dO in Q's place
      __syncthreads();
      load_tile<float, DP>(do_s, dout + q_row0 * s.d, s.d, q0, s.tq, s.d, 1.0f);
      __syncthreads();
    }
    dot_rows<DP, false>(v_s, do_s, dpt, 1.0f);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        const bool masked = q0 + col >= s.tq || (s.causal && kp[i] > qpos_s[col]) ||
                            below_half_neg_inf(lse_s[col]);
        const float p = masked ? 0.0f : expf(st[i][j] - lse_s[col]);
        pt_s[(ty + 16 * i) * kLdp + col] = p;
        if constexpr (kShare) {
          dpt[i][j] = p * (dpt[i][j] - delta_s[col]);
        } else {
          dst_s[(ty + 16 * i) * kLdp + col] = p * (dpt[i][j] - delta_s[col]);
        }
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
      load_tile<T, DP>(q_s, q_bh, s.q_st, q0, s.tq, s.d, 1.0f);
      __syncthreads();
    }
    acc_pv<DP>(dst_s, q_s, dk_acc);
  }
  store_rows<float, DP>(dk + k_row0 * s.d, s.d, k0, s.tk, s.d, dk_acc, s.scale);
  store_rows<float, DP>(dv + k_row0 * s.d, s.d, k0, s.tk, s.d, dv_acc, 1.0f);
}

template <typename T, int DP>
cudaError_t launch_ring_fwd(const void* q, const void* k, const void* v, float* acc,
                            float* lse, const int* q_pos, const int* k_pos, int batch,
                            const RingShape& s, cudaStream_t st) {
  // bf16 and f16 run on the tensor cores; f32 keeps the FMA kernel.
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return launch_ring_fwd_mma<T, DP>(q, k, v, acc, lse, q_pos, k_pos, batch, s, st);
  } else if constexpr (std::is_same<T, __half>::value) {
    return edl_ring::fwd_f16<DP>(q, k, v, acc, lse, q_pos, k_pos, batch, s, st);
  } else {
    constexpr int bytes = fwd_smem_bytes<DP>() + kRingSmemInts * 4;
    cudaError_t err = allow_smem(ring_fwd_kernel<T, DP>, bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid((s.tq + kTile - 1) / kTile, s.heads, batch);
    ring_fwd_kernel<T, DP><<<grid, kThreads, bytes, st>>>(
        (const T*)q, (const T*)k, (const T*)v, acc, lse, q_pos, k_pos, s);
    return cudaGetLastError();
  }
}

// dout_dtype as dtype: bf16 and f16 q, k, v run on the tensor cores with
// dO as it comes (in q's type, or f32 split in three bf16 parts); f32
// keeps the FMA kernel, whose dO is f32.
template <typename T, int DP>
cudaError_t launch_ring_dq(const void* q, const void* k, const void* v, const void* dout,
                           int dout_dtype, const float* lse, const float* delta, float* dq,
                           const int* q_pos, const int* k_pos, int batch, const RingShape& s,
                           cudaStream_t st) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (dout_dtype == 1) {
      return launch_ring_dq_mma<T, DP, 1>(q, k, v, dout, lse, delta, dq, q_pos, k_pos, batch,
                                          s, st);
    }
    if (dout_dtype == 0) {
      return launch_ring_dq_mma<T, DP, kF32DoParts>(q, k, v, dout, lse, delta, dq, q_pos,
                                                    k_pos, batch, s, st);
    }
    return cudaErrorInvalidValue;
  } else if constexpr (std::is_same<T, __half>::value) {
    return edl_ring::dq_f16<DP>(q, k, v, dout, dout_dtype, lse, delta, dq, q_pos, k_pos, batch,
                                s, st);
  } else {
    if (dout_dtype != 0) return cudaErrorInvalidValue;
    constexpr int bytes = dq_smem_bytes<DP>() + kRingSmemInts * 4;
    cudaError_t err = allow_smem(ring_dq_kernel<T, DP>, bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid((s.tq + kTile - 1) / kTile, s.heads, batch);
    ring_dq_kernel<T, DP><<<grid, kThreads, bytes, st>>>((const T*)q, (const T*)k, (const T*)v,
                                                         (const float*)dout, lse, delta, dq,
                                                         q_pos, k_pos, s);
    return cudaGetLastError();
  }
}

template <typename T, int DP>
cudaError_t launch_ring_dkv(const void* q, const void* k, const void* v, const void* dout,
                            int dout_dtype, const float* lse, const float* delta, float* dk,
                            float* dv, const int* q_pos, const int* k_pos, int batch,
                            const RingShape& s, cudaStream_t st) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (dout_dtype == 1) {
      return launch_ring_dkv_mma<T, DP, 1>(q, k, v, dout, lse, delta, dk, dv, q_pos, k_pos,
                                           batch, s, st);
    }
    if (dout_dtype == 0) {
      return launch_ring_dkv_mma<T, DP, kF32DoParts>(q, k, v, dout, lse, delta, dk, dv, q_pos,
                                                     k_pos, batch, s, st);
    }
    return cudaErrorInvalidValue;
  } else if constexpr (std::is_same<T, __half>::value) {
    return edl_ring::dkv_f16<DP>(q, k, v, dout, dout_dtype, lse, delta, dk, dv, q_pos, k_pos,
                                 batch, s, st);
  } else {
    if (dout_dtype != 0) return cudaErrorInvalidValue;
    constexpr int bytes = dkv_smem_bytes<DP>() + kRingSmemInts * 4;
    cudaError_t err = allow_smem(ring_dkv_kernel<T, DP>, bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid((s.tk + kTile - 1) / kTile, s.heads, batch);
    ring_dkv_kernel<T, DP><<<grid, kThreads, bytes, st>>>((const T*)q, (const T*)k, (const T*)v,
                                                          (const float*)dout, lse, delta, dk, dv,
                                                          q_pos, k_pos, s);
    return cudaGetLastError();
  }
}

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  K7-K9, as K4-K6:
// head_dim d <= 64 runs the DP=64 build, 64 < d <= 128 the DP=128 one,
// 128 < d <= 256 the DP=256 one (the wrapper pads d to a multiple of 8).
#define EDL_RING_DISPATCH(CALL)                                      \
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

// The ring steps: q strides, then the K/V block's; t_len, which the
// dispatch checks, is the shorter of Tq and Tk.
int edl_ring_fwd(const void* q, const void* k, const void* v, float* acc, float* lse,
                 const int* q_pos, const int* k_pos, int batch, int heads, int tq,
                 int tk, int d, long long q_sb, long long q_st, long long q_sh,
                 long long kv_sb, long long kv_st, long long kv_sh, float scale,
                 int causal, int dtype, void* stream) {
  const RingShape s{heads, tq, tk, d, q_sb, q_st, q_sh, kv_sb, kv_st, kv_sh, scale, causal};
  const cudaStream_t st = (cudaStream_t)stream;
  const int t_len = tq < tk ? tq : tk;
#define EDL_CALL(T, DP) \
  launch_ring_fwd<T, DP>(q, k, v, acc, lse, q_pos, k_pos, batch, s, st)
  EDL_RING_DISPATCH(EDL_CALL);
#undef EDL_CALL
}

// The ring's backward steps take dO's dtype code after dO (0 = float32,
// 1 = bfloat16, 2 = float16; a 2-byte dO only beside q, k, v of its
// type).
int edl_ring_dq(const void* q, const void* k, const void* v, const void* dout, int dout_dtype,
                const float* lse, const float* delta, float* dq, const int* q_pos,
                const int* k_pos, int batch, int heads, int tq, int tk, int d,
                long long q_sb, long long q_st, long long q_sh, long long kv_sb,
                long long kv_st, long long kv_sh, float scale, int causal, int dtype,
                void* stream) {
  const RingShape s{heads, tq, tk, d, q_sb, q_st, q_sh, kv_sb, kv_st, kv_sh, scale, causal};
  const cudaStream_t st = (cudaStream_t)stream;
  const int t_len = tq < tk ? tq : tk;
#define EDL_CALL(T, DP) \
  launch_ring_dq<T, DP>(q, k, v, dout, dout_dtype, lse, delta, dq, q_pos, k_pos, batch, s, st)
  EDL_RING_DISPATCH(EDL_CALL);
#undef EDL_CALL
}

int edl_ring_dkv(const void* q, const void* k, const void* v, const void* dout, int dout_dtype,
                 const float* lse, const float* delta, float* dk, float* dv,
                 const int* q_pos, const int* k_pos, int batch, int heads, int tq,
                 int tk, int d, long long q_sb, long long q_st, long long q_sh,
                 long long kv_sb, long long kv_st, long long kv_sh, float scale,
                 int causal, int dtype, void* stream) {
  const RingShape s{heads, tq, tk, d, q_sb, q_st, q_sh, kv_sb, kv_st, kv_sh, scale, causal};
  const cudaStream_t st = (cudaStream_t)stream;
  const int t_len = tq < tk ? tq : tk;
#define EDL_CALL(T, DP)                                                                       \
  launch_ring_dkv<T, DP>(q, k, v, dout, dout_dtype, lse, delta, dk, dv, q_pos, k_pos, batch, s, \
                         st)
  EDL_RING_DISPATCH(EDL_CALL);
#undef EDL_CALL
}

}  // extern "C"
