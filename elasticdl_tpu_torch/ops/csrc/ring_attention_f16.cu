// The float16 builds of K7-K9 (ring_fwd_mma_kernel, ring_dq_mma_kernel,
// ring_dkv_mma_kernel and, at DP = 256, ring_dkv_mma_pair_kernel on
// __half), the templates of ring_mma.cuh instantiated in a unit of their
// own so that they compile beside ring_attention.cu and the flash
// attention units (ops/_build.py) instead of lengthening one of them.
// ring_attention.cu's entry points reach them for dtype 2 through the
// edl_ring::*_f16 launchers defined here; K8 and K9 take dO as f16
// (dout_dtype 2, the CP path's gradient) or as f32 (0, three bf16 parts).

#include "ring_mma.cuh"

namespace edl_ring {

template <int DP>
cudaError_t fwd_f16(const void* q, const void* k, const void* v, float* acc, float* lse,
                    const int* q_pos, const int* k_pos, int batch, const RingShape& s,
                    cudaStream_t st) {
  return launch_ring_fwd_mma<__half, DP>(q, k, v, acc, lse, q_pos, k_pos, batch, s, st);
}

template <int DP>
cudaError_t dq_f16(const void* q, const void* k, const void* v, const void* dout,
                   int dout_dtype, const float* lse, const float* delta, float* dq,
                   const int* q_pos, const int* k_pos, int batch, const RingShape& s,
                   cudaStream_t st) {
  if (dout_dtype == 2) {
    return launch_ring_dq_mma<__half, DP, 1>(q, k, v, dout, lse, delta, dq, q_pos, k_pos,
                                             batch, s, st);
  }
  if (dout_dtype == 0) {
    return launch_ring_dq_mma<__half, DP, kF32DoParts>(q, k, v, dout, lse, delta, dq, q_pos,
                                                       k_pos, batch, s, st);
  }
  return cudaErrorInvalidValue;
}

template <int DP>
cudaError_t dkv_f16(const void* q, const void* k, const void* v, const void* dout,
                    int dout_dtype, const float* lse, const float* delta, float* dk, float* dv,
                    const int* q_pos, const int* k_pos, int batch, const RingShape& s,
                    cudaStream_t st) {
  if (dout_dtype == 2) {
    return launch_ring_dkv_mma<__half, DP, 1>(q, k, v, dout, lse, delta, dk, dv, q_pos, k_pos,
                                              batch, s, st);
  }
  if (dout_dtype == 0) {
    return launch_ring_dkv_mma<__half, DP, kF32DoParts>(q, k, v, dout, lse, delta, dk, dv,
                                                        q_pos, k_pos, batch, s, st);
  }
  return cudaErrorInvalidValue;
}

#define EDL_RING_F16_BUILDS(DP)                                                                \
  template cudaError_t fwd_f16<DP>(const void*, const void*, const void*, float*, float*,      \
                                   const int*, const int*, int, const RingShape&,              \
                                   cudaStream_t);                                              \
  template cudaError_t dq_f16<DP>(const void*, const void*, const void*, const void*, int,     \
                                  const float*, const float*, float*, const int*, const int*,  \
                                  int, const RingShape&, cudaStream_t);                        \
  template cudaError_t dkv_f16<DP>(const void*, const void*, const void*, const void*, int,    \
                                   const float*, const float*, float*, float*, const int*,     \
                                   const int*, int, const RingShape&, cudaStream_t);

EDL_RING_F16_BUILDS(64)
EDL_RING_F16_BUILDS(128)
EDL_RING_F16_BUILDS(256)

#undef EDL_RING_F16_BUILDS

}  // namespace edl_ring
