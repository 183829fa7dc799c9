// The float16 builds of K4-K6 (flash_fwd_mma_kernel, flash_dq_mma_kernel,
// flash_dkv_mma_kernel and, at DP = 256, flash_dkv_mma_pair_kernel on
// __half), the templates of flash_mma.cuh instantiated in a unit of their
// own so that they compile beside flash_attention.cu and
// ring_attention.cu (ops/_build.py) instead of lengthening either.
// flash_attention.cu's entry points reach them for dtype 2 through the
// edl_flash::*_f16 launchers defined here.

#include "flash_mma.cuh"

namespace edl_flash {

template <int DP>
cudaError_t fwd_f16(const void* q, const void* k, const void* v, void* out, float* lse,
                    int batch, const Shape& s, cudaStream_t st) {
  return launch_fwd_mma<__half, DP>(q, k, v, out, lse, batch, s, st);
}

template <int DP>
cudaError_t dq_f16(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, void* dq, int batch, const Shape& s,
                   cudaStream_t st) {
  return launch_dq_mma<__half, DP>(q, k, v, dout, lse, delta, dq, batch, s, st);
}

template <int DP>
cudaError_t dkv_f16(const void* q, const void* k, const void* v, const void* dout,
                    const float* lse, const float* delta, void* dk, void* dv, int batch,
                    const Shape& s, cudaStream_t st) {
  return launch_dkv_mma<__half, DP>(q, k, v, dout, lse, delta, dk, dv, batch, s, st);
}

#define EDL_F16_BUILDS(DP)                                                                    \
  template cudaError_t fwd_f16<DP>(const void*, const void*, const void*, void*, float*, int,  \
                                   const Shape&, cudaStream_t);                               \
  template cudaError_t dq_f16<DP>(const void*, const void*, const void*, const void*,         \
                                  const float*, const float*, void*, int, const Shape&,       \
                                  cudaStream_t);                                              \
  template cudaError_t dkv_f16<DP>(const void*, const void*, const void*, const void*,        \
                                   const float*, const float*, void*, void*, int,             \
                                   const Shape&, cudaStream_t);

EDL_F16_BUILDS(64)
EDL_F16_BUILDS(128)
EDL_F16_BUILDS(256)

#undef EDL_F16_BUILDS

}  // namespace edl_flash
