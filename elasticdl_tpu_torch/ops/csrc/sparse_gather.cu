// K10, the block-gather probe, for Hopper (sm_90a), behind a plain C
// interface that ops/_build.py compiles with nvcc and binds with ctypes.
//
//   edl_block_gather  <- gather_kernel (scripts/exp_sparse_gather.py:154,
//                        pallas_gather :157, pallas_call :159): for each
//                        index b[i], copy the aligned 8-row block
//                        packed[8*b[i] : 8*b[i]+8, :] of the packed
//                        [num_blocks, 128] f32 table to out[i] ([n, 8, 128]).
//
// The index rule is the Pallas kernel's, read in interpret mode (JAX 0.9):
// the block's first row is 8*b as an int32 product (it wraps), a negative
// first row is moved up by the table's row count once (so b = -1 reads the
// last block), and the result is clamped to [0, rows - 8].  Hence b in
// [-nb8, nb8) reads block b mod nb8, b >= nb8 the last block, b < -nb8
// block 0 (nb8 = num_blocks / 8).
//
// What bounds it: bytes.  Each index reads 4096 B and writes 4096 B and
// does no arithmetic.  The design: one warp per index, each lane moving 8
// float4 (16 B) of the block, neighbouring lanes on neighbouring addresses,
// so every load and store of a warp covers one contiguous 512-B span.  A
// faster design (TMA bulk copies, several indices in flight per warp) is
// later work.
//
// The entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;                         // f32 per packed row
constexpr int kRows = 8;                            // packed rows per block
constexpr int kVecs = kRows * kLanes / 4;           // float4 per block: 256
constexpr int kWarps = 8;                           // indices per thread block

__device__ __forceinline__ long long first_row(int b, int rows) {
  int start = (int)((unsigned int)b * 8u);  // the int32 product, wrapping
  if (start < 0) start += rows;
  return (long long)min(max(start, 0), rows - kRows);
}

__global__ void __launch_bounds__(kWarps * 32)
block_gather_kernel(const float4* __restrict__ table,
                    const int* __restrict__ idx, float4* __restrict__ out,
                    long long n, int rows) {
  const long long i = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= n) return;
  const int lane = threadIdx.x & 31;
  const float4* src = table + first_row(__ldg(idx + i), rows) * (kLanes / 4);
  float4* dst = out + i * kVecs;
#pragma unroll
  for (int k = 0; k < kVecs / 32; ++k) {
    dst[k * 32 + lane] = __ldg(src + k * 32 + lane);
  }
}

}  // namespace

extern "C" {

int edl_block_gather(const float* table, const int* idx, float* out,
                     long long n, int num_blocks8, void* stream) {
  if (n > 0) {
    const long long blocks = (n + kWarps - 1) / kWarps;
    if (blocks > 0x7fffffffLL || num_blocks8 < 1 ||
        num_blocks8 > 0x7fffffff / kRows) {
      return (int)cudaErrorInvalidConfiguration;
    }
    block_gather_kernel<<<(unsigned int)blocks, kWarps * 32, 0,
                          (cudaStream_t)stream>>>(
        (const float4*)table, idx, (float4*)out, n, num_blocks8 * kRows);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
