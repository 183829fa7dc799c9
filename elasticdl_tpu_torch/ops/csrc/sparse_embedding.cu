// Sparse-embedding forward kernels for Hopper (sm_90a), behind a plain C
// interface that ops/_build.py compiles with nvcc and binds with ctypes.
//
// Two kernels, each replacing one Pallas TPU kernel of
// elasticdl_tpu/ops/sparse_embedding.py:
//
//   edl_fused_lookup     <- _lookup_kernel (fused_lookup): gather each id's
//                           row and keep its first `dim` lanes.
//   edl_fused_lookup_fm  <- _fm_kernel (fused_lookup_fm): the DeepFM merged
//                           1+d lookup, acts = (row + bet) * valid, plus the
//                           first-order sum (lane 0) and the FM partial sums
//                           sum_v / sum_sq (lanes 1..dim-1) in the same pass.
//
// The table is addressed as LOGICAL rows of `dim_padded` f32 (the JAX
// package's packed [num_blocks, 128] buffer is the same bytes), and an id
// maps to row clamp(id // r, 0, nb-1) * r + floor_mod(id, r): the clamp
// rule of _block_and_lane, so every id reads a real row.
//
// What bounds them: both move a few bytes per id and do almost no
// arithmetic, so device-memory traffic (random 64 B rows at DeepFM's
// dim_padded 16) and its latency are the limit, not operations.  The
// design answers with one thread per output element: neighbouring threads
// read neighbouring lanes of a row, every thread owns its outputs (no
// atomics, no shared memory), and the FM kernel walks the fields in order
// f = 0..F-1 like _fm_kernel, so a repeat call gives the same bits.  The
// sums are formed with __fadd_rn / __fmul_rn so nvcc cannot contract
// `ss + a * a` into an FMA: the kernel's rounding is the sequential f32
// loop of the TPU kernel, step for step.
//
// Every entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() so the Python wrapper can raise on a
// refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ long long row_of(int id, int rows_per_block,
                                            int num_blocks) {
  int block = id / rows_per_block;
  int slot = id - block * rows_per_block;
  if (slot < 0) {  // C division truncates; the rule is floor division
    slot += rows_per_block;
    block -= 1;
  }
  block = min(max(block, 0), num_blocks - 1);
  return (long long)block * rows_per_block + slot;
}

__global__ void lookup_kernel(const float* __restrict__ table,
                              const int* __restrict__ ids,
                              float* __restrict__ out, long long n,
                              int rows_per_block, int num_blocks,
                              int dim_padded, int dim) {
  const long long total = n * dim;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    const long long i = t / dim;
    const int lane = (int)(t - i * dim);
    const long long row = row_of(__ldg(ids + i), rows_per_block, num_blocks);
    out[t] = __ldg(table + row * dim_padded + lane);
  }
}

__global__ void lookup_fm_kernel(const float* __restrict__ table,
                                 const float* __restrict__ bet,
                                 const int* __restrict__ ids,
                                 const uint8_t* __restrict__ valid,
                                 float* __restrict__ acts,
                                 float* __restrict__ first,
                                 float* __restrict__ sum_v,
                                 float* __restrict__ sum_sq, int batch,
                                 int fields, int rows_per_block,
                                 int num_blocks, int dim_padded, int dim) {
  const long long total = (long long)batch * dim;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    const long long b = t / dim;
    const int lane = (int)(t - b * dim);
    float acc = 0.0f;
    float acc_sq = 0.0f;
    for (int f = 0; f < fields; ++f) {
      const long long bf = b * fields + f;
      const long long row = row_of(__ldg(ids + bf), rows_per_block,
                                   num_blocks);
      const float x = __ldg(table + row * dim_padded + lane);
      const float add = bet != nullptr ? __ldg(bet + bf * dim + lane) : 0.0f;
      const float keep = __ldg(valid + bf) ? 1.0f : 0.0f;
      const float a = __fmul_rn(__fadd_rn(x, add), keep);
      acts[bf * dim + lane] = a;
      acc = __fadd_rn(acc, a);
      acc_sq = __fadd_rn(acc_sq, __fmul_rn(a, a));
    }
    if (lane == 0) {
      first[b] = acc;
    } else {
      sum_v[b * (dim - 1) + lane - 1] = acc;
      sum_sq[b * (dim - 1) + lane - 1] = acc_sq;
    }
  }
}

unsigned int grid_for(long long total) {
  long long blocks = (total + kThreads - 1) / kThreads;
  // Past ~1M blocks the grid-stride loop takes over.
  return (unsigned int)(blocks < (1 << 20) ? blocks : (1 << 20));
}

}  // namespace

extern "C" {

int edl_fused_lookup(const float* table, const int* ids, float* out,
                     long long n, int rows_per_block, int num_blocks,
                     int dim_padded, int dim, void* stream) {
  const long long total = n * dim;
  if (total > 0) {
    lookup_kernel<<<grid_for(total), kThreads, 0, (cudaStream_t)stream>>>(
        table, ids, out, n, rows_per_block, num_blocks, dim_padded, dim);
  }
  return (int)cudaGetLastError();
}

int edl_fused_lookup_fm(const float* table, const float* bet, const int* ids,
                        const uint8_t* valid, float* acts, float* first,
                        float* sum_v, float* sum_sq, int batch, int fields,
                        int rows_per_block, int num_blocks, int dim_padded,
                        int dim, void* stream) {
  const long long total = (long long)batch * dim;
  if (total > 0) {
    lookup_fm_kernel<<<grid_for(total), kThreads, 0, (cudaStream_t)stream>>>(
        table, bet, ids, valid, acts, first, sum_v, sum_sq, batch, fields,
        rows_per_block, num_blocks, dim_padded, dim);
  }
  return (int)cudaGetLastError();
}

const char* edl_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
