// Sparse-embedding kernels for Hopper (sm_90a), behind a plain C
// interface that ops/_build.py compiles with nvcc and binds with ctypes.
//
// Three kernels, each replacing one Pallas TPU kernel of
// elasticdl_tpu/ops/sparse_embedding.py:
//
//   edl_fused_lookup       <- _lookup_kernel (fused_lookup): gather each
//                             id's row and keep its first `dim` lanes.
//   edl_fused_lookup_fm    <- _fm_kernel (fused_lookup_fm): the DeepFM
//                             merged 1+d lookup, acts = (row + bet) * valid,
//                             plus the first-order sum (lane 0) and the FM
//                             partial sums sum_v / sum_sq (lanes 1..dim-1)
//                             in the same pass.
//   edl_fused_dedup_apply  <- _dedup_apply_kernel (fused_dedup_apply): the
//                             sparse optimizer update, in place; see its
//                             own note below.
//
// The lookups:
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

// ---------------------------------------------------------------------
// edl_fused_dedup_apply <- _dedup_apply_kernel (fused_dedup_apply)
//
// The one-pass sparse optimizer update.  The wrapper sorts the ids
// (stable, so each row's occurrences stay in position order; ids outside
// [0, vocab_padded) carry the key vocab_padded and sort last).  Thread
// group i (G = min(dim_padded, 32) threads, one per lane, lanes beyond
// 32 looped) owns sorted position i; it is active when i starts a
// segment of a real row.  It sums the segment's grads lane by lane from
// 0.0f in position order (the JAX scatter-add onto the representative),
// tests "any lane != 0" with a warp ballot (the touched rule: rows whose
// sum is exactly zero keep their slots), and applies the optimizer math
// to the row in place, in delta form: every operand becomes
// old + fl(new - old).  Each touched row belongs to exactly one segment,
// so no two groups write the same row and no atomics are needed: the
// TPU kernel serialised representatives sharing a 512 B storage row
// through its sequential grid, logical 64 B rows remove the sharing.
//
// Rounding: every product, sum and quotient is an explicit _rn
// intrinsic, so nvcc cannot contract a*b + c into an FMA; constants
// arrive from the host already rounded to f32 as JAX rounds its weakly
// typed hyperparameters (1 - b1 formed in double).  sqrt and division
// are IEEE-rounded.  Pad lanes (>= dim) are not written: their grads are
// zero, and the JAX kernel's write there adds a zero delta to a zero.
//
// What bounds it: memory traffic and its latency.  Per id it reads a
// sort key, a permutation index and `dim` grads; per touched row it
// reads and writes the table and slot rows (64 B each at dim_padded 16).
// The arithmetic is a few dozen flops per lane.
// ---------------------------------------------------------------------

enum Kind { kSgd = 0, kMomentum = 1, kAdagrad = 2, kAdam = 3, kAdamGlobal = 4 };

struct ApplyConsts {
  float lr_neg, mu, eps, b1, b2, omb1, omb2;
  int nesterov;
};

__device__ __forceinline__ float segment_sum(const int* __restrict__ sorted_ids,
                                             const long long* __restrict__ perm,
                                             const float* __restrict__ grads,
                                             long long i, long long n, int row,
                                             int dim, int lane) {
  float acc = 0.0f;
  for (long long j = i; j < n && __ldg(sorted_ids + j) == row; ++j) {
    acc = __fadd_rn(acc, __ldg(grads + __ldg(perm + j) * dim + lane));
  }
  return acc;
}

__global__ void dedup_apply_kernel(const int* __restrict__ sorted_ids,
                                   const long long* __restrict__ perm,
                                   const float* __restrict__ grads, long long n,
                                   int vocab_padded, int dim_padded, int dim,
                                   int kind, float* table, float* s1, float* s2,
                                   float* s3, const float* tr_global,
                                   ApplyConsts c) {
  const int group = dim_padded < 32 ? dim_padded : 32;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long i = t / group;
  const int sub = (int)(t - i * group);
  int row = vocab_padded;
  bool start = false;
  if (i < n) {
    row = __ldg(sorted_ids + i);
    start = row < vocab_padded && (i == 0 || __ldg(sorted_ids + i - 1) != row);
  }
  float g_first = 0.0f;
  bool nonzero = false;
  float tr = 0.0f;
  const long long base = (long long)row * dim_padded;
  if (start) {
    for (int lane = sub; lane < dim; lane += group) {
      const float s = segment_sum(sorted_ids, perm, grads, i, n, row, dim, lane);
      if (lane == sub) g_first = s;
      nonzero = nonzero || s != 0.0f;
    }
    // Adam's step count, read before any thread of the group writes the
    // row: tr = max(t[lane 0] + 1, 1) per row, or the host's t_global.
    if (kind == kAdam) tr = fmaxf(__fadd_rn(s3[base], 1.0f), 1.0f);
    if (kind == kAdamGlobal) tr = *tr_global;
  }
  // Every thread of the warp reaches the ballot (no early return above).
  const unsigned ballot = __ballot_sync(0xffffffffu, nonzero);
  __syncwarp();
  const int first_bit = ((threadIdx.x & 31) / group) * group;
  const unsigned mask =
      group == 32 ? 0xffffffffu : ((1u << group) - 1u) << first_bit;
  if (!start || (ballot & mask) == 0u) return;

  float bc1 = 1.0f, bc2 = 1.0f;
  if (kind == kAdam || kind == kAdamGlobal) {
    bc1 = __fsub_rn(1.0f, powf(c.b1, tr));
    bc2 = __fsub_rn(1.0f, powf(c.b2, tr));
  }
  for (int lane = sub; lane < dim; lane += group) {
    const float g = lane == sub
        ? g_first
        : segment_sum(sorted_ids, perm, grads, i, n, row, dim, lane);
    const long long x = base + lane;
    const float w = table[x];
    switch (kind) {
      case kSgd:
        table[x] = __fadd_rn(w, __fmul_rn(c.lr_neg, g));
        break;
      case kMomentum: {
        const float v = s1[x];
        const float v_new = __fadd_rn(__fmul_rn(c.mu, v), g);
        const float step =
            c.nesterov ? __fadd_rn(__fmul_rn(c.mu, v_new), g) : v_new;
        table[x] = __fadd_rn(w, __fmul_rn(c.lr_neg, step));
        s1[x] = __fadd_rn(v, __fsub_rn(v_new, v));
        break;
      }
      case kAdagrad: {
        const float acc = s1[x];
        const float gg = __fmul_rn(g, g);
        const float new_acc = __fadd_rn(acc, gg);
        const float update = __fdiv_rn(__fmul_rn(c.lr_neg, g),
                                       __fadd_rn(__fsqrt_rn(new_acc), c.eps));
        table[x] = __fadd_rn(w, update);
        s1[x] = __fadd_rn(acc, gg);
        break;
      }
      default: {  // kAdam, kAdamGlobal
        const float m = s1[x];
        const float v = s2[x];
        const float m_new = __fadd_rn(__fmul_rn(c.b1, m), __fmul_rn(c.omb1, g));
        const float v_new = __fadd_rn(__fmul_rn(c.b2, v),
                                      __fmul_rn(__fmul_rn(c.omb2, g), g));
        const float m_hat = __fdiv_rn(m_new, bc1);
        const float v_hat = __fdiv_rn(v_new, bc2);
        const float update = __fdiv_rn(__fmul_rn(c.lr_neg, m_hat),
                                       __fadd_rn(__fsqrt_rn(v_hat), c.eps));
        table[x] = __fadd_rn(w, update);
        s1[x] = __fadd_rn(m, __fsub_rn(m_new, m));
        s2[x] = __fadd_rn(v, __fsub_rn(v_new, v));
        if (kind == kAdam) s3[x] = __fadd_rn(s3[x], 1.0f);
        break;
      }
    }
  }
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

int edl_fused_dedup_apply(const int* sorted_ids, const long long* perm,
                          const float* grads, long long n, int vocab_padded,
                          int dim_padded, int dim, int kind, float* table,
                          float* s1, float* s2, float* s3,
                          const float* tr_global, float lr_neg, float mu,
                          int nesterov, float eps, float b1, float b2,
                          float omb1, float omb2, void* stream) {
  const int group = dim_padded < 32 ? dim_padded : 32;
  const long long total = n * group;
  if (total > 0) {
    // One block per kThreads threads, no grid-stride loop: every warp of
    // the grid must reach the ballot as a whole.
    const long long blocks = (total + kThreads - 1) / kThreads;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    ApplyConsts c{lr_neg, mu, eps, b1, b2, omb1, omb2, nesterov};
    dedup_apply_kernel<<<(unsigned int)blocks, kThreads, 0,
                         (cudaStream_t)stream>>>(
        sorted_ids, perm, grads, n, vocab_padded, dim_padded, dim, kind,
        table, s1, s2, s3, tr_global, c);
  }
  return (int)cudaGetLastError();
}

const char* edl_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
