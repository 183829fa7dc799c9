// Sparse-embedding kernels for Hopper (sm_90a), behind a plain C
// interface that ops/_build.py compiles with nvcc and binds with ctypes.
//
// Three kernels, each replacing one Pallas TPU kernel of
// elasticdl_tpu/ops/sparse_embedding.py:
//
//   edl_fused_lookup       <- _lookup_kernel (fused_lookup): gather each
//                             id's row and keep its first `dim` lanes, on
//                             one card or on a model shard with the ids
//                             routed to it; see its own note below.
//   edl_fused_lookup_fm    <- _fm_kernel (fused_lookup_fm): the DeepFM
//                             merged 1+d lookup, acts = (row + bet) * valid,
//                             plus the first-order sum (lane 0) and the FM
//                             partial sums sum_v / sum_sq (lanes 1..dim-1)
//                             in the same pass; see its own note below.
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
// What bounds all three: they move a few bytes per id and do almost no
// arithmetic, and the rows they touch are random 64 B rows (DeepFM's
// dim_padded 16; its 9 real lanes span two 32-byte sectors).  So the
// limit is device-memory latency and sector traffic, not operations:
// the designs keep many independent loads in flight and no thread waits
// on a chain of loads that depend on each other.  Every sum is formed
// with __fadd_rn / __fmul_rn so nvcc cannot contract `ss + a * a` into
// an FMA, in a fixed order, so a repeat call gives the same bits.
//
// Every entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() so the Python wrapper can raise on a
// refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

// ---------------------------------------------------------------------
// edl_fused_lookup <- _lookup_kernel (fused_lookup),
// elasticdl_tpu/ops/sparse_embedding.py:249, with the shard routing of
// _sharded_lookup_impl (:340)
//
// The Pallas kernel DMAs one storage row per id, double-buffered (row
// i+1's copy overlaps row i's lane select).  Here the output is read as
// units of V floats (V = 4, 2 or 1: the widest that divides dim, chosen
// by the launcher); a block owns a tile of `tile` ids, one contiguous
// span of them and of the output, and every thread takes kLookupLoads
// of the tile's units a blockDim apart:
//   1. it loads the ids of all its units at once (the lanes of one id
//      read the same word, coalesced) and turns each into its row by
//      row_of.  On a model shard (start >= 0) the id is routed first:
//      rel = id - start in 64 bits is owned when 0 <= rel < the shard's
//      rows and reads its clamp-rule row; an id another shard owns reads
//      local row 0, kept as 0.0f: its lanes are multiplied by 0.0f as the
//      plain route and JAX mask them, so a -0.0 or a NaN in row 0 comes
//      through as there (owned lanes are multiplied by 1.0f, as there);
//   2. it issues all its units' row loads before it stores any, and the
//      stores of a warp are contiguous.
// What bounds it: a few bytes per id and no arithmetic, so the random
// rows' 32-byte sectors and their latency.  A thread waits on two
// dependent round trips (ids, then rows) with kLookupLoads row loads in
// flight; a dim-8 row is two float4 loads and two float4 stores.  No
// shared memory and no barrier: a unit's row load leaves as soon as its
// own id is back (a build that staged the tile's row offsets in shared
// memory first ran slower at small calls and at dim 1).  With the L2
// cold, every schedule tried reads the path's shapes at nearly the same
// time: the random rows' DRAM accesses set it (PERF.md).  Every lane is
// an exact copy of the row's (times 1.0f or 0.0f on a shard).
// ---------------------------------------------------------------------

constexpr int kLookupLoads = 4;
// Units a tile holds: one pass of a block's threads.
constexpr int kLookupUnits = kThreads * kLookupLoads;
// Fewer ids a tile until the grid has this many blocks (about two an SM):
// a small call (a serving batch) spreads over the SMs.
constexpr int kLookupMinBlocks = 512;

template <int V> struct Units;
template <> struct Units<1> { using T = float; };
template <> struct Units<2> { using T = float2; };
template <> struct Units<4> { using T = float4; };

__device__ __forceinline__ float scaled(float x, float k) { return __fmul_rn(x, k); }
__device__ __forceinline__ float2 scaled(float2 x, float k) {
  return make_float2(__fmul_rn(x.x, k), __fmul_rn(x.y, k));
}
__device__ __forceinline__ float4 scaled(float4 x, float k) {
  return make_float4(__fmul_rn(x.x, k), __fmul_rn(x.y, k), __fmul_rn(x.z, k),
                     __fmul_rn(x.w, k));
}

template <int V>
__global__ void __launch_bounds__(kThreads)
lookup_kernel(const float* __restrict__ table, const int* __restrict__ ids,
              float* __restrict__ out, long long n, long long start,
              int rows_per_block, int num_blocks, int dim_padded, int dim,
              int tile) {
  using T = typename Units<V>::T;
  const long long i0 = (long long)blockIdx.x * tile;
  const int count = (int)min((long long)tile, n - i0);
  const int w = dim / V;  // units a row
  const int units = count * w;
  const bool routed = start >= 0;
  const long long shard_rows = (long long)rows_per_block * num_blocks;
  const int* tile_ids = ids + i0;
  T* out_t = reinterpret_cast<T*>(out + i0 * dim);
  for (int e0 = threadIdx.x; e0 < units; e0 += blockDim.x * kLookupLoads) {
    int id[kLookupLoads];
#pragma unroll
    for (int u = 0; u < kLookupLoads; ++u) {
      const int e = e0 + u * blockDim.x;
      id[u] = e < units ? __ldg(tile_ids + e / w) : 0;
    }
    T x[kLookupLoads];
    float keep[kLookupLoads];
#pragma unroll
    for (int u = 0; u < kLookupLoads; ++u) {
      const int e = e0 + u * blockDim.x;
      keep[u] = 1.0f;
      if (e < units) {
        int local = id[u];
        if (routed) {
          const long long rel = (long long)id[u] - start;
          const bool owned = rel >= 0 && rel < shard_rows;
          local = owned ? (int)rel : 0;
          keep[u] = owned ? 1.0f : 0.0f;
        }
        const long long base = row_of(local, rows_per_block, num_blocks) * dim_padded;
        x[u] = __ldg(reinterpret_cast<const T*>(table + base) + (e - (e / w) * w));
      }
    }
#pragma unroll
    for (int u = 0; u < kLookupLoads; ++u) {
      const int e = e0 + u * blockDim.x;
      if (e < units) out_t[e] = routed ? scaled(x[u], keep[u]) : x[u];
    }
  }
}

// ---------------------------------------------------------------------
// edl_fused_lookup_fm <- _fm_kernel (fused_lookup_fm),
// elasticdl_tpu/ops/sparse_embedding.py:755
//
// The Pallas kernel walks one example's fields in order, prefetching
// field f+1's storage row while it uses field f's.  Here a block owns a
// tile of `tile_rows` batch rows (at most kFmRows) and works in three
// steps:
//   1. the tile's ids and valid flags, one contiguous span each, are read
//      coalesced into shared memory as row offsets and 1.0f / 0.0f;
//   2. every thread takes (b, f, lane) elements of the tile kFmLoads at
//      a time: it issues all their table loads (and bet loads) before it
//      uses any, so a thread has kFmLoads rows in flight and a block a
//      whole tile; acts = (row + bet) * valid is written coalesced (the
//      tile's acts are one contiguous span) and kept in shared memory;
//   3. after a barrier, thread (b, lane) sums f = 0..F-1 IN ORDER from
//      0.0f out of shared memory: the operations and the order of the
//      sequential loop of the Pallas kernel, so the sums' bits do not
//      depend on the tile.
// A thread thus waits on two device-memory round trips (ids, then rows)
// instead of one pair per field.  A ragged last tile is masked; any
// fields >= 1 and dim >= 2 are taken.
// ---------------------------------------------------------------------

constexpr int kFmRows = 8;
constexpr int kFmLoads = 8;
// Fewer rows a tile until the grid has this many blocks: a small batch
// (serving's 64 rows) spreads over more SMs.
constexpr int kFmMinBlocks = 64;

__global__ void __launch_bounds__(kThreads)
lookup_fm_kernel(const float* __restrict__ table, const float* __restrict__ bet,
                 const int* __restrict__ ids, const uint8_t* __restrict__ valid,
                 float* __restrict__ acts, float* __restrict__ first,
                 float* __restrict__ sum_v, float* __restrict__ sum_sq,
                 int batch, int fields, int rows_per_block, int num_blocks,
                 int dim_padded, int dim, int tile_rows) {
  extern __shared__ __align__(16) unsigned char fm_smem[];
  const long long b0 = (long long)blockIdx.x * tile_rows;
  const int rows = (int)min((long long)tile_rows, batch - b0);
  const int nf = rows * fields;   // ids in the tile
  const int ne = nf * dim;        // acts elements in the tile
  long long* base_s = reinterpret_cast<long long*>(fm_smem);
  float* keep_s = reinterpret_cast<float*>(base_s + (long long)tile_rows * fields);
  float* acts_s = keep_s + (long long)tile_rows * fields;
  const long long id0 = b0 * fields;

  for (int t = threadIdx.x; t < nf; t += blockDim.x) {
    base_s[t] = row_of(__ldg(ids + id0 + t), rows_per_block, num_blocks) * dim_padded;
    keep_s[t] = __ldg(valid + id0 + t) ? 1.0f : 0.0f;
  }
  __syncthreads();

  const long long e_base = id0 * dim;
  for (int e0 = threadIdx.x; e0 < ne; e0 += blockDim.x * kFmLoads) {
    float x[kFmLoads];
    float add[kFmLoads];
#pragma unroll
    for (int u = 0; u < kFmLoads; ++u) {
      const int e = e0 + u * blockDim.x;
      x[u] = 0.0f;
      add[u] = 0.0f;
      if (e < ne) {
        const int t = e / dim;
        x[u] = __ldg(table + base_s[t] + (e - t * dim));
        if (bet != nullptr) add[u] = __ldg(bet + e_base + e);
      }
    }
#pragma unroll
    for (int u = 0; u < kFmLoads; ++u) {
      const int e = e0 + u * blockDim.x;
      if (e < ne) {
        const float a = __fmul_rn(__fadd_rn(x[u], add[u]), keep_s[e / dim]);
        acts[e_base + e] = a;
        acts_s[e] = a;
      }
    }
  }
  __syncthreads();

  for (int t = threadIdx.x; t < rows * dim; t += blockDim.x) {
    const int b = t / dim;
    const int lane = t - b * dim;
    const float* col = acts_s + (long long)b * fields * dim + lane;
    float acc = 0.0f;
    float acc_sq = 0.0f;
    for (int f = 0; f < fields; ++f) {
      const float a = col[f * dim];
      acc = __fadd_rn(acc, a);
      acc_sq = __fadd_rn(acc_sq, __fmul_rn(a, a));
    }
    const long long bb = b0 + b;
    if (lane == 0) {
      first[bb] = acc;
    } else {
      sum_v[bb * (dim - 1) + lane - 1] = acc;
      sum_sq[bb * (dim - 1) + lane - 1] = acc_sq;
    }
  }
}

// ---------------------------------------------------------------------
// edl_fused_dedup_apply <- _dedup_apply_kernel (fused_dedup_apply),
// elasticdl_tpu/ops/sparse_embedding.py:491, with the dedup prologue of
// elasticdl_tpu/parallel/packed.py:292 (dedup_representatives)
//
// The one-pass sparse optimizer update.  The wrapper stable-sorts the
// raw ids, so each row's occurrences form one segment in position order
// (ids outside [0, vocab_padded) sort to the ends and are skipped here).
// That sort stands in for JAX's scatter-max / scatter-add prologue.
//
// What bounds it: per touched row the table and slot rows are read and
// written in place (64 B rows in random order, two 32-byte sectors of
// DeepFM's 9 lanes each), per id a random grad row: sector traffic and
// its latency.  So a segment's loads are issued a chunk at a time, in
// flight together, never one occurrence (three dependent loads) at a
// time.
//
// A group of `width` = min(dim, 32) lanes of one warp (32 / width groups
// a warp) owns sorted position i, one column per lane (columns past 32
// looped); it works only if i starts the segment of a real row:
//   1. the ids at i - 1, i, i + 1 and the position perm[i] are loaded
//      together (every lane of the group reads the same addresses);
//      then the operand rows (the table's and the slots', per-row Adam's
//      t among them) beside the grad at perm[i], before any sum, so a
//      segment of one (most of them) costs two dependent round trips;
//   2. a longer segment goes on kChunk sorted positions at a time: the
//      chunk's ids and positions together, then the grads of the row's
//      entries in it together, each lane its own column, added IN
//      POSITION ORDER onto 0.0f + the first grad (the order of the JAX
//      scatter-add onto the representative).  A 64-long segment takes 8
//      chunks of 2 round trips, not 63 steps of 3;
//   3. "any lane != 0" by a ballot over the group (the touched rule:
//      rows whose sum is exactly zero keep their slots), then the
//      optimizer math on the row in place, in delta form: every operand
//      becomes old + fl(new - old).
// Each touched row belongs to exactly one segment, so no two groups
// write the same row and no atomics touch the table or the slots.  A
// group that starts no segment returns at once; the sums hold no warp
// operation, so a lane's columns past dim skip theirs freely, and the
// group's own lanes are the only ones its ballot and shuffle wait on.
//
// Rounding: every product, sum and quotient is an explicit _rn
// intrinsic, so nvcc cannot contract a*b + c into an FMA; constants
// arrive from the host already rounded to f32 as JAX rounds its weakly
// typed hyperparameters (1 - b1 formed in double).  sqrt and division
// are IEEE-rounded.  Pad lanes (>= dim) are not written: their grads are
// zero, and the JAX kernel's write there adds a zero delta to a zero.
// ---------------------------------------------------------------------

enum Kind { kSgd = 0, kMomentum = 1, kAdagrad = 2, kAdam = 3, kAdamGlobal = 4 };

struct ApplyConsts {
  float lr_neg, mu, eps, b1, b2, omb1, omb2;
  int nesterov;
};

constexpr int kChunk = 8;

// The sum of column `col` (< dim) of the grads over the segment of `row`
// that starts at sorted position i (batch position p), in position order
// from 0.0f.  Past i (`tail`: it goes on) the segment is read kChunk
// sorted positions at a time: the chunk's ids and positions together,
// then the grads of the row's entries in it together, then their adds.
// Positions fit an int (the launcher checks n).
__device__ __forceinline__ float column_sum(const int* __restrict__ sorted_ids,
                                            const long long* __restrict__ perm,
                                            const float* __restrict__ grads,
                                            long long i, long long p, bool tail,
                                            long long n, int row, int dim,
                                            int col) {
  float acc = __fadd_rn(0.0f, __ldg(grads + p * dim + col));
  for (long long j0 = i + 1; tail; j0 += kChunk) {
    int id[kChunk];
    int pos[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const long long j = j0 + u;
      id[u] = j < n ? __ldg(sorted_ids + j) : -1;
      pos[u] = j < n ? (int)__ldg(perm + j) : 0;
    }
    float g[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      g[u] = id[u] == row ? __ldg(grads + (long long)pos[u] * dim + col) : 0.0f;
    }
    // The ids are sorted: the row's entries are a prefix of the chunk.
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      if (id[u] == row) acc = __fadd_rn(acc, g[u]);
    }
    tail = id[kChunk - 1] == row;
  }
  return acc;
}

// The operands of one lane of a row: the table's, then the slots'.
struct Lane {
  float w, o1, o2, o3;
};

__device__ __forceinline__ Lane load_lane(int kind, long long x,
                                          const float* table, const float* s1,
                                          const float* s2, const float* s3) {
  Lane l{table[x], 0.0f, 0.0f, 0.0f};
  if (kind != kSgd) l.o1 = s1[x];
  if (kind == kAdam || kind == kAdamGlobal) l.o2 = s2[x];
  if (kind == kAdam) l.o3 = s3[x];
  return l;
}

__device__ __forceinline__ void apply_lane(int kind, const ApplyConsts& c,
                                           float g, long long x, Lane l,
                                           float bc1, float bc2, float* table,
                                           float* s1, float* s2, float* s3) {
  switch (kind) {
    case kSgd:
      table[x] = __fadd_rn(l.w, __fmul_rn(c.lr_neg, g));
      break;
    case kMomentum: {
      const float v = l.o1;
      const float v_new = __fadd_rn(__fmul_rn(c.mu, v), g);
      const float step =
          c.nesterov ? __fadd_rn(__fmul_rn(c.mu, v_new), g) : v_new;
      table[x] = __fadd_rn(l.w, __fmul_rn(c.lr_neg, step));
      s1[x] = __fadd_rn(v, __fsub_rn(v_new, v));
      break;
    }
    case kAdagrad: {
      const float acc = l.o1;
      const float gg = __fmul_rn(g, g);
      const float new_acc = __fadd_rn(acc, gg);
      const float update = __fdiv_rn(__fmul_rn(c.lr_neg, g),
                                     __fadd_rn(__fsqrt_rn(new_acc), c.eps));
      table[x] = __fadd_rn(l.w, update);
      s1[x] = __fadd_rn(acc, gg);
      break;
    }
    default: {  // kAdam, kAdamGlobal
      const float m = l.o1;
      const float v = l.o2;
      const float m_new = __fadd_rn(__fmul_rn(c.b1, m), __fmul_rn(c.omb1, g));
      const float v_new = __fadd_rn(__fmul_rn(c.b2, v),
                                    __fmul_rn(__fmul_rn(c.omb2, g), g));
      const float m_hat = __fdiv_rn(m_new, bc1);
      const float v_hat = __fdiv_rn(v_new, bc2);
      const float update = __fdiv_rn(__fmul_rn(c.lr_neg, m_hat),
                                     __fadd_rn(__fsqrt_rn(v_hat), c.eps));
      table[x] = __fadd_rn(l.w, update);
      s1[x] = __fadd_rn(m, __fsub_rn(m_new, m));
      s2[x] = __fadd_rn(v, __fsub_rn(v_new, v));
      if (kind == kAdam) s3[x] = __fadd_rn(l.o3, 1.0f);
      break;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
dedup_apply_kernel(const int* __restrict__ sorted_ids,
                   const long long* __restrict__ perm,
                   const float* __restrict__ grads, long long n,
                   int vocab_padded, int dim_padded, int dim, int kind,
                   float* table, float* s1, float* s2, float* s3,
                   const float* tr_global, ApplyConsts c) {
  const int width = dim < 32 ? dim : 32;
  const int groups = 32 / width;  // groups per warp
  const int lane = threadIdx.x & 31;
  const int q = lane / width;
  const int sub = lane - q * width;
  if (q >= groups) return;  // a warp's lanes past its last group
  const long long i = ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * groups + q;
  if (i >= n) return;
  // Every test below gives one answer for all lanes of the group.
  const int row = __ldg(sorted_ids + i);
  const int prev = i > 0 ? __ldg(sorted_ids + i - 1) : -1;
  const int next = i + 1 < n ? __ldg(sorted_ids + i + 1) : -1;
  const long long p = __ldg(perm + i);
  if (row < 0 || row >= vocab_padded || prev == row) return;

  const unsigned gmask =
      width == 32 ? 0xffffffffu : ((1u << width) - 1u) << (q * width);
  const long long base = (long long)row * dim_padded;
  const bool tail = next == row;  // the segment goes on past i
  const Lane first_lane = load_lane(kind, base + sub, table, s1, s2, s3);
  const float g_first = column_sum(sorted_ids, perm, grads, i, p, tail, n, row, dim, sub);
  bool nonzero = g_first != 0.0f;
  for (int col = width + sub; col < dim && !nonzero; col += width) {
    nonzero = column_sum(sorted_ids, perm, grads, i, p, tail, n, row, dim, col) != 0.0f;
  }
  // Adam's step count from lane 0's t, taken before any lane writes the
  // row: tr = max(t + 1, 1) per row, or the host's t_global.
  float tr = 0.0f;
  if (kind == kAdam) {
    tr = fmaxf(__fadd_rn(__shfl_sync(gmask, first_lane.o3, q * width), 1.0f), 1.0f);
  } else if (kind == kAdamGlobal) {
    tr = *tr_global;
  }
  if (__ballot_sync(gmask, nonzero) == 0u) return;

  float bc1 = 1.0f, bc2 = 1.0f;
  if (kind == kAdam || kind == kAdamGlobal) {
    bc1 = __fsub_rn(1.0f, powf(c.b1, tr));
    bc2 = __fsub_rn(1.0f, powf(c.b2, tr));
  }
  apply_lane(kind, c, g_first, base + sub, first_lane, bc1, bc2, table, s1, s2, s3);
  for (int col = width + sub; col < dim; col += width) {
    // The same chunks in the same order: the same bits as above.
    const float g = column_sum(sorted_ids, perm, grads, i, p, tail, n, row, dim, col);
    const Lane l = load_lane(kind, base + col, table, s1, s2, s3);
    apply_lane(kind, c, g, base + col, l, bc1, bc2, table, s1, s2, s3);
  }
}

}  // namespace

extern "C" {

int edl_fused_lookup(const float* table, const int* ids, float* out,
                     long long n, long long start, int rows_per_block,
                     int num_blocks, int dim_padded, int dim, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (dim <= 0 || dim > dim_padded) return (int)cudaErrorInvalidValue;
  // The widest unit that divides the row and that both pointers' alignment
  // allows (a row offset is a multiple of dim_padded, an output row's of
  // dim).
  const uintptr_t addresses = (uintptr_t)table | (uintptr_t)out;
  int v = 4;
  while (v > 1 && (dim % v != 0 || dim_padded % v != 0 || addresses % (4 * v) != 0)) v /= 2;
  const long long w = dim / v;
  long long tile = kLookupUnits / w;
  const long long spread = (n + kLookupMinBlocks - 1) / kLookupMinBlocks;
  tile = tile < spread ? tile : spread;
  tile = tile < 1 ? 1 : tile;
  const long long blocks = (n + tile - 1) / tile;
  if (blocks > 0x7fffffffLL || tile * w > 0x7fffffffLL) {
    return (int)cudaErrorInvalidConfiguration;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const unsigned int grid = (unsigned int)blocks;
  if (v == 4) {
    lookup_kernel<4><<<grid, kThreads, 0, s>>>(table, ids, out, n, start, rows_per_block,
                                               num_blocks, dim_padded, dim, (int)tile);
  } else if (v == 2) {
    lookup_kernel<2><<<grid, kThreads, 0, s>>>(table, ids, out, n, start, rows_per_block,
                                               num_blocks, dim_padded, dim, (int)tile);
  } else {
    lookup_kernel<1><<<grid, kThreads, 0, s>>>(table, ids, out, n, start, rows_per_block,
                                               num_blocks, dim_padded, dim, (int)tile);
  }
  return (int)cudaGetLastError();
}

int edl_fused_lookup_fm(const float* table, const float* bet, const int* ids,
                        const uint8_t* valid, float* acts, float* first,
                        float* sum_v, float* sum_sq, int batch, int fields,
                        int rows_per_block, int num_blocks, int dim_padded,
                        int dim, void* stream) {
  if (batch <= 0 || fields <= 0) return (int)cudaGetLastError();
  // As many rows a tile as fit 48 KB of shared memory, up to kFmRows and
  // down to what gives kFmMinBlocks blocks; a single row that needs more
  // shared memory asks for the opt-in size.
  constexpr long long kDefaultSmem = 48 * 1024;
  constexpr long long kMaxSmem = 227 * 1024;
  // Per id: its row offset (8 B), its flag as f32 (4 B), its acts.
  const long long per_row = (long long)fields * (8 + 4 + 4LL * dim);
  long long tile = kDefaultSmem / per_row;
  tile = tile < kFmRows ? tile : kFmRows;
  tile = tile < batch / kFmMinBlocks ? tile : batch / kFmMinBlocks;
  const int tile_rows = tile < 1 ? 1 : (int)tile;
  const long long smem = per_row * tile_rows;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        lookup_fm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned int blocks = (unsigned int)((batch + tile_rows - 1) / tile_rows);
  lookup_fm_kernel<<<blocks, kThreads, (size_t)smem, (cudaStream_t)stream>>>(
      table, bet, ids, valid, acts, first, sum_v, sum_sq, batch, fields,
      rows_per_block, num_blocks, dim_padded, dim, tile_rows);
  return (int)cudaGetLastError();
}

int edl_fused_dedup_apply(const int* sorted_ids, const long long* perm,
                          const float* grads, long long n, int vocab_padded,
                          int dim_padded, int dim, int kind, float* table,
                          float* s1, float* s2, float* s3,
                          const float* tr_global, float lr_neg, float mu,
                          int nesterov, float eps, float b1, float b2,
                          float omb1, float omb2, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  // Positions are kept as int: n must fit one.
  if (n > 0x7fffffffLL || dim <= 0) return (int)cudaErrorInvalidValue;
  const int width = dim < 32 ? dim : 32;
  const int groups = 32 / width;
  const long long blocks = (n + (long long)groups * kWarps - 1) / ((long long)groups * kWarps);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const ApplyConsts c{lr_neg, mu, eps, b1, b2, omb1, omb2, nesterov};
  dedup_apply_kernel<<<(unsigned int)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      sorted_ids, perm, grads, n, vocab_padded, dim_padded, dim, kind, table,
      s1, s2, s3, tr_global, c);
  return (int)cudaGetLastError();
}

const char* edl_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
