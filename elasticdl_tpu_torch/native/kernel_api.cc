// Host-side optimizer kernels: dense and sparse (indexed-rows) apply.
// elasticdl_tpu_torch's own copy of the JAX package's kernel_api.cc: the
// same code, built with the same flags, so both libraries give the same
// bits.
//
// Parity: the reference's cgo/C++ kernels
// (elasticdl/pkg/kernel/capi/kernel_api.cc — Eigen-backed
// SGD/Adam/Momentum/AdaGrad plus their *SparseApply variants used by the
// Go parameter server on pushed IndexedSlices).  On TPU the production
// update path is XLA-compiled (parallel/sparse_optim.py); this library is
// the native mirror of that math for host-side application (CPU-resident
// tables, feature pipelines) and for cross-implementation parity tests —
// both suites check against the same golden values.
//
// Sparse semantics match sparse_optim.py exactly: duplicate ids within one
// apply are segment-summed first, then each unique row is updated once.
// Zero-gradient rows (padding) are skipped entirely.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 kernel_api.cc -o libedl_kernels.so
// (see elasticdl_tpu_torch/native/__init__.py::build_kernels).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Dense kernels.
// ---------------------------------------------------------------------------

void edl_sgd_dense(float* param, const float* grad, float lr, int64_t n) {
  for (int64_t i = 0; i < n; ++i) param[i] -= lr * grad[i];
}

void edl_momentum_dense(float* param, float* velocity, const float* grad,
                        float lr, float mu, int nesterov, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    velocity[i] = mu * velocity[i] + grad[i];
    const float step = nesterov ? mu * velocity[i] + grad[i] : velocity[i];
    param[i] -= lr * step;
  }
}

void edl_adagrad_dense(float* param, float* accum, const float* grad,
                       float lr, float eps, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    accum[i] += grad[i] * grad[i];
    param[i] -= lr * grad[i] / (std::sqrt(accum[i]) + eps);
  }
}

void edl_adam_dense(float* param, float* m, float* v, const float* grad,
                    float lr, float beta1, float beta2, float eps,
                    int64_t step, int64_t n) {
  const float bc1 = 1.0f - std::pow(beta1, static_cast<float>(step));
  const float bc2 = 1.0f - std::pow(beta2, static_cast<float>(step));
  for (int64_t i = 0; i < n; ++i) {
    m[i] = beta1 * m[i] + (1.0f - beta1) * grad[i];
    v[i] = beta2 * v[i] + (1.0f - beta2) * grad[i] * grad[i];
    param[i] -= lr * (m[i] / bc1) / (std::sqrt(v[i] / bc2) + eps);
  }
}

// ---------------------------------------------------------------------------
// Sparse (indexed-rows) kernels.  grads is [n_ids, dim] row-major.
// ---------------------------------------------------------------------------

namespace {

// Segment-sum duplicate ids; returns unique ids (first-seen order) and the
// summed gradient rows.  Rows whose summed gradient is entirely zero are
// dropped (padding must not touch slots).
void dedup(const int64_t* ids, const float* grads, int64_t n_ids,
           int64_t dim, std::vector<int64_t>* out_ids,
           std::vector<float>* out_grads) {
  std::unordered_map<int64_t, int64_t> slot;  // id -> index in out
  slot.reserve(static_cast<size_t>(n_ids) * 2);
  for (int64_t i = 0; i < n_ids; ++i) {
    auto it = slot.find(ids[i]);
    int64_t row;
    if (it == slot.end()) {
      row = static_cast<int64_t>(out_ids->size());
      slot.emplace(ids[i], row);
      out_ids->push_back(ids[i]);
      out_grads->insert(out_grads->end(), dim, 0.0f);
    } else {
      row = it->second;
    }
    float* acc = out_grads->data() + row * dim;
    const float* g = grads + i * dim;
    for (int64_t d = 0; d < dim; ++d) acc[d] += g[d];
  }
}

bool all_zero(const float* g, int64_t dim) {
  for (int64_t d = 0; d < dim; ++d)
    if (g[d] != 0.0f) return false;
  return true;
}

}  // namespace

void edl_sgd_sparse(float* table, int64_t dim, const int64_t* ids,
                    const float* grads, int64_t n_ids, float lr) {
  std::vector<int64_t> uids;
  std::vector<float> ugrads;
  dedup(ids, grads, n_ids, dim, &uids, &ugrads);
  for (size_t r = 0; r < uids.size(); ++r) {
    float* row = table + uids[r] * dim;
    const float* g = ugrads.data() + r * dim;
    for (int64_t d = 0; d < dim; ++d) row[d] -= lr * g[d];
  }
}

void edl_momentum_sparse(float* table, float* velocity, int64_t dim,
                         const int64_t* ids, const float* grads,
                         int64_t n_ids, float lr, float mu, int nesterov) {
  std::vector<int64_t> uids;
  std::vector<float> ugrads;
  dedup(ids, grads, n_ids, dim, &uids, &ugrads);
  for (size_t r = 0; r < uids.size(); ++r) {
    const float* g = ugrads.data() + r * dim;
    if (all_zero(g, dim)) continue;
    float* row = table + uids[r] * dim;
    float* vel = velocity + uids[r] * dim;
    for (int64_t d = 0; d < dim; ++d) {
      vel[d] = mu * vel[d] + g[d];
      const float step = nesterov ? mu * vel[d] + g[d] : vel[d];
      row[d] -= lr * step;
    }
  }
}

void edl_adagrad_sparse(float* table, float* accum, int64_t dim,
                        const int64_t* ids, const float* grads,
                        int64_t n_ids, float lr, float eps) {
  std::vector<int64_t> uids;
  std::vector<float> ugrads;
  dedup(ids, grads, n_ids, dim, &uids, &ugrads);
  for (size_t r = 0; r < uids.size(); ++r) {
    const float* g = ugrads.data() + r * dim;
    float* row = table + uids[r] * dim;
    float* acc = accum + uids[r] * dim;
    for (int64_t d = 0; d < dim; ++d) {
      acc[d] += g[d] * g[d];
      row[d] -= lr * g[d] / (std::sqrt(acc[d]) + eps);
    }
  }
}

void edl_adam_sparse(float* table, float* m, float* v, int64_t* t_rows,
                     int64_t dim, const int64_t* ids, const float* grads,
                     int64_t n_ids, float lr, float beta1, float beta2,
                     float eps) {
  std::vector<int64_t> uids;
  std::vector<float> ugrads;
  dedup(ids, grads, n_ids, dim, &uids, &ugrads);
  for (size_t r = 0; r < uids.size(); ++r) {
    const float* g = ugrads.data() + r * dim;
    if (all_zero(g, dim)) continue;
    const int64_t id = uids[r];
    t_rows[id] += 1;
    const float t = static_cast<float>(t_rows[id]);
    const float bc1 = 1.0f - std::pow(beta1, t);
    const float bc2 = 1.0f - std::pow(beta2, t);
    float* row = table + id * dim;
    float* mr = m + id * dim;
    float* vr = v + id * dim;
    for (int64_t d = 0; d < dim; ++d) {
      mr[d] = beta1 * mr[d] + (1.0f - beta1) * g[d];
      vr[d] = beta2 * vr[d] + (1.0f - beta2) * g[d] * g[d];
      row[d] -= lr * (mr[d] / bc1) / (std::sqrt(vr[d] / bc2) + eps);
    }
  }
}

}  // extern "C"
