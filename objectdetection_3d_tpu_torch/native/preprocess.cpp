// Native host-side point-cloud preprocessing.
//
// The reference's host compute enters through numba-JIT'd native loops
// (reference ops/ops_numba.py:171-308); in this port the voxelization
// itself runs on the card, and the host hot path is the data loader's
// per-cloud preprocessing (reference model/PointPillars.py:241-266):
// 5-sigma outlier rejection, range cropping and feature-column selection.
// This translation unit implements that fused pass in C++ so the
// prefetch threads spend no time under the Python interpreter.
//
// Exposed via a plain C ABI for ctypes, the same as the JAX package's
// native/preprocess.cpp, of which this is the port's own copy.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Stats {
  double sum[3] = {0, 0, 0};
  double norm_sum = 0;
  double norm_sq_sum = 0;
};

inline int64_t clamp_threads(int64_t n) {
  unsigned hw = std::thread::hardware_concurrency();
  int64_t t = hw ? static_cast<int64_t>(hw) : 4;
  if (t > 16) t = 16;
  int64_t by_work = n / 65536;  // don't spawn threads for tiny clouds
  if (by_work < 1) by_work = 1;
  return t < by_work ? t : by_work;
}

}  // namespace

extern "C" {

// Fused preprocess of one cloud.
//
//   points      (n, c) float32 row-major
//   sel_cols    (n_sel,) int64 column indices to keep
//   range_min / range_max   (3,) floats; keep x,y,z in [min, max)
//   sigma_mult  outlier threshold multiplier (reference uses 5.0)
//   out         (max_points, n_sel) float32 output buffer (caller-owned)
//
// Returns the number of points written (<= max_points).  Semantics match
// the numpy path bit-for-bit in structure: a point survives iff its
// distance from the centroid is < mean + sigma_mult * std (population
// std), and its xyz lies inside [range_min, range_max).
int64_t preprocess_cloud(const float* points, int64_t n, int64_t c,
                         const int64_t* sel_cols, int64_t n_sel,
                         const float* range_min, const float* range_max,
                         float sigma_mult, float* out,
                         int64_t max_points) {
  if (n <= 0 || c < 3) return 0;

  const int64_t n_threads = clamp_threads(n);
  std::vector<Stats> partial(n_threads);
  std::vector<std::thread> pool;

  auto chunk_bounds = [&](int64_t t, int64_t* lo, int64_t* hi) {
    int64_t per = (n + n_threads - 1) / n_threads;
    *lo = t * per;
    *hi = (*lo + per < n) ? *lo + per : n;
  };

  // pass 1: centroid
  for (int64_t t = 0; t < n_threads; ++t) {
    pool.emplace_back([&, t]() {
      int64_t lo, hi;
      chunk_bounds(t, &lo, &hi);
      Stats& s = partial[t];
      for (int64_t i = lo; i < hi; ++i) {
        const float* p = points + i * c;
        s.sum[0] += p[0];
        s.sum[1] += p[1];
        s.sum[2] += p[2];
      }
    });
  }
  for (auto& th : pool) th.join();
  pool.clear();

  double mean[3] = {0, 0, 0};
  for (auto& s : partial)
    for (int k = 0; k < 3; ++k) mean[k] += s.sum[k];
  for (int k = 0; k < 3; ++k) mean[k] /= static_cast<double>(n);

  // pass 2: norm statistics
  for (int64_t t = 0; t < n_threads; ++t) {
    pool.emplace_back([&, t]() {
      int64_t lo, hi;
      chunk_bounds(t, &lo, &hi);
      Stats& s = partial[t];
      for (int64_t i = lo; i < hi; ++i) {
        const float* p = points + i * c;
        double dx = p[0] - mean[0];
        double dy = p[1] - mean[1];
        double dz = p[2] - mean[2];
        double nrm = std::sqrt(dx * dx + dy * dy + dz * dz);
        s.norm_sum += nrm;
        s.norm_sq_sum += nrm * nrm;
      }
    });
  }
  for (auto& th : pool) th.join();
  pool.clear();

  double norm_mean = 0, norm_sq = 0;
  for (auto& s : partial) {
    norm_mean += s.norm_sum;
    norm_sq += s.norm_sq_sum;
  }
  norm_mean /= static_cast<double>(n);
  norm_sq /= static_cast<double>(n);
  double var = norm_sq - norm_mean * norm_mean;
  double thr = norm_mean + sigma_mult * std::sqrt(var > 0 ? var : 0);

  // pass 3: filter + select columns (order-preserving, serial write)
  int64_t written = 0;
  for (int64_t i = 0; i < n && written < max_points; ++i) {
    const float* p = points + i * c;
    double dx = p[0] - mean[0];
    double dy = p[1] - mean[1];
    double dz = p[2] - mean[2];
    double nrm = std::sqrt(dx * dx + dy * dy + dz * dz);
    if (nrm >= thr) continue;
    bool in_range = true;
    for (int k = 0; k < 3; ++k) {
      if (!(p[k] >= range_min[k] && p[k] < range_max[k])) {
        in_range = false;
        break;
      }
    }
    if (!in_range) continue;
    float* dst = out + written * n_sel;
    for (int64_t j = 0; j < n_sel; ++j) dst[j] = p[sel_cols[j]];
    ++written;
  }
  return written;
}

}  // extern "C"
