// Native host-side data engine for the window pipeline: the port's own
// copy of the JAX package's engine, the same C ABI and arithmetic.
//
// Multithreaded strided window gathering and per-entity standardization
// that write straight into preallocated buffers, with no index-matrix
// temporaries; each window is one memcpy.  Exposed through a C ABI for
// ctypes (native/__init__.py builds it with g++ into build/native/ at the
// root of the checkout).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline int worker_count(int64_t work_items) {
  unsigned hc = std::thread::hardware_concurrency();
  if (hc == 0) hc = 1;
  int64_t max_useful = std::max<int64_t>(1, work_items / 64);
  return static_cast<int>(std::min<int64_t>(hc, max_useful));
}

template <typename Fn>
void parallel_for(int64_t n, Fn&& fn) {
  int workers = worker_count(n);
  if (workers <= 1) {
    for (int64_t i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int64_t> next(0);
  std::vector<std::thread> threads;
  threads.reserve(workers);
  for (int w = 0; w < workers; ++w) {
    threads.emplace_back([&]() {
      for (;;) {
        int64_t i = next.fetch_add(1, std::memory_order_relaxed);
        if (i >= n) return;
        fn(i);
      }
    });
  }
  for (auto& t : threads) t.join();
}

}  // namespace

extern "C" {

// Gather n_windows contiguous [start, start+time_steps) row-blocks of a
// row-major (rows, cols) float32 matrix into out (n_windows, time_steps,
// cols).  Rows of one window are contiguous, so each window is a single
// memcpy of time_steps*cols floats.
void fgp_gather_windows(const float* values, int64_t rows, int64_t cols,
                        const int64_t* starts, int64_t n_windows,
                        int64_t time_steps, float* out) {
  const int64_t window_floats = time_steps * cols;
  parallel_for(n_windows, [&](int64_t i) {
    const float* src = values + starts[i] * cols;
    std::memcpy(out + i * window_floats, src,
                sizeof(float) * static_cast<size_t>(window_floats));
  });
}

// Per-entity z-score: for each entity run [offsets[e], offsets[e+1]) of a
// row-major (rows, cols) matrix, compute column means/stds over the run
// and standardize in place (ddof=0, sklearn StandardScaler semantics).
// means/stds are written out per entity: (n_entities, cols).
void fgp_standardize_per_entity(float* values, int64_t rows, int64_t cols,
                                const int64_t* offsets, int64_t n_entities,
                                float* means_out, float* stds_out) {
  parallel_for(n_entities, [&](int64_t e) {
    const int64_t lo = offsets[e], hi = offsets[e + 1];
    const int64_t n = hi - lo;
    if (n <= 0) return;
    std::vector<double> mean(cols, 0.0), m2(cols, 0.0);
    for (int64_t r = lo; r < hi; ++r) {
      const float* row = values + r * cols;
      for (int64_t c = 0; c < cols; ++c) mean[c] += row[c];
    }
    for (int64_t c = 0; c < cols; ++c) mean[c] /= static_cast<double>(n);
    for (int64_t r = lo; r < hi; ++r) {
      const float* row = values + r * cols;
      for (int64_t c = 0; c < cols; ++c) {
        const double d = row[c] - mean[c];
        m2[c] += d * d;
      }
    }
    for (int64_t c = 0; c < cols; ++c) {
      double sd = std::sqrt(m2[c] / static_cast<double>(n));
      if (sd == 0.0) sd = 1.0;  // sklearn: zero-variance columns unscaled
      means_out[e * cols + c] = static_cast<float>(mean[c]);
      stds_out[e * cols + c] = static_cast<float>(sd);
    }
    for (int64_t r = lo; r < hi; ++r) {
      float* row = values + r * cols;
      for (int64_t c = 0; c < cols; ++c) {
        row[c] = static_cast<float>(
            (row[c] - means_out[e * cols + c]) / stds_out[e * cols + c]);
      }
    }
  });
}

// Enumerate valid window start indices per entity: for each entity run
// [offsets[e], offsets[e+1]) with length >= time_steps, starts are
// offsets[e] .. offsets[e+1]-time_steps.  Returns the count written.
int64_t fgp_valid_window_starts(const int64_t* offsets, int64_t n_entities,
                                int64_t time_steps, int64_t* starts_out) {
  int64_t k = 0;
  for (int64_t e = 0; e < n_entities; ++e) {
    const int64_t lo = offsets[e], hi = offsets[e + 1];
    if (hi - lo >= time_steps) {
      for (int64_t s = lo; s <= hi - time_steps; ++s) starts_out[k++] = s;
    }
  }
  return k;
}

}  // extern "C"
