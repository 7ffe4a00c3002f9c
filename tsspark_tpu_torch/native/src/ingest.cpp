// Native ingest/pivot engine for tsspark_tpu_torch (a copy of the JAX
// package's ingest engine, the same C ABI and the same results).
//
// The reference offloads its runtime hot paths (data movement around the
// fit) to the JVM/native layer; here the two host-side hot paths are:
//
//   1. bulk pivot ("collect"): scatter tens of millions of long-format rows
//      into a padded (B, T) batch before device transfer — threaded scatter
//      with last-write-wins per (row, col).
//   2. streaming history store: per-series bounded ring of (day, value)
//      observations with sorted dedup-append ("absorb") and padded
//      materialization, replacing the pandas concat/dedup/sort per
//      micro-batch in the streaming driver.
//
// Exposed as a C ABI for ctypes (no pybind11 on this image).  All ids are
// pre-factorized int64 codes (string interning stays in Python/pandas,
// which already does it in C).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

constexpr double kNaN = std::numeric_limits<double>::quiet_NaN();

struct Series {
  // Kept sorted by day; bounded to max_history newest observations.
  std::vector<double> days;
  std::vector<double> values;
};

struct Store {
  int64_t max_history;
  std::unordered_map<int64_t, Series> series;
};

struct ParamTable {
  // Fixed-width float64 rows in contiguous storage; id -> row index.
  // Double because the rows carry absolute-time scaling meta (ds_start in
  // epoch days ~2e4): float32 would quantize warm-start time alignment to
  // ~5-minute granularity, a real bias at hourly/minute cadence.
  int64_t row_dim;
  std::unordered_map<int64_t, int64_t> index;
  std::vector<double> rows;
  std::vector<int64_t> ids;  // row index -> id (for export)
};

int hardware_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n == 0 ? 4 : static_cast<int>(n);
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------- bulk pivot

// Scatter n long-format rows into out[b, t] (row-major), NaN-prefilled.
// Rows arrive in order; for duplicate (row, col) pairs the LAST wins, so the
// parallelization partitions by destination row (each row's writes stay on
// one thread, in input order).  Out-of-range indices are skipped (the Python
// layer rejects them; this is defense in depth, not an API).
void bulk_pivot(int64_t n, const int64_t* rows, const int64_t* cols,
                const double* vals, double* out, int64_t b, int64_t t) {
  std::fill(out, out + b * t, kNaN);
  auto in_range = [=](int64_t i) {
    return rows[i] >= 0 && rows[i] < b && cols[i] >= 0 && cols[i] < t;
  };
  int n_threads = std::min<int64_t>(hardware_threads(), std::max<int64_t>(b, 1));
  if (n < (1 << 16) || n_threads <= 1) {
    for (int64_t i = 0; i < n; ++i) {
      if (in_range(i)) out[rows[i] * t + cols[i]] = vals[i];
    }
    return;
  }
  // Bucket row indices per thread in one pass (O(n) total work instead of
  // every thread scanning all n rows); order within a bucket preserves the
  // input order, keeping last-wins semantics per destination row.
  std::vector<int64_t> counts(n_threads, 0);
  for (int64_t i = 0; i < n; ++i) {
    if (in_range(i)) ++counts[rows[i] % n_threads];
  }
  std::vector<int64_t> offsets(n_threads + 1, 0);
  for (int tid = 0; tid < n_threads; ++tid) {
    offsets[tid + 1] = offsets[tid] + counts[tid];
  }
  std::vector<int64_t> bucketed(offsets[n_threads]);
  std::vector<int64_t> cursor(offsets.begin(), offsets.end() - 1);
  for (int64_t i = 0; i < n; ++i) {
    if (in_range(i)) bucketed[cursor[rows[i] % n_threads]++] = i;
  }
  std::vector<std::thread> workers;
  workers.reserve(n_threads);
  for (int tid = 0; tid < n_threads; ++tid) {
    workers.emplace_back([&, tid] {
      for (int64_t k = offsets[tid]; k < offsets[tid + 1]; ++k) {
        int64_t i = bucketed[k];
        out[rows[i] * t + cols[i]] = vals[i];
      }
    });
  }
  for (auto& w : workers) w.join();
}

// ------------------------------------------------------------ history store

void* store_new(int64_t max_history) {
  auto* s = new Store();
  s->max_history = max_history;
  return s;
}

void store_free(void* handle) { delete static_cast<Store*>(handle); }

int64_t store_series_count(void* handle) {
  return static_cast<int64_t>(static_cast<Store*>(handle)->series.size());
}

int64_t store_series_length(void* handle, int64_t sid) {
  auto& m = static_cast<Store*>(handle)->series;
  auto it = m.find(sid);
  return it == m.end() ? 0 : static_cast<int64_t>(it->second.days.size());
}

// Append n observations (sid code, day, value); per series the result stays
// sorted by day with duplicate days resolved last-write-wins, trimmed to the
// newest max_history points.
void store_append(void* handle, int64_t n, const int64_t* sids,
                  const double* days, const double* vals) {
  auto* store = static_cast<Store*>(handle);
  for (int64_t i = 0; i < n; ++i) {
    Series& s = store->series[sids[i]];
    double d = days[i];
    if (!s.days.empty() && d > s.days.back()) {
      s.days.push_back(d);
      s.values.push_back(vals[i]);
    } else {
      auto it = std::lower_bound(s.days.begin(), s.days.end(), d);
      size_t pos = static_cast<size_t>(it - s.days.begin());
      if (it != s.days.end() && *it == d) {
        s.values[pos] = vals[i];  // duplicate day: last wins
      } else {
        s.days.insert(it, d);
        s.values.insert(s.values.begin() + pos, vals[i]);
      }
    }
    if (static_cast<int64_t>(s.days.size()) > store->max_history) {
      size_t drop = s.days.size() - static_cast<size_t>(store->max_history);
      s.days.erase(s.days.begin(), s.days.begin() + drop);
      s.values.erase(s.values.begin(), s.values.begin() + drop);
    }
  }
}

// Union time grid across the requested series, sorted ascending.  Returns
// the grid length; call with grid == nullptr to size the buffer first.
int64_t store_union_grid(void* handle, const int64_t* sids, int64_t b,
                         double* grid) {
  auto* store = static_cast<Store*>(handle);
  std::vector<double> all;
  for (int64_t i = 0; i < b; ++i) {
    auto it = store->series.find(sids[i]);
    if (it == store->series.end()) continue;
    all.insert(all.end(), it->second.days.begin(), it->second.days.end());
  }
  std::sort(all.begin(), all.end());
  all.erase(std::unique(all.begin(), all.end()), all.end());
  if (grid != nullptr) {
    std::memcpy(grid, all.data(), all.size() * sizeof(double));
  }
  return static_cast<int64_t>(all.size());
}

// Materialize the requested series onto a (sorted) grid: out[b, t] gets the
// value at the matching day or NaN.  Threaded over series.
void store_materialize(void* handle, const int64_t* sids, int64_t b,
                       const double* grid, int64_t t, double* out) {
  auto* store = static_cast<Store*>(handle);
  int n_threads = std::min<int64_t>(hardware_threads(), std::max<int64_t>(b, 1));
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      double* row = out + i * t;
      std::fill(row, row + t, kNaN);
      auto it = store->series.find(sids[i]);
      if (it == store->series.end()) continue;
      const Series& s = it->second;
      size_t gi = 0;
      for (size_t k = 0; k < s.days.size(); ++k) {
        const double* pos =
            std::lower_bound(grid + gi, grid + t, s.days[k]);
        if (pos == grid + t) break;
        gi = static_cast<size_t>(pos - grid);
        if (*pos == s.days[k]) row[gi] = s.values[k];
      }
    }
  };
  if (b < 64 || n_threads <= 1) {
    work(0, b);
    return;
  }
  std::vector<std::thread> workers;
  int64_t chunk = (b + n_threads - 1) / n_threads;
  for (int tid = 0; tid < n_threads; ++tid) {
    int64_t lo = tid * chunk, hi = std::min<int64_t>(lo + chunk, b);
    if (lo >= hi) break;
    workers.emplace_back(work, lo, hi);
  }
  for (auto& w : workers) w.join();
}

// ------------------------------------------------------------- param table
//
// The streaming warm-start state (fitted theta + scaling rows keyed by
// series) lives here so a 30k-series micro-batch update/lookup is two
// memcpy-bound bulk calls instead of a Python loop over series.

void* pstore_new(int64_t row_dim) {
  auto* t = new ParamTable();
  t->row_dim = row_dim;
  return t;
}

void pstore_free(void* handle) { delete static_cast<ParamTable*>(handle); }

int64_t pstore_size(void* handle) {
  return static_cast<int64_t>(static_cast<ParamTable*>(handle)->index.size());
}

int64_t pstore_row_dim(void* handle) {
  return static_cast<ParamTable*>(handle)->row_dim;
}

// Upsert n rows (each row_dim doubles).  Last write wins on duplicate ids
// within one call (matching the Python dict semantics it replaces).
void pstore_update(void* handle, int64_t n, const int64_t* ids,
                   const double* data) {
  auto* t = static_cast<ParamTable*>(handle);
  const int64_t d = t->row_dim;
  for (int64_t i = 0; i < n; ++i) {
    auto [it, inserted] =
        t->index.try_emplace(ids[i], static_cast<int64_t>(t->ids.size()));
    if (inserted) {
      t->ids.push_back(ids[i]);
      t->rows.resize(t->rows.size() + d);
    }
    std::memcpy(t->rows.data() + it->second * d, data + i * d,
                d * sizeof(double));
  }
}

// Gather n rows into out (n x row_dim, zero-filled on miss); found[i] gets
// 1/0.  Returns the number found.  Threaded gather for large batches.
int64_t pstore_lookup(void* handle, int64_t n, const int64_t* ids,
                      double* out, uint8_t* found) {
  auto* t = static_cast<ParamTable*>(handle);
  const int64_t d = t->row_dim;
  std::vector<int64_t> row_of(n);
  int64_t n_found = 0;
  for (int64_t i = 0; i < n; ++i) {  // map probes stay single-threaded
    auto it = t->index.find(ids[i]);
    row_of[i] = it == t->index.end() ? -1 : it->second;
    found[i] = row_of[i] >= 0;
    n_found += found[i];
  }
  auto gather = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      double* dst = out + i * d;
      if (row_of[i] < 0) {
        std::fill(dst, dst + d, 0.0);
      } else {
        std::memcpy(dst, t->rows.data() + row_of[i] * d, d * sizeof(double));
      }
    }
  };
  int n_threads = hardware_threads();
  if (n < 4096 || n_threads <= 1) {
    gather(0, n);
  } else {
    std::vector<std::thread> workers;
    int64_t chunk = (n + n_threads - 1) / n_threads;
    for (int tid = 0; tid < n_threads; ++tid) {
      int64_t lo = tid * chunk, hi = std::min<int64_t>(lo + chunk, n);
      if (lo >= hi) break;
      workers.emplace_back(gather, lo, hi);
    }
    for (auto& w : workers) w.join();
  }
  return n_found;
}

// Dump every (id, row) pair; buffers must hold pstore_size rows.
void pstore_export(void* handle, int64_t* ids_out, double* rows_out) {
  auto* t = static_cast<ParamTable*>(handle);
  std::memcpy(ids_out, t->ids.data(), t->ids.size() * sizeof(int64_t));
  std::memcpy(rows_out, t->rows.data(), t->rows.size() * sizeof(double));
}

}  // extern "C"
