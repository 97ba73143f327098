// Host event-stream engine of benerf_tpu_torch (the port's copy of the JAX
// package's csrc/events.cpp), bound by ctypes in data/_native.py and built
// there with the host C++ compiler at first use:
//   - accumulate_events: deterministic polarity scatter-add (reference
//     utils/event_utils.py:261-265);
//   - time_window: the index range of a time window over a sorted stream
//     (event_utils.py:104-162);
//   - prepare_events: one-pass ingest (time crop, normalise, flatten, stable
//     time sort) feeding data/events.py prepare_raw.
//
// Host preprocessing for ingesting large raw streams; the train step never
// calls it (its ETA scatter runs on the card, data/events.py).

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

// out[y*width + x] += pol, sequential (deterministic).
void accumulate_events(double* out, const int32_t* x, const int32_t* y,
                       const float* pol, int64_t n, int32_t width) {
  for (int64_t i = 0; i < n; ++i) {
    out[static_cast<int64_t>(y[i]) * width + x[i]] += pol[i];
  }
}

// searchsorted over a sorted time array: [lo, hi) covering t0 <= ts <= t1
// (inclusive ends, matching model/nerf.py:170-172 mask semantics).
void time_window(const float* ts, int64_t n, float t0, float t1, int64_t* lo,
                 int64_t* hi) {
  *lo = std::lower_bound(ts, ts + n, t0) - ts;
  *hi = std::upper_bound(ts, ts + n, t1) - ts;
}

// One-pass ingest: filter to [t_lo, t_hi], normalize time to [0,1] over that
// range, flatten pixels, stable-sort by raw timestamp. Two-phase API: call
// with pix_out == nullptr to get the kept-count, then again with buffers.
// Returns number of kept events.
int64_t prepare_events(const double* x, const double* y, const double* t,
                       const double* p, int64_t n, int32_t width, double t_lo,
                       double t_hi, int32_t* pix_out, float* ts_out,
                       float* pol_out) {
  std::vector<int64_t> keep;
  keep.reserve(n);
  for (int64_t i = 0; i < n; ++i) {
    if (t[i] >= t_lo && t[i] <= t_hi) keep.push_back(i);
  }
  if (pix_out == nullptr) return static_cast<int64_t>(keep.size());

  std::stable_sort(keep.begin(), keep.end(),
                   [&](int64_t a, int64_t b) { return t[a] < t[b]; });
  const double span = (t_hi > t_lo) ? (t_hi - t_lo) : 1.0;
  for (size_t j = 0; j < keep.size(); ++j) {
    int64_t i = keep[j];
    pix_out[j] = static_cast<int32_t>(y[i]) * width + static_cast<int32_t>(x[i]);
    ts_out[j] = static_cast<float>((t[i] - t_lo) / span);
    pol_out[j] = static_cast<float>(p[i]);
  }
  return static_cast<int64_t>(keep.size());
}

}  // extern "C"
