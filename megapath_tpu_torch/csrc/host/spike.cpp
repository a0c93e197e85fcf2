// Streaming length-weighted moments fold for the SPIKE filter.
//
// The port's copy of megapath_tpu/native/spike.cpp, built by
// megapath_tpu_torch/native.py. Byte-faithful port of the update order in
// the reference genomeCovFilter.cpp:61-75 (same double-precision
// expression shapes as the plain loop beside it in
// megapath_tpu_torch/filters/spike.py: left-to-right products, division
// last), run natively because the fold is a sequential recurrence over
// ~100k depth runs that numpy cannot vectorize without changing float
// rounding.

#include <cstdint>

extern "C" void spike_moments(
    const int32_t* seq,
    const int64_t* len,
    const int64_t* depth,
    int64_t n,
    double* mean,
    double* diff_power,
    double* count) {
  for (int64_t i = 0; i < n; i++) {
    int32_t s = seq[i];
    double ln = (double)len[i];
    double d = (double)depth[i];
    double avg_diff = d - mean[s];
    double new_mean = mean[s] + avg_diff * ln / (count[s] + ln);
    diff_power[s] += avg_diff * avg_diff * ln * count[s] / (count[s] + ln);
    count[s] += ln;
    mean[s] = new_mean;
  }
}
