// Native host-side F0 extractor (NCCF pitch tracker).
//
// Role parity with the reference's C++ feature extractors (pyworld DIO /
// praat-parselmouth, the reference's ddsp/vocoder.py:62-86): a fast host
// pitch tracker for the preprocessing pipeline, where per-file extraction is
// CPU-bound and embarrassingly parallel. Same frame contract as the JAX
// extractor: n_frames = floor(T / hop) + 1, frame n centered at round(n*hop),
// f0 = 0 for unvoiced frames.
//
// Algorithm: normalized cross-correlation (NCCF, RAPT-family) over the lag
// range [sr/fmax, sr/fmin] on mean-removed centered windows, with a
// Praat-style octave cost favoring shorter lags, parabolic lag refinement,
// and a dual voicing decision (correlation > 0.6 and non-silent energy).
//
// The PyTorch port's copy of the JAX package's library, built at first use
// by ddsp_svc_tpu_torch/native/__init__.py (g++ -O3 -march=native
// -ffast-math -fPIC -shared -std=c++17) and bound with ctypes there.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>

extern "C" {

// Returns the number of frames written (== n_frames) or -1 on error.
int64_t extract_f0_nccf(
    const float* audio, int64_t n_samples, double sample_rate, double hop,
    double f0_min, double f0_max, int win, float* out, int64_t n_frames) {
  if (n_samples <= 0 || n_frames <= 0 || win <= 8) return -1;
  const int lag_min = std::max(2, (int)std::floor(sample_rate / f0_max));
  const int lag_max =
      std::min(win - 2, (int)std::ceil(sample_rate / f0_min));
  if (lag_max <= lag_min) return -1;

  const int half = win / 2;
  // padded copy: [half zeros][audio][half+win zeros]
  std::vector<float> x((size_t)n_samples + win + half + 1, 0.0f);
  std::memcpy(x.data() + half, audio, sizeof(float) * (size_t)n_samples);

  std::vector<double> frame(win);
  std::vector<double> score(lag_max + 1);

  for (int64_t f = 0; f < n_frames; ++f) {
    const int64_t pos = (int64_t)std::llround((double)f * hop);
    const float* seg = x.data() + pos;

    // mean removal
    double mean = 0.0;
    for (int i = 0; i < win; ++i) mean += seg[i];
    mean /= win;
    for (int i = 0; i < win; ++i) frame[i] = seg[i] - mean;

    // energy of the fixed query segment [0, win - lag_max)
    const int m = win - lag_max;
    double e0 = 0.0;
    for (int i = 0; i < m; ++i) e0 += frame[i] * frame[i];
    const double energy = e0 / std::max(m, 1);
    if (energy < 1e-9) {  // silent frame
      out[f] = 0.0f;
      continue;
    }

    // running energy of the shifted segment [lag, lag + m)
    double e1 = 0.0;
    for (int i = lag_min; i < lag_min + m; ++i) e1 += frame[i] * frame[i];

    int best_lag = lag_min;
    double best_score = -1e30;
    for (int lag = lag_min; lag <= lag_max; ++lag) {
      double dot = 0.0;
      const double* a = frame.data();
      const double* b = frame.data() + lag;
      for (int i = 0; i < m; ++i) dot += a[i] * b[i];
      const double r = dot / std::sqrt(e0 * e1 + 1e-12);
      score[lag] = r;
      const double s = r - 0.01 * std::log2((double)lag);
      if (s > best_score) {
        best_score = s;
        best_lag = lag;
      }
      // slide e1 to the next lag
      if (lag < lag_max) {
        e1 += (double)frame[lag + m] * frame[lag + m] -
              (double)frame[lag] * frame[lag];
      }
    }

    const double peak = score[best_lag];
    double lag_refined = best_lag;
    if (best_lag > lag_min && best_lag < lag_max) {
      const double p0 = score[best_lag - 1];
      const double p1 = score[best_lag];
      const double p2 = score[best_lag + 1];
      const double denom = p0 - 2.0 * p1 + p2;
      if (std::fabs(denom) > 1e-12) {
        double delta = 0.5 * (p0 - p2) / denom;
        delta = std::max(-0.5, std::min(0.5, delta));
        lag_refined = best_lag + delta;
      }
    }
    const double f0 = sample_rate / std::max(lag_refined, 1.0);
    const bool voiced = peak > 0.6 && f0 >= f0_min && f0 <= f0_max;
    out[f] = voiced ? (float)f0 : 0.0f;
  }
  return n_frames;
}

// Frame-RMS volume (host fast path; parity with vocoder.py:116-137).
int64_t extract_volume(
    const float* audio, int64_t n_samples, double hop, float* out,
    int64_t n_frames) {
  if (n_samples <= 0 || n_frames <= 0) return -1;
  const int64_t pad_l = (int64_t)(hop / 2.0);
  const int64_t pad_r = (int64_t)((hop + 1.0) / 2.0);
  const int64_t total = n_samples + pad_l + pad_r;
  std::vector<double> cs((size_t)total + 1, 0.0);
  // reflect padding
  auto sample = [&](int64_t i) -> double {
    int64_t j = i - pad_l;
    if (j < 0) j = -j;
    if (j >= n_samples) j = 2 * (n_samples - 1) - j;
    j = std::max<int64_t>(0, std::min<int64_t>(n_samples - 1, j));
    return audio[j];
  };
  for (int64_t i = 0; i < total; ++i) {
    const double v = sample(i);
    cs[i + 1] = cs[i] + v * v;
  }
  for (int64_t f = 0; f < n_frames; ++f) {
    const int64_t s = (int64_t)((double)f * hop);
    int64_t e = (int64_t)((double)(f + 1) * hop);
    e = std::min(e, total);
    const int64_t cnt = std::max<int64_t>(e - s, 1);
    out[f] = (float)std::sqrt((cs[e] - cs[s]) / cnt);
  }
  return n_frames;
}

}  // extern "C"
