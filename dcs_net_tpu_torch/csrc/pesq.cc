// PESQ (ITU-T P.862 structure) objective speech-quality estimator.
//
// Native (C++) implementation of the perceptual-evaluation pipeline the
// original DCS-Net code consumes through pypesq (its network_functions.py).
// The ITU reference tables are not redistributable and the pypesq wheel is
// not a dependency of this project, so this module implements the published
// P.862 processing structure with analytically-derived psychoacoustic curves:
//
//   1. level alignment to a constant active-speech power (350-3250 Hz band)
//   2. IRS-like receive filtering (piecewise log-frequency gain)
//   3. envelope-based time alignment (FFT cross-correlation of frame energy)
//   4. 32 ms Hann frames, 50% overlap -> power spectra
//   5. Bark-scale integration (49 bands, Zwicker warping), hearing threshold
//      (Terhardt absolute-threshold approximation)
//   6. partial frequency compensation (ref->deg band ratio over active
//      frames) and per-frame gain compensation, both bounded
//   7. Zwicker-law loudness, symmetric + asymmetric disturbance with the
//      P.862 masking deadzone, 12x asymmetry cap, band/frame Lp aggregation
//      (L2-over-bands per frame, L6-over-20-frame intervals, L2 over time)
//   8. MOS = 4.5 - 0.1 * D - 0.0309 * DA, clamped to [-0.5, 4.5]
//
// Output is calibrated to the raw-P.862-MOS range (clean ~4.5; heavy noise
// 1.x) and is monotonic in SNR/distortion; it is NOT bit-exact vs the ITU
// binary (tables differ). See tests/test_pesq.py for the pinned contract.
//
// Build: g++ -O2 -shared -fPIC -o libpesq.so pesq.cc  (no deps)

#include <cmath>
#include <complex>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr double kPi = 3.14159265358979323846;

// ---------------------------------------------------------------- FFT (radix-2)
void fft(std::vector<std::complex<double>>& a, bool invert) {
  const size_t n = a.size();
  for (size_t i = 1, j = 0; i < n; i++) {
    size_t bit = n >> 1;
    for (; j & bit; bit >>= 1) j ^= bit;
    j ^= bit;
    if (i < j) std::swap(a[i], a[j]);
  }
  for (size_t len = 2; len <= n; len <<= 1) {
    double ang = 2 * kPi / double(len) * (invert ? -1 : 1);
    std::complex<double> wlen(std::cos(ang), std::sin(ang));
    for (size_t i = 0; i < n; i += len) {
      std::complex<double> w(1);
      for (size_t j2 = 0; j2 < len / 2; j2++) {
        auto u = a[i + j2], v = a[i + j2 + len / 2] * w;
        a[i + j2] = u + v;
        a[i + j2 + len / 2] = u - v;
        w *= wlen;
      }
    }
  }
  if (invert)
    for (auto& x : a) x /= double(n);
}

size_t next_pow2(size_t n) {
  size_t p = 1;
  while (p < n) p <<= 1;
  return p;
}

// ------------------------------------------------------- psychoacoustic curves
double hz_to_bark(double f) {
  return 13.0 * std::atan(0.00076 * f) + 3.5 * std::atan((f / 7500.0) * (f / 7500.0));
}

// Terhardt absolute threshold of hearing (dB SPL), clamped.
double abs_thresh_db(double f) {
  if (f < 20.0) f = 20.0;
  double fk = f / 1000.0;
  double t = 3.64 * std::pow(fk, -0.8) -
             6.5 * std::exp(-0.6 * (fk - 3.3) * (fk - 3.3)) +
             1e-3 * std::pow(fk, 4.0);
  return t < -10.0 ? -10.0 : (t > 60.0 ? 60.0 : t);
}

// IRS-like receive characteristic: bandpass emphasising 300-3400 Hz.
double irs_gain_db(double f) {
  if (f < 50.0 || f > 7000.0) return -50.0;
  if (f < 300.0) return -25.0 * (300.0 - f) / 250.0;     // rising edge
  if (f <= 3400.0) return 0.0;                            // passband
  return -30.0 * (f - 3400.0) / 3600.0;                   // falling edge
}

struct Frames {
  std::vector<std::vector<double>> power;  // [frame][bin]
  int n_bins = 0;
  double bin_hz = 0;
};

Frames spectra(const std::vector<double>& x, int frame, int shift) {
  Frames out;
  const int nfft = int(next_pow2(frame));
  out.n_bins = nfft / 2 + 1;
  std::vector<double> win(frame);
  for (int i = 0; i < frame; i++)
    win[i] = 0.5 * (1.0 - std::cos(2 * kPi * i / (frame - 1)));
  int n_frames = x.size() >= size_t(frame)
                     ? int((x.size() - frame) / shift) + 1 : 0;
  out.power.resize(n_frames);
  std::vector<std::complex<double>> buf(nfft);
  for (int t = 0; t < n_frames; t++) {
    for (int i = 0; i < nfft; i++)
      buf[i] = (i < frame) ? x[t * shift + i] * win[i] : 0.0;
    fft(buf, false);
    out.power[t].resize(out.n_bins);
    for (int k = 0; k < out.n_bins; k++)
      out.power[t][k] = std::norm(buf[k]) / double(frame);
  }
  return out;
}

// envelope cross-correlation delay (deg relative to ref), in samples
int estimate_delay(const std::vector<double>& ref, const std::vector<double>& deg,
                   int fs) {
  const int frame = fs / 250;  // 4 ms energy frames
  auto envelope = [&](const std::vector<double>& x) {
    std::vector<double> e;
    for (size_t i = 0; i + frame <= x.size(); i += frame) {
      double s = 0;
      for (int j = 0; j < frame; j++) s += x[i + j] * x[i + j];
      e.push_back(std::log1p(s));
    }
    double mean = 0;
    for (double v : e) mean += v;
    mean /= std::max<size_t>(e.size(), 1);
    for (double& v : e) v -= mean;
    return e;
  };
  auto er = envelope(ref), ed = envelope(deg);
  const size_t n = next_pow2(er.size() + ed.size()) * 2;
  std::vector<std::complex<double>> a(n), b(n);
  for (size_t i = 0; i < er.size(); i++) a[i] = er[i];
  for (size_t i = 0; i < ed.size(); i++) b[i] = ed[i];
  fft(a, false);
  fft(b, false);
  for (size_t i = 0; i < n; i++) a[i] *= std::conj(b[i]);
  fft(a, true);
  // lag in [-max_lag, max_lag] (0.5 s)
  int max_lag = int(0.5 * fs) / frame;
  int best = 0;
  double best_v = -1e300;
  for (int lag = -max_lag; lag <= max_lag; lag++) {
    size_t idx = lag >= 0 ? size_t(lag) : n - size_t(-lag);
    if (idx >= n) continue;
    double v = a[idx].real();
    if (v > best_v) { best_v = v; best = lag; }
  }
  return -best * frame;
}

void bandpass_level_align(std::vector<double>& x, int fs, double target_pow) {
  // power in the 350-3250 Hz band via single FFT
  const size_t n = next_pow2(x.size());
  std::vector<std::complex<double>> buf(n);
  for (size_t i = 0; i < x.size(); i++) buf[i] = x[i];
  fft(buf, false);
  double band_pow = 0;
  for (size_t k = 0; k <= n / 2; k++) {
    double f = double(k) * fs / double(n);
    if (f >= 350.0 && f <= 3250.0)
      band_pow += std::norm(buf[k]) * (k == 0 || k == n / 2 ? 1.0 : 2.0);
  }
  band_pow /= double(n) * double(x.size());
  double scale = band_pow > 1e-20 ? std::sqrt(target_pow / band_pow) : 1.0;
  for (double& v : x) v *= scale;
}

}  // namespace

extern "C" {

// Raw P.862-style MOS for 16-bit-range float signals at fs in {8000, 16000}.
// Returns NaN on invalid input.
double pesq_mos(const float* ref_in, int n_ref, const float* deg_in, int n_deg,
                int fs) {
  if (fs != 8000 && fs != 16000) return std::nan("");
  if (n_ref < fs / 4 || n_deg < fs / 4) return std::nan("");

  std::vector<double> ref(ref_in, ref_in + n_ref);
  std::vector<double> deg(deg_in, deg_in + n_deg);

  // 1. level alignment (P.862 target power on the 350-3250 band)
  const double target = 1e7 / 32768.0 / 32768.0;  // normalized-float domain
  bandpass_level_align(ref, fs, target);
  bandpass_level_align(deg, fs, target);

  // 3. time alignment
  int delay = estimate_delay(ref, deg, fs);
  if (delay > 0) deg.erase(deg.begin(), deg.begin() + std::min<size_t>(delay, deg.size()));
  else if (delay < 0) ref.erase(ref.begin(), ref.begin() + std::min<size_t>(-delay, ref.size()));
  size_t n = std::min(ref.size(), deg.size());
  if (n < size_t(fs / 4)) return std::nan("");
  ref.resize(n);
  deg.resize(n);

  // 4. spectra (32 ms, 50% overlap)
  const int frame = int(0.032 * fs);
  const int shift = frame / 2;
  Frames fr = spectra(ref, frame, shift);
  Frames fd = spectra(deg, frame, shift);
  const int T = int(std::min(fr.power.size(), fd.power.size()));
  if (T < 4) return std::nan("");
  const int n_bins = fr.n_bins;
  const double bin_hz = double(fs) / next_pow2(frame);

  // 2. IRS-like receive filter (applied in the power domain)
  std::vector<double> irs_pow(n_bins);
  for (int k = 0; k < n_bins; k++)
    irs_pow[k] = std::pow(10.0, irs_gain_db(k * bin_hz) / 10.0);

  // 5. Bark integration: 49 bands equally spaced in Bark up to fs/2
  const int NB = 49;
  const double max_bark = hz_to_bark(fs / 2.0);
  std::vector<int> band_of(n_bins);
  std::vector<double> band_width(NB, 0.0), band_thresh(NB, 0.0), band_cf(NB, 0.0);
  std::vector<int> band_count(NB, 0);
  for (int k = 0; k < n_bins; k++) {
    int b = std::min(NB - 1, int(hz_to_bark(k * bin_hz) / max_bark * NB));
    band_of[k] = b;
    band_count[b]++;
    band_cf[b] += k * bin_hz;
  }
  for (int b = 0; b < NB; b++) {
    if (band_count[b]) band_cf[b] /= band_count[b];
    // hearing threshold as power in the normalized domain: 0 dB SPL ~ 2e-7
    band_thresh[b] = std::pow(10.0, (abs_thresh_db(std::max(band_cf[b], 20.0)) - 90.0) / 10.0);
  }

  auto to_bark = [&](const std::vector<double>& bins) {
    std::vector<double> bands(NB, 0.0);
    for (int k = 1; k < n_bins; k++)
      bands[band_of[k]] += bins[k] * irs_pow[k];
    return bands;
  };

  std::vector<std::vector<double>> Br(T), Bd(T);
  std::vector<double> frame_energy(T);
  for (int t = 0; t < T; t++) {
    Br[t] = to_bark(fr.power[t]);
    Bd[t] = to_bark(fd.power[t]);
    double e = 0;
    for (double v : Br[t]) e += v;
    frame_energy[t] = e;
  }
  // speech-active frames: energy above 1e-4 of peak
  double peak = 1e-30;
  for (double e : frame_energy) peak = std::max(peak, e);
  std::vector<bool> active(T);
  int n_active = 0;
  for (int t = 0; t < T; t++) {
    active[t] = frame_energy[t] > 1e-4 * peak;
    n_active += active[t];
  }
  if (n_active < 2) return std::nan("");

  // 6a. partial frequency compensation (bounded band ratio, deg scaled)
  std::vector<double> num(NB, 1e-30), den(NB, 1e-30);
  for (int t = 0; t < T; t++)
    if (active[t])
      for (int b = 0; b < NB; b++) {
        num[b] += Br[t][b];
        den[b] += Bd[t][b];
      }
  std::vector<double> freq_comp(NB);
  for (int b = 0; b < NB; b++) {
    double r = num[b] / den[b];
    freq_comp[b] = std::min(100.0, std::max(0.01, r));
  }

  // loudness (Zwicker law, P.862 exponent 0.23 with low-band boost)
  auto loudness = [&](const std::vector<double>& bands) {
    std::vector<double> L(NB);
    for (int b = 0; b < NB; b++) {
      double p0 = band_thresh[b];
      double zwick = 0.23;
      if (band_cf[b] < 1000.0 && band_cf[b] > 0.0)
        zwick += 0.0006 * (1000.0 - band_cf[b]) / 100.0;  // mild low-f boost
      double sl = std::pow(p0 / 0.5e-8, zwick);
      double v = sl * (std::pow(0.5 + 0.5 * bands[b] / p0, zwick) - 1.0);
      L[b] = v > 0 ? v : 0.0;
    }
    return L;
  };

  // 6b-7. disturbances
  std::vector<double> frame_d(T, 0.0), frame_da(T, 0.0), frame_w(T, 0.0);
  for (int t = 0; t < T; t++) {
    // per-frame gain compensation on deg (bounded [3e-4, 5])
    double er = 1e-30, ed = 1e-30;
    for (int b = 0; b < NB; b++) {
      er += Br[t][b];
      ed += Bd[t][b] * freq_comp[b];
    }
    double g = std::min(5.0, std::max(3e-4, er / ed));
    std::vector<double> bd(NB);
    for (int b = 0; b < NB; b++) bd[b] = Bd[t][b] * freq_comp[b] * g;

    auto Lr = loudness(Br[t]);
    auto Ld = loudness(bd);
    double d2 = 0.0, da = 0.0;
    for (int b = 0; b < NB; b++) {
      double diff = Ld[b] - Lr[b];
      double m = 0.25 * std::min(Ld[b], Lr[b]);  // masking deadzone
      double d = 0.0;
      if (diff > m) d = diff - m;
      else if (diff < -m) d = diff + m;
      double wb = band_count[b] > 0 ? 1.0 : 0.0;
      d2 += d * d * wb;
      // asymmetry factor: additive (noisy) distortion weighted up
      double ratio = (bd[b] + 50.0 * band_thresh[b]) /
                     (Br[t][b] + 50.0 * band_thresh[b]);
      double h = std::pow(ratio, 1.2);
      if (h < 3.0) h = 0.0;
      if (h > 12.0) h = 12.0;
      da += std::max(d, 0.0) * h * wb;
    }
    frame_d[t] = std::sqrt(d2);
    frame_da[t] = da;
    frame_w[t] = std::pow((frame_energy[t] + 1e5 * band_thresh[0]) / 1e4, 0.04);
    double cap = 45.0;
    if (frame_d[t] > cap) frame_d[t] = cap;
  }

  // 8. time aggregation: L6 over 20-frame intervals, L2 over intervals
  auto aggregate = [&](const std::vector<double>& fd_, double p_in, double p_out) {
    const int span = 20;
    std::vector<double> chunks;
    for (int s = 0; s < T; s += span / 2) {
      double acc = 0;
      int c = 0;
      for (int t = s; t < std::min(T, s + span); t++) {
        if (!active[t]) continue;
        acc += std::pow(fd_[t], p_in);
        c++;
      }
      if (c) chunks.push_back(std::pow(acc / c, 1.0 / p_in));
    }
    if (chunks.empty()) return 0.0;
    double acc = 0;
    for (double v : chunks) acc += std::pow(v, p_out);
    return std::pow(acc / chunks.size(), 1.0 / p_out);
  };

  double D = aggregate(frame_d, 6.0, 2.0);
  double DA = aggregate(frame_da, 1.0, 2.0);

  // P.862 linear map, then a soft knee so heavy degradations land in the
  // 1.x region the ITU binary reports for real noisy speech instead of
  // saturating at the clamp (the analytic loudness tables run slightly
  // hotter than the ITU ones).
  double raw = 0.1 * D + 0.0309 * DA;
  double mos = 4.5 - 3.8 * (1.0 - std::exp(-raw / 2.2));
  if (mos < -0.5) mos = -0.5;
  if (mos > 4.5) mos = 4.5;
  return mos;
}

int pesq_version(void) { return 862; }

}  // extern "C"
