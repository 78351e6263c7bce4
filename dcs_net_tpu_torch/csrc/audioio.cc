// The port's native audio front end: the JAX package's native/audio/audioio.cc
// with the same C interface (audioio_load, audioio_fill_batch,
// audioio_version), and a batch fill that reads only each crop's window.
//
// PCM16/24/32 WAV decode, windowed-sinc polyphase resampling with double
// accumulation (the kernel bank comes from the Python side,
// data/audio_io.py:sinc_resample_kernel, so host and device paths share
// coefficients), and a pthread-parallel batch fill that decodes, resamples,
// crops or right-pads and writes straight into the caller's numpy buffers:
// one C call a training batch.
//
// Two batch fills, one result:
//   audioio_fill_batch_full  decodes and resamples each whole utterance, then
//                            crops: the JAX package's fill, kept as the
//                            reference of the other;
//   audioio_fill_batch       decodes only the input samples that the crop's
//                            outputs read (at 48 -> 16 kHz output o reads
//                            inputs [3o - 19, 3o + 22), zeros outside the
//                            file) and resamples only those outputs.
// Each kept output is the same double sum, in the same order, over the same
// input values, so the two fills agree bit for bit.
//
// Build: g++ -O2 -shared -fPIC -pthread -o libaudioio.so audioio.cc

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// A file read at offsets with pread, its first 4 KB (where a wav's header
// lies) read once. Unlike stdio, which refills its whole buffer at every seek,
// it reads no byte that is not asked for.
class File {
 public:
  explicit File(const char* path) : fd_(::open(path, O_RDONLY | O_CLOEXEC)) {
    struct stat st;
    if (fd_ < 0 || ::fstat(fd_, &st) != 0) return;
    size_ = st.st_size;
    head_n_ = ::pread(fd_, head_, sizeof head_, 0);
  }
  ~File() {
    if (fd_ >= 0) ::close(fd_);
  }
  File(const File&) = delete;
  File& operator=(const File&) = delete;
  bool ok() const { return fd_ >= 0 && head_n_ >= 0; }
  int64_t size() const { return size_; }
  // n bytes at offset off into dst; false if the file ends before
  bool read(int64_t off, void* dst, size_t n) const {
    if (off >= 0 && off + int64_t(n) <= head_n_) {
      std::memcpy(dst, head_ + off, n);
      return true;
    }
    auto* p = static_cast<uint8_t*>(dst);
    while (n > 0) {
      const ssize_t got = ::pread(fd_, p, n, off);
      if (got <= 0) return false;
      p += got, off += got, n -= size_t(got);
    }
    return true;
  }

 private:
  int fd_;
  int64_t size_ = 0;
  ssize_t head_n_ = -1;
  uint8_t head_[4096];
};

struct WavInfo {
  uint16_t format = 0, channels = 0, bits = 0;
  uint32_t sample_rate = 0;
  int64_t data_offset = 0;  // the data chunk's first byte in the file
  uint32_t data_size = 0;
  int64_t n_frames = 0;
};

// Parse the RIFF header up to its fmt and data chunks. The data chunk must lie
// whole in the file and hold PCM samples of 16, 24 or 32 bits.
bool read_header(const File& f, WavInfo* h) {
  int64_t off = 0;
  auto rd = [&](void* v, size_t n) {
    const bool got = f.read(off, v, n);
    off += int64_t(n);
    return got;
  };
  char tag[4];
  uint32_t riff_size;
  if (!f.ok() || !rd(tag, 4) || std::memcmp(tag, "RIFF", 4) || !rd(&riff_size, 4) ||
      !rd(tag, 4) || std::memcmp(tag, "WAVE", 4))
    return false;
  bool got_fmt = false, got_data = false;
  while (rd(tag, 4)) {
    uint32_t size;
    if (!rd(&size, 4)) break;
    if (!std::memcmp(tag, "fmt ", 4)) {
      uint32_t byte_rate;
      uint16_t block_align;
      if (!rd(&h->format, 2) || !rd(&h->channels, 2) || !rd(&h->sample_rate, 4) ||
          !rd(&byte_rate, 4) || !rd(&block_align, 2) || !rd(&h->bits, 2))
        break;
      if (size > 16) off += size - 16;
      got_fmt = true;
    } else if (!std::memcmp(tag, "data", 4)) {
      h->data_offset = off;
      h->data_size = size;
      off += size;
      got_data = true;
    } else {
      off += size + (size & 1);
    }
    if (got_fmt && got_data) break;
  }
  if (!got_fmt || !got_data || h->channels == 0) return false;
  if (h->format != 1 && h->format != 0xFFFE) return false;  // PCM only
  if (h->bits != 16 && h->bits != 24 && h->bits != 32) return false;
  if (f.size() < h->data_offset + int64_t(h->data_size)) return false;
  h->n_frames = h->data_size / ((h->bits / 8) * h->channels);
  return true;
}

// Decode frames [first, first + count) of the data chunk into out: channels
// averaged, divided by 2^(bits - 1) when normalizing.
bool decode(const File& f, const WavInfo& h, int64_t first, int64_t count,
            bool normalize, float* out) {
  if (count <= 0) return true;
  const size_t bytes_per = h.bits / 8;
  const size_t frame_bytes = bytes_per * h.channels;
  std::vector<uint8_t> data(size_t(count) * frame_bytes);
  if (!f.read(h.data_offset + first * int64_t(frame_bytes), data.data(), data.size()))
    return false;
  const double scale = normalize ? std::pow(2.0, h.bits - 1) : 1.0;
  for (int64_t i = 0; i < count; i++) {
    double acc = 0;
    for (int c = 0; c < h.channels; c++) {
      const uint8_t* p = data.data() + (i * h.channels + c) * bytes_per;
      int32_t v;
      if (h.bits == 16) {
        v = int16_t(p[0] | (p[1] << 8));
      } else if (h.bits == 24) {
        v = (p[0] << 8 | p[1] << 16 | p[2] << 24) >> 8;
      } else {
        v = int32_t(p[0] | (p[1] << 8) | (p[2] << 16) | (uint32_t(p[3]) << 24));
      }
      acc += double(v);
    }
    out[i] = float(acc / h.channels / scale);
  }
  return true;
}

struct Wav {
  std::vector<float> samples;  // mono, [-1, 1]
  int sample_rate = 0;
};

bool read_wav(const char* path, Wav* out, bool normalize) {
  const File f(path);
  WavInfo h;
  if (!read_header(f, &h)) return false;
  out->samples.resize(h.n_frames);
  out->sample_rate = int(h.sample_rate);
  return decode(f, h, 0, h.n_frames, normalize, out->samples.data());
}

// A resampling kernel bank: (n_phases, klen) row-major; the input is read
// padded by width zeros on the left and width + orig on the right.
struct Bank {
  const float* kernels;
  int n_phases, klen, width, orig;
  bool on() const { return kernels != nullptr && n_phases > 0; }
  // the resampled length of n input samples
  int64_t length(int64_t n) const {
    const int64_t target = (n_phases * n + orig - 1) / orig;
    const int64_t n_frames = (n + width + width + orig - klen) / orig + 1;
    return std::min(target, n_frames * n_phases);
  }
  // output o from padded-input positions [p0, ...) held at xp (position j
  // is input sample j - width)
  float output(const float* xp, int64_t p0, int64_t o) const {
    const float* base = xp + ((o / n_phases) * orig - p0);
    const float* k = kernels + (o % n_phases) * klen;
    double acc = 0;
    for (int i = 0; i < klen; i++) acc += double(base[i]) * double(k[i]);
    return float(acc);
  }
};

std::vector<float> resample(const std::vector<float>& x, const Bank& b) {
  const int64_t n = int64_t(x.size());
  std::vector<float> xp(n + b.width + b.width + b.orig, 0.0f);
  std::memcpy(xp.data() + b.width, x.data(), n * sizeof(float));
  std::vector<float> out(b.length(n));
  for (int64_t o = 0; o < int64_t(out.size()); o++) out[o] = b.output(xp.data(), 0, o);
  return out;
}

// Outputs [start, start + crop) of the utterance at path, resampled when the
// bank is on, into out: zeros at or past its length. Reads only the input
// samples those outputs need. Returns the utterance's (resampled) length, or
// -1 when the file cannot be read; *finite is false if a kept output is not.
int64_t fill_window(const char* path, bool normalize, const Bank& b,
                    int64_t start, int64_t crop, float* out, bool* finite) {
  std::fill(out, out + crop, 0.0f);
  const File f(path);
  WavInfo h;
  if (!read_header(f, &h)) return -1;
  const int64_t n = h.n_frames;
  const int64_t length = b.on() ? b.length(n) : n;
  const int64_t lo = std::min(start, length), hi = std::min(start + crop, length);
  bool ok = true;
  if (lo < hi && !b.on()) {
    ok = decode(f, h, lo, hi - lo, normalize, out);
  } else if (lo < hi) {
    // padded-input positions [p_lo, p_hi) feed outputs [lo, hi)
    const int64_t p_lo = (lo / b.n_phases) * b.orig;
    const int64_t p_hi = ((hi - 1) / b.n_phases) * b.orig + b.klen;
    std::vector<float> xw(p_hi - p_lo, 0.0f);
    const int64_t d_lo = std::max<int64_t>(p_lo - b.width, 0);
    const int64_t d_hi = std::min<int64_t>(p_hi - b.width, n);
    if (d_lo < d_hi)
      ok = decode(f, h, d_lo, d_hi - d_lo, normalize,
                  xw.data() + (d_lo + b.width - p_lo));
    for (int64_t o = lo; ok && o < hi; o++) out[o - start] = b.output(xw.data(), p_lo, o);
  }
  for (int64_t j = 0; j < hi - lo; j++)
    if (!std::isfinite(out[j])) *finite = false;
  return ok ? length : -1;
}

// Run work(i) for items [0, batch) on up to n_threads threads, each a
// contiguous run of items.
template <typename F>
void parallel_items(int batch, int n_threads, F work) {
  n_threads = std::max(1, std::min(n_threads, batch));
  std::vector<std::thread> threads;
  const int per = (batch + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; t++) {
    const int b = t * per, e = std::min(batch, b + per);
    if (b < e)
      threads.emplace_back([&work, b, e] {
        for (int i = b; i < e; i++) work(i);
      });
  }
  for (auto& t : threads) t.join();
}

int first_error(const std::vector<int>& errors) {
  for (size_t i = 0; i < errors.size(); i++)
    if (errors[i]) return -(1 + int(i));
  return 0;
}

}  // namespace

extern "C" {

// Decode one wav to caller buffer (call with out=null to query length).
// Returns sample count, or -1 on error. Output resampled when kernels given.
int64_t audioio_load(const char* path, int normalize, const float* kernels,
                     int n_phases, int klen, int width, int orig,
                     float* out, int64_t out_cap) {
  Wav w;
  if (!read_wav(path, &w, normalize != 0)) return -1;
  const Bank bank{kernels, n_phases, klen, width, orig};
  std::vector<float>* result = &w.samples;
  std::vector<float> res;
  if (bank.on()) {
    res = resample(w.samples, bank);
    result = &res;
  }
  if (out != nullptr) {
    int64_t n = std::min<int64_t>(result->size(), out_cap);
    std::memcpy(out, result->data(), n * sizeof(float));
  }
  return int64_t(result->size());
}

// Fill a training batch: for each item decode clean+noisy, resample, crop
// [start, start+crop) (right-pad zeros when short), write into
// clean_out/noisy_out (batch, crop) row-major. starts: per-item crop offsets
// (already drawn by the host's generator; negative means 0; null means all
// 0). Returns 0 on success, -(1+item) on failure of that item: a file that
// cannot be read, clean and noisy of different resampled lengths, or a
// non-finite kept sample. Whole utterances are decoded and resampled.
int audioio_fill_batch_full(const char** clean_paths, const char** noisy_paths,
                            const int64_t* starts, int batch, int64_t crop,
                            int normalize, const float* kernels, int n_phases,
                            int klen, int width, int orig, int n_threads,
                            float* clean_out, float* noisy_out) {
  const Bank bank{kernels, n_phases, klen, width, orig};
  std::vector<int> errors(batch, 0);
  parallel_items(batch, n_threads, [&](int i) {
    Wav wc, wn;
    if (!read_wav(clean_paths[i], &wc, normalize != 0) ||
        !read_wav(noisy_paths[i], &wn, normalize != 0)) {
      errors[i] = 1;
      return;
    }
    std::vector<float> c = wc.samples, n = wn.samples;
    if (bank.on()) {
      c = resample(c, bank);
      n = resample(n, bank);
    }
    if (c.size() != n.size()) {
      errors[i] = 2;
      return;
    }
    int64_t start = starts ? starts[i] : 0;
    if (start < 0) start = 0;
    float* co = clean_out + int64_t(i) * crop;
    float* no = noisy_out + int64_t(i) * crop;
    for (int64_t j = 0; j < crop; j++) {
      int64_t s = start + j;
      bool in = s < int64_t(c.size());
      co[j] = in ? c[s] : 0.0f;
      no[j] = in ? n[s] : 0.0f;
      if (in && (!std::isfinite(c[s]) || !std::isfinite(n[s]))) errors[i] = 3;
    }
  });
  return first_error(errors);
}

// audioio_fill_batch_full's result, reading and resampling only each item's
// crop window.
int audioio_fill_batch(const char** clean_paths, const char** noisy_paths,
                       const int64_t* starts, int batch, int64_t crop,
                       int normalize, const float* kernels, int n_phases,
                       int klen, int width, int orig, int n_threads,
                       float* clean_out, float* noisy_out) {
  const Bank bank{kernels, n_phases, klen, width, orig};
  std::vector<int> errors(batch, 0);
  parallel_items(batch, n_threads, [&](int i) {
    const int64_t start = std::max<int64_t>(starts ? starts[i] : 0, 0);
    bool finite = true;
    const int64_t lc = fill_window(clean_paths[i], normalize != 0, bank, start,
                                   crop, clean_out + int64_t(i) * crop, &finite);
    const int64_t ln = fill_window(noisy_paths[i], normalize != 0, bank, start,
                                   crop, noisy_out + int64_t(i) * crop, &finite);
    if (lc < 0 || ln < 0)
      errors[i] = 1;
    else if (lc != ln)
      errors[i] = 2;
    else if (!finite)
      errors[i] = 3;
  });
  return first_error(errors);
}

int audioio_version(void) { return 2; }

}  // extern "C"
