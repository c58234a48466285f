// wavio: native WAV decode + windowed-sinc resample for the host data
// pipeline of mme_tpu_torch (data/wavio.py loads it with ctypes).
//
// The decode + resample loop is C++ called through ctypes, which releases
// the GIL for the whole call, so a Python thread pool decodes on every core
// while the card trains. The sinc kernel is built as
// mme_tpu_torch/ops/resample.py::sinc_resample_kernel builds it.
//
// Supported: RIFF/WAVE, PCM 16/24/32-bit and IEEE float32, any channel
// count (averaged to mono).
//
// Built at first use by data/wavio.py::build_library:
//   g++ -O3 -march=native -ffast-math -shared -fPIC
// into mme_tpu_torch/_build/.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

struct WavData {
  int sample_rate = 0;
  int channels = 0;
  std::vector<float> mono;  // channel-averaged samples
};

bool read_wav(const char* path, WavData* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  char riff[4], wave[4];
  uint32_t riff_size;
  if (fread(riff, 1, 4, f) != 4 || memcmp(riff, "RIFF", 4) ||
      fread(&riff_size, 4, 1, f) != 1 || fread(wave, 1, 4, f) != 4 ||
      memcmp(wave, "WAVE", 4)) {
    fclose(f);
    return false;
  }
  uint16_t fmt_code = 0, channels = 0, bits = 0;
  uint32_t sample_rate = 0;
  bool got_fmt = false;
  std::vector<uint8_t> data;
  char chunk_id[4];
  uint32_t chunk_size;
  while (fread(chunk_id, 1, 4, f) == 4 && fread(&chunk_size, 4, 1, f) == 1) {
    if (!memcmp(chunk_id, "fmt ", 4)) {
      std::vector<uint8_t> fmt(chunk_size);
      if (fread(fmt.data(), 1, chunk_size, f) != chunk_size) break;
      fmt_code = *reinterpret_cast<uint16_t*>(&fmt[0]);
      channels = *reinterpret_cast<uint16_t*>(&fmt[2]);
      sample_rate = *reinterpret_cast<uint32_t*>(&fmt[4]);
      bits = *reinterpret_cast<uint16_t*>(&fmt[14]);
      if (fmt_code == 0xFFFE && chunk_size >= 26)  // WAVE_FORMAT_EXTENSIBLE
        fmt_code = *reinterpret_cast<uint16_t*>(&fmt[24]);
      got_fmt = true;
    } else if (!memcmp(chunk_id, "data", 4)) {
      data.resize(chunk_size);
      if (fread(data.data(), 1, chunk_size, f) != chunk_size) break;
    } else {
      fseek(f, chunk_size + (chunk_size & 1), SEEK_CUR);
      continue;
    }
    if (chunk_size & 1) fseek(f, 1, SEEK_CUR);
  }
  fclose(f);
  if (!got_fmt || data.empty() || channels == 0) return false;

  const size_t bytes_per_sample = bits / 8;
  const size_t frames = data.size() / (bytes_per_sample * channels);
  out->sample_rate = static_cast<int>(sample_rate);
  out->channels = channels;
  out->mono.resize(frames);
  const float inv_ch = 1.0f / channels;
  for (size_t i = 0; i < frames; ++i) {
    float acc = 0.0f;
    for (int c = 0; c < channels; ++c) {
      const uint8_t* p = &data[(i * channels + c) * bytes_per_sample];
      float v = 0.0f;
      if (fmt_code == 3 && bits == 32) {  // IEEE float
        v = *reinterpret_cast<const float*>(p);
      } else if (bits == 16) {
        v = *reinterpret_cast<const int16_t*>(p) / 32768.0f;
      } else if (bits == 32) {
        v = *reinterpret_cast<const int32_t*>(p) / 2147483648.0f;
      } else if (bits == 24) {
        int32_t s = (p[0] << 8) | (p[1] << 16) | (p[2] << 24);
        v = (s >> 8) / 8388608.0f;
      }
      acc += v;
    }
    out->mono[i] = acc * inv_ch;
  }
  return true;
}

// the windowed-sinc kernel of ops/resample.py::sinc_resample_kernel
void build_kernel(int orig_r, int new_r, int lowpass_width, double rolloff,
                  std::vector<std::vector<float>>* kernel, int* width) {
  const double base_freq = (orig_r < new_r ? orig_r : new_r) * rolloff;
  *width = static_cast<int>(std::ceil(lowpass_width * orig_r / base_freq));
  const int klen = 2 * (*width) + orig_r;
  kernel->assign(new_r, std::vector<float>(klen));
  const double scale = base_freq / orig_r;
  for (int phase = 0; phase < new_r; ++phase) {
    for (int j = 0; j < klen; ++j) {
      double t = (-(double)phase / new_r + (double)(j - *width) / orig_r) *
                 base_freq;
      if (t < -lowpass_width) t = -lowpass_width;
      if (t > lowpass_width) t = lowpass_width;
      double w = std::cos(t * M_PI / lowpass_width / 2);
      w *= w;
      double tp = t * M_PI;
      double s = (tp == 0.0) ? 1.0 : std::sin(tp) / tp;
      (*kernel)[phase][j] = static_cast<float>(s * w * scale);
    }
  }
}

int64_t gcd64(int64_t a, int64_t b) { return b == 0 ? a : gcd64(b, a % b); }

void resample(const std::vector<float>& in, int orig_freq, int new_freq,
              int lowpass_width, double rolloff, std::vector<float>* out) {
  if (orig_freq == new_freq) {
    *out = in;
    return;
  }
  const int g = static_cast<int>(gcd64(orig_freq, new_freq));
  const int orig_r = orig_freq / g, new_r = new_freq / g;
  std::vector<std::vector<float>> kernel;
  int width = 0;
  build_kernel(orig_r, new_r, lowpass_width, rolloff, &kernel, &width);
  const int klen = 2 * width + orig_r;
  const int64_t T = static_cast<int64_t>(in.size());
  const int64_t target_len =
      static_cast<int64_t>(std::ceil((double)new_r * T / orig_r));
  // padded input: [width zeros] in [width + orig_r zeros]
  std::vector<float> x(width + T + width + orig_r, 0.0f);
  std::copy(in.begin(), in.end(), x.begin() + width);
  const int64_t num_windows = ((int64_t)x.size() - klen) / orig_r + 1;
  out->assign(num_windows * new_r, 0.0f);
  for (int64_t wi = 0; wi < num_windows; ++wi) {
    const float* seg = &x[wi * orig_r];
    for (int phase = 0; phase < new_r; ++phase) {
      const float* k = kernel[phase].data();
      float acc = 0.0f;
      for (int j = 0; j < klen; ++j) acc += seg[j] * k[j];
      (*out)[wi * new_r + phase] = acc;
    }
  }
  out->resize(target_len);
}

}  // namespace

extern "C" {

// Returns 0 on success. Fills sample_rate/channels/num_frames.
int wav_info(const char* path, int* sample_rate, int* channels,
             long long* num_frames) {
  WavData w;
  if (!read_wav(path, &w)) return 1;
  *sample_rate = w.sample_rate;
  *channels = w.channels;
  *num_frames = static_cast<long long>(w.mono.size());
  return 0;
}

// Decode `path`, average channels to mono, resample to target_sr.
// Writes up to `capacity` floats into `out`; stores true length in
// `out_len` (if > capacity the output was truncated). Returns 0 on success.
int wav_read_resampled(const char* path, int target_sr, float* out,
                       long long capacity, long long* out_len) {
  WavData w;
  if (!read_wav(path, &w)) return 1;
  std::vector<float> res;
  resample(w.mono, w.sample_rate, target_sr, 6, 0.99, &res);
  *out_len = static_cast<long long>(res.size());
  const long long n = *out_len < capacity ? *out_len : capacity;
  std::memcpy(out, res.data(), n * sizeof(float));
  return 0;
}

}  // extern "C"
