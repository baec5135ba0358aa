// Threaded RIFF/WAVE batch decoder.
//
// The reference decodes AudioSet wavs per sample inside torch DataLoader's
// C++ worker pool (old/data_manager/audioset.py:160-176: torchaudio.load ->
// stereo->mono -> zero-pad both ends -> random unit-length crop).  Here the
// same batch assembly runs as one C++ thread pool writing straight into a
// caller-provided float32 buffer — the wav-domain sibling of
// npy_batch_loader.cc; the mel/normalize/augment work stays on device
// (train/steps.py make_device_frontend).
//
// Exposed C ABI (ctypes-friendly):
//   int read_wav_batch(const char** paths, int n, long long unit_length,
//                      int expect_sr, unsigned long long seed, int n_threads,
//                      float* out /* n * unit_length */);
// Returns 0 on success, else the (1-based) index of the first failing file
// (unreadable, unsupported encoding, or sample-rate mismatch — the Python
// path asserts the same "convert to 16 kHz first" contract,
// ssl_audio_tpu/data/datasets.py:358-362).
//
// Supported payloads: RIFF/WAVE with fmt PCM int16 / int32 (format 1 or the
// matching WAVE_FORMAT_EXTENSIBLE) or IEEE float32 (format 3), any channel
// count (averaged to mono).  Crop starts use a per-item splitmix64 stream —
// same distribution as the Python path's Generator.integers, different
// (still deterministic) draws, matching the npy loader's seeding contract.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

struct WavInfo {
  uint16_t format = 0;        // 1 = PCM, 3 = IEEE float
  uint16_t channels = 0;
  uint32_t sample_rate = 0;
  uint16_t bits = 0;
  long data_offset = 0;
  uint32_t data_bytes = 0;
};

bool read_u32(FILE* f, uint32_t* v) {
  unsigned char b[4];
  if (fread(b, 1, 4, f) != 4) return false;
  *v = b[0] | (b[1] << 8) | (b[2] << 16) | (uint32_t(b[3]) << 24);
  return true;
}

bool parse_wav(FILE* f, WavInfo* info) {
  unsigned char hdr[12];
  if (fread(hdr, 1, 12, f) != 12) return false;
  if (memcmp(hdr, "RIFF", 4) != 0 || memcmp(hdr + 8, "WAVE", 4) != 0)
    return false;
  bool have_fmt = false;
  for (;;) {
    unsigned char id[4];
    uint32_t size = 0;
    if (fread(id, 1, 4, f) != 4 || !read_u32(f, &size)) return false;
    long next = ftell(f) + long(size) + (size & 1);  // RIFF pads to even
    if (memcmp(id, "fmt ", 4) == 0) {
      unsigned char fmt[16];
      if (size < 16 || fread(fmt, 1, 16, f) != 16) return false;
      info->format = fmt[0] | (fmt[1] << 8);
      info->channels = fmt[2] | (fmt[3] << 8);
      info->sample_rate =
          fmt[4] | (fmt[5] << 8) | (fmt[6] << 16) | (uint32_t(fmt[7]) << 24);
      info->bits = fmt[14] | (fmt[15] << 8);
      if (info->format == 0xFFFE && size >= 26) {
        // WAVE_FORMAT_EXTENSIBLE: first 2 bytes of the SubFormat GUID hold
        // the real format tag (cbSize u16 + wValidBits u16 + dwMask u32
        // precede it)
        unsigned char ext[10];
        if (fread(ext, 1, 10, f) != 10) return false;
        info->format = ext[8] | (ext[9] << 8);
      }
      have_fmt = true;
    } else if (memcmp(id, "data", 4) == 0) {
      info->data_offset = ftell(f);
      info->data_bytes = size;
      return have_fmt && info->channels > 0;
    }
    if (fseek(f, next, SEEK_SET) != 0) return false;
  }
}

// Decode one wav to mono float32, pad/crop to unit_length, write to out.
bool load_one(const char* path, int64_t unit_length, int expect_sr,
              uint64_t item_seed, float* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  WavInfo info;
  if (!parse_wav(f, &info) || int(info.sample_rate) != expect_sr ||
      fseek(f, info.data_offset, SEEK_SET) != 0) {
    fclose(f);
    return false;
  }
  const int ch = info.channels;
  int word;
  if (info.format == 1 && info.bits == 16) word = 2;
  else if (info.format == 1 && info.bits == 32) word = 4;
  else if (info.format == 3 && info.bits == 32) word = 4;
  else { fclose(f); return false; }

  const int64_t frame_bytes = int64_t(word) * ch;
  int64_t n_frames = info.data_bytes / frame_bytes;
  std::vector<unsigned char> raw(size_t(n_frames) * frame_bytes);
  size_t got = fread(raw.data(), 1, raw.size(), f);
  fclose(f);
  n_frames = int64_t(got / frame_bytes);  // tolerate truncated data chunks
  if (n_frames <= 0) return false;

  // mono decode into a scratch buffer (only the cropped window when the
  // clip is longer than unit_length — decode-after-crop saves the work)
  int64_t start = 0, length = n_frames;
  if (n_frames > unit_length) {
    start = int64_t(splitmix64(item_seed) % uint64_t(n_frames - unit_length + 1));
    length = unit_length;
  }
  const float inv_ch = 1.0f / float(ch);
  int64_t pad = unit_length > n_frames ? (unit_length - n_frames) / 2 : 0;
  if (pad > 0) memset(out, 0, size_t(pad) * sizeof(float));
  float* dst = out + pad;
  const unsigned char* src = raw.data() + size_t(start) * frame_bytes;
  for (int64_t i = 0; i < length; ++i) {
    float acc = 0.0f;
    for (int c = 0; c < ch; ++c) {
      const unsigned char* p = src + i * frame_bytes + int64_t(c) * word;
      if (word == 2) {
        int16_t v;
        memcpy(&v, p, 2);
        acc += float(v) * (1.0f / 32768.0f);
      } else if (info.format == 1) {
        int32_t v;
        memcpy(&v, p, 4);
        acc += float(double(v) * (1.0 / 2147483648.0));
      } else {
        float v;
        memcpy(&v, p, 4);
        acc += v;
      }
    }
    dst[i] = acc * inv_ch;
  }
  int64_t tail = unit_length - pad - length;
  if (tail > 0) memset(dst + length, 0, size_t(tail) * sizeof(float));
  return true;
}

}  // namespace

extern "C" int read_wav_batch(const char** paths, int n, long long unit_length,
                              int expect_sr, unsigned long long seed,
                              int n_threads, float* out) {
  std::atomic<int> next(0);
  std::atomic<int> failed(0);  // 1-based index of first failure (0 = none)
  int workers = n_threads > 0 ? n_threads : 1;
  if (workers > n) workers = n;
  auto run = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n || failed.load(std::memory_order_relaxed)) return;
      uint64_t item_seed = splitmix64(seed ^ (uint64_t(i) * 0x9E3779B97F4A7C15ull));
      if (!load_one(paths[i], unit_length, expect_sr, item_seed,
                    out + int64_t(i) * unit_length)) {
        int expect = 0;
        failed.compare_exchange_strong(expect, i + 1);
      }
    }
  };
  std::vector<std::thread> pool;
  for (int t = 0; t < workers; ++t) pool.emplace_back(run);
  for (auto& t : pool) t.join();
  return failed.load();
}
