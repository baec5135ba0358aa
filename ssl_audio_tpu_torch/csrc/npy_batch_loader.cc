// Threaded .npy log-mel batch loader.
//
// The reference leans on torch DataLoader's C++ worker pool for its per-sample
// hot loop (SURVEY.md §3.1).  Our device pipeline removed the augmentation
// work from the host, leaving pure IO: read B `.npy` spectrograms, random
// time-crop/pad each to crop_frames, and normalize — exactly
// datasets.py:85-119 minus the transform.  This library does that batch
// assembly in C++ with a std::thread pool, writing straight into a
// caller-provided float32 buffer (zero Python-object overhead per sample).
//
// Exposed C ABI (ctypes-friendly):
//   int read_npy_batch(const char** paths, int n, int n_mels, int crop_frames,
//                      float mean, float inv_std, unsigned long long seed,
//                      int n_threads, float* out /* n*n_mels*crop_frames */);
// Returns 0 on success, else the (1-based) index of the first failing file.
//
// Supported .npy payloads: little-endian f4/f8, C-order, shape (n_mels, T).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct NpyInfo {
  int64_t rows = 0;
  int64_t cols = 0;
  int word = 0;          // 4 or 8
  long data_offset = 0;  // byte offset of payload
};

bool parse_header(FILE* f, NpyInfo* info) {
  unsigned char magic[8];
  if (fread(magic, 1, 8, f) != 8) return false;
  if (memcmp(magic, "\x93NUMPY", 6) != 0) return false;
  int major = magic[6];
  uint32_t header_len = 0;
  if (major == 1) {
    unsigned char b[2];
    if (fread(b, 1, 2, f) != 2) return false;
    header_len = b[0] | (b[1] << 8);
    info->data_offset = 10 + header_len;
  } else {
    unsigned char b[4];
    if (fread(b, 1, 4, f) != 4) return false;
    header_len = b[0] | (b[1] << 8) | (b[2] << 16) | (uint32_t(b[3]) << 24);
    info->data_offset = 12 + header_len;
  }
  std::string header(header_len, '\0');
  if (fread(&header[0], 1, header_len, f) != header_len) return false;

  if (header.find("'fortran_order': True") != std::string::npos) return false;
  size_t dpos = header.find("'descr':");
  if (dpos == std::string::npos) return false;
  if (header.find("<f4", dpos) != std::string::npos ||
      header.find("|f4", dpos) != std::string::npos) {
    info->word = 4;
  } else if (header.find("<f8", dpos) != std::string::npos) {
    info->word = 8;
  } else {
    return false;
  }
  size_t spos = header.find("'shape':");
  if (spos == std::string::npos) return false;
  size_t open = header.find('(', spos);
  if (open == std::string::npos) return false;
  long r = 0, c = 0;
  if (sscanf(header.c_str() + open, "(%ld, %ld", &r, &c) != 2) {
    // 1-D array: treat as one row
    if (sscanf(header.c_str() + open, "(%ld", &r) != 1) return false;
    c = r;
    r = 1;
  }
  info->rows = r;
  info->cols = c;
  return true;
}

// xorshift64* — deterministic per-sample crop RNG
inline uint64_t xs64(uint64_t* s) {
  uint64_t x = *s;
  x ^= x >> 12;
  x ^= x << 25;
  x ^= x >> 27;
  *s = x;
  return x * 0x2545F4914F6CDD1DULL;
}

bool load_one(const char* path, int n_mels, int crop_frames, float mean,
              float inv_std, uint64_t seed, float* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  NpyInfo info;
  if (!parse_header(f, &info) || info.rows != n_mels) {
    fclose(f);
    return false;
  }
  const int64_t T = info.cols;
  int64_t start = 0;
  int64_t width = crop_frames < T ? crop_frames : T;
  if (T > crop_frames) {
    uint64_t s = seed ? seed : 0x9E3779B97F4A7C15ULL;
    start = (int64_t)(xs64(&s) % (uint64_t)(T - crop_frames));
  }
  std::vector<unsigned char> row(T * info.word);
  for (int64_t r = 0; r < n_mels; ++r) {
    if (fseek(f, info.data_offset + r * T * info.word, SEEK_SET) != 0 ||
        fread(row.data(), info.word, T, f) != (size_t)T) {
      fclose(f);
      return false;
    }
    float* dst = out + r * crop_frames;
    if (info.word == 4) {
      const float* src = reinterpret_cast<const float*>(row.data()) + start;
      for (int64_t c = 0; c < width; ++c) dst[c] = (src[c] - mean) * inv_std;
    } else {
      const double* src = reinterpret_cast<const double*>(row.data()) + start;
      for (int64_t c = 0; c < width; ++c)
        dst[c] = (float(src[c]) - mean) * inv_std;
    }
    // zero-pad (normalized zero is (0-mean)*inv_std in the reference? No —
    // the reference pads the RAW lms with 0 and normalizes afterwards,
    // datasets.py:91-95 then 117-119, so padding becomes (0-mean)/std)
    for (int64_t c = width; c < crop_frames; ++c) dst[c] = (0.0f - mean) * inv_std;
  }
  fclose(f);
  return true;
}

}  // namespace

extern "C" int read_npy_batch(const char** paths, int n, int n_mels,
                              int crop_frames, float mean, float inv_std,
                              unsigned long long seed, int n_threads,
                              float* out) {
  std::atomic<int> next(0);
  std::atomic<int> failed(0);
  const int64_t item = (int64_t)n_mels * crop_frames;
  int workers = n_threads > 0 ? n_threads : 1;
  if (workers > n) workers = n;

  auto work = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      uint64_t s = seed * 0x100000001B3ULL + (uint64_t)i * 0x9E3779B97F4A7C15ULL;
      if (!load_one(paths[i], n_mels, crop_frames, mean, inv_std, s,
                    out + (int64_t)i * item)) {
        int expected = 0;
        failed.compare_exchange_strong(expected, i + 1);
      }
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < workers; ++t) threads.emplace_back(work);
  for (auto& t : threads) t.join();
  return failed.load();
}
