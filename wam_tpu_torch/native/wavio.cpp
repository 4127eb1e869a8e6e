// Native WAV decoder — the host-side IO fast path of the audio data layer.
// Role of the reference's scipy.io.wavfile/soundfile C backends
// (src/dataloader.py:93-96, src/helpers.py:246-267): parse RIFF/WAVE PCM
// (16-bit int / 32-bit float), return float32 samples. Built as a shared
// library and loaded through ctypes (wam_tpu_torch/native/__init__.py), with a
// pure-scipy fallback when the toolchain is unavailable.
//
// API (C linkage):
//   wav_info(path, &sample_rate, &channels, &frames)  -> 0 on success
//   wav_read_f32(path, out, capacity_frames)          -> frames read (<0 err)
//     `out` receives channel-interleaved float32 in [-1, 1].

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

struct WavMeta {
  uint32_t sample_rate = 0;
  uint16_t channels = 0;
  uint16_t bits = 0;
  uint16_t format = 0;  // 1 = PCM, 3 = IEEE float
  long data_offset = -1;
  uint32_t data_bytes = 0;
};

bool parse_header(FILE* f, WavMeta* meta) {
  char tag[4];
  uint32_t riff_size;
  if (fread(tag, 1, 4, f) != 4 || memcmp(tag, "RIFF", 4) != 0) return false;
  if (fread(&riff_size, 4, 1, f) != 1) return false;
  if (fread(tag, 1, 4, f) != 4 || memcmp(tag, "WAVE", 4) != 0) return false;

  while (fread(tag, 1, 4, f) == 4) {
    uint32_t chunk_size;
    if (fread(&chunk_size, 4, 1, f) != 1) return false;
    if (memcmp(tag, "fmt ", 4) == 0) {
      uint16_t fmt, ch;
      uint32_t sr, byte_rate;
      uint16_t block_align, bits;
      if (chunk_size < 16) return false;
      if (fread(&fmt, 2, 1, f) != 1 || fread(&ch, 2, 1, f) != 1 ||
          fread(&sr, 4, 1, f) != 1 || fread(&byte_rate, 4, 1, f) != 1 ||
          fread(&block_align, 2, 1, f) != 1 || fread(&bits, 2, 1, f) != 1)
        return false;
      meta->format = fmt;
      meta->channels = ch;
      meta->sample_rate = sr;
      meta->bits = bits;
      if (chunk_size > 16) fseek(f, chunk_size - 16, SEEK_CUR);
    } else if (memcmp(tag, "data", 4) == 0) {
      meta->data_offset = ftell(f);
      meta->data_bytes = chunk_size;
      return meta->sample_rate != 0;
    } else {
      // chunks are word-aligned
      fseek(f, chunk_size + (chunk_size & 1), SEEK_CUR);
    }
  }
  return false;
}

}  // namespace

extern "C" {

int wav_info(const char* path, int* sample_rate, int* channels, long* frames) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavMeta meta;
  bool ok = parse_header(f, &meta);
  fclose(f);
  if (!ok || meta.channels == 0 || meta.bits == 0) return -2;
  *sample_rate = static_cast<int>(meta.sample_rate);
  *channels = meta.channels;
  *frames = static_cast<long>(meta.data_bytes) / (meta.channels * meta.bits / 8);
  return 0;
}

long wav_read_f32(const char* path, float* out, long capacity_frames) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavMeta meta;
  if (!parse_header(f, &meta)) {
    fclose(f);
    return -2;
  }
  const long frames =
      static_cast<long>(meta.data_bytes) / (meta.channels * meta.bits / 8);
  const long n = frames < capacity_frames ? frames : capacity_frames;
  const long samples = n * meta.channels;
  fseek(f, meta.data_offset, SEEK_SET);

  long written = -3;
  if (meta.format == 1 && meta.bits == 16) {
    std::vector<int16_t> buf(samples);
    if (fread(buf.data(), 2, samples, f) == static_cast<size_t>(samples)) {
      constexpr float kScale = 1.0f / 32768.0f;
      for (long i = 0; i < samples; ++i) out[i] = buf[i] * kScale;
      written = n;
    }
  } else if (meta.format == 3 && meta.bits == 32) {
    if (fread(out, 4, samples, f) == static_cast<size_t>(samples)) written = n;
  } else if (meta.format == 1 && meta.bits == 32) {
    std::vector<int32_t> buf(samples);
    if (fread(buf.data(), 4, samples, f) == static_cast<size_t>(samples)) {
      constexpr double kScale = 1.0 / 2147483648.0;
      for (long i = 0; i < samples; ++i)
        out[i] = static_cast<float>(buf[i] * kScale);
      written = n;
    }
  }
  fclose(f);
  return written;
}

}  // extern "C"
