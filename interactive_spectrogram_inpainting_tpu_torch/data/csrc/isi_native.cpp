// Native runtime pieces of the PyTorch port: mmap codemap-store reader +
// WAV PCM codec (the port's own copy of the JAX package's
// native/isi_native.cpp; the same C ABI).
//
// The reference's storage/IO runtime is native via dependencies: LMDB (C)
// for the codemap store (extract_code.py:256-265, lmdb_dataset.py:34-45)
// and libsndfile/sox for wav IO. This library reads the fixed-stride store
// format defined in interactive_spectrogram_inpainting_tpu_torch/data/
// codemap_store.py:
//
//   record := top int16[top_n] | bottom int16[bottom_n] | attrs int32[a_n]
//
// Exposed C ABI (consumed via ctypes from data/native.py):
//   isi_store_open(path, n, top_n, bottom_n, a_n, &handle) -> 0 / <0
//   isi_store_num_records(handle)
//   isi_store_read_batch(handle, indices, n, tops_i32, bottoms_i32,
//                        attrs_i32)         -> 0 / -1
//   isi_store_close(handle)
//   isi_wav_encode_pcm16(float*, n, ch, sr, out_buf) -> byte count
//   isi_wav_decode(bytes, len, float_out, &ch, &sr)  (PCM16/24/32+f32)
//
// Built at first use by data/native.py: g++ -O3 -shared -fPIC -std=c++17
// (no -march=native: a shared build directory must not carry a binary to
// another CPU).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <cmath>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

struct IsiStore {
  const uint8_t* data;
  size_t file_size;
  int64_t num_records;
  int64_t top_elems;
  int64_t bottom_elems;
  int64_t num_attrs;
  int64_t stride;
  int fd;
};

// Opens the raw codes.bin; geometry comes from the caller (parsed from
// store.json host-side, keeping the JSON parsing out of C++).
int isi_store_open(const char* codes_bin_path, int64_t num_records,
                   int64_t top_elems, int64_t bottom_elems,
                   int64_t num_attrs, IsiStore** out) {
  int fd = open(codes_bin_path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); return -2; }
  int64_t stride = 2 * (top_elems + bottom_elems) + 4 * num_attrs;
  if ((int64_t)st.st_size < stride * num_records) { close(fd); return -3; }
  void* mapped = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (mapped == MAP_FAILED) { close(fd); return -4; }
  madvise(mapped, st.st_size, MADV_RANDOM);
  IsiStore* store = new IsiStore{
      static_cast<const uint8_t*>(mapped), (size_t)st.st_size,
      num_records, top_elems, bottom_elems, num_attrs, stride, fd};
  *out = store;
  return 0;
}

int64_t isi_store_num_records(IsiStore* store) {
  return store ? store->num_records : -1;
}

// Gathers records by index, widening int16 codes to int32 (the device
// feed dtype) in one pass.
int isi_store_read_batch(IsiStore* store, const int64_t* indices,
                         int64_t n, int32_t* tops, int32_t* bottoms,
                         int32_t* attrs) {
  if (!store) return -1;
  const int64_t te = store->top_elems, be = store->bottom_elems,
                ae = store->num_attrs;
  for (int64_t i = 0; i < n; ++i) {
    int64_t idx = indices[i];
    if (idx < 0 || idx >= store->num_records) return -1;
    const uint8_t* rec = store->data + idx * store->stride;
    const int16_t* top16 = reinterpret_cast<const int16_t*>(rec);
    const int16_t* bottom16 = reinterpret_cast<const int16_t*>(rec + 2 * te);
    const int32_t* attr32 =
        reinterpret_cast<const int32_t*>(rec + 2 * (te + be));
    int32_t* top_out = tops + i * te;
    int32_t* bottom_out = bottoms + i * be;
    for (int64_t j = 0; j < te; ++j) top_out[j] = top16[j];
    for (int64_t j = 0; j < be; ++j) bottom_out[j] = bottom16[j];
    if (attrs && ae > 0) memcpy(attrs + i * ae, attr32, 4 * ae);
  }
  return 0;
}

void isi_store_close(IsiStore* store) {
  if (!store) return;
  munmap(const_cast<uint8_t*>(store->data), store->file_size);
  close(store->fd);
  delete store;
}

// ---- WAV codec --------------------------------------------------------------

static void put_u32(uint8_t* p, uint32_t v) {
  p[0] = v & 0xff; p[1] = (v >> 8) & 0xff;
  p[2] = (v >> 16) & 0xff; p[3] = (v >> 24) & 0xff;
}
static void put_u16(uint8_t* p, uint16_t v) {
  p[0] = v & 0xff; p[1] = (v >> 8) & 0xff;
}
static uint32_t get_u32(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | ((uint32_t)p[3] << 24);
}
static uint16_t get_u16(const uint8_t* p) { return p[0] | (p[1] << 8); }

// Interleaved float [-1,1] -> PCM16 WAV bytes. Returns byte count
// (call with out=null to size the buffer).
int64_t isi_wav_encode_pcm16(const float* samples, int64_t n_samples,
                             int32_t channels, int32_t sample_rate,
                             uint8_t* out) {
  int64_t payload = n_samples * channels * 2;
  int64_t total = 44 + payload;
  if (!out) return total;
  memcpy(out, "RIFF", 4);
  put_u32(out + 4, (uint32_t)(36 + payload));
  memcpy(out + 8, "WAVE", 4);
  memcpy(out + 12, "fmt ", 4);
  put_u32(out + 16, 16);
  put_u16(out + 20, 1);  // PCM
  put_u16(out + 22, (uint16_t)channels);
  put_u32(out + 24, (uint32_t)sample_rate);
  put_u32(out + 28, (uint32_t)(sample_rate * channels * 2));
  put_u16(out + 32, (uint16_t)(channels * 2));
  put_u16(out + 34, 16);
  memcpy(out + 36, "data", 4);
  put_u32(out + 40, (uint32_t)payload);
  int16_t* dst = reinterpret_cast<int16_t*>(out + 44);
  int64_t total_samples = n_samples * channels;
  for (int64_t i = 0; i < total_samples; ++i) {
    float v = samples[i];
    if (v > 1.0f) v = 1.0f;
    if (v < -1.0f) v = -1.0f;
    dst[i] = (int16_t)lrintf(v * 32767.0f);
  }
  return total;
}

// WAV bytes -> interleaved float. Returns sample count per channel or
// negative errno; pass out=null to query sizes.
int64_t isi_wav_decode(const uint8_t* bytes, int64_t len, float* out,
                       int32_t* channels, int32_t* sample_rate) {
  if (len < 44 || memcmp(bytes, "RIFF", 4) || memcmp(bytes + 8, "WAVE", 4))
    return -1;
  int64_t pos = 12;
  int fmt_code = 0, n_ch = 0, bits = 0;
  int32_t sr = 0;
  const uint8_t* data = nullptr;
  int64_t data_len = 0;
  while (pos + 8 <= len) {
    uint32_t chunk_size = get_u32(bytes + pos + 4);
    int64_t avail = len - pos - 8;  // bytes actually present for this chunk
    if (!memcmp(bytes + pos, "fmt ", 4)) {
      // A PCM fmt chunk is at least 16 bytes; reject truncated/undersized
      // ones instead of reading past the chunk (or the buffer).
      if (chunk_size < 16 || avail < 16) return -2;
      const uint8_t* f = bytes + pos + 8;
      fmt_code = get_u16(f);
      n_ch = get_u16(f + 2);
      sr = (int32_t)get_u32(f + 4);
      bits = get_u16(f + 14);
      if (fmt_code == 0xFFFE) {
        if (chunk_size < 40 || avail < 26) return -2;
        fmt_code = get_u16(f + 24);
      }
    } else if (!memcmp(bytes + pos, "data", 4)) {
      data = bytes + pos + 8;
      data_len = chunk_size;
      if (data_len > avail) data_len = avail;
    }
    pos += 8 + chunk_size + (chunk_size & 1);
    if (data && fmt_code) break;
  }
  if (!data || !n_ch || !bits) return -2;
  int64_t frame_bytes = (int64_t)n_ch * bits / 8;
  if (frame_bytes <= 0) return -2;
  int64_t frames = data_len / frame_bytes;
  *channels = n_ch;
  *sample_rate = sr;
  if (!out) return frames;
  int64_t total = frames * n_ch;
  if (fmt_code == 1 && bits == 16) {
    const int16_t* src = reinterpret_cast<const int16_t*>(data);
    for (int64_t i = 0; i < total; ++i) out[i] = src[i] / 32768.0f;
  } else if (fmt_code == 1 && bits == 32) {
    const int32_t* src = reinterpret_cast<const int32_t*>(data);
    for (int64_t i = 0; i < total; ++i) out[i] = src[i] / 2147483648.0f;
  } else if (fmt_code == 1 && bits == 24) {
    for (int64_t i = 0; i < total; ++i) {
      const uint8_t* p = data + 3 * i;
      int32_t v = p[0] | (p[1] << 8) | (p[2] << 16);
      if (v >= (1 << 23)) v -= (1 << 24);
      out[i] = v / 8388608.0f;
    }
  } else if (fmt_code == 3 && bits == 32) {
    memcpy(out, data, total * 4);
  } else {
    return -3;
  }
  return frames;
}

}  // extern "C"
