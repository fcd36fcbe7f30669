// Native data-IO runtime of the port's input pipeline: a copy of
// compare_gan_tpu/native/dataio.cc, so the port builds its own, plus PNG
// unfiltering and the CRC32C of TensorFlow's file formats.
//
// TFRecord scanning, indexing and reading, the image crop/resize
// transforms of compare_gan_torch/datasets.py, PNG scanline unfiltering and
// CRC32C (TFRecord framing, checkpoint bundles), compiled -O3 so the input
// pipeline needs no TensorFlow runtime. Plain C ABI, loaded with ctypes by
// compare_gan_torch/native.py, which builds it with g++ at first use into
// compare_gan_torch/_build/.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <vector>
#if defined(__SSE4_2__)
#include <nmmintrin.h>
#endif

extern "C" {

// --------------------------------------------------------------------------
// CRC32C (Castagnoli, reflected polynomial 0x82F63B78), the checksum of
// TFRecord framing and of checkpoint bundles. `crc` is the running value
// (0 to start); the SSE4.2 instruction when the build targets it, else
// slicing-by-8 tables.
// --------------------------------------------------------------------------

static uint32_t kCrcTable[8][256];

static bool init_crc_table() {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
    kCrcTable[0][i] = c;
  }
  for (uint32_t i = 0; i < 256; ++i)
    for (int t = 1; t < 8; ++t)
      kCrcTable[t][i] = (kCrcTable[t - 1][i] >> 8) ^
                        kCrcTable[0][kCrcTable[t - 1][i] & 0xFF];
  return true;
}

static const bool kCrcTableReady = init_crc_table();

uint32_t crc32c_extend(uint32_t crc, const uint8_t* data, int64_t n) {
  uint32_t c = ~crc;
#if defined(__SSE4_2__)
  uint64_t c64 = c;
  for (; n >= 8; n -= 8, data += 8) {
    uint64_t word;
    std::memcpy(&word, data, 8);
    c64 = _mm_crc32_u64(c64, word);
  }
  c = static_cast<uint32_t>(c64);
  for (; n > 0; --n, ++data) c = _mm_crc32_u8(c, *data);
#else
  for (; n >= 8; n -= 8, data += 8) {
    uint32_t lo, hi;
    std::memcpy(&lo, data, 4);
    std::memcpy(&hi, data + 4, 4);
    lo ^= c;
    c = kCrcTable[7][lo & 0xFF] ^ kCrcTable[6][(lo >> 8) & 0xFF] ^
        kCrcTable[5][(lo >> 16) & 0xFF] ^ kCrcTable[4][lo >> 24] ^
        kCrcTable[3][hi & 0xFF] ^ kCrcTable[2][(hi >> 8) & 0xFF] ^
        kCrcTable[1][(hi >> 16) & 0xFF] ^ kCrcTable[0][hi >> 24];
  }
  for (; n > 0; --n, ++data) c = (c >> 8) ^ kCrcTable[0][(c ^ *data) & 0xFF];
#endif
  return ~c;
}

// --------------------------------------------------------------------------
// TFRecord format: [len:u64le][crc(len):u32][payload][crc(payload):u32]
// --------------------------------------------------------------------------

// Sanity bound on one record: a corrupt u64 length with high bits set
// would otherwise cast to a negative seek (backwards -> infinite loop)
// or walk past EOF counting garbage.
static const uint64_t kMaxRecordBytes = 1ull << 31;  // 2 GB

static bool record_fits(FILE* f, uint64_t len, long file_size) {
  if (len > kMaxRecordBytes) return false;
  long pos = std::ftell(f);
  if (pos < 0) return false;
  // pos is just past the length header; the length crc (4), payload,
  // and payload crc (4) must fit in the remaining bytes.
  return static_cast<uint64_t>(file_size - pos) >= len + 8;
}

static long file_size_of(FILE* f) {
  long cur = std::ftell(f);
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, cur, SEEK_SET);
  return size;
}

// Number of records in the file, or -1 on error. Truncated or corrupt
// trailing records are not counted.
int64_t tfrecord_count(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  const long size = file_size_of(f);
  int64_t count = 0;
  uint64_t len;
  while (std::fread(&len, 8, 1, f) == 1) {
    if (!record_fits(f, len, size)) break;
    if (std::fseek(f, static_cast<long>(len) + 8, SEEK_CUR) != 0) break;
    ++count;
  }
  std::fclose(f);
  return count;
}

// Write up to `max` byte offsets (of the length header) into `offsets`.
// Returns the number written, or -1 on error.
int64_t tfrecord_index(const char* path, int64_t* offsets, int64_t max) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  const long size = file_size_of(f);
  int64_t count = 0;
  uint64_t len;
  while (count < max) {
    long pos = std::ftell(f);
    if (std::fread(&len, 8, 1, f) != 1) break;
    if (!record_fits(f, len, size)) break;  // Truncated/corrupt tail.
    offsets[count++] = pos;
    if (std::fseek(f, static_cast<long>(len) + 8, SEEK_CUR) != 0) break;
  }
  std::fclose(f);
  return count;
}

// Read the payload of the record at `offset` into buf (size buf_size).
// Returns payload size; -1 on IO error (missing file, bad offset,
// truncated record); -2 when the record is larger than buf_size (the
// Python side grows its scratch buffer and retries ONLY on -2, so IO
// errors surface immediately instead of after futile reallocations).
int64_t tfrecord_read(const char* path, int64_t offset, uint8_t* buf,
                      int64_t buf_size) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  if (std::fseek(f, static_cast<long>(offset), SEEK_SET) != 0) {
    std::fclose(f);
    return -1;
  }
  uint64_t len;
  if (std::fread(&len, 8, 1, f) != 1) {
    std::fclose(f);
    return -1;
  }
  if (static_cast<int64_t>(len) > buf_size) {
    std::fclose(f);
    return -2;
  }
  std::fseek(f, 4, SEEK_CUR);  // length crc
  int64_t got = static_cast<int64_t>(std::fread(buf, 1, len, f));
  std::fclose(f);
  return got == static_cast<int64_t>(len) ? got : -1;
}

// --------------------------------------------------------------------------
// Image transforms (float32 HWC). Box-filter ("area") resize — matches the
// PIL.Image.BOX semantics of the Python fallback (datasets.py:_resize_area).
// --------------------------------------------------------------------------

static inline void box_resize(const float* src, int64_t sh, int64_t sw,
                              int64_t c, float* dst, int64_t dh,
                              int64_t dw) {
  const double sy = static_cast<double>(sh) / dh;
  const double sx = static_cast<double>(sw) / dw;
  std::vector<double> acc(c);
  for (int64_t oy = 0; oy < dh; ++oy) {
    const double y0 = oy * sy, y1 = (oy + 1) * sy;
    const int64_t iy0 = static_cast<int64_t>(y0);
    const int64_t iy1 = std::min<int64_t>(sh, static_cast<int64_t>(
        std::max(y1 - 1e-9, y0)) + 1);
    for (int64_t ox = 0; ox < dw; ++ox) {
      const double x0 = ox * sx, x1 = (ox + 1) * sx;
      const int64_t ix0 = static_cast<int64_t>(x0);
      const int64_t ix1 = std::min<int64_t>(sw, static_cast<int64_t>(
          std::max(x1 - 1e-9, x0)) + 1);
      std::fill(acc.begin(), acc.end(), 0.0);
      double total_w = 0.0;
      for (int64_t iy = iy0; iy < iy1; ++iy) {
        const double wy = std::min<double>(iy + 1, y1) -
                          std::max<double>(iy, y0);
        for (int64_t ix = ix0; ix < ix1; ++ix) {
          const double wx = std::min<double>(ix + 1, x1) -
                            std::max<double>(ix, x0);
          const double w = wy * wx;
          const float* p = src + (iy * sw + ix) * c;
          for (int64_t k = 0; k < c; ++k) acc[k] += w * p[k];
          total_w += w;
        }
      }
      float* q = dst + (oy * dw + ox) * c;
      const double inv = total_w > 0 ? 1.0 / total_w : 0.0;
      for (int64_t k = 0; k < c; ++k)
        q[k] = static_cast<float>(acc[k] * inv);
    }
  }
}

void resize_area_f32(const float* src, int64_t sh, int64_t sw, int64_t c,
                     float* dst, int64_t dh, int64_t dw) {
  box_resize(src, sh, sw, c, dst, dh, dw);
}

// TF1 `tf.image.resize_images` default bilinear (align_corners=false,
// legacy scaling: src = dst_idx * in/out) — the resize the reference
// applies after every crop (compare_gan/datasets.py:474-476).
void resize_bilinear_f32(const float* src, int64_t sh, int64_t sw, int64_t c,
                         float* dst, int64_t dh, int64_t dw) {
  const float sy = static_cast<float>(sh) / dh;
  const float sx = static_cast<float>(sw) / dw;
  for (int64_t oy = 0; oy < dh; ++oy) {
    const float fy = oy * sy;
    const int64_t y0 = static_cast<int64_t>(fy);
    const int64_t y1 = std::min(y0 + 1, sh - 1);
    const float wy = fy - y0;
    for (int64_t ox = 0; ox < dw; ++ox) {
      const float fx = ox * sx;
      const int64_t x0 = static_cast<int64_t>(fx);
      const int64_t x1 = std::min(x0 + 1, sw - 1);
      const float wx = fx - x0;
      const float* p00 = src + (y0 * sw + x0) * c;
      const float* p01 = src + (y0 * sw + x1) * c;
      const float* p10 = src + (y1 * sw + x0) * c;
      const float* p11 = src + (y1 * sw + x1) * c;
      float* q = dst + (oy * dw + ox) * c;
      for (int64_t k = 0; k < c; ++k) {
        const float top = p00[k] + (p01[k] - p00[k]) * wx;
        const float bot = p10[k] + (p11[k] - p10[k]) * wx;
        q[k] = top + (bot - top) * wy;
      }
    }
  }
}

// Crop [top:top+ch, left:left+cw] then area-resize to (dh, dw).
void crop_resize_f32(const float* src, int64_t sh, int64_t sw, int64_t c,
                     int64_t top, int64_t left, int64_t ch, int64_t cw,
                     float* dst, int64_t dh, int64_t dw) {
  std::vector<float> crop(static_cast<size_t>(ch) * cw * c);
  for (int64_t y = 0; y < ch; ++y) {
    std::memcpy(crop.data() + y * cw * c,
                src + ((top + y) * sw + left) * c,
                sizeof(float) * cw * c);
  }
  box_resize(crop.data(), ch, cw, c, dst, dh, dw);
}

// Fused crop + TF1-legacy bilinear resize: reads the source in place (no
// intermediate crop copy) — the hot path of every ImageNet train example.
void crop_resize_bilinear_f32(const float* src, int64_t sh, int64_t sw,
                              int64_t c, int64_t top, int64_t left,
                              int64_t ch, int64_t cw, float* dst,
                              int64_t dh, int64_t dw) {
  const float sy = static_cast<float>(ch) / dh;
  const float sx = static_cast<float>(cw) / dw;
  for (int64_t oy = 0; oy < dh; ++oy) {
    const float fy = oy * sy;
    const int64_t y0 = top + std::min(static_cast<int64_t>(fy), ch - 1);
    const int64_t y1 = std::min(y0 + 1, top + ch - 1);
    const float wy = fy - static_cast<int64_t>(fy);
    for (int64_t ox = 0; ox < dw; ++ox) {
      const float fx = ox * sx;
      const int64_t x0 = left + std::min(static_cast<int64_t>(fx), cw - 1);
      const int64_t x1 = std::min(x0 + 1, left + cw - 1);
      const float wx = fx - static_cast<int64_t>(fx);
      const float* p00 = src + (y0 * sw + x0) * c;
      const float* p01 = src + (y0 * sw + x1) * c;
      const float* p10 = src + (y1 * sw + x0) * c;
      const float* p11 = src + (y1 * sw + x1) * c;
      float* q = dst + (oy * dw + ox) * c;
      for (int64_t k = 0; k < c; ++k) {
        const float t = p00[k] + (p01[k] - p00[k]) * wx;
        const float b = p10[k] + (p11[k] - p10[k]) * wx;
        q[k] = t + (b - t) * wy;
      }
    }
  }
}

// PNG scanline unfiltering: `raw` holds `rows` lines of 1 + `stride`
// bytes (filter type, then the filtered bytes), `bpp` bytes per complete
// pixel; writes rows * stride bytes to `out`. Returns 0, or -1 for a bad
// filter type. The Python loop of compare_gan_torch/tf_io/image_codec.py
// is the fallback (and the reference the tests hold this to).
int64_t png_unfilter(const uint8_t* raw, int64_t rows, int64_t stride,
                     int64_t bpp, uint8_t* out) {
  for (int64_t r = 0; r < rows; ++r) {
    const uint8_t* in = raw + r * (stride + 1);
    const int kind = in[0];
    ++in;
    uint8_t* cur = out + r * stride;
    const uint8_t* prev = r ? out + (r - 1) * stride : nullptr;
    for (int64_t i = 0; i < stride; ++i) {
      const int a = i >= bpp ? cur[i - bpp] : 0;
      const int b = prev ? prev[i] : 0;
      const int c = prev && i >= bpp ? prev[i - bpp] : 0;
      int pred;
      switch (kind) {
        case 0: pred = 0; break;
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: {
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b),
                    pc = std::abs(p - c);
          pred = pa <= pb && pa <= pc ? a : (pb <= pc ? b : c);
          break;
        }
        default: return -1;
      }
      cur[i] = static_cast<uint8_t>(in[i] + pred);
    }
  }
  return 0;
}

// uint8 HWC -> float32 [0,1] (decode post-processing fast path).
void u8_to_f32_scaled(const uint8_t* src, int64_t n, float* dst) {
  constexpr float kInv = 1.0f / 255.0f;
  for (int64_t i = 0; i < n; ++i) dst[i] = src[i] * kInv;
}

}  // extern "C"
