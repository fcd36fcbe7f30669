// JPEG decoder of the port's input pipeline: returns what
// `tf.io.decode_image` returns for a JPEG, without TensorFlow or libjpeg.
//
// TensorFlow decodes with libjpeg(-turbo) at its defaults: the fast integer
// IDCT (JDCT_IFAST, jidctfst.c), fancy (triangle) upsampling of subsampled
// chroma (jdsample.c) and the fixed-point YCbCr -> RGB tables of jdcolor.c.
// This file follows those three pieces step for step, so that its pixels
// equal TensorFlow's; entropy decoding is exact by the standard.
//
// Handles: baseline and extended sequential (SOF0/SOF1) and progressive
// (SOF2) Huffman coding, 8-bit samples, 1 (grayscale) or 3 (YCbCr, or RGB
// per the Adobe marker / component ids) components, sampling factors up to
// 2x2 per component (other integer ratios by replication, as libjpeg),
// restart intervals, interleaved and non-interleaved scans. APPn and COM
// segments are skipped (APP0 JFIF and APP14 Adobe are read for the color
// space). Refused with an error: arithmetic coding, lossless and
// hierarchical frames, 12-bit samples, 2 or 4 components (CMYK).
//
// Plain C ABI for ctypes (compare_gan_torch/native.py builds it with g++
// into the same library as dataio.cc). No global mutable state: every call
// decodes into its own buffers, so threads may call it at once.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

// Zigzag index -> natural (row-major) index; 16 extra entries absorb a
// corrupt run that steps past 63 (as libjpeg's jpeg_natural_order does).
const int kNaturalOrder[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// jddctmgr.c: the AAN scale factors of the fast IDCT, scaled by 2^14.
const int kAanScales[64] = {
    16384, 22725, 21407, 19266, 16384, 12873, 8867,  4520,
    22725, 31521, 29692, 26722, 22725, 17855, 12299, 6270,
    21407, 29692, 27969, 25172, 21407, 16819, 11585, 5906,
    19266, 26722, 25172, 22654, 19266, 15137, 10426, 5315,
    16384, 22725, 21407, 19266, 16384, 12873, 8867,  4520,
    12873, 17855, 16819, 15137, 12873, 10114, 6967,  3552,
    8867,  12299, 11585, 10426, 8867,  6967,  4799,  2446,
    4520,  6270,  5906,  5315,  4520,  3552,  2446,  1247};

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

struct HuffTable {
  bool defined = false;
  uint8_t values[256] = {0};
  int32_t maxcode[18] = {0};   // largest code of each length, -1 if none
  int32_t valoffset[18] = {0};
  uint16_t lookup[1 << 9] = {0};  // (length << 8 | value) for codes <= 9 bits

  void build(const uint8_t counts[16], const uint8_t* vals, int n) {
    std::memcpy(values, vals, n);
    std::memset(lookup, 0, sizeof(lookup));
    int32_t code = 0, k = 0;
    for (int len = 1; len <= 16; ++len) {
      valoffset[len] = k - code;
      if (counts[len - 1]) {
        for (int i = 0; i < counts[len - 1]; ++i, ++k, ++code) {
          if (len <= 9) {
            const int shift = 9 - len;
            for (int j = 0; j < (1 << shift); ++j)
              lookup[(code << shift) | j] =
                  static_cast<uint16_t>(len << 8 | vals[k]);
          }
        }
        maxcode[len] = code - 1;
      } else {
        maxcode[len] = -1;
      }
      if (code > (1 << len)) throw Error("bad Huffman table");
      code <<= 1;
    }
    maxcode[17] = 0x7FFFFFFF;
    defined = true;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dc_table = 0, ac_table = 0;
  int down_w = 0, down_h = 0;      // downsampled size in samples
  int blocks_w = 0, blocks_h = 0;  // allocated blocks (whole MCUs)
  int scan_blocks_w = 0, scan_blocks_h = 0;  // blocks of a lone scan
  int pred = 0;                    // DC predictor
  bool quant_latched = false;
  int16_t quant_mult[64] = {0};    // IFAST multipliers, natural order
  std::vector<int16_t> coefs;      // blocks_w * blocks_h * 64, natural
};

class BitReader {
 public:
  BitReader(const uint8_t* p, const uint8_t* end) : p_(p), end_(end) {}

  int get_bits(int n) {
    if (n == 0) return 0;
    fill(n);
    const int v = static_cast<int>((buf_ >> (64 - n)) & ((1u << n) - 1));
    buf_ <<= n;
    bits_ -= n;
    return v;
  }

  int decode(const HuffTable& t) {
    fill(16);
    const int peek = static_cast<int>(buf_ >> (64 - 9));
    const int entry = t.lookup[peek];
    if (entry) {
      const int len = entry >> 8;
      buf_ <<= len;
      bits_ -= len;
      return entry & 0xFF;
    }
    int len = 10;
    int32_t code = static_cast<int32_t>(buf_ >> (64 - len));
    while (code > t.maxcode[len]) {
      ++len;
      if (len > 16) throw Error("corrupt Huffman code");
      code = static_cast<int32_t>(buf_ >> (64 - len));
    }
    buf_ <<= len;
    bits_ -= len;
    return t.values[(code + t.valoffset[len]) & 0xFF];
  }

  // Drops the bits left in the buffer; the reader then stands at the
  // marker that ended the entropy-coded data.
  void reset() {
    buf_ = 0;
    bits_ = 0;
    at_marker_ = false;
  }

  // The position of the next marker (0xFF followed by a non-zero, non-0xFF
  // byte) at or after the bytes consumed so far.
  const uint8_t* marker_position() const {
    const uint8_t* q = p_;
    while (q + 1 < end_ && !(q[0] == 0xFF && q[1] != 0x00 && q[1] != 0xFF))
      ++q;
    return q;
  }

  void seek(const uint8_t* p) {
    p_ = p;
    reset();
  }

 private:
  void fill(int need) {
    while (bits_ < need) {
      uint32_t byte = 0;
      if (!at_marker_ && p_ < end_) {
        byte = *p_;
        if (byte == 0xFF) {
          const uint8_t* q = p_ + 1;
          while (q < end_ && *q == 0xFF) ++q;  // fill bytes
          if (q < end_ && *q == 0x00) {
            p_ = q + 1;  // stuffed 0xFF
          } else {
            at_marker_ = true;  // a marker: feed zeros from here (libjpeg)
            byte = 0;
          }
        } else {
          ++p_;
        }
      }
      buf_ |= static_cast<uint64_t>(byte) << (56 - bits_);
      bits_ += 8;
    }
  }

  const uint8_t* p_;
  const uint8_t* end_;
  uint64_t buf_ = 0;
  int bits_ = 0;
  bool at_marker_ = false;
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

inline uint8_t clamp255(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// jidctfst.c: the AAN fast integer IDCT with 8-bit constants and no
// rounding (DESCALE is a plain arithmetic shift there). Writes 8x8 samples.
void idct_ifast(const int16_t* coef, const int16_t* qmult, uint8_t* out,
                int stride) {
  const int kFix1082 = 277, kFix1414 = 362, kFix1847 = 473, kFix2613 = 669;
  auto mul = [](int v, int c) { return (v * c) >> 8; };
  int ws[64];
  for (int col = 0; col < 8; ++col) {
    const int16_t* in = coef + col;
    const int16_t* q = qmult + col;
    int* w = ws + col;
    if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] &&
        !in[56]) {
      const int dc = in[0] * q[0];
      for (int r = 0; r < 8; ++r) w[8 * r] = dc;
      continue;
    }
    int tmp0 = in[0] * q[0], tmp1 = in[16] * q[16];
    int tmp2 = in[32] * q[32], tmp3 = in[48] * q[48];
    int tmp10 = tmp0 + tmp2, tmp11 = tmp0 - tmp2;
    int tmp13 = tmp1 + tmp3;
    int tmp12 = mul(tmp1 - tmp3, kFix1414) - tmp13;
    tmp0 = tmp10 + tmp13;
    tmp3 = tmp10 - tmp13;
    tmp1 = tmp11 + tmp12;
    tmp2 = tmp11 - tmp12;
    int tmp4 = in[8] * q[8], tmp5 = in[24] * q[24];
    int tmp6 = in[40] * q[40], tmp7 = in[56] * q[56];
    const int z13 = tmp6 + tmp5, z10 = tmp6 - tmp5;
    const int z11 = tmp4 + tmp7, z12 = tmp4 - tmp7;
    tmp7 = z11 + z13;
    tmp11 = mul(z11 - z13, kFix1414);
    const int z5 = mul(z10 + z12, kFix1847);
    tmp10 = mul(z12, kFix1082) - z5;
    tmp12 = mul(z10, -kFix2613) + z5;
    tmp6 = tmp12 - tmp7;
    tmp5 = tmp11 - tmp6;
    tmp4 = tmp10 + tmp5;
    w[0] = tmp0 + tmp7;
    w[56] = tmp0 - tmp7;
    w[8] = tmp1 + tmp6;
    w[48] = tmp1 - tmp6;
    w[16] = tmp2 + tmp5;
    w[40] = tmp2 - tmp5;
    w[32] = tmp3 + tmp4;
    w[24] = tmp3 - tmp4;
  }
  // Rows: descale by PASS1_BITS + 3 = 5 and add the centre 128.
  for (int row = 0; row < 8; ++row) {
    const int* w = ws + 8 * row;
    uint8_t* o = out + row * stride;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      const uint8_t dc = clamp255((w[0] >> 5) + 128);
      for (int c = 0; c < 8; ++c) o[c] = dc;
      continue;
    }
    int tmp10 = w[0] + w[4], tmp11 = w[0] - w[4];
    int tmp13 = w[2] + w[6];
    int tmp12 = mul(w[2] - w[6], kFix1414) - tmp13;
    const int tmp0 = tmp10 + tmp13, tmp3 = tmp10 - tmp13;
    const int tmp1 = tmp11 + tmp12, tmp2 = tmp11 - tmp12;
    const int z13 = w[5] + w[3], z10 = w[5] - w[3];
    const int z11 = w[1] + w[7], z12 = w[1] - w[7];
    const int tmp7 = z11 + z13;
    tmp11 = mul(z11 - z13, kFix1414);
    const int z5 = mul(z10 + z12, kFix1847);
    tmp10 = mul(z12, kFix1082) - z5;
    tmp12 = mul(z10, -kFix2613) + z5;
    const int tmp6 = tmp12 - tmp7;
    const int tmp5 = tmp11 - tmp6;
    const int tmp4 = tmp10 + tmp5;
    o[0] = clamp255(((tmp0 + tmp7) >> 5) + 128);
    o[7] = clamp255(((tmp0 - tmp7) >> 5) + 128);
    o[1] = clamp255(((tmp1 + tmp6) >> 5) + 128);
    o[6] = clamp255(((tmp1 - tmp6) >> 5) + 128);
    o[2] = clamp255(((tmp2 + tmp5) >> 5) + 128);
    o[5] = clamp255(((tmp2 - tmp5) >> 5) + 128);
    o[4] = clamp255(((tmp3 + tmp4) >> 5) + 128);
    o[3] = clamp255(((tmp3 - tmp4) >> 5) + 128);
  }
}

// A component's samples after the IDCT: `stride` = blocks_w * 8.
struct Plane {
  std::vector<uint8_t> data;
  int stride = 0;
  const uint8_t* row(int r) const { return data.data() + r * stride; }
};

class Decoder {
 public:
  Decoder(const uint8_t* data, int64_t size)
      : data_(data), end_(data + size) {}

  // Reads the segments up to the first scan (or all of the file).
  void read(bool headers_only) {
    const uint8_t* p = data_;
    if (end_ - p < 2 || p[0] != 0xFF || p[1] != 0xD8)
      throw Error("not a JPEG (no SOI marker)");
    p += 2;
    while (true) {
      while (p < end_ && *p != 0xFF) ++p;  // garbage between segments
      while (p < end_ && *p == 0xFF) ++p;  // fill bytes
      if (p >= end_) {
        if (seen_scan_) return;  // No EOI: decode what arrived, as libjpeg.
        throw Error("truncated JPEG (no scan)");
      }
      const int marker = *p++;
      if (marker == 0xD9) {  // EOI
        if (!seen_scan_) throw Error("JPEG has no scan");
        return;
      }
      if (marker >= 0xD0 && marker <= 0xD7) continue;  // stray RSTn
      if (end_ - p < 2) throw Error("truncated JPEG segment");
      const int len = p[0] << 8 | p[1];
      if (len < 2 || p + len > end_) throw Error("truncated JPEG segment");
      const uint8_t* seg = p + 2;
      const int n = len - 2;
      p += len;
      switch (marker) {
        case 0xC0: case 0xC1: case 0xC2:
          read_sof(seg, n, marker == 0xC2);
          if (headers_only) return;
          break;
        case 0xC3: throw Error("lossless JPEG is not supported");
        case 0xC5: case 0xC6: case 0xC7:
          throw Error("hierarchical JPEG is not supported");
        case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
        case 0xCC:
          throw Error("arithmetic-coded JPEG is not supported");
        case 0xC4: read_dht(seg, n); break;
        case 0xDB: read_dqt(seg, n); break;
        case 0xDD:
          if (n < 2) throw Error("bad DRI segment");
          restart_interval_ = seg[0] << 8 | seg[1];
          break;
        case 0xDA:
          if (!frame_) throw Error("JPEG scan before its frame header");
          p = read_scan(seg, n, p);
          seen_scan_ = true;
          break;
        case 0xE0:
          if (n >= 5 && !std::memcmp(seg, "JFIF\0", 5)) saw_jfif_ = true;
          break;
        case 0xEE:
          if (n >= 12 && !std::memcmp(seg, "Adobe", 5)) {
            saw_adobe_ = true;
            adobe_transform_ = seg[11];
          }
          break;
        default:
          break;  // APPn, COM, DNL and the rest: skipped.
      }
    }
  }

  int height() const { return height_; }
  int width() const { return width_; }
  int channels() const { return static_cast<int>(comps_.size()); }

  void output(uint8_t* out) {
    std::vector<Plane> planes(comps_.size());
    for (size_t c = 0; c < comps_.size(); ++c) planes[c] = idct(comps_[c]);
    if (comps_.size() == 1) {
      upsample(comps_[0], planes[0], out, 1, 0);
      return;
    }
    std::vector<uint8_t> full(static_cast<size_t>(height_) * width_ * 3);
    for (int c = 0; c < 3; ++c)
      upsample(comps_[c], planes[c], full.data(), 3, c);
    if (!is_ycc()) {
      std::memcpy(out, full.data(), full.size());
      return;
    }
    // jdcolor.c: R = Y + 1.402 Cr, G = Y - 0.34414 Cb - 0.71414 Cr,
    // B = Y + 1.772 Cb in 16-bit fixed point, tables rounded as there.
    int cr_r[256], cb_b[256];
    int32_t cr_g[256], cb_g[256];
    const int kOneHalf = 1 << 15;
    auto fix = [](double x) {
      return static_cast<int32_t>(x * 65536.0 + 0.5);
    };
    for (int i = 0; i < 256; ++i) {
      const int x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + kOneHalf) >> 16);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + kOneHalf) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kOneHalf;
    }
    const size_t n = static_cast<size_t>(height_) * width_;
    for (size_t i = 0; i < n; ++i) {
      const int y = full[3 * i], cb = full[3 * i + 1], cr = full[3 * i + 2];
      out[3 * i] = clamp255(y + cr_r[cr]);
      out[3 * i + 1] = clamp255(y + ((cb_g[cb] + cr_g[cr]) >> 16));
      out[3 * i + 2] = clamp255(y + cb_b[cb]);
    }
  }

 private:
  bool is_ycc() const {
    if (saw_jfif_) return true;
    if (saw_adobe_) return adobe_transform_ != 0;
    const bool rgb_ids = comps_[0].id == 'R' && comps_[1].id == 'G' &&
                         comps_[2].id == 'B';
    return !rgb_ids;
  }

  void read_sof(const uint8_t* s, int n, bool progressive) {
    if (frame_) throw Error("JPEG has two frame headers");
    if (n < 6) throw Error("bad SOF segment");
    if (s[0] != 8)
      throw Error(std::to_string(s[0]) +
                  "-bit JPEG samples are not supported (8-bit only)");
    height_ = s[1] << 8 | s[2];
    width_ = s[3] << 8 | s[4];
    const int nc = s[5];
    if (height_ == 0) throw Error("JPEG height in a DNL marker: unsupported");
    if (width_ == 0) throw Error("JPEG width is 0");
    if (nc != 1 && nc != 3)
      throw Error(std::to_string(nc) +
                  "-component JPEG is not supported (1 or 3; CMYK is not)");
    if (n < 6 + 3 * nc) throw Error("bad SOF segment");
    progressive_ = progressive;
    comps_.resize(nc);
    for (int i = 0; i < nc; ++i) {
      Component& c = comps_[i];
      c.id = s[6 + 3 * i];
      c.h = s[7 + 3 * i] >> 4;
      c.v = s[7 + 3 * i] & 15;
      c.tq = s[8 + 3 * i] & 3;
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4)
        throw Error("bad JPEG sampling factors");
      hmax_ = std::max(hmax_, c.h);
      vmax_ = std::max(vmax_, c.v);
    }
    mcus_x_ = (width_ + 8 * hmax_ - 1) / (8 * hmax_);
    mcus_y_ = (height_ + 8 * vmax_ - 1) / (8 * vmax_);
    for (Component& c : comps_) {
      if (hmax_ % c.h || vmax_ % c.v)
        throw Error("JPEG sampling factors of non-integral ratio");
      c.down_w = (width_ * c.h + hmax_ - 1) / hmax_;
      c.down_h = (height_ * c.v + vmax_ - 1) / vmax_;
      c.scan_blocks_w = (c.down_w + 7) / 8;
      c.scan_blocks_h = (c.down_h + 7) / 8;
      c.blocks_w = mcus_x_ * c.h;
      c.blocks_h = mcus_y_ * c.v;
      c.coefs.assign(static_cast<size_t>(c.blocks_w) * c.blocks_h * 64, 0);
    }
    frame_ = true;
  }

  void read_dht(const uint8_t* s, int n) {
    int pos = 0;
    while (pos < n) {
      if (pos + 17 > n) throw Error("bad DHT segment");
      const int tc = s[pos] >> 4, th = s[pos] & 15;
      if (tc > 1 || th > 3) throw Error("bad DHT table id");
      int total = 0;
      for (int i = 0; i < 16; ++i) total += s[pos + 1 + i];
      if (total > 256 || pos + 17 + total > n) throw Error("bad DHT segment");
      (tc == 0 ? dc_tables_ : ac_tables_)[th].build(s + pos + 1,
                                                   s + pos + 17, total);
      pos += 17 + total;
    }
  }

  void read_dqt(const uint8_t* s, int n) {
    int pos = 0;
    while (pos < n) {
      const int pq = s[pos] >> 4, tq = s[pos] & 15;
      if (tq > 3 || pq > 1) throw Error("bad DQT segment");
      const int size = pq ? 128 : 64;
      if (pos + 1 + size > n) throw Error("bad DQT segment");
      for (int k = 0; k < 64; ++k) {
        const int v = pq ? (s[pos + 1 + 2 * k] << 8 | s[pos + 2 + 2 * k])
                         : s[pos + 1 + k];
        quant_[tq][kNaturalOrder[k]] = static_cast<uint16_t>(v);
      }
      quant_defined_[tq] = true;
      pos += 1 + size;
    }
  }

  // libjpeg latches a component's quantization table when the component
  // first appears in a scan, as IFAST multipliers: q * aanscale >> 12,
  // rounded.
  void latch_quant(Component& c) {
    if (c.quant_latched) return;
    if (!quant_defined_[c.tq]) throw Error("JPEG quantization table missing");
    for (int i = 0; i < 64; ++i) {
      const int32_t prod = static_cast<int32_t>(quant_[c.tq][i]) *
                           kAanScales[i];
      c.quant_mult[i] = static_cast<int16_t>((prod + (1 << 11)) >> 12);
    }
    c.quant_latched = true;
  }

  const uint8_t* read_scan(const uint8_t* s, int n, const uint8_t* data) {
    if (n < 1) throw Error("bad SOS segment");
    const int ns = s[0];
    if (ns < 1 || ns > 4 || n < 4 + 2 * ns) throw Error("bad SOS segment");
    std::vector<Component*> scan;
    for (int i = 0; i < ns; ++i) {
      const int id = s[1 + 2 * i];
      Component* found = nullptr;
      for (Component& c : comps_)
        if (c.id == id) found = &c;
      if (!found) throw Error("JPEG scan names an unknown component");
      found->dc_table = s[2 + 2 * i] >> 4;
      found->ac_table = s[2 + 2 * i] & 15;
      if (found->dc_table > 3 || found->ac_table > 3)
        throw Error("bad JPEG Huffman table id");
      latch_quant(*found);
      scan.push_back(found);
    }
    ss_ = s[1 + 2 * ns];
    se_ = s[2 + 2 * ns];
    ah_ = s[3 + 2 * ns] >> 4;
    al_ = s[3 + 2 * ns] & 15;
    if (progressive_) {
      if (ss_ == 0 ? se_ != 0 : (se_ < ss_ || se_ > 63 || ns != 1))
        throw Error("bad progressive JPEG scan");
    } else if (ss_ != 0 || se_ != 63 || ah_ || al_) {
      ss_ = 0, se_ = 63, ah_ = al_ = 0;  // ignored by sequential decoders
    }
    for (Component* c : scan) {
      c->pred = 0;
      if ((!progressive_ || ss_ == 0) && ah_ == 0 &&
          !dc_tables_[c->dc_table].defined)
        throw Error("JPEG DC Huffman table missing");
      if ((!progressive_ || ss_ > 0) && !ac_tables_[c->ac_table].defined)
        throw Error("JPEG AC Huffman table missing");
    }
    eobrun_ = 0;

    BitReader br(data, end_);
    const bool single = ns == 1;
    const int mx = single ? scan[0]->scan_blocks_w : mcus_x_;
    const int my = single ? scan[0]->scan_blocks_h : mcus_y_;
    const int64_t total = static_cast<int64_t>(mx) * my;
    int64_t todo_restart = restart_interval_;
    for (int64_t m = 0; m < total; ++m) {
      if (restart_interval_ && todo_restart == 0) {
        const uint8_t* q = br.marker_position();
        if (q + 1 < end_ && q[1] >= 0xD0 && q[1] <= 0xD7) q += 2;
        br.seek(q);
        for (Component* c : scan) c->pred = 0;
        eobrun_ = 0;
        todo_restart = restart_interval_;
      }
      const int mcu_y = static_cast<int>(m / mx);
      const int mcu_x = static_cast<int>(m % mx);
      if (single) {
        decode_block(br, *scan[0], block_of(*scan[0], mcu_y, mcu_x));
      } else {
        for (Component* c : scan)
          for (int v = 0; v < c->v; ++v)
            for (int h = 0; h < c->h; ++h)
              decode_block(br, *c, block_of(*c, mcu_y * c->v + v,
                                            mcu_x * c->h + h));
      }
      if (restart_interval_) --todo_restart;
    }
    return br.marker_position();
  }

  int16_t* block_of(Component& c, int by, int bx) {
    return c.coefs.data() + (static_cast<size_t>(by) * c.blocks_w + bx) * 64;
  }

  void decode_block(BitReader& br, Component& c, int16_t* blk) {
    if (!progressive_) {
      const int s = br.decode(dc_tables_[c.dc_table]);
      const int diff = s ? extend(br.get_bits(s), s) : 0;
      c.pred += diff;
      blk[0] = static_cast<int16_t>(c.pred);
      const HuffTable& ac = ac_tables_[c.ac_table];
      for (int k = 1; k < 64; ++k) {
        const int rs = br.decode(ac);
        const int r = rs >> 4, sz = rs & 15;
        if (sz) {
          k += r;
          blk[kNaturalOrder[k]] =
              static_cast<int16_t>(extend(br.get_bits(sz), sz));
        } else if (r == 15) {
          k += 15;
        } else {
          break;
        }
      }
      return;
    }
    if (ss_ == 0) {
      if (ah_ == 0) {
        const int s = br.decode(dc_tables_[c.dc_table]);
        const int diff = s ? extend(br.get_bits(s), s) : 0;
        c.pred += diff;
        blk[0] = static_cast<int16_t>(c.pred * (1 << al_));
      } else if (br.get_bits(1)) {
        blk[0] = static_cast<int16_t>(blk[0] | (1 << al_));
      }
      return;
    }
    const HuffTable& ac = ac_tables_[c.ac_table];
    if (ah_ == 0) {  // AC first pass
      if (eobrun_ > 0) {
        --eobrun_;
        return;
      }
      for (int k = ss_; k <= se_; ++k) {
        const int rs = br.decode(ac);
        const int r = rs >> 4, sz = rs & 15;
        if (sz) {
          k += r;
          blk[kNaturalOrder[k]] = static_cast<int16_t>(
              extend(br.get_bits(sz), sz) * (1 << al_));
        } else if (r == 15) {
          k += 15;
        } else {
          eobrun_ = 1 << r;
          if (r) eobrun_ += br.get_bits(r);
          --eobrun_;
          break;
        }
      }
      return;
    }
    // AC refinement (jdphuff.c decode_mcu_AC_refine).
    const int p1 = 1 << al_, m1 = -1 * (1 << al_);
    int k = ss_;
    if (eobrun_ == 0) {
      for (; k <= se_; ++k) {
        const int rs = br.decode(ac);
        int r = rs >> 4;
        int s = rs & 15;
        if (s) {
          s = br.get_bits(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun_ = 1 << r;
          if (r) eobrun_ += br.get_bits(r);
          break;
        }
        do {
          int16_t* coef = blk + kNaturalOrder[k];
          if (*coef != 0) {
            if (br.get_bits(1) && (*coef & p1) == 0)
              *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1
                                                      : *coef + m1);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= se_);
        if (s) blk[kNaturalOrder[k]] = static_cast<int16_t>(s);
      }
    }
    if (eobrun_ > 0) {
      for (; k <= se_; ++k) {
        int16_t* coef = blk + kNaturalOrder[k];
        if (*coef != 0 && br.get_bits(1) && (*coef & p1) == 0)
          *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1 : *coef + m1);
      }
      --eobrun_;
    }
  }

  Plane idct(const Component& c) const {
    Plane p;
    p.stride = c.blocks_w * 8;
    p.data.assign(static_cast<size_t>(p.stride) * c.blocks_h * 8, 0);
    const int rows = std::min(c.blocks_h, c.scan_blocks_h);
    const int cols = std::min(c.blocks_w, c.scan_blocks_w);
    for (int by = 0; by < rows; ++by)
      for (int bx = 0; bx < cols; ++bx)
        idct_ifast(
            c.coefs.data() + (static_cast<size_t>(by) * c.blocks_w + bx) * 64,
            c.quant_mult, p.data.data() + by * 8 * p.stride + bx * 8,
            p.stride);
    return p;
  }

  // jdsample.c: a component to full size, into channel `ch` of `out`
  // (`nch` channels, height_ x width_). Fancy (triangle) upsampling for
  // 2x1 and 2x2 when the component is wider than 2 samples and for 1x2;
  // replication otherwise. Rows above the first and below the last real
  // row repeat it, as libjpeg's context rows do.
  void upsample(const Component& c, const Plane& p, uint8_t* out, int nch,
                int ch) const {
    const int hx = hmax_ / c.h, vx = vmax_ / c.v;
    const int cw = c.down_w, chh = c.down_h;
    std::vector<uint8_t> row(static_cast<size_t>(cw) * 2 + 2);
    std::vector<int> colsum(cw);
    auto put = [&](int y, const uint8_t* src) {
      if (y >= height_) return;
      uint8_t* o = out + static_cast<size_t>(y) * width_ * nch + ch;
      for (int x = 0; x < width_; ++x) o[x * nch] = src[x];
    };
    if (hx == 1 && vx == 1) {
      for (int y = 0; y < height_; ++y) put(y, p.row(y));
      return;
    }
    const bool fancy_h2 = hx == 2 && cw > 2;
    if (hx == 2 && vx == 2 && fancy_h2) {
      for (int r = 0; r < chh; ++r) {
        for (int v = 0; v < 2; ++v) {
          const uint8_t* in0 = p.row(r);
          const uint8_t* in1 = p.row(v == 0 ? std::max(r - 1, 0)
                                            : std::min(r + 1, chh - 1));
          for (int j = 0; j < cw; ++j) colsum[j] = in0[j] * 3 + in1[j];
          uint8_t* o = row.data();
          int this_sum = colsum[0], next_sum = colsum[1], last_sum;
          *o++ = static_cast<uint8_t>((this_sum * 4 + 8) >> 4);
          *o++ = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
          last_sum = this_sum;
          this_sum = next_sum;
          for (int j = 2; j < cw; ++j) {
            next_sum = colsum[j];
            *o++ = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
            *o++ = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
            last_sum = this_sum;
            this_sum = next_sum;
          }
          *o++ = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
          *o++ = static_cast<uint8_t>((this_sum * 4 + 7) >> 4);
          put(2 * r + v, row.data());
        }
      }
      return;
    }
    if (hx == 2 && vx == 1 && fancy_h2) {
      for (int r = 0; r < chh; ++r) {
        const uint8_t* in = p.row(r);
        uint8_t* o = row.data();
        *o++ = in[0];
        *o++ = static_cast<uint8_t>((in[0] * 3 + in[1] + 2) >> 2);
        for (int j = 1; j < cw - 1; ++j) {
          const int value = in[j] * 3;
          *o++ = static_cast<uint8_t>((value + in[j - 1] + 1) >> 2);
          *o++ = static_cast<uint8_t>((value + in[j + 1] + 2) >> 2);
        }
        *o++ = static_cast<uint8_t>((in[cw - 1] * 3 + in[cw - 2] + 1) >> 2);
        *o++ = in[cw - 1];
        put(r, row.data());
      }
      return;
    }
    if (hx == 1 && vx == 2) {
      for (int r = 0; r < chh; ++r) {
        for (int v = 0; v < 2; ++v) {
          const uint8_t* in0 = p.row(r);
          const uint8_t* in1 = p.row(v == 0 ? std::max(r - 1, 0)
                                            : std::min(r + 1, chh - 1));
          const int bias = v == 0 ? 1 : 2;
          for (int j = 0; j < cw; ++j)
            row[j] = static_cast<uint8_t>((in0[j] * 3 + in1[j] + bias) >> 2);
          put(2 * r + v, row.data());
        }
      }
      return;
    }
    // Replication (int_upsample, and h2v1/h2v2 of components <= 2 wide).
    std::vector<uint8_t> wide(static_cast<size_t>(cw) * hx);
    for (int r = 0; r < chh; ++r) {
      const uint8_t* in = p.row(r);
      for (int j = 0; j < cw; ++j)
        for (int k = 0; k < hx; ++k) wide[j * hx + k] = in[j];
      for (int k = 0; k < vx; ++k) put(r * vx + k, wide.data());
    }
  }

  const uint8_t* data_;
  const uint8_t* end_;
  bool frame_ = false, progressive_ = false, seen_scan_ = false;
  bool saw_jfif_ = false, saw_adobe_ = false;
  int adobe_transform_ = -1;
  int height_ = 0, width_ = 0, hmax_ = 1, vmax_ = 1, mcus_x_ = 0, mcus_y_ = 0;
  int restart_interval_ = 0;
  int ss_ = 0, se_ = 63, ah_ = 0, al_ = 0;
  int eobrun_ = 0;
  std::vector<Component> comps_;
  HuffTable dc_tables_[4], ac_tables_[4];
  uint16_t quant_[4][64] = {{0}};
  bool quant_defined_[4] = {false, false, false, false};
};

void set_error(const char* msg, char* err, int64_t err_len) {
  if (err && err_len > 0) {
    std::strncpy(err, msg, static_cast<size_t>(err_len - 1));
    err[err_len - 1] = '\0';
  }
}

}  // namespace

extern "C" {

// Height, width and channels (1 or 3) of a JPEG into dims[0..2]. Returns 0,
// or -1 with a message in `err`.
int jpeg_header(const uint8_t* data, int64_t size, int64_t* dims, char* err,
                int64_t err_len) {
  try {
    Decoder d(data, size);
    d.read(/*headers_only=*/true);
    if (d.channels() == 0) throw Error("JPEG has no frame header");
    dims[0] = d.height();
    dims[1] = d.width();
    dims[2] = d.channels();
    return 0;
  } catch (const std::exception& e) {
    set_error(e.what(), err, err_len);
    return -1;
  } catch (...) {
    set_error("JPEG decode failed", err, err_len);
    return -1;
  }
}

// Decodes a JPEG into `out` (height * width * channels bytes, HWC). Returns
// 0, or -1 with a message in `err`.
int jpeg_decode(const uint8_t* data, int64_t size, uint8_t* out,
                int64_t out_size, char* err, int64_t err_len) {
  try {
    Decoder d(data, size);
    d.read(/*headers_only=*/false);
    const int64_t need =
        static_cast<int64_t>(d.height()) * d.width() * d.channels();
    if (need > out_size) throw Error("JPEG output buffer too small");
    d.output(out);
    return 0;
  } catch (const std::exception& e) {
    set_error(e.what(), err, err_len);
    return -1;
  } catch (...) {
    set_error("JPEG decode failed", err, err_len);
    return -1;
  }
}

}  // extern "C"
