// image_decode: host decoders behind the port's image reader
// (zebrapose_tpu_torch/data/jpeg.py and data/tiff.py), in place of the
// cv2.imread that the JAX package reads frames with.
//
// JPEG: baseline and extended-sequential Huffman, 8-bit, 1 or 3
// components, decoded to exactly what cv2.imread (libjpeg-turbo, default
// settings) returns. It follows libjpeg's defaults step by step:
//   * entropy decoding as jdhuff.c: canonical codes, a bad code gives 0
//     after 17 bits, data that runs out (a marker or the end of the file)
//     reads as zero bits and leaves the rest of the segment's blocks zero,
//     restart markers resynchronised as jpeg_resync_to_restart does,
//     missing tables 0/1 replaced by the standard ones (jstdhuff.c);
//   * the accurate integer IDCT (jidctint.c, JDCT_ISLOW) with its
//     range-limit table;
//   * fancy (triangle-filter) upsampling (jdsample.c): h2v1 and h2v2 when
//     the downsampled width exceeds 2, h1v2 always; other integral
//     factors by replication;
//   * YCbCr -> RGB in 16-bit fixed point (jdcolor.c), RGB -> gray as
//     rgb_gray_convert; gray output of a YCbCr file is its Y plane.
// Progressive, arithmetic-coded, lossless, hierarchical and 12-bit files,
// and 4-component (CMYK / YCCK) files, are refused with their own codes.
//
// TIFF: the LZW (new style, MSB-first, early change) and PackBits strip
// codecs; the container is parsed in numpy (data/tiff.py).
//
// Plain C interface, consumed via ctypes; built by ops/_build.py's
// host-C++ route (c++ -O3 -std=c++17, no fast math).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// status codes shared with data/jpeg.py
enum {
  ZD_OK = 0,
  ZD_MALFORMED = 1,
  ZD_PROGRESSIVE = 2,
  ZD_ARITHMETIC = 3,
  ZD_LOSSLESS = 4,
  ZD_PRECISION = 5,
  ZD_CMYK = 6,
  ZD_HIERARCHICAL = 7,
  ZD_SAMPLING = 8,
  ZD_COMPONENTS = 9,
};

const int kNaturalOrder[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// The standard Huffman tables (ITU-T T.81 K.3), jstdhuff.c.
const uint8_t kDcLumBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0,
                                0, 0, 0};
const uint8_t kDcLumVal[] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kDcChromBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0,
                                  0, 0, 0, 0};
const uint8_t kDcChromVal[] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4,
                                0, 0, 1, 0x7d};
const uint8_t kAcLumVal[] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4,
                                  0, 1, 2, 0x77};
const uint8_t kAcChromVal[] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct HuffTable {
  bool present = false;
  uint8_t bits[17] = {0};  // bits[l]: codes of length l
  uint8_t val[256] = {0};
  // derived (jpeg_make_d_derived_tbl)
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint16_t lookup[1 << 9];  // (length << 8) | symbol; 0 = longer code
};

void set_table(HuffTable& t, const uint8_t* bits, const uint8_t* val) {
  int count = 0;
  for (int l = 1; l <= 16; ++l) count += bits[l];
  std::memcpy(t.bits, bits, 17);
  std::memset(t.val, 0, sizeof t.val);
  std::memcpy(t.val, val, count);
  t.present = true;
}

// Returns false on a table libjpeg rejects (JERR_BAD_HUFF_TABLE).
bool derive(HuffTable& t, bool is_dc) {
  int huffsize[257], huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l) {
    for (int i = 0; i < t.bits[l]; ++i) {
      if (p >= 256) return false;
      huffsize[p++] = l;
    }
  }
  huffsize[p] = 0;
  const int numsymbols = p;
  int code = 0, si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) huffcode[p++] = code++;
    if ((int64_t)code >= ((int64_t)1 << si)) return false;
    code <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (t.bits[l]) {
      t.valoffset[l] = p - huffcode[p];
      p += t.bits[l];
      t.maxcode[l] = huffcode[p - 1];
    } else {
      t.maxcode[l] = -1;
    }
  }
  t.valoffset[17] = 0;
  t.maxcode[17] = 0xFFFFF;  // ensures decode terminates
  std::memset(t.lookup, 0, sizeof t.lookup);
  p = 0;
  for (int l = 1; l <= 9; ++l) {
    for (int i = 1; i <= t.bits[l]; ++i, ++p) {
      int look = huffcode[p] << (9 - l);
      for (int c = 1 << (9 - l); c > 0; --c)
        t.lookup[look++] = (uint16_t)((l << 8) | t.val[p]);
    }
  }
  if (is_dc) {
    for (int i = 0; i < numsymbols; ++i)
      if (t.val[i] > 15) return false;
  }
  return true;
}

// The entropy-coded byte stream of a scan, as jdhuff.c sees it.
struct BitReader {
  const uint8_t* d;
  size_t n;
  size_t pos;
  uint64_t buf = 0;  // MSB-aligned
  int cnt = 0;
  int marker = 0;  // unread marker, 0 = none
  bool insufficient = false;

  void fill() {
    while (cnt <= 56 && !marker) {
      if (pos >= n) {
        marker = 0xD9;  // the source manager's fake EOI
        return;
      }
      int c = d[pos++];
      if (c == 0xFF) {
        int c2;
        do {
          if (pos >= n) {
            marker = 0xD9;
            return;
          }
          c2 = d[pos++];
        } while (c2 == 0xFF);
        if (c2 != 0) {
          marker = c2;
          return;
        }
      }
      buf |= (uint64_t)c << (56 - cnt);
      cnt += 8;
    }
  }
  // The next k (<= 25) bits; zero bits past a marker.
  uint32_t peek(int k) {
    if (cnt < k) fill();
    return (uint32_t)(buf >> (64 - k));
  }
  void skip(int k) {
    if (cnt < k) {
      fill();
      if (cnt < k) {  // ran out: zero bits stand in (JWRN_HIT_MARKER)
        insufficient = true;
        buf = 0;
        cnt = 0;
        return;
      }
    }
    buf <<= k;
    cnt -= k;
  }
  uint32_t get(int k) {
    uint32_t v = peek(k);
    skip(k);
    return v;
  }
  int decode(const HuffTable& t) {
    uint32_t look = peek(9);
    int e = t.lookup[look];
    if (e) {
      skip(e >> 8);
      return e & 255;
    }
    uint32_t bits16 = peek(16);
    int l = 10;
    int32_t code = (int32_t)(bits16 >> 6);
    while (l <= 16 && code > t.maxcode[l]) {
      ++l;
      code = (int32_t)(bits16 >> (16 - l));
    }
    if (l > 16) {  // JWRN_HUFF_BAD_CODE: 17 bits gone, symbol 0
      skip(16);
      skip(1);
      return 0;
    }
    skip(l);
    return t.val[(code + t.valoffset[l]) & 255];
  }
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v + (int)((~0u << s) + 1) : v;
}

struct Component {
  int id, h, v, tq;
  int bw, bh;        // blocks allocated (MCU-padded)
  int wib, hib;      // width / height in blocks
  int dw, dh;        // downsampled width / height in samples
  bool latched = false;
  uint16_t quant[64];
  std::vector<int16_t> coef;  // bh x bw blocks of 64
};

struct Marker {
  int code;
  size_t body;  // offset of the segment's body (after its length)
  size_t len;   // body length
};

struct Decoder {
  const uint8_t* d;
  size_t n;
  size_t pos = 0;
  int width = 0, height = 0, precision = 0;
  std::vector<Component> comps;
  int max_h = 1, max_v = 1, mcus_x = 0, mcus_y = 0;
  bool have_frame = false, progressive = false;
  HuffTable dc[4], ac[4];
  uint16_t qt[4][64];
  bool qt_present[4] = {false, false, false, false};
  int restart_interval = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = 0;
  int unread = 0;  // marker read by the entropy decoder
  bool header_only = false;

  // next_marker (jdmarker.c): skip garbage, then 0xFF fills.
  int next_marker() {
    for (;;) {
      while (pos < n && d[pos] != 0xFF) ++pos;
      while (pos < n && d[pos] == 0xFF) ++pos;
      if (pos >= n) return 0xD9;  // fake EOI at the end of the file
      int c = d[pos++];
      if (c != 0) return c;
    }
  }

  bool segment(size_t& body, size_t& len) {
    if (pos + 2 > n) return false;
    size_t L = ((size_t)d[pos] << 8) | d[pos + 1];
    if (L < 2 || pos + L > n) return false;
    body = pos + 2;
    len = L - 2;
    pos += L;
    return true;
  }

  int read_sof(int code, size_t b, size_t len) {
    if (have_frame) return ZD_MALFORMED;  // JERR_SOF_DUPLICATE
    if (len < 6) return ZD_MALFORMED;
    precision = d[b];
    height = (d[b + 1] << 8) | d[b + 2];
    width = (d[b + 3] << 8) | d[b + 4];
    int nc = d[b + 5];
    if (len != 6 + 3 * (size_t)nc || nc == 0) return ZD_MALFORMED;
    if (code == 0xC3 || code == 0xC7 || code == 0xCB || code == 0xCF)
      return ZD_LOSSLESS;
    if (code == 0xC5 || code == 0xC6 || code == 0xC7 || code == 0xCD ||
        code == 0xCE || code == 0xCF)
      return ZD_HIERARCHICAL;
    if (code >= 0xC9) return ZD_ARITHMETIC;
    if (code == 0xC2) return ZD_PROGRESSIVE;
    if (precision != 8) return ZD_PRECISION;
    if (height == 0 || width == 0 || height > 65500 || width > 65500)
      return ZD_MALFORMED;
    if (nc == 4) return ZD_CMYK;
    if (nc != 1 && nc != 3) return ZD_COMPONENTS;
    comps.resize(nc);
    for (int i = 0; i < nc; ++i) {
      Component& c = comps[i];
      c.id = d[b + 6 + 3 * i];
      c.h = d[b + 7 + 3 * i] >> 4;
      c.v = d[b + 7 + 3 * i] & 15;
      c.tq = d[b + 8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        return ZD_MALFORMED;
      max_h = std::max(max_h, c.h);
      max_v = std::max(max_v, c.v);
    }
    mcus_x = (width + 8 * max_h - 1) / (8 * max_h);
    mcus_y = (height + 8 * max_v - 1) / (8 * max_v);
    for (auto& c : comps) {
      if (max_h % c.h || max_v % c.v) return ZD_SAMPLING;
      c.wib = (int)(((int64_t)width * c.h + 8 * max_h - 1) / (8 * max_h));
      c.hib = (int)(((int64_t)height * c.v + 8 * max_v - 1) / (8 * max_v));
      c.dw = (int)(((int64_t)width * c.h + max_h - 1) / max_h);
      c.dh = (int)(((int64_t)height * c.v + max_v - 1) / max_v);
      c.bw = mcus_x * c.h;
      c.bh = mcus_y * c.v;
      std::memset(c.quant, 0, sizeof c.quant);
    }
    have_frame = true;
    return ZD_OK;
  }

  int read_dht(size_t b, size_t len) {
    size_t e = b + len;
    while (b < e) {
      if (b + 17 > e) return ZD_MALFORMED;
      int tc = d[b] >> 4, th = d[b] & 15;
      uint8_t bits[17] = {0};
      int count = 0;
      for (int l = 1; l <= 16; ++l) {
        bits[l] = d[b + l];
        count += bits[l];
      }
      b += 17;
      if (count > 256 || b + count > e) return ZD_MALFORMED;
      if (th > 3 || tc > 1) return ZD_MALFORMED;
      set_table(tc ? ac[th] : dc[th], bits, d + b);
      b += count;
    }
    return ZD_OK;
  }

  int read_dqt(size_t b, size_t len) {
    size_t e = b + len;
    while (b < e) {
      int pq = d[b] >> 4, tq = d[b] & 15;
      if (tq > 3 || pq > 1) return ZD_MALFORMED;
      size_t need = 1 + 64 * (pq + 1);
      if (b + need > e) return ZD_MALFORMED;
      for (int k = 0; k < 64; ++k) {
        int q = pq ? (d[b + 1 + 2 * k] << 8) | d[b + 2 + 2 * k]
                   : d[b + 1 + k];
        qt[tq][kNaturalOrder[k]] = (uint16_t)q;
      }
      qt_present[tq] = true;
      b += need;
    }
    return ZD_OK;
  }

  // jpeg_resync_to_restart's decision loop.
  void resync(BitReader& br, int desired) {
    for (;;) {
      int m = br.marker;
      int action;
      if (m < 0xC0) {
        action = 2;
      } else if (m < 0xD0 || m > 0xD7) {
        action = 3;
      } else if (m == 0xD0 + ((desired + 1) & 7) ||
                 m == 0xD0 + ((desired + 2) & 7)) {
        action = 3;
      } else if (m == 0xD0 + ((desired - 1) & 7) ||
                 m == 0xD0 + ((desired - 2) & 7)) {
        action = 2;
      } else {
        action = 1;
      }
      if (action == 1) {
        br.marker = 0;
        return;
      }
      if (action == 3) return;
      pos = br.pos;
      br.marker = next_marker();
      br.pos = pos;
    }
  }

  int decode_scan(size_t b, size_t len) {
    if (!have_frame) return ZD_MALFORMED;  // JERR_SOS_NO_SOF
    if (len < 1) return ZD_MALFORMED;
    int ns = d[b];
    if (ns < 1 || ns > 4 || len != 4 + 2 * (size_t)ns) return ZD_MALFORMED;
    int idx[4], td[4], ta[4];
    for (int i = 0; i < ns; ++i) {
      int cid = d[b + 1 + 2 * i];
      idx[i] = -1;
      for (size_t c = 0; c < comps.size(); ++c)
        if (comps[c].id == cid) idx[i] = (int)c;
      if (idx[i] < 0) return ZD_MALFORMED;
      for (int j = 0; j < i; ++j)
        if (idx[j] == idx[i]) return ZD_MALFORMED;
      td[i] = d[b + 2 + 2 * i] >> 4;
      ta[i] = d[b + 2 + 2 * i] & 15;
      if (td[i] > 3 || ta[i] > 3) return ZD_MALFORMED;
    }
    int ss = d[b + 1 + 2 * ns], se = d[b + 2 + 2 * ns];
    int ah = d[b + 3 + 2 * ns] >> 4, al = d[b + 3 + 2 * ns] & 15;
    if (ss != 0 || se != 63 || ah != 0 || al != 0) return ZD_MALFORMED;
    // tables: latch the quantizers, derive the Huffman codes, replacing
    // absent tables 0 and 1 with the standard ones
    for (int i = 0; i < ns; ++i) {
      Component& c = comps[idx[i]];
      if (!c.latched) {
        if (!qt_present[c.tq]) return ZD_MALFORMED;
        std::memcpy(c.quant, qt[c.tq], sizeof c.quant);
        c.latched = true;
      }
      for (int k = 0; k < 2; ++k) {
        HuffTable& t = k ? ac[ta[i]] : dc[td[i]];
        int no = k ? ta[i] : td[i];
        if (!t.present) {
          if (no > 1) return ZD_MALFORMED;  // JERR_NO_HUFF_TABLE
          if (k)
            set_table(t, no ? kAcChromBits : kAcLumBits,
                      no ? kAcChromVal : kAcLumVal);
          else
            set_table(t, no ? kDcChromBits : kDcLumBits,
                      no ? kDcChromVal : kDcLumVal);
        }
        if (!derive(t, k == 0)) return ZD_MALFORMED;
      }
      if (c.coef.empty()) c.coef.assign((size_t)c.bw * c.bh * 64, 0);
    }
    if (ns > 1) {
      int blocks = 0;
      for (int i = 0; i < ns; ++i)
        blocks += comps[idx[i]].h * comps[idx[i]].v;
      if (blocks > 10) return ZD_MALFORMED;  // JERR_BAD_MCU_SIZE
    }

    BitReader br;
    br.d = d;
    br.n = n;
    br.pos = pos;
    int last_dc[4] = {0, 0, 0, 0};
    int restarts_to_go = restart_interval;
    int next_rst = 0;
    auto block = [&](int i, int by, int bx) {
      Component& c = comps[idx[i]];
      const HuffTable& dct = dc[td[i]];
      const HuffTable& act = ac[ta[i]];
      int16_t* blk = &c.coef[((size_t)by * c.bw + bx) * 64];
      int s = br.decode(dct);
      if (s) s = extend((int)br.get(s), s);
      s += last_dc[i];
      last_dc[i] = s;
      blk[0] = (int16_t)s;
      for (int k = 1; k < 64; ++k) {
        int rs = br.decode(act);
        int r = rs >> 4;
        s = rs & 15;
        if (s) {
          k += r;
          blk[kNaturalOrder[k]] = (int16_t)extend((int)br.get(s), s);
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
    };
    auto restart = [&]() {
      br.buf = 0;
      br.cnt = 0;
      if (!br.marker) {
        pos = br.pos;
        br.marker = next_marker();
        br.pos = pos;
      }
      if (br.marker == 0xD0 + next_rst)
        br.marker = 0;
      else
        resync(br, next_rst);
      next_rst = (next_rst + 1) & 7;
      for (int& v : last_dc) v = 0;
      restarts_to_go = restart_interval;
      if (br.marker == 0) br.insufficient = false;
    };
    if (ns == 1) {
      Component& c = comps[idx[0]];
      for (int by = 0; by < c.hib; ++by) {
        for (int bx = 0; bx < c.wib; ++bx) {
          if (restart_interval && restarts_to_go == 0) restart();
          if (!br.insufficient) block(0, by, bx);
          if (restart_interval) --restarts_to_go;
        }
      }
    } else {
      for (int my = 0; my < mcus_y; ++my) {
        for (int mx = 0; mx < mcus_x; ++mx) {
          if (restart_interval && restarts_to_go == 0) restart();
          if (!br.insufficient) {
            for (int i = 0; i < ns; ++i) {
              const Component& c = comps[idx[i]];
              for (int y = 0; y < c.v; ++y)
                for (int x = 0; x < c.h; ++x)
                  block(i, my * c.v + y, mx * c.h + x);
            }
          }
          if (restart_interval) --restarts_to_go;
        }
      }
    }
    pos = br.pos;
    unread = br.marker;
    return ZD_OK;
  }

  // Walk the markers; decode every scan unless header_only (then stop at
  // the frame header).
  int run() {
    if (n < 2 || d[0] != 0xFF || d[1] != 0xD8) return ZD_MALFORMED;
    pos = 2;
    bool saw_scan = false;
    for (;;) {
      int m = unread ? unread : next_marker();
      unread = 0;
      if (m == 0xD9) return saw_scan ? ZD_OK : ZD_MALFORMED;
      if (m >= 0xD0 && m <= 0xD7) continue;  // stray RSTn
      if (m == 0x01) continue;               // TEM
      if (m == 0xD8) return ZD_MALFORMED;    // JERR_SOI_DUPLICATE
      size_t b, len;
      if (!segment(b, len)) return ZD_MALFORMED;
      int rc = ZD_OK;
      if ((m >= 0xC0 && m <= 0xCF) && m != 0xC4 && m != 0xC8 &&
          m != 0xCC) {
        rc = read_sof(m, b, len);
        if (rc == ZD_OK && header_only) return ZD_OK;
      } else if (m == 0xC4) {
        rc = read_dht(b, len);
      } else if (m == 0xCC) {
        rc = ZD_ARITHMETIC;
      } else if (m == 0xDB) {
        rc = read_dqt(b, len);
      } else if (m == 0xDD) {
        if (len != 2) return ZD_MALFORMED;
        restart_interval = (d[b] << 8) | d[b + 1];
      } else if (m == 0xDA) {
        if (header_only) return ZD_MALFORMED;
        rc = decode_scan(b, len);
        saw_scan = true;
      } else if (m == 0xDE || m == 0xDF) {
        rc = ZD_HIERARCHICAL;
      } else if (m == 0xE0) {
        if (len >= 5 && !std::memcmp(d + b, "JFIF\0", 5)) jfif = true;
      } else if (m == 0xEE) {
        if (len >= 12 && !std::memcmp(d + b, "Adobe", 5)) {
          adobe = true;
          adobe_transform = d[b + 11];
        }
      } else if ((m >= 0xE1 && m <= 0xEF) || m == 0xFE || m == 0xDC) {
        // other APPn, COM, DNL: skipped
      } else {
        return ZD_MALFORMED;  // JERR_UNKNOWN_MARKER
      }
      if (rc != ZD_OK) return rc;
    }
  }

  bool is_rgb() const {
    if (comps.size() != 3 || jfif) return false;
    if (adobe) return adobe_transform == 0;
    return comps[0].id == 82 && comps[1].id == 71 && comps[2].id == 66;
  }
};

// jidctint.c, jpeg_idct_islow, with jdmaster.c's range-limit table.
const int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196,
              FIX_0_541196100 = 4433, FIX_0_765366865 = 6270,
              FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
              FIX_1_501321110 = 12299, FIX_1_847759065 = 15137,
              FIX_1_961570560 = 16069, FIX_2_053119869 = 16819,
              FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;
const int CONST_BITS = 13, PASS1_BITS = 2;

inline int64_t descale(int64_t x, int n) {
  return (x + ((int64_t)1 << (n - 1))) >> n;
}

inline uint8_t idct_limit(int64_t x) {
  int i = (int)(x & 1023);
  if (i < 128) return (uint8_t)(i + 128);
  if (i < 512) return 255;
  if (i < 896) return 0;
  return (uint8_t)(i - 896);
}

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int* wp = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] &&
        !ip[56]) {
      int dcval = (int)((int64_t)ip[0] * qp[0] * (1 << PASS1_BITS));
      for (int r = 0; r < 8; ++r) wp[8 * r] = dcval;
      continue;
    }
    int64_t z2 = (int64_t)ip[16] * qp[16], z3 = (int64_t)ip[48] * qp[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = (int64_t)ip[0] * qp[0];
    z3 = (int64_t)ip[32] * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
    int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = (int64_t)ip[56] * qp[56];
    tmp1 = (int64_t)ip[40] * qp[40];
    tmp2 = (int64_t)ip[24] * qp[24];
    tmp3 = (int64_t)ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = CONST_BITS - PASS1_BITS;
    wp[0] = (int)descale(tmp10 + tmp3, sh);
    wp[56] = (int)descale(tmp10 - tmp3, sh);
    wp[8] = (int)descale(tmp11 + tmp2, sh);
    wp[48] = (int)descale(tmp11 - tmp2, sh);
    wp[16] = (int)descale(tmp12 + tmp1, sh);
    wp[40] = (int)descale(tmp12 - tmp1, sh);
    wp[24] = (int)descale(tmp13 + tmp0, sh);
    wp[32] = (int)descale(tmp13 - tmp0, sh);
  }
  for (int r = 0; r < 8; ++r) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + (size_t)r * stride;
    if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] &&
        !wp[7]) {
      uint8_t v = idct_limit(descale(wp[0], PASS1_BITS + 3));
      for (int k = 0; k < 8; ++k) op[k] = v;
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = ((int64_t)wp[0] + wp[4]) * (1 << CONST_BITS);
    int64_t tmp1 = ((int64_t)wp[0] - wp[4]) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = CONST_BITS + PASS1_BITS + 3;
    op[0] = idct_limit(descale(tmp10 + tmp3, sh));
    op[7] = idct_limit(descale(tmp10 - tmp3, sh));
    op[1] = idct_limit(descale(tmp11 + tmp2, sh));
    op[6] = idct_limit(descale(tmp11 - tmp2, sh));
    op[2] = idct_limit(descale(tmp12 + tmp1, sh));
    op[5] = idct_limit(descale(tmp12 - tmp1, sh));
    op[3] = idct_limit(descale(tmp13 + tmp0, sh));
    op[4] = idct_limit(descale(tmp13 - tmp0, sh));
  }
}

// One component's samples at full resolution, width x height (jdsample.c).
std::vector<uint8_t> upsample(const Component& c, int max_h, int max_v,
                              int width, int height) {
  const int sw = c.bw * 8;
  std::vector<uint8_t> plane((size_t)sw * c.bh * 8);
  for (int by = 0; by < c.bh; ++by)
    for (int bx = 0; bx < c.bw; ++bx)
      idct_islow(&c.coef[((size_t)by * c.bw + bx) * 64], c.quant,
                 &plane[(size_t)by * 8 * sw + bx * 8], sw);
  const int fh = max_h / c.h, fv = max_v / c.v;
  std::vector<uint8_t> out((size_t)width * height);
  auto row = [&](int r) {  // context rows replicate the edge rows
    r = r < 0 ? 0 : (r >= c.dh ? c.dh - 1 : r);
    return &plane[(size_t)r * sw];
  };
  if (fh == 1 && fv == 1) {
    for (int y = 0; y < height; ++y)
      std::memcpy(&out[(size_t)y * width], row(y), width);
  } else if (fh == 2 && fv == 1 && c.dw > 2) {
    std::vector<uint8_t> tmp(2 * (size_t)c.dw);
    for (int y = 0; y < height; ++y) {
      const uint8_t* in = row(y);
      int w = c.dw;
      tmp[0] = in[0];
      tmp[1] = (uint8_t)((in[0] * 3 + in[1] + 2) >> 2);
      for (int i = 1; i < w - 1; ++i) {
        int v3 = in[i] * 3;
        tmp[2 * i] = (uint8_t)((v3 + in[i - 1] + 1) >> 2);
        tmp[2 * i + 1] = (uint8_t)((v3 + in[i + 1] + 2) >> 2);
      }
      tmp[2 * w - 2] = (uint8_t)((in[w - 1] * 3 + in[w - 2] + 1) >> 2);
      tmp[2 * w - 1] = in[w - 1];
      std::memcpy(&out[(size_t)y * width], tmp.data(), width);
    }
  } else if (fh == 1 && fv == 2) {
    for (int y = 0; y < height; ++y) {
      int r = y >> 1;
      const uint8_t* in0 = row(r);
      const uint8_t* in1 = row((y & 1) ? r + 1 : r - 1);
      int bias = (y & 1) ? 2 : 1;
      uint8_t* o = &out[(size_t)y * width];
      for (int x = 0; x < width; ++x)
        o[x] = (uint8_t)((in0[x] * 3 + in1[x] + bias) >> 2);
    }
  } else if (fh == 2 && fv == 2 && c.dw > 2) {
    std::vector<int> sum(c.dw);
    std::vector<uint8_t> tmp(2 * (size_t)c.dw);
    for (int y = 0; y < height; ++y) {
      int r = y >> 1;
      const uint8_t* in0 = row(r);
      const uint8_t* in1 = row((y & 1) ? r + 1 : r - 1);
      int w = c.dw;
      for (int i = 0; i < w; ++i) sum[i] = in0[i] * 3 + in1[i];
      tmp[0] = (uint8_t)((sum[0] * 4 + 8) >> 4);
      tmp[1] = (uint8_t)((sum[0] * 3 + sum[1] + 7) >> 4);
      for (int i = 1; i < w - 1; ++i) {
        tmp[2 * i] = (uint8_t)((sum[i] * 3 + sum[i - 1] + 8) >> 4);
        tmp[2 * i + 1] = (uint8_t)((sum[i] * 3 + sum[i + 1] + 7) >> 4);
      }
      tmp[2 * w - 2] = (uint8_t)((sum[w - 1] * 3 + sum[w - 2] + 8) >> 4);
      tmp[2 * w - 1] = (uint8_t)((sum[w - 1] * 4 + 7) >> 4);
      std::memcpy(&out[(size_t)y * width], tmp.data(), width);
    }
  } else {  // replication (h2v1_upsample, h2v2_upsample, int_upsample)
    for (int y = 0; y < height; ++y) {
      const uint8_t* in = row(y / fv);
      uint8_t* o = &out[(size_t)y * width];
      for (int x = 0; x < width; ++x) o[x] = in[x / fh];
    }
  }
  return out;
}

inline uint8_t clamp255(int x) {
  return (uint8_t)(x < 0 ? 0 : (x > 255 ? 255 : x));
}

}  // namespace

extern "C" {

// Frame header: info = {width, height, components}. Returns a status
// code (0 = ok).
int zd_jpeg_header(const uint8_t* data, size_t n, int* info) {
  Decoder dec;
  dec.d = data;
  dec.n = n;
  dec.header_only = true;
  int rc = dec.run();
  if (rc != ZD_OK) return rc;
  if (!dec.have_frame) return ZD_MALFORMED;
  info[0] = dec.width;
  info[1] = dec.height;
  info[2] = (int)dec.comps.size();
  return ZD_OK;
}

// Decode into out: height x width x 3 (BGR) when gray == 0, height x
// width when gray != 0.
int zd_jpeg_decode(const uint8_t* data, size_t n, int gray, uint8_t* out) {
  Decoder dec;
  dec.d = data;
  dec.n = n;
  int rc = dec.run();
  if (rc != ZD_OK) return rc;
  const int W = dec.width, H = dec.height;
  const size_t P = (size_t)W * H;
  for (auto& c : dec.comps)
    if (c.coef.empty()) c.coef.assign((size_t)c.bw * c.bh * 64, 0);
  const bool rgb = dec.is_rgb();
  if (dec.comps.size() == 1) {
    std::vector<uint8_t> y = upsample(dec.comps[0], dec.max_h, dec.max_v,
                                      W, H);
    if (gray) {
      std::memcpy(out, y.data(), P);
    } else {
      for (size_t i = 0; i < P; ++i)
        out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = y[i];
    }
    return ZD_OK;
  }
  if (gray && !rgb) {  // the Y plane; chroma is not needed
    std::vector<uint8_t> y = upsample(dec.comps[0], dec.max_h, dec.max_v,
                                      W, H);
    std::memcpy(out, y.data(), P);
    return ZD_OK;
  }
  std::vector<uint8_t> p0 = upsample(dec.comps[0], dec.max_h, dec.max_v, W,
                                     H);
  std::vector<uint8_t> p1 = upsample(dec.comps[1], dec.max_h, dec.max_v, W,
                                     H);
  std::vector<uint8_t> p2 = upsample(dec.comps[2], dec.max_h, dec.max_v, W,
                                     H);
  const int SCALEBITS = 16;
  const int64_t ONE_HALF = (int64_t)1 << (SCALEBITS - 1);
  if (rgb) {
    if (gray) {  // rgb_gray_convert
      const int64_t FR = 19595, FG = 38470, FB = 7471;  // FIX(.299/.587/.114)
      for (size_t i = 0; i < P; ++i)
        out[i] = (uint8_t)((FR * p0[i] + FG * p1[i] + FB * p2[i] + ONE_HALF)
                           >> SCALEBITS);
    } else {
      for (size_t i = 0; i < P; ++i) {
        out[3 * i] = p2[i];
        out[3 * i + 1] = p1[i];
        out[3 * i + 2] = p0[i];
      }
    }
    return ZD_OK;
  }
  // build_ycc_rgb_table / ycc_rgb_convert
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  for (int i = 0; i < 256; ++i) {
    int64_t x = i - 128;
    cr_r[i] = (int)((91881 * x + ONE_HALF) >> SCALEBITS);   // FIX(1.40200)
    cb_b[i] = (int)((116130 * x + ONE_HALF) >> SCALEBITS);  // FIX(1.77200)
    cr_g[i] = -46802 * x;                                   // FIX(0.71414)
    cb_g[i] = -22554 * x + ONE_HALF;                        // FIX(0.34414)
  }
  for (size_t i = 0; i < P; ++i) {
    int y = p0[i], cb = p1[i], cr = p2[i];
    out[3 * i + 2] = clamp255(y + cr_r[cr]);
    out[3 * i + 1] =
        clamp255(y + (int)((cb_g[cb] + cr_g[cr]) >> SCALEBITS));
    out[3 * i] = clamp255(y + cb_b[cb]);
  }
  return ZD_OK;
}

// TIFF LZW (new style: MSB-first codes, 9-12 bits, early change). Returns
// the bytes written to out (at most out_n), or -1 on a malformed stream.
long zd_tiff_lzw(const uint8_t* in, size_t n, uint8_t* out, size_t out_n) {
  const int CLEAR = 256, EOI = 257;
  std::vector<int32_t> prefix(4096);
  std::vector<uint8_t> suffix(4096), first(4096);
  std::vector<uint16_t> length(4096);
  for (int i = 0; i < 256; ++i) {
    prefix[i] = -1;
    suffix[i] = first[i] = (uint8_t)i;
    length[i] = 1;
  }
  size_t o = 0;
  uint64_t buf = 0;
  int cnt = 0;
  size_t pos = 0;
  int width = 9, next = 258, old = -1;
  std::vector<uint8_t> stack(4096);
  for (;;) {
    while (cnt < width) {
      if (pos >= n) return (long)o;  // no EOI: take what came
      buf = (buf << 8) | in[pos++];
      cnt += 8;
    }
    int code = (int)((buf >> (cnt - width)) & ((1u << width) - 1));
    cnt -= width;
    if (code == EOI) break;
    if (code == CLEAR) {
      width = 9;
      next = 258;
      old = -1;
      continue;
    }
    int emit;
    uint8_t head;
    if (code < next) {
      emit = code;
      head = first[code];
    } else if (code == next && old >= 0) {
      emit = -1;  // KwKwK: old + first(old)
      head = first[old];
    } else {
      return -1;
    }
    if (old >= 0 && next < 4096) {
      prefix[next] = old;
      suffix[next] = head;
      first[next] = first[old];
      length[next] = (uint16_t)(length[old] + 1);
      ++next;
    }
    if (emit < 0) emit = next - 1;
    int len = length[emit];
    int k = emit;
    for (int i = len - 1; i >= 0; --i) {
      stack[i] = suffix[k];
      k = prefix[k];
    }
    for (int i = 0; i < len && o < out_n; ++i) out[o++] = stack[i];
    old = code;
    if (next + 1 >= (1 << width) && width < 12) ++width;
  }
  return (long)o;
}

// PackBits. Returns the bytes written to out (at most out_n).
long zd_tiff_packbits(const uint8_t* in, size_t n, uint8_t* out,
                      size_t out_n) {
  size_t i = 0, o = 0;
  while (i < n && o < out_n) {
    int c = (int8_t)in[i++];
    if (c >= 0) {
      for (int k = 0; k <= c && i < n && o < out_n; ++k) out[o++] = in[i++];
    } else if (c != -128) {
      if (i >= n) break;
      uint8_t v = in[i++];
      for (int k = 0; k < 1 - c && o < out_n; ++k) out[o++] = v;
    }
  }
  return (long)o;
}

}  // extern "C"
