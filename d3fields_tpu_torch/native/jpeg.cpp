// A JPEG decoder whose output equals libjpeg-turbo's, as cv2.imread gives it.
//
// Built with g++ on first use by d3fields_tpu_torch/native_build.py and
// called through ctypes from d3fields_tpu_torch/utils/jpeg.py, which
// applies the EXIF orientation. It reads 8-bit Huffman-coded files:
// baseline (SOF0), extended sequential (SOF1) and progressive (SOF2), with
// restart intervals, greyscale or three components (YCbCr, or RGB under an
// Adobe marker or 'R','G','B' component ids) at any integral sampling
// factors. What it computes is libjpeg-turbo's default decompression
// (what OpenCV asks for):
//
// - jpeg_idct_islow, the accurate integer inverse DCT, with its range
//   limit table (values wrap modulo 1024 before the clamp);
// - "fancy" triangle upsampling of 2:1 chroma (h2v1, h1v2, h2v2), box
//   replication of other integral factors, both replicating the edge of
//   the component's own (downsampled) size;
// - the integer YCbCr -> RGB tables (16-bit fixed point);
// - no block smoothing: it applies only while some scan of a progressive
//   file has not yet refined the low coefficients, never to a file decoded
//   to its end.
//
// Arithmetic coding, lossless and hierarchical frames, other precisions
// than 8 bits and four-component (CMYK / YCCK) files are refused with an
// error that names the marker or the property.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

// zigzag -> natural order, padded so that a corrupt run past 63 stays inside
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Error {
  std::string msg;
};

constexpr int kLookupBits = 9;

struct Huffman {
  bool present = false;
  uint8_t fast_len[1 << kLookupBits];  // 0: longer than kLookupBits bits
  uint8_t fast_val[1 << kLookupBits];
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];

  void build(const uint8_t* counts, const uint8_t* symbols, int nsym) {
    std::memcpy(vals, symbols, nsym);
    std::memset(fast_len, 0, sizeof(fast_len));
    int code = 0, k = 0;
    for (int len = 1; len <= 16; ++len) {
      valoffset[len] = k - code;
      for (int i = 0; i < counts[len - 1]; ++i, ++k, ++code) {
        if (len <= kLookupBits) {
          const int shift = kLookupBits - len;
          for (int j = 0; j < (1 << shift); ++j) {
            fast_len[(code << shift) | j] = static_cast<uint8_t>(len);
            fast_val[(code << shift) | j] = symbols[k];
          }
        }
      }
      maxcode[len] = counts[len - 1] ? code - 1 : -1;
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    present = true;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;
  int bw = 0, bh = 0;          // blocks allocated (whole MCUs)
  int wblocks = 0, hblocks = 0;  // blocks that hold image data
  int dw = 0, dh = 0;          // downsampled size in samples
  int pred = 0;
  bool latched = false;
  uint16_t q[64];
  std::vector<int16_t> coef;
};

class Decoder {
 public:
  Decoder(const uint8_t* data, size_t size) : d_(data), n_(size) {}

  void header_only() { parse(false); }
  void decode() { parse(true); }

  int width = 0, height = 0, ncomp = 0;
  int orientation = 1;
  std::vector<uint8_t> out;  // BGR rows, before the EXIF orientation

 private:
  const uint8_t* d_;
  size_t n_, pos_ = 0;
  uint16_t qt_[4][64];
  bool qt_present_[4] = {false, false, false, false};
  Huffman dc_[4], ac_[4];
  Component comp_[4];
  int hmax_ = 1, vmax_ = 1, mcux_ = 0, mcuy_ = 0;
  bool progressive_ = false, frame_ = false, jfif_ = false, adobe_ = false;
  int adobe_transform_ = -1;
  int restart_ = 0;
  // entropy decoder state
  uint32_t bits_ = 0;
  int nbits_ = 0;
  bool marker_hit_ = false;
  int eobrun_ = 0;

  [[noreturn]] void fail(const std::string& m) { throw Error{m}; }

  int u8() {
    if (pos_ >= n_) fail("unexpected end of file");
    return d_[pos_++];
  }
  int u16() {
    const int a = u8();
    return (a << 8) | u8();
  }

  static std::string hex(int marker) {
    char buf[8];
    std::snprintf(buf, sizeof(buf), "0xFF%02X", marker);
    return buf;
  }

  void parse(bool full) {
    if (u8() != 0xFF || u8() != 0xD8) fail("not a JPEG file (no SOI marker)");
    for (;;) {
      int c = u8();
      if (c != 0xFF) continue;  // garbage between segments, as libjpeg skips it
      while (c == 0xFF) c = u8();
      if (c == 0xD9) break;  // EOI
      if (c >= 0xD0 && c <= 0xD7) continue;
      if (c == 0xC0 || c == 0xC1 || c == 0xC2) {
        sof(c);
        if (!full) return;
        continue;
      }
      if (c == 0xC3) fail("lossless JPEG (SOF3 " + hex(c) + ") is not supported");
      if (c >= 0xC5 && c <= 0xC7)
        fail("hierarchical JPEG (SOF" + std::to_string(c - 0xC0) + " " + hex(c) +
             ") is not supported");
      if (c >= 0xC9 && c <= 0xCF && c != 0xCC)
        fail("arithmetic-coded JPEG (SOF" + std::to_string(c - 0xC0) + " " + hex(c) +
             ") is not supported");
      if (c == 0xCC) fail("arithmetic-coded JPEG (DAC " + hex(c) + ") is not supported");
      const int len = u16();
      if (len < 2 || pos_ + len - 2 > n_) fail("segment " + hex(c) + " runs past the file");
      const size_t end = pos_ + len - 2;
      if (c == 0xC4) {
        dht(end);
      } else if (c == 0xDB) {
        dqt(end);
      } else if (c == 0xDD) {
        restart_ = u16();
      } else if (c == 0xDA) {
        if (!frame_) fail("SOS before SOF");
        sos(end);
        continue;  // sos() leaves pos_ at the marker after the scan
      } else if (c == 0xE0) {
        jfif_ = jfif_ || (len >= 7 && std::memcmp(d_ + pos_, "JFIF\0", 5) == 0);
      } else if (c == 0xE1) {
        if (len >= 8 && std::memcmp(d_ + pos_, "Exif\0\0", 6) == 0 && orientation == 1)
          exif(pos_ + 6, end);
      } else if (c == 0xEE) {
        if (len >= 14 && std::memcmp(d_ + pos_, "Adobe", 5) == 0) {
          adobe_ = true;
          adobe_transform_ = d_[pos_ + 11];
        }
      }
      pos_ = end;
    }
    if (!frame_) fail("no SOF marker before EOI");
    if (full) output();
  }

  void exif(size_t tiff, size_t end) {
    // the TIFF header, IFD0, and its Orientation tag (0x0112)
    if (tiff + 8 > end) return;
    const bool le = d_[tiff] == 'I';
    auto rd16 = [&](size_t p) -> int {
      if (p + 2 > end) return -1;
      return le ? d_[p] | (d_[p + 1] << 8) : (d_[p] << 8) | d_[p + 1];
    };
    auto rd32 = [&](size_t p) -> int64_t {
      if (p + 4 > end) return -1;
      return le ? (int64_t)d_[p] | ((int64_t)d_[p + 1] << 8) | ((int64_t)d_[p + 2] << 16) |
                      ((int64_t)d_[p + 3] << 24)
                : ((int64_t)d_[p] << 24) | ((int64_t)d_[p + 1] << 16) |
                      ((int64_t)d_[p + 2] << 8) | (int64_t)d_[p + 3];
    };
    const int64_t ifd = rd32(tiff + 4);
    if (ifd < 0) return;
    const int count = rd16(tiff + ifd);
    for (int i = 0; i < count; ++i) {
      const size_t e = tiff + ifd + 2 + 12 * i;
      if (rd16(e) == 0x0112) {
        const int v = rd16(e + 8);
        if (v >= 1 && v <= 8) orientation = v;
        return;
      }
    }
  }

  void sof(int marker) {
    if (frame_) fail("a second SOF marker");
    const int len = u16();
    const size_t end = pos_ + len - 2;
    const int precision = u8();
    if (precision != 8)
      fail(std::to_string(precision) + "-bit JPEG (SOF" + std::to_string(marker - 0xC0) + " " +
           hex(marker) + ") is not supported; only 8-bit samples are");
    height = u16();
    width = u16();
    ncomp = u8();
    if (height == 0 || width == 0) fail("a JPEG without a height or width in its SOF");
    if (ncomp == 4)
      fail("four-component JPEG (CMYK / YCCK, SOF" + std::to_string(marker - 0xC0) + " " +
           hex(marker) + ") is not supported");
    if (ncomp != 1 && ncomp != 3)
      fail(std::to_string(ncomp) + "-component JPEG is not supported");
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp_[i];
      c.id = u8();
      const int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8() & 3;
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) fail("bad sampling factors in SOF");
      hmax_ = std::max(hmax_, c.h);
      vmax_ = std::max(vmax_, c.v);
    }
    if (ncomp == 1) comp_[0].h = comp_[0].v = hmax_ = vmax_ = 1;
    mcux_ = (width + 8 * hmax_ - 1) / (8 * hmax_);
    mcuy_ = (height + 8 * vmax_ - 1) / (8 * vmax_);
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp_[i];
      if (hmax_ % c.h || vmax_ % c.v) fail("non-integral sampling factors are not supported");
      c.dw = (width * c.h + hmax_ - 1) / hmax_;
      c.dh = (height * c.v + vmax_ - 1) / vmax_;
      c.wblocks = (c.dw + 7) / 8;
      c.hblocks = (c.dh + 7) / 8;
      c.bw = mcux_ * c.h;
      c.bh = mcuy_ * c.v;
    }
    progressive_ = marker == 0xC2;
    frame_ = true;
    pos_ = end;
  }

  void dht(size_t end) {
    while (pos_ < end) {
      const int tc = u8();
      const int cls = tc >> 4, id = tc & 15;
      if (cls > 1 || id > 3) fail("bad Huffman table id in DHT");
      uint8_t counts[16];
      int total = 0;
      for (int i = 0; i < 16; ++i) total += counts[i] = static_cast<uint8_t>(u8());
      if (total > 256 || pos_ + total > end) fail("bad Huffman table in DHT");
      (cls ? ac_ : dc_)[id].build(counts, d_ + pos_, total);
      pos_ += total;
    }
  }

  void dqt(size_t end) {
    while (pos_ < end) {
      const int pq = u8();
      const int id = pq & 15;
      if (id > 3) fail("bad quantization table id in DQT");
      for (int i = 0; i < 64; ++i) qt_[id][kNatural[i]] = static_cast<uint16_t>(pq >> 4 ? u16() : u8());
      qt_present_[id] = true;
    }
  }

  // --- entropy decoding -----------------------------------------------------

  void reset_bits() {
    bits_ = 0;
    nbits_ = 0;
    marker_hit_ = false;
  }

  void fill() {
    while (nbits_ <= 24) {
      int b = 0;
      if (!marker_hit_ && pos_ < n_) {
        b = d_[pos_];
        if (b == 0xFF) {
          const int nx = pos_ + 1 < n_ ? d_[pos_ + 1] : 0xD9;
          if (nx == 0x00) {
            pos_ += 2;
          } else {
            marker_hit_ = true;  // leave the marker for the parser; feed zeros
            b = 0;
          }
        } else {
          ++pos_;
        }
      }
      bits_ |= static_cast<uint32_t>(b) << (24 - nbits_);
      nbits_ += 8;
    }
  }

  int get_bits(int n) {
    if (n == 0) return 0;
    if (nbits_ < n) fill();
    const int v = static_cast<int>(bits_ >> (32 - n));
    bits_ <<= n;
    nbits_ -= n;
    return v;
  }

  int get1() { return get_bits(1); }

  static int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

  int receive_extend(int s) { return s ? extend(get_bits(s), s) : 0; }

  int decode(const Huffman& h) {
    if (nbits_ < 16) fill();
    const int peek = static_cast<int>(bits_ >> (32 - kLookupBits));
    if (const int len = h.fast_len[peek]) {
      bits_ <<= len;
      nbits_ -= len;
      return h.fast_val[peek];
    }
    int code = 0;
    int len = 0;
    do {
      code = (code << 1) | get1();
      ++len;
    } while (len < 17 && code > h.maxcode[len]);
    if (len > 16) return 0;  // corrupt data: libjpeg warns and uses 0
    return h.vals[(h.valoffset[len] + code) & 0xFF];
  }

  // --- scans ----------------------------------------------------------------

  void sos(size_t end) {
    const int ns = u8();
    if (ns < 1 || ns > 4) fail("bad component count in SOS");
    Component* sc[4];
    for (int i = 0; i < ns; ++i) {
      const int cid = u8();
      const int t = u8();
      sc[i] = nullptr;
      for (int j = 0; j < ncomp; ++j)
        if (comp_[j].id == cid) sc[i] = &comp_[j];
      if (!sc[i]) fail("SOS names a component the frame does not have");
      sc[i]->td = t >> 4;
      sc[i]->ta = t & 15;
      if (sc[i]->td > 3 || sc[i]->ta > 3) fail("bad Huffman table id in SOS");
    }
    const int ss = u8(), se = u8(), a = u8();
    const int ah = a >> 4, al = a & 15;
    pos_ = end;
    if (progressive_ &&
        (ss > se || se > 63 || (ss == 0 && se != 0) || (ss != 0 && ns != 1) || al > 13)) {
      fail("bad progressive scan parameters in SOS");
    }
    for (int i = 0; i < ns; ++i) {
      Component& c = *sc[i];
      if (!c.latched) {  // libjpeg latches a component's table at its first scan
        if (!qt_present_[c.tq]) fail("a component's quantization table is missing");
        std::memcpy(c.q, qt_[c.tq], sizeof(c.q));
        c.latched = true;
      }
      if (c.coef.empty()) c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
      c.pred = 0;
      if ((!progressive_ || ss == 0) && ah == 0 && !dc_[c.td].present)
        fail("a scan's DC Huffman table is missing");
      if ((!progressive_ || ss > 0) && !ac_[c.ta].present)
        fail("a scan's AC Huffman table is missing");
    }
    reset_bits();
    eobrun_ = 0;

    int units_x, units_y;
    if (ns == 1) {
      units_x = sc[0]->wblocks;
      units_y = sc[0]->hblocks;
    } else {
      units_x = mcux_;
      units_y = mcuy_;
    }
    const int64_t total = static_cast<int64_t>(units_x) * units_y;
    int todo = restart_;
    for (int64_t m = 0; m < total; ++m) {
      if (restart_ && todo == 0) {
        restart_marker();
        for (int i = 0; i < ns; ++i) sc[i]->pred = 0;
        eobrun_ = 0;
        todo = restart_;
      }
      const int mx = static_cast<int>(m % units_x), my = static_cast<int>(m / units_x);
      if (ns == 1) {
        block(*sc[0], my, mx, ss, se, ah, al);
      } else {
        for (int i = 0; i < ns; ++i) {
          Component& c = *sc[i];
          for (int by = 0; by < c.v; ++by)
            for (int bx = 0; bx < c.h; ++bx) block(c, my * c.v + by, mx * c.h + bx, ss, se, ah, al);
        }
      }
      if (restart_) --todo;
    }
    // leave pos_ at the next marker
    reset_bits();
    while (pos_ + 1 < n_ && !(d_[pos_] == 0xFF && d_[pos_ + 1] != 0x00 &&
                              !(d_[pos_ + 1] >= 0xD0 && d_[pos_ + 1] <= 0xD7)))
      ++pos_;
  }

  void restart_marker() {
    reset_bits();
    // skip to the next marker; take it if it is an RSTn
    while (pos_ + 1 < n_ && !(d_[pos_] == 0xFF && d_[pos_ + 1] != 0x00 && d_[pos_ + 1] != 0xFF))
      ++pos_;
    if (pos_ + 1 < n_ && d_[pos_ + 1] >= 0xD0 && d_[pos_ + 1] <= 0xD7) pos_ += 2;
  }

  void block(Component& c, int by, int bx, int ss, int se, int ah, int al) {
    int16_t* blk = &c.coef[(static_cast<size_t>(by) * c.bw + bx) * 64];
    if (!progressive_) {
      const int s = decode(dc_[c.td]);
      c.pred += receive_extend(s);
      blk[0] = static_cast<int16_t>(c.pred);
      const Huffman& h = ac_[c.ta];
      for (int k = 1; k < 64; ++k) {
        const int rs = decode(h);
        const int r = rs >> 4, s2 = rs & 15;
        if (s2) {
          k += r;
          blk[kNatural[k]] = static_cast<int16_t>(receive_extend(s2));
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
      return;
    }
    if (ss == 0) {  // DC scans
      if (ah == 0) {
        const int s = decode(dc_[c.td]);
        c.pred += receive_extend(s);
        blk[0] = static_cast<int16_t>(static_cast<uint32_t>(c.pred) << al);
      } else if (get1()) {
        blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
      }
      return;
    }
    const Huffman& h = ac_[c.ta];
    if (ah == 0) {  // AC first scan
      if (eobrun_ > 0) {
        --eobrun_;
        return;
      }
      for (int k = ss; k <= se; ++k) {
        const int rs = decode(h);
        const int r = rs >> 4, s = rs & 15;
        if (s) {
          k += r;
          blk[kNatural[k]] = static_cast<int16_t>(static_cast<uint32_t>(receive_extend(s)) << al);
        } else if (r == 15) {
          k += 15;
        } else {
          eobrun_ = (1 << r) - 1;
          if (r) eobrun_ += get_bits(r);
          break;
        }
      }
      return;
    }
    // AC refinement (libjpeg's decode_mcu_AC_refine)
    const int p1 = 1 << al, m1 = -(1 << al);
    int k = ss;
    if (eobrun_ == 0) {
      for (; k <= se; ++k) {
        const int rs = decode(h);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = get1() ? p1 : m1;
        } else if (r != 15) {
          eobrun_ = 1 << r;
          if (r) eobrun_ += get_bits(r);
          break;
        }
        do {
          int16_t* t = &blk[kNatural[k]];
          if (*t != 0) {
            if (get1() && (*t & p1) == 0) *t = static_cast<int16_t>(*t >= 0 ? *t + p1 : *t + m1);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= se);
        if (s) blk[kNatural[k]] = static_cast<int16_t>(s);
      }
    }
    if (eobrun_ > 0) {
      for (; k <= se; ++k) {
        int16_t* t = &blk[kNatural[k]];
        if (*t != 0 && get1() && (*t & p1) == 0)
          *t = static_cast<int16_t>(*t >= 0 ? *t + p1 : *t + m1);
      }
      --eobrun_;
    }
  }

  // --- reconstruction -------------------------------------------------------

  static inline int limit(int64_t v) {
    // libjpeg's IDCT range limit: wrap modulo 1024 into [-512, 511], clamp
    // to [-128, 127], add 128
    int x = static_cast<int>(((v + 512) & 1023) - 512);
    x = x < -128 ? -128 : (x > 127 ? 127 : x);
    return x + 128;
  }

  static void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
    const int CONST_BITS = 13, PASS1_BITS = 2;
    const int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
                  FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
                  FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;
    auto descale = [](int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; };
    int ws[64];
    for (int col = 0; col < 8; ++col) {
      const int16_t* ip = in + col;
      const uint16_t* qp = q + col;
      int* wp = ws + col;
      if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
        const int dc = static_cast<int>(static_cast<int64_t>(ip[0]) * qp[0] * (1 << PASS1_BITS));
        for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
        continue;
      }
      int64_t z2 = static_cast<int64_t>(ip[16]) * qp[16], z3 = static_cast<int64_t>(ip[48]) * qp[48];
      int64_t z1 = (z2 + z3) * FIX_0_541196100;
      int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
      int64_t tmp3 = z1 + z2 * FIX_0_765366865;
      z2 = static_cast<int64_t>(ip[0]) * qp[0];
      z3 = static_cast<int64_t>(ip[32]) * qp[32];
      int64_t tmp0 = (z2 + z3) * (int64_t(1) << CONST_BITS);
      int64_t tmp1 = (z2 - z3) * (int64_t(1) << CONST_BITS);
      const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = static_cast<int64_t>(ip[56]) * qp[56];
      tmp1 = static_cast<int64_t>(ip[40]) * qp[40];
      tmp2 = static_cast<int64_t>(ip[24]) * qp[24];
      tmp3 = static_cast<int64_t>(ip[8]) * qp[8];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      const int64_t z5 = (z3 + z4) * FIX_1_175875602;
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
      wp[0] = static_cast<int>(descale(tmp10 + tmp3, sh));
      wp[56] = static_cast<int>(descale(tmp10 - tmp3, sh));
      wp[8] = static_cast<int>(descale(tmp11 + tmp2, sh));
      wp[48] = static_cast<int>(descale(tmp11 - tmp2, sh));
      wp[16] = static_cast<int>(descale(tmp12 + tmp1, sh));
      wp[40] = static_cast<int>(descale(tmp12 - tmp1, sh));
      wp[24] = static_cast<int>(descale(tmp13 + tmp0, sh));
      wp[32] = static_cast<int>(descale(tmp13 - tmp0, sh));
    }
    for (int row = 0; row < 8; ++row) {
      const int* wp = ws + 8 * row;
      uint8_t* op = out + row * stride;
      const int sh = CONST_BITS + PASS1_BITS + 3;
      if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
        const uint8_t dc = static_cast<uint8_t>(limit(descale(wp[0], PASS1_BITS + 3)));
        for (int i = 0; i < 8; ++i) op[i] = dc;
        continue;
      }
      int64_t z2 = wp[2], z3 = wp[6];
      int64_t z1 = (z2 + z3) * FIX_0_541196100;
      int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
      int64_t tmp3 = z1 + z2 * FIX_0_765366865;
      int64_t tmp0 = (static_cast<int64_t>(wp[0]) + wp[4]) * (int64_t(1) << CONST_BITS);
      int64_t tmp1 = (static_cast<int64_t>(wp[0]) - wp[4]) * (int64_t(1) << CONST_BITS);
      const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = wp[7];
      tmp1 = wp[5];
      tmp2 = wp[3];
      tmp3 = wp[1];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      const int64_t z5 = (z3 + z4) * FIX_1_175875602;
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
      op[0] = static_cast<uint8_t>(limit(descale(tmp10 + tmp3, sh)));
      op[7] = static_cast<uint8_t>(limit(descale(tmp10 - tmp3, sh)));
      op[1] = static_cast<uint8_t>(limit(descale(tmp11 + tmp2, sh)));
      op[6] = static_cast<uint8_t>(limit(descale(tmp11 - tmp2, sh)));
      op[2] = static_cast<uint8_t>(limit(descale(tmp12 + tmp1, sh)));
      op[5] = static_cast<uint8_t>(limit(descale(tmp12 - tmp1, sh)));
      op[3] = static_cast<uint8_t>(limit(descale(tmp13 + tmp0, sh)));
      op[4] = static_cast<uint8_t>(limit(descale(tmp13 - tmp0, sh)));
    }
  }

  // The component's samples at its downsampled size (dh, dw).
  std::vector<uint8_t> plane(const Component& c) {
    const int pw = c.bw * 8;
    std::vector<uint8_t> full(static_cast<size_t>(pw) * c.bh * 8, 0);
    if (!c.coef.empty()) {
      for (int by = 0; by < c.hblocks; ++by)
        for (int bx = 0; bx < c.wblocks; ++bx)
          idct_islow(&c.coef[(static_cast<size_t>(by) * c.bw + bx) * 64], c.q,
                     &full[static_cast<size_t>(by) * 8 * pw + bx * 8], pw);
    }
    std::vector<uint8_t> p(static_cast<size_t>(c.dw) * c.dh);
    for (int y = 0; y < c.dh; ++y) std::memcpy(&p[static_cast<size_t>(y) * c.dw], &full[static_cast<size_t>(y) * pw], c.dw);
    return p;
  }

  // Upsampled to the full (height, width) grid, as libjpeg-turbo's
  // jdsample.c does it.
  std::vector<uint8_t> upsample(const Component& c, const std::vector<uint8_t>& p) {
    const int fh = hmax_ / c.h, fv = vmax_ / c.v;
    const int ow = c.dw * fh, oh = c.dh * fv;  // may exceed the image by < factor
    std::vector<uint8_t> o(static_cast<size_t>(ow) * oh);
    const int dw = c.dw, dh = c.dh;
    auto at = [&](int y, int x) -> int {
      y = y < 0 ? 0 : (y >= dh ? dh - 1 : y);
      x = x < 0 ? 0 : (x >= dw ? dw - 1 : x);
      return p[static_cast<size_t>(y) * dw + x];
    };
    if (fh == 1 && fv == 1) return p;
    if (fh == 2 && fv == 1 && dw > 2) {  // h2v1 fancy
      for (int y = 0; y < dh; ++y)
        for (int x = 0; x < dw; ++x) {
          const int v = at(y, x) * 3;
          o[static_cast<size_t>(y) * ow + 2 * x] = static_cast<uint8_t>((v + at(y, x - 1) + 1) >> 2);
          o[static_cast<size_t>(y) * ow + 2 * x + 1] = static_cast<uint8_t>((v + at(y, x + 1) + 2) >> 2);
        }
      return o;
    }
    if (fh == 1 && fv == 2) {  // h1v2 fancy
      for (int y = 0; y < dh; ++y)
        for (int x = 0; x < dw; ++x) {
          const int v = at(y, x) * 3;
          o[static_cast<size_t>(2 * y) * ow + x] = static_cast<uint8_t>((v + at(y - 1, x) + 1) >> 2);
          o[static_cast<size_t>(2 * y + 1) * ow + x] = static_cast<uint8_t>((v + at(y + 1, x) + 2) >> 2);
        }
      return o;
    }
    if (fh == 2 && fv == 2 && dw > 2) {  // h2v2 fancy
      for (int y = 0; y < dh; ++y)
        for (int v = 0; v < 2; ++v) {
          const int ny = v == 0 ? y - 1 : y + 1;
          uint8_t* row = &o[static_cast<size_t>(2 * y + v) * ow];
          for (int x = 0; x < dw; ++x) {
            const int th = at(y, x) * 3 + at(ny, x);
            const int left = at(y, x - 1) * 3 + at(ny, x - 1);
            const int right = at(y, x + 1) * 3 + at(ny, x + 1);
            row[2 * x] = static_cast<uint8_t>((th * 3 + left + 8) >> 4);
            row[2 * x + 1] = static_cast<uint8_t>((th * 3 + right + 7) >> 4);
          }
        }
      return o;
    }
    for (int y = 0; y < oh; ++y)  // box replication (int_upsample, h2v1/h2v2_upsample)
      for (int x = 0; x < ow; ++x) o[static_cast<size_t>(y) * ow + x] = static_cast<uint8_t>(at(y / fv, x / fh));
    return o;
  }

  void output() {
    std::vector<std::vector<uint8_t>> planes(ncomp);
    std::vector<int> strides(ncomp);
    for (int i = 0; i < ncomp; ++i) {
      planes[i] = upsample(comp_[i], plane(comp_[i]));
      strides[i] = comp_[i].dw * (hmax_ / comp_[i].h);
    }
    out.assign(static_cast<size_t>(width) * height * 3, 0);
    if (ncomp == 1) {
      for (int y = 0; y < height; ++y)
        for (int x = 0; x < width; ++x) {
          const uint8_t g = planes[0][static_cast<size_t>(y) * strides[0] + x];
          uint8_t* o = &out[(static_cast<size_t>(y) * width + x) * 3];
          o[0] = o[1] = o[2] = g;
        }
      return;
    }
    bool rgb = false;
    if (jfif_) {
      rgb = false;
    } else if (adobe_) {
      rgb = adobe_transform_ == 0;
    } else {
      rgb = comp_[0].id == 82 && comp_[1].id == 71 && comp_[2].id == 66;
    }
    // jdcolor.c's tables: SCALEBITS 16, FIX(x) = x * 65536 + 0.5
    const int64_t ONE_HALF = int64_t(1) << 15;
    auto fix = [](double x) { return static_cast<int64_t>(x * 65536.0 + 0.5); };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0; i < 256; ++i) {
      const int64_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + ONE_HALF) >> 16);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + ONE_HALF) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + ONE_HALF;
    }
    auto clamp = [](int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); };
    for (int y = 0; y < height; ++y)
      for (int x = 0; x < width; ++x) {
        const int c0 = planes[0][static_cast<size_t>(y) * strides[0] + x];
        const int c1 = planes[1][static_cast<size_t>(y) * strides[1] + x];
        const int c2 = planes[2][static_cast<size_t>(y) * strides[2] + x];
        uint8_t* o = &out[(static_cast<size_t>(y) * width + x) * 3];
        if (rgb) {
          o[0] = static_cast<uint8_t>(c2);
          o[1] = static_cast<uint8_t>(c1);
          o[2] = static_cast<uint8_t>(c0);
        } else {
          o[2] = clamp(c0 + cr_r[c2]);
          o[1] = clamp(c0 + static_cast<int>((cb_g[c1] + cr_g[c2]) >> 16));
          o[0] = clamp(c0 + cb_b[c1]);
        }
      }
  }
};

void write_error(const std::string& m, char* err, int64_t errlen) {
  if (errlen <= 0) return;
  const size_t n = std::min(m.size(), static_cast<size_t>(errlen - 1));
  std::memcpy(err, m.data(), n);
  err[n] = 0;
}

}  // namespace

extern "C" {

// info: height, width, components, and the EXIF orientation (1-8) of the
// segments before the frame header. Returns 0, or -1 with a message in err.
int64_t jpeg_header(const uint8_t* data, int64_t size, int64_t* info, char* err, int64_t errlen) {
  try {
    Decoder d(data, static_cast<size_t>(size));
    d.header_only();
    info[0] = d.height;
    info[1] = d.width;
    info[2] = d.ncomp;
    info[3] = d.orientation;
    return 0;
  } catch (const Error& e) {
    write_error(e.msg, err, errlen);
    return -1;
  } catch (const std::exception& e) {
    write_error(e.what(), err, errlen);
    return -1;
  }
}

// out: (height, width, 3) BGR of the stored image (no orientation);
// orientation: the EXIF orientation (1-8) found in the whole file.
// Returns 0, or -1 with a message in err.
int64_t jpeg_decode(const uint8_t* data, int64_t size, uint8_t* out, int64_t capacity,
                    int64_t* orientation, char* err, int64_t errlen) {
  try {
    Decoder d(data, static_cast<size_t>(size));
    d.decode();
    *orientation = d.orientation;
    if (static_cast<int64_t>(d.out.size()) != capacity) {
      write_error("the output buffer does not fit the image", err, errlen);
      return -1;
    }
    std::memcpy(out, d.out.data(), d.out.size());
    return 0;
  } catch (const Error& e) {
    write_error(e.msg, err, errlen);
    return -1;
  } catch (const std::exception& e) {
    write_error(e.what(), err, errlen);
    return -1;
  }
}

}  // extern "C"
