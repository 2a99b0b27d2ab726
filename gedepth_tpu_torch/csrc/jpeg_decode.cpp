// A baseline and extended-sequential Huffman JPEG decoder on the host
// (ITU-T T.81), 8-bit, with libjpeg's arithmetic wherever it decides a
// pixel, so that the output equals libjpeg-turbo's (and PIL's) bit for bit:
//
//   * markers SOF0/SOF1, DHT, DQT, DRI, SOS, APP0 (JFIF), APP14 (Adobe),
//     restart markers; interleaved and single-component scans;
//   * Huffman decoding (a 9-bit lookahead, then the code lengths in turn)
//     and dequantisation with the table latched at a component's first
//     scan, as jdinput.c latches it;
//   * the `islow` integer IDCT of jidctint.c (13 constant bits, 2 pass-1
//     bits), its output clamped to 0..255;
//   * "fancy" upsampling of jdsample.c: h2v1 (4:2:2) and h2v2 (4:2:0)
//     triangle filters with the alternating +8/+7 (h2v2) and +1/+2 (h2v1)
//     biases, the rows above the first and below the last replicating
//     them (jdmainct.c's context rows); a chroma plane of 2 columns or
//     fewer is replicated instead, as libjpeg-turbo's jdsample.c does;
//   * the fixed-point YCbCr -> RGB tables of jdcolor.c (16 scale bits);
//   * gray replicated to RGB, as PIL's convert("RGB") replicates it.
//
// `jpeg_decode` returns 0 and fills `out` with (height, width, 3) RGB
// bytes; 1 when the file is of a kind this decoder does not read
// (progressive, lossless, hierarchical or arithmetic-coded, not 8-bit,
// CMYK, YCCK, RGB-coded, a sampling other than 4:4:4, 4:2:2, 4:2:0 or
// gray), with the kind in `msg`; 2 when it is not a readable JPEG, with
// the reason in `msg`. `jpeg_size` reads the frame header alone.
#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Refused {
  std::string what;
};
struct Corrupt {
  std::string what;
};

// zigzag position -> natural (row-major) index; 16 extra entries catch a
// run that overflows the block, as libjpeg's jpeg_natural_order does
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLookBits = 9;

struct Huffman {
  bool defined = false;
  uint8_t vals[256] = {};
  int32_t maxcode[18] = {};   // largest code of each length, -1 if none
  int32_t valoffset[18] = {}; // vals index of a code of that length - code
  uint16_t look[1 << kLookBits] = {};  // (length << 8) | value, 0 = slower

  void build(const uint8_t* bits, const uint8_t* v, int n) {
    std::memcpy(vals, v, n);
    int32_t code = 0;
    int k = 0;
    std::memset(look, 0, sizeof(look));
    for (int len = 1; len <= 16; ++len) {
      const int count = bits[len - 1];
      if (count == 0) {
        maxcode[len] = -1;
      } else {
        valoffset[len] = k - code;
        for (int i = 0; i < count; ++i, ++k, ++code) {
          if (code >= (1 << len)) throw Corrupt{"bad Huffman table"};
          if (len <= kLookBits) {
            const int shift = kLookBits - len;
            for (int fill = 0; fill < (1 << shift); ++fill)
              look[(code << shift) | fill] =
                  static_cast<uint16_t>((len << 8) | vals[k]);
          }
        }
        maxcode[len] = code - 1;
      }
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;   // sentinel: no code is longer than 16
    defined = true;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;            // Huffman tables of the current scan
  bool latched = false;
  int16_t quant[64] = {};        // natural order
  int bw = 0, bh = 0;            // blocks in the coefficient buffer
  int dw = 0, dh = 0;            // samples of the component
  std::vector<int16_t> coef;     // bh x bw blocks of 64 (natural order)
  std::vector<uint8_t> plane;    // (bh * 8) x (bw * 8) samples
};

class Decoder {
 public:
  Decoder(const uint8_t* data, size_t n) : d_(data), n_(n) {}

  void header_only() {
    parse(true);
  }

  void decode(uint8_t* out) {
    parse(false);
    if (!saw_scan_) throw Corrupt{"no scan before the end of the file"};
    for (Component& c : comps_) idct_component(c);
    if (comps_.size() == 1) {
      const Component& c = comps_[0];
      for (int y = 0; y < height_; ++y) {
        const uint8_t* row = &c.plane[static_cast<size_t>(y) * c.bw * 8];
        uint8_t* o = out + static_cast<size_t>(y) * width_ * 3;
        for (int x = 0; x < width_; ++x) o[3 * x] = o[3 * x + 1] =
            o[3 * x + 2] = row[x];
      }
      return;
    }
    int up_w = 0;
    std::vector<uint8_t> cb = upsample(comps_[1], &up_w);
    std::vector<uint8_t> cr = upsample(comps_[2], &up_w);
    color(comps_[0], cb, cr, up_w, out);
  }

  int height() const { return height_; }
  int width() const { return width_; }

 private:
  // ---- bytes and markers ----
  int byte() {
    if (pos_ >= n_) throw Corrupt{"unexpected end of file"};
    return d_[pos_++];
  }
  int u16() {
    const int hi = byte();
    return (hi << 8) | byte();
  }
  // the next marker code, skipping whatever precedes it (libjpeg's
  // next_marker skips garbage and fill bytes)
  int next_marker() {
    for (;;) {
      while (pos_ < n_ && d_[pos_] != 0xFF) ++pos_;
      while (pos_ < n_ && d_[pos_] == 0xFF) ++pos_;
      if (pos_ >= n_) throw Corrupt{"unexpected end of file"};
      const int m = d_[pos_++];
      if (m != 0) return m;
    }
  }

  void parse(bool header_only) {
    if (n_ < 4 || d_[0] != 0xFF || d_[1] != 0xD8)
      throw Corrupt{"no SOI marker"};
    pos_ = 2;
    for (;;) {
      const int m = next_marker();
      if (m == 0xD9) return;                          // EOI
      if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
      const int len = u16();
      if (len < 2 || pos_ + len - 2 > n_)
        throw Corrupt{"a marker segment runs past the end of the file"};
      const size_t end = pos_ + len - 2;
      if (m == 0xC0 || m == 0xC1) {
        frame(end);
        if (header_only) return;
      } else if (m == 0xC2 || m == 0xC6 || m == 0xCA || m == 0xCE) {
        throw Refused{"progressive"};
      } else if (m == 0xC3 || m == 0xC7 || m == 0xCB || m == 0xCF) {
        throw Refused{"lossless"};
      } else if (m == 0xC5) {
        throw Refused{"hierarchical"};
      } else if (m == 0xC9) {
        throw Refused{"arithmetic-coded"};
      } else if (m == 0xC4) {
        huffman_tables(end);
      } else if (m == 0xDB) {
        quant_tables(end);
      } else if (m == 0xDD) {
        restart_interval_ = u16();
      } else if (m == 0xDA) {
        if (comps_.empty()) throw Corrupt{"a scan before the frame header"};
        scan(end);
        continue;                                     // pos_ is past it
      } else if (m == 0xE0) {
        if (len >= 7 && std::memcmp(d_ + pos_, "JFIF\0", 5) == 0)
          jfif_ = true;
      } else if (m == 0xEE) {
        if (len >= 14 && std::memcmp(d_ + pos_, "Adobe", 5) == 0) {
          adobe_ = true;
          adobe_transform_ = d_[pos_ + 11];
        }
      }
      pos_ = end;
    }
  }

  void frame(size_t end) {
    if (!comps_.empty()) throw Corrupt{"two frame headers"};
    const int precision = byte();
    height_ = u16();
    width_ = u16();
    const int nf = byte();
    if (precision != 8) throw Refused{std::to_string(precision) + "-bit"};
    if (height_ == 0) throw Refused{"height given by a DNL marker"};
    if (width_ == 0 || nf < 1 || pos_ + 3 * nf > end)
      throw Corrupt{"bad frame header"};
    for (int i = 0; i < nf; ++i) {
      Component c;
      c.id = byte();
      const int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        throw Corrupt{"bad sampling factors or quantisation table"};
      comps_.push_back(c);
    }
    if (nf == 4)
      throw Refused{adobe_ && adobe_transform_ == 2 ? "YCCK" : "CMYK"};
    if (nf != 1 && nf != 3)
      throw Refused{std::to_string(nf) + "-component"};
    if (nf == 3) {
      bool rgb;
      if (jfif_) {
        rgb = false;
      } else if (adobe_) {
        rgb = adobe_transform_ == 0;
      } else {
        rgb = comps_[0].id == 'R' && comps_[1].id == 'G' &&
              comps_[2].id == 'B';
      }
      if (rgb) throw Refused{"RGB-coded"};
      const Component &y = comps_[0], &b = comps_[1], &r = comps_[2];
      const bool ok = b.h == r.h && b.v == r.v && y.h % b.h == 0 &&
                      y.v % b.v == 0 && y.h >= b.h && y.v >= b.v;
      const int rh = ok ? y.h / b.h : 0, rv = ok ? y.v / b.v : 0;
      if (!ok || !((rh == 1 && rv == 1) || (rh == 2 && rv == 1) ||
                   (rh == 2 && rv == 2))) {
        char buf[64];
        std::snprintf(buf, sizeof(buf), "sampling %dx%d,%dx%d,%dx%d", y.h,
                      y.v, b.h, b.v, r.h, r.v);
        throw Refused{buf};
      }
    } else {
      comps_[0].h = comps_[0].v = 1;   // one component: one block an MCU
    }
    hmax_ = vmax_ = 1;
    for (const Component& c : comps_) {
      hmax_ = std::max(hmax_, c.h);
      vmax_ = std::max(vmax_, c.v);
    }
    mcux_ = (width_ + 8 * hmax_ - 1) / (8 * hmax_);
    mcuy_ = (height_ + 8 * vmax_ - 1) / (8 * vmax_);
    for (Component& c : comps_) {
      c.dw = static_cast<int>((static_cast<int64_t>(width_) * c.h + hmax_ - 1)
                              / hmax_);
      c.dh = static_cast<int>((static_cast<int64_t>(height_) * c.v + vmax_ - 1)
                              / vmax_);
      c.bw = mcux_ * c.h;
      c.bh = mcuy_ * c.v;
    }
  }

  void huffman_tables(size_t end) {
    while (pos_ < end) {
      const int tc_th = byte();
      const int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) throw Corrupt{"bad Huffman table class or id"};
      uint8_t bits[16];
      int total = 0;
      for (int i = 0; i < 16; ++i) total += bits[i] = byte();
      if (total > 256 || pos_ + total > end)
        throw Corrupt{"bad Huffman table"};
      (tc == 0 ? dc_ : ac_)[th].build(bits, d_ + pos_, total);
      pos_ += total;
    }
  }

  void quant_tables(size_t end) {
    while (pos_ < end) {
      const int pq_tq = byte();
      const int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (pq > 1 || tq > 3) throw Corrupt{"bad quantisation table"};
      for (int k = 0; k < 64; ++k) {
        const int q = pq ? u16() : byte();
        // libjpeg multiplies by a short (ISLOW_MULT_TYPE)
        quant_[tq][kNatural[k]] = static_cast<int16_t>(q);
      }
      quant_defined_[tq] = true;
    }
  }

  // ---- the entropy-coded segment ----
  void fill() {
    while (bits_ <= 56) {
      int b = 0;
      if (!hit_marker_ && pos_ < n_) {
        b = d_[pos_];
        if (b == 0xFF) {
          size_t p = pos_ + 1;
          while (p < n_ && d_[p] == 0xFF) ++p;
          if (p < n_ && d_[p] == 0x00) {
            pos_ = p + 1;
          } else {                 // a marker: stop before it, feed zeros
            hit_marker_ = true;
            b = 0;
          }
        } else {
          ++pos_;
        }
      }
      buf_ |= static_cast<uint64_t>(b) << (56 - bits_);
      bits_ += 8;
    }
  }
  int get_bits(int n) {
    if (n == 0) return 0;
    if (bits_ < n) fill();
    const int v = static_cast<int>(buf_ >> (64 - n));
    buf_ <<= n;
    bits_ -= n;
    return v;
  }
  int decode_huffman(const Huffman& t) {
    if (bits_ < 16) fill();
    const int look = t.look[buf_ >> (64 - kLookBits)];
    if (look) {
      const int len = look >> 8;
      buf_ <<= len;
      bits_ -= len;
      return look & 0xFF;
    }
    int len = kLookBits + 1;
    int32_t code = static_cast<int32_t>(buf_ >> (64 - len));
    while (len <= 16 && code > t.maxcode[len]) {
      ++len;
      code = static_cast<int32_t>(buf_ >> (64 - len));
    }
    if (len > 16) throw Corrupt{"bad Huffman code"};
    buf_ <<= len;
    bits_ -= len;
    return t.vals[(t.valoffset[len] + code) & 0xFF];
  }
  static int extend(int v, int t) {
    return v < (1 << (t - 1)) ? v - (1 << t) + 1 : v;
  }

  void decode_block(Component& c, int16_t* block, int& pred) {
    const int t = decode_huffman(dc_[c.td]);
    if (t > 15) throw Corrupt{"bad DC magnitude"};
    if (t) pred += extend(get_bits(t), t);
    block[0] = static_cast<int16_t>(pred);
    const Huffman& ac = ac_[c.ta];
    for (int k = 1; k < 64; ++k) {
      const int rs = decode_huffman(ac);
      const int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        block[kNatural[k]] = static_cast<int16_t>(extend(get_bits(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  void restart(int expected) {
    buf_ = 0;
    bits_ = 0;
    hit_marker_ = false;
    const int m = next_marker();
    if (m != 0xD0 + expected)
      throw Corrupt{"a restart marker is missing or out of order"};
  }

  void scan(size_t end) {
    const int ns = byte();
    if (ns < 1 || ns > 4 || pos_ + 2 * ns + 3 > end)
      throw Corrupt{"bad scan header"};
    std::vector<Component*> sc;
    for (int i = 0; i < ns; ++i) {
      const int id = byte(), tables = byte();
      Component* found = nullptr;
      for (Component& c : comps_) if (c.id == id) found = &c;
      if (!found) throw Corrupt{"a scan names an unknown component"};
      found->td = tables >> 4;
      found->ta = tables & 15;
      if (found->td > 3 || found->ta > 3 ||
          !dc_[found->td].defined || !ac_[found->ta].defined)
        throw Corrupt{"a scan uses an undefined Huffman table"};
      sc.push_back(found);
    }
    const int ss = byte(), se = byte(), ahal = byte();
    if (ss != 0 || se != 63 || ahal != 0)
      throw Corrupt{"a sequential scan with a spectral selection"};
    pos_ = end;
    saw_scan_ = true;
    for (Component* c : sc) {
      if (!c->latched) {
        if (!quant_defined_[c->tq])
          throw Corrupt{"a component's quantisation table is undefined"};
        std::memcpy(c->quant, quant_[c->tq], sizeof(c->quant));
        c->latched = true;
        c->coef.assign(static_cast<size_t>(c->bw) * c->bh * 64, 0);
      }
    }
    buf_ = 0;
    bits_ = 0;
    hit_marker_ = false;
    int pred[4] = {0, 0, 0, 0};
    int64_t mcus_x, mcus_y;
    if (ns == 1) {          // non-interleaved: one block an MCU
      mcus_x = (sc[0]->dw + 7) / 8;
      mcus_y = (sc[0]->dh + 7) / 8;
    } else {
      mcus_x = mcux_;
      mcus_y = mcuy_;
    }
    int64_t todo = restart_interval_, next_rst = 0;
    for (int64_t my = 0; my < mcus_y; ++my) {
      for (int64_t mx = 0; mx < mcus_x; ++mx) {
        if (restart_interval_ && todo == 0) {
          restart(static_cast<int>(next_rst));
          next_rst = (next_rst + 1) & 7;
          todo = restart_interval_;
          for (int& p : pred) p = 0;
        }
        for (int i = 0; i < ns; ++i) {
          Component& c = *sc[i];
          const int bh = ns == 1 ? 1 : c.v, bwn = ns == 1 ? 1 : c.h;
          for (int by = 0; by < bh; ++by)
            for (int bx = 0; bx < bwn; ++bx) {
              const int64_t row = ns == 1 ? my : my * c.v + by;
              const int64_t col = ns == 1 ? mx : mx * c.h + bx;
              decode_block(c, &c.coef[(row * c.bw + col) * 64], pred[i]);
            }
        }
        if (restart_interval_) --todo;
      }
    }
    pos_ = std::min(pos_, n_);
  }

  // ---- jidctint.c: jpeg_idct_islow ----
  static void idct_islow(const int16_t* in, const int16_t* q, uint8_t* out,
                         int stride) {
    constexpr int kConst = 13, kPass1 = 2;
    constexpr int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433,
                      F0765 = 6270, F0899 = 7373, F1175 = 9633,
                      F1501 = 12299, F1847 = 15137, F1961 = 16069,
                      F2053 = 16819, F2562 = 20995, F3072 = 25172;
    auto descale = [](int64_t x, int n) {
      return (x + (int64_t{1} << (n - 1))) >> n;
    };
    int ws[64];
    for (int col = 0; col < 8; ++col) {
      const int16_t* ip = in + col;
      const int16_t* qp = q + col;
      auto deq = [&](int r) {
        return static_cast<int64_t>(static_cast<int>(ip[8 * r]) *
                                    static_cast<int>(qp[8 * r]));
      };
      if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 &&
          ip[40] == 0 && ip[48] == 0 && ip[56] == 0) {
        const int dc = static_cast<int>(deq(0) * (1 << kPass1));
        for (int r = 0; r < 8; ++r) ws[8 * r + col] = dc;
        continue;
      }
      int64_t z2 = deq(2), z3 = deq(6);
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * -F1847;
      int64_t tmp3 = z1 + z2 * F0765;
      z2 = deq(0);
      z3 = deq(4);
      int64_t tmp0 = (z2 + z3) * (int64_t{1} << kConst);
      int64_t tmp1 = (z2 - z3) * (int64_t{1} << kConst);
      const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = deq(7);
      tmp1 = deq(5);
      tmp2 = deq(3);
      tmp3 = deq(1);
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      const int64_t z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      constexpr int s = kConst - kPass1;
      ws[col] = static_cast<int>(descale(tmp10 + tmp3, s));
      ws[56 + col] = static_cast<int>(descale(tmp10 - tmp3, s));
      ws[8 + col] = static_cast<int>(descale(tmp11 + tmp2, s));
      ws[48 + col] = static_cast<int>(descale(tmp11 - tmp2, s));
      ws[16 + col] = static_cast<int>(descale(tmp12 + tmp1, s));
      ws[40 + col] = static_cast<int>(descale(tmp12 - tmp1, s));
      ws[24 + col] = static_cast<int>(descale(tmp13 + tmp0, s));
      ws[32 + col] = static_cast<int>(descale(tmp13 - tmp0, s));
    }
    auto limit = [](int64_t x) {       // centred sample -> 0..255
      x += 128;
      return static_cast<uint8_t>(x < 0 ? 0 : (x > 255 ? 255 : x));
    };
    constexpr int s2 = kConst + kPass1 + 3;
    for (int row = 0; row < 8; ++row) {
      const int* w = ws + 8 * row;
      uint8_t* o = out + static_cast<size_t>(row) * stride;
      if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 &&
          w[6] == 0 && w[7] == 0) {
        const uint8_t v = limit(descale(w[0], kPass1 + 3));
        for (int i = 0; i < 8; ++i) o[i] = v;
        continue;
      }
      int64_t z2 = w[2], z3 = w[6];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * -F1847;
      int64_t tmp3 = z1 + z2 * F0765;
      int64_t tmp0 = (int64_t{w[0]} + w[4]) * (int64_t{1} << kConst);
      int64_t tmp1 = (int64_t{w[0]} - w[4]) * (int64_t{1} << kConst);
      const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = w[7];
      tmp1 = w[5];
      tmp2 = w[3];
      tmp3 = w[1];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      const int64_t z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      o[0] = limit(descale(tmp10 + tmp3, s2));
      o[7] = limit(descale(tmp10 - tmp3, s2));
      o[1] = limit(descale(tmp11 + tmp2, s2));
      o[6] = limit(descale(tmp11 - tmp2, s2));
      o[2] = limit(descale(tmp12 + tmp1, s2));
      o[5] = limit(descale(tmp12 - tmp1, s2));
      o[3] = limit(descale(tmp13 + tmp0, s2));
      o[4] = limit(descale(tmp13 - tmp0, s2));
    }
  }

  static void idct_component(Component& c) {
    if (!c.latched) throw Corrupt{"a component is in no scan"};
    const int stride = c.bw * 8;
    c.plane.assign(static_cast<size_t>(stride) * c.bh * 8, 0);
    for (int by = 0; by < c.bh; ++by)
      for (int bx = 0; bx < c.bw; ++bx)
        idct_islow(&c.coef[(static_cast<size_t>(by) * c.bw + bx) * 64],
                   c.quant,
                   &c.plane[static_cast<size_t>(by) * 8 * stride + bx * 8],
                   stride);
  }

  // ---- jdsample.c: fullsize, h2v1 and h2v2 fancy upsampling ----
  // the upsampled samples of a chroma component; `*out_stride` receives
  // the length of their rows
  std::vector<uint8_t> upsample(const Component& c, int* out_stride) const {
    const int stride = c.bw * 8;
    const int rh = hmax_ / c.h, rv = vmax_ / c.v;
    if (rh == 1 && rv == 1) {
      *out_stride = stride;
      return c.plane;
    }
    const int out_w = c.dw * 2;
    *out_stride = out_w;
    const int out_h = c.dh * rv;
    std::vector<uint8_t> out(static_cast<size_t>(out_w) * out_h);
    auto row = [&](int r) {       // context rows replicate the edges
      r = r < 0 ? 0 : (r >= c.dh ? c.dh - 1 : r);
      return &c.plane[static_cast<size_t>(r) * stride];
    };
    if (c.dw <= 2) {              // jdsample.c: fancy only past 2 columns
      for (int r = 0; r < out_h; ++r) {
        const uint8_t* in = row(r / rv);
        uint8_t* o = &out[static_cast<size_t>(r) * out_w];
        for (int i = 0; i < out_w; ++i) o[i] = in[i / 2];
      }
      return out;
    }
    if (rv == 1) {                // h2v1
      for (int r = 0; r < c.dh; ++r) {
        const uint8_t* in = row(r);
        uint8_t* o = &out[static_cast<size_t>(r) * out_w];
        int v = in[0];
        *o++ = static_cast<uint8_t>(v);
        *o++ = static_cast<uint8_t>((v * 3 + in[1] + 2) >> 2);
        int i = 1;
        for (int n = c.dw - 2; n > 0; --n, ++i) {
          v = in[i] * 3;
          *o++ = static_cast<uint8_t>((v + in[i - 1] + 1) >> 2);
          *o++ = static_cast<uint8_t>((v + in[i + 1] + 2) >> 2);
        }
        v = in[i];
        *o++ = static_cast<uint8_t>((v * 3 + in[i - 1] + 1) >> 2);
        *o++ = static_cast<uint8_t>(v);
      }
      return out;
    }
    for (int r = 0; r < c.dh; ++r) {  // h2v2
      for (int half = 0; half < 2; ++half) {
        const uint8_t* in0 = row(r);
        const uint8_t* in1 = row(half == 0 ? r - 1 : r + 1);
        uint8_t* o = &out[(static_cast<size_t>(r) * 2 + half) * out_w];
        int this_sum = in0[0] * 3 + in1[0];
        int next_sum = in0[1] * 3 + in1[1];
        *o++ = static_cast<uint8_t>((this_sum * 4 + 8) >> 4);
        *o++ = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
        int last_sum = this_sum;
        this_sum = next_sum;
        int i = 2;
        for (int n = c.dw - 2; n > 0; --n, ++i) {
          next_sum = in0[i] * 3 + in1[i];
          *o++ = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
          *o++ = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
          last_sum = this_sum;
          this_sum = next_sum;
        }
        *o++ = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
        *o++ = static_cast<uint8_t>((this_sum * 4 + 7) >> 4);
      }
    }
    return out;
  }

  // ---- jdcolor.c: ycc_rgb_convert ----
  void color(const Component& y, const std::vector<uint8_t>& cb,
             const std::vector<uint8_t>& cr, int up_w, uint8_t* out) const {
    constexpr int kScale = 16;
    constexpr int64_t kHalf = int64_t{1} << (kScale - 1);
    auto fix = [](double x) {
      return static_cast<int64_t>(x * (1 << kScale) + 0.5);
    };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0; i < 256; ++i) {
      const int64_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + kHalf) >> kScale);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + kHalf) >> kScale);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kHalf;
    }
    auto clamp = [](int v) {
      return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
    };
    const int ystride = y.bw * 8;
    for (int r = 0; r < height_; ++r) {
      const uint8_t* yr = &y.plane[static_cast<size_t>(r) * ystride];
      const uint8_t* br = &cb[static_cast<size_t>(r) * up_w];
      const uint8_t* rr = &cr[static_cast<size_t>(r) * up_w];
      uint8_t* o = out + static_cast<size_t>(r) * width_ * 3;
      for (int x = 0; x < width_; ++x) {
        const int yy = yr[x], b = br[x], rc = rr[x];
        o[3 * x] = clamp(yy + cr_r[rc]);
        o[3 * x + 1] = clamp(yy + static_cast<int>(
                                      (cb_g[b] + cr_g[rc]) >> kScale));
        o[3 * x + 2] = clamp(yy + cb_b[b]);
      }
    }
  }

  const uint8_t* d_;
  size_t n_;
  size_t pos_ = 0;
  int height_ = 0, width_ = 0, hmax_ = 1, vmax_ = 1, mcux_ = 0, mcuy_ = 0;
  int restart_interval_ = 0;
  bool jfif_ = false, adobe_ = false, saw_scan_ = false;
  int adobe_transform_ = -1;
  std::vector<Component> comps_;
  Huffman dc_[4], ac_[4];
  int16_t quant_[4][64] = {};
  bool quant_defined_[4] = {false, false, false, false};
  uint64_t buf_ = 0;
  int bits_ = 0;
  bool hit_marker_ = false;
};

int report(const std::string& what, char* msg, int cap, int rc) {
  if (msg && cap > 0) {
    std::strncpy(msg, what.c_str(), cap - 1);
    msg[cap - 1] = 0;
  }
  return rc;
}

}  // namespace

extern "C" int jpeg_size(const uint8_t* data, int64_t n, int32_t* hw,
                         char* msg, int cap) {
  try {
    Decoder dec(data, static_cast<size_t>(n));
    dec.header_only();
    if (dec.height() == 0) return report("no frame header", msg, cap, 2);
    hw[0] = dec.height();
    hw[1] = dec.width();
    return 0;
  } catch (const Refused& e) {
    return report(e.what, msg, cap, 1);
  } catch (const Corrupt& e) {
    return report(e.what, msg, cap, 2);
  } catch (const std::exception& e) {
    return report(e.what(), msg, cap, 2);
  }
}

extern "C" int jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out,
                           int64_t out_bytes, char* msg, int cap) {
  try {
    Decoder dec(data, static_cast<size_t>(n));
    Decoder head(data, static_cast<size_t>(n));
    head.header_only();
    if (static_cast<int64_t>(head.height()) * head.width() * 3 != out_bytes)
      return report("the output buffer does not fit the frame", msg, cap, 2);
    dec.decode(out);
    return 0;
  } catch (const Refused& e) {
    return report(e.what, msg, cap, 1);
  } catch (const Corrupt& e) {
    return report(e.what, msg, cap, 2);
  } catch (const std::exception& e) {
    return report(e.what(), msg, cap, 2);
  }
}
