// PIZ codec (OpenEXR wavelet + Huffman compression), C++ host-side.
//
// The reference reads whatever EXR OpenCV's OpenEXR build handles
// (util/CvUtil.cpp imread path); PIZ is the most common wavelet default
// from capture tooling, so real-capture interop needs it. Implemented from
// the OpenEXR 2.x format specification (ImfPizCompressor / ImfHuf / ImfWav
// semantics): range-compaction LUT from a bitmap of used u16 values, a
// 2-level 2D Haar-like integer wavelet per channel plane, and a canonical
// Huffman coder with a 14-bit fast decode table and an explicit
// run-length pseudo-symbol.
//
// Layout contract with the Python caller (core/exr.py): channel-major
// planes — for each channel (file order), ny rows of nx*size uint16s,
// where size = pixel bytes / 2 (HALF=1, FLOAT/UINT=2) and a pixel's u16s
// are adjacent in memory order (little-endian reinterpret round-trips).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int USHORT_RANGE = 1 << 16;
constexpr int BITMAP_SIZE = USHORT_RANGE >> 3;

constexpr int HUF_ENCBITS = 16;
constexpr int HUF_DECBITS = 14;
constexpr int HUF_ENCSIZE = (1 << HUF_ENCBITS) + 1;
constexpr int HUF_DECSIZE = 1 << HUF_DECBITS;
constexpr int HUF_DECMASK = HUF_DECSIZE - 1;

constexpr int SHORT_ZEROCODE_RUN = 59;
constexpr int LONG_ZEROCODE_RUN = 63;
constexpr int SHORTEST_LONG_RUN = 2 + LONG_ZEROCODE_RUN - SHORT_ZEROCODE_RUN;
constexpr int LONGEST_LONG_RUN = 255 + SHORTEST_LONG_RUN;

inline int hufLength(uint64_t code) { return int(code & 63); }
inline uint64_t hufCode(uint64_t code) { return code >> 6; }

// ---------------------------------------------------------------- wavelet

constexpr int W_NBITS = 16;
constexpr int A_OFFSET = 1 << (W_NBITS - 1);
constexpr int M_OFFSET = 1 << (W_NBITS - 1);
constexpr int MOD_MASK = (1 << W_NBITS) - 1;

inline void wenc14(uint16_t a, uint16_t b, uint16_t& l, uint16_t& h) {
  int16_t as = int16_t(a), bs = int16_t(b);
  int16_t ms = int16_t((as + bs) >> 1);
  int16_t ds = int16_t(as - bs);
  l = uint16_t(ms);
  h = uint16_t(ds);
}

inline void wdec14(uint16_t l, uint16_t h, uint16_t& a, uint16_t& b) {
  int16_t ls = int16_t(l), hs = int16_t(h);
  int hi = hs;
  int ai = ls + (hi & 1) + (hi >> 1);
  int16_t as = int16_t(ai);
  int16_t bs = int16_t(ai - hi);
  a = uint16_t(as);
  b = uint16_t(bs);
}

inline void wenc16(uint16_t a, uint16_t b, uint16_t& l, uint16_t& h) {
  int ao = (a + A_OFFSET) & MOD_MASK;
  int m = (ao + b) >> 1;
  int d = ao - b;
  if (d < 0) m = (m + M_OFFSET) & MOD_MASK;
  d &= MOD_MASK;
  l = uint16_t(m);
  h = uint16_t(d);
}

inline void wdec16(uint16_t l, uint16_t h, uint16_t& a, uint16_t& b) {
  int m = l;
  int d = h;
  int bb = (m - (d >> 1)) & MOD_MASK;
  int aa = (d + bb - A_OFFSET) & MOD_MASK;
  b = uint16_t(bb);
  a = uint16_t(aa);
}

// 2D wavelet transform of an (ny, nx) plane at element strides (oy, ox),
// levels from fine to coarse; mx selects the 14-bit vs mod-2^16 filter.
void wav2Encode(uint16_t* in, int nx, int ox, int ny, int oy, uint16_t mx) {
  bool w14 = (mx < (1 << 14));
  int n = (nx > ny) ? ny : nx;
  int p = 1, p2 = 2;

  while (p2 <= n) {
    uint16_t* py = in;
    uint16_t* ey = in + (long)oy * (ny - p2);
    int oy1 = oy * p, oy2 = oy * p2;
    int ox1 = ox * p, ox2 = ox * p2;
    uint16_t i00, i01, i10, i11;
    uint16_t* px = py;

    for (; py <= ey; py += oy2) {
      px = py;
      uint16_t* ex = py + (long)ox * (nx - p2);
      for (; px <= ex; px += ox2) {
        uint16_t* p01 = px + ox1;
        uint16_t* p10 = px + oy1;
        uint16_t* p11 = p10 + ox1;
        if (w14) {
          wenc14(*px, *p01, i00, i01);
          wenc14(*p10, *p11, i10, i11);
          wenc14(i00, i10, *px, *p10);
          wenc14(i01, i11, *p01, *p11);
        } else {
          wenc16(*px, *p01, i00, i01);
          wenc16(*p10, *p11, i10, i11);
          wenc16(i00, i10, *px, *p10);
          wenc16(i01, i11, *p01, *p11);
        }
      }
      if (nx & p) {
        uint16_t* p10 = px + oy1;
        if (w14)
          wenc14(*px, *p10, i00, *p10);
        else
          wenc16(*px, *p10, i00, *p10);
        *px = i00;
      }
    }
    if (ny & p) {
      px = py;
      uint16_t* ex = py + (long)ox * (nx - p2);
      for (; px <= ex; px += ox2) {
        uint16_t* p01 = px + ox1;
        if (w14)
          wenc14(*px, *p01, i00, *p01);
        else
          wenc16(*px, *p01, i00, *p01);
        *px = i00;
      }
    }
    p = p2;
    p2 <<= 1;
  }
}

void wav2Decode(uint16_t* in, int nx, int ox, int ny, int oy, uint16_t mx) {
  bool w14 = (mx < (1 << 14));
  int n = (nx > ny) ? ny : nx;
  int p = 1, p2;

  while (p <= n) p <<= 1;
  p >>= 1;
  p2 = p;
  p >>= 1;

  while (p >= 1) {
    uint16_t* py = in;
    uint16_t* ey = in + (long)oy * (ny - p2);
    int oy1 = oy * p, oy2 = oy * p2;
    int ox1 = ox * p, ox2 = ox * p2;
    uint16_t i00, i01, i10, i11;
    uint16_t* px = py;

    for (; py <= ey; py += oy2) {
      px = py;
      uint16_t* ex = py + (long)ox * (nx - p2);
      for (; px <= ex; px += ox2) {
        uint16_t* p01 = px + ox1;
        uint16_t* p10 = px + oy1;
        uint16_t* p11 = p10 + ox1;
        if (w14) {
          wdec14(*px, *p10, i00, i10);
          wdec14(*p01, *p11, i01, i11);
          wdec14(i00, i01, *px, *p01);
          wdec14(i10, i11, *p10, *p11);
        } else {
          wdec16(*px, *p10, i00, i10);
          wdec16(*p01, *p11, i01, i11);
          wdec16(i00, i01, *px, *p01);
          wdec16(i10, i11, *p10, *p11);
        }
      }
      if (nx & p) {
        uint16_t* p10 = px + oy1;
        if (w14)
          wdec14(*px, *p10, i00, *p10);
        else
          wdec16(*px, *p10, i00, *p10);
        *px = i00;
      }
    }
    if (ny & p) {
      px = py;
      uint16_t* ex = py + (long)ox * (nx - p2);
      for (; px <= ex; px += ox2) {
        uint16_t* p01 = px + ox1;
        if (w14)
          wdec14(*px, *p01, i00, *p01);
        else
          wdec16(*px, *p01, i00, *p01);
        *px = i00;
      }
    }
    p2 = p;
    p >>= 1;
  }
}

// ---------------------------------------------------------------- huffman

struct BitWriter {
  uint64_t c = 0;
  int lc = 0;
  uint8_t* p;
  uint8_t* start;
  explicit BitWriter(uint8_t* out) : p(out), start(out) {}
  void outputBits(int nBits, uint64_t bits) {
    c = (c << nBits) | bits;
    lc += nBits;
    while (lc >= 8) {
      lc -= 8;
      *p++ = uint8_t(c >> lc);
    }
  }
  void outputCode(uint64_t code) { outputBits(hufLength(code), hufCode(code)); }
  long bitCount() const { return (p - start) * 8 + lc; }
  void flush() {
    if (lc) *p++ = uint8_t(c << (8 - lc));
  }
};

struct BitReader {
  uint64_t c = 0;
  int lc = 0;
  const uint8_t* p;
  const uint8_t* end;
  BitReader(const uint8_t* in, const uint8_t* e) : p(in), end(e) {}
  bool getBits(int nBits, uint64_t& out) {
    while (lc < nBits) {
      if (p >= end) return false;
      c = (c << 8) | *p++;
      lc += 8;
    }
    lc -= nBits;
    out = (c >> lc) & ((1ULL << nBits) - 1);
    return true;
  }
};

// canonical code assignment over code lengths in hcode[] (in place:
// hcode[i] becomes length | code << 6)
void canonicalCodeTable(uint64_t* hcode) {
  uint64_t n[59];
  for (int i = 0; i <= 58; ++i) n[i] = 0;
  for (int i = 0; i < HUF_ENCSIZE; ++i) n[hcode[i]] += 1;
  uint64_t c = 0;
  for (int i = 58; i > 0; --i) {
    uint64_t nc = (c + n[i]) >> 1;
    n[i] = c;
    c = nc;
  }
  for (int i = 0; i < HUF_ENCSIZE; ++i) {
    int l = int(hcode[i]);
    if (l > 0) hcode[i] = uint64_t(l) | (n[l]++ << 6);
  }
}

// Huffman tree build: lowest-two-frequency merging with linked code-length
// increment chains; appends the run-length pseudo-symbol at iM.
void buildEncTable(uint64_t* frq, int* im, int* iM) {
  std::vector<int> hlink(HUF_ENCSIZE);
  std::vector<uint64_t*> fHeap(HUF_ENCSIZE);

  *im = 0;
  while (!frq[*im]) (*im)++;
  int nf = 0;
  for (int i = *im; i < HUF_ENCSIZE; i++) {
    hlink[i] = i;
    if (frq[i]) {
      fHeap[nf++] = &frq[i];
      *iM = i;
    }
  }
  (*iM)++;
  frq[*iM] = 1;
  fHeap[nf++] = &frq[*iM];

  auto cmp = [](uint64_t* a, uint64_t* b) { return *a > *b; };
  std::make_heap(fHeap.begin(), fHeap.begin() + nf, cmp);

  std::vector<uint64_t> scode(HUF_ENCSIZE, 0);

  while (nf > 1) {
    int mm = int(fHeap[0] - frq);
    std::pop_heap(fHeap.begin(), fHeap.begin() + nf, cmp);
    --nf;
    int m = int(fHeap[0] - frq);
    std::pop_heap(fHeap.begin(), fHeap.begin() + nf, cmp);
    frq[m] += frq[mm];
    std::push_heap(fHeap.begin(), fHeap.begin() + nf, cmp);

    for (int j = m;; j = hlink[j]) {
      scode[j]++;
      if (hlink[j] == j) {
        hlink[j] = mm;
        break;
      }
    }
    for (int j = mm;; j = hlink[j]) {
      scode[j]++;
      if (hlink[j] == j) break;
    }
  }
  std::memcpy(frq, scode.data(), sizeof(uint64_t) * HUF_ENCSIZE);
  canonicalCodeTable(frq);
}

// pack code lengths [im, iM] as 6-bit values with zero-run escapes
void packEncTable(const uint64_t* hcode, int im, int iM, BitWriter& w) {
  for (; im <= iM; im++) {
    int l = hufLength(hcode[im]);
    if (l == 0) {
      int zerun = 1;
      while ((im < iM) && (zerun < LONGEST_LONG_RUN)) {
        if (hufLength(hcode[im + 1]) > 0) break;
        im++;
        zerun++;
      }
      if (zerun >= 2) {
        if (zerun >= SHORTEST_LONG_RUN) {
          w.outputBits(6, LONG_ZEROCODE_RUN);
          w.outputBits(8, zerun - SHORTEST_LONG_RUN);
        } else {
          w.outputBits(6, SHORT_ZEROCODE_RUN + zerun - 2);
        }
        continue;
      }
    }
    w.outputBits(6, l);
  }
}

int unpackEncTable(BitReader& r, int im, int iM, uint64_t* hcode) {
  std::memset(hcode, 0, sizeof(uint64_t) * HUF_ENCSIZE);
  for (; im <= iM; im++) {
    uint64_t l;
    if (!r.getBits(6, l)) return -1;
    hcode[im] = l;
    if (l == uint64_t(LONG_ZEROCODE_RUN)) {
      uint64_t z;
      if (!r.getBits(8, z)) return -1;
      uint64_t zerun = z + SHORTEST_LONG_RUN;
      if (im + int(zerun) > HUF_ENCSIZE) return -2;
      while (zerun--) hcode[im++] = 0;
      im--;
    } else if (l >= uint64_t(SHORT_ZEROCODE_RUN)) {
      uint64_t zerun = l - SHORT_ZEROCODE_RUN + 2;
      if (im + int(zerun) > HUF_ENCSIZE) return -2;
      while (zerun--) hcode[im++] = 0;
      im--;
    }
  }
  canonicalCodeTable(hcode);
  return 0;
}

struct HufDec {
  int len = 0;             // code length if <= HUF_DECBITS, else 0
  int lit = 0;             // symbol (short codes) / count (long codes)
  std::vector<int> longs;  // symbols whose code exceeds HUF_DECBITS
};

int buildDecTable(const uint64_t* hcode, int im, int iM, std::vector<HufDec>& hdecod) {
  for (; im <= iM; im++) {
    uint64_t c = hufCode(hcode[im]);
    int l = hufLength(hcode[im]);
    if (c >> l) return -3;  // code value longer than its length
    if (l > HUF_DECBITS) {
      HufDec& pl = hdecod[c >> (l - HUF_DECBITS)];
      if (pl.len) return -3;
      pl.lit++;
      pl.longs.push_back(im);
    } else if (l) {
      HufDec* pl = &hdecod[c << (HUF_DECBITS - l)];
      for (uint64_t i = 1ULL << (HUF_DECBITS - l); i > 0; i--, pl++) {
        if (pl->len || !pl->longs.empty()) return -3;
        pl->len = l;
        pl->lit = im;
      }
    }
  }
  return 0;
}

// emit one decoded symbol (or expand a run) into out
inline int emitCode(int po, int rlc, uint64_t& c, int& lc, const uint8_t*& in,
                    const uint8_t* ie, uint16_t*& out, const uint16_t* outb,
                    const uint16_t* oe) {
  if (po == rlc) {
    if (lc < 8) {
      if (in >= ie) return -4;
      c = (c << 8) | *in++;
      lc += 8;
    }
    lc -= 8;
    int cs = int((c >> lc) & 0xFF);
    if (out == outb) return -4;
    if (out + cs > oe) return -4;
    uint16_t s = out[-1];
    while (cs-- > 0) *out++ = s;
  } else if (out < oe) {
    *out++ = uint16_t(po);
  } else {
    return -4;
  }
  return 0;
}

int hufDecode(const uint64_t* hcode, const std::vector<HufDec>& hdecod,
              const uint8_t* in, long nBits, int rlc, long nRaw, uint16_t* out) {
  uint64_t c = 0;
  int lc = 0;
  const uint8_t* ie = in + (nBits + 7) / 8;
  uint16_t* outb = out;
  const uint16_t* oe = out + nRaw;

  while (in < ie) {
    c = (c << 8) | *in++;
    lc += 8;
    while (lc >= HUF_DECBITS) {
      const HufDec& pl = hdecod[(c >> (lc - HUF_DECBITS)) & HUF_DECMASK];
      if (pl.len) {
        lc -= pl.len;
        int rc = emitCode(pl.lit, rlc, c, lc, in, ie, out, outb, oe);
        if (rc) return rc;
      } else {
        if (pl.longs.empty()) return -5;
        size_t j;
        for (j = 0; j < pl.longs.size(); j++) {
          int l = hufLength(hcode[pl.longs[j]]);
          while (lc < l && in < ie) {
            c = (c << 8) | *in++;
            lc += 8;
          }
          if (lc >= l &&
              hufCode(hcode[pl.longs[j]]) == ((c >> (lc - l)) & ((1ULL << l) - 1))) {
            lc -= l;
            int rc = emitCode(pl.longs[j], rlc, c, lc, in, ie, out, outb, oe);
            if (rc) return rc;
            break;
          }
        }
        if (j == pl.longs.size()) return -5;
      }
    }
  }

  // final partial byte: nBits is the exact stream length
  int i = int((8 - nBits) & 7);
  c >>= i;
  lc -= i;
  while (lc > 0) {
    const HufDec& pl = hdecod[(c << (HUF_DECBITS - lc)) & HUF_DECMASK];
    if (pl.len && pl.len <= lc) {
      lc -= pl.len;
      int rc = emitCode(pl.lit, rlc, c, lc, in, ie, out, outb, oe);
      if (rc) return rc;
    } else {
      return -5;
    }
  }
  if (out - outb != nRaw) return -6;
  return 0;
}

// full hufCompress: [im u32][iM u32][tableLen u32][nBits u32][0 u32]
// [packed table][bitstream]; returns byte length or < 0
long hufCompress(const uint16_t* raw, long nRaw, uint8_t* out) {
  if (nRaw == 0) return 0;
  std::vector<uint64_t> freq(HUF_ENCSIZE, 0);
  for (long i = 0; i < nRaw; i++) freq[raw[i]]++;

  int im = 0, iM = 0;
  buildEncTable(freq.data(), &im, &iM);

  uint8_t* tableStart = out + 20;
  BitWriter tw(tableStart);
  packEncTable(freq.data(), im, iM, tw);
  tw.flush();
  uint32_t tableLength = uint32_t(tw.p - tableStart);

  BitWriter dw(tw.p);
  // run-length collapsed emission: repeats of the previous symbol become
  // (code, rlc-code, 8-bit count) when that is shorter
  uint64_t rlcCode = freq[iM];
  int s = raw[0];
  int cs = 0;
  auto send = [&](int sym, int count) {
    uint64_t sc = freq[sym];
    if (hufLength(sc) + hufLength(rlcCode) + 8 < hufLength(sc) * count) {
      dw.outputCode(sc);
      dw.outputCode(rlcCode);
      dw.outputBits(8, count);
    } else {
      while (count-- >= 0) dw.outputCode(sc);
    }
  };
  for (long i = 1; i < nRaw; i++) {
    if (s == raw[i] && cs < 255) {
      cs++;
    } else {
      send(s, cs);
      cs = 0;
      s = raw[i];
    }
  }
  send(s, cs);
  uint32_t nBits = uint32_t(dw.bitCount());
  dw.flush();

  uint32_t vals[5] = {uint32_t(im), uint32_t(iM), tableLength, nBits, 0};
  std::memcpy(out, vals, 20);
  return (dw.p - out);
}

long hufUncompress(const uint8_t* in, long nCompressed, uint16_t* raw, long nRaw) {
  if (nCompressed == 0) return nRaw == 0 ? 0 : -7;
  if (nCompressed < 20) return -7;
  uint32_t vals[5];
  std::memcpy(vals, in, 20);
  int im = int(vals[0]), iM = int(vals[1]);
  long nBits = long(vals[3]);
  if (im < 0 || im >= HUF_ENCSIZE || iM < 0 || iM >= HUF_ENCSIZE) return -7;

  const uint8_t* ptr = in + 20;
  std::vector<uint64_t> hcode(HUF_ENCSIZE);
  BitReader tr(ptr, in + nCompressed);
  int rc = unpackEncTable(tr, im, iM, hcode.data());
  if (rc) return rc;
  ptr = tr.p;  // table reader stops at its last consumed byte

  if (nBits > 8 * (nCompressed - (ptr - in))) return -7;
  std::vector<HufDec> hdecod(HUF_DECSIZE);
  rc = buildDecTable(hcode.data(), im, iM, hdecod);
  if (rc) return rc;
  return hufDecode(hcode.data(), hdecod, ptr, nBits, iM, nRaw, raw);
}

inline long planeTotal(int nx, int ny, int nchan, const int* sizes) {
  long total = 0;
  for (int i = 0; i < nchan; i++) total += long(nx) * ny * sizes[i];
  return total;
}

}  // namespace

extern "C" {

// in: channel-major u16 planes; out must hold >= raw bytes + 8 KiB slack.
// Returns 0 and *out_len on success, < 0 on error.
int piz_compress(const uint16_t* in_data, int nx, int ny, int nchan,
                 const int* sizes, uint8_t* out, int* out_len) {
  long total = planeTotal(nx, ny, nchan, sizes);
  if (total <= 0) {
    *out_len = 0;
    return 0;
  }
  std::vector<uint16_t> tmp(in_data, in_data + total);

  std::vector<uint8_t> bitmap(BITMAP_SIZE, 0);
  for (long i = 0; i < total; i++) bitmap[tmp[i] >> 3] |= uint8_t(1 << (tmp[i] & 7));
  bitmap[0] &= uint8_t(~1);  // zero is always present implicitly
  int minNonZero = BITMAP_SIZE - 1, maxNonZero = 0;
  for (int i = 0; i < BITMAP_SIZE; ++i)
    if (bitmap[i]) {
      if (i < minNonZero) minNonZero = i;
      if (i > maxNonZero) maxNonZero = i;
    }

  std::vector<uint16_t> lut(USHORT_RANGE);
  int k = 0;
  for (int i = 0; i < USHORT_RANGE; ++i)
    lut[i] = uint16_t(((i == 0) || (bitmap[i >> 3] & (1 << (i & 7)))) ? k++ : 0);
  uint16_t maxValue = uint16_t(k - 1);
  for (long i = 0; i < total; i++) tmp[i] = lut[tmp[i]];

  uint16_t* ptr = tmp.data();
  for (int ci = 0; ci < nchan; ci++) {
    int size = sizes[ci];
    for (int j = 0; j < size; ++j)
      wav2Encode(ptr + j, nx, size, ny, nx * size, maxValue);
    ptr += long(nx) * ny * size;
  }

  uint8_t* op = out;
  uint16_t mn = uint16_t(minNonZero), mx = uint16_t(maxNonZero);
  std::memcpy(op, &mn, 2);
  op += 2;
  std::memcpy(op, &mx, 2);
  op += 2;
  if (minNonZero <= maxNonZero) {
    std::memcpy(op, &bitmap[minNonZero], maxNonZero - minNonZero + 1);
    op += maxNonZero - minNonZero + 1;
  }
  uint8_t* lengthPtr = op;
  op += 4;
  long len = hufCompress(tmp.data(), total, op);
  if (len < 0) return int(len);
  uint32_t len32 = uint32_t(len);
  std::memcpy(lengthPtr, &len32, 4);
  op += len;
  *out_len = int(op - out);
  return 0;
}

// out: channel-major u16 planes (same layout as piz_compress input)
int piz_uncompress(const uint8_t* in, int in_len, int nx, int ny, int nchan,
                   const int* sizes, uint16_t* out) {
  long total = planeTotal(nx, ny, nchan, sizes);
  if (total <= 0) return 0;
  if (in_len < 4) return -8;

  const uint8_t* ip = in;
  uint16_t minNonZero, maxNonZero;
  std::memcpy(&minNonZero, ip, 2);
  ip += 2;
  std::memcpy(&maxNonZero, ip, 2);
  ip += 2;
  if (maxNonZero >= BITMAP_SIZE) return -8;

  std::vector<uint8_t> bitmap(BITMAP_SIZE, 0);
  if (minNonZero <= maxNonZero) {
    int nbytes = maxNonZero - minNonZero + 1;
    if (ip + nbytes > in + in_len) return -8;
    std::memcpy(&bitmap[minNonZero], ip, nbytes);
    ip += nbytes;
  }

  // reverse LUT: k-th used value (0 always used)
  std::vector<uint16_t> lut(USHORT_RANGE, 0);
  int k = 0;
  for (int i = 0; i < USHORT_RANGE; ++i)
    if ((i == 0) || (bitmap[i >> 3] & (1 << (i & 7)))) lut[k++] = uint16_t(i);
  uint16_t maxValue = uint16_t(k - 1);

  if (ip + 4 > in + in_len) return -8;
  uint32_t length;
  std::memcpy(&length, ip, 4);
  ip += 4;
  if (ip + length > in + in_len) return -8;

  long rc = hufUncompress(ip, length, out, total);
  if (rc) return int(rc);

  uint16_t* ptr = out;
  for (int ci = 0; ci < nchan; ci++) {
    int size = sizes[ci];
    for (int j = 0; j < size; ++j)
      wav2Decode(ptr + j, nx, size, ny, nx * size, maxValue);
    ptr += long(nx) * ny * size;
  }
  for (long i = 0; i < total; i++) out[i] = lut[out[i]];
  return 0;
}

}  // extern "C"
