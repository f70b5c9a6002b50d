// BC7 texture compression (mode 6) + decoder for verification.
//
// Native replacement for the reference's vendored ISPC texture compressor
// (source/thirdparty/bc7_compressor, built by ISPC.cmake — the prebuilt ispc
// binaries are not shipped in this mirror, see SURVEY.md Appendix B). Mode 6
// (single subset, 7.7.7.7 endpoints + per-endpoint P-bit, 4-bit indices) is
// the workhorse mode for opaque photographic content; output is valid BC7
// consumable by any GPU/DDS reader, including the reference's viewers.
//
// C ABI:
//   void compress_bc7(const uint8_t* rgba, int width, int height, uint8_t* out);
//     rgba: row-major RGBA8; width/height multiples of 4; out: 16 B / block.
//   void decompress_bc7_mode6(const uint8_t* blocks, int width, int height,
//                             uint8_t* rgba_out);

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

struct BitWriter {
  uint8_t* out;
  int bit = 0;
  explicit BitWriter(uint8_t* o) : out(o) { std::memset(out, 0, 16); }
  void put(uint32_t value, int count) {
    for (int i = 0; i < count; ++i) {
      if ((value >> i) & 1) out[(bit + i) >> 3] |= uint8_t(1u << ((bit + i) & 7));
    }
    bit += count;
  }
};

struct BitReader {
  const uint8_t* in;
  int bit = 0;
  explicit BitReader(const uint8_t* i) : in(i) {}
  uint32_t get(int count) {
    uint32_t v = 0;
    for (int i = 0; i < count; ++i)
      v |= uint32_t((in[(bit + i) >> 3] >> ((bit + i) & 7)) & 1) << i;
    bit += count;
    return v;
  }
};

// BC7 interpolation weights for 4-bit indices
const int kWeights4[16] = {0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64};

inline int interpolate(int e0, int e1, int w) {
  return (e0 * (64 - w) + e1 * w + 32) >> 6;
}

// quantize an 8-bit channel to 7 bits + shared p bit, reconstructing as
// (v7 << 1 | p) << ... BC7 mode 6: endpoint = (7-bit << 1 | p), then
// expanded to 8 bits exactly (7+1 = 8 bits, no replication needed).
inline int quant7(int v8, int p) {
  int v = (v8 - p) >> 1;
  if (v < 0) v = 0;
  if (v > 127) v = 127;
  return v;
}

void encodeBlock(const uint8_t px[16][4], uint8_t* out) {
  // endpoints: min/max along the principal direction approximated by the
  // luminance axis, then least-squares refined from the index assignment
  float mean[4] = {0, 0, 0, 0};
  for (int i = 0; i < 16; ++i)
    for (int c = 0; c < 4; ++c) mean[c] += px[i][c];
  for (int c = 0; c < 4; ++c) mean[c] /= 16.0f;

  // principal axis via a few power iterations on the covariance
  float axis[4] = {1, 1, 1, 0};
  for (int it = 0; it < 4; ++it) {
    float next[4] = {0, 0, 0, 0};
    for (int i = 0; i < 16; ++i) {
      float d[4], dot = 0;
      for (int c = 0; c < 4; ++c) d[c] = px[i][c] - mean[c];
      for (int c = 0; c < 4; ++c) dot += d[c] * axis[c];
      for (int c = 0; c < 4; ++c) next[c] += dot * d[c];
    }
    float len = std::sqrt(next[0] * next[0] + next[1] * next[1] + next[2] * next[2] + next[3] * next[3]);
    if (len < 1e-10f) break;
    for (int c = 0; c < 4; ++c) axis[c] = next[c] / len;
  }

  float tmin = 1e30f, tmax = -1e30f;
  for (int i = 0; i < 16; ++i) {
    float t = 0;
    for (int c = 0; c < 4; ++c) t += (px[i][c] - mean[c]) * axis[c];
    tmin = std::min(tmin, t);
    tmax = std::max(tmax, t);
  }
  float e0f[4], e1f[4];
  for (int c = 0; c < 4; ++c) {
    e0f[c] = mean[c] + tmin * axis[c];
    e1f[c] = mean[c] + tmax * axis[c];
  }

  // two rounds: assign indices, then least-squares refit endpoints
  int indices[16];
  for (int round = 0; round < 2; ++round) {
    float len2 = 0;
    float dir[4];
    for (int c = 0; c < 4; ++c) {
      dir[c] = e1f[c] - e0f[c];
      len2 += dir[c] * dir[c];
    }
    if (len2 < 1e-10f) {
      for (int i = 0; i < 16; ++i) indices[i] = 0;
      break;
    }
    for (int i = 0; i < 16; ++i) {
      float t = 0;
      for (int c = 0; c < 4; ++c) t += (px[i][c] - e0f[c]) * dir[c];
      t /= len2;
      int idx = int(t * 15.0f + 0.5f);
      indices[i] = std::min(std::max(idx, 0), 15);
    }
    if (round == 1) break;
    // least squares: minimize sum |e0*(1-w) + e1*w - p|^2
    float a00 = 0, a01 = 0, a11 = 0;
    float b0[4] = {0, 0, 0, 0}, b1[4] = {0, 0, 0, 0};
    for (int i = 0; i < 16; ++i) {
      const float w = kWeights4[indices[i]] / 64.0f;
      a00 += (1 - w) * (1 - w);
      a01 += (1 - w) * w;
      a11 += w * w;
      for (int c = 0; c < 4; ++c) {
        b0[c] += (1 - w) * px[i][c];
        b1[c] += w * px[i][c];
      }
    }
    const float det = a00 * a11 - a01 * a01;
    if (std::fabs(det) > 1e-8f) {
      for (int c = 0; c < 4; ++c) {
        e0f[c] = (a11 * b0[c] - a01 * b1[c]) / det;
        e1f[c] = (a00 * b1[c] - a01 * b0[c]) / det;
        e0f[c] = std::min(std::max(e0f[c], 0.0f), 255.0f);
        e1f[c] = std::min(std::max(e1f[c], 0.0f), 255.0f);
      }
    }
  }

  // anchor: index 0's MSB must be 0 — swap endpoints if needed
  if (indices[0] >= 8) {
    for (int i = 0; i < 16; ++i) indices[i] = 15 - indices[i];
    for (int c = 0; c < 4; ++c) std::swap(e0f[c], e1f[c]);
  }

  // choose p bits to minimize endpoint rounding error
  int e0[4], e1[4], p0 = 0, p1 = 0;
  float err0[2] = {0, 0}, err1[2] = {0, 0};
  for (int p = 0; p < 2; ++p) {
    for (int c = 0; c < 4; ++c) {
      const int v0 = (quant7(int(e0f[c] + 0.5f), p) << 1) | p;
      const int v1 = (quant7(int(e1f[c] + 0.5f), p) << 1) | p;
      err0[p] += (v0 - e0f[c]) * (v0 - e0f[c]);
      err1[p] += (v1 - e1f[c]) * (v1 - e1f[c]);
    }
  }
  p0 = err0[1] < err0[0];
  p1 = err1[1] < err1[0];
  for (int c = 0; c < 4; ++c) {
    e0[c] = quant7(int(e0f[c] + 0.5f), p0);
    e1[c] = quant7(int(e1f[c] + 0.5f), p1);
  }

  BitWriter bw(out);
  bw.put(1u << 6, 7); // mode 6
  for (int c = 0; c < 4; ++c) {
    bw.put(uint32_t(e0[c]), 7);
    bw.put(uint32_t(e1[c]), 7);
  }
  bw.put(uint32_t(p0), 1);
  bw.put(uint32_t(p1), 1);
  bw.put(uint32_t(indices[0]), 3); // anchor: MSB implicit 0
  for (int i = 1; i < 16; ++i) bw.put(uint32_t(indices[i]), 4);
}

} // namespace

extern "C" void compress_bc7(const uint8_t* rgba, int width, int height, uint8_t* out) {
  const int bw = width / 4, bh = height / 4;
  for (int by = 0; by < bh; ++by) {
    for (int bx = 0; bx < bw; ++bx) {
      uint8_t px[16][4];
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x)
          std::memcpy(px[y * 4 + x], rgba + ((by * 4 + y) * width + bx * 4 + x) * 4, 4);
      encodeBlock(px, out + (by * bw + bx) * 16);
    }
  }
}

extern "C" void decompress_bc7_mode6(
    const uint8_t* blocks, int width, int height, uint8_t* rgba_out) {
  const int bw = width / 4, bh = height / 4;
  for (int by = 0; by < bh; ++by) {
    for (int bx = 0; bx < bw; ++bx) {
      BitReader br(blocks + (by * bw + bx) * 16);
      const uint32_t mode = br.get(7);
      (void)mode; // assumes mode 6 (1 << 6)
      int e0[4], e1[4];
      for (int c = 0; c < 4; ++c) {
        e0[c] = int(br.get(7));
        e1[c] = int(br.get(7));
      }
      const int p0 = int(br.get(1));
      const int p1 = int(br.get(1));
      for (int c = 0; c < 4; ++c) {
        e0[c] = (e0[c] << 1) | p0;
        e1[c] = (e1[c] << 1) | p1;
      }
      int indices[16];
      indices[0] = int(br.get(3));
      for (int i = 1; i < 16; ++i) indices[i] = int(br.get(4));
      for (int y = 0; y < 4; ++y) {
        for (int x = 0; x < 4; ++x) {
          const int w = kWeights4[indices[y * 4 + x]];
          uint8_t* dst = rgba_out + ((by * 4 + y) * width + bx * 4 + x) * 4;
          for (int c = 0; c < 4; ++c) dst[c] = uint8_t(interpolate(e0[c], e1[c], w));
        }
      }
    }
  }
}
