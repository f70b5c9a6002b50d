// Torn-quad face emission for the publish mesh build.
//
// Native single-pass implementation of stream/mesh.py get_triangle_masks +
// the face gather (reference: render/MeshUtil.h:170-296 getTriangleMask /
// getFaces). The vectorized numpy version walks ~30 full-size (Q,)
// intermediates over 3.1M quads (~3 s at 2K); this loop reads each corner
// once and emits faces directly (~0.2 s). Semantics are bit-identical to
// the numpy path (IEEE float division, NaN comparisons false, FIRST-min /
// LAST-max tie rules) and pinned by a parity test over random/NaN/tied
// corners.
//
// C ABI:
//   int build_faces(const float* proxy, int height, int width,
//                   float tear_ratio, uint32_t* out_faces);
// proxy is the (height, width) row-major depth-proxy plane; out_faces must
// hold 4*(height-1)*(width-1)*3 uint32. Returns the emitted face count.

#include <cmath>
#include <cstdint>

namespace {

inline void sort4(float c0, float c1, float c2, float c3,
                  float& v0, float& v1, float& v2, float& v3) {
  const float m01 = c0 < c1 ? c0 : c1, b01 = c0 < c1 ? c1 : c0;
  const float m23 = c2 < c3 ? c2 : c3, b23 = c2 < c3 ? c3 : c2;
  v0 = m01 < m23 ? m01 : m23;
  v3 = b01 < b23 ? b23 : b01;
  const float mid_a = m01 < m23 ? m23 : m01;
  const float mid_b = b01 < b23 ? b01 : b23;
  v1 = mid_a < mid_b ? mid_a : mid_b;
  v2 = mid_a < mid_b ? mid_b : mid_a;
}

}  // namespace

extern "C" int build_faces(
    const float* proxy,
    int height,
    int width,
    float tear_ratio,
    uint32_t* out_faces) {
  // addTriangle vertex patterns (MeshUtil.h:224-247), offsets relative to
  // the quad's top-left vertex; triangle order 0..3 (tl, tr, bl, br)
  uint32_t pat[4][3];
  const uint32_t W = uint32_t(width);
  const uint32_t off[4] = {0u, 1u, W, W + 1u};  // tl, tr, bl, br
  const int tri[4][3] = {{2, 1, 0}, {0, 3, 1}, {3, 0, 2}, {1, 2, 3}};
  for (int t = 0; t < 4; ++t)
    for (int k = 0; k < 3; ++k) pat[t][k] = off[tri[t][k]];

  uint32_t* out = out_faces;
  for (int y = 0; y < height - 1; ++y) {
    const float* row0 = proxy + size_t(y) * width;
    const float* row1 = row0 + width;
    const uint32_t base_row = uint32_t(y) * W;
    for (int x = 0; x < width - 1; ++x) {
      const float c0 = row0[x], c1 = row0[x + 1];
      const float c2 = row1[x], c3 = row1[x + 1];
      // numpy's minimum/maximum propagate NaN through the sort network, so
      // a quad with any NaN corner fails every ratio comparison and emits
      // nothing — replicate that with an explicit early-out
      if (std::isnan(c0) || std::isnan(c1) || std::isnan(c2) || std::isnan(c3)) continue;
      float v0, v1, v2, v3;
      sort4(c0, c1, c2, c3, v0, v1, v2, v3);

      // NaN/inf from the divisions compare false, matching numpy under
      // errstate(ignore) — a NaN quad emits nothing
      const bool all_close = v0 / v3 > tear_ratio;
      const float lo = v0 / v2;
      const float hi = v1 / v3;
      const bool diag_tlbr = std::fabs(c0 - c3) < std::fabs(c1 - c2);

      bool m0, m1, m2, m3;
      if (all_close) {
        m1 = m2 = diag_tlbr;
        m0 = m3 = !diag_tlbr;
      } else if (lo >= tear_ratio && lo > hi) {
        // three near corners: drop the triangle opposite the farthest
        // corner — LAST max index (reversed-argmax tie rule)
        int idx = c3 >= c2 && c3 >= c1 && c3 >= c0 ? 3
            : c2 >= c1 && c2 >= c0                 ? 2
            : c1 >= c0                             ? 1
                                                   : 0;
        idx ^= 0x3;
        m0 = idx == 0;
        m1 = idx == 1;
        m2 = idx == 2;
        m3 = idx == 3;
      } else if (hi >= tear_ratio) {
        // three far corners: drop opposite the nearest — FIRST min index
        int idx = c0 <= c1 && c0 <= c2 && c0 <= c3 ? 0
            : c1 <= c2 && c1 <= c3                 ? 1
            : c2 <= c3                             ? 2
                                                   : 3;
        idx ^= 0x3;
        m0 = idx == 0;
        m1 = idx == 1;
        m2 = idx == 2;
        m3 = idx == 3;
      } else {
        m0 = m1 = m2 = m3 = false;
      }

      const uint32_t base = base_row + uint32_t(x);
      const bool m[4] = {m0, m1, m2, m3};
      for (int t = 0; t < 4; ++t) {
        if (!m[t]) continue;
        out[0] = base + pat[t][0];
        out[1] = base + pat[t][1];
        out[2] = base + pat[t][2];
        out += 3;
      }
    }
  }
  return int((out - out_faces) / 3);
}
