// Barycentric z-buffer triangle rasterizer.
//
// Used to decode streamed equi-error meshes back into dense disparity maps
// (the inverse of ConvertToBinary's mesh generation) — the offline equivalent
// of the reference viewer's vertex-displacement raster (RigScene.cpp:195) and
// a faithful sibling of MeshUtil::writePfm's crude rasterizer (MeshUtil.h:35-69).
//
// C ABI:
//   void rasterize_mesh(const float* verts, int nv, const uint32_t* faces,
//                       int nf, int width, int height,
//                       float sx, float sy,      // vertex xy -> pixel scale
//                       float* out);             // (h, w) init to NaN,
//                                                //  z written where covered
// Vertices are (x, y, z); z-test keeps the LARGEST z (equi-error z is
// focal/depth = scaled disparity, so larger z = closer surface wins).

#include <algorithm>
#include <cmath>
#include <cstdint>

extern "C" void rasterize_mesh(
    const float* verts,
    int nv,
    const uint32_t* faces,
    int nf,
    int width,
    int height,
    float sx,
    float sy,
    float* out) {
  for (int i = 0; i < width * height; ++i) out[i] = NAN;
  for (int f = 0; f < nf; ++f) {
    const float* p0 = verts + 3 * faces[3 * f];
    const float* p1 = verts + 3 * faces[3 * f + 1];
    const float* p2 = verts + 3 * faces[3 * f + 2];
    const float x0 = p0[0] * sx, y0 = p0[1] * sy, z0 = p0[2];
    const float x1 = p1[0] * sx, y1 = p1[1] * sy, z1 = p1[2];
    const float x2 = p2[0] * sx, y2 = p2[1] * sy, z2 = p2[2];
    const float denom = (y1 - y2) * (x0 - x2) + (x2 - x1) * (y0 - y2);
    if (std::fabs(denom) < 1e-12f) continue;
    const float inv = 1.0f / denom;
    const int xmin = std::max(0, int(std::floor(std::min({x0, x1, x2}))));
    const int xmax = std::min(width - 1, int(std::ceil(std::max({x0, x1, x2}))));
    const int ymin = std::max(0, int(std::floor(std::min({y0, y1, y2}))));
    const int ymax = std::min(height - 1, int(std::ceil(std::max({y0, y1, y2}))));
    for (int y = ymin; y <= ymax; ++y) {
      const float py = y + 0.5f;
      for (int x = xmin; x <= xmax; ++x) {
        const float px = x + 0.5f;
        const float w0 = ((y1 - y2) * (px - x2) + (x2 - x1) * (py - y2)) * inv;
        const float w1 = ((y2 - y0) * (px - x2) + (x0 - x2) * (py - y2)) * inv;
        const float w2 = 1.0f - w0 - w1;
        if (w0 < 0 || w1 < 0 || w2 < 0) continue;
        const float z = w0 * z0 + w1 * z1 + w2 * z2;
        float& dst = out[y * width + x];
        if (std::isnan(dst) || z > dst) dst = z;
      }
    }
  }
}
