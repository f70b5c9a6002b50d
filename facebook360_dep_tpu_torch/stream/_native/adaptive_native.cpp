// Native adaptive-grid LOD mesh builder for the publish path.
//
// Single-pass C++ implementation of stream/adaptive.py (compute_step_map +
// build_adaptive_faces): per-16x16-vertex-tile pick the largest step s in
// {16, 8, 4, 2} whose s-subsampled bilinear upsample reproduces every tile
// vertex within tol_rel * mean|z|; tiles containing a tear quad
// (reference ratio test, render/MeshUtil.h:170-216), an invalid (NaN)
// vertex, or the partial image-border strips stay full-res and emit the
// exact reference torn triangulation; LOD transitions stitch with
// cell-center fans subdivided at the finer side's step (watertight by
// construction). The numpy version walks ~10 full-grid f32 temporaries
// (~1.5-2.5 s at 2K on the 1-core publish host); this emits the same face
// SET in one cache-friendly pass (~0.1 s). Parity with the numpy path is
// pinned by tests/test_adaptive_mesh.py (sorted-face-set equality).
//
// Float semantics match numpy: f32 blends with named single-op statements
// (no FMA contraction across statements), NaN comparisons false, the tear
// network identical to mesh_faces.cpp. The one deliberate deviation: the
// per-tile mean |z| accumulates in double (numpy uses pairwise f32
// summation); the ~1e-7 relative difference can only flip a tile whose
// max error sits within 1 ulp of the tolerance — no effect on any tested
// input, and either decision is valid by construction.
//
// C ABI:
//   int build_adaptive_faces(const float* z, int height, int width,
//                            float tear_ratio, float tol_rel,
//                            uint32_t* out_faces, int32_t* out_step);
// z is the (height, width) row-major equi-error plane with NaN at invalid
// vertices; out_faces must hold 4*(height-1)*(width-1)*3 uint32; out_step
// (optional, may be null) receives the ((h-1)/16, (w-1)/16) per-tile step.
// Returns the emitted face count.

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

constexpr int TILE = 16;

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

// Emit the reference torn triangulation for one quad with top-left vertex
// index `base` (semantics of mesh_faces.cpp / MeshUtil.h:170-296).
inline uint32_t* emit_torn_quad(float c0, float c1, float c2, float c3,
                                uint32_t base, uint32_t W, float tear_ratio,
                                uint32_t* out) {
  if (std::isnan(c0) || std::isnan(c1) || std::isnan(c2) || std::isnan(c3))
    return out;
  float v0, v1, v2, v3;
  sort4(c0, c1, c2, c3, v0, v1, v2, v3);
  const bool all_close = v0 / v3 > tear_ratio;
  const float lo = v0 / v2;
  const float hi = v1 / v3;
  const bool diag_tlbr = std::fabs(c0 - c3) < std::fabs(c1 - c2);

  bool m[4];
  if (all_close) {
    m[1] = m[2] = diag_tlbr;
    m[0] = m[3] = !diag_tlbr;
  } else if (lo >= tear_ratio && lo > hi) {
    int idx = c3 >= c2 && c3 >= c1 && c3 >= c0 ? 3
        : c2 >= c1 && c2 >= c0                 ? 2
        : c1 >= c0                             ? 1
                                               : 0;
    idx ^= 0x3;
    m[0] = idx == 0; m[1] = idx == 1; m[2] = idx == 2; m[3] = idx == 3;
  } else if (hi >= tear_ratio) {
    int idx = c0 <= c1 && c0 <= c2 && c0 <= c3 ? 0
        : c1 <= c2 && c1 <= c3                 ? 1
        : c2 <= c3                             ? 2
                                               : 3;
    idx ^= 0x3;
    m[0] = idx == 0; m[1] = idx == 1; m[2] = idx == 2; m[3] = idx == 3;
  } else {
    return out;
  }
  const uint32_t off[4] = {0u, 1u, W, W + 1u};  // tl, tr, bl, br
  static const int tri[4][3] = {{2, 1, 0}, {0, 3, 1}, {3, 0, 2}, {1, 2, 3}};
  for (int t = 0; t < 4; ++t) {
    if (!m[t]) continue;
    out[0] = base + off[tri[t][0]];
    out[1] = base + off[tri[t][1]];
    out[2] = base + off[tri[t][2]];
    out += 3;
  }
  return out;
}

// |z - bilinear(z[::s,::s])| at vertex (y, x); the subsample grid is
// GLOBAL (origin 0) but s divides TILE so it aligns with tile origins.
// Exactly numpy's blend order: y first, then x, f32, no contraction.
inline float upsample_err(const float* z, int w, int y, int x, int s) {
  const int ry = y % s, rx = x % s;
  const float zv = z[size_t(y) * w + x];
  if (ry == 0 && rx == 0) return std::isfinite(zv) ? 0.0f : INFINITY;
  const int by = y - ry, bx = x - rx;
  const float ty = float(ry) / float(s);   // exact: s is a power of two
  const float tx = float(rx) / float(s);
  const float one_ty = 1.0f - ty, one_tx = 1.0f - tx;
  const float z00 = z[size_t(by) * w + bx];
  const float z01 = z[size_t(by) * w + bx + s];
  const float z10 = z[size_t(by + s) * w + bx];
  const float z11 = z[size_t(by + s) * w + bx + s];
  const float a0 = z00 * one_ty;
  const float a1 = z10 * ty;
  const float rowL = a0 + a1;
  const float b0 = z01 * one_ty;
  const float b1 = z11 * ty;
  const float rowR = b0 + b1;
  const float c0 = rowL * one_tx;
  const float c1 = rowR * tx;
  const float up = c0 + c1;
  const float d = std::fabs(zv - up);
  return std::isfinite(d) ? d : INFINITY;
}

}  // namespace

extern "C" int build_adaptive_faces(
    const float* z,
    int height,
    int width,
    float tear_ratio,
    float tol_rel,
    uint32_t* out_faces,
    int32_t* out_step) {
  const uint32_t W = uint32_t(width);
  const int qh = height - 1, qw = width - 1;
  const int nty = qh / TILE, ntx = qw / TILE;

  // ---- step map over complete tiles ---------------------------------------
  std::vector<int32_t> step(size_t(nty) * ntx, 1);
  for (int ty = 0; ty < nty; ++ty) {
    for (int tx = 0; tx < ntx; ++tx) {
      const int y0 = ty * TILE, x0 = tx * TILE;
      // tear/invalid scan over the tile's 16x16 quads + mean |z| over its
      // 16x16 vertices (nan -> 0), double accumulator (see header note)
      bool bad = false;
      double acc = 0.0;
      for (int i = 0; i < TILE && !bad; ++i) {
        const float* r0 = z + size_t(y0 + i) * width + x0;
        const float* r1 = r0 + width;
        for (int j = 0; j < TILE; ++j) {
          const float c0 = r0[j], c1 = r0[j + 1];
          const float c2 = r1[j], c3 = r1[j + 1];
          if (std::isnan(c0) || std::isnan(c1) || std::isnan(c2) || std::isnan(c3)) {
            bad = true;
            break;
          }
          float lo = c0 < c1 ? c0 : c1;
          float hi = c0 < c1 ? c1 : c0;
          lo = lo < c2 ? lo : c2;
          hi = hi < c3 ? (c3 < hi ? hi : c3) : hi;
          lo = lo < c3 ? lo : c3;
          hi = hi < c2 ? c2 : hi;
          if (!(lo / hi > tear_ratio)) {
            bad = true;
            break;
          }
        }
      }
      if (bad) {
        if (out_step) out_step[size_t(ty) * ntx + tx] = 1;
        continue;
      }
      for (int i = 0; i < TILE; ++i) {
        const float* r0 = z + size_t(y0 + i) * width + x0;
        for (int j = 0; j < TILE; ++j) {
          const float v = r0[j];
          acc += std::isnan(v) ? 0.0 : std::fabs(double(v));
        }
      }
      const float zmean = float(acc / (TILE * TILE));
      const float tol = tol_rel * (zmean > 1e-30f ? zmean : 1e-30f);

      int s_pick = 1;
      for (int s = 2; s <= TILE; s *= 2) {
        float maxerr = 0.0f;
        bool over = false;
        for (int i = 0; i <= TILE && !over; ++i) {   // include the shared
          for (int j = 0; j <= TILE; ++j) {          // far row/col vertices?
            // numpy's tile max covers rows [y0, y0+16) x [x0, x0+16) only —
            // the tile's far edge belongs to the NEXT tile (or the image
            // remainder, which is forced fine)
            if (i == TILE || j == TILE) continue;
            const float e = upsample_err(z, width, y0 + i, x0 + j, s);
            if (e > maxerr) maxerr = e;
            if (!(maxerr <= tol)) { over = true; break; }
          }
        }
        if (over) break;
        s_pick = s;
      }
      step[size_t(ty) * ntx + tx] = s_pick;
      if (out_step) out_step[size_t(ty) * ntx + tx] = s_pick;
    }
  }

  uint32_t* out = out_faces;

  // ---- fine region: every quad not inside a complete coarse tile ----------
  for (int y = 0; y < qh; ++y) {
    const int ty = y / TILE;
    const float* r0 = z + size_t(y) * width;
    const float* r1 = r0 + width;
    const uint32_t base_row = uint32_t(y) * W;
    for (int x = 0; x < qw; ++x) {
      const int tx = x / TILE;
      if (ty < nty && tx < ntx && step[size_t(ty) * ntx + tx] > 1) continue;
      out = emit_torn_quad(r0[x], r0[x + 1], r1[x], r1[x + 1],
                           base_row + uint32_t(x), W, tear_ratio, out);
    }
  }

  // ---- coarse tiles: plain quads + LOD-transition fans ---------------------
  for (int ty = 0; ty < nty; ++ty) {
    for (int tx = 0; tx < ntx; ++tx) {
      const int s = step[size_t(ty) * ntx + tx];
      if (s <= 1) continue;
      // per-side edge steps: min(self, neighbor); image border -> self;
      // partial remainder strip -> 1 (it runs fine)
      auto nbr_step = [&](int dy, int dx) -> int {
        const int ny_ = ty + dy, nx_ = tx + dx;
        if (ny_ < 0 || nx_ < 0) return s;
        if (ny_ >= nty) return (qh % TILE) ? 1 : s;
        if (nx_ >= ntx) return (qw % TILE) ? 1 : s;
        return step[size_t(ny_) * ntx + nx_];
      };
      const int et = s < nbr_step(-1, 0) ? s : nbr_step(-1, 0);
      const int eb = s < nbr_step(+1, 0) ? s : nbr_step(+1, 0);
      const int el = s < nbr_step(0, -1) ? s : nbr_step(0, -1);
      const int er = s < nbr_step(0, +1) ? s : nbr_step(0, +1);
      const int n = TILE / s;
      for (int iy = 0; iy < n; ++iy) {
        for (int ix = 0; ix < n; ++ix) {
          const int oy = ty * TILE + iy * s;
          const int ox = tx * TILE + ix * s;
          // side steps (top, right, bottom, left); interior sides run at s
          const int st = iy == 0 ? et : s;
          const int sr = ix == n - 1 ? er : s;
          const int sb = iy == n - 1 ? eb : s;
          const int sl = ix == 0 ? el : s;
          const uint32_t b00 = uint32_t(oy) * W + uint32_t(ox);
          if (st == s && sr == s && sb == s && sl == s) {
            // plain quad, diagonal per the reference all_close rule
            const float d_diag = std::fabs(z[size_t(oy) * width + ox]
                                           - z[size_t(oy + s) * width + ox + s]);
            const float d_anti = std::fabs(z[size_t(oy) * width + ox + s]
                                           - z[size_t(oy + s) * width + ox]);
            const uint32_t tl = b00, tr = b00 + uint32_t(s);
            const uint32_t bl = b00 + uint32_t(s) * W;
            const uint32_t br = bl + uint32_t(s);
            if (d_diag < d_anti) {  // diag split: triangles 1 + 2
              out[0] = tl; out[1] = br; out[2] = tr; out += 3;
              out[0] = br; out[1] = tl; out[2] = bl; out += 3;
            } else {                // anti split: triangles 0 + 3
              out[0] = bl; out[1] = tr; out[2] = tl; out += 3;
              out[0] = tr; out[1] = bl; out[2] = br; out += 3;
            }
          } else {
            // fan around the cell center, sides subdivided at their edge
            // step; perimeter order top -> right -> bottom -> left matches
            // adaptive._fan_template, winding (c, p[i+1], p[i])
            int py[128], px[128];
            int np_ = 0;
            for (int k = 0; k < s; k += st) { py[np_] = 0; px[np_] = k; ++np_; }
            for (int k = 0; k < s; k += sr) { py[np_] = k; px[np_] = s; ++np_; }
            for (int k = s; k > 0; k -= sb) { py[np_] = s; px[np_] = k; ++np_; }
            for (int k = s; k > 0; k -= sl) { py[np_] = k; px[np_] = 0; ++np_; }
            const uint32_t c =
                uint32_t(oy + s / 2) * W + uint32_t(ox + s / 2);
            for (int i = 0; i < np_; ++i) {
              const int i1 = (i + 1) % np_;
              out[0] = c;
              out[1] = uint32_t(oy + py[i1]) * W + uint32_t(ox + px[i1]);
              out[2] = uint32_t(oy + py[i]) * W + uint32_t(ox + px[i]);
              out += 3;
            }
          }
        }
      }
    }
  }

  return int((out - out_faces) / 3);
}
