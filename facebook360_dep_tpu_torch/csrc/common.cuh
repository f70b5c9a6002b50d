// Device helpers shared by the plane-sweep kernels: the packed camera
// parameters, the projection of a world point into a source camera, and
// clamp-to-edge bilinear sampling.
//
// The arithmetic follows the port's plain PyTorch path operation for
// operation (ops/cost.py::reproject_rays -> core/camera.py::sees,
// ops/sampling.py::bilinear_sample), which is the JAX package's XLA path.
// The library is built with -fmad=false, so every product is rounded where
// PyTorch rounds it; what remains between kernel and plain version is the
// last-ulp difference of atan2f and friends.
#pragma once

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace fdt {

// Packed per-source camera parameters (ops/warp_cuda.py::pack_camera_params,
// the layout of facebook360_dep_tpu/ops/warp_pallas.py:269-300).
constexpr int PARAM_POS = 0;        // 3
constexpr int PARAM_ROT = 3;        // 9, rows (right, up, backward)
constexpr int PARAM_PRINCIPAL = 12; // 2
constexpr int PARAM_FOCAL = 14;     // 2
constexpr int PARAM_DIST = 16;      // 3
constexpr int PARAM_DIST_MAX = 19;  // 1
constexpr int PARAM_COS_FOV = 20;   // 1
constexpr int PARAM_TYPE = 21;      // 1
constexpr int PARAM_RES = 22;       // 2
constexpr int PARAM_SIZE = 24;

constexpr int FTHETA = 0;
constexpr int RECTILINEAR = 1;
constexpr int ORTHOGRAPHIC = 3;

// tan(float32(pi/2)): the RECTILINEAR radius of a point behind the camera
constexpr float TAN_HALF_PI = -22877332.0f;

// torch.minimum: NaN if either operand is NaN (fminf would drop it)
__device__ __forceinline__ float nan_min(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

// torch.clamp(a, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float a, float lo) {
  return isnan(a) ? a : fmaxf(a, lo);
}

// Reflect-101 index (OpenCV BORDER_DEFAULT) for one step past either edge,
// clamped beyond that (such positions feed no in-image patch).
__device__ __forceinline__ int reflect101(int i, int n) {
  i = i < 0 ? -i : (i >= n ? 2 * (n - 1) - i : i);
  return min(max(i, 0), n - 1);
}

// World point -> source pixel in normalized units (core/camera.py::sees:
// pixel() then is_outside_fov / is_outside_sensor). Returns the validity.
__device__ __forceinline__ bool project_point(const float* __restrict__ P, float wx, float wy,
                                              float wz, float& px, float& py) {
  const float ox = wx - P[PARAM_POS + 0];
  const float oy = wy - P[PARAM_POS + 1];
  const float oz = wz - P[PARAM_POS + 2];
  const float* R = P + PARAM_ROT;
  const float vx = R[0] * ox + R[1] * oy + R[2] * oz;
  const float vy = R[3] * ox + R[4] * oy + R[5] * oz;
  const float vz = R[6] * ox + R[7] * oy + R[8] * oz;

  const float xy_sq = vx * vx + vy * vy;
  const float xy_norm = sqrtf(xy_sq);
  const float full_norm = sqrtf(xy_sq + vz * vz);
  const float xy_safe = clamp_min(xy_norm, FLT_MIN);
  const float full_safe = clamp_min(full_norm, FLT_MIN);

  const float d0 = P[PARAM_DIST + 0], d1 = P[PARAM_DIST + 1], d2 = P[PARAM_DIST + 2];
  const int tc = static_cast<int>(P[PARAM_TYPE]);
  float sx, sy;
  if (tc == ORTHOGRAPHIC) {
    // xy/|v| in front, xy/|xy| behind; no clamp on the factor
    const float den = vz < 0.f ? full_safe : xy_safe;
    const float prx = vx / den, pry = vy / den;
    const float pre_sq = prx * prx + pry * pry;
    const float f = 1.f + pre_sq * (d0 + pre_sq * (d1 + pre_sq * d2));
    sx = f * prx;
    sy = f * pry;
  } else {
    float r;
    if (tc == FTHETA) {
      r = atan2f(xy_norm, -vz);
    } else if (tc == RECTILINEAR) {
      r = -vz > 0.f ? xy_norm / -vz : TAN_HALF_PI;
    } else {  // EQUISOLID
      r = 2.f * sqrtf(clamp_min((1.f + vz / full_safe) / 2.f, 0.f));
    }
    const float rc = nan_min(r, P[PARAM_DIST_MAX]);
    const float s2 = rc * rc;
    const float k = (1.f + s2 * (d0 + s2 * (d1 + s2 * d2))) * rc / xy_safe;
    sx = k * vx;
    sy = k * vy;
  }
  px = P[PARAM_FOCAL + 0] * sx + P[PARAM_PRINCIPAL + 0];
  py = P[PARAM_FOCAL + 1] * sy + P[PARAM_PRINCIPAL + 1];

  // FOV cone on the unrotated offset, forward = -backward row
  const float dot = -R[6] * ox + -R[7] * oy + -R[8] * oz;
  const float cf = P[PARAM_COS_FOV];
  const bool outside_fov =
      (dot * fabsf(dot) <= cf * fabsf(cf) * (ox * ox + oy * oy + oz * oz)) && (cf != -1.f);
  const bool outside_sensor =
      px < 0.f || px >= P[PARAM_RES + 0] || py < 0.f || py >= P[PARAM_RES + 1];
  return !outside_fov && !outside_sensor;
}

// The source-independent half of reproject: the world point of a
// destination pixel at disparity d along its ray.
__device__ __forceinline__ void world_point(const float* __restrict__ pos, float rx, float ry, float rz,
                                            float d, float& wx, float& wy, float& wz) {
  const float depth = 1.f / clamp_min(d, 1e-12f);
  wx = pos[0] + rx * depth;
  wy = pos[1] + ry * depth;
  wz = pos[2] + rz * depth;
}

// The source-dependent half: world point -> source sample coords (source
// pixel units) and validity; ``d_ok`` is the pixel's d > 0.
__device__ __forceinline__ bool reproject_world(const float* __restrict__ P, float wx, float wy, float wz,
                                                bool d_ok, int hs, int ws, float& cx, float& cy) {
  float px, py;
  const bool seen = project_point(P, wx, wy, wz, px, py);
  cx = px * static_cast<float>(ws);
  cy = py * static_cast<float>(hs);
  return seen && d_ok && isfinite(cx) && isfinite(cy);
}

// Destination pixel at disparity d along its ray -> source sample coords
// and validity (ops/cost.py::reproject_rays).
__device__ __forceinline__ bool reproject(const float* __restrict__ P, const float* __restrict__ pos,
                                          float rx, float ry, float rz, float d, int hs, int ws,
                                          float& cx, float& cy) {
  float wx, wy, wz;
  world_point(pos, rx, ry, rz, d, wx, wy, wz);
  return reproject_world(P, wx, wy, wz, d > 0.f, hs, ws, cx, cy);
}

// Bilinear taps of ops/sampling.py::bilinear_sample: each tap clamped to
// the edge; the caller calls this only for finite coords.
struct Taps {
  int i00, i01, i10, i11;
  float wx, wy;
};

__device__ __forceinline__ Taps bilinear_taps(float cx, float cy, int hs, int ws) {
  const float x = cx - 0.5f, y = cy - 0.5f;
  const float x0 = floorf(x), y0 = floorf(y);
  Taps t;
  t.wx = x - x0;
  t.wy = y - y0;
  // clamp in float first so the int conversion is defined for any finite x
  const int xi = static_cast<int>(fminf(fmaxf(x0, -1.f), static_cast<float>(ws)));
  const int yi = static_cast<int>(fminf(fmaxf(y0, -1.f), static_cast<float>(hs)));
  const int xa = min(max(xi, 0), ws - 1), xb = min(max(xi + 1, 0), ws - 1);
  const int ya = min(max(yi, 0), hs - 1), yb = min(max(yi + 1, 0), hs - 1);
  t.i00 = ya * ws + xa;
  t.i01 = ya * ws + xb;
  t.i10 = yb * ws + xa;
  t.i11 = yb * ws + xb;
  return t;
}

// All four taps enter the lerp, so a NaN tap with zero weight still gives NaN.
__device__ __forceinline__ float lerp4(float a00, float a01, float a10, float a11, const Taps& t) {
  const float top = a00 * (1.f - t.wx) + a01 * t.wx;
  const float bot = a10 * (1.f - t.wx) + a11 * t.wx;
  return top * (1.f - t.wy) + bot * t.wy;
}

__device__ __forceinline__ float bilinear(const float* __restrict__ plane, const Taps& t) {
  return lerp4(plane[t.i00], plane[t.i01], plane[t.i10], plane[t.i11], t);
}

// ---- The TPU sampler's semantics (ops/warp_cuda.py, the TPU-mode twins) ----
// A destination tile of V4_TILE_H x V4_TILE_W pixels samples each source
// through a ww x wh window at an anchor (ox, oy) (tile_windows.cu); a
// visible pixel outside its tile's window is clipped; coordinates local to
// the window round to 1/256 px (warp_pallas.py:529-537, 772-775).
constexpr int V4_TILE_H = 24;
constexpr int V4_TILE_W = 128;

// The sample coordinate of a valid projection: coords - 0.5 clamped to the
// source (warp_pallas.py:456-462).
__device__ __forceinline__ float tpu_coord(float c, int n) {
  return fminf(fmaxf(c - 0.5f, 0.f), static_cast<float>(n - 1));
}

// The window test of (xt, yt) against the window at (ox, oy), and the taps
// of the bilinear sample at the window-local coordinates rounded to 1/256
// px (clamp-to-edge taps are what the window's edge padding holds).
// Returns whether the point lies in the window.
__device__ __forceinline__ bool tpu_taps(float xt, float yt, int ox, int oy, int ww, int wh, int hs, int ws,
                                         Taps& t) {
  const float fox = static_cast<float>(ox), foy = static_cast<float>(oy);
  const bool in = xt >= fox && xt <= fox + static_cast<float>(ww - 1) && yt >= foy &&
                  yt <= foy + static_cast<float>(wh - 1);
  const float lx = rintf(fminf(fmaxf(xt - fox, 0.f), static_cast<float>(ww - 1)) * 256.f) * (1.f / 256.f);
  const float ly = rintf(fminf(fmaxf(yt - foy, 0.f), static_cast<float>(wh - 1)) * 256.f) * (1.f / 256.f);
  const float fx = floorf(lx), fy = floorf(ly);
  t.wx = lx - fx;
  t.wy = ly - fy;
  const int x0 = ox + static_cast<int>(fx), y0 = oy + static_cast<int>(fy);
  const int xa = min(x0, ws - 1), xb = min(x0 + 1, ws - 1);
  const int ya = min(y0, hs - 1), yb = min(y0 + 1, hs - 1);
  t.i00 = ya * ws + xa;
  t.i01 = ya * ws + xb;
  t.i10 = yb * ws + xa;
  t.i11 = yb * ws + xb;
  return in;
}

// The packed path's sample rounding (warp_pallas.py:625-636): R to 2^-24,
// G and B clamped to [0, 1] then to 2^-16 with 65535 the top code.
__device__ __forceinline__ float packed_r(float r) {
  return rintf(fmaxf(r, 0.f) * 16777216.f) * (1.f / 16777216.f);
}
__device__ __forceinline__ float packed_gb(float g) {
  return fminf(rintf(fminf(fmaxf(g, 0.f), 1.f) * 65536.f), 65535.f) * (1.f / 65536.f);
}

constexpr float MIN_VAR = static_cast<float>(1.0 / 12.0 / 65025.0);  // ops/cost.py
constexpr int MIN_PATCH_SUPPORT = 5;

// One column of a 3x3 box sum: (top + middle) + bottom. The box takes its
// three column sums the same way, (left + centre) + right, which is the
// order ops/sampling.py::box_sum_planar adds its shifted planes in; the
// kernels' separable boxes keep it, so they round as the plain path does.
__device__ __forceinline__ float col3(float top, float mid, float bot) { return (top + mid) + bot; }

// Running drop-2-worst state over sources (ops/cost.py::combine_top2).
struct Top2 {
  float b1 = -FLT_MAX, u1 = 0.f, b2 = -FLT_MAX, u2 = 0.f, total_u = 0.f;
  int count = 0;
};

// One source's bias-compensated 3x3 patch SSD at one pixel
// (ops/cost.py::ssd_planar): biased, unbiased and whether it counts.
// Where it does not, b = -FLT_MAX and u = 0, so folding it changes nothing.
struct Patch {
  float b, u;
  bool v;
};

// From the 3x3 sums of validity (cnt), sum_c diff_c^2 and each channel's
// masked difference, and the centre's validity.
template <int C>
__device__ __forceinline__ Patch patch_ssd(float cnt, float sum_d2, const float (&sum_dc)[C], bool center) {
  const float cnt_safe = fmaxf(cnt, 1.f);
  const float biased = sum_d2 * (9.f / cnt_safe);
  float md_sq = 0.f;
#pragma unroll
  for (int ch = 0; ch < C; ++ch) {
    const float md = sum_dc[ch] / cnt_safe;
    md_sq = ch == 0 ? md * md : md_sq + md * md;
  }
  const float unbiased = fmaxf(biased - 9.f * md_sq, 0.f);
  const bool v = center && cnt >= static_cast<float>(MIN_PATCH_SUPPORT);
  return Patch{v ? biased : -FLT_MAX, v ? unbiased : 0.f, v};
}

// Fold one source's patch into the running state, sources in order: the
// two largest biased SSDs, the earlier source winning ties (argmax order).
__device__ __forceinline__ void top2_fold(const Patch& p, Top2& t) {
  if (p.b > t.b1) {
    t.b2 = t.b1;
    t.u2 = t.u1;
    t.b1 = p.b;
    t.u1 = p.u;
  } else if (p.b > t.b2) {
    t.b2 = p.b;
    t.u2 = p.u;
  }
  t.total_u += p.u;
  t.count += p.v;
}

// keep = clip(max(count - 2, 1), 1, n); cost = (sum u - dropped) / keep^2 /
// max(var, MIN_VAR); FLT_MAX (and confidence 0) where no source counts.
__device__ __forceinline__ void top2_finish(const Top2& t, int n, float var, float& cost,
                                            float& conf) {
  const int keep = min(max(t.count - 2, 1), n);
  const int drop = t.count - keep;
  const float cost_sum = t.total_u - (drop >= 1 ? t.u1 : 0.f) - (drop >= 2 ? t.u2 : 0.f);
  const float keepf = static_cast<float>(keep);
  const float confidence = clamp_min(var, MIN_VAR);
  const bool enough = t.count >= 1;
  cost = enough ? cost_sum / (keepf * keepf) / confidence : FLT_MAX;
  conf = enough ? confidence : 0.f;
}

}  // namespace fdt
