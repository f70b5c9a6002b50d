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

// Destination pixel at disparity d along its ray -> source sample coords
// (source pixel units) and validity (ops/cost.py::reproject_rays).
__device__ __forceinline__ bool reproject(const float* __restrict__ P, const float* __restrict__ pos,
                                          float rx, float ry, float rz, float d, int hs, int ws,
                                          float& cx, float& cy) {
  const float depth = 1.f / clamp_min(d, 1e-12f);
  float px, py;
  const bool seen = project_point(P, pos[0] + rx * depth, pos[1] + ry * depth,
                                  pos[2] + rz * depth, px, py);
  cx = px * static_cast<float>(ws);
  cy = py * static_cast<float>(hs);
  return seen && d > 0.f && isfinite(cx) && isfinite(cy);
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
__device__ __forceinline__ float bilinear(const float* __restrict__ plane, const Taps& t) {
  const float top = plane[t.i00] * (1.f - t.wx) + plane[t.i01] * t.wx;
  const float bot = plane[t.i10] * (1.f - t.wx) + plane[t.i11] * t.wx;
  return top * (1.f - t.wy) + bot * t.wy;
}


constexpr float MIN_VAR = static_cast<float>(1.0 / 12.0 / 65025.0);  // ops/cost.py
constexpr int MIN_PATCH_SUPPORT = 5;

// 3x3 sum of a [dy][dx] neighbourhood: rows first, then columns, as
// ops/sampling.py::box_sum_planar adds its shifted planes.
__device__ __forceinline__ float box3(const float (&a)[3][3]) {
  const float c0 = (a[0][0] + a[1][0]) + a[2][0];
  const float c1 = (a[0][1] + a[1][1]) + a[2][1];
  const float c2 = (a[0][2] + a[1][2]) + a[2][2];
  return (c0 + c1) + c2;
}

// Running drop-2-worst state over sources (ops/cost.py::combine_top2).
struct Top2 {
  float b1 = -FLT_MAX, u1 = 0.f, b2 = -FLT_MAX, u2 = 0.f, total_u = 0.f;
  int count = 0;
};

// One source's bias-compensated 3x3 patch SSD (ops/cost.py::ssd_planar)
// folded into the running state. vld/d2/dc are [dy][dx] neighbourhoods of
// validity, sum_c diff_c^2 and the per-channel masked differences.
template <int C>
__device__ __forceinline__ void patch_update(const float (&vld)[3][3], const float (&d2)[3][3],
                                             const float (&dc)[C][3][3], Top2& t) {
  const float cnt = box3(vld);
  const float cnt_safe = fmaxf(cnt, 1.f);
  const float biased = box3(d2) * (9.f / cnt_safe);
  float md_sq = 0.f;
#pragma unroll
  for (int ch = 0; ch < C; ++ch) {
    const float md = box3(dc[ch]) / cnt_safe;
    md_sq = ch == 0 ? md * md : md_sq + md * md;
  }
  const float unbiased = fmaxf(biased - 9.f * md_sq, 0.f);
  const bool v = vld[1][1] > 0.f && cnt >= static_cast<float>(MIN_PATCH_SUPPORT);
  const float b = v ? biased : -FLT_MAX;
  const float u = v ? unbiased : 0.f;
  // two largest biased SSDs; the earlier source wins ties (argmax order)
  if (b > t.b1) {
    t.b2 = t.b1;
    t.u2 = t.u1;
    t.b1 = b;
    t.u1 = u;
  } else if (b > t.b2) {
    t.b2 = b;
    t.u2 = u;
  }
  t.total_u += u;
  t.count += v;
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
