// Tile anchors of the TPU sampler: for every destination tile of 24 x 128
// pixels and every source, the origin of the source window the tile samples
// through.
//
// Replaces the window anchor of facebook360_dep_tpu/ops/warp_pallas.py
// (_make_project_kernel_v4, :471-497), which each grid step of
// project_sample_planar_v4 and project_sample_packed computes before it
// fetches its window: the anchor is centred on the span of the tile's valid
// sample coordinates (xt, yt), aligned down to 128 in x and to ``ay`` (8,
// or 16 for a bf16 stack) in y, and clamped to the padded source; a tile no
// pixel of which the source sees gets (0, 0). The tiles lie on the
// destination grid padded to whole tiles: by edge rows and columns for the
// plain sampler (K1), or by one reflect-101 row and column then edge for
// the packed path (K3), whose ring cells take these anchors.
//
// One block a (tile, source, destination): its 256 threads project 12 of
// the tile's 3072 pixels each (fdt::world_point + fdt::reproject_world, the
// device functions K1 and K3 sample with, so an anchor and the samples it
// governs come from the same bits), reduce the min and max of the valid
// coordinates by warp shuffles and shared memory, and one thread writes the
// anchor. A simple design: it projects every pixel once more than K1 and K3
// do; its bound is set by those projections' operations.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TILE = fdt::V4_TILE_H * fdt::V4_TILE_W;

// The image row of padded grid row i of an n-row image.
__device__ __forceinline__ int grid_source(int i, int n, bool reflect) {
  if (i < n) return i;
  return (reflect && i == n) ? max(n - 2, 0) : n - 1;
}

__device__ __forceinline__ int floor_div(int a, int b) { return a >= 0 ? a / b : -((-a + b - 1) / b); }

__global__ void __launch_bounds__(THREADS)
tile_windows_kernel(const float* __restrict__ params, int n, int hs, int ws, const float* __restrict__ dst_pos,
                    const float* __restrict__ disparity, const float* __restrict__ rays, int h, int w, int ntx,
                    int nty, int ww, int wh, int ay, int hs_pad, int ws_pad, bool reflect,
                    int2* __restrict__ anchors) {
  __shared__ float s_par[fdt::PARAM_SIZE];
  __shared__ float s_red[4][THREADS / 32];
  const int tile = blockIdx.x, s = blockIdx.y, d = blockIdx.z;
  const int ty = tile / ntx, tx = tile % ntx;
  if (threadIdx.x < fdt::PARAM_SIZE) s_par[threadIdx.x] = params[s * fdt::PARAM_SIZE + threadIdx.x];
  __syncthreads();

  const float big = 1e9f;
  float xmin = big, ymin = big, xmax = -big, ymax = -big;
  const size_t hw = static_cast<size_t>(h) * w;
  const float* disp = disparity + d * hw;
  const float* ray = rays + d * 3 * hw;
  for (int p = threadIdx.x; p < TILE; p += THREADS) {
    const int y = grid_source(ty * fdt::V4_TILE_H + p / fdt::V4_TILE_W, h, reflect);
    const int x = grid_source(tx * fdt::V4_TILE_W + p % fdt::V4_TILE_W, w, reflect);
    const size_t q = static_cast<size_t>(y) * w + x;
    const float dv = disp[q];
    float wx, wy, wz;
    fdt::world_point(dst_pos + 3 * d, ray[q], ray[hw + q], ray[2 * hw + q], dv, wx, wy, wz);
    const bool d_ok = dv > 0.f;
    if (!(d_ok && !isnan(wx) && !isnan(wy) && !isnan(wz))) continue;
    float cx, cy;
    if (!fdt::reproject_world(s_par, wx, wy, wz, d_ok, hs, ws, cx, cy)) continue;
    const float xt = fdt::tpu_coord(cx, ws), yt = fdt::tpu_coord(cy, hs);
    xmin = fminf(xmin, xt);
    xmax = fmaxf(xmax, xt);
    ymin = fminf(ymin, yt);
    ymax = fmaxf(ymax, yt);
  }
  for (int off = 16; off > 0; off >>= 1) {
    xmin = fminf(xmin, __shfl_xor_sync(0xffffffffu, xmin, off));
    xmax = fmaxf(xmax, __shfl_xor_sync(0xffffffffu, xmax, off));
    ymin = fminf(ymin, __shfl_xor_sync(0xffffffffu, ymin, off));
    ymax = fmaxf(ymax, __shfl_xor_sync(0xffffffffu, ymax, off));
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    s_red[0][warp] = xmin;
    s_red[1][warp] = xmax;
    s_red[2][warp] = ymin;
    s_red[3][warp] = ymax;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int k = 1; k < THREADS / 32; ++k) {
    xmin = fminf(xmin, s_red[0][k]);
    xmax = fmaxf(xmax, s_red[1][k]);
    ymin = fminf(ymin, s_red[2][k]);
    ymax = fmaxf(ymax, s_red[3][k]);
  }
  const bool none = xmin >= big;
  const float xa = none ? 0.f : 0.5f * (xmin + xmax) - 0.5f * static_cast<float>(ww - 128);
  const float ya = none ? 0.f : 0.5f * (ymin + ymax) - 0.5f * static_cast<float>(wh - ay);
  const int ox = min(max(floor_div(static_cast<int>(xa), 128), 0), max((ws_pad - ww) / 128, 0)) * 128;
  const int oy = min(max(floor_div(static_cast<int>(ya), ay), 0), max((hs_pad - wh) / ay, 0)) * ay;
  anchors[((static_cast<size_t>(d) * n + s) * nty + ty) * ntx + tx] = make_int2(ox, oy);
}

}  // namespace

// params (n, 24); dst_pos (d, 3); disparity (d, h, w); rays (d, 3, h, w) ->
// anchors (d, n, ceil(h/24), ceil(w/128), 2) int32 (x, y).
extern "C" int fdt_tile_windows(const float* params, int n, int hs, int ws, const float* dst_pos,
                                const float* disparity, const float* rays, int d, int h, int w, int ww, int wh,
                                int ay, int hs_pad, int ws_pad, int reflect, int* anchors, void* stream) {
  const int nty = (h + fdt::V4_TILE_H - 1) / fdt::V4_TILE_H, ntx = (w + fdt::V4_TILE_W - 1) / fdt::V4_TILE_W;
  const dim3 grid(nty * ntx, n, d);
  tile_windows_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      params, n, hs, ws, dst_pos, disparity, rays, h, w, ntx, nty, ww, wh, ay, hs_pad, ws_pad, reflect != 0,
      reinterpret_cast<int2*>(anchors));
  return static_cast<int>(cudaGetLastError());
}
