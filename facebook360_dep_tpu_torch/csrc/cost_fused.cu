// K3 cost_fused: projection + sampling + patch SSD + drop-2-worst combine
// in one kernel.
//
// Replaces facebook360_dep_tpu/ops/warp_pallas.py:project_sample_packed
// (builder _make_project_kernel_v4, packed=(h0, w0)) composed with
// ssd_combine(true_shape=...): the TPU wrote the sampled stack into the
// combine kernel's padded layout as two int32 fixed-point planes to save
// HBM traffic between its two kernels. On the H100 the samples never reach
// device memory at all.
//
// What bounds it on the H100: the 4-tap source gathers (3 channels) for
// every (source, destination pixel), plus ~27% halo recomputation; the
// only device-memory writes are the two output maps. One block owns a
// 16 x 16 destination tile. For each source it projects and samples the
// 18 x 18 halo into shared memory (masked differences, their squared sum
// and validity), then each thread forms its 3x3 sums from shared memory
// and updates its running top two in registers. A halo pixel outside the
// image takes the reflect-101 pixel's disparity, ray and color, which is
// exactly the plain path's reflect-101 box over the sampled planes. A
// source that sees no halo pixel of the tile is skipped after one
// block-wide vote. The result equals K1 followed by K2 bit for bit.
#include "common.cuh"

namespace {

constexpr int TILE = 16;
constexpr int HALO = TILE + 2;
constexpr int CELLS = HALO * HALO;
constexpr int THREADS = TILE * TILE;
constexpr int CELLS_PER_THREAD = (CELLS + THREADS - 1) / THREADS;

__global__ void __launch_bounds__(THREADS)
cost_fused_kernel(const float* __restrict__ src, int n, int hs, int ws,
                  const float* __restrict__ params, const float* __restrict__ dst_pos,
                  const float* __restrict__ disparity, const float* __restrict__ rays,
                  const float* __restrict__ dst, const float* __restrict__ var, int h, int w,
                  int exclude, float* __restrict__ cost, float* __restrict__ conf) {
  __shared__ float s_vld[HALO][HALO];
  __shared__ float s_d2[HALO][HALO];
  __shared__ float s_dc[3][HALO][HALO];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TILE + tx;
  const int x0 = blockIdx.x * TILE, y0 = blockIdx.y * TILE;
  const int hw = h * w;
  const size_t plane = static_cast<size_t>(hs) * ws;

  // the halo cells this thread projects: source-independent inputs, loaded once
  int cell[CELLS_PER_THREAD];
  float rx[CELLS_PER_THREAD], ry[CELLS_PER_THREAD], rz[CELLS_PER_THREAD];
  float dd[CELLS_PER_THREAD], dcol[CELLS_PER_THREAD][3];
  int ncell = 0;
  for (int k = tid; k < CELLS; k += THREADS, ++ncell) {
    const int gy = fdt::reflect101(y0 + k / HALO - 1, h);
    const int gx = fdt::reflect101(x0 + k % HALO - 1, w);
    const int q = gy * w + gx;
    cell[ncell] = k;
    rx[ncell] = rays[q];
    ry[ncell] = rays[hw + q];
    rz[ncell] = rays[2 * hw + q];
    dd[ncell] = disparity[q];
    for (int ch = 0; ch < 3; ++ch) dcol[ncell][ch] = dst[ch * hw + q];
  }
  const bool inside = x0 + tx < w && y0 + ty < h;

  fdt::Top2 t;
  for (int s = 0; s < n; ++s) {
    if (s == exclude) continue;  // uniform across the block
    const float* P = params + s * fdt::PARAM_SIZE;
    const float* img = src + static_cast<size_t>(s) * 3 * plane;
    bool any = false;
    for (int j = 0; j < ncell; ++j) {
      float cx, cy;
      const bool ok = fdt::reproject(P, dst_pos, rx[j], ry[j], rz[j], dd[j], hs, ws, cx, cy);
      float diff[3] = {0.f, 0.f, 0.f};
      if (ok) {
        const fdt::Taps tp = fdt::bilinear_taps(cx, cy, hs, ws);
        for (int ch = 0; ch < 3; ++ch) diff[ch] = dcol[j][ch] - fdt::bilinear(img + ch * plane, tp);
      }
      const int hy = cell[j] / HALO, hx = cell[j] % HALO;
      s_vld[hy][hx] = ok ? 1.f : 0.f;
      float sq = diff[0] * diff[0];
      sq = sq + diff[1] * diff[1];
      s_d2[hy][hx] = sq + diff[2] * diff[2];
      for (int ch = 0; ch < 3; ++ch) s_dc[ch][hy][hx] = diff[ch];
      any = any || ok;
    }
    if (!__syncthreads_or(any)) continue;  // the source sees nothing of this tile
    if (inside) {
      float vld[3][3], d2[3][3], dc[3][3][3];
      for (int dy = 0; dy < 3; ++dy)
        for (int dx = 0; dx < 3; ++dx) {
          vld[dy][dx] = s_vld[ty + dy][tx + dx];
          d2[dy][dx] = s_d2[ty + dy][tx + dx];
          for (int ch = 0; ch < 3; ++ch) dc[ch][dy][dx] = s_dc[ch][ty + dy][tx + dx];
        }
      fdt::patch_update<3>(vld, d2, dc, t);
    }
    __syncthreads();  // the next source overwrites the halo
  }
  if (inside) {
    const int q = (y0 + ty) * w + (x0 + tx);
    fdt::top2_finish(t, n, var[q], cost[q], conf[q]);
  }
}

}  // namespace

// src (n, 3, hs, ws); params (n, 24); dst_pos (3,); disparity (h, w);
// rays (3, h, w); dst (3, h, w); var (h, w) -> cost, conf (h, w).
extern "C" int fdt_cost_fused(const float* src, int n, int hs, int ws, const float* params,
                              const float* dst_pos, const float* disparity, const float* rays,
                              const float* dst, const float* var, int h, int w, int exclude,
                              float* cost, float* conf, void* stream) {
  const dim3 block(TILE, TILE);
  const dim3 grid((w + TILE - 1) / TILE, (h + TILE - 1) / TILE);
  cost_fused_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      src, n, hs, ws, params, dst_pos, disparity, rays, dst, var, h, w, exclude, cost, conf);
  return static_cast<int>(cudaGetLastError());
}
