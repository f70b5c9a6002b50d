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
// What bounds it on the H100. At 2048x1536 with 16 sources it must read
// the 15 non-self sources' colors (566 MB), the rays, disparity, dst and
// variance (101 MB) and write cost and confidence (25 MB): 0.207 ms at
// 3.35 TB/s. Its ~140 FLOPs per (pixel, source) are 0.10 ms at 67 TFLOP/s.
// The first design took 1.56 ms, 7.5x that bound, on instruction issue and
// latency rather than bytes: a 16x16 tile projected its 18x18 halo with
// 256 threads (a second, quarter-full round), made 12 scalar loads per
// halo cell and source from three planes, recomputed the world point per
// source, read 45 shared values per pixel and source, and took three
// block-wide barriers per source.
//
// This design (0.91 ms there, device time in a CUDA graph, chip_smoke.py's
// kernel table):
// - reads the sources from an interleaved (N, Hs, Ws, 4) stack (RGB + pad,
//   built once per level by depth/solver.py): one 16-byte load a tap;
// - gives each warp whole 32-cell halo rows: a 30-wide tile of TILE_H rows
//   has a 32 x (TILE_H + 2) halo, TILE_H + 2 a multiple of 8, so the 256
//   threads project exactly (TILE_H + 2) / 8 cells each, every lane busy;
// - computes each halo cell's world point, its d > 0 test and its dst
//   color once, before the source loop; a cell whose world point is NaN
//   (outside the dst FOV) or whose disparity is not positive is invalid
//   for every source and is never projected;
// - keeps the camera parameters in shared memory (read as a broadcast);
// - double-buffers the five halo planes (validity, sum_c diff^2, diff_c),
//   so one barrier per source (the vote that skips a source seeing nothing
//   of the tile) separates writing source s from reading it;
// - forms the 3x3 boxes separably: each lane sums its halo column over
//   three rows from shared memory, then takes its right neighbours' column
//   sums by warp shuffles, in fdt::col3's order, so the result is
//   bit-identical to K1 followed by K2; a warp skips an output row none of
//   whose centres the source sees (such a source folds nothing).
// What remains is instruction issue and latency, not bytes: the
// projection's arithmetic (divides, square roots, atan2f for FTHETA), the
// tap gathers and the patch phase. Of the tile heights 6, 14, 22 and 30,
// 14 measured fastest (PERF.md).
// Kept from the first design: the reflect-101 halo (a halo pixel outside
// the image takes the reflect-101 pixel's disparity, ray and color, which
// is the plain path's reflect-101 box over the sampled planes), -fmad=false
// and the exact XLA-path semantics.
#include "common.cuh"

namespace {

constexpr int WARP = 32;
constexpr int WARPS = 8;
constexpr int THREADS = WARP * WARPS;
constexpr int TILE_W = WARP - 2;
constexpr int TILE_H = 14;
constexpr int HALO_H = TILE_H + 2;
static_assert(HALO_H % WARPS == 0, "every thread projects the same number of halo cells");
constexpr int CELLS = HALO_H / WARPS;                    // halo cells a thread projects
constexpr int ROWS = (TILE_H + WARPS - 1) / WARPS;       // output rows a warp owns
constexpr int PLANES = 5;                                // validity, sum_c diff^2, diff_r, diff_g, diff_b
constexpr int BUFFER = PLANES * HALO_H * WARP;           // floats of one halo buffer
constexpr unsigned FULL = 0xffffffffu;

// four blocks an SM (at most 64 registers a thread): fewer, with more
// registers, and more, with spills, both measured slower
__global__ void __launch_bounds__(THREADS, 4)
cost_fused_kernel(const float4* __restrict__ src, int n, int hs, int ws,
                  const float* __restrict__ params, const float* __restrict__ dst_pos,
                  const float* __restrict__ disparity, const float* __restrict__ rays,
                  const float* __restrict__ dst, const float* __restrict__ var, int h, int w,
                  int exclude, float* __restrict__ cost, float* __restrict__ conf) {
  extern __shared__ float smem[];
  float* s_buf = smem;                    // [2][PLANES][HALO_H][WARP]
  float* s_par = smem + 2 * BUFFER;       // [n][PARAM_SIZE]

  const int lane = threadIdx.x % WARP, warp = threadIdx.x / WARP;
  const int x0 = blockIdx.x * TILE_W, y0 = blockIdx.y * TILE_H;
  const int hw = h * w;
  const size_t plane = static_cast<size_t>(hs) * ws;

  for (int i = threadIdx.x; i < n * fdt::PARAM_SIZE; i += THREADS) s_par[i] = params[i];

  // the source-independent inputs of this thread's halo cells (halo row
  // warp + WARPS * k, column lane): world point, d > 0, dst color
  float wx[CELLS], wy[CELLS], wz[CELLS], dcol[CELLS][3];
  bool d_ok[CELLS], live[CELLS];
  const int gx = fdt::reflect101(x0 + lane - 1, w);
#pragma unroll
  for (int k = 0; k < CELLS; ++k) {
    const int gy = fdt::reflect101(y0 + warp + WARPS * k - 1, h);
    const int q = gy * w + gx;
    const float d = disparity[q];
    fdt::world_point(dst_pos, rays[q], rays[hw + q], rays[2 * hw + q], d, wx[k], wy[k], wz[k]);
    d_ok[k] = d > 0.f;
    live[k] = d_ok[k] && !isnan(wx[k]) && !isnan(wy[k]) && !isnan(wz[k]);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) dcol[k][ch] = dst[ch * hw + q];
  }
  __syncthreads();  // the camera parameters

  fdt::Top2 t[ROWS];
  int buf = 0;
  for (int s = 0; s < n; ++s) {
    if (s == exclude) continue;  // uniform across the block
    const float* P = s_par + s * fdt::PARAM_SIZE;
    const float4* img = src + static_cast<size_t>(s) * plane;
    float* B = s_buf + buf * BUFFER;
    bool any = false;
#pragma unroll
    for (int k = 0; k < CELLS; ++k) {
      bool ok = false;
      float diff[3] = {0.f, 0.f, 0.f};
      if (live[k]) {
        float cx, cy;
        ok = fdt::reproject_world(P, wx[k], wy[k], wz[k], d_ok[k], hs, ws, cx, cy);
        if (ok) {
          const fdt::Taps tp = fdt::bilinear_taps(cx, cy, hs, ws);
          const float4 a = __ldg(img + tp.i00), b = __ldg(img + tp.i01);
          const float4 c = __ldg(img + tp.i10), e = __ldg(img + tp.i11);
          diff[0] = dcol[k][0] - fdt::lerp4(a.x, b.x, c.x, e.x, tp);
          diff[1] = dcol[k][1] - fdt::lerp4(a.y, b.y, c.y, e.y, tp);
          diff[2] = dcol[k][2] - fdt::lerp4(a.z, b.z, c.z, e.z, tp);
        }
      }
      float sq = diff[0] * diff[0];
      sq = sq + diff[1] * diff[1];
      const int cell = (warp + WARPS * k) * WARP + lane;
      B[0 * HALO_H * WARP + cell] = ok ? 1.f : 0.f;
      B[1 * HALO_H * WARP + cell] = sq + diff[2] * diff[2];
      B[2 * HALO_H * WARP + cell] = diff[0];
      B[3 * HALO_H * WARP + cell] = diff[1];
      B[4 * HALO_H * WARP + cell] = diff[2];
      any = any || ok;
    }
    buf ^= 1;  // the next source writes the other buffer while this one is read
    if (!__syncthreads_or(any)) continue;  // the source sees nothing of this tile

#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int oy = warp + WARPS * r;  // output row; halo rows oy .. oy + 2
      const float center = oy < TILE_H ? B[(oy + 1) * WARP + min(lane + 1, WARP - 1)] : 0.f;
      // a row whose centres the source does not see folds nothing (b =
      // -FLT_MAX, u = 0 changes no state): skipped, uniform across the warp
      if (!__any_sync(FULL, center > 0.f)) continue;
      float box[PLANES];
#pragma unroll
      for (int p = 0; p < PLANES; ++p) {
        const float* col = B + p * HALO_H * WARP + oy * WARP + lane;
        const float c0 = fdt::col3(col[0], col[WARP], col[2 * WARP]);
        const float c1 = __shfl_down_sync(FULL, c0, 1);
        const float c2 = __shfl_down_sync(FULL, c0, 2);
        box[p] = fdt::col3(c0, c1, c2);
      }
      const float sum_dc[3] = {box[2], box[3], box[4]};
      fdt::top2_fold(fdt::patch_ssd<3>(box[0], box[1], sum_dc, center > 0.f), t[r]);
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int x = x0 + lane, y = y0 + warp + WARPS * r;
    if (lane < TILE_W && warp + WARPS * r < TILE_H && x < w && y < h) {
      const int q = y * w + x;
      fdt::top2_finish(t[r], n, var[q], cost[q], conf[q]);
    }
  }
}

}  // namespace

// src (n, hs, ws, 4) interleaved RGB + pad; params (n, 24); dst_pos (3,);
// disparity (h, w); rays (3, h, w); dst (3, h, w); var (h, w) -> cost,
// conf (h, w).
extern "C" int fdt_cost_fused(const float* src, int n, int hs, int ws, const float* params,
                              const float* dst_pos, const float* disparity, const float* rays,
                              const float* dst, const float* var, int h, int w, int exclude,
                              float* cost, float* conf, void* stream) {
  const size_t smem = (2 * BUFFER + static_cast<size_t>(n) * fdt::PARAM_SIZE) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(cost_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((w + TILE_W - 1) / TILE_W, (h + TILE_H - 1) / TILE_H);
  cost_fused_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(src), n, hs, ws, params, dst_pos, disparity, rays, dst, var, h, w,
      exclude, cost, conf);
  return static_cast<int>(cudaGetLastError());
}
