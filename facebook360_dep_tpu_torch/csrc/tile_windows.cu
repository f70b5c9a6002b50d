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
// One block a (tile, destination), all D destinations in one launch, every
// source in a loop inside the block. Each of the 512 threads loads its 6
// pixels' disparity and rays once (coalesced along the tile's 128-wide
// rows) and keeps their world points (fdt::world_point, once a pixel) in
// registers. Then for each source, whose parameters it holds in registers,
// it projects them (fdt::reproject_world, fdt::tpu_coord: the device
// functions K1 and K3 sample with, so an anchor and the samples it governs
// come from the same bits), folds the valid coordinates into their min and
// max, reduces those across the warp by shuffles and leaves the warp's
// partials in shared memory; at the end one thread a source reduces the
// warps' partials and writes the anchor. Min and max are exact, so the
// anchors do not depend on the order of the reduction.
//
// Each map's disparity and rays are read once a launch, so the bound is
// the projections' operations: one a (pixel, source), ~150 instructions
// issued unfused under -fmad=false (IEEE square roots and divisions, each
// with its slow-path test, and atan2f for FTHETA sources). The projection
// is a long dependent chain, so the kernel lives on latency hiding: 16
// warps a block, two blocks an SM at 64 registers, and no branch around a
// pixel's projection (an invalid pixel projects a zero world point and is
// masked out of the fold), which lets the compiler interleave a thread's
// six chains. (Tried on the card: 128 to 1024 threads a block and a branch
// a pixel were slower; a projection specialised by camera type gained a
// little, left out to keep common.cuh's projection as K1 and K3 use it.)
#include "common.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = fdt::V4_TILE_H * fdt::V4_TILE_W;
constexpr int PIX = TILE / THREADS;  // pixels a thread
static_assert(TILE % THREADS == 0 && fdt::V4_TILE_W % 32 == 0, "a warp's pixels lie in one tile row");
static_assert(PIX <= 32, "the pixels' flags fit one word");
constexpr float BIG = 1e9f;

// The image row of padded grid row i of an n-row image.
__device__ __forceinline__ int grid_source(int i, int n, bool reflect) {
  if (i < n) return i;
  return (reflect && i == n) ? max(n - 2, 0) : n - 1;
}

__device__ __forceinline__ int floor_div(int a, int b) { return a >= 0 ? a / b : -((-a + b - 1) / b); }

// Dynamic shared memory: the sources' parameters [n][PARAM_SIZE], then the
// warps' partial (xmin, xmax, ymin, ymax) [n][4][WARPS].
constexpr size_t smem_floats(int n) {
  return static_cast<size_t>(n) * (fdt::PARAM_SIZE + 4 * WARPS);
}

__global__ void __launch_bounds__(THREADS)
tile_windows_kernel(const float* __restrict__ params, int n, int hs, int ws, const float* __restrict__ dst_pos,
                    const float* __restrict__ disparity, const float* __restrict__ rays, int h, int w, int ntx,
                    int nty, int ww, int wh, int ay, int hs_pad, int ws_pad, bool reflect,
                    int2* __restrict__ anchors) {
  extern __shared__ float smem[];
  float* s_par = smem;
  float* s_red = smem + static_cast<size_t>(n) * fdt::PARAM_SIZE;
  const int tile = blockIdx.x, d = blockIdx.y;
  const int ty = tile / ntx, tx = tile % ntx;
  for (int i = threadIdx.x; i < n * fdt::PARAM_SIZE; i += THREADS) s_par[i] = params[i];

  // the thread's pixels: world points and flags, whatever the number of sources
  const size_t hw = static_cast<size_t>(h) * w;
  const float* disp = disparity + d * hw;
  const float* ray = rays + d * 3 * hw;
  float wx[PIX], wy[PIX], wz[PIX];
  unsigned ok = 0;  // bit k: pixel k has d > 0 and a world point without NaN
#pragma unroll
  for (int k = 0; k < PIX; ++k) {
    const int p = threadIdx.x + k * THREADS;
    const int y = grid_source(ty * fdt::V4_TILE_H + p / fdt::V4_TILE_W, h, reflect);
    const int x = grid_source(tx * fdt::V4_TILE_W + p % fdt::V4_TILE_W, w, reflect);
    const size_t q = static_cast<size_t>(y) * w + x;
    const float dv = disp[q];
    fdt::world_point(dst_pos + 3 * d, ray[q], ray[hw + q], ray[2 * hw + q], dv, wx[k], wy[k], wz[k]);
    if (dv > 0.f && !isnan(wx[k]) && !isnan(wy[k]) && !isnan(wz[k])) {
      ok |= 1u << k;
    } else {  // projected all the same, off the slow paths NaNs take, and masked
      wx[k] = wy[k] = wz[k] = 0.f;
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int s = 0; s < n; ++s) {
    float P[fdt::PARAM_SIZE];
#pragma unroll
    for (int i = 0; i < fdt::PARAM_SIZE; ++i) P[i] = s_par[s * fdt::PARAM_SIZE + i];
    float xmin = BIG, ymin = BIG, xmax = -BIG, ymax = -BIG;
#pragma unroll
    for (int k = 0; k < PIX; ++k) {
      float cx, cy;
      const bool v = fdt::reproject_world(P, wx[k], wy[k], wz[k], true, hs, ws, cx, cy) && ((ok >> k) & 1u);
      const float xt = fdt::tpu_coord(cx, ws), yt = fdt::tpu_coord(cy, hs);
      xmin = v ? fminf(xmin, xt) : xmin;
      xmax = v ? fmaxf(xmax, xt) : xmax;
      ymin = v ? fminf(ymin, yt) : ymin;
      ymax = v ? fmaxf(ymax, yt) : ymax;
    }
    for (int off = 16; off > 0; off >>= 1) {
      xmin = fminf(xmin, __shfl_xor_sync(0xffffffffu, xmin, off));
      xmax = fmaxf(xmax, __shfl_xor_sync(0xffffffffu, xmax, off));
      ymin = fminf(ymin, __shfl_xor_sync(0xffffffffu, ymin, off));
      ymax = fmaxf(ymax, __shfl_xor_sync(0xffffffffu, ymax, off));
    }
    if (lane == 0) {
      float* r = s_red + static_cast<size_t>(s) * 4 * WARPS + warp;
      r[0 * WARPS] = xmin;
      r[1 * WARPS] = xmax;
      r[2 * WARPS] = ymin;
      r[3 * WARPS] = ymax;
    }
  }
  __syncthreads();

  for (int s = threadIdx.x; s < n; s += THREADS) {
    const float* r = s_red + static_cast<size_t>(s) * 4 * WARPS;
    float xmin = BIG, ymin = BIG, xmax = -BIG, ymax = -BIG;
    for (int k = 0; k < WARPS; ++k) {
      xmin = fminf(xmin, r[0 * WARPS + k]);
      xmax = fmaxf(xmax, r[1 * WARPS + k]);
      ymin = fminf(ymin, r[2 * WARPS + k]);
      ymax = fmaxf(ymax, r[3 * WARPS + k]);
    }
    const bool none = xmin >= BIG;
    const float xa = none ? 0.f : 0.5f * (xmin + xmax) - 0.5f * static_cast<float>(ww - 128);
    const float ya = none ? 0.f : 0.5f * (ymin + ymax) - 0.5f * static_cast<float>(wh - ay);
    const int ox = min(max(floor_div(static_cast<int>(xa), 128), 0), max((ws_pad - ww) / 128, 0)) * 128;
    const int oy = min(max(floor_div(static_cast<int>(ya), ay), 0), max((hs_pad - wh) / ay, 0)) * ay;
    anchors[((static_cast<size_t>(d) * n + s) * nty + ty) * ntx + tx] = make_int2(ox, oy);
  }
}

}  // namespace

// params (n, 24); dst_pos (d, 3); disparity (d, h, w); rays (d, 3, h, w) ->
// anchors (d, n, ceil(h/24), ceil(w/128), 2) int32 (x, y).
extern "C" int fdt_tile_windows(const float* params, int n, int hs, int ws, const float* dst_pos,
                                const float* disparity, const float* rays, int d, int h, int w, int ww, int wh,
                                int ay, int hs_pad, int ws_pad, int reflect, int* anchors, void* stream) {
  const int nty = (h + fdt::V4_TILE_H - 1) / fdt::V4_TILE_H, ntx = (w + fdt::V4_TILE_W - 1) / fdt::V4_TILE_W;
  const size_t smem = smem_floats(n) * sizeof(float);
  if (smem > 48 * 1024) {  // a rig of more than 139 sources: opt in to the larger carve-out
    const cudaError_t err = cudaFuncSetAttribute(tile_windows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(nty * ntx, d);
  tile_windows_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      params, n, hs, ws, dst_pos, disparity, rays, h, w, ntx, nty, ww, wh, ay, hs_pad, ws_pad, reflect != 0,
      reinterpret_cast<int2*>(anchors));
  return static_cast<int>(cudaGetLastError());
}
