// K1 project_sample: plane-sweep projection + bilinear sampling.
//
// Replaces facebook360_dep_tpu/ops/warp_pallas.py:project_sample_planar_v4
// (builder _make_project_kernel_v4, packed=None). For every destination
// pixel and source camera: the world point pos + ray / disparity, its
// projection into the source (any of the four camera models, distortion
// clamped at distortion_max), validity (FOV cone, sensor bounds, finite,
// disparity > 0), and a clamp-to-edge bilinear sample of C channels.
//
// What bounds it on the H100: the 4-tap gathers from the source planes
// (N x C x Hs x Ws float32, up to 600 MB at 2K x 16 sources) and the
// N x C x H x W output writes; the projection is ~100 FLOPs a pixel. The
// TPU kernel staged per-tile source windows in VMEM and contracted hat
// weights on the MXU because the TPU has no gather; here each thread
// gathers its four taps directly through L1/L2, so there is no window,
// no coordinate quantization and nothing is ever clipped. One thread per
// (source, destination pixel); neighbouring threads take neighbouring
// destination pixels, so the output writes coalesce and the taps of a
// warp land in a few nearby source rows.
#include "common.cuh"

namespace {

__global__ void project_sample_kernel(const float* __restrict__ src, int c, int hs, int ws,
                                      const float* __restrict__ params,
                                      const float* __restrict__ dst_pos,
                                      const float* __restrict__ disparity,
                                      const float* __restrict__ rays, int hw,
                                      float* __restrict__ out, uint8_t* __restrict__ valid) {
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  const int s = blockIdx.y;
  if (pix >= hw) return;
  const float* P = params + s * fdt::PARAM_SIZE;
  float cx, cy;
  const bool ok = fdt::reproject(P, dst_pos, rays[pix], rays[hw + pix], rays[2 * hw + pix],
                                 disparity[pix], hs, ws, cx, cy);
  valid[static_cast<size_t>(s) * hw + pix] = ok;
  const size_t plane = static_cast<size_t>(hs) * ws;
  const float* img = src + static_cast<size_t>(s) * c * plane;
  float* o = out + static_cast<size_t>(s) * c * hw + pix;
  if (!ok) {
    for (int ch = 0; ch < c; ++ch) o[static_cast<size_t>(ch) * hw] = 0.f;
    return;
  }
  const fdt::Taps t = fdt::bilinear_taps(cx, cy, hs, ws);
  for (int ch = 0; ch < c; ++ch) o[static_cast<size_t>(ch) * hw] = fdt::bilinear(img + ch * plane, t);
}

}  // namespace

// src (n, c, hs, ws); params (n, 24); dst_pos (3,); disparity (h, w);
// rays (3, h, w) -> out (n, c, h, w), valid (n, h, w) bool.
extern "C" int fdt_project_sample(const float* src, int n, int c, int hs, int ws,
                                  const float* params, const float* dst_pos,
                                  const float* disparity, const float* rays, int h, int w,
                                  float* out, uint8_t* valid, void* stream) {
  const int hw = h * w;
  const dim3 block(256);
  const dim3 grid((hw + block.x - 1) / block.x, n);
  project_sample_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      src, c, hs, ws, params, dst_pos, disparity, rays, hw, out, valid);
  return static_cast<int>(cudaGetLastError());
}
