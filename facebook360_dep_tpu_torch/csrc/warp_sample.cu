// K4 warp_sample: clamp-to-edge bilinear sampling at caller-given coords.
//
// Replaces facebook360_dep_tpu/ops/warp_pallas.py:warp_sample_planar
// (made by _make_kernel). For every source s and destination pixel p:
// valid = coords[s, p] is finite; sampled[s, :, p] = the bilinear sample of
// the source's C planes at coords[s, p] (pixel-center convention, each tap
// clamped to the image), 0 where not valid. A NaN tap propagates to the
// sample even at zero weight, as in ops/sampling.py::bilinear_sample, which
// the render gather relies on to drop cameras whose own disparity is NaN.
//
// What bounds it on the H100: memory traffic. A launch reads the coords
// (8 bytes a pixel and source) and writes C + 1 planes (4C + 1 bytes);
// the four taps a pixel and channel come through L1/L2 from source planes
// that are read many times over (one render gather samples 15 sources of
// 2048x1536x4 floats at 6 x 1536^2 cube pixels each). The TPU kernel
// staged a 48x384 source window per 16x128 tile in VMEM, quantized the
// subpixel position to 1/256 px and contracted bf16 hat weights on the MXU,
// because the TPU has no gather; the H100 gathers natively, so there is no
// window, no quantization and no window-overflow invalidity here. One
// thread per (source, destination pixel), looping over channels;
// neighbouring threads take neighbouring destination pixels, so the coord
// reads and the output writes coalesce.
#include "common.cuh"

namespace {

__global__ void warp_sample_kernel(const float* __restrict__ src, int c, int hs, int ws,
                                   const float* __restrict__ coords, int hw,
                                   float* __restrict__ out, uint8_t* __restrict__ valid) {
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  const int s = blockIdx.y;
  if (pix >= hw) return;
  const size_t sp = static_cast<size_t>(s) * hw + pix;
  const float cx = coords[2 * sp], cy = coords[2 * sp + 1];
  // bilinear_sample tests x - 0.5 and y - 0.5; both overflow to inf only
  // where the coords are already infinite
  const bool ok = isfinite(cx) && isfinite(cy);
  valid[sp] = ok;
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

// src (n, c, hs, ws); coords (n, h, w, 2) as (x, y) -> out (n, c, h, w),
// valid (n, h, w) bool.
extern "C" int fdt_warp_sample(const float* src, int n, int c, int hs, int ws, const float* coords,
                               int h, int w, float* out, uint8_t* valid, void* stream) {
  const int hw = h * w;
  const dim3 block(256);
  const dim3 grid((hw + block.x - 1) / block.x, n);
  warp_sample_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(src, c, hs, ws, coords,
                                                                           hw, out, valid);
  return static_cast<int>(cudaGetLastError());
}
