// K1 project_sample: plane-sweep projection + bilinear sampling, all the
// destination maps of a level in one launch.
//
// Replaces facebook360_dep_tpu/ops/warp_pallas.py:project_sample_planar_v4
// (builder _make_project_kernel_v4, packed=None), batched over destinations
// as the JAX solver's lax.map over them. For every destination map, pixel
// and source camera: the world point pos + ray / disparity, its projection
// into the source (any of the four camera models, distortion clamped at
// distortion_max), validity (FOV cone, sensor bounds, finite, disparity >
// 0), and a clamp-to-edge bilinear sample of C channels. The semantics are
// the JAX package's exact XLA path: no source windows, no coordinate
// quantization, nothing ever clipped; built with -fmad=false.
//
// What bounds it on the H100: its roofline is set by bytes. One launch at
// 256x192 with 16 maps and 16 sources writes 151 MB of samples and 12.6 MB
// of validity and reads the sources' 9.4 MB of colors and 12.6 MB of rays
// and disparities: ~186 MB, ~0.055 ms at 3.35 TB/s, against ~90 FLOPs a
// (pixel, source) that take a third of that at 67 TFLOP/s. (The stack it
// reads carries a pad float a pixel, 12.6 MB in all; the bound counts only
// the colors.) At the coarsest level (50x38) the whole launch is ~7 MB,
// ~2 us: there only the launch itself and filling 132 SMs matter.
//
// The first design launched once per destination map, one thread per
// (pixel, source): 16 launches a level evaluation, each of a few hundred
// blocks at the coarse levels, where the launch's fixed cost (~3 us on the
// device, ~50 us from the host) was the kernel's time. Each thread read its
// camera from global memory, formed the world point again for every source
// and gathered 12 scalar taps from three planes.
//
// This design:
// - takes all D destination maps in one launch: the grid is (pixel blocks,
//   source groups, destinations), so the coarsest level still puts ~950
//   blocks of 128 threads on the card;
// - gives each thread one (destination, pixel) and SOURCES_PER_THREAD
//   sources: it loads the pixel's ray and disparity and forms the world
//   point (fdt::world_point) once, then projects it into each source of its
//   group (fdt::reproject_world; the two give the bits of fdt::reproject);
//   a pixel whose world point is NaN (outside the destination's FOV) or
//   whose disparity is not positive is invalid for every source and is not
//   projected;
// - stages the N x 24 camera parameters in shared memory once a block;
// - for C = 3 gathers from the interleaved (N, Hs, Ws, 4) RGB + pad stack
//   that K3 reads (one 16-byte load a tap); for C = 1 and 2 from the planes;
// - keeps the outputs channel-planar, (D, N, C, H, W) samples and (D, N, H,
//   W) validity bytes, the layout K2 reads: a warp's 32 neighbouring pixels
//   store 128 contiguous bytes of a plane (32 of validity).
// One launch for the 16 maps takes 0.135 ms at 256x192 (41% of its bound)
// and 8.9 us at 50x38 (24%), device time in a CUDA graph, against 0.233 ms
// and 49 us for the first design's 16 launches (PERF.md). What keeps it
// from the bound at 256x192 is, most likely, instruction issue: ~12.6 M
// projections (divides, square roots, atan2f for FTHETA, built without
// FMA) and 50 M 16-byte tap gathers. Of 1, 4 and 16 sources a thread, 4
// lost least over a solve's launches: 1 reforms the world point 16 times a
// pixel (0.189 ms at 256x192), 16 leaves 240 blocks at 50x38 (14.8 us).
//
// The TPU mode (template parameter TPU; the default instantiation is the
// kernel above, unchanged) reproduces the Pallas sampler's semantics as the
// JAX package runs them on its own chip: each pixel reads the window anchor
// of its 24 x 128 tile and source (tile_windows.cu), a valid projection
// outside that window is clipped (written to a third output, and not
// valid), and the window-local coordinates round to 1/256 px before the
// lerp (fdt::tpu_taps). On a stack quantized to k/256 every product and sum
// of the lerp is exact, so the kernel, its twin and the Pallas kernel agree
// to the bit wherever their projections do.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int SOURCES_PER_THREAD = 4;

// The TPU mode's inputs and its clipped flags (unused by the default mode).
struct TpuArgs {
  const int2* anchors;  // (d, n, nty, ntx) window origins
  int w, ntx, nty, ww, wh;
  uint8_t* clipped;  // (d, n, h, w)
};

// C = 3: src is the interleaved (n, hs, ws, 4) stack; C = 1, 2: (n, C, hs, ws) planes.
template <int C, bool TPU>
__global__ void __launch_bounds__(THREADS)
project_sample_kernel(const float* __restrict__ src, int n, int hs, int ws,
                      const float* __restrict__ params, const float* __restrict__ dst_pos,
                      const float* __restrict__ disparity, const float* __restrict__ rays, int hw,
                      float* __restrict__ out, uint8_t* __restrict__ valid, TpuArgs tpu) {
  extern __shared__ float s_par[];  // [n][PARAM_SIZE]
  for (int i = threadIdx.x; i < n * fdt::PARAM_SIZE; i += THREADS) s_par[i] = params[i];
  __syncthreads();

  const int pix = blockIdx.x * THREADS + threadIdx.x;
  const int d = blockIdx.z;
  if (pix >= hw) return;
  const size_t q = static_cast<size_t>(d) * hw + pix;  // (destination, pixel)
  const float disp = disparity[q];
  const float* ray = rays + static_cast<size_t>(d) * 3 * hw + pix;
  float wx, wy, wz;
  fdt::world_point(dst_pos + 3 * d, ray[0], ray[hw], ray[2 * hw], disp, wx, wy, wz);
  const bool d_ok = disp > 0.f;
  const bool live = d_ok && !isnan(wx) && !isnan(wy) && !isnan(wz);
  const size_t plane = static_cast<size_t>(hs) * ws;

  const int s_end = min(n, (static_cast<int>(blockIdx.y) + 1) * SOURCES_PER_THREAD);
  for (int s = blockIdx.y * SOURCES_PER_THREAD; s < s_end; ++s) {
    float cx, cy;
    bool ok = live && fdt::reproject_world(s_par + s * fdt::PARAM_SIZE, wx, wy, wz, d_ok, hs, ws, cx, cy);
    const size_t ds = static_cast<size_t>(d) * n + s;  // (destination, source)
    fdt::Taps t;
    if constexpr (TPU) {
      bool clip = false;
      if (ok) {
        const int y = pix / tpu.w, x = pix % tpu.w;
        const int2 o = tpu.anchors[(ds * tpu.nty + y / fdt::V4_TILE_H) * tpu.ntx + x / fdt::V4_TILE_W];
        const bool in = fdt::tpu_taps(fdt::tpu_coord(cx, ws), fdt::tpu_coord(cy, hs), o.x, o.y, tpu.ww, tpu.wh,
                                      hs, ws, t);
        clip = !in;
        ok = in;
      }
      tpu.clipped[ds * hw + pix] = clip;
    }
    valid[ds * hw + pix] = ok;
    float v[C];
#pragma unroll
    for (int ch = 0; ch < C; ++ch) v[ch] = 0.f;
    if (ok) {
      if constexpr (!TPU) t = fdt::bilinear_taps(cx, cy, hs, ws);
      if constexpr (C == 3) {
        const float4* img = reinterpret_cast<const float4*>(src) + s * plane;
        const float4 a = __ldg(img + t.i00), b = __ldg(img + t.i01);
        const float4 c = __ldg(img + t.i10), e = __ldg(img + t.i11);
        v[0] = fdt::lerp4(a.x, b.x, c.x, e.x, t);
        v[1] = fdt::lerp4(a.y, b.y, c.y, e.y, t);
        v[2] = fdt::lerp4(a.z, b.z, c.z, e.z, t);
      } else {
#pragma unroll
        for (int ch = 0; ch < C; ++ch) v[ch] = fdt::bilinear(src + (s * C + ch) * plane, t);
      }
    }
    float* o = out + ds * C * hw + pix;
#pragma unroll
    for (int ch = 0; ch < C; ++ch) o[static_cast<size_t>(ch) * hw] = v[ch];
  }
}

template <int C, bool TPU>
cudaError_t launch(const float* src, int n, int hs, int ws, const float* params, const float* dst_pos,
                   const float* disparity, const float* rays, int d, int hw, float* out, uint8_t* valid,
                   TpuArgs tpu, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(n) * fdt::PARAM_SIZE * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(project_sample_kernel<C, TPU>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((hw + THREADS - 1) / THREADS, (n + SOURCES_PER_THREAD - 1) / SOURCES_PER_THREAD, d);
  project_sample_kernel<C, TPU><<<grid, THREADS, smem, stream>>>(src, n, hs, ws, params, dst_pos, disparity,
                                                                rays, hw, out, valid, tpu);
  return cudaGetLastError();
}

}  // namespace

// c = 3: src (n, hs, ws, 4) interleaved RGB + pad; c = 1, 2: src (n, c, hs,
// ws) planes. params (n, 24); dst_pos (d, 3); disparity (d, h, w); rays (d,
// 3, h, w) -> out (d, n, c, h, w), valid (d, n, h, w) bool.
extern "C" int fdt_project_sample(const float* src, int n, int c, int hs, int ws,
                                  const float* params, const float* dst_pos,
                                  const float* disparity, const float* rays, int d, int h, int w,
                                  float* out, uint8_t* valid, void* stream) {
  const int hw = h * w;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const TpuArgs none{};
  cudaError_t err;
  switch (c) {
    case 1: err = launch<1, false>(src, n, hs, ws, params, dst_pos, disparity, rays, d, hw, out, valid, none, st); break;
    case 2: err = launch<2, false>(src, n, hs, ws, params, dst_pos, disparity, rays, d, hw, out, valid, none, st); break;
    case 3: err = launch<3, false>(src, n, hs, ws, params, dst_pos, disparity, rays, d, hw, out, valid, none, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The TPU mode: as fdt_project_sample, with anchors (d, n, ceil(h/24),
// ceil(w/128), 2) int32 and the window ww x wh -> out, valid and clipped
// (d, n, h, w) bool.
extern "C" int fdt_project_sample_tpu(const float* src, int n, int c, int hs, int ws,
                                      const float* params, const float* dst_pos,
                                      const float* disparity, const float* rays, int d, int h, int w,
                                      const int* anchors, int ww, int wh, float* out, uint8_t* valid,
                                      uint8_t* clipped, void* stream) {
  const int hw = h * w;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const TpuArgs tpu{reinterpret_cast<const int2*>(anchors), w, (w + fdt::V4_TILE_W - 1) / fdt::V4_TILE_W,
                    (h + fdt::V4_TILE_H - 1) / fdt::V4_TILE_H, ww, wh, clipped};
  cudaError_t err;
  switch (c) {
    case 1: err = launch<1, true>(src, n, hs, ws, params, dst_pos, disparity, rays, d, hw, out, valid, tpu, st); break;
    case 2: err = launch<2, true>(src, n, hs, ws, params, dst_pos, disparity, rays, d, hw, out, valid, tpu, st); break;
    case 3: err = launch<3, true>(src, n, hs, ws, params, dst_pos, disparity, rays, d, hw, out, valid, tpu, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
