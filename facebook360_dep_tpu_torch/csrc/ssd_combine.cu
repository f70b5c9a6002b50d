// K2 ssd_combine: bias-compensated 3x3 patch SSDs + drop-2-worst combine.
//
// Replaces facebook360_dep_tpu/ops/warp_pallas.py:ssd_combine (builder
// _make_ssd_combine_kernel). For every destination pixel and non-self
// source: masked differences dst - sample, the 3x3 reflect-101 box of
// validity (cnt), biased = box(sum_c diff^2) * 9 / cnt, unbiased =
// max(biased - 9 * sum_c (box(diff_c) / cnt)^2, 0), the source counting
// where the center is valid and cnt >= 5; then the two largest biased
// SSDs are dropped and the rest averaged (ops/cost.py::combine_top2).
//
// What bounds it on the H100: reading the sampled stack (N x C x H x W)
// and validity, 9 neighbours a source; the arithmetic is ~60 FLOPs per
// neighbour. The TPU kernel DMA'd padded (32, 512) windows with an (8, 128)
// aligned halo ring; here one thread owns one destination pixel, reads its
// 3x3 neighbourhood through L1 (neighbouring threads share 6 of 9 cells),
// and keeps the running top two in registers across the source loop, so no
// per-source plane is written. Differences are masked with a select, not a
// multiply by validity, so an invalid sample never reaches the sums.
#include "common.cuh"

namespace {

template <int C>
__global__ void ssd_combine_kernel(const float* __restrict__ sampled,
                                   const uint8_t* __restrict__ valid,
                                   const float* __restrict__ dst, const float* __restrict__ var,
                                   int n, int h, int w, int exclude, float* __restrict__ cost,
                                   float* __restrict__ conf) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const int hw = h * w;
  const int ys[3] = {fdt::reflect101(y - 1, h), y, fdt::reflect101(y + 1, h)};
  const int xs[3] = {fdt::reflect101(x - 1, w), x, fdt::reflect101(x + 1, w)};
  int q[3][3];
  float dv[C][3][3];
  for (int dy = 0; dy < 3; ++dy)
    for (int dx = 0; dx < 3; ++dx) {
      q[dy][dx] = ys[dy] * w + xs[dx];
      for (int ch = 0; ch < C; ++ch) dv[ch][dy][dx] = dst[ch * hw + q[dy][dx]];
    }

  fdt::Top2 t;
  for (int s = 0; s < n; ++s) {
    if (s == exclude) continue;
    const uint8_t* vs = valid + static_cast<size_t>(s) * hw;
    const float* ss = sampled + static_cast<size_t>(s) * C * hw;
    float vld[3][3], d2[3][3], dc[C][3][3];
    for (int dy = 0; dy < 3; ++dy)
      for (int dx = 0; dx < 3; ++dx) {
        const int qq = q[dy][dx];
        const bool v = vs[qq] != 0;
        vld[dy][dx] = v ? 1.f : 0.f;
        float sq = 0.f;
        for (int ch = 0; ch < C; ++ch) {
          const float diff = v ? dv[ch][dy][dx] - ss[static_cast<size_t>(ch) * hw + qq] : 0.f;
          dc[ch][dy][dx] = diff;
          sq = ch == 0 ? diff * diff : sq + diff * diff;
        }
        d2[dy][dx] = sq;
      }
    fdt::patch_update<C>(vld, d2, dc, t);
  }
  fdt::top2_finish(t, n, var[y * w + x], cost[y * w + x], conf[y * w + x]);
}

}  // namespace

// sampled (n, c, h, w); valid (n, h, w) bool; dst (c, h, w); var (h, w)
// -> cost, conf (h, w). c in 1..3.
extern "C" int fdt_ssd_combine(const float* sampled, const uint8_t* valid, const float* dst,
                               const float* var, int n, int c, int h, int w, int exclude,
                               float* cost, float* conf, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((w + block.x - 1) / block.x, (h + block.y - 1) / block.y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 1:
      ssd_combine_kernel<1><<<grid, block, 0, st>>>(sampled, valid, dst, var, n, h, w, exclude, cost, conf);
      break;
    case 2:
      ssd_combine_kernel<2><<<grid, block, 0, st>>>(sampled, valid, dst, var, n, h, w, exclude, cost, conf);
      break;
    case 3:
      ssd_combine_kernel<3><<<grid, block, 0, st>>>(sampled, valid, dst, var, n, h, w, exclude, cost, conf);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
