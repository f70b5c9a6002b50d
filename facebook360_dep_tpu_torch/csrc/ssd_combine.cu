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
// What bounds it on the H100: reading the non-self sources' samples
// ((N - 1) x C x H x W) and validity, dst and variance once and writing two
// maps: 3.2 us at 256x192 and 0.12 us at 50x38 with 16 sources and C = 3,
// at 3.35 TB/s; its ~50
// FLOPs per (pixel, source) are far below that. It runs at the solve's
// seven coarse levels, 69% of its launches at the coarsest (50x38, the
// 150-hypothesis sweep), where the first design, one thread per pixel
// walking the sources in series with 9 validity and 9 C sample loads a
// source, gave the card 10 blocks and ~16 us of serial latency at every
// shape.
//
// This design (4.1 us at 50x38 and 15.7 us at 256x192, device time in a
// CUDA graph, chip_smoke.py's kernel table) spreads (pixels x sources) over a block of one warp per
// source (SRC = 16, looping when N is larger): a 30 x TILE_H output tile
// has a 32-wide halo, one halo column a lane. Each warp walks the halo rows
// of its source once: each cell's validity and samples are loaded once
// (coalesced) and its masked differences, sum_c diff^2 and validity
// computed once; the last three rows stay in registers, so each output row
// takes its column sums there and its right neighbours' by warp shuffles,
// in fdt::col3's order, and fdt::patch_ssd gives the source's (biased,
// unbiased) there. A lane issues all its halo column's loads (validity,
// samples, dst) before it computes, so their latencies overlap; the dst
// cells, the same for every source, come from L1. Then one thread per
// output pixel folds the sources' results into the running top two in
// source order (fdt::top2_fold), so the result is bit-identical to the
// serial design's, and K3 keeps equalling K1 followed by K2. Differences are masked with a select, not a multiply by validity,
// so an invalid sample never reaches the sums. Of the tile heights 1, 2
// and 3, one output row a block measured fastest summed over the solve's
// levels, most blocks at the coarse levels (PERF.md).
#include "common.cuh"

namespace {

constexpr int WARP = 32;
constexpr int SRC = 16;  // sources a block computes at once, one warp each
constexpr int THREADS = WARP * SRC;
constexpr int TILE_W = WARP - 2;
constexpr int TILE_H = 1;
constexpr int HALO_H = TILE_H + 2;
constexpr int PIXELS = TILE_W * TILE_H;
static_assert(PIXELS <= THREADS, "one folding thread per output pixel");
constexpr unsigned FULL = 0xffffffffu;

template <int C>
__global__ void __launch_bounds__(THREADS)
ssd_combine_kernel(const float* __restrict__ sampled, const uint8_t* __restrict__ valid,
                   const float* __restrict__ dst, const float* __restrict__ var, int n, int h, int w,
                   int exclude, float* __restrict__ cost, float* __restrict__ conf) {
  // each source's biased (-FLT_MAX where it does not count) and unbiased SSD
  __shared__ float s_b[SRC][PIXELS], s_u[SRC][PIXELS];

  const int lane = threadIdx.x % WARP, warp = threadIdx.x / WARP;
  const int x0 = blockIdx.x * TILE_W, y0 = blockIdx.y * TILE_H;
  const int hw = h * w;
  const int gx = fdt::reflect101(x0 + lane - 1, w);
  int q[HALO_H];  // this lane's halo cells
#pragma unroll
  for (int r = 0; r < HALO_H; ++r) q[r] = fdt::reflect101(y0 - 1 + r, h) * w + gx;

  fdt::Top2 t;
  for (int base = 0; base < n; base += SRC) {
    const int s = base + warp;
    if (s < n && s != exclude) {  // uniform across the warp
      const uint8_t* vs = valid + static_cast<size_t>(s) * hw;
      const float* ss = sampled + static_cast<size_t>(s) * C * hw;
      // every load of the halo column first, so their latencies overlap
      bool v[HALO_H];
      float dv[HALO_H][C], sv[HALO_H][C];
#pragma unroll
      for (int r = 0; r < HALO_H; ++r) {
        v[r] = vs[q[r]] != 0;
#pragma unroll
        for (int ch = 0; ch < C; ++ch) {
          dv[r][ch] = __ldg(dst + ch * hw + q[r]);
          sv[r][ch] = ss[static_cast<size_t>(ch) * hw + q[r]];
        }
      }
      float win[3][2 + C];  // halo rows r - 2 .. r: validity, sum_c diff^2, diff_c
#pragma unroll
      for (int r = 0; r < HALO_H; ++r) {
        float* cell = win[r % 3];
        cell[0] = v[r] ? 1.f : 0.f;
        float sq = 0.f;
#pragma unroll
        for (int ch = 0; ch < C; ++ch) {
          const float diff = v[r] ? dv[r][ch] - sv[r][ch] : 0.f;
          cell[2 + ch] = diff;
          sq = ch == 0 ? diff * diff : sq + diff * diff;
        }
        cell[1] = sq;
        if (r < 2) continue;
        const float* top = win[(r - 2) % 3];
        const float* mid = win[(r - 1) % 3];
        float box[2 + C];
#pragma unroll
        for (int p = 0; p < 2 + C; ++p) {
          const float c0 = fdt::col3(top[p], mid[p], cell[p]);
          const float c1 = __shfl_down_sync(FULL, c0, 1);
          const float c2 = __shfl_down_sync(FULL, c0, 2);
          box[p] = fdt::col3(c0, c1, c2);
        }
        const float center = __shfl_down_sync(FULL, mid[0], 1);
        float sum_dc[C];
#pragma unroll
        for (int ch = 0; ch < C; ++ch) sum_dc[ch] = box[2 + ch];
        const fdt::Patch pt = fdt::patch_ssd<C>(box[0], box[1], sum_dc, center > 0.f);
        if (lane < TILE_W) {
          s_b[warp][(r - 2) * TILE_W + lane] = pt.b;
          s_u[warp][(r - 2) * TILE_W + lane] = pt.u;
        }
      }
    }
    __syncthreads();
    if (threadIdx.x < PIXELS) {  // the fold, in source order
      const int m = min(SRC, n - base);
      for (int k = 0; k < m; ++k) {
        if (base + k == exclude) continue;
        const float b = s_b[k][threadIdx.x];  // a biased SSD that counts is >= 0 or NaN
        fdt::top2_fold(fdt::Patch{b, s_u[k][threadIdx.x], b != -FLT_MAX}, t);
      }
    }
    __syncthreads();  // the next chunk overwrites s_b and s_u
  }
  const int x = x0 + threadIdx.x % TILE_W, y = y0 + threadIdx.x / TILE_W;
  if (threadIdx.x < PIXELS && x < w && y < h) fdt::top2_finish(t, n, var[y * w + x], cost[y * w + x], conf[y * w + x]);
}

}  // namespace

// sampled (n, c, h, w); valid (n, h, w) bool; dst (c, h, w); var (h, w)
// -> cost, conf (h, w). c in 1..3.
extern "C" int fdt_ssd_combine(const float* sampled, const uint8_t* valid, const float* dst,
                               const float* var, int n, int c, int h, int w, int exclude,
                               float* cost, float* conf, void* stream) {
  const dim3 block(THREADS);
  const dim3 grid((w + TILE_W - 1) / TILE_W, (h + TILE_H - 1) / TILE_H);
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
