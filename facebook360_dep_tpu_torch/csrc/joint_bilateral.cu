// Joint bilateral of a level: the colour-guided joint bilateral filter of
// all D destination disparity maps of a pyramid level in one launch.
//
// Replaces no TPU kernel. The JAX package computes this filter with XLA ops
// (facebook360_dep_tpu/ops/filters.py:39-69) one map at a time, and so did
// the port (ops/filters.py::joint_bilateral, a loop of whole-image ops over
// the window's taps): some 17 launches a tap, 746 taps a map over a ten-level
// frame, ~207,000 launches a 2K frame of 16 maps, whose host cost was the
// largest part of the solve. This kernel does the work of one level's
// solver.spatial_bilateral in one launch.
//
// For each map d, pixel p and tap t = (dy, dx) of the (2R+1)^2 window, every
// position clamped to the edge, with g the map's source colours
// (dst2src[d]), v its disparity and m its mask (fov & fg):
//   dist = (w0 d0) d0 + (w1 d1) d1 + (w2 d2) d2,  dc = g_c(p) - g_c(p + t),
//   wt   = expf(-(dist * float(1/3)) * 20000) * m(p + t),
//   sum_w += wt;  sum_wv += wt * v(p + t)           (dy, then dx),
// and out = sum_wv / sum_w where m(p) and sum_w != 0, else v(p). The
// arithmetic is the plain path's operation for operation, as PyTorch runs it
// on the card: the weights (1, 1, 0.5) of filters.BILATERAL_WEIGHTS_RGB (a
// product by 1 is exact and left out), a division by the Python scalar 3 as
// a product by the float32 reciprocal, 1 / (2 sigma^2) for sigma 0.005 as the
// float32 20000, expf, each sum in tap order, an IEEE division, and no
// contraction into FMAs (-fmad=false), so the result is the plain path's bit
// for bit. A masked-out tap still adds its 0 x v, which is NaN where v is not
// finite, as in the plain path; only a thread whose pixels all pass through
// skips the taps.
//
// What bounds it on the H100: FP32 issue. A tap is ~15 unfused FP32
// operations and one expf (one MUFU.EX2 and a few FP32 instructions of its
// range reduction), the expf's SFU time about half the issue's; the bytes
// (12 of colour, 4 of disparity, 1 of mask read and 4 written a pixel and map)
// would take about a tenth of it. So the design keeps the taps' operands out
// of device memory and cuts the shared-memory traffic per tap:
// - one block a (32 x 4T output tile, map), the D maps on gridDim.z; the
//   block loads the tile and its R-wide halo once into shared memory, each
//   pixel as one float4 (r, g, b of the 16-byte interleaved source stack,
//   the disparity in the pad lane) and the mask as one byte;
// - each thread owns a column of 4 pixels and walks the halo rows it needs
//   once: a loaded (row, dx) value serves up to 4 of its pixels (at
//   successive dy), so a tap costs ~0.3 shared loads, not 2; each pixel
//   still meets its taps in the plain path's order (dy, then dx);
// - the radius is a template parameter (1..5), so the dx and pixel loops
//   unroll; the row loop stays rolled, which keeps the code within the
//   instruction cache at R = 5;
// - T (threads a column, 8, 4, 2 or 1) shrinks on the small levels until the
//   grid holds two blocks an SM, so the coarse levels still spread over the
//   card. The algorithm is one for every level: it adapts to the radius and
//   the level's shape.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE_W = 32;         // a warp across the tile's width
constexpr int PIX = 4;             // pixels a thread, down a column
constexpr int MAX_THREADS_Y = 8;   // 256 threads a block at most
constexpr int MAX_MAPS = 512;      // maps a launch: their sources travel by value
constexpr float ONE_THIRD = 1.0f / 3.0f;     // PyTorch's reciprocal of the divisor 3
constexpr float INV_TWO_SIGMA_SQ = 20000.0f; // float32(1 / (2 * 0.005^2))
constexpr float WEIGHT_B = 0.5f;   // filters.BILATERAL_WEIGHTS_RGB[2]; R and G weigh 1

struct MapSources {
  int src[MAX_MAPS];  // each map's index among the sources
};

__device__ __forceinline__ void tap(float c0, float c1, float c2, float4 g, float m, float& sw, float& swv) {
  const float d0 = c0 - g.x, d1 = c1 - g.y, d2 = c2 - g.z;
  float dist = d0 * d0;
  dist = dist + d1 * d1;
  dist = dist + (WEIGHT_B * d2) * d2;
  const float wt = expf(-(dist * ONE_THIRD) * INV_TWO_SIGMA_SQ) * m;
  sw = sw + wt;
  swv = swv + wt * g.w;
}

template <int R>
__global__ void __launch_bounds__(TILE_W * MAX_THREADS_Y)
joint_bilateral_kernel(const float4* __restrict__ rgba, int h, int w, MapSources maps,
                       const float* __restrict__ disparity, const uint8_t* __restrict__ mask,
                       float* __restrict__ out) {
  constexpr int HALO_W = TILE_W + 2 * R;
  extern __shared__ float4 s_px[];  // [halo_h][HALO_W] (r, g, b, disparity), then the mask bytes
  const int tile_h = blockDim.y * PIX;
  const int halo_h = tile_h + 2 * R;
  uint8_t* s_m = reinterpret_cast<uint8_t*>(s_px + halo_h * HALO_W);
  const int d = blockIdx.z;
  const size_t plane = static_cast<size_t>(h) * w;
  const float4* guide = rgba + static_cast<size_t>(maps.src[d]) * plane;
  const float* disp = disparity + d * plane;
  const uint8_t* msk = mask + d * plane;
  const int x0 = blockIdx.x * TILE_W, y0 = blockIdx.y * tile_h;

  for (int i = threadIdx.y * TILE_W + threadIdx.x; i < halo_h * HALO_W; i += TILE_W * blockDim.y) {
    const int gy = min(max(y0 - R + i / HALO_W, 0), h - 1);
    const int gx = min(max(x0 - R + i % HALO_W, 0), w - 1);
    const size_t q = static_cast<size_t>(gy) * w + gx;
    float4 g = guide[q];
    g.w = disp[q];
    s_px[i] = g;
    s_m[i] = msk[q];
  }
  __syncthreads();

  const int x = x0 + threadIdx.x, row0 = threadIdx.y * PIX;  // the thread's first row in the tile
  float c0[PIX], c1[PIX], c2[PIX], v[PIX], sw[PIX], swv[PIX];
  bool in[PIX];
  bool any = false;
#pragma unroll
  for (int k = 0; k < PIX; ++k) {
    const int i = (row0 + k + R) * HALO_W + threadIdx.x + R;
    const float4 c = s_px[i];
    c0[k] = c.x;
    c1[k] = c.y;
    c2[k] = c.z;
    v[k] = c.w;
    in[k] = s_m[i] != 0 && y0 + row0 + k < h && x < w;
    any = any || in[k];
    sw[k] = 0.f;
    swv[k] = 0.f;
  }
  if (any) {
    // halo row r holds tap dy = r - k - R of the thread's pixel k
    for (int r = 0; r < PIX + 2 * R; ++r) {
      bool ok[PIX];
#pragma unroll
      for (int k = 0; k < PIX; ++k) ok[k] = r - k >= 0 && r - k <= 2 * R;
      const int base = (row0 + r) * HALO_W + threadIdx.x;
#pragma unroll
      for (int j = 0; j <= 2 * R; ++j) {  // dx = j - R
        const float4 g = s_px[base + j];
        const float m = static_cast<float>(s_m[base + j]);
#pragma unroll
        for (int k = 0; k < PIX; ++k) {
          if (ok[k]) tap(c0[k], c1[k], c2[k], g, m, sw[k], swv[k]);
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < PIX; ++k) {
    const int y = y0 + row0 + k;
    if (y < h && x < w) {
      out[d * plane + static_cast<size_t>(y) * w + x] = (in[k] && sw[k] != 0.f) ? __fdiv_rn(swv[k], sw[k]) : v[k];
    }
  }
}

template <int R>
int launch(const float4* rgba, int h, int w, const MapSources& maps, int d, const float* disparity,
           const uint8_t* mask, float* out, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the tallest tile that still gives two blocks an SM (a column of one thread at least)
  const int gx = (w + TILE_W - 1) / TILE_W;
  int ty = MAX_THREADS_Y;
  while (ty > 1 && static_cast<long long>(gx) * ((h + ty * PIX - 1) / (ty * PIX)) * d < 2LL * sms) ty /= 2;
  const dim3 grid(gx, (h + ty * PIX - 1) / (ty * PIX), d), block(TILE_W, ty);
  const size_t halo = static_cast<size_t>(ty * PIX + 2 * R) * (TILE_W + 2 * R);
  const size_t smem = halo * (sizeof(float4) + 1);  // under 48 KB at R = 5, T = 8
  joint_bilateral_kernel<R><<<grid, block, smem, stream>>>(rgba, h, w, maps, disparity, mask, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rgba (n, h, w, 4) the interleaved source stack; dst2src (d,) host ints, each
// map's source; disparity (d, h, w) f32; mask (d, h, w) bool; radius 1..5 ->
// out (d, h, w) f32.
extern "C" int fdt_joint_bilateral(const float* rgba, int n, int h, int w, const int* dst2src, int d,
                                   const float* disparity, const uint8_t* mask, int radius, float* out,
                                   void* stream) {
  if (d < 1 || d > MAX_MAPS || h < 1 || w < 1) return static_cast<int>(cudaErrorInvalidValue);
  MapSources maps{};
  for (int i = 0; i < d; ++i) {
    if (dst2src[i] < 0 || dst2src[i] >= n) return static_cast<int>(cudaErrorInvalidValue);
    maps.src[i] = dst2src[i];
  }
  const float4* src = reinterpret_cast<const float4*>(rgba);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (radius) {
    case 1: return launch<1>(src, h, w, maps, d, disparity, mask, out, s);
    case 2: return launch<2>(src, h, w, maps, d, disparity, mask, out, s);
    case 3: return launch<3>(src, h, w, maps, d, disparity, mask, out, s);
    case 4: return launch<4>(src, h, w, maps, d, disparity, mask, out, s);
    case 5: return launch<5>(src, h, w, maps, d, disparity, mask, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
