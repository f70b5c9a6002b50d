// Chamfer labels: for each of B maps of valid flags, the flat index y * W + x
// of every pixel's nearest valid pixel under OpenCV's chamfer distance with
// labels (imgproc/distransform.cpp, distanceTransformEx_5x5, which
// cv2.distanceTransformWithLabels(~valid, DIST_L2, ..., DIST_LABEL_PIXEL)
// runs whatever mask size it is given), and -1 in a map with no valid pixel.
// The labels are those of depth/pipeline.py::_nearest_valid_index and of
// ops/warp_cuda.py::chamfer_labels_plain, bit for bit.
//
// Replaces no TPU kernel. The JAX package computes these labels on its host
// with cv2 (facebook360_dep_tpu/depth/pipeline.py:125-170) in the init
// between pyramid levels of the foreground pass, and so did the port, in
// numpy: some 9-10 s of host time a 2K frame of 16 maps at level 0, with
// the card idle. This kernel makes the labels of a level's maps in one
// launch, so the init stays on the card.
//
// The algorithm, as OpenCV and the numpy twin run it, in int32 16.16 fixed
// point: dist is 0 at a valid pixel and INIT = (2^31 - 1) >> 2 elsewhere,
// the label the pixel's own index or -1; a border of 2 px of INIT with label
// -1 surrounds the map. A forward pass walks the rows top to bottom; each
// pixel first takes, in order and each compare strict, the seven neighbours
// of the two finished rows above, (dy, dx, cost) = (-2,-1,L) (-2,1,L)
// (-1,-2,L) (-1,-1,D) (-1,0,H) (-1,1,D) (-1,2,L), then its left neighbour
// (H), with H, D, L = 65536, 91750, 143976. A backward pass mirrors it:
// rows bottom to top, the neighbours negated, then the right neighbour.
//
// The in-row step v[j] = min(a[j], v[j-1] + H), which takes the label of
// j-1 only where a[j] is strictly larger, is a scan: v[j] = min over k <= j
// of (a[k] - k H) + j H, and the label is that of the largest such k among
// equal minima. So a row is a block-wide inclusive scan of the pairs
// (a[k] - k H, label) in which the later element wins ties: a thread scans
// its run of P pixels, the warps scan the threads' totals with shuffles, and
// one exchange through shared memory adds the earlier warps' totals.
//
// What bounds it on the H100: the chain of 2H dependent row steps of each
// map, not bytes. A 2K level (16 maps of 2048x1536) moves about 1.06 GB
// (valid read, the forward pass's dist and label written and read back, the
// labels written): 0.32 ms at 3.35 TB/s; its 3,072 row steps, each a
// block-wide scan with two barriers, take milliseconds. So the design keeps
// every row step short:
// - one block a map, all the level's maps in one launch on gridDim.x; each
//   thread owns a run of P consecutive pixels of every row (P the smallest
//   of 1..16 that fits the row in 256 threads, a template parameter), and
//   keeps its pixels of the two previous rows in registers;
// - only the two pixels at each end of a thread's run go through shared
//   memory, for the neighbours' halos: a row step reads 4 and writes up to 4
//   (dist, label) pairs a thread, where a ring of whole rows in shared memory
//   would read ~2P with bank conflicts;
// - the row's inputs (the valid flags, or in the backward pass the forward
//   pass's dist and label) are loaded one row ahead into registers, so their
//   latency hides under the current row's scan;
// - the forward pass's dist and label, which the backward pass needs, go to
//   device memory as 16-byte stores where the row allows.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int HV = 65536;          // cvRound(1 * 2^16): a step along a row or column
constexpr int DIAG = 91750;        // cvRound(1.4 * 2^16): a diagonal step
constexpr int KNIGHT = 143976;     // cvRound(2.1969 * 2^16): a (1, 2) step
constexpr int INIT = INT_MAX >> 2; // "far": INIT + KNIGHT and W steps of HV stay below 2^31
constexpr int MAX_THREADS = 256;
constexpr int MAX_P = 16;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

// A scan element: key a[k] - k HV and the label that goes with it.
struct KL {
  int key, lab;
};

// a, then b along the scan: the later element wins ties
__device__ __forceinline__ KL later_min(KL a, KL b) { return b.key <= a.key ? b : a; }

__device__ __forceinline__ void relax(int2& best, int2 n, int cost) {
  const int cand = n.x + cost;
  if (cand < best.x) best = make_int2(cand, n.y);
}

// the element of the lane `off` before this one along the scan
template <bool BACK>
__device__ __forceinline__ KL shfl_earlier(KL v, int off) {
  if (BACK) return KL{__shfl_down_sync(FULL, v.key, off), __shfl_down_sync(FULL, v.lab, off)};
  return KL{__shfl_up_sync(FULL, v.key, off), __shfl_up_sync(FULL, v.lab, off)};
}

// The pass's input of row y at the thread's pixels x0..x0+P-1: from the valid
// flags (forward) or the forward pass's dist and label (backward); INIT and
// -1 beyond the row.
template <int P, bool BACK>
__device__ __forceinline__ void load_row(const uint8_t* __restrict__ valid, const int* dist, const int* label,
                                         int y, int w, int x0, int2 (&out)[P]) {
  const size_t row = static_cast<size_t>(y) * w;
  if (!BACK) {
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int x = x0 + k;
      const bool v = x < w && valid[row + x] != 0;
      out[k] = v ? make_int2(0, static_cast<int>(row + x)) : make_int2(INIT, -1);
    }
    return;
  }
  if constexpr (P % 4 == 0) {
    if ((w & 3) == 0 && x0 + P <= w) {
#pragma unroll
      for (int k = 0; k < P; k += 4) {
        const int4 d = *reinterpret_cast<const int4*>(dist + row + x0 + k);
        const int4 l = *reinterpret_cast<const int4*>(label + row + x0 + k);
        out[k] = make_int2(d.x, l.x);
        out[k + 1] = make_int2(d.y, l.y);
        out[k + 2] = make_int2(d.z, l.z);
        out[k + 3] = make_int2(d.w, l.w);
      }
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int x = x0 + k;
    out[k] = x < w ? make_int2(dist[row + x], label[row + x]) : make_int2(INIT, -1);
  }
}

template <int P>
__device__ __forceinline__ void store_row(int* dist, int* label, int y, int w, int x0, const int2 (&v)[P],
                                          bool with_dist) {
  const size_t row = static_cast<size_t>(y) * w;
  if constexpr (P % 4 == 0) {
    if ((w & 3) == 0 && x0 + P <= w) {
#pragma unroll
      for (int k = 0; k < P; k += 4) {
        if (with_dist) {
          *reinterpret_cast<int4*>(dist + row + x0 + k) = make_int4(v[k].x, v[k + 1].x, v[k + 2].x, v[k + 3].x);
        }
        *reinterpret_cast<int4*>(label + row + x0 + k) = make_int4(v[k].y, v[k + 1].y, v[k + 2].y, v[k + 3].y);
      }
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int x = x0 + k;
    if (x < w) {
      if (with_dist) dist[row + x] = v[k].x;
      label[row + x] = v[k].y;
    }
  }
}

// One raster pass over a map. s_edge holds (dist, label) of the previous row
// at column x in entry x + 2 (two columns of padding on the left, and on the
// right past the threads' last pixel), written only at the ends of each
// thread's run; s_tot the warps' scan totals.
template <int P, bool BACK>
__device__ void chamfer_pass(const uint8_t* __restrict__ valid, int h, int w, int* dist, int* label, int2* s_edge,
                             KL* s_tot) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, nwarps = blockDim.x >> 5;
  const int wp = blockDim.x * P;  // the padded row the threads cover
  const int x0 = t * P;
  const int2 far = make_int2(INIT, -1);
  const KL none{INT_MAX, -1};

  for (int i = t; i < wp + 4; i += blockDim.x) s_edge[i] = far;  // the border row before the first
  __syncthreads();
  int2 prev1[P], prev2[P], cur[P], next[P];  // rows y -/+ 1 and 2 of the pass, y, and the next y
#pragma unroll
  for (int k = 0; k < P; ++k) prev1[k] = prev2[k] = far;
  int2 prev2_left = far, prev2_right = far;  // row y -/+ 2 at x0 - 1 and x0 + P
  load_row<P, BACK>(valid, dist, label, BACK ? h - 1 : 0, w, x0, cur);

  for (int i = 0; i < h; ++i) {
    const int y = BACK ? h - 1 - i : i;
    if (i + 1 < h) load_row<P, BACK>(valid, dist, label, BACK ? y - 1 : y + 1, w, x0, next);

    // the previous row at x0 - 2 .. x0 + P + 1 (n1[j] is column x0 - 2 + j),
    // the one before at x0 - 1 .. x0 + P (n2[j] is column x0 - 1 + j)
    int2 n1[P + 4], n2[P + 2];
    n1[0] = s_edge[x0];
    n1[1] = s_edge[x0 + 1];
    n1[P + 2] = s_edge[x0 + P + 2];
    n1[P + 3] = s_edge[x0 + P + 3];
    n2[0] = prev2_left;
    n2[P + 1] = prev2_right;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      n1[k + 2] = prev1[k];
      n2[k + 1] = prev2[k];
    }

    // the finished rows' neighbours, in OpenCV's order, then the scan key
    KL run[P];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      int2 b = cur[k];
      if (BACK) {
        relax(b, n2[k + 2], KNIGHT);  // (2, 1)
        relax(b, n2[k], KNIGHT);      // (2, -1)
        relax(b, n1[k + 4], KNIGHT);  // (1, 2)
        relax(b, n1[k + 3], DIAG);    // (1, 1)
        relax(b, n1[k + 2], HV);      // (1, 0)
        relax(b, n1[k + 1], DIAG);    // (1, -1)
        relax(b, n1[k], KNIGHT);      // (1, -2)
      } else {
        relax(b, n2[k], KNIGHT);      // (-2, -1)
        relax(b, n2[k + 2], KNIGHT);  // (-2, 1)
        relax(b, n1[k], KNIGHT);      // (-1, -2)
        relax(b, n1[k + 1], DIAG);    // (-1, -1)
        relax(b, n1[k + 2], HV);      // (-1, 0)
        relax(b, n1[k + 3], DIAG);    // (-1, 1)
        relax(b, n1[k + 4], KNIGHT);  // (-1, 2)
      }
      if (x0 + k >= w) b = far;  // past the row: the border, which no pixel of the row can take
      const int pos = BACK ? wp - 1 - (x0 + k) : x0 + k;  // the pixel's place along the scan
      run[k] = KL{b.x - pos * HV, b.y};
    }
    // the thread's run, scanned in the pass's direction
#pragma unroll
    for (int j = 1; j < P; ++j) {
      const int k = BACK ? P - 1 - j : j;
      run[k] = later_min(run[BACK ? k + 1 : k - 1], run[k]);
    }
    // the warp's threads, then the warps
    KL inc = run[BACK ? 0 : P - 1];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const KL o = shfl_earlier<BACK>(inc, off);
      if (BACK ? lane + off < 32 : lane >= off) inc = later_min(o, inc);
    }
    KL before = shfl_earlier<BACK>(inc, 1);
    if (BACK ? lane == 31 : lane == 0) before = none;
    if (BACK ? lane == 0 : lane == 31) s_tot[warp] = inc;
    __syncthreads();
    KL pre = none;
    if (BACK) {
      for (int v = nwarps - 1; v > warp; --v) pre = later_min(pre, s_tot[v]);
    } else {
      for (int v = 0; v < warp; ++v) pre = later_min(pre, s_tot[v]);
    }
    pre = later_min(pre, before);

    int2 out[P];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const KL r = later_min(pre, run[k]);
      const int pos = BACK ? wp - 1 - (x0 + k) : x0 + k;
      out[k] = x0 + k < w ? make_int2(r.key + pos * HV, r.lab) : far;
    }
    // the forward pass keeps dist and label for the backward pass, which writes the labels
    store_row<P>(dist, label, y, w, x0, out, !BACK);
    prev2_left = n1[1];
    prev2_right = n1[P + 2];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      prev2[k] = prev1[k];
      prev1[k] = out[k];
      if (k < 2 || k >= P - 2) s_edge[x0 + k + 2] = out[k];
      cur[k] = next[k];
    }
    __syncthreads();
  }
}

template <int P>
__global__ void __launch_bounds__(MAX_THREADS) chamfer_labels_kernel(const uint8_t* __restrict__ valid, int h, int w,
                                                                     int* dist, int* label) {
  __shared__ KL s_tot[MAX_WARPS];
  extern __shared__ int2 s_edge[];
  const size_t plane = static_cast<size_t>(h) * w;
  const size_t map = static_cast<size_t>(blockIdx.x) * plane;
  chamfer_pass<P, false>(valid + map, h, w, dist + map, label + map, s_edge, s_tot);
  chamfer_pass<P, true>(valid + map, h, w, dist + map, label + map, s_edge, s_tot);
}

template <int P>
int launch(const uint8_t* valid, int b, int h, int w, int* dist, int* label, cudaStream_t stream) {
  const int threads = ((w + P - 1) / P + 31) / 32 * 32;
  const size_t smem = static_cast<size_t>(threads * P + 4) * sizeof(int2);  // 33 KB at most
  chamfer_labels_kernel<P><<<b, threads, smem, stream>>>(valid, h, w, dist, label);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// valid (b, h, w) bool -> label (b, h, w) int32; dist (b, h, w) int32 is
// scratch (the forward pass's distances). w at most 4096, h * w below 2^31.
extern "C" int fdt_chamfer_labels(const uint8_t* valid, int b, int h, int w, int* dist, int* label, void* stream) {
  if (b < 1 || h < 1 || w < 1 || w > MAX_P * MAX_THREADS || static_cast<long long>(h) * w > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w <= MAX_THREADS) return launch<1>(valid, b, h, w, dist, label, s);
  if (w <= 2 * MAX_THREADS) return launch<2>(valid, b, h, w, dist, label, s);
  if (w <= 4 * MAX_THREADS) return launch<4>(valid, b, h, w, dist, label, s);
  if (w <= 8 * MAX_THREADS) return launch<8>(valid, b, h, w, dist, label, s);
  return launch<16>(valid, b, h, w, dist, label, s);
}
