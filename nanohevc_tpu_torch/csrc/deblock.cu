// Deblocking filter of a batch of planes (spec 8.7.2, all-intra bS = 2),
// for Hopper (sm_90a).
//
// What it replaces.  No TPU kernel stands behind it: the JAX package
// deblocks as XLA ops inside its closed-loop encode
// (nanohevc_tpu/models/wavefront.py:431-475) and decode (:784-806),
// through nanohevc_tpu/ops/deblock.py::deblock_plane (:159): two passes
// of strided views, the horizontal one on the transpose.  The port's
// plain version, ops/deblock.py, is the same dozens of small ops per
// plane.  This kernel is one launch per (B, H, W) batch, both passes
// fused, bit for bit equal to that plain version.
//
// The rules it keeps (ops/deblock.py, ref/deblock.py):
// - edges lie on the 8-sample grid, n_e = (w - 4) / 8 of them a pass
//   (edge k at x = 8k, k = 1..n_e: its q3 is inside the plane);
// - luma: 4-line segments aligned at 0, decided from their lines 0 and
//   3 (8.7.2.5.3), strong (p2..q2) or weak (p1..q1, 8.7.2.5.7) filter;
//   lines past the last full segment stay unfiltered;
// - chroma: p0 / q0 only, every line, no segment decision (8.7.2.5.5);
// - beta and tc from Table 8-12 at the plane's QP (clipped), shifted by
//   bit_depth - 8; `>>` is arithmetic;
// - the vertical edges first over the whole plane, then the horizontal
//   edges on its output (8.7.2.1).
//
// The design.  A thread block owns an output tile of kTileH x kTileW
// samples whose origin is a multiple of 8, and loads it with a 4-sample
// halo on every side into shared memory (out-of-plane samples are read
// by no edge that is filtered, and are loaded as 0).  The vertical pass
// runs over the tile's rows plus the 4-row halos: an edge a filter
// touches reads at most 4 samples on each side, so the halo columns are
// enough for the tile's columns, and since the 4-row segments stay
// aligned (the tile's first halo row is a multiple of 4), a segment's
// decision stays inside the shared tile.  After one block barrier the
// horizontal pass runs on the vertical output for the tile's own
// columns, reading the halo rows the vertical pass filtered.  One item
// of work is an (edge, 4-line segment): one thread reads the segment's
// 4 x 8 samples, decides and writes them back; the edges of a pass are
// 8 apart and touch at most 4 samples a side, so no two items touch a
// sample.  The plane is read once and written once.
//
// What bounds it on this card: bytes.  A plane is read and written once
// (8 bytes a sample as int32; 16.6 MB for a padded 1080p luma plane,
// 5 us at 3.35 TB/s); the halo adds (40 x 72) / (32 x 64) - 1 = 41 % of
// reads, mostly from L2.  The filter's integer work, at most ~60
// operations a segment line, is far below the bytes' time.

#include <cuda_runtime.h>

namespace {

constexpr int kTileH = 32;                  // output rows a thread block
constexpr int kTileW = 64;                  // output columns
constexpr int kHalo = 4;
constexpr int kSH = kTileH + 2 * kHalo;     // shared rows
constexpr int kSW = kTileW + 2 * kHalo;     // shared columns
constexpr int kThreads = 128;
// (segment, edge) items of each pass: the vertical pass has kSH / 4
// segments by kTileW / 8 + 1 edges, the horizontal kTileW / 4 column
// segments by kTileH / 8 + 1 edges; each fits the block once.
constexpr int kVEdges = kTileW / 8 + 1, kVSegs = kSH / 4;
constexpr int kHEdges = kTileH / 8 + 1, kHSegs = kTileW / 4;
static_assert(kVEdges * kVSegs <= kThreads, "vertical items");
static_assert(kHEdges * kHSegs <= kThreads, "horizontal items");

// Spec Table 8-12: beta' by Q = clip(qp, 0, 51), tc' by Q = clip(qp + 2,
// 0, 53) (ref/deblock.py: BETA_TABLE, TC_TABLE).
__constant__ int kBeta[52] = {
    0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  6,  7,
    8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 20, 22, 24, 26, 28, 30, 32,
    34, 36, 38, 40, 42, 44, 46, 48, 50, 52, 54, 56, 58, 60, 62, 64};
__constant__ int kTc[54] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1,  1,  1,  1,  1,  1,  1,  1,  1,
    2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 5, 5, 6, 6, 7, 8, 9, 10, 11, 13, 14, 16, 18, 20, 22, 24};

__device__ __forceinline__ int clamp3(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// One luma segment: 4 lines of [p3 p2 p1 p0 | q0 q1 q2 q3], q0 of line l
// at s[l * across], p_i at -(i + 1) * along, q_i at +i * along.
__device__ void filter_luma(int* s, int along, int across, int beta, int tc,
                            int pix_max) {
  int p[4][4], q[4][4];
#pragma unroll
  for (int l = 0; l < 4; ++l) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      p[l][i] = s[l * across - (i + 1) * along];
      q[l][i] = s[l * across + i * along];
    }
  }
  const int dp0 = abs(p[0][2] - 2 * p[0][1] + p[0][0]);
  const int dq0 = abs(q[0][2] - 2 * q[0][1] + q[0][0]);
  const int dp3 = abs(p[3][2] - 2 * p[3][1] + p[3][0]);
  const int dq3 = abs(q[3][2] - 2 * q[3][1] + q[3][0]);
  const int dp03 = dp0 + dp3, dq03 = dq0 + dq3;
  if (!(dp03 + dq03 < beta)) return;               // 8.7.2.5.3: d < beta
  const int tc5 = (5 * tc + 1) >> 1;
  const bool strong0 = 2 * (dp0 + dq0) < (beta >> 2) &&
                       abs(p[0][3] - p[0][0]) + abs(q[0][0] - q[0][3]) <
                           (beta >> 3) &&
                       abs(p[0][0] - q[0][0]) < tc5;
  const bool strong3 = 2 * (dp3 + dq3) < (beta >> 2) &&
                       abs(p[3][3] - p[3][0]) + abs(q[3][0] - q[3][3]) <
                           (beta >> 3) &&
                       abs(p[3][0] - q[3][0]) < tc5;
  const int c2 = 2 * tc;
  if (strong0 && strong3) {
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const int p3 = p[l][3], p2 = p[l][2], p1 = p[l][1], p0 = p[l][0];
      const int q0 = q[l][0], q1 = q[l][1], q2 = q[l][2], q3 = q[l][3];
      int* o = s + l * across;
      o[-3 * along] = clamp3((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3,
                             p2 - c2, p2 + c2);
      o[-2 * along] = clamp3((p2 + p1 + p0 + q0 + 2) >> 2, p1 - c2, p1 + c2);
      o[-1 * along] = clamp3((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                             p0 - c2, p0 + c2);
      o[0] = clamp3((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3, q0 - c2,
                    q0 + c2);
      o[along] = clamp3((p0 + q0 + q1 + q2 + 2) >> 2, q1 - c2, q1 + c2);
      o[2 * along] = clamp3((p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3,
                            q2 - c2, q2 + c2);
    }
    return;
  }
  const int side = (beta + (beta >> 1)) >> 3;
  const bool filt_p1 = dp03 < side, filt_q1 = dq03 < side;
  const int th = tc >> 1;
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    const int p2 = p[l][2], p1 = p[l][1], p0 = p[l][0];
    const int q0 = q[l][0], q1 = q[l][1], q2 = q[l][2];
    const int delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4;
    if (!(abs(delta) < 10 * tc)) continue;         // weak filter off
    const int dc = clamp3(delta, -tc, tc);
    int* o = s + l * across;
    o[-1 * along] = clamp3(p0 + dc, 0, pix_max);
    o[0] = clamp3(q0 - dc, 0, pix_max);
    if (filt_p1)
      o[-2 * along] = clamp3(
          p1 + clamp3((((p2 + p0 + 1) >> 1) - p1 + dc) >> 1, -th, th), 0,
          pix_max);
    if (filt_q1)
      o[along] = clamp3(
          q1 + clamp3((((q2 + q0 + 1) >> 1) - q1 - dc) >> 1, -th, th), 0,
          pix_max);
  }
}

// One chroma line: [p1 p0 | q0 q1] around s (q0), p0 / q0 filtered.
__device__ __forceinline__ void filter_chroma(int* s, int along, int tc,
                                              int pix_max) {
  const int p1 = s[-2 * along], p0 = s[-along], q0 = s[0], q1 = s[along];
  const int delta = clamp3(((q0 - p0) * 4 + p1 - q1 + 4) >> 3, -tc, tc);
  s[-along] = clamp3(p0 + delta, 0, pix_max);
  s[0] = clamp3(q0 - delta, 0, pix_max);
}

template <bool kChroma>
__global__ void __launch_bounds__(kThreads)
    deblock_kernel(const int* __restrict__ planes, int height, int width,
                   int bit_depth, int qp_scalar, const int* __restrict__ qps,
                   int* __restrict__ out) {
  __shared__ int s[kSH][kSW];
  const int plane = blockIdx.z;
  const int y0 = blockIdx.y * kTileH, x0 = blockIdx.x * kTileW;
  const long long base = (long long)plane * height * width;
  const int tid = threadIdx.x;
  for (int i = tid; i < kSH * kSW; i += kThreads) {
    const int r = i / kSW, c = i % kSW;
    const int gy = y0 - kHalo + r, gx = x0 - kHalo + c;
    s[r][c] = (gy >= 0 && gy < height && gx >= 0 && gx < width)
                  ? planes[base + (long long)gy * width + gx]
                  : 0;
  }
  const int qp = qps ? qps[plane] : qp_scalar;
  const int shift = bit_depth - 8;
  const int beta = kBeta[clamp3(qp, 0, 51)] << shift;
  const int tc = kTc[clamp3(qp + 2, 0, 53)] << shift;
  const int pix_max = (1 << bit_depth) - 1;
  __syncthreads();

  // Vertical edges: edge j at shared column kHalo + 8j (x = x0 + 8j),
  // segment g over shared rows 4g..4g+3 (y = y0 - 4 + 4g, aligned at 0).
  if (tid < kVEdges * kVSegs) {
    const int j = tid % kVEdges, g = tid / kVEdges;
    const int k = (x0 >> 3) + j, gy = y0 - kHalo + 4 * g;
    if (k >= 1 && k <= (width - 4) / 8) {
      int* q0 = &s[4 * g][kHalo + 8 * j];
      if (kChroma) {
        for (int l = 0; l < 4; ++l)
          if (gy + l >= 0 && gy + l < height)
            filter_chroma(q0 + l * kSW, 1, tc, pix_max);
      } else if (gy >= 0 && gy / 4 < height / 4) {
        filter_luma(q0, 1, kSW, beta, tc, pix_max);
      }
    }
  }
  __syncthreads();

  // Horizontal edges on the vertical output: edge j at shared row kHalo
  // + 8j (y = y0 + 8j), column segment g over the tile's columns 4g..4g+3.
  if (tid < kHEdges * kHSegs) {
    const int g = tid % kHSegs, j = tid / kHSegs;
    const int k = (y0 >> 3) + j, gx = x0 + 4 * g;
    if (k >= 1 && k <= (height - 4) / 8) {
      int* q0 = &s[kHalo + 8 * j][kHalo + 4 * g];
      if (kChroma) {
        for (int l = 0; l < 4; ++l)
          if (gx + l < width) filter_chroma(q0 + l, kSW, tc, pix_max);
      } else if (gx / 4 < width / 4) {
        filter_luma(q0, kSW, 1, beta, tc, pix_max);
      }
    }
  }
  __syncthreads();

  for (int i = tid; i < kTileH * kTileW; i += kThreads) {
    const int r = i / kTileW, c = i % kTileW;
    const int gy = y0 + r, gx = x0 + c;
    if (gy < height && gx < width)
      out[base + (long long)gy * width + gx] = s[kHalo + r][kHalo + c];
  }
}

}  // namespace

// Deblock `batch` (height, width) int32 planes into `out` (same shape,
// never in place): luma's filter, or chroma's where is_chroma.  The QP
// of plane b is qps[b] (a device array of batch ints) or, where qps is
// null, qp_scalar.  Launches one grid on `stream` without synchronising;
// returns the CUDA error of the launch, or cudaSuccess.
extern "C" int nhv_deblock(const int* planes, int batch, int height,
                           int width, int bit_depth, int is_chroma,
                           int qp_scalar, const int* qps, int* out,
                           void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (batch < 0 || height < 0 || width < 0 || bit_depth < 8 ||
      bit_depth > 16 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || height == 0 || width == 0) return (int)cudaSuccess;
  const dim3 grid((width + kTileW - 1) / kTileW,
                  (height + kTileH - 1) / kTileH, batch);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_chroma)
    deblock_kernel<true><<<grid, kThreads, 0, s>>>(planes, height, width,
                                                   bit_depth, qp_scalar, qps,
                                                   out);
  else
    deblock_kernel<false><<<grid, kThreads, 0, s>>>(planes, height, width,
                                                    bit_depth, qp_scalar, qps,
                                                    out);
  return (int)cudaGetLastError();
}
