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
// samples whose origin is a multiple of 8, and copies it with a
// 4-sample halo on every side into shared memory (out-of-plane samples
// are read by no edge that is filtered, and are copied as 0).  Where the
// plane's width is a multiple of 4 (every padded plane: N >= 4) the
// copy is 16-byte cp.async chunks, each wholly inside or outside the
// plane, the outside ones zero-filled by the copy itself; else scalar
// loads.  One item of work is one line of one edge, the 8 samples
// [p3 p2 p1 p0 | q0 q1 q2 q3] around it, an "octet":
// - the vertical pass runs over the tile's rows and the 4-row halos
//   above and below (the horizontal pass reads them filtered): item
//   (row, octet) reads its octet from shared memory as two 16-byte
//   loads and writes it back the same way;
// - after one block barrier, the horizontal pass runs on the vertical
//   output for the tile's own columns: item (octet of rows, column)
//   reads 8 samples of a column and stores the tile's rows among them
//   straight to the output (a warp covers 32 columns of one row: one
//   128-byte store a row).
// A luma segment's decision needs its lines 0 and 3: the 4 lines of a
// segment are the 4 lanes of a quad (items are laid out so that a quad
// is 4 consecutive rows, or 4 consecutive columns, of one edge, and the
// tile's first halo row is a multiple of 4), and each lane computes its
// own line's d_p, d_q and strong test and reads lines 0 and 3 with
// __shfl_sync.  The edges of a pass are 8 apart and a filter touches at
// most 4 samples a side, so no two items touch a sample.
//
// Shared memory without bank conflicts.  A shared row holds kPitch
// words, an odd number of 16-byte chunks; the 8 lanes of a quarter warp
// in the vertical pass are 8 consecutive rows of one octet, so their
// 16-byte accesses fall on the 8 distinct chunk slots of the 32 banks.
// The horizontal pass reads 32 consecutive words of a row a warp.
//
// What bounds it on this card: bytes.  A plane is read and written once
// (8 bytes a sample as int32; 16.6 MB for a padded 1080p luma plane,
// 4.95 us at 3.35 TB/s); the halo adds (40 x 72) / (32 x 64) - 1 = 41 %
// of reads, mostly from L2.  The filter's integer work, at most ~60
// operations a segment line, is far below the bytes' time.
// tools/deblock_variants.py times the design's alternatives (pitch,
// copies, threads, tile) and PERF.md keeps their numbers.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTileH = 32;                  // output rows a thread block
constexpr int kTileW = 64;                  // output columns
constexpr int kHalo = 4;
constexpr int kThreads = 256;
constexpr int kRows = kTileH + 2 * kHalo;   // shared rows
constexpr int kCols = kTileW + 2 * kHalo;   // shared columns in use
constexpr int kPitch = kCols + 4;           // words a shared row
// Vertical pass: kVOcts octets a row (edges x0, x0 + 8, .., x0 + kTileW);
// item i = (row group g, octet j, row 8g + i % 8), i / 8 = g * kVOcts + j.
constexpr int kVOcts = kTileW / 8 + 1;
constexpr int kVItems = kRows * kVOcts;
// Horizontal pass: kHOcts octets of rows a column (edges y0 .. y0 +
// kTileH); item i = (octet i / kTileW, column i % kTileW).
constexpr int kHOcts = kTileH / 8 + 1;
constexpr int kHItems = kHOcts * kTileW;
static_assert(kTileH % 8 == 0 && kTileW % 8 == 0, "segments stay aligned");
static_assert(kHalo == 4 && kThreads % 32 == 0, "halo, whole warps");
static_assert(kPitch % 4 == 0 && (kPitch / 4) % 2 == 1,
              "an odd number of 16-byte chunks a shared row");

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

// 16 bytes from global to shared memory, the last 16 - bytes of them
// zero-filled (bytes 0: all zeros, nothing read).
__device__ __forceinline__ void copy16(int* smem, const int* gmem,
                                       int bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(gmem), "r"(bytes)
               : "memory");
}

// One line of a luma segment, v = [p3 p2 p1 p0 q0 q1 q2 q3], in the lane
// of its quad that holds it (lane 0 of the quad: the segment's line 0).
// `on` (the same in the whole quad): the segment's edge is filtered.
// Every lane of the warp calls it.  Returns whether v changed.
__device__ __forceinline__ bool filter_luma_line(int* v, bool on, int beta,
                                                 int tc, int pix_max) {
  const int p3 = v[0], p2 = v[1], p1 = v[2], p0 = v[3];
  const int q0 = v[4], q1 = v[5], q2 = v[6], q3 = v[7];
  const int dp = abs(p2 - 2 * p1 + p0), dq = abs(q2 - 2 * q1 + q0);
  const int tc5 = (5 * tc + 1) >> 1;
  const int strong = 2 * (dp + dq) < (beta >> 2) &&
                     abs(p3 - p0) + abs(q0 - q3) < (beta >> 3) &&
                     abs(p0 - q0) < tc5;
  // Lines 0 and 3 of the segment: dq and the strong test in one word.
  const int lead = (threadIdx.x & 31) & ~3;
  const int dqs = 2 * dq + strong;
  const int dp0 = __shfl_sync(kFull, dp, lead);
  const int dp3 = __shfl_sync(kFull, dp, lead + 3);
  const int dqs0 = __shfl_sync(kFull, dqs, lead);
  const int dqs3 = __shfl_sync(kFull, dqs, lead + 3);
  const int dp03 = dp0 + dp3, dq03 = (dqs0 >> 1) + (dqs3 >> 1);
  if (!on || !(dp03 + dq03 < beta)) return false;  // 8.7.2.5.3: d < beta
  const int c2 = 2 * tc;
  if (dqs0 & dqs3 & 1) {                             // strong filter
    v[1] = clamp3((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2 - c2,
                  p2 + c2);
    v[2] = clamp3((p2 + p1 + p0 + q0 + 2) >> 2, p1 - c2, p1 + c2);
    v[3] = clamp3((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3, p0 - c2,
                  p0 + c2);
    v[4] = clamp3((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3, q0 - c2,
                  q0 + c2);
    v[5] = clamp3((p0 + q0 + q1 + q2 + 2) >> 2, q1 - c2, q1 + c2);
    v[6] = clamp3((p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3, q2 - c2,
                  q2 + c2);
    return true;
  }
  const int delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4;
  if (!(abs(delta) < 10 * tc)) return false;         // weak filter off
  const int side = (beta + (beta >> 1)) >> 3;
  const int th = tc >> 1;
  const int dc = clamp3(delta, -tc, tc);
  v[3] = clamp3(p0 + dc, 0, pix_max);
  v[4] = clamp3(q0 - dc, 0, pix_max);
  if (dp03 < side)
    v[2] = clamp3(p1 + clamp3((((p2 + p0 + 1) >> 1) - p1 + dc) >> 1, -th, th),
                  0, pix_max);
  if (dq03 < side)
    v[5] = clamp3(q1 + clamp3((((q2 + q0 + 1) >> 1) - q1 - dc) >> 1, -th, th),
                  0, pix_max);
  return true;
}

// One chroma line, v as for luma: p0 / q0 filtered.
__device__ __forceinline__ void filter_chroma_line(int* v, int tc,
                                                   int pix_max) {
  const int p1 = v[2], p0 = v[3], q0 = v[4], q1 = v[5];
  const int delta = clamp3(((q0 - p0) * 4 + p1 - q1 + 4) >> 3, -tc, tc);
  v[3] = clamp3(p0 + delta, 0, pix_max);
  v[4] = clamp3(q0 - delta, 0, pix_max);
}

template <bool kChroma, bool kVec>
__global__ void __launch_bounds__(kThreads)
    deblock_kernel(const int* __restrict__ planes, int height, int width,
                   int bit_depth, int qp_scalar, const int* __restrict__ qps,
                   int* __restrict__ out) {
  __shared__ __align__(16) int s[kRows * kPitch];
  const int plane = blockIdx.z;
  const int y0 = blockIdx.y * kTileH, x0 = blockIdx.x * kTileW;
  const long long base = (long long)plane * height * width;
  const int* __restrict__ in = planes + base;
  const int tid = threadIdx.x, lane = tid & 31;
  // Shared row r, column c holds the sample at (y0 - 4 + r, x0 - 4 + c).
  if (kVec) {
    constexpr int kChunks = kCols / 4;
    for (int i = tid; i < kRows * kChunks; i += kThreads) {
      const int r = i / kChunks, c = i - r * kChunks;
      const int gy = y0 - kHalo + r, gx = x0 - kHalo + 4 * c;
      const bool inside = gy >= 0 && gy < height && gx >= 0 && gx < width;
      copy16(&s[r * kPitch + 4 * c],
             inside ? in + (long long)gy * width + gx : in, inside ? 16 : 0);
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
  } else {
    for (int i = tid; i < kRows * kCols; i += kThreads) {
      const int r = i / kCols, c = i - r * kCols;
      const int gy = y0 - kHalo + r, gx = x0 - kHalo + c;
      s[r * kPitch + c] = (gy >= 0 && gy < height && gx >= 0 && gx < width)
                              ? in[(long long)gy * width + gx]
                              : 0;
    }
  }
  const int qp = qps ? qps[plane] : qp_scalar;
  const int shift = bit_depth - 8;
  const int beta = kBeta[clamp3(qp, 0, 51)] << shift;
  const int tc = kTc[clamp3(qp + 2, 0, 53)] << shift;
  const int pix_max = (1 << bit_depth) - 1;
  __syncthreads();

  // Vertical edges: octet j of shared row r is columns 8j..8j+7, its
  // edge at x = x0 + 8j; the warps run whole, so a quad's shuffles
  // always have their lanes.
  const int n_vx = (width - 4) / 8, n_hy = (height - 4) / 8;
  for (int first = tid - lane; first < kVItems; first += kThreads) {
    const int i = first + lane;
    const bool valid = i < kVItems;
    const int pair = valid ? i >> 3 : 0;
    const int j = pair % kVOcts, r = 8 * (pair / kVOcts) + (i & 7);
    const int kx = (x0 >> 3) + j, gy = y0 - kHalo + r;
    bool on = valid && kx >= 1 && kx <= n_vx;
    int4* o = reinterpret_cast<int4*>(&s[r * kPitch + 8 * j]);
    const int4 a = o[0], b = o[1];
    int v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    if (kChroma) {
      on = on && gy >= 0 && gy < height;
      if (on) filter_chroma_line(v, tc, pix_max);
    } else {
      const int seg = gy - (r & 3);                  // the segment's line 0
      on = on && seg >= 0 && seg / 4 < height / 4;
      on = filter_luma_line(v, on, beta, tc, pix_max);
    }
    if (on) {
      o[0] = make_int4(v[0], v[1], v[2], v[3]);
      o[1] = make_int4(v[4], v[5], v[6], v[7]);
    }
  }
  __syncthreads();

  // Horizontal edges on the vertical output: octet k of a column is
  // shared rows 8k..8k+7, its edge at y = y0 + 8k; the tile's rows among
  // them go straight to the output.
  for (int first = tid - lane; first < kHItems; first += kThreads) {
    const int i = first + lane;
    const bool valid = i < kHItems;
    const int k = valid ? i / kTileW : 0, c = i % kTileW;
    const int ky = (y0 >> 3) + k, gx = x0 + c;
    bool on = valid && ky >= 1 && ky <= n_hy;
    const int* col = &s[8 * k * kPitch + kHalo + c];
    int v[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) v[t] = col[t * kPitch];
    if (kChroma) {
      on = on && gx < width;
      if (on) filter_chroma_line(v, tc, pix_max);
    } else {
      on = on && gx / 4 < width / 4;
      filter_luma_line(v, on, beta, tc, pix_max);
    }
    if (valid && gx < width) {
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int row = 8 * k + t - kHalo;           // the tile's row
        if (row >= 0 && row < kTileH && y0 + row < height)
          out[base + (long long)(y0 + row) * width + gx] = v[t];
      }
    }
  }
}

template <bool kChroma>
void launch(dim3 grid, cudaStream_t s, bool vec, const int* planes,
            int height, int width, int bit_depth, int qp_scalar,
            const int* qps, int* out) {
  if (vec)
    deblock_kernel<kChroma, true><<<grid, kThreads, 0, s>>>(
        planes, height, width, bit_depth, qp_scalar, qps, out);
  else
    deblock_kernel<kChroma, false><<<grid, kThreads, 0, s>>>(
        planes, height, width, bit_depth, qp_scalar, qps, out);
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
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  // 16-byte copies: rows start on 16 bytes, chunks never straddle the
  // plane's right edge.
  const bool vec =
      width % 4 == 0 && reinterpret_cast<std::uintptr_t>(planes) % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_chroma)
    launch<true>(grid, s, vec, planes, height, width, bit_depth, qp_scalar,
                 qps, out);
  else
    launch<false>(grid, s, vec, planes, height, width, bit_depth, qp_scalar,
                  qps, out);
  return (int)cudaGetLastError();
}
