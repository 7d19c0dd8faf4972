// The row-per-thread body of the open-loop kernel (slab_pipeline.cu, K1)
// and the blocks-API kernel (fused_pipeline.cu, K5): the DC/planar
// decision and the transform-quantize-reconstruct tail, bit for bit
// those of dc_planar.cuh and encode_tail.cuh, laid out for Hopper.
//
// Layout.  A thread holds one row of one N x N block in registers (N
// ints); the N rows of a block are N neighbouring lanes of one warp, so
// a warp holds 32 / N whole blocks and nothing is shared across warps:
// every exchange is a warp shuffle or a __syncwarp'ed shared-memory tile
// of the warp's own, and there is no __syncthreads.
//
// Transforms.  The HEVC DCT matrices are even/odd symmetric at every
// level of halving: for M = N, N/2, ..., 2 and S = N/M, row S*v of T
// restricted to its first M columns satisfies
//   T[S*v][M-1-k] = (-1)^v T[S*v][k].
// So y = T.x folds into sums and differences (E/O) of mirrored inputs,
// the odd rows taking the differences and the even rows recursing on the
// sums (the spec's and HM's partial butterflies): 3 multiplies an output
// at N = 8 instead of 8, about 11 instead of 32 at N = 32.  The result
// is a reassociation of the same integer sum: it gives the same int32
// bits as the N-term dot product, and it would even under wrap-around,
// since addition and multiplication mod 2^32 are ring operations.
// DST-VII (4x4, K1 only) has no such symmetry and stays a 4x4 product.
// Every coefficient is kCoef[OFF + u*N + k] with OFF, u and k
// compile-time constants in fully unrolled loops, and kCoef a constant
// array whose values the compiler sees: each folds into the multiply as
// an immediate, with no shared-memory copy of the tables and no table
// load at all.  The values come from kernels/slab_pipeline.py::
// transform_table(), the table the other kernels upload into constant
// memory: kernels/build.py writes them into a generated header in the
// build directory (transform_table.h) and hashes it with the sources.
// Read from __constant__ memory instead, the coefficients took a
// uniform-register load (ULDC.64) for every two multiplies at N = 32,
// whose table is 4 KB, and the kernel twice the time (PERF.md).
//
// Passes.  The rounding fixes the order: forward T.X (columns) then
// .T^T (rows), inverse T^T.D (columns) then .T (rows), each
// (acc + rnd) >> (log2N + 5).  A thread that holds a row transposes
// before and after each column pass through a padded (N+1)-int-row tile:
// four transposes of one shared store and one shared load a pixel each,
// conflict-free at every N, against the 8N shared loads a pixel of the
// dot-product tail.

#pragma once

#include "encode_tail.cuh"
#include "transform_table.h"  // generated: #define NHV_TRANSFORM_TABLE {...}

// The transform matrices in the layout of encode_tail.cuh.
__device__ const int kCoef[kTransformInts] = NHV_TRANSFORM_TABLE;

constexpr unsigned kFullWarp = 0xffffffffu;
constexpr int kRowWarps = 4;                // warps in a thread block
constexpr int kRowThreads = 32 * kRowWarps;

// Ints of one warp's transpose tile: 32 / N blocks of N rows of N + 1.
template <int N>
__host__ __device__ constexpr int row_tile_ints() {
  return (32 / N) * N * (N + 1);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

// --- 16-byte row loads and stores ---------------------------------------

template <int N>
__device__ __forceinline__ void load_row(const int* __restrict__ src,
                                         int (&v)[N]) {
  const int4* p = reinterpret_cast<const int4*>(src);
#pragma unroll
  for (int c = 0; c < N / 4; ++c) {
    const int4 w = __ldg(p + c);
    v[4 * c] = w.x;
    v[4 * c + 1] = w.y;
    v[4 * c + 2] = w.z;
    v[4 * c + 3] = w.w;
  }
}

template <int N>
__device__ __forceinline__ void store_row(int* dst, const int (&v)[N]) {
  int4* p = reinterpret_cast<int4*>(dst);
#pragma unroll
  for (int c = 0; c < N / 4; ++c)
    p[c] = make_int4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
}

// Lane i of a block writes its v as row i of the tile and reads column
// i back: afterwards v[k] is lane k's old v[i].  `tile` is this block's
// N x (N+1) region; every lane of the warp must call it.  The caller
// alternates two tiles, so the barrier of one transpose also orders the
// reads of the one before it against the writes of the one after.
template <int N>
__device__ __forceinline__ void transpose(int* tile, int i, int (&v)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) tile[i * (N + 1) + k] = v[k];
  __syncwarp();
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = tile[k * (N + 1) + i];
}

// --- partial butterflies --------------------------------------------------

// Forward: y[S*v] = sum_{k<M} T[S*v][k] * a[k] for v < M, S = N / M,
// where a is the line folded to M terms by the levels above (at M = N,
// the line itself).  T is the N x N matrix at kCoef[OFF].
template <int N, int OFF, int M>
struct ForwardButterfly {
  static __device__ __forceinline__ void run(const int (&a)[M], int (&y)[N]) {
    constexpr int S = N / M, H = M / 2;
    int e[H], o[H];
#pragma unroll
    for (int k = 0; k < H; ++k) {
      e[k] = a[k] + a[M - 1 - k];
      o[k] = a[k] - a[M - 1 - k];
    }
#pragma unroll
    for (int v = 1; v < M; v += 2) {
      int acc = 0;
#pragma unroll
      for (int k = 0; k < H; ++k) acc += kCoef[OFF + S * v * N + k] * o[k];
      y[S * v] = acc;
    }
    ForwardButterfly<N, OFF, H>::run(e, y);
  }
};

template <int N, int OFF>
struct ForwardButterfly<N, OFF, 1> {
  static __device__ __forceinline__ void run(const int (&a)[1], int (&y)[N]) {
    y[0] = kCoef[OFF] * a[0];
  }
};

// Inverse: out[k] = sum_{v<M} T[S*v][k] * c[S*v] for k < M, S = N / M:
// the even rows' sum E recursed at M / 2, the odd rows' sum O, then
// out[k] = E[k] + O[k] and out[M-1-k] = E[k] - O[k].
template <int N, int OFF, int M>
struct InverseButterfly {
  static __device__ __forceinline__ void run(const int (&c)[N], int (&out)[M]) {
    constexpr int S = N / M, H = M / 2;
    int e[H];
    InverseButterfly<N, OFF, H>::run(c, e);
#pragma unroll
    for (int k = 0; k < H; ++k) {
      int o = 0;
#pragma unroll
      for (int v = 1; v < M; v += 2) o += kCoef[OFF + S * v * N + k] * c[S * v];
      out[k] = e[k] + o;
      out[M - 1 - k] = e[k] - o;
    }
  }
};

template <int N, int OFF>
struct InverseButterfly<N, OFF, 1> {
  static __device__ __forceinline__ void run(const int (&c)[N], int (&out)[1]) {
    out[0] = kCoef[OFF] * c[0];
  }
};

// One forward (or inverse) pass over the thread's line, in place, with
// the rounding shift: the DST-VII as a 4x4 product, the DCT as a
// butterfly.  OFF is transform_offset(N, DST), which the host-side
// launch passes down as a template argument.
template <int N, bool DST, int OFF>
__device__ __forceinline__ void forward_pass(int (&v)[N]) {
  constexpr int TSHIFT = Log2<N>::value + 5;
  constexpr int RND = 1 << (TSHIFT - 1);
  int y[N];
  if constexpr (DST) {
#pragma unroll
    for (int u = 0; u < N; ++u) {
      int acc = 0;
#pragma unroll
      for (int k = 0; k < N; ++k) acc += kCoef[OFF + u * N + k] * v[k];
      y[u] = acc;
    }
  } else {
    ForwardButterfly<N, OFF, N>::run(v, y);
  }
#pragma unroll
  for (int u = 0; u < N; ++u) v[u] = (y[u] + RND) >> TSHIFT;
}

template <int N, bool DST, int OFF>
__device__ __forceinline__ void inverse_pass(int (&v)[N]) {
  constexpr int TSHIFT = Log2<N>::value + 5;
  constexpr int RND = 1 << (TSHIFT - 1);
  int y[N];
  if constexpr (DST) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      int acc = 0;
#pragma unroll
      for (int u = 0; u < N; ++u) acc += kCoef[OFF + u * N + k] * v[u];
      y[k] = acc;
    }
  } else {
    InverseButterfly<N, OFF, N>::run(v, y);
  }
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = (y[k] + RND) >> TSHIFT;
}

// --- the DC/planar decision, one row a lane --------------------------------

// Predict row i of a block whose row is x, top references top[0..N-1]
// (T[1..N]) and left reference `left` (L[1+i]); the block's N lanes
// call it together, every lane of the warp at once.  DC = floor((sum T +
// sum L + N) / 2N); planar with T[N] / L[N] as top-right / bottom-left;
// the energies are per-row partial sums and a shuffle tree over the
// block's lanes (int32 sums wrap alike in any order); ties to DC.
// Writes the prediction to pred and returns whether DC won.
template <int N>
__device__ __forceinline__ bool row_dc_planar(const int (&x)[N],
                                              const int (&top)[N], int left,
                                              int i, int (&pred)[N]) {
  constexpr int LOG2N = Log2<N>::value;
  int sum = left;
#pragma unroll
  for (int off = N / 2; off > 0; off >>= 1)
    sum += __shfl_xor_sync(kFullWarp, sum, off);
#pragma unroll
  for (int k = 0; k < N; ++k) sum += top[k];
  const int dc = floor_div(sum + N, 2 * N);
  const int tr = top[N - 1];
  const int bl = __shfl_sync(kFullWarp, left, N - 1, N);

  int e_dc = 0, e_pl = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    pred[j] = ((N - 1 - j) * left + (j + 1) * tr + (N - 1 - i) * top[j] +
               (i + 1) * bl + N) >> (LOG2N + 1);
    const int rd = x[j] - dc, rp = x[j] - pred[j];
    e_dc += rd * rd;
    e_pl += rp * rp;
  }
#pragma unroll
  for (int off = N / 2; off > 0; off >>= 1) {
    e_dc += __shfl_xor_sync(kFullWarp, e_dc, off);
    e_pl += __shfl_xor_sync(kFullWarp, e_pl, off);
  }
  const bool use_dc = e_dc <= e_pl;
  if (use_dc) {
#pragma unroll
    for (int j = 0; j < N; ++j) pred[j] = dc;
  }
  return use_dc;
}

// --- the tail, one row a lane ---------------------------------------------

// Transform, quantize and reconstruct row i of a block from its residual
// row r (overwritten) and prediction row pred: level receives the
// quantized levels of row i (raster), rec the clipped reconstruction.
// tile_a and tile_b are this block's two transpose tiles; OFF is
// transform_offset(N, DST); every lane of the warp must call it.
template <int N, bool DST, int OFF>
__device__ __forceinline__ void row_transform_quant_recon(
    int (&r)[N], const int (&pred)[N], int i, int* tile_a, int* tile_b,
    const QpScalars& q, int (&level)[N], int (&rec)[N]) {
  // forward: columns (T.R), then rows (.T^T)
  transpose<N>(tile_a, i, r);
  forward_pass<N, DST, OFF>(r);
  transpose<N>(tile_b, i, r);
  forward_pass<N, DST, OFF>(r);

  // deadzone quantizer and dequantizer (signed dequant shift)
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int coeff = r[j];
    const int mag = ((coeff < 0 ? -coeff : coeff) * q.mf + q.qoffset) >> q.qshift;
    level[j] = coeff > 0 ? mag : (coeff < 0 ? -mag : 0);
    const int base = level[j] * q.dscale;
    r[j] = q.dq_shift >= 1
               ? (base + (1 << (q.dq_shift - 1))) >> q.dq_shift
               : (int)((unsigned)base << (-q.dq_shift));
  }

  // inverse: columns (T^T.D), then rows (.T)
  transpose<N>(tile_a, i, r);
  inverse_pass<N, DST, OFF>(r);
  transpose<N>(tile_b, i, r);
  inverse_pass<N, DST, OFF>(r);
#pragma unroll
  for (int j = 0; j < N; ++j) rec[j] = min(max(pred[j] + r[j], 0), q.max_pix);
}
