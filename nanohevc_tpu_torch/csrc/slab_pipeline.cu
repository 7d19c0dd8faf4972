// Open-loop DC/planar all-intra encode of one plane, for Hopper (sm_90a).
//
// Replaces the TPU kernel nanohevc_tpu/kernels/slab_pipeline.py
// (slab_encode_plane -> _kernel -> _encode_block_row ->
// _transform_quant_recon).  Same arithmetic, bit for bit:
//   source-fed references with a 1 << (bd-1) fill outside the plane;
//   DC = floor((sum top + sum left + N) / 2N) over the N samples per side;
//   planar with top[N-1] / left[N-1] as top-right / bottom-left;
//   pick by residual energy, ties to DC;
//   forward T.X then .T^T, each (acc + rnd) >> (log2N + 5);
//   deadzone quantizer, parity or spec-rescale dequant (signed shift);
//   inverse T^T.X then .T; clip to [0, max_pix].
//
// What bounds it on the card: it reads the plane once (4 bytes a pixel,
// plus one row and one column of neighbours per block) and writes recon
// and levels (8 bytes a pixel), about 12 bytes a pixel, 7.5 us for a
// 1080p luma plane at 3.35 TB/s.  Against that it does 8N + 34 integer
// operations a pixel counted as dot products (chip_smoke.py::
// kernel_bound; 290 at N = 32, where that count would make operations
// the bound), 59 at N = 8 and 123 at N = 32 as the butterflies
// below do them (3 multiplies an output a pass at N = 8, about 11 at
// N = 32, instead of N; chip_smoke.py::butterfly_ops): bytes bound it
// at every N.
//
// Design (row_tail.cuh has the body).  One thread per block row, N ints
// in registers; a warp holds 32 / N horizontally neighbouring blocks of
// one block row (raster order), a thread block 4 warps.  Rows are read
// and recon and levels written as 16-byte int4 accesses (the plane,
// recon and levels must be 16-byte aligned; width % N == 0 keeps every
// row aligned).  The top references are the row above, read as int4
// (broadcast to the block's lanes); the left reference of row i is the
// last sample of row i of the block to the left, taken by a shuffle from
// the lane that loaded it, and read from memory only by the first block
// of a warp.  Nothing crosses warps: no __syncthreads.  The transforms
// are even/odd partial butterflies (matrix form for the DST) with the
// coefficients compiled in as immediates.
//
// What was measured (NVIDIA H100 80GB HBM3, 700.00 W; 1080p luma plane,
// QP 22; device time through a CUDA graph, tools/torch_kernel_times.py,
// PERF.md): 9.0-9.2 / 11.0-11.2 / 16.4-16.6 / 28.4-29.0 us at N = 4 DST
// / 8 / 16 / 32, against 22.7-23.1 / 33.7-34.2 / 55.5-55.8 / 102.1 us
// for the earlier one-thread-per-pixel dot-product design in the same
// call; 67 % of the bytes bound at N = 8.

#include "row_tail.cuh"

template <int N, bool DST, int OFF>
__global__ void __launch_bounds__(kRowThreads)
slab_encode_kernel(const int* __restrict__ plane, int width, int nbx, int nb,
                   QpScalars q, int* __restrict__ recon,
                   int* __restrict__ levels, int* __restrict__ modes) {
  constexpr int BPW = 32 / N;              // blocks a warp
  constexpr int TILE = row_tile_ints<N>();
  __shared__ int s_tiles[kRowWarps][2][TILE];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane / N, i = lane % N;  // block slot in the warp, row
  const int g = (blockIdx.x * kRowWarps + warp) * BPW + grp;
  const bool active = g < nb;
  const int by = active ? g / nbx : 0;
  const int bx = active ? g % nbx : 0;
  const int y0 = by * N, x0 = bx * N;

  int x[N], top[N];
  if (active) {
    load_row<N>(plane + (size_t)(y0 + i) * width + x0, x);
    if (by > 0) {
      load_row<N>(plane + (size_t)(y0 - 1) * width + x0, top);
    } else {
#pragma unroll
      for (int k = 0; k < N; ++k) top[k] = q.boundary;
    }
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) x[k] = top[k] = 0;
  }
  // Block g - 1 is the left neighbour when bx > 0; it sits in the lanes
  // just below unless this block is the first of its warp.
  const int shuffled = __shfl_up_sync(kFullWarp, x[N - 1], N);
  int left = 0;
  if (active)
    left = bx == 0  ? q.boundary
           : grp > 0 ? shuffled
                     : plane[(size_t)(y0 + i) * width + x0 - 1];

  int pred[N];
  const bool use_dc = row_dc_planar<N>(x, top, left, i, pred);
#pragma unroll
  for (int j = 0; j < N; ++j) x[j] -= pred[j];

  int* tiles = &s_tiles[warp][0][grp * N * (N + 1)];
  int level[N], rec[N];
  row_transform_quant_recon<N, DST, OFF>(x, pred, i, tiles, tiles + TILE, q,
                                         level, rec);

  if (active) {
    store_row<N>(recon + (size_t)(y0 + i) * width + x0, rec);
    store_row<N>(levels + (size_t)g * N * N + i * N, level);
    if (i == 0) modes[g] = use_dc ? 1 : 0;
  }
}

template <int N, bool DST>
static void launch(const int* plane, int width, int nbx, int nb, QpScalars q,
                   int* recon, int* levels, int* modes, cudaStream_t stream) {
  constexpr int per_block = kRowWarps * (32 / N);
  const int grid = (nb + per_block - 1) / per_block;
  slab_encode_kernel<N, DST, transform_offset(N, DST)>
      <<<grid, kRowThreads, 0, stream>>>(
      plane, width, nbx, nb, q, recon, levels, modes);
}

// Encode the full block-rows of an (height, width) int32 plane.  Rows
// below the last full block-row are left to the caller.  plane, recon
// and levels must be 16-byte aligned (cudaErrorMisalignedAddress if
// not).  Launches on `stream` without synchronising; returns
// cudaGetLastError().
extern "C" int nhv_slab_encode(const int* plane, int height, int width, int n,
                               int use_dst, int mf, int qshift, int qoffset,
                               int dscale, int dq_shift, int max_pix,
                               int boundary, int* recon, int* levels,
                               int* modes, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || width % n != 0 || (use_dst && n != 4))
    return (int)cudaErrorInvalidValue;
  const int nbx = width / n;
  const int nb = (height / n) * nbx;
  if (nb == 0) return (int)cudaSuccess;
  if (!aligned16(plane) || !aligned16(recon) || !aligned16(levels))
    return (int)cudaErrorMisalignedAddress;
  const QpScalars q{mf, qshift, qoffset, dscale, dq_shift, max_pix, boundary};
  cudaStream_t s = (cudaStream_t)stream;
  switch (n) {
    case 4:
      if (use_dst)
        launch<4, true>(plane, width, nbx, nb, q, recon, levels, modes, s);
      else
        launch<4, false>(plane, width, nbx, nb, q, recon, levels, modes, s);
      break;
    case 8:
      launch<8, false>(plane, width, nbx, nb, q, recon, levels, modes, s);
      break;
    case 16:
      launch<16, false>(plane, width, nbx, nb, q, recon, levels, modes, s);
      break;
    case 32:
      launch<32, false>(plane, width, nbx, nb, q, recon, levels, modes, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
