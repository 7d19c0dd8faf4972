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
// Design.  The TPU kernel kept whole (N, W) row slabs in lanes and
// turned every block-local step into lane rolls and butterflies.  Here
// one thread block takes BPB whole N x N blocks (BPB = 256 / N^2 for
// N <= 8, else 1), one thread per pixel.  A block, its top row and its
// left column sit in shared memory; the energies are warp-shuffle sums
// (dc_planar.cuh); each transform pass is an N-term dot product per pixel
// against T (and T^T) copied from __constant__ memory into shared
// memory.  Outputs go straight to their final layouts: recon (H, W),
// levels (nb, N, N) raster blocks, one mode per block (1 DC, 0 planar).
// The DC/planar decision lives in dc_planar.cuh, shared with
// wavefront.cu; the transform-quantize tail in encode_tail.cuh, shared
// with mode_search.cu and wavefront.cu.
//
// What bounds it on the card: it reads the plane once (4 bytes a pixel,
// plus one row and one column of neighbours per block) and writes recon
// and levels (8 bytes a pixel), about 12 bytes a pixel in all, against
// about 4N multiply-adds a pixel.  It is memory-bound, so it needs many
// blocks in flight: a 1080p luma plane at N = 8 gives 32,400 blocks,
// 8,100 thread blocks of 256 threads.

#include "dc_planar.cuh"

// The transform matrices only (layout in encode_tail.cuh).
constexpr int kTableInts = kTransformInts;
__constant__ int c_tables[kTableInts];

template <int N, int BPB>
__global__ void __launch_bounds__(N * N * BPB)
slab_encode_kernel(const int* __restrict__ plane, int width, int nbx, int nb,
                   int t_offset, QpScalars q, int* __restrict__ recon,
                   int* __restrict__ levels, int* __restrict__ modes) {
  constexpr int NN = N * N;
  constexpr int R = 2 * N + 1;  // one reference arm, corner at 0

  __shared__ int s_t[NN];    // T[i][k] at i*N + k
  __shared__ int s_tt[NN];   // T[j][k] at k*N + j (transposed copy)
  __shared__ int s_x[BPB][NN];
  __shared__ int s_a[BPB][NN];
  __shared__ int s_b[BPB][NN];
  __shared__ int s_ref[BPB][2 * R];  // T[1..N] at 1.., L[1..N] at R+1..

  const int tid = threadIdx.x;
  const int lb = tid / NN;          // block slot in this thread block
  const int p = tid % NN;           // pixel in the block
  const int i = p / N, j = p % N;
  const int g = blockIdx.x * BPB + lb;
  const bool active = g < nb;
  const int y0 = active ? (g / nbx) * N : 0;
  const int x0 = active ? (g % nbx) * N : 0;

  if (tid < NN) {
    s_t[tid] = c_tables[t_offset + tid];
    s_tt[tid] = c_tables[t_offset + (tid % N) * N + tid / N];
  }
  int x = 0;
  if (active) {
    x = plane[(size_t)(y0 + i) * width + x0 + j];
    if (i == 0)
      s_ref[lb][1 + j] = y0 == 0 ? q.boundary
                                 : plane[(size_t)(y0 - 1) * width + x0 + j];
    if (j == 0)
      s_ref[lb][R + 1 + i] = x0 == 0 ? q.boundary
                                     : plane[(size_t)(y0 + i) * width + x0 - 1];
  } else {
    if (i == 0) s_ref[lb][1 + j] = 0;
    if (j == 0) s_ref[lb][R + 1 + i] = 0;
  }
  __syncthreads();

  // --- DC/planar by energy, ties to DC (dc_planar.cuh) -------------
  bool use_dc;
  const int pred = dc_planar_energy<N, N * N * BPB>(
      s_ref[lb], x, i, j, s_a[lb], s_b[lb], use_dc);

  // --- transform, quantize, reconstruct (shared tail) ----------------
  int level, rec;
  transform_quant_recon<N>(s_t, s_tt, s_x[lb], s_a[lb], s_b[lb], i, j,
                           x - pred, pred, q, level, rec);

  if (active) {
    recon[(size_t)(y0 + i) * width + x0 + j] = rec;
    levels[(size_t)g * NN + p] = level;
    if (p == 0) modes[g] = use_dc ? 1 : 0;
  }
}

template <int N, int BPB>
static void launch(const int* plane, int width, int nbx, int nb, int t_offset,
                   QpScalars q, int* recon, int* levels, int* modes,
                   cudaStream_t stream) {
  const int grid = (nb + BPB - 1) / BPB;
  slab_encode_kernel<N, BPB><<<grid, N * N * BPB, 0, stream>>>(
      plane, width, nbx, nb, t_offset, q, recon, levels, modes);
}

extern "C" int nhv_table_ints() { return kTableInts; }

// Copy the transform tables (layout in encode_tail.cuh) into constant memory of
// `device`.  Returns a cudaError_t.
extern "C" int nhv_upload_tables(const int* host, int count, int device) {
  if (count != kTableInts) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyToSymbol(c_tables, host, count * sizeof(int));
}

// Encode the full block-rows of an (height, width) int32 plane.  Rows
// below the last full block-row are left to the caller.  Launches on
// `stream` without synchronising; returns cudaGetLastError().
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
  const QpScalars q{mf, qshift, qoffset, dscale, dq_shift, max_pix, boundary};
  cudaStream_t s = (cudaStream_t)stream;
  switch (n) {
    case 4:
      launch<4, 16>(plane, width, nbx, nb, transform_offset(4, use_dst), q,
                    recon, levels, modes, s);
      break;
    case 8:
      launch<8, 4>(plane, width, nbx, nb, transform_offset(8, false), q,
                   recon, levels, modes, s);
      break;
    case 16:
      launch<16, 1>(plane, width, nbx, nb, transform_offset(16, false), q,
                    recon, levels, modes, s);
      break;
    case 32:
      launch<32, 1>(plane, width, nbx, nb, transform_offset(32, false), q,
                    recon, levels, modes, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
