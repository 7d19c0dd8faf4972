// Open-loop 35-mode SATD search and all-intra encode of one plane, for
// Hopper (sm_90a).
//
// Replaces both TPU kernels that compute it, through
// mode_search_encode_plane_auto:
//   nanohevc_tpu/kernels/mode_search_slab.py (mode_search_encode_plane
//     -> _kernel -> _search_block_row -> _mode_sweep), N 16/32 there;
//   nanohevc_tpu/kernels/mode_search_grouped.py
//     (mode_search_encode_plane_grouped -> _kernel -> _mode_sweep_g,
//     _transform_quant_recon_g), N 4/8 there.
// One kernel serves N 4, 8, 16 and 32.  Same arithmetic, bit for bit,
// as decide_modes(mode_set="all", decision="satd") followed by the slab
// kernel's tail:
//   source-fed references (extract_refs): top = row y0-1, columns
//   clamped to W-1; left = column x0-1, rows y0-1 .. y0+2N-1 clamped to
//   H-1 (true source rows below the block, also below the last full
//   block-row); 1 << (bd-1) on the plane's top row and left column, and
//   at the corner when y0 == 0 or x0 == 0;
//   the 35-mode SATD search of mode_sweep.cuh (shared with
//   wavefront.cu);
//   then transform, deadzone quantizer, dequant, inverse, clip
//   (encode_tail.cuh, shared with slab_pipeline.cu and wavefront.cu).
//
// Design.  The TPU kernels keep row slabs in lanes and turn the search
// into lane rolls, phase masks, g-row interleaving, 128-lane padding
// and a packed (cost*64 + mode) minimum; of those only the packed
// minimum carries over.  Here, as in slab_pipeline.cu, one thread block
// takes BPB whole N x N blocks (BPB = 128 / N^2 for N <= 8, else 1; 128
// threads measured a little faster than 256 or 512 with this sweep),
// one thread per pixel.  Each block's pixels, its 4N+2 references and
// all 33 per-mode reference arrays are built in shared memory once;
// then the block's N*N threads, as N groups of N lanes, sweep the 35
// modes a group at a time, each mode's WHT as XOR butterflies in
// registers and warp shuffles (mode_sweep.cuh): ceil(35 / N) passes
// with no barrier inside, one shared-memory step for the winner at
// N >= 8.  The winner's prediction is recomputed per pixel for the tail.
//
// What bounds it on the card: operations.  Per block the search is 35
// SATDs of about 2 log2 N butterfly adds a pixel, the predictions and
// the |.| sums, against 12 bytes a pixel of memory traffic (read the
// plane, write recon and levels).  32,400 blocks of a 1080p plane at
// N = 8 keep every SM full, so it is throughput-bound: the groups idle
// in the last pass (1 of 36 slots at N = 4, 5 of 40 at 8, 13 of 48 at
// 16, 29 of 64 at 32; whole idle warps leave the loop) and the
// reference reads are what is left above the operation count.

#include "mode_sweep.cuh"   // also defines c_tables, the constant table

template <int N, int BPB>
__global__ void __launch_bounds__(N * N * BPB)
mode_search_kernel(const int* __restrict__ plane, int height, int width,
                   int nbx, int nb, int t_offset, QpScalars q,
                   int* __restrict__ recon, int* __restrict__ levels,
                   int* __restrict__ modes) {
  constexpr int NN = N * N;
  constexpr int R = 2 * N + 1;          // one reference arm, corner at 0

  __shared__ int s_t[NN];               // T[i][k] at i*N + k
  __shared__ int s_tt[NN];              // T[j][k] at k*N + j
  __shared__ int s_x[BPB][NN];          // the tail's scratch
  __shared__ int s_a[BPB][NN];
  __shared__ int s_b[BPB][NN];
  __shared__ int s_ref[BPB][2 * R];     // top arm | left arm
  __shared__ SweepScratch<N, NN> s_sweep[BPB];

  const int tid = threadIdx.x;
  const int lb = tid / NN;              // block slot in this thread block
  const int p = tid % NN;               // pixel in the block
  const int i = p / N, j = p % N;
  const int g = blockIdx.x * BPB + lb;
  const bool active = g < nb;
  const int y0 = active ? (g / nbx) * N : 0;
  const int x0 = active ? (g % nbx) * N : 0;

  if (tid < NN) {
    s_t[tid] = c_tables[t_offset + tid];
    s_tt[tid] = c_tables[t_offset + (tid % N) * N + tid / N];
  }
  const int x = active ? plane[(size_t)(y0 + i) * width + x0 + j] : 0;
  s_sweep[lb].x[i * (N + 1) + j] = x;

  // --- references (extract_refs) -------------------------------------
  for (int k = p; k < 2 * R; k += NN) {
    const int t = k % R;
    int v = 0;
    if (active) {
      if (t == 0) {
        v = (y0 == 0 || x0 == 0) ? q.boundary
                                 : plane[(size_t)(y0 - 1) * width + x0 - 1];
      } else if (k < R) {               // top: row y0-1, column clamp
        v = y0 == 0 ? q.boundary
                    : plane[(size_t)(y0 - 1) * width +
                            min(x0 + t - 1, width - 1)];
      } else {                          // left: column x0-1, row clamp
        v = x0 == 0 ? q.boundary
                    : plane[(size_t)min(y0 + t - 1, height - 1) * width +
                            x0 - 1];
      }
    }
    s_ref[lb][k] = v;
  }
  __syncthreads();

  // --- the 35-mode search (mode_sweep.cuh) --------------------------
  const int best_mode =
      mode_sweep<N, NN, NN * BPB>(s_ref[lb], s_sweep[lb], p, q.max_pix);
  const int best_pred =
      predict_pixel<N>(s_ref[lb], s_sweep[lb].mref, best_mode, i, j);

  // --- transform, quantize, reconstruct (shared tail) ------------------
  int level, rec;
  transform_quant_recon<N>(s_t, s_tt, s_x[lb], s_a[lb], s_b[lb], i, j,
                           x - best_pred, best_pred, q, level, rec);

  if (active) {
    recon[(size_t)(y0 + i) * width + x0 + j] = rec;
    levels[(size_t)g * NN + p] = level;
    if (p == 0) modes[g] = best_mode;
  }
}

template <int N, int BPB>
static void launch(const int* plane, int height, int width, int nbx, int nb,
                   int t_offset, QpScalars q, int* recon, int* levels,
                   int* modes, cudaStream_t stream) {
  const int grid = (nb + BPB - 1) / BPB;
  mode_search_kernel<N, BPB><<<grid, N * N * BPB, 0, stream>>>(
      plane, height, width, nbx, nb, t_offset, q, recon, levels, modes);
}

extern "C" int nhv_table_ints() { return kTableInts; }

// Copy the constant table (layout in mode_sweep.cuh) into constant memory of
// `device`.  Returns a cudaError_t.
extern "C" int nhv_upload_tables(const int* host, int count, int device) {
  if (count != kTableInts) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyToSymbol(c_tables, host, count * sizeof(int));
}

// Search and encode the full block-rows of an (height, width) int32
// plane.  Rows below the last full block-row are left to the caller
// (they still feed the left references).  Launches on `stream` without
// synchronising; returns cudaGetLastError().
extern "C" int nhv_mode_search_encode(const int* plane, int height, int width,
                                      int n, int use_dst, int mf, int qshift,
                                      int qoffset, int dscale, int dq_shift,
                                      int max_pix, int boundary, int* recon,
                                      int* levels, int* modes, void* stream,
                                      int device) {
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
      launch<4, 8>(plane, height, width, nbx, nb, transform_offset(4, use_dst),
                    q, recon, levels, modes, s);
      break;
    case 8:
      launch<8, 2>(plane, height, width, nbx, nb, transform_offset(8, false), q,
                   recon, levels, modes, s);
      break;
    case 16:
      launch<16, 1>(plane, height, width, nbx, nb, transform_offset(16, false),
                    q, recon, levels, modes, s);
      break;
    case 32:
      launch<32, 1>(plane, height, width, nbx, nb, transform_offset(32, false),
                    q, recon, levels, modes, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
