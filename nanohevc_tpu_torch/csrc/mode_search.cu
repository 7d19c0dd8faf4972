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
// and a packed (cost*64 + mode) minimum; none of that carries over.
// Here, as in slab_pipeline.cu, one thread block takes BPB whole N x N
// blocks (BPB = 256 / N^2 for N <= 8, else 1), one thread per pixel.
// Each block's pixels, its 4N+2 references and all 33 per-mode
// reference arrays are built in shared memory once; then the 35 modes
// are swept in order (mode_sweep.cuh).  Each thread computes its pixel's prediction,
// the residual goes through the WHT as two N-term signed sums (columns,
// then rows) in shared memory, and |.| is summed per block with warp
// shuffles (plus one shared-memory step across the block's warps at
// N >= 8).  Each thread keeps its pixel of the best prediction in a
// register, so the tail needs no second prediction pass.
//
// What bounds it on the card: per block about 35 SATDs, each roughly 2N
// adds per pixel plus 2-3 barriers, against 12 bytes per pixel of
// memory traffic (read the plane, write recon and levels).  It should
// be bound by integer ALU and barriers, not by HBM.  Left for later:
// the WHT-linearity shortcuts the TPU kernel uses for DC / 10 / 26
// (mode_search_slab.py:23-27), a WHT as butterflies in warp shuffles,
// and a Hadamard on the tensor cores.

#include "mode_sweep.cuh"   // also defines c_tables, the constant table

template <int N, int BPB>
__global__ void __launch_bounds__(N * N * BPB)
mode_search_kernel(const int* __restrict__ plane, int height, int width,
                   int nbx, int nb, int t_offset, QpScalars q,
                   int* __restrict__ recon, int* __restrict__ levels,
                   int* __restrict__ modes) {
  constexpr int NN = N * N;
  constexpr int R = 2 * N + 1;          // one reference arm, corner at 0
  constexpr int L = 3 * N + 1;          // a mode's projection array
  constexpr int WARPS = NN > 32 ? NN / 32 : 1;   // warps per N x N block

  __shared__ int s_t[NN];               // T[i][k] at i*N + k
  __shared__ int s_tt[NN];              // T[j][k] at k*N + j
  __shared__ int s_x[BPB][NN];          // the tail's scratch
  __shared__ int s_a[BPB][NN];          // residual, then tail scratch
  __shared__ int s_b[BPB][NN];          // column WHT, then tail scratch
  __shared__ int s_ref[BPB][2 * R];     // top arm | left arm
  __shared__ int s_mref[BPB][kNumAngular][L];
  __shared__ int s_part[BPB][WARPS];

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
  int best_mode, best_pred;
  mode_sweep<N, N * N * BPB>(s_ref[lb], s_mref[lb], s_a[lb], s_b[lb],
                             s_part[lb], x, i, j, best_mode, best_pred);

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
      launch<4, 16>(plane, height, width, nbx, nb, transform_offset(4, use_dst),
                    q, recon, levels, modes, s);
      break;
    case 8:
      launch<8, 4>(plane, height, width, nbx, nb, transform_offset(8, false), q,
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
