// Closed-loop (wavefront) all-intra encode of a batch of planes, for
// Hopper (sm_90a).
//
// Replaces the three TPU kernels of the closed loop, as reached through
// nanohevc_tpu/models/wavefront.py (encode_planes_closed_loop):
//   nanohevc_tpu/kernels/wavefront_slab.py (wavefront_encode_blocks ->
//     _kernel), K4: DC/planar by energy;
//   nanohevc_tpu/kernels/wavefront_mode_slab.py
//     (wavefront_mode_search_blocks -> _kernel), K3b, and
//   nanohevc_tpu/kernels/wavefront_mode_grouped.py
//     (wavefront_mode_search_raster_grouped -> _kernel), K3a: the
//     35-mode SATD search; K3a and K3b differ only in TPU layout.
// One kernel, templated on the body (DC/planar by energy, dc_planar.cuh,
// shared with slab_pipeline.cu; or the 35-mode search, mode_sweep.cuh,
// shared with mode_search.cu) and on N in {4, 8, 16, 32}.  Same
// arithmetic, bit for bit, as the plain loop
// kernels/wavefront.py::wavefront_encode_planes_reference:
//   blocks on anti-diagonal d (by + bx == d) depend only on diagonals
//   before d.  A block's references come from the reconstruction under
//   the closed loop's availability rule (ops.extract_refs_at on a
//   zero-filled recon written one diagonal at a time):
//     T[0] = L[0] = 1 << (bd-1) where by == 0 or bx == 0, else the
//       reconstructed pixel (y0-1, x0-1);
//     T[1..N] = recon row y0-1 (1 << (bd-1) on the top row);
//     T[N+1..2N] = T[N] at the last block-column, else 0: block
//       (by-1, bx+1) is on the same diagonal, not yet reconstructed;
//     L[1..N], L[N+1..2N] likewise from column x0-1 (L[N] replicated
//       at the last block-row);
//   then the body's decision and the transform-quantize tail
//   (encode_tail.cuh).
// The kernel never reads a block of the diagonal it is coding: the
// extensions that lie there are written as the rule says, not read, so
// the blocks of one launch do not race.
//
// Design.  The TPU kernels skew the blocks so that each diagonal is one
// lane-dense slab and relay the bottom rows and right columns of the
// last diagonal through VMEM scratch across their sequential grid.
// Here the reconstruction itself, (B, Hp, Wp) int32 in device memory,
// is the state: each block reads its 4N+2 references from it and
// writes its N x N recon back.  The host C function below walks the
// nby + nbx - 1 diagonals and launches one grid per diagonal on the
// caller's stream: B x (blocks on the diagonal) thread blocks of N x N
// threads, one block each (BPB = 1), so the at most 135 blocks of a
// 1080p diagonal spread over the 132 SMs.  Stream order makes diagonal
// d's writes visible to d+1.  Levels go to (B, nb, N, N) raster
// blocks, modes to (B, nb).
//
// What bounds it on the card: the dependency chain, not bytes or
// operations.  A 1080p luma plane at N = 8 is 374 dependent launches;
// each moves at most 135 x 64 pixels (12 bytes each) and does the
// per-block work of K1 or K2, so a launch is a few microseconds of
// work and a few microseconds of launch latency.  Left for later: a
// persistent kernel with per-row ready flags, or the 374 launches
// captured in a CUDA graph.

#include "dc_planar.cuh"
#include "mode_sweep.cuh"   // also defines c_tables, the constant table

template <int N, bool SEARCH>
__global__ void __launch_bounds__(N * N)
wavefront_kernel(const int* __restrict__ planes, int* __restrict__ recon,
                 int height, int width, int nby, int nbx, int d, int by_lo,
                 int count, int t_offset, QpScalars q,
                 int* __restrict__ levels, int* __restrict__ modes) {
  constexpr int NN = N * N;
  constexpr int R = 2 * N + 1;          // one reference arm, corner at 0
  constexpr int WARPS = NN > 32 ? NN / 32 : 1;

  __shared__ int s_t[NN];               // T[i][k] at i*N + k
  __shared__ int s_tt[NN];              // T[j][k] at k*N + j
  __shared__ int s_x[NN];
  __shared__ int s_a[NN];
  __shared__ int s_b[NN];
  __shared__ int s_ref[2 * R];          // top arm | left arm
  __shared__ int s_mref[SEARCH ? kNumAngular : 1][SEARCH ? 3 * N + 1 : 1];
  __shared__ int s_part[WARPS];

  const int p = threadIdx.x;            // pixel in the block
  const int i = p / N, j = p % N;
  const int f = blockIdx.x / count;     // plane of the batch
  const int by = by_lo + blockIdx.x % count;
  const int bx = d - by;
  const int y0 = by * N, x0 = bx * N;
  const size_t plane_off = (size_t)f * height * width;
  const int* plane = planes + plane_off;
  int* rec = recon + plane_off;

  s_t[p] = c_tables[t_offset + p];
  s_tt[p] = c_tables[t_offset + j * N + i];
  const int x = plane[(size_t)(y0 + i) * width + x0 + j];

  // --- references from the reconstruction (availability rule) --------
  for (int k = p; k < 2 * R; k += NN) {
    const bool is_top = k < R;
    const int t = is_top ? k : k - R;
    int v;
    if (t == 0) {
      v = (by == 0 || bx == 0) ? q.boundary
                               : rec[(size_t)(y0 - 1) * width + x0 - 1];
    } else if (is_top) {                // row y0-1
      if (by == 0)
        v = q.boundary;
      else if (t <= N)
        v = rec[(size_t)(y0 - 1) * width + x0 + t - 1];
      else
        v = bx == nbx - 1 ? rec[(size_t)(y0 - 1) * width + width - 1] : 0;
    } else {                            // column x0-1
      if (bx == 0)
        v = q.boundary;
      else if (t <= N)
        v = rec[(size_t)(y0 + t - 1) * width + x0 - 1];
      else
        v = by == nby - 1 ? rec[(size_t)(height - 1) * width + x0 - 1] : 0;
    }
    s_ref[k] = v;
  }
  __syncthreads();

  // --- the body's decision ---------------------------------------------
  int pred, mode;
  if constexpr (SEARCH) {
    mode_sweep<N, NN>(s_ref, s_mref, s_a, s_b, s_part, x, i, j, mode, pred);
  } else {
    bool use_dc;
    pred = dc_planar_energy<N>(s_ref, x, i, j, s_a, s_b, use_dc);
    mode = use_dc ? 1 : 0;
  }

  // --- transform, quantize, reconstruct (shared tail) ------------------
  int level, r;
  transform_quant_recon<N>(s_t, s_tt, s_x, s_a, s_b, i, j, x - pred, pred, q,
                           level, r);

  rec[(size_t)(y0 + i) * width + x0 + j] = r;
  const size_t g = (size_t)f * nby * nbx + (size_t)by * nbx + bx;
  levels[g * NN + p] = level;
  if (p == 0) modes[g] = mode;
}

// One launch per anti-diagonal, in order, on `stream`.
template <int N, bool SEARCH>
static int run(const int* planes, int batch, int height, int width,
               int t_offset, QpScalars q, int* recon, int* levels, int* modes,
               cudaStream_t stream) {
  const int nby = height / N, nbx = width / N;
  for (int d = 0; d < nby + nbx - 1; ++d) {
    const int by_lo = d - nbx + 1 > 0 ? d - nbx + 1 : 0;
    const int by_hi = d < nby - 1 ? d : nby - 1;
    const int count = by_hi - by_lo + 1;
    wavefront_kernel<N, SEARCH><<<batch * count, N * N, 0, stream>>>(
        planes, recon, height, width, nby, nbx, d, by_lo, count, t_offset, q,
        levels, modes);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

template <int N>
static int run_body(int body, const int* planes, int batch, int height,
                    int width, int t_offset, QpScalars q, int* recon,
                    int* levels, int* modes, cudaStream_t stream) {
  return body ? run<N, true>(planes, batch, height, width, t_offset, q, recon,
                             levels, modes, stream)
              : run<N, false>(planes, batch, height, width, t_offset, q,
                              recon, levels, modes, stream);
}

extern "C" int nhv_table_ints() { return kTableInts; }

// Copy the constant table (layout in mode_sweep.cuh) into constant
// memory of `device`.  Returns a cudaError_t.
extern "C" int nhv_upload_tables(const int* host, int count, int device) {
  if (count != kTableInts) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyToSymbol(c_tables, host, count * sizeof(int));
}

// Closed-loop encode of `batch` block-aligned (height, width) int32
// planes.  body 0 is DC/planar by energy, 1 the 35-mode SATD search.
// `recon` (batch, height, width) is written in place; levels
// (batch, nb, n, n) and modes (batch, nb) in raster block order.
// Launches on `stream` without synchronising; returns the first CUDA
// error of a launch, or cudaSuccess.
extern "C" int nhv_wavefront_encode(const int* planes, int batch, int height,
                                    int width, int n, int body, int use_dst,
                                    int mf, int qshift, int qoffset,
                                    int dscale, int dq_shift, int max_pix,
                                    int boundary, int* recon, int* levels,
                                    int* modes, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || batch < 0 || height % n != 0 || width % n != 0 ||
      (body != 0 && body != 1) || (use_dst && n != 4))
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || height == 0 || width == 0) return (int)cudaSuccess;
  const QpScalars q{mf, qshift, qoffset, dscale, dq_shift, max_pix, boundary};
  cudaStream_t s = (cudaStream_t)stream;
  const int t_offset = transform_offset(n, use_dst);
  switch (n) {
    case 4:
      return run_body<4>(body, planes, batch, height, width, t_offset, q,
                         recon, levels, modes, s);
    case 8:
      return run_body<8>(body, planes, batch, height, width, t_offset, q,
                         recon, levels, modes, s);
    case 16:
      return run_body<16>(body, planes, batch, height, width, t_offset, q,
                          recon, levels, modes, s);
    case 32:
      return run_body<32>(body, planes, batch, height, width, t_offset, q,
                          recon, levels, modes, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
