// Closed-loop decode of a batch of planes, for Hopper (sm_90a).
//
// No TPU kernel stands behind it.  The JAX package decodes a batch of
// planes as one compiled program: nanohevc_tpu/models/wavefront.py,
// decode_planes (:679) vmaps decode_plane, whose jax.lax.scan over the
// anti-diagonals (:765-781) predicts each diagonal's blocks by their
// signalled modes, adds the residual and clips.  This kernel is the
// port's counterpart of that scan: one launch per call, for all planes.
// Same arithmetic, bit for bit, as the plain loop
// kernels/decode.py::decode_blocks_reference.  The residual (dequantized
// and inverse-transformed, the same for every block order) is computed
// by the caller, batched; the kernel predicts, adds and clips.
//
// A block's references follow the closed loop's availability rule, as
// in wavefront.cu:
//   T[0] = L[0] = 1 << (bd-1) where by == 0 or bx == 0, else the
//     reconstructed pixel (y0-1, x0-1);
//   T[1..N] = recon row y0-1 (1 << (bd-1) on the top row);
//   T[N+1..2N] = T[N] at the last block-column, else 0 (1 << (bd-1) on
//     the top row);
//   L[1..N], L[N+1..2N] likewise from column x0-1 (L[N] replicated at
//     the last block-row; 1 << (bd-1) on the left column).
// Then, where the mode's bit of `filter_mask` is set (the wrapper builds
// it from ops.intra.mode_filter_flags: luma smoothing, N > 4), the
// [1 2 1] filter along bottom-left -> corner -> top-right, with the path
// ends unfiltered, and at N = 32 the strong (bilinear) filter where both
// arms are flat (intra_smooth.cuh, shared with wavefront.cu; ops.intra.
// smooth_refs); planar reads the filtered
// references at every N > 4, DC never.  Then the mode's prediction
// (mode_sweep.cuh: planar_pixel, dc_value, or the angular projection
// array of the one signalled mode and angular_pixel), the residual
// added, the sum clipped to [0, (1 << bd) - 1].  A mode outside 0..34
// reads as the plain version reads it: below 0 as 2, above 34 as 34.
//
// Design: wavefront.cu's schedule (wavefront_sync.cuh).  One persistent
// launch per call; the work unit is a block row (plane f, row by),
// taken by ticket in the order (by outer, f inner) and decoded left to
// right.  Before block bx, thread 0 waits until progress[f][by-1] > bx;
// after it, a bottom-row lane publishes progress[f][by] = bx + 1 with a
// st.release.gpu after the bottom row's stores and a __syncwarp.  The
// top arm comes from device memory through L2 (__ldcg); the left arm
// and the corner from the thread block's own previous block, kept in
// registers.  N*N threads, one a pixel.  Shared memory holds the raw
// and the filtered references and one projection array; barriers: the
// raw references, the filtered ones (where filtered), the projection
// array (angular modes), and one at the end of the block, so that the
// next block's reference writes wait for this block's reads.
//
// What bounds it on the card: the dependency chain, as for the encoder.
// A plane is nby + nbx - 1 block latencies long (374 at 1080p, N = 8),
// plus a hand-off between thread blocks for each of the nby - 1 rows.
// Bytes (a residual read, a recon written: 8 a pixel) and operations
// are a small fraction of that chain's time.

#include "intra_smooth.cuh"
#include "mode_sweep.cuh"   // c_tables and the predictors
#include "wavefront_sync.cuh"

template <int N>
__global__ void __launch_bounds__(N * N)
decode_kernel(const int* __restrict__ residual, const int* __restrict__ modes,
              int* recon, int batch, int height, int width, int nby, int nbx,
              int max_pix, int boundary, int strong_thresh,
              unsigned long long filter_mask, int* ticket, int* progress) {
  constexpr int NN = N * N;
  constexpr int R = 2 * N + 1;          // one reference arm, corner at 0
  constexpr int L = 3 * N + 1;          // a mode's projection array

  __shared__ int s_ref[2 * R];          // top arm | left arm
  __shared__ int s_fref[2 * R];         // the same, filtered
  __shared__ int s_proj[L];
  __shared__ int s_row;

  // warp 0 (the top arm), and the bottom row's lanes (the publish)
  constexpr unsigned kWarp0 = NN >= 32 ? 0xffffffffu : (1u << NN) - 1u;
  constexpr unsigned kBottom =
      N == 32 ? 0xffffffffu : ((1u << N) - 1u) << ((NN - N) % 32);
  const int t = threadIdx.x;
  const int i = t / N, j = t % N;
  const int rows = batch * nby;

  for (;;) {
    if (t == 0) s_row = atomicAdd(ticket, 1);
    __syncthreads();
    const int row = s_row;
    if (row >= rows) break;
    const int by = row / batch, f = row % batch;
    const size_t plane_off = (size_t)f * height * width;
    const int* res = residual + plane_off;
    int* rec = recon + plane_off;
    const int* row_modes = modes + ((size_t)f * nby + by) * nbx;
    const int* above = progress + (size_t)f * nby + by - 1;
    int* mine = progress + (size_t)f * nby + by;
    const int y0 = by * N;
    int seen = 0;       // thread 0: the last value of *above it read
    int corner = 0;     // thread 0: the previous block's T[N]
    int right = 0;      // threads (i, N-1): the previous block's pixel

#pragma unroll 1
    for (int bx = 0; bx < nbx; ++bx) {
      const int x0 = bx * N;
      const int r0 = res[(size_t)(y0 + i) * width + x0 + j];
      int mode = row_modes[bx];
      if (mode != 0 && mode != 1) mode = min(max(mode, 2), 34);

      // --- references (availability rule) -------------------------------
      if (t < 32) {                     // warp 0: the top arm
        if (by > 0 && t == 0 && seen <= bx) seen = wait_above(above, bx);
        __syncwarp(kWarp0);
        int v = boundary;
        if (by > 0 && t < N)
          v = __ldcg(rec + (size_t)(y0 - 1) * width + x0 + t);
        const int tn = __shfl_sync(kWarp0, v, N - 1);   // T[N]
        if (t < N) {
          s_ref[1 + t] = v;
          s_ref[N + 1 + t] = by == 0 ? boundary : bx == nbx - 1 ? tn : 0;
        }
        if (t == 0) {
          s_ref[0] = s_ref[R] = by == 0 || bx == 0 ? boundary : corner;
          corner = tn;
        }
      }
      if (j == N - 1) {                 // the left arm, from registers
        s_ref[R + 1 + i] = bx == 0 ? boundary : right;
        if (bx == 0 || by != nby - 1) {
          s_ref[R + N + 1 + i] = bx == 0 ? boundary : 0;
        } else if (i == N - 1) {        // last block-row: L[N] replicated
#pragma unroll
          for (int k = 1; k <= N; ++k) s_ref[R + N + k] = right;
        }
      }
      __syncthreads();

      // --- reference smoothing, where the mode's flag is set -------------
      const int* ref = s_ref;
      if constexpr (N > 4) {
        if ((filter_mask >> mode) & 1ull) {   // uniform over the block
          if (t < 2 * R) s_fref[t] = smoothed_ref<N>(s_ref, t, strong_thresh);
          __syncthreads();
          ref = s_fref;
        }
      }

      // --- prediction, residual, clip ------------------------------------
      if (mode >= 2) {                  // uniform: the mode's projection
        if (t < L) s_proj[t] = projection_sample<N>(ref, mode, t);
        __syncthreads();
      }
      const int pred = mode == 0   ? planar_pixel<N>(ref, i, j)
                       : mode == 1 ? dc_value<N>(ref)
                                   : angular_pixel<N>(s_proj, mode, i, j);
      const int r = min(max(pred + r0, 0), max_pix);
      rec[(size_t)(y0 + i) * width + x0 + j] = r;
      if (j == N - 1) right = r;
      if (i == N - 1) {                 // the row below reads these N
        __syncwarp(kBottom);
        if (j == N - 1) store_release(mine, bx + 1);
      }
      __syncthreads();                  // this block's shared reads end
    }
  }
}

// One persistent launch on `stream`; `grids` gets the grids launched.
template <int N>
static int run(const int* residual, const int* modes, int batch, int height,
               int width, int max_pix, int boundary, int strong_thresh,
               unsigned long long filter_mask, int* recon, int* work,
               int* grids, cudaStream_t stream) {
  const int nby = height / N, nbx = width / N;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, decode_kernel<N>, N * N, 0);
  if (err != cudaSuccess) return (int)err;
  const int rows = batch * nby;
  const int resident = per_sm * sms > 0 ? per_sm * sms : 1;
  const int grid = rows < resident ? rows : resident;
  decode_kernel<N><<<grid, N * N, 0, stream>>>(
      residual, modes, recon, batch, height, width, nby, nbx, max_pix,
      boundary, strong_thresh, filter_mask, work, work + 1);
  err = cudaGetLastError();
  if (err == cudaSuccess) *grids += 1;
  return (int)err;
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

// Decode `batch` block-aligned (height, width) planes: `residual` and
// `recon` are (batch, height, width) int32, `modes` (batch, nb) int32 in
// raster block order.  filter_mask bit m set: mode m reads the smoothed
// references (0 at n = 4); strong_thresh is 1 << (bit_depth - 5), read
// at n = 32 only.  `work` is 1 + batch * (height / n) zeroed ints on the
// device: the ticket counter, then the progress flag of each block row.
// Launches one grid on `stream` without synchronising and adds the grids
// it launched to *grids; returns the CUDA error of the launch, or
// cudaSuccess.
extern "C" int nhv_wavefront_decode(const int* residual, const int* modes,
                                    int batch, int height, int width, int n,
                                    int bit_depth, int strong_thresh,
                                    unsigned long long filter_mask,
                                    int* recon, int* work, int* grids,
                                    void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || batch < 0 || height < 0 || width < 0 || height % n != 0 ||
      width % n != 0 || bit_depth < 1 || bit_depth > 16 ||
      (filter_mask >> 35) != 0 || (n == 4 && filter_mask != 0))
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || height == 0 || width == 0) return (int)cudaSuccess;
  const int max_pix = (1 << bit_depth) - 1, boundary = 1 << (bit_depth - 1);
  cudaStream_t s = (cudaStream_t)stream;
  switch (n) {
    case 4:
      return run<4>(residual, modes, batch, height, width, max_pix, boundary,
                    strong_thresh, filter_mask, recon, work, grids, s);
    case 8:
      return run<8>(residual, modes, batch, height, width, max_pix, boundary,
                    strong_thresh, filter_mask, recon, work, grids, s);
    case 16:
      return run<16>(residual, modes, batch, height, width, max_pix,
                     boundary, strong_thresh, filter_mask, recon, work, grids,
                     s);
    case 32:
      return run<32>(residual, modes, batch, height, width, max_pix,
                     boundary, strong_thresh, filter_mask, recon, work, grids,
                     s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
