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
// shared with slab_pipeline.cu and fused_pipeline.cu; or the 35-mode
// search, mode_sweep.cuh, shared with mode_search.cu) and on N in
// {4, 8, 16, 32}.  Same arithmetic, bit for bit, as the plain loop
// kernels/wavefront.py::wavefront_encode_planes_reference, which codes
// one anti-diagonal (by + bx == d) at a time.  A block's references
// follow the closed loop's availability rule (ops.extract_refs_at on a
// zero-filled recon written one diagonal at a time):
//   T[0] = L[0] = 1 << (bd-1) where by == 0 or bx == 0, else the
//     reconstructed pixel (y0-1, x0-1);
//   T[1..N] = recon row y0-1 (1 << (bd-1) on the top row);
//   T[N+1..2N] = T[N] at the last block-column, else 0: block
//     (by-1, bx+1) is on the same diagonal, not yet reconstructed;
//   L[1..N], L[N+1..2N] likewise from column x0-1 (L[N] replicated
//     at the last block-row);
//   then the body's decision and the transform-quantize tail
//   (encode_tail.cuh).
// So block (by, bx) reads only its top (by-1, bx), left (by, bx-1) and
// top-left (by-1, bx-1) neighbours: T[N]'s replica at the last column
// lies in the top block, L[N]'s at the last row in the left block.  The
// extensions are written as the rule says and never read: under the
// schedule below the top-right and below-left blocks may already be
// reconstructed, and reading them would change the bitstream.
//
// Design: one persistent launch per call.  The work unit is a block
// row (plane f, row by).  A thread block takes a ticket from a global
// counter, in the order (by outer, f inner), codes its row left to
// right, and takes the next ticket.  Before block bx it waits until
// progress[f][by-1] > bx; after it, it publishes progress[f][by] =
// bx + 1.  A row waits only on a lower ticket, held by a thread block
// that is already running, so the schedule cannot deadlock whatever the
// grid size and occupancy; the grid is the occupancy limit times the SM
// count (at most one thread block a row).  The left neighbour is this
// thread block's own previous block: the threads of its right column
// keep their pixel in a register for the next block's left arm, and
// thread 0 keeps its T[N] as the next block's corner.  Only the top arm
// comes from the reconstruction in device memory.  Levels go to
// (B, nb, N, N) raster blocks, modes to (B, nb); the wrapper zeroes
// the ticket and the progress flags, and every recon pixel is written
// before it is read.
//
// Memory ordering.  The L1 is not coherent across SMs.  Publish: the N
// threads of the block's bottom row (the pixels the row below reads,
// one warp's lanes) store their recon pixels, __syncwarp(), then one of
// them makes a st.release.gpu of the flag (a release fence at device
// scope, which orders the stores the warp barrier ordered before it).
// Wait: thread 0 spins on ld.acquire.gpu with __nanosleep backoff (and
// keeps the last value it read, so a row that is ahead costs no load),
// then __syncwarp(); the lanes of warp 0 read the top arm with __ldcg
// (L2, never L1) and a __syncthreads() hands it to the block.  A spin
// that lasts a second ends in __trap(), so a schedule fault is a CUDA
// error at the next synchronise, not a hang.  Shared memory needs no
// barrier between blocks: every shared read of a block comes before the
// first barrier of its tail, every shared write of the next block after
// the last one.
//
// Thread blocks: the DC/planar body N*N threads, one a pixel; the
// search body max(N*N, 16N), so that 16 (32 at N = 32) groups of N
// lanes sweep the 35 modes in 3 (2) passes (mode_sweep.cuh); threads
// beyond N*N mirror pixel t % N*N in the tail, writing the same values.
//
// What bounds it on the card: the dependency chain, not bytes or
// operations.  A plane is nby + nbx - 1 block latencies long (374 at
// 1080p, N = 8), plus one hand-off between thread blocks for each of
// the nby - 1 rows; a batch of planes, or more rows than resident
// thread blocks, adds little to that while the SMs have room.

#include <type_traits>

#include "dc_planar.cuh"
#include "mode_sweep.cuh"   // also defines c_tables, the constant table
#include "wavefront_sync.cuh"

template <int N, bool SEARCH>
__host__ __device__ constexpr int wavefront_threads() {
  return SEARCH ? (N * N > 16 * N ? N * N : 16 * N) : N * N;
}

template <int N, bool SEARCH>
__global__ void __launch_bounds__(wavefront_threads<N, SEARCH>())
wavefront_kernel(const int* __restrict__ planes, int* recon, int batch,
                 int height, int width, int nby, int nbx, int t_offset,
                 QpScalars q, int* __restrict__ levels,
                 int* __restrict__ modes, int* ticket, int* progress) {
  constexpr int NN = N * N;
  constexpr int R = 2 * N + 1;          // one reference arm, corner at 0
  constexpr int THREADS = wavefront_threads<N, SEARCH>();
  using Scratch =
      typename std::conditional<SEARCH, SweepScratch<N, THREADS>, int>::type;

  __shared__ int s_t[NN];               // T[i][k] at i*N + k
  __shared__ int s_tt[NN];              // T[j][k] at k*N + j
  __shared__ int s_x[NN];
  __shared__ int s_a[NN];
  __shared__ int s_b[NN];
  __shared__ int s_ref[2 * R];          // top arm | left arm
  __shared__ int s_row;
  __shared__ Scratch s_sweep;

  // warp 0 (the top arm), and the bottom row's lanes (the publish)
  constexpr unsigned kWarp0 = THREADS >= 32 ? 0xffffffffu : (1u << THREADS) - 1u;
  constexpr unsigned kBottom =
      N == 32 ? 0xffffffffu : ((1u << N) - 1u) << ((NN - N) % 32);
  const int t = threadIdx.x;
  const int p = t % NN;                 // pixel (threads >= N*N mirror)
  const int i = p / N, j = p % N;
  s_t[p] = c_tables[t_offset + p];
  s_tt[p] = c_tables[t_offset + j * N + i];

  const int rows = batch * nby;
  for (;;) {
    if (t == 0) s_row = atomicAdd(ticket, 1);
    __syncthreads();
    const int row = s_row;
    if (row >= rows) break;
    const int by = row / batch, f = row % batch;
    const size_t plane_off = (size_t)f * height * width;
    const int* plane = planes + plane_off;
    int* rec = recon + plane_off;
    const int* above = progress + (size_t)f * nby + by - 1;
    int* mine = progress + (size_t)f * nby + by;
    const int y0 = by * N;
    int seen = 0;       // thread 0: the last value of *above it read
    int corner = 0;     // thread 0: the previous block's T[N]
    int right = 0;      // threads (i, N-1): the previous block's pixel

#pragma unroll 1
    for (int bx = 0; bx < nbx; ++bx) {
      const int x0 = bx * N;
      const int x = plane[(size_t)(y0 + i) * width + x0 + j];

      // --- references (availability rule; extensions never read) -----
      if (t < 32) {                     // warp 0: the top arm
        if (by > 0 && t == 0 && seen <= bx) seen = wait_above(above, bx);
        __syncwarp(kWarp0);
        int v = q.boundary;
        if (by > 0 && t < N)
          v = __ldcg(rec + (size_t)(y0 - 1) * width + x0 + t);
        const int tn = __shfl_sync(kWarp0, v, N - 1);   // T[N]
        if (t < N) {
          s_ref[1 + t] = v;
          s_ref[N + 1 + t] = by == 0 ? q.boundary : bx == nbx - 1 ? tn : 0;
        }
        if (t == 0) {
          s_ref[0] = s_ref[R] = by == 0 || bx == 0 ? q.boundary : corner;
          corner = tn;
        }
      }
      if (t < NN && j == N - 1) {       // the left arm, from registers
        s_ref[R + 1 + i] = bx == 0 ? q.boundary : right;
        if (bx == 0 || by != nby - 1) {
          s_ref[R + N + 1 + i] = bx == 0 ? q.boundary : 0;
        } else if (i == N - 1) {        // last block-row: L[N] replicated
#pragma unroll
          for (int k = 1; k <= N; ++k) s_ref[R + N + k] = right;
        }
      }
      if constexpr (SEARCH) s_sweep.x[i * (N + 1) + j] = x;
      __syncthreads();

      // --- the body's decision -----------------------------------------
      int pred, mode;
      if constexpr (SEARCH) {
        mode = mode_sweep<N, THREADS, THREADS>(s_ref, s_sweep, t, q.max_pix);
        pred = predict_pixel<N>(s_ref, s_sweep.mref, mode, i, j);
      } else {
        bool use_dc;
        pred = dc_planar_energy<N, THREADS>(s_ref, x, i, j, s_a, s_b, use_dc);
        mode = use_dc ? 1 : 0;
      }

      // --- transform, quantize, reconstruct (shared tail) ----------------
      int level, r;
      transform_quant_recon<N>(s_t, s_tt, s_x, s_a, s_b, i, j, x - pred, pred,
                               q, level, r);

      if (t < NN) {
        rec[(size_t)(y0 + i) * width + x0 + j] = r;
        if (j == N - 1) right = r;
        if (i == N - 1) {               // the row below reads these N
          __syncwarp(kBottom);
          if (j == N - 1) store_release(mine, bx + 1);
        }
        const size_t g = (size_t)f * nby * nbx + (size_t)by * nbx + bx;
        levels[g * NN + p] = level;
        if (p == 0) modes[g] = mode;
      }
    }
  }
}

// One persistent launch on `stream`; `grids` gets the grids launched.
template <int N, bool SEARCH>
static int run(const int* planes, int batch, int height, int width,
               int t_offset, QpScalars q, int* recon, int* levels, int* modes,
               int* work, int* grids, cudaStream_t stream) {
  constexpr int threads = wavefront_threads<N, SEARCH>();
  const int nby = height / N, nbx = width / N;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, wavefront_kernel<N, SEARCH>, threads, 0);
  if (err != cudaSuccess) return (int)err;
  const int rows = batch * nby;
  const int resident = per_sm * sms > 0 ? per_sm * sms : 1;
  const int grid = rows < resident ? rows : resident;
  wavefront_kernel<N, SEARCH><<<grid, threads, 0, stream>>>(
      planes, recon, batch, height, width, nby, nbx, t_offset, q, levels,
      modes, work, work + 1);
  err = cudaGetLastError();
  if (err == cudaSuccess) *grids += 1;
  return (int)err;
}

template <int N>
static int run_body(int body, const int* planes, int batch, int height,
                    int width, int t_offset, QpScalars q, int* recon,
                    int* levels, int* modes, int* work, int* grids,
                    cudaStream_t stream) {
  return body ? run<N, true>(planes, batch, height, width, t_offset, q, recon,
                             levels, modes, work, grids, stream)
              : run<N, false>(planes, batch, height, width, t_offset, q,
                              recon, levels, modes, work, grids, stream);
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
// `recon` (batch, height, width) is written whole; levels
// (batch, nb, n, n) and modes (batch, nb) in raster block order.
// `work` is 1 + batch * (height / n) zeroed ints on the device: the
// ticket counter, then the progress flag of each block row.  Launches
// one grid on `stream` without synchronising and adds the grids it
// launched to *grids; returns the CUDA error of the launch, or
// cudaSuccess.
extern "C" int nhv_wavefront_encode(const int* planes, int batch, int height,
                                    int width, int n, int body, int use_dst,
                                    int mf, int qshift, int qoffset,
                                    int dscale, int dq_shift, int max_pix,
                                    int boundary, int* recon, int* levels,
                                    int* modes, int* work, int* grids,
                                    void* stream, int device) {
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
                         recon, levels, modes, work, grids, s);
    case 8:
      return run_body<8>(body, planes, batch, height, width, t_offset, q,
                         recon, levels, modes, work, grids, s);
    case 16:
      return run_body<16>(body, planes, batch, height, width, t_offset, q,
                          recon, levels, modes, work, grids, s);
    case 32:
      return run_body<32>(body, planes, batch, height, width, t_offset, q,
                          recon, levels, modes, work, grids, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
