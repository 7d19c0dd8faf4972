// Closed-loop decode of a batch of planes, for Hopper (sm_90a).
//
// What it replaces.  No TPU kernel stands behind it: the JAX package
// decodes a batch of planes as one compiled program,
// nanohevc_tpu/models/wavefront.py, decode_planes (:679) vmapping
// decode_plane (:718), whose jax.lax.scan over the anti-diagonals
// (:765-781) predicts each diagonal's blocks by their signalled modes,
// adds the residual and clips.  This kernel is the port's counterpart
// of that scan: one launch per call, for all planes.  Same arithmetic,
// bit for bit, as the plain loop kernels/decode.py::
// decode_blocks_reference.  The residual (dequantized and inverse-
// transformed, the same for every block order) is computed by the
// caller, batched; the kernel predicts, adds and clips.
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
// smooth_refs); planar reads the filtered references at every N > 4, DC
// never.  Then the mode's prediction (mode_sweep.cuh: planar_pixel,
// dc_value, or the angular projection array of the one signalled mode
// and angular_pixel), the residual added, the sum clipped to
// [0, (1 << bd) - 1].  A mode outside 0..34 reads as the plain version
// reads it: below 0 as 2, above 34 as 34.
//
// What bounds it on this card: the dependency chain.  Block (by, bx)
// needs the bottom line of (by-1, bx) and the right column of
// (by, bx-1), so a plane is a chain of nby + nbx - 1 block latencies
// (374 at 1080p, N = 8), whatever the number of SMs.  Bytes (a residual
// read, a recon written: 8 a pixel) and operations are a small fraction
// of that chain's time.  A plane takes about nbx * T_b + nby * h: T_b,
// one block's latency within a row, which is the latency of one team's
// instruction stream (shared loads, shuffles, barriers, branches: a few
// hundred dependent instructions at one or two warps), and h, the
// hand-off from a row to the row below.  The design takes barriers,
// fences and global round trips out of both, and then instructions out
// of T_b.
//
// The design, point by point:
// 1. A block row belongs to one team of threads, joined by a named
//    barrier (bar.sync id, 32 x warps) or, for one warp, __syncwarp:
//    one warp at N = 4 (one pixel a lane, lanes 16-31 idle), two warps
//    at N = 8 (one pixel a thread), a warpgroup of four at N 16 and 32
//    (2 and 8 pixels a thread).  A thread's pixels are a serial chain of
//    loads and arithmetic, so more threads a row shorten the block, and
//    more barrier partners lengthen it: tools/decode_variants.py times
//    one warp and a warpgroup at every N against this choice.  Thread t
//    of a team holds column t % N, rows t / N + k * (threads / N).
//    Inside a team, never __syncthreads: one barrier after the
//    references are written, one after the filtered references, and at
//    N = 32 one after the projection array.  Each team has a slice of
//    shared memory: two reference buffers (block parity), the filtered
//    references and a projection array of 3N+1 samples.  The right
//    column of a block is written straight into the other parity's
//    buffer as the next block's left arm, so no barrier ends a block;
//    the corner is the previous block's T[N], kept in registers.
// 2. A thread block takes a group of W consecutive block rows of one
//    plane, one team a row.  W is default_group_rows (4, or 2 at N =
//    32: tools/torch_decode_phase.py --tune times W = 1..8), fewer where
//    the plane is short or its lines do not fit in the card's shared
//    memory; nhv_decode_group_rows gives it to the wrapper.  Groups are
//    taken by ticket in the order (group outer, plane inner); the grid
//    is min(groups, occupancy x SMs, the caller's cap).  A group waits
//    only on the group with the ticket `batch` below its own, so the
//    schedule is deadlock-free at any grid size, a grid of one included.
// 3. Inside a thread block, a row hands its bottom line to the row
//    below through shared memory, with no flag and no fence: a line of
//    `width` 32-bit words between each two rows of the group, each word
//    (tag << 17) | (pixel + 1), where the tag counts the thread block's
//    groups (1..32767; the lines are cleared at the start and when the
//    count wraps).  The row below polls the N words it needs with
//    volatile shared loads and goes ahead once each carries its tag; a
//    stale word from an earlier group carries another tag.  The lines
//    are dynamic shared memory: (W - 1) * width * 4 bytes.
// 4. Between thread blocks, the group's last row writes its bottom line
//    to a device-memory edge buffer as pixel + 1 words (st.relaxed.gpu);
//    the next group's first row polls them (ld.relaxed.gpu, 32 polls,
//    then __nanosleep backoff, __trap() after a second).  Each word is
//    atomic on its own and carries its own data, so a thread block reads
//    exactly the words it has seen ready, and no release or acquire
//    ordering is needed.  The wrapper zeroes the buffer with the ticket,
//    in one allocation.
// 5. Off the chain: the modes of a row are read 32 blocks at a time, a
//    chunk ahead, and shuffled out; block bx+1's residual is loaded into
//    registers while block bx computes; at N <= 16 an angular mode's
//    two reference indices and weight per pixel come from a table in
//    shared memory (33 modes x N*N words) that each thread block builds
//    once, at its start, with the shared predictors themselves:
//    angular_pixel on an array of projection indices times 32 gives a
//    pixel's two samples and weight, projection_sample on an array of
//    reference indices where each sample comes from.  The block then
//    weighs its two reference samples as angular_pixel does, with no
//    projection array and no barrier for it.  The spins read the clock
//    once in 1024 polls; the loop's invariants are pinned in registers
//    (no special-register reads or parameter loads inside it); the
//    bottom row is published before the rest of the block is stored;
//    recon is written with plain coalesced 4-byte stores (a warp writes
//    whole 32-byte sectors) that nothing waits for (the kernel's end
//    makes them visible).

#include "intra_smooth.cuh"
#include "mode_sweep.cuh"   // c_tables and the predictors
#include "wavefront_sync.cuh"   // the edge buffer's words, the clock

constexpr int kMaxGroupRows = 8;       // W, the block rows of a group
constexpr unsigned kTags = 32767;      // line tags 1..kTags
constexpr int kTagShift = 17;          // pixel + 1 <= 65536 < 2^17

// The pixel of a shared line word once it carries `tag`.  The spin
// reads the clock only every 1024 polls, so a word is seen one shared
// load after it lands.
__device__ __forceinline__ int poll_line(const unsigned* word, unsigned tag) {
  unsigned v, spins = 0;
  unsigned long long t0 = 0;
  while (((v = *(volatile const unsigned*)word) >> kTagShift) != tag) {
    if ((++spins & 1023u) == 0) {
      if (t0 == 0) t0 = global_ns();
      check_spin(t0);
    }
  }
  return (int)(v & ((1u << kTagShift) - 1u)) - 1;
}

// The barrier of one block row's team: its warp, or its named barrier.
template <int TEAM>
__device__ __forceinline__ void team_sync(int id) {
  if constexpr (TEAM == 1) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(32 * TEAM) : "memory");
  }
}

// The warps of one block row's team, by N: 1, 2, 4, 4 (a warpgroup).
template <int N>
__host__ __device__ constexpr int team_warps() {
  return N >= 16 ? 4 : N == 8 ? 2 : 1;
}

// Whether an angular mode reads its reference indices from the thread
// block's table (N <= 16) or builds the projection array (N = 32, where
// the table would take 135 KB).
template <int N>
__host__ __device__ constexpr bool indexed() {
  return N <= 16;
}

// Shared ints of one team's slice: two reference buffers (block
// parity), the filtered references and one projection array.
template <int N>
__host__ __device__ constexpr int slice_ints() {
  return 3 * 2 * (2 * N + 1) + 3 * N + 1;
}

// Shared ints of the thread block's table of angular reference indices
// (N <= 16): the identity arrays that build it (reference index k at k,
// 0 .. 4N+1, and projection index e as 32 e, 0 .. 3N), then 33 modes x
// N*N words.
template <int N>
__host__ __device__ constexpr int table_ints() {
  return indexed<N>() ? 2 * (2 * N + 1) + 3 * N + 1 + 33 * N * N : 0;
}

template <int N>
__global__ void __launch_bounds__(32 * team_warps<N>() * kMaxGroupRows)
decode_kernel(const int* __restrict__ residual, const int* __restrict__ modes,
              int* recon, int batch, int height, int width, int nby, int nbx,
              int max_pix, int boundary, int strong_thresh,
              unsigned long long filter_mask, int group_rows, int groups,
              int* ticket, int* edge) {
  constexpr int TEAM = team_warps<N>();
  constexpr int THREADS = 32 * TEAM;    // one block row's team
  constexpr int NN = N * N;
  constexpr int ACTIVE = NN < THREADS ? NN : THREADS;   // threads with pixels
  constexpr int P = NN / ACTIVE;        // pixels a thread
  constexpr int STEP = ACTIVE / N;      // rows between a thread's pixels
  constexpr int R = 2 * N + 1;          // one reference arm, corner at 0
  constexpr int L = 3 * N + 1;          // a mode's projection array

  extern __shared__ unsigned smem[];
  __shared__ int s_ticket;
  constexpr bool INDEXED = indexed<N>();
  width = pinned(width);
  nby = pinned(nby);
  nbx = pinned(nbx);
  max_pix = pinned(max_pix);
  boundary = pinned(boundary);
  const int lines_words = (group_rows - 1) * width;
  const int tid = pinned((int)threadIdx.x);
  const int w = tid / THREADS;          // the team's row in the group
  const int t = tid % THREADS;
  const int lane = tid & 31;
  const int i0 = t / N, j = t % N;      // the thread's first pixel
  const bool has_pixels = t < ACTIVE;
  const bool bottom = has_pixels && t >= ACTIVE - N;   // row N-1, pixel P-1
  int* s_id = (int*)(smem + lines_words);   // k at k, for 0 <= k < 2R
  int* s_id32 = s_id + 2 * R;                // 32 e at e, for 0 <= e < L
  int* s_tab = s_id32 + L;
  int* slice = s_id + table_ints<N>() + w * slice_ints<N>();
  int* s_fref = slice + 2 * 2 * R;
  int* s_proj = s_fref + 2 * R;
  const int bar_id = 1 + w;

  for (int k = threadIdx.x; k < lines_words; k += blockDim.x) smem[k] = 0;
  if constexpr (INDEXED) {
    // The table: for angular mode m and the pixel of slot (k, t), the
    // reference indices of its two samples and its weight, s1 | s2 << 8
    // | frac << 16.  angular_pixel on the projection indices (times 32)
    // gives the samples and the weight, projection_sample on the
    // reference indices where each sample comes from.
    for (int k = tid; k < 2 * R; k += blockDim.x) s_id[k] = k;
    for (int k = tid; k < L; k += blockDim.x) s_id32[k] = 32 * k;
    __syncthreads();
    for (int q = tid; q < 33 * NN; q += blockDim.x) {
      const int mode = 2 + q / NN, k = q % NN / ACTIVE, tt = q % ACTIVE;
      const int v = angular_pixel<N>(s_id32, mode, tt / N + k * STEP, tt % N);
      const int e = v >> 5;
      s_tab[q] = projection_sample<N>(s_id, mode, e) |
                 projection_sample<N>(s_id, mode, min(e + 1, 3 * N)) << 8 |
                 (v & 31) << 16;
    }
  }
  unsigned local = 0;                   // this thread block's groups so far
  for (;; ++local) {
    const unsigned tag = 1 + local % kTags;
    if (local > 0 && tag == 1)          // the tags wrap: clear the lines
      for (int k = threadIdx.x; k < lines_words; k += blockDim.x) smem[k] = 0;
    if (threadIdx.x == 0) s_ticket = atomicAdd(ticket, 1);
    __syncthreads();
    const int grp = s_ticket;
    if (grp >= batch * groups) break;
    const int gi = grp / batch, f = grp % batch;
    const int by = gi * group_rows + w;

    if (by < nby) {
      const size_t plane_off = (size_t)f * height * width;
      const int* res = residual + plane_off;
      int* rec = recon + plane_off;
      const int* row_modes = modes + ((size_t)f * nby + by) * nbx;
      const int y0 = by * N;
      // where the top arm comes from, and where the bottom line goes
      const bool from_edge = w == 0 && by > 0;
      const unsigned* line_above = smem + (w - 1) * width;
      const int* edge_above =
          edge + ((size_t)f * (groups - 1) + gi - 1) * width;
      const bool publish = by < nby - 1;
      const bool to_edge = w == group_rows - 1;
      unsigned* line_below = smem + w * width;
      int* edge_below = edge + ((size_t)f * (groups - 1) + gi) * width;
      const unsigned word_tag = tag << kTagShift;

      int mchunk = lane < nbx ? __ldg(row_modes + lane) : 0;
      int mnext = 32 + lane < nbx ? __ldg(row_modes + 32 + lane) : 0;
      // the thread's pixels of the residual: this block's, the next's
      const int* res_px = res + (size_t)(y0 + i0) * width + j;
      int cur[P], nxt[P] = {};
#pragma unroll
      for (int k = 0; k < P; ++k)
        cur[k] = has_pixels ? __ldg(res_px + (size_t)k * STEP * width) : 0;
      int corner = boundary;            // warp 0: the previous block's T[N]

#pragma unroll 1
      for (int bx = 0; bx < nbx; ++bx) {
        const int x0 = bx * N;
        int* s_ref = slice + (bx & 1) * 2 * R;
        int* s_next = slice + (~bx & 1) * 2 * R;
        if ((bx & 31) == 0 && bx > 0) {
          mchunk = mnext;
          mnext = bx + 32 + lane < nbx ? __ldg(row_modes + bx + 32 + lane) : 0;
        }
        int mode = __shfl_sync(0xffffffffu, mchunk, bx & 31);
        if (mode != 0 && mode != 1) mode = min(max(mode, 2), 34);
        if (bx + 1 < nbx && has_pixels) {
#pragma unroll
          for (int k = 0; k < P; ++k)
            nxt[k] = __ldg(res_px + (size_t)k * STEP * width + x0 + N);
        }

        // --- an angular mode's reference indices, from the table ---------
        int s1[P], s2[P], frac[P];
        if (INDEXED && mode >= 2 && has_pixels) {
#pragma unroll
          for (int k = 0; k < P; ++k) {
            const int q = s_tab[(mode - 2) * NN + k * ACTIVE + t];
            s1[k] = q & 255;
            s2[k] = (q >> 8) & 255;
            frac[k] = q >> 16;
          }
        }

        // --- references (availability rule) -----------------------------
        int v = boundary;               // the team's first warp: T[1 + t]
        if (t < 32) {
          if (t < N && by > 0)
            v = from_edge ? poll_edge(edge_above + x0 + t)
                          : poll_line(line_above + x0 + t, tag);
          int ext = by == 0 ? boundary : 0;
          if (bx == nbx - 1 && by > 0)  // T[N] replicated
            ext = __shfl_sync(0xffffffffu, v, N - 1);
          if (t < N) {
            s_ref[1 + t] = v;
            s_ref[N + 1 + t] = ext;
            if (bx == 0) {
              s_ref[R + 1 + t] = boundary;
              s_ref[R + N + 1 + t] = boundary;
            } else if (by != nby - 1) {
              s_ref[R + N + 1 + t] = 0;
            }
          }
          if (t == 0) s_ref[0] = s_ref[R] = by == 0 || bx == 0 ? boundary
                                                               : corner;
        }
        team_sync<TEAM>(bar_id);
        if (t < 32) corner = __shfl_sync(0xffffffffu, v, N - 1);

        // --- reference smoothing, where the mode's flag is set -----------
        const int* ref = s_ref;
        if constexpr (N > 4) {
          if ((filter_mask >> mode) & 1ull) {   // uniform over the team
            for (int e = t; e < 2 * R; e += THREADS)
              s_fref[e] = smoothed_ref<N>(s_ref, e, strong_thresh);
            team_sync<TEAM>(bar_id);
            ref = s_fref;
          }
        }

        if (!INDEXED && mode >= 2) {
          for (int e = t; e < L; e += THREADS)
            s_proj[e] = projection_sample<N>(ref, mode, e);
          team_sync<TEAM>(bar_id);
        }

        // --- prediction, residual, clip; the bottom row published first --
        if (has_pixels) {
          int r[P];
          if (INDEXED && mode >= 2) {   // angular_pixel's two-tap weighting
#pragma unroll
            for (int k = 0; k < P; ++k)
              r[k] = ((32 - frac[k]) * ref[s1[k]] + frac[k] * ref[s2[k]] +
                      16) >> 5;
          } else if (mode >= 2) {
#pragma unroll
            for (int k = 0; k < P; ++k)
              r[k] = angular_pixel<N>(s_proj, mode, i0 + k * STEP, j);
          } else if (mode == 0) {
#pragma unroll
            for (int k = 0; k < P; ++k)
              r[k] = planar_pixel<N>(ref, i0 + k * STEP, j);
          } else {
            const int dc = dc_value<N>(ref);
#pragma unroll
            for (int k = 0; k < P; ++k) r[k] = dc;
          }
#pragma unroll
          for (int k = 0; k < P; ++k)
            r[k] = min(max(r[k] + cur[k], 0), max_pix);
          if (bottom && publish) {      // row N-1 is pixel P-1
            if (to_edge)
              store_relaxed(edge_below + x0 + j, r[P - 1] + 1);
            else
              *(volatile unsigned*)(line_below + x0 + j) =
                  word_tag | (unsigned)(r[P - 1] + 1);
          }
#pragma unroll
          for (int k = P - 1; k >= 0; --k) {
            const int i = i0 + k * STEP;
            rec[(size_t)(y0 + i) * width + x0 + j] = r[k];
            if (j == N - 1) s_next[R + 1 + i] = r[k];   // the next left arm
          }
          if (bottom && j == N - 1 && by == nby - 1) {  // L[N] replicated
#pragma unroll
            for (int e = 1; e <= N; ++e) s_next[R + N + e] = r[P - 1];
          }
        }
#pragma unroll
        for (int k = 0; k < P; ++k) cur[k] = nxt[k];
      }
    }
    __syncthreads();                    // the group's rows end together
  }
}

// Dynamic shared memory of a launch: the lines, the index table, then
// the teams' slices.
template <int N>
static size_t shared_bytes(int group_rows, int width) {
  return ((size_t)(group_rows - 1) * width + table_ints<N>() +
          (size_t)group_rows * slice_ints<N>()) * sizeof(int);
}

// W by N, from the times of tools/torch_decode_phase.py --tune.
template <int N>
constexpr int default_group_rows() {
  return N == 32 ? 2 : 4;
}

// Whether a launch of W = group_rows fits the shared memory that a
// thread block of `device` may take (the dynamic part and s_ticket).
template <int N>
static cudaError_t fits(int group_rows, int width, int device, bool* ok) {
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  *ok = shared_bytes<N>(group_rows, width) + sizeof(int) <= (size_t)optin;
  return err;
}

// default_group_rows, no more than the plane's block rows, and fewer
// while the launch does not fit (at least 1).
template <int N>
static int group_rows_for(int height, int width, int device) {
  int rows = height / N < default_group_rows<N>() ? height / N
                                                  : default_group_rows<N>();
  if (rows < 1) rows = 1;
  for (bool ok = false; rows > 1; --rows) {
    cudaError_t err = fits<N>(rows, width, device, &ok);
    if (err != cudaSuccess) return -(int)err;
    if (ok) break;
  }
  return rows;
}

// One persistent launch on `stream`; `grids` gets the grids launched.
template <int N>
static int run(const int* residual, const int* modes, int batch, int height,
               int width, int max_pix, int boundary, int strong_thresh,
               unsigned long long filter_mask, int group_rows, int max_grid,
               int* recon, int* work, int* grids, cudaStream_t stream) {
  const int nby = height / N, nbx = width / N;
  const int groups = (nby + group_rows - 1) / group_rows;
  const int threads = 32 * team_warps<N>() * group_rows;
  const size_t smem = shared_bytes<N>(group_rows, width);
  int device = 0, sms = 0, per_sm = 0;
  bool ok = false;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = fits<N>(group_rows, width, device, &ok);
  if (err != cudaSuccess) return (int)err;
  if (!ok) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(decode_kernel<N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, decode_kernel<N>, threads, smem);
  if (err != cudaSuccess) return (int)err;
  const int total = batch * groups;
  int grid = per_sm * sms > 0 ? per_sm * sms : 1;
  if (max_grid > 0 && max_grid < grid) grid = max_grid;
  if (total < grid) grid = total;
  decode_kernel<N><<<grid, threads, smem, stream>>>(
      residual, modes, recon, batch, height, width, nby, nbx, max_pix,
      boundary, strong_thresh, filter_mask, group_rows, groups, work,
      work + 1);
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

// W for block-aligned (height, width) planes at block size n on
// `device`: default_group_rows, fewer on short planes or where the lines
// do not fit.  Returns W >= 1, or minus a CUDA error.
extern "C" int nhv_decode_group_rows(int n, int height, int width,
                                     int device) {
  if (height < 0 || width < 0) return -(int)cudaErrorInvalidValue;
  switch (n) {
    case 4: return group_rows_for<4>(height, width, device);
    case 8: return group_rows_for<8>(height, width, device);
    case 16: return group_rows_for<16>(height, width, device);
    case 32: return group_rows_for<32>(height, width, device);
    default: return -(int)cudaErrorInvalidValue;
  }
}

// Decode `batch` block-aligned (height, width) planes: `residual` and
// `recon` are (batch, height, width) int32, `modes` (batch, nb) int32 in
// raster block order.  filter_mask bit m set: mode m reads the smoothed
// references (0 at n = 4); strong_thresh is 1 << (bit_depth - 5), read
// at n = 32 only.  group_rows (1..8) is W, the block rows a thread block
// decodes together (nhv_decode_group_rows gives the default); max_grid caps the grid (0: occupancy x SMs; a test
// of the schedule on small grids).  `work` is 1 + batch * (groups - 1)
// * width zeroed ints on the device, groups = ceil((height / n) /
// group_rows): the ticket counter, then the edge buffer, one line of
// width words after each group of each plane but the last.  Launches one
// grid on `stream` without synchronising and adds the grids it launched
// to *grids; returns the CUDA error of the launch, or cudaSuccess.
extern "C" int nhv_wavefront_decode(const int* residual, const int* modes,
                                    int batch, int height, int width, int n,
                                    int bit_depth, int strong_thresh,
                                    unsigned long long filter_mask,
                                    int group_rows, int max_grid, int* recon,
                                    int* work, int* grids, void* stream,
                                    int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || batch < 0 || height < 0 || width < 0 || height % n != 0 ||
      width % n != 0 || bit_depth < 1 || bit_depth > 16 ||
      (filter_mask >> 35) != 0 || (n == 4 && filter_mask != 0) ||
      group_rows < 1 || group_rows > kMaxGroupRows || max_grid < 0)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || height == 0 || width == 0) return (int)cudaSuccess;
  const int max_pix = (1 << bit_depth) - 1, boundary = 1 << (bit_depth - 1);
  cudaStream_t s = (cudaStream_t)stream;
  switch (n) {
    case 4:
      return run<4>(residual, modes, batch, height, width, max_pix, boundary,
                    strong_thresh, filter_mask, group_rows, max_grid, recon,
                    work, grids, s);
    case 8:
      return run<8>(residual, modes, batch, height, width, max_pix, boundary,
                    strong_thresh, filter_mask, group_rows, max_grid, recon,
                    work, grids, s);
    case 16:
      return run<16>(residual, modes, batch, height, width, max_pix,
                     boundary, strong_thresh, filter_mask, group_rows,
                     max_grid, recon, work, grids, s);
    case 32:
      return run<32>(residual, modes, batch, height, width, max_pix,
                     boundary, strong_thresh, filter_mask, group_rows,
                     max_grid, recon, work, grids, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
