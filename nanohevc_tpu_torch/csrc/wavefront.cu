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
//     35-mode SATD search; K3a and K3b differ only in TPU layout;
// and the JAX package's closed-loop XLA scan (models/wavefront.py there,
// `step` and `one_frame`, the jax.lax.scan of encode_planes_closed_loop),
// which codes every configuration its Pallas kernels do not take: the
// mode sets dc, planar, dc_planar and all under the decisions energy,
// sad and satd, luma reference smoothing, and RDOQ in every scan.  Only
// decision="rd", which prices each batch with the adaptive rate model
// on the host, stays outside (models/wavefront.py, _encode_planes_rd).
// One kernel, templated on N in {4, 8, 16, 32}, on the body's shape
// (one fixed mode; the pair DC / planar, K4's energy body of
// dc_planar.cuh or, by SAD or SATD, the pair through mode_sweep.cuh; the
// 35-mode sweep of mode_sweep.cuh, shared with mode_search.cu), on the
// cost and on RDOQ (rdoq_tail.cuh); smoothing (intra_smooth.cuh, shared
// with decode.cu) and RDOQ's scan are switches taken once a block.  Same
// arithmetic, bit for bit, as the plain loop
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
//   then, with smoothing, their filtered copy for the modes that read
//   it; the body's decision; and the transform-quantize tail
//   (encode_tail.cuh), with RDOQ between quantizer and dequantizer.
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
// right, and takes the next ticket.  A row waits only on the row above
// it, a lower ticket held by a thread block that is already running, so
// the schedule cannot deadlock whatever the grid size and occupancy; the
// grid is the occupancy limit times the SM count (at most one thread
// block a row), or the caller's cap, which only the tests of the
// schedule set.  The left neighbour is this thread block's own previous
// block: the threads of its right column keep their pixel in a register
// for the next block's left arm, and thread 0 keeps its T[N] as the next
// block's corner.  Only the top arm comes from another thread block.
// Levels go to (B, nb, N, N) raster blocks, modes to (B, nb).
//
// The hand-off (wavefront_sync.cuh): self-announcing words, no flag and
// no fence.  The work buffer holds, after the ticket, an edge buffer of
// one line of `width` words under each block row of each plane but the
// last, zeroed by the wrapper in the same allocation as the ticket.  The
// N threads of a block's bottom row store their pixel + 1 into their
// words with st.relaxed.gpu, first of the block's stores; lanes t < N of
// warp 0 of the row below each poll their own word with ld.relaxed.gpu
// (32 polls back to back, then __nanosleep backoff, __trap() after a
// second) and take the pixel from it, so one L2 round trip both waits
// and reads.  In the 35-mode sweep without RDOQ they also load the next
// block's words while this block computes, so a row that trails the row
// above finds them written and polls not at all (about 5 % off the search
// at N=8 on an H100 80GB HBM3 at 700 W; no gain elsewhere,
// tools/wavefront_variants.py).  Each word is written once a launch (a
// recon pixel is coded once), after the zeroing, so "nonzero" is all the
// tag it needs: a stale word cannot exist within a launch, and each word
// carries its own data, so no release or acquire ordering is needed.
// The recon, levels and modes are stored after the publish; nothing in
// the launch reads them, and the kernel's end makes them visible.
// Shared memory needs no
// barrier between blocks: every shared read of a block comes before the
// first barrier of its tail, every shared write of the next block after
// the last one.
//
// Thread blocks: the fixed and pair bodies N*N threads, one a pixel; the
// search body max(N*N, 16N), so that 16 (32 at N = 32) groups of N
// lanes sweep the 35 modes in 3 (2) passes (mode_sweep.cuh); threads
// beyond N*N mirror pixel t % N*N in the tail, writing the same values.
// Smoothing adds one barrier a block; RDOQ (rdoq_tail.cuh) adds four
// block barriers (at N = 32 also a barrier of the four warps that hold
// its runs of 16), warp reductions, and serial float32 loops of up to 32
// (within a run) and 63 (across runs) adds, in lanes of different warps,
// to every block of the dependency chain; each thread loads its RDOQ
// table entries once, before the block loop, into registers.
//
// What bounds it on the card: the dependency chain, not bytes or
// operations.  A plane is nby + nbx - 1 block latencies long (374 at
// 1080p, N = 8), plus one hand-off between thread blocks for each of
// the nby - 1 rows; a batch of planes, or more rows than resident
// thread blocks, adds little to that while the SMs have room.  What a
// body or the RDOQ tail adds to a block's latency adds to the whole
// chain.

#include <type_traits>

#include "dc_planar.cuh"
#include "intra_smooth.cuh"
#include "mode_sweep.cuh"   // also defines c_tables, the constant table
#include "rdoq_tail.cuh"
#include "wavefront_sync.cuh"

// The body's shape: one fixed mode (mode_set "dc" or "planar"), the pair
// DC / planar ("dc_planar"), or the 35-mode sweep ("all").
constexpr int kBodyFixed = 0, kBodyPair = 1, kBodySweep = 2;

template <int N, int BODY>
__host__ __device__ constexpr int wavefront_threads() {
  return BODY == kBodySweep ? (N * N > 16 * N ? N * N : 16 * N) : N * N;
}

// The body's runtime switches: the fixed body's mode (0 planar, 1 DC),
// the modes that read filtered references (bit m: mode m; 0 without
// smoothing) and the strong filter's threshold (N = 32).
struct BodyArgs {
  int fixed_mode;
  int strong_thresh;
  unsigned long long filter_mask;
};

template <int N, int BODY, int COST, bool RDOQ>
__global__ void __launch_bounds__(wavefront_threads<N, BODY>())
wavefront_kernel(const int* __restrict__ planes, int* recon, int batch,
                 int height, int width, int nby, int nbx, int t_offset,
                 QpScalars q, BodyArgs body, RdoqArgs rq,
                 int* __restrict__ levels, int* __restrict__ modes,
                 int* ticket, int* edge) {
  constexpr int NN = N * N;
  constexpr int R = 2 * N + 1;          // one reference arm, corner at 0
  constexpr int THREADS = wavefront_threads<N, BODY>();
  // the pair by energy keeps K4's body (dc_planar.cuh), 16-43 % faster
  // than the sweep's pair by energy at N 4-32 on an H100 80GB HBM3 at
  // 700 W (tools/wavefront_body_times.py --pair-by-sweep); the other
  // decisions sweep
  constexpr bool SWEEP =
      BODY == kBodySweep || (BODY == kBodyPair && COST != kCostEnergy);
  using Scratch =
      typename std::conditional<SWEEP, SweepScratch<N, THREADS>, int>::type;
  // the 35-mode sweep's blocks are long enough for the next block's words
  // to land while they compute: without RDOQ it loads them ahead (5 % off
  // the search at N=8; about 1 % slower under RDOQ and in the shorter
  // bodies, tools/wavefront_variants.py)
  constexpr bool PREFETCH = BODY == kBodySweep && !RDOQ;

  // the tail's scratch, padded for RDOQ's runs
  constexpr int SCR = RDOQ ? rdoq_scratch_words<N>() : NN;

  __shared__ int s_t[NN];               // T[i][k] at i*N + k
  __shared__ int s_tt[NN];              // T[j][k] at k*N + j
  __shared__ int s_x[SCR];
  __shared__ int s_a[SCR];
  __shared__ int s_b[SCR];
  __shared__ int s_ref[2 * R];          // top arm | left arm
  __shared__ int s_fref[N > 4 ? 2 * R : 1];   // the same, filtered
  __shared__ int s_row;
  __shared__ Scratch s_sweep;

  // warp 0, which reads the top arm
  constexpr unsigned kWarp0 = THREADS >= 32 ? 0xffffffffu : (1u << THREADS) - 1u;
  const int t = threadIdx.x;
  const int p = t % NN;                 // pixel (threads >= N*N mirror)
  const int i = p / N, j = p % N;
  s_t[p] = c_tables[t_offset + p];
  s_tt[p] = c_tables[t_offset + j * N + i];
  // the RDOQ tail's invariants, once, for every block of every row
  const RdoqRegs<N> rr = RDOQ ? rdoq_regs<N>(rq, p) : RdoqRegs<N>{};

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
    // the edge lines this row reads (by > 0) and writes (by < nby - 1)
    const size_t line = (size_t)f * (nby - 1) + by;
    const int* above = by > 0 ? edge + (line - 1) * width : nullptr;
    int* below = by < nby - 1 ? edge + line * width : nullptr;
    const int y0 = by * N;
    int corner = 0;     // thread 0: the previous block's T[N]
    int ahead = 0;      // lanes t < N: block bx + 1's word, if written
    int right = 0;      // threads (i, N-1): the previous block's pixel

#pragma unroll 1
    for (int bx = 0; bx < nbx; ++bx) {
      const int x0 = bx * N;
      const int x = plane[(size_t)(y0 + i) * width + x0 + j];

      // --- references (availability rule; extensions never read) -----
      if (t < 32) {                     // warp 0: the top arm
        int v = q.boundary;
        if (by > 0 && t < N) {          // its own word, then the next's
          v = ahead ? ahead - 1 : poll_edge(above + x0 + t);
          if constexpr (PREFETCH)
            ahead = bx + 1 < nbx ? load_relaxed(above + x0 + N + t) : 0;
        }
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
      if constexpr (SWEEP) s_sweep.x[i * (N + 1) + j] = x;
      __syncthreads();

      // --- luma smoothing: the filtered references, where a mode reads
      // them (a uniform branch) -----------------------------------------
      const int* fref = s_ref;          // the modes of filter_mask
      const int* pref = s_ref;          // planar
      if constexpr (N > 4) {
        if (body.filter_mask != 0ull) {
          if (t < 2 * R)
            s_fref[t] = smoothed_ref<N>(s_ref, t, body.strong_thresh);
          __syncthreads();
          fref = s_fref;
          if (body.filter_mask & 1ull) pref = s_fref;
        }
      }

      // --- the body's decision -----------------------------------------
      int pred, mode;
      if constexpr (BODY == kBodyFixed) {
        mode = body.fixed_mode;
        pred = mode == 1 ? dc_value<N>(s_ref) : planar_pixel<N>(pref, i, j);
      } else if constexpr (!SWEEP) {
        bool use_dc;
        pred = dc_planar_energy<N, THREADS>(s_ref, pref, x, i, j, s_a, s_b,
                                            use_dc);
        mode = use_dc ? 1 : 0;
      } else {
        // Two call sites: without smoothing the sweep reads s_ref alone,
        // which keeps the unsmoothed passes as fast as before the mask
        // (a runtime choice of array in them cost the N=8 search 28 %
        // of its passes; PERF.md).
        constexpr int M = BODY == kBodySweep ? 35 : 2;
        mode = body.filter_mask
                   ? mode_sweep<N, THREADS, THREADS, COST, M>(
                         s_ref, fref, body.filter_mask, s_sweep, t, q.max_pix)
                   : mode_sweep<N, THREADS, THREADS, COST, M>(
                         s_ref, s_ref, 0ull, s_sweep, t, q.max_pix);
        pred = predict_pixel<N>(s_ref, pref, s_sweep.mref, mode, i, j);
      }

      // --- transform, quantize (RDOQ), reconstruct (shared tail) --------
      int level, r;
      if constexpr (RDOQ) {
        auto rdoq = [&](int coeff, int lev) {
          return rdoq_level<N, THREADS>(
              coeff, lev, t, mode, rq, rr, q, reinterpret_cast<float*>(s_x),
              reinterpret_cast<float*>(s_a), reinterpret_cast<float*>(s_b));
        };
        transform_quant_recon<N>(s_t, s_tt, s_x, s_a, s_b, i, j, x - pred,
                                 pred, q, level, r, rdoq);
      } else {
        transform_quant_recon<N>(s_t, s_tt, s_x, s_a, s_b, i, j, x - pred,
                                 pred, q, level, r);
      }

      // --- the hand-off, then the outputs -------------------------------
      if (t < NN) {
        if (i == N - 1 && below != nullptr)   // the row below reads these N
          store_relaxed(below + x0 + j, r + 1);
        rec[(size_t)(y0 + i) * width + x0 + j] = r;
        if (j == N - 1) right = r;
        const size_t g = (size_t)f * nby * nbx + (size_t)by * nbx + bx;
        levels[g * NN + p] = level;
        if (p == 0) modes[g] = mode;
      }
    }
  }
}

struct Launch {
  const int* planes;
  int batch, height, width, t_offset;
  QpScalars q;
  BodyArgs body;
  RdoqArgs rq;
  int *recon, *levels, *modes, *work, *grids;
  int max_grid;
  cudaStream_t stream;
};

// One persistent launch on the call's stream; `grids` gets the grids
// launched.
template <int N, int BODY, int COST, bool RDOQ>
static int launch(const Launch& a) {
  constexpr int threads = wavefront_threads<N, BODY>();
  const int nby = a.height / N, nbx = a.width / N;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, wavefront_kernel<N, BODY, COST, RDOQ>, threads, 0);
  if (err != cudaSuccess) return (int)err;
  const int rows = a.batch * nby;
  const int resident = per_sm * sms > 0 ? per_sm * sms : 1;
  int grid = rows < resident ? rows : resident;
  if (a.max_grid > 0 && grid > a.max_grid) grid = a.max_grid;
  wavefront_kernel<N, BODY, COST, RDOQ><<<grid, threads, 0, a.stream>>>(
      a.planes, a.recon, a.batch, a.height, a.width, nby, nbx, a.t_offset,
      a.q, a.body, a.rq, a.levels, a.modes, a.work, a.work + 1);
  err = cudaGetLastError();
  if (err == cudaSuccess) *a.grids += 1;
  return (int)err;
}

// RDOQ is a template switch, so that the kernels without it keep no
// registers for it.
template <int N, int BODY, int COST>
static int run(const Launch& a) {
  return a.rq.scan >= 0 ? launch<N, BODY, COST, true>(a)
                        : launch<N, BODY, COST, false>(a);
}

template <int N, int BODY>
static int run_cost(int cost, const Launch& a) {
  switch (cost) {
    case kCostEnergy: return run<N, BODY, kCostEnergy>(a);
    case kCostSad: return run<N, BODY, kCostSad>(a);
    case kCostSatd: return run<N, BODY, kCostSatd>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int N>
static int run_body(int body, int cost, const Launch& a) {
  switch (body) {
    case kBodyFixed: return run<N, kBodyFixed, kCostEnergy>(a);  // no cost
    case kBodyPair: return run_cost<N, kBodyPair>(cost, a);
    case kBodySweep: return run_cost<N, kBodySweep>(cost, a);
    default: return (int)cudaErrorInvalidValue;
  }
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
// planes.  body 0 codes one fixed mode (fixed_mode 0 planar, 1 DC), 1
// decides DC / planar, 2 searches the 35 modes; cost 0 energy, 1 SAD, 2
// SATD (not read by body 0).  filter_mask bit m set: mode m reads the
// smoothed references (luma smoothing; 0 at n = 4); strong_thresh is
// 1 << (bit_depth - 5), read at n = 32 only.  rdoq_scan -1 codes the
// deadzone levels; 0 / 1 / 2 / 3 re-decides them by RDOQ in the
// diagonal, horizontal, vertical or per-mode scan, with `rdoq_tables`
// on the device (rdoq_tail.cuh) and `rdoq_scalars` the 7 host float32
// scalars of RdoqArgs in their order.  `recon` (batch, height, width) is
// written whole; levels (batch, nb, n, n) and modes (batch, nb) in
// raster block order.  `work` is 1 + batch * (height / n - 1) * width
// zeroed ints on the device: the ticket counter, then the edge buffer
// (a line of width words under each block row of each plane but the
// last).  Launches one grid of at most max_grid thread blocks (0: the
// occupancy limit) on `stream` without synchronising and adds the grids
// it launched to *grids; returns the CUDA error of the launch, or
// cudaSuccess.
extern "C" int nhv_wavefront_encode(
    const int* planes, int batch, int height, int width, int n, int body,
    int cost, int fixed_mode, int use_dst, int mf, int qshift, int qoffset,
    int dscale, int dq_shift, int max_pix, int boundary, int strong_thresh,
    unsigned long long filter_mask, int rdoq_scan, const int* rdoq_tables,
    const float* rdoq_scalars, int* recon, int* levels, int* modes,
    int* work, int* grids, int max_grid, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || batch < 0 || height % n != 0 || width % n != 0 ||
      body < kBodyFixed || body > kBodySweep || cost < kCostEnergy ||
      cost > kCostSatd || (fixed_mode != 0 && fixed_mode != 1) ||
      (use_dst && n != 4) || (filter_mask >> 35) != 0 ||
      (n == 4 && filter_mask != 0) || rdoq_scan < -1 || rdoq_scan > 3 ||
      (rdoq_scan >= 0 && (rdoq_tables == nullptr || rdoq_scalars == nullptr)) ||
      max_grid < 0)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || height == 0 || width == 0) return (int)cudaSuccess;
  Launch a;
  a.planes = planes;
  a.batch = batch;
  a.height = height;
  a.width = width;
  a.t_offset = transform_offset(n, use_dst);
  a.q = QpScalars{mf, qshift, qoffset, dscale, dq_shift, max_pix, boundary};
  // only the bits of the modes this body can pick
  const unsigned long long live =
      body == kBodyFixed ? 1ull << fixed_mode
                         : body == kBodyPair ? 3ull : (1ull << 35) - 1;
  a.body = BodyArgs{fixed_mode, strong_thresh, filter_mask & live};
  a.rq = RdoqArgs{rdoq_tables, 0, 0, 0, 0, 0, 0, 0, rdoq_scan};
  if (rdoq_scan >= 0) {
    const float* f = rdoq_scalars;
    a.rq = RdoqArgs{rdoq_tables, f[0], f[1], f[2], f[3], f[4], f[5], f[6],
                    rdoq_scan};
  }
  a.recon = recon;
  a.levels = levels;
  a.modes = modes;
  a.work = work;
  a.grids = grids;
  a.max_grid = max_grid;
  a.stream = (cudaStream_t)stream;
  switch (n) {
    case 4: return run_body<4>(body, cost, a);
    case 8: return run_body<8>(body, cost, a);
    case 16: return run_body<16>(body, cost, a);
    case 32: return run_body<32>(body, cost, a);
    default: return (int)cudaErrorInvalidValue;
  }
}
