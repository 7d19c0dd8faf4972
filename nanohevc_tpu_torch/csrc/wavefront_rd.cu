// The closed loop under decision="rd": a batch of planes coded in one
// persistent cooperative launch, for Hopper (sm_90a).
//
// Replaces the RD branch of the JAX package's closed-loop XLA scan
// (nanohevc_tpu/models/wavefront.py, encode_planes_closed_loop: `step`
// with rd, the jax.lax.scan vmapped over frames; no Pallas kernel),
// whose decision is nanohevc_tpu/models/all_intra.py's decide_modes with
// decision="rd" and exact MPM bits.  Bit for bit the port's plain loop,
// models/wavefront.py::_encode_planes_rd, which holds JAX's batches:
// for each frame and each anti-diagonal d in order, all nby slots of
// JAX's skewed layout (slot by holds block (by, d - by); the slots off
// the plane hold a neighbouring row's block or the pad, and read their
// references from the skewed buffers too):
//   A. every candidate of every slot (DC and planar; with the 35-mode
//      set also the 33 angular modes, smoothed where the filter mask
//      says) through forward transform, deadzone quantizer, dequantizer,
//      inverse transform and clip; its SSE (an exact integer sum rounded
//      once to float32), its diag-packed levels, and its bins counted
//      into the frame's adaptive-model batch: the pair (nby x 2 rows)
//      and the angular modes (nby x 33 rows) are two batches, priced
//      apart, as JAX's two rd(...) calls are;
//   B. each slot prices its frame's batches (rate_model.cuh), costs
//      every candidate SSE + lambda * bits + lambda * MPM bits (the MPM
//      list from the previous diagonal's modes of the slot and of the
//      slot above, DC where unavailable), takes the argmin (DC unless
//      planar costs strictly less; of the 35 modes the lowest index on a
//      tie), codes the chosen block (RDOQ in `scan` order when set:
//      rdoq_tail.cuh) and writes recon, levels, mode and the skewed
//      buffers (the bottom rows s_bot and right columns r_sp of JAX's
//      _skew_buffers, exactly: the statistics depend on what the
//      off-plane slots read).
// Lambda of the decision is unscaled (_rd_lambda(qp, 1.0));
// rd_lambda_scale reaches RDOQ's lambda only.
//
// Design.  The statistics of a diagonal are a reduction over all its
// slots, so the row tickets and ready flags of wavefront.cu cannot
// carry this schedule: it is diagonal-synchronous, as JAX's scan is.
// One cooperative launch (cudaLaunchCooperativeKernel, the grid at the
// occupancy limit times the SM count, capped by the largest phase's
// work) walks the diagonals; each is phase A over the work items
// (frame, slot, candidate) of every frame, a grid barrier, phase B over
// (frame, slot), a grid barrier.  A thread block serves one item at a
// time with max(N*N, 32) threads, one a pixel (threads beyond N*N
// mirror pixel t % N*N and count nothing).  Phase A leaves in device
// memory each candidate's packed levels, SSE and last significant
// position, and each slot's references (phase B writes the buffers
// they were read from); its bin counts go through shared-memory sums,
// then one atomicAdd per counter into the frame's count vector for
// this diagonal.  There are two count vectors a frame and batch, by the
// parity of d: phase A of d zeroes those of d + 1, which phase B of
// d - 1 read before the last barrier.  The modes the MPM lists read are
// double-buffered by parity alike.  Phase B's thread blocks each price
// the counts again (45 contexts at most; every block computes the same
// bits, which saves a barrier), then one warp a candidate sums its bits.
//
// The grid barrier is a monotonic arrival counter: thread 0 of each
// block fences (release), adds one, and spins on ld.acquire.gpu until
// the count reaches the barrier's target; data written by other thread
// blocks in an earlier phase is read through L2 (__ldcg).  A wait that
// lasts a second ends in __trap(), so a fault is a CUDA error, not a
// hang.  If the grid cannot be co-resident the launch returns an error.
//
// What bounds it on the card: the chain of 2 (nby + nbx - 1) barriers
// and the latency of a phase's longest item, not bytes or operations
// (chip_smoke.py's 6h times an empty body with the same grid and
// barriers beside it).  Each candidate is a few thousand integer
// operations a pixel at most, far from the card's rate.

#include "intra_smooth.cuh"
#include "mode_sweep.cuh"   // also defines c_tables, the constant table
#include "rate_model.cuh"
#include "rdoq_tail.cuh"
#include "wavefront_sync.cuh"

template <int N>
__host__ __device__ constexpr int rd_threads() {
  return N * N > 32 ? N * N : 32;
}

// Warps that sum candidates' bits in phase B (N = 32: four, to keep
// the thread block's static shared memory under 48 KB).
template <int N>
__host__ __device__ constexpr int rd_bit_warps() {
  return N == 32 ? 4 : rd_threads<N>() / 32;
}

__host__ __device__ constexpr int rd_counters(int n) {
  return 70 + 2 * (n == 4 ? 3 : n == 8 ? 5 : n == 16 ? 7 : 9);
}

// The work buffer's layout (int32 words, zeroed by the caller): the
// barrier's arrival count; the count vectors (frame, parity of d,
// batch: pair / angular, KC counters); the slots' modes (parity, frame,
// slot); the skewed buffers s_bot (frame, nby, WD) and r_sp (frame,
// ndiag + nby, WD); then phase A's scratch: each slot's 4N+2 references,
// each candidate's SSE (float32 bits), last significant position and
// N*N packed levels.
struct RdLayout {
  long long counts, prev, s_bot, r_sp, refs, sse, last, lev, total;
  int wd, nc, kc;
  __host__ __device__ RdLayout(int n, int batch, int nby, int nbx,
                               int all_modes) {
    const long long b = batch, ndiag = nby + nbx - 1;
    nc = all_modes ? 35 : 2;
    kc = rd_counters(n);
    wd = (int)((ndiag + 2) * n + 2);
    counts = 1;
    prev = counts + b * 4 * kc;
    s_bot = prev + 2 * b * nby;
    r_sp = s_bot + b * nby * wd;
    refs = r_sp + b * (ndiag + nby) * wd;
    sse = refs + b * nby * (4 * n + 2);
    last = sse + b * nby * nc;
    lev = last + b * nby * nc;
    total = lev + b * nby * nc * n * n;
  }
};

struct RdArgs {
  const int* planes;
  int batch, height, width, nby, nbx, ndiag, t_offset, all_modes;
  QpScalars q;
  int strong_thresh;
  unsigned long long filter_mask;
  RdoqArgs rq;          // tables always set (diagonal scan at 4 N*N)
  float lam;
  RateConsts rc;
  int *recon, *levels, *modes, *work;
};

template <int N>
struct RdShared {
  static constexpr int NN = N * N, R = 2 * N + 1, T = rd_threads<N>();
  int t[NN];            // T[i][k] at i*N + k
  int tt[NN];           // T[j][k] at k*N + j
  int x[NN], a[NN], b[NN];
  int ref[2 * R];       // top arm | left arm
  int fref[N > 4 ? 2 * R : 1];
  int proj[3 * N + 1];
  int cnt[RateDims<NN>::KC];
  int red[T / 32];
  long long sse[T / 32];
  Prices<RateDims<NN>::M> price[2];
  float pref[RateDims<NN>::M];
  float per[rd_bit_warps<N>()][NN + NN / 32];
  float cost[35];
  int mode;
};

// Arrive at the grid barrier and wait for every thread block.
__device__ __forceinline__ void grid_barrier(unsigned* count,
                                             unsigned& target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    target += gridDim.x;
    __threadfence();
    atomicAdd(count, 1u);
    const int* c = reinterpret_cast<const int*>(count);
    if ((unsigned)load_acquire(c) < target) {
      const unsigned long long t0 = global_ns();
      unsigned ns = 16;
      while ((unsigned)load_acquire(c) < target) {
        __nanosleep(ns);
        if (ns < 256) ns <<= 1;
        if (global_ns() - t0 > 1000000000ull) __trap();   // a second
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// The prediction of pixel (i, j) under `mode` from s.ref (written before
// a barrier): DC from the raw references, planar and the angular modes
// from the filtered ones where `filter_mask` sets their bit.  Every
// thread must call it (it holds barriers).
template <int N>
__device__ __forceinline__ int rd_predict(RdShared<N>& s, int mode, int t,
                                          int i, int j,
                                          unsigned long long filter_mask,
                                          int strong_thresh) {
  constexpr int R = 2 * N + 1;
  const int* fref = s.ref;
  if constexpr (N > 4) {
    if (filter_mask != 0ull) {
      if (t < 2 * R) s.fref[t] = smoothed_ref<N>(s.ref, t, strong_thresh);
      __syncthreads();
      fref = s.fref;
    }
  }
  if (mode == 1) return dc_value<N>(s.ref);
  if (mode == 0)
    return planar_pixel<N>((filter_mask & 1ull) ? fref : s.ref, i, j);
  const int* src = (filter_mask >> mode) & 1ull ? fref : s.ref;
  // The projection array; its corner (sample N) is the top arm's, as
  // ops.angular_tables gives it (the off-plane slots' two corners may
  // differ).
  if (t <= 3 * N) s.proj[t] = t == N ? src[0] : projection_sample<N>(src, mode, t);
  __syncthreads();
  return angular_pixel<N>(s.proj, mode, i, j);
}

// The slot's block pixel (i, j): JAX's skewed blocks, skewed[d, slot] =
// the block-padded raster's flat block slot * ndiag + d (0 in the pad).
__device__ __forceinline__ int skewed_pixel(const RdArgs& a, int n, int f,
                                            int slot, int d, int i, int j) {
  const int k = slot * a.ndiag + d;
  const int r = k / (a.ndiag + 1), c = k % (a.ndiag + 1);
  if (c >= a.nbx) return 0;
  return __ldg(a.planes + (size_t)f * a.height * a.width +
               (size_t)(r * n + i) * a.width + c * n + j);
}

template <int N>
__device__ void phase_a(const RdArgs& a, const RdLayout& lay, RdShared<N>& s,
                        int d, int item) {
  constexpr int NN = N * N, R = 2 * N + 1, T = rd_threads<N>();
  using D = RateDims<NN>;
  const int t = threadIdx.x, p = t % NN, i = p / N, j = p % N;
  const int cand = item % lay.nc, slot = (item / lay.nc) % a.nby;
  const int f = item / (lay.nc * a.nby);
  const int bx = d - slot;
  int* w = a.work;
  const int x = skewed_pixel(a, N, f, slot, d, i, j);

  // references (_read_refs_skewed)
  if (t < 2 * R) {
    const bool edge = slot == 0 || bx == 0;
    int v = a.q.boundary;
    if (t < R) {                        // top: bottom rows of the slot above
      if (slot > 0 && !(t == 0 && edge))
        v = __ldcg(w + lay.s_bot + ((size_t)f * a.nby + slot - 1) * lay.wd +
                   d * N + t);
    } else if (bx != 0 && !(t == R && edge)) {   // left: the right columns
      v = __ldcg(w + lay.r_sp +
                 ((size_t)f * (a.ndiag + a.nby) + d + a.nby - 1 - slot) *
                     lay.wd +
                 d * N + t - R);
    }
    s.ref[t] = v;
    if (cand == 0) w[lay.refs + ((size_t)f * a.nby + slot) * 2 * R + t] = v;
  }
  for (int k = t; k < D::KC; k += T) s.cnt[k] = 0;
  __syncthreads();

  const int pred = rd_predict<N>(s, cand, t, i, j, a.filter_mask,
                                 a.strong_thresh);
  int level, rec;
  transform_quant_recon<N>(s.t, s.tt, s.x, s.a, s.b, i, j, x - pred, pred,
                           a.q, level, rec);
  // s.x is free again (its last read is the forward transform's): the
  // diag-packed row
  const int kpos = __ldg(a.rq.tables + 4 * NN + p);
  s.x[kpos] = level;
  long long e = t < NN ? (long long)(x - rec) * (x - rec) : 0;
#pragma unroll
  for (int h = 16; h > 0; h >>= 1) e += __shfl_xor_sync(0xffffffffu, e, h);
  if ((t & 31) == 0) s.sse[t >> 5] = e;
  __syncthreads();

  const int lv = s.x[p];                // packed position p
  const int mag = lv < 0 ? -lv : lv;
  const int last = block_max<T>(mag > 0 ? p : -1, t, s.red);
  const size_t row = item;              // (frame, slot, candidate)
  if (t < NN) w[lay.lev + row * NN + t] = lv;
  if (t == 0) {
    long long sse = 0;
#pragma unroll
    for (int k = 0; k < T / 32; ++k) sse += s.sse[k];
    w[lay.sse + row] = __float_as_int(__ll2float_rn(sse));
    w[lay.last + row] = last;
  }
  count_row<NN, T>(mag, last, t, s.cnt);
  __syncthreads();
  int* counts = w + lay.counts +
                (((size_t)f * 2 + (d & 1)) * 2 + (cand >= 2)) * D::KC;
  for (int k = t; k < D::KC; k += T)
    if (s.cnt[k]) atomicAdd(counts + k, s.cnt[k]);
  __syncthreads();
}

// The MPM signalling bits of `mode` with left / above neighbour modes
// am / bm (ops.mode_rate.mpm_mode_bits).
__device__ __forceinline__ float mpm_bits(int mode, int am, int bm) {
  int m0, m1, m2;
  if (am == bm) {
    if (am < 2) {
      m0 = 0, m1 = 1, m2 = 26;
    } else {
      m0 = am, m1 = 2 + (am + 29) % 32, m2 = 2 + (am - 1) % 32;
    }
  } else {
    m0 = am, m1 = bm;
    m2 = am != 0 && bm != 0 ? 0 : am + bm < 2 ? 26 : 1;
  }
  return mode == m0 ? 2.0f : mode == m1 || mode == m2 ? 3.0f : 6.0f;
}

template <int N>
__device__ void phase_b(const RdArgs& a, const RdLayout& lay, RdShared<N>& s,
                        int d, int item) {
  constexpr int NN = N * N, R = 2 * N + 1, T = rd_threads<N>();
  constexpr int BW = rd_bit_warps<N>();
  using D = RateDims<NN>;
  const int t = threadIdx.x, p = t % NN, i = p / N, j = p % N;
  const int slot = item % a.nby, f = item / a.nby;
  const int bx = d - slot;
  int* w = a.work;
  const int* counts =
      w + lay.counts + ((size_t)f * 2 + (d & 1)) * 2 * D::KC;

  price_batch<NN, T>(counts, s.price[0], s.pref, t, a.rc);
  if (a.all_modes) price_batch<NN, T>(counts + D::KC, s.price[1], s.pref, t,
                                      a.rc);

  // the slot's left and above neighbours in the previous diagonal
  const int* prev = w + lay.prev + (size_t)((d + 1) & 1) * a.batch * a.nby +
                    (size_t)f * a.nby;
  const int am = slot == d ? 1 : __ldcg(prev + slot);
  const int bm = slot == 0 ? 1 : __ldcg(prev + slot - 1);
  const int warp = t >> 5, lane = t & 31;
  if (warp < BW) {
    for (int c = warp; c < lay.nc; c += BW) {
      const size_t row = (size_t)item * lay.nc + c;
      const float bits =
          row_bits<NN>(w + lay.lev + row * NN, __ldcg(w + lay.last + row),
                       s.price[c >= 2], s.per[warp], lane);
      if (lane == 0) {
        const float sse = __int_as_float(__ldcg(w + lay.sse + row));
        const float cost = __fadd_rn(sse, __fmul_rn(a.lam, bits));
        s.cost[c] = __fadd_rn(cost, __fmul_rn(a.lam, mpm_bits(c, am, bm)));
      }
    }
  }
  __syncthreads();
  if (t == 0) {
    int best = s.cost[1] <= s.cost[0] ? 1 : 0;   // the pair: ties to DC
    if (a.all_modes) {                            // lowest index on a tie
      best = 0;
      for (int c = 1; c < 35; ++c)
        if (s.cost[c] < s.cost[best]) best = c;
    }
    s.mode = best;
    w[lay.prev + (size_t)(d & 1) * a.batch * a.nby + item] = best;
  }
  __syncthreads();
  const int mode = s.mode;
  if (bx < 0 || bx >= a.nbx) return;    // off the plane: the mode only

  // code the chosen block from phase A's references
  if (t < 2 * R) s.ref[t] = __ldcg(w + lay.refs + (size_t)item * 2 * R + t);
  const int x = skewed_pixel(a, N, f, slot, d, i, j);
  __syncthreads();
  const int pred = rd_predict<N>(s, mode, t, i, j, a.filter_mask,
                                 a.strong_thresh);
  int level, rec;
  if (a.rq.scan >= 0) {                 // uniform over the launch
    auto rdoq = [&](int coeff, int lev) {
      return rdoq_level<N, T>(coeff, lev, p, t, mode, a.rq, a.q,
                              reinterpret_cast<float*>(s.x),
                              reinterpret_cast<float*>(s.a),
                              reinterpret_cast<float*>(s.b));
    };
    transform_quant_recon<N>(s.t, s.tt, s.x, s.a, s.b, i, j, x - pred, pred,
                             a.q, level, rec, rdoq);
  } else {
    transform_quant_recon<N>(s.t, s.tt, s.x, s.a, s.b, i, j, x - pred, pred,
                             a.q, level, rec);
  }
  if (t < NN) {
    const size_t plane = (size_t)f * a.height * a.width;
    a.recon[plane + (size_t)(slot * N + i) * a.width + bx * N + j] = rec;
    const size_t g = (size_t)f * a.nby * a.nbx + (size_t)slot * a.nbx + bx;
    a.levels[g * NN + p] = level;
    if (p == 0) a.modes[g] = mode;
    // the skewed buffers (_write_bufs_skewed), from column d*N + N + 1
    const int c0 = d * N + N + 1;
    int* sb = w + lay.s_bot + ((size_t)f * a.nby + slot) * lay.wd + c0;
    int* rs = w + lay.r_sp +
              ((size_t)f * (a.ndiag + a.nby) + d + a.nby - slot) * lay.wd + c0;
    if (i == N - 1) sb[j] = rec;
    if (j == N - 1) rs[i] = rec;
    if (p == NN - 1) {                  // the last pixel's N-wide tails
      for (int k = 0; k < N; ++k) {
        if (bx == a.nbx - 1) sb[N + k] = rec;
        if (slot == a.nby - 1) rs[N + k] = rec;
      }
    }
  }
  __syncthreads();
}

template <int N>
__global__ void __launch_bounds__(rd_threads<N>())
wavefront_rd_kernel(RdArgs a) {
  constexpr int NN = N * N, T = rd_threads<N>();
  using D = RateDims<NN>;
  __shared__ RdShared<N> s;
  const int t = threadIdx.x, p = t % NN, i = p / N, j = p % N;
  const RdLayout lay(N, a.batch, a.nby, a.nbx, a.all_modes);
  unsigned* count = reinterpret_cast<unsigned*>(a.work);
  unsigned target = 0;
  s.t[p] = c_tables[a.t_offset + p];
  s.tt[p] = c_tables[a.t_offset + j * N + i];
  // the modes before diagonal 0 (parity 1): DC; read in phase B of d = 0
  const int slots = a.batch * a.nby;
  for (int k = blockIdx.x * T + t; k < slots; k += gridDim.x * T)
    a.work[lay.prev + slots + k] = 1;
  const int items_a = slots * lay.nc;
#pragma unroll 1
  for (int d = 0; d < a.ndiag; ++d) {
    if (blockIdx.x == 0) {              // the counts of d + 1 (read in d - 1)
      for (int k = t; k < a.batch * 2 * D::KC; k += T) {
        const int f = k / (2 * D::KC), r = k % (2 * D::KC);
        a.work[lay.counts + ((size_t)f * 2 + ((d + 1) & 1)) * 2 * D::KC + r] =
            0;
      }
    }
#pragma unroll 1
    for (int item = blockIdx.x; item < items_a; item += gridDim.x)
      phase_a<N>(a, lay, s, d, item);
    grid_barrier(count, target);
#pragma unroll 1
    for (int item = blockIdx.x; item < slots; item += gridDim.x)
      phase_b<N>(a, lay, s, d, item);
    grid_barrier(count, target);
  }
}

// The encoder's synchronisation alone: its block size through the same
// 2 * ndiag grid barriers with an empty body (chip_smoke.py's 6h times
// it on the encoder's grid beside the kernel).
template <int N>
__global__ void __launch_bounds__(rd_threads<N>())
rd_barriers_kernel(unsigned* count, int ndiag) {
  unsigned target = 0;
#pragma unroll 1
  for (int d = 0; d < 2 * ndiag; ++d) grid_barrier(count, target);
}

// One cooperative launch of `kernel` (wavefront_rd_kernel<N> or
// rd_barriers_kernel<N>) on the encoder's grid: its occupancy limit times
// the SM count, capped by `items`, the largest phase's work.  Adds 1 to
// info[0] and sets info[1] to the grid's thread blocks on success.
template <int N>
static int launch_grid(const void* kernel, void** params, long long items,
                       int* info, cudaStream_t stream) {
  constexpr int T = rd_threads<N>();
  int device = 0, sms = 0, per_sm = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, wavefront_rd_kernel<N>, T, 0);
  if (err != cudaSuccess) return (int)err;
  if (!coop || per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  long long grid = (long long)per_sm * sms;
  if (grid > items) grid = items;
  err = cudaLaunchCooperativeKernel(kernel, dim3((unsigned)grid), dim3(T),
                                    params, 0, stream);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err == cudaSuccess) {
    info[0] += 1;
    info[1] = (int)grid;
  }
  return (int)err;
}

template <int N>
static int run(const RdArgs& args, int* info, cudaStream_t stream) {
  RdArgs a = args;
  void* params[] = {&a};
  return launch_grid<N>((const void*)wavefront_rd_kernel<N>, params,
                        (long long)a.batch * a.nby * (a.all_modes ? 35 : 2),
                        info, stream);
}

template <int N>
static int run_barriers(unsigned* count, int ndiag, long long items,
                        int* info, cudaStream_t stream) {
  void* params[] = {&count, &ndiag};
  return launch_grid<N>((const void*)rd_barriers_kernel<N>, params, items,
                        info, stream);
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

// The int32 words of the work buffer `nhv_wavefront_rd` takes for this
// call (RdLayout), or -1 for a geometry it does not take.
extern "C" int nhv_wavefront_rd_work_ints(int batch, int height, int width,
                                          int n, int all_modes) {
  if ((n != 4 && n != 8 && n != 16 && n != 32) || batch < 0 || height <= 0 ||
      width <= 0 || height % n != 0 || width % n != 0)
    return -1;
  const RdLayout lay(n, batch, height / n, width / n, all_modes);
  return lay.total < (1LL << 31) ? (int)lay.total : -1;
}

// Closed-loop encode under decision="rd" of `batch` block-aligned
// (height, width) int32 planes: all_modes 0 decides DC / planar, 1 the
// 35 modes.  filter_mask bit m set: mode m reads the smoothed references
// (luma smoothing; 0 at n = 4); strong_thresh is 1 << (bit_depth - 5),
// read at n = 32 only.  `tables` are kernels/wavefront.py's rdoq_tables
// on the device (the diagonal scan is read always); rdoq_scan -1 codes
// the deadzone levels, 0 / 1 / 2 / 3 re-decides them by RDOQ in the
// diagonal, horizontal, vertical or per-mode scan with the 7 host
// float32 `rdoq_scalars`.  lam is the decision's float32 lambda,
// log_gamma and ln2 the rate model's float32 constants.  `recon`
// (batch, height, width), levels (batch, nb, n, n) raster blocks and
// modes (batch, nb) are written whole; `work` holds
// nhv_wavefront_rd_work_ints zeroed words.  Launches one cooperative grid
// on `stream` without synchronising; adds 1 to info[0] and sets info[1] to the grid's
// thread blocks; returns the CUDA error of the launch, or cudaSuccess.
extern "C" int nhv_wavefront_rd(
    const int* planes, int batch, int height, int width, int n, int all_modes,
    int use_dst, int mf, int qshift, int qoffset, int dscale, int dq_shift,
    int max_pix, int boundary, int strong_thresh,
    unsigned long long filter_mask, int rdoq_scan, const int* tables,
    const float* rdoq_scalars, float lam, float log_gamma, float ln2,
    int* recon, int* levels, int* modes, int* work, int* info, void* stream,
    int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nhv_wavefront_rd_work_ints(batch, height, width, n, all_modes) < 0 ||
      (use_dst && n != 4) || (filter_mask >> 35) != 0 ||
      (n == 4 && filter_mask != 0) || rdoq_scan < -1 || rdoq_scan > 3 ||
      tables == nullptr || (rdoq_scan >= 0 && rdoq_scalars == nullptr))
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return (int)cudaSuccess;
  RdArgs a;
  a.planes = planes;
  a.batch = batch;
  a.height = height;
  a.width = width;
  a.nby = height / n;
  a.nbx = width / n;
  a.ndiag = a.nby + a.nbx - 1;
  a.t_offset = transform_offset(n, use_dst);
  a.all_modes = all_modes ? 1 : 0;
  a.q = QpScalars{mf, qshift, qoffset, dscale, dq_shift, max_pix, boundary};
  a.strong_thresh = strong_thresh;
  // only the bits of the modes this set can pick
  a.filter_mask = filter_mask & (all_modes ? (1ull << 35) - 1 : 3ull);
  a.rq = RdoqArgs{tables, 0, 0, 0, 0, 0, 0, 0, rdoq_scan};
  if (rdoq_scan >= 0) {
    const float* f = rdoq_scalars;
    a.rq = RdoqArgs{tables, f[0], f[1], f[2], f[3], f[4], f[5], f[6],
                    rdoq_scan};
  }
  a.lam = lam;
  a.rc = RateConsts{log_gamma, ln2};
  a.recon = recon;
  a.levels = levels;
  a.modes = modes;
  a.work = work;
  cudaStream_t s = (cudaStream_t)stream;
  switch (n) {
    case 4: return run<4>(a, info, s);
    case 8: return run<8>(a, info, s);
    case 16: return run<16>(a, info, s);
    case 32: return run<32>(a, info, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The grid nhv_wavefront_rd would launch for this call, through the same
// 2 (height / n + width / n - 1) grid barriers with an empty body: what
// its synchronisation costs alone.  `work` is one zeroed int32 word (the
// arrival count); info and the return value as nhv_wavefront_rd's.
extern "C" int nhv_wavefront_rd_barriers(int batch, int height, int width,
                                         int n, int all_modes, int* work,
                                         int* info, void* stream,
                                         int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nhv_wavefront_rd_work_ints(batch, height, width, n, all_modes) < 0 ||
      work == nullptr)
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return (int)cudaSuccess;
  const int nby = height / n, ndiag = nby + width / n - 1;
  const long long items = (long long)batch * nby * (all_modes ? 35 : 2);
  unsigned* count = reinterpret_cast<unsigned*>(work);
  cudaStream_t s = (cudaStream_t)stream;
  switch (n) {
    case 4: return run_barriers<4>(count, ndiag, items, info, s);
    case 8: return run_barriers<8>(count, ndiag, items, info, s);
    case 16: return run_barriers<16>(count, ndiag, items, info, s);
    case 32: return run_barriers<32>(count, ndiag, items, info, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

__global__ void rd_prices_kernel(const int* n1, const int* n, int count,
                                 RateConsts rc, float* c1, float* c0) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k < count)
    ctx_prices(__int2float_rn(n1[k]), __int2float_rn(n[k]), rc, c1[k], c0[k]);
}

// The rate model's per-context prices (ctx_prices) of `count` pairs of
// bin counts (n1 ones of n bins, n < 2^24) on the device: the function
// the kernel prices every context with, for a sweep against the host.
extern "C" int nhv_rd_prices(const int* n1, const int* n, int count,
                             float log_gamma, float ln2, float* c1, float* c0,
                             void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (count < 0) return (int)cudaErrorInvalidValue;
  if (count == 0) return (int)cudaSuccess;
  rd_prices_kernel<<<(count + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      n1, n, count, RateConsts{log_gamma, ln2}, c1, c0);
  return (int)cudaGetLastError();
}
