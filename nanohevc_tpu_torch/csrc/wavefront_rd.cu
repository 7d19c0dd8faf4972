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
// What bounds it on the card: a chain of ndiag = nby + nbx - 1 steps,
// each a reduction over one frame's slots, then a hand-off to the next
// diagonal; not bytes or operations (chip_smoke.py's 6h times the same
// synchronisation with an empty body beside it).  Each step is a chain
// of dependent latencies in one thread block; tools/wavefront_rd_stages.py
// splits it by stage, in SM cycles.  The design takes the grid out of
// the synchronisation (one wait a frame and diagonal, point to point
// between neighbouring blocks), fences and device-memory buffers out of
// the chain, and block barriers out of the candidates.
//
// Schedule.  A thread block owns W consecutive slots s0 .. s0+W-1 of a
// frame and walks its diagonals; the grid holds the thread blocks of F
// frames (W and F chosen on the host, below: F the batch where it fits),
// and a block codes frames f0, f0 + F, f0 + 2F, ... in turn, each with
// the same slots.  For each frame and diagonal d:
//   A(d): take the first slot's top arm, corner and the mode above from
//     the message of the block above (the one owning slot s0 - 1), sent
//     at its B(d-1); evaluate every candidate of its slots; add its bins
//     to the frame's counters of d;
//   B(d): wait until every thread block of the frame has added to the
//     counters a context needs; price, decide and code its slots; send
//     its message for the block below; build its references of d + 1.
// Frames never wait for one another: the blocks that code a frame code
// the same frames in the same order, and a frame's waits stay among them.
//
// The references stay in the thread block.  JAX's skewed buffers s_bot
// and r_sp are read and written so that a slot needs, at d + 1, only a
// window of each: W(d + 1) = s_bot[slot][(d+1)N .. (d+1)N + 2N] follows
// from W(d) (its corner W(d)[N]; the slot's bottom row at d, or W(d)[N+1
// .. 2N] where the slot is off the plane; the replicated last pixel at
// the plane's last block column, else 0), and r_sp's row of the slot is
// the corner (the last pixel of the slot above at d - 1, 0 where off the
// plane), the slot's right column at d (0 where off the plane) and the
// replicated last pixel at the plane's last block row (else 0).  From
// _read_refs_skewed / _write_bufs_skewed: B(d', s') writes s_bot row s'
// and r_sp row d' + nby - s', columns d'N + N + 1 .. d'N + 3N (the tails,
// N + 1 .. 2N of them, only at bx = nbx - 1 and s' = nby - 1), and A(d,
// s) reads s_bot row s - 1 and r_sp row d + nby - 1 - s, columns dN .. dN
// + 2N; so what A(d, s) reads was written by slot s at d - 1 and slot
// s - 1 at d - 1, d - 2 and d - 3 only (other diagonals write other
// columns), and what B(d, s -+ 1) writes at d lies beyond what A(d, s)
// has read by then.  So each block keeps each slot's window and last
// pixels in shared memory (parity-buffered), and only the first slot's
// top arm and corner cross thread blocks.
//
// Self-validating words, no fences.  A message word is (tag << 16) |
// value: the last slot's window W(d + 1), its last pixel at d - 1 and
// its mode at d, tagged d + 1; the block below polls the words it needs
// until each carries its tag (one word a thread), and a stale word, from
// d, carries another.  The frame's counters of d (frame, d, batch: KC
// 64-bit words, zeroed by the wrapper, never reused) each hold (count <<
// 32) | arrivals: every thread block adds (its count << 32) | 1 to every
// counter, and a reader polls the two counters a context needs until
// their arrivals reach G, the frame's thread blocks.  Each word is atomic
// on its own and carries its completeness, so no fence or flag orders
// data against readiness.  The order they give: A(d) of a block after
// B(d - 1) of the block above (the message); B(d) of every block after
// A(d) of every block of the frame (the counters), so B(d, s -+ 1)'s
// writes come after A(d, s)'s reads, and B(d)'s prices count every slot.
// Deadlock-free: a block waits on the block above it or on its frame's
// counters, to which every block of the frame adds before it waits, and
// a block that has left a frame has sent and added all that frame's
// words; the grid is co-resident (cudaLaunchCooperativeKernel refuses a
// grid that is not).  A wait that lasts a second ends in __trap(), so a fault is a
// CUDA error, not a hang.
//
// Layout.  A candidate is a group of N neighbouring lanes of one warp,
// lane i holding row i in registers (row_tail.cuh: butterflies,
// coefficients as immediates, transposes through the warp's own tiles,
// no __syncthreads); a warp holds 32 / N candidates.  GA groups evaluate
// the W x NC candidates of a diagonal in rounds.  Each candidate's SSE
// (an integer sum over the group, rounded once to float32), last
// significant position, significance of positions 0..30 and level counts
// reduce inside its group by shuffles; the warp then gathers its
// candidates' bins as bit masks, a lane a counter, in registers
// (rate_model.cuh's count_candidates), stores them once a diagonal, and
// a thread a counter sums the warps' into the frame's counters.  The
// levels go to shared memory as one byte a position (rate_model.cuh's
// level_code) for B's bits, a lane a run of 32 in ordered_sum's order.
// Where a group holds one candidate through the diagonal (one round, no
// RDOQ), its levels and recon stay in its registers and the chosen group
// writes them out, and the pair at N <= 16 is decided by a shuffle
// between the two groups of a slot, with no barrier.  Otherwise (several
// rounds, or RDOQ) the chosen block is coded again by the whole thread
// block, one thread a pixel (encode_tail.cuh with rdoq_tail.cuh), one
// slot at a time, so a thread block has at least N * N threads.  Every
// thread block prices the
// counts itself (2 x 45 contexts in parallel, each a float64 chain):
// publishing prices once a frame would add a hand-off to the chain,
// pricing again adds none.  The next diagonal's pixels are loaded while
// the counters fill.

#include <type_traits>

#include "intra_smooth.cuh"
#include "mode_sweep.cuh"   // also defines c_tables, the constant table
#include "rate_model.cuh"
#include "rdoq_tail.cuh"
#include "row_tail.cuh"
#include "wavefront_sync.cuh"   // global_ns

constexpr int cmax(int a, int b) { return a > b ? a : b; }
constexpr int cmin(int a, int b) { return a < b ? a : b; }

// The shape of the thread block for block size N and mode set ALL (0:
// DC / planar, 1: the 35 modes).  It can code a chosen block again one
// thread a pixel (RDOQ, or candidates in several rounds), so it has at
// least N * N threads.
template <int N, int ALL>
struct Rd {
  static constexpr int NN = N * N, R = 2 * N + 1, PJ = 3 * N + 1;
  static constexpr int NC = ALL ? 35 : 2;          // candidates a slot
  static constexpr int NB = ALL ? 2 : 1;           // priced batches
  using D = RateDims<NN>;
  static constexpr int KC = D::KC, K = D::K, M = D::M;
  static constexpr int MW = 2 * N + 3;             // message words
  // slots a thread block by preference: the 35 modes 2 at N = 4 (half
  // the thread blocks adding to each counter), else 1; the pair 4 (1 at
  // N = 32, whose blocks are 1024 threads)
  static constexpr int WPREF = ALL ? (N == 4 ? 2 : 1) : N == 32 ? 1 : 4;
  // threads: WPREF slots' candidates in a round where 1024 allow, one a
  // pixel, and two warps a priced batch
  static constexpr int T =
      cmax(cmax((cmin(WPREF * NC * N, 1024) + 31) / 32 * 32, NN),
           ALL ? 128 : 64);
  // groups that evaluate candidates (at N = 32, 16: the tiles' size)
  static constexpr int GA = N == 32 ? 16 : T / N;
  static constexpr int GW = 32 / N;                // groups a warp
  static constexpr int CW = GA * N / 32;           // candidate warps
  static constexpr int TILE = N * (N + 1);
  static constexpr int SCRATCH =
      cmax(cmax(2 * GA * TILE, GA * (NN + NN / 32)),
           2 * NN + 3 * rdoq_scratch_words<N>());
  // thread blocks an SM must hold for a 1080p luma plane at WPREF
  static constexpr int MINB = ALL && N <= 8 ? 2 : 1;
};

__host__ __device__ constexpr int rd_counters(int n) {
  return 70 + 2 * (n == 4 ? 3 : n == 8 ? 5 : n == 16 ? 7 : 9);
}

__host__ __device__ constexpr long long align4(long long v) {
  return (v + 3) & ~3LL;
}

// The work buffer's layout (int32 words, zeroed by the caller): the
// messages (frame, slot, 2N + 3 words; a block's at its last slot), then
// the counters (frame, d, batch: pair / angular, KC 64-bit words).
struct RdLayout {
  long long msg, counts, total;
  int nb, kc, mw;
  __host__ __device__ RdLayout(int n, int batch, int nby, int nbx,
                               int all_modes) {
    const long long b = batch, ndiag = nby + nbx - 1;
    nb = all_modes ? 2 : 1;
    kc = rd_counters(n);
    mw = 2 * n + 3;
    msg = 0;
    counts = (msg + b * nby * mw + 1) & ~1LL;      // 8-byte aligned
    total = counts + 2 * (b * ndiag * nb * kc);
  }
};

// The thread block's dynamic shared memory (int32 words) for W slots.
template <int N, int ALL>
struct RdSmem {
  using C = Rd<N, ALL>;
  long long scratch, x, ref, fref, proj, dc, prev, mode, sse, last, cost,
      kpos, ang, cnt, price, win, lastpix, rowb, colr, left, misc, code,
      total;
  __host__ __device__ explicit RdSmem(int w) {
    const long long nc = (long long)w * C::NC;
    scratch = 0;                                   // tiles | bits | tail
    x = align4(scratch + C::SCRATCH);              // [2][W][NN]
    ref = align4(x + 2LL * w * C::NN);             // [W][2R]
    fref = align4(ref + 2LL * w * C::R);           // [W][2R] (N > 4)
    proj = align4(fref + (N > 4 ? 2LL * w * C::R : 0));   // [W][33][PJ]
    dc = align4(proj + (ALL ? 33LL * w * C::PJ : 0));
    prev = dc + w;
    mode = prev + w;
    sse = mode + w;                                // [W * NC] float
    last = sse + nc;
    cost = last + nc;                              // [W * NC] float
    kpos = align4(cost + nc);                      // [NN]
    ang = kpos + C::NN;                            // [66]
    cnt = ang + 2 * kNumAngular;                   // [CW][NB][KC]
    price = align4(cnt + C::CW * C::NB * C::KC);   // Prices<M> [NB]
    win = price + C::NB * (sizeof(Prices<C::M>) / 4);   // [2][W][2N + 1]
    lastpix = win + 2LL * w * (2 * N + 1);         // [2][W]
    rowb = lastpix + 2 * w;                        // [W][N]
    colr = rowb + (long long)w * N;                // [W][N]
    left = colr + (long long)w * N;                // [W][2N + 1]
    misc = left + w * (2LL * N + 1);               // the mode above
    code = align4(misc + 1);                       // [W * NC][NN] bytes
    total = code + (nc * C::NN + 3) / 4;
  }
};

struct RdArgs {
  const int* planes;
  int batch, height, width, nby, nbx, ndiag, t_offset, all_modes;
  int slots, groups;    // W slots a thread block, G thread blocks a frame
  int frames;           // F frames' thread blocks in the grid
  QpScalars q;
  int strong_thresh;
  unsigned long long filter_mask;
  RdoqArgs rq;          // tables always set (diagonal scan at 4 N*N)
  float lam;
  RateConsts rc;
  int *recon, *levels, *modes, *work;
};

// --- self-validating words -----------------------------------------------
// A message word is (tag << 16) | value (a pixel or a mode); a counter is
// (count << 32) | arrivals, each thread block of the frame adding
// (its count << 32) | 1 to every counter of a diagonal.  Each word is
// atomic on its own and says itself whether it is complete, so a reader
// polls exactly the words it needs, with no fence or flag between the
// data and its readiness.

__device__ __forceinline__ unsigned ld_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long ld_relaxed64(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

// A spin that lasts a second is a schedule fault: __trap(), a CUDA error
// at the next synchronise, not a hang.
__device__ __noinline__ void spin_fault(unsigned long long t0) {
  if (global_ns() - t0 > 1000000000ull) __trap();
}

// The message word at p once it carries `tag` (16 bits); its value.
__device__ __forceinline__ int poll_message(const unsigned* p, unsigned tag) {
  unsigned v = ld_relaxed(p);
  if ((v >> 16) != tag) {
    const unsigned long long t0 = global_ns();
    for (int polls = 1; ((v = ld_relaxed(p)) >> 16) != tag; ++polls) {
      if (polls > 32) __nanosleep(32);
      if ((polls & 1023) == 0) spin_fault(t0);
    }
  }
  return (int)(v & 0xffffu);
}

// The counter at p, first read as v, once all `arrivals` thread blocks
// have added to it; its count.
__device__ __forceinline__ int poll_count(const unsigned long long* p,
                                          unsigned long long v,
                                          unsigned arrivals) {
  if ((unsigned)v != arrivals) {
    const unsigned long long t0 = global_ns();
    for (int polls = 1; (unsigned)(v = ld_relaxed64(p)) != arrivals;
         ++polls) {
      if (polls > 32) __nanosleep(32);
      if ((polls & 1023) == 0) spin_fault(t0);
    }
  }
  return (int)(v >> 32);
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

// mode_sweep.cuh's projection_sample with the angle tables in shared
// memory (`ang`: intraPredAngle of modes 2..34, then invAngle).
template <int N>
__device__ __forceinline__ int proj_sample(const int* ref, int mode, int e,
                                           const int* ang) {
  constexpr int R = 2 * N + 1;
  const int angle = ang[mode - 2];
  const bool vertical = mode >= 18;
  const int prim = vertical ? 0 : R, sec = vertical ? R : 0;
  const int pos = e - N;
  if (pos >= 0) return ref[prim + pos];
  if (angle < 0 && pos >= ((N * angle) >> 5))
    return ref[sec + (((pos + 1) * ang[kNumAngular + mode - 2] + 128) >> 8)];
  return ref[0];
}

// mode_sweep.cuh's angular_pixel, angle from shared memory.
template <int N>
__device__ __forceinline__ int ang_pixel(const int* proj, int angle,
                                         bool vertical, int i, int j) {
  const int scan = vertical ? i : j, base = vertical ? j : i;
  const int p = (scan + 1) * angle;
  const int frac = p & 31;
  const int idx = N + base + 1 + (p >> 5);
  const int a = proj[idx];
  const int b = proj[min(idx + 1, 3 * N)];
  return ((32 - frac) * a + frac * b + 16) >> 5;
}

// Row i of candidate `mode`'s prediction: DC from `dcv`, planar from
// `pl` (the filtered references where planar filters), an angular mode
// from its projection array.
template <int N>
__device__ __forceinline__ void predict_row(int mode, int dcv, const int* pl,
                                            const int* proj, const int* ang,
                                            int i, int (&pred)[N]) {
  if (mode == 1) {
#pragma unroll
    for (int j = 0; j < N; ++j) pred[j] = dcv;
  } else if (mode == 0) {
#pragma unroll
    for (int j = 0; j < N; ++j) pred[j] = planar_pixel<N>(pl, i, j);
  } else {
    const int angle = ang[mode - 2];
    const bool vertical = mode >= 18;
#pragma unroll
    for (int j = 0; j < N; ++j)
      pred[j] = ang_pixel<N>(proj, angle, vertical, i, j);
  }
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

// OFF is transform_offset(N, DST), passed down by the host-side launch.
template <int N, int ALL, bool DST, int OFF>
__global__ void __launch_bounds__(Rd<N, ALL>::T, Rd<N, ALL>::MINB)
wavefront_rd_kernel(RdArgs a) {
  using C = Rd<N, ALL>;
  constexpr int NN = C::NN, R = C::R, NC = C::NC, NB = C::NB, T = C::T;
  constexpr int GA = C::GA, GW = C::GW, PJ = C::PJ, KC = C::KC, CW = C::CW;
  constexpr int M = C::M, TILE = C::TILE, MW = C::MW;
  extern __shared__ __align__(16) int smem[];
  const RdSmem<N, ALL> L(a.slots);
  int* s_x = smem + L.x;
  int* s_ref = smem + L.ref;
  int* s_fref = N > 4 ? smem + L.fref : s_ref;
  int* s_proj = smem + L.proj;
  int* s_dc = smem + L.dc;
  int* s_prev = smem + L.prev;
  int* s_mode = smem + L.mode;
  float* s_sse = reinterpret_cast<float*>(smem + L.sse);
  int* s_last = smem + L.last;
  float* s_cost = reinterpret_cast<float*>(smem + L.cost);
  int* s_kpos = smem + L.kpos;
  int* s_ang = smem + L.ang;
  int* s_cnt = smem + L.cnt;
  Prices<M>* s_price = reinterpret_cast<Prices<M>*>(smem + L.price);
  int* s_win = smem + L.win;
  int* s_lastpix = smem + L.lastpix;
  int* s_rowb = smem + L.rowb;
  int* s_colr = smem + L.colr;
  int* s_left = smem + L.left;
  int* s_misc = smem + L.misc;
  int* s_scr = smem + L.scratch;
  unsigned char* s_code = reinterpret_cast<unsigned char*>(smem + L.code);

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = t / N, i = t % N;                 // group, row
  int f = blockIdx.x / a.groups;                  // this block's first frame
  const int s0 = (blockIdx.x % a.groups) * a.slots;
  const int nw = min(a.slots, a.nby - s0);        // this block's slots
  const int last = s0 + nw - 1;
  const bool below = last + 1 < a.nby;            // a block reads our messages
  const int total = nw * NC;                      // candidates a diagonal
  const int rounds = (total + GA - 1) / GA;
  const bool rdoq = a.rq.scan >= 0;               // uniform over the launch
  const bool keep = !rdoq && rounds == 1;
  const bool pl_filtered = (a.filter_mask & 1ull) != 0;
  const RdLayout lay(N, a.batch, a.nby, a.nbx, ALL);
  int* w = a.work;
  const int W1 = 2 * N + 1;                       // a window's samples
  // frame f's message lines, counters and plane (set for each frame)
  const unsigned* msg_in = nullptr;
  unsigned* msg_out = nullptr;
  unsigned long long* counts = nullptr;            // [d][NB][KC]
  size_t plane = 0;
  const int xstride = a.slots * NN;               // s_x's parity stride

  for (int k = t; k < NN; k += T) s_kpos[k] = __ldg(a.rq.tables + 4 * NN + k);
  for (int k = t; k < 2 * kNumAngular; k += T)
    s_ang[k] = c_tables[kAngleOffset + k];

  // After B(d) (d = -1: the start): each slot's window of s_bot, W(d + 1)
  // = s_bot[slot][(d+1)N .. (d+1)N + 2N], from W(d): its corner W(d)[N];
  // the slot's bottom row at d, or W(d)[N+1 .. 2N] where the slot is off
  // the plane at d; the replicated last pixel at the plane's last block
  // column, else 0.  The references of d + 1 (_read_refs_skewed): the top
  // arm is the window of the slot above; the left arm (r_sp's row) the
  // corner, the last pixel of the slot above at d - 1 (0 where off the
  // plane), then the slot's right column at d (0 where off the plane)
  // and the replicated last pixel at the plane's last block row (else
  // 0).  The first slot's top arm and corner come in the block above's
  // message (polled in A(d + 1)); the last slot's window, its last pixel
  // at d - 1 and its mode go out in this block's, tagged d + 1.
  auto next_refs = [&](int d) {
    const int dn = d + 1, par = d & 1, npar = dn & 1;
    const unsigned tag = ((unsigned)dn & 0xffffu) << 16;
    const bool send = below && d >= 0;
    auto window = [&](int wi, int u) {  // W(d + 1)[u] of slot s0 + wi
      const int bx = d - s0 - wi;
      const bool on = bx >= 0 && bx < a.nbx;
      const int* win = s_win + (par * a.slots + wi) * W1;
      return u == 0 ? win[N]
             : u <= N ? (on ? s_rowb[wi * N + u - 1] : win[N + u])
                      : (on && bx == a.nbx - 1 ? s_rowb[wi * N + N - 1] : 0);
    };
    if (send && t >= T - MW) {          // the message first: a word a thread
      const int u = t - (T - MW);
      const int v = u <= 2 * N ? window(nw - 1, u)
                    : u == 2 * N + 1 ? s_lastpix[npar * a.slots + nw - 1]
                                     : s_mode[nw - 1];
      st_relaxed(msg_out + u, tag | (unsigned)v);
    }
    // each slot's window W(d + 1) (and its last pixel at d), then its left
    // arm of d + 1 before the edge rules
    for (int k = t; k < nw * W1; k += T) {
      const int wi = k / W1, u = k % W1, bx = d - s0 - wi;
      s_win[(npar * a.slots + wi) * W1 + u] = window(wi, u);
      if (u == 0)
        s_lastpix[par * a.slots + wi] =
            bx >= 0 && bx < a.nbx ? s_rowb[wi * N + N - 1] : 0;
    }
    for (int k = t; k < nw * W1; k += T) {
      const int wi = k / W1, u = k % W1, bx = d - s0 - wi;
      const bool on = bx >= 0 && bx < a.nbx;
      const int corner = wi > 0 ? s_lastpix[npar * a.slots + wi - 1] : 0;
      s_left[wi * W1 + u] =
          u == 0 ? corner
          : u <= N ? (on ? s_colr[wi * N + u - 1] : 0)
                   : (on && s0 + wi == a.nby - 1 ? s_rowb[wi * N + N - 1] : 0);
    }
    __syncthreads();
    // the references of d + 1: the edge rules; the first slot's top arm
    // and corner are left to the message
    for (int k = t; k < nw * 2 * R; k += T) {
      const int wi = k / (2 * R), u = k % (2 * R), slot = s0 + wi;
      const int bx = dn - slot;
      const bool edge = slot == 0 || bx == 0, top = u < R;
      const bool bnd = top ? slot == 0 || (u == 0 && edge)
                           : bx == 0 || (u == R && edge);
      const bool from_msg = wi == 0 && dn > 0 && !bnd && (top || u == R);
      const int above = s_win[(npar * a.slots + max(wi - 1, 0)) * W1 + min(u, 2 * N)];
      const int v = bnd ? a.q.boundary
                    : top ? (wi > 0 ? above : 0)
                          : s_left[wi * W1 + max(u - R, 0)];
      if (!from_msg) s_ref[k] = v;
    }
  };
  __syncthreads();
  int kp[N <= 8 ? N : 1];               // row i's diag-packed positions
  if constexpr (N <= 8) {
#pragma unroll
    for (int j = 0; j < N; ++j) kp[j] = s_kpos[i * N + j];
  }

#pragma unroll 1
  for (; f < a.batch; f += a.frames) {  // frames f0, f0 + F, ... in turn
    unsigned* msgs =
        reinterpret_cast<unsigned*>(w + lay.msg) + (size_t)f * a.nby * MW;
    msg_in = msgs + (size_t)(s0 > 0 ? s0 - 1 : 0) * MW;
    msg_out = msgs + (size_t)last * MW;
    counts = reinterpret_cast<unsigned long long*>(w + lay.counts) +
             (size_t)f * a.ndiag * NB * KC;
    plane = (size_t)f * a.height * a.width;
    for (int k = t; k < nw; k += T) s_prev[k] = 1;  // before d = 0: DC
    for (int k = t; k < 2 * a.slots * W1 + 2 * a.slots; k += T) s_win[k] = 0;
    for (int k = t; k < nw * NN; k += T)
      s_x[k] = skewed_pixel(a, N, f, s0 + k / NN, 0, (k % NN) / N, k % N);
    __syncthreads();
    next_refs(-1);
    __syncthreads();

#pragma unroll 1
    for (int d = 0; d < a.ndiag; ++d) {
      const int* xs = s_x + (d & 1) * xstride;

      // --- A(d): the first slot's top arm and left corner, and the mode
      // above, from the block above's message tagged d
      const bool from_above = s0 > 0 && d > 0;
      if (from_above) {
        const unsigned tag_in = d & 0xffff;
        const int bx = d - s0;
        for (int u = t; u <= R; u += T) {
          if (u < R && !(u == 0 && bx == 0))
            s_ref[u] = poll_message(msg_in + u, tag_in);
          else if (u == R && bx != 0)
            s_ref[R] = poll_message(msg_in + 2 * N + 1, tag_in);
        }
        if (t == T - 1) s_misc[0] = poll_message(msg_in + 2 * N + 2, tag_in);
      } else if (t == T - 1) {
        s_misc[0] = 1;                    // DC
      }
      __syncthreads();
      if constexpr (N > 4) {
        if (a.filter_mask != 0ull)
          for (int k = t; k < nw * 2 * R; k += T)
            s_fref[k] = smoothed_ref<N>(s_ref + k / (2 * R) * 2 * R, k % (2 * R),
                                        a.strong_thresh);
      }
      for (int k = t; k < nw; k += T) s_dc[k] = dc_value<N>(s_ref + k * 2 * R);
      __syncthreads();
      if constexpr (ALL) {                // the 33 projection arrays a slot
        for (int k = t; k < nw * kNumAngular * PJ; k += T) {
          const int wi = k / (kNumAngular * PJ), r = k % (kNumAngular * PJ);
          const int mode = 2 + r / PJ, e = r % PJ;
          const int* src = ((a.filter_mask >> mode) & 1ull) ? s_fref + wi * 2 * R
                                                            : s_ref + wi * 2 * R;
          // the corner (sample N) is the top arm's, as ops.angular_tables
          // gives it (the off-plane slots' two corners may differ)
          s_proj[k] = e == N ? src[0] : proj_sample<N>(src, mode, e, s_ang);
        }
        __syncthreads();
      }

      // the candidates, in rounds of GA groups
      int keep_lev[N], keep_rec[N], keep_last = -1;
      float keep_sse = 0.0f;
      WarpBins<NB> bins;
#pragma unroll 1
      for (int r = 0; r < rounds; ++r) {
        if (g >= GA || r * GA + warp * GW >= total) continue;   // warp-uniform
        const int q = r * GA + g;
        const bool valid = q < total;
        const int wi = valid ? q / NC : 0, c = valid ? q % NC : 1;
        int x[N], pred[N], res[N], lev[N], rec[N];
        const int4* xr = reinterpret_cast<const int4*>(xs + wi * NN + i * N);
#pragma unroll
        for (int v = 0; v < N / 4; ++v) {
          const int4 p = xr[v];
          x[4 * v] = p.x, x[4 * v + 1] = p.y, x[4 * v + 2] = p.z,
                  x[4 * v + 3] = p.w;
        }
        const int* ref = s_ref + wi * 2 * R;
        const int* pl = pl_filtered ? s_fref + wi * 2 * R : ref;
        if constexpr (ALL) {
          predict_row<N>(c, s_dc[wi], pl,
                         s_proj + (wi * kNumAngular + (c >= 2 ? c - 2 : 0)) * PJ,
                         s_ang, i, pred);
        } else {                          // planar in every lane, then DC's
          const int dcv = s_dc[wi];
#pragma unroll
          for (int j = 0; j < N; ++j)
            pred[j] = c == 1 ? dcv : planar_pixel<N>(pl, i, j);
        }
#pragma unroll
        for (int j = 0; j < N; ++j) res[j] = x[j] - pred[j];
        int* tile = s_scr + 2 * g * TILE;
        row_transform_quant_recon<N, DST, OFF>(res, pred, i, tile, tile + TILE,
                                               a.q, lev, rec);
        int e = 0, pk = 0;
        RowStats st{-1, 0u, 0, 0};
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const int dd = x[j] - rec[j];
          e += dd * dd;
          const int av = lev[j] < 0 ? -lev[j] : lev[j];
          const int k = N <= 8 ? kp[N <= 8 ? j : 0] : s_kpos[i * N + j];
          st.last = max(st.last, av ? k : -1);
          st.sig31 |= av && k < 31 ? 1u << (k & 31) : 0u;
          pk += (av > 0) + ((av > 1) << 16);
          st.gt2 += av > 2;
          if (valid) s_code[q * NN + k] = (unsigned char)level_code(av);
        }
        // the SSE: an exact integer sum (N <= 16: at most 256 * 4095^2 <
        // 2^32), rounded once to float32
        using Sse = typename std::conditional<N <= 16, unsigned,
                                              unsigned long long>::type;
        Sse sse = (unsigned)e;
#pragma unroll
        for (int off = N / 2; off > 0; off >>= 1) {
          sse += __shfl_xor_sync(kFullWarp, sse, off);
          st.last = max(st.last, __shfl_xor_sync(kFullWarp, st.last, off));
          st.sig31 |= __shfl_xor_sync(kFullWarp, st.sig31, off);
          pk += __shfl_xor_sync(kFullWarp, pk, off);
          st.gt2 += __shfl_xor_sync(kFullWarp, st.gt2, off);
        }
        st.sig_gt1 = pk;
        if (valid && i == 0) {
          s_sse[q] = N <= 16 ? __uint2float_rn((unsigned)sse)
                             : __ull2float_rn((unsigned long long)sse);
          s_last[q] = st.last;
        }
        if (keep) {
#pragma unroll
          for (int j = 0; j < N; ++j) keep_lev[j] = lev[j], keep_rec[j] = rec[j];
          keep_last = st.last;
          keep_sse = N <= 16 ? __uint2float_rn((unsigned)sse)
                             : __ull2float_rn((unsigned long long)sse);
        }
        count_candidates<N, NB>(st, (int)valid | (ALL && c >= 2 ? 2 : 0), lane,
                                bins);
      }
      if (g < GA) store_bins<N, NB>(bins, lane, s_cnt + warp * NB * KC);
      __syncthreads();

      // this block's bins of d: (count << 32) | 1 added to every counter of
      // the frame's vector of d
      unsigned long long* counts_d = counts + (size_t)d * NB * KC;
      for (int k = t; k < NB * KC; k += T) {  // a thread a counter
        int v = 0;
#pragma unroll
        for (int cw = 0; cw < CW; ++cw) v += s_cnt[cw * NB * KC + k];
        atomicAdd(counts_d + k, ((unsigned long long)v << 32) | 1ull);
      }
      // the next diagonal's pixels, in flight while the counters fill
      int* xn = s_x + ((d + 1) & 1) * xstride;
      const int npix = d + 1 < a.ndiag ? nw * NN : 0;
      int pf[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = t + j * T;
        if (k < npix)
          pf[j] = skewed_pixel(a, N, f, s0 + k / NN, d + 1, (k % NN) / N, k % N);
      }

      // --- B(d): price the frame's counts, each counter once every thread
      // block of the frame has added to it
      {
        const int b = t >> 6, k = t & 63;
        float c1 = 0.0f;
        if (b < NB && k < C::K) {
          int i1, i0;
          context_counters<NN>(k, i1, i0);
          const unsigned long long* cb = counts_d + b * KC;
          const unsigned long long v1 = ld_relaxed64(cb + i1);
          const unsigned long long v0 = ld_relaxed64(cb + i0);
          const int n1 = poll_count(cb + i1, v1, a.groups);
          const int n0 = poll_count(cb + i0, v0, a.groups);
          price_context<NN>(k, n1, n0, s_price[b], a.rc, c1);
        }
        if ((warp & 1) == 0 && (warp >> 1) < NB)
          prefix_scan<M>(c1, lane, s_price[warp >> 1]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (t + j * T < npix) xn[t + j * T] = pf[j];
      for (int k = t + 4 * T; k < npix; k += T)
        xn[k] = skewed_pixel(a, N, f, s0 + k / NN, d + 1, (k % NN) / N, k % N);
      __syncthreads();

      // each candidate's cost; with one candidate a group (keep), the pair
      // (N <= 16: both groups of a slot in one warp) decided by a shuffle
      constexpr bool kPairShuffle = !ALL && N <= 16;
      int keep_mode = -1;
      if (keep) {
        if (g < GA && warp * GW < total) {           // warp-uniform
          const int q = g;
          const bool valid = q < total;
          const int wi = valid ? q / NC : 0, c = valid ? q % NC : 1;
          const float bits = group_bits<N>(
              s_code + (valid ? q : 0) * NN, keep_last,
              s_price[ALL && c >= 2 ? 1 : 0],
              reinterpret_cast<float*>(s_scr) + g * (NN + NN / 32), i, lane - i);
          float cost = 0.0f;
          if (i == 0) {
            const int slot = s0 + wi;
            const int am = slot == d ? 1 : s_prev[wi];
            const int bm = slot == 0 ? 1 : wi > 0 ? s_prev[wi - 1] : s_misc[0];
            cost = __fadd_rn(__fadd_rn(keep_sse, __fmul_rn(a.lam, bits)),
                             __fmul_rn(a.lam, mpm_bits(c, am, bm)));
          }
          if constexpr (kPairShuffle) {
            cost = __shfl_sync(kFullWarp, cost, lane - i);
            const float other = __shfl_xor_sync(kFullWarp, cost, N);
            const float planar = c == 0 ? cost : other;
            const float dcc = c == 0 ? other : cost;
            keep_mode = dcc <= planar ? 1 : 0;       // ties to DC
            if (valid && i == 0 && c == 0) s_mode[wi] = keep_mode;
          } else {
            if (valid && i == 0) s_cost[q] = cost;
          }
        }
      } else {
#pragma unroll 1
        for (int r = 0; r < rounds; ++r) {
          if (g >= GA || r * GA + warp * GW >= total) continue;   // warp-uniform
          const int q = r * GA + g;
          const bool valid = q < total;
          const int qq = valid ? q : 0, wi = qq / NC, c = qq % NC;
          const float bits = group_bits<N>(
              s_code + qq * NN, s_last[qq], s_price[ALL && c >= 2 ? 1 : 0],
              reinterpret_cast<float*>(s_scr) + g * (NN + NN / 32), i,
              lane - i);
          if (valid && i == 0) {
            const int slot = s0 + wi;
            const int am = slot == d ? 1 : s_prev[wi];
            const int bm = slot == 0 ? 1 : wi > 0 ? s_prev[wi - 1] : s_misc[0];
            const float cost = __fadd_rn(s_sse[q], __fmul_rn(a.lam, bits));
            s_cost[q] = __fadd_rn(cost, __fmul_rn(a.lam, mpm_bits(c, am, bm)));
          }
        }
      }

      // the decision of each slot (but the pair's by shuffle)
      if (!(kPairShuffle && keep)) {
        __syncthreads();
        if constexpr (ALL) {              // a warp a slot: the first minimum
          for (int wi = warp; wi < nw; wi += T / 32) {
            const float* cs = s_cost + wi * 35;
            float v = cs[lane];
            int k = lane;
            if (lane < 3 && cs[lane + 32] < v) v = cs[lane + 32], k = lane + 32;
#pragma unroll
            for (int h = 16; h > 0; h >>= 1) {
              const float ov = __shfl_xor_sync(kFullWarp, v, h);
              const int ok = __shfl_xor_sync(kFullWarp, k, h);
              if (ov < v || (ov == v && ok < k)) v = ov, k = ok;
            }
            if (lane == 0) s_mode[wi] = k;
          }
        } else {                          // the pair: ties to DC
          for (int wi = t; wi < nw; wi += T)
            s_mode[wi] = s_cost[2 * wi + 1] <= s_cost[2 * wi] ? 1 : 0;
        }
        __syncthreads();
        if (keep && g < GA && g < total) keep_mode = s_mode[g / NC];
      }

      // code the chosen blocks: each slot's bottom row and right column for
      // the references of d + 1, then the outputs
      if (keep) {                         // the chosen group's registers
        const int q = g, wi = q / NC, c = q % NC;
        const int slot = s0 + wi, bx = d - slot;
        if (g < GA && q < total && keep_mode == c && bx >= 0 && bx < a.nbx) {
          s_colr[wi * N + i] = keep_rec[N - 1];
          if (i == N - 1) {
#pragma unroll
            for (int j = 0; j < N; ++j) s_rowb[wi * N + j] = keep_rec[j];
          }
          store_row<N>(a.recon + plane + (size_t)(slot * N + i) * a.width + bx * N,
                       keep_rec);
          const size_t gb = (size_t)f * a.nby * a.nbx + (size_t)slot * a.nbx + bx;
          store_row<N>(a.levels + gb * NN + i * N, keep_lev);
          if (i == 0) a.modes[gb] = c;
        }
      } else {                            // one thread a pixel, slot by slot
        const int p = t % NN, pi = p / N, pj = p % N;
        int* st = s_scr;                  // T, T^T and the tail's scratch
        int* stt = st + NN;
        int* sx = stt + NN;
        int* sa = sx + rdoq_scratch_words<N>();
        int* sb_ = sa + rdoq_scratch_words<N>();
        st[p] = c_tables[a.t_offset + p];
        stt[p] = c_tables[a.t_offset + pj * N + pi];
#pragma unroll 1
        for (int wi = 0; wi < nw; ++wi) {
          const int slot = s0 + wi, bx = d - slot;
          if (bx < 0 || bx >= a.nbx) continue;   // off the plane: the mode only
          const int mode = s_mode[wi];
          const int* ref = s_ref + wi * 2 * R;
          int pred;
          if (mode == 1) {
            pred = s_dc[wi];
          } else if (mode == 0) {
            pred = planar_pixel<N>(pl_filtered ? s_fref + wi * 2 * R : ref, pi,
                                   pj);
          } else {
            pred = ang_pixel<N>(s_proj + (wi * kNumAngular + mode - 2) * PJ,
                                s_ang[mode - 2], mode >= 18, pi, pj);
          }
          const int x = xs[wi * NN + p];
          int level, rec;
          if (rdoq) {
            auto adjust = [&](int coeff, int lv) {
              return rdoq_level<N, T>(coeff, lv, t, mode, a.rq,
                                      rdoq_regs<N>(a.rq, p), a.q,
                                      reinterpret_cast<float*>(sx),
                                      reinterpret_cast<float*>(sa),
                                      reinterpret_cast<float*>(sb_));
            };
            transform_quant_recon<N>(st, stt, sx, sa, sb_, pi, pj, x - pred,
                                     pred, a.q, level, rec, adjust);
          } else {
            transform_quant_recon<N>(st, stt, sx, sa, sb_, pi, pj, x - pred,
                                     pred, a.q, level, rec);
          }
          if (t < NN) {
            if (pi == N - 1) s_rowb[wi * N + pj] = rec;
            if (pj == N - 1) s_colr[wi * N + pi] = rec;
            a.recon[plane + (size_t)(slot * N + pi) * a.width + bx * N + pj] = rec;
            const size_t gb =
                (size_t)f * a.nby * a.nbx + (size_t)slot * a.nbx + bx;
            a.levels[gb * NN + p] = level;
            if (p == 0) a.modes[gb] = mode;
          }
        }
      }
      __syncthreads();
      for (int k = t; k < nw; k += T) s_prev[k] = s_mode[k];
      next_refs(d);
    }
    __syncthreads();                    // the frame's last reads, then the next
  }
}

// The encoder's synchronisation alone: the same grid and block size
// through the same message polls, counter adds and counter polls with an
// empty body, frames in the same turns (chip_smoke.py's 6h times it
// beside the kernel).
template <int N, int ALL>
__global__ void __launch_bounds__(Rd<N, ALL>::T)
rd_sync_kernel(int* work, int batch, int nby, int nbx, int slots,
               int groups, int frames) {
  using C = Rd<N, ALL>;
  constexpr int NB = C::NB, KC = C::KC, MW = C::MW;
  const int t = threadIdx.x, lane = t & 31;
  const int s0 = (blockIdx.x % groups) * slots;
  const int last = min(s0 + slots, nby) - 1;
  const int ndiag = nby + nbx - 1;
  const RdLayout lay(N, batch, nby, nbx, ALL);
#pragma unroll 1
  for (int f = blockIdx.x / groups; f < batch; f += frames) {
    unsigned* msgs =
        reinterpret_cast<unsigned*>(work + lay.msg) + (size_t)f * nby * MW;
    unsigned long long* counts =
        reinterpret_cast<unsigned long long*>(work + lay.counts) +
        (size_t)f * ndiag * NB * KC;
#pragma unroll 1
    for (int d = 0; d < ndiag; ++d) {
      if (s0 > 0 && d > 0 && t < MW)
        poll_message(msgs + (size_t)(s0 - 1) * MW + t, d & 0xffff);
      __syncthreads();
      unsigned long long* counts_d = counts + (size_t)d * NB * KC;
      if (t < 32)
        for (int k = lane; k < NB * KC; k += 32) atomicAdd(counts_d + k, 1ull);
      const int b = t >> 6, k = t & 63;
      if (b < NB && k < C::K) {
        int i1, i0;
        context_counters<N * N>(k, i1, i0);
        const unsigned long long* cb = counts_d + b * KC;
        const unsigned long long v1 = ld_relaxed64(cb + i1);
        const unsigned long long v0 = ld_relaxed64(cb + i0);
        poll_count(cb + i1, v1, groups);
        poll_count(cb + i0, v0, groups);
      }
      __syncthreads();
      if (last + 1 < nby && t < MW)
        st_relaxed(msgs + (size_t)last * MW + t, ((d + 1) & 0xffffu) << 16);
    }
  }
}

// The grid for `batch` planes of nby slots: W slots a thread block, from
// Rd::WPREF up while the shared memory fits, and the F frames whose
// ceil(nby / W) thread blocks each are co-resident (the occupancy limit
// times the SM count), at most the batch.  Takes the W that codes the
// batch in the fewest turns ceil(batch / F), the smallest such W: the
// fewest slots a block where the batch fits at once, as before striding.
// Fails with cudaErrorCooperativeLaunchTooLarge where not one frame's
// thread blocks fit.
template <int N, int ALL>
static int plan_grid(const void* kernel, int batch, int nby, int& slots,
                     int& groups, int& frames, size_t& smem) {
  constexpr int T = Rd<N, ALL>::T;
  int device = 0, sms = 0, coop = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 device);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorCooperativeLaunchTooLarge;
  int best = 0;                                    // turns of the best W
  for (int wv = cmin(Rd<N, ALL>::WPREF, nby); wv <= nby && best != 1; ++wv) {
    const size_t bytes = (size_t)RdSmem<N, ALL>(wv).total * 4;
    if (bytes > (size_t)optin) break;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    int per_sm = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, T,
                                                          bytes);
    if (err != cudaSuccess) return (int)err;
    const int g = (nby + wv - 1) / wv;
    const long long fit = (long long)per_sm * sms / g;
    if (fit < 1) continue;
    const int fv = fit < batch ? (int)fit : batch;
    const int turns = (batch + fv - 1) / fv;
    if (best == 0 || turns < best) {
      best = turns;
      slots = wv, groups = g, frames = fv, smem = bytes;
    }
  }
  if (best == 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// One cooperative launch of the encoder; adds 1 to info[0] and sets
// info[1] to the grid's thread blocks and info[2] to its frames F on
// success.
template <int N, int ALL, bool DST>
static int run(RdArgs a, int* info, cudaStream_t stream) {
  const void* kernel =
      (const void*)wavefront_rd_kernel<N, ALL, DST, transform_offset(N, DST)>;
  size_t smem = 0;
  int err = plan_grid<N, ALL>(kernel, a.batch, a.nby, a.slots, a.groups,
                              a.frames, smem);
  if (err) return err;
  const int grid = a.frames * a.groups;
  void* params[] = {&a};
  cudaError_t e = cudaLaunchCooperativeKernel(kernel, dim3((unsigned)grid),
                                              dim3(Rd<N, ALL>::T), params,
                                              smem, stream);
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e == cudaSuccess) {
    info[0] += 1;
    info[1] = grid;
    info[2] = a.frames;
  }
  return (int)e;
}

// The synchronisation alone on the grid of the encoder without RDOQ.
template <int N, int ALL>
static int run_sync(int* work, int batch, int nby, int nbx, int* info,
                    cudaStream_t stream) {
  int slots = 0, groups = 0, frames = 0;
  size_t smem = 0;
  int err = plan_grid<N, ALL>(
      (const void*)wavefront_rd_kernel<N, ALL, false,
                                       transform_offset(N, false)>,
      batch, nby, slots, groups, frames, smem);
  if (err) return err;
  const int grid = frames * groups;
  void* params[] = {&work, &batch, &nby, &nbx, &slots, &groups, &frames};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)rd_sync_kernel<N, ALL>, dim3((unsigned)grid),
      dim3(Rd<N, ALL>::T), params, 0, stream);
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e == cudaSuccess) {
    info[0] += 1;
    info[1] = grid;
    info[2] = frames;
  }
  return (int)e;
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
  // a frame's counts of a diagonal fit the counters' 31 bits
  if ((long long)(height / n) * (all_modes ? 35 : 2) * n * n >= (1LL << 31))
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
// nhv_wavefront_rd_work_ints zeroed words.  Launches one cooperative
// grid on `stream` without synchronising, for any batch (the grid's
// thread blocks code F frames at a time); adds 1 to info[0] and sets
// info[1] to the grid's thread blocks and info[2] to F; returns the CUDA
// error of the launch (cudaErrorCooperativeLaunchTooLarge where not one
// frame's thread blocks can be co-resident), or cudaSuccess.
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
  if (!aligned16(recon) || !aligned16(levels)) return (int)cudaErrorInvalidValue;
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
  a.slots = a.groups = a.frames = 0;
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
  const bool all = a.all_modes;
  switch (n) {
    case 4:
      if (use_dst) return all ? run<4, 1, true>(a, info, s) : run<4, 0, true>(a, info, s);
      return all ? run<4, 1, false>(a, info, s) : run<4, 0, false>(a, info, s);
    case 8: return all ? run<8, 1, false>(a, info, s) : run<8, 0, false>(a, info, s);
    case 16: return all ? run<16, 1, false>(a, info, s) : run<16, 0, false>(a, info, s);
    case 32: return all ? run<32, 1, false>(a, info, s) : run<32, 0, false>(a, info, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The grid nhv_wavefront_rd would launch for this call, through the same
// ndiag waits for the block above, frame arrivals and message words
// with an empty body: what its synchronisation costs alone.  `work`
// holds nhv_wavefront_rd_work_ints zeroed words (the counters and
// message words of its layout are used); info and the return value as
// nhv_wavefront_rd's.
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
  const int nby = height / n, nbx = width / n;
  cudaStream_t s = (cudaStream_t)stream;
  const bool all = all_modes != 0;
  switch (n) {
    case 4: return all ? run_sync<4, 1>(work, batch, nby, nbx, info, s)
                       : run_sync<4, 0>(work, batch, nby, nbx, info, s);
    case 8: return all ? run_sync<8, 1>(work, batch, nby, nbx, info, s)
                       : run_sync<8, 0>(work, batch, nby, nbx, info, s);
    case 16: return all ? run_sync<16, 1>(work, batch, nby, nbx, info, s)
                        : run_sync<16, 0>(work, batch, nby, nbx, info, s);
    case 32: return all ? run_sync<32, 1>(work, batch, nby, nbx, info, s)
                        : run_sync<32, 0>(work, batch, nby, nbx, info, s);
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
