// Sample Adaptive Offset of a batch of planes (spec 8.7.3), per plane or
// per CTB tile, for Hopper (sm_90a): two kernels, the estimate and the
// application.
//
// What they replace.  No TPU kernel stands behind them: the JAX package
// runs SAO as XLA ops inside its closed-loop encode
// (nanohevc_tpu/models/wavefront.py:431-475) and decode (:784-806),
// through nanohevc_tpu/ops/sao.py (estimate_sao :111, apply_sao :73)
// and ops/sao_ctb.py (sao_tile_stats :76, estimate_sao_ctb :144,
// apply_sao_ctb :232).  The port's plain versions (ops/sao.py,
// ops/sao_ctb.py) are scatter-adds with int64 atomics over the whole
// plane, then 34 candidates and the merge pass as tensors of a few
// hundred tiles each.  Bit for bit the same results, in two launches:
//
// 1. sao_estimate_kernel: thread blocks of 1024 threads, each over a
//    group of consecutive tiles (as many groups as the card holds at
//    once: one wave), the statistics of each tile and then its decision.
//    - Statistics: each sample is classified with its 1-sample
//      neighbourhood (a neighbour outside the plane gives category 0;
//      the tiles at the right and bottom edges are partial), and its
//      difference src - rec goes into the tile's 16 EO (class x
//      category 1-4) and 32 band counts and sums: one histogram a
//      counting warp in shared memory, two shared atomics a key a
//      sample; warps 1-3 then sum the warps' histograms into 96 int32 a
//      tile, written out.  Per-tile values are exact in int32
//      (ops/sao_ctb.py asserts tile^2 * (2^bd - 1) < 2^31).  Layout:
//      [eo_cnt 16 | eo_sum 16 | bo_cnt 32 | bo_sum 32], eo index
//      class * 4 + category - 1.
//      tools/sao_stats_variants.py times the alternatives: 16 or 8
//      counting warps a block, one tile a block (PERF.md keeps them).
//    - The decision, in warp 0, overlapped: warp 0 counts no samples;
//      it takes tile k's statistics at a named barrier and decides it
//      while warps 1-31 count tile k + 1's samples, two buffers
//      alternating.  The 34 candidates (off, EO 0-3, BO
//      positions 0-28) of a tile, a lane a bin and a candidate: lane l
//      holds band l (offset and SSE delta) and, for l < 16, EO bin l;
//      lanes 0-3 gather their class's four deltas, lanes 0-28 their band
//      window's, and a warp reduction takes the first minimum by index.
//      Float32 in JAX's order, one rounding an op (no FMA: __fmul_rn,
//      __fadd_rn, __fsub_rn, __fdiv_rn): cnt*(o*o) - (2*o)*ssum, the EO
//      sum ((d0+d1)+d2)+d3, the band window ((a+b)+c)+d, the offset as
//      rintf(float(ssum) / float(cnt)) clipped.  CTB SAO adds each
//      candidate's price (lambda * bits, computed by the host in
//      float32); per-plane SAO adds none.
//    - CTB SAO's merge pass (ops/sao_ctb.py:139-164) offers each tile
//      its left, then its upper neighbour's pass-1 parameters, priced on
//      this tile's statistics at the merge price, strict `<`.  A block
//      takes its group by an atomic ticket in raster order and
//      publishes each tile's pass-1 parameters as one self-announcing
//      64-bit word (the parameters and the launch's tag, one relaxed
//      store: no flag, no fence; wavefront_sync.cuh's style) as soon as
//      it has them; once its group's words are out, warp 0 polls the
//      words of each tile's left and upper tiles (two lanes at once) and
//      runs the merge passes.  Those tiles come earlier in its own group
//      or in a group of a smaller ticket, whose block is running or done,
//      and no word waits on a merge: no schedule deadlocks, and no chain
//      of waits runs through the groups.  A spin that lasts a second
//      traps.
//    - Per-plane SAO: warp 0 adds each tile's 96 ints into the plane's
//      uint32 sums with atomicAdd (the wrap-around sum is the same in
//      any order: the plain version's int64 sum wrapped to int32, JAX's
//      int32 sums), and the plane's last tile, found by a done counter,
//      reads and zeroes the sums and decides.
//    - No reset launch: the workspace (the ticket, the per-plane done
//      counters and sums, a word a tile) is zeroed once when the wrapper
//      allocates it, and each launch leaves it so.  The ticket's upper
//      half is a generation: the block that takes the last ticket zeroes
//      the count and moves the generation on in one atomicAdd, and a
//      word's tag is the generation + 1, so a word of an earlier launch
//      never reads as ready.  The generation lives on the device, so
//      replays of a captured CUDA graph move it too.
// 2. sao_apply_kernel: one elementwise pass, a thread a sample: read the
//    input plane (never in place) and its tile's parameters, classify the
//    sample as the statistics do, add its slot's offset, clip.  Per-plane
//    SAO is one tile a plane.
//
// What bounds them on this card: bytes.  The estimate reads two planes
// (src and rec: 8 bytes a sample; the 8-neighbourhood comes from L1)
// and writes 96 + 6 ints a tile; the application reads one plane and
// writes one (8 bytes a sample).  Their integer work (about 40
// operations a sample in the statistics, 10 in the application) and
// the decision's few hundred float32 operations a tile are below the
// bytes' time at 67 T ops/s.  What holds the estimate back instead is
// the counting: a thread block's warps take a tile of 64 x 64 in rounds
// of shared atomics, and with warp 0 deciding, 31 warps need 5 rounds
// where 32 would need 4 (PERF.md).

#include <cuda_runtime.h>

#include <math_constants.h>

#include "wavefront_sync.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kStatInts = 96;         // a tile's statistics
constexpr int kEoCnt = 0, kEoSum = 16, kBoCnt = 32, kBoSum = 64;
// A thread block: warp 0 decides, kCountWarps warps count samples.
constexpr int kStatThreads = 1024;
constexpr int kCountWarps = kStatThreads / 32 - 1;
constexpr int kCountThreads = 32 * kCountWarps;
// Tiles a thread block at most.
constexpr int kMaxGroup = 64;
constexpr int kApplyX = 32, kApplyY = 8;
constexpr int kOff = 0, kEo0 = 1, kBo = 5;
// The counting warps meet at named barrier kBarCount; warps 1..kSumWarps
// then sum a tile's histograms and hand the statistics in buffer b to
// warp 0 at named barrier kBarFull + b, and warp 0 hands the buffer back
// at kBarFree + b.
constexpr int kSumWarps = kStatInts / 32;
constexpr int kBarCount = 1, kBarFull = 2, kBarFree = 4;
constexpr int kHandOff = 32 * (1 + kSumWarps);
// nhv_sao_estimate's modes.
constexpr int kModeFrame = 0, kModeCtb = 1, kModeMerge = 2;
// The workspace's counters (int32): the 64-bit ticket (count, then
// generation) at kTicket; the per-plane done counters and sums follow
// at kCounters.
constexpr int kTicket = 0;
constexpr int kCounters = 4;
// A published word: type (3 bits), band (5), the offsets (6 bits each,
// two's complement) from bit kWordOff; the tag in the upper 32 bits.
constexpr int kWordOff = 8;
constexpr int kWordOffBits = 6;

// (dy0, dx0, dy1, dx1) of EO classes 0-3 (ref/sao.py: EO_NEIGHBORS).
__constant__ int kNeighbors[4][4] = {
    {0, -1, 0, 1}, {-1, 0, 1, 0}, {-1, -1, 1, 1}, {-1, 1, 1, -1}};

// EO category (0-4) of the sample p at (y, x) for class c: 0 where a
// neighbour lies outside the plane; else EDGE_CAT[2 + sign + sign],
// EDGE_CAT = (1, 2, 0, 3, 4).
__device__ __forceinline__ int eo_category(const int* __restrict__ rec,
                                           int height, int width, int y,
                                           int x, int p, int c) {
  const int y0 = y + kNeighbors[c][0], x0 = x + kNeighbors[c][1];
  const int y1 = y + kNeighbors[c][2], x1 = x + kNeighbors[c][3];
  if (y0 < 0 || y0 >= height || x0 < 0 || x0 >= width || y1 < 0 ||
      y1 >= height || x1 < 0 || x1 >= width)
    return 0;
  const int n0 = __ldg(rec + (long long)y0 * width + x0);
  const int n1 = __ldg(rec + (long long)y1 * width + x1);
  const int ei = 2 + (p > n0) - (p < n0) + (p > n1) - (p < n1);
  return ei == 2 ? 0 : (ei < 2 ? ei + 1 : ei);
}

// Add (1, val) to bin `key` of a warp's histogram.
__device__ __forceinline__ void hist_add(int* cnt, int* sum, int key,
                                         int val) {
  atomicAdd(cnt + key, 1);
  atomicAdd(sum + key, val);
}


// --- the decision --------------------------------------------------------

// A tile's statistics as its warp holds them: lane l has band l and, for
// l < 16, EO bin l.
struct Bins {
  int ec, es, bc, bs;
};

__device__ __forceinline__ Bins load_bins(const int* st) {
  const int lane = threadIdx.x & 31;
  Bins b;
  b.ec = lane < 16 ? st[kEoCnt + lane] : 0;
  b.es = lane < 16 ? st[kEoSum + lane] : 0;
  b.bc = st[kBoCnt + lane];
  b.bs = st[kBoSum + lane];
  return b;
}

// ops/sao.py::_offset_from_stats: the float32 mean rounded half to even,
// clipped to [lo, hi], 0 where nothing was counted.
__device__ __forceinline__ int offset_of(int cnt, int ssum, int lo, int hi) {
  if (cnt <= 0) return 0;
  const float o = rintf(__fdiv_rn(__int2float_rn(ssum), __int2float_rn(cnt)));
  return min(max((int)o, lo), hi);
}

// ops/sao.py::_delta_sse: cnt*(o*o) - (2*o)*ssum, one rounding an op.
__device__ __forceinline__ float delta_sse(int cnt, int ssum, int o) {
  const float fc = __int2float_rn(cnt), fs = __int2float_rn(ssum);
  const float fo = __int2float_rn(o);
  return __fsub_rn(__fmul_rn(fc, __fmul_rn(fo, fo)),
                   __fmul_rn(__fmul_rn(2.0f, fo), fs));
}

// One tile's pass-1 choice, the same in every lane.
struct Choice {
  float cost;
  int type, band, off[4];
};

// The first minimum of the 34 candidates (off, EO 0-3, BO 0-28) of the
// tile the warp holds; `priced` adds price_off / price_eo / price_bo
// (CTB SAO), else no add (per-plane SAO, whose off candidate is 0).
__device__ Choice decide(const Bins& b, int cap, bool priced,
                         float price_off, float price_eo, float price_bo) {
  const int lane = threadIdx.x & 31;
  const int k = lane & 3;                          // EO category - 1
  const int eo = offset_of(b.ec, b.es, k < 2 ? 0 : -cap, k < 2 ? cap : 0);
  const float ed = delta_sse(b.ec, b.es, eo);
  const int bo = offset_of(b.bc, b.bs, -cap, cap);
  const float bd = delta_sse(b.bc, b.bs, bo);
  // Lane c < 4: class c's ((d0 + d1) + d2) + d3; lane p < 29: band
  // window p's ((a + b) + c) + d.
  float d_eo = __shfl_sync(kFull, ed, 4 * k);
  float d_win = bd;
#pragma unroll
  for (int j = 1; j < 4; ++j) {
    d_eo = __fadd_rn(d_eo, __shfl_sync(kFull, ed, 4 * k + j));
    d_win = __fadd_rn(d_win, __shfl_sync(kFull, bd, (lane + j) & 31));
  }
  // This lane's candidates in index order: 0 (lane 0), 1 + lane (lanes
  // 0-3), 5 + lane (lanes 0-28); strict < keeps the first of equals.
  float best = CUDART_INF_F;
  int idx = 64;
  if (lane == 0) {
    best = priced ? price_off : 0.0f;
    idx = 0;
  }
  if (lane < 4) {
    const float sc = priced ? __fadd_rn(d_eo, price_eo) : d_eo;
    if (sc < best) {
      best = sc;
      idx = 1 + lane;
    }
  }
  if (lane < 29) {
    const float sc = priced ? __fadd_rn(d_win, price_bo) : d_win;
    if (sc < best) {
      best = sc;
      idx = 5 + lane;
    }
  }
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) {
    const float ob = __shfl_xor_sync(kFull, best, m);
    const int oi = __shfl_xor_sync(kFull, idx, m);
    if (ob < best || (ob == best && oi < idx)) {
      best = ob;
      idx = oi;
    }
  }
  Choice ch;
  ch.cost = best;
  ch.type = idx == 0 ? kOff : (idx <= 4 ? idx : kBo);
  ch.band = idx >= 5 ? idx - 5 : 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int e = __shfl_sync(kFull, eo, (4 * (idx - 1) + j) & 31);
    const int o = __shfl_sync(kFull, bo, (idx - 5 + j) & 31);
    ch.off[j] = idx == 0 ? 0 : (idx <= 4 ? e : o);
  }
  return ch;
}

// ops/sao_ctb.py::_delta_for_params: the SSE delta of `type` / `band` /
// `off` on the tile the warp holds, (((0 + d0) + d1) + d2) + d3; 0 for
// SAO_OFF (and for a type no candidate has).
__device__ float params_delta(const Bins& b, int type, int band,
                              const int* off) {
  float d = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int eo_lane = (4 * (type - kEo0) + j) & 31;
    const int bo_lane = (band + j) & 31;
    const int ec = __shfl_sync(kFull, b.ec, eo_lane);
    const int es = __shfl_sync(kFull, b.es, eo_lane);
    const int bc = __shfl_sync(kFull, b.bc, bo_lane);
    const int bs = __shfl_sync(kFull, b.bs, bo_lane);
    if (type >= kEo0 && type < kBo)
      d = __fadd_rn(d, delta_sse(ec, es, off[j]));
    else if (type == kBo)
      d = __fadd_rn(d, delta_sse(bc, bs, off[j]));
  }
  return d;
}

__device__ __forceinline__ void store_choice(const Choice& ch, long long t,
                                             int* type_map, int* band_map,
                                             int* off_map) {
  if ((threadIdx.x & 31) == 0) {
    type_map[t] = ch.type;
    band_map[t] = ch.band;
#pragma unroll
    for (int j = 0; j < 4; ++j) off_map[4 * t + j] = ch.off[j];
  }
}

// --- the estimate: statistics, then the decision ------------------------

__device__ __forceinline__ unsigned long long load_word(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_word(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

// Named barriers: `n` threads (whole warps) meet at barrier `id`.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ unsigned pack_params(const Choice& ch) {
  unsigned w = (unsigned)ch.type | (unsigned)ch.band << 3;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    w |= ((unsigned)ch.off[j] & ((1u << kWordOffBits) - 1))
         << (kWordOff + kWordOffBits * j);
  return w;
}

__device__ __forceinline__ Choice unpack_params(unsigned p) {
  Choice ch;
  ch.cost = 0.0f;
  ch.type = p & 7;
  ch.band = (p >> 3) & 31;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    ch.off[j] = (int)(p << (32 - kWordOff - kWordOffBits * (j + 1))) >>
                (32 - kWordOffBits);
  return ch;
}

// The low 32 bits of word `t` once it carries `tag`, in lane `lane` of
// the warp where `want`; lanes poll their own words at once (32 polls
// back to back, then __nanosleep backoff, a trap after a second).
__device__ __forceinline__ unsigned poll_word(const unsigned long long* w,
                                              bool want, unsigned tag) {
  unsigned long long v = 0;
  if (want) {
    unsigned spins = 0, ns = 16;
    unsigned long long t0 = 0;
    while ((unsigned)((v = load_word(w)) >> 32) != tag) {
      if (++spins < 32) continue;
      if (t0 == 0) t0 = global_ns();
      __nanosleep(ns);
      if (ns < 128) ns <<= 1;
      check_spin(t0);
    }
  }
  return (unsigned)v;
}

// Tile t's first decision (raster over plane, row, column) from its
// statistics `own`, in warp 0; it never waits.  Per-plane SAO: the
// tile's statistics go into the plane's sums, and the plane's last tile
// reads them back, leaves zeros and decides.  CTB SAO: the tile's pass
// 1, stored (kModeCtb) or kept for the merge pass in `cost` / `params`
// and published as tile t's word (kModeMerge).
template <int kMode>
__device__ void first_decision(const Bins& own, long long t, int per_plane,
                               int cap, float price_off, float price_eo,
                               float price_bo, unsigned tag, int* type_map,
                               int* band_map, int* off_map, int* counters,
                               int batch, unsigned long long* words,
                               float* cost, unsigned* params) {
  const int lane = threadIdx.x & 31;
  if (kMode == kModeFrame) {
    // The tile's sums go in before it counts itself done (a fence).
    const int plane = (int)(t / per_plane);
    int* done = counters + kCounters + plane;
    unsigned* sums = reinterpret_cast<unsigned*>(counters + kCounters +
                                                 batch) +
                     (long long)plane * kStatInts;
    if (lane < 16) {
      atomicAdd(sums + kEoCnt + lane, (unsigned)own.ec);
      atomicAdd(sums + kEoSum + lane, (unsigned)own.es);
    }
    atomicAdd(sums + kBoCnt + lane, (unsigned)own.bc);
    atomicAdd(sums + kBoSum + lane, (unsigned)own.bs);
    __threadfence();
    int last = 0;
    if (lane == 0) last = atomicAdd(done, 1) == per_plane - 1;
    if (!__shfl_sync(kFull, last, 0)) return;
    __threadfence();
    Bins all;
    all.ec = lane < 16 ? (int)atomicExch(sums + kEoCnt + lane, 0u) : 0;
    all.es = lane < 16 ? (int)atomicExch(sums + kEoSum + lane, 0u) : 0;
    all.bc = (int)atomicExch(sums + kBoCnt + lane, 0u);
    all.bs = (int)atomicExch(sums + kBoSum + lane, 0u);
    if (lane == 0) atomicExch(done, 0);
    const Choice ch = decide(all, cap, false, 0.f, 0.f, 0.f);
    store_choice(ch, plane, type_map, band_map, off_map);
    return;
  }
  const Choice ch = decide(own, cap, true, price_off, price_eo, price_bo);
  if (kMode == kModeCtb) {
    store_choice(ch, t, type_map, band_map, off_map);
    return;
  }
  if (lane == 0) {
    const unsigned p = pack_params(ch);
    store_word(words + t, (unsigned long long)tag << 32 | p);
    *cost = ch.cost;
    *params = p;
  }
}

// CTB SAO's merge pass of tile t, in warp 0: its left, then its upper
// neighbour's pass-1 parameters (their words: lane 0 polls the left,
// lane 1 the upper one, at once) priced on its statistics `own` at the
// merge price against its own pass 1 (`cost`, `params`), strict `<`.
__device__ void merge_tile(const Bins& own, long long t, int ntx,
                           int per_plane, float price_merge, unsigned tag,
                           float cost, unsigned params, int* type_map,
                           int* band_map, int* off_map,
                           const unsigned long long* words) {
  const int lane = threadIdx.x & 31;
  const int cell = (int)(t % per_plane);
  const int ty = cell / ntx, tx = cell % ntx;
  const bool has = lane == 0 ? tx > 0 : (lane == 1 && ty > 0);
  const unsigned p =
      poll_word(words + (lane == 0 ? t - 1 : t - ntx), has, tag);
  Choice best = unpack_params(params);
  best.cost = cost;
#pragma unroll
  for (int dir = 0; dir < 2; ++dir) {                // left, then up
    if (dir == 0 ? tx == 0 : ty == 0) continue;
    const Choice nb = unpack_params(__shfl_sync(kFull, p, dir));
    const float d = nb.type == kOff
                        ? 0.0f
                        : params_delta(own, nb.type, nb.band, nb.off);
    const float c = __fadd_rn(d, price_merge);
    if (c < best.cost) {
      best.cost = c;
      best.type = nb.type;
      best.band = nb.band;
#pragma unroll
      for (int j = 0; j < 4; ++j) best.off[j] = nb.off[j];
    }
  }
  store_choice(best, t, type_map, band_map, off_map);
}

// Grid (groups), kStatThreads threads.  A thread block takes group g
// (its blockIdx.x, or under kModeMerge its ticket: groups in raster
// order) and its tiles g * per_group .. + per_group - 1 in order.  Warps
// 1-31 count the samples of tile k into their own histograms; after a
// barrier of theirs warps 1-3 sum the histograms into the tile's
// statistics (written out, and handed to warp 0 at a named barrier)
// while the others go on to tile k + 1; warp 0 takes the first decision
// of tile k meanwhile.  Two histogram and statistics buffers alternate.
// Under
// kModeMerge warp 0 then runs the group's merge passes, once every tile
// of the group has published its pass 1: a word waits on no merge, so
// no chain of waits runs through the groups.  The ticket's upper 32
// bits are the launch's generation: the block that takes the last
// ticket zeroes the count and moves the generation on, and a word's tag
// is the generation + 1.
template <int kMode>
__global__ void __launch_bounds__(kStatThreads)
    sao_estimate_kernel(const int* __restrict__ src,
                        const int* __restrict__ rec, int height, int width,
                        int tile_shift, int bit_depth, int batch, int nty,
                        int ntx, int per_group, int cap, float price_off,
                        float price_eo, float price_bo, float price_merge,
                        int* __restrict__ stats, int* __restrict__ type_map,
                        int* __restrict__ band_map, int* __restrict__ off_map,
                        int* __restrict__ counters,
                        unsigned long long* __restrict__ words) {
  __shared__ int hist[2][kCountWarps][kStatInts];
  __shared__ int total[2][kStatInts];
  __shared__ float pass1_cost[kMaxGroup];
  __shared__ unsigned pass1_params[kMaxGroup];
  __shared__ long long group;
  __shared__ unsigned launch_tag;
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < 2 * kCountWarps * kStatInts;
       i += kStatThreads)
    (&hist[0][0][0])[i] = 0;
  if (threadIdx.x == 0) {
    long long g = blockIdx.x;
    unsigned tag = 0;
    if (kMode == kModeMerge) {
      unsigned long long* ticket =
          reinterpret_cast<unsigned long long*>(counters + kTicket);
      const unsigned long long old = atomicAdd(ticket, 1ull);
      g = (long long)(old & 0xffffffffull);
      tag = (unsigned)(old >> 32) + 1u;
      if (g == gridDim.x - 1)         // every ticket is taken
        atomicAdd(ticket, (1ull << 32) - gridDim.x);
    }
    group = g;
    launch_tag = tag;
  }
  __syncthreads();
  const int per_plane = nty * ntx;
  const long long ntiles = (long long)batch * per_plane;
  const long long first = group * per_group;
  const int n = (int)min((long long)per_group, ntiles - first);
  const int tile = 1 << tile_shift;
  if (warp == 0) {
    for (int k = 0; k < n; ++k) {
      bar_sync(kBarFull + (k & 1), kHandOff);
      const Bins own = load_bins(total[k & 1]);
      if (k + 2 < n) bar_arrive(kBarFree + (k & 1), kHandOff);
      first_decision<kMode>(own, first + k, per_plane, cap, price_off,
                            price_eo, price_bo, launch_tag, type_map,
                            band_map, off_map, counters, batch, words,
                            &pass1_cost[k], &pass1_params[k]);
    }
    if (kMode == kModeMerge) {
      __syncwarp();
      for (int k = 0; k < n; ++k)
        merge_tile(load_bins(stats + (first + k) * kStatInts), first + k,
                   ntx, per_plane, price_merge, launch_tag, pass1_cost[k],
                   pass1_params[k], type_map, band_map, off_map, words);
    }
    return;
  }
  const int counter = threadIdx.x - 32;
  for (int k = 0; k < n; ++k) {
    const int buf = k & 1;
    const long long t = first + k;
    const int plane = (int)(t / per_plane), cell = (int)(t % per_plane);
    const int y0 = (cell / ntx) << tile_shift, x0 = (cell % ntx) << tile_shift;
    const int th = min(tile, height - y0), tw = min(tile, width - x0);
    const int cnt = th * tw;
    const long long base = (long long)plane * height * width;
    const int* __restrict__ r = rec + base;
    const int* __restrict__ s = src + base;
    int* h = hist[buf][warp - 1];
    for (int i = counter; i < cnt; i += kCountThreads) {
      const int y = y0 + i / tw, x = x0 + i % tw;
      const int p = __ldg(r + (long long)y * width + x);
      const int d = __ldg(s + (long long)y * width + x) - p;
      const int band = p >> (bit_depth - 5);
      if (band >= 0 && band < 32) hist_add(h + kBoCnt, h + kBoSum, band, d);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int cat = eo_category(r, height, width, y, x, p, c);
        if (cat) hist_add(h + kEoCnt, h + kEoSum, c * 4 + cat - 1, d);
      }
    }
    bar_sync(kBarCount, kCountThreads);
    if (warp <= kSumWarps) {
      const int e = counter;
      int sum = 0;
#pragma unroll
      for (int w = 0; w < kCountWarps; ++w) {
        sum += hist[buf][w][e];
        hist[buf][w][e] = 0;
      }
      stats[t * kStatInts + e] = sum;
      if (k >= 2) bar_sync(kBarFree + buf, kHandOff);   // warp 0 took k - 2
      total[buf][e] = sum;
      bar_arrive(kBarFull + buf, kHandOff);
    }
  }
}

// --- the application -----------------------------------------------------

__global__ void __launch_bounds__(kApplyX * kApplyY)
    sao_apply_kernel(const int* __restrict__ planes,
                     const int* __restrict__ type_map,
                     const int* __restrict__ band_map,
                     const int* __restrict__ off_map, int height, int width,
                     int tile_shift, int nty, int ntx, int bit_depth,
                     int* __restrict__ out) {
  const int x = blockIdx.x * kApplyX + threadIdx.x;
  const int y = blockIdx.y * kApplyY + threadIdx.y;
  if (x >= width || y >= height) return;
  const int plane = blockIdx.z;
  const long long base = (long long)plane * height * width;
  const int* __restrict__ r = planes + base;
  const int p = __ldg(r + (long long)y * width + x);
  const long long t =
      ((long long)plane * nty + (y >> tile_shift)) * ntx + (x >> tile_shift);
  const int type = __ldg(type_map + t);
  int slot = -1;
  if (type >= kEo0 && type < kBo) {
    slot = eo_category(r, height, width, y, x, p, type - kEo0) - 1;
  } else if (type == kBo) {
    const int wi = ((p >> (bit_depth - 5)) - __ldg(band_map + t)) & 31;
    slot = wi < 4 ? wi : -1;
  }
  const int delta = slot >= 0 ? __ldg(off_map + 4 * t + slot) : 0;
  out[base + (long long)y * width + x] =
      min(max(p + delta, 0), (1 << bit_depth) - 1);
}

bool bad_shape(int batch, int height, int width, int bit_depth) {
  return batch < 0 || height < 0 || width < 0 || bit_depth < 5 ||
         bit_depth > 16 || batch > 65535;
}

// Thread blocks of the estimate kernel that the card holds at once, by
// device (0: not asked yet).
constexpr int kMaxDevices = 64;
int resident_blocks[3][kMaxDevices];

template <int kMode>
int launch_estimate(const int* src, const int* rec, int batch, int height,
                    int width, int tile_shift, int bit_depth, int nty,
                    int ntx, int cap, const float* prices, int* stats,
                    int* type_map, int* band_map, int* off_map,
                    int* counters, unsigned long long* words,
                    cudaStream_t stream, int device) {
  int& resident = resident_blocks[kMode][device];
  if (resident == 0) {
    int per_sm = 0, sms = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sao_estimate_kernel<kMode>, kStatThreads, 0);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    if (err != cudaSuccess) return (int)err;
    resident = per_sm * sms > 0 ? per_sm * sms : 1;
  }
  // Groups of consecutive tiles, as many as the card holds at once, so
  // that one grid runs in one wave and a block's decisions overlap its
  // later tiles' counting.
  const long long ntiles = (long long)batch * nty * ntx;
  const int fill = (int)((ntiles + resident - 1) / resident);
  const int per_group = fill < kMaxGroup ? fill : kMaxGroup;
  const long long groups = (ntiles + per_group - 1) / per_group;
  sao_estimate_kernel<kMode><<<(unsigned)groups, kStatThreads, 0, stream>>>(
      src, rec, height, width, tile_shift, bit_depth, batch, nty, ntx,
      per_group, cap, prices[0], prices[1], prices[2], prices[3], stats,
      type_map, band_map, off_map, counters, words);
  return (int)cudaGetLastError();
}

}  // namespace

// The estimate of `batch` (height, width) int32 src / rec planes over
// tiles of 1 << tile_shift samples: `stats` (batch, nty, ntx, 96) int32,
// and the parameters: mode kModeFrame one set a plane, type / band
// (batch) and offsets (batch, 4), with no prices; kModeCtb / kModeMerge
// a set a tile, (batch, nty, ntx) and (batch, nty, ntx, 4), with the
// four prices, the merge pass under kModeMerge.  cap (< 32) bounds the
// offsets.  `counters` is the workspace's int32 part (kCounters + batch
// * 97 ints), `words` its word a tile (kModeMerge), both zeroed once
// when allocated and left so by every launch; launches that share them
// must not overlap (one stream).
extern "C" int nhv_sao_estimate(const int* src, const int* rec, int batch,
                                int height, int width, int tile_shift,
                                int bit_depth, int mode, int cap,
                                float price_off, float price_eo,
                                float price_bo, float price_merge,
                                int* stats, int* type_map, int* band_map,
                                int* off_map, int* counters,
                                unsigned long long* words, void* stream,
                                int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_shape(batch, height, width, bit_depth) || tile_shift < 0 ||
      tile_shift > 15 || mode < kModeFrame || mode > kModeMerge || cap < 0 ||
      cap >= 1 << (kWordOffBits - 1) || device < 0 || device >= kMaxDevices)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || height == 0 || width == 0) return (int)cudaSuccess;
  const long long nty = ((height - 1) >> tile_shift) + 1;
  const long long ntx = ((width - 1) >> tile_shift) + 1;
  if (batch * nty * ntx > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const float prices[4] = {price_off, price_eo, price_bo, price_merge};
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == kModeFrame)
    return launch_estimate<kModeFrame>(src, rec, batch, height, width,
                                       tile_shift, bit_depth, (int)nty,
                                       (int)ntx, cap, prices, stats, type_map,
                                       band_map, off_map, counters, words, s,
                                       device);
  if (mode == kModeCtb)
    return launch_estimate<kModeCtb>(src, rec, batch, height, width,
                                     tile_shift, bit_depth, (int)nty,
                                     (int)ntx, cap, prices, stats, type_map,
                                     band_map, off_map, counters, words, s,
                                     device);
  return launch_estimate<kModeMerge>(src, rec, batch, height, width,
                                     tile_shift, bit_depth, (int)nty,
                                     (int)ntx, cap, prices, stats, type_map,
                                     band_map, off_map, counters, words, s,
                                     device);
}

// Apply per-tile parameters ((batch, nty, ntx) type and band maps, (batch,
// nty, ntx, 4) offsets; tiles of 1 << tile_shift samples) to `batch`
// (height, width) int32 planes into `out` (never in place).
extern "C" int nhv_sao_apply(const int* planes, const int* type_map,
                             const int* band_map, const int* off_map,
                             int batch, int height, int width, int tile_shift,
                             int bit_depth, int* out, void* stream,
                             int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_shape(batch, height, width, bit_depth) || tile_shift < 0 ||
      tile_shift > 30)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || height == 0 || width == 0) return (int)cudaSuccess;
  const int nty = ((height - 1) >> tile_shift) + 1;
  const int ntx = ((width - 1) >> tile_shift) + 1;
  const dim3 grid((width + kApplyX - 1) / kApplyX,
                  (height + kApplyY - 1) / kApplyY, batch);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  sao_apply_kernel<<<grid, dim3(kApplyX, kApplyY), 0,
                     (cudaStream_t)stream>>>(planes, type_map, band_map,
                                             off_map, height, width,
                                             tile_shift, nty, ntx, bit_depth,
                                             out);
  return (int)cudaGetLastError();
}
