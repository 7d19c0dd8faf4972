// RDOQ of one block inside the closed loop's encode tail (wavefront.cu),
// between quantization and dequantization, so that the recon, and the
// neighbours' references, come from the levels the stream carries:
// bit for bit ops.rdoq.rdoq_levels of the plain version (the JAX
// package's nanohevc_tpu/ops/rdoq.py, rdoq_levels, as the closed loop's
// _code_residual calls it), for one block in its scan order:
//   stage A, level trim: each nonzero level l against l - 1, by
//     g * d * d through the transform gain plus lambda times its
//     separable bits (a 1 -> 0 trim only before the block's last
//     significant scan position);
//   stage B, last position: for every scan position p with a level,
//     lambda * (cbf1 + last(p) + the bits before p + its own bits less
//     its sig1 price) plus the distortion of zeroing everything after
//     p; the first minimum wins, unless the all-zero block's lambda *
//     cbf0 + the distortion of zeroing all costs no more.
//
// Float32, as the plain version computes it on the CPU and the card:
// every add and multiply is written __fadd_rn / __fsub_rn / __fmul_rn,
// which nvcc never contracts into an FMA, in the plain version's
// association (g * d * d = (g * d) * d; rate_p = ((cbf1 + last) +
// prefix) + (ccoef - sig1)).  The sums along the scan take XLA's CPU
// order, as ops.rate.ordered_sum and ordered_cumsum spell it out:
//   the total: runs of 32 summed left to right, then the runs' sums
//     left to right (16 terms: one run);
//   the prefix sums: runs of 16 scanned left to right, then a
//     left-to-right carry over the runs' totals (16 terms: one scan);
// so each run is a serial loop of one thread, the runs in parallel, and
// the carry one serial loop.  EG0's floor(log2) keeps XLA's four
// deviations (ops.rate.eg0_floor_log2).
//
// Layout: one thread a pixel (threads beyond N*N mirror pixel t % N*N
// and write the same values).  Each thread loads its loop invariants
// once, before the kernel's block loop (rdoq_regs): its pixel's
// transform gain, and for each scan kind its scan position and the
// rate-table entries there, from `tables`, built once per (N, DST,
// device) by the wrapper (kernels/wavefront.py, rdoq_tables): gain by
// raster position, sig0, sig1 and the last position's bits by scan
// position (float32 bits), then the scan position of each raster
// position for the diagonal, horizontal and vertical scans.  Under scan
// "mode" at N 4 and 8 a thread keeps all three kinds and the block's own
// mode picks one (ops.scan.mode_scan_idx); elsewhere it keeps one.  The
// per-position values go to shared memory by scan position, with a pad
// word after every 16 (rdoq_scratch_words).
//
// Lane roles, so that no warp runs two serial chains one after the
// other: the distortion's and the bits' runs of 16 are one branch (lane
// r < NN/16 takes run r of the distortion, lane NN/16 + r run r of the
// bits, each through a pointer its lane chooses); the two carries are
// one branch (lane 0 the distortion's, lane 1 the bits'); the total's
// runs of 32 and their sum run in the first warp with no run of 16.
// The carries read the runs' totals after a warp barrier (N <= 16: the
// runs of 16 are warp 0) or a named barrier of the runs' warps (N = 32).
// The last significant position (max) and the first minimum
// (lexicographic, exact in any order: the least cost by an int key in
// float order, then the least position holding it) are warp reductions
// (redux.sync) with one exchange across the warps each.  Block-wide
// barriers: one that ends the forward transform's reads and exchanges
// the max, one after stage A's writes, one after the sums, one for the
// minimum's exchange, whose reads end the scratch's (a one-warp block
// syncs its warp instead).

#pragma once

#include <math_constants.h>

#include "encode_tail.cuh"

// What the tail needs besides the block: the tables (layout above) and
// the float32 scalars of the plain version (lam from
// ops.rdoq.rd_lambda_calibrated, lam * cbf0 as its float32 product, the
// default rate table's cbf1 and gt1 / gt2 bins), and the scan: -1 off,
// 0 diagonal, 1 horizontal, 2 vertical, 3 by mode.
struct RdoqArgs {
  const int* tables;
  float lam, lam_cbf0, cbf1, gt1_0, gt1_1, gt2_0, gt2_1;
  int scan;
};

// ops.scan.mode_scan_idx at N 4 and 8: vertical for modes 6-14,
// horizontal for 22-30, diagonal otherwise.
__device__ __forceinline__ int mode_scan_kind(int mode) {
  return mode >= 6 && mode <= 14 ? 2 : mode >= 22 && mode <= 30 ? 1 : 0;
}

// 2 * floor(log2(max(a - 2, 1))) + 1 with XLA's floor(log2) deviations.
__device__ __forceinline__ float eg0_bits(int a) {
  const int x = max(a - 2, 1);
  int e = 31 - __clz(x);
  if (x == 8192 || x == 32768) e -= 1;
  if (x == 2097151 || x == 4194303) e += 1;
  return __fadd_rn(__fmul_rn(2.0f, (float)e), 1.0f);
}

// The separable bits of level magnitude a at an emitted position.
__device__ __forceinline__ float coef_rate(int a, float sig0, float sig1,
                                           const RdoqArgs& rq) {
  if (a <= 0) return sig0;
  const float gt =
      a > 1 ? __fadd_rn(rq.gt1_1, a > 2 ? __fadd_rn(rq.gt2_1, eg0_bits(a))
                                        : rq.gt2_0)
            : rq.gt1_0;
  return __fadd_rn(__fadd_rn(sig1, 1.0f), gt);
}

// The words of each of the tail's three scratch arrays: N*N and a pad
// word after every 16 positions (a scan position k lives at padded(k)),
// so that the lanes of a warp that walk runs of 16 (17 words apart) or
// of 32 (34 apart) fall in different shared-memory banks.
template <int N>
__host__ __device__ constexpr int rdoq_scratch_words() {
  return N * N + N * N / 16;
}

__device__ __forceinline__ int padded(int k) { return k + (k >> 4); }

// A thread's loop invariants (layout above): the gain of its pixel and,
// for each scan kind it keeps, the pixel's scan position and the rate
// table's sig0, sig1 and last-position bits there.
template <int N>
struct RdoqRegs {
  static constexpr int KINDS = N <= 8 ? 3 : 1;
  float g;
  int k[KINDS];
  float sig0[KINDS], sig1[KINDS], last_bits[KINDS];
};

// Load pixel p's invariants (every kind the scan "mode" may pick at N
// 4 and 8, else the launch's scan), pinned in registers so that the
// compiler cannot load them again inside the caller's loop.
template <int N>
__device__ __forceinline__ RdoqRegs<N> rdoq_regs(const RdoqArgs& rq, int p) {
  constexpr int NN = N * N;
  const float* tf = reinterpret_cast<const float*>(rq.tables);
  RdoqRegs<N> r;
  r.g = pinned(__ldg(tf + p));
#pragma unroll
  for (int c = 0; c < RdoqRegs<N>::KINDS; ++c) {
    const int kind = rq.scan == 3 ? c : rq.scan;   // "mode" above 8: diag
    const int k = __ldg(rq.tables + (4 + kind) * NN + p);
    r.k[c] = pinned(k);
    r.sig0[c] = pinned(__ldg(tf + NN + k));
    r.sig1[c] = pinned(__ldg(tf + 2 * NN + k));
    r.last_bits[c] = pinned(__ldg(tf + 3 * NN + k));
  }
  return r;
}

// v[c] of a thread's kinds, by selects (no local memory).
template <class T, int KINDS>
__device__ __forceinline__ T of_kind(const T (&v)[KINDS], int c) {
  if constexpr (KINDS == 1) {
    return v[0];
  } else {
    return c == 0 ? v[0] : c == 1 ? v[1] : v[2];
  }
}

// The thread block's barrier: its warp where it has one.
template <int THREADS>
__device__ __forceinline__ void block_sync() {
  if constexpr (THREADS <= 32) {
    __syncwarp(THREADS == 32 ? 0xffffffffu : (1u << THREADS) - 1u);
  } else {
    __syncthreads();
  }
}

// A float's key: ints in the order of float compares.  -0 becomes +0
// first (x + 0 is x for every other x), so that -0 == +0 as the compares
// have it; no NaN reaches it.
__device__ __forceinline__ int float_key(float c) {
  const int i = __float_as_int(__fadd_rn(c, 0.0f));
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float key_float(int key) {
  return __int_as_float(key >= 0 ? key : key ^ 0x7fffffff);
}

// The first minimum of (key, k) over the warp's lanes in MASK, in every
// one of them: the least key, then the least k of the lanes that hold it
// (two warp reductions, exact in any order).
template <unsigned MASK>
__device__ __forceinline__ void warp_argmin(int& key, int& k) {
  const int least = __reduce_min_sync(MASK, key);
  k = __reduce_min_sync(MASK, key == least ? k : 0x7fffffff);
  key = least;
}

// The RDOQ level of the block's pixel whose invariants `rr` holds, from
// its transform coefficient and deadzone level; `mode` is the block's
// decided mode.  Every thread of the thread block must call it (it holds
// barriers), right after the forward transform: its first barrier ends
// the transform's reads of the scratch.
// s_zg, s_cc and s_czg are the block's three shared scratch arrays of
// rdoq_scratch_words<N>() words (the tail's s_x, s_a, s_b), free until
// its dequantizer: the distortion saved by zeroing, the bits, and the
// prefix sums of the first, by padded scan position.  Every read of them
// is done when it returns, so the caller may write them again.
template <int N, int THREADS>
__device__ __forceinline__ int rdoq_level(int coeff, int level, int t,
                                          int mode, const RdoqArgs& rq,
                                          const RdoqRegs<N>& rr,
                                          const QpScalars& q, float* s_zg,
                                          float* s_cc, float* s_czg) {
  constexpr int NN = N * N;
  constexpr int NR16 = NN / 16;         // prefix-sum runs
  constexpr int NR32 = NN / 32;         // total's runs (0 at N = 4)
  constexpr int WARPS = THREADS > 32 ? THREADS / 32 : 1;
  // the total's runs of 32: the first warp with no run of 16
  constexpr int T32 = (2 * NR16 + 31) / 32 * 32;
  static_assert(NN <= 16 || T32 + NR32 <= THREADS,
                "the total's runs need a warp of their own");
  static_assert(WARPS <= 32, "an exchange fits one warp");
  const int xw = (t & 31) < WARPS ? t & 31 : 0;   // a lane's warp entry
  __shared__ int s_last[WARPS];
  __shared__ int s_min_key[WARPS];
  __shared__ int s_min_k[WARPS];
  __shared__ float s_tot[2 * NR16];     // the runs' totals: distortion, bits
  __shared__ float s_carry[2 * NR16];   // their carries, alike
  __shared__ float s_run32[NR32 > 0 ? NR32 : 1];
  __shared__ float s_total;

  const int kind = RdoqRegs<N>::KINDS == 3 && rq.scan == 3
                       ? mode_scan_kind(mode) : 0;
  const int k = of_kind(rr.k, kind);
  const float g = rr.g;
  const float sig0 = of_kind(rr.sig0, kind);
  const float sig1 = of_kind(rr.sig1, kind);
  const float last_bits = of_kind(rr.last_bits, kind);
  const int a = level < 0 ? -level : level;
  const int sgn = level > 0 ? 1 : level < 0 ? -1 : 0;

  // --- stage A: the level trim; its costs first, while the block
  // gathers at the max's exchange ----------------------------------------
  const float cf = __int2float_rn(coeff);
  auto dist = [&](int aa) {
    const float d =
        __fsub_rn(cf, __int2float_rn(dequant_level(sgn * aa, q)));
    return __fmul_rn(__fmul_rn(g, d), d);
  };
  const int down = a > 0 ? a - 1 : 0;
  const float dist_down = dist(down);
  const float rate_down = coef_rate(down, sig0, sig1, rq);
  const float dist_a = dist(a), rate_a = coef_rate(a, sig0, sig1, rq);
  const bool cheaper_down =
      __fadd_rn(dist_down, __fmul_rn(rq.lam, rate_down)) <
      __fadd_rn(dist_a, __fmul_rn(rq.lam, rate_a));

  // the last significant scan position: a warp's max, then one exchange,
  // whose barrier also ends the forward transform's reads
  constexpr unsigned kMask = THREADS >= 32 ? 0xffffffffu : (1u << THREADS) - 1u;
  int last = __reduce_max_sync(kMask, a > 0 ? k : -1);
  if constexpr (WARPS > 1) {
    if ((t & 31) == 0) s_last[t >> 5] = last;
  }
  block_sync<THREADS>();
  if constexpr (WARPS > 1)
    last = __reduce_max_sync(0xffffffffu, s_last[xw]);
  if (last < 0) last = NN - 1;

  const bool trim = a > 0 && (a > 1 || k < last) && cheaper_down;
  const int kept = trim ? down : a;
  const float ccoef = trim ? rate_down : rate_a;
  const float dist_zero = __fmul_rn(__fmul_rn(g, cf), cf);
  s_zg[padded(k)] = __fsub_rn(dist_zero, trim ? dist_down : dist_a);
  s_cc[padded(k)] = ccoef;
  block_sync<THREADS>();

  // --- stage B: the sums in XLA's order -----------------------------------
  if constexpr (NN <= 16) {             // one left-to-right scan each
    if (t < 2) {                        // lane 0 the distortion, 1 the bits
      const float* src = t ? s_cc : s_zg;
      float* dst = t ? s_cc : s_czg;
      float v[NN];                      // every load before the stores
#pragma unroll
      for (int e = 0; e < NN; ++e) v[e] = src[e];
      float acc = v[0];
      dst[0] = acc;
#pragma unroll
      for (int e = 1; e < NN; ++e) dst[e] = acc = __fadd_rn(acc, v[e]);
      if (t == 0) s_total = acc;        // a 16-term sum is the last prefix
    }
  } else {
    if (t < 2 * NR16) {                 // the runs of 16, both arrays
      const bool bits = t >= NR16;
      const int b = 17 * (bits ? t - NR16 : t);   // padded(16 r)
      const float* src = (bits ? s_cc : s_zg) + b;
      float* dst = (bits ? s_cc : s_czg) + b;     // the bits in place
      float v[16];                      // every load before the stores
#pragma unroll
      for (int e = 0; e < 16; ++e) v[e] = src[e];
      float acc = v[0];
      dst[0] = acc;
#pragma unroll
      for (int e = 1; e < 16; ++e) dst[e] = acc = __fadd_rn(acc, v[e]);
      s_tot[t] = acc;
    } else if (t >= T32 && t < T32 + NR32) {      // the total's runs of 32
      const float* src = s_zg + 34 * (t - T32);   // padded(32 r)
      float acc = src[0];
#pragma unroll
      for (int e = 1; e < 16; ++e) acc = __fadd_rn(acc, src[e]);
#pragma unroll
      for (int e = 0; e < 16; ++e) acc = __fadd_rn(acc, src[17 + e]);
      s_run32[t - T32] = acc;
    }
    // the runs' totals to the carries' lanes, the runs of 32 to theirs
    if constexpr (2 * NR16 <= 32) {
      if (t < 32) __syncwarp();
    } else {
      if (t < 2 * NR16)
        asm volatile("bar.sync 1, %0;" ::"n"(2 * NR16) : "memory");
    }
    if (t >= T32 && t < T32 + 32) __syncwarp();
    if (t < 2) {                        // lane 0 the distortion, 1 the bits
      const float* src = s_tot + t * NR16;
      float* dst = s_carry + t * NR16;
      float acc = src[0];
      dst[0] = acc;
#pragma unroll 4
      for (int r = 1; r < NR16 - 1; ++r) dst[r] = acc = __fadd_rn(acc, src[r]);
    } else if (t == T32) {              // the runs' sums, left to right
      float acc = s_run32[0];
#pragma unroll 4
      for (int r = 1; r < NR32; ++r) acc = __fadd_rn(acc, s_run32[r]);
      s_total = acc;
    }
  }
  block_sync<THREADS>();
  const int run = k >> 4;
  float cum_zg = s_czg[padded(k)], cum_cc = s_cc[padded(k)];
  if (NN > 16 && run > 0) {
    cum_zg = __fadd_rn(s_carry[run - 1], cum_zg);
    cum_cc = __fadd_rn(s_carry[NR16 + run - 1], cum_cc);
  }
  const float total = s_total;
  const float suffix = __fsub_rn(total, cum_zg);      // over positions > k
  const float prefix = __fsub_rn(cum_cc, ccoef);      // over positions < k
  const float rate_p =
      __fadd_rn(__fadd_rn(__fadd_rn(rq.cbf1, last_bits), prefix),
                __fsub_rn(ccoef, sig1));
  int best = float_key(kept > 0
                           ? __fadd_rn(__fmul_rn(rq.lam, rate_p), suffix)
                           : CUDART_INF_F);
  int best_k = k;

  // --- the first minimum: a warp's, then one exchange -------------------
  warp_argmin<kMask>(best, best_k);
  if constexpr (WARPS > 1) {
    if ((t & 31) == 0) {
      s_min_key[t >> 5] = best;
      s_min_k[t >> 5] = best_k;
    }
    __syncthreads();                    // also: the scratch's reads end
    best = s_min_key[xw];
    best_k = s_min_k[xw];
    warp_argmin<0xffffffffu>(best, best_k);
  } else {
    block_sync<THREADS>();              // the scratch's reads end
  }
  const bool all_zero = __fadd_rn(rq.lam_cbf0, total) <= key_float(best);
  return k <= best_k && !all_zero ? sgn * kept : 0;
}
