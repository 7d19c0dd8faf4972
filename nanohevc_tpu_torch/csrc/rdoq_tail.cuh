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
// and write the same values).  A thread reads its coefficient's scan
// position, transform gain and rate-table entries from `tables`, built
// once per (N, DST, device) by the wrapper (kernels/wavefront.py,
// rdoq_tables): gain by raster position, sig0, sig1 and the last
// position's bits by scan position (float32 bits), then the scan
// position of each raster position for the diagonal, horizontal and
// vertical scans.  Under scan "mode" at N 4 and 8 the block's own mode
// picks its scan (ops.scan.mode_scan_idx).  The per-position values go
// to shared memory by scan position; block reductions find the last
// significant position and the first minimum.

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

// The largest v over the thread block.
template <int THREADS>
__device__ __forceinline__ int block_max(int v, int t, int* s_red) {
  constexpr unsigned kMask = THREADS >= 32 ? 0xffffffffu : (1u << THREADS) - 1u;
  v = __reduce_max_sync(kMask, v);
  if constexpr (THREADS > 32) {
    if ((t & 31) == 0) s_red[t >> 5] = v;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) v = max(v, s_red[w]);
  }
  return v;
}

// The lexicographic minimum of (c, k) over the thread block: the first
// minimum of c, as torch.argmin takes it (float compares: -0 == +0).
template <int THREADS>
__device__ __forceinline__ void block_argmin(float& c, int& k, int t,
                                             float* s_c, int* s_k) {
  constexpr unsigned kMask = THREADS >= 32 ? 0xffffffffu : (1u << THREADS) - 1u;
  constexpr int SPAN = THREADS < 32 ? THREADS : 32;
#pragma unroll
  for (int h = 1; h < SPAN; h <<= 1) {
    const float oc = __shfl_xor_sync(kMask, c, h);
    const int ok = __shfl_xor_sync(kMask, k, h);
    if (oc < c || (oc == c && ok < k)) {
      c = oc;
      k = ok;
    }
  }
  if constexpr (THREADS > 32) {
    if ((t & 31) == 0) {
      s_c[t >> 5] = c;
      s_k[t >> 5] = k;
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) {
      const float oc = s_c[w];
      const int ok = s_k[w];
      if (oc < c || (oc == c && ok < k)) {
        c = oc;
        k = ok;
      }
    }
  }
}

// The RDOQ level of pixel p (raster) of the block, from its transform
// coefficient and deadzone level; `mode` is the block's decided mode.
// Every thread of the thread block must call it (it holds barriers),
// after the reads of the forward transform.  s_zg, s_cc and s_czg are
// the block's three N*N-word shared scratch arrays (the tail's s_x,
// s_a, s_b), free until its dequantizer: the distortion saved by
// zeroing, the bits, and the prefix sums of the first.  Ends in a
// barrier, so the caller may write them again.
template <int N, int THREADS>
__device__ __forceinline__ int rdoq_level(int coeff, int level, int p, int t,
                                          int mode, const RdoqArgs& rq,
                                          const QpScalars& q, float* s_zg,
                                          float* s_cc, float* s_czg) {
  constexpr int NN = N * N;
  constexpr int NR16 = NN / 16;         // prefix-sum runs
  constexpr int NR32 = NN / 32;         // total's runs (0 at N = 4)
  constexpr int W = THREADS > 32 ? THREADS / 32 : 1;
  // roles of the serial loops, in different warps where there are some
  constexpr int TB = THREADS >= 64 ? 32 : 1;
  constexpr int TC = THREADS >= 96 ? 64 : 2;
  __shared__ int s_last[W];
  __shared__ float s_min_c[W];
  __shared__ int s_min_k[W];
  __shared__ float s_tot_zg[NR16], s_tot_cc[NR16];
  __shared__ float s_carry_zg[NR16], s_carry_cc[NR16];
  __shared__ float s_run32[NR32 > 0 ? NR32 : 1];
  __shared__ float s_total;

  const int kind =
      rq.scan == 3 ? (N <= 8 ? mode_scan_kind(mode) : 0) : rq.scan;
  const float* tf = reinterpret_cast<const float*>(rq.tables);
  const int k = __ldg(rq.tables + (4 + kind) * NN + p);
  const float g = __ldg(tf + p);
  const float sig0 = __ldg(tf + NN + k);
  const float sig1 = __ldg(tf + 2 * NN + k);
  const float last_bits = __ldg(tf + 3 * NN + k);
  const int a = level < 0 ? -level : level;
  const int sgn = level > 0 ? 1 : level < 0 ? -1 : 0;

  __syncthreads();                      // the forward transform's reads end
  int last = block_max<THREADS>(a > 0 ? k : -1, t, s_last);
  if (last < 0) last = NN - 1;

  // --- stage A: the level trim ------------------------------------------
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
  const bool trim =
      a > 0 && (a > 1 || k < last) &&
      __fadd_rn(dist_down, __fmul_rn(rq.lam, rate_down)) <
          __fadd_rn(dist_a, __fmul_rn(rq.lam, rate_a));
  const int kept = trim ? down : a;
  const float ccoef = trim ? rate_down : rate_a;
  const float dist_zero = __fmul_rn(__fmul_rn(g, cf), cf);
  s_zg[k] = __fsub_rn(dist_zero, trim ? dist_down : dist_a);
  s_cc[k] = ccoef;
  __syncthreads();

  // --- stage B: the sums in XLA's order -----------------------------------
  if constexpr (NN <= 16) {             // one left-to-right scan each
    if (t == 0) {
      float acc = s_zg[0];
      s_czg[0] = acc;
      for (int e = 1; e < NN; ++e) s_czg[e] = acc = __fadd_rn(acc, s_zg[e]);
      s_total = acc;                    // a 16-term sum is the last prefix
    }
    if (t == TB) {
      float acc = s_cc[0];
      for (int e = 1; e < NN; ++e) s_cc[e] = acc = __fadd_rn(acc, s_cc[e]);
    }
    __syncthreads();
  } else {
    if (t < NR16) {                     // the distortion's runs of 16
      const int b = 16 * t;
      float acc = s_zg[b];
      s_czg[b] = acc;
#pragma unroll
      for (int e = 1; e < 16; ++e)
        s_czg[b + e] = acc = __fadd_rn(acc, s_zg[b + e]);
      s_tot_zg[t] = acc;
    } else if (t < 2 * NR16) {          // the bits' runs of 16, in place
      const int r = t - NR16, b = 16 * r;
      float acc = s_cc[b];
#pragma unroll
      for (int e = 1; e < 16; ++e)
        s_cc[b + e] = acc = __fadd_rn(acc, s_cc[b + e]);
      s_tot_cc[r] = acc;
    } else if (t < 2 * NR16 + NR32) {   // the total's runs of 32
      const int r = t - 2 * NR16, b = 32 * r;
      float acc = s_zg[b];
#pragma unroll
      for (int e = 1; e < 32; ++e) acc = __fadd_rn(acc, s_zg[b + e]);
      s_run32[r] = acc;
    }
    __syncthreads();
    if (t == 0) {                       // carries over the runs
      float acc = s_tot_zg[0];
      s_carry_zg[0] = acc;
      for (int r = 1; r < NR16 - 1; ++r)
        s_carry_zg[r] = acc = __fadd_rn(acc, s_tot_zg[r]);
    }
    if (t == TB) {
      float acc = s_tot_cc[0];
      s_carry_cc[0] = acc;
      for (int r = 1; r < NR16 - 1; ++r)
        s_carry_cc[r] = acc = __fadd_rn(acc, s_tot_cc[r]);
    }
    if (t == TC) {                      // the runs' sums, left to right
      float acc = s_run32[0];
      for (int r = 1; r < NR32; ++r) acc = __fadd_rn(acc, s_run32[r]);
      s_total = acc;
    }
    __syncthreads();
  }
  const int run = k >> 4;
  float cum_zg = s_czg[k], cum_cc = s_cc[k];
  if (NN > 16 && run > 0) {
    cum_zg = __fadd_rn(s_carry_zg[run - 1], cum_zg);
    cum_cc = __fadd_rn(s_carry_cc[run - 1], cum_cc);
  }
  const float total = s_total;
  const float suffix = __fsub_rn(total, cum_zg);      // over positions > k
  const float prefix = __fsub_rn(cum_cc, ccoef);      // over positions < k
  const float rate_p =
      __fadd_rn(__fadd_rn(__fadd_rn(rq.cbf1, last_bits), prefix),
                __fsub_rn(ccoef, sig1));
  float best = kept > 0 ? __fadd_rn(__fmul_rn(rq.lam, rate_p), suffix)
                        : CUDART_INF_F;
  int best_k = k;
  block_argmin<THREADS>(best, best_k, t, s_min_c, s_min_k);
  const bool all_zero = __fadd_rn(rq.lam_cbf0, total) <= best;
  __syncthreads();                      // the scratch's reads end
  return k <= best_k && !all_zero ? sgn * kept : 0;
}
