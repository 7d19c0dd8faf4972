// The adaptive rate model of the RD decision on the card (the closed
// loop's decision="rd", wavefront_rd.cu): bit for bit the port's
// ops/rate.py, which is the JAX package's nanohevc_tpu/ops/rate.py with
// its prices taken on the host:
//   the bin counts of a batch of diag-packed rows, exact integers, in
//     the layout of adaptive_counts (rows, coded rows, full rows, the
//     last position's prefix ones and totals (M each), sig ones and
//     totals (32 contexts each), significant, > 1 and > 2 levels);
//   each context's prices from its counts, in the arithmetic of
//     _ctx_total / _prices, and the sequential float32 cum1 scan of
//     adaptive_prices;
//   a row's bits at those prices, in the order of adaptive_bits, the
//     per-position sum in ordered_sum's runs of 32 (EG0's floor(log2)
//     with XLA's deviations: rdoq_tail.cuh's eg0_bits).
// Float32 as the host computes it: every add, multiply and divide is
// written __fadd_rn / __fsub_rn / __fmul_rn / __fdiv_rn, which nvcc
// never contracts into an FMA, in the host's association; each
// transcendental (log2, log, pow(31/32, t)) is taken in float64 and
// rounded once to float32, as numpy does on the host.  CUDA's float64
// log, log2 and pow are within 1-2 ulp of the exact value, so the
// float32 result is the host's unless the float64 value lies within a
// few float64 ulp of a float32 rounding midpoint; chip_smoke.py's price
// sweep holds the device prices to the host's over every (n1, n) with
// n <= 4096 and 10^7 seeded pairs up to 2^21.

#pragma once

#include "rdoq_tail.cuh"   // eg0_bits, block_max

// The model's sizes for NN coefficients: M = floor(log2(max(NN-1, 2)))
// prefix bins of the last position, KC counters, K priced contexts.
template <int NN>
struct RateDims {
  static constexpr int M = NN == 16 ? 3 : NN == 64 ? 5 : NN == 256 ? 7 : 9;
  static constexpr int KC = 70 + 2 * M;
  static constexpr int K = 36 + M;
  // counter offsets (adaptive_counts' layout)
  static constexpr int kRows = 0, kCoded = 1, kFull = 2, kPrefOnes = 3,
                       kPrefTot = 3 + M, kSigOnes = 3 + 2 * M,
                       kSigTot = 35 + 2 * M, kSig = 67 + 2 * M,
                       kGt1 = 68 + 2 * M, kGt2 = 69 + 2 * M;
};

// float32(log(31/32)) and float32(log(2)), as the host rounds them
// (passed in, so that the host's own constants are used).
struct RateConsts {
  float log_gamma, ln2;
};

__device__ __forceinline__ float rounded_log2(float x) {
  return __double2float_rn(log2((double)x));
}

// _ctx_total of a context that saw n bins, n1 of them ones, with
// p = (n1 + 0.5) / (n + 1) and l1 = log2(p), l0 = log2(1 - p) as the
// caller rounded them.
__device__ __forceinline__ float ctx_total(float n1, float n, float p,
                                           float l1, float l0,
                                           const RateConsts& rc) {
  const float n0 = __fsub_rn(n, n1);
  const float arg = __fdiv_rn(fmaxf(p, 1e-6f), 0.5f);
  float ts = __fdiv_rn(__double2float_rn(log((double)arg)), rc.log_gamma);
  ts = fminf(fmaxf(ts, 0.0f), n);                     // np.clip(t, 0, n)
  const float pw = __double2float_rn(pow(0.96875, (double)ts));
  const float trans = __fdiv_rn(
      __fdiv_rn(__fmul_rn(0.5f, __fsub_rn(1.0f, pw)), 0.03125f), rc.ln2);
  const float e1 = n1 > 0.0f ? __fmul_rn(n1, l1) : 0.0f;
  const float e0 = n0 > 0.0f ? __fmul_rn(n0, l0) : 0.0f;
  const float ent = __fdiv_rn(-__fadd_rn(e1, e0), fmaxf(n, 1.0f));
  const float steady = __fmul_rn(fmaxf(__fsub_rn(n, ts), 0.0f), ent);
  return n > 0.0f ? __fadd_rn(trans, steady) : 0.0f;
}

// _prices of one context: the per-bin costs (ones, zeros), scaled so
// that the context's total matches ctx_total.
__device__ __forceinline__ void ctx_prices(float n1, float n,
                                           const RateConsts& rc, float& c1s,
                                           float& c0s) {
  const float p = __fdiv_rn(__fadd_rn(n1, 0.5f), __fadd_rn(n, 1.0f));
  const float l1 = rounded_log2(p), l0 = rounded_log2(__fsub_rn(1.0f, p));
  const float c1 = -l1, c0 = -l0;
  const float emp =
      __fadd_rn(__fmul_rn(n1, c1), __fmul_rn(__fsub_rn(n, n1), c0));
  const float scale =
      emp > 0.0f
          ? __fdiv_rn(ctx_total(n1, n, p, l1, l0, rc), fmaxf(emp, 1e-9f))
          : 1.0f;
  c1s = __fmul_rn(c1, scale);
  c0s = __fmul_rn(c0, scale);
}

// The prices of one batch (adaptive_prices' dict).
template <int M>
struct Prices {
  float cbf1, cbf0, lf1, lf0, g11, g10, g21, g20;
  float sig1[32], sig0[32];
  float cum1[M + 1], lp0[M + 1];
};

// Price a batch from its KC counters (device memory written by other
// thread blocks: read through L2) into `P`, with the T threads of the
// thread block; every thread must call it (it holds barriers).
template <int NN, int T>
__device__ __forceinline__ void price_batch(const int* counts,
                                            Prices<RateDims<NN>::M>& P,
                                            float* s_pref, int t,
                                            const RateConsts& rc) {
  using D = RateDims<NN>;
  constexpr int M = D::M;
  for (int k = t; k < D::K; k += T) {
    int i1, i0;                          // counters of (n1, n)
    if (k == 0) {
      i1 = D::kCoded, i0 = D::kRows;
    } else if (k == 1) {
      i1 = D::kFull, i0 = D::kCoded;
    } else if (k < 2 + M) {
      i1 = D::kPrefOnes + k - 2, i0 = D::kPrefTot + k - 2;
    } else if (k < 34 + M) {
      i1 = D::kSigOnes + k - 2 - M, i0 = D::kSigTot + k - 2 - M;
    } else if (k == 34 + M) {
      i1 = D::kGt1, i0 = D::kSig;
    } else {
      i1 = D::kGt2, i0 = D::kGt1;
    }
    float c1, c0;
    ctx_prices(__int2float_rn(__ldcg(counts + i1)),
               __int2float_rn(__ldcg(counts + i0)), rc, c1, c0);
    if (k == 0) {
      P.cbf1 = c1, P.cbf0 = c0;
    } else if (k == 1) {
      P.lf1 = c1, P.lf0 = c0;
    } else if (k < 2 + M) {
      s_pref[k - 2] = c1, P.lp0[k - 2] = c0;
    } else if (k < 34 + M) {
      P.sig1[k - 2 - M] = c1, P.sig0[k - 2 - M] = c0;
    } else if (k == 34 + M) {
      P.g11 = c1, P.g10 = c0;
    } else {
      P.g21 = c1, P.g20 = c0;
    }
  }
  __syncthreads();
  if (t == 0) {                          // a sequential float32 scan
    float acc = 0.0f;
    P.cum1[0] = acc;
    for (int i = 0; i < M; ++i) P.cum1[i + 1] = acc = __fadd_rn(acc, s_pref[i]);
    P.lp0[M] = 0.0f;
  }
  __syncthreads();
}

// Add one row's counts to the thread block's KC counters `s_cnt`
// (shared, zeroed by the caller): thread t < NN holds diag-packed
// position t's level magnitude `a`; threads t >= NN mirror and add
// nothing.  `last` is the row's last significant position (-1 for none),
// the same in every thread.
template <int NN, int T>
__device__ __forceinline__ void count_row(int a, int last, int t,
                                          int* s_cnt) {
  static_assert(T % 32 == 0 && T >= NN, "whole warps, a thread a position");
  using D = RateDims<NN>;
  constexpr unsigned kMask = T >= 32 ? 0xffffffffu : (1u << T) - 1u;
  const bool coded = last >= 0;
  const int lastidx = coded ? last : NN - 1;
  const bool mine = t < NN;
  if (t == 0) {
    int klen = 0;
#pragma unroll
    for (int k = 1; k <= D::M; ++k) klen += (lastidx + 1) >= (1 << k);
    const bool full = coded && lastidx == NN - 1;
    const bool nf = coded && !full;
    s_cnt[D::kRows] += 1;
    s_cnt[D::kCoded] += coded;
    s_cnt[D::kFull] += full;
#pragma unroll
    for (int i = 0; i < D::M; ++i) {
      s_cnt[D::kPrefOnes + i] += nf && klen > i;
      s_cnt[D::kPrefTot + i] += nf && klen >= i;
    }
  }
  const bool emitted = mine && coded && t < lastidx;
  const bool sig_em = emitted && a > 0;
  if (t < 31) {                          // contexts 0..30: one position each
    if (emitted) atomicAdd(s_cnt + D::kSigTot + t, 1);
    if (sig_em) atomicAdd(s_cnt + D::kSigOnes + t, 1);
  }
  // context 31 (positions >= 31) and the level totals: warp sums
  const int tot31 = __reduce_add_sync(kMask, (int)(emitted && t >= 31));
  const int one31 = __reduce_add_sync(kMask, (int)(sig_em && t >= 31));
  const int n_sig = __reduce_add_sync(kMask, (int)(mine && a > 0));
  const int n_gt1 = __reduce_add_sync(kMask, (int)(mine && a > 1));
  const int n_gt2 = __reduce_add_sync(kMask, (int)(mine && a > 2));
  if ((t & 31) == 0) {
    if (tot31) atomicAdd(s_cnt + D::kSigTot + 31, tot31);
    if (one31) atomicAdd(s_cnt + D::kSigOnes + 31, one31);
    if (n_sig) atomicAdd(s_cnt + D::kSig, n_sig);
    if (n_gt1) atomicAdd(s_cnt + D::kGt1, n_gt1);
    if (n_gt2) atomicAdd(s_cnt + D::kGt2, n_gt2);
  }
}

// adaptive_bits of one row, by one warp (`lane` 0..31): `lev` its NN
// diag-packed levels (device memory written by other thread blocks:
// read through L2), `last` its last significant position (-1 for
// none), `s_per` the warp's NN + NN/32 floats of shared scratch.
// Returns the bits in every lane.
template <int NN>
__device__ __forceinline__ float row_bits(const int* lev, int last,
                                          const Prices<RateDims<NN>::M>& P,
                                          float* s_per, int lane) {
  constexpr int M = RateDims<NN>::M;
  constexpr int E = NN < 32 ? 1 : NN / 32;   // positions a lane
  constexpr int RUN = NN < 32 ? NN : 32;     // ordered_sum's runs
  constexpr int NR = NN / RUN;
  const bool coded = last >= 0;
  const int lastidx = coded ? last : NN - 1;
#pragma unroll 4
  for (int e = 0; e < E; ++e) {
    const int k = 32 * e + lane;
    if (k < NN) {
      const int l = __ldcg(lev + k);
      const int a = l < 0 ? -l : l;
      const int ctx = k < 31 ? k : 31;
      const float cost_sig =
          coded && k < lastidx ? (a > 0 ? P.sig1[ctx] : P.sig0[ctx]) : 0.0f;
      float tail = 0.0f;
      if (a > 0) {
        const float gt =
            a > 1 ? __fadd_rn(P.g11, a > 2 ? __fadd_rn(P.g21, eg0_bits(a))
                                           : P.g20)
                  : P.g10;
        tail = __fadd_rn(gt, 1.0f);
      }
      s_per[k + (k >> 5)] = __fadd_rn(cost_sig, tail);
    }
  }
  __syncwarp();
  float run = 0.0f;
  if (lane < NR) {                       // run `lane`, left to right
    const float* r = s_per + RUN * lane + lane;
    run = r[0];
#pragma unroll 8
    for (int i = 1; i < RUN; ++i) run = __fadd_rn(run, r[i]);
  }
  float sum = __shfl_sync(0xffffffffu, run, 0);
#pragma unroll 1
  for (int i = 1; i < NR; ++i) sum = __fadd_rn(sum, __shfl_sync(0xffffffffu, run, i));
  __syncwarp();                          // s_per's reads end
  int klen = 0;
#pragma unroll
  for (int k = 1; k <= M; ++k) klen += (lastidx + 1) >= (1 << k);
  const bool full = coded && lastidx == NN - 1;
  const float prefix = __fadd_rn(P.cum1[klen], klen < M ? P.lp0[klen] : 0.0f);
  const float last_cost =
      full ? P.lf1 : __fadd_rn(__fadd_rn(P.lf0, prefix), (float)klen);
  return coded ? __fadd_rn(__fadd_rn(P.cbf1, last_cost), sum) : P.cbf0;
}
