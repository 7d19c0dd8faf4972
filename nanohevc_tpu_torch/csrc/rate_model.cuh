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
// Layout (row_tail.cuh's): a candidate block is a group of N
// neighbouring lanes of one warp, lane i holding row i; the counts and
// the bits are warp-level work with no thread-block barrier.
// Float32 as the host computes it: every add, multiply and divide is
// written __fadd_rn / __fsub_rn / __fmul_rn / __fdiv_rn, which nvcc
// never contracts into an FMA, in the host's association; each
// transcendental (log2, log, pow(31/32, t)) is taken in float64 and
// rounded once to float32, as numpy does on the host.  CUDA's float64
// log and log2, and pow_31_32's exp2 form, are within 1-2 ulp of the
// exact value, so the
// float32 result is the host's unless the float64 value lies within a
// few float64 ulp of a float32 rounding midpoint; chip_smoke.py's price
// sweep holds the device prices to the host's over every (n1, n) with
// n <= 4096 and 10^7 seeded pairs up to 2^21.

#pragma once

#include <cuda_runtime.h>

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

// 0.96875^x in float64, as pow(0.96875, x) gives it to a couple of ulp:
// exp2 of x * log2(31/32), the product kept in double-double (log2(31/32)
// as kHi + kLo, the rounding error of x * kHi recovered by an FMA), and
// exp2(hi + lo) as exp2(hi) * (1 + lo * ln 2).  One exp2 instead of
// pow's logarithm and exponential.
__device__ __forceinline__ double pow_31_32(double x) {
  constexpr double kHi = -0.04580368961312479, kLo = -2.5450972276520026e-18;
  const double hi = x * kHi;
  const double lo = fma(x, kHi, -hi) + x * kLo;
  const double e = exp2(hi);
  return fma(e, lo * 0.69314718055994531, e);
}

// _ctx_total of a context that saw n bins, n1 of them ones, with
// p = (n1 + 0.5) / (n + 1) and l1 = log2(p), l0 = log2(1 - p) as the
// caller rounded them.
__device__ __forceinline__ float ctx_total(float n1, float n, float p,
                                           float l1, float l0,
                                           const RateConsts& rc) {
  const float n0 = __fsub_rn(n, n1);
  // x / 0.5 and x / 0.03125 below are x * 2 and x * 32, exactly
  const float arg = __fmul_rn(fmaxf(p, 1e-6f), 2.0f);
  float ts = __fdiv_rn(__double2float_rn(log((double)arg)), rc.log_gamma);
  ts = fminf(fmaxf(ts, 0.0f), n);                     // np.clip(t, 0, n)
  const float pw = __double2float_rn(pow_31_32((double)ts));
  const float trans = __fdiv_rn(
      __fmul_rn(__fmul_rn(0.5f, __fsub_rn(1.0f, pw)), 32.0f), rc.ln2);
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

// The counters context k of a batch is priced from: (n1, n).
template <int NN>
__device__ __forceinline__ void context_counters(int k, int& i1, int& i0) {
  using D = RateDims<NN>;
  constexpr int M = D::M;
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
}

// Price context k (0 .. K-1) of a batch from its counters n1 and n
// (context_counters' pair) into `P`.  The prefix contexts' ones prices
// (k = 2 .. M+1) go into no field: they are returned through c1 for the
// caller's cum1 scan.
template <int NN>
__device__ __forceinline__ void price_context(int k, int n1, int n,
                                              Prices<RateDims<NN>::M>& P,
                                              const RateConsts& rc,
                                              float& c1) {
  constexpr int M = RateDims<NN>::M;
  float c0;
  ctx_prices(__int2float_rn(n1), __int2float_rn(n), rc, c1, c0);
  if (k == 0) {
    P.cbf1 = c1, P.cbf0 = c0;
  } else if (k == 1) {
    P.lf1 = c1, P.lf0 = c0;
  } else if (k < 2 + M) {
    P.lp0[k - 2] = c0;
  } else if (k < 34 + M) {
    P.sig1[k - 2 - M] = c1, P.sig0[k - 2 - M] = c0;
  } else if (k == 34 + M) {
    P.g11 = c1, P.g10 = c0;
  } else {
    P.g21 = c1, P.g20 = c0;
  }
}

// The cum1 scan of adaptive_prices, by the warp whose lanes 2 .. M+1
// priced the prefix contexts (their ones prices in c1): a sequential
// float32 sum in lane 0.  Every lane of the warp must call it.
template <int M>
__device__ __forceinline__ void prefix_scan(float c1, int lane,
                                            Prices<M>& P) {
  float v[M];
#pragma unroll
  for (int i = 0; i < M; ++i) v[i] = __shfl_sync(0xffffffffu, c1, 2 + i);
  if (lane == 0) {
    float acc = 0.0f;
    P.cum1[0] = acc;
#pragma unroll
    for (int i = 0; i < M; ++i) P.cum1[i + 1] = acc = __fadd_rn(acc, v[i]);
    P.lp0[M] = 0.0f;
  }
}

// A level's magnitude as the bits need it, in a byte: 0, 1, 2, or 3 + e
// for a > 2 with e EG0's floor(log2(a - 2)) and XLA's deviations
// (eg0_bits(a) == 2e + 1).
__device__ __forceinline__ int level_code(int a) {
  const int x = max(a - 2, 1);
  const int e = 31 - __clz(x) - (x == 8192 || x == 32768) +
                (x == 2097151 || x == 4194303);
  return a <= 2 ? a : 3 + e;
}

// What a candidate block's bins need, reduced over its N lanes (every
// lane of the group gets it): the last significant diag-packed
// position (-1 for none), the significance of positions 0..30 as bits,
// (significant | > 1 << 16) counts and the > 2 count.
struct RowStats {
  int last;
  unsigned sig31;
  int sig_gt1, gt2;
};

// The bins of a warp's candidate blocks, lane by lane: lane k < 31
// holds sig context k (emitted, significant), lane k < M the last
// position's prefix bin k (ones, totals), and each group's first lane
// the group's scalars (16-bit fields), by batch.
template <int NB>
struct WarpBins {
  int tot[NB] = {}, ones[NB] = {}, p1[NB] = {}, p0[NB] = {};
  int sa[NB] = {}, sb[NB] = {}, sc[NB] = {}, sd[NB] = {};
};

// Add the bins of the warp's candidate blocks (32 / N groups of N lanes,
// each lane holding its group's stats; `info`: bit 0 valid, bit 1 its
// batch) to the warp's registers: each group's counts as bit masks (sig
// contexts 0..30 emitted and significant, the prefix bins), lane k
// gathering bit k of every group's masks, and the group's scalars in
// its first lane.  No shared memory, no branch on the lane.  Every lane
// of the warp must call it.
template <int N, int NB>
__device__ __forceinline__ void count_candidates(const RowStats& st, int info,
                                                 int lane, WarpBins<NB>& acc) {
  constexpr int NN = N * N, GW = 32 / N;
  constexpr int M = RateDims<NN>::M;
  constexpr unsigned kAll = 0xffffffffu;
  const bool coded = st.last >= 0;
  const int li = coded ? st.last : NN - 1;
  int klen = 0;
#pragma unroll
  for (int k = 1; k <= M; ++k) klen += (li + 1) >= (1 << k);
  const bool full = coded && li == NN - 1, nf = coded && !full;
  // positions 0..30 emitted (k < last), and of them the significant
  const unsigned em = !coded ? 0u : li >= 31 ? 0x7fffffffu : (1u << li) - 1u;
  const unsigned one = em & st.sig31;
  // prefix bins: ones at i < klen, totals at i <= klen
  const unsigned pm =
      nf ? ((1u << klen) - 1u) | (((2u << klen) - 1u) << 16) : 0u;
  const int nsig = st.sig_gt1 & 0xffff;
  const int tot31 = coded ? max(li - 31, 0) : 0;
  const int one31 = coded ? nsig - __popc(st.sig31) - (li >= 31) : 0;
#pragma unroll
  for (int h = 0; h < GW; ++h) {
    const int src = h * N;
    const unsigned e = __shfl_sync(kAll, em, src);
    const unsigned o = __shfl_sync(kAll, one, src);
    const unsigned pv = __shfl_sync(kAll, pm, src);
    const int iv = __shfl_sync(kAll, info, src);
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const bool take = (iv & 1) && (iv >> 1) == b;
      acc.tot[b] += take ? (e >> lane) & 1u : 0u;
      acc.ones[b] += take ? (o >> lane) & 1u : 0u;
      acc.p1[b] += take && lane < M ? (pv >> lane) & 1u : 0u;
      acc.p0[b] += take && lane < M ? (pv >> (16 + (lane & 15))) & 1u : 0u;
    }
  }
  const bool lead = (info & 1) && (lane % N) == 0;
  // 16-bit fields: a warp's groups hold 32 N <= 1024 positions a round;
  // the fields are summed over the warp once, at the flush
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const bool mine = lead && (info >> 1) == b;
    acc.sa[b] += mine ? tot31 | one31 << 16 : 0;
    acc.sb[b] += mine ? st.sig_gt1 : 0;
    acc.sc[b] += mine ? st.gt2 | 1 << 16 : 0;
    acc.sd[b] += mine ? coded | full << 16 : 0;
  }
}

// Store the warp's bins into its own KC counters a batch (`s_w`, NB x
// KC ints), each counter by exactly one lane, zeros included: lanes
// 24..31 the scalars, summed over the warp.  Every lane must call it.
template <int N, int NB>
__device__ __forceinline__ void store_bins(const WarpBins<NB>& acc, int lane,
                                           int* s_w) {
  using D = RateDims<N * N>;
  constexpr int M = D::M;
  constexpr unsigned kAll = 0xffffffffu;
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const int sa = __reduce_add_sync(kAll, acc.sa[b]);
    const int sb = __reduce_add_sync(kAll, acc.sb[b]);
    const int sc = __reduce_add_sync(kAll, acc.sc[b]);
    const int sd = __reduce_add_sync(kAll, acc.sd[b]);
    int* c = s_w + b * D::KC;
    if (lane < 31) {
      c[D::kSigTot + lane] = acc.tot[b];
      c[D::kSigOnes + lane] = acc.ones[b];
    }
    if (lane < M) {
      c[D::kPrefOnes + lane] = acc.p1[b];
      c[D::kPrefTot + lane] = acc.p0[b];
    }
    // the scalars, one a lane of lanes 24..31, chosen without a branch
    const int sv = lane == 31 ? sa & 0xffff : lane == 30 ? sa >> 16
                 : lane == 29 ? sb & 0xffff : lane == 28 ? sb >> 16
                 : lane == 27 ? sc & 0xffff : lane == 26 ? sc >> 16
                 : lane == 25 ? sd & 0xffff : sd >> 16;
    const int si = lane == 31 ? D::kSigTot + 31 : lane == 30 ? D::kSigOnes + 31
                 : lane == 29 ? D::kSig : lane == 28 ? D::kGt1
                 : lane == 27 ? D::kGt2 : lane == 26 ? D::kRows
                 : lane == 25 ? D::kCoded : D::kFull;
    if (lane >= 24) c[si] = sv;
  }
}

// The tail of adaptive_bits of a candidate block, by its group of N
// lanes, once each position's cost is in s_per (position k at
// k + k / 32): ordered_sum's runs of 32 (16 at N = 4) left to right, one
// lane a run, the runs left to right, then the last position's and the
// cbf bits.  Returns the bits in every lane of the group; every lane of
// the warp must call it.
template <int N>
__device__ __forceinline__ float sum_bits(const float* s_per, int last,
                                          const Prices<RateDims<N * N>::M>& P,
                                          int i, int base) {
  constexpr int NN = N * N, M = RateDims<NN>::M;
  constexpr int RUN = NN < 32 ? NN : 32;     // ordered_sum's runs
  constexpr int NR = NN / RUN;
  __syncwarp();
  float run = 0.0f;
  if (i < NR) {                          // run i, left to right
    const float* r = s_per + RUN * i + i;
    run = r[0];
#pragma unroll 8
    for (int e = 1; e < RUN; ++e) run = __fadd_rn(run, r[e]);
  }
  float sum = __shfl_sync(0xffffffffu, run, base);
#pragma unroll
  for (int r = 1; r < NR; ++r)
    sum = __fadd_rn(sum, __shfl_sync(0xffffffffu, run, base + r));
  __syncwarp();                          // s_per's reads end
  const bool coded = last >= 0;
  const int lastidx = coded ? last : NN - 1;
  int klen = 0;
#pragma unroll
  for (int k = 1; k <= M; ++k) klen += (lastidx + 1) >= (1 << k);
  const bool full = coded && lastidx == NN - 1;
  const float prefix = __fadd_rn(P.cum1[klen], klen < M ? P.lp0[klen] : 0.0f);
  const float last_cost =
      full ? P.lf1 : __fadd_rn(__fadd_rn(P.lf0, prefix), (float)klen);
  return coded ? __fadd_rn(__fadd_rn(P.cbf1, last_cost), sum) : P.cbf0;
}

// The cost of one position under adaptive_bits: its significance bin
// where it is emitted (before the last position), then > 1, > 2 and
// EG0's bits (level_code's `code`), and the sign.
template <int M>
__device__ __forceinline__ float position_bits(int code, int k, bool coded,
                                               int lastidx,
                                               const Prices<M>& P) {
  const int ctx = k < 31 ? k : 31;
  const float cost_sig =
      coded && k < lastidx ? (code > 0 ? P.sig1[ctx] : P.sig0[ctx]) : 0.0f;
  float tail = 0.0f;
  if (code > 0) {
    const float eg0 = __fadd_rn(__fmul_rn(2.0f, (float)(code - 3)), 1.0f);
    const float gt =
        code > 1 ? __fadd_rn(P.g11, code > 2 ? __fadd_rn(P.g21, eg0) : P.g20)
                 : P.g10;
    tail = __fadd_rn(gt, 1.0f);
  }
  return __fadd_rn(cost_sig, tail);
}

// adaptive_bits of one candidate block by its group of N lanes (lane i
// of the group, `base` the warp lane of its row 0): `codes` its NN
// level_code bytes by diag-packed position, `last` its last
// significant position (-1 for none), `s_per` the group's NN + NN/32
// floats of shared scratch; lane i prices positions i, i + N, ....
// Returns the bits in every lane of the group; every lane of the warp
// must call it.
template <int N>
__device__ __forceinline__ float group_bits(const unsigned char* codes,
                                            int last,
                                            const Prices<RateDims<N * N>::M>& P,
                                            float* s_per, int i, int base) {
  constexpr int NN = N * N;
  const bool coded = last >= 0;
  const int lastidx = coded ? last : NN - 1;
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const int k = i + N * e;
    s_per[k + (k >> 5)] = position_bits(codes[k], k, coded, lastidx, P);
  }
  return sum_bits<N>(s_per, last, P, i, base);
}
