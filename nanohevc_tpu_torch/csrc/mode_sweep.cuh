// The mode search of one block, shared by the open-loop search
// (mode_search.cu, K2a+K2b: the 35 modes by SATD) and the closed loop's
// search and pair bodies (wavefront.cu: the 35 modes, or DC and planar,
// by energy, SAD or SATD): bit for bit decide_modes of the JAX package
// (nanohevc_tpu/models/all_intra.py; ops/metrics.py for the costs):
//   planar with T[N] / L[N] (corner-at-0) as top-right / bottom-left;
//   DC = floor((sum + N) / 2N);
//   angular 2..34 from a per-mode reference array of 3N+1 samples with
//   the negative-angle extension ref[N+i] = side[((i+1)*inv + 128) >> 8],
//   then ((32-f)*a + f*b + 16) >> 5 with the idx+1 read clamped at 3N;
//   SATD = sum |H.D.H^T| with the Sylvester Walsh-Hadamard matrix H,
//   SAD = sum |D|, energy = sum D^2, each an int32 sum that wraps as
//   the plain version's int64 sum cast to int32 does;
//   strict < in mode order 0..34, so ties go to the lowest index; of the
//   pair (mode_set="dc_planar"), DC unless planar costs strictly less;
//   with luma smoothing, the modes whose bit of the caller's filter mask
//   is set (planar included) read the filtered references
//   (intra_smooth.cuh), DC never.
// The projections shift negative ints right (proj >> 5 with a negative
// angle); this relies on nvcc's >> on signed int being arithmetic, as
// it is on every NVIDIA target.
//
// Design.  The modes are spread over groups of N lanes, one group per
// mode at a time: the BT threads that serve a block form BT / N groups,
// and group g takes modes g, g + BT/N, ... in rising order, so a block
// is a few passes (2-9, by N and BT) with no barrier inside.  A group
// first builds its mode's projection array (3N+1 samples, about 3 a
// lane) in shared memory, then synchronises its warp.  Lane r of
// a group holds one line of the residual in N registers: row r for
// planar, DC and the vertical modes 18..34, column r for the horizontal
// modes 2..17.  A horizontal mode's prediction along a column is the
// vertical formula with the axes swapped, so both families run one
// code path (one fraction and one run of N+1 reference reads a lane),
// and the SATD of the transposed residual is the same sum, since H is
// symmetric.  The WHT is log2 N XOR-butterfly stages in registers along
// the line, then log2 N stages across the group's lanes with
// __shfl_xor_sync: Sylvester order gives H.D.H^T exactly (int32 adds
// wrap alike in any order).  |.| is summed in the lane, then across the
// group with shuffles.  The winner is the lexicographic minimum of
// (cost, mode) over the groups: shuffles within a warp, then one
// shared-memory step across the block's warps; it is the packed key
// cost * 64 + mode where that fits int32 for every possible SATD
// (mode_search_slab.py::_packed_min_ok: N^3 * max_pix * 64 + 34 <
// 2^31), else the pair.  The caller recomputes the winner's prediction
// per pixel for the tail (predict_pixel).
//
// Each .cu under csrc/ is its own shared library, so this header
// defines the __constant__ table of each library that includes it:
// the transform matrices (encode_tail.cuh), then intraPredAngle of
// modes 2..34, then invAngle of modes 2..34 (0 where the angle is not
// negative).

#pragma once

#include "encode_tail.cuh"

constexpr int kNumAngular = 33;
constexpr int kAngleOffset = kTransformInts;
constexpr int kInvAngleOffset = kTransformInts + kNumAngular;
constexpr int kTableInts = kTransformInts + 2 * kNumAngular;
__constant__ int c_tables[kTableInts];

// Shared scratch of one block's search, served by BT threads.
template <int N, int BT>
struct SweepScratch {
  int mref[kNumAngular][3 * N + 1];     // the 33 projection arrays
  int x[N * (N + 1)];                   // the block's pixels, row stride N+1
  int best[2][BT > 32 ? BT / 32 : 1];   // per warp: key or (cost, mode)
};

// The per-block costs of decide_modes' decisions.
constexpr int kCostEnergy = 0, kCostSad = 1, kCostSatd = 2;

// Whether cost * 64 + rank fits int32 for every cost at this bit depth
// (cost >= 0: SATD <= N^3 max_pix, SAD <= N^2 max_pix, energy <= N^2
// max_pix^2, which wraps in int32 beyond that).
template <int N, int COST = kCostSatd>
__device__ __forceinline__ bool packed_min_ok(int max_pix) {
  const long long m = max_pix;
  const long long bound = COST == kCostSatd  ? (long long)N * N * N * m
                          : COST == kCostSad ? (long long)N * N * m
                                             : (long long)N * N * m * m;
  return bound * 64 + 34 < (1LL << 31);
}

// a + b mod 2^32, as the plain version's int64 sums cast to int32 give
__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

// Planar's prediction of pixel (i, j).
template <int N>
__device__ __forceinline__ int planar_pixel(const int* ref, int i, int j) {
  const int* top = ref;
  const int* left = ref + 2 * N + 1;
  return ((N - 1 - j) * left[1 + i] + (j + 1) * top[N] +
          (N - 1 - i) * top[1 + j] + (i + 1) * left[N] + N) >>
         (Log2<N>::value + 1);
}

template <int N>
__device__ __forceinline__ int dc_value(const int* ref) {
  int sum = 0;
#pragma unroll
  for (int k = 1; k <= N; ++k) sum += ref[k] + ref[2 * N + 1 + k];
  return floor_div(sum + N, 2 * N);
}

// Sample e (0 .. 3N) of angular `mode`'s projection array
// (angular_tables.py src): ref[N + i] for i in -N..2N, the primary arm
// at i >= 0 (i = 0 is the corner); below 0, the extension from the
// other arm where the angle is negative and i >= (N * angle) >> 5, else
// the corner.  `ref` is the block's extract_refs layout.
template <int N>
__device__ __forceinline__ int projection_sample(const int* ref, int mode,
                                                 int e) {
  constexpr int R = 2 * N + 1;
  const int m = mode - 2;
  const int angle = c_tables[kAngleOffset + m];
  const bool vertical = mode >= 18;
  const int prim = vertical ? 0 : R, sec = vertical ? R : 0;
  const int pos = e - N;
  if (pos >= 0) return ref[prim + pos];
  if (angle < 0 && pos >= ((N * angle) >> 5))
    return ref[sec + (((pos + 1) * c_tables[kInvAngleOffset + m] + 128) >> 8)];
  return ref[0];
}

// Angular `mode`'s prediction of pixel (i, j) from its projection
// array `proj` (3N+1 samples, projection_sample's).
template <int N>
__device__ __forceinline__ int angular_pixel(const int* proj, int mode, int i,
                                             int j) {
  const int angle = c_tables[kAngleOffset + mode - 2];
  const bool vertical = mode >= 18;
  const int scan = vertical ? i : j, base = vertical ? j : i;
  const int p = (scan + 1) * angle;
  const int frac = p & 31;
  const int idx = N + base + 1 + (p >> 5);
  const int a = proj[idx];
  const int b = proj[min(idx + 1, 3 * N)];
  return ((32 - frac) * a + frac * b + 16) >> 5;
}

// The prediction of pixel (i, j) under `mode`, from the block's
// references (planar from `pl_ref`, the filtered ones where planar
// filters) and its projection arrays (as mode_sweep left them).
template <int N>
__device__ __forceinline__ int predict_pixel(const int* ref, const int* pl_ref,
                                             const int (*mref)[3 * N + 1],
                                             int mode, int i, int j) {
  if (mode == 0) return planar_pixel<N>(pl_ref, i, j);
  if (mode == 1) return dc_value<N>(ref);
  return angular_pixel<N>(mref[mode - 2], mode, i, j);
}

template <int N>
__device__ __forceinline__ int predict_pixel(const int* ref,
                                             const int (*mref)[3 * N + 1],
                                             int mode, int i, int j) {
  return predict_pixel<N>(ref, ref, mref, mode, i, j);
}

// Search one N x N block with the BT threads t = 0 .. BT-1 that serve
// it (BT a multiple of N, at least N*N, and of 32 when above it), in a
// thread block of THREADS threads, over M candidates: the 35 modes
// (M = 35), or DC and planar (M = 2, ties to DC), by COST.  `ref` is
// the block's 4N+2 references in shared memory (extract_refs layout:
// top arm at 0..2N, corner at 0, left arm at 2N+1..4N+1), `fref` the
// same filtered (or `ref` itself), read by the modes whose bit of
// `filter_mask` is set; s.x holds the block's pixels, x[i * (N+1) + j].
// Every thread of the thread block must call it (it holds barriers),
// after a barrier that follows the writes of `ref`, `fref` and s.x.
// Fills s.mref and returns the winning mode, the same for every thread
// of the block.
template <int N, int BT, int THREADS, int COST, int M>
__device__ __forceinline__ int mode_sweep(const int* ref, const int* fref,
                                          unsigned long long filter_mask,
                                          SweepScratch<N, BT>& s, int t,
                                          int max_pix) {
  constexpr int L = 3 * N + 1;          // a mode's projection array
  constexpr int G = BT / N;             // groups, one candidate each a pass
  constexpr int SPAN = BT < 32 ? BT : 32;   // a block's lanes in a warp
  constexpr int S = N + 1;              // row stride of s.x
  constexpr unsigned kMask = THREADS >= 32 ? 0xffffffffu : (1u << THREADS) - 1u;
  static_assert(BT % N == 0 && BT >= N * N && G <= 34, "threads per block");
  static_assert(M == 35 || M == 2, "the 35 modes or the pair");

  const int dc = dc_value<N>(ref);      // DC reads the raw references
  const int* pl_ref = (filter_mask & 1ull) ? fref : ref;

  // --- the passes: group g codes candidate base + g, lane r one line --
  // A candidate's rank is its mode (M = 35) or DC 0, planar 1 (M = 2).
  const int g = t / N, r = t % N;
  const int warp_g0 = (t & ~31) / N;    // first group of this warp
  int best_cost = 0x7fffffff, best_rank = 0;
#pragma unroll 1
  for (int base = 0; base < M; base += G) {
    if (base + warp_g0 >= M) break;     // uniform: the warp has no mode
    const int rank = min(base + g, M - 1);
    const bool real = base + g < M;
    const int mode = M == 35 ? rank : 1 - rank;
    const int m = mode - 2;
    // The group's projection array; groups past the last candidate
    // neither build nor keep anything.
    const int angle = mode >= 2 ? c_tables[kAngleOffset + m] : 0;
    const bool vertical = mode >= 18;
    if (mode >= 2 && real) {
      const int* src = (filter_mask >> mode) & 1ull ? fref : ref;
      for (int e = r; e < L; e += N)
        s.mref[m][e] = projection_sample<N>(src, mode, e);
    }
    __syncwarp(kMask);                  // the group's array is complete
    int v[N];
    if (mode < 2) {                     // planar or DC, lane r = row r
#pragma unroll
      for (int k = 0; k < N; ++k)
        v[k] = s.x[r * S + k] -
               (mode == 0 ? planar_pixel<N>(pl_ref, r, k) : dc);
    } else {                            // lane r = row (vertical) or column
      const int proj = (r + 1) * angle;
      const int frac = proj & 31;
      const int idx = N + 1 + (proj >> 5);
      const int* a = s.mref[m];
      const int* xs = s.x + (vertical ? r * S : r);
      const int step = vertical ? 1 : S;
      int prev = a[idx];
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const int next = a[min(idx + k + 1, 3 * N)];
        v[k] = xs[k * step] - (((32 - frac) * prev + frac * next + 16) >> 5);
        prev = next;
      }
    }
    int cost = 0;
    if constexpr (COST == kCostSatd) {
      // WHT along the line, in registers
#pragma unroll
      for (int h = 1; h < N; h <<= 1) {
#pragma unroll
        for (int k = 0; k < N; ++k) {
          if (k & h) continue;
          const int lo = v[k], hi = v[k + h];
          v[k] = lo + hi;
          v[k + h] = lo - hi;
        }
      }
      // WHT across the group's lanes; the upper lane keeps lo - hi
#pragma unroll
      for (int h = 1; h < N; h <<= 1) {
        const int sign = r & h ? -1 : 1;
#pragma unroll
        for (int k = 0; k < N; ++k)
          v[k] = __shfl_xor_sync(kMask, v[k], h) + sign * v[k];
      }
#pragma unroll
      for (int k = 0; k < N; ++k) cost += v[k] < 0 ? -v[k] : v[k];
    } else if constexpr (COST == kCostSad) {
#pragma unroll
      for (int k = 0; k < N; ++k) cost += v[k] < 0 ? -v[k] : v[k];
    } else {
      unsigned acc = 0;
#pragma unroll
      for (int k = 0; k < N; ++k) acc += (unsigned)v[k] * (unsigned)v[k];
      cost = (int)acc;
    }
#pragma unroll
    for (int h = 1; h < N; h <<= 1)
      cost = wrap_add(cost, __shfl_xor_sync(kMask, cost, h));
    if (real && cost < best_cost) {     // ranks rise in a group
      best_cost = cost;
      best_rank = rank;
    }
  }

  // --- the winner: lexicographic (cost, rank) minimum over groups ------
  int rank;
  if (packed_min_ok<N, COST>(max_pix)) {   // uniform over the launch
    // a group that had no candidate (the pair's groups past rank 1)
    // keeps the largest key
    int key = best_cost == 0x7fffffff ? 0x7fffffff
                                      : best_cost * 64 + best_rank;
#pragma unroll
    for (int h = N; h < SPAN; h <<= 1)
      key = min(key, __shfl_xor_sync(kMask, key, h));
    if constexpr (BT > 32) {            // each warp takes the warps' min
      if ((t & 31) == 0) s.best[0][t >> 5] = key;
      __syncthreads();
      key = (t & 31) < BT / 32 ? s.best[0][t & 31] : 0x7fffffff;
#pragma unroll
      for (int h = 16; h > 0; h >>= 1)
        key = min(key, __shfl_xor_sync(kMask, key, h));
    }
    __syncwarp(kMask);                  // the winner's array, BT <= 32
    rank = key & 63;
  } else {
    int cost = best_cost;
    rank = best_rank;
#pragma unroll
    for (int h = N; h < SPAN; h <<= 1) {
      const int oc = __shfl_xor_sync(kMask, cost, h);
      const int orank = __shfl_xor_sync(kMask, rank, h);
      if (oc < cost || (oc == cost && orank < rank)) {
        cost = oc;
        rank = orank;
      }
    }
    if constexpr (BT > 32) {
      if ((t & 31) == 0) {
        s.best[0][t >> 5] = cost;
        s.best[1][t >> 5] = rank;
      }
      __syncthreads();
      const bool real = (t & 31) < BT / 32;
      cost = real ? s.best[0][t & 31] : 0x7fffffff;
      rank = real ? s.best[1][t & 31] : 0;
#pragma unroll
      for (int h = 16; h > 0; h >>= 1) {
        const int oc = __shfl_xor_sync(kMask, cost, h);
        const int orank = __shfl_xor_sync(kMask, rank, h);
        if (oc < cost || (oc == cost && orank < rank)) {
          cost = oc;
          rank = orank;
        }
      }
    }
    __syncwarp(kMask);
  }
  return M == 35 ? rank : 1 - rank;
}

// The 35-mode SATD search on unfiltered references (K2's form).
template <int N, int BT, int THREADS>
__device__ __forceinline__ int mode_sweep(const int* ref,
                                          SweepScratch<N, BT>& s, int t,
                                          int max_pix) {
  return mode_sweep<N, BT, THREADS, kCostSatd, 35>(ref, ref, 0ull, s, t,
                                                   max_pix);
}
