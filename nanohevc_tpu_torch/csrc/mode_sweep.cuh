// The 35-mode SATD search of one block, shared by the open-loop search
// (mode_search.cu, K2a+K2b) and the closed loop's search body
// (wavefront.cu, K3a+K3b): bit for bit
// decide_modes(mode_set="all", decision="satd") of the JAX package:
//   planar with T[N] / L[N] (corner-at-0) as top-right / bottom-left;
//   DC = floor((sum + N) / 2N);
//   angular 2..34 from a per-mode reference array of 3N+1 samples with
//   the negative-angle extension ref[N+i] = side[((i+1)*inv + 128) >> 8],
//   then ((32-f)*a + f*b + 16) >> 5 with the idx+1 read clamped at 3N;
//   SATD = sum |H.D.H^T| with the Sylvester Walsh-Hadamard matrix H;
//   strict < in mode order 0..34, so ties go to the lowest index.
// The projections shift negative ints right (proj >> 5 with a negative
// angle); this relies on nvcc's >> on signed int being arithmetic, as
// it is on every NVIDIA target.
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

// Search one N x N block, one thread per pixel (i, j), in a thread
// block of THREADS threads.  `ref` is the block's 4N+2 references in
// shared memory (extract_refs layout: top arm at 0..2N, corner at 0,
// left arm at 2N+1..4N+1), `mref` its shared 33 x (3N+1) projection
// arrays, s_a / s_b its N*N-int shared scratch and s_part one int per
// warp of the block.  Every thread of the thread block must call it
// (it holds barriers), after a barrier that follows the writes of
// `ref`.  Returns the winning mode (the same for every pixel of the
// block) and this pixel's prediction under it.
template <int N, int THREADS>
__device__ __forceinline__ void mode_sweep(const int* ref,
                                           int (*mref)[3 * N + 1], int* s_a,
                                           int* s_b, int* s_part, int x, int i,
                                           int j, int& best_mode,
                                           int& best_pred) {
  constexpr int NN = N * N;
  constexpr int LOG2N = Log2<N>::value;
  constexpr int R = 2 * N + 1;          // one reference arm, corner at 0
  constexpr int L = 3 * N + 1;          // a mode's projection array
  constexpr int WARPS = NN > 32 ? NN / 32 : 1;   // warps per N x N block
  constexpr int LANES = NN < 32 ? NN : 32;       // lanes per block per warp
  constexpr unsigned kMask = THREADS >= 32 ? 0xffffffffu : (1u << THREADS) - 1u;
  const int p = i * N + j;

  // --- the 33 projection arrays (angular_tables.py src) ---------------
  // ref[N + i] for i in -N..2N: the primary arm at i >= 0 (i = 0 is the
  // corner); below 0, the extension from the other arm where the angle
  // is negative and i >= (N * angle) >> 5, else the corner.
  for (int e = p; e < kNumAngular * L; e += NN) {
    const int m = e / L;
    const int pos = e % L - N;
    const int angle = c_tables[kAngleOffset + m];
    const bool vertical = m + 2 >= 18;
    const int prim = vertical ? 0 : R, sec = vertical ? R : 0;
    int v;
    if (pos >= 0) {
      v = ref[prim + pos];
    } else if (angle < 0 && pos >= ((N * angle) >> 5)) {
      const int inv = c_tables[kInvAngleOffset + m];
      v = ref[sec + (((pos + 1) * inv + 128) >> 8)];
    } else {
      v = ref[0];
    }
    mref[m][e % L] = v;
  }

  // --- DC and planar, per pixel ---------------------------------------
  const int* top = ref;
  const int* left = ref + R;
  int sum = 0;
#pragma unroll
  for (int k = 1; k <= N; ++k) sum += top[k] + left[k];
  const int dc = floor_div(sum + N, 2 * N);
  const int pl = ((N - 1 - j) * left[1 + i] + (j + 1) * top[N] +
                  (N - 1 - i) * top[1 + j] + (i + 1) * left[N] + N) >>
                 (LOG2N + 1);
  __syncthreads();                      // projection arrays complete

  // --- the sweep over modes 0..34 -------------------------------------
  int best_cost = 0x7fffffff;
  best_mode = 0;
  best_pred = 0;
#pragma unroll 1
  for (int mode = 0; mode < 35; ++mode) {
    int pred;
    if (mode == 0) {
      pred = pl;
    } else if (mode == 1) {
      pred = dc;
    } else {
      const int m = mode - 2;
      const int angle = c_tables[kAngleOffset + m];
      const bool vertical = mode >= 18;
      const int scan = vertical ? i : j, base = vertical ? j : i;
      const int proj = (scan + 1) * angle;
      const int frac = proj & 31;
      const int idx = N + base + 1 + (proj >> 5);
      const int a = mref[m][idx];
      const int b = mref[m][min(idx + 1, 3 * N)];
      pred = ((32 - frac) * a + frac * b + 16) >> 5;
    }

    // SATD: column pass H.D, then row pass (H.D).H^T; H[r][c] is
    // (-1)^popcount(r & c) in Sylvester order.
    s_a[p] = x - pred;
    __syncthreads();
    int acc = 0;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int v = s_a[k * N + j];
      acc += (__popc(i & k) & 1) ? -v : v;
    }
    s_b[p] = acc;
    __syncthreads();
    acc = 0;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int v = s_b[i * N + k];
      acc += (__popc(j & k) & 1) ? -v : v;
    }
    int cost = acc < 0 ? -acc : acc;
#pragma unroll
    for (int off = LANES / 2; off > 0; off >>= 1)
      cost += __shfl_xor_sync(kMask, cost, off);
    if constexpr (WARPS > 1) {
      if ((p & 31) == 0) s_part[p >> 5] = cost;
      __syncthreads();
      cost = 0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) cost += s_part[w];
    }
    if (cost < best_cost) {             // uniform across the block
      best_cost = cost;
      best_mode = mode;
      best_pred = pred;
    }
  }
}
