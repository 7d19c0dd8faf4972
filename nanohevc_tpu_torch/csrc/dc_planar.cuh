// The DC/planar decision by residual energy of the closed loop's
// DC/planar body (wavefront.cu, K4; the row kernels K1 and K5 have its
// row form in row_tail.cuh): bit for bit the decision of the TPU
// kernels nanohevc_tpu/kernels/slab_pipeline.py and wavefront_slab.py:
//   DC = floor((sum T[1..N] + sum L[1..N] + N) / 2N);
//   planar with T[N] / L[N] as top-right / bottom-left;
//   pick by residual energy, ties to DC;
//   with luma smoothing, planar from the filtered references.
// Each caller fills the references its own way (source-fed or
// reconstruction-fed); this header defines no variables.

#pragma once

#include "encode_tail.cuh"

// Predict one N x N block, one thread per pixel (i, j), in a thread
// block of THREADS threads.  `ref` is the block's references in shared
// memory, in the layout of ops.tiling.extract_refs: the top arm at
// ref[0..2N] with the corner at 0, the left arm at ref[2N+1..4N+1]; only
// T[1..N] and L[1..N] are read, by DC from `ref` and by planar from
// `pref` (`ref` itself, or its filtered copy).  s_a and s_b are the
// block's N*N-int shared scratch (the first N*N/32 ints of each hold
// the per-warp sums at N >= 8).  Every thread of the thread block must
// call it (it holds a barrier at N >= 8), after a barrier that follows
// the writes of `ref` and `pref`.
// Returns the prediction of pixel (i, j); `use_dc` is the same for every
// pixel of the block.
template <int N, int THREADS>
__device__ __forceinline__ int dc_planar_energy(const int* ref,
                                                const int* pref, int x,
                                                int i, int j, int* s_a,
                                                int* s_b, bool& use_dc) {
  constexpr int NN = N * N;
  constexpr int LOG2N = Log2<N>::value;
  constexpr int LANES = NN < 32 ? NN : 32;       // lanes per block per warp
  constexpr unsigned kMask = THREADS >= 32 ? 0xffffffffu : (1u << THREADS) - 1u;
  const int p = i * N + j;

  int sum = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) sum += ref[1 + k] + ref[2 * N + 2 + k];
  const int dc = floor_div(sum + N, 2 * N);
  const int* top = pref + 1;            // planar's T[1..N]
  const int* left = pref + 2 * N + 2;   // planar's L[1..N]
  const int tr = top[N - 1];
  const int bl = left[N - 1];
  const int pl = ((N - 1 - j) * left[i] + (j + 1) * tr +
                  (N - 1 - i) * top[j] + (i + 1) * bl + N) >>
                 (LOG2N + 1);

  // energies: warp shuffles, then one shared-memory step across the
  // block's warps; int32 sums wrap alike in any order.  Ties to DC.
  const int rd = x - dc, rp = x - pl;
  int e_dc = rd * rd, e_pl = rp * rp;
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1) {
    e_dc += __shfl_xor_sync(kMask, e_dc, off);
    e_pl += __shfl_xor_sync(kMask, e_pl, off);
  }
  if constexpr (NN > 32) {             // each warp sums the warps' sums
    const int lane = p & 31;
    if (lane == 0) {
      s_a[p >> 5] = e_dc;
      s_b[p >> 5] = e_pl;
    }
    __syncthreads();
    e_dc = lane < NN / 32 ? s_a[lane] : 0;
    e_pl = lane < NN / 32 ? s_b[lane] : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      e_dc += __shfl_xor_sync(kMask, e_dc, off);
      e_pl += __shfl_xor_sync(kMask, e_pl, off);
    }
  }
  use_dc = e_dc <= e_pl;
  return use_dc ? dc : pl;
}
