// The DC/planar decision by residual energy, shared by the open-loop
// kernel (slab_pipeline.cu, K1) and the closed loop's DC/planar body
// (wavefront.cu, K4): bit for bit the decision of the TPU kernels
// nanohevc_tpu/kernels/slab_pipeline.py and wavefront_slab.py:
//   DC = floor((sum T[1..N] + sum L[1..N] + N) / 2N);
//   planar with T[N] / L[N] as top-right / bottom-left;
//   pick by residual energy, ties to DC.
// Each caller fills the references its own way (source-fed or
// reconstruction-fed); this header defines no variables.

#pragma once

#include "encode_tail.cuh"

// Predict one N x N block, one thread per pixel (i, j).  `ref` is the
// block's references in shared memory, in the layout of
// ops.tiling.extract_refs: the top arm at ref[0..2N] with the corner at
// 0, the left arm at ref[2N+1..4N+1]; only T[1..N] and L[1..N] are
// read.  s_a and s_b are the block's N*N-int shared scratch.  Every
// thread of the thread block must call it (it holds barriers), after a
// barrier that follows the writes of `ref`.  Returns the prediction of
// pixel (i, j); `use_dc` is the same for every pixel of the block.
template <int N>
__device__ __forceinline__ int dc_planar_energy(const int* ref, int x, int i,
                                                int j, int* s_a, int* s_b,
                                                bool& use_dc) {
  constexpr int NN = N * N;
  constexpr int LOG2N = Log2<N>::value;
  const int* top = ref + 1;             // T[1..N]
  const int* left = ref + 2 * N + 2;    // L[1..N]
  const int p = i * N + j;

  int sum = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) sum += top[k] + left[k];
  const int dc = floor_div(sum + N, 2 * N);
  const int tr = top[N - 1];
  const int bl = left[N - 1];
  const int pl = ((N - 1 - j) * left[i] + (j + 1) * tr +
                  (N - 1 - i) * top[j] + (i + 1) * bl + N) >>
                 (LOG2N + 1);

  // energies as shared-memory tree reductions, ties to DC
  const int rd = x - dc, rp = x - pl;
  s_a[p] = rd * rd;
  s_b[p] = rp * rp;
  __syncthreads();
#pragma unroll
  for (int s = NN / 2; s > 0; s >>= 1) {
    if (p < s) {
      s_a[p] += s_a[p + s];
      s_b[p] += s_b[p + s];
    }
    __syncthreads();
  }
  use_dc = s_a[0] <= s_b[0];
  return use_dc ? dc : pl;
}
