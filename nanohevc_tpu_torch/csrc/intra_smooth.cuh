// Reference-sample smoothing (HEVC 8.4.4.2.3) of one block's references,
// shared by the closed-loop encoder (wavefront.cu) and the decoder
// (decode.cu): bit for bit ops.intra.smooth_refs of the plain versions
// (the JAX package's nanohevc_tpu/ops/intra.py, smooth_refs):
//   the [1 2 1] filter along bottom-left -> corner -> top-right, the
//   corner averaging its two path neighbours (T[1], L[1]) and the two
//   path ends (T[2N], L[2N]) unfiltered;
//   at N = 32, where both arms are near-linear (|corner + end - 2 mid|
//   < strong_thresh = 1 << (bit_depth - 5)), the bilinear ramp from the
//   corner to each arm's far end instead.
// Which modes read the filtered samples is the caller's 35-bit mask,
// built on the host from ops.intra.mode_filter_flags (luma smoothing,
// N > 4): planar at every N > 4, DC never, the angular modes by their
// distance from 10 and 26.

#pragma once

#include "encode_tail.cuh"   // Log2

// Filtered sample t (0 .. 4N+1) of the block's references `ref`, in the
// layout of ops.tiling.extract_refs (top arm at 0..2N with the corner at
// 0, left arm at 2N+1..4N+1 with a copy of the corner at 2N+1).  Reads
// only `ref`, so one thread a sample can fill a second array at once.
template <int N>
__device__ __forceinline__ int smoothed_ref(const int* ref, int t,
                                            int strong_thresh) {
  constexpr int R = 2 * N + 1;          // one reference arm, corner at 0
  const int arm = t < R ? 0 : R;
  const int k = t - arm;
  const int* a = ref + arm;
  int v;
  if (k == 0)
    v = (ref[R + 1] + 2 * ref[0] + ref[1] + 2) >> 2;
  else if (k == 2 * N)
    v = a[2 * N];
  else
    v = (a[k - 1] + 2 * a[k] + a[k + 1] + 2) >> 2;
  if constexpr (N == 32) {              // strong: both arms near-linear
    const int c = ref[0];
    const bool flat =
        abs(c + ref[2 * N] - 2 * ref[N]) < strong_thresh &&
        abs(c + ref[R + 2 * N] - 2 * ref[R + N]) < strong_thresh;
    if (flat)
      v = k == 0 ? c
                 : ((2 * N - k) * c + k * a[2 * N] + N) >> (Log2<N>::value + 1);
  }
  return v;
}
