// Pieces shared by the encode kernels (slab_pipeline.cu, mode_search.cu):
// the transform-table layout, the per-QP scalars, and the tail every
// encode runs after its mode decision -- forward transform, deadzone
// quantizer, parity or spec-rescale dequantizer, inverse transform,
// clip -- bit for bit the tail of the TPU kernels
// (nanohevc_tpu/kernels/slab_pipeline.py, _transform_quant_recon).
//
// Each .cu under csrc/ is built into a shared library of its own, so
// each defines its own __constant__ table; this header defines no
// variables.

#pragma once

#include <cuda_runtime.h>

// The transform matrices at the front of every constant table:
// DCT4 @ 0, DCT8 @ 16, DCT16 @ 80, DCT32 @ 336, DST4 @ 1360.
constexpr int kTransformInts = 16 + 64 + 256 + 1024 + 16;
constexpr int kDst4Offset = 1360;

constexpr int transform_offset(int n, bool use_dst) {
  return use_dst ? kDst4Offset : n == 4 ? 0 : n == 8 ? 16 : n == 16 ? 80 : 336;
}

struct QpScalars {
  int mf, qshift, qoffset, dscale, dq_shift, max_pix, boundary;
};

__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

template <int N>
struct Log2 {
  static constexpr int value = N == 4 ? 2 : N == 8 ? 3 : N == 16 ? 4 : 5;
};

// Transform, quantize and reconstruct one N x N block, one thread per
// pixel (i, j).  Every thread of the thread block must call it (it
// holds barriers).  s_t is T (T[i][k] at i*N + k) and s_tt its
// transpose, both in shared memory; s_x, s_a, s_b are this block's
// N*N-int shared scratch, which the caller may have used before the
// call.  Returns the quantized level through `level` and the clipped
// reconstruction through `rec`.
template <int N>
__device__ __forceinline__ void transform_quant_recon(
    const int* s_t, const int* s_tt, int* s_x, int* s_a, int* s_b, int i,
    int j, int residual, int pred, const QpScalars& q, int& level,
    int& rec) {
  constexpr int TSHIFT = Log2<N>::value + 5;
  constexpr int RND = 1 << (TSHIFT - 1);
  const int p = i * N + j;

  s_x[p] = residual;
  __syncthreads();                  // also ends the caller's reads of s_a/s_b

  // forward: temp = T.R, coeff = temp.T^T
  int acc = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) acc += s_t[i * N + k] * s_x[k * N + j];
  s_a[p] = (acc + RND) >> TSHIFT;
  __syncthreads();
  acc = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) acc += s_a[i * N + k] * s_tt[k * N + j];
  const int coeff = (acc + RND) >> TSHIFT;

  // deadzone quantizer and dequantizer (signed dequant shift)
  const int mag = ((coeff < 0 ? -coeff : coeff) * q.mf + q.qoffset) >> q.qshift;
  level = coeff > 0 ? mag : (coeff < 0 ? -mag : 0);
  const int base = level * q.dscale;
  const int deq =
      q.dq_shift >= 1
          ? (base + (1 << (q.dq_shift - 1))) >> q.dq_shift
          : (int)((unsigned)base << (-q.dq_shift));
  s_b[p] = deq;
  __syncthreads();

  // inverse: temp = T^T.D, res = temp.T
  acc = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) acc += s_t[k * N + i] * s_b[k * N + j];
  s_a[p] = (acc + RND) >> TSHIFT;
  __syncthreads();
  acc = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) acc += s_a[i * N + k] * s_t[k * N + j];
  const int res = (acc + RND) >> TSHIFT;
  rec = min(max(pred + res, 0), q.max_pix);
}
