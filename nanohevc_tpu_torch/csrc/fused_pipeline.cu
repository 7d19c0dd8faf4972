// The blocks-API fused all-intra pipeline, for Hopper (sm_90a).
//
// Replaces the TPU kernel nanohevc_tpu/kernels/fused_pipeline.py
// (fused_encode_blocks -> _build -> _kernel).  Same arithmetic, bit for
// bit, over blocks and references that the caller hands in:
//   refs[b] = [corner, T1..T2N, corner, L1..L2N] (ops.tiling.extract_refs);
//   DC = floor((sum T[1..N] + sum L[1..N] + N) / 2N);
//   planar with T[N] / L[N] (refs[N], refs[3N+1]) as top-right /
//   bottom-left; pick by residual energy, ties to DC;
//   forward DCT T.X then .T^T at every N (no DST, also at 4x4), each
//   (acc + rnd) >> (log2N + 5); deadzone quantizer; the parity dequant
//   only; inverse T^T.X then .T; clip to [0, max_pix].
//
// What bounds it on the card: per pixel it reads 4 bytes of block and
// (4N+2) * 4 / N^2 bytes of references and writes 8 bytes of recon and
// levels (14.1 bytes at N = 8, 8.74 us for a 1080p luma plane at 3.35
// TB/s), against the slab kernel's 8N + 34 integer operations counted as
// dot products (chip_smoke.py::fused_bound; that count makes operations
// the bound at N = 32), fewer with the butterflies, which leave bytes the
// bound at every N.
//
// Design: K1's (slab_pipeline.cu), with its body from row_tail.cuh.  One
// thread per block row, 32 / N blocks a warp, 4 warps a thread block;
// the block is row b of the (nb, N, N) input, read as int4 (blocks,
// recon and levels must be 16-byte aligned), and recon and levels go out
// as int4 rows of (nb, N, N).  The references of a warp's blocks are one
// contiguous run of the (nb, 4N+2) input, 8-byte aligned only: the warp
// copies it into shared memory as it is, coalesced, and syncs itself.
// Nothing crosses warps: no __syncthreads.  It lives in a file of its
// own so that each kernel's code, registers and times are its own.
//
// What was measured (NVIDIA H100 80GB HBM3, 700.00 W; 1080p luma plane,
// QP 22; device time through a CUDA graph, tools/torch_kernel_times.py,
// PERF.md): 11.5-11.7 / 9.8-9.9 / 14.5-14.7 / 28.3-28.5 us at N = 4 / 8
// / 16 / 32 and 87.0-87.8 us for a batch of 8 planes at N = 8, against
// 22.0-22.5 / 31.6-32.3 / 54.4-54.7 / 94.6-95.1 and 232.2-232.7 us for
// the earlier dot-product design in the same call; 89 % of the bytes
// bound at N = 8.

#include "row_tail.cuh"

template <int N, int OFF>
__global__ void __launch_bounds__(kRowThreads)
fused_encode_kernel(const int* __restrict__ blocks,
                    const int* __restrict__ refs, int nb, QpScalars q,
                    int* __restrict__ recon, int* __restrict__ levels) {
  constexpr int BPW = 32 / N;              // blocks a warp
  constexpr int RR = 4 * N + 2;            // one block's references
  constexpr int TILE = row_tile_ints<N>();
  __shared__ int s_tiles[kRowWarps][2][TILE];
  __shared__ int s_refs[kRowWarps][BPW * RR];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane / N, i = lane % N;  // block slot in the warp, row
  const int first = (blockIdx.x * kRowWarps + warp) * BPW;
  const int g = first + grp;
  const bool active = g < nb;

  // The warp's references: refs[first*RR .. (first+BPW)*RR), slots past
  // nb read as 0.
  int* ref = s_refs[warp];
  for (int k = lane; k < BPW * RR; k += 32)
    ref[k] = first + k / RR < nb ? refs[(size_t)first * RR + k] : 0;
  int x[N];
  if (active) {
    load_row<N>(blocks + (size_t)g * N * N + i * N, x);
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) x[k] = 0;
  }
  __syncwarp();
  ref += grp * RR;
  int top[N];
#pragma unroll
  for (int k = 0; k < N; ++k) top[k] = ref[1 + k];
  const int left = ref[2 * N + 2 + i];

  int pred[N];
  row_dc_planar<N>(x, top, left, i, pred);
#pragma unroll
  for (int j = 0; j < N; ++j) x[j] -= pred[j];

  int* tiles = &s_tiles[warp][0][grp * N * (N + 1)];
  int level[N], rec[N];
  row_transform_quant_recon<N, false, OFF>(x, pred, i, tiles, tiles + TILE,
                                           q, level, rec);

  if (active) {
    store_row<N>(recon + (size_t)g * N * N + i * N, rec);
    store_row<N>(levels + (size_t)g * N * N + i * N, level);
  }
}

template <int N>
static void launch(const int* blocks, const int* refs, int nb, QpScalars q,
                   int* recon, int* levels, cudaStream_t stream) {
  constexpr int per_block = kRowWarps * (32 / N);
  const int grid = (nb + per_block - 1) / per_block;
  fused_encode_kernel<N, transform_offset(N, false)>
      <<<grid, kRowThreads, 0, stream>>>(
      blocks, refs, nb, q, recon, levels);
}

// Encode nb (N, N) int32 blocks against their (nb, 4N+2) references into
// recon and levels, both (nb, N, N) raster.  blocks, recon and levels
// must be 16-byte aligned (cudaErrorMisalignedAddress if not).  The QP
// scalars are the parity ones (dq_shift = 4 - qp/6); `boundary` is not
// read.  Launches on `stream` without synchronising; returns
// cudaGetLastError().
extern "C" int nhv_fused_encode(const int* blocks, const int* refs, int nb,
                                int n, int mf, int qshift, int qoffset,
                                int dscale, int dq_shift, int max_pix,
                                int boundary, int* recon, int* levels,
                                void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nb < 0) return (int)cudaErrorInvalidValue;
  if (nb == 0) return (int)cudaSuccess;
  if (!aligned16(blocks) || !aligned16(recon) || !aligned16(levels))
    return (int)cudaErrorMisalignedAddress;
  const QpScalars q{mf, qshift, qoffset, dscale, dq_shift, max_pix, boundary};
  cudaStream_t s = (cudaStream_t)stream;
  switch (n) {
    case 4:
      launch<4>(blocks, refs, nb, q, recon, levels, s);
      break;
    case 8:
      launch<8>(blocks, refs, nb, q, recon, levels, s);
      break;
    case 16:
      launch<16>(blocks, refs, nb, q, recon, levels, s);
      break;
    case 32:
      launch<32>(blocks, refs, nb, q, recon, levels, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
