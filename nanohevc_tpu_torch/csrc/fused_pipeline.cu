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
// Design.  The TPU kernel held chunks of blocks with the block axis on
// the 128 lanes.  Here the layout is the open-loop slab kernel's
// (slab_pipeline.cu): one thread per pixel, BPB whole N x N blocks per
// thread block (16/4/1/1 at N = 4/8/16/32), the block and its
// references in shared memory, and its body -- the DC/planar decision of
// dc_planar.cuh and the tail of encode_tail.cuh -- unchanged.  Only where
// a block and its references come from differs: the block is row b of
// the (nb, N, N) input, and the 4N+2 references of the BPB blocks are
// one contiguous run of the (nb, 4N+2) input, which the thread block
// copies into shared memory as it is (the layout dc_planar_energy
// reads).  It lives in a file of its own so that the slab kernel's code,
// registers and times stay as they were.
//
// What bounds it on the card: per pixel it reads 4 bytes of block and
// (4N+2) * 4 / N^2 bytes of references and writes 8 bytes of recon and
// levels (14.1 bytes at N = 8), against the slab kernel's 8N + 34
// integer operations, so it is memory-bound: a 1080p luma plane at N = 8
// is 32,400 blocks, 8,100 thread blocks of 256 threads.

#include "dc_planar.cuh"

// The transform matrices only (layout in encode_tail.cuh).
constexpr int kTableInts = kTransformInts;
__constant__ int c_tables[kTableInts];

template <int N, int BPB>
__global__ void __launch_bounds__(N * N * BPB)
fused_encode_kernel(const int* __restrict__ blocks,
                    const int* __restrict__ refs, int nb, int t_offset,
                    QpScalars q, int* __restrict__ recon,
                    int* __restrict__ levels) {
  constexpr int NN = N * N;
  constexpr int RR = 4 * N + 2;     // one block's references

  __shared__ int s_t[NN];    // T[i][k] at i*N + k
  __shared__ int s_tt[NN];   // T[j][k] at k*N + j (transposed copy)
  __shared__ int s_x[BPB][NN];
  __shared__ int s_a[BPB][NN];
  __shared__ int s_b[BPB][NN];
  __shared__ int s_ref[BPB][RR];

  const int tid = threadIdx.x;
  const int lb = tid / NN;          // block slot in this thread block
  const int p = tid % NN;           // pixel in the block
  const int i = p / N, j = p % N;
  const int first = blockIdx.x * BPB;
  const int g = first + lb;
  const bool active = g < nb;

  if (tid < NN) {
    s_t[tid] = c_tables[t_offset + tid];
    s_tt[tid] = c_tables[t_offset + (tid % N) * N + tid / N];
  }
  // The BPB blocks' references are refs[first*RR .. (first+BPB)*RR):
  // copied whole, coalesced; slots past nb read as 0.
  for (int k = tid; k < BPB * RR; k += N * N * BPB)
    (&s_ref[0][0])[k] =
        first + k / RR < nb ? refs[(size_t)first * RR + k] : 0;
  const int x = active ? blocks[(size_t)g * NN + p] : 0;
  __syncthreads();

  // --- DC/planar by energy, ties to DC (dc_planar.cuh) -------------
  bool use_dc;
  const int pred = dc_planar_energy<N, N * N * BPB>(
      s_ref[lb], x, i, j, s_a[lb], s_b[lb], use_dc);

  // --- transform, quantize, reconstruct (shared tail) ----------------
  int level, rec;
  transform_quant_recon<N>(s_t, s_tt, s_x[lb], s_a[lb], s_b[lb], i, j,
                           x - pred, pred, q, level, rec);

  if (active) {
    recon[(size_t)g * NN + p] = rec;
    levels[(size_t)g * NN + p] = level;
  }
}

template <int N, int BPB>
static void launch(const int* blocks, const int* refs, int nb, QpScalars q,
                   int* recon, int* levels, cudaStream_t stream) {
  const int grid = (nb + BPB - 1) / BPB;
  fused_encode_kernel<N, BPB><<<grid, N * N * BPB, 0, stream>>>(
      blocks, refs, nb, transform_offset(N, false), q, recon, levels);
}

extern "C" int nhv_table_ints() { return kTableInts; }

// Copy the transform tables (layout in encode_tail.cuh) into constant
// memory of `device`.  Returns a cudaError_t.
extern "C" int nhv_upload_tables(const int* host, int count, int device) {
  if (count != kTableInts) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyToSymbol(c_tables, host, count * sizeof(int));
}

// Encode nb (N, N) int32 blocks against their (nb, 4N+2) references into
// recon and levels, both (nb, N, N) raster.  The QP scalars are the
// parity ones (dq_shift = 4 - qp/6); `boundary` is not read.  Launches
// on `stream` without synchronising; returns cudaGetLastError().
extern "C" int nhv_fused_encode(const int* blocks, const int* refs, int nb,
                                int n, int mf, int qshift, int qoffset,
                                int dscale, int dq_shift, int max_pix,
                                int boundary, int* recon, int* levels,
                                void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nb < 0) return (int)cudaErrorInvalidValue;
  if (nb == 0) return (int)cudaSuccess;
  const QpScalars q{mf, qshift, qoffset, dscale, dq_shift, max_pix, boundary};
  cudaStream_t s = (cudaStream_t)stream;
  switch (n) {
    case 4:
      launch<4, 16>(blocks, refs, nb, q, recon, levels, s);
      break;
    case 8:
      launch<8, 4>(blocks, refs, nb, q, recon, levels, s);
      break;
    case 16:
      launch<16, 1>(blocks, refs, nb, q, recon, levels, s);
      break;
    case 32:
      launch<32, 1>(blocks, refs, nb, q, recon, levels, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
