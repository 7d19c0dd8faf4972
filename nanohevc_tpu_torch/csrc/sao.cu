// Sample Adaptive Offset of a batch of planes (spec 8.7.3), per plane or
// per CTB tile, for Hopper (sm_90a): three kernels.
//
// What they replace.  No TPU kernel stands behind them: the JAX package
// runs SAO as XLA ops inside its closed-loop encode
// (nanohevc_tpu/models/wavefront.py:431-475) and decode (:784-806),
// through nanohevc_tpu/ops/sao.py (estimate_sao :111, apply_sao :73)
// and ops/sao_ctb.py (sao_tile_stats :76, estimate_sao_ctb :144,
// apply_sao_ctb :232).  The port's plain versions (ops/sao.py,
// ops/sao_ctb.py) are scatter-adds with int64 atomics over the whole
// plane, then 34 candidates and the merge pass as tensors of a few
// hundred tiles each.  Bit for bit the same results, in three launches:
//
// 1. sao_stats_kernel: a thread block of 1024 threads per (plane, tile).
//    Each sample is classified with its 1-sample neighbourhood (a
//    neighbour outside the plane gives category 0; the tiles at the
//    right and bottom edges are partial), and its difference src - rec
//    goes into the tile's 16 EO (class x category 1-4) and 32 band
//    counts and sums: one histogram a warp in shared memory, two shared
//    atomics a key a sample, then the warps' histograms summed into 96
//    int32 a tile.  Per-tile values are exact in int32 (ops/sao_ctb.py
//    asserts tile^2 * (2^bd - 1) < 2^31).  Layout: [eo_cnt 16 | eo_sum
//    16 | bo_cnt 32 | bo_sum 32], eo index class * 4 + category - 1.
//    tools/sao_stats_variants.py times the alternatives: summing the
//    lanes of one key first (__match_any_sync, __reduce_add_sync) and
//    256 threads a block (16 serial iterations at tile 64) were each
//    slower (PERF.md, PR 16).
// 2. sao_decide_ctb_kernel and sao_decide_frame_kernel: the 34 candidates (off, EO 0-3, BO positions
//    0-28) of a tile, a warp a tile, a lane a bin and a candidate: lane l
//    holds band l (offset and SSE delta) and, for l < 16, EO bin l; lanes
//    0-3 gather their class's four deltas, lanes 0-28 their band
//    window's, and a warp reduction takes the first minimum by index.
//    Float32 in JAX's order, one rounding an op (no FMA: __fmul_rn,
//    __fadd_rn, __fsub_rn, __fdiv_rn): cnt*(o*o) - (2*o)*ssum, the EO sum
//    ((d0+d1)+d2)+d3, the band window ((a+b)+c)+d, the offset as
//    rintf(float(ssum) / float(cnt)) clipped.  CTB SAO adds each
//    candidate's price (lambda * bits, computed by the host in float32);
//    per-plane SAO adds none.  The merge pass (ops/sao_ctb.py:139-164)
//    offers each tile its left, then its upper neighbour's pass-1
//    parameters, priced on this tile's statistics at the merge price,
//    strict `<`, no neighbour at inf.  It reads pass-1 results only, so a
//    thread block of kDecideWarps warps owns as many tiles of a tile row,
//    computes pass 1 for them and for the kDecideWarps + 1 neighbours above and
//    to the left (pass 1 is a pure function of a tile's statistics, so a
//    neighbour computed twice gives the same bits), and after one block
//    barrier runs the merge pass from shared memory: no second launch and
//    no grid-wide synchronisation, at 2x the pass-1 work (a few hundred
//    float operations a tile).  Per-plane SAO: a thread block a plane sums
//    the plane's tile-64 statistics with wrap-around (uint32, as the plain
//    version's int64 sum wrapped to int32 and JAX's int32 sums) and one
//    warp decides.
// 3. sao_apply_kernel: one elementwise pass, a thread a sample: read the
//    input plane (never in place) and its tile's parameters, classify the
//    sample as the statistics do, add its slot's offset, clip.  Per-plane
//    SAO is one tile a plane.
//
// What bounds them on this card: bytes.  The statistics read two planes
// (src and rec: 8 bytes a sample; the 8-neighbourhood comes from L1),
// the application reads one and writes one (8 bytes a sample); the
// decision reads 384 bytes of statistics a tile and writes 24.  Their
// integer work (about 40 operations a sample in the statistics, 10 in
// the application) is below the bytes' time at 67 T ops/s.

#include <cuda_runtime.h>

#include <math_constants.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kStatInts = 96;         // a tile's statistics
constexpr int kEoCnt = 0, kEoSum = 16, kBoCnt = 32, kBoSum = 64;
constexpr int kStatThreads = 1024;
constexpr int kStatWarps = kStatThreads / 32;
constexpr int kDecideWarps = 8;       // tiles a thread block (CTB SAO)
constexpr int kJobs = 2 * kDecideWarps + 1;
constexpr int kSumGroups = 8;         // per-plane SAO: tile groups summed
constexpr int kFrameThreads = kSumGroups * kStatInts;
constexpr int kApplyX = 32, kApplyY = 8;
constexpr int kOff = 0, kEo0 = 1, kBo = 5;

// (dy0, dx0, dy1, dx1) of EO classes 0-3 (ref/sao.py: EO_NEIGHBORS).
__constant__ int kNeighbors[4][4] = {
    {0, -1, 0, 1}, {-1, 0, 1, 0}, {-1, -1, 1, 1}, {-1, 1, 1, -1}};

// EO category (0-4) of the sample p at (y, x) for class c: 0 where a
// neighbour lies outside the plane; else EDGE_CAT[2 + sign + sign],
// EDGE_CAT = (1, 2, 0, 3, 4).
__device__ __forceinline__ int eo_category(const int* __restrict__ rec,
                                           int height, int width, int y,
                                           int x, int p, int c) {
  const int y0 = y + kNeighbors[c][0], x0 = x + kNeighbors[c][1];
  const int y1 = y + kNeighbors[c][2], x1 = x + kNeighbors[c][3];
  if (y0 < 0 || y0 >= height || x0 < 0 || x0 >= width || y1 < 0 ||
      y1 >= height || x1 < 0 || x1 >= width)
    return 0;
  const int n0 = __ldg(rec + (long long)y0 * width + x0);
  const int n1 = __ldg(rec + (long long)y1 * width + x1);
  const int ei = 2 + (p > n0) - (p < n0) + (p > n1) - (p < n1);
  return ei == 2 ? 0 : (ei < 2 ? ei + 1 : ei);
}

// Add (1, val) to bin `key` of a warp's histogram.
__device__ __forceinline__ void hist_add(int* cnt, int* sum, int key,
                                         int val) {
  atomicAdd(cnt + key, 1);
  atomicAdd(sum + key, val);
}

__global__ void __launch_bounds__(kStatThreads)
    sao_stats_kernel(const int* __restrict__ src, const int* __restrict__ rec,
                     int height, int width, int tile_shift, int bit_depth,
                     int* __restrict__ stats) {
  __shared__ int hist[kStatWarps][kStatInts];
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < kStatWarps * kStatInts; i += kStatThreads)
    (&hist[0][0])[i] = 0;
  __syncthreads();
  const int plane = blockIdx.z, ty = blockIdx.y, tx = blockIdx.x;
  const int tile = 1 << tile_shift;
  const int y0 = ty << tile_shift, x0 = tx << tile_shift;
  const int th = min(tile, height - y0), tw = min(tile, width - x0);
  const int n = th * tw;
  const long long base = (long long)plane * height * width;
  const int* __restrict__ r = rec + base;
  const int* __restrict__ s = src + base;
  int* h = hist[warp];
  for (int i = threadIdx.x; i < n; i += kStatThreads) {
    const int y = y0 + i / tw, x = x0 + i % tw;
    const int p = __ldg(r + (long long)y * width + x);
    const int d = __ldg(s + (long long)y * width + x) - p;
    const int band = p >> (bit_depth - 5);
    if (band >= 0 && band < 32) hist_add(h + kBoCnt, h + kBoSum, band, d);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int cat = eo_category(r, height, width, y, x, p, c);
      if (cat) hist_add(h + kEoCnt, h + kEoSum, c * 4 + cat - 1, d);
    }
  }
  __syncthreads();
  if (threadIdx.x < kStatInts) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kStatWarps; ++w) total += hist[w][threadIdx.x];
    const int ntx = gridDim.x, nty = gridDim.y;
    stats[(((long long)plane * nty + ty) * ntx + tx) * kStatInts +
          threadIdx.x] = total;
  }
}

// --- the decision --------------------------------------------------------

// A tile's statistics as its warp holds them: lane l has band l and, for
// l < 16, EO bin l.
struct Bins {
  int ec, es, bc, bs;
};

__device__ __forceinline__ Bins load_bins(const int* st) {
  const int lane = threadIdx.x & 31;
  Bins b;
  b.ec = lane < 16 ? st[kEoCnt + lane] : 0;
  b.es = lane < 16 ? st[kEoSum + lane] : 0;
  b.bc = st[kBoCnt + lane];
  b.bs = st[kBoSum + lane];
  return b;
}

// ops/sao.py::_offset_from_stats: the float32 mean rounded half to even,
// clipped to [lo, hi], 0 where nothing was counted.
__device__ __forceinline__ int offset_of(int cnt, int ssum, int lo, int hi) {
  if (cnt <= 0) return 0;
  const float o = rintf(__fdiv_rn(__int2float_rn(ssum), __int2float_rn(cnt)));
  return min(max((int)o, lo), hi);
}

// ops/sao.py::_delta_sse: cnt*(o*o) - (2*o)*ssum, one rounding an op.
__device__ __forceinline__ float delta_sse(int cnt, int ssum, int o) {
  const float fc = __int2float_rn(cnt), fs = __int2float_rn(ssum);
  const float fo = __int2float_rn(o);
  return __fsub_rn(__fmul_rn(fc, __fmul_rn(fo, fo)),
                   __fmul_rn(__fmul_rn(2.0f, fo), fs));
}

// One tile's pass-1 choice, the same in every lane.
struct Choice {
  float cost;
  int type, band, off[4];
};

// The first minimum of the 34 candidates (off, EO 0-3, BO 0-28) of the
// tile the warp holds; `priced` adds price_off / price_eo / price_bo
// (CTB SAO), else no add (per-plane SAO, whose off candidate is 0).
__device__ Choice decide(const Bins& b, int cap, bool priced,
                         float price_off, float price_eo, float price_bo) {
  const int lane = threadIdx.x & 31;
  const int k = lane & 3;                          // EO category - 1
  const int eo = offset_of(b.ec, b.es, k < 2 ? 0 : -cap, k < 2 ? cap : 0);
  const float ed = delta_sse(b.ec, b.es, eo);
  const int bo = offset_of(b.bc, b.bs, -cap, cap);
  const float bd = delta_sse(b.bc, b.bs, bo);
  // Lane c < 4: class c's ((d0 + d1) + d2) + d3; lane p < 29: band
  // window p's ((a + b) + c) + d.
  float d_eo = __shfl_sync(kFull, ed, 4 * k);
  float d_win = bd;
#pragma unroll
  for (int j = 1; j < 4; ++j) {
    d_eo = __fadd_rn(d_eo, __shfl_sync(kFull, ed, 4 * k + j));
    d_win = __fadd_rn(d_win, __shfl_sync(kFull, bd, (lane + j) & 31));
  }
  // This lane's candidates in index order: 0 (lane 0), 1 + lane (lanes
  // 0-3), 5 + lane (lanes 0-28); strict < keeps the first of equals.
  float best = CUDART_INF_F;
  int idx = 64;
  if (lane == 0) {
    best = priced ? price_off : 0.0f;
    idx = 0;
  }
  if (lane < 4) {
    const float sc = priced ? __fadd_rn(d_eo, price_eo) : d_eo;
    if (sc < best) {
      best = sc;
      idx = 1 + lane;
    }
  }
  if (lane < 29) {
    const float sc = priced ? __fadd_rn(d_win, price_bo) : d_win;
    if (sc < best) {
      best = sc;
      idx = 5 + lane;
    }
  }
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) {
    const float ob = __shfl_xor_sync(kFull, best, m);
    const int oi = __shfl_xor_sync(kFull, idx, m);
    if (ob < best || (ob == best && oi < idx)) {
      best = ob;
      idx = oi;
    }
  }
  Choice ch;
  ch.cost = best;
  ch.type = idx == 0 ? kOff : (idx <= 4 ? idx : kBo);
  ch.band = idx >= 5 ? idx - 5 : 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int e = __shfl_sync(kFull, eo, (4 * (idx - 1) + j) & 31);
    const int o = __shfl_sync(kFull, bo, (idx - 5 + j) & 31);
    ch.off[j] = idx == 0 ? 0 : (idx <= 4 ? e : o);
  }
  return ch;
}

// ops/sao_ctb.py::_delta_for_params: the SSE delta of `type` / `band` /
// `off` on the tile the warp holds, (((0 + d0) + d1) + d2) + d3; 0 for
// SAO_OFF (and for a type no candidate has).
__device__ float params_delta(const Bins& b, int type, int band,
                              const int* off) {
  float d = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int eo_lane = (4 * (type - kEo0) + j) & 31;
    const int bo_lane = (band + j) & 31;
    const int ec = __shfl_sync(kFull, b.ec, eo_lane);
    const int es = __shfl_sync(kFull, b.es, eo_lane);
    const int bc = __shfl_sync(kFull, b.bc, bo_lane);
    const int bs = __shfl_sync(kFull, b.bs, bo_lane);
    if (type >= kEo0 && type < kBo)
      d = __fadd_rn(d, delta_sse(ec, es, off[j]));
    else if (type == kBo)
      d = __fadd_rn(d, delta_sse(bc, bs, off[j]));
  }
  return d;
}

__device__ __forceinline__ void store_choice(const Choice& ch, long long t,
                                             int* type_map, int* band_map,
                                             int* off_map) {
  if ((threadIdx.x & 31) == 0) {
    type_map[t] = ch.type;
    band_map[t] = ch.band;
#pragma unroll
    for (int j = 0; j < 4; ++j) off_map[4 * t + j] = ch.off[j];
  }
}

// CTB SAO: grid (ceil(ntx / kDecideWarps), nty, batch), kDecideWarps
// warps; warp w decides tile (ty, tx0 + w).
__global__ void __launch_bounds__(kDecideWarps * 32)
    sao_decide_ctb_kernel(const int* __restrict__ stats, int nty, int ntx,
                          int cap, float price_off, float price_eo,
                          float price_bo, float price_merge, int merge,
                          int* __restrict__ type_map,
                          int* __restrict__ band_map,
                          int* __restrict__ off_map) {
  // Pass-1 choices: jobs 0..W-1 the block's tiles, W..2W-1 the tiles
  // above them, 2W the tile left of the first.
  __shared__ Choice pass1[kJobs];
  const int warp = threadIdx.x >> 5;
  const int plane = blockIdx.z, ty = blockIdx.y;
  const int tx0 = blockIdx.x * kDecideWarps;
  const long long row = ((long long)plane * nty + ty) * ntx;
  const int tx = tx0 + warp;
  const bool mine = tx < ntx;
  Bins own{0, 0, 0, 0};
  Choice ch{};
  if (mine) {
    own = load_bins(stats + (row + tx) * kStatInts);
    ch = decide(own, cap, true, price_off, price_eo, price_bo);
  }
  if (!merge) {
    if (mine) store_choice(ch, row + tx, type_map, band_map, off_map);
    return;
  }
  if (mine && (threadIdx.x & 31) == 0) pass1[warp] = ch;
  for (int job = kDecideWarps + warp; job < kJobs; job += kDecideWarps) {
    int jy = ty - 1, jx = tx0 + job - kDecideWarps;   // above
    if (job == 2 * kDecideWarps) {                     // left
      jy = ty;
      jx = tx0 - 1;
    }
    if (jy < 0 || jx < 0 || jx >= ntx) continue;
    const Bins nb = load_bins(
        stats + (((long long)plane * nty + jy) * ntx + jx) * kStatInts);
    const Choice nc = decide(nb, cap, true, price_off, price_eo, price_bo);
    if ((threadIdx.x & 31) == 0) pass1[job] = nc;
  }
  __syncthreads();
  if (!mine) return;
  Choice best = ch;
#pragma unroll
  for (int dir = 0; dir < 2; ++dir) {                  // left, then up
    const bool has = dir == 0 ? tx > 0 : ty > 0;
    const Choice& n = pass1[dir == 0 ? (warp > 0 ? warp - 1 : 2 * kDecideWarps)
                                     : kDecideWarps + warp];
    const int nt = has ? n.type : kOff, nbd = has ? n.band : 0;
    int noff[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) noff[j] = has ? n.off[j] : 0;
    const float d = nt == kOff ? 0.0f : params_delta(own, nt, nbd, noff);
    const float cost = has ? __fadd_rn(d, price_merge) : CUDART_INF_F;
    if (cost < best.cost) {
      best.cost = cost;
      best.type = nt;
      best.band = nbd;
#pragma unroll
      for (int j = 0; j < 4; ++j) best.off[j] = noff[j];
    }
  }
  store_choice(best, row + tx, type_map, band_map, off_map);
}

// Per-plane SAO: grid (batch), kFrameThreads threads; sums the plane's
// nt tile statistics (wrapping) and decides with no prices.
__global__ void __launch_bounds__(kFrameThreads)
    sao_decide_frame_kernel(const int* __restrict__ stats, int nt, int cap,
                            int* __restrict__ type_map,
                            int* __restrict__ band_map,
                            int* __restrict__ off_map) {
  __shared__ unsigned part[kSumGroups][kStatInts];
  __shared__ int total[kStatInts];
  const int plane = blockIdx.x;
  const int e = threadIdx.x % kStatInts, g = threadIdx.x / kStatInts;
  const int* st = stats + (long long)plane * nt * kStatInts;
  unsigned acc = 0;
  for (int t = g; t < nt; t += kSumGroups)
    acc += (unsigned)st[(long long)t * kStatInts + e];
  part[g][e] = acc;
  __syncthreads();
  if (threadIdx.x < kStatInts) {
    unsigned sum = 0;
#pragma unroll
    for (int k = 0; k < kSumGroups; ++k) sum += part[k][threadIdx.x];
    total[threadIdx.x] = (int)sum;
  }
  __syncthreads();
  if (threadIdx.x >= 32) return;
  const Choice ch = decide(load_bins(total), cap, false, 0.f, 0.f, 0.f);
  store_choice(ch, plane, type_map, band_map, off_map);
}

// --- the application -----------------------------------------------------

__global__ void __launch_bounds__(kApplyX * kApplyY)
    sao_apply_kernel(const int* __restrict__ planes,
                     const int* __restrict__ type_map,
                     const int* __restrict__ band_map,
                     const int* __restrict__ off_map, int height, int width,
                     int tile_shift, int nty, int ntx, int bit_depth,
                     int* __restrict__ out) {
  const int x = blockIdx.x * kApplyX + threadIdx.x;
  const int y = blockIdx.y * kApplyY + threadIdx.y;
  if (x >= width || y >= height) return;
  const int plane = blockIdx.z;
  const long long base = (long long)plane * height * width;
  const int* __restrict__ r = planes + base;
  const int p = __ldg(r + (long long)y * width + x);
  const long long t =
      ((long long)plane * nty + (y >> tile_shift)) * ntx + (x >> tile_shift);
  const int type = __ldg(type_map + t);
  int slot = -1;
  if (type >= kEo0 && type < kBo) {
    slot = eo_category(r, height, width, y, x, p, type - kEo0) - 1;
  } else if (type == kBo) {
    const int wi = ((p >> (bit_depth - 5)) - __ldg(band_map + t)) & 31;
    slot = wi < 4 ? wi : -1;
  }
  const int delta = slot >= 0 ? __ldg(off_map + 4 * t + slot) : 0;
  out[base + (long long)y * width + x] =
      min(max(p + delta, 0), (1 << bit_depth) - 1);
}

bool bad_shape(int batch, int height, int width, int bit_depth) {
  return batch < 0 || height < 0 || width < 0 || bit_depth < 5 ||
         bit_depth > 16 || batch > 65535;
}

}  // namespace

// Statistics of `batch` (height, width) int32 src / rec planes over tiles
// of 1 << tile_shift samples: `stats` is (batch, nty, ntx, 96) int32.
extern "C" int nhv_sao_stats(const int* src, const int* rec, int batch,
                             int height, int width, int tile_shift,
                             int bit_depth, int* stats, void* stream,
                             int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_shape(batch, height, width, bit_depth) || tile_shift < 0 ||
      tile_shift > 15)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || height == 0 || width == 0) return (int)cudaSuccess;
  const int tile = 1 << tile_shift;
  const dim3 grid((width + tile - 1) / tile, (height + tile - 1) / tile,
                  batch);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  sao_stats_kernel<<<grid, kStatThreads, 0, (cudaStream_t)stream>>>(
      src, rec, height, width, tile_shift, bit_depth, stats);
  return (int)cudaGetLastError();
}

// The decision from `stats` ((batch, nty, ntx, 96), as nhv_sao_stats
// writes them).  frame != 0: per-plane SAO, the tiles summed, outputs
// (batch), (batch), (batch, 4); else CTB SAO with the four prices and
// the merge pass where merge != 0, outputs (batch, nty, ntx), (batch,
// nty, ntx), (batch, nty, ntx, 4).  cap is the offsets' magnitude bound.
extern "C" int nhv_sao_decide(const int* stats, int batch, int nty, int ntx,
                              int frame, int cap, float price_off,
                              float price_eo, float price_bo,
                              float price_merge, int merge, int* type_map,
                              int* band_map, int* off_map, void* stream,
                              int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (batch < 0 || nty < 0 || ntx < 0 || cap < 0 || batch > 65535 ||
      nty > 65535)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || nty == 0 || ntx == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (frame) {
    sao_decide_frame_kernel<<<batch, kFrameThreads, 0, s>>>(
        stats, nty * ntx, cap, type_map, band_map, off_map);
  } else {
    const dim3 grid((ntx + kDecideWarps - 1) / kDecideWarps, nty, batch);
    sao_decide_ctb_kernel<<<grid, kDecideWarps * 32, 0, s>>>(
        stats, nty, ntx, cap, price_off, price_eo, price_bo, price_merge,
        merge, type_map, band_map, off_map);
  }
  return (int)cudaGetLastError();
}

// Apply per-tile parameters ((batch, nty, ntx) type and band maps, (batch,
// nty, ntx, 4) offsets; tiles of 1 << tile_shift samples) to `batch`
// (height, width) int32 planes into `out` (never in place).
extern "C" int nhv_sao_apply(const int* planes, const int* type_map,
                             const int* band_map, const int* off_map,
                             int batch, int height, int width, int tile_shift,
                             int bit_depth, int* out, void* stream,
                             int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_shape(batch, height, width, bit_depth) || tile_shift < 0 ||
      tile_shift > 30)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || height == 0 || width == 0) return (int)cudaSuccess;
  const int nty = ((height - 1) >> tile_shift) + 1;
  const int ntx = ((width - 1) >> tile_shift) + 1;
  const dim3 grid((width + kApplyX - 1) / kApplyX,
                  (height + kApplyY - 1) / kApplyY, batch);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  sao_apply_kernel<<<grid, dim3(kApplyX, kApplyY), 0,
                     (cudaStream_t)stream>>>(planes, type_map, band_map,
                                             off_map, height, width,
                                             tile_shift, nty, ntx, bit_depth,
                                             out);
  return (int)cudaGetLastError();
}
