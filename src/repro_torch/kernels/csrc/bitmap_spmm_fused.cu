// K3: last-layer SpMM with the DEDUP-C subtraction folded in, sm_90a.
//
// Replaces: src/repro/kernels/bitmap_spmm.py::_fused_kernel (the Pallas TPU
// kernel launched by _bitmap_spmm_fused).
//
// Computes y = B h - sum_k 2^k (D_k x) over the operands of
// repro_torch/kernels/correction.py::build_fused_stream: the stream's main
// slots (kind 0: bitmap main_idx[s], source tile main_src[s] of h) and its
// correction slots (kind 1: P bit-planes corr_idx[s], source tile
// corr_src[s] of x), each with destination row tile slot_row[s].  Main
// bitmaps add their rows' sums of h; correction planes subtract 2^k times
// their rows' sums of x.  Plus-times only.  The powers of two scale
// exactly, so integer-valued frontiers give the same bits as
// SpMM-then-subtract; float sums are merged with atomics, in an order that
// changes from run to run.
//
// What bounds it on the H100: device memory, as for K1 (bitmap_spmm.cu):
// every main bitmap (2 KiB) and every correction plane (2 KiB each, P
// planes per slot; P = bit width of the largest duplicate count) is read
// once, and the planes are most of the bytes.  The design is K1's
// (bitmap_common.cuh) over one list of units: the main bitmaps, then the
// planes in their stored order (corr_idx * P + k), cut into equal slices of
// 16 units per block.  The TPU kernel walked the stream row tile by row
// tile with two accumulators and wrote acc - cacc once; on this card that
// order puts the heaviest correction rows (high-degree authors: a quarter
// of all plane bits in one row tile of the smoke's graph) on one SM, so
// the port walks the bitmaps in storage order and merges with atomics
// instead.  A first small kernel inverts the stream's main_idx / corr_idx
// into per-bitmap destination and source tiles; row_start and row_count
// are not read.  Shared memory: none, so admission depends on neither the slot
// count nor P.
//
// Launches: the table inversion (fill + scatter), zero y, the SpMM, all on
// the caller's stream.

#include "bitmap_common.cuh"

namespace bitmap_spmm {

__global__ void fill_int_kernel(int32_t* __restrict__ t, int64_t n, int32_t v) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    t[i] = v;
  }
}

// Per stored bitmap, its destination and source tiles: tables[0 .. n_main)
// and [n_main .. 2 n_main) for the main bitmaps, then the same for the
// correction stack.  Bitmaps the stream never names keep -1 and are
// skipped.
__global__ void invert_stream_kernel(
    const int32_t* __restrict__ kind, const int32_t* __restrict__ main_src,
    const int32_t* __restrict__ corr_src, const int32_t* __restrict__ main_idx,
    const int32_t* __restrict__ corr_idx, const int32_t* __restrict__ slot_row,
    int n_slots, int n_main, int n_corr, int32_t* __restrict__ tables) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n_slots) return;
  if (__ldg(kind + s) == 0) {
    const int m = __ldg(main_idx + s);
    if (m < 0 || m >= n_main) return;
    tables[m] = __ldg(slot_row + s);
    tables[n_main + m] = __ldg(main_src + s);
  } else {
    const int c = __ldg(corr_idx + s);
    if (c < 0 || c >= n_corr) return;
    int32_t* corr = tables + 2 * static_cast<int64_t>(n_main);
    corr[c] = __ldg(slot_row + s);
    corr[n_corr + c] = __ldg(corr_src + s);
  }
}

__global__ void __launch_bounds__(THREADS) bitmap_spmm_fused_kernel(
    const int32_t* __restrict__ tables, const uint2* __restrict__ bitmaps,
    const uint2* __restrict__ planes, int n_main, int n_corr, int n_planes,
    const float* __restrict__ h, const float* __restrict__ x, float* __restrict__ y,
    int n_out, int n_feat) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int feature = blockIdx.y * FEATURE_BLOCK + lane;
  const bool active = feature < n_feat;
  const int64_t n_units = n_main + static_cast<int64_t>(n_corr) * n_planes;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * UNITS_PER_BLOCK;
  const int count = n_units - first < UNITS_PER_BLOCK ? static_cast<int>(n_units - first)
                                                     : UNITS_PER_BLOCK;

  // lane j < count holds unit first + j's tables; code 0 = main, k + 1 = plane k
  int my_dst = -1, my_src = 0, my_code = 0;
  if (lane < count) {
    const int64_t u = first + lane;
    if (u < n_main) {
      my_dst = __ldg(tables + u);
      my_src = __ldg(tables + n_main + u);
    } else {
      const int64_t v = u - n_main;
      const int64_t c = v / n_planes;
      const int32_t* corr = tables + 2 * static_cast<int64_t>(n_main);
      my_dst = __ldg(corr + c);
      my_src = __ldg(corr + n_corr + c);
      my_code = 1 + static_cast<int>(v % n_planes);
    }
  }
  uint2 pairs[UNITS_PER_BLOCK];
#pragma unroll
  for (int j = 0; j < UNITS_PER_BLOCK; ++j) {
    const int64_t u = first + j;
    const uint2* unit = u < n_main ? bitmaps + u * UNIT_PAIRS
                                   : planes + (u - n_main) * UNIT_PAIRS;
    pairs[j] = j < count ? __ldcs(unit + warp * 32 + lane) : make_uint2(0u, 0u);
  }
  const Target t{h, x, y, n_feat, feature, active};
  BitQueue q;
#pragma unroll
  for (int j = 0; j < UNITS_PER_BLOCK; ++j) {
    const int dst = __shfl_sync(FULL_MASK, my_dst, j);
    const int src = __shfl_sync(FULL_MASK, my_src, j);
    const int code = __shfl_sync(FULL_MASK, my_code, j);
    if (dst < 0) continue;
    queue_unit<OP_SUM>(q, t, pairs[j], dst, src, code, n_out, warp, lane);
  }
  finish<OP_SUM>(q, t);
}

}  // namespace bitmap_spmm

// Launch on ``stream``; returns cudaGetLastError() as an int (0 = success).
// y must hold n_out rows of n_feat floats; plane k carries weight 2^k
// (n_planes <= 31); bitmaps and planes must be 8-byte aligned; tables is
// int32 scratch of 2 * (n_main + n_corr) entries.
extern "C" int bitmap_spmm_fused_launch(
    const int32_t* kind, const int32_t* main_src, const int32_t* corr_src,
    const int32_t* main_idx, const int32_t* corr_idx, const int32_t* slot_row,
    int n_slots, const uint32_t* bitmaps, int n_main, const uint32_t* planes,
    int n_corr, int n_planes, const float* h, const float* x, float* y, int n_out,
    int n_feat, int32_t* tables, int device, void* stream) {
  using namespace bitmap_spmm;
  if (n_out <= 0 || n_feat <= 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (n_planes < 1 || n_planes > 31) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t n_y = static_cast<int64_t>(n_out) * n_feat;
  fill_kernel<<<elementwise_grid(n_y), THREADS, 0, st>>>(y, n_y, 0.0f);
  const int64_t n_tables = 2 * (static_cast<int64_t>(n_main) + n_corr);
  if (n_tables > 0 && n_slots > 0) {
    fill_int_kernel<<<elementwise_grid(n_tables), THREADS, 0, st>>>(tables, n_tables, -1);
    invert_stream_kernel<<<(n_slots + THREADS - 1) / THREADS, THREADS, 0, st>>>(
        kind, main_src, corr_src, main_idx, corr_idx, slot_row, n_slots, n_main, n_corr,
        tables);
    const int64_t n_units = n_main + static_cast<int64_t>(n_corr) * n_planes;
    const dim3 grid(static_cast<unsigned>((n_units + UNITS_PER_BLOCK - 1) / UNITS_PER_BLOCK),
                    (n_feat + FEATURE_BLOCK - 1) / FEATURE_BLOCK);
    bitmap_spmm_fused_kernel<<<grid, THREADS, 0, st>>>(
        tables, reinterpret_cast<const uint2*>(bitmaps),
        reinterpret_cast<const uint2*>(planes), n_main, n_corr, n_planes, h, x, y,
        n_out, n_feat);
  }
  return static_cast<int>(cudaGetLastError());
}
