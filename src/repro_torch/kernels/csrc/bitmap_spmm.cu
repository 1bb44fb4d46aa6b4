// K1 / K2: bit-packed block-sparse SpMM, y = B (+) x, for sm_90a.
//
// Replaces: src/repro/kernels/bitmap_spmm.py::_kernel (the Pallas TPU
// kernel launched by _bitmap_spmm_pallas), op='sum' (K1) and
// op='min' | 'max' (K2), with row_window = 128.
//
// Computes, for every destination row r,
//   y[r, f] = (+)_{slots s of r's row tile} (+)_{set bits (r, c) of s} x[128*slot_src[s] + c, f]
// where (+) is a float32 sum (K1) or a min / max select (K2).  Rows with no
// source take the semiring zero: +inf -> zero for min, -inf -> zero for
// max (every -inf, a genuine one included, as the JAX segment path does).
// No multiply ever meets a frontier value, so inf frontiers are safe, and
// the sum runs on CUDA cores in float32: integer-valued frontiers stay
// exact (no tensor cores, no TF32).  Float sums are merged with atomics,
// in an order that changes from run to run.
//
// What bounds it on the H100: device memory.  Every 2 KiB bitmap is read
// once and the condensed layers this serves hold a few set bits per
// 128x128 block (3.3 on the DBLP smoke graph's first layer), so the
// operation count is far below the bytes' share of the roofline.  The TPU
// kernel staged a dense (128, Fb) source tile per slot and fed the MXU;
// here that would read 128 source rows to use a few, so the design reads
// only the source rows that set bits select, mostly from L2.  What it does
// about the bitmap bytes (bitmap_common.cuh): each warp issues its 16
// units' words at once, a ballot skips empty word pairs, and the slot list
// is cut into equal slices of 16 slots, one per block, so a high-degree
// row tile is spread over many SMs.  Shared memory: none, so any layer
// that packs is served.
//
// Launches: fill y with the op's identity, the SpMM, and (min / max) the
// zero substitution, all on the caller's stream.
//
// Feature block.  The JAX engine pads the batch axis to 128; the server's
// batches are 8, 16 or 32 wide, so the port uses 32 features per block
// (one per lane) and masks lanes past F instead of padding.

#include "bitmap_common.cuh"

namespace bitmap_spmm {

template <int OP>
__global__ void __launch_bounds__(THREADS) bitmap_spmm_kernel(
    const int32_t* __restrict__ slot_src, const int32_t* __restrict__ slot_row,
    const uint2* __restrict__ bitmaps, int n_slots, const float* __restrict__ x,
    float* __restrict__ y, int n_out, int n_feat) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int feature = blockIdx.y * FEATURE_BLOCK + lane;
  const bool active = feature < n_feat;
  const int first = blockIdx.x * UNITS_PER_BLOCK;
  const int count = min(UNITS_PER_BLOCK, n_slots - first);

  // lane j < count holds slot first + j's tables
  int my_dst = 0, my_src = 0;
  if (lane < count) {
    my_dst = __ldg(slot_row + first + lane);
    my_src = __ldg(slot_src + first + lane);
  }
  uint2 pairs[UNITS_PER_BLOCK];
#pragma unroll
  for (int j = 0; j < UNITS_PER_BLOCK; ++j) {
    pairs[j] = j < count
        ? __ldcs(bitmaps + static_cast<int64_t>(first + j) * UNIT_PAIRS + warp * 32 + lane)
        : make_uint2(0u, 0u);
  }
  const Target t{x, x, y, n_feat, feature, active};
  BitQueue q;
#pragma unroll
  for (int j = 0; j < UNITS_PER_BLOCK; ++j) {
    const int dst = __shfl_sync(FULL_MASK, my_dst, j);
    const int src = __shfl_sync(FULL_MASK, my_src, j);
    queue_unit<OP>(q, t, pairs[j], dst, src, 0, n_out, warp, lane);
  }
  finish<OP>(q, t);
}

template <int OP>
int launch(const int32_t* slot_src, const int32_t* slot_row, const uint32_t* bitmaps,
           int n_slots, const float* x, float* y, int n_out, int n_feat, float zero,
           cudaStream_t st) {
  const int64_t n_y = static_cast<int64_t>(n_out) * n_feat;
  fill_kernel<<<elementwise_grid(n_y), THREADS, 0, st>>>(y, n_y, identity<OP>());
  if (n_slots > 0) {
    const dim3 grid((n_slots + UNITS_PER_BLOCK - 1) / UNITS_PER_BLOCK,
                    (n_feat + FEATURE_BLOCK - 1) / FEATURE_BLOCK);
    bitmap_spmm_kernel<OP><<<grid, THREADS, 0, st>>>(
        slot_src, slot_row, reinterpret_cast<const uint2*>(bitmaps), n_slots, x, y,
        n_out, n_feat);
  }
  if (OP != OP_SUM) {
    replace_kernel<<<elementwise_grid(n_y), THREADS, 0, st>>>(y, n_y, identity<OP>(),
                                                              zero);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bitmap_spmm

// Launch on ``stream``; returns cudaGetLastError() as an int (0 = success).
// y must hold n_out rows of n_feat floats; every set bit's row lies in a
// row tile below n_rt; bitmaps must be 8-byte aligned.  row_start and
// row_count describe the same slots by row tile and are not read: the
// kernel walks the slot list in equal slices.
extern "C" int bitmap_spmm_launch(const int32_t* slot_src, const int32_t* slot_row,
                                  const uint32_t* bitmaps, int n_slots,
                                  const float* x, float* y, int n_out, int n_feat,
                                  int op, float zero, int device, void* stream) {
  using namespace bitmap_spmm;
  if (n_out <= 0 || n_feat <= 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (op) {
    case OP_SUM:
      return launch<OP_SUM>(slot_src, slot_row, bitmaps, n_slots, x, y, n_out, n_feat, zero, st);
    case OP_MIN:
      return launch<OP_MIN>(slot_src, slot_row, bitmaps, n_slots, x, y, n_out, n_feat, zero, st);
    case OP_MAX:
      return launch<OP_MAX>(slot_src, slot_row, bitmaps, n_slots, x, y, n_out, n_feat, zero, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
