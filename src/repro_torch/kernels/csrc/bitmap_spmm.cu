// K1 / K2: y = B (+) x over the row index of a packed incidence, sm_90a.
//
// Replaces: src/repro/kernels/bitmap_spmm.py::_kernel (the Pallas TPU
// kernel launched by _bitmap_spmm_pallas), op='sum' (K1) and
// op='min' | 'max' (K2), with row_window = 128.
//
// Computes, for every destination row r < n_out,
//   y[r, f] = (+)_{e in [row_ptr[r], row_ptr[r+1])} x[col[e], f]
// where (+) is a float32 sum (K1) or a min / max select (K2), and a value
// equal to the op's identity becomes ``zero`` (every empty row, and for max
// every -inf, as the JAX segment path does).  No multiply meets a frontier
// value, so inf frontiers are safe; the sum runs on CUDA cores in float32
// (no tensor cores, no TF32), so integer-valued frontiers stay exact.
//
// Why the bitmaps are no longer read: the TPU kernel streamed every 128x128
// bitmap to feed its matrix unit; the condensed layers this serves hold a
// few set bits per 2 KiB bitmap (3.3 on the DBLP smoke graph's first
// layer, ~630 bytes per edge), so reading them bounds any schedule above
// one library call on a CSR.  The kernel reads the row index that
// bitmap_index.cu builds from the same operands at upload.
//
// What bounds it on the H100: the gathers.  The bytes these inputs need
// are the index (row_ptr, col), each source row of x once and each output
// row once; the gathers themselves re-read source rows, 128 bytes each at
// F = 32, from L2 (x fits the 50 MB L2).  The design (bitmap_common.cuh):
// equal merge-path ranges so skewed rows spread over the card, BATCH
// gathers in flight per group, 16-byte gathers, streaming loads of the
// index, and a fixed-order carry pass in place of atomics, so the sums are
// bit-identical from launch to launch.
//
// Launches: the range kernel and the carry pass, on the caller's stream.

#include "bitmap_common.cuh"

namespace bitmap_spmm {

template <int OP, int V>
struct Reduce {
  const int32_t* __restrict__ col;
  const float* __restrict__ x;
  float* __restrict__ y;
  int n_feat;
  float zero;

  using State = Vec<V>;
  using Index = int;   // source row, -1 past the range
  using Item = Vec<V>;

  __device__ static State init() { return splat<V>(identity<OP>()); }
  __device__ Index index(int e, bool ok) const { return ok ? __ldcs(col + e) : -1; }
  __device__ Item gather(Index c, const Lane& l) const {
    return c >= 0 && l.active ? load<V>(x + static_cast<int64_t>(c) * n_feat + l.feature)
                              : init();
  }
  __device__ static void fold(State& s, const Item& v) { s = combine<OP, V>(s, v); }
  __device__ static State merge(State a, const State& b) { return combine<OP, V>(a, b); }
  __device__ void finish(int r, State s, const Lane& l) const {
    if (!l.active) return;
    if (OP != OP_SUM) {
#pragma unroll
      for (int i = 0; i < V; ++i) s.v[i] = s.v[i] == identity<OP>() ? zero : s.v[i];
    }
    store<V>(y + static_cast<int64_t>(r) * n_feat + l.feature, s);
  }
  __device__ void save(float* vals, int64_t g, int slot, const State& s, const Lane& l) const {
    if (l.active) store<V>(carry_slot<1>(vals, g, slot, 0, n_feat) + l.feature, s);
  }
  __device__ State restore(const float* vals, int64_t g, int slot, const Lane& l) const {
    return l.active ? load<V>(carry_slot<1>(vals, g, slot, 0, n_feat) + l.feature) : init();
  }
};

template <int OP, int V>
__global__ void __launch_bounds__(THREADS) spmm_kernel(
    Reduce<OP, V> p, const int32_t* __restrict__ row_ptr, int n_out, int range_items,
    int n_groups, int log_g, int32_t* __restrict__ carry_rows, float* __restrict__ carry_vals) {
  const Lane l = lane_of<V>(log_g, p.n_feat);
  if (l.group >= n_groups) return;
  walk(p, row_ptr, n_out, range_items, l, carry_rows, carry_vals);
}

template <int OP, int V>
__global__ void __launch_bounds__(THREADS) carry_kernel(
    Reduce<OP, V> p, const int32_t* __restrict__ row_ptr, int range_items,
    const int32_t* __restrict__ carry_rows, const float* __restrict__ carry_vals, int n_groups,
    int log_g) {
  carry<decltype(p), V>(p, row_ptr, range_items, carry_rows, carry_vals, n_groups, log_g);
}

template <int OP, int V>
int launch(const int32_t* row_ptr, const int32_t* col, const float* x, float* y, int n_out,
           int n_feat, float zero, int log_g, int range_items, int n_groups,
           int32_t* carry_rows, float* carry_vals, cudaStream_t st) {
  const Reduce<OP, V> p{col, x, y, n_feat, zero};
  const dim3 grid(blocks_for(n_groups, log_g), (n_feat + FEATURE_BLOCK - 1) / FEATURE_BLOCK);
  spmm_kernel<OP, V><<<grid, THREADS, 0, st>>>(p, row_ptr, n_out, range_items, n_groups, log_g,
                                              carry_rows, carry_vals);
  carry_kernel<OP, V><<<grid, THREADS, 0, st>>>(p, row_ptr, range_items, carry_rows, carry_vals,
                                               n_groups, log_g);
  return static_cast<int>(cudaGetLastError());
}

template <int OP>
int launch_vec(int vec, const int32_t* row_ptr, const int32_t* col, const float* x, float* y,
               int n_out, int n_feat, float zero, int log_g, int range_items, int n_groups,
               int32_t* carry_rows, float* carry_vals, cudaStream_t st) {
  if (vec == 4) {
    return launch<OP, 4>(row_ptr, col, x, y, n_out, n_feat, zero, log_g, range_items, n_groups,
                         carry_rows, carry_vals, st);
  }
  return launch<OP, 1>(row_ptr, col, x, y, n_out, n_feat, zero, log_g, range_items, n_groups,
                       carry_rows, carry_vals, st);
}

}  // namespace bitmap_spmm

// Launch on ``stream``; returns cudaGetLastError() as an int (0 = success).
// y holds n_out rows of n_feat floats; row_ptr holds at least n_out + 1
// offsets.  vec = 4 needs n_feat % 4 == 0 and x 16-byte aligned; a group
// is 2^log_g lanes (vec x 2^log_g <= 32); n_groups ranges of range_items
// items cover n_out + row_ptr[n_out]; the carry scratch holds n_groups
// rows and 2 n_groups n_feat floats.
extern "C" int bitmap_spmm_launch(const int32_t* row_ptr, const int32_t* col, const float* x,
                                  float* y, int n_out, int n_feat, int op, float zero, int vec,
                                  int log_g, int range_items, int n_groups,
                                  int32_t* carry_rows, float* carry_vals, int device,
                                  void* stream) {
  using namespace bitmap_spmm;
  if (n_out <= 0 || n_feat <= 0 || n_groups <= 0) return 0;
  if ((vec != 1 && vec != 4) || (vec << log_g) > FEATURE_BLOCK || range_items <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (op) {
    case OP_SUM:
      return launch_vec<OP_SUM>(vec, row_ptr, col, x, y, n_out, n_feat, zero, log_g, range_items,
                                n_groups, carry_rows, carry_vals, st);
    case OP_MIN:
      return launch_vec<OP_MIN>(vec, row_ptr, col, x, y, n_out, n_feat, zero, log_g, range_items,
                                n_groups, carry_rows, carry_vals, st);
    case OP_MAX:
      return launch_vec<OP_MAX>(vec, row_ptr, col, x, y, n_out, n_feat, zero, log_g, range_items,
                                n_groups, carry_rows, carry_vals, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
