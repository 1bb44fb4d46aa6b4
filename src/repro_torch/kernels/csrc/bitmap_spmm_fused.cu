// K3: last-layer SpMM with the DEDUP-C subtraction folded in, sm_90a.
//
// Replaces: src/repro/kernels/bitmap_spmm.py::_fused_kernel (the Pallas TPU
// kernel launched by _bitmap_spmm_fused).
//
// Computes y = B h - D x over the row index of the fused stream
// (bitmap_index.cu): for every row r < n_out, its main entries (weight 0,
// bits of the last layer's bitmaps, over h) and its correction entries
// (weight = the duplicate count sum_k 2^k bit_k folded from the P
// bit-planes, over x),
//   acc  = sum_{main e}  h[col[e]]
//   cacc = sum_{corr e}  weight[e] * x[col[e]]
//   y[r] = acc - cacc,
// two accumulators and one subtraction, as the TPU kernel's epilogue does.
// Plus-times only, float32 on CUDA cores (no tensor cores, no TF32):
// integer-valued frontiers give the same bits as SpMM-then-subtract.
//
// Why the bitmaps and planes are no longer read: the TPU kernel streamed
// each main bitmap and each correction slot's P planes (14 at the smoke's
// size, 2 KiB each) to find a few set bits, and split one count over up to
// P gathers.  The index holds one entry per correction count (2,955,152 in
// place of 3,422,444 plane bits on the smoke graph) and no empty words.
//
// What bounds it on the H100: the gathers.  The bytes these inputs need are
// the index (row_ptr, col, weight), each source row of h and x once and
// each output row once; the gathers re-read 128-byte source rows (F = 32)
// from L2, where h and x fit.  The correction is skewed (one row tile of
// 391 holds a quarter of its bits on the smoke graph), so a row per warp
// would leave one SM working long after the rest: the merge-path ranges of
// bitmap_common.cuh give every group the same number of items, and the
// carry pass merges split rows in a fixed order, so float sums are
// bit-identical from launch to launch.  At F > 32 (the triangle and
// clustering blocks' 128 columns) the wide route of bitmap_common.cuh
// walks each range once for all 128 features, gathering whole 512-byte
// rows of h and x.
//
// Launches: the range kernel and the carry pass, on the caller's stream.

#include "bitmap_common.cuh"

namespace bitmap_spmm {

template <int V>
struct Fused {
  const int32_t* __restrict__ col;
  const int32_t* __restrict__ weight;
  const float* __restrict__ h;
  const float* __restrict__ x;
  float* __restrict__ y;
  int n_feat;

  struct State {
    Vec<V> acc;    // main entries, over h
    Vec<V> cacc;   // correction entries, weight x x
  };
  struct Index {
    int col;   // -1 past the range
    int w;
  };
  struct Item {
    Vec<V> v;   // h row, or weight x the x row (rounded once)
    bool main;
  };

  __device__ static State init() { return {splat<V>(0.0f), splat<V>(0.0f)}; }
  __device__ Index index(int e, bool ok) const {
    return ok ? Index{__ldcs(col + e), __ldcs(weight + e)} : Index{-1, 0};
  }
  __device__ static Index shfl(Index i, int j, unsigned mask, int width) {
    return {__shfl_sync(mask, i.col, j, width), __shfl_sync(mask, i.w, j, width)};
  }
  __device__ Item gather(Index i, const Lane& l) const {
    Item it{splat<V>(0.0f), i.w == 0};
    if (i.col < 0 || !l.active) return it;
    it.v = load<V>((it.main ? h : x) + static_cast<int64_t>(i.col) * n_feat + l.feature);
    if (!it.main) {
      const float w = static_cast<float>(i.w);
#pragma unroll
      for (int k = 0; k < V; ++k) it.v.v[k] = __fmul_rn(w, it.v.v[k]);
    }
    return it;
  }
  __device__ static void fold(State& s, const Item& it) {
    if (it.main) s.acc = combine<OP_SUM, V>(s.acc, it.v);
    else s.cacc = combine<OP_SUM, V>(s.cacc, it.v);
  }
  __device__ static State merge(State a, const State& b) {
    return {combine<OP_SUM, V>(a.acc, b.acc), combine<OP_SUM, V>(a.cacc, b.cacc)};
  }
  template <bool STREAM = false>
  __device__ void finish(int r, const State& s, const Lane& l) const {
    if (!l.active) return;
    Vec<V> out;
#pragma unroll
    for (int k = 0; k < V; ++k) out.v[k] = __fsub_rn(s.acc.v[k], s.cacc.v[k]);
    store_y<STREAM>(y + static_cast<int64_t>(r) * n_feat + l.feature, out);
  }
  __device__ void save(float* vals, int64_t g, int slot, const State& s, const Lane& l) const {
    if (!l.active) return;
    store<V>(carry_slot<2>(vals, g, slot, 0, n_feat) + l.feature, s.acc);
    store<V>(carry_slot<2>(vals, g, slot, 1, n_feat) + l.feature, s.cacc);
  }
  __device__ State restore(const float* vals, int64_t g, int slot, const Lane& l) const {
    if (!l.active) return init();
    return {load<V>(carry_slot<2>(vals, g, slot, 0, n_feat) + l.feature),
            load<V>(carry_slot<2>(vals, g, slot, 1, n_feat) + l.feature)};
  }
};

template <int V>
__global__ void __launch_bounds__(THREADS) fused_kernel(
    Fused<V> p, const int32_t* __restrict__ row_ptr, int n_out, int range_items, int n_groups,
    int log_g, int32_t* __restrict__ carry_rows, float* __restrict__ carry_vals) {
  const Lane l = lane_of<V>(log_g, p.n_feat);
  if (l.group >= n_groups) return;
  walk(p, row_ptr, n_out, range_items, l, carry_rows, carry_vals);
}

// The wide route's range kernel (V = 4, F > 32).
__global__ void __launch_bounds__(THREADS) fused_wide_kernel(
    Fused<4> p, const int32_t* __restrict__ row_ptr, int n_out, int range_items, int n_groups,
    int log_g, int32_t* __restrict__ carry_rows, float* __restrict__ carry_vals) {
  const Lane l = lane_of<4, WIDE_BLOCK>(log_g, p.n_feat);
  if (l.group >= n_groups) return;
  walk_wide(p, row_ptr, n_out, range_items, l, log_g, carry_rows, carry_vals);
}

// FB: the feature block of the range kernel it follows.
template <int V, int FB>
__global__ void __launch_bounds__(THREADS) fused_carry_kernel(
    Fused<V> p, const int32_t* __restrict__ row_ptr, int range_items,
    const int32_t* __restrict__ carry_rows, const float* __restrict__ carry_vals, int n_groups,
    int log_g) {
  carry<decltype(p), V, FB>(p, row_ptr, range_items, carry_rows, carry_vals, n_groups, log_g);
}

template <int V>
int launch(const int32_t* row_ptr, const int32_t* col, const int32_t* weight, const float* h,
           const float* x, float* y, int n_out, int n_feat, int log_g, int range_items,
           int n_groups, int32_t* carry_rows, float* carry_vals, cudaStream_t st) {
  const Fused<V> p{col, weight, h, x, y, n_feat};
  const dim3 grid(blocks_for(n_groups, log_g), (n_feat + FEATURE_BLOCK - 1) / FEATURE_BLOCK);
  fused_kernel<V><<<grid, THREADS, 0, st>>>(p, row_ptr, n_out, range_items, n_groups, log_g,
                                            carry_rows, carry_vals);
  fused_carry_kernel<V, FEATURE_BLOCK><<<grid, THREADS, 0, st>>>(
      p, row_ptr, range_items, carry_rows, carry_vals, n_groups, log_g);
  return static_cast<int>(cudaGetLastError());
}

int launch_wide(const int32_t* row_ptr, const int32_t* col, const int32_t* weight,
                const float* h, const float* x, float* y, int n_out, int n_feat, int log_g,
                int range_items, int n_groups, int32_t* carry_rows, float* carry_vals,
                cudaStream_t st) {
  const Fused<4> p{col, weight, h, x, y, n_feat};
  const dim3 grid(blocks_for(n_groups, log_g), (n_feat + WIDE_BLOCK - 1) / WIDE_BLOCK);
  fused_wide_kernel<<<grid, THREADS, 0, st>>>(p, row_ptr, n_out, range_items, n_groups, log_g,
                                              carry_rows, carry_vals);
  fused_carry_kernel<4, WIDE_BLOCK><<<grid, THREADS, 0, st>>>(
      p, row_ptr, range_items, carry_rows, carry_vals, n_groups, log_g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bitmap_spmm

// Launch on ``stream``; returns cudaGetLastError() as an int (0 = success).
// As bitmap_spmm_launch, with the frontiers h (main entries) and x
// (correction entries) sharing n_feat, both 16-byte aligned for vec = 4
// (the wide route at n_feat > 32), and a carry scratch of n_groups rows
// and 4 n_groups n_feat floats.
extern "C" int bitmap_spmm_fused_launch(const int32_t* row_ptr, const int32_t* col,
                                        const int32_t* weight, const float* h, const float* x,
                                        float* y, int n_out, int n_feat, int vec, int log_g,
                                        int range_items, int n_groups, int32_t* carry_rows,
                                        float* carry_vals, int device, void* stream) {
  using namespace bitmap_spmm;
  if (n_out <= 0 || n_feat <= 0 || n_groups <= 0) return 0;
  if (!valid_grid(vec, n_feat, log_g) || range_items <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 4 && n_feat > FEATURE_BLOCK) {
    return launch_wide(row_ptr, col, weight, h, x, y, n_out, n_feat, log_g, range_items,
                       n_groups, carry_rows, carry_vals, st);
  }
  if (vec == 4) {
    return launch<4>(row_ptr, col, weight, h, x, y, n_out, n_feat, log_g, range_items, n_groups,
                     carry_rows, carry_vals, st);
  }
  return launch<1>(row_ptr, col, weight, h, x, y, n_out, n_feat, log_g, range_items, n_groups,
                   carry_rows, carry_vals, st);
}
