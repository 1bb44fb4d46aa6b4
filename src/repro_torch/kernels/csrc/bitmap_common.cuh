// Shared pieces of the SpMM kernels over the row index (sm_90a).
//
// Operands: the destination-row CSR of bitmap_index.cu (row_ptr, col, and
// for K3 weight), built once per uploaded graph from the packed bitmaps,
// and float32 frontiers (rows, n_feat) in row-major order.
//
// Schedule shared by the kernels here (merge-based CSR SpMM).  The
// n_out row ends and the row_ptr[n_out] entries form one merged list of
// n_out + nnz items (a row's end follows its last entry); it is cut into
// equal ranges of ``range_items`` items, one range per *group* of G lanes
// (G = 1 .. 32, a power of two; a warp holds 32 / G groups).  A group
// finds its range's first (row, entry) by binary search over row_ptr and
// walks its items in order, so no group walks more than range_items items
// however skewed the rows are.  Each lane of a group holds V consecutive
// features (V = 4: 16-byte float4 gathers when n_feat % 4 == 0 and the
// frontiers are 16-byte aligned; V = 1 otherwise), so at F = 32 eight
// lanes cover a source row and a warp is four groups; F > 32 tiles the
// feature axis over grid.y in blocks of 32.  A group loads BATCH entries'
// columns at once (streaming loads, so the index does not evict the
// frontiers from L2) and issues their BATCH gathers before it folds any of
// them: 16 source rows in flight a warp at F = 32.  On the H100 BATCH = 4
// beat 2, 8 and 16, and loading the next batch's columns early lost (more
// registers, fewer warps; scripts/spmm_times.py).
//
// Merge without atomics, in a fixed order.  A row that ends inside the
// range and began inside it is folded in registers and stored once.  The
// first row of a range may have begun in an earlier range (its partial is
// the range's *head*), and the last may go on into a later one (its
// partial is the range's *tail*).  Both go to a carry buffer, two slots
// per range, and a second short kernel gives each row with a head its
// value from the tails of the ranges before it that hold the row and the
// head, in a fixed order (see ``carry``; folding an identity is exact, so
// padding a batch of tails with it changes no bit).  The order depends only on the
// index and range_items, so float sums are bit-identical from launch to
// launch.  Every range writes its head row (-1 where it has none), so no
// scratch needs clearing.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace bitmap_spmm {

constexpr int THREADS = 256;
constexpr int FEATURE_BLOCK = 32;   // features per grid.y block
constexpr int BATCH = 4;            // entries a group has in flight

enum Op { OP_SUM = 0, OP_MIN = 1, OP_MAX = 2 };

template <int OP>
__host__ __device__ __forceinline__ float identity() {
  return OP == OP_SUM ? 0.0f : (OP == OP_MIN ? INFINITY : -INFINITY);
}

// Sums round once per add (no contraction with a multiply), so the plain
// mirror in bitmap_spmm.py repeats them bit for bit.
template <int OP>
__device__ __forceinline__ float combine(float acc, float v) {
  if (OP == OP_SUM) return __fadd_rn(acc, v);
  if (OP == OP_MIN) return fminf(acc, v);
  return fmaxf(acc, v);
}

template <int V>
struct Vec {
  float v[V];
};

template <int V>
__device__ __forceinline__ Vec<V> splat(float f) {
  Vec<V> r;
#pragma unroll
  for (int i = 0; i < V; ++i) r.v[i] = f;
  return r;
}

template <int V>
__device__ __forceinline__ Vec<V> load(const float* __restrict__ p) {
  Vec<V> r;
  if constexpr (V == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    r.v[0] = q.x; r.v[1] = q.y; r.v[2] = q.z; r.v[3] = q.w;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) r.v[i] = __ldg(p + i);
  }
  return r;
}

template <int V>
__device__ __forceinline__ void store(float* __restrict__ p, const Vec<V>& a) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(a.v[0], a.v[1], a.v[2], a.v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = a.v[i];
  }
}

template <int OP, int V>
__device__ __forceinline__ Vec<V> combine(Vec<V> acc, const Vec<V>& v) {
#pragma unroll
  for (int i = 0; i < V; ++i) acc.v[i] = combine<OP>(acc.v[i], v.v[i]);
  return acc;
}

// Rows whose ends lie before merged item d: the count of r < n_rows with
// row_ptr[r + 1] + r < d (row r's end is merged item row_ptr[r + 1] + r).
__device__ __forceinline__ int path_row(const int32_t* __restrict__ row_ptr, int n_rows,
                                        int64_t d) {
  int lo = 0;
  int hi = d < n_rows ? static_cast<int>(d) : n_rows;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(row_ptr + mid + 1) + static_cast<int64_t>(mid) < d) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// A lane's place in the grid: its group (one range), its first feature,
// and whether it writes the group's carry rows.
struct Lane {
  int64_t group;
  int feature;
  bool active;   // the feature exists
  bool writer;   // first lane of its group in feature block 0
};

template <int V>
__device__ __forceinline__ Lane lane_of(int log_g, int n_feat) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  const int g_lane = static_cast<int>(t & ((1 << log_g) - 1));
  Lane l;
  l.group = t >> log_g;
  l.feature = blockIdx.y * FEATURE_BLOCK + g_lane * V;
  l.active = l.feature < n_feat;
  l.writer = blockIdx.y == 0 && g_lane == 0;
  return l;
}

// Carry slots: range g's head (slot 0) and tail (slot 1), each ACC
// accumulators of n_feat floats; carry_rows[g] names the head's row (-1:
// none).  A tail's row needs no name: the carry pass finds the tails of row
// r from row_ptr.
template <int ACC, typename T>
__device__ __forceinline__ T* carry_slot(T* vals, int64_t g, int slot, int acc, int n_feat) {
  return vals + ((g * 2 + slot) * ACC + acc) * n_feat;
}

inline unsigned blocks_for(int64_t n_groups, int log_g) {
  return static_cast<unsigned>(((n_groups << log_g) + THREADS - 1) / THREADS);
}

// The walk of one range.  ``P`` is the kernel's policy: its accumulator
// ``State`` (init / fold / merge), ``index(e, ok)`` (the streaming loads of
// entry e's index words), ``gather`` (the source row's features),
// ``finish(r, state)`` (store row r of y) and ``save`` / ``restore`` (a
// carry slot).  A group's lanes share every branch.
template <class P>
__device__ __forceinline__ void walk(const P& p, const int32_t* __restrict__ row_ptr,
                                     int n_out, int range_items, const Lane& l,
                                     int32_t* __restrict__ carry_rows,
                                     float* __restrict__ carry_vals) {
  const int nnz = __ldg(row_ptr + n_out);
  const int64_t total = n_out + static_cast<int64_t>(nnz);
  int64_t d = l.group * range_items;
  const int64_t d_end = d + range_items < total ? d + range_items : total;
  int head = -1;
  if (d < total) {
    int r = path_row(row_ptr, n_out, d);
    int e = static_cast<int>(d - r);
    const int r0 = r;
    const bool begun = e > __ldg(row_ptr + r);   // row r0 began in an earlier range
    int row_end = __ldg(row_ptr + r + 1);
    int row_first = e;
    typename P::State acc = P::init();
    while (d < d_end) {
      const int64_t left = d_end - d;
      typename P::Index idx[BATCH];
#pragma unroll
      for (int k = 0; k < BATCH; ++k) idx[k] = p.index(e + k, k < left && e + k < nnz);
      typename P::Item v[BATCH];
#pragma unroll
      for (int k = 0; k < BATCH; ++k) v[k] = p.gather(idx[k], l);
#pragma unroll
      for (int k = 0; k < BATCH; ++k) {
        while (e >= row_end && d < d_end) {   // the next item is row r's end
          if (r == r0 && begun) {
            p.save(carry_vals, l.group, 0, acc, l);
            head = r;
          } else {
            p.finish(r, acc, l);
          }
          ++r;
          ++d;
          row_first = e;
          acc = P::init();
          if (r < n_out) row_end = __ldg(row_ptr + r + 1);
        }
        if (d >= d_end) break;
        P::fold(acc, v[k]);   // entry e = the batch's first + k
        ++e;
        ++d;
      }
    }
    if (e > row_first) p.save(carry_vals, l.group, 1, acc, l);   // row r goes on
  }
  if (l.writer) carry_rows[l.group] = head;
}

// The carry pass, one kernel; each range with a head finishes its row r
// from the tails of the ranges before it that hold the row, then the head.
// Those T tails are the ranges from the one holding r's first entry
// (merged item row_ptr[r] + r) up to the head's, so no search is needed.
// They are cut into CHUNKS chunks of ceil(T / CHUNKS) consecutive tails,
// each folded in order from the identity, and the row is the identity,
// then the chunks in order, then the head: for T <= CHUNKS a chunk is one
// tail, so that is the plain range order.  A light head (T <= CHUNKS)
// folds its chunks alone; a heavy one (a row over more than CHUNKS ranges:
// the high-degree rows of a skewed graph) is folded by every group of its
// block, a chunk or more each, through shared memory, so no group walks
// more than about T / CHUNKS + CHUNKS slots.  Heavy heads lie more than
// CHUNKS ranges apart, so a block meets at most MAX_HEAVY of them.
constexpr int CHUNKS = 32;
constexpr int MAX_HEAVY = THREADS / (CHUNKS + 1) + 1;

// Fold the tail slots [u0, u1) into acc, BATCH loads in flight.
template <class P>
__device__ __forceinline__ void fold_tails(const P& p, typename P::State& acc,
                                           const float* __restrict__ carry_vals, int64_t u0,
                                           int64_t u1, const Lane& l) {
  for (int64_t u = u0; u < u1; u += BATCH) {
    typename P::State tails[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      tails[k] = u + k < u1 ? p.restore(carry_vals, u + k, 1, l) : P::init();
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k) acc = P::merge(acc, tails[k]);   // identity: no-op
  }
}

template <class P, int V>
__device__ __forceinline__ void carry(const P& p, const int32_t* __restrict__ row_ptr,
                                      int range_items, const int32_t* __restrict__ carry_rows,
                                      const float* __restrict__ carry_vals, int64_t n_groups,
                                      int log_g) {
  __shared__ typename P::State part[CHUNKS][FEATURE_BLOCK / V];
  __shared__ int heavy[MAX_HEAVY];
  __shared__ int n_heavy;
  const Lane l = lane_of<V>(log_g, p.n_feat);
  const int g_lane = threadIdx.x & ((1 << log_g) - 1);
  const int local = threadIdx.x >> log_g;   // group within the block
  const int n_local = THREADS >> log_g;
  const int64_t block_group = l.group - local;
  if (threadIdx.x == 0) n_heavy = 0;
  __syncthreads();
  const int r = l.group < n_groups ? carry_rows[l.group] : -1;
  const int64_t first =
      r >= 0 ? (__ldg(row_ptr + r) + static_cast<int64_t>(r)) / range_items : l.group;
  if (r >= 0 && l.group - first <= CHUNKS) {
    typename P::State acc = P::init();
    fold_tails(p, acc, carry_vals, first, l.group, l);
    p.finish(r, P::merge(acc, p.restore(carry_vals, l.group, 0, l)), l);
  } else if (r >= 0 && g_lane == 0) {
    heavy[atomicAdd(&n_heavy, 1)] = local;   // the order found does not matter
  }
  __syncthreads();
  for (int k = 0; k < n_heavy; ++k) {
    const int64_t g = block_group + heavy[k];
    const int hr = carry_rows[g];
    const int64_t h_first = (__ldg(row_ptr + hr) + static_cast<int64_t>(hr)) / range_items;
    const int64_t size = (g - h_first + CHUNKS - 1) / CHUNKS;
    for (int j = local; j < CHUNKS; j += n_local) {
      const int64_t u0 = h_first + j * size;
      typename P::State acc = P::init();
      fold_tails(p, acc, carry_vals, u0, u0 + size < g ? u0 + size : g, l);
      part[j][g_lane] = acc;
    }
    __syncthreads();
    if (local == heavy[k]) {
      typename P::State acc = P::init();
      for (int j = 0; j < CHUNKS; ++j) acc = P::merge(acc, part[j][g_lane]);
      p.finish(hr, P::merge(acc, p.restore(carry_vals, g, 0, l)), l);
    }
    __syncthreads();
  }
}

}  // namespace bitmap_spmm
