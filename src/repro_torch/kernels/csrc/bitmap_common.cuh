// Shared pieces of the bit-packed block-sparse SpMM kernels (sm_90a).
//
// Operand layout (repro_torch/kernels/pack.py, byte-identical to the JAX
// package's): each slot is a 128x128 0/1 block stored as 128 rows x 4
// uint32 words; bit j of word w in row r is source column 32*w + j of the
// slot's source tile.  A 2 KiB bitmap is a "unit": one per slot for K1/K2,
// one per main slot and one per correction slot and bit-plane for K3.
//
// Schedule shared by every kernel here.  A block of 8 warps takes 16
// consecutive units and one feature block of 32 columns; warp k takes
// rows 16k .. 16k+15 of each of its units, lane l one feature column.  A
// lane first loads its 8 bytes of all 16 units (row l/2, columns
// 64*(l%2) .. +63) with streaming loads, so a warp keeps 4 KiB of bitmap
// reads in flight and the bitmaps do not push the frontier and the output
// out of L2.  For each unit a ballot says which lanes hold any set bit;
// the warp walks those word pairs and queues one entry (destination row,
// source row) per set bit, lane q holding entry q.  A full queue (32
// entries), and the last one, is drained eight entries a round: every
// lane loads its feature of the eight source rows at once (one coalesced
// row segment each), sums runs of entries that share a destination row
// (also across drains), and folds each run into y with one atomic per
// lane.  Queued entries cross unit boundaries, so the loads of a warp's
// sparse units overlap instead of waiting one by one.  The words are
// warp-uniform, so no loop diverges.
//
// Why not one block per output row tile, as the TPU kernel's grid had it:
// the graphs this serves are skewed.  On DBLP-shaped data a few
// high-degree authors own most of the correction's set bits (on the
// smoke's 50K-author graph one output row tile of 391 holds a quarter of
// them, and single bit-planes are over half dense), so a block per row
// tile leaves one SM working long after the rest are idle.  Equal slices of the unit list spread that work over
// the card; atomics merge the slices' partial rows.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace bitmap_spmm {

constexpr int TILE = 128;
constexpr int UNIT_PAIRS = TILE * TILE / 64;       // uint2 per 2 KiB unit: 256
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS_PER_WARP = TILE / WARPS;        // 16 rows = 32 uint2
constexpr int FEATURE_BLOCK = 32;                  // one feature per lane
constexpr int UNITS_PER_BLOCK = 16;
constexpr int LOADS_PER_ROUND = 8;
constexpr unsigned FULL_MASK = 0xffffffffu;

static_assert(ROWS_PER_WARP * 2 == 32, "a lane holds half a row of a warp's rows");
static_assert(UNITS_PER_BLOCK <= 32, "one lane holds each unit's tables");
static_assert(32 % LOADS_PER_ROUND == 0, "rounds tile the queue");

enum Op { OP_SUM = 0, OP_MIN = 1, OP_MAX = 2 };

template <int OP>
__host__ __device__ __forceinline__ float identity() {
  return OP == OP_SUM ? 0.0f : (OP == OP_MIN ? INFINITY : -INFINITY);
}

template <int OP>
__device__ __forceinline__ float combine(float acc, float v) {
  if (OP == OP_SUM) return acc + v;
  if (OP == OP_MIN) return fminf(acc, v);
  return fmaxf(acc, v);
}

// *addr (+)= v.  Float min/max through the integer atomics: for v with
// the sign bit clear the float order is the signed-integer order of the
// bits; with it set, the reversed unsigned order.
template <int OP>
__device__ __forceinline__ void atomic_combine(float* addr, float v) {
  if (OP == OP_SUM) {
    atomicAdd(addr, v);
    return;
  }
  const int bits = __float_as_int(v);
  int* as_int = reinterpret_cast<int*>(addr);
  unsigned* as_uint = reinterpret_cast<unsigned*>(addr);
  if (OP == OP_MIN) {
    if (bits >= 0) atomicMin(as_int, bits);
    else atomicMax(as_uint, static_cast<unsigned>(bits));
  } else {
    if (bits >= 0) atomicMax(as_int, bits);
    else atomicMin(as_uint, static_cast<unsigned>(bits));
  }
}

// A warp's queue of set bits.  Entry q lives in lane q's registers; n is
// warp-uniform.  ``code`` picks the operand and weight (K3): 0 reads ``a``
// with weight 1, k + 1 reads ``b`` with weight -2^k (sums only).  The
// pending run (``prow``, ``pacc``: one destination row and this lane's
// partial for it) carries across drains, so consecutive bits of one row
// cost one atomic.
struct BitQueue {
  int n = 0;
  int row = 0;   // destination row of this lane's entry
  int src = 0;   // source row
  int code = 0;
  int prow = -1;
  float pacc = 0.0f;
};

// Where every lane sends its feature: operands, output and row width.
struct Target {
  const float* __restrict__ a;
  const float* __restrict__ b;
  float* __restrict__ y;
  int ld;        // features per row of a, b and y
  int feature;   // this lane's column
  bool active;   // the column exists
};

template <int OP>
__device__ __forceinline__ void flush_run(BitQueue& q, const Target& t) {
  if (q.prow >= 0 && t.active) {
    atomic_combine<OP>(t.y + static_cast<int64_t>(q.prow) * t.ld + t.feature, q.pacc);
  }
  q.prow = -1;
}

// Load the queued entries' source features, LOADS_PER_ROUND at once, and
// fold them into the pending run, emitting it whenever the row changes.
template <int OP>
__device__ __forceinline__ void drain(BitQueue& q, const Target& t) {
  for (int k0 = 0; k0 < q.n; k0 += LOADS_PER_ROUND) {
    float v[LOADS_PER_ROUND];
    int row[LOADS_PER_ROUND];
#pragma unroll
    for (int j = 0; j < LOADS_PER_ROUND; ++j) {
      const int k = k0 + j;
      row[j] = __shfl_sync(FULL_MASK, q.row, k);
      const int src = __shfl_sync(FULL_MASK, q.src, k);
      const int code = __shfl_sync(FULL_MASK, q.code, k);
      v[j] = identity<OP>();
      if (k < q.n && t.active) {
        v[j] = __ldg((code == 0 ? t.a : t.b) + static_cast<int64_t>(src) * t.ld + t.feature);
        if (OP == OP_SUM && code != 0) v[j] *= -static_cast<float>(1u << (code - 1));
      }
    }
#pragma unroll
    for (int j = 0; j < LOADS_PER_ROUND; ++j) {
      if (k0 + j >= q.n) break;
      if (row[j] == q.prow) {
        q.pacc = combine<OP>(q.pacc, v[j]);
      } else {
        flush_run<OP>(q, t);
        q.prow = row[j];
        q.pacc = v[j];
      }
    }
  }
  q.n = 0;
}

// Drain the queue and emit the pending run: the warp's last word.
template <int OP>
__device__ __forceinline__ void finish(BitQueue& q, const Target& t) {
  drain<OP>(q, t);
  flush_run<OP>(q, t);
}

// Queue the set bits of one unit's rows 16*warp .. +15 (destination row
// tile ``dst_tile``, source tile ``src_tile``, operand ``code``), draining
// whenever the queue fills.  ``pair`` is this lane's 8 bytes of the unit.
template <int OP>
__device__ __forceinline__ void queue_unit(BitQueue& q, const Target& t, uint2 pair,
                                           int dst_tile, int src_tile, int code,
                                           int n_out, int warp, int lane) {
  unsigned nz = __ballot_sync(FULL_MASK, (pair.x | pair.y) != 0u);
  while (nz) {
    const int l = __ffs(nz) - 1;
    nz &= nz - 1;
    const uint32_t w0 = __shfl_sync(FULL_MASK, pair.x, l);
    const uint32_t w1 = __shfl_sync(FULL_MASK, pair.y, l);
    uint64_t bits = (static_cast<uint64_t>(w1) << 32) | w0;
    const int row = dst_tile * TILE + warp * ROWS_PER_WARP + (l >> 1);
    if (row >= n_out) continue;
    const int col0 = src_tile * TILE + 64 * (l & 1);
    while (bits) {
      const int b = __ffsll(static_cast<long long>(bits)) - 1;
      bits &= bits - 1;
      if (lane == q.n) {
        q.row = row;
        q.src = col0 + b;
        q.code = code;
      }
      if (++q.n == 32) drain<OP>(q, t);
    }
  }
}

// y[i] = v for i < n (grid-stride).
__global__ void fill_kernel(float* __restrict__ y, int64_t n, float v) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    y[i] = v;
  }
}

// y[i] = to where y[i] == from (grid-stride): the semiring-zero epilogue.
__global__ void replace_kernel(float* __restrict__ y, int64_t n, float from, float to) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    if (y[i] == from) y[i] = to;
  }
}

inline dim3 elementwise_grid(int64_t n) {
  const int64_t blocks = (n + THREADS - 1) / THREADS;
  return dim3(static_cast<unsigned>(blocks < 4096 ? (blocks > 0 ? blocks : 1) : 4096));
}

}  // namespace bitmap_spmm
