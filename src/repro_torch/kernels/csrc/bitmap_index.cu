// The row index of a packed incidence, built on the card at upload, sm_90a.
//
// Serves: the SpMM kernels that replace src/repro/kernels/bitmap_spmm.py::
// _kernel (K1/K2, bitmap_spmm.cu) and ::_fused_kernel (K3,
// bitmap_spmm_fused.cu); it replaces no Pallas kernel itself.  The TPU
// kernels read the 128x128 bitmaps on every call; on the condensed layers
// this serves a 2 KiB bitmap holds a few set bits (3.3 on the DBLP smoke
// graph's first layer), so the SpMMs here read a destination-row CSR of the
// set bits instead, built once per uploaded graph from the same
// byte-identical operands:
//
//   row_ptr (n_rows + 1) int32   entries of row r: [row_ptr[r], row_ptr[r+1])
//   col     (nnz) int32          source row of each entry
//   weight  (nnz) int32          fused stream only: 0 marks a main entry (a
//                                bit of the layer's bitmap, over h); a
//                                correction entry (over x) holds its count
//                                sum_k 2^k bit_k, folded from the P planes
//
// n_rows = 128 x the row tiles.  The order is fixed by the layout, with no
// sort and no atomics: slots are sorted by (row tile, source tile) and the
// run table row_start / row_count names each row tile's slots; each row's
// entries come in slot order, columns ascending within a slot.  A fused row
// thus holds its main entries, then its correction entries, as the stream
// orders its slots.
//
// Bound: device memory.  Every stored bitmap and bit-plane (2 KiB units) is
// read once per pass; the index written is small beside them (the DBLP
// smoke graph's fused stream: 810,552 units, 1.66 GB, for 28 MB of index).
//
// Schedule.  The tiles are uneven (the smoke's fused stream: 2,073 units a
// tile on average, up to 6,256), and one block per tile with each thread
// walking its tile's slots one load at a time left the card waiting on
// memory latency: 13.3 ms for that stream on an H100, 3.8% of its bound,
// slower than the plain PyTorch version.  So:
//
//  * Chunks.  Windows of U units (a main slot 1, a correction slot P) on
//    the stream's unit axis, cut where a row tile ends: slot s of tile t
//    lies in chunk floor(o_s / U) + t, o_s the units before it.  A chunk
//    holds at most U slots (U <= 32: one bit each in a mask) and at most
//    U - 1 + P units; tile t's chunks are [base[t-1], base[t]) with
//    base[t] = floor(o_end / U) + t + 1, so every tile has at least one and
//    an empty tile's rows still get a row_ptr entry.  The grid is
//    n_rt + floor(units / U) chunks, known on the host (exact for one
//    direction; for the fused stream bounded by one correction slot per
//    plane unit, and a stream past it is refused after the count pass).
//    For one direction (every slot one unit) base and each chunk's slots
//    have closed forms in the run table, which the kernels evaluate: on the
//    card each tensor op is a launch on the host's clock, and the builds
//    run one after another at upload.  The fused stream's table (a scan of
//    the slots' units and a search) comes from the wrapper's tensor ops.
//  * Count pass, one block of 128 threads a chunk, thread i owning row i of
//    the tile.  Warp 0 finds the chunk's tile by a 32-way search of base
//    and stages its slots (kind, index, source) and their units' addresses
//    in shared memory; each thread then loads its 16-byte row of 8 units
//    before it uses any of them, so 8 loads are in flight a thread.  It
//    writes its row's entry count and a mask of the chunk's slots whose row
//    is not empty.  The counts go straight into output order: tile t, row
//    i, chunk k at 128 base[t-1] + i n_t + k (n_t = the tile's chunks), so
//    one flat inclusive scan (the wrapper's torch.cumsum, exact in int32)
//    gives every (chunk, row) its first entry and every row its row_ptr.
//  * Fill pass, the same grid.  Each thread starts at the entries before
//    its (chunk, row) and loads only the slots its mask names, up to 8 main
//    rows in flight: on the smoke graph's main slots that is 3.3 set bits
//    in 2 KiB, so most rows are never read again.  A correction slot's P
//    plane rows are loaded once, kept in shared memory for the thread, and
//    each set bit's count is folded from there: no plane row is read twice
//    within a pass.  The correction planes are dense enough that the fill
//    reads most of them again, so the fused stream's floor is about twice
//    its bound.
//
// Both kernels are templated on the stream's kind: one direction has no
// correction path, no weight and no kind / index loads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace bitmap_index {

constexpr int TILE = 128;
constexpr int MAX_SLOTS = 32;                      // a chunk's slots: one mask bit each
constexpr int MAX_PLANES = 31;                     // counts fit 31 bits
constexpr int MAX_UNITS = MAX_SLOTS + MAX_PLANES;  // U - 1 + P at most
constexpr int BATCH = 8;                           // 16-byte row loads in flight a thread
constexpr int LAST = 0x40;                         // unit tag: the last unit of its slot

struct Stream {
  const int32_t* kind;      // null: one direction, every slot a main slot
  const int32_t* main_idx;  // null: slot s reads bitmap s
  const int32_t* corr_idx;
  const int32_t* main_src;  // slot_src in one direction
  const int32_t* corr_src;
  const int32_t* row_start;
  const int32_t* row_count;
  const uint4* bitmaps;
  const uint4* planes;
  int n_planes;
};

struct Chunks {
  const int32_t* base;   // n_rt: row tile t's chunks are [base[t-1], base[t]); null: one
                         // direction, base[t] = (row_start[t] + row_count[t]) / U + t + 1
  const int32_t* first;  // n_chunks + 1: chunk c's slots are [first[c], first[c+1]); null:
                         // one direction, tile t's slots in [(c - t) U, (c - t) U + U)
  int n_rt;
  int n_chunks;          // the grid; chunks from base[n_rt - 1] on are empty
  int units;             // U
};

// One block's chunk, staged in shared memory by warp 0.
struct Chunk {
  int tile, k, n_tile_chunks, base, n_units;
  const uint4* slot_ptr[MAX_SLOTS];  // the slot's unit 0 (a correction slot's P planes follow)
  int slot_src[MAX_SLOTS];           // source tile
  int slot_corr[MAX_SLOTS];
  const uint4* unit_ptr[MAX_UNITS];
  int unit_tag[MAX_UNITS];           // slot in the chunk | LAST
};

__device__ __forceinline__ int popc4(uint4 w) {
  return __popc(w.x) + __popc(w.y) + __popc(w.z) + __popc(w.w);
}

__device__ __forceinline__ uint4 or4(uint4 a, uint4 b) {
  return make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
}

__device__ __forceinline__ uint32_t word_of(uint4 w, int k) {
  return k == 0 ? w.x : (k == 1 ? w.y : (k == 2 ? w.z : w.w));
}

// The end of row tile t's chunks: base[t], from the run table in one
// direction.
__device__ __forceinline__ int tile_end(const Stream& st, const Chunks& ch, int t) {
  if (ch.base != nullptr) return __ldg(ch.base + t);
  return (__ldg(st.row_start + t) + __ldg(st.row_count + t)) / ch.units + t + 1;
}

// The tiles whose chunks all lie below chunk c: the count of t with
// tile_end(t) <= c, in [0, n_rt] (the ends ascend strictly), by one warp.
// Each round the 32 lanes probe 32 points of the range left, so a few
// rounds of one load each find it.
__device__ __forceinline__ int find_tile(const Stream& st, const Chunks& ch, int c, int lane) {
  int lo = 0, hi = ch.n_rt;  // the count lies in [lo, hi]
  while (lo < hi) {
    const int span = hi - lo;
    const int q = lo + 1 + static_cast<int>((static_cast<int64_t>(lane) * span) >> 5);
    const int m = __popc(__ballot_sync(0xffffffffu, tile_end(st, ch, q - 1) <= c));
    const int below = __shfl_sync(0xffffffffu, q, max(m - 1, 0));
    const int above = __shfl_sync(0xffffffffu, q, min(m, 31));
    if (m > 0) lo = below;
    if (m < 32) hi = above - 1;
  }
  return lo;
}

// Appends the set bits of main row ``w`` (columns of the source tile at
// ``src``) at col[cursor ..], ascending, with weight 0 in the fused stream.
template <bool FUSED>
__device__ __forceinline__ void emit_main(uint4 w, int src, int32_t* __restrict__ col,
                                          int32_t* __restrict__ weight, int& cursor) {
#pragma unroll
  for (int kw = 0; kw < 4; ++kw) {
    uint32_t bits = word_of(w, kw);
    while (bits) {
      const int b = __ffs(bits) - 1;
      bits &= bits - 1;
      col[cursor] = src + 32 * kw + b;
      if (FUSED) weight[cursor] = 0;
      ++cursor;
    }
  }
}

// Warp 0 stages chunk c: its tile, its slots and their units.  FUSED: the
// stream has correction slots; else every slot is a main slot reading
// bitmap s.
template <bool FUSED>
__device__ void stage(const Stream& st, const Chunks& ch, int c, Chunk& sm) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int t = find_tile(st, ch, c, lane);
    int b = 0, n_tc = 0, s0 = 0, s1 = 0;
    if (t < ch.n_rt) {
      b = t == 0 ? 0 : tile_end(st, ch, t - 1);
      n_tc = tile_end(st, ch, t) - b;
      if (ch.first != nullptr) {
        s0 = __ldg(ch.first + c);
        s1 = __ldg(ch.first + c + 1);
      } else {
        const int rs = __ldg(st.row_start + t), re = rs + __ldg(st.row_count + t);
        s0 = max(rs, (c - t) * ch.units);
        s1 = min(re, (c - t + 1) * ch.units);
      }
    }
    int units = 0;
    const uint4* p = nullptr;
    if (lane < s1 - s0) {
      const int s = s0 + lane;
      const bool corr = FUSED && __ldg(st.kind + s) != 0;
      if (corr) {
        p = st.planes + static_cast<int64_t>(__ldg(st.corr_idx + s)) * st.n_planes * TILE;
        units = st.n_planes;
      } else {
        p = st.bitmaps + static_cast<int64_t>(FUSED ? __ldg(st.main_idx + s) : s) * TILE;
        units = 1;
      }
      sm.slot_ptr[lane] = p;
      sm.slot_src[lane] = __ldg((corr ? st.corr_src : st.main_src) + s);
      sm.slot_corr[lane] = corr;
    }
    int end = units;  // inclusive scan of the slots' units over the warp
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, end, d);
      if (lane >= d) end += v;
    }
    for (int q = 0; q < units; ++q) {
      sm.unit_ptr[end - units + q] = p + q * TILE;
      sm.unit_tag[end - units + q] = lane | (q == units - 1 ? LAST : 0);
    }
    if (lane == 31) {
      sm.tile = t;
      sm.k = c - b;
      sm.n_tile_chunks = n_tc;
      sm.base = b;
      sm.n_units = end;
    }
  }
  __syncthreads();
}

// Pass 1: counts in output order (see the note) and the masks, (chunk, row).
// counts[128 n_chunks] gets the chunks the grid lacks (0 unless the
// wrapper's bound was short, which it then refuses).
template <bool FUSED>
__global__ void __launch_bounds__(TILE) count_kernel(Stream st, Chunks ch,
                                                     int32_t* __restrict__ counts,
                                                     uint32_t* __restrict__ masks) {
  __shared__ Chunk sm;
  const int c = blockIdx.x;
  const int i = threadIdx.x;
  stage<FUSED>(st, ch, c, sm);
  const int n_units = sm.n_units;
  uint4 acc = make_uint4(0u, 0u, 0u, 0u);
  int n = 0;
  uint32_t mask = 0;
  for (int j0 = 0; j0 < n_units; j0 += BATCH) {
    uint4 w[BATCH];
#pragma unroll
    for (int q = 0; q < BATCH; ++q) {
      w[q] = j0 + q < n_units ? __ldg(sm.unit_ptr[j0 + q] + i) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int q = 0; q < BATCH; ++q) {
      if (j0 + q < n_units) {
        acc = or4(acc, w[q]);
        const int tag = sm.unit_tag[j0 + q];
        if (tag & LAST) {
          const int bits = popc4(acc);
          n += bits;
          mask |= static_cast<uint32_t>(bits != 0) << (tag & (MAX_SLOTS - 1));
          acc = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
  }
  const int64_t cap = static_cast<int64_t>(ch.n_chunks) * TILE;
  if (sm.tile < ch.n_rt) {
    const int64_t at = static_cast<int64_t>(sm.base) * TILE +
                       static_cast<int64_t>(i) * sm.n_tile_chunks + sm.k;
    if (at < cap) counts[at] = n;
  } else {
    counts[static_cast<int64_t>(c) * TILE + i] = 0;
  }
  masks[static_cast<int64_t>(c) * TILE + i] = mask;
  if (c == 0 && i == 0) counts[cap] = max(0, tile_end(st, ch, ch.n_rt - 1) - ch.n_chunks);
}

// Pass 2: row_ptr, col and (FUSED) weight.  ``scan`` is the inclusive scan
// of pass 1's counts; ``nnz`` its total.
template <bool FUSED>
__global__ void __launch_bounds__(TILE) fill_kernel(
    Stream st, Chunks ch, const int32_t* __restrict__ scan, const uint32_t* __restrict__ masks,
    int nnz, int32_t* __restrict__ row_ptr, int32_t* __restrict__ col,
    int32_t* __restrict__ weight) {
  extern __shared__ uint4 plane_rows[];  // P x 128: each thread's rows of one correction slot
  __shared__ Chunk sm;
  const int c = blockIdx.x;
  const int i = threadIdx.x;
  if (c == 0 && i == 0) row_ptr[static_cast<int64_t>(ch.n_rt) * TILE] = nnz;
  uint32_t mask = masks[static_cast<int64_t>(c) * TILE + i];
  stage<FUSED>(st, ch, c, sm);
  if (sm.tile >= ch.n_rt) return;
  if (sm.k != 0 && mask == 0) return;
  const int64_t at = static_cast<int64_t>(sm.base) * TILE +
                     static_cast<int64_t>(i) * sm.n_tile_chunks + sm.k;
  int cursor = at == 0 ? 0 : scan[at - 1];
  if (sm.k == 0) row_ptr[static_cast<int64_t>(sm.tile) * TILE + i] = cursor;
  const int n_planes = st.n_planes;
  while (mask) {
    // the next run of main slots, up to BATCH, loaded before any is used
    int js[BATCH];
    uint4 w[BATCH];
#pragma unroll
    for (int q = 0; q < BATCH; ++q) {
      js[q] = -1;
      w[q] = make_uint4(0u, 0u, 0u, 0u);
      if (mask != 0) {
        const int j = __ffs(mask) - 1;
        if (!FUSED || !sm.slot_corr[j]) {
          js[q] = j;
          mask &= mask - 1;
          w[q] = __ldg(sm.slot_ptr[j] + i);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < BATCH; ++q) {
      if (js[q] >= 0) emit_main<FUSED>(w[q], sm.slot_src[js[q]] * TILE, col, weight, cursor);
    }
    if (!FUSED || mask == 0 || !sm.slot_corr[__ffs(mask) - 1]) continue;
    // a correction slot: its P plane rows, loaded once and kept for the fold
    const int j = __ffs(mask) - 1;
    mask &= mask - 1;
    const uint4* p = sm.slot_ptr[j];
    const int src = sm.slot_src[j] * TILE;
    uint4 present = make_uint4(0u, 0u, 0u, 0u);
    for (int q0 = 0; q0 < n_planes; q0 += BATCH) {
      uint4 v[BATCH];
#pragma unroll
      for (int r = 0; r < BATCH; ++r) {
        v[r] = q0 + r < n_planes ? __ldg(p + (q0 + r) * TILE + i) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int r = 0; r < BATCH; ++r) {
        if (q0 + r < n_planes) {
          plane_rows[(q0 + r) * TILE + i] = v[r];
          present = or4(present, v[r]);
        }
      }
    }
    const uint32_t* words = reinterpret_cast<const uint32_t*>(plane_rows);
    for (int kw = 0; kw < 4; ++kw) {
      uint32_t bits = word_of(present, kw);
      while (bits) {
        const int b = __ffs(bits) - 1;
        bits &= bits - 1;
        int count = 0;
        for (int q = 0; q < n_planes; ++q) {
          count |= static_cast<int>((words[(q * TILE + i) * 4 + kw] >> b) & 1u) << q;
        }
        col[cursor] = src + 32 * kw + b;
        weight[cursor] = count;
        ++cursor;
      }
    }
  }
}

}  // namespace bitmap_index

namespace {

bitmap_index::Stream make_stream(const int32_t* kind, const int32_t* main_idx,
                                 const int32_t* corr_idx, const int32_t* main_src,
                                 const int32_t* corr_src, const int32_t* row_start,
                                 const int32_t* row_count, const uint32_t* bitmaps,
                                 const uint32_t* planes, int n_planes) {
  return {kind, main_idx, corr_idx, main_src, corr_src, row_start, row_count,
          reinterpret_cast<const uint4*>(bitmaps), reinterpret_cast<const uint4*>(planes),
          n_planes};
}

// 0 if the launch may go ahead, else the error to return.
int check(int n_planes, int n_chunks, int units, int device) {
  if (n_planes < 1 || n_planes > bitmap_index::MAX_PLANES) return cudaErrorInvalidValue;
  if (units < 1 || units > bitmap_index::MAX_SLOTS || n_chunks < 1) return cudaErrorInvalidValue;
  return static_cast<int>(cudaSetDevice(device));
}

}  // namespace

// Both passes take the stream as it is stored: for one direction kind,
// main_idx, corr_idx, corr_src and planes are null, main_src is slot_src
// and n_planes is 1.  base (n_rt) and first (n_chunks + 1) are the
// wrapper's chunk table, both null for one direction.  Launch on
// ``stream``; return cudaGetLastError() as an int (0 = success).

// Pass 1: counts (128 n_chunks + 1) int32 and masks (n_chunks x 128).
extern "C" int bitmap_index_count_launch(
    const int32_t* kind, const int32_t* main_idx, const int32_t* corr_idx,
    const int32_t* main_src, const int32_t* corr_src, const int32_t* row_start,
    const int32_t* row_count, const uint32_t* bitmaps, const uint32_t* planes, int n_planes,
    const int32_t* base, const int32_t* first, int n_rt, int n_chunks, int units,
    int32_t* counts, uint32_t* masks, int device, void* stream) {
  using namespace bitmap_index;
  if (n_rt <= 0) return 0;
  const int bad = check(n_planes, n_chunks, units, device);
  if (bad != 0) return bad;
  const Stream st = make_stream(kind, main_idx, corr_idx, main_src, corr_src, row_start,
                                row_count, bitmaps, planes, n_planes);
  const Chunks ch{base, first, n_rt, n_chunks, units};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind != nullptr) {
    count_kernel<true><<<n_chunks, TILE, 0, s>>>(st, ch, counts, masks);
  } else {
    count_kernel<false><<<n_chunks, TILE, 0, s>>>(st, ch, counts, masks);
  }
  return static_cast<int>(cudaGetLastError());
}

// Pass 2: row_ptr (128 n_rt + 1), col and (fused) weight (nnz), from the
// inclusive scan of pass 1's counts.
extern "C" int bitmap_index_fill_launch(
    const int32_t* kind, const int32_t* main_idx, const int32_t* corr_idx,
    const int32_t* main_src, const int32_t* corr_src, const int32_t* row_start,
    const int32_t* row_count, const uint32_t* bitmaps, const uint32_t* planes, int n_planes,
    const int32_t* base, const int32_t* first, int n_rt, int n_chunks, int units,
    const int32_t* scan, const uint32_t* masks, int nnz, int32_t* row_ptr, int32_t* col,
    int32_t* weight, int device, void* stream) {
  using namespace bitmap_index;
  if (n_rt <= 0) return 0;
  const int bad = check(n_planes, n_chunks, units, device);
  if (bad != 0) return bad;
  const Stream st = make_stream(kind, main_idx, corr_idx, main_src, corr_src, row_start,
                                row_count, bitmaps, planes, n_planes);
  const Chunks ch{base, first, n_rt, n_chunks, units};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == nullptr) {
    fill_kernel<false><<<n_chunks, TILE, 0, s>>>(st, ch, scan, masks, nnz, row_ptr, col,
                                                 weight);
    return static_cast<int>(cudaGetLastError());
  }
  const int smem = n_planes * TILE * static_cast<int>(sizeof(uint4));
  if (smem > 48 * 1024) {
    const cudaError_t set = cudaFuncSetAttribute(
        fill_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (set != cudaSuccess) return static_cast<int>(set);
  }
  fill_kernel<true><<<n_chunks, TILE, smem, s>>>(st, ch, scan, masks, nnz, row_ptr, col,
                                                 weight);
  return static_cast<int>(cudaGetLastError());
}
