// The row-index builder's serial schedule, as it was before the chunked
// redesign of src/repro_torch/kernels/csrc/bitmap_index.cu: one block per
// row tile, each thread walking its tile's slots one load at a time, and the
// fill pass reading every correction slot's planes again for each set bit.
// scripts/index_times.py builds it with nvcc and times it beside the shipped
// builder on one card, in turns; the text below is its original note.
//
// The row index of a packed incidence, built on the card at upload, sm_90a.
//
// Serves: the SpMM kernels that replace src/repro/kernels/bitmap_spmm.py::
// _kernel (K1/K2, bitmap_spmm.cu) and ::_fused_kernel (K3,
// bitmap_spmm_fused.cu).  The TPU kernels read the 128x128 bitmaps on every
// call; on the condensed layers this serves a 2 KiB bitmap holds a few set
// bits (3.3 on the DBLP smoke graph's first layer), so the SpMMs here read a
// destination-row CSR of the set bits instead, built once per uploaded graph
// from the same byte-identical operands:
//
//   row_ptr (n_rows + 1) int32   entries of row r: [row_ptr[r], row_ptr[r+1])
//   col     (nnz) int32          source row of each entry
//   weight  (nnz) int32          fused stream only: 0 marks a main entry (a
//                                bit of the layer's bitmap, over h); a
//                                correction entry (over x) holds its count
//                                sum_k 2^k bit_k, folded from the P planes
//
// n_rows = 128 x the row tiles.  The order is fixed by the layout, with no
// sort: slots are sorted by (row tile, source tile) and the run table
// row_start / row_count names each row tile's slots, so pass 1 counts each
// row's entries across its tile's slots, the wrapper takes an exclusive
// scan, and pass 2 writes each row's entries in slot order, columns
// ascending within a slot.  A fused row thus holds its main entries, then
// its correction entries, as the stream orders its slots.
//
// Schedule: one block of 128 threads per row tile, thread i owning row i,
// so a slot's 2 KiB is read as 128 coalesced 16-byte rows (words must be
// 16-byte aligned).  Bound: device memory, every stored bitmap (and bit-plane)
// read once per pass; the work is upload-time and runs once per graph.

#include <cuda_runtime.h>
#include <stdint.h>

namespace bitmap_index {

constexpr int TILE = 128;

__device__ __forceinline__ int popc4(uint4 w) {
  return __popc(w.x) + __popc(w.y) + __popc(w.z) + __popc(w.w);
}

__device__ __forceinline__ uint4 or4(uint4 a, uint4 b) {
  return make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
}

__device__ __forceinline__ uint32_t word_of(uint4 w, int k) {
  return k == 0 ? w.x : (k == 1 ? w.y : (k == 2 ? w.z : w.w));
}

// Row i of 2 KiB unit u of a word stack.
__device__ __forceinline__ uint4 unit_row(const uint4* __restrict__ units, int64_t u, int i) {
  return __ldg(units + u * TILE + i);
}

// The present cells of correction slot c, row i: the OR of its P planes.
__device__ __forceinline__ uint4 plane_union(const uint4* __restrict__ planes, int c,
                                             int n_planes, int i) {
  uint4 w = make_uint4(0u, 0u, 0u, 0u);
  for (int k = 0; k < n_planes; ++k) {
    w = or4(w, unit_row(planes, static_cast<int64_t>(c) * n_planes + k, i));
  }
  return w;
}

// Appends the set bits of ``w`` (columns of source tile ``src_tile``) at
// col[cursor ..], ascending; weight (if given) gets 0 for a main slot
// (planes null) or, for correction slot c, the count folded from its planes.
__device__ __forceinline__ void emit(uint4 w, int src_tile, int32_t* __restrict__ col,
                                     int32_t* __restrict__ weight, int64_t& cursor,
                                     const uint4* __restrict__ planes, int c, int n_planes,
                                     int i) {
  for (int k = 0; k < 4; ++k) {
    uint32_t bits = word_of(w, k);
    while (bits) {
      const int b = __ffs(bits) - 1;
      bits &= bits - 1;
      col[cursor] = src_tile * TILE + 32 * k + b;
      if (weight != nullptr) {
        int count = 0;
        if (planes != nullptr) {
          for (int p = 0; p < n_planes; ++p) {
            const uint4 pw = unit_row(planes, static_cast<int64_t>(c) * n_planes + p, i);
            count |= static_cast<int>((word_of(pw, k) >> b) & 1u) << p;
          }
        }
        weight[cursor] = count;
      }
      ++cursor;
    }
  }
}

// One layer direction.  pass 0: counts[1 + r] = entries of row r (and
// counts[0] = 0); pass 1: the entries, at row_ptr[r] onward.
__global__ void __launch_bounds__(TILE) index_kernel(
    int pass, const int32_t* __restrict__ slot_src, const int32_t* __restrict__ row_start,
    const int32_t* __restrict__ row_count, const uint4* __restrict__ bitmaps,
    int32_t* __restrict__ counts_or_ptr, int32_t* __restrict__ col) {
  const int tile = blockIdx.x;
  const int i = threadIdx.x;
  const int r = tile * TILE + i;
  const int s0 = __ldg(row_start + tile);
  const int s1 = s0 + __ldg(row_count + tile);
  if (pass == 0) {
    int n = 0;
    for (int s = s0; s < s1; ++s) n += popc4(unit_row(bitmaps, s, i));
    counts_or_ptr[1 + r] = n;
    if (r == 0) counts_or_ptr[0] = 0;
    return;
  }
  int64_t cursor = counts_or_ptr[r];
  for (int s = s0; s < s1; ++s) {
    emit(unit_row(bitmaps, s, i), __ldg(slot_src + s), col, nullptr, cursor, nullptr, 0, 0, i);
  }
}

// The fused stream (main slots, kind 0, then correction slots, kind 1, per
// row tile).  pass 0 counts main bits plus present correction cells; pass 1
// writes col and weight.
__global__ void __launch_bounds__(TILE) index_fused_kernel(
    int pass, const int32_t* __restrict__ kind, const int32_t* __restrict__ main_src,
    const int32_t* __restrict__ corr_src, const int32_t* __restrict__ main_idx,
    const int32_t* __restrict__ corr_idx, const int32_t* __restrict__ row_start,
    const int32_t* __restrict__ row_count, const uint4* __restrict__ bitmaps,
    const uint4* __restrict__ planes, int n_planes, int32_t* __restrict__ counts_or_ptr,
    int32_t* __restrict__ col, int32_t* __restrict__ weight) {
  const int tile = blockIdx.x;
  const int i = threadIdx.x;
  const int r = tile * TILE + i;
  const int s0 = __ldg(row_start + tile);
  const int s1 = s0 + __ldg(row_count + tile);
  int64_t cursor = pass == 0 ? 0 : counts_or_ptr[r];
  for (int s = s0; s < s1; ++s) {
    const bool is_main = __ldg(kind + s) == 0;
    const int c = __ldg(corr_idx + s);
    const uint4 w = is_main ? unit_row(bitmaps, __ldg(main_idx + s), i)
                         : plane_union(planes, c, n_planes, i);
    if (pass == 0) {
      cursor += popc4(w);
    } else if (is_main) {
      emit(w, __ldg(main_src + s), col, weight, cursor, nullptr, 0, 0, i);
    } else {
      emit(w, __ldg(corr_src + s), col, weight, cursor, planes, c, n_planes, i);
    }
  }
  if (pass == 0) {
    counts_or_ptr[1 + r] = static_cast<int32_t>(cursor);
    if (r == 0) counts_or_ptr[0] = 0;
  }
}

}  // namespace bitmap_index

// Launch on ``stream``; return cudaGetLastError() as an int (0 = success).
// ``n_rt`` row tiles; words 16-byte aligned; pass 0 writes n_rt * 128 + 1
// counts, pass 1 reads them as the exclusive row_ptr and writes col (and
// weight).
extern "C" int bitmap_index_launch(int pass, const int32_t* slot_src, const int32_t* row_start,
                                   const int32_t* row_count, const uint32_t* bitmaps, int n_rt,
                                   int32_t* counts_or_ptr, int32_t* col, int device,
                                   void* stream) {
  using namespace bitmap_index;
  if (n_rt <= 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  index_kernel<<<n_rt, TILE, 0, static_cast<cudaStream_t>(stream)>>>(
      pass, slot_src, row_start, row_count, reinterpret_cast<const uint4*>(bitmaps),
      counts_or_ptr, col);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bitmap_index_fused_launch(
    int pass, const int32_t* kind, const int32_t* main_src, const int32_t* corr_src,
    const int32_t* main_idx, const int32_t* corr_idx, const int32_t* row_start,
    const int32_t* row_count, const uint32_t* bitmaps, const uint32_t* planes, int n_planes,
    int n_rt, int32_t* counts_or_ptr, int32_t* col, int32_t* weight, int device,
    void* stream) {
  using namespace bitmap_index;
  if (n_rt <= 0) return 0;
  if (n_planes < 1 || n_planes > 31) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  index_fused_kernel<<<n_rt, TILE, 0, static_cast<cudaStream_t>(stream)>>>(
      pass, kind, main_src, corr_src, main_idx, corr_idx, row_start, row_count,
      reinterpret_cast<const uint4*>(bitmaps), reinterpret_cast<const uint4*>(planes),
      n_planes, counts_or_ptr, col, weight);
  return static_cast<int>(cudaGetLastError());
}
