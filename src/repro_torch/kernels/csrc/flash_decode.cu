// K4 at decode: bf16 split-KV GQA attention for one query position, and
// the combine pass over its partials, for sm_90a.  The wrapper
// (repro_torch/kernels/flash_attention.py) sends a bfloat16 call with
// Tq == 1 here; Tq > 1 goes to flash_prefill.cu and float32 to
// flash_attention.cu.
//
// Replaces: src/repro/kernels/flash_attention.py::_kernel (the Pallas TPU
// kernel launched by flash_attention_pallas) as the JAX package's serving
// path calls it at decode (src/repro/models/layers.py::_flash_impl with
// Tq = 1, q_offset = cache length, kv_length = cache length + 1, not
// causal): one query per head over a ragged cache tail.
//
// Computes, for q (B, 1, H, D), k and v (B, Tk, KV, D), G = H / KV, the
// same function as the prefill kernel at Tq = 1 (see flash_prefill.cu for
// the formula and the rounding), split over key ranges:
//   flash_decode_kernel   for each (b, kv head, split s) and each of the
//                         group's query heads, over keys
//                         [s * split_keys, (s + 1) * split_keys) below
//                         kv_length[b]: the unnormalised partial
//                         (acc_s fp32, m_s, l_s) of the online softmax;
//   flash_combine_kernel  M = max_s m_s and
//                         out = sum_s e^(m_s - M) acc_s
//                               / max(sum_s e^(m_s - M) l_s, 1e-20),
//                         cast once to bf16; a row with no valid key is 0.
// p is rounded to bf16 against the split's running max (tiles of 64 keys
// inside a split), not against a max over all keys before it: the order
// of float sums and the point where p is rounded differ from the
// reference's 1024-key blocks, and nothing else.
//
// What bounds it on the H100: one query row per head reads every valid
// key and value once per kv head (33.6 MB for 8 slots over ~4100 keys at
// glm4-9b's shape), so bytes bound it (~0.010 ms at 3.35 TB/s).  What the
// design does about it:
//  * split-KV: the grid is (n_split, KV x ceil(G / 16), B), n_split
//    chosen by the wrapper from the cache's static length Tk (never from
//    kv_length, which would need a device sync) so that the grid holds at
//    least two blocks per SM at the main path's shape (352 blocks for 8
//    slots x 2 kv heads over a 4128-key cache), where one block per
//    (batch row, kv head) gave 16 blocks for 132 SMs;
//  * a block's 16 rows are 16 query heads of one group (all of glm4-9b's
//    G = 16; fewer heads are zero rows), so no thread computes a padded
//    position, and its 4 warps share each K/V tile: warp w scores and
//    multiplies keys 16w .. 16w + 15 of the tile for all 16 rows; the
//    tile's row max is merged over the warps in shared memory, so every
//    warp rounds p against the same running max, and at the end the warps'
//    partial acc and l are summed in shared memory into one partial;
//  * K/V tiles of 64 keys are staged as bf16 with 16-byte cp.async
//    copies, double-buffered, and multiplied with mma.sync
//    (flash_mma.cuh); 74 KB of shared memory lets three blocks share an
//    SM, so several tiles are in flight per SM;
//  * a split that starts at or past kv_length[b] writes the empty partial
//    (m = -inf, l = 0, acc = 0) and reads nothing.
// Partials live in scratch the wrapper allocates; the kernels allocate
// nothing.

#include "flash_mma.cuh"

#include <atomic>

namespace flash_decode {

using namespace flash_mma;

constexpr int ROWS = 16;              // query heads per block: one m-tile
constexpr int WARPS = 4;              // each scores and multiplies 16 keys of a tile
constexpr int THREADS = 32 * WARPS;
constexpr int NK = BKV / WARPS;
constexpr int COMBINE_THREADS = 128;  // one per output dim (D <= 128)

template <int DP>
constexpr size_t smem_bytes() {
  // Q, K and V x 2 stages, then the warps' row maxima and the rows' max
  return size_t(2) * (ROWS + 4 * BKV) * Tile<DP>::DS + sizeof(float) * (WARPS + 1) * ROWS;
}

template <int DP>
__global__ void __launch_bounds__(THREADS) flash_decode_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int32_t* __restrict__ kv_length,
    float* __restrict__ part_o, float* __restrict__ part_m, float* __restrict__ part_l,
    int Tk, int H, int KV, int D, int G, int n_chunks, int split_keys, int n_split,
    int q_offset, int causal, int vec, float scale_log2) {
  using T = Tile<DP>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);  // ROWS x DS
  __nv_bfloat16* KVs = Qs + ROWS * T::DS;                      // [stage][K, V] BKV x DS
  float* maxes = reinterpret_cast<float*>(KVs + 4 * BKV * T::DS);  // [warp][row]
  float* row_m = maxes + WARPS * ROWS;                              // [row]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x;
  const int kvh = static_cast<int>(blockIdx.y) / n_chunks;
  const int h0 = kvh * G + (static_cast<int>(blockIdx.y) % n_chunks) * ROWS;
  const int rows = min(ROWS, kvh * G + G - h0);
  const int64_t b = blockIdx.z;

  int n_keys = kv_length != nullptr ? kv_length[b] : Tk;
  n_keys = max(0, min(n_keys, Tk));
  if (causal) n_keys = min(n_keys, q_offset + 1);  // the one query sits at q_offset
  const int start = split * split_keys;
  const int end = min(start + split_keys, n_keys);
  const int n_tiles = start < end ? (end - start + BKV - 1) / BKV : 0;
  // partial (b, h, split) for h = h0 + r
  const int64_t part0 = (b * H + h0) * n_split + split;

  if (n_tiles == 0) {  // the empty partial: no key of this range is valid
    for (int e = tid; e < rows * D; e += THREADS)
      part_o[(part0 + int64_t(e / D) * n_split) * D + e % D] = 0.f;
    if (tid < rows) {
      part_m[part0 + int64_t(tid) * n_split] = -INFINITY;
      part_l[part0 + int64_t(tid) * n_split] = 0.f;
    }
    return;
  }

  const int64_t row_stride = int64_t(KV) * D;
  const __nv_bfloat16* kh = k + (b * Tk * KV + kvh) * D;
  const __nv_bfloat16* vh = v + (b * Tk * KV + kvh) * D;
  auto stage = [&](int tile) {
    __nv_bfloat16* Ks = KVs + (tile & 1) * 2 * BKV * T::DS;
    const int k0 = start + tile * BKV;
    auto key_src = [&](const __nv_bfloat16* head) {
      return [=](int j) { return k0 + j < end ? head + (k0 + j) * row_stride : nullptr; };
    };
    stage_rows<DP>(Ks, BKV, key_src(kh), kh, D, vec, tid, THREADS);
    stage_rows<DP>(Ks + BKV * T::DS, BKV, key_src(vh), vh, D, vec, tid, THREADS);
  };
  stage_rows<DP>(Qs, ROWS, [&](int r) -> const __nv_bfloat16* {
    return r < rows ? q + (b * H + h0 + r) * D : nullptr;
  }, q, D, vec, tid, THREADS);
  if (vec && D < DP) {
    zero_pad_columns<DP>(Qs, ROWS, D, tid, THREADS);
    zero_pad_columns<DP>(KVs, 4 * BKV, D, tid, THREADS);
  }
  stage(0);
  cp_async_commit();

  const int g = lane >> 2;
  const int no_causal[1][2] = {{0, 0}};  // unused: `end` already holds the causal bound
  WarpState<DP, 1> st;
  st.init();
  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + 1 < n_tiles) {
      stage(tile + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile `tile` (and Q) landed for every thread's copies
    const int k0 = start + tile * BKV;
    const __nv_bfloat16* Ks = KVs + (tile & 1) * 2 * BKV * T::DS + NK * warp * T::DS;
    float s[1][NK / 8][4], mx[1][2];
    uint32_t pa[1][NK / 8][2];
    score_tile<DP, 1, NK>(s, Qs, 0, Ks, lane);
    mask_max<1, NK>(s, mx, lane, scale_log2, k0 + BKV > end, k0 + NK * warp, end, false,
                    no_causal);
    // the tile's row max over all four warps' keys, so every warp rounds p
    // against the same running max
    if ((lane & 3) == 0) {
      maxes[warp * ROWS + g] = mx[0][0];
      maxes[warp * ROWS + g + 8] = mx[0][1];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int w = 0; w < WARPS; ++w) mx[0][i] = fmaxf(mx[0][i], maxes[w * ROWS + g + 8 * i]);
    softmax_update<DP, 1, NK>(st, s, mx, scale_log2, pa);
    pv_tile<DP, 1, NK>(st, pa, Ks + BKV * T::DS, lane);
    __syncthreads();  // every warp is done with this stage and the maxima
  }

  // Sum the warps' partial acc and l (all scaled to the same running max)
  // through shared memory, over the stage buffers: [warp][row][dim] fp32.
  float* acc = reinterpret_cast<float*>(KVs);
  float* lsum = maxes;  // [warp][row]
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = g + 8 * i;
    const float l = st.row_sum(0, i);
    if ((lane & 3) == 0) {
      lsum[warp * ROWS + r] = l;
      if (warp == 0) row_m[r] = st.m[0][i];  // the same in every warp
    }
#pragma unroll
    for (int n = 0; n < T::ONT; ++n) {
      const int d = 8 * n + 2 * (lane & 3);
      *reinterpret_cast<float2*>(acc + (warp * ROWS + r) * DP + d) =
          make_float2(st.o[0][n][2 * i], st.o[0][n][2 * i + 1]);
    }
  }
  __syncthreads();
  for (int e = tid; e < rows * D; e += THREADS) {
    const int r = e / D, d = e % D;
    float x = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) x += acc[(w * ROWS + r) * DP + d];
    part_o[(part0 + int64_t(r) * n_split) * D + d] = x;
  }
  if (tid < rows) {
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) l += lsum[w * ROWS + tid];
    part_m[part0 + int64_t(tid) * n_split] = row_m[tid];
    part_l[part0 + int64_t(tid) * n_split] = l;
  }
}

__device__ __forceinline__ float block_reduce(float x, float* red, bool is_max) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float y = __shfl_xor_sync(FULL_MASK, x, off);
    x = is_max ? fmaxf(x, y) : x + y;
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  x = red[0];
#pragma unroll
  for (int w = 1; w < COMBINE_THREADS / 32; ++w) x = is_max ? fmaxf(x, red[w]) : x + red[w];
  __syncthreads();  // red is free again
  return x;
}

// One block per (b, h) row of the output.  The threads first read the
// row's n_split (m, l) pairs together and reduce M and the denominator;
// then thread d sums its dim over the splits with the weights from shared
// memory, its loads independent of each other.
__global__ void __launch_bounds__(COMBINE_THREADS) flash_combine_kernel(
    const float* __restrict__ part_o, const float* __restrict__ part_m,
    const float* __restrict__ part_l, __nv_bfloat16* __restrict__ o, int D, int n_split) {
  extern __shared__ float weight[];  // n_split weights, then 4 floats of reduction
  float* red = weight + n_split;
  const int64_t row = blockIdx.x;
  const int tid = threadIdx.x;
  const float* pm = part_m + row * n_split;
  const float* pl = part_l + row * n_split;
  float M = -INFINITY;
  for (int s = tid; s < n_split; s += COMBINE_THREADS) {
    weight[s] = pm[s];
    M = fmaxf(M, weight[s]);
  }
  M = block_reduce(M, red, true);
  const float m_safe = M == -INFINITY ? 0.f : M;
  float den = 0.f;
  for (int s = tid; s < n_split; s += COMBINE_THREADS) {
    const float m = weight[s];
    const float w = m == -INFINITY ? 0.f : exp2f(m - m_safe);
    weight[s] = w;
    den += w * pl[s];
  }
  den = block_reduce(den, red, false);  // its barrier also publishes the weights
  if (tid >= D) return;
  const float* po = part_o + row * n_split * D + tid;
  float acc = 0.f;
#pragma unroll 8
  for (int s = 0; s < n_split; ++s) acc += weight[s] * po[int64_t(s) * D];
  o[row * D + tid] = __float2bfloat16(acc / fmaxf(den, 1e-20f));
}

template <int DP>
int launch(const void* q, const void* k, const void* v, const int32_t* kv_length,
           float* part_o, float* part_m, float* part_l, int B, int Tk, int H, int KV, int D,
           int split_keys, int n_split, int q_offset, int causal, bool vec, float scale_log2,
           int device, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<DP>();
  static std::atomic<uint64_t> attr_set{0};  // per device, as in flash_prefill.cu
  const uint64_t bit = device < 64 ? uint64_t{1} << device : 0;
  if (!(attr_set.load() & bit)) {
    const cudaError_t attr =
        cudaFuncSetAttribute(flash_decode_kernel<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (attr != cudaSuccess) return static_cast<int>(attr);
    attr_set.fetch_or(bit);
  }
  const int G = H / KV;
  const int n_chunks = (G + ROWS - 1) / ROWS;
  const dim3 grid(n_split, KV * n_chunks, B);
  flash_decode_kernel<DP><<<grid, THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), kv_length, part_o, part_m, part_l, Tk, H, KV, D, G,
      n_chunks, split_keys, n_split, q_offset, causal, vec ? 1 : 0, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace flash_decode

// Launch the split-KV kernel on ``stream``; returns cudaGetLastError() as
// an int (0 = success).  q is contiguous bf16 (B, 1, H, D), k and v
// contiguous bf16 (B, Tk, KV, D); kv_length is a device array of B int32 or
// null (every key valid).  part_o is fp32 (B, H, n_split, D), part_m and
// part_l fp32 (B, H, n_split); n_split * split_keys >= Tk and split_keys
// is a positive multiple of 64.  Needs H % KV == 0 and 0 < D <= 128.
// scale_log2 is the softmax scale times log2(e); part_m is in that base.
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v,
                                   const int32_t* kv_length, void* part_o, void* part_m,
                                   void* part_l, int B, int Tk, int H, int KV, int D,
                                   int split_keys, int n_split, int q_offset, int causal,
                                   float scale_log2, int device, void* stream) {
  using namespace flash_decode;
  if (KV <= 0 || H % KV != 0 || D <= 0 || D > 128 || split_keys <= 0 ||
      split_keys % BKV != 0 || int64_t(n_split) * split_keys < Tk)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return 0;
  int current = -1;
  if (cudaGetDevice(&current) != cudaSuccess || current != device) {
    const cudaError_t set = cudaSetDevice(device);
    if (set != cudaSuccess) return static_cast<int>(set);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = D % 8 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;
  float* po = static_cast<float*>(part_o);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  return D <= 64 ? launch<64>(q, k, v, kv_length, po, pm, pl, B, Tk, H, KV, D, split_keys,
                              n_split, q_offset, causal, vec, scale_log2, device, st)
                 : launch<128>(q, k, v, kv_length, po, pm, pl, B, Tk, H, KV, D, split_keys,
                               n_split, q_offset, causal, vec, scale_log2, device, st);
}

// Launch the combine on ``stream``: o (rows, D) bf16 from the partials of
// flash_decode_launch, rows = B * H.  Same return convention.
extern "C" int flash_combine_launch(const void* part_o, const void* part_m, const void* part_l,
                                    void* o, int rows, int D, int n_split, int device,
                                    void* stream) {
  using namespace flash_decode;
  if (D <= 0 || D > COMBINE_THREADS || n_split <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows <= 0) return 0;
  int current = -1;
  if (cudaGetDevice(&current) != cudaSuccess || current != device) {
    const cudaError_t set = cudaSetDevice(device);
    if (set != cudaSuccess) return static_cast<int>(set);
  }
  const size_t smem = sizeof(float) * (n_split + COMBINE_THREADS / 32);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  flash_combine_kernel<<<rows, COMBINE_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part_o), static_cast<const float*>(part_m),
      static_cast<const float*>(part_l), static_cast<__nv_bfloat16*>(o), D, n_split);
  return static_cast<int>(cudaGetLastError());
}
