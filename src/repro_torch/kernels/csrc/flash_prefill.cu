// K4 at prefill: bf16 GQA flash-attention forward on the tensor cores, for
// sm_90a.  The wrapper (repro_torch/kernels/flash_attention.py) sends a
// bfloat16 call with Tq > 1 here; Tq == 1 goes to flash_decode.cu and
// float32 to flash_attention.cu.
//
// Replaces: src/repro/kernels/flash_attention.py::_kernel (the Pallas TPU
// kernel launched by flash_attention_pallas), extended by the q_offset and
// kv_length arguments of the JAX package's serving path
// (src/repro/models/layers.py::_flash_impl): a causal prefill into a KV
// cache that may already hold q_offset positions, over a ragged valid key
// prefix kv_length[b].
//
// Computes, for q (B, Tq, H, D), k and v (B, Tk, KV, D), G = H / KV:
//   s[b, t, h, j] = (q[b, t, h] . k[b, j, h / G]) * scale            (fp32)
//   masked where j >= kv_length[b], or (causal) j > q_offset + t
//   out[b, t, h]  = sum_j softmax(s)[j] * v[b, j, h / G]
// with the reference's rounding: scores and sums in fp32, p rounded to
// bf16 before the P.V product, l summed from the fp32 p, the output
// acc / max(l, 1e-20) cast once to bf16.  A row whose every key is masked
// gives 0.  Keys at or past kv_length never reach a result: the
// mma.sync kernel never reads them; the sm90 kernel's TMA boxes read whole key
// tiles, so it masks their scores with a select (a NaN there becomes
// -inf) and zeroes their V rows in shared memory before P.V (0 x NaN is
// NaN in the tensor cores too).
//
// Training (the JAX package's _flash_train forward) also asks for the
// row's log-sum-exp: lse[b, t, h] = m + ln(l) in natural log, fp32, and
// +inf for a row whose every key is masked (layers.py's convention, so
// that the backward's recomputed p is 0 there).  The kernel keeps m in
// the base-2 domain (m2 = max_j s * scale * log2 e), so it writes
// m2 * ln 2 + ln(l).  A null lse writes nothing.
//
// What bounds it on the H100: at glm4-9b's 4096-token prefill the causal
// half is ~137 GFLOP per layer against ~6 MB of q/k/v/out, so operations
// bound it (0.139 ms at 989 TFLOP/s bf16); at SASRec's (65,536 sequences
// of 50 positions, one head, D = 50) bytes do (1.3 GB, 0.395 ms).
//
// Two kernels, by the launcher's choice (mirrored by the wrapper's
// prefill_route):
//   sm90   flash_prefill_sm90_kernel: head dim 64 or 128, q, k, v 16-byte
//          aligned, one sequence a block: every LM prefill and training
//          forward (glm4-9b, granite, moonshot, llama3-405b, yi-9b);
//   mma    the mma.sync kernel, flash_prefill_kernel<DP, false>: other head dims that are
//          a multiple of 8 (8 .. 120: the kernel sweep's 8, 16, 32), aligned,
//          one sequence a block;
//   relay  the mma.sync kernel re-laid, flash_prefill_kernel<DP, true>: a head dim that is not a
//          multiple of 8, unaligned operands, or short sequences packed
//          (SASRec's D = 50, two sequences a block).
//
// The sm90 kernel (FlashAttention-3's structure, on hopper.cuh):
//  * a block is one producer warpgroup and two (D = 128) or three (D =
//    64) consumer warpgroups of 64 query rows; the rows are the G heads of
//    one kv head at 128 / G (or 192 / G) positions, so each K / V tile is
//    read once per group (glm4-9b: 16 heads x 8 positions; granite: 3 x
//    64; moonshot: 1 x 128);
//  * the producer's one thread loads by TMA, from 4-D tensor maps over
//    (D, heads, T, B) in 128-byte-swizzled tiles of 64 columns: an item's
//    Q once, and K / V tiles of 128 (D = 128) or 96 (D = 64) keys into a
//    ring of 3 stages with full / empty mbarriers; TMA fills keys past Tk
//    and rows past Tq with zeros (rows past Tq are never written);
//  * S = Q.K^T is one wgmma m64nBKVk16 per 16 columns of D, Q and K read
//    from shared memory through matrix descriptors; O += P.V is one wgmma
//    m64nDk16 per 16 keys, P from registers (S's accumulator layout is the
//    A fragment's), V from shared memory with the transpose bit;
//  * the softmax runs in the accumulator registers: four partial maxima
//    and sums a row (short dependency chains), one fma and ex2.approx a
//    score, acc rescaled only where a row's max moved, the mask only on
//    tiles that cross kv_length or the diagonal of the item's first row;
//  * within a warpgroup, tile j's S and tile j - 1's P.V go to the tensor
//    cores together and tile j's softmax runs under the P.V (the loop is
//    unrolled by two so that P alternates between two register sets: a
//    copy between them made ptxas serialise the wgmmas);
//  * D = 128: a persistent grid of one block an SM walks the items
//    (query tile x batch row x kv head, longest first, in snake rounds), an
//    item's Q released once its last S retires so that the next item's
//    loads overlap its last P.V and write-out; D = 64: one block an item,
//    the three consumer warpgroups issuing their products in turns
//    (ping-pong), so that two softmaxes run under one warpgroup's products;
//  * registers: the producer warpgroup gives its registers back
//    (setmaxnreg 24), the consumers take 240 (two) or 160 (three).
// Each of these choices was timed against its alternatives on the card
// (scripts/prefill_sm90_variants.py; the numbers are in PERF.md).
//
// The mma.sync kernel (FlashAttention-2's structure), for the other shapes:
//  * the matrix products run on the tensor cores: mma.sync m16n8k16 bf16
//    with fp32 accumulators (flash_mma.cuh), not fp32 FMAs;
//  * a block of 4 warps takes 128 rows = the G query heads of one kv head
//    at 128 / G positions (8 at G = 16), so each K/V tile is read once per
//    group; warp w owns rows 32w .. 32w + 31, two m16 tiles, so that each
//    K and V fragment it reads from shared memory feeds two mma (with one
//    m-tile a warp, shared-memory reads of K and V, not the tensor cores,
//    set the pace); Q is staged once in shared memory, and its A fragments
//    are read again at each k-step (two m-tiles' worth held in registers
//    would not fit beside the 128 accumulator registers);
//  * short sequences are packed: where Tq == Tk, q_offset == 0 and one
//    sequence's Tq G rows fill at most half of the 128, a block takes
//    pack = 128 / (Tq G) whole sequences (the wrapper's prefill_pack: two
//    at SASRec's T = 50, 100 of 128 rows, where one gave 50).  Sequence s
//    brings its keys as keys s S .. s S + Tk - 1 of the block, S the power
//    of two at or above Tk, so that no sequence straddles two key tiles (p
//    is rounded against its row's final max, as unpacked); each row sees
//    the key range [lo, hi] of its own sequence (lo = s S, hi below
//    kv_length[b + s] and, causal, its position): a block-diagonal causal
//    mask, applied as one range test a score;
//  * K/V tiles of 64 keys are double-buffered, tile j + 1 in flight while
//    tile j is multiplied.  Where D % 8 == 0, the operands are 16-byte
//    aligned and sequences are not packed, each row goes straight to its
//    padded shared-memory row in 16-byte cp.async copies.  Otherwise (D =
//    50: a 100-byte row, 4-byte aligned; or packed) a tile is first
//    copied raw in 16-byte cp.async copies, as one slab where its rows
//    are contiguous (KV == 1: a sequence's (T, 1, D) block is; two packed
//    sequences are too) or row by row, each row's 16-byte-aligned cover,
//    and then re-laid warp by warp into the padded rows (4-byte words
//    where the row's raw offset allows, else 2-byte ones, in shared
//    memory), zeros past D and in the rows of invalid keys: no global
//    load is narrower than 16 bytes or waited for outside the pipeline;
//  * two blocks share an SM (104 KB of shared memory each at D = 128, 54
//    KB at D <= 64); three with the re-laid staging at D <= 64 (72 KB with
//    its raw buffer, 168 registers);
//  * a warp skips the key tiles that no row of it can see (past its last
//    position under causal, or outside its sequences' ranges), and only
//    the tiles that reach past some row's range apply a mask;
//  * blocks are launched longest first (the last query tiles of a causal
//    prefill have the most keys), so the tail of the grid is short work.
// CUDA caps grid.y at 65,535: the launcher walks the batch in chunks of
// that many blocks' worth of rows (SASRec's bulk scoring runs 262,144).
// Not yet in the sm90 kernel: softmax overlapped across warpgroups by
// clusters, TMA stores of the output, fp8.

#include "flash_mma.cuh"
#include "hopper.cuh"

#include <algorithm>
#include <atomic>
#include <climits>
#include <type_traits>

namespace flash_prefill {

using namespace flash_mma;

constexpr int WARPS = 4;
constexpr int MT = 2;                 // m-tiles of 16 rows per warp
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS = 16 * MT * WARPS; // query rows (sequence x position x head of the group) per block
constexpr int MAX_GRID_Y = 65535;     // blocks along the batch per launch
constexpr float LN2 = 0.6931471805599453f;

// how the re-laid instantiation stages Q, K and V (the launcher's choice)
constexpr int STAGE_SLAB = 0;   // KV == 1: a tile's rows are one slab, copied raw, re-laid
constexpr int STAGE_ROWS = 1;   // otherwise: each row's 16-byte cover copied raw, re-laid

template <int DP>
constexpr size_t smem_bytes(bool relay) {
  // Q, then K and V x 2 stages, then (re-laid staging) a raw buffer of
  // ROWS rows of 2 * DS bytes: K's 64 and V's 64 raw rows of one tile
  return size_t(2) * (ROWS + 4 * BKV + (relay ? ROWS : 0)) * Tile<DP>::DS;
}

// Row by row: row r's cover (D elements from row_src(r), nothing where
// that is null) at buf + r * RS.
template <int DP, typename RowSrc>
__device__ __forceinline__ void copy_row_covers(unsigned char* buf, int rows, RowSrc row_src,
                                                int D, int tid) {
  constexpr int RS = 2 * Tile<DP>::DS;  // bytes a raw row: any D <= DP with its offset
  constexpr int CPR = RS / 16;
  for (int e = tid; e < rows * CPR; e += THREADS) {
    const int r = e / CPR, c = e % CPR;
    const __nv_bfloat16* src = row_src(r);
    if (src == nullptr) continue;
    const uintptr_t s = reinterpret_cast<uintptr_t>(src);
    const uintptr_t p = (s & ~uintptr_t(15)) + 16 * uintptr_t(c), end = s + 2 * uintptr_t(D);
    if (p < end)
      cp_async16(buf + r * RS + 16 * c, reinterpret_cast<const void*>(p),
                 static_cast<int>(end - p < 16 ? end - p : 16));
  }
}

// If masked, set s to -inf where key < lo[mt][i] or key > hi[mt][i] (the
// row's visible key range); mx[mt][i] is the row's max over the NK keys,
// scaled into the log2 domain (times scale_log2 > 0).  key0: the key of
// n-tile 0, column 0.  Element (j, e): row g + 8 (e / 2), key
// key0 + 8j + 2 (lane % 4) + e % 2.
template <int NK>
__device__ __forceinline__ void mask_range_max(float (&s)[MT][NK / 8][4], float (&mx)[MT][2],
                                               int lane, float scale_log2, bool masked,
                                               int key0, const int (&lo)[MT][2],
                                               const int (&hi)[MT][2]) {
  const int kcol = key0 + 2 * (lane & 3);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float x_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < NK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = s[mt][j][2 * i + e];
          if (masked) {
            const int key = kcol + 8 * j + e;
            if (key < lo[mt][i] || key > hi[mt][i]) x = -INFINITY;
          }
          s[mt][j][2 * i + e] = x;
          x_max = fmaxf(x_max, x);
        }
      x_max = fmaxf(x_max, __shfl_xor_sync(FULL_MASK, x_max, 1));
      mx[mt][i] = fmaxf(x_max, __shfl_xor_sync(FULL_MASK, x_max, 2)) * scale_log2;
    }
}

__device__ __forceinline__ int warp_min(int x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = min(x, __shfl_xor_sync(FULL_MASK, x, off));
  return x;
}

__device__ __forceinline__ int warp_max(int x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = max(x, __shfl_xor_sync(FULL_MASK, x, off));
  return x;
}

// The mma.sync kernel's two instantiations a head dim (the launcher's choice):
//   RELAY false  a query tile of one sequence, 16-byte staging straight
//                into the rows (route 'mma': D % 8 == 0 other than 64 and
//                128, aligned, not packed; before the sm90 kernel it also served
//                glm4-9b's, granite's and moonshot's prefills);
//   RELAY true   re-laid staging (STAGE_SLAB or STAGE_ROWS), packed or not
//                (route 'relay': SASRec's; every packed call, whatever D).
// Only the second carries the row tables, the per-warp tile skip and the
// range mask: at D = 128 the skip's branch around a tile's products alone
// cost the straight route 13% (NVIDIA H100 80GB HBM3, scripts/k4_times.py).

// nb: batch rows of this launch; pack: sequences a block (1: a block is a
// query tile of one sequence, bq = ROWS / G positions; > 1: whole
// sequences, bq = Tq == Tk, n_qtiles == 1, q_offset == 0).  The re-laid
// instantiation at D <= 64 (SASRec's) is held to 168 registers, three
// blocks an SM: latency, not the tensor cores, bounds its short blocks.
// ptxas then spills 64 bytes (88 bytes of loads); uncapped it takes 237
// registers without spills, two blocks an SM, and SASRec's training
// prefill took 2.09 ms against 1.69 (NVIDIA H100 80GB HBM3,
// scripts/k4_times.py).
template <int DP, bool RELAY>
__global__ void __launch_bounds__(THREADS, RELAY && DP == 64 ? 3 : 2)
    flash_prefill_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, const int32_t* __restrict__ kv_length, int nb, int Tq, int Tk,
    int H, int KV, int D, int G, int bq, int n_qtiles, int pack, int q_offset, int causal,
    int staging, float scale_log2) {
  using T = Tile<DP>;
  constexpr int RS = 2 * T::DS;       // bytes a raw row
  constexpr int TABLE = RELAY ? ROWS : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int seq_len[TABLE];      // valid keys of each sequence of the block
  // row r of the block: its global row of q / o / lse (-1: past the
  // block's rows) and the keys [row_lo, row_hi] of the block it sees
  __shared__ int64_t row_at[TABLE];
  __shared__ int row_lo[TABLE], row_hi[TABLE];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);  // ROWS x DS
  __nv_bfloat16* KVs = Qs + ROWS * T::DS;                      // [stage][K, V] BKV x DS
  // re-laid staging: K's then V's raw rows of one tile; Q's raw rows go
  // to stage 1 (2 BKV x DS elements = ROWS x RS bytes), free until tile 1
  unsigned char* raw = reinterpret_cast<unsigned char*>(KVs + 4 * BKV * T::DS);
  unsigned char* raw_q = reinterpret_cast<unsigned char*>(KVs + 2 * BKV * T::DS);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // longest first: block 0 takes the last query tile of kv head 0
  const int qtile = n_qtiles - 1 - static_cast<int>(blockIdx.x) / KV;
  const int kvh = static_cast<int>(blockIdx.x) % KV;
  const int64_t b = int64_t(blockIdx.y) * pack;   // the block's first batch row
  const int n_seq = static_cast<int>(nb - b < pack ? nb - b : pack);
  const int t0 = qtile * bq;
  const int seq_rows = bq * G;        // rows of one sequence (packed: s holds rows s * seq_rows ..)
  const int row0 = 16 * MT * warp;    // this warp's first row
  const int g = lane >> 2;

  auto valid_keys = [&](int s) {
    const int len = kv_length != nullptr ? kv_length[b + s] : Tk;
    return max(0, min(len, Tk));
  };
  // Packed, sequence s's key j is key s * S + j of the block, S = 2^kshift
  // the power of two at or above Tk (<= 64): a sequence never straddles
  // two 64-key tiles, so each row's keys lie in one tile and p is rounded
  // against its row's final max, as unpacked.
  const int kshift = pack > 1 ? 32 - __clz(Tk - 1) : 0;
  int len0, n_keys;
  if constexpr (RELAY) {
    if (tid < n_seq) seq_len[tid] = valid_keys(tid);
    {  // thread tid fills row tid (THREADS == ROWS)
      int s = 0, rr = tid;
      if (pack > 1) {
        s = tid / seq_rows;
        rr = tid - s * seq_rows;
      }
      const int t = t0 + rr / G;
      const bool ok = s < n_seq && rr < seq_rows && t < Tq;
      row_at[tid] = ok ? ((b + s) * Tq + t) * H + kvh * G + rr % G : -1;
      int last = ok ? valid_keys(s) - 1 : -1;  // a row past the block's sees no key
      if (ok && causal) last = min(last, q_offset + t);
      row_lo[tid] = s << kshift;
      row_hi[tid] = (s << kshift) + last;
    }
    __syncthreads();
    len0 = seq_len[0];
    n_keys = pack > 1 ? ((n_seq - 1) << kshift) + seq_len[n_seq - 1] : len0;
  } else {
    len0 = n_keys = valid_keys(0);
  }
  if (pack == 1 && causal) n_keys = max(0, min(n_keys, q_offset + min(t0 + bq, Tq)));
  const int n_tiles = (n_keys + BKV - 1) / BKV;

  // row r of the block: the global row of q / o / lse, or -1 past the block's rows
  auto q_row = [&](int r) -> int64_t {
    if constexpr (RELAY) {
      return row_at[r];
    } else {
      const int t = t0 + r / G;
      return r < seq_rows && t < Tq ? (b * Tq + t) * H + kvh * G + r % G : -1;
    }
  };
  auto q_src = [&](int r) -> const __nv_bfloat16* {
    const int64_t row = q_row(r);
    return row >= 0 ? q + row * D : nullptr;
  };
  // key kc of the block (key kc % S of sequence kc / S when packed): its
  // memory row from the block's first key row, or -1 past its sequence's
  // kv_length
  const int64_t key_base = (b * Tk * KV + kvh) * D;  // key 0 of the block's first sequence
  const int64_t key_stride = int64_t(KV) * D;
  auto key_row = [&](int kc) -> int {
    if (RELAY && pack > 1) {
      const int s = kc >> kshift, j = kc & ((1 << kshift) - 1);
      return s < n_seq && j < seq_len[s] ? s * Tk + j : -1;
    }
    return kc < len0 ? kc : -1;
  };
  const __nv_bfloat16* kh = k + key_base;
  const __nv_bfloat16* vh = v + key_base;
  auto key_src = [&](const __nv_bfloat16* head, int kc) -> const __nv_bfloat16* {
    const int m = key_row(kc);
    return m >= 0 ? head + m * key_stride : nullptr;
  };
  // the rows of k / v a tile reads lie in one slab of memory rows from the
  // block's first key row: [r0, r0 + n) (whole sequences when packed)
  auto tile_rows = [&](int k0, int& r0) -> int {
    if (pack > 1) {
      const int s0 = k0 >> kshift, s1 = min(n_seq, ((k0 + BKV - 1) >> kshift) + 1);
      r0 = s0 * Tk;
      return (s1 - s0) * Tk;
    }
    r0 = k0;
    return min(BKV, Tk - k0);
  };

  // re-laid staging: a row's byte offset in its raw buffer (-1: zeros).
  // A slab's memory rows m lie at head + m * 2D from its cover's start
  // (head: the slab's offset from its 16-byte boundary); row by row, row r
  // lies at r * RS + its source's offset from its 16-byte boundary.
  auto head_of = [](const void* p) { return static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15); };
  // Q's slab (KV == 1): memory rows [0, q_mem) from q_first, the global
  // row first_row; block row r holds memory row row_at[r] - first_row
  const int64_t first_row = (b * Tq + t0) * H + kvh * G;
  const __nv_bfloat16* q_first = q + first_row * D;
  const int q_mem = pack > 1 ? n_seq * seq_rows : min(bq, Tq - t0) * G;
  auto copy_q_raw = [&]() {
    if (staging == STAGE_SLAB) cover_copy(raw_q, q_first, 2 * q_mem * D, tid, THREADS);
    else copy_row_covers<DP>(raw_q, ROWS, q_src, D, tid);
  };
  auto relay_q = [&]() {
    const int head = head_of(q_first);
    relay_rows<DP>(Qs, raw_q, ROWS, [&](int r) {
      if (staging == STAGE_SLAB)
        return row_at[r] >= 0 ? head + 2 * static_cast<int>(row_at[r] - first_row) * D : -1;
      const __nv_bfloat16* src = q_src(r);
      return src != nullptr ? r * RS + head_of(src) : -1;
    }, D, tid, THREADS);
  };
  auto copy_kv_raw = [&](int tile) {
    const int k0 = tile * BKV;
    for (int h = 0; h < 2; ++h) {
      const __nv_bfloat16* head = h == 0 ? kh : vh;
      unsigned char* buf = raw + h * BKV * RS;
      if (staging == STAGE_SLAB) {
        int r0;
        const int n = tile_rows(k0, r0);
        cover_copy(buf, head + r0 * key_stride, 2 * n * D, tid, THREADS);
      } else {
        copy_row_covers<DP>(buf, BKV, [&](int j) { return key_src(head, k0 + j); }, D, tid);
      }
    }
  };
  auto kv_tile = [&](int tile) { return KVs + (tile & 1) * 2 * BKV * T::DS; };
  auto relay_kv = [&](int tile) {
    const int k0 = tile * BKV;
    int r0;
    tile_rows(k0, r0);
    for (int h = 0; h < 2; ++h) {
      const __nv_bfloat16* head = h == 0 ? kh : vh;
      const int slab_head = head_of(head + r0 * key_stride);
      relay_rows<DP>(kv_tile(tile) + h * BKV * T::DS, raw + h * BKV * RS, BKV, [&](int j) {
        const int m = key_row(k0 + j);
        if (m < 0) return -1;
        if (staging == STAGE_ROWS) return j * RS + head_of(head + m * key_stride);
        return slab_head + 2 * (m - r0) * D;
      }, D, tid, THREADS);
    }
  };
  // straight staging: 16-byte cp.async into the padded rows
  auto stage_vec = [&](int tile) {
    const int k0 = tile * BKV;
    __nv_bfloat16* Ks = kv_tile(tile);
    auto src = [&](const __nv_bfloat16* head) {
      return [=](int j) { return key_src(head, k0 + j); };
    };
    stage_rows<DP>(Ks, BKV, src(kh), kh, D, true, tid, THREADS);
    stage_rows<DP>(Ks + BKV * T::DS, BKV, src(vh), vh, D, true, tid, THREADS);
  };

  if (n_tiles > 0) {
    if constexpr (!RELAY) {
      // Q: one copy group with K/V tile 0
      stage_rows<DP>(Qs, ROWS, q_src, q, D, true, tid, THREADS);
      if (D < DP) {
        zero_pad_columns<DP>(Qs, ROWS, D, tid, THREADS);
        zero_pad_columns<DP>(KVs, 4 * BKV, D, tid, THREADS);
      }
      stage_vec(0);
      cp_async_commit();
    } else {
      copy_q_raw();
      copy_kv_raw(0);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      relay_q();
      relay_kv(0);
      __syncthreads();
    }
  }

  // The mask of this thread's rows (g and g + 8 of each m-tile).  Straight:
  // key >= kv_length or (causal) past the row's position qpos.  Otherwise
  // the row's key range [lo, hi] of the block; over the warp's 32 rows, the
  // keys any of them sees (w_lo .. w_hi: tiles outside are skipped), and a
  // tile [k0, k0 + BKV) needs no mask where m_lo <= k0 and
  // k0 + BKV - 1 <= m_hi.
  int qpos[MT][2], lo[MT][2], hi[MT][2];
  int w_lo = INT_MAX, w_hi = INT_MIN, m_lo = INT_MIN, m_hi = INT_MAX;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row0 + 16 * mt + g + 8 * i;
      if constexpr (RELAY) {
        lo[mt][i] = row_lo[r];
        hi[mt][i] = row_hi[r];
      } else {
        qpos[mt][i] = q_offset + t0 + r / G;
      }
    }
  if constexpr (RELAY) {
    if (row_at[row0 + lane] >= 0) {   // rows past the block's are never written
      w_lo = m_lo = row_lo[row0 + lane];
      w_hi = m_hi = row_hi[row0 + lane];
    }
    w_lo = warp_min(w_lo);
    w_hi = warp_max(w_hi);
    m_lo = warp_max(m_lo);
    m_hi = warp_min(m_hi);
  }
  const int first_q = q_offset + t0;

  WarpState<DP, MT> st;
  st.init();
  auto multiply = [&](int tile, bool masked) {
    const int k0 = tile * BKV;
    const __nv_bfloat16* Ks = kv_tile(tile);
    float s[MT][BKV / 8][4], mx[MT][2];
    uint32_t pa[MT][BKV / 8][2];
    score_tile<DP, MT, BKV>(s, Qs, row0, Ks, lane);
    if constexpr (RELAY) {
      mask_range_max<BKV>(s, mx, lane, scale_log2, masked, k0, lo, hi);
    } else {
      mask_max<MT, BKV>(s, mx, lane, scale_log2, masked, k0, len0, causal != 0, qpos);
    }
    softmax_update<DP, MT, BKV>(st, s, mx, scale_log2, pa);
    pv_tile<DP, MT, BKV>(st, pa, Ks + BKV * T::DS, lane);
  };
  for (int tile = 0; tile < n_tiles; ++tile) {
    const bool next = tile + 1 < n_tiles;
    if constexpr (!RELAY) {
      if (next) {
        stage_vec(tile + 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // tile `tile` (and Q) landed for every thread's copies
    } else if (next) {
      copy_kv_raw(tile + 1);  // in flight while tile `tile` is multiplied
      cp_async_commit();
    }
    const int k0 = tile * BKV;
    if constexpr (RELAY) {
      if (k0 <= w_hi && k0 + BKV - 1 >= w_lo)  // some row of this warp sees a key of the tile
        multiply(tile, k0 < m_lo || k0 + BKV - 1 > m_hi);
    } else {
      multiply(tile, k0 + BKV > len0 || (causal && k0 + BKV - 1 > first_q));
    }
    if constexpr (!RELAY) {
      __syncthreads();  // every warp is done with this stage before it is refilled
    } else if (next) {
      cp_async_wait<0>();
      __syncthreads();  // tile + 1's raw rows landed; every warp is done with tile
      relay_kv(tile + 1);
      __syncthreads();
    }
  }

  // out = acc / max(l, 1e-20), rows g and g + 8 of each of this warp's m-tiles
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float l = st.row_sum(mt, i);
      const float den = fmaxf(l, 1e-20f);
      const int64_t row = q_row(row0 + 16 * mt + g + 8 * i);
      if (row < 0) continue;
      if (lse != nullptr && (lane & 3) == 0)
        lse[row] = l > 0.f ? st.m[mt][i] * LN2 + logf(l) : INFINITY;
      __nv_bfloat16* out = o + row * D;
#pragma unroll
      for (int n = 0; n < T::ONT; ++n) {
        const int d = 8 * n + 2 * (lane & 3);
        const float x0 = st.o[mt][n][2 * i] / den, x1 = st.o[mt][n][2 * i + 1] / den;
        if (d >= D) continue;
        if (D % 2 == 0) {
          *reinterpret_cast<__nv_bfloat162*>(out + d) = __floats2bfloat162_rn(x0, x1);
        } else {
          out[d] = __float2bfloat16(x0);
          if (d + 1 < D) out[d + 1] = __float2bfloat16(x1);
        }
      }
    }
}

template <int DP, bool RELAY>
int launch(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
           __nv_bfloat16* o, float* lse, const int32_t* kv_length, int B, int Tq, int Tk, int H,
           int KV, int D, int q_offset, int causal, int pack, int staging, float scale_log2,
           int device, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<DP>(RELAY);
  // The shared-memory limit is a per-device attribute of the kernel: set
  // it at the first launch on each device, not at every launch.
  static std::atomic<uint64_t> attr_set{0};
  const uint64_t bit = device < 64 ? uint64_t{1} << device : 0;
  if (!(attr_set.load() & bit)) {
    const cudaError_t attr =
        cudaFuncSetAttribute(flash_prefill_kernel<DP, RELAY>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (attr != cudaSuccess) return static_cast<int>(attr);
    attr_set.fetch_or(bit);
  }
  const int G = H / KV;
  const int bq = pack > 1 ? Tq : ROWS / G;
  const int n_qtiles = (Tq + bq - 1) / bq;
  const int64_t per_launch = int64_t(MAX_GRID_Y) * pack;  // batch rows a launch
  for (int64_t b0 = 0; b0 < B; b0 += per_launch) {
    const int64_t nb = std::min<int64_t>(per_launch, B - b0);
    const dim3 grid(n_qtiles * KV, static_cast<unsigned>((nb + pack - 1) / pack));
    flash_prefill_kernel<DP, RELAY><<<grid, THREADS, smem, st>>>(
        q + b0 * Tq * H * D, k + b0 * Tk * KV * D, v + b0 * Tk * KV * D, o + b0 * Tq * H * D,
        lse != nullptr ? lse + b0 * Tq * H : nullptr,
        kv_length != nullptr ? kv_length + b0 : nullptr, static_cast<int>(nb), Tq, Tk, H, KV,
        D, G, bq, n_qtiles, pack, q_offset, causal, staging, scale_log2);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace flash_prefill

// ---------------------------------------------------------------------------
// The sm90 route: TMA-fed, warp-specialised wgmma (hopper.cuh)
// ---------------------------------------------------------------------------

// Whether head dims 64 and 128 of the straight route go to
// flash_prefill_sm90_kernel (a build flag, so that a measurement can build
// the mma.sync kernel alone from the same source: -DFLASH_PREFILL_SM90=0).
#ifndef FLASH_PREFILL_SM90
#define FLASH_PREFILL_SM90 1
#endif
// The kernel's shape, by head dim (scripts/prefill_sm90_variants.py times
// builds with other values): ping-pong between the consumer warpgroups (1) or not (0),
// and a persistent grid of one block an SM (1) or one block an item (0)
#ifndef FLASH_SM90_PINGPONG_64
#define FLASH_SM90_PINGPONG_64 1
#endif
#ifndef FLASH_SM90_PINGPONG_128
#define FLASH_SM90_PINGPONG_128 0
#endif
#ifndef FLASH_SM90_PERSISTENT_64
#define FLASH_SM90_PERSISTENT_64 0
#endif
#ifndef FLASH_SM90_PERSISTENT_128
#define FLASH_SM90_PERSISTENT_128 1
#endif
// keys a K / V tile, and stages of the ring
#ifndef FLASH_SM90_BKV_64
#define FLASH_SM90_BKV_64 96
#endif
#ifndef FLASH_SM90_BKV_128
#define FLASH_SM90_BKV_128 128
#endif
#ifndef FLASH_SM90_STAGES_64
#define FLASH_SM90_STAGES_64 3
#endif
#ifndef FLASH_SM90_STAGES_128
#define FLASH_SM90_STAGES_128 3
#endif
// consumer warpgroups of 64 query rows a block, by head dim
#ifndef FLASH_SM90_CONSUMERS_64
#define FLASH_SM90_CONSUMERS_64 3
#endif
#ifndef FLASH_SM90_CONSUMERS_128
#define FLASH_SM90_CONSUMERS_128 2
#endif

// Internal linkage: a process that loads two builds of this library (a
// measurement of variants) keeps one set of statics each.
namespace {
namespace flash_prefill_sm90 {

using namespace hopper;
using flash_mma::ex2;
using flash_mma::pack_bf16;

constexpr int ROW_BYTES = 128;         // a swizzled tile row: 64 bf16 columns
constexpr int PRODUCER_REGS = 24;
constexpr float LN2 = 0.6931471805599453f;

template <int DP>
struct Config {
  static constexpr int BKV = DP == 64 ? FLASH_SM90_BKV_64 : FLASH_SM90_BKV_128;
  static constexpr int STAGES = DP == 64 ? FLASH_SM90_STAGES_64 : FLASH_SM90_STAGES_128;
  // warpgroups of 64 rows; a block's rows are the G heads of a kv head at
  // ROWS / G positions
  static constexpr int CONSUMERS = DP == 64 ? FLASH_SM90_CONSUMERS_64 : FLASH_SM90_CONSUMERS_128;
  static constexpr int ROWS = 64 * CONSUMERS;
  static constexpr int THREADS = 128 * (1 + CONSUMERS);
  // the register file's 64K split between the producer and the consumers
  static constexpr int CONSUMER_REGS = CONSUMERS == 2 ? 240 : 160;
  static constexpr bool PINGPONG = DP == 64 ? FLASH_SM90_PINGPONG_64 : FLASH_SM90_PINGPONG_128;
  static constexpr bool PERSISTENT =
      DP == 64 ? FLASH_SM90_PERSISTENT_64 : FLASH_SM90_PERSISTENT_128;
  static_assert(CONSUMERS == 2 || CONSUMERS == 3, "two or three consumer warpgroups");
  static constexpr int HALVES = DP / 64;                        // 64-column tiles a row
  static constexpr int Q_BYTES = HALVES * ROWS * ROW_BYTES;
  static constexpr int TILE_BYTES = HALVES * BKV * ROW_BYTES;   // K (or V) of one stage
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES;
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * STAGE_BYTES;  // + 1024-byte alignment
  static_assert(BKV % 16 == 0 && BKV <= 256, "a tile's keys: one wgmma N, one TMA box");
};

// A persistent grid: one block an SM walks the work items, each 128
// (or 192) query rows (row r: position t0 + r / G, head kvh G + r % G of
// batch row b) against the keys of kv head kvh.  Warpgroup 0 is the
// producer: its thread 0 loads each item's Q and K / V tiles by TMA, the
// tiles into a ring of STAGES stages that runs on across items.
// Warpgroups 1 .. CONSUMERS each own 64 rows: per tile, S = Q.K^T and O +=
// P.V on wgmma, the softmax in the accumulator registers between them.
// An item's Q is released (q_empty) once its last S retires, so that the
// next item's Q and first tiles load during its last P.V and write-out.
template <int DP>
__global__ void __launch_bounds__(Config<DP>::THREADS, 1) flash_prefill_sm90_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, const int32_t* __restrict__ kv_length, int B, int Tq, int Tk,
    int H, int KV, int G, int bq, int n_qtiles, int q_offset, int causal, float scale_log2) {
  using C = Config<DP>;
  constexpr int BKV = C::BKV, ROWS = C::ROWS, CONSUMERS = C::CONSUMERS, STAGES = C::STAGES;
  constexpr int NS = BKV / 8;          // 8-key column groups of S
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t q_full, q_empty, kv_full[STAGES], kv_empty[STAGES];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Qs = smem;            // [half][row][128 bytes]
  auto k_tile = [&](int s) { return smem + C::Q_BYTES + s * C::STAGE_BYTES; };  // [half][key][128 bytes]
  auto v_tile = [&](int s) { return k_tile(s) + C::TILE_BYTES; };

  const int tid = threadIdx.x;
  // This block's k-th item: the items in order of length (longest query
  // tile first, then batch row, then kv head) in rounds of gridDim.x, the
  // block taking the bid-th of an even round and the bid-th from the end
  // of an odd one, so that each block's long and short items pair up.
  const int n_items = n_qtiles * B * KV;
  // items a block: a bound the compiler sees where the grid is one block
  // an item (without it, head dim 64's blocks took 0.149 ms at granite's
  // prefill against 0.140 with it, NVIDIA H100 80GB HBM3,
  // scripts/prefill_sm90_variants.py)
  constexpr int MAX_ITEMS = C::PERSISTENT ? INT_MAX : 1;
  struct Item {
    int t0, kvh, b, len0, n_tiles;
  };
  auto item = [&](int k, Item& it) {
    const int grid = static_cast<int>(gridDim.x), bid = static_cast<int>(blockIdx.x);
    const int w = k * grid + ((k & 1) ? grid - 1 - bid : bid);
    if (w >= n_items) return false;
    const int rank = w / (B * KV), rest = w - rank * (B * KV);
    it.b = rest / KV;
    it.kvh = rest - it.b * KV;
    it.t0 = (n_qtiles - 1 - rank) * bq;
    it.len0 = kv_length != nullptr ? max(0, min(kv_length[it.b], Tk)) : Tk;
    int n_keys = it.len0;
    if (causal) n_keys = max(0, min(n_keys, q_offset + min(it.t0 + bq, Tq)));
    it.n_tiles = (n_keys + BKV - 1) / BKV;
    return true;
  };

  if (tid == 0) {
    mbar_init(&q_full, 1);
    mbar_init(&q_empty, CONSUMERS);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&kv_full[s], 1);
      mbar_init(&kv_empty[s], CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid < 128) {
    // ---- the producer warpgroup ------------------------------------------
    reg_dealloc<PRODUCER_REGS>();
    if (tid == 0) {
      tma_prefetch_map(&tm_q);
      tma_prefetch_map(&tm_k);
      tma_prefetch_map(&tm_v);
      int q_round = 0, g = 0;          // items with keys so far, tiles so far
      Item it;
      for (int k = 0; k < MAX_ITEMS && item(k, it); ++k) {
        for (int tile = 0; tile < it.n_tiles; ++tile, ++g) {
          const int s = g % STAGES;
          if (g >= STAGES) mbar_wait(&kv_empty[s], (g / STAGES - 1) & 1);
          mbar_arrive_expect_tx(&kv_full[s], C::STAGE_BYTES);
#pragma unroll
          for (int h = 0; h < C::HALVES; ++h) {
            tma_load_4d(k_tile(s) + h * BKV * ROW_BYTES, &tm_k, &kv_full[s], 64 * h, it.kvh,
                        tile * BKV, it.b);
            tma_load_4d(v_tile(s) + h * BKV * ROW_BYTES, &tm_v, &kv_full[s], 64 * h, it.kvh,
                        tile * BKV, it.b);
          }
          if (tile == 0) {
            // Q once the last item's last S retired (its first tile already
            // in flight); the box's bytes, rows past Tq (zeros) included
            if (q_round > 0) mbar_wait(&q_empty, (q_round - 1) & 1);
            mbar_arrive_expect_tx(&q_full, C::HALVES * G * bq * ROW_BYTES);
#pragma unroll
            for (int h = 0; h < C::HALVES; ++h)
              tma_load_4d(Qs + h * ROWS * ROW_BYTES, &tm_q, &q_full, 64 * h, it.kvh * G, it.t0,
                          it.b);
            ++q_round;
          }
        }
      }
    }
  } else {
    // ---- the consumer warpgroups -------------------------------------------
    reg_alloc<C::CONSUMER_REGS>();
    const int c = tid / 128 - 1;                  // rows 64c .. 64c + 63
    const int t = tid % 128, warp = t / 32, lane = t % 32;
    const int rows_used = G * bq;                 // ROWS - ROWS % G
    // this thread's rows: l / 4 and l / 4 + 8 of its warp's 16
    auto row_of = [&](int i) { return 64 * c + 16 * warp + lane / 4 + 8 * i; };
    // Rows rows_used .. ROWS - 1 lie outside Q's box (past ROWS - G >=
    // ROWS - 64, so in the last warpgroup's rows): zero them once, so that
    // their scores are finite.  They are never written out.
    if (c == CONSUMERS - 1 && rows_used < ROWS) {
      const int per_half = (ROWS - rows_used) * (ROW_BYTES / 16);
      for (int e = t; e < C::HALVES * per_half; e += 128) {
        const int h = e / per_half;
        reinterpret_cast<uint4*>(Qs + h * ROWS * ROW_BYTES + rows_used * ROW_BYTES)
            [e - h * per_half] = make_uint4(0u, 0u, 0u, 0u);
      }
      fence_proxy_async();
      named_barrier(1, 128);
    }
    // shared addresses of this warpgroup's Q rows and of stage 0's K tile
    const uint32_t q_addr = smem_u32(Qs) + c * 64 * ROW_BYTES;
    const uint32_t k_addr = smem_u32(k_tile(0));
    int q_round = 0, g = 0;            // as the producer counts them
    // Ping-pong between the warpgroups (FlashAttention-3's), in turn: each
    // issues its products (a "point": an item's first S, then each of its
    // tiles' S with the last tile's P.V, then its last P.V) only in its
    // turn, so that one warpgroup's softmax runs while another's products
    // do.  Warpgroup c waits at named barrier 3 + c for the previous one's
    // arrival.  The turns run on across items: warpgroup 0 takes the
    // kernel's first point without waiting and, after its last, waits once
    // more for the last warpgroup's last arrival, so that each barrier sees
    // one arrival for each wait and never two arrivals from one warpgroup.
    int point = 0;
    auto my_turn = [&]() {
      if (C::PINGPONG && (c > 0 || point > 0)) named_barrier(3 + c, 256);
    };
    auto your_turn = [&]() {
      if (C::PINGPONG)
        asm volatile("bar.arrive %0, %1;\n" ::"r"(3 + (c + 1) % CONSUMERS), "r"(256) : "memory");
      ++point;
    };
    Item it;
    for (int k = 0; k < MAX_ITEMS && item(k, it); ++k) {
      const int t0 = it.t0, len0 = it.len0, n_tiles = it.n_tiles;
      // the last key each of this thread's rows may see: one comparison a
      // score on a masked tile
      int lim[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int pos = q_offset + t0 + row_of(i) / G;
        lim[i] = causal ? min(len0 - 1, pos) : len0 - 1;
      }
      float acc[DP / 2];               // O: element 4n + e is row i = e / 2, dim 8n + 2 (l % 4) + e % 2
#pragma unroll
      for (int e = 0; e < DP / 2; ++e) acc[e] = 0.f;
      float m[2] = {-INFINITY, -INFINITY};   // running max, log2 domain
      float l[2] = {0.f, 0.f};               // this lane's partial of the running sum
      float alpha[2] = {0.f, 0.f};           // the last update's rescale of acc
      bool moved = false;                    // some alpha of this warp is not 1
      const int first_q = q_offset + t0;

      // wait for tile `tile`'s stage; where the tile reaches past kv_length,
      // V's rows there hold whatever the cache holds (NaN included), and 0 x
      // NaN is NaN in the tensor cores too, so zero them before P.V: the
      // consumer warpgroups share the rows and meet at a named barrier.  (K's rows
      // there only give scores that the mask's select turns to -inf.)
      auto stage_in = [&](int tile) {
        const int s = (g + tile) % STAGES;
        mbar_wait(&kv_full[s], ((g + tile) / STAGES) & 1);
        const int k0 = tile * BKV;
        if (k0 + BKV > len0) {
          const int z0 = max(0, len0 - k0);
          const int per_half = (BKV - z0) * (ROW_BYTES / 16);
          unsigned char* Vs = v_tile(s) + z0 * ROW_BYTES;
          for (int e = tid - 128; e < C::HALVES * per_half; e += 128 * CONSUMERS) {
            const int h = e / per_half;
            reinterpret_cast<uint4*>(Vs + h * BKV * ROW_BYTES)[e - h * per_half] =
                make_uint4(0u, 0u, 0u, 0u);
          }
          fence_proxy_async();
          named_barrier(2, 128 * CONSUMERS);
        }
        return s;
      };
      // S = Q.K^T for stage s: DP / 16 k-steps, 32 bytes along a row each
      auto issue_scores = [&](float (&sc)[BKV / 2], int s) {
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          const int h = kk / 4, off = (kk % 4) * 32;
          wgmma_ss<BKV>(sc, desc_k_major(q_addr + h * ROWS * ROW_BYTES + off),
                        desc_k_major(k_addr + s * C::STAGE_BYTES + h * BKV * ROW_BYTES + off),
                        kk > 0);
        }
        wgmma_commit();
      };
      // O += P.V for stage s: BKV / 16 k-steps of 16 keys, V MN-major
      auto issue_pv = [&](const uint32_t (&pa)[BKV / 4], int s) {
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk) {
          const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3]};
          wgmma_rs<DP>(acc, a,
                       desc_mn_major(k_addr + s * C::STAGE_BYTES + C::TILE_BYTES +
                                         kk * 16 * ROW_BYTES,
                                     BKV * ROW_BYTES),
                       1);
        }
        wgmma_commit();
      };
      // The mask (only where the tile crosses kv_length or the causal
      // diagonal of the block's first row, one comparison a score) and the
      // online update: each row's max in the log2 domain, p = 2^(s scale
      // log2 e - m) in fp32, l summed from it, p rounded to bf16 into P.V's A
      // fragments (S's accumulator layout is that fragment's: pa[2j + i] is
      // row i, keys 8j + 2 (l % 4) + {0, 1}), alpha the rescale of acc.
      auto softmax = [&](float (&sc)[BKV / 2], int tile, uint32_t (&pa)[BKV / 4]) {
        const int k0 = tile * BKV;
        const bool masked = k0 + BKV > len0 || (causal && k0 + BKV - 1 > first_q);
        const int kcol = k0 + 2 * (lane & 3);
        bool any_moved = false;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          // four partial maxima and sums: short dependency chains (the max is
          // exact whatever its order; the sum's order is the kernel's own)
          float part[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
          for (int j = 0; j < NS; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float x = sc[4 * j + 2 * i + e];
              if (masked) x = kcol + 8 * j + e > lim[i] ? -INFINITY : x;  // a select: NaN too
              sc[4 * j + 2 * i + e] = x;
              part[(2 * j + e) % 4] = fmaxf(part[(2 * j + e) % 4], x);
            }
          float x_max = fmaxf(fmaxf(part[0], part[1]), fmaxf(part[2], part[3]));
          x_max = fmaxf(x_max, __shfl_xor_sync(0xffffffffu, x_max, 1));
          x_max = fmaxf(x_max, __shfl_xor_sync(0xffffffffu, x_max, 2)) * scale_log2;
          const float m_new = fmaxf(m[i], x_max);
          const float m_safe = m_new == -INFINITY ? 0.f : m_new;
          alpha[i] = m[i] == -INFINITY ? 0.f : ex2(m[i] - m_safe);
          any_moved |= alpha[i] != 1.f;
#pragma unroll
          for (int k = 0; k < 4; ++k) part[k] = 0.f;
#pragma unroll
          for (int j = 0; j < NS; ++j) {
            const float p0 = ex2(fmaf(sc[4 * j + 2 * i], scale_log2, -m_safe));
            const float p1 = ex2(fmaf(sc[4 * j + 2 * i + 1], scale_log2, -m_safe));
            part[j % 4] += p0 + p1;
            pa[2 * j + i] = pack_bf16(p0, p1);
          }
          l[i] = l[i] * alpha[i] + ((part[0] + part[1]) + (part[2] + part[3]));
          m[i] = m_new;
        }
        moved = __any_sync(0xffffffffu, any_moved);
      };
      // acc to the running max of the last update (a no-op where no max moved)
      auto rescale = [&]() {
        if (moved) {
#pragma unroll
          for (int n = 0; n < DP / 8; ++n) {
            acc[4 * n] *= alpha[0];
            acc[4 * n + 1] *= alpha[0];
            acc[4 * n + 2] *= alpha[1];
            acc[4 * n + 3] *= alpha[1];
          }
        }
      };

      // FlashAttention-3's overlap within a warpgroup: tile j's S = Q.K^T and
      // tile j - 1's O += P.V go to the tensor cores together, and tile j's
      // softmax runs while the P.V product does.  A stage is released once
      // its P.V has retired.  The loop is unrolled by two so that P
      // alternates between two register sets, never copied between them.
      int s_prev = 0;
      auto step = [&](int tile, uint32_t (&p_in)[BKV / 4], uint32_t (&p_out)[BKV / 4]) {
        const int s = stage_in(tile);
        float sc[BKV / 2];
        my_turn();
        wgmma_fence();
        issue_scores(sc, s);
        rescale();                       // while S runs
        fence_regs(acc);                 // acc and P defined before the next fence
        fence_regs(p_in);
        wgmma_fence();
        issue_pv(p_in, s_prev);
        your_turn();
        wgmma_wait<1>();                 // S retired; P.V may still run
        fence_regs(sc);
        if (t == 0 && tile == n_tiles - 1) mbar_arrive(&q_empty);  // Q's last reader retired
        softmax(sc, tile, p_out);
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(p_in);
        if (t == 0) mbar_arrive(&kv_empty[s_prev]);
        s_prev = s;
      };
      auto last_pv = [&](uint32_t (&p_in)[BKV / 4]) {
        my_turn();
        rescale();
        fence_regs(acc);
        fence_regs(p_in);
        wgmma_fence();
        issue_pv(p_in, s_prev);
        your_turn();
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(p_in);
        if (t == 0) mbar_arrive(&kv_empty[s_prev]);
      };
      if (n_tiles > 0) {
        mbar_wait(&q_full, q_round & 1);
        uint32_t pa[BKV / 4], pb[BKV / 4];
        s_prev = stage_in(0);
        {
          float sc[BKV / 2];
          my_turn();
          wgmma_fence();
          issue_scores(sc, s_prev);
          your_turn();
          wgmma_wait<0>();
          fence_regs(sc);
          if (t == 0 && n_tiles == 1) mbar_arrive(&q_empty);
          softmax(sc, 0, pa);
        }
        int tile = 1;
        for (; tile + 1 < n_tiles; tile += 2) {
          step(tile, pa, pb);
          step(tile + 1, pb, pa);
        }
        if (tile < n_tiles) {
          step(tile, pa, pb);
          last_pv(pb);
        } else {
          last_pv(pa);
        }
      }

      if (n_tiles > 0) {
        g += n_tiles;
        ++q_round;
      }

      // out = acc / max(l, 1e-20); rows past Tq and past rows_used are not written
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float lr = l[i];
        lr += __shfl_xor_sync(0xffffffffu, lr, 1);
        lr += __shfl_xor_sync(0xffffffffu, lr, 2);
        const int r = row_of(i), tq = t0 + r / G;
        if (r >= rows_used || tq >= Tq) continue;
        const int64_t grow = (int64_t(it.b) * Tq + tq) * H + it.kvh * G + r % G;
        if (lse != nullptr && (lane & 3) == 0)
          lse[grow] = lr > 0.f ? m[i] * LN2 + logf(lr) : INFINITY;
        const float den = fmaxf(lr, 1e-20f);
        __nv_bfloat16* out = o + grow * DP + 2 * (lane & 3);
#pragma unroll
        for (int n = 0; n < DP / 8; ++n)
          *reinterpret_cast<__nv_bfloat162*>(out + 8 * n) =
              __floats2bfloat162_rn(acc[4 * n + 2 * i] / den, acc[4 * n + 2 * i + 1] / den);
      }
    }
    if (C::PINGPONG && c == 0 && point > 0) named_barrier(3, 256);
  }
}

template <int DP>
int launch(const void* q, const void* k, const void* v, __nv_bfloat16* o, float* lse,
           const int32_t* kv_length, int B, int Tq, int Tk, int H, int KV, int q_offset,
           int causal, float scale_log2, int device, cudaStream_t st) {
  using C = Config<DP>;
  constexpr int ROWS = C::ROWS;
  static std::atomic<uint64_t> attr_set{0};
  const uint64_t bit = device < 64 ? uint64_t{1} << device : 0;
  if (!(attr_set.load() & bit)) {
    const cudaError_t attr = cudaFuncSetAttribute(
        flash_prefill_sm90_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    attr_set.fetch_or(bit);
  }
  const int G = H / KV;
  const int bq = ROWS / G;
  const int n_qtiles = (Tq + bq - 1) / bq;
  const int64_t n_items = int64_t(n_qtiles) * B * KV;
  if (n_items > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  // persistent: one block an SM (the SM count read once a device); else
  // one block an item
  int64_t grid = n_items;
  if (C::PERSISTENT) {
    static std::atomic<int> sms[64];
    int n_sm = device < 64 ? sms[device].load() : 0;
    if (n_sm == 0) {
      const cudaError_t e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
      if (e != cudaSuccess) return static_cast<int>(e);
      if (device < 64) sms[device].store(n_sm);
    }
    grid = std::min<int64_t>(n_items, n_sm);
  }
  // maps over (D, heads, T, B): Q's box G heads x bq positions, K's and
  // V's one kv head x BKV keys
  CUtensorMap tq, tk, tv;
  int err = tensor_map_bf16_4d(&tq, q, DP, H, Tq, B, G, bq);
  if (err == 0) err = tensor_map_bf16_4d(&tk, k, DP, KV, Tk, B, 1, C::BKV);
  if (err == 0) err = tensor_map_bf16_4d(&tv, v, DP, KV, Tk, B, 1, C::BKV);
  if (err != 0) return err;
  if (grid == 0) return 0;
  flash_prefill_sm90_kernel<DP><<<static_cast<unsigned>(grid), C::THREADS, C::SMEM, st>>>(
      tq, tk, tv, o, lse, kv_length, B, Tq, Tk, H, KV, G, bq, n_qtiles, q_offset, causal,
      scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace flash_prefill_sm90
}  // namespace

// Launch on ``stream``; returns cudaGetLastError() as an int (0 = success).
// q and o are contiguous bf16 (B, Tq, H, D), k and v contiguous bf16
// (B, Tk, KV, D); lse is a device array of B * Tq * H fp32, or null (not
// written); kv_length is a device array of B int32 or null (every key
// valid).  pack: whole sequences a block (1, or > 1 where Tq == Tk,
// q_offset == 0 and pack * Tq * H / KV <= 128).  Needs H % KV == 0,
// H / KV <= 128 and 0 < D <= 128.  scale_log2 is the softmax scale times
// log2(e).
extern "C" int flash_prefill_launch(const void* q, const void* k, const void* v, void* o,
                                    void* lse, const int32_t* kv_length, int B, int Tq, int Tk,
                                    int H, int KV, int D, int q_offset, int causal, int pack,
                                    float scale_log2, int device, void* stream) {
  using namespace flash_prefill;
  if (KV <= 0 || H % KV != 0 || H / KV > ROWS || D <= 0 || D > 128 || pack < 1 ||
      (pack > 1 && (Tq != Tk || q_offset != 0 || int64_t(pack) * Tq * (H / KV) > ROWS)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || Tq <= 0) return 0;
  int current = -1;
  if (cudaGetDevice(&current) != cudaSuccess || current != device) {
    const cudaError_t set = cudaSetDevice(device);
    if (set != cudaSuccess) return static_cast<int>(set);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool aligned = (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  const bool relay = D % 8 != 0 || !aligned || pack > 1;
  const int staging = KV == 1 ? STAGE_SLAB : STAGE_ROWS;  // read only where re-laid
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  auto* ob = static_cast<__nv_bfloat16*>(o);
  auto* lf = static_cast<float*>(lse);
  if (FLASH_PREFILL_SM90 && !relay && (D == 64 || D == 128)) {
    return D == 64 ? flash_prefill_sm90::launch<64>(q, k, v, static_cast<__nv_bfloat16*>(o),
                                                    static_cast<float*>(lse), kv_length, B, Tq,
                                                    Tk, H, KV, q_offset, causal, scale_log2,
                                                    device, st)
                   : flash_prefill_sm90::launch<128>(q, k, v, static_cast<__nv_bfloat16*>(o),
                                                     static_cast<float*>(lse), kv_length, B, Tq,
                                                     Tk, H, KV, q_offset, causal, scale_log2,
                                                     device, st);
  }
  auto run = [&](auto mode) {
    constexpr bool M = decltype(mode)::value;
    return D <= 64 ? launch<64, M>(qb, kb, vb, ob, lf, kv_length, B, Tq, Tk, H, KV, D,
                                   q_offset, causal, pack, staging, scale_log2, device, st)
                   : launch<128, M>(qb, kb, vb, ob, lf, kv_length, B, Tq, Tk, H, KV, D,
                                    q_offset, causal, pack, staging, scale_log2, device, st);
  };
  return relay ? run(std::true_type{}) : run(std::false_type{});
}
