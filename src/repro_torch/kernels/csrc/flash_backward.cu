// K4's training backward: the bf16 GQA flash-attention backward on the
// tensor cores, for sm_90a.  The wrapper (repro_torch/kernels/
// flash_attention.py, FlashAttentionFn.backward) sends a bfloat16 call here
// by two routes (its backward_route): the short route where a sequence is
// one tile (SASRec's), the long route at head_dim 64 or 128 (the LMs');
// float32 runs csrc/flash_backward_f32.cu.
//
// Replaces no Pallas kernel: it computes what the JAX package's custom-VJP
// backward computes (src/repro/models/layers.py::_flash_train_bwd, XLA
// code on the TPU), the last part of K4's training route that was plain
// PyTorch on the card.  Given q (B, Tq, H, D), k and v (B, Tk, KV, D), the
// forward's out (B, Tq, H, D) and its log-sum-exp lse (B, Tq, H) fp32 in
// natural log (+inf on a row whose every key is masked), and do = dL/dout,
// with G = H / KV, q_offset 0 and no kv_length:
//   p[t, h, j]  = exp(s[t, h, j] * scale - lse[t, h]),  s = q . k   (0 where masked:
//                 causal, j > t)
//   delta[t, h] = sum_d do[t, h, d] out[t, h, d]
//   dp[t, h, j] = do[t, h] . v[j, h / G]
//   ds          = p (dp - delta)
//   dq[t, h]    = scale sum_j ds[t, h, j] k[j, h / G]
//   dk[j, kv]   = scale sum_{t, h in kv} ds[t, h, j] q[t, h]
//   dv[j, kv]   =       sum_{t, h in kv} p[t, h, j] do[t, h]
// Sums in fp32; p and ds are rounded to bf16 before their products (as
// the forward rounds p before P.V); dq, dk, dv cast once to bf16.  Every
// product runs on the tensor cores, mma.sync m16n8k16 bf16 with fp32
// accumulators: mma.sync (flash_mma.cuh) on the short route, wgmma
// (hopper.cuh) on the long one.  The query rows of a kv head are the G
// heads of each position in turn (row r: position r / G, head r % G), as
// the prefill kernel lays them.  No float atomics: the gradients repeat
// their bits.
//
// The short route (short_kernel: Tq == Tk = T, KV == 1, T H <= 64, any
// D <= 64; SASRec's q (65,536, 50, 1, 50)).  Bytes bound it: five 327.7 MB
// operands in and three out, 2.63 GB, 0.786 ms at 3.35 TB/s, against 4.2e10
// FLOPs (0.04 ms).  A sequence is one 64-row x 64-key tile, so a block of 8
// warps takes two whole sequences (at KV == 1 two consecutive sequences'
// rows are one contiguous slab of each operand: 10,000 bytes at SASRec's
// shape, 16-byte aligned at an even batch row) and makes their dq, dk and
// dv in one launch, with the five products and no recompute, partials or
// second pass:
//  * q, k, v, out and do come in as raw slabs (cover_copy: 16-byte
//    cp.async only) and are re-laid into padded 64-wide rows (relay_rows);
//    lse2 and delta = rowsum(do o) are made in the block;
//  * warp w takes 16 keys of sequence w / 4: S^T = K Q^T and dP^T = V dO^T
//    (keys as the m dimension), then dV = P^T dO and dK = dS^T Q from
//    registers; it writes its dS^T over its own 16 rows of V, which no other
//    warp reads, and then takes 16 rows: dQ = dS K with dS read through
//    ldmatrix.trans;
//  * dq, dk and dv go back through shared memory in their slabs' layout,
//    then out in 16-byte stores (2-byte ones at a slab's unaligned ends);
//  * the grid is persistent, a block an SM (176 KB of shared memory at
//    SASRec's shape, 203 registers): block x takes pairs x, x + grid, ...,
//    and the raw slabs of its next pair are in flight while this pair is
//    re-laid, multiplied and written back (two raw buffers where they
//    fit beside the padded tiles, else one).
//
// The long route (head_dim 64 or 128, any Tq, Tk, H / KV <= 64; glm4-9b's
// q (1, 4096, 32, 128) over 2 kv heads, granite's (1, 4096, 24, 64) over
// 8).  Operations bound it: five products of 2 FLOPs a multiply-add over
// the causal pairs, 10 B H D pairs FLOPs: 3.44e11 at glm4-9b's training
// shape, 0.348 ms at 989 TFLOP/s (granite's 0.130 ms), against ~143 MB of
// operands (0.043 ms at 3.35 TB/s).  FlashAttention-2's backward in three
// kernels, the two that multiply written as FlashAttention-3 writes them
// for Hopper (TMA-fed, warp-specialised wgmma, hopper.cuh):
//  (a) rowstat_kernel: delta = rowsum(do o) and lse log2 e in row tiles:
//      tile i of a kv head holds the rows of positions i P .. i P + P - 1,
//      P = floor(64 / G) (G P rows: 64 at glm4-9b's G = 16, 63 at
//      granite's 3), in 64 slots, the slots past G P and past Tq +inf / 0
//      so that their p and ds are 0;
//  (b) dkdv_sm90_kernel: a block owns KEYS keys (128 at D = 128: two
//      consumer warpgroups of 64; 64 at D = 64: one, two blocks an SM) of
//      one kv head and one split of the row tiles that see them.  One producer thread loads K and V once by TMA, then
//      streams the row tiles (from the diagonal under causal) into a ring
//      of STAGES stages: Q and dO each one 4-D TMA box of G heads x P
//      positions over (D, heads, T, B), as the prefill lays its Q, with
//      the tile's lse2 / delta by bulk copy, on full / empty mbarriers.
//      Per row tile a consumer warpgroup issues S^T = K Q^T and dP^T =
//      V dO^T (wgmma m64n64k16, both operands K-major from shared memory:
//      keys are the m dimension, so P^T and dS^T come out of the
//      accumulators in the A-fragment layout of the register form), takes
//      p and ds in fp32 (p while dP^T runs), and issues dV += P^T dO and
//      dK += dS^T Q (wgmma m64nDk16, A from registers, dO and Q MN-major
//      B), dK and dV accumulating in registers across the walk;
//  (c) dq_sm90_kernel: a block owns two row tiles (a consumer warpgroup
//      each) of one kv head; the producer loads their Q and dO once and
//      streams K / V tiles of DQ_KEYS keys up to the diagonal; S = Q K^T
//      and dP = dO V^T (wgmma, shared memory), ds in registers, dQ += dS K
//      (wgmma, K MN-major).  It recomputes S and dP: two products more
//      than the five, which keeps every sum in a fixed order without
//      atomics;
//  * register plan (D = 128): dK and dV accumulators 2 x 64 floats a
//    thread, S^T and dP^T 32 each, P^T and dS^T 16 bf16 pairs each; dQ's
//    accumulator 64, S and dP 64 each over 128-key tiles, dS 32 pairs: the
//    producer warpgroup gives its registers back (setmaxnreg 24), the two
//    consumers take 240 (one consumer, two blocks an SM: 232);
//  * masks only on the tiles that cross the diagonal (a comparison of the
//    row's slot with (key - i P) G, no division), and in dq also Tk; key
//    rows past Tk arrive from TMA as zeros, and their dK / dV are not
//    written; the slots past G P are zeroed once in each stage;
//  * load balance under causal: key tile j sees n_rt - j KEYS / P row
//    tiles.  The row tiles of a key tile are cut into `splits` runs (the
//    wrapper's backward_splits: the longest walk over the card's share of
//    all walks), each writing an fp32 partial that reduce_kernel adds in
//    split order; both grids run longest first (key tile 0 first, dq's
//    last row tiles first).
// The plan's constants are Config<DP>'s; the wrapper's sm90_backward_plan
// mirrors them, and scripts/backward_sm90_variants.py builds copies with
// other values to time them in turns.  The mma.sync kernels these
// replaced (16 keys a warp, every warp reading the whole Q and dO tiles
// through ldmatrix, two blocks of 4 warps an SM) and the dQ fold measured
// and set aside before them (scripts/backward_fold_ab.py keeps it) are
// timed against this design in PERF.md.

#include "flash_mma.cuh"
#include "hopper.cuh"

#include <algorithm>
#include <atomic>
#include <climits>

namespace flash_backward {

using namespace flash_mma;

constexpr int BQ = 64;               // query rows a tile (the long route: slots of a row tile)
constexpr int MAX_GRID_Y = 65535;    // blocks along the batch per launch
constexpr float LOG2E = 1.4426950408889634f;
constexpr int SHORT_THREADS = 256;   // the short route's blocks: 8 warps
constexpr int SEQS = 2;              // sequences a block of the short route
constexpr int SDP = 64;              // the short route's padded head dim
constexpr int DSS = BQ + 8;          // row stride of a dS^T tile [key][row], bf16

// the short route's: SEQS x [Q, K, V, dO] padded tiles, SEQS x [lse2,
// delta], then n_buf raw buffers, each five slots of `slot` bytes (q, k,
// v, out, do) and a slot for lse (two sequences' rows and a 16-byte
// cover's slack)
constexpr int SHORT_LSE_SLOT = 4 * SEQS * BQ + 32;
inline size_t short_smem(int slot, int n_buf) {
  return size_t(2) * SEQS * 4 * BQ * Tile<SDP>::DS + size_t(4) * SEQS * 2 * BQ +
         size_t(n_buf) * (5 * slot + SHORT_LSE_SLOT);
}

// bytes a raw slot of the short route: two sequences' q rows (T H x D
// bf16) and the 16-byte cover's slack
inline int short_slot(int T, int H, int D) { return ((4 * T * H * D + 15) / 16 + 1) * 16; }

// The short route's products that accumulate (dV += P^T dO, dK += dS^T Q)
// are flash_mma.cuh's pv_tile: A from registers as bf16 pairs in an
// accumulator tile's layout, B a [k][n] tile in shared memory read through
// ldmatrix.trans, the sum in a WarpState's o (its m and l go unused).

// acc[n] += dS[rows r0 .. r0 + 15][NKEYS keys] . K[keys][dims d0 + 8n ..]:
// dS from a dS^T tile [key][row] (stride DSS) through ldmatrix.trans, K
// from a [key][dim] tile through ldmatrix.trans, NT n-tiles of 8 dims.
template <int DP, int NKEYS, int NT>
__device__ __forceinline__ void ds_k_tile(float (&acc)[NT][4], const __nv_bfloat16* dST, int r0,
                                          const __nv_bfloat16* Ks, int d0, int lane) {
  using T = Tile<DP>;
  const __nv_bfloat16* arow =
      dST + ((lane & 7) + ((lane >> 4) << 3)) * DSS + r0 + ((lane >> 3) & 1) * 8;
  const __nv_bfloat16* krow =
      Ks + ((lane & 7) + ((lane >> 3) & 1) * 8) * T::DS + d0 + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < NKEYS / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4_trans(a, arow + kk * 16 * DSS);
#pragma unroll
    for (int nn = 0; nn < NT / 2; ++nn) {
      uint32_t b[4];
      ldsm_x4_trans(b, krow + kk * 16 * T::DS + nn * 16);
      mma_bf16(acc[2 * nn], a, b[0], b[1]);
      mma_bf16(acc[2 * nn + 1], a, b[2], b[3]);
    }
  }
}

// p and ds of one warp's S^T / dP^T tile (16 keys x 64 rows): row col of
// the tile reads lse2 / delta at st[col] / st[BQ + col]; a pair is seen
// where key < Tk and (causal) key <= the row's position.  Both go out as
// bf16 pairs in the accumulator layout (the A fragments of P^T / dS^T).
// key_lo: the thread's first key (the other is key_lo + 8); row0: the
// tile's first row; masked: whether any pair of the tile may be unseen.
__device__ __forceinline__ void probs(const float (&s)[1][BQ / 8][4],
                                      const float (&dp)[1][BQ / 8][4], const float* st,
                                      int lane, int key_lo, int row0, int G, int Tk, bool causal,
                                      bool masked, float scale_log2, uint32_t (&pa)[1][BQ / 8][2],
                                      uint32_t (&dsa)[1][BQ / 8][2]) {
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j) {
    float p4[4], ds4[4];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = 8 * j + 2 * (lane & 3) + c;  // the row of the tile
      const float l2 = st[col], dl = st[BQ + col];
      const int t = masked ? (row0 + col) / G : 0;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int e = 2 * i + c;
        const int key = key_lo + 8 * i;
        float p = ex2(fmaf(s[0][j][e], scale_log2, -l2));
        if (masked && (key >= Tk || (causal && key > t))) p = 0.f;
        p4[e] = p;
        ds4[e] = p * (dp[0][j][e] - dl);
      }
    }
    pa[0][j][0] = pack_bf16(p4[0], p4[1]);
    pa[0][j][1] = pack_bf16(p4[2], p4[3]);
    dsa[0][j][0] = pack_bf16(ds4[0], ds4[1]);
    dsa[0][j][1] = pack_bf16(ds4[2], ds4[3]);
  }
}

// a warp's dS^T (its 16 keys x 64 rows, from dsa) into a [key][row] tile
__device__ __forceinline__ void store_dst(__nv_bfloat16* dST, int key0,
                                          const uint32_t (&dsa)[1][BQ / 8][2], int lane) {
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<uint32_t*>(dST + (key0 + (lane >> 2) + 8 * i) * DSS + 8 * j +
                                   2 * (lane & 3)) = dsa[0][j][i];
}

// (a) Row statistics: slot j of row tile i of kv head kvh of batch row b
// holds the row of position i P + j / G, head kvh G + j % G (j < G P,
// position < Tq) and gets lse2 = lse log2 e and delta = sum_d do o; the
// other slots get +inf and 0, so that their p and ds are 0.  D / 8 lanes
// a slot, 16-byte loads of 8 values each, a fixed butterfly over the
// lanes (the same bits every run): 2 slots a warp at D = 128, 4 at 64.
template <int DP>
__global__ void rowstat_kernel(const __nv_bfloat16* __restrict__ o,
                               const __nv_bfloat16* __restrict__ dO,
                               const float* __restrict__ lse, float* __restrict__ lse2,
                               float* __restrict__ delta, int64_t n_slots, int Tq, int H,
                               int KV, int G, int P, int n_rt) {
  constexpr int LANES = DP / 8;           // lanes a slot
  const int lane = threadIdx.x & 31;
  const int64_t idx = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) / LANES;
  const int part = lane % LANES;
  const bool live = idx < n_slots;
  int64_t row = -1;
  if (live) {
    const int j = static_cast<int>(idx % BQ);
    const int64_t tile = idx / BQ;
    const int i = static_cast<int>(tile % n_rt);
    const int64_t bk = tile / n_rt;       // b KV + kvh
    const int t = i * P + j / G, g = j % G;
    if (j < G * P && t < Tq) row = ((bk / KV) * Tq + t) * H + (bk % KV) * G + g;
  }
  float s = 0.f;
  if (row >= 0) {
    const uint4 a = *reinterpret_cast<const uint4*>(o + row * DP + 8 * part);
    const uint4 c = *reinterpret_cast<const uint4*>(dO + row * DP + 8 * part);
    const uint32_t aw[4] = {a.x, a.y, a.z, a.w}, cw[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&aw[w]));
      const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&cw[w]));
      s = fmaf(x.x, y.x, s);
      s = fmaf(x.y, y.y, s);
    }
  }
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1) s += __shfl_xor_sync(FULL_MASK, s, off);
  if (live && part == 0) {
    lse2[idx] = row >= 0 ? lse[row] * LOG2E : INFINITY;
    delta[idx] = row >= 0 ? s : 0.f;
  }
}

// dk = bf16(scale sum_s part_k[s]), dv = bf16(sum_s part_v[s]), the splits
// added in order; four elements a thread and a step.
__global__ void reduce_kernel(const float* __restrict__ part_k, const float* __restrict__ part_v,
                              __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                              int64_t n, int splits, float scale) {
  const int64_t n4 = n / 4;
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n4;
       i += int64_t(gridDim.x) * blockDim.x) {
    float4 sk = reinterpret_cast<const float4*>(part_k)[i];
    float4 sv = reinterpret_cast<const float4*>(part_v)[i];
    for (int s = 1; s < splits; ++s) {
      const float4 a = reinterpret_cast<const float4*>(part_k + s * n)[i];
      const float4 c = reinterpret_cast<const float4*>(part_v + s * n)[i];
      sk.x += a.x; sk.y += a.y; sk.z += a.z; sk.w += a.w;
      sv.x += c.x; sv.y += c.y; sv.z += c.z; sv.w += c.w;
    }
    __nv_bfloat162* ok = reinterpret_cast<__nv_bfloat162*>(dk + 4 * i);
    __nv_bfloat162* ov = reinterpret_cast<__nv_bfloat162*>(dv + 4 * i);
    ok[0] = __floats2bfloat162_rn(scale * sk.x, scale * sk.y);
    ok[1] = __floats2bfloat162_rn(scale * sk.z, scale * sk.w);
    ov[0] = __floats2bfloat162_rn(sv.x, sv.y);
    ov[1] = __floats2bfloat162_rn(sv.z, sv.w);
  }
}

// x0 (and x1 where two) as bf16 at byte off of a staged slab: one 4-byte
// store where off is 4-byte aligned, else 2-byte ones
__device__ __forceinline__ void put_pair(unsigned char* buf, int off, float x0, float x1,
                                         bool two) {
  if (two && (off & 3) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(buf + off) = __floats2bfloat162_rn(x0, x1);
  } else {
    *reinterpret_cast<__nv_bfloat16*>(buf + off) = __float2bfloat16(x0);
    if (two) *reinterpret_cast<__nv_bfloat16*>(buf + off + 2) = __float2bfloat16(x1);
  }
}

// The n_bytes at dst (2-byte aligned) from a slab staged as cover_copy
// lays it (the bytes at buf + (dst & 15) on): 16-byte stores of the
// chunks of the cover that lie inside, 2-byte stores at the ends.
__device__ __forceinline__ void slab_store(void* dst, const unsigned char* buf, int n_bytes,
                                           int tid) {
  const uintptr_t s = reinterpret_cast<uintptr_t>(dst);
  const uintptr_t a0 = s & ~uintptr_t(15), end = s + uintptr_t(n_bytes);
  const int chunks = static_cast<int>((end - a0 + 15) >> 4);
  for (int c = tid; c < chunks; c += SHORT_THREADS) {
    const uintptr_t p = a0 + 16 * uintptr_t(c);
    if (p >= s && p + 16 <= end) {
      *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(buf + 16 * c);
    } else {
      for (int e = 0; e < 16; e += 2)
        if (p + e >= s && p + e < end)
          *reinterpret_cast<uint16_t*>(p + e) =
              *reinterpret_cast<const uint16_t*>(buf + 16 * c + e);
    }
  }
}

// (d) The short route: pairs of sequences (T positions, H heads over one
// kv head, D <= 64) whole, pair p = 2p, 2p + 1.  A persistent grid: block
// x takes pairs x, x + gridDim.x, ...; with n_buf == 2 the raw slabs of
// its next pair are in flight while this pair is re-laid, multiplied and
// written back (n_buf == 1: fetched after the write-back).
__global__ void __launch_bounds__(SHORT_THREADS, 1) short_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ o,
    const __nv_bfloat16* __restrict__ dO, const float* __restrict__ lse,
    __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int64_t B, int T, int H, int D, int causal, int slot,
    int n_buf, float scale_log2, float scale) {
  constexpr int DS = Tile<SDP>::DS;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(smem);  // [seq][Q, K, V, dO] BQ x DS
  float* stats = reinterpret_cast<float*>(tiles + SEQS * 4 * BQ * DS);  // [seq][lse2, delta] BQ
  // n_buf raw buffers of 5 slots (q, k, v, out, do) and lse's slot
  unsigned char* raw = reinterpret_cast<unsigned char*>(stats + SEQS * 2 * BQ);
  const int buf_bytes = 5 * slot + SHORT_LSE_SLOT;
  auto tile = [&](int s, int x) { return tiles + (s * 4 + x) * BQ * DS; };
  auto head_of = [](const void* p) { return static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15); };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g8 = lane >> 2;
  const int R = T * H;  // query rows of a sequence (one kv head: G = H)
  const int64_t n_pairs = (B + SEQS - 1) / SEQS;
  // a pair's first batch row, its sequences, and its slabs' element offsets
  struct Pair {
    int64_t b0, q0, k0;
    int n_seq;
  };
  auto pair_of = [&](int64_t p) {
    Pair r;
    r.b0 = p * SEQS;
    r.n_seq = static_cast<int>(B - r.b0 < SEQS ? B - r.b0 : SEQS);
    r.q0 = r.b0 * R * D;
    r.k0 = r.b0 * T * D;
    return r;
  };
  // raw slots: q, k, v, out, do (dq, dk, dv are staged in the first three), lse
  auto fetch = [&](int64_t p, unsigned char* buf) {
    const Pair c = pair_of(p);
    const __nv_bfloat16* src[5] = {q + c.q0, k + c.k0, v + c.k0, o + c.q0, dO + c.q0};
#pragma unroll
    for (int x = 0; x < 5; ++x)
      cover_copy(buf + x * slot, src[x], 2 * c.n_seq * (x == 1 || x == 2 ? T : R) * D, tid,
                 SHORT_THREADS);
    cover_copy(buf + 5 * slot, lse + c.b0 * R, 4 * c.n_seq * R, tid, SHORT_THREADS);
  };

  int cur = 0;
  if (blockIdx.x < n_pairs) fetch(blockIdx.x, raw);
  cp_async_commit();
  for (int64_t pair = blockIdx.x; pair < n_pairs; pair += gridDim.x) {
    const int64_t next = pair + gridDim.x;
    unsigned char* buf = raw + cur * buf_bytes;
    const Pair c = pair_of(pair);
    const __nv_bfloat16* src[5] = {q + c.q0, k + c.k0, v + c.k0, o + c.q0, dO + c.q0};
    cp_async_wait<0>();
    __syncthreads();  // this pair's slabs landed; the last pair's write-back is done
    if (n_buf == 2 && next < n_pairs) fetch(next, raw + (cur ^ 1) * buf_bytes);
    cp_async_commit();

    // Q, K, V, dO re-laid into padded rows (zeros past a sequence's rows)
#pragma unroll
    for (int s = 0; s < SEQS; ++s)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int xr = x == 3 ? 4 : x;
        const int n_rows = x == 1 || x == 2 ? T : R;
        const int head = head_of(src[xr]);
        relay_rows<SDP>(tile(s, x), buf + xr * slot, BQ, [&](int r) {
          return s < c.n_seq && r < n_rows ? head + 2 * (s * n_rows + r) * D : -1;
        }, D, tid, SHORT_THREADS);
      }
    // lse2 and delta = rowsum(do o) of row r of sequence s, one thread a
    // row, in order over d; +inf and 0 past the sequence's rows
    if (tid < SEQS * BQ) {
      const int s = tid / BQ, r = tid % BQ;
      float l2 = INFINITY, acc = 0.f;
      if (s < c.n_seq && r < R) {
        l2 = *reinterpret_cast<const float*>(buf + 5 * slot + head_of(lse + c.b0 * R) +
                                             4 * (s * R + r)) * LOG2E;
        const unsigned char* a = buf + 3 * slot + head_of(src[3]) + 2 * (s * R + r) * D;
        const unsigned char* e = buf + 4 * slot + head_of(src[4]) + 2 * (s * R + r) * D;
        for (int d = 0; d < D; ++d)
          acc = fmaf(__bfloat162float(reinterpret_cast<const __nv_bfloat16*>(a)[d]),
                     __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(e)[d]), acc);
      }
      stats[s * 2 * BQ + r] = l2;
      stats[s * 2 * BQ + BQ + r] = acc;
    }
    __syncthreads();

    // warp w: 16 keys (then 16 rows) of sequence w / 4
    const int s = warp >> 2, part = warp & 3;
    const __nv_bfloat16* Qs = tile(s, 0);
    const __nv_bfloat16* Ks = tile(s, 1);
    __nv_bfloat16* Vs = tile(s, 2);
    const __nv_bfloat16* dOs = tile(s, 3);
    float sc[1][BQ / 8][4], dp[1][BQ / 8][4];
    score_tile<SDP, 1, BQ>(sc, Ks, 16 * part, Qs, lane);
    score_tile<SDP, 1, BQ>(dp, Vs, 16 * part, dOs, lane);
    const int key_lo = 16 * part + g8;
    uint32_t pa[1][BQ / 8][2], dsa[1][BQ / 8][2];
    probs(sc, dp, stats + s * 2 * BQ, lane, key_lo, 0, H, T, causal != 0, true, scale_log2, pa,
          dsa);
    WarpState<SDP, 1> dk_acc, dv_acc;
    dk_acc.init();
    dv_acc.init();
    pv_tile<SDP, 1, BQ>(dv_acc, pa, dOs, lane);  // dV = P^T dO
    pv_tile<SDP, 1, BQ>(dk_acc, dsa, Qs, lane);  // dK = dS^T Q
    __syncwarp();  // this warp's reads of its V rows are done
    store_dst(Vs, 16 * part, dsa, lane);  // DS == DSS at SDP
    // dk, dv into the k and v slots, in their slabs' layout
    const bool live = s < c.n_seq;
    const int head_k = head_of(dk + c.k0), head_v = head_of(dv + c.k0);
    const int head_q = head_of(dq + c.q0);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = key_lo + 8 * i;
      if (!live || key >= T) continue;
#pragma unroll
      for (int nt = 0; nt < Tile<SDP>::ONT; ++nt) {
        const int d = 8 * nt + 2 * (lane & 3);
        if (d >= D) continue;
        const int off = 2 * ((s * T + key) * D + d);
        put_pair(buf + slot, head_k + off, scale * dk_acc.o[0][nt][2 * i],
                 scale * dk_acc.o[0][nt][2 * i + 1], d + 1 < D);
        put_pair(buf + 2 * slot, head_v + off, dv_acc.o[0][nt][2 * i],
                 dv_acc.o[0][nt][2 * i + 1], d + 1 < D);
      }
    }
    __syncthreads();  // every warp's dS^T is in its V rows

    // dQ = dS K: rows 16 part .. of sequence s
    float acc[Tile<SDP>::ONT][4];
#pragma unroll
    for (int nt = 0; nt < Tile<SDP>::ONT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
    ds_k_tile<SDP, BQ, Tile<SDP>::ONT>(acc, Vs, 16 * part, Ks, 0, lane);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 16 * part + g8 + 8 * i;
      if (!live || r >= R) continue;
#pragma unroll
      for (int nt = 0; nt < Tile<SDP>::ONT; ++nt) {
        const int d = 8 * nt + 2 * (lane & 3);
        if (d >= D) continue;
        put_pair(buf, head_q + 2 * ((s * R + r) * D + d), scale * acc[nt][2 * i],
                 scale * acc[nt][2 * i + 1], d + 1 < D);
      }
    }
    __syncthreads();
    const int bytes_q = 2 * c.n_seq * R * D, bytes_k = 2 * c.n_seq * T * D;
    slab_store(dq + c.q0, buf, bytes_q, tid);
    slab_store(dk + c.k0, buf + slot, bytes_k, tid);
    slab_store(dv + c.k0, buf + 2 * slot, bytes_k, tid);
    if (n_buf == 1) {
      __syncthreads();  // the write-back read the buffer
      if (next < n_pairs) fetch(next, raw);
      cp_async_commit();
    } else {
      cur ^= 1;
    }
  }
  cp_async_wait<0>();
}

int set_device(int device) {
  int current = -1;
  if (cudaGetDevice(&current) != cudaSuccess || current != device) {
    const cudaError_t set = cudaSetDevice(device);
    if (set != cudaSuccess) return static_cast<int>(set);
  }
  return 0;
}

// The shared-memory limit is a per-device attribute of a kernel: set it at
// the first launch on each device, not at every launch.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes, int device, std::atomic<uint64_t>& done) {
  const uint64_t bit = device < 64 ? uint64_t{1} << device : 0;
  if (done.load() & bit) return 0;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  done.fetch_or(bit);
  return 0;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// the long route's shapes: head dim 64 or 128, at most 64 query heads a
// kv head (a row tile holds at least one position)
bool shape_ok(int B, int Tq, int Tk, int H, int KV, int D) {
  return B > 0 && Tq > 0 && Tk > 0 && KV > 0 && H % KV == 0 && H / KV <= BQ &&
         (D == 64 || D == 128) && int64_t(Tq) + BQ < (int64_t(1) << 31) &&
         int64_t(Tk) + 256 < (int64_t(1) << 31);
}

// positions a row tile of the long route: P = floor(64 / G)
inline int tile_positions(int H, int KV) { return BQ / (H / KV); }
inline int row_tiles(int Tq, int H, int KV) {
  const int P = tile_positions(H, KV);
  return (Tq + P - 1) / P;
}

}  // namespace flash_backward

// ---------------------------------------------------------------------------
// The long route's products: TMA-fed, warp-specialised wgmma (hopper.cuh)
// ---------------------------------------------------------------------------

// Internal linkage: a process that loads two builds of this library (a
// measurement of variants) keeps one set of statics each.
namespace {
namespace flash_backward_sm90 {

using namespace hopper;
using flash_backward::BQ;
using flash_backward::LOG2E;
using flash_mma::ex2;
using flash_mma::pack_bf16;

constexpr int ROW_BYTES = 128;             // a swizzled tile row: 64 bf16 columns
constexpr int STAT_BYTES = 2 * BQ * 4;     // a row tile's lse2 and delta
constexpr int PRODUCER_REGS = 24;
constexpr int SMEM_OPTIN = 232448;         // an H100 block's shared memory

template <int DP>
struct Config {
  static constexpr int HALVES = DP / 64;                      // 64-column tiles a row
  // The plan (the wrapper's sm90_backward_plan mirrors it;
  // scripts/backward_sm90_variants.py builds copies with other values):
  // dK / dV: KEYS keys a block, a consumer warpgroup each 64; STAGES of
  // the Q / dO ring (and of the dQ kernel's K / V ring, as many as fit)
  static constexpr int KEYS = DP == 64 ? 64 : 128;
  static constexpr int STAGES = 3;
  static constexpr int CONSUMERS = KEYS / 64;
  static constexpr int THREADS = 128 * (1 + CONSUMERS);
  // one consumer: two blocks an SM share its registers
  static constexpr int MIN_BLOCKS = CONSUMERS == 1 ? 2 : 1;
  static constexpr int CONSUMER_REGS = CONSUMERS == 1 ? 232 : 240;
  static constexpr int KV_BYTES = HALVES * KEYS * ROW_BYTES;        // K (or V) of the key tile
  static constexpr int ROW_TILE_BYTES = HALVES * BQ * ROW_BYTES;    // Q (or dO) of a row tile
  static constexpr int STAGE_BYTES = 2 * ROW_TILE_BYTES;            // [Q, dO]; stats apart
  static constexpr int SMEM = 1024 + 2 * KV_BYTES + STAGES * (STAGE_BYTES + STAT_BYTES);
  // dQ: two consumer warpgroups of a row tile each, K / V tiles of DQ_KEYS
  static constexpr int DQ_KEYS = 128;
  static constexpr int DQ_CONSUMERS = 2;
  static constexpr int DQ_THREADS = 128 * (1 + DQ_CONSUMERS);
  static constexpr int DQ_STAGE_BYTES = 2 * HALVES * DQ_KEYS * ROW_BYTES;   // [K, V]
  static constexpr int DQ_FIXED = 1024 + 2 * DQ_CONSUMERS * ROW_TILE_BYTES;
  static constexpr int DQ_FIT = (SMEM_OPTIN - 256 - DQ_FIXED) / DQ_STAGE_BYTES;
  static constexpr int DQ_STAGES = STAGES < DQ_FIT ? STAGES : DQ_FIT;
  static constexpr int DQ_SMEM = DQ_FIXED + DQ_STAGES * DQ_STAGE_BYTES;
  static_assert(KEYS == 64 || KEYS == 128, "one or two consumer warpgroups of 64 keys");
  static_assert(DQ_KEYS == 64 || DQ_KEYS == 128, "a dQ K / V tile: one wgmma N");
  static_assert(DQ_STAGES >= 2 && SMEM <= SMEM_OPTIN - 256, "the rings fit a block");
};

// Zero rows `from` .. 63 of `n_tiles` row tiles (HALVES x 64 rows of 128
// bytes each) starting at `base`, `tile_stride` bytes apart: TMA never
// writes them, and their products must be finite.  Threads `t` of `n`.
template <int HALVES>
__device__ __forceinline__ void zero_tail_rows(unsigned char* base, int tile_stride, int n_tiles,
                                               int from, int t, int n) {
  const int per = (BQ - from) * (ROW_BYTES / 16);   // 16-byte chunks a 64-column tile
  const int total = n_tiles * HALVES * per;
  for (int e = t; e < total; e += n) {
    const int chunk = e % per, rest = e / per;
    const int h = rest % HALVES, tile = rest / HALVES;
    reinterpret_cast<uint4*>(base + tile * tile_stride + (h * BQ + from) * ROW_BYTES)[chunk] =
        make_uint4(0u, 0u, 0u, 0u);
  }
}

// (b) dK and dV of KEYS keys (k0 ..) of kv head kvh of batch row b0 +
// blockIdx.y, over the row tiles [lo, hi) of its split.  grid.x: key tile
// x kv head x split, key tile 0 first (under causal the longest).  Row
// tile i: positions i P .. i P + P - 1, its G P rows in the kernels' row
// order (slot r: position i P + r / G, head kvh G + r % G).  part_k null:
// write bf16 dk / dv (dk scaled); else fp32 partials, unscaled, at part +
// split * part_stride.
template <int DP>
__global__ void __launch_bounds__(Config<DP>::THREADS, Config<DP>::MIN_BLOCKS) dkdv_sm90_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
    const float* __restrict__ lse2, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, float* __restrict__ part_k,
    float* __restrict__ part_v, int64_t part_stride, int b0, int Tq, int Tk, int KV, int G,
    int P, int n_rt, int causal, int splits, float scale_log2, float scale) {
  using C = Config<DP>;
  constexpr int KEYS = C::KEYS, STAGES = C::STAGES, HALVES = C::HALVES;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t kv_full, full[STAGES], empty[STAGES];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Ks = smem;                          // [half][key][128 bytes]
  unsigned char* Vs = smem + C::KV_BYTES;
  unsigned char* tiles = smem + 2 * C::KV_BYTES;     // [stage][Q, dO][half][row][128 bytes]
  float* stats = reinterpret_cast<float*>(tiles + STAGES * C::STAGE_BYTES);  // [stage][lse2, delta][64]

  const int tid = threadIdx.x;
  const int x = static_cast<int>(blockIdx.x);
  const int split = x % splits;
  const int kvh = (x / splits) % KV;
  const int kt = x / (splits * KV);
  const int b = b0 + static_cast<int>(blockIdx.y);
  const int k0 = kt * KEYS;
  // under causal a key at position j is seen by the rows of positions >= j
  const int first = causal ? min(k0 / P, n_rt) : 0;
  const int n = n_rt - first;
  const int lo = first + static_cast<int>((int64_t(split) * n) / splits);
  const int hi = first + static_cast<int>((int64_t(split + 1) * n) / splits);
  const int rows_used = G * P;

  if (tid == 0) {
    mbar_init(&kv_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], C::CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid < 128) {
    // ---- the producer warpgroup: one thread issues every load -------------
    reg_dealloc<PRODUCER_REGS>();
    if (tid == 0 && lo < hi) {
      tma_prefetch_map(&tm_q);
      tma_prefetch_map(&tm_do);
      mbar_arrive_expect_tx(&kv_full, 2 * C::KV_BYTES);
#pragma unroll
      for (int h = 0; h < HALVES; ++h) {
        tma_load_4d(Ks + h * KEYS * ROW_BYTES, &tm_k, &kv_full, 64 * h, kvh, k0, b);
        tma_load_4d(Vs + h * KEYS * ROW_BYTES, &tm_v, &kv_full, 64 * h, kvh, k0, b);
      }
      const int64_t stat0 = (int64_t(b) * KV + kvh) * n_rt;
      for (int it = 0; it < hi - lo; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(&empty[s], (it / STAGES - 1) & 1);
        // the boxes' bytes, positions past Tq (zeros) included
        mbar_arrive_expect_tx(&full[s], 2 * HALVES * rows_used * ROW_BYTES + STAT_BYTES);
        unsigned char* qs = tiles + s * C::STAGE_BYTES;
        const int t0 = (lo + it) * P;
#pragma unroll
        for (int h = 0; h < HALVES; ++h) {
          tma_load_4d(qs + h * BQ * ROW_BYTES, &tm_q, &full[s], 64 * h, kvh * G, t0, b);
          tma_load_4d(qs + C::ROW_TILE_BYTES + h * BQ * ROW_BYTES, &tm_do, &full[s], 64 * h,
                      kvh * G, t0, b);
        }
        const int64_t so = (stat0 + lo + it) * BQ;
        bulk_load(stats + s * 2 * BQ, lse2 + so, BQ * 4, &full[s]);
        bulk_load(stats + s * 2 * BQ + BQ, delta + so, BQ * 4, &full[s]);
      }
    }
  } else {
    // ---- the consumer warpgroups: 64 keys each ------------------------------
    reg_alloc<C::CONSUMER_REGS>();
    const int c = tid / 128 - 1;
    const int t = tid % 128, warp = t / 32, lane = t % 32;
    if (rows_used < BQ) {
      // Q and dO have 2 STAGES row tiles, ROW_TILE_BYTES apart
      zero_tail_rows<HALVES>(tiles, C::ROW_TILE_BYTES, 2 * STAGES, rows_used, tid - 128,
                             128 * C::CONSUMERS);
      fence_proxy_async();
      named_barrier(1, 128 * C::CONSUMERS);
    }
    const int kc0 = k0 + 64 * c;                     // this warpgroup's first key
    const uint32_t k_addr = smem_u32(Ks) + c * 64 * ROW_BYTES;
    const uint32_t v_addr = smem_u32(Vs) + c * 64 * ROW_BYTES;
    float dk_acc[DP / 2], dv_acc[DP / 2];   // element 4n + e: key 16 warp + lane / 4 + 8 (e / 2), dim 8n + 2 (lane % 4) + e % 2
#pragma unroll
    for (int e = 0; e < DP / 2; ++e) {
      dk_acc[e] = 0.f;
      dv_acc[e] = 0.f;
    }
    // S^T = K Q^T, then dP^T = V dO^T of stage s, one commit group each:
    // 64 keys x the tile's 64 slots, element 4j + e: key 16 warp + lane / 4
    // + 8 (e / 2), slot 8j + 2 (lane % 4) + e % 2
    float st[32], dpt[32];
    auto issue_s = [&](int s) {
      const uint32_t q_addr = smem_u32(tiles + s * C::STAGE_BYTES);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const int h = kk / 4, off = (kk % 4) * 32;
        wgmma_ss<64>(st, desc_k_major(k_addr + h * KEYS * ROW_BYTES + off),
                     desc_k_major(q_addr + h * BQ * ROW_BYTES + off), kk > 0);
      }
      wgmma_commit();
    };
    auto issue_dp = [&](int s) {
      const uint32_t do_addr = smem_u32(tiles + s * C::STAGE_BYTES) + C::ROW_TILE_BYTES;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const int h = kk / 4, off = (kk % 4) * 32;
        wgmma_ss<64>(dpt, desc_k_major(v_addr + h * KEYS * ROW_BYTES + off),
                     desc_k_major(do_addr + h * BQ * ROW_BYTES + off), kk > 0);
      }
      wgmma_commit();
    };
    // p = 2^(s scale log2 e - lse2) in place in st, 0 where masked: only
    // where row tile i's first position lies below this warpgroup's last
    // key, key sees slot r iff key G <= i P G + r
    auto probs = [&](int s, int i) {
      const float* l2s = stats + s * 2 * BQ;
      const bool masked = causal && i * P < kc0 + 63;
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const int thr = (kc0 + 16 * warp + lane / 4 + 8 * ii - i * P) * G;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 8 * j + 2 * (lane & 3);
          const float2 l2 = *reinterpret_cast<const float2*>(l2s + col);
          float p0 = ex2(fmaf(st[4 * j + 2 * ii], scale_log2, -l2.x));
          float p1 = ex2(fmaf(st[4 * j + 2 * ii + 1], scale_log2, -l2.y));
          if (masked) {
            p0 = col < thr ? 0.f : p0;
            p1 = col + 1 < thr ? 0.f : p1;
          }
          st[4 * j + 2 * ii] = p0;
          st[4 * j + 2 * ii + 1] = p1;
        }
      }
    };
    uint32_t pa[16], dsa[16];          // P^T and dS^T as the A fragments: [2j + ii]
    auto pack_p = [&]() {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int ii = 0; ii < 2; ++ii)
          pa[2 * j + ii] = pack_bf16(st[4 * j + 2 * ii], st[4 * j + 2 * ii + 1]);
    };
    auto pack_ds = [&](int s) {
      const float* dls = stats + s * 2 * BQ + BQ;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 8 * j + 2 * (lane & 3);
        const float2 dl = *reinterpret_cast<const float2*>(dls + col);
#pragma unroll
        for (int ii = 0; ii < 2; ++ii)
          dsa[2 * j + ii] = pack_bf16(st[4 * j + 2 * ii] * (dpt[4 * j + 2 * ii] - dl.x),
                                      st[4 * j + 2 * ii + 1] * (dpt[4 * j + 2 * ii + 1] - dl.y));
      }
    };
    // dV += P^T dO, dK += dS^T Q of stage s: 4 k-steps of 16 slots, dO and
    // Q MN-major; one commit group
    auto issue_grads = [&](int s) {
      const uint32_t q_addr = smem_u32(tiles + s * C::STAGE_BYTES);
      const uint32_t do_addr = q_addr + C::ROW_TILE_BYTES;
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3]};
        wgmma_rs<DP>(dv_acc, a, desc_mn_major(do_addr + kk * 16 * ROW_BYTES, BQ * ROW_BYTES), 1);
      }
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        const uint32_t a[4] = {dsa[4 * kk], dsa[4 * kk + 1], dsa[4 * kk + 2], dsa[4 * kk + 3]};
        wgmma_rs<DP>(dk_acc, a, desc_mn_major(q_addr + kk * 16 * ROW_BYTES, BQ * ROW_BYTES), 1);
      }
      wgmma_commit();
    };
    auto stage_in = [&](int it) {
      const int s = it % STAGES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      return s;
    };
    // one row tile at a time: p under dP^T, then dV and dK (issuing the
    // next tile's S^T ahead of this tile's dV / dK, with p taken under
    // them, measured 25% slower: PERF.md)
    const int n_it = hi - lo;
    if (n_it > 0) mbar_wait(&kv_full, 0);
    for (int it = 0; it < n_it; ++it) {
      const int s = stage_in(it);
      wgmma_fence();
      issue_s(s);
      issue_dp(s);
      wgmma_wait<1>();                 // S^T retired; dP^T may still run
      fence_regs(st);
      probs(s, lo + it);
      pack_p();
      wgmma_wait<0>();
      fence_regs(dpt);
      pack_ds(s);
      wgmma_fence();
      issue_grads(s);
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      fence_regs(pa);
      fence_regs(dsa);
      if (t == 0) mbar_arrive(&empty[s]);       // this warpgroup is done with the stage
    }

    // keys kc0 + 16 warp + lane / 4 + 8 ii, dims 8 n + 2 (lane % 4) + {0, 1}
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      const int key = kc0 + 16 * warp + lane / 4 + 8 * ii;
      if (key >= Tk) continue;
      const int64_t off = ((int64_t(b) * Tk + key) * KV + kvh) * DP + 2 * (lane & 3);
#pragma unroll
      for (int nn = 0; nn < DP / 8; ++nn) {
        const float k0v = dk_acc[4 * nn + 2 * ii], k1v = dk_acc[4 * nn + 2 * ii + 1];
        const float v0v = dv_acc[4 * nn + 2 * ii], v1v = dv_acc[4 * nn + 2 * ii + 1];
        if (part_k == nullptr) {
          *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * nn) =
              __floats2bfloat162_rn(scale * k0v, scale * k1v);
          *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * nn) = __floats2bfloat162_rn(v0v, v1v);
        } else {
          const int64_t p = split * part_stride + off + 8 * nn;
          *reinterpret_cast<float2*>(part_k + p) = make_float2(k0v, k1v);
          *reinterpret_cast<float2*>(part_v + p) = make_float2(v0v, v1v);
        }
      }
    }
  }
}

// (c) dQ of two row tiles (a consumer warpgroup each) of kv head kvh of
// batch row b0 + blockIdx.y, over the K / V tiles of DQ_KEYS keys its rows
// see.  grid.x: pair of row tiles x kv head, the last pair first (under
// causal the longest).
template <int DP>
__global__ void __launch_bounds__(Config<DP>::DQ_THREADS, 1) dq_sm90_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
    const float* __restrict__ lse2, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dq, int b0, int Tq, int Tk, int H, int KV, int G, int P,
    int n_rt, int causal, float scale_log2, float scale) {
  using C = Config<DP>;
  constexpr int BKV = C::DQ_KEYS, STAGES = C::DQ_STAGES, HALVES = C::HALVES;
  constexpr int CONS = C::DQ_CONSUMERS;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t q_full, kv_full[STAGES], kv_empty[STAGES];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* rows = smem;          // [Q of tile 0, Q of tile 1, dO of 0, dO of 1][half][row][128]
  unsigned char* kv = smem + 2 * CONS * C::ROW_TILE_BYTES;   // [stage][K, V][half][key][128]

  const int tid = threadIdx.x;
  const int n_groups = (n_rt + CONS - 1) / CONS;
  const int grp = n_groups - 1 - static_cast<int>(blockIdx.x) / KV;
  const int kvh = static_cast<int>(blockIdx.x) % KV;
  const int b = b0 + static_cast<int>(blockIdx.y);
  const int tile0 = grp * CONS;
  const int n_here = min(CONS, n_rt - tile0);
  const int rows_used = G * P;
  const int t_last = min(Tq, (tile0 + n_here) * P) - 1;   // the block's last position
  const int n_keys = causal ? min(Tk, t_last + 1) : Tk;
  const int n_kt = (n_keys + BKV - 1) / BKV;

  if (tid == 0) {
    mbar_init(&q_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&kv_full[s], 1);
      mbar_init(&kv_empty[s], CONS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid < 128) {
    reg_dealloc<PRODUCER_REGS>();
    if (tid == 0 && n_kt > 0) {
      tma_prefetch_map(&tm_k);
      tma_prefetch_map(&tm_v);
      mbar_arrive_expect_tx(&q_full, n_here * 2 * HALVES * rows_used * ROW_BYTES);
      for (int c = 0; c < n_here; ++c) {
        const int t0 = (tile0 + c) * P;
#pragma unroll
        for (int h = 0; h < HALVES; ++h) {
          tma_load_4d(rows + c * C::ROW_TILE_BYTES + h * BQ * ROW_BYTES, &tm_q, &q_full,
                      64 * h, kvh * G, t0, b);
          tma_load_4d(rows + (CONS + c) * C::ROW_TILE_BYTES + h * BQ * ROW_BYTES, &tm_do,
                      &q_full, 64 * h, kvh * G, t0, b);
        }
      }
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) mbar_wait(&kv_empty[s], (j / STAGES - 1) & 1);
        mbar_arrive_expect_tx(&kv_full[s], C::DQ_STAGE_BYTES);
        unsigned char* ks = kv + s * C::DQ_STAGE_BYTES;
#pragma unroll
        for (int h = 0; h < HALVES; ++h) {
          tma_load_4d(ks + h * BKV * ROW_BYTES, &tm_k, &kv_full[s], 64 * h, kvh, j * BKV, b);
          tma_load_4d(ks + (HALVES + h) * BKV * ROW_BYTES, &tm_v, &kv_full[s], 64 * h, kvh,
                      j * BKV, b);
        }
      }
    }
  } else {
    reg_alloc<240>();
    const int c = tid / 128 - 1;
    const int t = tid % 128, warp = t / 32, lane = t % 32;
    const bool active = c < n_here;
    const int i = tile0 + c;            // this warpgroup's row tile
    if (active && rows_used < BQ) {
      // its Q and dO tiles: CONS row tiles apart
      zero_tail_rows<HALVES>(rows + c * C::ROW_TILE_BYTES, CONS * C::ROW_TILE_BYTES, 2,
                             rows_used, t, 128);
      fence_proxy_async();
      named_barrier(1 + c, 128);
    }
    // this thread's slots 16 warp + lane / 4 + 8 ii: lse2, delta, the last
    // key each sees
    float l2[2], dl[2];
    int lim[2];
    const int64_t so = ((int64_t(b) * KV + kvh) * n_rt + min(i, n_rt - 1)) * BQ;
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      const int r = 16 * warp + lane / 4 + 8 * ii;
      l2[ii] = lse2[so + r];
      dl[ii] = delta[so + r];
      lim[ii] = causal ? min(Tk - 1, i * P + r / G) : Tk - 1;
    }
    const int first_pos = i * P;
    const uint32_t q_addr = smem_u32(rows) + c * C::ROW_TILE_BYTES;
    const uint32_t do_addr = q_addr + CONS * C::ROW_TILE_BYTES;
    float acc[DP / 2];     // element 4n + e: slot 16 warp + lane / 4 + 8 (e / 2), dim 8n + 2 (lane % 4) + e % 2
#pragma unroll
    for (int e = 0; e < DP / 2; ++e) acc[e] = 0.f;
    // S = Q K^T and dP = dO V^T of stage s, a commit group each: element
    // 4m + e: slot 16 warp + lane / 4 + 8 (e / 2), key 8m + 2 (lane % 4) + e % 2
    float sc[BKV / 2], dp[BKV / 2];
    uint32_t dsa[BKV / 4];
    auto k_of = [&](int s) { return smem_u32(kv + s * C::DQ_STAGE_BYTES); };
    auto issue_s = [&](int s) {
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const int h = kk / 4, off = (kk % 4) * 32;
        wgmma_ss<BKV>(sc, desc_k_major(q_addr + h * BQ * ROW_BYTES + off),
                      desc_k_major(k_of(s) + h * BKV * ROW_BYTES + off), kk > 0);
      }
      wgmma_commit();
    };
    auto issue_dp = [&](int s) {
      const uint32_t v_addr = k_of(s) + HALVES * BKV * ROW_BYTES;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const int h = kk / 4, off = (kk % 4) * 32;
        wgmma_ss<BKV>(dp, desc_k_major(do_addr + h * BQ * ROW_BYTES + off),
                      desc_k_major(v_addr + h * BKV * ROW_BYTES + off), kk > 0);
      }
      wgmma_commit();
    };
    // p in place in sc, 0 where masked (only on tiles that cross Tk or the
    // diagonal of the tile's first position)
    auto probs = [&](int j) {
      const int k0 = j * BKV;
      const bool masked = k0 + BKV > Tk || (causal && k0 + BKV - 1 > first_pos);
#pragma unroll
      for (int m = 0; m < BKV / 8; ++m) {
        const int key = k0 + 8 * m + 2 * (lane & 3);
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          float p0 = ex2(fmaf(sc[4 * m + 2 * ii], scale_log2, -l2[ii]));
          float p1 = ex2(fmaf(sc[4 * m + 2 * ii + 1], scale_log2, -l2[ii]));
          if (masked) {
            p0 = key > lim[ii] ? 0.f : p0;
            p1 = key + 1 > lim[ii] ? 0.f : p1;
          }
          sc[4 * m + 2 * ii] = p0;
          sc[4 * m + 2 * ii + 1] = p1;
        }
      }
    };
    auto pack_ds = [&]() {
#pragma unroll
      for (int m = 0; m < BKV / 8; ++m)
#pragma unroll
        for (int ii = 0; ii < 2; ++ii)
          dsa[2 * m + ii] = pack_bf16(sc[4 * m + 2 * ii] * (dp[4 * m + 2 * ii] - dl[ii]),
                                      sc[4 * m + 2 * ii + 1] * (dp[4 * m + 2 * ii + 1] - dl[ii]));
    };
    // dQ += dS K of stage s: BKV / 16 k-steps of 16 keys, K MN-major
    auto issue_dq = [&](int s) {
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        const uint32_t a[4] = {dsa[4 * kk], dsa[4 * kk + 1], dsa[4 * kk + 2], dsa[4 * kk + 3]};
        wgmma_rs<DP>(acc, a, desc_mn_major(k_of(s) + kk * 16 * ROW_BYTES, BKV * ROW_BYTES), 1);
      }
      wgmma_commit();
    };
    auto stage_in = [&](int j) {
      const int s = j % STAGES;
      mbar_wait(&kv_full[s], (j / STAGES) & 1);
      return s;
    };
    if (!active) {
      // no row tile here (the last block of an odd count): release each stage
      for (int j = 0; j < n_kt; ++j) {
        const int s = stage_in(j);
        if (t == 0) mbar_arrive(&kv_empty[s]);
      }
    } else if (n_kt > 0) {
      mbar_wait(&q_full, 0);
      for (int j = 0; j < n_kt; ++j) {
        const int s = stage_in(j);
        wgmma_fence();
        issue_s(s);
        issue_dp(s);
        wgmma_wait<1>();               // S retired; dP may still run
        fence_regs(sc);
        probs(j);
        wgmma_wait<0>();
        fence_regs(dp);
        pack_ds();
        wgmma_fence();
        issue_dq(s);
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(dsa);
        if (t == 0) mbar_arrive(&kv_empty[s]);
      }
    }

    if (active) {
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const int r = 16 * warp + lane / 4 + 8 * ii;
        const int tq = i * P + r / G;
        if (r >= rows_used || tq >= Tq) continue;
        __nv_bfloat16* out =
            dq + ((int64_t(b) * Tq + tq) * H + kvh * G + r % G) * DP + 2 * (lane & 3);
#pragma unroll
        for (int nn = 0; nn < DP / 8; ++nn)
          *reinterpret_cast<__nv_bfloat162*>(out + 8 * nn) =
              __floats2bfloat162_rn(scale * acc[4 * nn + 2 * ii], scale * acc[4 * nn + 2 * ii + 1]);
      }
    }
  }
}

// The maps of q / do (boxes of G heads x P positions) and of k / v (boxes
// of `keys` keys); 0 or a cudaError_t
inline int maps(CUtensorMap* tm, const void* q, const void* k, const void* v, const void* dO,
                int B, int Tq, int Tk, int H, int KV, int D, int keys) {
  const int G = H / KV, P = BQ / G;
  int err = tensor_map_bf16_4d(&tm[0], q, D, H, Tq, B, G, P);
  if (err == 0) err = tensor_map_bf16_4d(&tm[1], k, D, KV, Tk, B, 1, keys);
  if (err == 0) err = tensor_map_bf16_4d(&tm[2], v, D, KV, Tk, B, 1, keys);
  if (err == 0) err = tensor_map_bf16_4d(&tm[3], dO, D, H, Tq, B, G, P);
  return err;
}

template <int DP>
int launch_dkdv(const void* q, const void* k, const void* v, const void* dO, const float* lse2,
                const float* delta, void* dk, void* dv, float* part_k, float* part_v, int B,
                int Tq, int Tk, int H, int KV, int causal, int splits, float scale_log2,
                float scale, int device, cudaStream_t st) {
  using C = Config<DP>;
  static std::atomic<uint64_t> attr{0};
  const int rc = flash_backward::allow_smem(dkdv_sm90_kernel<DP>, C::SMEM, device, attr);
  if (rc != 0) return rc;
  CUtensorMap tm[4];
  const int err = maps(tm, q, k, v, dO, B, Tq, Tk, H, KV, DP, C::KEYS);
  if (err != 0) return err;
  const int G = H / KV, P = BQ / G, n_rt = (Tq + P - 1) / P;
  const int n_kt = (Tk + C::KEYS - 1) / C::KEYS;
  const int64_t part_stride = int64_t(B) * Tk * KV * DP;
  if (int64_t(n_kt) * KV * splits > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  for (int64_t b0 = 0; b0 < B; b0 += flash_backward::MAX_GRID_Y) {
    const int64_t nb = std::min<int64_t>(flash_backward::MAX_GRID_Y, B - b0);
    const dim3 grid(static_cast<unsigned>(n_kt * KV * splits), static_cast<unsigned>(nb));
    dkdv_sm90_kernel<DP><<<grid, C::THREADS, C::SMEM, st>>>(
        tm[0], tm[1], tm[2], tm[3], lse2, delta, static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv), part_k, part_v, part_stride, static_cast<int>(b0), Tq,
        Tk, KV, G, P, n_rt, causal, splits, scale_log2, scale);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

template <int DP>
int launch_dq(const void* q, const void* k, const void* v, const void* dO, const float* lse2,
              const float* delta, void* dq, int B, int Tq, int Tk, int H, int KV, int causal,
              float scale_log2, float scale, int device, cudaStream_t st) {
  using C = Config<DP>;
  static std::atomic<uint64_t> attr{0};
  const int rc = flash_backward::allow_smem(dq_sm90_kernel<DP>, C::DQ_SMEM, device, attr);
  if (rc != 0) return rc;
  CUtensorMap tm[4];
  const int err = maps(tm, q, k, v, dO, B, Tq, Tk, H, KV, DP, C::DQ_KEYS);
  if (err != 0) return err;
  const int G = H / KV, P = BQ / G, n_rt = (Tq + P - 1) / P;
  const int n_groups = (n_rt + C::DQ_CONSUMERS - 1) / C::DQ_CONSUMERS;
  if (int64_t(n_groups) * KV > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  for (int64_t b0 = 0; b0 < B; b0 += flash_backward::MAX_GRID_Y) {
    const int64_t nb = std::min<int64_t>(flash_backward::MAX_GRID_Y, B - b0);
    const dim3 grid(static_cast<unsigned>(n_groups * KV), static_cast<unsigned>(nb));
    dq_sm90_kernel<DP><<<grid, C::DQ_THREADS, C::DQ_SMEM, st>>>(
        tm[0], tm[1], tm[2], tm[3], lse2, delta, static_cast<__nv_bfloat16*>(dq),
        static_cast<int>(b0), Tq, Tk, H, KV, G, P, n_rt, causal, scale_log2, scale);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

}  // namespace flash_backward_sm90
}  // namespace

// All launch on ``stream`` and return cudaGetLastError() as an int (0 =
// success).  q, o and do are contiguous bf16 (B, Tq, H, D), k and v
// contiguous bf16 (B, Tk, KV, D), H % KV == 0; lse is fp32 (B, Tq, H).
// The long route takes D 64 or 128, H / KV <= 64 and every pointer 16-byte
// aligned; its lse2 and delta are fp32 (B, KV, n_rt, 64): n_rt =
// ceil(Tq / P) row tiles of P = floor(64 / (H / KV)) positions, a slot a
// row.

// The short route: Tq == Tk == T, KV == 1, T H <= 64, 0 < D <= 64; any
// 2-byte alignment.  dq, dk, dv written whole.
extern "C" int flash_backward_short_launch(const void* q, const void* k, const void* v,
                                           const void* o, const void* dO, const void* lse,
                                           void* dq, void* dk, void* dv, int64_t B, int T, int H,
                                           int D, int causal, float scale, int device,
                                           void* stream) {
  using namespace flash_backward;
  if (B <= 0 || T <= 0 || H <= 0 || T * H > BQ || D <= 0 || D > SDP)
    return static_cast<int>(cudaErrorInvalidValue);
  int rc = set_device(device);
  if (rc != 0) return rc;
  // two raw buffers where they fit beside the padded tiles (SASRec's: 176
  // KB in all), else one
  const int slot = short_slot(T, H, D);
  int max_smem = 0, n_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_buf = short_smem(slot, 2) <= size_t(max_smem) ? 2 : 1;
  static std::atomic<uint64_t> attr{0};
  rc = allow_smem(short_kernel, size_t(max_smem), device, attr);
  if (rc != 0) return rc;
  const int64_t n_pairs = (B + SEQS - 1) / SEQS;
  const unsigned grid = static_cast<unsigned>(std::min<int64_t>(n_pairs, n_sm));
  short_kernel<<<grid, SHORT_THREADS, short_smem(slot, n_buf),
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dO), static_cast<const float*>(lse),
      static_cast<__nv_bfloat16*>(dq), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), B, T, H, D, causal, slot, n_buf, scale * LOG2E, scale);
  return static_cast<int>(cudaGetLastError());
}

// The long route, (a): lse2 = lse log2 e and delta = rowsum(do o) in the
// kernels' row tiles.
extern "C" int flash_backward_rowstat_launch(const void* o, const void* dO, const void* lse,
                                             void* lse2, void* delta, int B, int Tq, int H,
                                             int KV, int D, int device, void* stream) {
  using namespace flash_backward;
  if (!shape_ok(B, Tq, Tq, H, KV, D) || !(aligned16(o) && aligned16(dO)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rc = set_device(device);
  if (rc != 0) return rc;
  const int G = H / KV, P = tile_positions(H, KV), n_rt = row_tiles(Tq, H, KV);
  const int64_t n_slots = int64_t(B) * KV * n_rt * BQ;
  constexpr int THREADS_A_BLOCK = 256;
  const int64_t threads = n_slots * (D / 8);
  auto* l2 = static_cast<float*>(lse2);
  auto* dl = static_cast<float*>(delta);
  const auto* ob = static_cast<const __nv_bfloat16*>(o);
  const auto* db = static_cast<const __nv_bfloat16*>(dO);
  const auto* lf = static_cast<const float*>(lse);
  const unsigned blocks = static_cast<unsigned>((threads + THREADS_A_BLOCK - 1) / THREADS_A_BLOCK);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    rowstat_kernel<64><<<blocks, THREADS_A_BLOCK, 0, st>>>(ob, db, lf, l2, dl, n_slots, Tq, H,
                                                            KV, G, P, n_rt);
  else
    rowstat_kernel<128><<<blocks, THREADS_A_BLOCK, 0, st>>>(ob, db, lf, l2, dl, n_slots, Tq,
                                                             H, KV, G, P, n_rt);
  return static_cast<int>(cudaGetLastError());
}

// The long route, (b): dk, dv over key tiles of sm90_backward_plan's keys;
// splits > 1 writes fp32 partials to part_k /
// part_v (each splits x B x Tk x KV x D) for flash_backward_reduce_launch,
// splits == 1 writes dk / dv.
extern "C" int flash_backward_dkdv_launch(const void* q, const void* k, const void* v,
                                          const void* dO, const void* lse2, const void* delta,
                                          void* dk, void* dv, void* part_k, void* part_v, int B,
                                          int Tq, int Tk, int H, int KV, int D, int causal,
                                          int splits, float scale, int device, void* stream) {
  using namespace flash_backward;
  if (!shape_ok(B, Tq, Tk, H, KV, D) || splits < 1 ||
      (splits > 1 && (part_k == nullptr || part_v == nullptr)) ||
      !(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dO) && aligned16(lse2) &&
        aligned16(delta)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rc = set_device(device);
  if (rc != 0) return rc;
  auto* pk = splits > 1 ? static_cast<float*>(part_k) : nullptr;
  auto* pv = splits > 1 ? static_cast<float*>(part_v) : nullptr;
  const auto* l2 = static_cast<const float*>(lse2);
  const auto* dl = static_cast<const float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale_log2 = scale * LOG2E;
  using flash_backward_sm90::launch_dkdv;
  return D == 64 ? launch_dkdv<64>(q, k, v, dO, l2, dl, dk, dv, pk, pv, B, Tq, Tk, H, KV, causal,
                                   splits, scale_log2, scale, device, st)
                 : launch_dkdv<128>(q, k, v, dO, l2, dl, dk, dv, pk, pv, B, Tq, Tk, H, KV,
                                    causal, splits, scale_log2, scale, device, st);
}

// The long route, (c): dq over row tiles.
extern "C" int flash_backward_dq_launch(const void* q, const void* k, const void* v,
                                        const void* dO, const void* lse2, const void* delta,
                                        void* dq, int B, int Tq, int Tk, int H, int KV, int D,
                                        int causal, float scale, int device, void* stream) {
  using namespace flash_backward;
  if (!shape_ok(B, Tq, Tk, H, KV, D) ||
      !(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dO) && aligned16(lse2) &&
        aligned16(delta)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rc = set_device(device);
  if (rc != 0) return rc;
  const auto* l2 = static_cast<const float*>(lse2);
  const auto* dl = static_cast<const float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale_log2 = scale * LOG2E;
  using flash_backward_sm90::launch_dq;
  return D == 64 ? launch_dq<64>(q, k, v, dO, l2, dl, dq, B, Tq, Tk, H, KV, causal, scale_log2,
                                 scale, device, st)
                 : launch_dq<128>(q, k, v, dO, l2, dl, dq, B, Tq, Tk, H, KV, causal, scale_log2,
                                  scale, device, st);
}

// The splits' partials added in order: dk = bf16(scale sum), dv = bf16(sum);
// n = B Tk KV D elements each (a multiple of 4).
extern "C" int flash_backward_reduce_launch(const void* part_k, const void* part_v, void* dk,
                                            void* dv, int64_t n, int splits, float scale,
                                            int device, void* stream) {
  using namespace flash_backward;
  if (n % 4 != 0 || splits < 2) return static_cast<int>(cudaErrorInvalidValue);
  const int rc = set_device(device);
  if (rc != 0) return rc;
  if (n == 0) return 0;
  const int64_t n4 = n / 4;
  const unsigned blocks = static_cast<unsigned>(std::min<int64_t>((n4 + 255) / 256, 4096));
  reduce_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part_k), static_cast<const float*>(part_v),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), n, splits, scale);
  return static_cast<int>(cudaGetLastError());
}
