// K4's training backward: the bf16 GQA flash-attention backward on the
// tensor cores, for sm_90a.  The wrapper (repro_torch/kernels/
// flash_attention.py, FlashAttentionFn.backward) sends a bfloat16 call here
// by two routes (its backward_route): the short route where a sequence is
// one tile (SASRec's), the long route at head_dim 64 or 128 (the LMs');
// float32 runs the plain backward.
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
// accumulators (flash_mma.cuh).  The query rows of a kv head are the G
// heads of each position in turn (row r: position r / G, head r % G), as
// the prefill kernel lays them; rows go in tiles of BQ = 64.  No float
// atomics: the gradients repeat their bits.
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
// The long route (head_dim 64 or 128, any Tq, Tk; glm4-9b's q (1, 4096, 32,
// 128) over 2 kv heads).  Operations bound it: five products of 2 FLOPs a
// multiply-add over the causal pairs, 10 B H D pairs FLOPs: 3.44e11 at
// glm4-9b's training shape, 0.348 ms at 989 TFLOP/s, against ~143 MB of
// operands (0.043 ms at 3.35 TB/s).  FlashAttention-2's backward in three
// kernels:
//  (a) rowstat_kernel: delta = rowsum(do o) and lse log2 e, in the row
//      order above, padded to whole row tiles (+inf / 0);
//  (b) dkdv_kernel: a block of 4 warps per (64-key tile, kv head, split):
//      S^T = K Q^T and dP^T = V dO^T with keys as the m dimension (a warp
//      owns 16 keys), then dV += P^T dO and dK += dS^T Q from registers,
//      the dK / dV accumulators of the tile held in registers across the
//      walk over row tiles (from the diagonal under causal);
//  (c) dq_kernel: a block per row tile walks the key tiles up to the
//      diagonal, recomputes S, P, dP and dS, and accumulates dQ += dS K
//      (two more products than the five);
//  * load balance under causal: key tile j sees Tq G - 64 j G rows, so the
//    first tile does 64x the last one's work at 4096 positions.  The rows
//    of a key tile are cut into `splits` runs of whole row tiles (the
//    wrapper's backward_splits: enough blocks for three an SM), each
//    writing an fp32 partial that reduce_kernel adds in split order; and
//    the grid is launched longest first (key tile 0 first, dq's last row
//    tile first);
//  * Q / dO tiles (dK / dV) and K / V tiles (dQ) are double-buffered with
//    16-byte cp.async, the next tile in flight while this one is
//    multiplied; two blocks share an SM (104 KB of shared memory each at
//    D = 128).  ptxas: dkdv_kernel 254 registers at D = 128 (its dK and dV
//    accumulators alone take 128), 234 at D = 64; dq_kernel 221 and 189;
//    no spills.
// Measured and set aside (scripts/backward_fold_ab.py keeps it): dQ folded
// into the dK / dV walk (five products, 8 warps over 128-key tiles, dQ
// added in fp32 in a fixed key-tile order behind per-row-tile counters)
// lost to these three kernels at both training shapes on an H100.
// Not yet: wgmma and TMA (FlashAttention-3's shape).

#include "flash_mma.cuh"

#include <algorithm>
#include <atomic>

namespace flash_backward {

using namespace flash_mma;

constexpr int WARPS = 4;             // the long route's blocks
constexpr int THREADS = 32 * WARPS;
constexpr int BQ = 64;               // query rows a tile
constexpr int MAX_GRID_Y = 65535;    // blocks along the batch per launch
constexpr float LOG2E = 1.4426950408889634f;
constexpr int SHORT_THREADS = 256;   // the short route's blocks: 8 warps
constexpr int SEQS = 2;              // sequences a block of the short route
constexpr int SDP = 64;              // the short route's padded head dim
constexpr int DSS = BQ + 8;          // row stride of a dS^T tile [key][row], bf16

// the shared memory of dkdv_kernel: K and V of the tile, then two stages
// of [Q, dO] row tiles, then two stages of [lse2, delta] (BQ floats each)
template <int DP>
constexpr size_t dkdv_smem() {
  return size_t(2) * (2 * BKV + 4 * BQ) * Tile<DP>::DS + size_t(4) * 2 * 2 * BQ;
}

// dq_kernel's: Q and dO of the row tile, then two stages of [K, V]
template <int DP>
constexpr size_t dq_smem() {
  return size_t(2) * (2 * BQ + 4 * BKV) * Tile<DP>::DS;
}

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

// The products that accumulate (dV += P^T dO, dK += dS^T Q, dQ += dS K)
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

// (a) Row statistics, one warp a row of the padded row order: row r of kv
// head kvh of batch row b (r < R = Tq G: position r / G, head kvh G + r % G)
// gets lse2 = lse log2 e and delta = sum_d do o (lanes over d, a fixed
// butterfly: the same bits every run); rows R .. R_pad - 1 get +inf and 0,
// so that their p and ds are 0.
__global__ void rowstat_kernel(const __nv_bfloat16* __restrict__ o,
                               const __nv_bfloat16* __restrict__ dO,
                               const float* __restrict__ lse, float* __restrict__ lse2,
                               float* __restrict__ delta, int64_t n_rows, int Tq, int H,
                               int KV, int D, int G, int R_pad) {
  const int64_t idx = int64_t(blockIdx.x) * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (idx >= n_rows) return;
  const int r = static_cast<int>(idx % R_pad);
  const int64_t bk = idx / R_pad;           // b KV + kvh
  if (r >= Tq * G) {
    if (lane == 0) {
      lse2[idx] = INFINITY;
      delta[idx] = 0.f;
    }
    return;
  }
  const int64_t b = bk / KV, kvh = bk % KV;
  const int t = r / G, g = r - t * G;
  const int64_t row = (b * Tq + t) * H + kvh * G + g;
  const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(o + row * D);
  const __nv_bfloat162* c = reinterpret_cast<const __nv_bfloat162*>(dO + row * D);
  float s = 0.f;
  for (int d = lane; d < D / 2; d += 32) {
    const float2 x = __bfloat1622float2(a[d]), y = __bfloat1622float2(c[d]);
    s = fmaf(x.x, y.x, s);
    s = fmaf(x.y, y.y, s);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(FULL_MASK, s, off);
  if (lane == 0) {
    lse2[idx] = lse[row] * LOG2E;
    delta[idx] = s;
  }
}

// (b) dK and dV of one 64-key tile of one kv head, over the row tiles
// [lo, hi) of its split.  grid.x: key tile x kv head x split, key tile 0
// first (under causal the longest); grid.y: batch rows of this launch.
// part_k null: write bf16 dk / dv (scale dk); else fp32 partials, unscaled,
// at part + split * part_stride.
template <int DP>
__global__ void __launch_bounds__(THREADS, 2) dkdv_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dO,
    const float* __restrict__ lse2, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, float* __restrict__ part_k,
    float* __restrict__ part_v, int64_t part_stride, int Tq, int Tk, int H, int KV, int G,
    int causal, int splits, int R_pad, float scale_log2, float scale) {
  using T = Tile<DP>;
  constexpr int D = DP;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);  // BKV x DS
  __nv_bfloat16* Vs = Ks + BKV * T::DS;                         // BKV x DS
  __nv_bfloat16* QD = Vs + BKV * T::DS;                         // [stage][Q, dO] BQ x DS
  float* stats = reinterpret_cast<float*>(QD + 4 * BQ * T::DS);  // [stage][lse2, delta] BQ

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g8 = lane >> 2;
  const int x = blockIdx.x;
  const int split = x % splits;
  const int kvh = (x / splits) % KV;
  const int kt = x / (splits * KV);
  const int64_t b = blockIdx.y;
  const int k0 = kt * BKV;
  const int R = Tq * G;
  const int n_rt = R_pad / BQ;
  // under causal a key at position j is seen by rows of positions >= j
  const int first = causal ? min((k0 * G) / BQ, n_rt) : 0;
  const int n = n_rt - first;
  const int lo = first + static_cast<int>((int64_t(split) * n) / splits);
  const int hi = first + static_cast<int>((int64_t(split + 1) * n) / splits);

  const int64_t kv_stride = int64_t(KV) * D;
  const __nv_bfloat16* kh = k + (b * Tk * KV + kvh) * D;
  const __nv_bfloat16* vh = v + (b * Tk * KV + kvh) * D;
  auto key_src = [&](const __nv_bfloat16* head) {
    return [=](int j) -> const __nv_bfloat16* {
      return k0 + j < Tk ? head + (k0 + j) * kv_stride : nullptr;
    };
  };
  stage_rows<DP>(Ks, BKV, key_src(kh), kh, D, true, tid, THREADS);
  stage_rows<DP>(Vs, BKV, key_src(vh), vh, D, true, tid, THREADS);

  const int64_t stat0 = (b * KV + kvh) * R_pad;
  auto stage_tile = [&](int rt, int buf) {
    __nv_bfloat16* Qs = QD + buf * 2 * BQ * T::DS;
    __nv_bfloat16* dOs = Qs + BQ * T::DS;
    auto row_src = [&](const __nv_bfloat16* base) {
      return [=](int r) -> const __nv_bfloat16* {
        const int rg = rt * BQ + r;
        if (rg >= R) return nullptr;
        const int t = rg / G;
        return base + ((b * Tq + t) * H + kvh * G + (rg - t * G)) * D;
      };
    };
    stage_rows<DP>(Qs, BQ, row_src(q), q, D, true, tid, THREADS);
    stage_rows<DP>(dOs, BQ, row_src(dO), dO, D, true, tid, THREADS);
    float* st = stats + buf * 2 * BQ;
    if (tid < BQ / 4) {
      cp_async16(st + 4 * tid, lse2 + stat0 + rt * BQ + 4 * tid, 16);
    } else if (tid < BQ / 2) {
      const int c = tid - BQ / 4;
      cp_async16(st + BQ + 4 * c, delta + stat0 + rt * BQ + 4 * c, 16);
    }
  };

  WarpState<DP, 1> dk_acc, dv_acc;  // this warp's 16 keys x D
  dk_acc.init();
  dv_acc.init();
  if (lo < hi) stage_tile(lo, 0);
  cp_async_commit();  // K, V and the first row tile

  // this thread's keys of the tile: 16 warp + g8 + 8 i
  const int key_lo = k0 + 16 * warp + g8;
  for (int rt = lo; rt < hi; ++rt) {
    const int buf = (rt - lo) & 1;
    if (rt + 1 < hi) {
      stage_tile(rt + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* Qs = QD + buf * 2 * BQ * T::DS;
    const __nv_bfloat16* dOs = Qs + BQ * T::DS;
    const float* st = stats + buf * 2 * BQ;
    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x the tile's 64 rows
    float s[1][BQ / 8][4], dp[1][BQ / 8][4];
    score_tile<DP, 1, BQ>(s, Ks, 16 * warp, Qs, lane);
    score_tile<DP, 1, BQ>(dp, Vs, 16 * warp, dOs, lane);
    // a row tile needs the causal mask where its first position is below
    // the tile's last key
    const bool masked = causal && (rt * BQ) / G < k0 + BKV - 1;
    uint32_t pa[1][BQ / 8][2], dsa[1][BQ / 8][2];
    probs(s, dp, st, lane, key_lo, rt * BQ, G, Tk, causal != 0, masked, scale_log2, pa, dsa);
    pv_tile<DP, 1, BQ>(dv_acc, pa, dOs, lane);   // dV += P^T dO
    pv_tile<DP, 1, BQ>(dk_acc, dsa, Qs, lane);   // dK += dS^T Q
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();

  // keys key_lo + 8 i, dims 8 n + 2 (lane % 4) + {0, 1}
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key_lo + 8 * i;
    if (key >= Tk) continue;
    const int64_t off = ((b * Tk + key) * KV + kvh) * D;
#pragma unroll
    for (int nt = 0; nt < T::ONT; ++nt) {
      const int d = 8 * nt + 2 * (lane & 3);
      if (part_k == nullptr) {
        *reinterpret_cast<__nv_bfloat162*>(dk + off + d) = __floats2bfloat162_rn(
            scale * dk_acc.o[0][nt][2 * i], scale * dk_acc.o[0][nt][2 * i + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + off + d) =
            __floats2bfloat162_rn(dv_acc.o[0][nt][2 * i], dv_acc.o[0][nt][2 * i + 1]);
      } else {
        const int64_t p = split * part_stride + off + d;
        *reinterpret_cast<float2*>(part_k + p) =
            make_float2(dk_acc.o[0][nt][2 * i], dk_acc.o[0][nt][2 * i + 1]);
        *reinterpret_cast<float2*>(part_v + p) =
            make_float2(dv_acc.o[0][nt][2 * i], dv_acc.o[0][nt][2 * i + 1]);
      }
    }
  }
}

// (c) dQ of one row tile of one kv head over the key tiles it sees.
// grid.x: row tile x kv head, the last row tile first (under causal the
// longest); grid.y: batch rows of this launch.
template <int DP>
__global__ void __launch_bounds__(THREADS, 2) dq_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dO,
    const float* __restrict__ lse2, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dq, int Tq, int Tk, int H, int KV, int G, int causal, int R_pad,
    float scale_log2, float scale) {
  using T = Tile<DP>;
  constexpr int D = DP;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);  // BQ x DS
  __nv_bfloat16* dOs = Qs + BQ * T::DS;                         // BQ x DS
  __nv_bfloat16* KVs = dOs + BQ * T::DS;                        // [stage][K, V] BKV x DS

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g8 = lane >> 2;
  const int n_rt = R_pad / BQ;
  const int rt = n_rt - 1 - static_cast<int>(blockIdx.x) / KV;
  const int kvh = static_cast<int>(blockIdx.x) % KV;
  const int64_t b = blockIdx.y;
  const int R = Tq * G;
  const int r0 = rt * BQ;
  const int t_first = r0 / G;
  const int t_last = min(R - 1, r0 + BQ - 1) / G;
  const int n_keys = causal ? min(Tk, t_last + 1) : Tk;
  const int n_tiles = (n_keys + BKV - 1) / BKV;

  auto row_src = [&](const __nv_bfloat16* base) {
    return [=](int r) -> const __nv_bfloat16* {
      const int rg = r0 + r;
      if (rg >= R) return nullptr;
      const int t = rg / G;
      return base + ((b * Tq + t) * H + kvh * G + (rg - t * G)) * D;
    };
  };
  const int64_t kv_stride = int64_t(KV) * D;
  const __nv_bfloat16* kh = k + (b * Tk * KV + kvh) * D;
  const __nv_bfloat16* vh = v + (b * Tk * KV + kvh) * D;
  auto kv_tile = [&](int tile) { return KVs + (tile & 1) * 2 * BKV * T::DS; };
  auto stage_kv = [&](int tile) {
    const int k0 = tile * BKV;
    __nv_bfloat16* Ks = kv_tile(tile);
    auto src = [&](const __nv_bfloat16* head) {
      return [=](int j) -> const __nv_bfloat16* {
        return k0 + j < Tk ? head + (k0 + j) * kv_stride : nullptr;
      };
    };
    stage_rows<DP>(Ks, BKV, src(kh), kh, D, true, tid, THREADS);
    stage_rows<DP>(Ks + BKV * T::DS, BKV, src(vh), vh, D, true, tid, THREADS);
  };

  // this thread's rows of the tile: 16 warp + g8 + 8 i
  float l2[2], dl[2];
  int tpos[2];
  const int64_t stat0 = (b * KV + kvh) * R_pad + r0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 16 * warp + g8 + 8 * i;
    l2[i] = lse2[stat0 + r];
    dl[i] = delta[stat0 + r];
    tpos[i] = (r0 + r) / G;
  }

  WarpState<DP, 1> dq_acc;  // this warp's 16 rows x D
  dq_acc.init();
  if (n_tiles > 0) {
    stage_rows<DP>(Qs, BQ, row_src(q), q, D, true, tid, THREADS);
    stage_rows<DP>(dOs, BQ, row_src(dO), dO, D, true, tid, THREADS);
    stage_kv(0);
    cp_async_commit();
  }
  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + 1 < n_tiles) {
      stage_kv(tile + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = tile * BKV;
    const __nv_bfloat16* Ks = kv_tile(tile);
    const __nv_bfloat16* Vs = Ks + BKV * T::DS;
    float s[1][BKV / 8][4], dp[1][BKV / 8][4];
    score_tile<DP, 1, BKV>(s, Qs, 16 * warp, Ks, lane);    // S = Q K^T
    score_tile<DP, 1, BKV>(dp, dOs, 16 * warp, Vs, lane);  // dP = dO V^T
    const bool masked = k0 + BKV > Tk || (causal && k0 + BKV - 1 > t_first);
    uint32_t dsa[1][BKV / 8][2];
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) {
      float ds[4];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int key = k0 + 8 * j + 2 * (lane & 3) + c;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int e = 2 * i + c;
          float p = ex2(fmaf(s[0][j][e], scale_log2, -l2[i]));
          if (masked && (key >= Tk || (causal && key > tpos[i]))) p = 0.f;
          ds[e] = p * (dp[0][j][e] - dl[i]);
        }
      }
      dsa[0][j][0] = pack_bf16(ds[0], ds[1]);
      dsa[0][j][1] = pack_bf16(ds[2], ds[3]);
    }
    pv_tile<DP, 1, BKV>(dq_acc, dsa, Ks, lane);  // dQ += dS K
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int rg = r0 + 16 * warp + g8 + 8 * i;
    if (rg >= R) continue;
    const int t = rg / G;
    __nv_bfloat16* out = dq + ((b * Tq + t) * H + kvh * G + (rg - t * G)) * D;
#pragma unroll
    for (int nt = 0; nt < T::ONT; ++nt) {
      const int d = 8 * nt + 2 * (lane & 3);
      *reinterpret_cast<__nv_bfloat162*>(out + d) =
          __floats2bfloat162_rn(scale * dq_acc.o[0][nt][2 * i], scale * dq_acc.o[0][nt][2 * i + 1]);
    }
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

template <int DP>
int launch_dkdv(const void* q, const void* k, const void* v, const void* dO, const float* lse2,
                const float* delta, void* dk, void* dv, float* part_k, float* part_v, int B,
                int Tq, int Tk, int H, int KV, int causal, int splits, float scale_log2,
                float scale, int device, cudaStream_t st) {
  static std::atomic<uint64_t> attr{0};
  constexpr size_t smem = dkdv_smem<DP>();
  const int rc = allow_smem(dkdv_kernel<DP>, smem, device, attr);
  if (rc != 0) return rc;
  const int G = H / KV;
  const int R_pad = (Tq * G + BQ - 1) / BQ * BQ;
  const int n_kt = (Tk + BKV - 1) / BKV;
  const int64_t part_stride = int64_t(B) * Tk * KV * DP;
  for (int64_t b0 = 0; b0 < B; b0 += MAX_GRID_Y) {
    const int64_t nb = std::min<int64_t>(MAX_GRID_Y, B - b0);
    const int64_t qo = b0 * Tq * H * DP, ko = b0 * Tk * KV * DP, so = b0 * KV * R_pad;
    const dim3 grid(n_kt * KV * splits, static_cast<unsigned>(nb));
    dkdv_kernel<DP><<<grid, THREADS, smem, st>>>(
        static_cast<const __nv_bfloat16*>(q) + qo, static_cast<const __nv_bfloat16*>(k) + ko,
        static_cast<const __nv_bfloat16*>(v) + ko, static_cast<const __nv_bfloat16*>(dO) + qo,
        lse2 + so, delta + so, static_cast<__nv_bfloat16*>(dk) + ko,
        static_cast<__nv_bfloat16*>(dv) + ko, part_k != nullptr ? part_k + ko : nullptr,
        part_v != nullptr ? part_v + ko : nullptr, part_stride, Tq, Tk, H, KV, G, causal, splits,
        R_pad, scale_log2, scale);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

template <int DP>
int launch_dq(const void* q, const void* k, const void* v, const void* dO, const float* lse2,
              const float* delta, void* dq, int B, int Tq, int Tk, int H, int KV, int causal,
              float scale_log2, float scale, int device, cudaStream_t st) {
  static std::atomic<uint64_t> attr{0};
  constexpr size_t smem = dq_smem<DP>();
  const int rc = allow_smem(dq_kernel<DP>, smem, device, attr);
  if (rc != 0) return rc;
  const int G = H / KV;
  const int R_pad = (Tq * G + BQ - 1) / BQ * BQ;
  for (int64_t b0 = 0; b0 < B; b0 += MAX_GRID_Y) {
    const int64_t nb = std::min<int64_t>(MAX_GRID_Y, B - b0);
    const int64_t qo = b0 * Tq * H * DP, ko = b0 * Tk * KV * DP, so = b0 * KV * R_pad;
    const dim3 grid((R_pad / BQ) * KV, static_cast<unsigned>(nb));
    dq_kernel<DP><<<grid, THREADS, smem, st>>>(
        static_cast<const __nv_bfloat16*>(q) + qo, static_cast<const __nv_bfloat16*>(k) + ko,
        static_cast<const __nv_bfloat16*>(v) + ko, static_cast<const __nv_bfloat16*>(dO) + qo,
        lse2 + so, delta + so, static_cast<__nv_bfloat16*>(dq) + qo, Tq, Tk, H, KV, G, causal,
        R_pad, scale_log2, scale);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

bool shape_ok(int B, int Tq, int Tk, int H, int KV, int D) {
  return B > 0 && Tq > 0 && Tk > 0 && KV > 0 && H % KV == 0 && (D == 64 || D == 128) &&
         int64_t(Tq) * (H / KV) + BQ < (int64_t(1) << 31);
}

}  // namespace flash_backward

// All launch on ``stream`` and return cudaGetLastError() as an int (0 =
// success).  q, o and do are contiguous bf16 (B, Tq, H, D), k and v
// contiguous bf16 (B, Tk, KV, D), H % KV == 0; lse is fp32 (B, Tq, H).
// The long route takes D 64 or 128 and every pointer 16-byte aligned; its
// lse2 and delta are fp32 (B, KV, R_pad), R_pad = Tq H / KV rounded up to
// a multiple of 64.

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
// kernels' row order.
extern "C" int flash_backward_rowstat_launch(const void* o, const void* dO, const void* lse,
                                             void* lse2, void* delta, int B, int Tq, int H,
                                             int KV, int D, int device, void* stream) {
  using namespace flash_backward;
  if (!shape_ok(B, Tq, Tq, H, KV, D)) return static_cast<int>(cudaErrorInvalidValue);
  const int rc = set_device(device);
  if (rc != 0) return rc;
  const int G = H / KV;
  const int R_pad = (Tq * G + BQ - 1) / BQ * BQ;
  const int64_t n_rows = int64_t(B) * KV * R_pad;
  constexpr int ROWS_A_BLOCK = 8;  // one warp a row
  rowstat_kernel<<<static_cast<unsigned>((n_rows + ROWS_A_BLOCK - 1) / ROWS_A_BLOCK),
                   32 * ROWS_A_BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dO),
      static_cast<const float*>(lse), static_cast<float*>(lse2), static_cast<float*>(delta),
      n_rows, Tq, H, KV, D, G, R_pad);
  return static_cast<int>(cudaGetLastError());
}

// The long route, (b): dk, dv over key tiles; splits > 1 writes fp32 partials to part_k /
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
      !(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dO)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rc = set_device(device);
  if (rc != 0) return rc;
  const auto* l2 = static_cast<const float*>(lse2);
  const auto* dl = static_cast<const float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale_log2 = scale * LOG2E;
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
