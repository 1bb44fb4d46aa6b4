// K4's training backward: the bf16 GQA flash-attention backward on the
// tensor cores, for sm_90a.  The wrapper (repro_torch/kernels/
// flash_attention.py, FlashAttentionFn.backward) sends a bfloat16 call at
// head_dim 64 or 128 here; float32 and other head dims run the plain
// backward.
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
// the forward rounds p before P.V); dq, dk, dv cast once to bf16.
//
// What bounds it on the H100: five products of 2 FLOPs a multiply-add over
// the causal pairs, 10 B H D pairs FLOPs: 3.44e11 at glm4-9b's training
// shape (q (1, 4096, 32, 128), 2 kv heads), 0.348 ms at 989 TFLOP/s,
// against ~143 MB of operands (0.043 ms at 3.35 TB/s): operations bound
// it.  What the design does about it (FlashAttention-2's backward):
//  * every product runs on the tensor cores, mma.sync m16n8k16 bf16 with
//    fp32 accumulators (flash_mma.cuh's score_tile and pv_tile);
//  * the query rows of a kv head are the G heads of each position in turn
//    (row r: position r / G, head r % G), as the prefill kernel lays them,
//    so that one K/V tile serves the whole group; rows are walked in tiles
//    of BQ = 64;
//  * three kernels, no float atomics, so the gradients repeat their bits:
//    (a) rowstat_kernel: delta = rowsum(do o) and lse log2 e, in the row
//        order above, padded to whole row tiles (+inf / 0);
//    (b) dkdv_kernel: a block per (64-key tile, kv head, split): S^T =
//        K Q^T and dP^T = V dO^T with keys as the m dimension (a warp owns
//        16 keys), then dV += P^T dO and dK += dS^T Q from registers, the
//        dK / dV accumulators of the tile held in registers across the
//        walk over row tiles (from the diagonal under causal);
//    (c) dq_kernel: a block per row tile walks the key tiles up to the
//        diagonal, recomputes S, P, dP and dS, and accumulates dQ += dS K
//        (the dQ pass's recompute costs two more products than the five);
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
// Not yet: wgmma and TMA, 128-key tiles (each Q / dO tile is read from L2
// once per 64 keys), dQ folded into the dK / dV walk.

#include "flash_mma.cuh"

#include <algorithm>
#include <atomic>

namespace flash_backward {

using namespace flash_mma;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BQ = 64;               // query rows a tile
constexpr int MAX_GRID_Y = 65535;    // blocks along the batch per launch
constexpr float LOG2E = 1.4426950408889634f;

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

// The products that accumulate (dV += P^T dO, dK += dS^T Q, dQ += dS K)
// are flash_mma.cuh's pv_tile: A from registers as bf16 pairs in an
// accumulator tile's layout, B a [k][n] tile in shared memory read through
// ldmatrix.trans, the sum in a WarpState's o (its m and l go unused).

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
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      float p4[4], ds4[4];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * j + 2 * (lane & 3) + c;   // the row of the tile
        const float l2 = st[col], dl = st[BQ + col];
        const int t = masked ? (rt * BQ + col) / G : 0;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int e = 2 * i + c;
          float p = ex2(fmaf(s[0][j][e], scale_log2, -l2));
          if (masked && key_lo + 8 * i > t) p = 0.f;
          p4[e] = p;
          ds4[e] = p * (dp[0][j][e] - dl);
        }
      }
      pa[0][j][0] = pack_bf16(p4[0], p4[1]);
      pa[0][j][1] = pack_bf16(p4[2], p4[3]);
      dsa[0][j][0] = pack_bf16(ds4[0], ds4[1]);
      dsa[0][j][1] = pack_bf16(ds4[2], ds4[3]);
    }
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

// All four launch on ``stream`` and return cudaGetLastError() as an int (0
// = success).  q, o and do are contiguous bf16 (B, Tq, H, D), k and v
// contiguous bf16 (B, Tk, KV, D), D 64 or 128, H % KV == 0, every pointer
// 16-byte aligned; lse is fp32 (B, Tq, H); lse2 and delta are fp32
// (B, KV, R_pad), R_pad = Tq H / KV rounded up to a multiple of 64.

// (a) lse2 = lse log2 e and delta = rowsum(do o) in the kernels' row order.
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

// (b) dk, dv over key tiles; splits > 1 writes fp32 partials to part_k /
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

// (c) dq over row tiles.
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
