// K4's training backward, float32 route: the GQA flash-attention backward
// on the CUDA cores (FFMA), for sm_90a.  The wrapper (repro_torch/kernels/
// flash_attention.py, FlashAttentionFn.backward) sends every float32 call
// here (lm-100m's training); bfloat16 calls go to flash_backward.cu.
//
// Replaces no Pallas kernel: it computes what the JAX package's custom-VJP
// backward computes (src/repro/models/layers.py::_flash_train_bwd, XLA
// code on the TPU).  Given q (B, Tq, H, D), k and v (B, Tk, KV, D), the
// forward's out (B, Tq, H, D) and its log-sum-exp lse (B, Tq, H) in
// natural log (+inf on a row whose every key is masked, flash_attention.cu
// with its lse output), and do = dL/dout, with G = H / KV, no cache
// (q_offset 0, every key valid):
//   p[t, h, j]  = exp(s[t, h, j] * scale - lse[t, h]),  s = q . k   (0 where masked:
//                 causal, j > t)
//   delta[t, h] = sum_d do[t, h, d] out[t, h, d]
//   ds          = p (do . v[j] - delta)
//   dq[t, h]    = scale sum_j ds[t, h, j] k[j, h / G]
//   dk[j, kv]   = scale sum_{t, h in kv} ds[t, h, j] q[t, h]
//   dv[j, kv]   =       sum_{t, h in kv} p[t, h, j] do[t, h]
// in float32 throughout, every product an FFMA on the CUDA cores: no TF32,
// whose ~3 decimal digits could not hold lm-100m's step-0 gate (loss
// within 1e-6 and gradient norm within 1e-5 of the CPU's), as the
// forward's header says of its own route.  No float atomics and no
// workspace: every output element is written by one thread of one block,
// its sums in a fixed order, so the gradients repeat their bits.
//
// What bounds it on the H100: at lm-100m's shape (q (4, 128, 8, 64) over 4
// kv heads, causal) five causal products, 10 B H D pairs = 1.69e8 FLOPs
// (2.5 us at 67 TFLOP/s), against 6.3 MB of operands (1.9 us at 3.35
// TB/s).  What a walk's step costs decides the design: with 8-key tiles
// and one (row, key) pair a thread, cut copies timed with per-block clocks
// (scripts/backward_f32_variants.py) put half of a step in re-reading its
// rows from L2 (each row read by each of 16 key tiles, ~38 MB a call) and
// a third in the score phase (four shared loads for eight FMAs), and the
// longest walk (key tile 0's, every row) at 8 steps.  The design:
//  * one launch of 4-block clusters (CL): a 1-D grid whose first clusters
//    take tiles of BK = 32 keys of one kv head and write their dK and dV,
//    and whose others take tiles of RQ = 32 query rows and write their dQ.
//    A dK / dV tile walks every row that sees one of its keys (from its
//    first position under causal) in chunks of RC = 32; a dQ tile walks
//    its key tiles (BKQ = 32 keys) up to its last position.  A tile's walk
//    of n steps is split over s = 4, 2 or 1 ranks of a cluster, the fewest
//    that keep a rank's share within `target` steps: the `sub`-th takes
//    steps [sub n / s, (sub + 1) n / s), sums its share (zeros if it is
//    empty), and the shares are added in distributed shared memory in
//    rank order (then row- or key-split order), each rank writing 1 / s of
//    the tile's outputs (a tile not split: in the block's own memory, with
//    no cluster barrier).  `target` is the fewest steps, from the longest
//    walk over 4, whose grid is at most a quarter more blocks than the
//    card holds at two an SM: 3 at lm-100m's shape (key tile 0's 8 chunks
//    over 4 ranks; 304 blocks).  A cluster holds the ranks of one tile
//    index, of one or more heads;
//  * 32 x 32 (row, key) steps on both kinds of block, so each staged chunk
//    serves 32 keys (4x fewer row re-reads than 8-key tiles) and each
//    staged key tile 32 rows: ~24 MB of L2 reads a call in place of ~38;
//  * the score phase register-blocked: a thread takes 2 rows x 2 keys
//    (rows r, r + 16; keys k, k + 16), eight independent 64-long FMA
//    chains, eight 16-byte shared loads for 32 FMAs, a warp's loads
//    touching 4 keys and 8 rows (no bank conflicts at the row stride D +
//    4).  delta is summed there too: the 4 lanes that share a row pair
//    take a quarter of its columns each, then two shuffles (dK / dV
//    blocks), or once for the tile's rows before the walk (dQ blocks);
//  * the sums register-blocked: 4 keys x 4 columns of dK and dV a thread
//    (512 / DP row splits), 4 rows x 4 columns of dQ (512 / DP key
//    splits), each 16-byte load feeding 16 FMAs;
//  * three stages of cp.async (the chunk after next loads while this one
//    is multiplied; the first alone, so that it lands sooner), two
//    barriers a step; a row's global offset from one small division;
//  * the query rows of a kv head are the G heads of each position in turn
//    (row r: position r / G, head kv G + r % G), as the forward lays them;
//  * longest first: dK / dV clusters before dQ clusters, the widest split
//    first, key tile 0 (the most rows under causal) and the last row tile
//    (the most keys) first of their kinds (ordering every cluster by its
//    ranks' shares measured 6% slower).
// Measured at lm-100m's shape (the same script): 0.029 ms a call against
// the 8-key design's 0.035; a 32 x 32 step ~10,000 cycles at two blocks an
// SM, the first chunk's wait ~7,000 a block, the cluster's add and
// barriers ~5,000.  The score phase's shared loads take a quarter of the
// call (its K / V loads a fifth) and its FMAs a fifth.  Not yet: K / V (or
// Q / dO) held in registers across a walk, or larger micro-tiles, so that
// each shared read feeds more FMAs.
// Residency: 105 KB of shared memory a dK / dV block at DP = 64 (K and V,
// three stages of Q / dO / O chunks, P and dS), 75 KB a dQ block; two
// blocks an SM (__launch_bounds__(256, 2): at most 128 registers a
// thread); at DP = 128, 195 KB, one block an SM.

#include "flash_f32.cuh"

#include <cooperative_groups.h>

#include <algorithm>
#include <atomic>
#include <climits>

namespace flash_backward_f32 {

namespace cg = cooperative_groups;
using namespace flash_f32;

constexpr int THREADS = 256;          // 8 warps, both kinds of block
constexpr int CL = 4;                 // blocks a cluster: the ranks a tile's walk is split over
constexpr int BK = 32;                // keys a dK / dV tile
constexpr int RC = 32;                // query rows a chunk of its walk
constexpr int RQ = 32;                // query rows a dQ tile
constexpr int BKQ = 32;               // keys a tile of its walk
constexpr int STAGES = 3;             // chunks (key tiles) in the cp.async ring
constexpr int PS = BK + 4;            // row stride of the dK / dV block's P and dS [row][key]
constexpr int SS = RQ + 8;            // row stride of the dQ block's dS^T [key][row]
constexpr int LEVELS = CL == 4 ? 3 : CL == 2 ? 2 : 1;  // splits CL, CL / 2, .., 1
static_assert(RC == 32 && BK == 32 && RQ == 32 && BKQ == 32, "the score phase takes 32 x 32 steps");
static_assert(THREADS == 256, "16 x 16 threads of 2 x 2 pairs, 8 threads a staged row");
static_assert(CL == 1 || CL == 2 || CL == 4, "a walk is split 1, 2 or 4 ways");

// DP: head_dim padded to 64 or 128 (columns past D are zero)
template <int DP>
struct Layout {
  static constexpr int QS = DP + 4;                  // row stride of every row tile
  static constexpr int NCG = DP / 4;                 // float4 columns of a row
  static constexpr int RS = THREADS / (BK / 4 * NCG);    // row splits of the dK / dV sums
  static constexpr int RSQ = THREADS / (RQ / 4 * NCG);   // key splits of the dQ sums
  // dK / dV block: K and V; STAGES stages of [Q, dO, O] chunks; P and dS;
  // STAGES stages of lse
  static constexpr int KV_FLOATS =
      2 * BK * QS + STAGES * 3 * RC * QS + 2 * RC * PS + STAGES * RC;
  // dQ block: its Q and dO rows; STAGES stages of [K, V] tiles (O first
  // staged in the third); dS^T; lse; delta
  static constexpr int Q_FLOATS = 2 * RQ * QS + STAGES * 2 * BKQ * QS + BKQ * SS + 2 * RQ;
  static constexpr size_t SMEM =
      sizeof(float) * size_t(KV_FLOATS > Q_FLOATS ? KV_FLOATS : Q_FLOATS);
  static_assert(RS >= 1 && RSQ >= 1, "DP is 64 or 128");
  static_assert(RS * 2 * BK * NCG * 4 <= STAGES * 3 * RC * QS, "dK / dV shares fit the stages");
  static_assert(RSQ * RQ * NCG * 4 <= STAGES * 2 * BKQ * QS, "dQ shares fit the stages");
  static_assert(RQ <= BKQ, "O fits a K tile's stage");
};

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* o;
  const float* lse;
  const float* dout;
  float* dq;
  float* dk;
  float* dv;
  int Tq, Tk, H, KV, D, G, causal, vw;
  float scale;
  float inv_g;          // 1 / G, for small quotients
  int n_rt;             // row tiles (RQ rows) of a kv head
  int64_t heads;        // B x KV
  // [dK / dV, dQ]: the tiles, in walk order, whose walk is split CL >>
  // level ways, for each level but the last (which takes the rest), and
  // the tiles of the kind
  int tiles[2][LEVELS];
  int64_t kv_clusters;  // clusters of dK / dV tiles, first in the grid
};

// A block's place in the grid: its tile (a key tile, or a row tile), head,
// and share of the tile's walk, which is split over `split` ranks of the
// cluster from rank `base`, this block being the `sub`-th; `live` false
// on a rank past the last head, which only pads its cluster
struct Unit {
  int tile;
  int64_t b;
  int kvh;
  int split, sub, base;
  bool live;
};

// (32-bit: the launch refuses a grid of more than INT_MAX blocks, and
// every count here is at most the grid's)
__device__ __forceinline__ Unit find_unit(const Args& a, int ci, int rank, bool dq) {
  const int* tiles = a.tiles[dq ? 1 : 0];
  const int heads = static_cast<int>(a.heads);
  int j0 = 0, split = CL;
  for (int lv = 0; lv < LEVELS; ++lv, split >>= 1) {
    const int per = (heads * split + CL - 1) / CL;  // clusters of one tile
    const int n = lv + 1 < LEVELS ? tiles[lv] : tiles[LEVELS - 1] - j0;
    if (ci < n * per || lv + 1 == LEVELS) {
      const int j = j0 + ci / per;
      const int g = (ci % per) * CL + rank;  // rank among the tile's split x heads
      const int head = g / split;
      Unit u;
      u.tile = dq ? a.n_rt - 1 - j : j;
      u.b = head / a.KV;
      u.kvh = head % a.KV;
      u.split = split;
      u.sub = rank % split;
      u.base = rank - u.sub;
      u.live = head < heads;
      return u;
    }
    ci -= n * per;
    j0 += n;
  }
  return Unit{};  // not reached
}

// the sum of x over the N consecutive lanes (N a power of two <= 32) that
// share a row, in a fixed order
template <int N>
__device__ __forceinline__ float lane_sum(float x) {
#pragma unroll
  for (int off = N / 2; off > 0; off >>= 1) x += __shfl_xor_sync(FULL_MASK, x, off);
  return x;
}

// n / G for 0 <= n < 2^22: a float quotient, corrected once
__device__ __forceinline__ int div_small(int n, int G, float inv_g) {
  int q = __float2int_rz(__int2float_rn(n) * inv_g);
  const int rem = n - q * G;
  if (rem < 0) --q;
  else if (rem >= G) ++q;
  return q;
}

// The rows r0 .. r0 + 31 of a kv head: position r / G, head offset r % G.
// One division by G for the block's base, small quotients for the rest.
struct Rows {
  int pos0, g0;
  __device__ __forceinline__ Rows(int r0, int G) : pos0(r0 / G), g0(r0 - (r0 / G) * G) {}
  __device__ __forceinline__ int pos(int i, int G, float inv_g) const {
    return pos0 + div_small(g0 + i, G, inv_g);
  }
  // the element offset / D of row r0 + i of the kv head whose rows start
  // at `head` (b Tq H + kv G): (pos) H + head + r % G
  __device__ __forceinline__ int64_t offset(int64_t head, int i, int G, int H,
                                            float inv_g) const {
    const int p = pos(i, G, inv_g);
    return head + int64_t(p) * H + (g0 + i - (p - pos0) * G);
  }
};

// The `part`-th of 8 threads copying one row of D floats to dst (zeros
// where !valid: then `any` is the global address the copy names).
__device__ __forceinline__ void copy_row(float* dst, const float* src, bool valid,
                                         const float* any, int D, int vw, int part) {
  const int per_row = D / vw;
  for (int c = part; c < per_row; c += 8) {
    const float* s = valid ? src + vw * c : any;
    if (vw == 4) {
      cp_async<16>(dst + 4 * c, s, valid);
    } else if (vw == 2) {
      cp_async<8>(dst + 2 * c, s, valid);
    } else {
      cp_async<4>(dst + c, s, valid);
    }
  }
}

// s and dp of a 32 x 32 step: rows (r, r + 16) of the row tile (Qr, dOr)
// against keys (k, k + 16) of the key tile (Kt, Vt), then p and ds by the
// mask, lse and delta.  dK / dV blocks (TRANSPOSED false) write P and dS
// [row][key]; dQ blocks (true) write dS^T [key][row].  delta: from Or,
// the 4 lanes of a row pair summing a quarter of its columns each
// (DELTA_SMEM false), or read from Ds (true).
template <int DP, bool TRANSPOSED>
__device__ __forceinline__ void score_step(const float* Qr, const float* dOr, const float* Or,
                                           const float* Lr, const float* Ds, const float* Kt,
                                           const float* Vt, float* P, float* dS,
                                           const Args& a, int r0, int R, int j0, int pos_r0,
                                           int pos_r1) {
  using L = Layout<DP>;
  constexpr int QS = L::QS, NCG = L::NCG;
  const int tid = threadIdx.x, w = tid >> 5, l = tid & 31;
  const int k = (w & 3) * 4 + (l & 3);   // keys k, k + 16
  const int r = (w >> 2) * 8 + (l >> 2);  // rows r, r + 16
  float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}}, dp[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll 4
  for (int d4 = 0; d4 < NCG; ++d4) {
    float4 qq[2], gg[2], kk[2], vv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      qq[i] = *reinterpret_cast<const float4*>(Qr + (r + 16 * i) * QS + 4 * d4);
      gg[i] = *reinterpret_cast<const float4*>(dOr + (r + 16 * i) * QS + 4 * d4);
      kk[i] = *reinterpret_cast<const float4*>(Kt + (k + 16 * i) * QS + 4 * d4);
      vv[i] = *reinterpret_cast<const float4*>(Vt + (k + 16 * i) * QS + 4 * d4);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[i][j] = dot4(qq[i], kk[j], s[i][j]);
        dp[i][j] = dot4(gg[i], vv[j], dp[i][j]);
      }
    }
  }
  float delta[2];
  if constexpr (TRANSPOSED) {
    delta[0] = Ds[r];
    delta[1] = Ds[r + 16];
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float x = 0.f;
      for (int d4 = l & 3; d4 < NCG; d4 += 4)
        x = dot4(*reinterpret_cast<const float4*>(dOr + (r + 16 * i) * QS + 4 * d4),
                 *reinterpret_cast<const float4*>(Or + (r + 16 * i) * QS + 4 * d4), x);
      delta[i] = lane_sum<4>(x);
    }
  }
  const int pos[2] = {pos_r0, pos_r1};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int rr = r + 16 * i;
    const float lse = Lr[rr];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int kc = k + 16 * j;
      const int key = j0 + kc;
      const bool seen = r0 + rr < R && key < a.Tk && (!a.causal || key <= pos[i]);
      const float p = seen ? expf(s[i][j] * a.scale - lse) : 0.f;
      const float ds = p * (dp[i][j] - delta[i]);
      if constexpr (TRANSPOSED) {
        dS[kc * SS + rr] = ds;
      } else {
        P[rr * PS + kc] = p;
        dS[rr * PS + kc] = ds;
      }
    }
  }
}

// The ranks that share a tile wait for each other: a cluster barrier, or
// the block's own where the tile is not split (then every block of the
// cluster is such a block: a cluster holds the ranks of one tile index)
__device__ __forceinline__ void share_sync(cg::cluster_group& cluster, const Unit& u) {
  if (u.split > 1) {
    cluster.sync();
  } else {
    __syncthreads();
  }
}

// The `sub`-th of the SPLIT ranks that share a tile writes rows [sub rows
// / SPLIT, (sub + 1) rows / SPLIT) of its outputs: for each, the shares of
// all of them (zeros from a rank whose share of the walk is empty), each
// one's row or key splits in turn, added in that order from their shared
// memory, every load made before the first add.  `shares` is
// [split][m][row][NCG] float4 in each rank (M outputs: dK then dV, or
// dQ); `store(m, row, c4, x)` writes one float4.
template <int DP, int SPLIT, int SPLITS, int M, typename Store>
__device__ __forceinline__ void reduce_shares(cg::cluster_group& cluster, float4* shares,
                                              int rows, const Unit& u, Store store) {
  constexpr int NCG = Layout<DP>::NCG;
  const int out_rows = rows / SPLIT;
  const float4* part[SPLIT];
#pragma unroll
  for (int i = 0; i < SPLIT; ++i)
    part[i] = SPLIT > 1 ? cluster.map_shared_rank(shares, u.base + i) : shares;
  for (int e = threadIdx.x; e < M * out_rows * NCG; e += THREADS) {
    const int c = e % NCG, row = u.sub * out_rows + (e / NCG) % out_rows;
    const int m = e / (NCG * out_rows);
    float4 x[SPLIT * SPLITS];
#pragma unroll
    for (int i = 0; i < SPLIT; ++i) {
#pragma unroll
      for (int h = 0; h < SPLITS; ++h)
        x[i * SPLITS + h] = part[i][((h * M + m) * rows + row) * NCG + c];
    }
    float4 acc = x[0];
#pragma unroll
    for (int i = 1; i < SPLIT * SPLITS; ++i)
      acc = make_float4(acc.x + x[i].x, acc.y + x[i].y, acc.z + x[i].z, acc.w + x[i].w);
    store(m, row, c, acc);
  }
}

template <int DP, int SPLITS, int M, typename Store>
__device__ __forceinline__ void cluster_reduce(cg::cluster_group& cluster, float4* shares,
                                               int rows, const Unit& u, Store store) {
  if constexpr (CL >= 4) {
    if (u.split == 4) return reduce_shares<DP, 4, SPLITS, M>(cluster, shares, rows, u, store);
  }
  if constexpr (CL >= 2) {
    if (u.split == 2) return reduce_shares<DP, 2, SPLITS, M>(cluster, shares, rows, u, store);
  }
  reduce_shares<DP, 1, SPLITS, M>(cluster, shares, rows, u, store);
}

// one float4 of an output row (d = 4 c .. 4 c + 3), vw == 4 or by element
__device__ __forceinline__ void store4(float* out, int d, int D, int vw, float4 x) {
  if (d >= D) return;
  if (vw == 4) {  // D % 4 == 0 and every operand 16-byte aligned
    *reinterpret_cast<float4*>(out) = x;
  } else {
    const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (d + e < D) out[e] = xs[e];
  }
}

// where the `sub`-th of `split` ranks starts its share of a walk of n steps
__device__ __forceinline__ int share_begin(int sub, int n, int split) {
  return static_cast<int>(int64_t(sub) * n / split);
}

template <int DP>
__device__ __forceinline__ void dkdv_block(const Args& a, float* smem, const Unit& u) {
  using L = Layout<DP>;
  constexpr int QS = L::QS, NCG = L::NCG, RS = L::RS, KG = BK / 4;
  float* Ks = smem;                       // BK x QS
  float* Vs = Ks + BK * QS;               // BK x QS
  float* St = Vs + BK * QS;               // [stage][Q, dO, O] RC x QS each
  float* Ps = St + STAGES * 3 * RC * QS;  // RC x PS
  float* dSs = Ps + RC * PS;              // RC x PS
  float* Ls = dSs + RC * PS;              // [stage] RC

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int D = a.D, G = a.G, H = a.H, vw = a.vw, Tk = a.Tk;
  const int R = a.Tq * G;                 // query rows of the kv head
  const int64_t b = u.b;
  const int kvh = u.kvh;
  const int k0 = u.tile * BK;
  const int r_first = a.causal ? min(k0 * G, R) : 0;   // rows before see no key of the tile
  const int n_chunks = (R - r_first + RC - 1) / RC;
  const int lo = u.live ? share_begin(u.sub, n_chunks, u.split) : 0;
  const int hi = u.live ? share_begin(u.sub + 1, n_chunks, u.split) : 0;
  const int64_t head = b * a.Tq * H + kvh * G;
  const int64_t key_stride = int64_t(a.KV) * D;
  const float* kh = a.k + (b * Tk * a.KV + kvh) * D;
  const float* vh = a.v + (b * Tk * a.KV + kvh) * D;

  // sums: keys 4 kg .. 4 kg + 3, columns 4 c .. 4 c + 3, rows h, h + RS, ...
  const int c = tid % NCG, kg = (tid / NCG) % KG, h = tid / (KG * NCG);
  float4 dk[4], dv[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    dk[e] = make_float4(0.f, 0.f, 0.f, 0.f);
    dv[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  if (hi > lo) {
    if (D < DP) {  // never written by the copies; read by the dot products
      zero_columns<DP, THREADS>(Ks, QS, 2 * BK, D, tid);
      zero_columns<DP, THREADS>(St, QS, STAGES * 3 * RC, D, tid);
    }
    const int row = tid >> 3, part = tid & 7;  // the staged row of this thread
    {
      const bool ok = k0 + row < Tk;
      copy_row(Ks + row * QS, kh + (k0 + row) * key_stride, ok, kh, D, vw, part);
      copy_row(Vs + row * QS, vh + (k0 + row) * key_stride, ok, vh, D, vw, part);
    }
    auto stage_chunk = [&](int ch, int slot) {
      const int r0 = r_first + ch * RC;
      const Rows rows(r0, G);
      float* dst = St + slot * 3 * RC * QS + row * QS;
      const bool ok = r0 + row < R;
      const int64_t off = ok ? rows.offset(head, row, G, H, a.inv_g) * D : 0;
      copy_row(dst, a.q + off, ok, a.q, D, vw, part);
      copy_row(dst + RC * QS, a.dout + off, ok, a.dout, D, vw, part);
      copy_row(dst + 2 * RC * QS, a.o + off, ok, a.o, D, vw, part);
      if (tid < RC) {
        const bool in = r0 + tid < R;
        cp_async<4>(Ls + slot * RC + tid,
                    in ? a.lse + rows.offset(head, tid, G, H, a.inv_g) : a.lse, in);
      }
    };
    stage_chunk(lo, 0);
    cp_async_commit();  // K, V and the first chunk, alone: the next load while it is multiplied

    const int sr = ((tid >> 5) >> 2) * 8 + ((tid & 31) >> 2);  // the score phase's rows sr, sr + 16
    for (int ch = lo; ch < hi; ++ch) {
      const int slot = (ch - lo) % STAGES;
      if (ch == lo) {
        cp_async_wait<0>();
      } else {
        cp_async_wait<1>();
      }
      __syncthreads();  // chunk ch landed; every thread is done with chunk ch - 1
      if (ch == lo) {
        if (lo + 1 < hi) stage_chunk(lo + 1, 1);
        cp_async_commit();
      }
      if (ch + 2 < hi) stage_chunk(ch + 2, (ch - lo + 2) % STAGES);  // where ch - 1 was
      cp_async_commit();
      const float* Qc = St + slot * 3 * RC * QS;
      const float* dOc = Qc + RC * QS;
      const float* Oc = dOc + RC * QS;
      const int r0 = r_first + ch * RC;
      const Rows rows(r0, G);
      score_step<DP, false>(Qc, dOc, Oc, Ls + slot * RC, nullptr, Ks, Vs, Ps, dSs, a, r0, R, k0,
                            rows.pos(sr, G, a.inv_g), rows.pos(sr + 16, G, a.inv_g));
      __syncthreads();  // P and dS of the chunk are written

#pragma unroll 4
      for (int r = h; r < RC; r += RS) {
        const float4 pp = *reinterpret_cast<const float4*>(Ps + r * PS + 4 * kg);
        const float4 ss = *reinterpret_cast<const float4*>(dSs + r * PS + 4 * kg);
        const float4 gg = *reinterpret_cast<const float4*>(dOc + r * QS + 4 * c);
        const float4 qq = *reinterpret_cast<const float4*>(Qc + r * QS + 4 * c);
        dv[0] = fma4(pp.x, gg, dv[0]);
        dv[1] = fma4(pp.y, gg, dv[1]);
        dv[2] = fma4(pp.z, gg, dv[2]);
        dv[3] = fma4(pp.w, gg, dv[3]);
        dk[0] = fma4(ss.x, qq, dk[0]);
        dk[1] = fma4(ss.y, qq, dk[1]);
        dk[2] = fma4(ss.z, qq, dk[2]);
        dk[3] = fma4(ss.w, qq, dk[3]);
      }
    }
    cp_async_wait_all();
  }
  __syncthreads();  // every read of the stages is done

  // this rank's shares, [split][dK, dV][key][NCG], over the stages
  float4* shares = reinterpret_cast<float4*>(St);
  if (u.live) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      shares[((h * 2 + 0) * BK + 4 * kg + e) * NCG + c] = dk[e];
      shares[((h * 2 + 1) * BK + 4 * kg + e) * NCG + c] = dv[e];
    }
  }
  share_sync(cluster, u);  // every rank's shares are written
  if (u.live) cluster_reduce<DP, RS, 2>(
      cluster, shares, BK, u,
      [&](int m, int key, int c4, float4 x) {
        const int j = k0 + key;
        if (j >= Tk) return;
        const int64_t at = ((b * Tk + j) * a.KV + kvh) * D + 4 * c4;
        if (m == 0) {
          store4(a.dk + at, 4 * c4, D, vw,
                 make_float4(a.scale * x.x, a.scale * x.y, a.scale * x.z, a.scale * x.w));
        } else {
          store4(a.dv + at, 4 * c4, D, vw, x);
        }
      });
  share_sync(cluster, u);  // no rank leaves while another reads its shares
}

template <int DP>
__device__ __forceinline__ void dq_block(const Args& a, float* smem, const Unit& u) {
  using L = Layout<DP>;
  constexpr int QS = L::QS, NCG = L::NCG, RSQ = L::RSQ, RG = RQ / 4;
  float* Qs = smem;                          // RQ x QS
  float* dOs = Qs + RQ * QS;                 // RQ x QS
  float* KVs = dOs + RQ * QS;                // [stage][K, V] BKQ x QS each
  float* dSt = KVs + STAGES * 2 * BKQ * QS;  // BKQ x SS: dS^T
  float* Ls = dSt + BKQ * SS;                // RQ
  float* Ds = Ls + RQ;                       // RQ
  float* Os = KVs + 2 * 2 * BKQ * QS;        // RQ x QS in the third stage, before the walk

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int D = a.D, G = a.G, H = a.H, vw = a.vw;
  const int R = a.Tq * G;
  const int64_t b = u.b;
  const int kvh = u.kvh;
  const int r0 = u.tile * RQ;
  const int last = min(r0 + RQ, R) - 1;   // the tile's last row
  const int n_keys = a.causal ? min(a.Tk, last / G + 1) : a.Tk;
  const int n_tiles = (n_keys + BKQ - 1) / BKQ;
  const int lo = u.live ? share_begin(u.sub, n_tiles, u.split) : 0;
  const int hi = u.live ? share_begin(u.sub + 1, n_tiles, u.split) : 0;
  const int64_t head = b * a.Tq * H + kvh * G;
  const int64_t key_stride = int64_t(a.KV) * D;
  const float* kh = a.k + (b * a.Tk * a.KV + kvh) * D;
  const float* vh = a.v + (b * a.Tk * a.KV + kvh) * D;
  const Rows rows(r0, G);

  // sums: rows 4 rg .. 4 rg + 3, columns 4 c .. 4 c + 3, keys h, h + RSQ, ...
  const int c = tid % NCG, rg = (tid / NCG) % RG, h = tid / (RG * NCG);
  float4 acc[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] = make_float4(0.f, 0.f, 0.f, 0.f);

  if (hi > lo) {
    if (D < DP) {  // never written by the copies; read by the dot products
      zero_columns<DP, THREADS>(Qs, QS, 2 * RQ, D, tid);
      zero_columns<DP, THREADS>(KVs, QS, STAGES * 2 * BKQ, D, tid);
    }
    const int row = tid >> 3, part = tid & 7;  // the staged row of this thread
    {
      const bool ok = r0 + row < R;
      const int64_t off = ok ? rows.offset(head, row, G, H, a.inv_g) * D : 0;
      copy_row(Qs + row * QS, a.q + off, ok, a.q, D, vw, part);
      copy_row(dOs + row * QS, a.dout + off, ok, a.dout, D, vw, part);
      copy_row(Os + row * QS, a.o + off, ok, a.o, D, vw, part);
      if (tid < RQ) {
        const bool in = r0 + tid < R;
        cp_async<4>(Ls + tid, in ? a.lse + rows.offset(head, tid, G, H, a.inv_g) : a.lse, in);
      }
    }
    cp_async_commit();
    auto stage_kv = [&](int tile, int slot) {
      const int j = tile * BKQ + row;
      float* dst = KVs + slot * 2 * BKQ * QS + row * QS;
      const bool ok = j < n_keys;
      copy_row(dst, kh + j * key_stride, ok, kh, D, vw, part);
      copy_row(dst + BKQ * QS, vh + j * key_stride, ok, vh, D, vw, part);
    };
    stage_kv(lo, 0);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // the tile's rows landed
    {  // delta, 8 lanes a row; read after the walk's first barrier
      float x = 0.f;
      for (int d4 = part; d4 < NCG; d4 += 8)
        x = dot4(*reinterpret_cast<const float4*>(dOs + row * QS + 4 * d4),
                 *reinterpret_cast<const float4*>(Os + row * QS + 4 * d4), x);
      x = lane_sum<8>(x);
      if (part == 0) Ds[row] = x;
    }
    const int sr = ((tid >> 5) >> 2) * 8 + ((tid & 31) >> 2);  // the score phase's rows sr, sr + 16
    const int pos0 = rows.pos(sr, G, a.inv_g), pos1 = rows.pos(sr + 16, G, a.inv_g);

    for (int tile = lo; tile < hi; ++tile) {
      const int slot = (tile - lo) % STAGES;
      if (tile == lo) {
        cp_async_wait<0>();
      } else {
        cp_async_wait<1>();
      }
      __syncthreads();  // tile `tile` landed; every thread is done with tile - 1 (and with O)
      if (tile == lo) {
        if (lo + 1 < hi) stage_kv(lo + 1, 1);
        cp_async_commit();
      }
      if (tile + 2 < hi) stage_kv(tile + 2, (tile - lo + 2) % STAGES);
      cp_async_commit();
      const float* Kt = KVs + slot * 2 * BKQ * QS;
      const float* Vt = Kt + BKQ * QS;
      score_step<DP, true>(Qs, dOs, nullptr, Ls, Ds, Kt, Vt, nullptr, dSt, a, r0, R,
                           tile * BKQ, pos0, pos1);
      __syncthreads();  // dS^T of the tile is written

#pragma unroll 4
      for (int j = h; j < BKQ; j += RSQ) {
        const float4 ss = *reinterpret_cast<const float4*>(dSt + j * SS + 4 * rg);
        const float4 kk = *reinterpret_cast<const float4*>(Kt + j * QS + 4 * c);
        acc[0] = fma4(ss.x, kk, acc[0]);
        acc[1] = fma4(ss.y, kk, acc[1]);
        acc[2] = fma4(ss.z, kk, acc[2]);
        acc[3] = fma4(ss.w, kk, acc[3]);
      }
    }
    cp_async_wait_all();
  }
  __syncthreads();  // every read of the stages is done

  // this rank's shares, [split][row][NCG], over the stages
  float4* shares = reinterpret_cast<float4*>(KVs);
  if (u.live) {
#pragma unroll
    for (int e = 0; e < 4; ++e) shares[(h * RQ + 4 * rg + e) * NCG + c] = acc[e];
  }
  share_sync(cluster, u);  // every rank's shares are written
  if (u.live) cluster_reduce<DP, RSQ, 1>(
      cluster, shares, RQ, u,
      [&](int, int r, int c4, float4 x) {
        if (r0 + r >= R) return;
        float* out = a.dq + rows.offset(head, r, G, H, a.inv_g) * D + 4 * c4;
        store4(out, 4 * c4, D, vw,
               make_float4(a.scale * x.x, a.scale * x.y, a.scale * x.z, a.scale * x.w));
      });
  share_sync(cluster, u);  // no rank leaves while another reads its shares
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 2) flash_backward_f32_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ci = static_cast<int>(blockIdx.x / CL);  // the cluster
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  if (ci < a.kv_clusters) {
    // key tile 0 (the most rows under causal) of every (batch row, kv head) first
    dkdv_block<DP>(a, smem, find_unit(a, ci, rank, false));
  } else {
    // then the last row tile (the most keys) first
    dq_block<DP>(a, smem, find_unit(a, ci - static_cast<int>(a.kv_clusters), rank, true));
  }
}

template <int DP>
int launch(const Args& a, int64_t blocks, int device, cudaStream_t st) {
  constexpr size_t smem = Layout<DP>::SMEM;
  // The shared-memory limit is a per-device attribute of the kernel: set
  // it at the first launch on each device, not at every launch.
  static std::atomic<uint64_t> attr_set{0};
  const uint64_t bit = device < 64 ? uint64_t{1} << device : 0;
  if (!(attr_set.load() & bit)) {
    const cudaError_t attr = cudaFuncSetAttribute(
        flash_backward_f32_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (attr != cudaSuccess) return static_cast<int>(attr);
    attr_set.fetch_or(bit);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = CL;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, flash_backward_f32_kernel<DP>, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace flash_backward_f32

// Launch on ``stream``; returns the launch's error as an int (0 =
// success).  q, out, dout and dq are contiguous float32 (B, Tq, H, D); k,
// v, dk and dv contiguous float32 (B, Tk, KV, D); lse contiguous float32
// (B, Tq, H).  dq, dk and dv are written whole.  Needs B, Tq, Tk > 0, H %
// KV == 0, H / KV <= 64 and 0 < D <= 128; one launch of 4-block
// clusters: for each of the ceil(Tk / 32) key tiles and ceil(Tq H / KV /
// 32) row tiles, ceil(B KV s / 4) clusters, s the ranks its walk is split
// over (1, 2 or 4).
extern "C" int flash_backward_f32_launch(const void* q, const void* k, const void* v,
                                         const void* out, const void* lse, const void* dout,
                                         void* dq, void* dk, void* dv, int B, int Tq, int Tk,
                                         int H, int KV, int D, int causal, float scale,
                                         int device, void* stream) {
  using namespace flash_backward_f32;
  if (B <= 0 || Tq <= 0 || Tk <= 0 || KV <= 0 || H % KV != 0 || H / KV > 64 || D <= 0 ||
      D > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = H / KV;
  const int64_t R = int64_t(Tq) * G;
  const int64_t n_kt = (Tk + BK - 1) / BK, n_rt = (R + RQ - 1) / RQ;
  const int64_t heads = int64_t(B) * KV;
  if (R > INT_MAX / 2 || int64_t(Tk) * G > INT_MAX / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  // each kind's walks in walk order (non-increasing): a dK / dV tile's
  // chunks, a dQ tile's key tiles
  auto kv_walk = [&](int64_t j) {
    const int64_t first = causal ? std::min(j * BK * G, R) : 0;
    return (R - first + RC - 1) / RC;
  };
  auto q_walk = [&](int64_t j) {
    const int64_t rt = n_rt - 1 - j, last = std::min(rt * RQ + RQ, R) - 1;
    return ((causal ? std::min<int64_t>(Tk, last / G + 1) : Tk) + BKQ - 1) / BKQ;
  };
  Args a;
  // the clusters of a grid whose ranks walk at most `target` steps each
  // (a tile split over the fewest of CL, CL / 2, .., 1 ranks that keeps
  // its shares within it, else CL), its tile counts left in a
  auto walk = [&](int kind, int64_t j) { return kind ? q_walk(j) : kv_walk(j); };
  auto plan = [&](int64_t target) {
    int64_t clusters[2] = {0, 0};
    for (int kind = 0; kind < 2; ++kind) {
      const int64_t n = kind ? n_rt : n_kt;
      int64_t below = 0;  // tiles at a smaller level
      for (int lv = 0; lv < LEVELS; ++lv) {
        // tiles [below, end) walk more than target x (CL >> (lv + 1))
        // steps: split CL >> lv ways
        int64_t end = n;
        if (lv + 1 < LEVELS) {
          const int64_t over = target * (CL >> (lv + 1));
          int64_t lo = below, hi = n;  // the first tile that walks <= over
          while (lo < hi) {
            const int64_t mid = (lo + hi) / 2;
            if (walk(kind, mid) <= over) hi = mid; else lo = mid + 1;
          }
          end = lo;
        }
        clusters[kind] += (end - below) * ((heads * (CL >> lv) + CL - 1) / CL);
        a.tiles[kind][lv] = static_cast<int>(lv + 1 < LEVELS ? end - below : n);
        below = end;
      }
    }
    a.kv_clusters = clusters[0];
    return clusters[0] + clusters[1];
  };
  // the shortest shares whose grid the card holds at two blocks an SM,
  // with at most a quarter more blocks waiting
  static int sm_count[64] = {0};
  int n_sm = device >= 0 && device < 64 ? sm_count[device] : 0;
  if (n_sm == 0) {
    const cudaError_t attr =
        cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    if (device >= 0 && device < 64) sm_count[device] = n_sm;
  }
  const int64_t longest = std::max(kv_walk(0), q_walk(0));
  const int64_t slots = 2 * int64_t(n_sm);
  int64_t target = std::max<int64_t>(1, (longest + CL - 1) / CL), most = std::max<int64_t>(1, longest);
  while (target < most) {  // the grid shrinks as the shares grow
    const int64_t mid = (target + most) / 2;
    if (plan(mid) * CL > slots + slots / 4) target = mid + 1; else most = mid;
  }
  const int64_t blocks = plan(target) * CL;  // the last plan is the grid's
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  int current = -1;
  if (cudaGetDevice(&current) != cudaSuccess || current != device) {
    const cudaError_t set = cudaSetDevice(device);
    if (set != cudaSuccess) return static_cast<int>(set);
  }
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out) |
      reinterpret_cast<uintptr_t>(dout) | reinterpret_cast<uintptr_t>(dq) |
      reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv);
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.o = static_cast<const float*>(out);
  a.lse = static_cast<const float*>(lse);
  a.dout = static_cast<const float*>(dout);
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.Tq = Tq;
  a.Tk = Tk;
  a.H = H;
  a.KV = KV;
  a.D = D;
  a.G = G;
  a.causal = causal != 0;
  a.vw = copy_width(D, align);
  a.scale = scale;
  a.inv_g = 1.0f / static_cast<float>(G);
  a.n_rt = static_cast<int>(n_rt);
  a.heads = heads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return D <= 64 ? launch<64>(a, blocks, device, st) : launch<128>(a, blocks, device, st);
}
