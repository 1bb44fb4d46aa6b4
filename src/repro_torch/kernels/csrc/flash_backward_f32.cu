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
// TB/s); in fact by neither: the step around it waits on the host's
// dispatch, so what counts first is one launch a call in place of the
// plain backward's ~45, then how long the longest block runs.  The design:
//  * one launch: a 1-D grid of two kinds of 8-warp blocks, each writing
//    outputs that no other block writes.  The first n_kt x KV x B blocks
//    take a tile of BK = 8 keys of one kv head and write its dK and dV,
//    walking every query row that sees the tile (from the tile's first
//    position under causal) in chunks of RC = 32; the rest take a tile of
//    RQ = 16 query rows and write its dQ, walking the key tiles (BKQ = 32
//    keys) up to the tile's last position.  Both recompute p, and delta
//    from do and out, for what they read: seven products where one pass
//    would do five, in exchange for no second launch, no workspace and no
//    atomics.  lm-100m's shape gives 256 dK / dV blocks and 256 dQ blocks;
//  * the query rows of a kv head are the G heads of each position in turn
//    (row r: position r / G, head kv G + r % G), as the forward lays them;
//  * Q, dO, O and lse chunks (dK / dV) and K / V tiles (dQ) are staged
//    with the forward's cp.async loaders (flash_f32.cuh), double
//    buffered: the next is in flight while this one is multiplied;
//  * a dK / dV block's chunk: thread (key, row) computes s and dp, the 8
//    lanes sharing a row sum its delta by shuffles, p and ds go to shared
//    memory; then thread (4 keys x 4 columns) adds P^T dO and dS^T Q over
//    its share of the rows (one of RS = 512 / DP interleaved splits, so
//    that each shared read feeds 16 FMAs), the splits' sums added in
//    order at the end, dK scaled once;
//  * a dQ block: thread (key, two rows) computes ds for a 16 x 32 tile,
//    then thread (row, 4 columns) adds dS K, dQ scaled once;
//  * longest first: dK / dV blocks before dQ blocks, key tile 0 (the most
//    rows under causal) first, then the last row tile (the most keys).
// Measured at lm-100m's shape on an H100 (scripts/backward_f32_variants.py):
// the dK / dV blocks set the time (a launch of them alone takes as long as
// the kernel, the dQ blocks alone half), and 8 keys a block beat 16 by
// 12% (64-row chunks, or no two-blocks-an-SM register cap, moved it by
// 3% or less); a block's walk costs far more than its FMAs, and
// without counters on the card what it waits on is not known.  Not yet:
// a long key tile's rows split over a cluster with its dK / dV added in
// distributed shared memory, and tensor cores (3xTF32) for longer
// sequences.

#include "flash_f32.cuh"

#include <atomic>
#include <climits>

namespace flash_backward_f32 {

using namespace flash_f32;

constexpr int THREADS = 256;          // 8 warps, both kinds of block
constexpr int BK = 8;                 // keys a dK / dV block
constexpr int RC = 32;                // query rows a chunk of its walk
constexpr int RQ = 16;                // query rows a dQ block
constexpr int BKQ = 32;               // keys a tile of its walk
constexpr int PS = BK + 4;            // row stride of the dK / dV block's P and dS tiles
constexpr int SS = BKQ + 4;           // row stride of the dQ block's dS tile
constexpr int KG = BK / 4;             // groups of 4 keys a dK / dV block sums
constexpr int SR = RC * BK / THREADS;  // rows a dK / dV thread scores, one key each
static_assert(BK % 4 == 0 && THREADS % BK == 0 && SR >= 1 && RC * BK == SR * THREADS,
              "a dK / dV thread scores one key at SR rows");
static_assert(THREADS == BKQ * (RQ / 2), "a dQ thread scores one key at two rows");

// the sum of x over the N consecutive lanes (N a power of two <= 32) that
// share a row, in a fixed order
template <int N>
__device__ __forceinline__ float lane_sum(float x) {
#pragma unroll
  for (int off = N / 2; off > 0; off >>= 1) x += __shfl_xor_sync(FULL_MASK, x, off);
  return x;
}

// DP: head_dim padded to 64 or 128 (columns past D are zero)
template <int DP>
struct Layout {
  static constexpr int QS = DP + 4;                  // row stride of every row tile
  static constexpr int NCG = DP / 4;                 // float4 columns of a row
  static constexpr int RS = THREADS / (KG * NCG);    // row splits of the dK / dV sums
  static constexpr int QR = NCG * RQ / THREADS;      // rows a thread of the dQ sums
  // dK / dV block: K and V tiles; two stages of [Q, dO, O] chunks; P and
  // dS; two stages of lse
  static constexpr int KV_FLOATS = 2 * BK * QS + 2 * 3 * RC * QS + 2 * RC * PS + 2 * RC;
  // dQ block: its Q, dO and O rows; two stages of [K, V] tiles; dS; lse;
  // delta
  static constexpr int Q_FLOATS = 3 * RQ * QS + 2 * 2 * BKQ * QS + RQ * SS + 2 * RQ;
  static constexpr size_t SMEM =
      sizeof(float) * size_t(KV_FLOATS > Q_FLOATS ? KV_FLOATS : Q_FLOATS);
  static_assert(RS >= 1 && QR >= 1, "DP is 64 or 128");
  static_assert((RS - 1) * 8 * KG * NCG <= 2 * 3 * RC * QS / 4, "the split sums fit the stages");
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
  int n_rt;             // row tiles (RQ rows) of a kv head
  int64_t heads;        // B x KV
  int64_t n_kblocks;    // dK / dV blocks: key tiles x heads
};

// The element offset of row r of the kv head whose rows start at `head`
// (row r: position r / G, head head + r % G): ((b Tq + r / G) H + kv G +
// r % G) for head = b Tq H + kv G, times the row length.
__device__ __forceinline__ int64_t row_offset(int64_t head, int r, int G, int H) {
  return head + int64_t(r / G) * H + r % G;
}

template <int DP>
__device__ __forceinline__ void dkdv_block(const Args& a, float* smem, int kt, int64_t b,
                                           int kvh) {
  using L = Layout<DP>;
  constexpr int QS = L::QS, NCG = L::NCG, RS = L::RS;
  float* Ks = smem;                       // BK x QS
  float* Vs = Ks + BK * QS;               // BK x QS
  float* St = Vs + BK * QS;               // [stage][Q, dO, O] RC x QS each
  float* Ps = St + 2 * 3 * RC * QS;       // RC x PS
  float* dSs = Ps + RC * PS;              // RC x PS
  float* Ls = dSs + RC * PS;              // [stage] RC

  const int tid = threadIdx.x;
  const int D = a.D, G = a.G, H = a.H, vw = a.vw;
  const int R = a.Tq * G;                 // query rows of the kv head
  const int k0 = kt * BK;
  const int r_first = a.causal ? min(k0 * G, R) : 0;   // rows before see no key of the tile
  const int n_chunks = (R - r_first + RC - 1) / RC;
  const int64_t head = b * a.Tq * H + kvh * G;
  const int64_t key_stride = int64_t(a.KV) * D;
  const float* kh = a.k + (b * a.Tk * a.KV + kvh) * D;
  const float* vh = a.v + (b * a.Tk * a.KV + kvh) * D;

  if (D < DP) {  // never written by the copies; read by the dot products
    zero_columns<DP, THREADS>(Ks, QS, 2 * BK, D, tid);
    zero_columns<DP, THREADS>(St, QS, 2 * 3 * RC, D, tid);
  }
  const int Tk = a.Tk;
  auto key_src = [&](const float* t) {
    return [=](int j) -> const float* { return k0 + j < Tk ? t + (k0 + j) * key_stride : nullptr; };
  };
  stage_rows<DP, THREADS>(Ks, QS, BK, key_src(kh), kh, D, vw, tid);
  stage_rows<DP, THREADS>(Vs, QS, BK, key_src(vh), vh, D, vw, tid);
  auto stage_chunk = [&](int c) {
    const int r0 = r_first + c * RC;
    float* dst = St + (c & 1) * 3 * RC * QS;
    auto row_src = [&](const float* t) {
      return [=](int r) -> const float* {
        return r0 + r < R ? t + row_offset(head, r0 + r, G, H) * D : nullptr;
      };
    };
    stage_rows<DP, THREADS>(dst, QS, RC, row_src(a.q), a.q, D, vw, tid);
    stage_rows<DP, THREADS>(dst + RC * QS, QS, RC, row_src(a.dout), a.dout, D, vw, tid);
    stage_rows<DP, THREADS>(dst + 2 * RC * QS, QS, RC, row_src(a.o), a.o, D, vw, tid);
    if (tid < RC) {
      const bool ok = r0 + tid < R;
      cp_async<4>(Ls + (c & 1) * RC + tid, ok ? a.lse + row_offset(head, r0 + tid, G, H) : a.lse,
                  ok);
    }
  };
  if (n_chunks > 0) stage_chunk(0);
  cp_async_commit();                      // K, V and chunk 0

  // scores: key sk at rows sr + (THREADS / BK) i, i < SR; the BK lanes of
  // a row are those that share sr
  const int sk = tid % BK, sr = tid / BK;
  const int key = k0 + sk;
  // sums: keys 4 kg .. 4 kg + 3, columns 4 c .. 4 c + 3, rows h, h + RS, ...
  const int c = tid % NCG, kg = (tid / NCG) % KG, h = tid / (KG * NCG);
  float4 dk[4], dv[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    dk[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    dv[u] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int ch = 0; ch < n_chunks; ++ch) {
    cp_async_wait_all();
    __syncthreads();  // chunk ch landed; every thread is done with chunk ch - 1
    if (ch + 1 < n_chunks) {
      stage_chunk(ch + 1);  // into the stage chunk ch - 1 used
      cp_async_commit();
    }
    const float* Qc = St + (ch & 1) * 3 * RC * QS;
    const float* dOc = Qc + RC * QS;
    const float* Oc = dOc + RC * QS;
    const float* Lc = Ls + (ch & 1) * RC;
    const int r0 = r_first + ch * RC;

    float s[SR], dp[SR], dl[SR];
#pragma unroll
    for (int i = 0; i < SR; ++i) s[i] = dp[i] = dl[i] = 0.f;
#pragma unroll 4
    for (int d4 = 0; d4 < NCG; ++d4) {
      const float4 kk = *reinterpret_cast<const float4*>(Ks + sk * QS + 4 * d4);
      const float4 vv = *reinterpret_cast<const float4*>(Vs + sk * QS + 4 * d4);
#pragma unroll
      for (int i = 0; i < SR; ++i) {
        const int r = sr + i * (THREADS / BK);
        s[i] = dot4(*reinterpret_cast<const float4*>(Qc + r * QS + 4 * d4), kk, s[i]);
        dp[i] = dot4(*reinterpret_cast<const float4*>(dOc + r * QS + 4 * d4), vv, dp[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < SR; ++i) {
      const int r = sr + i * (THREADS / BK);
      for (int d4 = sk; d4 < NCG; d4 += BK)
        dl[i] = dot4(*reinterpret_cast<const float4*>(dOc + r * QS + 4 * d4),
                     *reinterpret_cast<const float4*>(Oc + r * QS + 4 * d4), dl[i]);
      const float delta = lane_sum<BK>(dl[i]);
      const int row = r0 + r;
      const bool seen = row < R && key < Tk && (!a.causal || key <= row / G);
      const float p = seen ? expf(s[i] * a.scale - Lc[r]) : 0.f;
      Ps[r * PS + sk] = p;
      dSs[r * PS + sk] = p * (dp[i] - delta);
    }
    __syncthreads();  // P and dS of the chunk are written

#pragma unroll 2
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

  // the splits' sums, added in split order through the stages' memory
  cp_async_wait_all();
  __syncthreads();
  float4* part = reinterpret_cast<float4*>(St);  // [split - 1][dk 0..3, dv 0..3][KG NCG]
  const int tl = tid % (KG * NCG);
  if (h > 0) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      part[((h - 1) * 8 + u) * KG * NCG + tl] = dk[u];
      part[((h - 1) * 8 + 4 + u) * KG * NCG + tl] = dv[u];
    }
  }
  __syncthreads();
  if (h > 0) return;
  for (int split = 1; split < RS; ++split) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 x = part[((split - 1) * 8 + u) * KG * NCG + tl];
      const float4 y = part[((split - 1) * 8 + 4 + u) * KG * NCG + tl];
      dk[u] = make_float4(dk[u].x + x.x, dk[u].y + x.y, dk[u].z + x.z, dk[u].w + x.w);
      dv[u] = make_float4(dv[u].x + y.x, dv[u].y + y.y, dv[u].z + y.z, dv[u].w + y.w);
    }
  }
  const int d = 4 * c;
  if (d >= D) return;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int j = k0 + 4 * kg + u;
    if (j >= Tk) break;
    const int64_t at = ((b * Tk + j) * a.KV + kvh) * D + d;
    const float4 x = make_float4(a.scale * dk[u].x, a.scale * dk[u].y, a.scale * dk[u].z,
                                 a.scale * dk[u].w);
    if (vw == 4) {  // D % 4 == 0 and every operand 16-byte aligned
      *reinterpret_cast<float4*>(a.dk + at) = x;
      *reinterpret_cast<float4*>(a.dv + at) = dv[u];
    } else {
      const float xs[4] = {x.x, x.y, x.z, x.w};
      const float ys[4] = {dv[u].x, dv[u].y, dv[u].z, dv[u].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (d + e < D) {
          a.dk[at + e] = xs[e];
          a.dv[at + e] = ys[e];
        }
      }
    }
  }
}

template <int DP>
__device__ __forceinline__ void dq_block(const Args& a, float* smem, int rt, int64_t b, int kvh) {
  using L = Layout<DP>;
  constexpr int QS = L::QS, NCG = L::NCG, QR = L::QR;
  float* Qs = smem;                       // RQ x QS
  float* dOs = Qs + RQ * QS;              // RQ x QS
  float* Os = dOs + RQ * QS;              // RQ x QS
  float* KVs = Os + RQ * QS;              // [stage][K, V] BKQ x QS each
  float* dSs = KVs + 2 * 2 * BKQ * QS;    // RQ x SS
  float* Ls = dSs + RQ * SS;              // RQ
  float* Ds = Ls + RQ;                    // RQ

  const int tid = threadIdx.x;
  const int D = a.D, G = a.G, H = a.H, vw = a.vw;
  const int R = a.Tq * G;
  const int r0 = rt * RQ;
  const int last = min(r0 + RQ, R) - 1;   // the block's last row
  const int n_keys = a.causal ? min(a.Tk, last / G + 1) : a.Tk;
  const int n_tiles = (n_keys + BKQ - 1) / BKQ;
  const int64_t head = b * a.Tq * H + kvh * G;
  const int64_t key_stride = int64_t(a.KV) * D;
  const float* kh = a.k + (b * a.Tk * a.KV + kvh) * D;
  const float* vh = a.v + (b * a.Tk * a.KV + kvh) * D;

  if (D < DP) {  // never written by the copies; read by the dot products
    zero_columns<DP, THREADS>(Qs, QS, 3 * RQ, D, tid);
    zero_columns<DP, THREADS>(KVs, QS, 2 * 2 * BKQ, D, tid);
  }
  auto row_src = [&](const float* t) {
    return [=](int r) -> const float* {
      return r0 + r < R ? t + row_offset(head, r0 + r, G, H) * D : nullptr;
    };
  };
  stage_rows<DP, THREADS>(Qs, QS, RQ, row_src(a.q), a.q, D, vw, tid);
  stage_rows<DP, THREADS>(dOs, QS, RQ, row_src(a.dout), a.dout, D, vw, tid);
  stage_rows<DP, THREADS>(Os, QS, RQ, row_src(a.o), a.o, D, vw, tid);
  if (tid < RQ) {
    const bool ok = r0 + tid < R;
    cp_async<4>(Ls + tid, ok ? a.lse + row_offset(head, r0 + tid, G, H) : a.lse, ok);
  }
  cp_async_commit();
  auto stage_kv = [&](int tile) {
    const int j0 = tile * BKQ;
    float* dst = KVs + (tile & 1) * 2 * BKQ * QS;
    auto key_src = [&](const float* t) {
      return [=](int j) -> const float* {
        return j0 + j < n_keys ? t + (j0 + j) * key_stride : nullptr;
      };
    };
    stage_rows<DP, THREADS>(dst, QS, BKQ, key_src(kh), kh, D, vw, tid);
    stage_rows<DP, THREADS>(dst + BKQ * QS, QS, BKQ, key_src(vh), vh, D, vw, tid);
  };
  if (n_tiles > 0) stage_kv(0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();  // the block's rows landed
  {  // delta, 16 lanes a row; read after the key loop's first barrier
    const int r = tid / 16, l = tid % 16;
    float dl = 0.f;
    for (int d4 = l; d4 < NCG; d4 += 16)
      dl = dot4(*reinterpret_cast<const float4*>(dOs + r * QS + 4 * d4),
                *reinterpret_cast<const float4*>(Os + r * QS + 4 * d4), dl);
    dl = row_sum16(dl);
    if (l == 0) Ds[r] = dl;
  }

  // scores: key `lane` of the tile at rows w and w + RQ / 2; sums: rows
  // qr + (THREADS / NCG) i, columns 4 qc .. 4 qc + 3
  const int lane = tid & 31, w = tid >> 5;
  const int qc = tid % NCG, qr = tid / NCG;
  float4 acc[QR];
#pragma unroll
  for (int i = 0; i < QR; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait_all();
    __syncthreads();  // tile `tile` landed; every thread is done with tile - 1
    if (tile + 1 < n_tiles) {
      stage_kv(tile + 1);  // into the stage tile - 1 used
      cp_async_commit();
    }
    const float* Kt = KVs + (tile & 1) * 2 * BKQ * QS;
    const float* Vt = Kt + BKQ * QS;
    const int key = tile * BKQ + lane;
    float s[2] = {0.f, 0.f}, dp[2] = {0.f, 0.f};
#pragma unroll 4
    for (int d4 = 0; d4 < NCG; ++d4) {
      const float4 kk = *reinterpret_cast<const float4*>(Kt + lane * QS + 4 * d4);
      const float4 vv = *reinterpret_cast<const float4*>(Vt + lane * QS + 4 * d4);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = w + i * (RQ / 2);
        s[i] = dot4(*reinterpret_cast<const float4*>(Qs + r * QS + 4 * d4), kk, s[i]);
        dp[i] = dot4(*reinterpret_cast<const float4*>(dOs + r * QS + 4 * d4), vv, dp[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = w + i * (RQ / 2);
      const int row = r0 + r;
      const bool seen = row < R && key < n_keys && (!a.causal || key <= row / G);
      const float p = seen ? expf(s[i] * a.scale - Ls[r]) : 0.f;
      dSs[r * SS + lane] = p * (dp[i] - Ds[r]);
    }
    __syncthreads();  // dS of the tile is written

#pragma unroll 2
    for (int j = 0; j < BKQ; j += 4) {
      float4 kk[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        kk[u] = *reinterpret_cast<const float4*>(Kt + (j + u) * QS + 4 * qc);
#pragma unroll
      for (int i = 0; i < QR; ++i) {
        const float4 ss =
            *reinterpret_cast<const float4*>(dSs + (qr + (THREADS / NCG) * i) * SS + j);
        acc[i] = fma4(ss.x, kk[0], acc[i]);
        acc[i] = fma4(ss.y, kk[1], acc[i]);
        acc[i] = fma4(ss.z, kk[2], acc[i]);
        acc[i] = fma4(ss.w, kk[3], acc[i]);
      }
    }
  }

  const int d = 4 * qc;
  if (d >= D) return;
#pragma unroll
  for (int i = 0; i < QR; ++i) {
    const int row = r0 + qr + (THREADS / NCG) * i;
    if (row >= R) continue;
    float* out = a.dq + row_offset(head, row, G, H) * D + d;
    const float4 x = make_float4(a.scale * acc[i].x, a.scale * acc[i].y, a.scale * acc[i].z,
                                 a.scale * acc[i].w);
    if (vw == 4) {
      *reinterpret_cast<float4*>(out) = x;
    } else {
      const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (d + e < D) out[e] = xs[e];
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 2) flash_backward_f32_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int64_t i = blockIdx.x;
  if (i < a.n_kblocks) {
    // key tile 0 (the most rows under causal) of every (batch row, kv head) first
    const int64_t rest = i % a.heads;
    dkdv_block<DP>(a, smem, static_cast<int>(i / a.heads), rest / a.KV,
                   static_cast<int>(rest % a.KV));
  } else {
    // then the last row tile (the most keys) first
    const int64_t j = i - a.n_kblocks;
    const int64_t rest = j % a.heads;
    dq_block<DP>(a, smem, a.n_rt - 1 - static_cast<int>(j / a.heads), rest / a.KV,
                 static_cast<int>(rest % a.KV));
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
  flash_backward_f32_kernel<DP><<<dim3(static_cast<unsigned>(blocks)), THREADS, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace flash_backward_f32

// Launch on ``stream``; returns cudaGetLastError() as an int (0 = success).
// q, out, dout and dq are contiguous float32 (B, Tq, H, D); k, v, dk and
// dv contiguous float32 (B, Tk, KV, D); lse contiguous float32 (B, Tq, H).
// dq, dk and dv are written whole.  Needs B, Tq, Tk > 0, H % KV == 0,
// H / KV <= 64 and 0 < D <= 128; one launch of (ceil(Tk / 16) +
// ceil(Tq H / KV / 16)) x KV x B blocks.
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
  const int64_t blocks = (n_kt + n_rt) * heads;
  if (R > INT_MAX / 2 || int64_t(Tk) * G > INT_MAX / 2 || blocks > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
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
  Args a;
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
  a.n_rt = static_cast<int>(n_rt);
  a.heads = heads;
  a.n_kblocks = n_kt * heads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return D <= 64 ? launch<64>(a, blocks, device, st) : launch<128>(a, blocks, device, st);
}
