// K4's training backward with dQ folded into the dK / dV walk: a design
// measured against csrc/flash_backward.cu's long route (rowstat, dK / dV,
// dQ with recompute, reduce) and set aside because it lost at glm4-9b's and
// granite's training shapes on an H100.  scripts/backward_fold_ab.py builds
// it with nvcc and times it beside the shipped kernels in one process; the
// main path never loads it.
//
// The design (FlashAttention-2's five products, FlashAttention-3's
// deterministic dQ): bf16, head_dim 64 or 128.  rowstat_kernel makes lse2
// and delta per row (the kernels' row order: the G heads of each position
// in turn) and zeroes the counters.  long_kernel is a persistent grid of
// 8-warp blocks that claim (row block, kv head, 128-key tile) items from a
// counter; a block keeps the key tile's K, V and dK / dV accumulators and
// walks its row tiles in the block with a 3-stage cp.async ring of Q / dO
// tiles: S^T, dP^T, dV += P^T dO, dK += dS^T Q, dS^T to shared memory, then
// dQ's contribution dS K into an fp32 staging tile, which thread 0 adds to
// a global fp32 sum with one bulk cp.reduce.async.bulk (the first key tile
// of a row tile copies) once a per-row-tile counter says every higher key
// tile that sees the row tile has added: the sum's order is fixed, the
// last key tile first, so that the diagonal key tiles, which start deepest
// into the rows, never wait.  finish_kernel casts dQ once and adds the row
// blocks' fp32 dK / dV partials in order.

#include "flash_mma.cuh"

#include <algorithm>
#include <atomic>

namespace flash_backward_fold {

using namespace flash_mma;

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int BQ = 64;               // query rows a tile
constexpr int BK = 128;              // keys a tile of the long route
constexpr int STAGES = 3;            // Q / dO row tiles in the long route's ring
constexpr int DSS = BQ + 8;          // row stride of a dS^T tile [key][row], bf16
constexpr float LOG2E = 1.4426950408889634f;

// the long route's shared memory: K and V of the key tile, STAGES x [Q, dO]
// row tiles, the dS^T tile, STAGES x [lse2, delta] (BQ floats each), then
// the fp32 dQ staging tile (BQ x DP)
template <int DP>
constexpr size_t long_smem() {
  return size_t(2) * (2 * BK + STAGES * 2 * BQ) * Tile<DP>::DS + size_t(2) * BK * DSS +
         size_t(4) * STAGES * 2 * BQ + size_t(4) * BQ * DP;
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.global.acquire.gpu.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Spin until *p == want.  Every wait is on an item a running block holds,
// so it ends; should it not (a fault), the block traps after ~2^35 clock
// cycles (~20 s), a launch failure the wrapper raises, rather than hold
// the card.
__device__ __forceinline__ void wait_for(const int* p, int want) {
  const long long t0 = clock64();
#pragma unroll 1
  while (ld_acquire(p) != want) {
    if (clock64() - t0 > (1ll << 35)) __trap();
  }
}

// one more at *p, releasing what this block wrote before its last
// __syncthreads (the fence releases the other threads' writes too)
__device__ __forceinline__ void red_release(int* p) {
  asm volatile("fence.acq_rel.gpu;\nred.relaxed.gpu.global.add.s32 [%0], 1;\n" ::"l"(p)
               : "memory");
}

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

// (a) Row statistics of the long route, one warp a row of the padded row
// order: row r of kv head kvh of batch row b (r < R = Tq G: position
// r / G, head kvh G + r % G) gets lse2 = lse log2 e and delta = sum_d do o
// (lanes over d, a fixed butterfly: the same bits every run); rows R ..
// R_pad - 1 get +inf and 0, so that their p and ds are 0.  Zeroes the
// n_counters counters of long_kernel first.
__global__ void rowstat_kernel(const __nv_bfloat16* __restrict__ o,
                               const __nv_bfloat16* __restrict__ dO,
                               const float* __restrict__ lse, float* __restrict__ lse2,
                               float* __restrict__ delta, int* __restrict__ counters,
                               int64_t n_counters, int64_t n_rows, int Tq, int H, int KV, int D,
                               int G, int R_pad) {
  const int64_t gtid = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (gtid < n_counters) counters[gtid] = 0;
  const int64_t idx = gtid / 32;
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

// Geometry of the long route's work, shared by long_kernel and
// finish_kernel.  Under causal a key at position j is seen by rows of
// positions >= j: key tile kt sees row tiles first_row_tile(kt) on, and row
// tile rt is seen by key tiles 0 .. last_key_tile(rt).  The rows are cut
// into n_blocks row blocks of RB row tiles; an item is one key tile's rows
// in one block.
struct LongGeometry {
  int n_rt, n_kt, G, causal, RB, n_blocks;
  __device__ LongGeometry(int R_pad, int Tk, int G_, int causal_, int splits)
      : n_rt(R_pad / BQ), n_kt((Tk + BK - 1) / BK), G(G_), causal(causal_),
        RB((R_pad / BQ + splits - 1) / splits), n_blocks((R_pad / BQ + RB - 1) / RB) {}
  __device__ int first_row_tile(int kt) const {
    return causal ? min(static_cast<int>((int64_t(kt) * BK * G) / BQ), n_rt) : 0;
  }
  __device__ int last_key_tile(int rt) const {
    return causal ? min(n_kt - 1,
                        static_cast<int>((int64_t(rt + 1) * BQ - 1) / (int64_t(BK) * G)))
                  : n_kt - 1;
  }
  // the first row block that holds rows of key tile kt (n_blocks: none)
  __device__ int first_block(int kt) const {
    const int f = first_row_tile(kt);
    return f >= n_rt ? n_blocks : f / RB;
  }
};

__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// bytes (a multiple of 16) from shared src to global dst, copied or added
// (fp32) by the bulk-copy unit; completion through this thread's bulk group
__device__ __forceinline__ void bulk_to_global(float* dst, const float* src, int bytes,
                                               bool add) {
  if (add)
    asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n"
                 ::"l"(dst), "r"(smem_addr(src)), "r"(bytes) : "memory");
  else
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
                 ::"l"(dst), "r"(smem_addr(src)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// this thread's bulk groups done: their writes made (not only their reads)
__device__ __forceinline__ void bulk_wait_done() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// (b) The long route.  Item i: row block n_blocks - 1 - i / (B KV n_kt)
// (the last first), then batch row and kv head, then key tile (the last
// first), so that the key tile above an item's, whose dQ goes in first,
// was claimed before it.  dq_acc: fp32 (B, KV, R_pad, D), the kernel's
// row order, each row's 16-byte chunks swizzled (chunk c at c ^ (row %
// 8): the staging tile's layout, so that one bulk add moves a row tile and
// the warps' writes to the staging tile meet no bank conflict); counters:
// B KV n_rt row-tile counters (how many key tiles
// have added into that row tile), then the item counter.  splits == 1:
// write bf16 dk / dv (scale dk); else fp32 partials, unscaled, at part +
// block * part_stride (only the blocks that hold the key tile's rows).
template <int DP>
__global__ void __launch_bounds__(THREADS, 1) long_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dO,
    const float* __restrict__ lse2, const float* __restrict__ delta, float* dq_acc,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, float* __restrict__ part_k,
    float* __restrict__ part_v, int* counters, int B, int Tq, int Tk, int H, int KV, int G,
    int causal, int splits, int R_pad, float scale_log2, float scale) {
  using T = Tile<DP>;
  constexpr int D = DP;
  constexpr int NT = DP / 16;       // n-tiles of a warp's half of dQ's dims
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);  // BK x DS
  __nv_bfloat16* Vs = Ks + BK * T::DS;                          // BK x DS
  __nv_bfloat16* QD = Vs + BK * T::DS;                          // [stage][Q, dO] BQ x DS
  __nv_bfloat16* dST = QD + STAGES * 2 * BQ * T::DS;            // BK x DSS
  float* stats = reinterpret_cast<float*>(dST + BK * DSS);      // [stage][lse2, delta] BQ
  float* dQs = stats + STAGES * 2 * BQ;                         // BQ x DP, swizzled
  __shared__ int claimed;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g8 = lane >> 2;
  const int R = Tq * G;
  const LongGeometry geo(R_pad, Tk, G, causal, splits);
  const int n_rt = geo.n_rt, n_kt = geo.n_kt, RB = geo.RB;
  const int per_block = B * KV * n_kt;
  const int n_items = geo.n_blocks * per_block;
  int* claim = counters + int64_t(B) * KV * n_rt;
  const int mq = warp & 3, half = warp >> 2;  // the warp's 16 rows and half of dims in dQ
  const int64_t kv_stride = int64_t(KV) * D;

  for (;;) {
    if (tid == 0) claimed = atomicAdd(claim, 1);
    __syncthreads();
    const int item = claimed;
    __syncthreads();  // every thread read it before the next claim
    if (item >= n_items) break;
    const int block = geo.n_blocks - 1 - item / per_block, rest = item % per_block;
    const int kt = n_kt - 1 - rest % n_kt;
    const int kvh = (rest / n_kt) % KV;
    const int64_t b = rest / (n_kt * KV);
    const int k0 = kt * BK;
    const int lo = max(geo.first_row_tile(kt), block * RB);
    const int hi = min(n_rt, block * RB + RB);
    if (lo >= hi && splits > 1) continue;  // no rows: the finish pass reads no partial here

    const __nv_bfloat16* kh = k + (b * Tk * KV + kvh) * D;
    const __nv_bfloat16* vh = v + (b * Tk * KV + kvh) * D;
    auto key_src = [&](const __nv_bfloat16* head) {
      return [=](int j) -> const __nv_bfloat16* {
        return k0 + j < Tk ? head + (k0 + j) * kv_stride : nullptr;
      };
    };
    stage_rows<DP>(Ks, BK, key_src(kh), kh, D, true, tid, THREADS);
    stage_rows<DP>(Vs, BK, key_src(vh), vh, D, true, tid, THREADS);

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
    if (lo < hi) stage_tile(lo, 0);
    cp_async_commit();  // K, V and the first row tile
    if (lo + 1 < hi) stage_tile(lo + 1, 1);
    cp_async_commit();

    WarpState<DP, 1> dk_acc, dv_acc;  // this warp's 16 keys x D
    dk_acc.init();
    dv_acc.init();
    int* cnt = counters + (b * KV + kvh) * n_rt;
    float* acc_rows = dq_acc + stat0 * D;  // row tile rt: BQ x D floats at rt * BQ * D
    // thread 0 adds a row tile's dQ and, a step later, once the adds are
    // made, lets the next key tile in
    auto release = [&](int rt) {
      if (tid == 0) {
        bulk_wait_done();
        fence_proxy_async_global();
        red_release(cnt + rt);
      }
    };
    // this thread's keys of the tile: 16 warp + g8 + 8 i
    const int key_lo = k0 + 16 * warp + g8;
    for (int rt = lo; rt < hi; ++rt) {
      const int i = rt - lo;
      // refill the stage of row tile rt - 1, which every warp is done with
      if (rt + 2 < hi) stage_tile(rt + 2, (i + 2) % STAGES);
      cp_async_commit();
      cp_async_wait<STAGES - 1>();
      __syncthreads();  // row tile rt landed
      const int buf = i % STAGES;
      const __nv_bfloat16* Qs = QD + buf * 2 * BQ * T::DS;
      const __nv_bfloat16* dOs = Qs + BQ * T::DS;
      const float* st = stats + buf * 2 * BQ;
      // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x the tile's 64 rows
      float s[1][BQ / 8][4], dp[1][BQ / 8][4];
      score_tile<DP, 1, BQ>(s, Ks, 16 * warp, Qs, lane);
      score_tile<DP, 1, BQ>(dp, Vs, 16 * warp, dOs, lane);
      // a row tile needs the mask where its first position is below the
      // tile's last key, or where the tile runs past Tk
      const bool masked = k0 + BK > Tk || (causal && (rt * BQ) / G < k0 + BK - 1);
      uint32_t pa[1][BQ / 8][2], dsa[1][BQ / 8][2];
      probs(s, dp, st, lane, key_lo, rt * BQ, G, Tk, causal != 0, masked, scale_log2, pa, dsa);
      pv_tile<DP, 1, BQ>(dv_acc, pa, dOs, lane);   // dV += P^T dO
      pv_tile<DP, 1, BQ>(dk_acc, dsa, Qs, lane);   // dK += dS^T Q
      store_dst(dST, 16 * warp, dsa, lane);
      if (rt > lo) release(rt - 1);  // and the staging tile is free again
      __syncthreads();  // dS^T whole
      // dQ's contribution of this key tile: rows 16 mq .., dims half D / 2 ..
      float dq[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dq[nt][e] = 0.f;
      ds_k_tile<DP, BK, NT>(dq, dST, 16 * mq, Ks, half * (DP / 2), lane);
      // rows 16 mq + g8 + 8 i2 (row % 8 == g8), dims half D / 2 + 8 nt +
      // 2 (lane % 4): the 16-byte chunk c of a row lies at c ^ (row % 8)
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2) {
        float* row = dQs + (16 * mq + g8 + 8 * i2) * DP + 2 * (lane & 1);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int chunk = half * (DP / 8) + 2 * nt + ((lane & 3) >> 1);
          *reinterpret_cast<float2*>(row + 4 * (chunk ^ g8)) =
              make_float2(dq[nt][2 * i2], dq[nt][2 * i2 + 1]);
        }
      }
      fence_proxy_async_shared();  // the staging tile visible to the bulk-copy unit
      __syncthreads();
      if (tid == 0) {
        // key tiles add into a row tile from the last that sees it down:
        // wait for the ones above this one; the last one copies
        const int last = geo.last_key_tile(rt);
        wait_for(cnt + rt, last - kt);
        fence_proxy_async_global();
        bulk_to_global(acc_rows + int64_t(rt) * BQ * D, dQs, BQ * D * 4, kt != last);
        bulk_commit();
      }
    }
    if (lo < hi) release(hi - 1);
    cp_async_wait<0>();
    __syncthreads();  // K, V, dS^T and the staging tile free

    // keys key_lo + 8 i, dims 8 n + 2 (lane % 4) + {0, 1}
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = key_lo + 8 * i;
      if (key >= Tk) continue;
      const int64_t off = ((b * Tk + key) * KV + kvh) * D;
#pragma unroll
      for (int nt = 0; nt < T::ONT; ++nt) {
        const int d = 8 * nt + 2 * (lane & 3);
        if (splits == 1) {
          *reinterpret_cast<__nv_bfloat162*>(dk + off + d) = __floats2bfloat162_rn(
              scale * dk_acc.o[0][nt][2 * i], scale * dk_acc.o[0][nt][2 * i + 1]);
          *reinterpret_cast<__nv_bfloat162*>(dv + off + d) =
              __floats2bfloat162_rn(dv_acc.o[0][nt][2 * i], dv_acc.o[0][nt][2 * i + 1]);
        } else {
          const int64_t p = block * (int64_t(B) * Tk * KV * D) + off + d;
          *reinterpret_cast<float2*>(part_k + p) =
              make_float2(dk_acc.o[0][nt][2 * i], dk_acc.o[0][nt][2 * i + 1]);
          *reinterpret_cast<float2*>(part_v + p) =
              make_float2(dv_acc.o[0][nt][2 * i], dv_acc.o[0][nt][2 * i + 1]);
        }
      }
    }
  }
}

// (c) dq = bf16(scale dq_acc), gathered from the kernel's row order (the
// 16-byte chunk c of row r at c ^ (r % 8)) into (B, Tq, H, D) (n_q
// elements); where splits > 1 also dk = bf16(scale
// sum_s part_k[s]), dv = bf16(sum_s part_v[s]) over the row blocks that
// hold each key's tile, added in block order (n_kv elements each).  Four
// elements a thread and a step.
__global__ void finish_kernel(const float* __restrict__ dq_acc, __nv_bfloat16* __restrict__ dq,
                              int64_t n_q, const float* __restrict__ part_k,
                              const float* __restrict__ part_v, __nv_bfloat16* __restrict__ dk,
                              __nv_bfloat16* __restrict__ dv, int64_t n_kv, int Tq, int Tk,
                              int H, int KV, int D, int causal, int splits, int R_pad,
                              float scale) {
  const int G = H / KV;
  const LongGeometry geo(R_pad, Tk, G, causal, splits);
  const int64_t nq4 = n_q / 4, nkv4 = splits > 1 ? n_kv / 4 : 0;
  const int64_t n4 = nq4 > nkv4 ? nq4 : nkv4;
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n4;
       i += int64_t(gridDim.x) * blockDim.x) {
    if (i < nq4) {
      const int64_t e = 4 * i, row = e / D;
      const int d = static_cast<int>(e - row * D), h = static_cast<int>(row % H);
      const int64_t bt = row / H, b = bt / Tq;
      const int t = static_cast<int>(bt - b * Tq);
      const int kvh = h / G, r = t * G + (h - kvh * G);
      const int64_t src = ((b * KV + kvh) * R_pad + r) * D + 4 * ((d / 4) ^ (r & 7));
      const float4 a = *reinterpret_cast<const float4*>(dq_acc + src);
      __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(dq + e);
      o[0] = __floats2bfloat162_rn(scale * a.x, scale * a.y);
      o[1] = __floats2bfloat162_rn(scale * a.z, scale * a.w);
    }
    if (i < nkv4) {
      const int key = static_cast<int>((4 * i / (int64_t(KV) * D)) % Tk);
      float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
      for (int s = geo.first_block(key / BK); s < geo.n_blocks; ++s) {
        const float4 a = reinterpret_cast<const float4*>(part_k + s * n_kv)[i];
        const float4 c = reinterpret_cast<const float4*>(part_v + s * n_kv)[i];
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
int launch_long(const void* q, const void* k, const void* v, const void* dO, const float* lse2,
                const float* delta, float* dq_acc, void* dk, void* dv, float* part_k,
                float* part_v, int* counters, int B, int Tq, int Tk, int H, int KV, int causal,
                int splits, float scale_log2, float scale, int device, cudaStream_t st) {
  static std::atomic<uint64_t> attr{0};
  constexpr size_t smem = long_smem<DP>();
  int rc = allow_smem(long_kernel<DP>, smem, device, attr);
  if (rc != 0) return rc;
  const int G = H / KV;
  const int R_pad = (Tq * G + BQ - 1) / BQ * BQ;
  const int n_rt = R_pad / BQ, RB = (n_rt + splits - 1) / splits;
  const int64_t n_items = int64_t((Tk + BK - 1) / BK) * B * KV * ((n_rt + RB - 1) / RB);
  int n_sm = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, long_kernel<DP>, THREADS, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid =
      static_cast<unsigned>(std::max<int64_t>(1, std::min<int64_t>(n_items, int64_t(n_sm) * per_sm)));
  long_kernel<DP><<<grid, THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dO), lse2, delta,
      dq_acc, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), part_k, part_v,
      counters, B, Tq, Tk, H, KV, G, causal, splits, R_pad, scale_log2, scale);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// the long route's shapes: row order and item counts within int
bool long_shape_ok(int B, int Tq, int Tk, int H, int KV, int D, int splits) {
  if (!(B > 0 && Tq > 0 && Tk > 0 && KV > 0 && H % KV == 0 && (D == 64 || D == 128) &&
        splits >= 1))
    return false;
  const int64_t rows = int64_t(Tq) * (H / KV) + BQ;
  const int64_t items = int64_t((Tk + BK - 1) / BK) * B * KV * splits;
  const int64_t counters = int64_t(B) * KV * (rows / BQ + 1) + 1;
  return rows < (int64_t(1) << 31) && items + 65536 < (int64_t(1) << 31) &&
         counters < (int64_t(1) << 31);
}

}  // namespace flash_backward_fold

// All launch on ``stream`` and return cudaGetLastError() as an int (0 =
// success).  q, o and do are contiguous bf16 (B, Tq, H, D), k and v
// contiguous bf16 (B, Tk, KV, D), H % KV == 0; lse is fp32 (B, Tq, H).

// The long route, (a): lse2 = lse log2 e and delta = rowsum(do o) in the
// kernels' row order, fp32 (B, KV, R_pad), R_pad = Tq H / KV rounded up
// to a multiple of 64; and n_counters ints at counters zeroed.
extern "C" int fold_rowstat_launch(const void* o, const void* dO, const void* lse,
                                             void* lse2, void* delta, void* counters,
                                             int64_t n_counters, int B, int Tq, int H, int KV,
                                             int D, int device, void* stream) {
  using namespace flash_backward_fold;
  if (!long_shape_ok(B, Tq, Tq, H, KV, D, 1) || n_counters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rc = set_device(device);
  if (rc != 0) return rc;
  const int G = H / KV;
  const int R_pad = (Tq * G + BQ - 1) / BQ * BQ;
  const int64_t n_rows = int64_t(B) * KV * R_pad;
  constexpr int ROWS_A_BLOCK = 8;  // one warp a row
  const int64_t threads = std::max<int64_t>(32 * n_rows, n_counters);
  rowstat_kernel<<<static_cast<unsigned>((threads + 32 * ROWS_A_BLOCK - 1) / (32 * ROWS_A_BLOCK)),
                   32 * ROWS_A_BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dO),
      static_cast<const float*>(lse), static_cast<float*>(lse2), static_cast<float*>(delta),
      static_cast<int*>(counters), n_counters, n_rows, Tq, H, KV, D, G, R_pad);
  return static_cast<int>(cudaGetLastError());
}

// The long route, (b): dk, dv and dq_acc (fp32 (B, KV, R_pad, D),
// unscaled) over (key tile, row block) items, the rows cut in `splits`
// blocks.  counters: B KV R_pad / 64 + 1 ints, zeroed (by the rowstat
// launch).  splits > 1 writes fp32 partials to part_k / part_v (each
// splits x B x Tk x KV x D) for the finish launch; splits == 1 writes
// dk / dv.  Pointers 16-byte aligned.
extern "C" int fold_long_launch(const void* q, const void* k, const void* v,
                                          const void* dO, const void* lse2, const void* delta,
                                          void* dq_acc, void* dk, void* dv, void* part_k,
                                          void* part_v, void* counters, int B, int Tq, int Tk,
                                          int H, int KV, int D, int causal, int splits,
                                          float scale, int device, void* stream) {
  using namespace flash_backward_fold;
  if (!long_shape_ok(B, Tq, Tk, H, KV, D, splits) ||
      (splits > 1 && (part_k == nullptr || part_v == nullptr)) ||
      !(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dO) && aligned16(lse2) &&
        aligned16(delta) && aligned16(dq_acc)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rc = set_device(device);
  if (rc != 0) return rc;
  auto* pk = splits > 1 ? static_cast<float*>(part_k) : nullptr;
  auto* pv = splits > 1 ? static_cast<float*>(part_v) : nullptr;
  const auto* l2 = static_cast<const float*>(lse2);
  const auto* dl = static_cast<const float*>(delta);
  auto* acc = static_cast<float*>(dq_acc);
  auto* cnt = static_cast<int*>(counters);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale_log2 = scale * LOG2E;
  return D == 64 ? launch_long<64>(q, k, v, dO, l2, dl, acc, dk, dv, pk, pv, cnt, B, Tq, Tk, H, KV,
                                   causal, splits, scale_log2, scale, device, st)
                 : launch_long<128>(q, k, v, dO, l2, dl, acc, dk, dv, pk, pv, cnt, B, Tq, Tk, H,
                                    KV, causal, splits, scale_log2, scale, device, st);
}

// The long route, (c): dq = bf16(scale dq_acc) in (B, Tq, H, D) from
// the kernels' row order; where splits > 1 the row blocks' partials added
// in order, dk = bf16(scale sum), dv = bf16(sum).  The shapes and splits
// of the long launch.
extern "C" int fold_finish_launch(const void* dq_acc, void* dq, const void* part_k,
                                            const void* part_v, void* dk, void* dv, int B,
                                            int Tq, int Tk, int H, int KV, int D, int causal,
                                            int splits, float scale, int device, void* stream) {
  using namespace flash_backward_fold;
  if (!long_shape_ok(B, Tq, Tk, H, KV, D, splits) ||
      (splits > 1 && (part_k == nullptr || part_v == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rc = set_device(device);
  if (rc != 0) return rc;
  const int64_t n_q = int64_t(B) * Tq * H * D, n_kv = int64_t(B) * Tk * KV * D;
  const int R_pad = (Tq * (H / KV) + BQ - 1) / BQ * BQ;
  const int64_t n4 = std::max<int64_t>(n_q, splits > 1 ? n_kv : 0) / 4;
  const unsigned blocks = static_cast<unsigned>(std::min<int64_t>((n4 + 255) / 256, 4096));
  finish_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dq_acc), static_cast<__nv_bfloat16*>(dq), n_q,
      static_cast<const float*>(part_k), static_cast<const float*>(part_v),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), n_kv, Tq, Tk, H, KV, D,
      causal, splits, R_pad, scale);
  return static_cast<int>(cudaGetLastError());
}
