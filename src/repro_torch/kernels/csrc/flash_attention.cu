// K4, float32 route: GQA flash-attention forward with online softmax on
// the CUDA cores (FFMA), for sm_90a.  The wrapper (repro_torch/kernels/
// flash_attention.py) sends every float32 call here; bfloat16 calls go to
// the tensor-core kernels of flash_prefill.cu (Tq > 1) and
// flash_decode.cu (Tq == 1).  The float32 route stays on the CUDA cores:
// plain TF32 tensor cores cannot hold the float32 tolerance (2e-5) that
// the tests and chip_smoke.py hold K4 to, and a 3xTF32 split (three
// mma.sync.m16n8k8.tf32 products a tile) is not built: at the training
// shape that reaches this kernel (lm-100m) the bound is ~1 us and the time
// goes to latency and to filling the card, not to the multiply rate.
//
// Replaces: src/repro/kernels/flash_attention.py::_kernel (the Pallas TPU
// kernel launched by flash_attention_pallas), extended by the q_offset and
// kv_length arguments of the JAX package's serving path
// (src/repro/models/layers.py::_flash_impl), so that one kernel serves
// prefill (Tq = T, causal, over a KV cache) and decode (Tq = 1,
// kv_length = cache_len + 1, not causal).
//
// Computes, for q (B, Tq, H, D), k and v (B, Tk, KV, D), G = H / KV:
//   s[b, t, h, j] = (q[b, t, h] . k[b, j, h / G]) * scale
//   masked where j >= kv_length[b], or (causal) j > q_offset + t
//   out[b, t, h]  = sum_j softmax(s)[j] * v[b, j, h / G]
// in float32 throughout, the output acc / max(l, 1e-20).  A row whose
// every key is masked gives 0.  Keys at or past kv_length are never read,
// so a ragged key tail needs no padding.  On request (the training
// forward) it also writes each row's log-sum-exp lse = m + ln(l), fp32,
// +inf for a row whose every key is masked.  The launcher walks the batch
// in chunks of 65,535 rows (CUDA's cap on grid.y).
//
// What bounds it on the H100: prefill is bound by operations (float32 at
// 67 TFLOP/s outside the tensor cores), decode by bytes; at lm-100m's
// training shape (q (4, 128, 8, 64), kv 4 heads, causal: 67.6 MFLOP, 1 us)
// by neither: by how many blocks fill the card and by how many global
// round trips a block waits for.  What the design does about it:
//  * a block of 4 warps takes RB query rows (the G query heads of one kv
//    head at RB / G positions), RB = 64, 32 or 16, chosen by the wrapper
//    (flash_attention.f32_block_rows) as the most rows whose grid still
//    gives two blocks an SM, else the fewest: at lm-100m's shape 16 rows,
//    8 positions, 256 blocks (the 64-row tile gave 64 blocks on 132 SMs);
//  * a warp owns RB / 4 rows: its 32 lanes are two row groups of 16
//    lanes, each lane holding RB / 8 rows x 4 keys of scores and
//    RB / 8 rows x DP / 16 output columns; a row's softmax state (m, l)
//    lives in the 16 lanes that share it, reduced with shuffles, and its
//    P row goes through the warp's own rows of shared memory, so P needs
//    only __syncwarp;
//  * K/V tiles of 64 keys (the longest block at lm-100m's shape walks
//    two) are staged with cp.async, 16 bytes a copy where D % 4 == 0 and
//    the operands are 16-byte aligned (8 or 4 bytes otherwise), double
//    buffered: tile j + 1 is in flight while tile j is multiplied, behind
//    one __syncthreads a tile; Q is staged once, with tile 0;
//  * the key loop stops at kv_length and, under causal, at the block's
//    last query position; a warp skips the tiles past its own last
//    position, and only tiles that reach past its first position (or past
//    kv_length) apply a mask;
//  * blocks are launched longest first (the last query tiles of a causal
//    prefill walk the most keys).
// The TPU kernel's grid walked the kv blocks in order per output block;
// here the loop over key tiles lives inside the block.

#include "flash_f32.cuh"

#include <atomic>

namespace flash_attention {

using namespace flash_f32;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BKV = 64;               // keys per tile
constexpr int KPT = BKV / 16;         // keys per lane  (16 lanes x 4 = BKV)
constexpr int PS = BKV + 4;           // row stride of the P tile
constexpr int MAX_GRID_Y = 65535;     // batch rows per launch

// DP: head_dim padded to 64 or 128 (columns past D are zero); RB: query
// rows a block.
template <int DP, int RB>
struct Layout {
  static constexpr int QS = DP + 4;          // row stride of the Q and K tiles
  static constexpr int RW = RB / WARPS;      // rows a warp
  static constexpr int RPT = RW / 2;         // rows a lane (two row groups a warp)
  static constexpr int NC = DP / 64;         // float4 output columns a lane
  static constexpr size_t SMEM =
      sizeof(float) * (size_t(RB) * QS + 2 * BKV * (QS + DP) + size_t(RB) * PS);
};

template <int DP, int RB>
__global__ void __launch_bounds__(THREADS, 2) flash_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, float* __restrict__ lse, const int32_t* __restrict__ kv_length,
    int Tq, int Tk, int H, int KV, int D, int G, int bq, int n_qtiles, int q_offset,
    int causal, int vw, float scale) {
  using L = Layout<DP, RB>;
  constexpr int QS = L::QS, RPT = L::RPT, NC = L::NC;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // RB x QS
  float* Ks = Qs + RB * QS;                      // [stage] BKV x QS
  float* Vs = Ks + 2 * BKV * QS;                 // [stage] BKV x DP
  float* Ps = Vs + 2 * BKV * DP;                 // RB x PS

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = lane & 15;           // key / column group
  // longest first: block 0 takes the last query tile of kv head 0
  const int qtile = n_qtiles - 1 - static_cast<int>(blockIdx.x) / KV;
  const int kvh = static_cast<int>(blockIdx.x) % KV;
  const int64_t b = blockIdx.y;
  const int t0 = qtile * bq;          // first query position of the block
  const int rows = bq * G;            // rows in use (<= RB)
  const int wrow0 = warp * L::RW;     // this warp's first row
  const int row0 = wrow0 + (lane >> 4) * RPT;  // this lane's first row

  int kv_len = kv_length != nullptr ? kv_length[b] : Tk;
  kv_len = max(0, min(kv_len, Tk));
  int n_keys = kv_len;
  if (causal) n_keys = max(0, min(n_keys, q_offset + min(t0 + bq, Tq)));
  const int n_tiles = (n_keys + BKV - 1) / BKV;
  // the warp's first query position, and the keys its rows can see
  const int first_q = q_offset + t0 + wrow0 / G;
  int warp_keys = n_keys;
  if (causal) warp_keys = min(warp_keys, q_offset + min(t0 + (wrow0 + L::RW - 1) / G + 1, Tq));

  const int64_t key_stride = int64_t(KV) * D;
  const float* kh = k + (b * Tk * KV + kvh) * D;  // key 0 of this kv head
  const float* vh = v + (b * Tk * KV + kvh) * D;
  auto stage_kv = [&](int tile) {
    const int k0 = tile * BKV, st = tile & 1;
    auto key_src = [&](const float* head) {
      return [=](int j) { return k0 + j < n_keys ? head + (k0 + j) * key_stride : nullptr; };
    };
    stage_rows<DP, THREADS>(Ks + st * BKV * QS, QS, BKV, key_src(kh), kh, D, vw, tid);
    stage_rows<DP, THREADS>(Vs + st * BKV * DP, DP, BKV, key_src(vh), vh, D, vw, tid);
  };
  if (n_tiles > 0) {
    if (D < DP) {  // never written by the copies; read by the dot products
      zero_columns<DP, THREADS>(Qs, QS, RB, D, tid);
      zero_columns<DP, THREADS>(Ks, QS, 2 * BKV, D, tid);
      zero_columns<DP, THREADS>(Vs, DP, 2 * BKV, D, tid);
    }
    // Q: row r is position t0 + r / G, head kvh * G + r % G; zero past the
    // block's rows and past Tq.  One copy group with K/V tile 0.
    stage_rows<DP, THREADS>(Qs, QS, RB, [&](int r) -> const float* {
      const int t = t0 + r / G;
      return r < rows && t < Tq ? q + ((b * Tq + t) * H + kvh * G + r % G) * D : nullptr;
    }, q, D, vw, tid);
    stage_kv(0);
    cp_async_commit();
  }

  int qpos[RPT];
  float m[RPT], l[RPT];
  float4 acc[RPT][NC];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    qpos[i] = q_offset + t0 + (row0 + i) / G;
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int dq4 = (D + 3) / 4;
  float* Pw = Ps + row0 * PS;         // this lane's P rows

  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait_all();
    __syncthreads();  // tile `tile` (and Q) landed; every warp is done with tile - 1
    if (tile + 1 < n_tiles) {
      stage_kv(tile + 1);  // into the stage tile - 1 used
      cp_async_commit();
    }
    const int k0 = tile * BKV;
    if (k0 >= warp_keys) continue;    // past this warp's last query position
    const float* Kt = Ks + (tile & 1) * BKV * QS;
    const float* Vt = Vs + (tile & 1) * BKV * DP;
    const bool masked = k0 + BKV > kv_len || (causal && k0 + BKV - 1 > first_q);

    float s[RPT][KPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d4 = 0; d4 < dq4; ++d4) {
      float4 kk[KPT];
#pragma unroll
      for (int j = 0; j < KPT; ++j)
        kk[j] = *reinterpret_cast<const float4*>(Kt + (tx + 16 * j) * QS + 4 * d4);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float4 qq = *reinterpret_cast<const float4*>(Qs + (row0 + i) * QS + 4 * d4);
#pragma unroll
        for (int j = 0; j < KPT; ++j) {
          s[i][j] = fmaf(qq.x, kk[j].x, s[i][j]);
          s[i][j] = fmaf(qq.y, kk[j].y, s[i][j]);
          s[i][j] = fmaf(qq.z, kk[j].z, s[i][j]);
          s[i][j] = fmaf(qq.w, kk[j].w, s[i][j]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      float tile_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int key = k0 + tx + 16 * j;
        const bool ok = !masked || (key < kv_len && (!causal || key <= qpos[i]));
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        tile_max = fmaxf(tile_max, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(tile_max));
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = m[i] == -INFINITY ? 0.f : expf(m[i] - m_safe);
      float p_sum = 0.f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const float p = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_safe);
        p_sum += p;
        Pw[i * PS + tx + 16 * j] = p;
      }
      l[i] = l[i] * alpha + row_sum16(p_sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        acc[i][c].x *= alpha;
        acc[i][c].y *= alpha;
        acc[i][c].z *= alpha;
        acc[i][c].w *= alpha;
      }
    }
    __syncwarp();  // the warp's P rows are written

#pragma unroll 2
    for (int kk = 0; kk < BKV; kk += 4) {
      float4 vv[4][NC];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int c = 0; c < NC; ++c)
          vv[u][c] = *reinterpret_cast<const float4*>(Vt + (kk + u) * DP + 4 * tx + 64 * c);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float4 pp = *reinterpret_cast<const float4*>(Pw + i * PS + kk);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          acc[i][c] = fma4(pp.x, vv[0][c], acc[i][c]);
          acc[i][c] = fma4(pp.y, vv[1][c], acc[i][c]);
          acc[i][c] = fma4(pp.z, vv[2][c], acc[i][c]);
          acc[i][c] = fma4(pp.w, vv[3][c], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = row0 + i;
    const int t = t0 + r / G;
    if (r >= rows || t >= Tq) continue;
    const float den = fmaxf(l[i], 1e-20f);
    const int64_t row = (b * Tq + t) * H + kvh * G + r % G;
    if (lse != nullptr && tx == 0) lse[row] = l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
    float* out = o + row * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = 4 * tx + 64 * c;
      if (d >= D) continue;
      const float4 x = make_float4(acc[i][c].x / den, acc[i][c].y / den, acc[i][c].z / den,
                                   acc[i][c].w / den);
      if (vw == 4) {  // D % 4 == 0 and o 16-byte aligned
        *reinterpret_cast<float4*>(out + d) = x;
      } else {
        const float vals[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (d + e < D) out[d + e] = vals[e];
      }
    }
  }
}

template <int DP, int RB>
int launch(const float* q, const float* k, const float* v, float* o, float* lse,
           const int32_t* kv_length, int B, int Tq, int Tk, int H, int KV, int D, int q_offset,
           int causal, int vw, float scale, int device, cudaStream_t st) {
  constexpr size_t smem = Layout<DP, RB>::SMEM;
  // The shared-memory limit is a per-device attribute of the kernel: set
  // it at the first launch on each device, not at every launch.
  static std::atomic<uint64_t> attr_set{0};
  const uint64_t bit = device < 64 ? uint64_t{1} << device : 0;
  if (!(attr_set.load() & bit)) {
    const cudaError_t attr = cudaFuncSetAttribute(
        flash_attention_kernel<DP, RB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (attr != cudaSuccess) return static_cast<int>(attr);
    attr_set.fetch_or(bit);
  }
  const int G = H / KV;
  const int bq = RB / G;
  const int n_qtiles = (Tq + bq - 1) / bq;
  for (int64_t b0 = 0; b0 < B; b0 += MAX_GRID_Y) {
    const int nb = static_cast<int>(B - b0 < MAX_GRID_Y ? B - b0 : MAX_GRID_Y);
    const dim3 grid(n_qtiles * KV, nb);
    flash_attention_kernel<DP, RB><<<grid, THREADS, smem, st>>>(
        q + b0 * Tq * H * D, k + b0 * Tk * KV * D, v + b0 * Tk * KV * D, o + b0 * Tq * H * D,
        lse != nullptr ? lse + b0 * Tq * H : nullptr,
        kv_length != nullptr ? kv_length + b0 : nullptr, Tq, Tk, H, KV, D, G, bq, n_qtiles,
        q_offset, causal, vw, scale);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

template <int DP>
int launch_rows(int rows, const float* q, const float* k, const float* v, float* o, float* lse,
                const int32_t* kv_length, int B, int Tq, int Tk, int H, int KV, int D,
                int q_offset, int causal, int vw, float scale, int device, cudaStream_t st) {
  switch (rows) {
    case 16:
      return launch<DP, 16>(q, k, v, o, lse, kv_length, B, Tq, Tk, H, KV, D, q_offset, causal,
                            vw, scale, device, st);
    case 32:
      return launch<DP, 32>(q, k, v, o, lse, kv_length, B, Tq, Tk, H, KV, D, q_offset, causal,
                            vw, scale, device, st);
    default:
      return launch<DP, 64>(q, k, v, o, lse, kv_length, B, Tq, Tk, H, KV, D, q_offset, causal,
                            vw, scale, device, st);
  }
}

}  // namespace flash_attention

// Launch on ``stream``; returns cudaGetLastError() as an int (0 = success).
// q and o are contiguous float32 (B, Tq, H, D), k and v contiguous float32
// (B, Tk, KV, D); lse is a device array of B * Tq * H float32, or null (not
// written); kv_length is a device array of B int32 or null (every key
// valid).  rows (16, 32 or 64) is the query rows a block takes, at least
// H / KV.  Needs H % KV == 0 and 0 < D <= 128.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      void* lse, const int32_t* kv_length, int B, int Tq,
                                      int Tk, int H, int KV, int D, int q_offset, int causal,
                                      int rows, float scale, int device, void* stream) {
  using namespace flash_attention;
  if (KV <= 0 || H % KV != 0 || D <= 0 || D > 128 ||
      (rows != 16 && rows != 32 && rows != 64) || H / KV > rows)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || Tq <= 0) return 0;
  int current = -1;
  if (cudaGetDevice(&current) != cudaSuccess || current != device) {
    const cudaError_t set = cudaSetDevice(device);
    if (set != cudaSuccess) return static_cast<int>(set);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the widest copy the row length and every operand's alignment allow
  const int vw = copy_width(D, reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                                   reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o));
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(o);
  auto* lf = static_cast<float*>(lse);
  return D <= 64 ? launch_rows<64>(rows, qf, kf, vf, of, lf, kv_length, B, Tq, Tk, H, KV, D,
                                   q_offset, causal, vw, scale, device, st)
                 : launch_rows<128>(rows, qf, kf, vf, of, lf, kv_length, B, Tq, Tk, H, KV, D,
                                    q_offset, causal, vw, scale, device, st);
}
