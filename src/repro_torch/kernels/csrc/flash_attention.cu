// K4, float32 route: GQA flash-attention forward with online softmax on
// the CUDA cores, for sm_90a.  The wrapper (repro_torch/kernels/
// flash_attention.py) sends every float32 call here; bfloat16 calls go to
// the tensor-core kernels of flash_prefill.cu (Tq > 1) and
// flash_decode.cu (Tq == 1).  The float32 route stays on the CUDA cores
// because TF32 tensor cores cannot hold the float32 tolerance (2e-5) that
// the tests and chip_smoke.py hold K4 to; the bf16 main path never
// launches it.
//
// Replaces: src/repro/kernels/flash_attention.py::_kernel (the Pallas TPU
// kernel launched by flash_attention_pallas), extended by the q_offset and
// kv_length arguments of the JAX package's serving path
// (src/repro/models/layers.py::_flash_impl), so that one kernel serves the
// LM's prefill (Tq = T, causal, over the KV cache) and decode (Tq = 1,
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
// in chunks of 65,535 rows (CUDA's cap on grid.z).
//
// What bounds it on the H100: prefill is bound by operations (float32 at
// 67 TFLOP/s outside the tensor cores), decode by bytes.  What it does:
//  * one block per (q-tile, kv head, batch) takes the G query heads of its
//    group, 64 query rows in all (64 / G positions), so each K/V tile is
//    read once per group and decode's bytes are read once per kv head;
//  * K/V tiles of 32 keys are staged in shared memory, Q once;
//  * each thread holds 4 rows x 2 keys of scores and 4 rows x DP/16
//    columns of the accumulator in registers; the online softmax state
//    (m, l) of a row lives in the 16 lanes that share it, reduced with
//    shuffles;
//  * the key loop stops at kv_length and, under causal, at the block's
//    last query position: tiles above the diagonal are skipped.
// The TPU kernel's grid walked the kv blocks in order per output block;
// here the loop over key tiles lives inside the block.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace flash_attention {

constexpr int THREADS = 256;
constexpr int ROWS = 64;              // query rows (position x head of the group) per block
constexpr int BKV = 32;               // keys per tile
constexpr int RPT = 4;                // rows per thread  (16 row groups x 4 = ROWS)
constexpr int KPT = BKV / 16;         // keys per thread  (16 lanes x 2 = BKV)
constexpr int PS = BKV + 4;           // row stride of the P tile
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int MAX_GRID_Z = 65535;     // batch rows per launch

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL_MASK, x, off));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(FULL_MASK, x, off);
  return x;
}

__device__ __forceinline__ float4 fma4(float a, float4 b, float4 c) {
  return make_float4(fmaf(a, b.x, c.x), fmaf(a, b.y, c.y), fmaf(a, b.z, c.z),
                     fmaf(a, b.w, c.w));
}

template <int DP>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((ROWS + BKV) * (DP + 4) + BKV * DP + ROWS * PS);
}

// DP: head_dim padded to 64 or 128 (columns past D are zero).
template <int DP>
__global__ void __launch_bounds__(THREADS, 2) flash_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, float* __restrict__ lse, const int32_t* __restrict__ kv_length,
    int Tq, int Tk, int H, int KV, int D, int G, int bq, int q_offset, int causal,
    float scale) {
  constexpr int QS = DP + 4;          // row stride of the Q and K tiles
  constexpr int NC = DP / 64;         // float4 accumulator columns per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // ROWS x QS
  float* Ks = Qs + ROWS * QS;                    // BKV x QS
  float* Vs = Ks + BKV * QS;                     // BKV x DP
  float* Ps = Vs + BKV * DP;                     // ROWS x PS

  const int tid = threadIdx.x;
  const int tx = tid % 16;            // key / column group
  const int ty = tid / 16;            // row group
  const int kvh = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int t0 = blockIdx.x * bq;     // first query position of the block
  const int rows = bq * G;            // rows in use (<= ROWS)

  int kv_len = kv_length != nullptr ? kv_length[b] : Tk;
  kv_len = max(0, min(kv_len, Tk));
  int n_keys = kv_len;
  if (causal) n_keys = max(0, min(n_keys, q_offset + min(t0 + bq, Tq)));

  for (int e = tid; e < ROWS * DP; e += THREADS) {
    const int r = e / DP, d = e % DP;
    float val = 0.f;
    if (r < rows && d < D) {
      const int t = t0 + r / G;
      if (t < Tq) {
        const int h = kvh * G + r % G;
        val = q[((b * Tq + t) * H + h) * D + d];
      }
    }
    Qs[r * QS + d] = val;
  }

  int qpos[RPT];
  float m[RPT], l[RPT];
  float4 acc[RPT][NC];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    qpos[i] = q_offset + t0 + (ty * RPT + i) / G;
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int dq4 = (D + 3) / 4;

  for (int k0 = 0; k0 < n_keys; k0 += BKV) {
    __syncthreads();  // the previous tile's K, V and P are consumed
#pragma unroll
    for (int e = tid; e < BKV * DP; e += THREADS) {
      const int j = e / DP, d = e % DP;
      const int key = k0 + j;
      float kf = 0.f, vf = 0.f;
      if (key < n_keys && d < D) {
        const int64_t off = ((b * Tk + key) * KV + kvh) * D + d;
        kf = k[off];
        vf = v[off];
      }
      Ks[j * QS + d] = kf;
      Vs[j * DP + d] = vf;
    }
    __syncthreads();

    float s[RPT][KPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[i][j] = 0.f;
    for (int d4 = 0; d4 < dq4; ++d4) {
      float4 kk[KPT];
#pragma unroll
      for (int j = 0; j < KPT; ++j)
        kk[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * QS + 4 * d4);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float4 qq = *reinterpret_cast<const float4*>(Qs + (ty * RPT + i) * QS + 4 * d4);
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
        const bool ok = key < n_keys && (!causal || key <= qpos[i]);
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
        Ps[(ty * RPT + i) * PS + tx + 16 * j] = p;
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
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < BKV; kk += 4) {
      float4 vv[4][NC];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int c = 0; c < NC; ++c)
          vv[u][c] = *reinterpret_cast<const float4*>(Vs + (kk + u) * DP + 4 * tx + 64 * c);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float4 pp = *reinterpret_cast<const float4*>(Ps + (ty * RPT + i) * PS + kk);
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
    const int r = ty * RPT + i;
    const int t = t0 + r / G;
    if (r >= rows || t >= Tq) continue;
    const float den = fmaxf(l[i], 1e-20f);
    const int64_t row = (b * Tq + t) * H + kvh * G + r % G;
    if (lse != nullptr && tx == 0) lse[row] = l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
    float* out = o + row * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float vals[4] = {acc[i][c].x, acc[i][c].y, acc[i][c].z, acc[i][c].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * tx + 64 * c + e;
        if (d < D) out[d] = vals[e] / den;
      }
    }
  }
}

template <int DP>
int launch(const float* q, const float* k, const float* v, float* o, float* lse,
           const int32_t* kv_length, int B, int Tq, int Tk, int H, int KV, int D, int q_offset,
           int causal, float scale, int device, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<DP>();
  // The shared-memory limit is a per-device attribute of the kernel: set
  // it at the first launch on each device, not at every launch.
  static std::atomic<uint64_t> attr_set{0};
  const uint64_t bit = device < 64 ? uint64_t{1} << device : 0;
  if (!(attr_set.load() & bit)) {
    const cudaError_t attr = cudaFuncSetAttribute(
        flash_attention_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (attr != cudaSuccess) return static_cast<int>(attr);
    attr_set.fetch_or(bit);
  }
  const int G = H / KV;
  const int bq = ROWS / G;
  for (int64_t b0 = 0; b0 < B; b0 += MAX_GRID_Z) {
    const int nb = static_cast<int>(B - b0 < MAX_GRID_Z ? B - b0 : MAX_GRID_Z);
    const dim3 grid((Tq + bq - 1) / bq, KV, nb);
    flash_attention_kernel<DP><<<grid, THREADS, smem, st>>>(
        q + b0 * Tq * H * D, k + b0 * Tk * KV * D, v + b0 * Tk * KV * D, o + b0 * Tq * H * D,
        lse != nullptr ? lse + b0 * Tq * H : nullptr,
        kv_length != nullptr ? kv_length + b0 : nullptr, Tq, Tk, H, KV, D, G, bq, q_offset,
        causal, scale);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace flash_attention

// Launch on ``stream``; returns cudaGetLastError() as an int (0 = success).
// q and o are contiguous float32 (B, Tq, H, D), k and v contiguous float32
// (B, Tk, KV, D); lse is a device array of B * Tq * H float32, or null (not
// written); kv_length is a device array of B int32 or null (every key
// valid).  Needs H % KV == 0, H / KV <= 64 and 0 < D <= 128.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      void* lse, const int32_t* kv_length, int B, int Tq,
                                      int Tk, int H, int KV, int D, int q_offset, int causal,
                                      float scale, int device, void* stream) {
  using namespace flash_attention;
  if (KV <= 0 || H % KV != 0 || H / KV > ROWS || D <= 0 || D > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || Tq <= 0) return 0;
  int current = -1;
  if (cudaGetDevice(&current) != cudaSuccess || current != device) {
    const cudaError_t set = cudaSetDevice(device);
    if (set != cudaSuccess) return static_cast<int>(set);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(o);
  auto* lf = static_cast<float*>(lse);
  return D <= 64 ? launch<64>(qf, kf, vf, of, lf, kv_length, B, Tq, Tk, H, KV, D, q_offset,
                              causal, scale, device, st)
                 : launch<128>(qf, kf, vf, of, lf, kv_length, B, Tq, Tk, H, KV, D, q_offset,
                               causal, scale, device, st);
}
