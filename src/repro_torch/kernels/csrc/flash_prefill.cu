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
// gives 0.  Keys at or past kv_length are never read.
//
// What bounds it on the H100: at glm4-9b's 4096-token prefill the causal
// half is ~137 GFLOP per layer against ~6 MB of q/k/v/out, so operations
// bound it (0.139 ms at 989 TFLOP/s bf16).  What the design does about it
// (FlashAttention-2's structure):
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
//  * two blocks share an SM (104 KB of shared memory each);
//  * K/V tiles of 64 keys are staged as bf16 with 16-byte cp.async
//    copies, double-buffered: tile j + 1 is in flight while tile j is
//    multiplied;
//  * the key loop ends at the block's last query position, and only the
//    tiles that reach past the block's first query position (or past
//    kv_length) apply a mask;
//  * blocks are launched longest first (the last query tiles of a causal
//    prefill have the most keys), so the tail of the grid is short work.
// Not yet: wgmma and TMA (FlashAttention-3's shape), a persistent grid.

#include "flash_mma.cuh"

#include <atomic>

namespace flash_prefill {

using namespace flash_mma;

constexpr int WARPS = 4;
constexpr int MT = 2;                 // m-tiles of 16 rows per warp
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS = 16 * MT * WARPS; // query rows (position x head of the group) per block

template <int DP>
constexpr size_t smem_bytes() {
  return size_t(2) * (ROWS + 4 * BKV) * Tile<DP>::DS;  // Q, then K and V x 2 stages
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 2) flash_prefill_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    const int32_t* __restrict__ kv_length, int Tq, int Tk, int H, int KV, int D, int G,
    int bq, int n_qtiles, int q_offset, int causal, int vec, float scale_log2) {
  using T = Tile<DP>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);  // ROWS x DS
  __nv_bfloat16* KVs = Qs + ROWS * T::DS;                      // [stage][K, V] BKV x DS

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // longest first: block 0 takes the last query tile of kv head 0
  const int qtile = n_qtiles - 1 - static_cast<int>(blockIdx.x) / KV;
  const int kvh = static_cast<int>(blockIdx.x) % KV;
  const int64_t b = blockIdx.y;
  const int t0 = qtile * bq;
  const int rows = bq * G;

  int kv_len = kv_length != nullptr ? kv_length[b] : Tk;
  kv_len = max(0, min(kv_len, Tk));
  int n_keys = kv_len;
  if (causal) n_keys = max(0, min(n_keys, q_offset + min(t0 + bq, Tq)));
  const int n_tiles = (n_keys + BKV - 1) / BKV;

  const int64_t row_stride = int64_t(KV) * D;
  const __nv_bfloat16* kh = k + (b * Tk * KV + kvh) * D;
  const __nv_bfloat16* vh = v + (b * Tk * KV + kvh) * D;
  auto stage = [&](int tile) {
    __nv_bfloat16* Ks = KVs + (tile & 1) * 2 * BKV * T::DS;
    const int k0 = tile * BKV;
    auto key_src = [&](const __nv_bfloat16* head) {
      return [=](int j) { return k0 + j < kv_len ? head + (k0 + j) * row_stride : nullptr; };
    };
    stage_rows<DP>(Ks, BKV, key_src(kh), kh, D, vec, tid, THREADS);
    stage_rows<DP>(Ks + BKV * T::DS, BKV, key_src(vh), vh, D, vec, tid, THREADS);
  };
  if (n_tiles > 0) {
    // Q: row r is position t0 + r / G, head kvh * G + r % G; zero past the
    // block's rows and past Tq.  One copy group with K/V tile 0.
    stage_rows<DP>(Qs, ROWS, [&](int r) -> const __nv_bfloat16* {
      const int t = t0 + r / G;
      return r < rows && t < Tq ? q + ((b * Tq + t) * H + kvh * G + r % G) * D : nullptr;
    }, q, D, vec, tid, THREADS);
    if (vec && D < DP) {
      zero_pad_columns<DP>(Qs, ROWS, D, tid, THREADS);
      zero_pad_columns<DP>(KVs, 4 * BKV, D, tid, THREADS);
    }
    stage(0);
    cp_async_commit();
  }

  const int row0 = 16 * MT * warp;    // this warp's first row
  const int g = lane >> 2;
  int qpos[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) qpos[mt][i] = q_offset + t0 + (row0 + 16 * mt + g + 8 * i) / G;
  const int first_q = q_offset + t0;

  WarpState<DP, MT> st;
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
    const int k0 = tile * BKV;
    const bool masked = k0 + BKV > kv_len || (causal && k0 + BKV - 1 > first_q);
    const __nv_bfloat16* Ks = KVs + (tile & 1) * 2 * BKV * T::DS;
    float s[MT][BKV / 8][4], mx[MT][2];
    uint32_t pa[MT][BKV / 8][2];
    score_tile<DP, MT, BKV>(s, Qs, row0, Ks, lane);
    mask_max<MT, BKV>(s, mx, lane, scale_log2, masked, k0, kv_len, causal != 0, qpos);
    softmax_update<DP, MT, BKV>(st, s, mx, scale_log2, pa);
    pv_tile<DP, MT, BKV>(st, pa, Ks + BKV * T::DS, lane);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // out = acc / max(l, 1e-20), rows g and g + 8 of each of this warp's m-tiles
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row0 + 16 * mt + g + 8 * i;
      const float den = fmaxf(st.row_sum(mt, i), 1e-20f);
      const int t = t0 + r / G;
      if (r >= rows || t >= Tq) continue;
      __nv_bfloat16* out = o + ((b * Tq + t) * H + kvh * G + r % G) * D;
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

template <int DP>
int launch(const void* q, const void* k, const void* v, void* o, const int32_t* kv_length,
           int B, int Tq, int Tk, int H, int KV, int D, int q_offset, int causal, bool vec,
           float scale_log2, int device, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<DP>();
  // The shared-memory limit is a per-device attribute of the kernel: set
  // it at the first launch on each device, not at every launch.
  static std::atomic<uint64_t> attr_set{0};
  const uint64_t bit = device < 64 ? uint64_t{1} << device : 0;
  if (!(attr_set.load() & bit)) {
    const cudaError_t attr =
        cudaFuncSetAttribute(flash_prefill_kernel<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (attr != cudaSuccess) return static_cast<int>(attr);
    attr_set.fetch_or(bit);
  }
  const int G = H / KV;
  const int bq = ROWS / G;
  const int n_qtiles = (Tq + bq - 1) / bq;
  const dim3 grid(n_qtiles * KV, B);
  flash_prefill_kernel<DP><<<grid, THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), kv_length, Tq, Tk,
      H, KV, D, G, bq, n_qtiles, q_offset, causal, vec ? 1 : 0, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace flash_prefill

// Launch on ``stream``; returns cudaGetLastError() as an int (0 = success).
// q and o are contiguous bf16 (B, Tq, H, D), k and v contiguous bf16
// (B, Tk, KV, D); kv_length is a device array of B int32 or null (every
// key valid).  Needs H % KV == 0, H / KV <= 128 and 0 < D <= 128.
// scale_log2 is the softmax scale times log2(e).
extern "C" int flash_prefill_launch(const void* q, const void* k, const void* v, void* o,
                                    const int32_t* kv_length, int B, int Tq, int Tk, int H,
                                    int KV, int D, int q_offset, int causal, float scale_log2,
                                    int device, void* stream) {
  using namespace flash_prefill;
  if (KV <= 0 || H % KV != 0 || H / KV > ROWS || D <= 0 || D > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || Tq <= 0) return 0;
  int current = -1;
  if (cudaGetDevice(&current) != cudaSuccess || current != device) {
    const cudaError_t set = cudaSetDevice(device);
    if (set != cudaSuccess) return static_cast<int>(set);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = D % 8 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;
  return D <= 64 ? launch<64>(q, k, v, o, kv_length, B, Tq, Tk, H, KV, D, q_offset, causal,
                              vec, scale_log2, device, st)
                 : launch<128>(q, k, v, o, kv_length, B, Tq, Tk, H, KV, D, q_offset, causal,
                               vec, scale_log2, device, st);
}
