// Shared pieces of the bf16 tensor-core attention kernels (sm_90a):
// flash_prefill.cu (K4 at Tq > 1), flash_decode.cu (K4 at Tq == 1) and
// flash_backward.cu (K4's training backward).
//
// Both stage Q once and K/V tiles of BKV = 64 keys in shared memory as
// bf16, row-major [row][dim] with a padded row stride of DP + 8 elements
// (272 bytes at DP = 128), so that the eight row addresses of an ldmatrix
// fall in eight different bank quads.  Columns D .. DP-1 are zero, which
// pads any head_dim D <= DP to the mma depth without a second code path.
//
// A warp owns MT m-tiles of 16 query rows ("the m16 of mma.sync") and NK
// keys of each tile; one key tile of FlashAttention-2's inner loop is
//   score_tile     S = Q.K^T with mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32:
//                  Q's A fragments through ldmatrix from the staged Q tile,
//                  K through ldmatrix (a [key][dim] tile is already the
//                  "col" B operand); each K fragment feeds all MT m-tiles;
//   mask_max       mask, and the tile's row max, reduced over the four lanes
//                  that share a row (a thread holds rows g and g + 8 of each
//                  m-tile, g = lane / 4), scaled into the log2 domain;
//   softmax_update the online update of (m, l, acc) on the accumulator
//                  fragments; p = 2^(s * scale * log2 e - m) in fp32 (one
//                  fma and ex2.approx an element), l summed from the
//                  fp32 p (a per-lane partial, reduced once at the end:
//                  every lane scales it by the same alpha), p rounded to
//                  bf16 in registers (the reference's p.astype(v.dtype));
//   pv_tile        O += P.V with the bf16 p as the A fragment and V through
//                  ldmatrix.trans; each V fragment feeds all MT m-tiles.
// Scores, maxima and sums stay in fp32, as in the reference.
//
// Rows that are not 16-byte aligned (a head dim that is not a multiple of
// 8: SASRec's D = 50 is a 100-byte row) are staged in two steps: a raw
// copy of the bytes' 16-byte-aligned cover (cover_copy, 16-byte cp.async
// only), then a re-lay into the padded rows in shared memory (relay_rows).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash_mma {

constexpr int BKV = 64;                  // keys per tile
constexpr unsigned FULL_MASK = 0xffffffffu;

template <int DP>
struct Tile {
  static constexpr int DS = DP + 8;      // smem row stride, in bf16 elements
  static constexpr int CHUNKS = DP / 8;  // 16-byte chunks per padded row
  static constexpr int KSTEPS = DP / 16; // mma k-steps over the head dim
  static constexpr int ONT = DP / 8;     // output n-tiles (8 dims each)
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a . b for one m16n8k16 tile (bf16 in, fp32 accumulate)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16-byte global -> shared copy; src_bytes = 0 fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Stage `rows` rows of D elements into a [row][dim] tile: row r comes from
// row_src(r), or is zeros where that is null.  vec (D % 8 == 0, sources
// 16-byte aligned): D / 8 cp.async copies a row, zero-filled for a null
// row (which then names `valid`, any global address, and reads nothing);
// columns D .. DP-1 are left alone (zero them once with zero_pad_columns).
// Else plain element loads, which write every column of the padded row.
// Called by `nthreads` threads, thread `tid`.
template <int DP, typename RowSrc>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, int rows, RowSrc row_src,
                                           const __nv_bfloat16* valid, int D, bool vec,
                                           int tid, int nthreads) {
  using T = Tile<DP>;
  if (vec) {
    const int chunks = D / 8;
    const bool full = chunks == T::CHUNKS;  // D == DP: divide by a constant
    for (int e = tid; e < rows * chunks; e += nthreads) {
      const int r = full ? e / T::CHUNKS : e / chunks;
      const int c = full ? e % T::CHUNKS : e % chunks;
      const __nv_bfloat16* src = row_src(r);
      cp_async16(dst + r * T::DS + 8 * c, src != nullptr ? src + 8 * c : valid,
                 src != nullptr ? 16 : 0);
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    for (int e = tid; e < rows * DP; e += nthreads) {
      const int r = e / DP, d = e % DP;
      const __nv_bfloat16* src = row_src(r);
      dst[r * T::DS + d] = (src != nullptr && d < D) ? src[d] : zero;
    }
  }
}

// Zero columns D .. DP-1 of `rows` tile rows (the cp.async path never
// writes them).
template <int DP>
__device__ __forceinline__ void zero_pad_columns(__nv_bfloat16* dst, int rows, int D, int tid,
                                                 int nthreads) {
  using T = Tile<DP>;
  const int width = DP - D;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int e = tid; e < rows * width; e += nthreads)
    dst[(e / width) * T::DS + D + e % width] = zero;
}

// Raw copy of the n_bytes at src (2-byte aligned) in 16-byte cp.async
// copies of its 16-byte-aligned cover: the bytes land at buf + (src & 15)
// on; the last copy reads only up to src + n_bytes.  Called by `nthreads`
// threads, thread `tid`.
__device__ __forceinline__ void cover_copy(unsigned char* buf, const void* src, int n_bytes,
                                           int tid, int nthreads) {
  const uintptr_t s = reinterpret_cast<uintptr_t>(src);
  const uintptr_t a0 = s & ~uintptr_t(15), end = s + uintptr_t(n_bytes);
  const int chunks = static_cast<int>((end - a0 + 15) >> 4);
  for (int c = tid; c < chunks; c += nthreads) {
    const uintptr_t p = a0 + 16 * uintptr_t(c);
    cp_async16(buf + 16 * c, reinterpret_cast<const void*>(p),
               static_cast<int>(end - p < 16 ? end - p : 16));
  }
}

// Re-lay `rows` raw rows into a padded [row][DS] tile, 16 bytes (8
// elements) a thread and a step: row r's D elements start at byte
// row_off(r) of buf (-1: a zero row); columns D .. DP-1 are written as
// zeros.  4-byte shared loads where the row's offset is 4-byte aligned
// (every row at SASRec's shape), 2-byte ones otherwise.  nthreads: a
// multiple of DP / 8.
template <int DP, typename RowOff>
__device__ __forceinline__ void relay_rows(__nv_bfloat16* dst, const unsigned char* buf,
                                           int rows, RowOff row_off, int D, int tid,
                                           int nthreads) {
  constexpr int CH = DP / 8;          // 16-byte chunks a padded row
  const int e0 = 8 * (tid % CH);      // this thread's first element of a row
  for (int r = tid / CH; r < rows; r += nthreads / CH) {
    const int off = row_off(r);
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (off >= 0 && e0 < D) {
      if ((off & 3) == 0) {
        const uint32_t* src = reinterpret_cast<const uint32_t*>(buf + off + 2 * e0);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int e = e0 + 2 * j;
          if (e < D) w[j] = e + 1 < D ? src[j] : src[j] & 0xffffu;
        }
      } else {
        const uint16_t* src = reinterpret_cast<const uint16_t*>(buf + off + 2 * e0);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int e = e0 + 2 * j;
          if (e < D) w[j] = src[2 * j] | (e + 1 < D ? uint32_t(src[2 * j + 1]) << 16 : 0u);
        }
      }
    }
    *reinterpret_cast<uint4*>(dst + r * Tile<DP>::DS + e0) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The online-softmax state of one warp's MT m-tiles, per lane: rows g and
// g + 8 of each (g = lane / 4), output dims 8n + 2 (lane % 4) + {0, 1}.
template <int DP, int MT>
struct WarpState {
  float o[MT][Tile<DP>::ONT][4];  // [mt][n][0..1] row g, [mt][n][2..3] row g + 8
  float m[MT][2];                 // running max, log2 domain (-inf: no key yet)
  float l[MT][2];                 // this lane's partial of the running sum
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int n = 0; n < Tile<DP>::ONT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[mt][n][e] = 0.f;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        m[mt][i] = -INFINITY;
        l[mt][i] = 0.f;
      }
    }
  }
  // l summed over the four lanes of a row
  __device__ __forceinline__ float row_sum(int mt, int i) const {
    float x = l[mt][i];
    x += __shfl_xor_sync(FULL_MASK, x, 1);
    x += __shfl_xor_sync(FULL_MASK, x, 2);
    return x;
  }
};

// s[mt][j] = Q[rows q_row0 + 16 mt ..] . K[keys 8j ..]^T for NK keys of the
// tile starting at Ks (fresh accumulators).
template <int DP, int MT, int NK>
__device__ __forceinline__ void score_tile(float (&s)[MT][NK / 8][4], const __nv_bfloat16* Qs,
                                           int q_row0, const __nv_bfloat16* Ks, int lane) {
  using T = Tile<DP>;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
  const __nv_bfloat16* qrow = Qs + (q_row0 + (lane & 15)) * T::DS + (lane >> 4) * 8;
  const __nv_bfloat16* krow =
      Ks + ((lane & 7) + ((lane >> 4) << 3)) * T::DS + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int d = 0; d < T::KSTEPS; ++d) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) ldsm_x4(a[mt], qrow + mt * 16 * T::DS + d * 16);
#pragma unroll
    for (int jj = 0; jj < NK / 16; ++jj) {  // 16 keys: n-tiles 2jj, 2jj + 1
      uint32_t b[4];
      ldsm_x4(b, krow + jj * 16 * T::DS + d * 16);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(s[mt][2 * jj], a[mt], b[0], b[1]);
        mma_bf16(s[mt][2 * jj + 1], a[mt], b[2], b[3]);
      }
    }
  }
}

// If masked, set s to -inf where key >= kv_len or (causal) key >
// qpos[mt][i]; mx[mt][i] is the row's max over the NK keys, scaled into the
// log2 domain (times scale_log2 > 0).  key0: the key of n-tile 0, column 0.
// Element (j, e): row g + 8 (e / 2), key key0 + 8j + 2 (lane % 4) + e % 2.
template <int MT, int NK>
__device__ __forceinline__ void mask_max(float (&s)[MT][NK / 8][4], float (&mx)[MT][2],
                                         int lane, float scale_log2, bool masked, int key0,
                                         int kv_len, bool causal, const int (&qpos)[MT][2]) {
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
            if (key >= kv_len || (causal && key > qpos[mt][i])) x = -INFINITY;
          }
          s[mt][j][2 * i + e] = x;
          x_max = fmaxf(x_max, x);
        }
      x_max = fmaxf(x_max, __shfl_xor_sync(FULL_MASK, x_max, 1));
      mx[mt][i] = fmaxf(x_max, __shfl_xor_sync(FULL_MASK, x_max, 2)) * scale_log2;
    }
}

__device__ __forceinline__ float ex2(float x) {  // 2^x; -inf gives 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The online update with the tile's row max mx (log2 domain): alpha
// rescales acc and l, p = 2^(s * scale_log2 - m) joins l in fp32 and goes to
// pa as bf16 pairs ([mt][j][0] row g, [mt][j][1] row g + 8).  acc is
// rescaled only when some row's max moved (alpha == 1 everywhere leaves it
// as it is, bit for bit), which late in a long row is most tiles.
template <int DP, int MT, int NK>
__device__ __forceinline__ void softmax_update(WarpState<DP, MT>& st,
                                               const float (&s)[MT][NK / 8][4],
                                               const float (&mx)[MT][2], float scale_log2,
                                               uint32_t (&pa)[MT][NK / 8][2]) {
  float alpha[MT][2];
  bool moved = false;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(st.m[mt][i], mx[mt][i]);
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      alpha[mt][i] = st.m[mt][i] == -INFINITY ? 0.f : ex2(st.m[mt][i] - m_safe);
      moved |= alpha[mt][i] != 1.f;
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < NK / 8; ++j) {
        const float p0 = ex2(fmaf(s[mt][j][2 * i], scale_log2, -m_safe));
        const float p1 = ex2(fmaf(s[mt][j][2 * i + 1], scale_log2, -m_safe));
        psum += p0 + p1;  // l sums the fp32 p, before rounding
        pa[mt][j][i] = pack_bf16(p0, p1);
      }
      st.l[mt][i] = st.l[mt][i] * alpha[mt][i] + psum;
      st.m[mt][i] = m_new;
    }
  if (__any_sync(FULL_MASK, moved)) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < Tile<DP>::ONT; ++n) {
        st.o[mt][n][0] *= alpha[mt][0];
        st.o[mt][n][1] *= alpha[mt][0];
        st.o[mt][n][2] *= alpha[mt][1];
        st.o[mt][n][3] *= alpha[mt][1];
      }
  }
}

// acc += P . V over NK keys of the tile starting at Vs.
template <int DP, int MT, int NK>
__device__ __forceinline__ void pv_tile(WarpState<DP, MT>& st,
                                        const uint32_t (&pa)[MT][NK / 8][2],
                                        const __nv_bfloat16* Vs, int lane) {
  using T = Tile<DP>;
  const __nv_bfloat16* vrow =
      Vs + ((lane & 7) + ((lane >> 3) & 1) * 8) * T::DS + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk) {  // keys 16kk ..: n-tiles 2kk, 2kk + 1 of S
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      a[mt][0] = pa[mt][2 * kk][0];
      a[mt][1] = pa[mt][2 * kk][1];
      a[mt][2] = pa[mt][2 * kk + 1][0];
      a[mt][3] = pa[mt][2 * kk + 1][1];
    }
#pragma unroll
    for (int nn = 0; nn < T::ONT / 2; ++nn) {  // dims 16nn ..: n-tiles 2nn, 2nn + 1
      uint32_t b[4];
      ldsm_x4_trans(b, vrow + kk * 16 * T::DS + nn * 16);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(st.o[mt][2 * nn], a[mt], b[0], b[1]);
        mma_bf16(st.o[mt][2 * nn + 1], a[mt], b[2], b[3]);
      }
    }
  }
}

}  // namespace flash_mma
