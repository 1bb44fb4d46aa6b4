// The pieces K4's two float32 kernels share: the forward
// (flash_attention.cu) and the training backward (flash_backward_f32.cu).
// Rows of D floats are staged into padded [row][stride] shared tiles with
// cp.async, 16 bytes a copy where D % 4 == 0 and every operand is 16-byte
// aligned (8 or 4 bytes otherwise: copy_width); columns D .. DP-1 are
// zeroed once, since no copy writes them; a row's statistics are reduced
// over the 16 lanes that share it with shuffles, in a fixed order.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash_f32 {

constexpr unsigned FULL_MASK = 0xffffffffu;

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

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// BYTES-byte global -> shared copy; !valid fills the BYTES with zeros
// (and reads nothing at src, which must still be a global address)
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "n"(BYTES), "r"(valid ? BYTES : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N copy groups of this thread are in flight
template <int N = 0>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() { cp_async_wait<0>(); }

// Stage `rows` rows of D floats into a [row][stride] tile, vw floats (4,
// 2 or 1) a cp.async, NT threads taking turns: row r comes from
// row_src(r), or is zeros where that is null (the copy then names
// `valid`, any global address).  Columns D .. DP-1 are left alone.  D ==
// DP at vw = 4 divides by a constant.
template <int DP, int NT, typename RowSrc>
__device__ __forceinline__ void stage_rows(float* dst, int stride, int rows, RowSrc row_src,
                                           const float* valid, int D, int vw, int tid) {
  constexpr int FULL = DP / 4;
  const int per_row = D / vw;
  const bool full = vw == 4 && D == DP;
  for (int e = tid; e < rows * per_row; e += NT) {
    const int r = full ? e / FULL : e / per_row;
    const int c = full ? e % FULL : e % per_row;
    const float* src = row_src(r);
    float* d = dst + r * stride + vw * c;
    const float* s = src != nullptr ? src + vw * c : valid;
    if (vw == 4) {
      cp_async<16>(d, s, src != nullptr);
    } else if (vw == 2) {
      cp_async<8>(d, s, src != nullptr);
    } else {
      cp_async<4>(d, s, src != nullptr);
    }
  }
}

// Zero columns D .. DP-1 of `rows` rows of a [row][stride] tile.
template <int DP, int NT>
__device__ __forceinline__ void zero_columns(float* dst, int stride, int rows, int D, int tid) {
  const int width = DP - D;
  for (int e = tid; e < rows * width; e += NT) dst[(e / width) * stride + D + e % width] = 0.f;
}

// The widest copy, in floats, that the row length D and the operands'
// addresses (OR-ed together into `align`) allow.
inline int copy_width(int D, uintptr_t align) {
  return (D % 4 == 0 && align % 16 == 0) ? 4 : (D % 2 == 0 && align % 8 == 0) ? 2 : 1;
}

}  // namespace flash_f32
