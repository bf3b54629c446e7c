// Shared device code of the chunk-causal attention kernels on the tensor
// cores (bf16 streams): K2f's body (banded_attention_tc.cu) and K2b-dq and
// K2b-dkv (banded_attention_bwd_tc.cu).  bf16 staging into shared memory
// by cp.async, ldmatrix and mma.sync m16n8k16 (bf16 in, f32 accumulate),
// and the band as per-row chunk ids.
//
// Fragment layouts of m16n8k16 (g = lane / 4, t4 = lane % 4): the C (and
// D) fragment of an n8 tile holds c0, c1 = row g, columns 2*t4 and
// 2*t4 + 1, and c2, c3 = row g + 8, the same columns.  Two n8 tiles of
// C, packed pairwise to bf16, are the A fragment of the next product
// (rows of C, and its 16 columns as the depth): {pack(c[0][0], c[0][1]),
// pack(c[0][2], c[0][3]), pack(c[1][0], c[1][1]), pack(c[1][2], c[1][3])}.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace attn_tc {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a . b for one m16n8k16 tile: bf16 operands, f32 accumulator
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows [row0, row0 + nrows) of the (T1, D) matrix `src` (one batch row),
// columns [col0, col0 + Dh), into dst (nrows_p x Dhp, row stride ST);
// rows outside [0, T1) or past nrows and columns past Dh are zeros and
// never read.  With `vec` (Dh and D multiples of 8, 16-byte aligned
// tensors) by cp.async in 16-byte chunks, else by scalar copies.
__device__ void stage(bf16* dst, int ST, const bf16* src, int row0, int nrows, int nrows_p,
                      int T1, int D, int col0, int Dh, int Dhp, bool vec) {
  if (vec) {
    const int cpr = Dhp / 8;
    for (int idx = threadIdx.x; idx < nrows_p * cpr; idx += blockDim.x) {
      const int r = idx / cpr, c = (idx - r * cpr) * 8, g = row0 + r;
      const bool ok = r < nrows && g >= 0 && g < T1 && c < Dh;
      const bf16* s = ok ? src + (size_t)g * D + col0 + c : src;
      cp_async16(smem_addr(dst + r * ST + c), s, ok ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < nrows_p * Dhp; idx += blockDim.x) {
      const int r = idx / Dhp, c = idx - r * Dhp, g = row0 + r;
      const bool ok = r < nrows && g >= 0 && g < T1 && c < Dh;
      dst[r * ST + c] = ok ? src[(size_t)g * D + col0 + c] : __float2bfloat16_rn(0.f);
    }
  }
}

// The band of _band_mask as chunk ids: key j of the window is admitted
// for query row i iff kc[j] <= qc[i] <= kc[j] + L, where kc[j] is the
// key's chunk (kNoKey where the key is masked whatever the query: outside
// [0, t_real) locally, at a negative absolute position or at/past the
// valid length) and qc[i] the query's chunk (kNoRow past t_real).
constexpr int kNoKey = 1 << 29;
constexpr int kNoRow = -(1 << 29);

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace attn_tc
