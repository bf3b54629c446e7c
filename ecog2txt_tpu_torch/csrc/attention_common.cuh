// Shared device code of the chunk-causal attention kernels
// (banded_attention.cu: K2f, K2b-dq, K2b-dkv; fused_attention.cu: K3f).
//
// Layout: q, k, v, g, out are (B, T1, D) row-major in the stream dtype
// (float or bf16), D = H * Dh with head h in columns [h*Dh, (h+1)*Dh);
// lse and delta are (B, T1, H) f32; lengths is (B,) int32.
// Every kernel runs kThreads threads (8 warps) per block and stages the
// rows it reads several times into shared memory as f32, one row every
// `stride = Dh + 1` floats so that lanes reading different rows at the
// same column hit different banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -1e30f;  // the Pallas kernels' finite mask fill

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to the stream dtype, kept as f32 (identity for f32 streams)
template <typename T>
__device__ __forceinline__ float rnd(float x) { return to_f<T>(from_f<T>(x)); }

__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// _band_mask of ops/pallas_attention.py for one (query row, key row) pair
// of LOCAL row indices: the chunk-causal band (offset is chunk-aligned),
// keys inside [0, t_real) locally and [0, length) absolutely, queries
// inside [0, t_real).
struct Band {
  int C, L, t_real, offset, length;
  __device__ __forceinline__ bool operator()(int gq, int gk) const {
    const int qc = floordiv(gq, C), kc = floordiv(gk, C);
    const long long ak = (long long)gk + offset;
    return kc <= qc && kc + L >= qc && gk >= 0 && gk < t_real && ak >= 0 &&
           ak < length && gq >= 0 && gq < t_real;
  }
};

// dst[r * stride + c] = f32(src[(row0 + r) * D + col0 + c]) for r < nrows,
// c < Dh; rows outside [0, T1) are not read and stage as 0 (their keys or
// queries are masked by Band).
template <typename T>
__device__ void stage_rows(float* dst, const T* src, int row0, int nrows, int T1,
                           int D, int col0, int Dh, int stride) {
  for (int idx = threadIdx.x; idx < nrows * Dh; idx += kThreads) {
    const int r = idx / Dh, c = idx - r * Dh, g = row0 + r;
    dst[r * stride + c] =
        (g >= 0 && g < T1) ? to_f<T>(src[(size_t)g * D + col0 + c]) : 0.f;
  }
}

// One warp: the attention output row of query `gq` (its Dh values at
// `qrow`, broadcast reads) against the W window keys/values staged at
// ksm/vsm (key j is local row gk0 + j).  Scores in f32, -1e30 where the
// band masks, row softmax in f32, p rounded to the stream dtype before
// p.v (as the Pallas kernel), output rounded; lse = m + log(sum).
// `sbuf` is this warp's W floats of scratch.
template <typename T>
__device__ void attend_row(const float* qrow, const float* ksm, const float* vsm,
                           int stride, int W, int Dh, float scale, const Band& band,
                           int gq, int gk0, float* sbuf, T* out_row, float* lse_out,
                           int lane) {
  float mloc = kNeg;
  for (int j = lane; j < W; j += 32) {
    float s = kNeg;
    if (band(gq, gk0 + j)) {
      const float* kr = ksm + j * stride;
      float acc = 0.f;
      for (int d = 0; d < Dh; ++d) acc = fmaf(qrow[d], kr[d], acc);
      s = acc * scale;
    }
    sbuf[j] = s;
    mloc = fmaxf(mloc, s);
  }
  const float m = warp_max(mloc);
  float part = 0.f;
  for (int j = lane; j < W; j += 32) {
    const float e = expf(sbuf[j] - m);
    sbuf[j] = e;
    part += e;
  }
  const float denom = warp_sum(part);
  for (int j = lane; j < W; j += 32) sbuf[j] = rnd<T>(sbuf[j] / denom);
  __syncwarp();
  for (int d = lane; d < Dh; d += 32) {
    float acc = 0.f;
    for (int j = 0; j < W; ++j) acc = fmaf(sbuf[j], vsm[j * stride + d], acc);
    out_row[d] = from_f<T>(acc);
  }
  if (lane == 0 && lse_out != nullptr) *lse_out = m + logf(denom);
  __syncwarp();
}

// Raise the dynamic shared memory limit of `kernel` and launch it; the
// CUDA error code (0 on success) of the attribute call or the launch.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace attn
