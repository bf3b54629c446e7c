// One row of the row LayerNorm forward for a warp: the body of K5f
// (layer_norm.cu::layer_norm_fwd_kernel) and of the first launch of K3f's
// tensor-core body (fused_attention_tc.cu::fused_attention_prep_kernel).
//
//   mu = mean(x),  var = mean((x - mu)^2),  rs = rsqrt(var + eps)
//   y  = S((x - mu) * rs * g + b)
//
// The statistics are f32 and taken in two passes (the mean, then the
// variance about it), as ecog2txt_tpu/ops/pallas_layernorm.py::_ln_fwd_kernel
// takes them; lanes stride the row's columns, one element each, and the
// second and third reads of the row hit L1.  A variant with 16-byte loads
// and each product of y rounded on its own measured slower for K5f on an
// H100, so both kernels run this one.

#pragma once

#include <cuda_bf16.h>

namespace ln_row {

template <typename S>
__device__ __forceinline__ float f32(S x);
template <>
__device__ __forceinline__ float f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename S>
__device__ __forceinline__ S to_s(float x);
template <>
__device__ __forceinline__ float to_s<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 to_s<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_total(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// mean and 1/sqrt(var + eps) of one row, every lane of the warp gets both
template <typename S>
__device__ __forceinline__ void row_stats(const S* xr, int D, float eps, int lane, float& mu,
                                          float& rs) {
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s += f32(xr[d]);
  mu = warp_total(s) / static_cast<float>(D);
  float v = 0.f;
  for (int d = lane; d < D; d += 32) {
    const float c = f32(xr[d]) - mu;
    v = fmaf(c, c, v);
  }
  rs = rsqrtf(warp_total(v) / static_cast<float>(D) + eps);
}

// y = S((x - mu) * rs * g + b) of the row xr into yr, every lane of the warp
// taking part
template <typename S>
__device__ __forceinline__ void layer_norm_row(const S* xr, const float* g, const float* b,
                                               S* yr, int D, float eps, int lane) {
  float mu, rs;
  row_stats<S>(xr, D, eps, lane, mu, rs);
  for (int d = lane; d < D; d += 32) yr[d] = to_s<S>((f32(xr[d]) - mu) * rs * g[d] + b[d]);
}

}  // namespace ln_row
