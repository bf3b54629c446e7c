// Row LayerNorm for NVIDIA Hopper (sm_90a): forward K5f, backward K5b.
//
// Replaces: ecog2txt_tpu/ops/pallas_layernorm.py::_ln_fwd (the
// pallas_call at :104, kernel _ln_fwd_kernel) and ::_ln_bwd (the
// pallas_call at :125, kernel _ln_bwd_kernel).  Over the last axis of a
// (rows, D) tensor in the stream type S (float or bf16), with f32
// statistics and f32 affine parameters g, b:
//
//   K5f:  mu = mean(x),  var = mean((x - mu)^2),  rs = rsqrt(var + eps)
//         y  = S((x - mu) * rs * g + b)
//   K5b:  xhat = (x - mu) * rs (recomputed from x),  dyg = dy * g
//         dx = S((dyg - mean(dyg) - xhat * mean(dyg * xhat)) * rs)
//         dg_part[blk] = sum over the block's rows of dy * xhat
//         db_part[blk] = sum over the block's rows of dy
//
// The per-block f32 partials of dg and db are summed outside the kernel
// (as the JAX package sums its per-grid-block partials), with no atomics,
// so results repeat run to run.  D may be any width.
//
// What bounds it on this card: bytes.  At the conformer's training shape
// (26624 rows of D=384, bf16) K5f moves x and y, 20.4 MB each, about 12 us
// at the HBM rate; K5b moves x, dy and dx, about 18 us.  The arithmetic is
// a few operations per element.
//
// Design (simple and right first).  K5f: one warp per row; lanes stride
// the row's columns and take the mean, then the variance about it (two
// passes, as the JAX kernel), then write y; the second and third reads of
// the row hit L1/L2, so device memory sees x about once.  K5b: each warp
// owns kRowsPerWarp consecutive rows.  Pass A takes each row's mu, rs,
// mean(dyg) and mean(dyg * xhat) (four floats a row in shared memory).
// Pass B walks the columns in tiles of 32, one column per lane: for its
// column the lane forms dx of each of the warp's rows and sums dy * xhat
// and dy over them in registers; the block's warps then add their sums in
// a fixed order into the block's partial row.  Vector loads, a block per
// row for wide D and keeping the row in registers are later work.
//
// Plain C interface, loaded with ctypes; launches go on the caller's
// stream and each function returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = 8;                       // K5b
constexpr int kBwdRowsPerBlock = kWarps * kRowsPerWarp;  // one partial row each

template <typename S>
__device__ __forceinline__ float to_f(S x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename S>
__device__ __forceinline__ S from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// mean and 1/sqrt(var + eps) of one row, every lane of the warp gets both
template <typename S>
__device__ __forceinline__ void row_stats(const S* xr, int D, float eps, int lane,
                                          float& mu, float& rs) {
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s += to_f<S>(xr[d]);
  mu = warp_sum(s) / static_cast<float>(D);
  float v = 0.f;
  for (int d = lane; d < D; d += 32) {
    const float c = to_f<S>(xr[d]) - mu;
    v = fmaf(c, c, v);
  }
  rs = rsqrtf(warp_sum(v) / static_cast<float>(D) + eps);
}

template <typename S>
__global__ void __launch_bounds__(kThreads)
layer_norm_fwd_kernel(const S* __restrict__ x,      // (rows, D)
                      const float* __restrict__ g,  // (D,)
                      const float* __restrict__ b,  // (D,)
                      S* __restrict__ y,            // (rows, D)
                      int rows, int D, float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= rows) return;  // a whole warp; this kernel has no block barrier
  const S* xr = x + static_cast<size_t>(row) * D;
  S* yr = y + static_cast<size_t>(row) * D;
  float mu, rs;
  row_stats<S>(xr, D, eps, lane, mu, rs);
  for (int d = lane; d < D; d += 32) {
    yr[d] = from_f<S>((to_f<S>(xr[d]) - mu) * rs * g[d] + b[d]);
  }
}

template <typename S>
__global__ void __launch_bounds__(kThreads)
layer_norm_bwd_kernel(const S* __restrict__ x,      // (rows, D)
                      const S* __restrict__ dy,     // (rows, D)
                      const float* __restrict__ g,  // (D,)
                      S* __restrict__ dx,           // (rows, D)
                      float* __restrict__ dg_part,  // (blocks, D)
                      float* __restrict__ db_part,  // (blocks, D)
                      int rows, int D, float eps) {
  __shared__ float s_mu[kWarps][kRowsPerWarp], s_rs[kWarps][kRowsPerWarp];
  __shared__ float s_m1[kWarps][kRowsPerWarp], s_m2[kWarps][kRowsPerWarp];
  __shared__ float s_dg[kWarps][32], s_db[kWarps][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = (blockIdx.x * kWarps + warp) * kRowsPerWarp;
  const int nrows = max(0, min(kRowsPerWarp, rows - row0));
  const float inv_d = 1.0f / static_cast<float>(D);

  // pass A: the statistics of each of this warp's rows
  for (int r = 0; r < nrows; ++r) {
    const size_t o = static_cast<size_t>(row0 + r) * D;
    float mu, rs;
    row_stats<S>(x + o, D, eps, lane, mu, rs);
    float a1 = 0.f, a2 = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float dyg = to_f<S>(dy[o + d]) * g[d];
      const float xhat = (to_f<S>(x[o + d]) - mu) * rs;
      a1 += dyg;
      a2 = fmaf(dyg, xhat, a2);
    }
    a1 = warp_sum(a1);
    a2 = warp_sum(a2);
    if (lane == 0) {
      s_mu[warp][r] = mu;
      s_rs[warp][r] = rs;
      s_m1[warp][r] = a1 * inv_d;
      s_m2[warp][r] = a2 * inv_d;
    }
  }
  __syncwarp();

  // pass B: column tiles of 32, one column per lane; every warp runs the
  // same number of tiles, so all reach the block barriers
  for (int c0 = 0; c0 < D; c0 += 32) {
    const int d = c0 + lane;
    float pg = 0.f, pb = 0.f;
    if (d < D) {
      const float gd = g[d];
      for (int r = 0; r < nrows; ++r) {
        const size_t o = static_cast<size_t>(row0 + r) * D + d;
        const float rs = s_rs[warp][r];
        const float xhat = (to_f<S>(x[o]) - s_mu[warp][r]) * rs;
        const float dyv = to_f<S>(dy[o]);
        dx[o] = from_f<S>((dyv * gd - s_m1[warp][r] - xhat * s_m2[warp][r]) * rs);
        pg = fmaf(dyv, xhat, pg);
        pb += dyv;
      }
    }
    s_dg[warp][lane] = pg;
    s_db[warp][lane] = pb;
    __syncthreads();
    if (warp == 0 && d < D) {
      float sg = 0.f, sb = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        sg += s_dg[w][lane];
        sb += s_db[w][lane];
      }
      dg_part[static_cast<size_t>(blockIdx.x) * D + d] = sg;
      db_part[static_cast<size_t>(blockIdx.x) * D + d] = sb;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// K5f over `rows` rows of width D; returns the CUDA error code.
int layer_norm_fwd(const void* x, const float* g, const float* b, void* y, int rows, int D,
                   int bf16, float eps, void* stream) {
  if (rows < 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (rows + kWarps - 1) / kWarps;
  if (bf16) {
    using S = __nv_bfloat16;
    layer_norm_fwd_kernel<S><<<blocks, kThreads, 0, s>>>(
        static_cast<const S*>(x), g, b, static_cast<S*>(y), rows, D, eps);
  } else {
    layer_norm_fwd_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(x), g, b, static_cast<float*>(y), rows, D, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

// Rows of x that share one partial row of dg and db in K5b.
int layer_norm_bwd_rows_per_block() { return kBwdRowsPerBlock; }

// K5b; dg_part and db_part are (ceil(rows / rows_per_block), D) f32.
int layer_norm_bwd(const void* x, const void* dy, const float* g, void* dx, float* dg_part,
                   float* db_part, int rows, int D, int bf16, float eps, void* stream) {
  if (rows < 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (rows + kBwdRowsPerBlock - 1) / kBwdRowsPerBlock;
  if (bf16) {
    using S = __nv_bfloat16;
    layer_norm_bwd_kernel<S><<<blocks, kThreads, 0, s>>>(
        static_cast<const S*>(x), static_cast<const S*>(dy), g, static_cast<S*>(dx), dg_part,
        db_part, rows, D, eps);
  } else {
    layer_norm_bwd_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy), g,
        static_cast<float*>(dx), dg_part, db_part, rows, D, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
