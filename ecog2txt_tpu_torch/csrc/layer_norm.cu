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
// The per-block f32 partials of dg and db are summed by K5b's second launch
// (layer_norm_bwd_sum_kernel, as the JAX package sums its per-grid-block
// partials outside its kernel) in a fixed order, with no atomics, so results
// repeat run to run.  D may be any width.
//
// What bounds it on this card: bytes.  At the conformer's training shape
// (26624 rows of D=384, bf16) K5f moves x and y, 20.4 MB each, about 12 us
// at the HBM rate; K5b moves x, dy and dx, about 18 us.  The arithmetic is
// a few operations per element.
//
// Design.  K5f: one warp per row, the row function of layer_norm_row.cuh
// (shared with K3f's tensor-core body): lanes stride the row's columns and
// take the mean, then the variance about it (two passes, as the JAX
// kernel), then write y; the second and third reads of the row hit L1/L2,
// so device memory sees x about once.
//
// K5b has two bodies, chosen by the host from the row's width before the
// launch (ops/layernorm_kernels.py::plan_k5b_body).
// - The registers body (layer_norm_bwd_rows_kernel), every width the
//   conformer uses: a warp takes a row at a time and holds x and dy of the
//   row in registers, NCH chunks of V elements a lane (16-byte vectors where
//   the row's bytes and pointers allow, V = 8 for bf16 and 4 for f32, else
//   single elements; up to 4 chunks: bf16 rows to 1024 wide, f32 to 512;
//   bf16 stays packed two to a register until it is used), so
//   each row comes from device memory once, as the bound counts, and dx
//   goes out once, in vectors; the warp loads its next row while it
//   computes this one.  mu, rs, mean(dyg) and mean(dyg * xhat) come from
//   warp reductions over the registers.  Each lane keeps dg and db of its
//   fixed columns in registers across the warp's rows; at the end the
//   block's warps add theirs in warp order into the block's one partial
//   row.  The grid is one wave of resident blocks (rows split evenly by a
//   stride), so the partial rows are few (a few hundred on an H100).
// - The columns body (layer_norm_bwd_kernel), wider rows: each warp owns
//   kRowsPerWarp consecutive rows.  Pass A takes each row's mu, rs,
//   mean(dyg) and mean(dyg * xhat) (four floats a row in shared memory);
//   pass B walks the columns in tiles of 32, one column per lane, forms dx
//   and sums dy * xhat and dy over the warp's rows; the block's warps add
//   their sums in a fixed order into the block's partial row.  It reads
//   each row of x four times and dy three times (L1/L2 catch most).
//
// Plain C interface, loaded with ctypes; launches go on the caller's
// stream and each function returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "layer_norm_row.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = 8;                       // K5b, columns body
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

template <typename S>
__global__ void __launch_bounds__(kThreads)
layer_norm_fwd_kernel(const S* __restrict__ x,      // (rows, D)
                      const float* __restrict__ g,  // (D,)
                      const float* __restrict__ b,  // (D,)
                      S* __restrict__ y,            // (rows, D)
                      int rows, int D, float eps) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= rows) return;  // a whole warp; this kernel has no block barrier
  const size_t o = static_cast<size_t>(row) * D;
  ln_row::layer_norm_row<S>(x + o, g, b, y + o, D, eps, threadIdx.x % 32);
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
    ln_row::row_stats<S>(x + o, D, eps, lane, mu, rs);
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


// V elements of a row as loaded, kept packed in registers (bf16 two to a
// word) and widened to f32 where used: one 16-byte access where V elements
// of S are 16 bytes, else V scalar ones.
template <typename S, int V>
struct Chunk;

template <int V>
struct Chunk<__nv_bfloat16, V> {
  uint32_t w[(V + 1) / 2];
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    if constexpr (V == 8) {
      const uint4 u = *reinterpret_cast<const uint4*>(p);
      w[0] = u.x;
      w[1] = u.y;
      w[2] = u.z;
      w[3] = u.w;
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const uint32_t h = __bfloat16_as_ushort(p[k]);
        w[k / 2] = k % 2 ? (w[k / 2] | (h << 16)) : h;
      }
    }
  }
  __device__ __forceinline__ float get(int k) const {
    return __uint_as_float(k % 2 ? (w[k / 2] & 0xffff0000u) : (w[k / 2] << 16));
  }
};

template <int V>
struct Chunk<float, V> {
  float w[V];
  __device__ __forceinline__ void load(const float* p) {
    if constexpr (V == 4) {
      const float4 u = *reinterpret_cast<const float4*>(p);
      w[0] = u.x;
      w[1] = u.y;
      w[2] = u.z;
      w[3] = u.w;
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) w[k] = p[k];
    }
  }
  __device__ __forceinline__ float get(int k) const { return w[k]; }
};

template <typename S, int V>
__device__ __forceinline__ void store_chunk(S* p, const float (&f)[V]) {
  if constexpr (V * sizeof(S) == 16) {
    uint4 u;
    S* e = reinterpret_cast<S*>(&u);
#pragma unroll
    for (int k = 0; k < V; ++k) e[k] = from_f<S>(f[k]);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) p[k] = from_f<S>(f[k]);
  }
}

// K5b's registers body: lane l holds the row's chunks l, l + 32, ..., l +
// 32 (NCH - 1) of V elements (D % V == 0; chunks past the row are empty).
template <typename S, int V, int NCH>
__global__ void __launch_bounds__(kThreads)
layer_norm_bwd_rows_kernel(const S* __restrict__ x,      // (rows, D)
                           const S* __restrict__ dy,     // (rows, D)
                           const float* __restrict__ g,  // (D,)
                           S* __restrict__ dx,           // (rows, D)
                           float* __restrict__ dg_part,  // (gridDim.x, D)
                           float* __restrict__ db_part,  // (gridDim.x, D)
                           int rows, int D, float eps) {
  __shared__ float s_dg[kWarps][32 * V], s_db[kWarps][32 * V];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nv = D / V;  // chunks in a row
  const float inv_d = 1.0f / static_cast<float>(D);
  bool has[NCH];
  float gv[NCH][V], pg[NCH][V], pb[NCH][V];
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    has[i] = lane + 32 * i < nv;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      gv[i][k] = has[i] ? g[(lane + 32 * i) * V + k] : 0.f;
      pg[i][k] = 0.f;
      pb[i][k] = 0.f;
    }
  }
  Chunk<S, V> xa[NCH], da[NCH], xn[NCH], dn[NCH];
  auto load_row = [&](int row, Chunk<S, V> (&xv)[NCH], Chunk<S, V> (&dv)[NCH]) {
    const size_t o = static_cast<size_t>(row) * D;
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      if (has[i]) {
        xv[i].load(x + o + (lane + 32 * i) * V);
        dv[i].load(dy + o + (lane + 32 * i) * V);
      }
    }
  };
  const int stride = gridDim.x * kWarps;
  int r = blockIdx.x * kWarps + warp;
  if (r < rows) load_row(r, xa, da);
  for (; r < rows; r += stride) {
    if (r + stride < rows) load_row(r + stride, xn, dn);  // the warp's next row, in flight
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < NCH; ++i)
#pragma unroll
      for (int k = 0; k < V; ++k) s += has[i] ? xa[i].get(k) : 0.f;
    const float mu = warp_sum(s) / static_cast<float>(D);
    float v = 0.f;
#pragma unroll
    for (int i = 0; i < NCH; ++i)
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float c = has[i] ? xa[i].get(k) - mu : 0.f;
        v = fmaf(c, c, v);
      }
    const float rs = rsqrtf(warp_sum(v) / static_cast<float>(D) + eps);
    float a1 = 0.f, a2 = 0.f;
#pragma unroll
    for (int i = 0; i < NCH; ++i)
#pragma unroll
      for (int k = 0; k < V; ++k) {
        if (has[i]) {
          const float dyg = da[i].get(k) * gv[i][k];
          a1 += dyg;
          a2 = fmaf(dyg, (xa[i].get(k) - mu) * rs, a2);
        }
      }
    const float m1 = warp_sum(a1) * inv_d, m2 = warp_sum(a2) * inv_d;
    S* dxr = dx + static_cast<size_t>(r) * D;
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      if (!has[i]) continue;
      float o[V];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float xhat = (xa[i].get(k) - mu) * rs, dyv = da[i].get(k);
        o[k] = (dyv * gv[i][k] - m1 - xhat * m2) * rs;
        pg[i][k] = fmaf(dyv, xhat, pg[i][k]);
        pb[i][k] += dyv;
      }
      store_chunk<S, V>(dxr + (lane + 32 * i) * V, o);
    }
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      xa[i] = xn[i];
      da[i] = dn[i];
    }
  }
  // the block's partial row: chunk i's columns [32 V i, 32 V (i + 1)), the
  // warps' sums added in warp order (every warp reaches the barriers)
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      s_dg[warp][lane * V + k] = pg[i][k];
      s_db[warp][lane * V + k] = pb[i][k];
    }
    __syncthreads();
    for (int t = threadIdx.x; t < 32 * V; t += kThreads) {
      const int col = 32 * V * i + t;
      if (col < D) {
        float sg = 0.f, sb = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          sg += s_dg[w][t];
          sb += s_db[w][t];
        }
        dg_part[static_cast<size_t>(blockIdx.x) * D + col] = sg;
        db_part[static_cast<size_t>(blockIdx.x) * D + col] = sb;
      }
    }
    __syncthreads();
  }
}

// dg and db from the (blocks, D) partials of either body, summed over the
// blocks in a fixed order: block (c, a) takes columns [32c, 32c + 32) of
// array a (0: dg, 1: db); warp w adds partial rows w, w + kWarps, ... in
// order, lane l column 32c + l (128-byte rows), then the warps' sums add in
// warp order.
__global__ void __launch_bounds__(kThreads)
layer_norm_bwd_sum_kernel(const float* __restrict__ dg_part,  // (blocks, D)
                          const float* __restrict__ db_part,  // (blocks, D)
                          int blocks, int D,
                          float* __restrict__ dg,  // (D,)
                          float* __restrict__ db) {
  __shared__ float s_sum[kWarps][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col = blockIdx.x * 32 + lane;
  const float* src = blockIdx.y ? db_part : dg_part;
  float acc = 0.f;
  if (col < D) {
#pragma unroll 4
    for (int r = warp; r < blocks; r += kWarps) acc += src[static_cast<size_t>(r) * D + col];
  }
  s_sum[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && col < D) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += s_sum[w][lane];
    (blockIdx.y ? db : dg)[col] = t;
  }
}

constexpr int kMaxChunks = 4;  // chunks a lane holds in the registers body

template <typename S, int V>
struct RowsBody {
  static const void* pick(int nch) {
    switch (nch) {
      case 1: return reinterpret_cast<const void*>(layer_norm_bwd_rows_kernel<S, V, 1>);
      case 2: return reinterpret_cast<const void*>(layer_norm_bwd_rows_kernel<S, V, 2>);
      case 3: return reinterpret_cast<const void*>(layer_norm_bwd_rows_kernel<S, V, 3>);
      case 4: return reinterpret_cast<const void*>(layer_norm_bwd_rows_kernel<S, V, 4>);
      default: return nullptr;
    }
  }
};

// The registers body's kernel for rows of width D (vec: 16-byte chunks), or
// null where a lane would need more than kMaxChunks chunks.
const void* rows_kernel(int D, int bf16, int vec) {
  const int V = vec ? (bf16 ? 8 : 4) : 1;
  if (D <= 0 || D % V) return nullptr;
  const int nch = (D / V + 31) / 32;
  if (nch > kMaxChunks) return nullptr;
  if (bf16) {
    return vec ? RowsBody<__nv_bfloat16, 8>::pick(nch) : RowsBody<__nv_bfloat16, 1>::pick(nch);
  }
  return vec ? RowsBody<float, 4>::pick(nch) : RowsBody<float, 1>::pick(nch);
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

// Rows of x that share one partial row of dg and db in K5b's columns body.
int layer_norm_bwd_rows_per_block() { return kBwdRowsPerBlock; }

// K5b on the columns body; dg_part and db_part are
// (ceil(rows / rows_per_block), D) f32.
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

// K5b's registers body: the blocks of one wave on the current device (those
// it keeps resident, kWarps rows each at most, so the host takes
// min(ceil(rows / kWarps), wave) blocks, which are the partial rows) for
// rows of width D; 0 where the body does not take this width (the columns
// body runs it), -1 where the runtime cannot say.  vec: x, dy and dx are
// 16-byte aligned and a row is a whole number of 16-byte chunks.
int layer_norm_bwd_rows_wave(int D, int bf16, int vec) {
  const void* k = rows_kernel(D, bf16, vec);
  if (k == nullptr) return 0;
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, kThreads, 0) != cudaSuccess) {
    return -1;
  }
  return sms * (per_sm > 0 ? per_sm : 1);
}

// K5b on the registers body over `blocks` blocks (layer_norm_bwd_rows_wave);
// dg_part and db_part are (blocks, D) f32.
int layer_norm_bwd_rows(const void* x, const void* dy, const float* g, void* dx, float* dg_part,
                        float* db_part, int rows, int D, int bf16, int vec, int blocks,
                        float eps, void* stream) {
  const void* k = rows_kernel(D, bf16, vec);
  if (k == nullptr || rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  if (blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&x, &dy, &g, &dx, &dg_part, &db_part, &rows, &D, &eps};
  const cudaError_t err = cudaLaunchKernel(k, dim3(blocks), dim3(kThreads), args, 0,
                                           static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// dg and db (D,) each, the sums over the blocks of either body's (blocks, D)
// partials in a fixed order: K5b's second launch.
int layer_norm_bwd_sum(const float* dg_part, const float* db_part, int blocks, int D, float* dg,
                       float* db, void* stream) {
  if (blocks < 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  layer_norm_bwd_sum_kernel<<<dim3((D + 31) / 32, 2), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(dg_part, db_part, blocks, D,
                                                                   dg, db);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
