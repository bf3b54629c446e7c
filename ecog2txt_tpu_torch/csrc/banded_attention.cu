// Chunk-causal ("banded") attention for Hopper (sm_90a): the forward
// kernel K2f and the two backward kernels K2b-dq and K2b-dkv.
//
// Replaces ecog2txt_tpu/ops/pallas_attention.py::_fwd_call (K2f, the
// pallas_call at :329) and ::_bwd_calls (K2b, the pallas_calls at :290
// for dq and :302 for dk/dv).  Semantics (mask, -1e30 fill, f32 softmax,
// rounding points, the saved per-head LSE) are those of the Pallas
// kernels and of the plain versions in ops/attention_kernels.py.
//
// Design: one block per (query or key block n, head h, batch row b).
// The rows a block reads many times (the QB + L*C key/value window of
// K2f and K2b-dq, the QB + L*C attending query/gradient rows of
// K2b-dkv) are staged once into shared memory as f32; rows outside
// [0, T1) (before block 0, after the last block) are never read and
// stage as zeros, masked by index like the Pallas kernels' clamped views.
// Each warp owns one row at a time: lanes own keys for the scores (a
// row softmax by warp shuffles), then head-dim columns for the products
// with the window.
//
// Bound on the card: at the conformer's shapes (QB=128, window 144,
// Dh=64) each kernel does ~2*144*64 multiply-adds per row and head and
// moves each input once, so by the H100's peaks it is bound by bytes
// (q, k, v, out: ~100 MB at B=256, T1=128, D=384, bf16).  This simple
// kernel runs its products on the CUDA cores from shared memory, so in
// practice shared-memory bandwidth and latency bound it.
//
// Since the tensor-core body of K2f (banded_attention_tc.cu) took over
// bf16 streams, the forward here runs f32 streams (the tensor cores have
// no f32 product, and TF32 would break the f32 tolerance) and bf16 blocks
// too large for that body's shared memory; the wrapper picks the body by
// dtype and shape before the launch (ops/attention_kernels.py::
// plan_k2f_body).  K2b-dq and K2b-dkv are still this design; their
// redesign as K2f's is the next step.

#include "attention_common.cuh"

using namespace attn;

namespace {

// K2f: out and lse of query block n, head h, batch row b.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    banded_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                const T* __restrict__ v, const int* __restrict__ lengths,
                                T* __restrict__ out, float* __restrict__ lse, int T1, int H,
                                int Dh, int C, int L, int t_real, int QB, int offset,
                                float scale) {
  const int n = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int PREV = L * C, W = QB + PREV, D = H * Dh, stride = Dh + 1;
  const int base = n * QB;
  const size_t boff = (size_t)b * T1 * D;
  extern __shared__ float smem[];
  float* ksm = smem;
  float* vsm = ksm + W * stride;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* qrow = vsm + W * stride + warp * (Dh + W);
  float* sbuf = qrow + Dh;

  stage_rows(ksm, k + boff, base - PREV, W, T1, D, h * Dh, Dh, stride);
  stage_rows(vsm, v + boff, base - PREV, W, T1, D, h * Dh, Dh, stride);
  __syncthreads();
  const Band band{C, L, t_real, offset, lengths[b]};
  for (int i = warp; i < QB; i += kWarps) {
    const int gq = base + i;
    const T* qg = q + boff + (size_t)gq * D + h * Dh;
    for (int d = lane; d < Dh; d += 32) qrow[d] = to_f<T>(qg[d]);
    __syncwarp();
    attend_row<T>(qrow, ksm, vsm, stride, W, Dh, scale, band, gq, base - PREV, sbuf,
                  out + boff + (size_t)gq * D + h * Dh,
                  lse + ((size_t)b * T1 + gq) * H + h, lane);
  }
}

// K2b-dq: dq of query block n.  p = exp(s - lse) inside the band, else 0;
// ds = S(p * (g.v - delta)); dq = S(f32(ds . k) * scale).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    banded_attention_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v, const T* __restrict__ g,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               const int* __restrict__ lengths, T* __restrict__ dq, int T1,
                               int H, int Dh, int C, int L, int t_real, int QB, int offset,
                               float scale) {
  const int n = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int PREV = L * C, W = QB + PREV, D = H * Dh, stride = Dh + 1;
  const int base = n * QB;
  const size_t boff = (size_t)b * T1 * D;
  extern __shared__ float smem[];
  float* ksm = smem;
  float* vsm = ksm + W * stride;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* qrow = vsm + W * stride + warp * (2 * Dh + W);
  float* grow = qrow + Dh;
  float* dsbuf = grow + Dh;

  stage_rows(ksm, k + boff, base - PREV, W, T1, D, h * Dh, Dh, stride);
  stage_rows(vsm, v + boff, base - PREV, W, T1, D, h * Dh, Dh, stride);
  __syncthreads();
  const Band band{C, L, t_real, offset, lengths[b]};
  for (int i = warp; i < QB; i += kWarps) {
    const int gq = base + i;
    const size_t row = (size_t)gq * D + h * Dh;
    for (int d = lane; d < Dh; d += 32) {
      qrow[d] = to_f<T>(q[boff + row + d]);
      grow[d] = to_f<T>(g[boff + row + d]);
    }
    const float lse_i = lse[((size_t)b * T1 + gq) * H + h];
    const float delta_i = delta[((size_t)b * T1 + gq) * H + h];
    __syncwarp();
    for (int j = lane; j < W; j += 32) {
      float ds = 0.f;
      if (band(gq, base - PREV + j)) {
        const float* kr = ksm + j * stride;
        const float* vr = vsm + j * stride;
        float s = 0.f, dp = 0.f;
        for (int d = 0; d < Dh; ++d) {
          s = fmaf(qrow[d], kr[d], s);
          dp = fmaf(grow[d], vr[d], dp);
        }
        const float p = expf(s * scale - lse_i);
        ds = rnd<T>(p * (dp - delta_i));
      }
      dsbuf[j] = ds;
    }
    __syncwarp();
    for (int d = lane; d < Dh; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < W; ++j) acc = fmaf(dsbuf[j], ksm[j * stride + d], acc);
      dq[boff + row + d] = from_f<T>(acc * scale);
    }
    __syncwarp();
  }
}

// K2b-dkv: dk and dv of key block n.  Its attending query rows are
// [n*QB, n*QB + QB + L*C): the block's own and the first L*C rows of the
// next block; those at or past T1 are not read (staged as zeros) and are
// masked.  dv = S(f32(S(p)^T . g)), dk = S(f32(ds^T . q) * scale).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    banded_attention_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                const T* __restrict__ v, const T* __restrict__ g,
                                const float* __restrict__ lse, const float* __restrict__ delta,
                                const int* __restrict__ lengths, T* __restrict__ dk,
                                T* __restrict__ dv, int T1, int H, int Dh, int C, int L,
                                int t_real, int QB, int offset, float scale) {
  const int n = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int PREV = L * C, Wq = QB + PREV, D = H * Dh, stride = Dh + 1;
  const int base = n * QB;
  const size_t boff = (size_t)b * T1 * D;
  extern __shared__ float smem[];
  float* qsm = smem;
  float* gsm = qsm + Wq * stride;
  float* lsesm = gsm + Wq * stride;
  float* deltasm = lsesm + Wq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* krow = deltasm + Wq + warp * (2 * Dh + 2 * Wq);
  float* vrow = krow + Dh;
  float* pbuf = vrow + Dh;
  float* dsbuf = pbuf + Wq;

  stage_rows(qsm, q + boff, base, Wq, T1, D, h * Dh, Dh, stride);
  stage_rows(gsm, g + boff, base, Wq, T1, D, h * Dh, Dh, stride);
  for (int i = threadIdx.x; i < Wq; i += kThreads) {
    const int gq = base + i;
    const bool in = gq < T1;
    lsesm[i] = in ? lse[((size_t)b * T1 + gq) * H + h] : 0.f;
    deltasm[i] = in ? delta[((size_t)b * T1 + gq) * H + h] : 0.f;
  }
  __syncthreads();
  const Band band{C, L, t_real, offset, lengths[b]};
  for (int j = warp; j < QB; j += kWarps) {
    const int gk = base + j;
    const size_t row = (size_t)gk * D + h * Dh;
    for (int d = lane; d < Dh; d += 32) {
      krow[d] = to_f<T>(k[boff + row + d]);
      vrow[d] = to_f<T>(v[boff + row + d]);
    }
    __syncwarp();
    for (int i = lane; i < Wq; i += 32) {
      float pc = 0.f, ds = 0.f;
      if (band(base + i, gk)) {
        const float* qr = qsm + i * stride;
        const float* gr = gsm + i * stride;
        float s = 0.f, dp = 0.f;
        for (int d = 0; d < Dh; ++d) {
          s = fmaf(qr[d], krow[d], s);
          dp = fmaf(gr[d], vrow[d], dp);
        }
        const float p = expf(s * scale - lsesm[i]);
        pc = rnd<T>(p);
        ds = rnd<T>(p * (dp - deltasm[i]));
      }
      pbuf[i] = pc;
      dsbuf[i] = ds;
    }
    __syncwarp();
    for (int d = lane; d < Dh; d += 32) {
      float accv = 0.f, acck = 0.f;
      for (int i = 0; i < Wq; ++i) {
        accv = fmaf(pbuf[i], gsm[i * stride + d], accv);
        acck = fmaf(dsbuf[i], qsm[i * stride + d], acck);
      }
      dv[boff + row + d] = from_f<T>(accv);
      dk[boff + row + d] = from_f<T>(acck * scale);
    }
    __syncwarp();
  }
}

size_t fwd_smem(int W, int Dh) {
  return sizeof(float) * ((size_t)2 * W * (Dh + 1) + (size_t)kWarps * (Dh + W));
}

size_t dq_smem(int W, int Dh) {
  return sizeof(float) * ((size_t)2 * W * (Dh + 1) + (size_t)kWarps * (2 * Dh + W));
}

size_t dkv_smem(int Wq, int Dh) {
  return sizeof(float) *
         ((size_t)2 * Wq * (Dh + 1) + 2 * (size_t)Wq + (size_t)kWarps * (2 * Dh + 2 * Wq));
}

}  // namespace

extern "C" {

// Each entry point launches one kernel on `stream` over the grid
// (T1/QB, H, B) and returns the CUDA error code (0 on success).
// bf16 != 0 selects bfloat16 streams, else float32.

int banded_attention_fwd(const void* q, const void* k, const void* v, const int* lengths,
                         void* out, float* lse, int B, int T1, int H, int Dh, int C, int L,
                         int t_real, int QB, int offset, int bf16, float scale,
                         void* stream) {
  const int W = QB + L * C;
  const dim3 grid(T1 / QB, H, B);
  const size_t smem = fwd_smem(W, Dh);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    using T = __nv_bfloat16;
    return launch(banded_attention_fwd_kernel<T>, grid, smem, s, (const T*)q, (const T*)k,
                  (const T*)v, lengths, (T*)out, lse, T1, H, Dh, C, L, t_real, QB, offset,
                  scale);
  }
  return launch(banded_attention_fwd_kernel<float>, grid, smem, s, (const float*)q, (const float*)k,
                (const float*)v, lengths, (float*)out, lse, T1, H, Dh, C, L, t_real, QB,
                offset, scale);
}

int banded_attention_dq(const void* q, const void* k, const void* v, const void* g,
                        const float* lse, const float* delta, const int* lengths, void* dq,
                        int B, int T1, int H, int Dh, int C, int L, int t_real, int QB,
                        int offset, int bf16, float scale, void* stream) {
  const int W = QB + L * C;
  const dim3 grid(T1 / QB, H, B);
  const size_t smem = dq_smem(W, Dh);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    using T = __nv_bfloat16;
    return launch(banded_attention_dq_kernel<T>, grid, smem, s, (const T*)q, (const T*)k,
                  (const T*)v, (const T*)g, lse, delta, lengths, (T*)dq, T1, H, Dh, C, L,
                  t_real, QB, offset, scale);
  }
  return launch(banded_attention_dq_kernel<float>, grid, smem, s, (const float*)q, (const float*)k,
                (const float*)v, (const float*)g, lse, delta, lengths, (float*)dq, T1, H,
                Dh, C, L, t_real, QB, offset, scale);
}

int banded_attention_dkv(const void* q, const void* k, const void* v, const void* g,
                         const float* lse, const float* delta, const int* lengths, void* dk,
                         void* dv, int B, int T1, int H, int Dh, int C, int L, int t_real,
                         int QB, int offset, int bf16, float scale, void* stream) {
  const int Wq = QB + L * C;
  const dim3 grid(T1 / QB, H, B);
  const size_t smem = dkv_smem(Wq, Dh);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    using T = __nv_bfloat16;
    return launch(banded_attention_dkv_kernel<T>, grid, smem, s, (const T*)q, (const T*)k,
                  (const T*)v, (const T*)g, lse, delta, lengths, (T*)dk, (T*)dv, T1, H, Dh,
                  C, L, t_real, QB, offset, scale);
  }
  return launch(banded_attention_dkv_kernel<float>, grid, smem, s, (const float*)q, (const float*)k,
                (const float*)v, (const float*)g, lse, delta, lengths, (float*)dk,
                (float*)dv, T1, H, Dh, C, L, t_real, QB, offset, scale);
}

}  // extern "C"
