// The fused attention layer for Hopper (sm_90a): K3f's CUDA-core body.
//
// Replaces ecog2txt_tpu/ops/pallas_attention.py::_fused_fwd_call (the
// pallas_call at :579): LayerNorm (f32 statistics, eps 1e-6) -> the q,
// k, v projections with rotary as two products per projection, against
// W and the sign-permuted W@R -> the chunk-causal attention of K2f;
// optionally it saves q, k, v and the per-head LSE for the backward
// (which is K2b plus plain products, ops/attention_kernels.py).
//
// Design: one block per (query block n, head h, batch row b), as K2f.
// The block recomputes the LayerNorm of its QB + L*C window rows (f32
// statistics in shared memory) and runs the five projections of its
// head in its own body: the (D, D) weights do not fit shared memory, so
// for each projection the contraction over D is streamed in tiles of
// KT columns (the LayerNorm output of the window rows, computed on the
// fly, and the matching KT x Dh slice of the weight), each thread
// keeping a column strip of the result in registers.  KT, the tile's
// width (a launch argument, so no instantiation is added for it), is 32,
// or 16 where a 32-column weight tile does not fit beside the window (head
// dims 506-512 at chunk 16, left context 1); the LayerNorm
// tile holds the rows a pass really takes, min(kPassRows, window rows).
// Both change the staging only: the contraction runs over the same columns
// in the same order at either width.  Results are
// rounded to the stream dtype where the Pallas kernel rounds: the
// LayerNorm output, each product, cos and sin, and each step of
// S(x*cos) + S(xr*sin).  A thread takes NC head columns of a projection,
// a template parameter the host picks from the head dim: NC = 1 up to
// 256 (the common head dims run the same code as before), NC =
// ceil(Dh / 256) above, so any even head dim up to 512 runs; the query
// block shrinks until the window fits shared memory (32 rows at head dim
// 288, 16 at 384 and above; ops/attention_kernels.py::
// plan_fused_query_rows, which also picks KT).
// q, k and v of the window stay in shared memory as f32 and feed the
// attention of K2f's CUDA-core body (attention_common.cuh).
//
// Bound on the card: at the conformer's shapes the projections dominate
// (~2*(2*QB + 3*W)*D*Dh operations per block and head, recomputing the
// L*C previous rows' k/v).  This body runs them on the CUDA cores from
// shared memory: it is K3f's f32 body (the tensor cores have no f32
// product, and TF32 would break the f32 tolerance), and bf16's only where
// the tensor-core body's block does not fit.  bf16 streams run the
// tensor-core body, fused_attention_tc.cu (ops/attention_kernels.py::
// plan_k3f_body).

#include "attention_common.cuh"

using namespace attn;

namespace {

// contraction columns per streamed tile: KT = 1 << Layer::kt_shift (32 or
// 16); the LayerNorm tile's row stride is KT + 4 (16-byte rows)
constexpr int kMaxAcc = 48;     // result elements a thread keeps per pass
constexpr int kPassRows = 192;  // window rows per projection pass, at most

struct Layer {
  int T1, H, Dh, C, L, t_real, QB, offset, kt_shift;
  float scale, eps;
};

// Result of one projection of window rows [lo, hi) (local row w is
// sequence row base - PREV + w) against columns [h*Dh, (h+1)*Dh) of
// `w`, rounded to the stream dtype.  With `rot` (the second product of a
// rotary pair), dst already holds S(lnx . W) and becomes
// S(S(dst * cos) + S(S(lnx . W@R) * sin)); else dst = S(lnx . W).
// dst row w - lo, stride Dh + 1.  NC is the number of head columns a
// thread takes: the head's columns form Dc = ceil(Dh / NC) column groups,
// and thread (ty, col) takes columns col, col + Dc, ... (NC of them, those
// below Dh) for rows ty, ty + RG, ... with RG = kThreads / Dc row groups.
// A head dim up to kThreads runs NC = 1, one column a thread; a wider
// head runs NC = ceil(Dh / kThreads) (the host picks the instantiation),
// keeping kMaxAcc results a thread in all.  Where Dc does not divide
// kThreads, kThreads - RG * Dc threads are over (ty >= RG): they stage
// tiles and reach every barrier but own no result.
template <typename T, int NC>
__device__ void project(float* dst, int lo, int hi, bool rot, const T* xb, const float* mu,
                        const float* rs, const float* lng, const float* lnb, const T* w,
                        const float* freq, int h, int base, const Layer& P, float* ltile,
                        float* wtile) {
  constexpr int kAcc = kMaxAcc / NC;  // results a thread keeps per column and pass
  const int KT = 1 << P.kt_shift, kLStride = KT + 4;
  const int Dh = P.Dh, D = P.H * Dh, PREV = P.L * P.C, stride = Dh + 1;
  const int Dc = (Dh + NC - 1) / NC;
  const int RG = kThreads / Dc, ty = threadIdx.x / Dc, col = threadIdx.x % Dc;
  // rows per pass: at most kAcc results a thread and column (ceil(PR / RG) <= kAcc)
  const int PR = min(kPassRows, kAcc * RG), nacc = ty < RG ? (PR + RG - 1) / RG : 0;
  for (int p0 = lo; p0 < hi; p0 += PR) {
    const int prow = min(PR, hi - p0);
    float acc[NC][kAcc];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int a = 0; a < kAcc; ++a) acc[c][a] = 0.f;
    for (int d0 = 0; d0 < D; d0 += KT) {
      const int tk = min(KT, D - d0);
      __syncthreads();  // the previous tiles are consumed
      for (int idx = threadIdx.x; idx < prow * KT; idx += kThreads) {
        const int r = idx >> P.kt_shift, c = idx & (KT - 1);
        const int wr = p0 + r, gr = base - PREV + wr;
        float val = 0.f;
        if (c < tk && gr >= 0) {
          const float xv = to_f<T>(xb[(size_t)gr * D + d0 + c]);
          val = rnd<T>(__fadd_rn(__fmul_rn(__fmul_rn(xv - mu[wr], rs[wr]), lng[d0 + c]),
                                 lnb[d0 + c]));
        }
        ltile[r * kLStride + c] = val;
      }
      for (int idx = threadIdx.x; idx < KT * Dh; idx += kThreads) {
        const int kk = idx / Dh, c = idx - kk * Dh;
        wtile[idx] = kk < tk ? to_f<T>(w[(size_t)(d0 + kk) * D + h * Dh + c]) : 0.f;
      }
      __syncthreads();
      // four contraction columns per step: one 16-byte load of the
      // LayerNorm row per result row (columns past tk are zeros in both
      // tiles, so they add exact zeros)
      for (int kk = 0; kk < tk; kk += 4) {
        float wv[NC][4];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int cc = col + c * Dc;
          const bool own = NC == 1 || cc < Dh;
#pragma unroll
          for (int j = 0; j < 4; ++j) wv[c][j] = own ? wtile[(kk + j) * Dh + cc] : 0.f;
        }
#pragma unroll
        for (int a = 0; a < kAcc; ++a) {
          const int r = ty + a * RG;
          if (a < nacc && r < prow) {
            const float4 l = *reinterpret_cast<const float4*>(ltile + r * kLStride + kk);
#pragma unroll
            for (int c = 0; c < NC; ++c)
              acc[c][a] = fmaf(l.w, wv[c][3],
                               fmaf(l.z, wv[c][2], fmaf(l.y, wv[c][1], fmaf(l.x, wv[c][0], acc[c][a]))));
          }
        }
      }
    }
#pragma unroll
    for (int a = 0; a < kAcc; ++a) {
      const int r = ty + a * RG;
      if (a < nacc && r < prow) {
        const int wr = p0 + r;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int cc = col + c * Dc;
          if (NC > 1 && cc >= Dh) continue;
          float* o = dst + (wr - lo) * stride + cc;
          const float y = rnd<T>(acc[c][a]);
          if (rot) {
            const float ang =
                __fmul_rn((float)(base - PREV + P.offset + wr), freq[h * Dh + cc]);
            const float cs = rnd<T>(cosf(ang)), sn = rnd<T>(sinf(ang));
            *o = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(*o, cs)), rnd<T>(__fmul_rn(y, sn))));
          } else {
            *o = y;
          }
        }
      }
    }
  }
  __syncthreads();
}

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
    fused_attention_fwd_kernel(const T* __restrict__ x, const T* __restrict__ wq,
                               const T* __restrict__ wqr, const T* __restrict__ wk,
                               const T* __restrict__ wkr, const T* __restrict__ wv,
                               const float* __restrict__ lng, const float* __restrict__ lnb,
                               const float* __restrict__ freq, const int* __restrict__ lengths,
                               T* __restrict__ out, T* __restrict__ qs, T* __restrict__ ks,
                               T* __restrict__ vs, float* __restrict__ lse, Layer P,
                               int save) {
  const int n = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int Dh = P.Dh, D = P.H * Dh, PREV = P.L * P.C, QB = P.QB, W = QB + PREV;
  const int stride = Dh + 1, T1 = P.T1;
  const int base = n * QB;
  const size_t boff = (size_t)b * T1 * D;
  const T* xb = x + boff;
  extern __shared__ float smem[];
  const int KT = 1 << P.kt_shift;
  float* ltile = smem;                               // min(kPassRows, W) x (KT + 4)
  float* wtile = ltile + min(kPassRows, W) * (KT + 4);  // KT x Dh (16-byte aligned)
  float* qsm = wtile + KT * Dh;                      // QB x stride: rotated q
  float* ksm = qsm + QB * stride;              // W x stride: rotated k
  float* vsm = ksm + W * stride;               // W x stride: v
  float* mu = vsm + W * stride;                // W: row means
  float* rs = mu + W;                          // W: row 1/sqrt(var + eps)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* sbuf = rs + W + warp * W;

  // LayerNorm statistics of the window rows (rows before the sequence
  // are never read: their keys are masked)
  for (int wr = warp; wr < W; wr += kWarps) {
    const int gr = base - PREV + wr;
    float m = 0.f, r = 0.f;
    if (gr >= 0) {
      const T* xr = xb + (size_t)gr * D;
      float part = 0.f;
      for (int d = lane; d < D; d += 32) part += to_f<T>(xr[d]);
      m = warp_sum(part) / (float)D;
      part = 0.f;
      for (int d = lane; d < D; d += 32) {
        const float c = to_f<T>(xr[d]) - m;
        part = fmaf(c, c, part);
      }
      r = rsqrtf(warp_sum(part) / (float)D + P.eps);
    }
    if (lane == 0) {
      mu[wr] = m;
      rs[wr] = r;
    }
  }
  __syncthreads();

  project<T, NC>(qsm, PREV, W, false, xb, mu, rs, lng, lnb, wq, freq, h, base, P, ltile, wtile);
  project<T, NC>(qsm, PREV, W, true, xb, mu, rs, lng, lnb, wqr, freq, h, base, P, ltile, wtile);
  project<T, NC>(ksm, 0, W, false, xb, mu, rs, lng, lnb, wk, freq, h, base, P, ltile, wtile);
  project<T, NC>(ksm, 0, W, true, xb, mu, rs, lng, lnb, wkr, freq, h, base, P, ltile, wtile);
  project<T, NC>(vsm, 0, W, false, xb, mu, rs, lng, lnb, wv, freq, h, base, P, ltile, wtile);

  const Band band{P.C, P.L, P.t_real, P.offset, lengths[b]};
  for (int i = warp; i < QB; i += kWarps) {
    const int gq = base + i;
    const size_t row = boff + (size_t)gq * D + h * Dh;
    attend_row<T>(qsm + i * stride, ksm, vsm, stride, W, Dh, P.scale, band, gq,
                  base - PREV, sbuf, out + row,
                  save ? lse + ((size_t)b * T1 + gq) * P.H + h : nullptr, lane);
  }
  if (save) {
    for (int idx = threadIdx.x; idx < QB * Dh; idx += kThreads) {
      const int i = idx / Dh, d = idx - i * Dh;
      const size_t o = boff + (size_t)(base + i) * D + h * Dh + d;
      qs[o] = from_f<T>(qsm[i * stride + d]);
      ks[o] = from_f<T>(ksm[(PREV + i) * stride + d]);
      vs[o] = from_f<T>(vsm[(PREV + i) * stride + d]);
    }
  }
}

// Shared memory of one block, in bytes; ops/attention_kernels.py::
// _fused_smem computes the same sum to pick the query block.
size_t fused_smem(int QB, int W, int Dh, int KT) {
  return sizeof(float) * ((size_t)(QB + 2 * W) * (Dh + 1) + 2 * (size_t)W +
                          (size_t)(W < kPassRows ? W : kPassRows) * (KT + 4) + (size_t)KT * Dh +
                          (size_t)kWarps * W);
}

template <typename T, int NC>
int launch_fused(const void* x, const void* wq, const void* wqr, const void* wk,
                 const void* wkr, const void* wv, const float* lng, const float* lnb,
                 const float* freq, const int* lengths, void* out, void* qs, void* ks,
                 void* vs, float* lse, dim3 grid, size_t smem, cudaStream_t s, const Layer& P,
                 int save) {
  return launch(fused_attention_fwd_kernel<T, NC>, grid, smem, s, (const T*)x, (const T*)wq,
                (const T*)wqr, (const T*)wk, (const T*)wkr, (const T*)wv, lng, lnb, freq,
                lengths, (T*)out, (T*)qs, (T*)ks, (T*)vs, lse, P, save);
}

template <typename T>
int dispatch_columns(int NC, const void* x, const void* wq, const void* wqr, const void* wk,
                     const void* wkr, const void* wv, const float* lng, const float* lnb,
                     const float* freq, const int* lengths, void* out, void* qs, void* ks,
                     void* vs, float* lse, dim3 grid, size_t smem, cudaStream_t s,
                     const Layer& P, int save) {
  switch (NC) {
    case 1:
      return launch_fused<T, 1>(x, wq, wqr, wk, wkr, wv, lng, lnb, freq, lengths, out, qs, ks,
                                vs, lse, grid, smem, s, P, save);
    case 2:
      return launch_fused<T, 2>(x, wq, wqr, wk, wkr, wv, lng, lnb, freq, lengths, out, qs, ks,
                                vs, lse, grid, smem, s, P, save);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches K3f on `stream` over the grid (T1/QB, H, B) and returns the
// CUDA error code (0 on success).  bf16 != 0 selects bfloat16 streams.
// With save == 0, qs, ks, vs and lse may be null.  The projections take
// NC = ceil(Dh / kThreads) head columns a thread: 1 up to a head dim of
// 256, 2 up to 512 (wider heads do not fit shared memory anyway); tile is
// the streamed tiles' width, 32 or 16 (the wrapper picks it from the
// shared memory).
int fused_attention_fwd(const void* x, const void* wq, const void* wqr, const void* wk,
                        const void* wkr, const void* wv, const float* lng, const float* lnb,
                        const float* freq, const int* lengths, void* out, void* qs, void* ks,
                        void* vs, float* lse, int B, int T1, int H, int Dh, int C, int L,
                        int t_real, int QB, int offset, int bf16, int save, int tile,
                        float scale, float eps, void* stream) {
  if (tile != 32 && tile != 16) return (int)cudaErrorInvalidValue;
  const int W = QB + L * C;
  const dim3 grid(T1 / QB, H, B);
  const size_t smem = fused_smem(QB, W, Dh, tile);
  const Layer P{T1, H, Dh, C, L, t_real, QB, offset, tile == 32 ? 5 : 4, scale, eps};
  const int NC = (Dh + kThreads - 1) / kThreads;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    return dispatch_columns<__nv_bfloat16>(NC, x, wq, wqr, wk, wkr, wv, lng, lnb, freq, lengths,
                                           out, qs, ks, vs, lse, grid, smem, s, P, save);
  }
  return dispatch_columns<float>(NC, x, wq, wqr, wk, wkr, wv, lng, lnb, freq, lengths, out, qs,
                                 ks, vs, lse, grid, smem, s, P, save);
}

}  // extern "C"
