// Shared device code of the LSTM recurrence kernels: the forward
// recurrence of K1f (lstm_recurrence.cu) and the adjoint of K1b
// (lstm_recurrence_bwd.cu), each as the body of one block that owns R
// batch rows, and the one-launch bidirectional grid K4f / K4b
// (bilstm_grid.cu), whose blocks run the same bodies for one direction
// each.  One cell, one set of rounding points and one threading scheme
// for all four kernels.
//
// Cell (gates packed i, g, f, o; +1 on the forget gate), with S the
// stream type (float or bf16):
//
//   gates = f32(xw[t]) + S(h * mask) @ S(wh)        (f32 accumulation)
//   c' = sigmoid(f + 1) * c + sigmoid(i) * tanh(g)
//   h' = sigmoid(o) * tanh(c')
//
// For t >= length the carry freezes and h_seq[t] is 0.  reverse_time
// walks t = T-1 down to 0 (the backward direction of a biLSTM with no
// sequence reversal): steps t >= length are no-ops, so each row starts
// at t = length-1.
//
// Threading: thread u owns hidden unit u for all R rows of the block.
// In the forward it accumulates the four gate columns u, H+u, 2H+u, 3H+u
// in registers, reading wh from global memory (coalesced across the
// threads, L2-resident across steps) and the broadcast operand h * mask
// from shared memory (double-buffered), so h, c and the mask stay in
// registers and one barrier per step suffices.  The adjoint has two
// barrier-closed phases per step: recompute the gates and form unit u's
// dgates (stored to global memory and to shared memory), then reduce the
// shared 4H-wide dgates row against row u of wh, read through its
// transpose whT (4H, H) so a warp's threads read consecutive addresses.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace lstm {

template <typename S>
struct Stream;

template <>
struct Stream<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ float store(float x) { return x; }
  static __device__ __forceinline__ float round(float x) { return x; }
};

template <>
struct Stream<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float x) {
    return __float2bfloat16_rn(x);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Threads per block: one per hidden unit, rounded up to whole warps.  Four
// or more rows per block hold ~12 registers per row per thread, so those
// instantiations are limited to 512 threads (H <= 512): K1f and K1b
// declare __launch_bounds__(R <= 2 ? 1024 : 512), K4f and K4b 512 unless
// H > 512 (bilstm_grid.cu).
inline int threads_for(int H) { return (H + 31) / 32 * 32; }

// Shared memory of one block, in bytes.
template <int R>
size_t fwd_smem(int H) { return 2 * static_cast<size_t>(R) * H * sizeof(float); }
template <int R>
size_t bwd_smem(int H) { return 5 * static_cast<size_t>(R) * H * sizeof(float); }

// The forward recurrence of rows [row0, row0 + R).  h0 and c0 may be null
// (a zero initial state); c_seq may be null (not stored).  The block's
// dynamic shared memory holds [2][R][H] floats (fwd_smem).
template <typename S, int R>
__device__ __forceinline__ void fwd_rows(const S* __restrict__ xw,         // (T, B, 4H)
                                         const S* __restrict__ wh,         // (H, 4H)
                                         const int* __restrict__ lengths,  // (B,)
                                         const float* __restrict__ h0,     // (B, H)
                                         const float* __restrict__ c0,     // (B, H)
                                         const float* __restrict__ mask,   // (B, H)
                                         S* __restrict__ h_seq,            // (T, B, H)
                                         S* __restrict__ c_seq,            // (T, B, H)
                                         float* __restrict__ hT,           // (B, H)
                                         float* __restrict__ cT,           // (B, H)
                                         int T, int B, int H, int reverse_time, int row0) {
  extern __shared__ float hm_buf[];  // [2][R][H]: S(h * mask), two steps
  const int u = threadIdx.x;
  const bool active = u < H;
  const size_t G = 4 * static_cast<size_t>(H);

  float h[R], c[R], m[R];
  int len[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r;
    const bool ok = active && row < B;
    const size_t o = static_cast<size_t>(row) * H + u;
    h[r] = ok && h0 != nullptr ? h0[o] : 0.0f;
    c[r] = ok && c0 != nullptr ? c0[o] : 0.0f;
    m[r] = ok ? mask[o] : 0.0f;
    len[r] = row < B ? lengths[row] : 0;
    if (active) hm_buf[r * H + u] = Stream<S>::round(h[r] * m[r]);
  }
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    const int t = reverse_time ? T - 1 - s : s;
    const float* cur = hm_buf + (s & 1) * R * H;
    float* nxt = hm_buf + ((s + 1) & 1) * R * H;
    if (active) {
      // this step's input projection, loaded ahead of the product
      float xi[R], xg[R], xf[R], xo[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = row0 + r;
        xi[r] = xg[r] = xf[r] = xo[r] = 0.0f;
        if (row < B) {
          const S* x = xw + (static_cast<size_t>(t) * B + row) * G + u;
          xi[r] = Stream<S>::load(x);
          xg[r] = Stream<S>::load(x + H);
          xf[r] = Stream<S>::load(x + 2 * H);
          xo[r] = Stream<S>::load(x + 3 * H);
        }
      }
      float ai[R], ag[R], af[R], ao[R];
#pragma unroll
      for (int r = 0; r < R; ++r) ai[r] = ag[r] = af[r] = ao[r] = 0.0f;
      const S* w = wh + u;
#pragma unroll 4
      for (int k = 0; k < H; ++k) {
        const S* wk = w + k * G;
        const float wi = Stream<S>::load(wk);
        const float wg = Stream<S>::load(wk + H);
        const float wf = Stream<S>::load(wk + 2 * H);
        const float wo = Stream<S>::load(wk + 3 * H);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float a = cur[r * H + k];
          ai[r] = fmaf(a, wi, ai[r]);
          ag[r] = fmaf(a, wg, ag[r]);
          af[r] = fmaf(a, wf, af[r]);
          ao[r] = fmaf(a, wo, ao[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = row0 + r;
        if (row < B) {
          const bool valid = t < len[r];
          if (valid) {
            const float gi = xi[r] + ai[r];
            const float gg = xg[r] + ag[r];
            const float gf = xf[r] + af[r];
            const float go = xo[r] + ao[r];
            c[r] = sigmoid(gf + 1.0f) * c[r] + sigmoid(gi) * tanhf(gg);
            h[r] = sigmoid(go) * tanhf(c[r]);
          }
          const size_t o = (static_cast<size_t>(t) * B + row) * H + u;
          h_seq[o] = Stream<S>::store(valid ? h[r] : 0.0f);
          if (c_seq != nullptr) c_seq[o] = Stream<S>::store(c[r]);
        }
        nxt[r * H + u] = Stream<S>::round(h[r] * m[r]);
      }
    }
    __syncthreads();
  }

  if (active) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = row0 + r;
      if (row < B) {
        const size_t o = static_cast<size_t>(row) * H + u;
        hT[o] = h[r];
        cT[o] = c[r];
      }
    }
  }
}

// The adjoint of rows [row0, row0 + R): walks t = T-1 down to 0 (0 up to
// T-1 when the recurrence ran reverse_time) and, for each step,
//
//   h_in   = S(f32(hprev[t]) * mask)
//   gates  = f32(xw[t]) + h_in @ S(wh)              (recomputed, f32 acc.)
//   dh_t   = dh + dhseq[t]          (dhseq only where t < length)
//   do     = dh_t * tanh(c_t) * so * (1 - so)
//   dct    = dh_t * so * (1 - tanh(c_t)^2) + dc
//   di     = dct * tanh(g) * si * (1 - si)
//   dg     = dct * si * (1 - tanh(g)^2)
//   df     = dct * c_{t-1} * sf * (1 - sf)         (sf = sigmoid(f + 1))
//   dgates[t] = S([di, dg, df, do])                 (0 where t >= length)
//   dh     = (dgates[t] @ S(wh)^T) * mask,  dc = dct * sf   (t < length)
//
// with c_t = f32(cseq[t]), c_{t-1} = f32(cprev[t]); steps t >= length
// leave dh and dc unchanged.  dh0/dc0 get the final dh and dc in f32.
// The block's dynamic shared memory holds [R][H] + [R][4H] floats
// (bwd_smem).
template <typename S, int R>
__device__ __forceinline__ void bwd_rows(const S* __restrict__ xw,         // (T, B, 4H)
                                         const S* __restrict__ wh,         // (H, 4H)
                                         const S* __restrict__ whT,        // (4H, H)
                                         const S* __restrict__ hprev,      // (T, B, H)
                                         const S* __restrict__ cprev,      // (T, B, H)
                                         const S* __restrict__ cseq,       // (T, B, H)
                                         const int* __restrict__ lengths,  // (B,)
                                         const float* __restrict__ mask,   // (B, H)
                                         const S* __restrict__ dhseq,      // (T, B, H)
                                         const float* __restrict__ dhT,    // (B, H)
                                         const float* __restrict__ dcT,    // (B, H)
                                         S* __restrict__ dgates,           // (T, B, 4H)
                                         float* __restrict__ dh0,          // (B, H)
                                         float* __restrict__ dc0,          // (B, H)
                                         int T, int B, int H, int reverse_time, int row0) {
  extern __shared__ float smem[];
  float* hin = smem;          // [R][H]:  S(hprev * mask) of this step
  float* dgs = smem + R * H;  // [R][4H]: S(dgates) of this step
  const int u = threadIdx.x;
  const bool active = u < H;
  const size_t G = 4 * static_cast<size_t>(H);

  float dh[R], dc[R], m[R];
  int len[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r;
    const bool ok = active && row < B;
    const size_t o = static_cast<size_t>(row) * H + u;
    dh[r] = ok ? dhT[o] : 0.0f;
    dc[r] = ok ? dcT[o] : 0.0f;
    m[r] = ok ? mask[o] : 0.0f;
    len[r] = row < B ? lengths[row] : 0;
  }

  for (int s = 0; s < T; ++s) {
    const int t = reverse_time ? s : T - 1 - s;
    // ---- phase 0: the shared operand S(hprev * mask) ----
    if (active) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = row0 + r;
        float v = 0.0f;
        if (row < B) {
          v = Stream<S>::load(hprev + (static_cast<size_t>(t) * B + row) * H + u) * m[r];
        }
        hin[r * H + u] = Stream<S>::round(v);
      }
    }
    __syncthreads();
    // ---- phase 1: recompute the gates, form and store dgates ----
    if (active) {
      float ai[R], ag[R], af[R], ao[R];
#pragma unroll
      for (int r = 0; r < R; ++r) ai[r] = ag[r] = af[r] = ao[r] = 0.0f;
      const S* w = wh + u;
#pragma unroll 4
      for (int k = 0; k < H; ++k) {
        const S* wk = w + k * G;
        const float wi = Stream<S>::load(wk);
        const float wg = Stream<S>::load(wk + H);
        const float wf = Stream<S>::load(wk + 2 * H);
        const float wo = Stream<S>::load(wk + 3 * H);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float a = hin[r * H + k];
          ai[r] = fmaf(a, wi, ai[r]);
          ag[r] = fmaf(a, wg, ag[r]);
          af[r] = fmaf(a, wf, af[r]);
          ao[r] = fmaf(a, wo, ao[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = row0 + r;
        float di = 0.0f, dg = 0.0f, df = 0.0f, dov = 0.0f;
        if (row < B && t < len[r]) {
          const size_t o = (static_cast<size_t>(t) * B + row) * H + u;
          const S* x = xw + (static_cast<size_t>(t) * B + row) * G + u;
          const float si = sigmoid(Stream<S>::load(x) + ai[r]);
          const float tg = tanhf(Stream<S>::load(x + H) + ag[r]);
          const float sf = sigmoid(Stream<S>::load(x + 2 * H) + af[r] + 1.0f);
          const float so = sigmoid(Stream<S>::load(x + 3 * H) + ao[r]);
          const float tc = tanhf(Stream<S>::load(cseq + o));
          const float dht = dh[r] + Stream<S>::load(dhseq + o);
          dov = dht * tc * so * (1.0f - so);
          const float dct = dht * so * (1.0f - tc * tc) + dc[r];
          di = dct * tg * si * (1.0f - si);
          dg = dct * si * (1.0f - tg * tg);
          df = dct * Stream<S>::load(cprev + o) * sf * (1.0f - sf);
          dc[r] = dct * sf;
        }
        di = Stream<S>::round(di);
        dg = Stream<S>::round(dg);
        df = Stream<S>::round(df);
        dov = Stream<S>::round(dov);
        float* d = dgs + r * G + u;
        d[0] = di;
        d[H] = dg;
        d[2 * H] = df;
        d[3 * H] = dov;
        if (row < B) {
          S* out = dgates + (static_cast<size_t>(t) * B + row) * G + u;
          out[0] = Stream<S>::store(di);
          out[H] = Stream<S>::store(dg);
          out[2 * H] = Stream<S>::store(df);
          out[3 * H] = Stream<S>::store(dov);
        }
      }
    }
    __syncthreads();
    // ---- phase 2: dh_prev[u] = (S(dgates) @ S(wh)^T)[u] * mask ----
    if (active) {
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.0f;
      const S* w = whT + u;
#pragma unroll 4
      for (int j = 0; j < static_cast<int>(G); ++j) {
        const float wj = Stream<S>::load(w + static_cast<size_t>(j) * H);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(dgs[r * G + j], wj, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (t < len[r]) dh[r] = acc[r] * m[r];
      }
    }
    // the next step's phase 0 writes hin, which phase 1 above finished
    // reading before the last barrier; it writes dgs only after the next
    // barrier, when every thread has left this phase 2
  }

  if (active) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = row0 + r;
      if (row < B) {
        const size_t o = static_cast<size_t>(row) * H + u;
        dh0[o] = dh[r];
        dc0[o] = dc[r];
      }
    }
  }
}

// Raise the dynamic shared memory limit of `kernel` where it needs more
// than the default 48 KB.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// Whether rows (1, 2, 4 or 8 batch rows per block) and H are taken.
inline bool shape_ok(int T, int B, int H, int rows) {
  return T >= 0 && B > 0 && H > 0 && H <= 1024 && !(rows > 2 && H > 512) &&
         (rows == 1 || rows == 2 || rows == 4 || rows == 8);
}

}  // namespace lstm
