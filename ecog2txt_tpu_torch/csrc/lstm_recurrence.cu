// LSTM recurrence forward (kernel K1f) for NVIDIA Hopper (sm_90a).
//
// Replaces: ecog2txt_tpu/ops/pallas_lstm.py::_fwd_call (the Pallas TPU
// kernel built by _make_fwd_kernel, reached through
// fused_lstm_recurrence).  One launch runs the whole serial recurrence
//
//   gates = f32(xw[t]) + S(h * mask) @ S(wh)        (f32 accumulation)
//   i, g, f, o = split(gates)                        (packed i, g, f, o)
//   c' = sigmoid(f + 1) * c + sigmoid(i) * tanh(g)
//   h' = sigmoid(o) * tanh(c')
//
// where S is the stream type (float or bf16).  For t >= length the carry
// freezes and h_seq[t] is 0; h_seq (and c_seq, when asked for) are stored
// in the stream type, the final h and c in f32.  reverse_time walks
// t = T-1 down to 0 (the backward direction of a biLSTM with no sequence
// reversal): steps t >= length are no-ops, so each row starts at
// t = length-1 and its zeros land at the tail.
//
// What bounds it on this card.  At the serving shapes (H=400, T'=104) the
// recurrence is a chain of T' dependent (B, H) @ (H, 4H) products.  At
// B=256 the FLOPs and the bytes of xw + h_seq put the floor near 35 us,
// but at B=1 the floor is the serial chain itself: 104 steps, each a
// 1.3 MFLOP product whose operand wh (1.28 MB in bf16) is larger than one
// SM's shared memory, so every step streams wh from L2.
//
// Design (simple and right first).  Each block owns R rows of the batch
// and loops over t inside the kernel.  Thread u owns hidden unit u for
// all R rows: it accumulates the four gate columns u, H+u, 2H+u, 3H+u
// in registers, reading wh from global memory (coalesced across the
// threads, L2-resident across steps) and the broadcast operand h * mask
// from shared memory, then applies the cell itself, so h, c and the mask
// stay in registers and one barrier per step suffices (h * mask is
// double-buffered in shared memory).  R grows with B so the grid stays
// within one wave of SMs; each block re-reads wh every step, which makes
// L2 bandwidth the limit at large B.  Splitting wh across a thread-block
// cluster's distributed shared memory and using wgmma is later work.
//
// Plain C interface, loaded with ctypes; the launch goes on the caller's
// stream and the function returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

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

// Threads per block: one per hidden unit, rounded up to whole warps.
// Four or more rows per block hold ~12 registers per row per thread, so
// those instantiations are limited to 512 threads (H <= 512).
template <typename S, int R>
__global__ void __launch_bounds__(R <= 2 ? 1024 : 512)
lstm_recurrence_fwd_kernel(const S* __restrict__ xw,         // (T, B, 4H)
                           const S* __restrict__ wh,         // (H, 4H)
                           const int* __restrict__ lengths,  // (B,)
                           const float* __restrict__ h0,     // (B, H)
                           const float* __restrict__ c0,     // (B, H)
                           const float* __restrict__ mask,   // (B, H)
                           S* __restrict__ h_seq,            // (T, B, H)
                           S* __restrict__ c_seq,  // (T, B, H) or null
                           float* __restrict__ hT,  // (B, H)
                           float* __restrict__ cT,  // (B, H)
                           int T, int B, int H, int reverse_time) {
  extern __shared__ float hm_buf[];  // [2][R][H]: S(h * mask), two steps
  const int u = threadIdx.x;
  const bool active = u < H;
  const int row0 = blockIdx.x * R;
  const size_t G = 4 * static_cast<size_t>(H);

  float h[R], c[R], m[R];
  int len[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r;
    const bool ok = active && row < B;
    const size_t o = static_cast<size_t>(row) * H + u;
    h[r] = ok ? h0[o] : 0.0f;
    c[r] = ok ? c0[o] : 0.0f;
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

template <typename S, int R>
cudaError_t launch(const void* xw, const void* wh, const void* lengths,
                   const void* h0, const void* c0, const void* mask,
                   void* h_seq, void* c_seq, void* hT, void* cT, int T,
                   int B, int H, int reverse_time, cudaStream_t stream) {
  const int threads = (H + 31) / 32 * 32;
  const size_t smem = 2 * static_cast<size_t>(R) * H * sizeof(float);
  auto kernel = lstm_recurrence_fwd_kernel<S, R>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<(B + R - 1) / R, threads, smem, stream>>>(
      static_cast<const S*>(xw), static_cast<const S*>(wh),
      static_cast<const int*>(lengths), static_cast<const float*>(h0),
      static_cast<const float*>(c0), static_cast<const float*>(mask),
      static_cast<S*>(h_seq), static_cast<S*>(c_seq),
      static_cast<float*>(hT), static_cast<float*>(cT), T, B, H,
      reverse_time);
  return cudaGetLastError();
}

template <typename S>
cudaError_t dispatch_rows(int rows, const void* xw, const void* wh,
                          const void* lengths, const void* h0,
                          const void* c0, const void* mask, void* h_seq,
                          void* c_seq, void* hT, void* cT, int T, int B,
                          int H, int reverse_time, cudaStream_t stream) {
  switch (rows) {
    case 1:
      return launch<S, 1>(xw, wh, lengths, h0, c0, mask, h_seq, c_seq, hT,
                          cT, T, B, H, reverse_time, stream);
    case 2:
      return launch<S, 2>(xw, wh, lengths, h0, c0, mask, h_seq, c_seq, hT,
                          cT, T, B, H, reverse_time, stream);
    case 4:
      return launch<S, 4>(xw, wh, lengths, h0, c0, mask, h_seq, c_seq, hT,
                          cT, T, B, H, reverse_time, stream);
    case 8:
      return launch<S, 8>(xw, wh, lengths, h0, c0, mask, h_seq, c_seq, hT,
                          cT, T, B, H, reverse_time, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// rows: batch rows per block (1, 2, 4 or 8).  c_seq may be null.
extern "C" int lstm_recurrence_fwd(const void* xw, const void* wh,
                                   const void* lengths, const void* h0,
                                   const void* c0, const void* mask,
                                   void* h_seq, void* c_seq, void* hT,
                                   void* cT, int T, int B, int H,
                                   int is_bf16, int reverse_time, int rows,
                                   void* stream) {
  if (T < 0 || B <= 0 || H <= 0 || H > 1024 || (rows > 2 && H > 512)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dispatch_rows<__nv_bfloat16>(rows, xw, wh, lengths, h0, c0,
                                             mask, h_seq, c_seq, hT, cT, T,
                                             B, H, reverse_time, st)
              : dispatch_rows<float>(rows, xw, wh, lengths, h0, c0, mask,
                                     h_seq, c_seq, hT, cT, T, B, H,
                                     reverse_time, st);
  return static_cast<int>(err);
}
