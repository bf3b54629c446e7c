// LSTM recurrence adjoint (kernel K1b) for NVIDIA Hopper (sm_90a).
//
// Replaces: ecog2txt_tpu/ops/pallas_lstm.py::_bwd_call (the Pallas TPU
// kernel built by _make_bwd_kernel, run by the custom VJP of
// fused_lstm_recurrence).  One launch walks the whole sequence in adjoint
// order (t = T-1 down to 0, or 0 up to T-1 when the recurrence itself ran
// reverse_time) and, for each step,
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
// where S is the stream type (float or bf16), c_t = f32(cseq[t]) and
// c_{t-1} = f32(cprev[t]).  Steps t >= length leave dh and dc unchanged.
// dgates is stored in S, the final dh and dc (= dh0, dc0) in f32.  The
// weight gradient S(hprev * mask)^T @ dgates is one GEMM outside this
// kernel, as in the JAX package.
//
// What bounds it on this card.  At the training shapes (H=400, T'=104,
// B=256, bf16) each step is two dependent products, (B, H) @ (H, 4H) to
// recompute the gates and (B, 4H) @ (4H, H) to carry dh back, between
// which the whole 4H-wide dgates row must exist.  The FLOPs (4 T' B H 4H)
// and the bytes of xw, hprev, cprev, cseq, dhseq and dgates put the
// floor near 0.08 ms (bytes); the serial chain of 2 x 104 dependent
// products, each streaming wh (1.28 MB in bf16) from L2, sets the real
// floor well above that.
//
// Design (simple and right first), carried over from K1f
// (lstm_recurrence.cu).  Each block owns R batch rows and loops over t
// inside the kernel; thread u owns hidden unit u, and dh, dc and the
// mask of its R rows live in f32 registers.  Each step has two phases,
// each closed by a barrier:
//   1. thread u recomputes the four gate columns u, H+u, 2H+u, 3H+u from
//      the shared S(hprev * mask) row (written by every thread before a
//      first barrier), forms unit u's dgates and writes S(dgates) to
//      global memory and to shared memory;
//   2. thread u reduces the shared 4H-wide S(dgates) row against
//      column u of wh^T, i.e. row u of wh, to get dh_prev[u].
// Phase 2 reads wh through its transpose whT (4H, H), which the wrapper
// passes in, so the threads of a warp read consecutive addresses in both
// phases.  The rounding points are the Pallas kernel's (S(h_in) before
// the first product, S(dgates) before the second), so at f32 the kernel
// differs from the plain version by summation order only.  As in K1f,
// every block re-reads wh and whT from L2 every step, which makes L2
// bandwidth the limit at large B; keeping wh in distributed shared
// memory of a thread-block cluster and using wgmma is later work.
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
template <typename S, int R>
__global__ void __launch_bounds__(R <= 2 ? 1024 : 512)
lstm_recurrence_bwd_kernel(const S* __restrict__ xw,         // (T, B, 4H)
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
                           int T, int B, int H, int reverse_time) {
  extern __shared__ float smem[];
  float* hin = smem;          // [R][H]:  S(hprev * mask) of this step
  float* dgs = smem + R * H;  // [R][4H]: S(dgates) of this step
  const int u = threadIdx.x;
  const bool active = u < H;
  const int row0 = blockIdx.x * R;
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
          v = Stream<S>::load(hprev + (static_cast<size_t>(t) * B + row) * H +
                              u) *
              m[r];
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

template <typename S, int R>
cudaError_t launch(const void* xw, const void* wh, const void* whT,
                   const void* hprev, const void* cprev, const void* cseq,
                   const void* lengths, const void* mask, const void* dhseq,
                   const void* dhT, const void* dcT, void* dgates, void* dh0,
                   void* dc0, int T, int B, int H, int reverse_time,
                   cudaStream_t stream) {
  const int threads = (H + 31) / 32 * 32;
  const size_t smem = 5 * static_cast<size_t>(R) * H * sizeof(float);
  auto kernel = lstm_recurrence_bwd_kernel<S, R>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<(B + R - 1) / R, threads, smem, stream>>>(
      static_cast<const S*>(xw), static_cast<const S*>(wh),
      static_cast<const S*>(whT), static_cast<const S*>(hprev),
      static_cast<const S*>(cprev), static_cast<const S*>(cseq),
      static_cast<const int*>(lengths), static_cast<const float*>(mask),
      static_cast<const S*>(dhseq), static_cast<const float*>(dhT),
      static_cast<const float*>(dcT), static_cast<S*>(dgates),
      static_cast<float*>(dh0), static_cast<float*>(dc0), T, B, H,
      reverse_time);
  return cudaGetLastError();
}

template <typename S>
cudaError_t dispatch_rows(int rows, const void* xw, const void* wh,
                          const void* whT, const void* hprev,
                          const void* cprev, const void* cseq,
                          const void* lengths, const void* mask,
                          const void* dhseq, const void* dhT, const void* dcT,
                          void* dgates, void* dh0, void* dc0, int T, int B,
                          int H, int reverse_time, cudaStream_t stream) {
#define LSTM_BWD_LAUNCH(R)                                                  \
  launch<S, R>(xw, wh, whT, hprev, cprev, cseq, lengths, mask, dhseq, dhT, \
               dcT, dgates, dh0, dc0, T, B, H, reverse_time, stream)
  switch (rows) {
    case 1:
      return LSTM_BWD_LAUNCH(1);
    case 2:
      return LSTM_BWD_LAUNCH(2);
    case 4:
      return LSTM_BWD_LAUNCH(4);
    case 8:
      return LSTM_BWD_LAUNCH(8);
    default:
      return cudaErrorInvalidValue;
  }
#undef LSTM_BWD_LAUNCH
}

}  // namespace

// rows: batch rows per block (1, 2, 4 or 8).  whT is wh transposed,
// (4H, H) contiguous, in the stream type.
extern "C" int lstm_recurrence_bwd(const void* xw, const void* wh,
                                   const void* whT, const void* hprev,
                                   const void* cprev, const void* cseq,
                                   const void* lengths, const void* mask,
                                   const void* dhseq, const void* dhT,
                                   const void* dcT, void* dgates, void* dh0,
                                   void* dc0, int T, int B, int H,
                                   int is_bf16, int reverse_time, int rows,
                                   void* stream) {
  if (T < 0 || B <= 0 || H <= 0 || H > 1024 || (rows > 2 && H > 512)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dispatch_rows<__nv_bfloat16>(
                    rows, xw, wh, whT, hprev, cprev, cseq, lengths, mask,
                    dhseq, dhT, dcT, dgates, dh0, dc0, T, B, H, reverse_time,
                    st)
              : dispatch_rows<float>(rows, xw, wh, whT, hprev, cprev, cseq,
                                     lengths, mask, dhseq, dhT, dcT, dgates,
                                     dh0, dc0, T, B, H, reverse_time, st);
  return static_cast<int>(err);
}
