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
// inside the kernel (lstm_common.cuh::bwd_rows, shared with the
// bidirectional grid K4b); thread u owns hidden unit u, and dh, dc and the
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
// bandwidth the limit at large B.
//
// This is the "rows" body.  bf16 streams at widths whose slice of wh
// fits a thread-block cluster run the "cluster" body instead
// (lstm_bwd_cluster.cu: wh resident in shared memory across the cluster,
// only the dh chain serial, both products on the tensor cores); the
// wrapper picks the body before the launch (ops/lstm_kernels.py::
// plan_bwd_body).  This body stays for f32 streams (the tensor cores have
// no f32 product, and TF32 would break the f32 tolerance) and for wider
// layers, and its bwd_rows is also K4b's body for those (bilstm_grid.cu).
//
// Plain C interface, loaded with ctypes; the launch goes on the caller's
// stream and the function returns cudaGetLastError().

#include "lstm_common.cuh"

namespace {

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
  lstm::bwd_rows<S, R>(xw, wh, whT, hprev, cprev, cseq, lengths, mask, dhseq, dhT, dcT,
                       dgates, dh0, dc0, T, B, H, reverse_time, blockIdx.x * R);
}

template <typename S, int R>
cudaError_t launch(const void* xw, const void* wh, const void* whT,
                   const void* hprev, const void* cprev, const void* cseq,
                   const void* lengths, const void* mask, const void* dhseq,
                   const void* dhT, const void* dcT, void* dgates, void* dh0,
                   void* dc0, int T, int B, int H, int reverse_time,
                   cudaStream_t stream) {
  const size_t smem = lstm::bwd_smem<R>(H);
  auto kernel = lstm_recurrence_bwd_kernel<S, R>;
  const cudaError_t err = lstm::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(B + R - 1) / R, lstm::threads_for(H), smem, stream>>>(
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
  if (!lstm::shape_ok(T, B, H, rows)) {
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
