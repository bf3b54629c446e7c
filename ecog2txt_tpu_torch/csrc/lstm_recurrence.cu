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
// and loops over t inside the kernel (lstm_common.cuh::fwd_rows, shared
// with the bidirectional grid K4f).  Thread u owns hidden unit u for
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

#include "lstm_common.cuh"

namespace {

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
  lstm::fwd_rows<S, R>(xw, wh, lengths, h0, c0, mask, h_seq, c_seq, hT, cT, T, B, H,
                       reverse_time, blockIdx.x * R);
}

template <typename S, int R>
cudaError_t launch(const void* xw, const void* wh, const void* lengths,
                   const void* h0, const void* c0, const void* mask,
                   void* h_seq, void* c_seq, void* hT, void* cT, int T,
                   int B, int H, int reverse_time, cudaStream_t stream) {
  const size_t smem = lstm::fwd_smem<R>(H);
  auto kernel = lstm_recurrence_fwd_kernel<S, R>;
  const cudaError_t err = lstm::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(B + R - 1) / R, lstm::threads_for(H), smem, stream>>>(
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
  if (!lstm::shape_ok(T, B, H, rows)) {
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
