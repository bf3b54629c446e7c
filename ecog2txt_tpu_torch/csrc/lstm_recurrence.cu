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
// SM's shared memory.  Unlike the adjoint (K1b), the whole product sits on
// the chain: step t needs every unit of h[t-1].
//
// Two bodies, picked before the launch by ops/lstm_kernels.py::
// plan_fwd_body:
//
// - The cluster body (bf16 where a slice of wh fits; lstm_fwd_cluster.cuh,
//   which K4f shares).  A cluster of cs CTAs owns R = 16 or 32 batch rows
//   (one or two tensor-core M tiles; a ragged B is padded with rows that
//   are not stored); CTA c owns hidden units [c*Uc, (c+1)*Uc), Uc =
//   ceil(H / cs) rounded up to a multiple of 4.  Its slice of wh (H x 4Uc
//   bf16, the four gate columns of a unit side by side) is loaded once and
//   stays in shared memory: 173 KB at H=400, cs=8.  Each CTA also holds
//   the whole S(h * mask) of its R rows, double-buffered (26 KB at 16
//   rows).  A step:
//     1. wait at the cluster barrier: buffer s % 2 holds every unit;
//     2. gates = S(h * mask) @ slice on the tensor cores (mma.sync
//        m16n8k16, f32 accumulation; A and B by ldmatrix, B transposed),
//        warp w taking the gate columns of units 4w..4w+3;
//     3. one shuffle with the neighbouring lane gives each thread all four
//        gates of two adjacent units of one row: that thread keeps the
//        pairs' h, c, mask and length in registers for the whole launch,
//        adds xw and applies the cell;
//     4. all-gather: each thread pushes its row's S(h * mask) of the warp's
//        4 units (8 bytes, a swap with the lane of the other two units)
//        into buffer (s+1) % 2 of every CTA of the cluster
//        (st.shared::cluster), then barrier.cluster arrive.release;
//     5. off the chain, until the next wait: the next step's xw of the
//        thread's pairs comes into registers (the thread that loads is the
//        thread that uses, so no block barrier is needed), and h_seq /
//        c_seq go out as bf16 pairs.
//   One cluster barrier a step: double buffering makes the write-after-read
//   of a buffer safe, since a CTA pushes into buffer (s+1) % 2 only after
//   every CTA arrived past its product of step s-1.  The summation order is
//   fixed, so repeats are bit-identical, and a row's result does not depend
//   on the other rows of its tile (each row of an MMA's D is its own row of
//   A times B).  The step is latency-bound, and its cell costs each CTA
//   in proportion to its units, so the host (ops/lstm_kernels.py::
//   plan_fwd_body) takes the most CTAs (1, 2, 4 or 8) whose clusters all
//   stay resident at once, and the fewest whose slice fits where none do
//   or the tile is mostly padding (B < 16): 8 at H=400; at H=64 8 for
//   B=16, 4 for B=256, 1 for B=1.  32 rows a cluster where that saves
//   enough waves to pay for the slower 32-row step (K1f at B=256, H=400).
// - The rows body (f32 streams, and widths whose slice fits no cluster;
//   lstm_common.cuh::fwd_rows, shared with K4f): each block owns R rows and
//   loops over t; thread u owns hidden unit u for all R rows, accumulating
//   the four gate columns u, H+u, 2H+u, 3H+u on the CUDA cores and reading
//   wh from L2 every step, h * mask from shared memory (double-buffered),
//   one barrier a step.
//
// Plain C interface, loaded with ctypes; the launch goes on the caller's
// stream and each function returns the CUDA error code.

#include "lstm_common.cuh"
#include "lstm_fwd_cluster.cuh"

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

template <int MT>
__global__ void __launch_bounds__(lstm_cluster::kThreads, 1)
    lstm_recurrence_fwd_cluster_kernel(lstm_cluster::FwdArgs a) {
  lstm_cluster::fwd_body<MT>(a);
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

extern "C" {

// Shared memory (bytes) of one CTA of the cluster body at width H, cs CTAs
// a cluster and `rows` (16 or 32) batch rows a cluster;
// ops/lstm_kernels.py::_fwd_cluster_smem computes the same sum.
long long lstm_recurrence_fwd_cluster_smem(int H, int cs, int rows) {
  return (long long)lstm_cluster::FwdDims(H, cs, rows / lstm_cluster::kRows).smem();
}

// How many clusters of cs CTAs (16 rows each) the card keeps resident at
// once, more running in waves; K4f's clusters and 32-row ones take the
// same (one CTA an SM); negative on a CUDA error.
int lstm_recurrence_fwd_cluster_max_active(int H, int cs) {
  return lstm_cluster::fwd_max_active(lstm_recurrence_fwd_cluster_kernel<1>, lstm_cluster::kRows,
                                      1, H, cs, 1);
}

// The cluster body's launch: bf16 tensors, cs in {1, 2, 4, 8} CTAs a
// cluster with 4 * Uc <= 256 and the slice within the card's shared
// memory, rows 16 or 32 a cluster (the wrapper plans both).  h0, c0 f32;
// c_seq may be null.
int lstm_recurrence_fwd_cluster(const void* xw, const void* wh, const void* lengths,
                                const void* h0, const void* c0, const void* mask, void* h_seq,
                                void* c_seq, void* hT, void* cT, int T, int B, int H,
                                int reverse_time, int cs, int rows, void* stream) {
  if (rows != 16 && rows != 32) return (int)cudaErrorInvalidValue;
  const lstm_cluster::FwdArgs a = lstm_cluster::make_fwd_args(
      xw, wh, lengths, h0, c0, mask, h_seq, c_seq, hT, cT, T, B, H, reverse_time, cs);
  const cudaStream_t st = (cudaStream_t)stream;
  return rows == 32
             ? lstm_cluster::fwd_launch(lstm_recurrence_fwd_cluster_kernel<2>, a, 2, 1, st)
             : lstm_cluster::fwd_launch(lstm_recurrence_fwd_cluster_kernel<1>, a, 1, 1, st);
}

}  // extern "C"
