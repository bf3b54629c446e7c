// Both directions of one biLSTM layer in one launch, for NVIDIA Hopper
// (sm_90a): the forward recurrence K4f and its adjoint K4b.
//
// Replaces: ecog2txt_tpu/ops/pallas_lstm.py::_bi_grid_fwd_call (the
// pallas_call at :672, kernel _make_bi_fwd_kernel) and ::_bi_grid_bwd_call
// (the pallas_call at :847, kernel _make_bi_bwd_kernel).
//
//   K4f: direction 0 runs the forward chain over t = 0..T-1, direction 1
//        the reverse chain over t = T-1..0 (gather-free: the length
//        semantics of K1f's reverse_time), each from a zero state; h_seq
//        and c_seq per direction in the stream type, hT and cT in f32.
//   K4b: both adjoint chains: direction 0 walks t = T-1..0, direction 1
//        t = 0..T-1; dgates per direction in the stream type, dh0 and dc0
//        in f32 from dhT and dcT.
//
// Every per-direction tensor is stacked direction-major: xw (2, T, B, 4H),
// wh (2, H, 4H), whT (2, 4H, H), mask (2, B, H), the sequences
// (2, T, B, H), the states (2, B, H); lengths (B,) is shared.  The cell,
// the rounding points and the per-unit threading are K1f's and K1b's
// (lstm_common.cuh), so each direction computes what K1f / K1b compute
// for it.
//
// What bounds it on this card.  Per direction the work is K1f's (K1b's):
// at the serving shapes (H=400, T'=104) a chain of T' dependent
// (B, H) @ (H, 4H) products.  The floor from FLOPs and bytes is twice
// K1f's (K1b's), near 0.07 ms (0.15 ms) at B=256, but the real limit is
// the serial chain of 104 steps, each streaming wh (1.28 MB in bf16) from
// L2.  The two chains are independent.
//
// Design.  The grid has a direction axis: blockIdx.y picks the direction
// and blockIdx.x a tile of R batch rows, so the two chains run at once on
// different SMs (the TPU kernel interleaved them inside one core's
// instruction stream; here they need not share anything).  A block finds
// its direction's tensors at a fixed offset from the stacked bases, so one
// body serves both directions.  Blocks of at most 512 threads (H <= 512)
// leave the compiler 128 registers a thread; with the 64 of a 1024-thread
// block, one-row blocks ran several times slower on the H100.  The
// wrapper picks R so that the doubled grid stays within one wave of SMs.
//
// K4f's bf16 body is K1f's cluster body (lstm_fwd_cluster.cuh: the
// weight slice resident across a thread-block cluster, h all-gathered
// through distributed shared memory every step), launched over a grid of
// (cs * ceil(B / R), 2) CTAs in clusters of (cs, 1, 1) with R = 16 or 32
// rows a cluster: blockIdx.y picks the direction, whose tensors lie at the
// direction-major offsets, and reverse_time is the direction.  f32 streams
// and widths whose slice fits no cluster keep the rows body
// (lstm_common.cuh::fwd_rows); ops/lstm_kernels.py::plan_fwd_body picks
// the body before the launch.
//
// K4b's bf16 body is K1b's cluster body (lstm_bwd_cluster.cuh:
// the weight slice resident across a thread-block cluster, only
// dgates @ wh^T on the serial chain), launched over a grid of
// (cs * ceil(B / 16), 2) CTAs in clusters of (cs, 1, 1): blockIdx.y picks
// the direction, whose tensors lie at the direction-major offsets of the
// stacked inputs, exactly as for the rows body.  Direction 0 walks
// t = T-1..0, direction 1 t = 0..T-1 (its predecessor is t+1).  The
// directions' clusters share the card: at B=256, H=400 that is 32
// clusters of 8 CTAs, of which the H100 keeps 15 resident, so 3 waves
// where two K1b launches take 2 each.  It reads the resident slice
// transposed by ldmatrix.trans, so it needs no whT.  f32 streams, and
// widths whose slice fits no cluster, keep the rows body
// (lstm_common.cuh::bwd_rows) below; ops/lstm_kernels.py::plan_bwd_body
// picks the body before the launch.
//
// Plain C interface, loaded with ctypes; launches go on the caller's
// stream and each function returns cudaGetLastError().

#include "lstm_bwd_cluster.cuh"
#include "lstm_common.cuh"
#include "lstm_fwd_cluster.cuh"

namespace {

template <typename S, int R, int MaxThreads>
__global__ void __launch_bounds__(MaxThreads)
bilstm_grid_fwd_kernel(const S* __restrict__ xw,         // (2, T, B, 4H)
                       const S* __restrict__ wh,         // (2, H, 4H)
                       const int* __restrict__ lengths,  // (B,)
                       const float* __restrict__ mask,   // (2, B, H)
                       S* __restrict__ h_seq,            // (2, T, B, H)
                       S* __restrict__ c_seq,            // (2, T, B, H) or null
                       float* __restrict__ hT,           // (2, B, H)
                       float* __restrict__ cT,           // (2, B, H)
                       int T, int B, int H) {
  const size_t d = blockIdx.y, st = static_cast<size_t>(B) * H, seq = T * st;
  lstm::fwd_rows<S, R>(xw + d * 4 * seq, wh + d * 4 * H * static_cast<size_t>(H), lengths,
                       nullptr, nullptr, mask + d * st, h_seq + d * seq,
                       c_seq == nullptr ? nullptr : c_seq + d * seq, hT + d * st, cT + d * st,
                       T, B, H, /*reverse_time=*/static_cast<int>(blockIdx.y), blockIdx.x * R);
}

template <typename S, int R, int MaxThreads>
__global__ void __launch_bounds__(MaxThreads)
bilstm_grid_bwd_kernel(const S* __restrict__ xw,         // (2, T, B, 4H)
                       const S* __restrict__ wh,         // (2, H, 4H)
                       const S* __restrict__ whT,        // (2, 4H, H)
                       const S* __restrict__ hprev,      // (2, T, B, H)
                       const S* __restrict__ cprev,      // (2, T, B, H)
                       const S* __restrict__ cseq,       // (2, T, B, H)
                       const int* __restrict__ lengths,  // (B,)
                       const float* __restrict__ mask,   // (2, B, H)
                       const S* __restrict__ dhseq,      // (2, T, B, H)
                       const float* __restrict__ dhT,    // (2, B, H)
                       const float* __restrict__ dcT,    // (2, B, H)
                       S* __restrict__ dgates,           // (2, T, B, 4H)
                       float* __restrict__ dh0,          // (2, B, H)
                       float* __restrict__ dc0,          // (2, B, H)
                       int T, int B, int H) {
  const size_t d = blockIdx.y, st = static_cast<size_t>(B) * H, seq = T * st;
  const size_t w = 4 * H * static_cast<size_t>(H);
  lstm::bwd_rows<S, R>(xw + d * 4 * seq, wh + d * w, whT + d * w, hprev + d * seq,
                       cprev + d * seq, cseq + d * seq, lengths, mask + d * st, dhseq + d * seq,
                       dhT + d * st, dcT + d * st, dgates + d * 4 * seq, dh0 + d * st,
                       dc0 + d * st, T, B, H, /*reverse_time=*/static_cast<int>(blockIdx.y),
                       blockIdx.x * R);
}

// K4f's bf16 cluster body: CTA (blockIdx.x, d) runs K1f's cluster body on
// direction d's slice of the stacked tensors, from a zero state.
template <int MT>
__global__ void __launch_bounds__(lstm_cluster::kThreads, 1)
    bilstm_grid_fwd_cluster_kernel(lstm_cluster::FwdArgs a) {
  const size_t d = blockIdx.y, st = static_cast<size_t>(a.B) * a.H, seq = a.T * st;
  a.xw += d * 4 * seq;
  a.wh += d * 4 * a.H * static_cast<size_t>(a.H);
  a.mask += d * st;
  a.h_seq += d * seq;
  if (a.c_seq != nullptr) a.c_seq += d * seq;
  a.hT += d * st;
  a.cT += d * st;
  a.reverse_time = static_cast<int>(blockIdx.y);
  lstm_cluster::fwd_body<MT>(a);
}

// K4b's bf16 cluster body: CTA (blockIdx.x, d) runs K1b's cluster body on
// direction d's slice of the stacked tensors.
__global__ void __launch_bounds__(lstm_cluster::kThreads, 1)
    bilstm_grid_bwd_cluster_kernel(lstm_cluster::Args a) {
  const size_t d = blockIdx.y, st = static_cast<size_t>(a.B) * a.H, seq = a.T * st;
  a.xw += d * 4 * seq;
  a.wh += d * 4 * a.H * static_cast<size_t>(a.H);
  a.hprev += d * seq;
  a.cprev += d * seq;
  a.cseq += d * seq;
  a.mask += d * st;
  a.dhseq += d * seq;
  a.dhT += d * st;
  a.dcT += d * st;
  a.dgates += d * 4 * seq;
  a.dh0 += d * st;
  a.dc0 += d * st;
  a.reverse_time = static_cast<int>(blockIdx.y);
  lstm_cluster::bwd_body(a);
}

template <typename S, int R, int MaxThreads>
cudaError_t launch_fwd(void* const* p, int T, int B, int H, cudaStream_t stream) {
  const size_t smem = lstm::fwd_smem<R>(H);
  auto kernel = bilstm_grid_fwd_kernel<S, R, MaxThreads>;
  const cudaError_t err = lstm::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((B + R - 1) / R, 2), lstm::threads_for(H), smem, stream>>>(
      static_cast<const S*>(p[0]), static_cast<const S*>(p[1]), static_cast<const int*>(p[2]),
      static_cast<const float*>(p[3]), static_cast<S*>(p[4]), static_cast<S*>(p[5]),
      static_cast<float*>(p[6]), static_cast<float*>(p[7]), T, B, H);
  return cudaGetLastError();
}

template <typename S, int R, int MaxThreads>
cudaError_t launch_bwd(void* const* p, int T, int B, int H, cudaStream_t stream) {
  const size_t smem = lstm::bwd_smem<R>(H);
  auto kernel = bilstm_grid_bwd_kernel<S, R, MaxThreads>;
  const cudaError_t err = lstm::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const auto in = [p](int i) { return static_cast<const S*>(p[i]); };
  kernel<<<dim3((B + R - 1) / R, 2), lstm::threads_for(H), smem, stream>>>(
      in(0), in(1), in(2), in(3), in(4), in(5), static_cast<const int*>(p[6]),
      static_cast<const float*>(p[7]), in(8), static_cast<const float*>(p[9]),
      static_cast<const float*>(p[10]), static_cast<S*>(p[11]), static_cast<float*>(p[12]),
      static_cast<float*>(p[13]), T, B, H);
  return cudaGetLastError();
}

using Launch = cudaError_t (*)(void* const*, int, int, int, cudaStream_t);

template <typename S, int R, int MaxThreads>
Launch pick_dir(bool bwd) {
  return bwd ? &launch_bwd<S, R, MaxThreads> : &launch_fwd<S, R, MaxThreads>;
}

// rows 1, 2, 4 or 8 with H <= 512 (512-thread blocks); rows 1 or 2 with
// 512 < H <= 1024 (1024-thread blocks, as K1f and K1b)
template <typename S>
Launch pick(int rows, int H, bool bwd) {
  if (H > 512) return rows == 1 ? pick_dir<S, 1, 1024>(bwd) : pick_dir<S, 2, 1024>(bwd);
  switch (rows) {
    case 1:
      return pick_dir<S, 1, 512>(bwd);
    case 2:
      return pick_dir<S, 2, 512>(bwd);
    case 4:
      return pick_dir<S, 4, 512>(bwd);
    default:
      return pick_dir<S, 8, 512>(bwd);
  }
}

int run(bool bwd, void* const* p, int T, int B, int H, int is_bf16, int rows, void* stream) {
  if (!lstm::shape_ok(T, B, H, rows)) return static_cast<int>(cudaErrorInvalidValue);
  const Launch fn = is_bf16 ? pick<__nv_bfloat16>(rows, H, bwd) : pick<float>(rows, H, bwd);
  return static_cast<int>(fn(p, T, B, H, static_cast<cudaStream_t>(stream)));
}

}  // namespace

extern "C" {

// K4f.  p: xw, wh, lengths, mask, h_seq, c_seq (may be null), hT, cT,
// stacked as above.  rows: batch rows per block (1, 2, 4 or 8).
int bilstm_grid_fwd(void* const* p, int T, int B, int H, int is_bf16, int rows, void* stream) {
  return run(false, p, T, B, H, is_bf16, rows, stream);
}

// K4b.  p: xw, wh, whT, hprev, cprev, cseq, lengths, mask, dhseq, dhT,
// dcT, dgates, dh0, dc0, stacked as above.
int bilstm_grid_bwd(void* const* p, int T, int B, int H, int is_bf16, int rows, void* stream) {
  return run(true, p, T, B, H, is_bf16, rows, stream);
}

// K4f's cluster body (bf16 only: is_bf16 must be 1).  p: xw, wh,
// lengths, mask, h_seq, c_seq (may be null), hT, cT, stacked as above; cs
// in {1, 2, 4, 8} CTAs a cluster and rows 16 or 32 a cluster, as the
// wrapper plans them.
int bilstm_grid_fwd_cluster(void* const* p, int T, int B, int H, int is_bf16, int cs, int rows,
                            void* stream) {
  if (!is_bf16 || (rows != 16 && rows != 32)) return static_cast<int>(cudaErrorInvalidValue);
  const lstm_cluster::FwdArgs a = lstm_cluster::make_fwd_args(
      p[0], p[1], p[2], nullptr, nullptr, p[3], p[4], p[5], p[6], p[7], T, B, H,
      /*reverse_time=*/0, cs);
  const cudaStream_t st = (cudaStream_t)stream;
  return rows == 32 ? lstm_cluster::fwd_launch(bilstm_grid_fwd_cluster_kernel<2>, a, 2, 2, st)
                    : lstm_cluster::fwd_launch(bilstm_grid_fwd_cluster_kernel<1>, a, 1, 2, st);
}

// K4b's cluster body (bf16 only: is_bf16 must be 1).  p: xw, wh, hprev,
// cprev, cseq, lengths, mask, dhseq, dhT, dcT, dgates, dh0, dc0, stacked
// as above (no whT); cs in {1, 2, 4, 8} CTAs a cluster, as the wrapper
// plans it.
int bilstm_grid_bwd_cluster(void* const* p, int T, int B, int H, int is_bf16, int cs,
                            void* stream) {
  if (!is_bf16) return static_cast<int>(cudaErrorInvalidValue);
  const lstm_cluster::Args a = lstm_cluster::make_args(
      p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8], p[9], p[10], p[11], p[12], T, B, H,
      /*reverse_time=*/0, cs);
  return lstm_cluster::launch(bilstm_grid_bwd_cluster_kernel, a, 2, (cudaStream_t)stream);
}

// How many clusters of cs CTAs the card keeps resident at once for K4b's
// cluster launch (both directions' clusters share them); negative on a
// CUDA error.
int bilstm_grid_bwd_cluster_max_active(int B, int H, int cs) {
  return lstm_cluster::max_active(bilstm_grid_bwd_cluster_kernel, B, 2, H, cs);
}

}  // extern "C"
