// LSTM recurrence adjoint (kernel K1b) for Hopper (sm_90a), the bf16
// body: one serial product per step, the recurrent weight held in shared
// memory across a thread-block cluster.
//
// Replaces ecog2txt_tpu/ops/pallas_lstm.py::_bwd_call (the pallas_call at
// :415) for bf16 streams at widths whose weight slice fits (H up to ~420
// at 8 CTAs a cluster); f32 streams and wider layers keep the body of
// lstm_recurrence_bwd.cu (lstm_common.cuh::bwd_rows); K4b runs the same
// two bodies on the same terms.
// The function is that kernel's, step for step (t = T-1 down to 0, or 0
// up to T-1 when the recurrence ran reverse_time):
//
//   gates  = f32(xw[t]) + S(f32(hprev[t]) * mask) @ S(wh)
//   dh_t   = dh + dhseq[t]                       (t < length)
//   [di, dg, df, do] and dct from the cell adjoint; dc = dct * sf
//   dgates[t] = S([di, dg, df, do])              (0 where t >= length)
//   dh     = (S(dgates[t]) @ S(wh)^T) * mask     (t < length)
//
// What bounds it.  At B=256, H=400, T'=104 the bytes (xw, hprev, cprev,
// cseq, dhseq in, dgates out) put the floor near 0.08 ms; the old body
// re-read wh and whT (2.56 MB) from L2 in every block and step and ran two
// serial per-thread loops over 4H and H a step (~148 us a step, whatever
// B).  But only one product is serial: gates depends on hprev, an INPUT
// (the saved forward states), not on the adjoint.  The chain is
// dh -> cell adjoint -> dgates -> dgates @ wh^T -> dh.
//
// Design.
// - A cluster of cs CTAs owns R = 16 batch rows, one tensor-core row tile
//   (ragged B is padded with rows that are not stored); CTA c owns hidden
//   units [c*Uc, (c+1)*Uc), Uc = ceil(H / cs) rounded up to a
//   multiple of 4 (the last CTA may own fewer), i.e. gate columns
//   {g*H + u}.  Its slice wh[:, cols_c] (H x 4Uc bf16, columns interleaved
//   unit-major: local column 4*u + g) stays in shared memory for the whole
//   launch: 173 KB at H=400, cs=8, loaded once.  Rows are padded to a
//   stride of an odd number of 16-byte units so ldmatrix reads the slice
//   without bank conflicts, plainly (phase C) and transposed (phase A).
// - Phase A, no part of the adjoint chain: gates[t, :, cols_c] =
//   S(hprev[t] * mask) @ slice on the tensor cores (mma.sync m16n8k16, a
//   16-row tile = M; A from the staged rows, B by ldmatrix.trans), issued
//   for the NEXT step between the cluster barrier's arrive and its wait.
//   hprev's rows arrive by cp.async in 16-byte chunks issued a phase
//   earlier, the mask applied in place; the step's elementwise inputs of
//   the CTA's pairs (xw's four gates, cseq, cprev, dhseq) likewise, in
//   8-byte runs, so no warp waits on scattered 2-byte loads.
// - Phase B, elementwise: the C fragment of a gate n8 tile holds, per
//   thread, two gates of one unit for two rows; one shuffle with the
//   neighbouring lane gives each thread all four gates of one (row, unit)
//   pair.  That thread owns the pair's dh, dc and mask in registers for
//   the whole launch, and writes S(dgates) into the R x 4Uc A operand of
//   phase C, and from there to device memory in coalesced bf16x2 rows.
// - Phase C, the only serial product: S(dgates[:, cols_c]) @ slice^T,
//   R x H in f32, on the tensor cores from the same resident slice.  A
//   quad shuffle gives each lane 4 consecutive columns of one row, which it
//   pushes (one 16-byte st.shared::cluster) into the receive buffer of the
//   CTA that owns those units, slot c.  After barrier.cluster
//   (arrive.release / wait.acquire) the owner of pair (row, u) sums its cs
//   slots in rank order 0..cs-1 from its own shared memory, so results
//   repeat bit for bit run to run; then * mask.  Pushing replaced pulling
//   each partial through distributed shared memory, whose remote-load
//   latency sat on the chain.  A second, relaxed arrive/wait pair keeps
//   a CTA from pushing into a slot its owner has not yet read; its wait is
//   taken just before the next phase C, so it hides behind phase B.
//   Double-buffered slots would save that barrier but do not fit next to
//   the slice at H=400 (231040 of 232448 bytes used).
// - 512 threads (16 warps) a CTA: warp w owns gate n8-tile pair w in
//   phase A (4Uc <= 256), so a thread owns at most two (row, unit) pairs.
//   One CTA an SM.
// - The host takes the fewest CTAs a cluster (1, 2, 4 or 8) whose slice
//   fits: 8 at H=400, 1 at H=64.  At B=256 that is 16 clusters; the H100
//   keeps 15 clusters of 8 resident (GPC boundaries), so they run in two
//   waves.  Clusters of 16 CTAs (7 resident), with 16 or 32 rows each,
//   measured slower at B=256 and were not kept.
//
// The body lives in lstm_bwd_cluster.cuh, which K4b (bilstm_grid.cu)
// shares: there a second grid axis runs the biLSTM layer's two directions.
//
// Plain C interface, loaded with ctypes; the launch goes on the caller's
// stream and the function returns the CUDA error code.

#include "lstm_bwd_cluster.cuh"

namespace {

__global__ void __launch_bounds__(lstm_cluster::kThreads, 1)
    lstm_recurrence_bwd_cluster_kernel(lstm_cluster::Args a) {
  lstm_cluster::bwd_body(a);
}

}  // namespace

extern "C" {

// Shared memory (bytes) of one CTA at width H and cs CTAs a cluster;
// ops/lstm_kernels.py::_cluster_smem computes the same sum.
long long lstm_recurrence_bwd_cluster_smem(int H, int cs) {
  return (long long)lstm_cluster::Dims(H, cs).smem();
}

// How many clusters of cs CTAs the card keeps resident at once (for the
// record: more than that run in waves); negative on a CUDA error.
int lstm_recurrence_bwd_cluster_max_active(int B, int H, int cs) {
  return lstm_cluster::max_active(lstm_recurrence_bwd_cluster_kernel, B, 1, H, cs);
}

// The launch: bf16 tensors, cs in {1, 2, 4, 8} CTAs a cluster with
// 4 * Uc <= 256 and the slice within the card's shared memory (the
// wrapper plans it).
int lstm_recurrence_bwd_cluster(const void* xw, const void* wh, const void* hprev,
                                const void* cprev, const void* cseq, const void* lengths,
                                const void* mask, const void* dhseq, const void* dhT,
                                const void* dcT, void* dgates, void* dh0, void* dc0, int T,
                                int B, int H, int reverse_time, int cs, void* stream) {
  const lstm_cluster::Args a =
      lstm_cluster::make_args(xw, wh, hprev, cprev, cseq, lengths, mask, dhseq, dhT, dcT,
                              dgates, dh0, dc0, T, B, H, reverse_time, cs);
  return lstm_cluster::launch(lstm_recurrence_bwd_cluster_kernel, a, 1, (cudaStream_t)stream);
}

}  // extern "C"
