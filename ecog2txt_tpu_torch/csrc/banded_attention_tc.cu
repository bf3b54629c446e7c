// Chunk-causal ("banded") attention forward for Hopper (sm_90a) on the
// tensor cores: the bf16 body of K2f.
//
// Replaces ecog2txt_tpu/ops/pallas_attention.py::_fwd_call (the
// pallas_call at :329) for bf16 streams; f32 streams keep the CUDA-core
// body of banded_attention.cu (the tensor cores have no f32 product, and
// TF32 would break the f32 tolerance), and so does K3f, which shares that
// body's attend_row.  Semantics are _fwd_kernel's
// (pallas_attention.py:100-139): s = f32(q.k^T) * scale, -1e30 where the
// band masks (_band_mask), the row max, e = exp(s - m), the denominator,
// lse = m + log(denom), p = S(e / denom), out = S(f32(p.v)), all over the
// block's QB + L*C key window.  A row with no valid key gets the uniform
// average of its window and a finite lse, as the Pallas kernel and the
// CUDA-core body give it.
//
// Bound on the card.  At the headline shape (B=256, T1=128, QB=128, window
// W=144, Dh=64, H=6) a block does 2*(128*144*64)*2 ~ 4.7 MFLOP over ~52 KB
// of bf16 in and 16 KB out, about 90 FLOP per byte: below the H100's
// ~295 FLOP/byte bf16 ridge, so the bound is bytes (q, k, v read once,
// out written once: ~100 MB, 0.03 ms).  The chunk-causal band admits only
// L+1 chunks of keys per query row (32 of 144 at the headline), so the
// products that matter are a fraction of even that.
//
// Design.
// - One block per (query block n, head h, batch row b), as the CUDA-core
//   body; min(8, ceil(QB/16)) warps, a warp owning 16 query rows at a time.
// - Staging in bf16, not f32: Q (QB x Dh), K and V (W x Dh) go to shared
//   memory with cp.async in 16-byte chunks, rows padded to Dhp + 8
//   elements (Dhp = Dh rounded up to 16): the row stride is an odd number
//   of 16-byte units, so ldmatrix reads 8 rows without a bank conflict.
//   Window rows outside [0, T1) (block 0's L*C previous rows, the clamped
//   tail) are never read: cp.async is given src-size 0 and zero-fills
//   them; pad rows and columns are zeros too.  Q and K are one cp.async
//   group and V a second one, so V lands while pass 1 runs.  At the
//   headline shape that is 60 KB of shared memory a block (was 75 KB of
//   f32 plus per-warp buffers).  A head dim that is not a multiple of 8
//   (or unaligned tensors) stages by scalar copies.
// - Both products on the tensor cores with mma.sync.m16n8k16 (bf16 in,
//   f32 accumulate): q.k^T with A = Q (ldmatrix) and B = K rows
//   (ldmatrix, non-transposed), p.v with A = p and B = V (ldmatrix.trans).
//   The score fragment (16 rows x 16 keys, two n8 tiles) stays in
//   registers; its C layout is repacked as the A operand of p.v, as
//   FlashAttention-2 does.  K2f is bound by bytes, so wgmma's higher rate
//   would buy nothing here.
// - The band as chunk ids: each block writes the chunk id of its window's
//   keys to shared memory once (a sentinel for keys masked whatever the
//   query: outside [0, t_real), at negative absolute positions, at/past
//   the length), so a score's mask is two integer compares, not two floor
//   divisions.
// - Two passes over the key tiles the band can admit for the warp's 16
//   rows (L+1 chunks: 2 of 9 tiles at the headline): pass 1 the row max and
//   denominator (per-thread running max and sum, merged across the quad by
//   shuffles), pass 2 recomputes s and takes p = S(exp(s - m) / denom)
//   exactly where Pallas rounds, then p.v.  No online rescaling of the
//   output, so the rounding points are Pallas's; only the order of the sums
//   differs, which the bf16 tolerance covers.  A row with no admitted key
//   (padding rows past t_real, rows before the sequence) has m = -1e30 and
//   denom = W exactly, and its output is the window's uniform average
//   S(sum_j S(1/W) v_j), computed once per block on the CUDA cores only
//   when such a row exists, so those rows do not walk the whole window.
//   Keys past W (padding to a multiple of 16) are -inf: they add nothing.
// - The output accumulator covers 64 head columns (8 n8 tiles, 32 f32
//   registers a thread); a wider head runs pass 2 once per 64 columns.
// - Occupancy at the headline shape: 61 KB of shared memory and at most
//   85 registers a thread (__launch_bounds__(256, 3)): three blocks, 24
//   warps, an SM; 1536 blocks over 132 SMs.
//
// The tensor-core pieces (staging, ldmatrix, mma.sync, the chunk-id
// sentinels) live in attention_tc.cuh, which K2b's tensor-core bodies
// (banded_attention_bwd_tc.cu) share.

#include <stdint.h>

#include "attention_common.cuh"
#include "attention_tc.cuh"

using namespace attn;
using namespace attn_tc;

namespace {

constexpr int kTcWarps = 8;  // warps a block, at most

__global__ void __launch_bounds__(kTcWarps * 32, 3)
    banded_attention_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                   const bf16* __restrict__ v, const int* __restrict__ lengths,
                                   bf16* __restrict__ out, float* __restrict__ lse, int T1,
                                   int H, int Dh, int C, int L, int t_real, int QB, int offset,
                                   float scale, int vec) {
  const int n = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int PREV = L * C, W = QB + PREV, D = H * Dh;
  const int Dhp = (Dh + 15) & ~15, ST = Dhp + 8;
  const int QBp = (QB + 15) & ~15, Wp = (W + 15) & ~15;
  const int base = n * QB, k0row = base - PREV;  // local rows of query 0 and key 0
  const size_t boff = (size_t)b * T1 * D;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + QBp * ST;
  bf16* vs = ks + Wp * ST;
  int* kcs = reinterpret_cast<int*>(vs + Wp * ST);  // [Wp] key chunk ids
  float* mean = reinterpret_cast<float*>(kcs + Wp);  // [Dhp] the window's uniform average
  int* any_empty = reinterpret_cast<int*>(mean + Dhp);

  // group 0: Q and K, which pass 1 needs; group 1: V, for pass 2
  stage(qs, ST, q + boff, base, QB, QBp, T1, D, h * Dh, Dh, Dhp, vec);
  stage(ks, ST, k + boff, k0row, W, Wp, T1, D, h * Dh, Dh, Dhp, vec);
  cp_async_commit();
  stage(vs, ST, v + boff, k0row, W, Wp, T1, D, h * Dh, Dh, Dhp, vec);
  cp_async_commit();
  const int length = lengths[b];
  for (int j = threadIdx.x; j < W; j += blockDim.x) {
    const int gk = k0row + j;
    const long long ak = (long long)gk + offset;
    kcs[j] = gk >= 0 && gk < t_real && ak >= 0 && ak < length ? floordiv(gk, C) : kNoKey;
  }
  if (threadIdx.x == 0) *any_empty = 0;
  cp_async_wait<1>();
  __syncthreads();

  const Tile T{qs, ks, vs, kcs, ST, Dhp / 16, W, L, scale};
  attend_block(T, QB, Dh, base, k0row, C, t_real, out + boff + (size_t)base * D + h * Dh, D,
               lse + ((size_t)b * T1 + base) * H + h, H, mean, any_empty,
               [] { cp_async_wait<0>(); });
}

}  // namespace

extern "C" {

// Shared memory (bytes) of one block of the tensor-core K2f;
// ops/attention_kernels.py::_k2f_tc_smem computes the same sum.
int banded_attention_fwd_tc_smem(int QB, int W, int Dh) {
  const int Dhp = (Dh + 15) & ~15, Wp = (W + 15) & ~15;
  return 2 * (((QB + 15) & ~15) + 2 * Wp) * (Dhp + 8) + 4 * Wp + 4 * Dhp + 16;
}

// Launches the tensor-core K2f (bf16 streams only) on `stream` over the
// grid (T1/QB, H, B) and returns the CUDA error code (0 on success).
int banded_attention_fwd_tc(const void* q, const void* k, const void* v, const int* lengths,
                            void* out, float* lse, int B, int T1, int H, int Dh, int C, int L,
                            int t_real, int QB, int offset, float scale, void* stream) {
  const int W = QB + L * C;
  const size_t smem = banded_attention_fwd_tc_smem(QB, W, Dh);
  const int warps = min(kTcWarps, (QB + 15) / 16);
  const int vec = Dh % 8 == 0 &&
                  ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v)) % 16) == 0;
  cudaError_t err = cudaFuncSetAttribute(banded_attention_fwd_tc_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  banded_attention_fwd_tc_kernel<<<dim3(T1 / QB, H, B), warps * 32, smem,
                                   (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, lengths, (bf16*)out, lse, T1, H, Dh, C, L,
      t_real, QB, offset, scale, vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
