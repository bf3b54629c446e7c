// The fused attention layer for Hopper (sm_90a) on the tensor cores: the
// bf16 body of K3f.
//
// Replaces ecog2txt_tpu/ops/pallas_attention.py::_fused_fwd_call (the
// pallas_call at :579, kernel _fused_fwd_kernel at :472) for bf16 streams;
// f32 streams keep the CUDA-core body of fused_attention.cu (the tensor
// cores have no f32 product, and TF32 would break the f32 tolerance).
// Semantics are _fused_fwd_kernel's, rounded to bf16 (S) where it rounds:
//
//   lnx = S((x - mu) * rs * g + b)                        f32 statistics, eps 1e-6
//   q   = S(S(S(lnx.Wq) * cs) + S(S(lnx.Wq@R) * sn))      the QB query rows
//   k   = the same with Wk, over the QB + L*C window rows;   v = S(lnx.Wv)
//   cs, sn = S(cos(pos * freq)), S(sin(pos * freq)) at absolute positions
//   then K2f's attention: lse = m + log(denom), p = S(e / denom), out = S(f32(p.v))
//
// Bound on the card.  At the headline shape (B=256, T1=128, D=384, 6 heads,
// C=16, L=1) the q, k and v projections are 2 * B * T1 * D * 3D = 29 GFLOP
// (W@R is a signed column permutation of W: its product is a copy, not
// work) and the band's attention pairs ~0.2 GFLOP: 0.030 ms at the bf16
// tensor-core peak.  x in and out are 25 MB each and the weights 0.9 MB:
// 0.015 ms at the HBM rate.  Operations bound it.  Each block projects the
// L*C window rows before its query block again (k and v), 13 % more work
// than the bound counts at the headline.
//
// Design.
// - Two launches.  The first (fused_attention_prep_kernel) normalises every
//   row once, lnx = S((x - mu) * rs * g + b) with f32 statistics, a warp a
//   row (K5f's row function, layer_norm_row.cuh), and fills the table of
//   S(cos), S(sin) at every position a window takes.  Inside the blocks both would be done again for every head and
//   by the next query block's window (6.75 times a row at the headline),
//   on a path of loads, reductions and barriers that no product overlaps.
// - The second: one block per (query block n, head h, batch row b), 16
//   warps.  The query block tiles the work only (ops/attention_kernels.py::
//   plan_fused_layer picks it; each row sees the same keys whatever it is).
// - One pass over D for all of the block's products.  D is streamed in
//   tiles of kKT = 64 columns: the lnx tile of the window rows (rows before
//   the sequence and pad rows zero-filled) and the 64-row slices of Wq, Wk
//   and Wv for the head's columns arrive by cp.async, double-buffered (tile
//   t+1 lands while tile t is used), and each warp runs mma.sync m16n8k16
//   (bf16 in, f32 accumulate; A by ldmatrix, B by ldmatrix.trans) for its
//   item.  An item is one projection (q over the QB query rows, k or v over
//   all W window rows) of 32 rows by 64 head columns: two M tiles that
//   share the weight slice's B fragments, 64 f32 registers a thread.  A
//   pass over D takes one item a warp (16; the headline shape has 14); a
//   head wider than 64 columns, or more items, takes more passes.
// - Rotary without the second product: lnx.(W@R) is lnx.W with each head's
//   halves swapped and the first half negated, and rounding commutes with
//   negation, so S(lnx.W@R)[j] = -S(lnx.W)[j + half] (j < half) and
//   +S(lnx.W)[j - half] (j >= half) exactly.  The products are rounded to
//   bf16 into shared memory, and one pass over the pairs (j, j + half) of q
//   and k forms S(S(y_j * cs) + S(+-y_partner * sn)) in place, at any even
//   head dim, reading S(cos) and S(sin) from the first launch's table (0.2
//   MB at the headline, held in L2).  Three products instead of five; Wq@R
//   and Wk@R are not read.
// - q, k and v stay in shared memory in bf16 (exact: the reference rounds
//   them to bf16 there), rows padded to Dhp + 8 elements, and K2f's
//   tensor-core attention (attention_tc.cuh::attend_block) runs on them
//   without a trip through device memory.  With save, q, k and v of the
//   block's own rows and the f32 lse go out as the backward's residuals.
// - Shared memory at the headline shape: the lnx tiles (2 x 144 x 72) and
//   the weight slices (2 x 3 x 64 x 72), 96.8 KB of bf16; q, k and v (416 x
//   72 bf16) 59.9 KB; chunk ids and the window's average: 157.5 KB, one
//   block an SM (16 warps at up to 128 registers a thread).
//   ops/attention_kernels.py::_fused_tc_smem mirrors the count.

#include <stdint.h>

#include "attention_common.cuh"
#include "attention_tc.cuh"
#include "layer_norm_row.cuh"

using namespace attn;
using namespace attn_tc;

namespace {

constexpr int kFusedWarps = 16;                // warps a block
constexpr int kFusedThreads = 32 * kFusedWarps;
constexpr int kJobs = 2;                       // M tiles (16 rows x kNC columns) of an item
constexpr int kKT = 64;                        // contraction columns a streamed tile
constexpr int kXS = kKT + 8;                   // row stride of the lnx tile (elements)
constexpr int kNC = 64;                        // head columns a job covers
constexpr int kWS = kNC + 8;                   // row stride of a weight slice (elements)
constexpr int kPrepWarps = 8;

__host__ __device__ __forceinline__ int r16(int n) { return (n + 15) & ~15; }

// The shared memory of one block: the lnx tiles (2 x XR x kXS, XR covering
// the window's rows and the q jobs' padded rows), the weight slices (2 x 3 x
// kKT x kWS), q (QBp x ST), k and v (Wp x ST) in bf16; the keys' chunk ids
// (Wp), the window's uniform average (Dhp) and a flag.
struct Layout {
  int XR, QBp, Wp, Dhp, ST;
  __host__ __device__ Layout(int QB, int W, int Dh)
      : XR(r16(W - QB + r16(QB))), QBp(r16(QB)), Wp(r16(W)), Dhp(r16(Dh)), ST(r16(Dh) + 8) {}
  __host__ __device__ int xtile() const { return XR * kXS; }
  __host__ __device__ int wslice() const { return kKT * kWS; }
  __host__ __device__ size_t bytes() const {
    return 2 * (2 * (size_t)xtile() + 6 * (size_t)wslice() + (size_t)(QBp + 2 * Wp) * ST) +
           4 * ((size_t)Wp + Dhp) + 16;
  }
};

// K3f's first launch.  lnx = S((x - mu) * rs * g + b) of every row by K5f's
// row function (layer_norm_row.cuh), a warp a row; rot[(t + PREV) * D + l]
// = (S(cos), S(sin)) of the rotary angle (t + offset) * freq[l] for the
// positions t = -PREV .. T1 - 1 that the blocks' windows take.
__global__ void __launch_bounds__(kPrepWarps * 32)
    fused_attention_prep_kernel(const bf16* __restrict__ x, const float* __restrict__ lng,
                                const float* __restrict__ lnb, const float* __restrict__ freq,
                                bf16* __restrict__ lnx, __nv_bfloat162* __restrict__ rot,
                                int rows, int T1, int D, int PREV, int offset, float eps) {
  const int lane = threadIdx.x % 32;
  const int warps = gridDim.x * kPrepWarps;
  for (int row = blockIdx.x * kPrepWarps + threadIdx.x / 32; row < rows; row += warps) {
    ln_row::layer_norm_row<bf16>(x + (size_t)row * D, lng, lnb, lnx + (size_t)row * D, D, eps,
                                 lane);
  }
  const int n = (T1 + PREV) * D;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const int t = i / D - PREV, l = i - (i / D) * D;
    float sn, cs;
    sincosf(__fmul_rn((float)(t + offset), freq[l]), &sn, &cs);
    rot[i] = __floats2bfloat162_rn(cs, sn);
  }
}

// K3f's second launch, over the grid (T1/QB, H, B).  vec: lnx and the
// weights load in 16-byte chunks (Dh a multiple of 8, 16-byte aligned
// tensors).
__global__ void __launch_bounds__(kFusedThreads, 1)
    fused_attention_fwd_tc_kernel(const bf16* __restrict__ lnx, const bf16* __restrict__ wq,
                                  const bf16* __restrict__ wk, const bf16* __restrict__ wv,
                                  const __nv_bfloat162* __restrict__ rot,
                                  const int* __restrict__ lengths,
                                  bf16* __restrict__ out, bf16* __restrict__ qres,
                                  bf16* __restrict__ kres, bf16* __restrict__ vres,
                                  float* __restrict__ lse, int T1, int H, int Dh, int C, int L,
                                  int t_real, int QB, int offset, float scale, int save,
                                  int vec) {
  const int n = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int PREV = L * C, W = QB + PREV, D = H * Dh;
  const Layout S(QB, W, Dh);
  const int XR = S.XR, QBp = S.QBp, Wp = S.Wp, Dhp = S.Dhp, ST = S.ST;
  const int base = n * QB, k0row = base - PREV;  // local rows of query 0 and key 0
  const size_t boff = (size_t)b * T1 * D;
  const bf16* xb = lnx + boff;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xt = reinterpret_cast<bf16*>(smem_raw);      // [2][XR][kXS]
  bf16* wt = xt + 2 * S.xtile();                     // [2][3][kKT][kWS]
  bf16* qs = wt + 6 * S.wslice();                    // [QBp][ST]
  bf16* ks = qs + QBp * ST;                          // [Wp][ST]
  bf16* vs = ks + Wp * ST;                           // [Wp][ST]
  int* kcs = reinterpret_cast<int*>(vs + Wp * ST);   // [Wp]
  float* mean = reinterpret_cast<float*>(kcs + Wp);  // [Dhp] the window's uniform average
  int* any_empty = reinterpret_cast<int*>(mean + Dhp);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // phase clocks (attention_tc.cuh; only in a build with ATTN_PHASE_CLOCKS):
  // 0 start, 1 set-up issued, 2 + t tile t of the first pass landed,
  // kPhaseStamps - 6 products done, - 5 epilogue, - 4 rotary, - 3
  // residuals, - 2 attention pass 1, - 1 the end
  phase_stamp(0);

  const int length = lengths[b];
  for (int j = threadIdx.x; j < W; j += kFusedThreads) {
    const int gk = k0row + j;
    const long long ak = (long long)gk + offset;
    kcs[j] = gk >= 0 && gk < t_real && ak >= 0 && ak < length ? floordiv(gk, C) : kNoKey;
  }
  if (threadIdx.x == 0) *any_empty = 0;

  // the projections: passes over D, each for up to kFusedWarps items of one
  // kNC-column chunk of the head.  An item is two jobs of one projection
  // (M tiles 2p and 2p + 1 of q, of k or of v), so its two products share
  // the weight slice's B fragments.
  const int mq = QBp / 16, mk = Wp / 16;
  const int iq = (mq + 1) / 2, ik = (mk + 1) / 2, items = iq + 2 * ik;
  const int ntiles = (D + kKT - 1) / kKT;
  const int g = lane >> 2, t4 = lane & 3, mi = lane >> 3, lr = lane & 7;
  // tile t of lnx and of the three weight slices of head columns [c0, c0 +
  // kNC) into buffer s, one cp.async group (columns past D, rows past the
  // window or before the sequence and columns past the head are zeros)
  auto stage_tile = [&](int t, int s, int c0) {
    const int d0 = t * kKT, nk = min(kKT, D - d0);
    const int ncols = min(kNC, Dh - c0), nc16 = min(kNC, Dhp - c0);
    if (vec) {  // 16-byte chunks, 8 a row of each tile
      const uint32_t xdst = smem_addr(xt + s * S.xtile());
      for (int idx = threadIdx.x; idx < XR * (kKT / 8); idx += kFusedThreads) {
        const int r = idx >> 3, c = (idx & 7) * 8, gr = k0row + r;
        const bool ok = r < W && gr >= 0 && c < nk;
        cp_async16(xdst + (r * kXS + c) * 2, ok ? xb + (size_t)gr * D + d0 + c : xb, ok ? 16 : 0);
      }
      // weight row kr, chunk c of Wq, Wk and Wv: the same offsets in each
      for (int idx = threadIdx.x; idx < kKT * (kNC / 8); idx += kFusedThreads) {
        const int kr = idx >> 3, c = (idx & 7) * 8;
        if (c >= nc16) continue;
        const bool ok = kr < nk && c < ncols;
        const size_t o = ok ? (size_t)(d0 + kr) * D + h * Dh + c0 + c : 0;
        const uint32_t wdst = smem_addr(wt + 3 * s * S.wslice() + kr * kWS + c);
        cp_async16(wdst, wq + o, ok ? 16 : 0);
        cp_async16(wdst + S.wslice() * 2, wk + o, ok ? 16 : 0);
        cp_async16(wdst + S.wslice() * 4, wv + o, ok ? 16 : 0);
      }
    } else {
      stage(xt + s * S.xtile(), kXS, xb, k0row, W, XR, T1, D, d0, nk, kKT, false);
      stage(wt + (3 * s + 0) * S.wslice(), kWS, wq, d0, nk, kKT, D, D, h * Dh + c0, ncols, nc16,
            false);
      stage(wt + (3 * s + 1) * S.wslice(), kWS, wk, d0, nk, kKT, D, D, h * Dh + c0, ncols, nc16,
            false);
      stage(wt + (3 * s + 2) * S.wslice(), kWS, wv, d0, nk, kKT, D, D, h * Dh + c0, ncols, nc16,
            false);
    }
    cp_async_commit();
  };
  stage_tile(0, 0, 0);
  phase_stamp(1);

  for (int c0 = 0; c0 < Dhp; c0 += kNC) {
    const int nc16 = min(kNC, Dhp - c0);
    for (int i0 = 0; i0 < items; i0 += kFusedWarps) {
      // this warp's item: projection (0 q, 1 k, 2 v; -1 none), its jobs'
      // first tile row, and whether the second job exists
      const int it = i0 + warp;
      const int proj = it >= items ? -1 : it < iq ? 0 : it < iq + ik ? 1 : 2;
      const int p = proj == 0 ? it : proj == 1 ? it - iq : it - iq - ik;
      const bool two = 2 * p + 1 < (proj == 0 ? mq : mk);
      const int row0 = (proj == 0 ? PREV : 0) + 32 * p;
      float acc[kJobs][kNC / 8][4];
#pragma unroll
      for (int js = 0; js < kJobs; ++js)
#pragma unroll
        for (int nt = 0; nt < kNC / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[js][nt][e] = 0.f;
      if (c0 > 0 || i0 > 0) stage_tile(0, 0, c0);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t & 1;
        cp_async_wait<0>();
        __syncthreads();  // tile t landed; every warp is done with buffer s ^ 1
        if (c0 == 0 && i0 == 0) phase_stamp(2 + t);
        if (t + 1 < ntiles) stage_tile(t + 1, s ^ 1, c0);
        if (proj < 0) continue;
        const bf16* xs = xt + s * S.xtile();
        const uint32_t xa = smem_addr(xs + (row0 + (mi & 1) * 8 + lr) * kXS + (mi >> 1) * 8);
        const uint32_t wa = smem_addr(wt + (3 * s + proj) * S.wslice() +
                                      ((mi & 1) * 8 + lr) * kWS + (mi >> 1) * 8);
#pragma unroll
        for (int kk = 0; kk < kKT / 16; ++kk) {
          uint32_t a0[4], a1[4];
          ldsm_x4(a0, xa + kk * 32);
          if (two) ldsm_x4(a1, xa + 16 * kXS * 2 + kk * 32);
#pragma unroll
          for (int np = 0; np < kNC / 16; ++np) {
            if (np * 16 < nc16) {
              uint32_t bv[4];
              ldsm_x4_trans(bv, wa + kk * 16 * kWS * 2 + np * 32);
              mma16816(acc[0][2 * np], a0, bv[0], bv[1]);
              mma16816(acc[0][2 * np + 1], a0, bv[2], bv[3]);
              if (two) {
                mma16816(acc[1][2 * np], a1, bv[0], bv[1]);
                mma16816(acc[1][2 * np + 1], a1, bv[2], bv[3]);
              }
            }
          }
        }
      }
      __syncthreads();  // every warp is done with the tiles (a next pass restages them)
      phase_stamp(kPhaseStamps - 6);
      // S(lnx . W) of the item's rows and columns into q, k or v (zeros where
      // the rows or columns are padding)
      if (proj >= 0) {
        bf16* dst = proj == 0 ? qs : proj == 1 ? ks : vs;
        const int r0 = row0 - (proj == 0 ? PREV : 0);
#pragma unroll
        for (int js = 0; js < kJobs; ++js) {
          if (js == 1 && !two) continue;
#pragma unroll
          for (int nt = 0; nt < kNC / 8; ++nt) {
            if (nt * 8 >= nc16) continue;
            const int col = c0 + nt * 8 + 2 * t4;
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              *reinterpret_cast<__nv_bfloat162*>(dst + (r0 + 16 * js + g + 8 * hr) * ST + col) =
                  __floats2bfloat162_rn(acc[js][nt][2 * hr], acc[js][nt][2 * hr + 1]);
            }
          }
        }
      }
    }
  }
  __syncthreads();
  phase_stamp(kPhaseStamps - 5);

  // rotary in place, a (window row w, j < half) pair of lanes j and j + half
  // a thread: k row w, and q row w - PREV (the same absolute position
  // k0row + w + offset) where w >= PREV; S(cos) and S(sin) of both lanes
  // from the first launch's table
  const int half = Dh / 2;
  for (int idx = threadIdx.x; idx < W * half; idx += kFusedThreads) {
    const int w = idx / half, j = idx - w * half;
    const __nv_bfloat162* tr = rot + (size_t)(k0row + w + PREV) * D + h * Dh;
    const float2 r1 = __bfloat1622float2(tr[j]), r2 = __bfloat1622float2(tr[j + half]);
    const float c1 = r1.x, s1 = r1.y, c2 = r2.x, s2 = r2.y;
#pragma unroll
    for (int which = 0; which < 2; ++which) {
      if (which == 1 && w < PREV) break;
      bf16* yr = which == 0 ? ks + w * ST : qs + (w - PREV) * ST;
      const float y1 = __bfloat162float(yr[j]), y2 = __bfloat162float(yr[j + half]);
      yr[j] = __float2bfloat16_rn(
          __fadd_rn(rnd<bf16>(__fmul_rn(y1, c1)), rnd<bf16>(__fmul_rn(-y2, s1))));
      yr[j + half] = __float2bfloat16_rn(
          __fadd_rn(rnd<bf16>(__fmul_rn(y2, c2)), rnd<bf16>(__fmul_rn(y1, s2))));
    }
  }
  __syncthreads();
  phase_stamp(kPhaseStamps - 4);

  if (save) {  // q, k, v of the block's own rows, as bf16 pairs (Dh is even)
    for (int idx = threadIdx.x; idx < QB * half; idx += kFusedThreads) {
      const int i = idx / half, d = 2 * (idx - i * half);
      const size_t o = boff + (size_t)(base + i) * D + h * Dh + d;
      *reinterpret_cast<__nv_bfloat162*>(qres + o) =
          *reinterpret_cast<const __nv_bfloat162*>(qs + i * ST + d);
      *reinterpret_cast<__nv_bfloat162*>(kres + o) =
          *reinterpret_cast<const __nv_bfloat162*>(ks + (PREV + i) * ST + d);
      *reinterpret_cast<__nv_bfloat162*>(vres + o) =
          *reinterpret_cast<const __nv_bfloat162*>(vs + (PREV + i) * ST + d);
    }
  }

  phase_stamp(kPhaseStamps - 3);
  const Tile T{qs, ks, vs, kcs, ST, Dhp / 16, W, L, scale};
  attend_block(T, QB, Dh, base, k0row, C, t_real, out + boff + (size_t)base * D + h * Dh, D,
               save ? lse + ((size_t)b * T1 + base) * H + h : nullptr, H, mean, any_empty,
               [] {});
  __syncthreads();
  phase_stamp(kPhaseStamps - 1);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

// Shared memory (bytes) of one block of the tensor-core K3f;
// ops/attention_kernels.py::_fused_tc_smem computes the same sum.
int fused_attention_fwd_tc_smem(int QB, int W, int Dh) { return (int)Layout(QB, W, Dh).bytes(); }

// Launches the tensor-core K3f (bf16 streams only) on `stream`: the first
// launch (lnx, the normalised rows, B*T1*D bf16 into `lnx`; the rotary table
// into `rot`, (T1 + L*C) * D bf16 pairs), then the fused kernel over the
// grid (T1/QB, H, B); returns the CUDA error code (0 on success).  It takes
// wq, wk and wv alone: the rotary's W@R products are formed from them.  With
// save == 0, qs, ks, vs and lse may be null.
int fused_attention_fwd_tc(const void* x, const void* wq, const void* wk, const void* wv,
                           const float* lng, const float* lnb, const float* freq,
                           const int* lengths, void* out, void* qs, void* ks, void* vs,
                           float* lse, void* lnx, void* rot, int B, int T1, int H, int Dh, int C,
                           int L, int t_real, int QB, int offset, int save, float scale,
                           float eps, void* stream) {
  if (Dh % 2 || QB <= 0 || T1 % QB) return (int)cudaErrorInvalidValue;
  const int W = QB + L * C, D = H * Dh, PREV = L * C;
  const int vec = Dh % 8 == 0 && aligned16(lnx) && aligned16(wq) && aligned16(wk) &&
                  aligned16(wv);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = Layout(QB, W, Dh).bytes();
  const cudaStream_t s = (cudaStream_t)stream;
  const int rows = B * T1, prep_blocks = min((rows + kPrepWarps - 1) / kPrepWarps, 8 * sms);
  fused_attention_prep_kernel<<<prep_blocks, kPrepWarps * 32, 0, s>>>(
      (const bf16*)x, lng, lnb, freq, (bf16*)lnx, (__nv_bfloat162*)rot, rows, T1, D, PREV, offset,
      eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(fused_attention_fwd_tc_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_attention_fwd_tc_kernel<<<dim3(T1 / QB, H, B), kFusedThreads, smem, s>>>(
      (const bf16*)lnx, (const bf16*)wq, (const bf16*)wk, (const bf16*)wv,
      (const __nv_bfloat162*)rot, lengths, (bf16*)out, (bf16*)qs, (bf16*)ks, (bf16*)vs, lse, T1,
      H, Dh, C, L, t_real, QB, offset, scale, save, vec);
  return (int)cudaGetLastError();
}

#ifdef ATTN_PHASE_CLOCKS
// Where the phase clocks go ((blocks, kPhaseStamps) int64 on the device;
// null stops them): only in the copy ops/phase_clocks.py builds.
int attn_set_phase_clocks(long long* clocks) {
  return (int)cudaMemcpyToSymbol(attn_phase_clocks, &clocks, sizeof(clocks));
}
#endif

}  // extern "C"
