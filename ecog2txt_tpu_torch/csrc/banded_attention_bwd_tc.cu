// Chunk-causal ("banded") attention backward for Hopper (sm_90a) on the
// tensor cores: the bf16 bodies of K2b-dq and K2b-dkv.
//
// Replaces ecog2txt_tpu/ops/pallas_attention.py::_bwd_calls (the
// pallas_calls at :290 for dq and :302 for dk/dv) for bf16 streams; f32
// streams keep the CUDA-core bodies of banded_attention.cu (the tensor
// cores have no f32 product, and TF32 would break the f32 tolerance).
// Semantics are the Pallas kernels' and the plain versions'
// (ops/attention_kernels.py::banded_attention_{dq,dkv}_reference):
//
//   p   = exp(f32(q.k^T) * scale - lse)    where the band admits the key, else 0
//   ds  = S(p * (f32(g.v^T) - delta))
//   dq  = S(f32(ds . k) * scale)          over the query block's key window
//   dv  = S(f32(S(p)^T . g))              over the key block's attending rows
//   dk  = S(f32(ds^T . q) * scale)
//
// with S the bf16 rounding.  Rows with no valid key get p = 0 (the
// forward's uniform average has no gradient here, as in Pallas).
//
// Bound on the card.  At the headline shape (B=256, T1=128, QB=128,
// window 144, Dh=64, H=6) each kernel reads q, k, v, g once and writes
// dq (or dk and dv) once: ~125 MB (~150 MB for dk/dv) of bf16, ~0.04 ms at
// the HBM rate.  The band admits L+1 chunks of keys per query row (32 of
// 144 at the headline), so the products are a few MFLOP a block, far
// below the tensor cores' ridge: bytes bound it.
//
// Design (the pieces of K2f's tensor-core body, attention_tc.cuh; the
// block structure is the Pallas kernels'):
// - K2b-dq: one block per (query block n, head h, batch row b).  Q and G
//   of the block and K and V of its QB + L*C key window go to shared
//   memory in bf16 by cp.async (rows outside [0, T1) zero-filled, never
//   read), with the window keys' chunk ids (a sentinel where the key is
//   masked whatever the query).  Each warp owns 16 query rows, and holds
//   their lse, delta and chunk id in registers.  Per key tile the band
//   admits (within the valid keys), S = Q.K^T and dP = G.V^T on the
//   tensor cores (mma.sync m16n8k16, K and V as non-transposed B
//   operands), p and ds in the C fragments, ds repacked as the A operand
//   of dQ += ds.K (K by ldmatrix.trans).
// - K2b-dkv: one block per (key block n, head h, batch row b).  K and V
//   of the block, and Q, G, lse, delta and the chunk ids of its attending
//   rows [n*QB, n*QB + QB + L*C) go to shared memory; rows at or past T1
//   stage as zeros and are masked.  Each warp owns 16 key rows: per query
//   tile the band admits, S^T = K.Q^T and dP^T = V.G^T, then
//   dV += S(p)^T.G and dK += ds^T.Q with the transposed tiles repacked
//   as A operands (G and Q by ldmatrix.trans).
// - A warp whose rows have no valid key in their band (rows past t_real
//   or past the valid length, the padding of T1) walks no tile and writes
//   zeros, so the padding does not cost a window walk.
// - The accumulators cover 64 head columns (8 n8 tiles; dkv holds two);
//   a wider head recomputes the tile products once per 64 columns.
// - Rounding where Pallas rounds: ds and S(p) enter the products as bf16
//   (the A operand's rounding is that rounding), the sums stay f32.

#include <stdint.h>

#include "attention_common.cuh"
#include "attention_tc.cuh"

using namespace attn;
using namespace attn_tc;

namespace {

constexpr int kTcWarps = 8;  // warps a block, at most
constexpr int kChunk = 64;   // head columns an accumulator covers

// The 16 x 16 tile A[ar0 .. ar0+15] . B[br0 .. br0+15]^T of two row-major
// (rows x ST) bf16 operands in shared memory, over depth 16 * KS:
// s[nt][e] is row ar0 + g + 8*(e >= 2), column br0 + nt*8 + 2*t4 + (e & 1).
__device__ __forceinline__ void tile_product(float (&s)[2][4], const bf16* as, int ar0,
                                             const bf16* bs, int br0, int ST, int KS, int lane) {
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
  const int mi = lane >> 3, lr = lane & 7;
  const uint32_t aa = smem_addr(as + (ar0 + (mi & 1) * 8 + lr) * ST + (mi >> 1) * 8);
  const uint32_t ba = smem_addr(bs + (br0 + (mi >> 1) * 8 + lr) * ST + (mi & 1) * 8);
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t a[4], b[4];
    ldsm_x4(a, aa + kk * 32);
    ldsm_x4(b, ba + kk * 32);
    mma16816(s[0], a, b[0], b[1]);
    mma16816(s[1], a, b[2], b[3]);
  }
}

// acc[nt] += a . X[x0 .. x0+15, c0 + nt*8 ..] for the head columns of
// chunk c0: X (rows x ST, row-major bf16) read transposed by ldmatrix.
__device__ __forceinline__ void accumulate(float (&acc)[kChunk / 8][4], const uint32_t (&a)[4],
                                           const bf16* xs, int x0, int c0, int ST, int Dhp,
                                           int lane) {
  const int mi = lane >> 3, lr = lane & 7;
  const uint32_t xa = smem_addr(xs + (x0 + (mi & 1) * 8 + lr) * ST + c0 + (mi >> 1) * 8);
#pragma unroll
  for (int np = 0; np < kChunk / 16; ++np) {
    if (c0 + np * 16 < Dhp) {
      uint32_t b[4];
      ldsm_x4_trans(b, xa + np * 32);
      mma16816(acc[2 * np], a, b[0], b[1]);
      mma16816(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[kChunk / 8][4]) {
#pragma unroll
  for (int nt = 0; nt < kChunk / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
}

// Rows r0 + g + 8*hr (hr = 0, 1) of `acc` * mul, rounded to bf16, into
// rows base + i (i < QB) of dst's head columns [c0, c0 + kChunk) ∩ [0, Dh).
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[kChunk / 8][4],
                                           float mul, int r0, int QB, int base, int D, int col0,
                                           int c0, int Dh, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
  const bool pairs = (Dh & 1) == 0;  // bf16x2 stores
#pragma unroll
  for (int nt = 0; nt < kChunk / 8; ++nt) {
    const int col = c0 + nt * 8 + 2 * t4;
    if (col >= Dh) continue;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int i = r0 + g + 8 * hr;
      if (i >= QB) continue;
      const float y0 = acc[nt][2 * hr] * mul, y1 = acc[nt][2 * hr + 1] * mul;
      bf16* o = dst + (size_t)(base + i) * D + col0 + col;
      if (pairs) {
        *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(y0, y1);
      } else {
        o[0] = __float2bfloat16_rn(y0);
        if (col + 1 < Dh) o[1] = __float2bfloat16_rn(y1);
      }
    }
  }
}

// The valid key rows (local): [kv0, kv1) of _band_mask's key conditions
// (inside [0, t_real), at absolute positions >= 0 and < length).
struct KeyRange {
  int kv0;
  long long kv1;
  __device__ KeyRange(int t_real, int offset, int length)
      : kv0(max(0, -offset)), kv1(min((long long)t_real, (long long)length - offset)) {}
};

// K2b-dq: dq of query block n, head h, batch row b.
__global__ void __launch_bounds__(kTcWarps * 32, 2)
    banded_attention_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                  const bf16* __restrict__ v, const bf16* __restrict__ g,
                                  const float* __restrict__ lse, const float* __restrict__ delta,
                                  const int* __restrict__ lengths, bf16* __restrict__ dq, int T1,
                                  int H, int Dh, int C, int L, int t_real, int QB, int offset,
                                  float scale, int vec) {
  const int n = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int PREV = L * C, W = QB + PREV, D = H * Dh;
  const int Dhp = (Dh + 15) & ~15, ST = Dhp + 8, KS = Dhp / 16;
  const int QBp = (QB + 15) & ~15, Wp = (W + 15) & ~15;
  const int base = n * QB, k0row = base - PREV;  // local rows of query 0 and key 0
  const size_t boff = (size_t)b * T1 * D;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* gs = qs + QBp * ST;
  bf16* ks = gs + QBp * ST;
  bf16* vs = ks + Wp * ST;
  int* kcs = reinterpret_cast<int*>(vs + Wp * ST);  // [Wp] key chunk ids

  stage(qs, ST, q + boff, base, QB, QBp, T1, D, h * Dh, Dh, Dhp, vec);
  stage(gs, ST, g + boff, base, QB, QBp, T1, D, h * Dh, Dh, Dhp, vec);
  stage(ks, ST, k + boff, k0row, W, Wp, T1, D, h * Dh, Dh, Dhp, vec);
  stage(vs, ST, v + boff, k0row, W, Wp, T1, D, h * Dh, Dh, Dhp, vec);
  cp_async_commit();
  const KeyRange keys(t_real, offset, lengths[b]);
  for (int j = threadIdx.x; j < W; j += blockDim.x) {
    const int gk = k0row + j;
    kcs[j] = gk >= keys.kv0 && gk < keys.kv1 ? floordiv(gk, C) : kNoKey;
  }
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gr = lane >> 2, t4 = lane & 3;
  const int nwarps = blockDim.x / 32, groups = QBp / 16;
  for (int rg = warp; rg < groups; rg += nwarps) {  // no barrier below: warps run free
    const int r0 = rg * 16;
    int qc[2];
    float lse_r[2], delta_r[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int i = r0 + gr + 8 * hr, gq = base + i;  // gq >= 0
      const bool ok = i < QB && gq < t_real;
      const size_t o = ((size_t)b * T1 + gq) * H + h;
      qc[hr] = ok ? gq / C : kNoRow;
      lse_r[hr] = ok ? lse[o] : 0.f;
      delta_r[hr] = ok ? delta[o] : 0.f;
    }
    // key tiles the band admits for the warp's rows, within the valid keys
    int k0 = 0, k1 = -1;
    const int gq_hi = min(base + min(r0 + 15, QB - 1), t_real - 1);
    if (base + r0 <= gq_hi) {
      const int j0 = max(max(((base + r0) / C - L) * C, keys.kv0) - k0row, 0);
      const long long j1 =
          min(min((long long)(gq_hi / C + 1) * C, keys.kv1) - 1 - k0row, (long long)W - 1);
      if (j0 <= j1) {
        k0 = j0 / 16;
        k1 = (int)j1 / 16;
      }
    }
    for (int c0 = 0; c0 < Dhp; c0 += kChunk) {
      float acc[kChunk / 8][4];
      zero(acc);
      for (int kt = k0; kt <= k1; ++kt) {
        float s[2][4], dp[2][4];
        tile_product(s, qs, r0, ks, kt * 16, ST, KS, lane);
        tile_product(dp, gs, r0, vs, kt * 16, ST, KS, lane);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = kt * 16 + nt * 8 + 2 * t4 + (e & 1), hr = e >> 1;
            const int kc = j < W ? kcs[j] : kNoKey;
            const float p =
                kc <= qc[hr] && kc + L >= qc[hr] ? expf(s[nt][e] * scale - lse_r[hr]) : 0.f;
            s[nt][e] = p * (dp[nt][e] - delta_r[hr]);  // ds, rounded by the repack
          }
        const uint32_t a[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                               pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
        accumulate(acc, a, ks, kt * 16, c0, ST, Dhp, lane);
      }
      store_rows(dq + boff, acc, scale, r0, QB, base, D, h * Dh, c0, Dh, lane);
    }
  }
}

// K2b-dkv: dk and dv of key block n, head h, batch row b; its attending
// query rows are [n*QB, n*QB + QB + L*C).
__global__ void __launch_bounds__(kTcWarps * 32, 2)
    banded_attention_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                   const bf16* __restrict__ v, const bf16* __restrict__ g,
                                   const float* __restrict__ lse,
                                   const float* __restrict__ delta,
                                   const int* __restrict__ lengths, bf16* __restrict__ dk,
                                   bf16* __restrict__ dv, int T1, int H, int Dh, int C, int L,
                                   int t_real, int QB, int offset, float scale, int vec) {
  const int n = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int PREV = L * C, Wq = QB + PREV, D = H * Dh;
  const int Dhp = (Dh + 15) & ~15, ST = Dhp + 8, KS = Dhp / 16;
  const int QBp = (QB + 15) & ~15, Wqp = (Wq + 15) & ~15;
  const int base = n * QB;  // local row of key 0 and of attending query 0
  const size_t boff = (size_t)b * T1 * D;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + QBp * ST;
  bf16* qs = vs + QBp * ST;
  bf16* gs = qs + Wqp * ST;
  int* qcs = reinterpret_cast<int*>(gs + Wqp * ST);  // [Wqp] query chunk ids
  float* lses = reinterpret_cast<float*>(qcs + Wqp);  // [Wqp]
  float* dels = lses + Wqp;                           // [Wqp]

  stage(ks, ST, k + boff, base, QB, QBp, T1, D, h * Dh, Dh, Dhp, vec);
  stage(vs, ST, v + boff, base, QB, QBp, T1, D, h * Dh, Dh, Dhp, vec);
  stage(qs, ST, q + boff, base, Wq, Wqp, T1, D, h * Dh, Dh, Dhp, vec);
  stage(gs, ST, g + boff, base, Wq, Wqp, T1, D, h * Dh, Dh, Dhp, vec);
  cp_async_commit();
  for (int i = threadIdx.x; i < Wqp; i += blockDim.x) {
    const int gq = base + i;
    const bool ok = i < Wq && gq < t_real;  // t_real <= T1: rows past T1 are not read
    const size_t o = ((size_t)b * T1 + gq) * H + h;
    qcs[i] = ok ? gq / C : kNoRow;
    lses[i] = ok ? lse[o] : 0.f;
    dels[i] = ok ? delta[o] : 0.f;
  }
  const KeyRange keys(t_real, offset, lengths[b]);
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gr = lane >> 2, t4 = lane & 3;
  const int nwarps = blockDim.x / 32, groups = QBp / 16;
  for (int rg = warp; rg < groups; rg += nwarps) {  // no barrier below: warps run free
    const int r0 = rg * 16;
    int kc[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int i = r0 + gr + 8 * hr, gk = base + i;
      kc[hr] = i < QB && gk >= keys.kv0 && gk < keys.kv1 ? gk / C : kNoKey;
    }
    // query tiles the band admits for the warp's valid keys
    int q0 = 0, q1 = -1;
    const int lo = max(base + r0, keys.kv0);
    const long long hi = min((long long)base + min(r0 + 15, QB - 1), keys.kv1 - 1);
    if (lo <= hi) {
      const int i0 = max((lo / C) * C - base, 0);
      const int i1 = min(min(((int)hi / C + L + 1) * C, t_real) - 1 - base, Wq - 1);
      if (i0 <= i1) {
        q0 = i0 / 16;
        q1 = i1 / 16;
      }
    }
    for (int c0 = 0; c0 < Dhp; c0 += kChunk) {
      float dva[kChunk / 8][4], dka[kChunk / 8][4];
      zero(dva);
      zero(dka);
      for (int qt = q0; qt <= q1; ++qt) {
        float s[2][4], dp[2][4];
        tile_product(s, ks, r0, qs, qt * 16, ST, KS, lane);   // S^T: keys x queries
        tile_product(dp, vs, r0, gs, qt * 16, ST, KS, lane);  // dP^T
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = qt * 16 + nt * 8 + 2 * t4 + (e & 1), hr = e >> 1;
            const int qci = qcs[i];
            const float p = kc[hr] <= qci && kc[hr] + L >= qci
                                ? expf(s[nt][e] * scale - lses[i]) : 0.f;
            s[nt][e] = p;                      // S(p) by the repack
            dp[nt][e] = p * (dp[nt][e] - dels[i]);  // ds, likewise
          }
        const uint32_t ap[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                                pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
        const uint32_t ad[4] = {pack_bf16(dp[0][0], dp[0][1]), pack_bf16(dp[0][2], dp[0][3]),
                                pack_bf16(dp[1][0], dp[1][1]), pack_bf16(dp[1][2], dp[1][3])};
        accumulate(dva, ap, gs, qt * 16, c0, ST, Dhp, lane);
        accumulate(dka, ad, qs, qt * 16, c0, ST, Dhp, lane);
      }
      store_rows(dv + boff, dva, 1.f, r0, QB, base, D, h * Dh, c0, Dh, lane);
      store_rows(dk + boff, dka, scale, r0, QB, base, D, h * Dh, c0, Dh, lane);
    }
  }
}

int tc_warps(int QB) { return min(kTcWarps, (QB + 15) / 16); }

int staged_vec(int Dh, const void* q, const void* k, const void* v, const void* g) {
  return Dh % 8 == 0 &&
         ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
           reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(g)) % 16) == 0;
}

}  // namespace

extern "C" {

// Shared memory (bytes) of one block of the tensor-core K2b-dq and
// K2b-dkv at query block QB, window W = QB + L*C and head dim Dh;
// ops/attention_kernels.py::_k2b_tc_smem computes the same sums.
int banded_attention_dq_tc_smem(int QB, int W, int Dh) {
  const int ST = ((Dh + 15) & ~15) + 8, QBp = (QB + 15) & ~15, Wp = (W + 15) & ~15;
  return 2 * (2 * QBp + 2 * Wp) * ST + 4 * Wp;
}

int banded_attention_dkv_tc_smem(int QB, int W, int Dh) {
  const int ST = ((Dh + 15) & ~15) + 8, QBp = (QB + 15) & ~15, Wp = (W + 15) & ~15;
  return 2 * (2 * QBp + 2 * Wp) * ST + 12 * Wp;
}

// Each launches one kernel (bf16 streams only) on `stream` over the grid
// (T1/QB, H, B) and returns the CUDA error code (0 on success).
int banded_attention_dq_tc(const void* q, const void* k, const void* v, const void* g,
                           const float* lse, const float* delta, const int* lengths, void* dq,
                           int B, int T1, int H, int Dh, int C, int L, int t_real, int QB,
                           int offset, float scale, void* stream) {
  const int smem = banded_attention_dq_tc_smem(QB, QB + L * C, Dh);
  cudaError_t err = cudaFuncSetAttribute(banded_attention_dq_tc_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  banded_attention_dq_tc_kernel<<<dim3(T1 / QB, H, B), tc_warps(QB) * 32, smem,
                                  (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)g, lse, delta, lengths,
      (bf16*)dq, T1, H, Dh, C, L, t_real, QB, offset, scale, staged_vec(Dh, q, k, v, g));
  return (int)cudaGetLastError();
}

int banded_attention_dkv_tc(const void* q, const void* k, const void* v, const void* g,
                            const float* lse, const float* delta, const int* lengths, void* dk,
                            void* dv, int B, int T1, int H, int Dh, int C, int L, int t_real,
                            int QB, int offset, float scale, void* stream) {
  const int smem = banded_attention_dkv_tc_smem(QB, QB + L * C, Dh);
  cudaError_t err = cudaFuncSetAttribute(banded_attention_dkv_tc_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  banded_attention_dkv_tc_kernel<<<dim3(T1 / QB, H, B), tc_warps(QB) * 32, smem,
                                   (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)g, lse, delta, lengths,
      (bf16*)dk, (bf16*)dv, T1, H, Dh, C, L, t_real, QB, offset, scale,
      staged_vec(Dh, q, k, v, g));
  return (int)cudaGetLastError();
}

}  // extern "C"
