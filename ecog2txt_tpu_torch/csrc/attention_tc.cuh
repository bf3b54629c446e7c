// Shared device code of the chunk-causal attention kernels on the tensor
// cores (bf16 streams): K2f's body (banded_attention_tc.cu), K2b-dq and
// K2b-dkv (banded_attention_bwd_tc.cu) and K3f's body
// (fused_attention_tc.cu), which runs K2f's attention (attend_block) on the
// q, k and v it projects.  bf16 staging into shared memory
// by cp.async, ldmatrix and mma.sync m16n8k16 (bf16 in, f32 accumulate),
// and the band as per-row chunk ids.
//
// Fragment layouts of m16n8k16 (g = lane / 4, t4 = lane % 4): the C (and
// D) fragment of an n8 tile holds c0, c1 = row g, columns 2*t4 and
// 2*t4 + 1, and c2, c3 = row g + 8, the same columns.  Two n8 tiles of
// C, packed pairwise to bf16, are the A fragment of the next product
// (rows of C, and its 16 columns as the depth): {pack(c[0][0], c[0][1]),
// pack(c[0][2], c[0][3]), pack(c[1][0], c[1][1]), pack(c[1][2], c[1][3])}.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace attn_tc {

using attn::kNeg;

// Phase clocks, compiled in only with -DATTN_PHASE_CLOCKS (the tool
// ops/phase_clocks.py builds such a copy; the kernels the port runs have
// none): thread 0 of each block writes clock64() at fixed stamp indices
// into attn_phase_clocks[block * kPhaseStamps + index].
constexpr int kPhaseStamps = 64;
#ifdef ATTN_PHASE_CLOCKS
__device__ long long* attn_phase_clocks;
__device__ __forceinline__ void phase_stamp(int index) {
  if (threadIdx.x == 0 && attn_phase_clocks != nullptr && index < kPhaseStamps) {
    const size_t block = ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    attn_phase_clocks[block * kPhaseStamps + index] = clock64();
  }
}
#else
__device__ __forceinline__ void phase_stamp(int) {}
#endif

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a . b for one m16n8k16 tile: bf16 operands, f32 accumulator
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows [row0, row0 + nrows) of the (T1, D) matrix `src` (one batch row),
// columns [col0, col0 + Dh), into dst (nrows_p x Dhp, row stride ST);
// rows outside [0, T1) or past nrows and columns past Dh are zeros and
// never read.  With `vec` (Dh and D multiples of 8, 16-byte aligned
// tensors) by cp.async in 16-byte chunks, else by scalar copies.
__device__ void stage(bf16* dst, int ST, const bf16* src, int row0, int nrows, int nrows_p,
                      int T1, int D, int col0, int Dh, int Dhp, bool vec) {
  if (vec) {
    const int cpr = Dhp / 8;
    for (int idx = threadIdx.x; idx < nrows_p * cpr; idx += blockDim.x) {
      const int r = idx / cpr, c = (idx - r * cpr) * 8, g = row0 + r;
      const bool ok = r < nrows && g >= 0 && g < T1 && c < Dh;
      const bf16* s = ok ? src + (size_t)g * D + col0 + c : src;
      cp_async16(smem_addr(dst + r * ST + c), s, ok ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < nrows_p * Dhp; idx += blockDim.x) {
      const int r = idx / Dhp, c = idx - r * Dhp, g = row0 + r;
      const bool ok = r < nrows && g >= 0 && g < T1 && c < Dh;
      dst[r * ST + c] = ok ? src[(size_t)g * D + col0 + c] : __float2bfloat16_rn(0.f);
    }
  }
}

// The band of _band_mask as chunk ids: key j of the window is admitted
// for query row i iff kc[j] <= qc[i] <= kc[j] + L, where kc[j] is the
// key's chunk (kNoKey where the key is masked whatever the query: outside
// [0, t_real) locally, at a negative absolute position or at/past the
// valid length) and qc[i] the query's chunk (kNoRow past t_real).
constexpr int kNoKey = 1 << 29;
constexpr int kNoRow = -(1 << 29);

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}


// ---------------------------------------------------------------------------
// K2f's attention over a block whose Q, K and V are staged in shared memory:
// the tail of K2f's tensor-core body (banded_attention_tc.cu), which K3f's
// tensor-core body (fused_attention_tc.cu) runs on the q, k and v it
// projected itself.

constexpr int kOutChunk = 64;  // output head columns a pass 2 accumulates

struct Tile {
  const bf16 *qs, *ks, *vs;
  const int* kc;  // [W] key chunk ids (shared memory)
  int ST, KS, W, L;
  float scale;
};

// The masked, scaled scores of the warp's rows r0..r0+15 against keys
// kt*16..kt*16+15: s[nt][e] is row r0 + g + 8*(e >= 2), key kt*16 + nt*8 +
// 2*(lane%4) + (e & 1).  Masked keys are -1e30, keys past W are -inf.
__device__ __forceinline__ void scores(float (&s)[2][4], const Tile& T, int r0, int kt,
                                       int lane, const int (&qc)[2]) {
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
  const int mi = lane >> 3, lr = lane & 7;
  const uint32_t qa = smem_addr(T.qs + (r0 + (mi & 1) * 8 + lr) * T.ST + (mi >> 1) * 8);
  const uint32_t ka = smem_addr(T.ks + (kt * 16 + (mi >> 1) * 8 + lr) * T.ST + (mi & 1) * 8);
  for (int kk = 0; kk < T.KS; ++kk) {
    uint32_t a[4], b[4];
    ldsm_x4(a, qa + kk * 32);
    ldsm_x4(b, ka + kk * 32);
    mma16816(s[0], a, b[0], b[1]);
    mma16816(s[1], a, b[2], b[3]);
  }
  const int t4 = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = kt * 16 + nt * 8 + 2 * t4 + (e & 1), q = qc[e >> 1];
      float v;
      if (j >= T.W) {
        v = __int_as_float(0xff800000);  // -inf: padding, not a key
      } else {
        const int kc = T.kc[j];
        v = kc <= q && kc + T.L >= q ? s[nt][e] * T.scale : kNeg;
      }
      s[nt][e] = v;
    }
}

// Pass 1 over key tiles [k0, k1]: m[h] and den[h] of row r0 + g + 8h.
__device__ __forceinline__ void row_stats(float (&m)[2], float (&den)[2], const Tile& T, int r0,
                                          int k0, int k1, int lane, const int (&qc)[2]) {
  const float ninf = __int_as_float(0xff800000);
  float mt[2] = {ninf, ninf}, lt[2] = {0.f, 0.f};
  for (int kt = k0; kt <= k1; ++kt) {
    float s[2][4];
    scores(s, T, r0, kt, lane, qc);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const float tmax = fmaxf(fmaxf(s[0][2 * hr], s[0][2 * hr + 1]),
                               fmaxf(s[1][2 * hr], s[1][2 * hr + 1]));
      const float mn = fmaxf(mt[hr], tmax);
      if (mn == ninf) continue;  // only padding so far
      float l = mt[hr] == mn ? lt[hr] : lt[hr] * expf(mt[hr] - mn);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = s[nt][2 * hr + e];
          l += v == ninf ? 0.f : expf(v - mn);
        }
      mt[hr] = mn;
      lt[hr] = l;
    }
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    m[hr] = quad_max(mt[hr]);
    den[hr] = quad_sum(mt[hr] == ninf ? 0.f : lt[hr] * expf(mt[hr] - m[hr]));
  }
}

// The chunk-causal attention of one block (query rows base .. base + QB - 1,
// key window k0row .. k0row + W - 1, local rows) on the tensor cores, from
// the tiles of T: Q (QBp x ST), K and V (Wp x ST) in bf16, pad rows and
// columns zero, and the keys' chunk ids (kNoKey where a key is masked
// whatever the query).  min(#warps, QBp / 16) warps each own 16 query rows
// at a time.  Writes row i's Dh output columns at out_rows + i * D and, with
// lse_rows, its lse at lse_rows[i * H].  `mean` is Dhp floats of shared
// memory; *any_empty a shared flag the caller zeroed before a barrier that
// precedes this call.  Every thread calls wait_v() once before V is first
// read (K2f's wait for its cp.async group of V; nothing for K3f).
template <typename WaitV>
__device__ __forceinline__ void attend_block(const Tile& T, int QB, int Dh, int base, int k0row,
                                             int C, int t_real, bf16* out_rows, int D,
                                             float* lse_rows, int H, float* mean,
                                             int* any_empty, WaitV wait_v) {
  const int W = T.W, L = T.L, ST = T.ST, Dhp = 16 * T.KS, QBp = (QB + 15) & ~15;
  const bf16* vs = T.vs;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t4 = lane & 3;
  const int nwarps = blockDim.x / 32, groups = QBp / 16;
  const bool pairs = (Dh & 1) == 0;  // bf16x2 stores of the output
  const float ninf = __int_as_float(0xff800000);
  // every warp runs the same number of rounds, so the barriers below are uniform
  const int rounds = (groups + nwarps - 1) / nwarps;
  for (int round = 0; round < rounds; ++round) {
    const int rg = round * nwarps + warp;
    const bool active = rg < groups;
    const int r0 = rg * 16;
    float m[2] = {0.f, 0.f}, den[2] = {1.f, 1.f};
    bool empty[2] = {false, false};
    int qc[2], k0 = 0, k1 = -1;
    if (active) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int gq = base + r0 + g + 8 * hr;  // >= 0
        qc[hr] = gq < t_real ? gq / C : kNoRow;
      }
      // key tiles the band can admit for query rows base + r0 .. + 15
      const int j0 = max(((base + r0) / C - L) * C - k0row, 0);
      const int j1 = min(((base + r0 + 15) / C + 1) * C - 1 - k0row, W - 1);
      if (j0 <= j1) {
        k0 = j0 / 16;
        k1 = j1 / 16;
      }
      row_stats(m, den, T, r0, k0, k1, lane, qc);
      // A row with no admitted key (none in the window at all: the band is
      // inside the tile range) is the uniform average of the window:
      // m = -1e30, each of the W keys weighs exp(0) = 1, denom = W.
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        empty[hr] = k1 < k0 || m[hr] == kNeg;
        if (empty[hr]) {
          m[hr] = kNeg;
          den[hr] = (float)W;
        }
      }
      if (__any_sync(0xffffffffu, empty[0] || empty[1]) && lane == 0) *any_empty = 1;
      if (t4 == 0) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int i = r0 + g + 8 * hr;
          if (i < QB && lse_rows != nullptr) lse_rows[(size_t)i * H] = m[hr] + logf(den[hr]);
        }
      }
    }
    if (round == 0) {
      wait_v();
      __syncthreads();  // V staged; every warp of round 0 has flagged its empty rows
      if (rounds > 1 || *any_empty) {
        // the uniform average S(sum_j S(1/W) v_j), once for the block: 8
        // lanes a column, lane part taking keys part, part + 8, ..., then a
        // fixed shuffle tree over the 8 (a warp takes 4 columns at a time)
        const float p = __bfloat162float(__float2bfloat16_rn(1.f / (float)W));
        const int part = lane & 7;
        for (int d0 = warp * 4; d0 < Dhp; d0 += nwarps * 4) {
          const int d = d0 + (lane >> 3);
          float acc = 0.f;
          if (d < Dhp) {
            for (int j = part; j < W; j += 8) acc = fmaf(p, __bfloat162float(vs[j * ST + d]), acc);
          }
          acc += __shfl_xor_sync(0xffffffffu, acc, 1);
          acc += __shfl_xor_sync(0xffffffffu, acc, 2);
          acc += __shfl_xor_sync(0xffffffffu, acc, 4);
          if (part == 0 && d < Dhp) mean[d] = acc;
        }
        __syncthreads();
      }
      phase_stamp(kPhaseStamps - 2);  // K3f: attention pass 1 and the window's average
    }
    if (!active) continue;
    const int mi = lane >> 3, lr = lane & 7;
    for (int c0 = 0; c0 < Dhp; c0 += kOutChunk) {
      float o[kOutChunk / 8][4];
#pragma unroll
      for (int nt = 0; nt < kOutChunk / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
      for (int kt = k0; kt <= k1; ++kt) {
        float s[2][4];
        scores(s, T, r0, kt, lane, qc);
        float p[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = s[nt][e];
            p[nt][e] = x == ninf ? 0.f : expf(x - m[e >> 1]) / den[e >> 1];
          }
        // the score tile's C fragment, repacked as the A fragment of p.v
        const uint32_t a[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                               pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
        const uint32_t va =
            smem_addr(vs + (kt * 16 + (mi & 1) * 8 + lr) * ST + c0 + (mi >> 1) * 8);
#pragma unroll
        for (int np = 0; np < kOutChunk / 16; ++np) {
          if (c0 + np * 16 < Dhp) {
            uint32_t bv[4];
            ldsm_x4_trans(bv, va + np * 32);
            mma16816(o[2 * np], a, bv[0], bv[1]);
            mma16816(o[2 * np + 1], a, bv[2], bv[3]);
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < kOutChunk / 8; ++nt) {
        const int col = c0 + nt * 8 + 2 * t4;
        if (col >= Dh) continue;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int i = r0 + g + 8 * hr;
          if (i >= QB) continue;
          const float y0 = empty[hr] ? mean[col] : o[nt][2 * hr];
          const float y1 = empty[hr] ? mean[col + 1] : o[nt][2 * hr + 1];
          bf16* dst = out_rows + (size_t)i * D + col;
          if (pairs) {
            *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(y0, y1);
          } else {
            dst[0] = __float2bfloat16_rn(y0);
            if (col + 1 < Dh) dst[1] = __float2bfloat16_rn(y1);
          }
        }
      }
    }
  }
}


}  // namespace attn_tc
