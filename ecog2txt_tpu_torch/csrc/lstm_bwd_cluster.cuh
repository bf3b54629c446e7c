// The bf16 body of the LSTM adjoint on a thread-block cluster, shared by
// K1b (lstm_bwd_cluster.cu: one direction a launch) and K4b
// (bilstm_grid.cu: both directions of a biLSTM layer in one launch, a
// direction axis on the grid).  lstm_bwd_cluster.cu's header describes
// the design; bwd_body is one CTA's whole launch for one direction, whose
// base pointers and reverse_time the caller puts in Args.

#pragma once

#include <cooperative_groups.h>
#include <stdint.h>

#include "lstm_common.cuh"

namespace lstm_cluster {

namespace cg = cooperative_groups;

typedef __nv_bfloat16 bf16;
using Bf = lstm::Stream<bf16>;

constexpr int kRows = 16;  // batch rows a cluster owns: one tensor-core tile (M)
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kPairIn = 7;  // a pair's step inputs: xw's four gates, cseq, cprev, dhseq

struct Args {
  const bf16 *xw, *wh, *hprev, *cprev, *cseq, *dhseq;
  const int* lengths;
  const float *mask, *dhT, *dcT;
  bf16* dgates;
  float *dh0, *dc0;
  int T, B, H, reverse_time, cs;
  int vec;        // H % 8 == 0, hprev and mask 16-byte aligned: hprev rows by cp.async
  int vec_pairs;  // H % 4 == 0, xw, cseq, cprev, dhseq 8-byte aligned: by cp.async too
};

struct Dims {
  int cs, R, Hp, Uc, G4p, SW, SH;  // rows; H and 4Uc padded to 16; strides of slice/dgs, hin
  __host__ __device__ Dims(int H, int cs) {
    this->cs = cs;
    R = kRows;
    Hp = (H + 15) & ~15;
    Uc = ((H + cs - 1) / cs + 3) & ~3;  // a multiple of 4: 16-byte pushes stay in one CTA
    G4p = (4 * Uc + 15) & ~15;
    SW = G4p + 8;
    SH = Hp + 8;
  }
  // recv (cs x R x Uc f32), slice (Hp x SW bf16), hin (R x SH bf16), dgs (R x SW bf16),
  // pin (R x 7 x Uc bf16)
  __host__ __device__ size_t smem() const {
    return (size_t)cs * R * Uc * 4 + (size_t)Hp * SW * 2 + (size_t)R * SH * 2 +
           (size_t)R * SW * 2 + (size_t)R * kPairIn * Uc * 2;
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

// The body of one CTA of the cluster: the whole adjoint chain of one
// direction, whose base pointers and reverse_time `a` carries.
__device__ __forceinline__ void bwd_body(const Args& a) {
  constexpr int R = kRows;
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = a.cs, c = (int)cluster.block_rank();
  const int T = a.T, B = a.B, H = a.H;
  const size_t G = 4 * (size_t)H;
  const Dims d(H, cs);
  const int Hp = d.Hp, Uc = d.Uc, G4p = d.G4p, SW = d.SW, SH = d.SH;
  const int row0 = (blockIdx.x / cs) * R;
  const int u0 = c * Uc, nu = max(0, min(Uc, H - u0));  // this CTA's units
  const bool pairs = u0 % 2 == 0 && nu % 2 == 0 && H % 2 == 0;  // bf16x2 dgates stores

  extern __shared__ __align__(16) unsigned char smem_raw[];
  // recv[r][row][u]: CTA r's partial of this CTA's units, pushed by CTA r
  float* recv = reinterpret_cast<float*>(smem_raw);          // [cs][R][Uc] f32
  bf16* slice = reinterpret_cast<bf16*>(recv + cs * R * Uc);  // [Hp][SW]
  bf16* hin = slice + (size_t)Hp * SW;                   // [R][SH]
  bf16* dgs = hin + R * SH;                              // [R][SW]
  bf16* pin = dgs + R * SW;  // [R][kPairIn][Uc]: the step's xw gates, cseq, cprev, dhseq

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3, mi = lane >> 3, lr = lane & 7;
  // gate n8-tile pairs; warp w owns pair w (NP <= kWarps)
  const int NP = G4p / 16;
  const bool owner = warp < NP;

  // ---- the resident slice: slice[i][4u + gate] = wh[i][gate*H + u0 + u] ----
  {
    uint4* z = reinterpret_cast<uint4*>(slice);
    const int n16 = (int)((size_t)Hp * SW * 2 / 16);
    for (int idx = threadIdx.x; idx < n16; idx += kThreads) z[idx] = make_uint4(0, 0, 0, 0);
    __syncthreads();
#pragma unroll 4
    for (int idx = threadIdx.x; idx < H * 4 * nu; idx += kThreads) {
      const int i = idx / (4 * nu), rem = idx - i * 4 * nu, gate = rem / nu, u = rem - gate * nu;
      slice[(size_t)i * SW + 4 * u + gate] = a.wh[(size_t)i * G + gate * H + u0 + u];
    }
  }

  // ---- the (row, unit) pairs this thread owns: gate tiles 2w + q, q = 0, 1 ----
  const int rl = g + (t4 & 1) * 8, row = row0 + rl;
  const bool row_ok = row < B;
  const int len = row_ok ? a.lengths[row] : 0;
  int ul[2];
  bool pv[2];
  float dh[2], dc[2], msk[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    ul[q] = 4 * warp + 2 * q + (t4 >> 1);
    pv[q] = owner && row_ok && ul[q] < nu;
    const size_t o = (size_t)row * H + u0 + ul[q];
    dh[q] = pv[q] ? a.dhT[o] : 0.f;
    dc[q] = pv[q] ? a.dcT[o] : 0.f;
    msk[q] = pv[q] ? a.mask[o] : 0.f;
  }

  auto step_t = [&](int s) { return a.reverse_time ? s : T - 1 - s; };
  // S(hprev[t] * mask) of the cluster's rows into hin, in two halves: with
  // a.vec, issue_hin starts cp.async copies of the raw rows (16-byte
  // chunks; rows past B and columns past H zero-filled) early, and
  // finish_hin waits for this thread's chunks and applies the mask in
  // place; otherwise finish_hin loads and masks element by element.
  const int CPR = Hp / 8;  // 16-byte chunks a row
  auto issue_hin = [&](int t) {
    if (!a.vec) return;
    for (int ci = threadIdx.x; ci < R * CPR; ci += kThreads) {
      const int r = ci / CPR, c8 = (ci - r * CPR) * 8, rw = row0 + r;
      const bool ok = rw < B && c8 < H;
      const bf16* src = ok ? a.hprev + ((size_t)t * B + rw) * H + c8 : a.hprev;
      cp_async16(smem_addr(hin + r * SH + c8), src, ok ? 16 : 0);
    }
  };
  auto finish_hin = [&](int t) {
    cp_async_wait_all();  // this thread's copies of hin and pin have landed
    if (a.vec) {
      for (int ci = threadIdx.x; ci < R * CPR; ci += kThreads) {
        const int r = ci / CPR, c8 = (ci - r * CPR) * 8, rw = row0 + r;
        if (rw >= B || c8 >= H) continue;
        const float4* mk = reinterpret_cast<const float4*>(a.mask + (size_t)rw * H + c8);
        const float4 m0 = mk[0], m1 = mk[1];
        uint4* hp = reinterpret_cast<uint4*>(hin + r * SH + c8);
        uint4 raw = *hp;
        __nv_bfloat162* x = reinterpret_cast<__nv_bfloat162*>(&raw);
        const float mv[8] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(x[e]);
          x[e] = __floats2bfloat162_rn(f.x * mv[2 * e], f.y * mv[2 * e + 1]);
        }
        *hp = raw;
      }
      return;
    }
    for (int idx = threadIdx.x; idx < R * Hp; idx += kThreads) {
      const int r = idx / Hp, i = idx - r * Hp, rw = row0 + r;
      float x = 0.f;
      if (rw < B && i < H) {
        x = Bf::load(a.hprev + ((size_t)t * B + rw) * H + i) * a.mask[(size_t)rw * H + i];
      }
      hin[r * SH + i] = __float2bfloat16_rn(x);
    }
  };
  // The step's inputs of the CTA's (row, unit) pairs into pin, by cp.async
  // in 8-byte runs of 4 units (coalesced rows; rows past B and units past
  // the CTA's zero-filled) where a.vec_pairs, else element by element.
  // The 8-byte runs need 4 | Uc (Dims) and 4 | H.
  auto load_pairs = [&](int t) {
    const int runs = Uc / 4, n = R * kPairIn * runs;
    for (int idx = threadIdx.x; idx < n; idx += kThreads) {
      const int r = idx / (kPairIn * runs), rem = idx - r * kPairIn * runs;
      const int k = rem / runs, u = 4 * (rem - k * runs), rw = row0 + r;
      const bool ok = rw < B && u < nu;
      const size_t rowoff = (size_t)t * B + rw;
      const bf16* src = k < 4    ? a.xw + rowoff * G + k * H
                        : k == 4 ? a.cseq + rowoff * H
                        : k == 5 ? a.cprev + rowoff * H
                                 : a.dhseq + rowoff * H;
      bf16* dst = pin + (r * kPairIn + k) * Uc + u;
      if (a.vec_pairs) {
        cp_async8(smem_addr(dst), ok ? src + u0 + u : a.xw, ok ? 8 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dst[e] = ok && u + e < nu ? src[u0 + u + e] : __float2bfloat16_rn(0.f);
        }
      }
    }
  };
  // phase A: the pre-activation gates of this thread's pairs, gate[q][i, g, f, o]
  auto phase_a = [&](float (&gate)[2][4]) {
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    if (owner) {
      const uint32_t ha =
          smem_addr(hin + ((mi & 1) * 8 + lr) * SH + (mi >> 1) * 8);
      const uint32_t wa = smem_addr(slice + (size_t)((mi & 1) * 8 + lr) * SW + warp * 16 +
                                    (mi >> 1) * 8);
#pragma unroll 5
      for (int kk = 0; kk < Hp / 16; ++kk) {
        uint32_t fa[4], fb[4];
        ldsm_x4(fa, ha + kk * 32);
        ldsm_x4_trans(fb, wa + kk * 16 * SW * 2);
        mma16816(acc[0], fa, fb[0], fb[1]);
        mma16816(acc[1], fa, fb[2], fb[3]);
      }
    }
    const bool ev = (t4 & 1) == 0;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      // even lanes keep row g's (i, g) and take its (f, o); odd lanes keep
      // row g+8's (f, o) and take its (i, g)
      const float s0 = ev ? acc[q][2] : acc[q][0], s1 = ev ? acc[q][3] : acc[q][1];
      const float r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
      const float r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
      gate[q][0] = ev ? acc[q][0] : r0;
      gate[q][1] = ev ? acc[q][1] : r1;
      gate[q][2] = ev ? r0 : acc[q][2];
      gate[q][3] = ev ? r1 : acc[q][3];
    }
  };

  float gate[2][4];
  if (T > 0) {
    issue_hin(step_t(0));
    load_pairs(step_t(0));
    finish_hin(step_t(0));
    __syncthreads();  // hin and the slice are staged
    phase_a(gate);
  }
  for (int s = 0; s < T; ++s) {
    const int t = step_t(s);
    // ---- phase B: the cell adjoint of this thread's pairs -> dgs ----
    if (owner) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float di = 0.f, dg = 0.f, df = 0.f, dov = 0.f;
        if (pv[q] && t < len) {
          const bf16* in = pin + rl * kPairIn * Uc + ul[q];
          const float si = lstm::sigmoid(__bfloat162float(in[0]) + gate[q][0]);
          const float tg = tanhf(__bfloat162float(in[Uc]) + gate[q][1]);
          const float sf = lstm::sigmoid(__bfloat162float(in[2 * Uc]) + gate[q][2] + 1.0f);
          const float so = lstm::sigmoid(__bfloat162float(in[3 * Uc]) + gate[q][3]);
          const float tc = tanhf(__bfloat162float(in[4 * Uc]));
          const float dht = dh[q] + __bfloat162float(in[6 * Uc]);
          dov = dht * tc * so * (1.0f - so);
          const float dct = dht * so * (1.0f - tc * tc) + dc[q];
          di = dct * tg * si * (1.0f - si);
          dg = dct * si * (1.0f - tg * tg);
          df = dct * __bfloat162float(in[5 * Uc]) * sf * (1.0f - sf);
          dc[q] = dct * sf;
        }
        __nv_bfloat162 lo = __floats2bfloat162_rn(di, dg), hi = __floats2bfloat162_rn(df, dov);
        uint2 v;
        v.x = *reinterpret_cast<uint32_t*>(&lo);
        v.y = *reinterpret_cast<uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(dgs + rl * SW + 4 * ul[q]) = v;
      }
    }
    __syncthreads();  // dgs complete; every warp is past phase A, so hin is free
    if (s + 1 < T) {
      issue_hin(step_t(s + 1));
      load_pairs(step_t(s + 1));
    }
    if (s > 0) cluster_wait();  // every CTA has read what we pushed at step s-1
    // ---- phase C, the serial product: S(dgates) @ slice^T, pushed to the
    //      owners of its columns ----
    {
      // output n8-tile pairs, two at a time a warp
      const int NPC = Hp / 16;
      const uint32_t da = smem_addr(dgs + ((mi & 1) * 8 + lr) * SW + (mi >> 1) * 8);
      for (int p0 = warp; p0 < NPC; p0 += 2 * kWarps) {
        const int pb[2] = {p0, p0 + kWarps};
        const bool two = pb[1] < NPC;
        float acc[2][2][4] = {};
        const uint32_t wa0 =
            smem_addr(slice + (size_t)(p0 * 16 + (mi >> 1) * 8 + lr) * SW + (mi & 1) * 8);
        const uint32_t wa1 = wa0 + kWarps * 16 * SW * 2;
#pragma unroll 4
        for (int kk = 0; kk < G4p / 16; ++kk) {
          uint32_t fa[4], fb[4];
          ldsm_x4(fa, da + kk * 32);
          ldsm_x4(fb, wa0 + kk * 32);
          mma16816(acc[0][0], fa, fb[0], fb[1]);
          mma16816(acc[0][1], fa, fb[2], fb[3]);
          if (two) {
            ldsm_x4(fb, wa1 + kk * 32);
            mma16816(acc[1][0], fa, fb[0], fb[1]);
            mma16816(acc[1][1], fa, fb[2], fb[3]);
          }
        }
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          if (x == 1 && !two) break;
          const int pc = pb[x];
          // a quad shuffle gives each lane 4 consecutive columns of one row
          // (even lanes row g, odd lanes row g+8): one 16-byte push each
          const bool ev = (t4 & 1) == 0;
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const float* f = acc[x][q];
            const float r0 = __shfl_xor_sync(0xffffffffu, ev ? f[2] : f[0], 1);
            const float r1 = __shfl_xor_sync(0xffffffffu, ev ? f[3] : f[1], 1);
            const float4 v = ev ? make_float4(f[0], f[1], r0, r1) : make_float4(r0, r1, f[2], f[3]);
            const int col = pc * 16 + q * 8 + 4 * (t4 >> 1);  // hidden unit, a multiple of 4
            if (col < H) {
              const int rank = col / Uc;
              float* dst = cluster.map_shared_rank(recv, rank) +
                           (c * R + g + (ev ? 0 : 8)) * Uc + (col - rank * Uc);
              *reinterpret_cast<float4*>(dst) = v;
            }
          }
        }
      }
    }
    cluster_arrive();  // our partials are pushed
    // ---- off the chain: dgates to device memory, the next step's phase A ----
    if (pairs) {  // two units a store
      for (int idx = threadIdx.x; idx < R * 2 * nu; idx += kThreads) {
        const int r = idx / (2 * nu), rem = idx - r * 2 * nu, gt = rem / (nu / 2);
        const int u = 2 * (rem - gt * (nu / 2));
        if (row0 + r < B) {
          const bf16* d = dgs + r * SW + 4 * u + gt;
          __nv_bfloat162 v;
          v.x = d[0];
          v.y = d[4];
          *reinterpret_cast<__nv_bfloat162*>(
              a.dgates + ((size_t)t * B + row0 + r) * G + gt * H + u0 + u) = v;
        }
      }
    } else {
      for (int idx = threadIdx.x; idx < R * 4 * nu; idx += kThreads) {
        const int r = idx / (4 * nu), rem = idx - r * 4 * nu, gt = rem / nu, u = rem - gt * nu;
        if (row0 + r < B) {
          a.dgates[((size_t)t * B + row0 + r) * G + gt * H + u0 + u] = dgs[r * SW + 4 * u + gt];
        }
      }
    }
    if (s + 1 < T) finish_hin(step_t(s + 1));
    __syncthreads();  // hin staged; dgs read
    if (s + 1 < T) phase_a(gate);
    cluster_wait();  // every partial of our units has landed
    // ---- dh of this thread's pairs: the cs partials summed in rank order ----
    if (owner) {
      float sum[2] = {0.f, 0.f};
      for (int r = 0; r < cs; ++r) {
        const float* rp = recv + (r * R + rl) * Uc;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          if (pv[q]) sum[q] += rp[ul[q]];
        }
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (pv[q] && t < len) dh[q] = sum[q] * msk[q];
      }
    }
    cluster_arrive_relaxed();  // our reads of recv are done (their values are in registers)
  }
  if (T > 0) cluster_wait();  // no CTA leaves while another may still push to it

#pragma unroll
  for (int q = 0; q < 2; ++q) {
    if (pv[q]) {
      const size_t o = (size_t)row * H + u0 + ul[q];
      a.dh0[o] = dh[q];
      a.dc0[o] = dc[q];
    }
  }
}

// The launch of `directions` chains (1: K1b or K1f, 2: K4b or K4f) of
// ceil(B / R) clusters of cs CTAs each: grid (cs * ceil(B / R),
// directions), the clusters along x (D: Dims, or lstm_fwd_cluster.cuh's
// FwdDims).
template <typename D>
inline cudaLaunchConfig_t cluster_config(int B, int directions, const D& d,
                                         cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(d.cs * ((B + d.R - 1) / d.R), directions);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = d.smem();
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = d.cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

inline bool plan_ok(int H, int cs) {
  return H > 0 && (cs == 1 || cs == 2 || cs == 4 || cs == 8) &&
         Dims(H, cs).G4p / 16 <= kWarps;
}

// Args from the (first direction's) pointers.  The copy flags hold for a
// second direction stacked behind the first too: its offsets are whole
// multiples of T*B*H elements, and the flags require 8 | H (4 | H).
inline Args make_args(const void* xw, const void* wh, const void* hprev, const void* cprev,
                      const void* cseq, const void* lengths, const void* mask,
                      const void* dhseq, const void* dhT, const void* dcT, void* dgates,
                      void* dh0, void* dc0, int T, int B, int H, int reverse_time, int cs) {
  return Args{(const bf16*)xw, (const bf16*)wh, (const bf16*)hprev, (const bf16*)cprev,
              (const bf16*)cseq, (const bf16*)dhseq, (const int*)lengths, (const float*)mask,
              (const float*)dhT, (const float*)dcT, (bf16*)dgates, (float*)dh0, (float*)dc0,
              T, B, H, reverse_time, cs,
              H % 8 == 0 && reinterpret_cast<uintptr_t>(hprev) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(mask) % 16 == 0,
              H % 4 == 0 && ((reinterpret_cast<uintptr_t>(xw) | reinterpret_cast<uintptr_t>(cseq) |
                              reinterpret_cast<uintptr_t>(cprev) |
                              reinterpret_cast<uintptr_t>(dhseq)) % 8) == 0};
}

// Launch `kernel` (one of the two cluster kernels) over `directions`
// chains; the CUDA error code.
template <typename Kernel>
int launch(Kernel kernel, const Args& a, int directions, cudaStream_t stream) {
  if (a.T < 0 || a.B <= 0 || !plan_ok(a.H, a.cs)) return (int)cudaErrorInvalidValue;
  const Dims d(a.H, a.cs);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)d.smem());
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(a.B, directions, d, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many clusters of cs CTAs the card keeps resident at once for
// `kernel`'s launch (more run in waves); negative on a CUDA error.
template <typename Kernel>
int max_active(Kernel kernel, int B, int directions, int H, int cs) {
  if (!plan_ok(H, cs)) return -(int)cudaErrorInvalidValue;
  const Dims d(H, cs);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)d.smem());
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(B, directions, d, 0, &attr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

}  // namespace lstm_cluster
