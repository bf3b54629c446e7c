// The bf16 body of the LSTM forward recurrence on a thread-block cluster,
// shared by K1f (lstm_recurrence.cu: one direction a launch) and K4f
// (bilstm_grid.cu: both directions of a biLSTM layer in one launch, a
// direction axis on the grid).  lstm_recurrence.cu's header describes the
// design; fwd_body is one CTA's whole launch for one direction, whose base
// pointers and reverse_time the caller puts in FwdArgs.  The PTX wrappers
// (ldmatrix, mma.sync, cluster barriers) are lstm_bwd_cluster.cuh's.

#pragma once

#include "lstm_bwd_cluster.cuh"

namespace lstm_cluster {

struct FwdArgs {
  const bf16 *xw, *wh;
  const int* lengths;
  const float *h0, *c0, *mask;  // h0 and c0 may be null: a zero state
  bf16 *h_seq, *c_seq;          // c_seq may be null: not stored
  float *hT, *cT;
  int T, B, H, reverse_time, cs;
  int vec;  // H even, xw, h_seq and c_seq 4-byte aligned: bf16x2 loads and stores
};

// MT tensor-core row tiles (16 batch rows each) a cluster; CTA c of cs
// owns Uc units (a multiple of 4, so a CTA's 4-unit pushes stay 8-byte
// aligned): the slice (Hp x SW bf16) and the double-buffered S(h * mask)
// rows of the whole cluster (2 x R x SH bf16).
struct FwdDims {
  int cs, mt, R, Hp, Uc, G4p, SW, SH;
  __host__ __device__ FwdDims(int H, int cs, int mt) {
    this->cs = cs;
    this->mt = mt;
    R = kRows * mt;
    Hp = (H + 15) & ~15;
    Uc = ((H + cs - 1) / cs + 3) & ~3;
    G4p = (4 * Uc + 15) & ~15;
    SW = G4p + 8;
    SH = Hp + 8;
  }
  __host__ __device__ size_t smem() const {
    return (size_t)Hp * SW * 2 + 2 * (size_t)R * SH * 2;
  }
};

// The slice's local column of (unit u of the CTA, gate): warp w's n8-tile
// pair holds units 4w..4w+3, tile q the units with u % 2 == q, so that the
// C fragment leaves a lane the adjacent units 4w + 2k and 4w + 2k + 1.
__host__ __device__ __forceinline__ int fwd_col(int u, int gate) {
  return 16 * (u >> 2) + 8 * (u & 1) + 4 * ((u >> 1) & 1) + gate;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16x2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// The body of one CTA of the cluster: the whole recurrence of one
// direction over its MT x 16 rows, whose base pointers and reverse_time
// `a` carries.
template <int MT>
__device__ __forceinline__ void fwd_body(const FwdArgs& a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = a.cs, c = (int)cluster.block_rank();
  const int T = a.T, B = a.B, H = a.H;
  const size_t G = 4 * (size_t)H;
  const FwdDims d(H, cs, MT);
  const int R = d.R, Hp = d.Hp, Uc = d.Uc, SW = d.SW, SH = d.SH;
  const int row0 = (blockIdx.x / cs) * R;
  const int u0 = c * Uc, nu = max(0, min(Uc, H - u0));  // this CTA's units

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* slice = reinterpret_cast<bf16*>(smem_raw);  // [Hp][SW]
  bf16* hbuf = slice + (size_t)Hp * SW;             // [2][R][SH]: S(h * mask), two steps

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3, mi = lane >> 3, lr = lane & 7, k = t4 >> 1;
  const bool owner = warp < d.G4p / 16;  // warp w owns gate n8-tile pair w

  // ---- the resident slice and zeroed h buffers (padding columns stay 0) ----
  {
    uint4* z = reinterpret_cast<uint4*>(smem_raw);
    const int n16 = (int)(d.smem() / 16);
    for (int idx = threadIdx.x; idx < n16; idx += kThreads) z[idx] = make_uint4(0, 0, 0, 0);
    __syncthreads();
    // warp w copies rows w, w + kWarps, ... of the slice; a row's lanes
    // walk its 4 * nu gate columns in order, so the loads coalesce (and no
    // lane divides: a launch copies the whole slice before its first step)
    for (int i = warp; i < H; i += kWarps) {
      const bf16* src = a.wh + (size_t)i * G + u0;
      bf16* dst = slice + (size_t)i * SW;
      for (int j = lane; j < 4 * nu; j += 32) {
        const int gate = (j >= nu) + (j >= 2 * nu) + (j >= 3 * nu), u = j - gate * nu;
        dst[fwd_col(u, gate)] = src[gate * H + u];
      }
    }
  }

  // ---- the (row, unit) pairs this thread owns: rows rl + 16 m, units
  //      ul and ul + 1; their state stays in registers ----
  const int rl = g + (t4 & 1) * 8, ul = 4 * warp + 2 * k;
  const bool unit_ok[2] = {owner && ul < nu, owner && ul + 1 < nu};
  int row[MT], len[MT];
  float h[MT][2], cc[MT][2], msk[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    row[m] = row0 + m * kRows + rl;
    const bool row_ok = row[m] < B;
    len[m] = row_ok ? a.lengths[row[m]] : 0;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const bool ok = row_ok && unit_ok[q];
      const size_t o = (size_t)row[m] * H + u0 + ul + q;
      h[m][q] = ok && a.h0 != nullptr ? a.h0[o] : 0.f;
      cc[m][q] = ok && a.c0 != nullptr ? a.c0[o] : 0.f;
      msk[m][q] = ok ? a.mask[o] : 0.f;
    }
  }

  auto step_t = [&](int s) { return a.reverse_time ? T - 1 - s : s; };
  // xw's four gates of this thread's pairs at step t, as bf16x2 (units ul, ul + 1)
  uint32_t xr[MT][4];
  auto load_x = [&](int t) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) {
        xr[m][gate] = 0u;
        if (row[m] < B && unit_ok[0]) {
          const bf16* p = a.xw + ((size_t)t * B + row[m]) * G + gate * H + u0 + ul;
          if (a.vec) {
            xr[m][gate] = *reinterpret_cast<const uint32_t*>(p);
          } else {
            __nv_bfloat162 v = __halves2bfloat162(p[0], unit_ok[1] ? p[1] : __float2bfloat16_rn(0.f));
            xr[m][gate] = *reinterpret_cast<uint32_t*>(&v);
          }
        }
      }
    }
  };
  // S(h * mask) of this thread's pairs into buffer `buf` of every CTA of
  // the cluster: lanes k = 0 and 1 of a row swap their unit pairs, so each
  // holds the warp's 4 units of the row (one 8-byte store a CTA), and
  // push to the even and the odd ranks respectively.
  auto push = [&](int buf) {
    if (!owner) return;
    const bool cols_ok = u0 + 4 * warp < H;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const uint32_t mine = pack_bf16x2(h[m][0] * msk[m][0], h[m][1] * msk[m][1]);
      const uint32_t other = __shfl_xor_sync(0xffffffffu, mine, 2);
      if (!cols_ok || row[m] >= B) continue;
      const uint2 v = k == 0 ? make_uint2(mine, other) : make_uint2(other, mine);
      const int off = (buf * R + m * kRows + rl) * SH + u0 + 4 * warp;
      for (int r = k; r < cs; r += 2) {
        bf16* dst = r == c ? hbuf : cluster.map_shared_rank(hbuf, r);
        *reinterpret_cast<uint2*>(dst + off) = v;
      }
    }
  };
  // h_seq[t] (0 past the length) and c_seq[t] of this thread's pairs
  auto store_seq = [&](int t) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (row[m] >= B || !unit_ok[0]) continue;
      const bool valid = t < len[m];
      const size_t o = ((size_t)t * B + row[m]) * H + u0 + ul;
      const float h0v = valid ? h[m][0] : 0.f, h1v = valid ? h[m][1] : 0.f;
      if (a.vec) {
        *reinterpret_cast<uint32_t*>(a.h_seq + o) = pack_bf16x2(h0v, h1v);
        if (a.c_seq != nullptr) {
          *reinterpret_cast<uint32_t*>(a.c_seq + o) = pack_bf16x2(cc[m][0], cc[m][1]);
        }
      } else {
        a.h_seq[o] = __float2bfloat16_rn(h0v);
        if (a.c_seq != nullptr) a.c_seq[o] = __float2bfloat16_rn(cc[m][0]);
        if (unit_ok[1]) {
          a.h_seq[o + 1] = __float2bfloat16_rn(h1v);
          if (a.c_seq != nullptr) a.c_seq[o + 1] = __float2bfloat16_rn(cc[m][1]);
        }
      }
    }
  };

  // The step's barrier, split so that loads and stores off the chain run
  // between its two halves; a one-CTA cluster (narrow layers) takes the
  // block barrier whole at the arrive instead.
  auto arrive = [&] {
    if (cs > 1) {
      cluster_arrive();
    } else {
      __syncthreads();
    }
  };
  auto wait = [&] {
    if (cs > 1) cluster_wait();
  };

  // every CTA's buffers are zeroed (and every CTA has started) before any push
  arrive();
  wait();
  if (T > 0) {
    push(0);
    load_x(step_t(0));
    arrive();
  }
  for (int s = 0; s < T; ++s) {
    const int t = step_t(s);
    wait();  // buffer s % 2 holds every unit of S(h * mask)
    // ---- the product S(h * mask) @ slice on the tensor cores ----
    float acc[MT][2][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][q][e] = 0.f;
    if (owner) {
      const uint32_t ha =
          smem_addr(hbuf + ((s & 1) * R + (mi & 1) * 8 + lr) * SH + (mi >> 1) * 8);
      const uint32_t wa =
          smem_addr(slice + (size_t)((mi & 1) * 8 + lr) * SW + warp * 16 + (mi >> 1) * 8);
#pragma unroll 5
      for (int kk = 0; kk < Hp / 16; ++kk) {
        uint32_t fa[4], fb[4];
        ldsm_x4_trans(fb, wa + kk * 16 * SW * 2);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          ldsm_x4(fa, ha + m * kRows * SH * 2 + kk * 32);
          mma16816(acc[m][0], fa, fb[0], fb[1]);
          mma16816(acc[m][1], fa, fb[2], fb[3]);
        }
      }
    }
    // ---- the cell: even lanes keep row g's (i, g) and take its (f, o);
    //      odd lanes keep row g+8's (f, o) and take its (i, g) ----
    const bool ev = (t4 & 1) == 0;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const bool valid = t < len[m];
      float2 xg[4];
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) xg[gate] = unpack_bf16x2(xr[m][gate]);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float* f = acc[m][q];
        const float r0 = __shfl_xor_sync(0xffffffffu, ev ? f[2] : f[0], 1);
        const float r1 = __shfl_xor_sync(0xffffffffu, ev ? f[3] : f[1], 1);
        const float gi = ev ? f[0] : r0, gg = ev ? f[1] : r1;
        const float gf = ev ? r0 : f[2], go = ev ? r1 : f[3];
        if (valid) {
          const float xi = q ? xg[0].y : xg[0].x, xgv = q ? xg[1].y : xg[1].x;
          const float xf = q ? xg[2].y : xg[2].x, xo = q ? xg[3].y : xg[3].x;
          cc[m][q] = lstm::sigmoid(xf + gf + 1.0f) * cc[m][q] +
                     lstm::sigmoid(xi + gi) * tanhf(xgv + gg);
          h[m][q] = lstm::sigmoid(xo + go) * tanhf(cc[m][q]);
        }
      }
    }
    if (s + 1 < T) {
      push((s + 1) & 1);
      arrive();  // our units of the next step's S(h * mask) are pushed
      // ---- off the chain: the next step's xw comes in while we wait ----
      load_x(step_t(s + 1));
    }
    store_seq(t);
  }

#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (row[m] < B && unit_ok[q]) {
        const size_t o = (size_t)row[m] * H + u0 + ul + q;
        a.hT[o] = h[m][q];
        a.cT[o] = cc[m][q];
      }
    }
  }
}

inline bool fwd_plan_ok(int H, int cs, int mt) {
  return H > 0 && (cs == 1 || cs == 2 || cs == 4 || cs == 8) && (mt == 1 || mt == 2) &&
         FwdDims(H, cs, mt).G4p / 16 <= kWarps;
}

// FwdArgs from the (first direction's) pointers; h0, c0 and c_seq may be
// null.  The vec flag holds for a second direction stacked behind the
// first too: its offsets are whole multiples of T*B*H elements.
inline FwdArgs make_fwd_args(const void* xw, const void* wh, const void* lengths,
                             const void* h0, const void* c0, const void* mask, void* h_seq,
                             void* c_seq, void* hT, void* cT, int T, int B, int H,
                             int reverse_time, int cs) {
  return FwdArgs{(const bf16*)xw, (const bf16*)wh, (const int*)lengths, (const float*)h0,
                 (const float*)c0, (const float*)mask, (bf16*)h_seq, (bf16*)c_seq,
                 (float*)hT, (float*)cT, T, B, H, reverse_time, cs,
                 H % 2 == 0 && ((reinterpret_cast<uintptr_t>(xw) |
                                 reinterpret_cast<uintptr_t>(h_seq) |
                                 reinterpret_cast<uintptr_t>(c_seq)) % 4) == 0};
}

// Launch `kernel` (a forward cluster kernel of mt row tiles) over
// `directions` chains; the CUDA error code.
template <typename Kernel>
int fwd_launch(Kernel kernel, const FwdArgs& a, int mt, int directions, cudaStream_t stream) {
  if (a.T < 0 || a.B <= 0 || !fwd_plan_ok(a.H, a.cs, mt)) return (int)cudaErrorInvalidValue;
  const FwdDims d(a.H, a.cs, mt);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)d.smem());
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(a.B, directions, d, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many clusters of cs CTAs the card keeps resident at once for a
// forward cluster launch of mt row tiles; negative on a CUDA error.
template <typename Kernel>
int fwd_max_active(Kernel kernel, int B, int directions, int H, int cs, int mt) {
  if (!fwd_plan_ok(H, cs, mt)) return -(int)cudaErrorInvalidValue;
  const FwdDims d(H, cs, mt);
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
