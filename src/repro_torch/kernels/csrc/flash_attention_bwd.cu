// Hopper (sm_90a) flash-attention backward: K7 of the kernel table.
//
// Replaces the Pallas TPU kernels of repro/kernels/flash_attention_bwd.py:
//   flash_attention_bwd (flash_attention_bwd.py:149), pallas_calls at :189
//   (_dkdv_kernel, :63) and :209 (_dq_kernel, :109), with the GQA group sum
//   that repro/kernels/ops.py:63-69 does after them.
//
// From the forward's row log-sum-exp (K6 with its lse output) it computes,
// for q, o, dO (B, Hq, Sq, D) and k, v (B, Hkv, Skv, D):
//   Dv  = rowsum(dO ∘ O)                                        (f32)
//   s   = q·kᵀ · scale;  s = tanh(s / c) · c when softcap c > 0
//   p   = exp(s - lse) where the pair is visible, else 0 (masked after the
//         exp, so a row that sees no key, lse = -1e30, gets no gradient)
//   dp  = dO·vᵀ;  ds = p ∘ (dp - Dv) ∘ (1 - (s/c)²) · scale
//   dq  = ds·k;   dk = Σ_group dsᵀ·q;   dv = Σ_group pᵀ·dO
// with the mask of K6 (causal, window of previous positions, k < Skv; q and
// k positions both from 0), in q's dtype.  dk and dv are per kv head: the
// kernel sums each kv head's group of q heads itself.
//
// What bounds it on an H100: 10·D flops per visible (q, k) pair (S, dP, dV,
// dK and, recomputing S and dP, dQ: 5 products of 2·D) against one read of
// q, k, v, o, dO, lse and one write of dq, dk, dv; at the model's shapes
// (D = 256, 4096 rows) that is far above the ~300 flops per byte where the
// card stops being bandwidth-bound, so the bound is the bf16 tensor-core
// rate.
//
// Two routes; the wrapper (flash_attention_bwd.py, `route`) picks one
// before launch, from the dtype, shape, strides and alignment of q, k, v, o
// and dO:
// * the wgmma route (its section below): bf16 at head dims 64, 128 and
//   256 with 16-byte aligned bases and strides that are multiples of 8
//   elements.  A row pass, then a dK/dV kernel and a dQ kernel, each with
//   TMA loads into rings, a producer warpgroup and two consumer
//   warpgroups, and wgmma for all five products.  Entry point
//   roomy_flash_attention_bwd_tma; the library links libcuda for
//   cuTensorMapEncodeTiled.
// * the classic route, everything else (float32, other head dims, odd
//   strides): the kernels that follow, simple and right first.
//
// Classic route (FlashAttention-2's two passes, no atomics):
// * A small pass writes Dv, one warp per row, into f32 scratch.
// * dk/dv: one CTA per (kv tile of 64 keys, kv head, batch).  It keeps its
//   K and V tile in shared memory and loops, in a fixed order, over the
//   group's q heads and over the q tiles of 32 rows that see the tile,
//   accumulating dK and dV in f32 registers; so the GQA sum needs no float
//   atomics and the result is the same in every run.  Each warp owns 16
//   keys.  At D = 256 a warp's f32 dK and dV (16 × 256 × 2) would need 256
//   registers a thread, so D is split over two warps of 128 columns each
//   (8 warps a CTA): each computes Sᵀ and dPᵀ over its half of D, the pair
//   adds its partial sums through shared memory, and each accumulates dK
//   and dV for its 128 columns.
// * dq: one CTA of 4 warps per (q tile of 64 rows, q head, batch), each
//   warp 16 rows, looping over the kv tiles the tile sees (64 keys, 32 at
//   D = 256), accumulating dQ in f32 registers.
// * bf16: the products are warp-level mma.sync m16n8k16 (bf16 in, f32
//   accumulate), operands from padded shared memory by ldmatrix, as in K6;
//   P and dS are rounded to bf16 only as the A operand of their products.
//   D is padded with zeros to a template bucket (16, 32, 64, 128, 256).
// * f32: plain FMA on the CUDA cores, never TF32, so the result holds the
//   reference's 3e-4.  One lane per key (dq) or per query row (dk/dv) for
//   the dot products; each lane owns D/32 columns of the accumulators.
// * Masks and edges as in K6: no padding of Sq or Skv; rows and keys are
//   bounds-checked and tiles zero-filled past the end; only tiles that hold
//   a visible pair are loaded, and a warp skips the arithmetic of a tile it
//   does not see.  Strided q/k/v/o/dO/dq/dk/dv (only D contiguous).
//
// Plain C interface, loaded with ctypes.  The three launches go on the
// given stream, do not synchronise, and the call returns cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

enum { Q = 0, K = 1, V = 2, O = 3, DO = 4, DQ = 5, DK = 6, DV = 7 };

struct Params {
  int Hq, Sq, Skv, D, group;
  long long st[8][3];   // (batch, head, seq) element strides, in enum order
  int causal, window;   // window < 0: none
  float softcap, scale; // softcap 0: none
  int vec;              // q, k, v, dO rows all 16-byte aligned, D % 8 == 0
};

// P: Params or HParams (the wgmma route's), which share these fields.
template <class P>
__device__ __forceinline__ bool visible(const P& p, int qpos, int kpos) {
  return qpos < p.Sq && kpos < p.Skv && (!p.causal || kpos <= qpos) &&
         (p.window < 0 || kpos >= qpos - p.window);
}

// The capped logit, and the cap's derivative 1 - (s/c)² (1 without a cap).
__device__ __forceinline__ float logit(const Params& p, float s,
                                       float* dcap) {
  s *= p.scale;
  *dcap = 1.f;
  if (p.softcap != 0.f) {
    s = tanhf(s / p.softcap) * p.softcap;
    const float r = s / p.softcap;
    *dcap = 1.f - r * r;
  }
  return s;
}

// ds = p (dp - Dv) · dcap · scale, in the reference's order.
__device__ __forceinline__ float dlogit(const Params& p, float pv, float dp,
                                        float dv, float dcap) {
  return pv * (dp - dv) * dcap * p.scale;
}

// Keys [*lo, *hi) that rows [qlo, qhi] can see at all.
template <class P>
__device__ __forceinline__ void kv_range(const P& p, int qlo, int qhi,
                                         int* lo, int* hi) {
  int l = 0, h = p.Skv;
  if (p.causal && qhi + 1 < h) h = qhi + 1;
  if (p.window >= 0 && qlo - p.window > 0) l = qlo - p.window;
  *lo = l;
  *hi = h;
}

// Rows [*lo, *hi) that can see any of keys [klo, khi].
template <class P>
__device__ __forceinline__ void q_range(const P& p, int klo, int khi,
                                        int* lo, int* hi) {
  int l = 0, h = p.Sq;
  if (p.causal && klo > 0) l = klo;
  if (p.window >= 0 && (long long)khi + p.window + 1 < h)
    h = khi + p.window + 1;
  *lo = l;
  *hi = h;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(0xffffffffu, x, d);
  return x;
}

// Dv[row] = Σ_d dO[row, d] · O[row, d] in f32, one warp per (b, h, s) row.
template <typename T>
__global__ void dvec_kernel(const T* __restrict__ o, const T* __restrict__ dO,
                            float* __restrict__ dvec, Params p,
                            long long rows) {
  const long long row =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const long long s = row % p.Sq, h = (row / p.Sq) % p.Hq,
                  b = row / ((long long)p.Sq * p.Hq);
  const T* orow = o + b * p.st[O][0] + h * p.st[O][1] + s * p.st[O][2];
  const T* drow = dO + b * p.st[DO][0] + h * p.st[DO][1] + s * p.st[DO][2];
  float acc = 0.f;
  for (int d = lane; d < p.D; d += 32)
    acc += to_f32(drow[d]) * to_f32(orow[d]);
  acc = warp_sum(acc);
  if (lane == 0) dvec[row] = acc;
}

// ----------------------------------------------------------------- bf16

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(ptr))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(ptr))
      : "memory");
}

// d += a · b for one m16n8k16 tile, bf16 in, f32 accumulate.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two adjacent m16n8 accumulators (16 × 16) as the A operand of a k16 step.
__device__ __forceinline__ void to_a(uint32_t (&a)[4], const float (&x)[4],
                                     const float (&y)[4]) {
  a[0] = pack_bf16(x[0], x[1]);
  a[1] = pack_bf16(x[2], x[3]);
  a[2] = pack_bf16(y[0], y[1]);
  a[3] = pack_bf16(y[2], y[3]);
}

// ROWS rows of D bf16 from src (row stride `stride` elements) into dst
// (row stride DP + 8), zero past `rows` and past D; NT threads.
template <int DP, int ROWS, int NT>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long stride, int rows, int D,
                                          int vec) {
  constexpr int LD = DP + 8, CH = DP / 8;   // 16-byte chunks per row
  for (int i = threadIdx.x; i < ROWS * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows && c < D) {
      const bf16* s = src + r * stride + c;
      if (vec) {
        val = *reinterpret_cast<const uint4*>(s);
      } else {
        const uint16_t* s16 = reinterpret_cast<const uint16_t*>(s);
        uint32_t w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t lo = (c + 2 * j < D) ? s16[2 * j] : 0u;
          const uint32_t hi = (c + 2 * j + 1 < D) ? s16[2 * j + 1] : 0u;
          w[j] = lo | (hi << 16);
        }
        val = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// acc (16 rows × DH columns from column c0, mma layout) to dst rows
// [r0, r0 + 16) as bf16, rows < nrows and columns < D only.
template <int DH>
__device__ __forceinline__ void store_rows(bf16* dst, long long stride,
                                           const float (&acc)[DH / 8][4],
                                           int r0, int nrows, int c0, int D) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= nrows) continue;
    bf16* out = dst + row * stride;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = c0 + n * 8 + 2 * t + j;
        if (c < D) out[c] = __float2bfloat16(acc[n][2 * r + j]);
      }
  }
}

constexpr int kDkdvKeys = 64;   // keys per dk/dv CTA, 16 per warp row-slab
constexpr int kDkdvRows = 32;   // q rows per step of the dk/dv loop

// dK, dV for one (64-key tile, kv head, batch).  NS warps share each
// 16-key slab, each owning DP / NS columns; 4 · NS warps.
template <int DP, int NS>
__global__ void __launch_bounds__(128 * NS)
    dkdv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dO,
                     const float* __restrict__ lse,
                     const float* __restrict__ dvec, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, Params p) {
  constexpr int BK = kDkdvKeys, BQ = kDkdvRows, LD = DP + 8, NT = 128 * NS;
  constexpr int DH = DP / NS, NB = BQ / 8, NO = DH / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);    // BK x LD
  bf16* sV = sK + BK * LD;                          // BK x LD
  bf16* sQ = sV + BK * LD;                          // BQ x LD
  bf16* sdO = sQ + BQ * LD;                         // BQ x LD
  float* sL = reinterpret_cast<float*>(sdO + BQ * LD);   // BQ
  float* sDv = sL + BQ;                                  // BQ
  float* sX = sDv + BQ;   // NS == 2: 8 warps x 2 NB 4 x 32 partial sums

  const int k0 = blockIdx.x * BK;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slab = warp & 3, half = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int kw = k0 + slab * 16;   // the warp's first key

  load_tile<DP, BK, NT>(sK, k + b * p.st[K][0] + hk * p.st[K][1] +
                        k0 * p.st[K][2], p.st[K][2], min(BK, p.Skv - k0), p.D,
                        p.vec);
  load_tile<DP, BK, NT>(sV, v + b * p.st[V][0] + hk * p.st[V][1] +
                        k0 * p.st[V][2], p.st[V][2], min(BK, p.Skv - k0), p.D,
                        p.vec);
  int lo, hi, wlo = 0, whi = 0;
  q_range(p, k0, min(k0 + BK, p.Skv) - 1, &lo, &hi);
  if (kw < p.Skv) q_range(p, kw, min(kw + 16, p.Skv) - 1, &wlo, &whi);

  float acc_k[NO][4], acc_v[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_k[n][i] = acc_v[n][i] = 0.f;

  for (int hh = 0; hh < p.group; ++hh) {
    const int h = hk * p.group + hh;
    const bf16* qg = q + b * p.st[Q][0] + h * p.st[Q][1];
    const bf16* dog = dO + b * p.st[DO][0] + h * p.st[DO][1];
    const long long rowbase = ((long long)b * p.Hq + h) * p.Sq;
    for (int q0 = (lo / BQ) * BQ; q0 < hi; q0 += BQ) {
      __syncthreads();   // every warp is done with the previous q tile
      const int rows = min(BQ, p.Sq - q0);
      load_tile<DP, BQ, NT>(sQ, qg + q0 * p.st[Q][2], p.st[Q][2], rows, p.D,
                            p.vec);
      load_tile<DP, BQ, NT>(sdO, dog + q0 * p.st[DO][2], p.st[DO][2], rows,
                            p.D, p.vec);
      for (int i = threadIdx.x; i < BQ; i += NT) {
        sL[i] = i < rows ? lse[rowbase + q0 + i] : 0.f;
        sDv[i] = i < rows ? dvec[rowbase + q0 + i] : 0.f;
      }
      __syncthreads();
      const bool active = wlo < whi && q0 < whi && q0 + BQ > wlo;

      // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ for the warp's 16 keys and BQ rows, over
      // its columns of D.
      float s[NB][4], dp[NB][4];
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.f;
      if (active) {
#pragma unroll 2
        for (int ks = half * DH / 16; ks < (half + 1) * DH / 16; ++ks) {
          uint32_t ak[4], av[4];
          const int arow = (slab * 16 + (lane & 15)) * LD + ks * 16 +
                           (lane >> 4) * 8;
          ldsm_x4(ak, sK + arow);
          ldsm_x4(av, sV + arow);
#pragma unroll
          for (int n = 0; n < NB; n += 2) {
            const int brow = (n * 8 + (lane & 7) + (lane >> 4) * 8) * LD +
                             ks * 16 + ((lane >> 3) & 1) * 8;
            uint32_t bb[4];
            ldsm_x4(bb, sQ + brow);
            mma(s[n], ak, bb[0], bb[1]);
            mma(s[n + 1], ak, bb[2], bb[3]);
            ldsm_x4(bb, sdO + brow);
            mma(dp[n], av, bb[0], bb[1]);
            mma(dp[n + 1], av, bb[2], bb[3]);
          }
        }
      }
      if (NS == 2) {   // add the partner warp's half of D (same layout)
        float* mine = sX + warp * (2 * NB * 4 * 32);
        const float* other = sX + (warp ^ 4) * (2 * NB * 4 * 32);
#pragma unroll
        for (int n = 0; n < NB; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            mine[(n * 4 + i) * 32 + lane] = s[n][i];
            mine[((NB + n) * 4 + i) * 32 + lane] = dp[n][i];
          }
        __syncthreads();
#pragma unroll
        for (int n = 0; n < NB; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            s[n][i] += other[(n * 4 + i) * 32 + lane];
            dp[n][i] += other[((NB + n) * 4 + i) * 32 + lane];
          }
      }
      if (!active) continue;

      // P and dS, elementwise; element (key kw + g (+8), row q0 + col).
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = n * 8 + 2 * t + (i & 1);
          const int key = kw + g + 8 * (i >> 1);
          float dcap;
          const float x = logit(p, s[n][i], &dcap);
          const float pv =
              visible(p, q0 + col, key) ? expf(x - sL[col]) : 0.f;
          s[n][i] = pv;
          dp[n][i] = dlogit(p, pv, dp[n][i], sDv[col], dcap);
        }

      // dV += Pᵀ·dO and dK += dSᵀ·Q over the warp's columns.
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        uint32_t ap[4], ad[4];
        to_a(ap, s[2 * kk], s[2 * kk + 1]);
        to_a(ad, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int n = 0; n < NO; n += 2) {
          const int brow = (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                           half * DH + n * 8 + (lane >> 4) * 8;
          uint32_t bb[4];
          ldsm_x4_t(bb, sdO + brow);
          mma(acc_v[n], ap, bb[0], bb[1]);
          mma(acc_v[n + 1], ap, bb[2], bb[3]);
          ldsm_x4_t(bb, sQ + brow);
          mma(acc_k[n], ad, bb[0], bb[1]);
          mma(acc_k[n + 1], ad, bb[2], bb[3]);
        }
      }
    }
  }

  if (kw >= p.Skv) return;
  store_rows<DH>(dk + b * p.st[DK][0] + hk * p.st[DK][1], p.st[DK][2], acc_k,
                 kw, p.Skv, half * DH, p.D);
  store_rows<DH>(dv + b * p.st[DV][0] + hk * p.st[DV][1], p.st[DV][2], acc_v,
                 kw, p.Skv, half * DH, p.D);
}

// dQ for one (64-row q tile, q head, batch); 4 warps of 16 rows.
template <int DP, int BK>
__global__ void __launch_bounds__(128)
    dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dO,
                   const float* __restrict__ lse,
                   const float* __restrict__ dvec, bf16* __restrict__ dq,
                   Params p) {
  constexpr int BQ = 64, LD = DP + 8, NB = BK / 8, NO = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);   // BQ x LD
  bf16* sdO = sQ + BQ * LD;                        // BQ x LD
  bf16* sK = sdO + BQ * LD;                        // BK x LD
  bf16* sV = sK + BK * LD;                         // BK x LD

  const int nq = (p.Sq + BQ - 1) / BQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * BQ;   // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / p.group;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* kg = k + b * p.st[K][0] + hk * p.st[K][1];
  const bf16* vg = v + b * p.st[V][0] + hk * p.st[V][1];
  const int rows = min(BQ, p.Sq - q0);
  load_tile<DP, BQ, 128>(sQ, q + b * p.st[Q][0] + h * p.st[Q][1] +
                         q0 * p.st[Q][2], p.st[Q][2], rows, p.D, p.vec);
  load_tile<DP, BQ, 128>(sdO, dO + b * p.st[DO][0] + h * p.st[DO][1] +
                         q0 * p.st[DO][2], p.st[DO][2], rows, p.D, p.vec);

  const int r0 = q0 + warp * 16;
  const int row[2] = {r0 + g, r0 + g + 8};
  const bool idle = r0 >= p.Sq;
  const long long rowbase = ((long long)b * p.Hq + h) * p.Sq;
  float rl[2] = {0.f, 0.f}, rd[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r)
    if (row[r] < p.Sq) {
      rl[r] = lse[rowbase + row[r]];
      rd[r] = dvec[rowbase + row[r]];
    }
  int lo, hi, wlo = 0, whi = 0;
  kv_range(p, q0, min(q0 + BQ, p.Sq) - 1, &lo, &hi);
  if (!idle) kv_range(p, r0, min(r0 + 16, p.Sq) - 1, &wlo, &whi);

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int k0 = (lo / BK) * BK; k0 < hi; k0 += BK) {
    __syncthreads();   // every warp is done with the previous tile
    const int nk = min(BK, p.Skv - k0);
    load_tile<DP, BK, 128>(sK, kg + k0 * p.st[K][2], p.st[K][2], nk, p.D,
                           p.vec);
    load_tile<DP, BK, 128>(sV, vg + k0 * p.st[V][2], p.st[V][2], nk, p.D,
                           p.vec);
    __syncthreads();
    if (idle || k0 >= whi || k0 + BK <= wlo) continue;

    // S = Q·Kᵀ and dP = dO·Vᵀ for the warp's 16 rows and the tile's keys.
    float s[NB][4], dp[NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.f;
#pragma unroll 2
    for (int ks = 0; ks < DP / 16; ++ks) {
      uint32_t aq[4], ad[4];
      const int arow = (warp * 16 + (lane & 15)) * LD + ks * 16 +
                       (lane >> 4) * 8;
      ldsm_x4(aq, sQ + arow);
      ldsm_x4(ad, sdO + arow);
#pragma unroll
      for (int n = 0; n < NB; n += 2) {
        const int brow = (n * 8 + (lane & 7) + (lane >> 4) * 8) * LD +
                         ks * 16 + ((lane >> 3) & 1) * 8;
        uint32_t bb[4];
        ldsm_x4(bb, sK + brow);
        mma(s[n], aq, bb[0], bb[1]);
        mma(s[n + 1], aq, bb[2], bb[3]);
        ldsm_x4(bb, sV + brow);
        mma(dp[n], ad, bb[0], bb[1]);
        mma(dp[n + 1], ad, bb[2], bb[3]);
      }
    }
    // dS, elementwise; element (row g (+8), key k0 + col).
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1, key = k0 + n * 8 + 2 * t + (i & 1);
        float dcap;
        const float x = logit(p, s[n][i], &dcap);
        const float pv = visible(p, row[r], key) ? expf(x - rl[r]) : 0.f;
        s[n][i] = dlogit(p, pv, dp[n][i], rd[r], dcap);
      }
    // dQ += dS·K.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t bb[4];
        ldsm_x4_t(bb, sK + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                          n * 8 + (lane >> 4) * 8);
        mma(acc[n], a, bb[0], bb[1]);
        mma(acc[n + 1], a, bb[2], bb[3]);
      }
    }
  }

  if (idle) return;
  store_rows<DP>(dq + b * p.st[DQ][0] + h * p.st[DQ][1], p.st[DQ][2], acc,
                 r0, p.Sq, 0, p.D);
}

// ------------------------------------------------------------------ f32

constexpr int kF32Threads = 128;
constexpr int kF32Cols = 8;      // accumulator columns per lane (D <= 256)
constexpr int kF32DqRows = 16;   // dq: q rows per CTA, 4 per warp
constexpr int kF32DqKeys = 32;   // dq: keys per tile, one per lane
constexpr int kF32KvKeys = 16;   // dk/dv: keys per CTA, 4 per warp
constexpr int kF32KvRows = 32;   // dk/dv: q rows per tile, one per lane

// dQ for 16 q rows of one (q head, batch).
__global__ void __launch_bounds__(kF32Threads)
    dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dO,
                  const float* __restrict__ lse,
                  const float* __restrict__ dvec, float* __restrict__ dq,
                  Params p) {
  extern __shared__ float smem_f[];
  const int D = p.D, LDK = D + 1;          // key rows padded: no bank conflict
  float* sQ = smem_f;                       // kF32DqRows x D
  float* sdO = sQ + kF32DqRows * D;         // kF32DqRows x D
  float* sK = sdO + kF32DqRows * D;         // kF32DqKeys x LDK
  float* sV = sK + kF32DqKeys * LDK;        // kF32DqKeys x LDK

  const int nq = (p.Sq + kF32DqRows - 1) / kF32DqRows;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kF32DqRows;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / p.group;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* qg = q + b * p.st[Q][0] + h * p.st[Q][1] + q0 * p.st[Q][2];
  const float* dog = dO + b * p.st[DO][0] + h * p.st[DO][1] +
                     q0 * p.st[DO][2];
  const float* kg = k + b * p.st[K][0] + hk * p.st[K][1];
  const float* vg = v + b * p.st[V][0] + hk * p.st[V][1];
  for (int i = threadIdx.x; i < kF32DqRows * D; i += kF32Threads) {
    const int r = i / D, c = i % D;
    const bool in = q0 + r < p.Sq;
    sQ[i] = in ? qg[r * p.st[Q][2] + c] : 0.f;
    sdO[i] = in ? dog[r * p.st[DO][2] + c] : 0.f;
  }
  const long long rowbase = ((long long)b * p.Hq + h) * p.Sq;
  float rl[4], rd[4], acc[4][kF32Cols];
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    const int row = q0 + warp * 4 + rr;
    rl[rr] = row < p.Sq ? lse[rowbase + row] : 0.f;
    rd[rr] = row < p.Sq ? dvec[rowbase + row] : 0.f;
#pragma unroll
    for (int j = 0; j < kF32Cols; ++j) acc[rr][j] = 0.f;
  }
  int lo, hi;
  kv_range(p, q0, min(q0 + kF32DqRows, p.Sq) - 1, &lo, &hi);

  for (int k0 = (lo / kF32DqKeys) * kF32DqKeys; k0 < hi; k0 += kF32DqKeys) {
    __syncthreads();
    for (int i = threadIdx.x; i < kF32DqKeys * D; i += kF32Threads) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < p.Skv;
      sK[r * LDK + c] = in ? kg[(k0 + r) * p.st[K][2] + c] : 0.f;
      sV[r * LDK + c] = in ? vg[(k0 + r) * p.st[V][2] + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const int lr = warp * 4 + rr, row = q0 + lr;
      if (row >= p.Sq) continue;
      if (p.causal && k0 > row) continue;
      if (p.window >= 0 && k0 + kF32DqKeys - 1 < row - p.window) continue;
      const int key = k0 + lane;
      float s = 0.f, dp = 0.f;
      for (int d = 0; d < D; ++d) {
        s = fmaf(sQ[lr * D + d], sK[lane * LDK + d], s);
        dp = fmaf(sdO[lr * D + d], sV[lane * LDK + d], dp);
      }
      float dcap;
      const float x = logit(p, s, &dcap);
      const float pv = visible(p, row, key) ? expf(x - rl[rr]) : 0.f;
      const float ds = dlogit(p, pv, dp, rd[rr], dcap);
      for (int kk = 0; kk < kF32DqKeys; ++kk) {
        const float dsk = __shfl_sync(0xffffffffu, ds, kk);
#pragma unroll
        for (int j = 0; j < kF32Cols; ++j) {
          const int d = lane + 32 * j;
          if (d < D) acc[rr][j] = fmaf(dsk, sK[kk * LDK + d], acc[rr][j]);
        }
      }
    }
  }

  float* dqg = dq + b * p.st[DQ][0] + h * p.st[DQ][1];
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    const int row = q0 + warp * 4 + rr;
    if (row >= p.Sq) continue;
#pragma unroll
    for (int j = 0; j < kF32Cols; ++j) {
      const int d = lane + 32 * j;
      if (d < D) dqg[row * p.st[DQ][2] + d] = acc[rr][j];
    }
  }
}

// dK, dV for 16 keys of one (kv head, batch), over the group's q heads.
__global__ void __launch_bounds__(kF32Threads)
    dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dO,
                    const float* __restrict__ lse,
                    const float* __restrict__ dvec, float* __restrict__ dk,
                    float* __restrict__ dv, Params p) {
  extern __shared__ float smem_f[];
  const int D = p.D, LDQ = D + 1;          // q rows padded: no bank conflict
  float* sK = smem_f;                       // kF32KvKeys x D
  float* sV = sK + kF32KvKeys * D;          // kF32KvKeys x D
  float* sQ = sV + kF32KvKeys * D;          // kF32KvRows x LDQ
  float* sdO = sQ + kF32KvRows * LDQ;       // kF32KvRows x LDQ
  float* sL = sdO + kF32KvRows * LDQ;       // kF32KvRows
  float* sDv = sL + kF32KvRows;             // kF32KvRows

  const int k0 = blockIdx.x * kF32KvKeys;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* kg = k + b * p.st[K][0] + hk * p.st[K][1] + k0 * p.st[K][2];
  const float* vg = v + b * p.st[V][0] + hk * p.st[V][1] + k0 * p.st[V][2];
  for (int i = threadIdx.x; i < kF32KvKeys * D; i += kF32Threads) {
    const int r = i / D, c = i % D;
    const bool in = k0 + r < p.Skv;
    sK[i] = in ? kg[r * p.st[K][2] + c] : 0.f;
    sV[i] = in ? vg[r * p.st[V][2] + c] : 0.f;
  }
  float acc_k[4][kF32Cols], acc_v[4][kF32Cols];
#pragma unroll
  for (int kr = 0; kr < 4; ++kr)
#pragma unroll
    for (int j = 0; j < kF32Cols; ++j) acc_k[kr][j] = acc_v[kr][j] = 0.f;
  int lo, hi;
  q_range(p, k0, min(k0 + kF32KvKeys, p.Skv) - 1, &lo, &hi);

  for (int hh = 0; hh < p.group; ++hh) {
    const int h = hk * p.group + hh;
    const float* qg = q + b * p.st[Q][0] + h * p.st[Q][1];
    const float* dog = dO + b * p.st[DO][0] + h * p.st[DO][1];
    const long long rowbase = ((long long)b * p.Hq + h) * p.Sq;
    for (int q0 = (lo / kF32KvRows) * kF32KvRows; q0 < hi;
         q0 += kF32KvRows) {
      __syncthreads();
      for (int i = threadIdx.x; i < kF32KvRows * D; i += kF32Threads) {
        const int r = i / D, c = i % D;
        const bool in = q0 + r < p.Sq;
        sQ[r * LDQ + c] = in ? qg[(q0 + r) * p.st[Q][2] + c] : 0.f;
        sdO[r * LDQ + c] = in ? dog[(q0 + r) * p.st[DO][2] + c] : 0.f;
      }
      for (int i = threadIdx.x; i < kF32KvRows; i += kF32Threads) {
        sL[i] = q0 + i < p.Sq ? lse[rowbase + q0 + i] : 0.f;
        sDv[i] = q0 + i < p.Sq ? dvec[rowbase + q0 + i] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kr = 0; kr < 4; ++kr) {
        const int lk = warp * 4 + kr, key = k0 + lk;
        if (key >= p.Skv) continue;
        if (p.causal && q0 + kF32KvRows - 1 < key) continue;
        if (p.window >= 0 && q0 > key + p.window) continue;
        const int row = q0 + lane;
        float s = 0.f, dp = 0.f;
        for (int d = 0; d < D; ++d) {
          s = fmaf(sQ[lane * LDQ + d], sK[lk * D + d], s);
          dp = fmaf(sdO[lane * LDQ + d], sV[lk * D + d], dp);
        }
        float dcap;
        const float x = logit(p, s, &dcap);
        const float pv = visible(p, row, key) ? expf(x - sL[lane]) : 0.f;
        const float ds = dlogit(p, pv, dp, sDv[lane], dcap);
        for (int qq = 0; qq < kF32KvRows; ++qq) {
          const float pq = __shfl_sync(0xffffffffu, pv, qq);
          const float dsq = __shfl_sync(0xffffffffu, ds, qq);
#pragma unroll
          for (int j = 0; j < kF32Cols; ++j) {
            const int d = lane + 32 * j;
            if (d < D) {
              acc_v[kr][j] = fmaf(pq, sdO[qq * LDQ + d], acc_v[kr][j]);
              acc_k[kr][j] = fmaf(dsq, sQ[qq * LDQ + d], acc_k[kr][j]);
            }
          }
        }
      }
    }
  }

  float* dkg = dk + b * p.st[DK][0] + hk * p.st[DK][1];
  float* dvg = dv + b * p.st[DV][0] + hk * p.st[DV][1];
#pragma unroll
  for (int kr = 0; kr < 4; ++kr) {
    const int key = k0 + warp * 4 + kr;
    if (key >= p.Skv) continue;
#pragma unroll
    for (int j = 0; j < kF32Cols; ++j) {
      const int d = lane + 32 * j;
      if (d < D) {
        dkg[key * p.st[DK][2] + d] = acc_k[kr][j];
        dvg[key * p.st[DV][2] + d] = acc_v[kr][j];
      }
    }
  }
}

// ---------------------------------------------------------------- launch

template <typename F>
cudaError_t smem_attr(F* kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int DP, int NS, int BK>
int launch_bf16(cudaStream_t s, int B, int Hkv, const void* q, const void* k,
                const void* v, const void* dO, const float* lse,
                const float* dvec, void* dq, void* dk, void* dv,
                const Params& p) {
  constexpr int LD = DP + 8;
  const bf16 *q_ = static_cast<const bf16*>(q),
             *k_ = static_cast<const bf16*>(k),
             *v_ = static_cast<const bf16*>(v),
             *do_ = static_cast<const bf16*>(dO);
  if (p.Skv > 0) {
    const size_t smem =
        (size_t)(2 * kDkdvKeys + 2 * kDkdvRows) * LD * sizeof(bf16) +
        2 * kDkdvRows * sizeof(float) +
        (NS == 2 ? 8 * 2 * (kDkdvRows / 8) * 4 * 32 * sizeof(float) : 0);
    cudaError_t e = smem_attr(dkdv_bf16_kernel<DP, NS>, smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((p.Skv + kDkdvKeys - 1) / kDkdvKeys, Hkv, B);
    dkdv_bf16_kernel<DP, NS><<<grid, 128 * NS, smem, s>>>(
        q_, k_, v_, do_, lse, dvec, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), p);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (p.Sq == 0) return 0;
  const size_t smem = (size_t)(2 * 64 + 2 * BK) * LD * sizeof(bf16);
  cudaError_t e = smem_attr(dq_bf16_kernel<DP, BK>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((p.Sq + 63) / 64, p.Hq, B);
  dq_bf16_kernel<DP, BK><<<grid, 128, smem, s>>>(
      q_, k_, v_, do_, lse, dvec, static_cast<bf16*>(dq), p);
  return (int)cudaGetLastError();
}

int launch_f32(cudaStream_t s, int B, int Hkv, const void* q, const void* k,
               const void* v, const void* dO, const float* lse,
               const float* dvec, void* dq, void* dk, void* dv,
               const Params& p) {
  const float *q_ = static_cast<const float*>(q),
              *k_ = static_cast<const float*>(k),
              *v_ = static_cast<const float*>(v),
              *do_ = static_cast<const float*>(dO);
  const int D = p.D;
  if (p.Skv > 0) {
    const size_t smem = (size_t)(2 * kF32KvKeys * D +
                                 2 * kF32KvRows * (D + 1) + 2 * kF32KvRows) *
                        sizeof(float);
    cudaError_t e = smem_attr(dkdv_f32_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((p.Skv + kF32KvKeys - 1) / kF32KvKeys, Hkv, B);
    dkdv_f32_kernel<<<grid, kF32Threads, smem, s>>>(
        q_, k_, v_, do_, lse, dvec, static_cast<float*>(dk),
        static_cast<float*>(dv), p);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (p.Sq == 0) return 0;
  const size_t smem =
      (size_t)(2 * kF32DqRows * D + 2 * kF32DqKeys * (D + 1)) * sizeof(float);
  cudaError_t e = smem_attr(dq_f32_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((p.Sq + kF32DqRows - 1) / kF32DqRows, p.Hq, B);
  dq_f32_kernel<<<grid, kF32Threads, smem, s>>>(
      q_, k_, v_, do_, lse, dvec, static_cast<float*>(dq), p);
  return (int)cudaGetLastError();
}

// ------------------------------------------- bf16 on Hopper: TMA + wgmma
//
// The route for bf16 at head dims 64, 128 and 256 (the wrapper's `route`).
// Three launches:
// * bwd_rows_kernel, one warp per row: lse2 = lse·log2(e) and Dv =
//   rowsum(dO ∘ O) in f32, each (B, Hq, Sqp) with Sqp = Sq rounded up to
//   kRowPad and zeros past Sq, so that a tile's rows are one aligned bulk
//   copy.  A separate pass, not folded into the dQ kernel, so that the
//   dK/dV kernel does not wait on dQ's.
// * dkdv_hopper_kernel: one CTA of three warpgroups per (64 keys, kv head,
//   batch row), the lowest keys (the most rows under the causal mask)
//   launched first.  Warpgroup 0 is the producer (setmaxnreg 24): one of
//   its threads TMA-loads K and V once, then streams the Q and dO tiles
//   (BQ rows, 4-D maps as K6's) with their lse2 and Dv rows (bulk copies)
//   into a ring of STAGES slots behind full/empty mbarriers, over every q
//   head of the group and every q tile that sees the keys, in a fixed
//   order.  The two consumer warpgroups (setmaxnreg 240) share the 64
//   keys and split the work by gradient: warpgroup 1 holds dV, warpgroup 2
//   dK, each 64 × D in f32 (128 registers a thread at D = 256).  Per tile:
//     wg 1: Sᵀ = K·Qᵀ (SS), P = exp2(Sᵀ·scale·log2 e − lse2) masked, X =
//           P ∘ (1 − (s/c)²) · scale to shared memory, then dV += Pᵀ·dO
//           (RS: P rounded to bf16 pairs in place, dO MN-major);
//     wg 2: dPᵀ = V·dOᵀ (SS), then dSᵀ = X ∘ (dPᵀ − Dv) and dK += dSᵀ·Q
//           (RS).
//   X passes on two named barriers (ready, free).  Both warpgroups run the
//   same products with operands picked by warpgroup, so no wgmma sits on a
//   divergent path, and each does two of the four products: the work is
//   even, and the softmax of one overlaps the other's products.  The GQA
//   sum stays in the CTA's registers, in a fixed order, so every run gives
//   the same bits.
// * dq_hopper_kernel: one CTA per (128 q rows, q head, batch row), the
//   heaviest q tiles first.  The producer TMA-loads Q and dO once, then K
//   and V tiles into two rings (KST and VST slots: V is free after dP, K
//   only after dQ).  Each consumer warpgroup owns 64 rows: S = Q·Kᵀ and dP
//   = dO·Vᵀ (SS), p = exp2(S·scale·log2 e − lse2), dS = p ∘ (dP − Dv) ∘ (1
//   − (s/c)²) · scale in registers, dQ += dS·K (RS, K MN-major through the
//   transpose bit, as K6 reads V).  At D = 256 a consumer thread holds dQ
//   (128 f32), S (32) and dP (32).
// Masks run only on tiles that cut the diagonal, the window's edge, Sq or
// Skv; the softcap's tanh is 1 − 2/(1 + 2^(2x·log2 e)) from ex2.approx and
// rcp.approx, as in K6.  The elementwise loops are written once with the
// softcap and once without, and a tile's lse2 and Dv come into registers
// before them (a branch and a shared-memory load per element made K7 at
// the train shape 1.46x slower: PERF.md, PR 19).  Shared memory (from a
// 1024-byte aligned base):
//   dK/dV, D = 256: BQ 64, 2 stages: 64 KB K, V + 2 × 64 KB + 16 KB X
//          D = 128: BQ 128, 2 stages: 32 KB + 2 × 64 KB + 32 KB X
//          D = 64:  BQ 128, 3 stages: 16 KB + 3 × 32 KB + 32 KB X
//   dQ,    D = 256: BK 64, K ring 2, V ring 1: 128 KB Q, dO + 3 × 32 KB
//          D = 128: BK 128, 2 + 2: 64 KB + 4 × 32 KB
//          D = 64:  BK 128, 2 + 2: 32 KB + 4 × 16 KB

constexpr int kWsThreads = 384;  // producer warpgroup + 2 consumer ones
constexpr int kBKV = 64;         // keys a dK/dV CTA
constexpr int kBQ = 128;         // q rows a dQ CTA: 64 a consumer warpgroup
constexpr int kRowPad = 128;     // Sqp: Sq rounded up to this
constexpr int kXReady = 1, kXFree = 2;   // named barriers of the X exchange

struct HParams {
  int Hq, Sq, Skv, group, Sqp;
  long long st[5][3];   // (batch, head, seq) element strides: O, DO, and
                        // the outputs dq, dk, dv
  int causal, window;   // window < 0: none
  float softcap;        // 0: none
  float scale;
  float qk_log2;        // scale·log2(e): a dot product to a log2 logit
  float cap_in;         // 2·scale·log2(e)/softcap: the exponent of e^(2x)
  float cap_out;        // softcap·log2(e)
};
enum { HO = 0, HDO = 1, HDQ = 2, HDK = 3, HDV = 4 };

// The capped logit in log2 units, c·log2(e)·tanh(s/c), from a raw dot
// product x (tanh = 1 - 2/(1 + e^(2x·scale/c)), as K6), and its tanh.
__device__ __forceinline__ float capped(const HParams& p, float x,
                                        float* th) {
  *th = 1.f - 2.f * rcp(1.f + ex2(x * p.cap_in));
  return *th * p.cap_out;
}

// lse2 and Dv of one padded row (b, h, s < Sqp) per warp; 16-byte loads
// (the route's rows are 16-byte aligned and D % 8 == 0).
__global__ void bwd_rows_kernel(const bf16* __restrict__ o,
                                const bf16* __restrict__ dO,
                                const float* __restrict__ lse,
                                float* __restrict__ lse2,
                                float* __restrict__ dvec, HParams p, int D,
                                long long rows) {
  const long long row =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const long long s = row % p.Sqp, bh = row / p.Sqp;
  const long long h = bh % p.Hq, b = bh / p.Hq;
  float acc = 0.f, l2 = 0.f;
  if (s < p.Sq) {
    const bf16* orow = o + b * p.st[HO][0] + h * p.st[HO][1] +
                       s * p.st[HO][2];
    const bf16* drow = dO + b * p.st[HDO][0] + h * p.st[HDO][1] +
                       s * p.st[HDO][2];
    for (int d = lane * 8; d < D; d += 256) {
      const uint4 a = *reinterpret_cast<const uint4*>(orow + d);
      const uint4 c = *reinterpret_cast<const uint4*>(drow + d);
      const uint32_t aw[4] = {a.x, a.y, a.z, a.w};
      const uint32_t cw[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 x = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&aw[j]));
        const float2 y = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&cw[j]));
        acc += x.x * y.x + x.y * y.y;
      }
    }
    acc = warp_sum(acc);
    l2 = lse[bh * p.Sq + s] * kLog2e;
  }
  if (lane == 0) {
    lse2[row] = l2;
    dvec[row] = acc;
  }
}

template <int D> struct KvTile;   // q rows a tile, ring stages
template <> struct KvTile<64> { static constexpr int BQ = 128, STAGES = 3; };
template <> struct KvTile<128> { static constexpr int BQ = 128, STAGES = 2; };
template <> struct KvTile<256> { static constexpr int BQ = 64, STAGES = 2; };

// Byte offsets of the dK/dV kernel's shared memory.
template <int D> struct KvLayout {
  static constexpr int BQ = KvTile<D>::BQ, STAGES = KvTile<D>::STAGES;
  static constexpr int KV = kBKV * D * 2;   // K or V
  static constexpr int T = BQ * D * 2;      // a Q or dO tile
  static constexpr int STAGE0 = 2 * KV;     // slot s: Q, then dO
  static constexpr int ROWS = STAGE0 + 2 * STAGES * T;  // slot s: lse2, Dv
  static constexpr int X = ROWS + 2 * STAGES * BQ * 4;  // 64 × BQ f32
  static constexpr int BAR = X + kBKV * BQ * 4;
  static constexpr int NBAR = 1 + 2 * STAGES;   // kv_full; full, empty
  static constexpr int BYTES = BAR + 8 * NBAR + 1024;   // + alignment
};

template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
    dkdv_hopper_kernel(const __grid_constant__ CUtensorMap mq,
                       const __grid_constant__ CUtensorMap mdo,
                       const __grid_constant__ CUtensorMap mk,
                       const __grid_constant__ CUtensorMap mv,
                       const float* __restrict__ lse2,
                       const float* __restrict__ dvec, bf16* __restrict__ dk,
                       bf16* __restrict__ dv, HParams p) {
  using L = KvLayout<D>;
  constexpr int BQ = L::BQ, STAGES = L::STAGES, NC = D / 64;
  extern __shared__ __align__(16) unsigned char smem_ws[];
  const uint32_t raw = smem_addr(smem_ws);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_ws + (base - raw);   // the same, generic
  const uint32_t sk = base, sv = base + L::KV, bar = base + L::BAR;
  // slot s: Q at sq(s), dO at sq(s) + T, each NC boxes of (BQ x 128 bytes)
  auto sq = [&](int s) { return base + L::STAGE0 + 2 * s * L::T; };
  auto kv_full = [&]() { return bar; };
  auto full = [&](int s) { return bar + 8 * (1 + s); };
  auto empty = [&](int s) { return bar + 8 * (1 + STAGES + s); };

  const int hkv = p.Hq / p.group;
  const int hk = (int)(blockIdx.x % hkv), b = blockIdx.y;
  const int k0 = (int)(blockIdx.x / hkv) * kBKV;   // lowest keys first
  const int h0 = hk * p.group;                        // the group's first
  int lo, hi;
  q_range(p, k0, min(k0 + kBKV, p.Skv) - 1, &lo, &hi);
  const int t_lo = lo / BQ, nt = hi > lo ? (hi + BQ - 1) / BQ - t_lo : 0;
  const int tiles = p.group * nt;                     // head, q tile

  if (threadIdx.x == 0) {
    mbar_init(kv_full(), 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2);   // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full(), 2 * L::KV);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        tma_load(sk + c * kBKV * 128, &mk, kv_full(), 64 * c, k0, hk, b);
        tma_load(sv + c * kBKV * 128, &mv, kv_full(), 64 * c, k0, hk, b);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int n = 0; n < tiles; ++n) {
        const int h = h0 + n / nt, q0 = (t_lo + n % nt) * BQ;
        mbar_wait(empty(stage), phase ^ 1);   // the first round passes
        mbar_expect_tx(full(stage), 2 * L::T + 2 * BQ * 4);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          tma_load(sq(stage) + c * BQ * 128, &mq, full(stage), 64 * c, q0,
                   h, b);
          tma_load(sq(stage) + L::T + c * BQ * 128, &mdo, full(stage),
                   64 * c, q0, h, b);
        }
        const long long r = ((long long)b * p.Hq + h) * p.Sqp + q0;
        const uint32_t rows = base + L::ROWS + 2 * stage * BQ * 4;
        bulk_load(rows, lse2 + r, BQ * 4, full(stage));
        bulk_load(rows + BQ * 4, dvec + r, BQ * 4, full(stage));
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = threadIdx.x / 128 - 1, tid = threadIdx.x % 128;  // 0: dV
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int key0 = k0 + 16 * warp + g;   // this thread's keys: +0, +8
    float* X = reinterpret_cast<float*>(gbase + L::X);
    const uint32_t a_op = cw ? sv : sk;    // Sᵀ = K·Qᵀ or dPᵀ = V·dOᵀ

    float acc[D / 2];   // dV (cw 0) or dK (cw 1), keys x D
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    mbar_wait(kv_full(), 0);
    if (cw == 1 && tiles > 0) named_arrive(kXFree, 256);   // X starts free
    int stage = 0;
    uint32_t phase = 0;
    for (int n = 0; n < tiles; ++n) {
      const int q0 = (t_lo + n % nt) * BQ;
      const uint32_t tq = sq(stage), tdo = tq + L::T;
      const float* rl = reinterpret_cast<const float*>(
          gbase + L::ROWS + 2 * stage * BQ * 4);   // lse2, then Dv
      mbar_wait(full(stage), phase);

      // Sᵀ or dPᵀ: 64 keys x BQ rows, D/16 steps of k16.
      float s[BQ / 2];
      const uint32_t b_op = cw ? tdo : tq;
      wg_fence();
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss(s, sw128_desc(a_op + c * kBKV * 128 + kk * 32, 16, 1024),
                   sw128_desc(b_op + c * BQ * 128 + kk * 32, 16, 1024),
                   (c | kk) != 0);
      wg_commit();
      wg_wait0();
      fence_regs(s);

      // element i: key key0 + 8·((i >> 1) & 1), row q0 + col(i)
      const bool interior = k0 + kBKV <= p.Skv && q0 + BQ <= p.Sq &&
                            (!p.causal || q0 >= k0 + kBKV - 1) &&
                            (p.window < 0 || q0 + BQ - 1 - k0 <= p.window);
      if (cw == 0) {
        float2 l2[BQ / 8];   // lse2 of this thread's columns, in registers
#pragma unroll
        for (int c = 0; c < BQ / 8; ++c)
          l2[c] = *reinterpret_cast<const float2*>(rl + 8 * c + 2 * t);
        named_sync(kXFree, 256);   // wg 2 has read the last tile's X
        if (p.softcap != 0.f) {
#pragma unroll
          for (int i = 0; i < BQ / 2; ++i) {
            float th;
            const float x = capped(p, s[i], &th);
            float pv = ex2(x - ((i & 1) ? l2[i >> 2].y : l2[i >> 2].x));
            if (!interior && !visible(p, q0 + 8 * (i >> 2) + 2 * t + (i & 1),
                                      key0 + 8 * ((i >> 1) & 1)))
              pv = 0.f;
            s[i] = pv;
            X[i * 128 + tid] = pv * (1.f - th * th) * p.scale;
          }
        } else {
#pragma unroll
          for (int i = 0; i < BQ / 2; ++i) {
            float pv = ex2(s[i] * p.qk_log2 -
                           ((i & 1) ? l2[i >> 2].y : l2[i >> 2].x));
            if (!interior && !visible(p, q0 + 8 * (i >> 2) + 2 * t + (i & 1),
                                      key0 + 8 * ((i >> 1) & 1)))
              pv = 0.f;
            s[i] = pv;
            X[i * 128 + tid] = pv * p.scale;
          }
        }
        named_arrive(kXReady, 256);
      } else {
        float2 dd[BQ / 8];   // Dv of this thread's columns
#pragma unroll
        for (int c = 0; c < BQ / 8; ++c)
          dd[c] = *reinterpret_cast<const float2*>(rl + BQ + 8 * c + 2 * t);
        named_sync(kXReady, 256);
#pragma unroll
        for (int i = 0; i < BQ / 2; ++i)
          s[i] = X[i * 128 + tid] *
                 (s[i] - ((i & 1) ? dd[i >> 2].y : dd[i >> 2].x));
        if (n + 1 < tiles) named_arrive(kXFree, 256);
      }

      // dV += Pᵀ·dO or dK += dSᵀ·Q: BQ/16 steps of k16 over the whole D.
      uint32_t pa[BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          pa[kk][x] = pack_bf16(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);
      const uint32_t b2 = cw ? tq : tdo;
      fence_regs(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs(acc, pa[kk],
                 sw128_desc(b2 + kk * 16 * 128, BQ * 128, 1024));
      wg_commit();
      wg_wait0();
      fence_regs(acc);
      if (tid == 0) mbar_arrive(empty(stage));
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }

    const int o = cw ? HDK : HDV;
    bf16* og = (cw ? dk : dv) + b * p.st[o][0] + hk * p.st[o][1];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 8 * r;
      if (key >= p.Skv) continue;
      bf16* orow = og + key * p.st[o][2];
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n + 2 * t) =
            __floats2bfloat162_rn(acc[4 * n + 2 * r], acc[4 * n + 2 * r + 1]);
    }
  }
}

template <int D> struct DqTile;   // kv rows a tile, K ring, V ring
template <> struct DqTile<64> {
  static constexpr int BK = 128, KST = 2, VST = 2;
};
template <> struct DqTile<128> {
  static constexpr int BK = 128, KST = 2, VST = 2;
};
template <> struct DqTile<256> {
  static constexpr int BK = 64, KST = 2, VST = 1;
};

// Byte offsets of the dQ kernel's shared memory.
template <int D> struct DqLayout {
  static constexpr int BK = DqTile<D>::BK, KST = DqTile<D>::KST,
                       VST = DqTile<D>::VST;
  static constexpr int Q = kBQ * D * 2, KV = BK * D * 2;  // a tile's bytes
  static constexpr int KS = 2 * Q;               // Q, dO, then the K ring
  static constexpr int VS = KS + KST * KV;       // the V ring
  static constexpr int BAR = VS + VST * KV;
  static constexpr int NBAR = 1 + 2 * KST + 2 * VST;
  static constexpr int BYTES = BAR + 8 * NBAR + 1024;   // + alignment
};

template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
    dq_hopper_kernel(const __grid_constant__ CUtensorMap mq,
                     const __grid_constant__ CUtensorMap mdo,
                     const __grid_constant__ CUtensorMap mk,
                     const __grid_constant__ CUtensorMap mv,
                     const float* __restrict__ lse2,
                     const float* __restrict__ dvec, bf16* __restrict__ dq,
                     HParams p) {
  using L = DqLayout<D>;
  constexpr int BK = L::BK, KST = L::KST, VST = L::VST, NC = D / 64;
  extern __shared__ __align__(16) unsigned char smem_ws[];
  const uint32_t base = (smem_addr(smem_ws) + 1023u) & ~1023u;
  const uint32_t sq = base, sdo = base + L::Q, bar = base + L::BAR;
  auto sk = [&](int s) { return base + L::KS + s * L::KV; };
  auto sv = [&](int s) { return base + L::VS + s * L::KV; };
  auto q_full = [&]() { return bar; };
  auto k_full = [&](int s) { return bar + 8 * (1 + s); };
  auto k_empty = [&](int s) { return bar + 8 * (1 + KST + s); };
  auto v_full = [&](int s) { return bar + 8 * (1 + 2 * KST + s); };
  auto v_empty = [&](int s) { return bar + 8 * (1 + 2 * KST + VST + s); };

  const int nq = (p.Sq + kBQ - 1) / kBQ;
  const int h = (int)(blockIdx.x % p.Hq), b = blockIdx.y, hk = h / p.group;
  const int q0 = (nq - 1 - (int)(blockIdx.x / p.Hq)) * kBQ;  // heaviest first
  int lo, hi;
  kv_range(p, q0, min(q0 + kBQ, p.Sq) - 1, &lo, &hi);
  const int t_lo = lo / BK, t_hi = hi > lo ? (hi + BK - 1) / BK : t_lo;

  if (threadIdx.x == 0) {
    mbar_init(q_full(), 1);
    for (int s = 0; s < KST; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(k_empty(s), 2);   // one arrival per consumer warpgroup
    }
    for (int s = 0; s < VST; ++s) {
      mbar_init(v_full(s), 1);
      mbar_init(v_empty(s), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full(), 2 * L::Q);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        tma_load(sq + c * kBQ * 128, &mq, q_full(), 64 * c, q0, h, b);
        tma_load(sdo + c * kBQ * 128, &mdo, q_full(), 64 * c, q0, h, b);
      }
      int ks = 0, vs = 0;
      uint32_t kph = 0, vph = 0;
      for (int j = t_lo; j < t_hi; ++j) {
        mbar_wait(k_empty(ks), kph ^ 1);   // the first round passes
        mbar_expect_tx(k_full(ks), L::KV);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          tma_load(sk(ks) + c * BK * 128, &mk, k_full(ks), 64 * c, j * BK,
                   hk, b);
        mbar_wait(v_empty(vs), vph ^ 1);
        mbar_expect_tx(v_full(vs), L::KV);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          tma_load(sv(vs) + c * BK * 128, &mv, v_full(vs), 64 * c, j * BK,
                   hk, b);
        if (++ks == KST) {
          ks = 0;
          kph ^= 1;
        }
        if (++vs == VST) {
          vs = 0;
          vph ^= 1;
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = threadIdx.x / 128 - 1, tid = threadIdx.x % 128;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int ra = q0 + 64 * cw;                 // the warpgroup's rows
    const int row0 = ra + 16 * warp + g;         // this thread's: +0, +8
    const bool active = ra < p.Sq;
    int wlo = 0, whi = 0;
    if (active) kv_range(p, ra, min(ra + 63, p.Sq - 1), &wlo, &whi);
    const uint32_t qa = sq + cw * 64 * 128, da = sdo + cw * 64 * 128;
    const long long rb = ((long long)b * p.Hq + h) * p.Sqp;
    // rows past Sq (< Sqp) read the padding's zeros
    const float l2[2] = {lse2[rb + row0], lse2[rb + row0 + 8]};
    const float dd[2] = {dvec[rb + row0], dvec[rb + row0 + 8]};

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    mbar_wait(q_full(), 0);
    int ks = 0, vs = 0;
    uint32_t kph = 0, vph = 0;
    for (int j = t_lo; j < t_hi; ++j) {
      const int k0 = j * BK;
      mbar_wait(k_full(ks), kph);
      mbar_wait(v_full(vs), vph);
      if (active && k0 < whi && k0 + BK > wlo) {
        // S = Q·Kᵀ and dP = dO·Vᵀ: 64 rows x BK keys, D/16 steps of k16.
        float s[BK / 2], dp[BK / 2];
        wg_fence();
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss(s, sw128_desc(qa + c * kBQ * 128 + kk * 32, 16, 1024),
                     sw128_desc(sk(ks) + c * BK * 128 + kk * 32, 16, 1024),
                     (c | kk) != 0);
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss(dp, sw128_desc(da + c * kBQ * 128 + kk * 32, 16, 1024),
                     sw128_desc(sv(vs) + c * BK * 128 + kk * 32, 16, 1024),
                     (c | kk) != 0);
        wg_commit();
        wg_wait0();
        fence_regs(s);
        fence_regs(dp);
        if (tid == 0) mbar_arrive(v_empty(vs));   // V's last read

        // dS in place of S; the mask only where the tile needs it.
        const bool interior = k0 + BK <= p.Skv &&
                              (!p.causal || k0 + BK - 1 <= ra) &&
                              (p.window < 0 || k0 >= ra + 63 - p.window);
        if (p.softcap != 0.f) {
#pragma unroll
          for (int i = 0; i < BK / 2; ++i) {
            const int r = (i >> 1) & 1;
            float th;
            float pv = ex2(capped(p, s[i], &th) - l2[r]);
            if (!interior && !visible(p, row0 + 8 * r,
                                      k0 + 8 * (i >> 2) + 2 * t + (i & 1)))
              pv = 0.f;
            s[i] = pv * (dp[i] - dd[r]) * (1.f - th * th) * p.scale;
          }
        } else {
#pragma unroll
          for (int i = 0; i < BK / 2; ++i) {
            const int r = (i >> 1) & 1;
            float pv = ex2(s[i] * p.qk_log2 - l2[r]);
            if (!interior && !visible(p, row0 + 8 * r,
                                      k0 + 8 * (i >> 2) + 2 * t + (i & 1)))
              pv = 0.f;
            s[i] = pv * (dp[i] - dd[r]) * p.scale;
          }
        }
        uint32_t pa[BK / 16][4];
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
          for (int x = 0; x < 4; ++x)
            pa[kk][x] = pack_bf16(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);

        // dQ += dS·K: BK/16 steps of k16 over the whole head dim.
        fence_regs(acc);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_rs(acc, pa[kk],
                   sw128_desc(sk(ks) + kk * 16 * 128, BK * 128, 1024));
        wg_commit();
        wg_wait0();
        fence_regs(acc);
      } else if (tid == 0) {
        mbar_arrive(v_empty(vs));   // free only once both loads landed
      }
      if (tid == 0) mbar_arrive(k_empty(ks));
      if (++ks == KST) {
        ks = 0;
        kph ^= 1;
      }
      if (++vs == VST) {
        vs = 0;
        vph ^= 1;
      }
    }

    bf16* og = dq + b * p.st[HDQ][0] + h * p.st[HDQ][1];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (!active || row >= p.Sq) continue;
      bf16* orow = og + row * p.st[HDQ][2];
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n + 2 * t) =
            __floats2bfloat162_rn(acc[4 * n + 2 * r], acc[4 * n + 2 * r + 1]);
    }
  }
}

// The three launches of the wgmma route at head dim D.  maps: 8 x 11
// values, tma_geometry's of q, dO, k, v for the dQ kernel (boxes of kBQ, BK,
// BK rows), then of q, dO, k, v for the dK/dV kernel (BQ, BQ, kBKV, kBKV).
template <int D>
int launch_hopper(cudaStream_t stream, int B, const void* o, const void* dO,
                  const float* lse, float* lse2, float* dvec, void* dq,
                  void* dk, void* dv, const void* const* ptrs,
                  const long long* maps, const HParams& p) {
  using LQ = DqLayout<D>;
  using LK = KvLayout<D>;
  const int rows[8] = {kBQ, kBQ, LQ::BK, LQ::BK, LK::BQ, LK::BQ, kBKV, kBKV};
  CUtensorMap tm[8];
  for (int i = 0; i < 8; ++i) {
    const long long* g = maps + 11 * i;
    // the wrapper's geometry must be this instantiation's tiles
    if (g[0] != D || g[7] != 64 || g[8] != rows[i] || g[9] != 1 ||
        g[10] != 1)
      return (int)cudaErrorInvalidValue;
    const int e = encode_map(&tm[i], ptrs[i % 4], g);
    if (e) return e;
  }
  const long long nrows = (long long)B * p.Hq * p.Sqp;
  bwd_rows_kernel<<<(unsigned)((nrows * 32 + 255) / 256), 256, 0,
                    stream>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dO), lse, lse2,
      dvec, p, D, nrows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(dkdv_hopper_kernel<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           LK::BYTES);
  if (e != cudaSuccess) return (int)e;
  const long long nk = (p.Skv + kBKV - 1) / kBKV;
  dkdv_hopper_kernel<D><<<dim3((unsigned)(nk * (p.Hq / p.group)), B),
                          kWsThreads, LK::BYTES, stream>>>(
      tm[4], tm[5], tm[6], tm[7], lse2, dvec, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(dq_hopper_kernel<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           LQ::BYTES);
  if (e != cudaSuccess) return (int)e;
  const long long nq = (p.Sq + kBQ - 1) / kBQ;
  dq_hopper_kernel<D><<<dim3((unsigned)(nq * p.Hq), B), kWsThreads,
                        LQ::BYTES, stream>>>(
      tm[0], tm[1], tm[2], tm[3], lse2, dvec, static_cast<bf16*>(dq), p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* roomy_fab_error_string(int code) {
  if (code >= kDriverError) {
    const char* s = nullptr;
    cuGetErrorString((CUresult)(code - kDriverError), &s);
    return s != nullptr ? s : "unknown driver error";
  }
  return cudaGetErrorString((cudaError_t)code);
}

// dtype 0: float32, 1: bfloat16.  strides: 24 element strides, (batch,
// head, seq) of q, k, v, o, dO, dq, dk, dv in that order; the last dim of
// each is contiguous.  lse: B·Hq·Sq contiguous floats; dvec: B·Hq·Sq
// floats of scratch.  dq is (B, Hq, Sq, D), dk and dv (B, Hkv, Skv, D).
int roomy_flash_attention_bwd(const void* q, const void* k, const void* v,
                              const void* o, const void* dO, const float* lse,
                              float* dvec, void* dq, void* dk, void* dv,
                              int dtype, int B, int Hq, int Hkv, int Sq,
                              int Skv, int D, const long long* strides,
                              int causal, int window, float softcap,
                              float scale, void* stream) {
  if (D < 1 || D > 256 || Hkv < 1 || Hq % Hkv != 0 || B < 0 || Sq < 0 ||
      Skv < 0 || B > 65535 || Hq > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Hq == 0 || (Sq == 0 && Skv == 0)) return 0;
  Params p;
  p.Hq = Hq; p.Sq = Sq; p.Skv = Skv; p.D = D; p.group = Hq / Hkv;
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 3; ++j) p.st[i][j] = strides[3 * i + j];
  p.causal = causal; p.window = window; p.softcap = softcap; p.scale = scale;
  int vec = D % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
            aligned16(dO);
  for (int i = 0; i < 3 * DQ; ++i)   // the tiles loaded: q, k, v, dO
    if (i / 3 != O) vec = vec && strides[i] % 8 == 0;
  p.vec = vec;
  cudaStream_t s = (cudaStream_t)stream;
  const long long rows = (long long)B * Hq * Sq;
  if (rows > 0) {
    const unsigned blocks = (unsigned)((rows * 32 + 127) / 128);
    if (dtype == 0)
      dvec_kernel<float><<<blocks, 128, 0, s>>>(
          static_cast<const float*>(o), static_cast<const float*>(dO), dvec,
          p, rows);
    else
      dvec_kernel<bf16><<<blocks, 128, 0, s>>>(
          static_cast<const bf16*>(o), static_cast<const bf16*>(dO), dvec, p,
          rows);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (dtype == 0)
    return launch_f32(s, B, Hkv, q, k, v, dO, lse, dvec, dq, dk, dv, p);
  if (D <= 16)
    return launch_bf16<16, 1, 64>(s, B, Hkv, q, k, v, dO, lse, dvec, dq, dk,
                                  dv, p);
  if (D <= 32)
    return launch_bf16<32, 1, 64>(s, B, Hkv, q, k, v, dO, lse, dvec, dq, dk,
                                  dv, p);
  if (D <= 64)
    return launch_bf16<64, 1, 64>(s, B, Hkv, q, k, v, dO, lse, dvec, dq, dk,
                                  dv, p);
  if (D <= 128)
    return launch_bf16<128, 1, 64>(s, B, Hkv, q, k, v, dO, lse, dvec, dq, dk,
                                   dv, p);
  return launch_bf16<256, 2, 32>(s, B, Hkv, q, k, v, dO, lse, dvec, dq, dk,
                                 dv, p);
}

// Dynamic shared memory of the wgmma route's dK/dV and dQ kernels at head
// dim D (which = 0, 1), -1 for a head dim it does not take.
int roomy_flash_attention_bwd_tma_smem(int D, int which) {
  if (D == 64) return which ? DqLayout<64>::BYTES : KvLayout<64>::BYTES;
  if (D == 128) return which ? DqLayout<128>::BYTES : KvLayout<128>::BYTES;
  if (D == 256) return which ? DqLayout<256>::BYTES : KvLayout<256>::BYTES;
  return -1;
}

// The wgmma route: bf16, D in {64, 128, 256}, q, k, v, o, dO 16-byte
// aligned and every stride a multiple of 8 elements (the wrapper's
// `route`).  strides: 15 element strides, (batch, head, seq) of o, dO, dq,
// dk and dv in that order.  maps: 8 x 11 values, the 4-D tensor-map
// geometry (dims D, S, H, B; byte strides of S, H, B; box 64 x rows x 1 x
// 1) of q, dO, k, v with the dQ kernel's rows, then of q, dO, k, v with
// the dK/dV kernel's.  lse: B·Hq·Sq contiguous floats; rows: 2·B·Hq·Sqp
// floats of scratch, Sqp = Sq rounded up to a multiple of 128.
int roomy_flash_attention_bwd_tma(const void* q, const void* k, const void* v,
                                  const void* o, const void* dO,
                                  const float* lse, float* rows, void* dq,
                                  void* dk, void* dv, int B, int Hq, int Hkv,
                                  int Sq, int Skv, int D,
                                  const long long* strides,
                                  const long long* maps, int causal,
                                  int window, float softcap, float scale,
                                  void* stream) {
  if (Hkv < 1 || Hq < 1 || Hq % Hkv != 0 || B < 1 || B > 65535 || Sq < 1 ||
      Skv < 1 || !aligned16(q) || !aligned16(k) || !aligned16(v) ||
      !aligned16(o) || !aligned16(dO))
    return (int)cudaErrorInvalidValue;
  HParams p;
  p.Hq = Hq; p.Sq = Sq; p.Skv = Skv; p.group = Hq / Hkv;
  p.Sqp = (Sq + kRowPad - 1) / kRowPad * kRowPad;
  for (int i = 0; i < 5; ++i)
    for (int j = 0; j < 3; ++j) p.st[i][j] = strides[3 * i + j];
  p.causal = causal; p.window = window; p.softcap = softcap; p.scale = scale;
  p.qk_log2 = scale * kLog2e;
  p.cap_in = softcap > 0.f ? 2.f * scale * kLog2e / softcap : 0.f;
  p.cap_out = softcap * kLog2e;
  float* lse2 = rows;
  float* dvec = rows + (long long)B * Hq * p.Sqp;
  const void* ptrs[4] = {q, dO, k, v};
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 64)
    return launch_hopper<64>(s, B, o, dO, lse, lse2, dvec, dq, dk, dv,
                              ptrs, maps, p);
  if (D == 128)
    return launch_hopper<128>(s, B, o, dO, lse, lse2, dvec, dq, dk, dv,
                               ptrs, maps, p);
  if (D == 256)
    return launch_hopper<256>(s, B, o, dO, lse, lse2, dvec, dq, dk, dv,
                               ptrs, maps, p);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
