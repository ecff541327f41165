// Hopper (sm_90a) flash-attention forward: K6 of the kernel table.
//
// Replaces the Pallas TPU kernel of repro/kernels/flash_attention.py:
//   flash_attention (flash_attention.py:114, pallas_call at :181), kernel
//   body _attn_kernel (:40), and its :169 variant (_attn_kernel_lse, :100)
//   that also writes the row log-sum-exp the backward pass reads (K7,
//   flash_attention_bwd.cu).
//
// It computes, for q (B, Hq, Sq, D) and k, v (B, Hkv, Skv, D):
//   s   = q·kᵀ · scale;  s = tanh(s / softcap) · softcap  (when softcap > 0)
//   s   = NEG_INF where the pair is masked:  k_pos >= Skv, or causal and
//         k_pos > q_pos, or window >= 0 and k_pos < q_pos - window
//         (window counts previous positions, self excluded; q_pos and k_pos
//         both count from 0, also when Sq != Skv)
//   out = softmax(s) · v, a row with no visible key gives 0
//   lse = m + log(l) per row, with l == 0 read as 1 (so -1e30 for a row
//         that sees no key), float32, contiguous (B, Hq, Sq); written only
//         when the caller passes an lse pointer (nullptr: not wanted)
// with the kv head h / (Hq / Hkv) (GQA), in q's dtype.  NEG_INF is -1e30,
// not -inf, and p is masked to 0 after the exp, as in the reference, so a
// fully masked tile leaves the running sums unchanged.
//
// What bounds it on an H100: at the model's shapes (D = 256, Sq = Skv =
// 32768) it does 4·D flops for each visible (q, k) pair and reads each of
// q, k, v once, far above the ~300 flops per byte where the card stops
// being bandwidth-bound, so the bound is the bf16 tensor-core rate.
//
// Two routes; the wrapper (flash_attention.py, `route`) picks one before
// launch from dtype, shape, strides and alignment:
// * the wgmma route, fa_hopper_kernel (its section below): bf16 at head
//   dims 64, 128 and 256 with 16-byte aligned bases and strides that are
//   multiples of 8 elements.  TMA loads into a K/V ring, a producer
//   warpgroup and two consumer warpgroups, wgmma.  Entry point
//   roomy_flash_attention_tma; the library links libcuda for
//   cuTensorMapEncodeTiled.
// * the classic route, everything else (float32, other head dims, odd
//   strides): the kernels that follow, simple and right first.
//
// Classic route:
// * bf16: one CTA of 4 warps per (q tile of 64 rows, q head, batch); each
//   warp owns 16 rows.  Q, then each K/V tile, are staged in shared memory
//   (rows padded by 16 bytes so ldmatrix is free of bank conflicts).  S =
//   Q·Kᵀ and O += P·V are warp-level mma.sync m16n8k16 (bf16 in, f32
//   accumulate).  The running max, sum and the O accumulator stay in f32
//   registers, in the mma accumulator layout, so the rescale by
//   exp(m_old - m_new) needs no trip through shared memory; P is rounded to
//   bf16 only as the A operand of P·V.  D is padded with zeros to a multiple
//   of 16 (template buckets 16, 32, 64, 128, 256).
// * f32: plain FMA on the CUDA cores, never TF32, so the f32 result holds
//   the reference's 2e-5 tolerance.  One CTA of 4 warps per 16 q rows; a
//   32-key tile in shared memory, one key per lane for S, each lane owning
//   D/32 output columns for P·V.
// * Only kv tiles that hold a visible pair for the CTA are loaded (causal:
//   up to the tile's last row; window: from its first row minus window),
//   and a warp skips the arithmetic of a tile that none of its rows sees.
//   CTAs of the last q tiles, which have the most keys, are launched first.
// * No padding of Sq or Skv: rows and keys are bounds-checked, and the
//   tiles are zero-filled past the end, so 0·garbage never makes a NaN.
// * Strided q/k/v/o (the model passes (B, S, H, D) activations viewed as
//   (B, H, S, D)); only D must be contiguous.  16-byte loads when every row
//   start is 16-byte aligned, element loads otherwise (D = 12 in the smoke
//   configs).
//
// Plain C interface, loaded with ctypes.  The launch goes on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;  // 4 warps

struct Params {
  int Hq, Sq, Skv, D, group;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int causal, window;   // window < 0: none
  float softcap, scale; // softcap 0: none
  int vec;              // every row start 16-byte aligned and D % 8 == 0
};

// P: Params or HParams (the Hopper route's), which share these fields.
template <class P>
__device__ __forceinline__ bool visible(const P& p, int qpos, int kpos) {
  return kpos < p.Skv && (!p.causal || kpos <= qpos) &&
         (p.window < 0 || kpos >= qpos - p.window);
}

__device__ __forceinline__ float logit(const Params& p, float s) {
  s *= p.scale;
  if (p.softcap != 0.f) s = tanhf(s / p.softcap) * p.softcap;
  return s;
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

// ----------------------------------------------------------------- bf16

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
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

// ROWS rows of D bf16 from src (row stride `stride` elements) into dst
// (row stride DP + 8), zero past `rows` and past D.
template <int DP, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long stride, int rows, int D,
                                          int vec) {
  constexpr int LD = DP + 8, CH = DP / 8;   // 16-byte chunks per row
  for (int i = threadIdx.x; i < ROWS * CH; i += kThreads) {
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

template <int DP, int BK>
__global__ void __launch_bounds__(kThreads)
    fa_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ o,
                   float* __restrict__ lse, Params p) {
  constexpr int BQ = 64, LD = DP + 8, NB = BK / 8, NO = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);   // BQ x LD
  bf16* sK = sQ + BQ * LD;                         // BK x LD
  bf16* sV = sK + BK * LD;                         // BK x LD

  const int nq = (p.Sq + BQ - 1) / BQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * BQ;   // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / p.group;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* kg = k + b * p.k_sb + hk * p.k_sh;
  const bf16* vg = v + b * p.v_sb + hk * p.v_sh;

  load_tile<DP, BQ>(sQ, q + b * p.q_sb + h * p.q_sh + q0 * p.q_ss, p.q_ss,
                    min(BQ, p.Sq - q0), p.D, p.vec);

  const int r0 = q0 + warp * 16;
  const int row[2] = {r0 + g, r0 + g + 8};
  const bool idle = r0 >= p.Sq;
  int lo, hi, wlo = 0, whi = 0;
  kv_range(p, q0, min(q0 + BQ, p.Sq) - 1, &lo, &hi);
  if (!idle) kv_range(p, r0, min(r0 + 16, p.Sq) - 1, &wlo, &whi);

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int k0 = (lo / BK) * BK; k0 < hi; k0 += BK) {
    __syncthreads();   // every warp is done with the previous tile
    const int rows = min(BK, p.Skv - k0);
    load_tile<DP, BK>(sK, kg + k0 * p.k_ss, p.k_ss, rows, p.D, p.vec);
    load_tile<DP, BK>(sV, vg + k0 * p.v_ss, p.v_ss, rows, p.D, p.vec);
    __syncthreads();
    if (idle || k0 >= whi || k0 + BK <= wlo) continue;

    // S = Q·Kᵀ for the warp's 16 rows and the tile's BK keys.
    float s[NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
      uint32_t a[4];
      ldsm_x4(a, sQ + (warp * 16 + (lane & 15)) * LD + ks * 16 +
                     (lane >> 4) * 8);
#pragma unroll
      for (int n = 0; n < NB; n += 2) {
        uint32_t bb[4];
        ldsm_x4(bb, sK + (n * 8 + (lane & 7) + (lane >> 4) * 8) * LD +
                        ks * 16 + ((lane >> 3) & 1) * 8);
        mma(s[n], a, bb[0], bb[1]);
        mma(s[n + 1], a, bb[2], bb[3]);
      }
    }

    // Scale, softcap, mask; online softmax over the row (4 lanes a row).
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = k0 + n * 8 + 2 * t + (i & 1);
        const float x = logit(p, s[n][i]);
        s[n][i] = visible(p, row[i >> 1], col) ? x : kNegInf;
        mx[i >> 1] = fmaxf(mx[i >> 1], s[n][i]);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      mx[r] = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = k0 + n * 8 + 2 * t + (i & 1);
        const float e =
            visible(p, row[i >> 1], col) ? expf(s[n][i] - m[i >> 1]) : 0.f;
        s[n][i] = e;
        sum[i >> 1] += e;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * alpha[r] + sum[r];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P·V: two adjacent S accumulators are one A operand.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t bb[4];
        ldsm_x4_t(bb, sV + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                          n * 8 + (lane >> 4) * 8);
        mma(acc[n], a, bb[0], bb[1]);
        mma(acc[n + 1], a, bb[2], bb[3]);
      }
    }
  }

  if (idle) return;
  bf16* og = o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= p.Sq) continue;
    const float sl = l[r] == 0.f ? 1.f : l[r];
    if (lse != nullptr && t == 0)   // a row's 4 lanes hold the same m, l
      lse[((long long)b * p.Hq + h) * p.Sq + row[r]] = m[r] + logf(sl);
    bf16* orow = og + row[r] * p.o_ss;
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = n * 8 + 2 * t + j;
        if (c < p.D) orow[c] = __float2bfloat16(acc[n][2 * r + j] / sl);
      }
  }
}

// ------------------------------------------------------------------ f32

constexpr int kF32Rows = 16;   // q rows per CTA, 4 per warp
constexpr int kF32Keys = 32;   // keys per tile, one per lane
constexpr int kF32Cols = 8;    // output columns per lane (D <= 256)

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, d));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(0xffffffffu, x, d);
  return x;
}

__global__ void __launch_bounds__(kThreads)
    fa_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  float* __restrict__ lse, Params p) {
  extern __shared__ float smem_f[];
  const int D = p.D, LDK = D + 1;          // K rows padded: no bank conflict
  float* sQ = smem_f;                       // kF32Rows x D
  float* sK = sQ + kF32Rows * D;            // kF32Keys x LDK
  float* sV = sK + kF32Keys * LDK;          // kF32Keys x D

  const int nq = (p.Sq + kF32Rows - 1) / kF32Rows;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kF32Rows;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / p.group;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* qg = q + b * p.q_sb + h * p.q_sh + q0 * p.q_ss;
  const float* kg = k + b * p.k_sb + hk * p.k_sh;
  const float* vg = v + b * p.v_sb + hk * p.v_sh;

  for (int i = threadIdx.x; i < kF32Rows * D; i += kThreads) {
    const int r = i / D, c = i % D;
    sQ[i] = (q0 + r < p.Sq) ? qg[r * p.q_ss + c] : 0.f;
  }

  float acc[4][kF32Cols];
  float m[4], l[4];
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int j = 0; j < kF32Cols; ++j) acc[rr][j] = 0.f;
  }
  int lo, hi;
  kv_range(p, q0, min(q0 + kF32Rows, p.Sq) - 1, &lo, &hi);

  for (int k0 = (lo / kF32Keys) * kF32Keys; k0 < hi; k0 += kF32Keys) {
    __syncthreads();
    for (int i = threadIdx.x; i < kF32Keys * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < p.Skv;
      sK[r * LDK + c] = in ? kg[(k0 + r) * p.k_ss + c] : 0.f;
      sV[i] = in ? vg[(k0 + r) * p.v_ss + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const int lr = warp * 4 + rr, row = q0 + lr;
      if (row >= p.Sq) continue;
      if (p.causal && k0 > row) continue;
      if (p.window >= 0 && k0 + kF32Keys - 1 < row - p.window) continue;
      const int key = k0 + lane;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(sQ[lr * D + d], sK[lane * LDK + d], s);
      const bool vis = visible(p, row, key);
      const float x = vis ? logit(p, s) : kNegInf;
      const float mnew = fmaxf(m[rr], warp_max(x));
      const float alpha = expf(m[rr] - mnew);
      const float e = vis ? expf(x - mnew) : 0.f;
      l[rr] = l[rr] * alpha + warp_sum(e);
      m[rr] = mnew;
#pragma unroll
      for (int j = 0; j < kF32Cols; ++j) acc[rr][j] *= alpha;
      for (int kk = 0; kk < kF32Keys; ++kk) {
        const float pk = __shfl_sync(0xffffffffu, e, kk);
#pragma unroll
        for (int j = 0; j < kF32Cols; ++j) {
          const int d = lane + 32 * j;
          if (d < D) acc[rr][j] = fmaf(pk, sV[kk * D + d], acc[rr][j]);
        }
      }
    }
  }

  float* og = o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    const int row = q0 + warp * 4 + rr;
    if (row >= p.Sq) continue;
    const float sl = l[rr] == 0.f ? 1.f : l[rr];
    if (lse != nullptr && lane == 0)   // m and l are warp-uniform
      lse[((long long)b * p.Hq + h) * p.Sq + row] = m[rr] + logf(sl);
#pragma unroll
    for (int j = 0; j < kF32Cols; ++j) {
      const int d = lane + 32 * j;
      if (d < D) og[row * p.o_ss + d] = acc[rr][j] / sl;
    }
  }
}

// ------------------------------------------- bf16 on Hopper: TMA + wgmma
//
// The route for bf16 at head dims 64, 128 and 256 (the wrapper's `route`):
// one CTA of three warpgroups per (128 q rows, q head, batch row).
// Warpgroup 0 is the producer: it gives up registers (setmaxnreg 24) and
// one of its threads issues every copy as a TMA load (cp.async.bulk.tensor
// over a 4-D map (D, S, H, B) of the strided view, so a box never leaves
// its head and rows past S come in as zeros): Q once, then K and V tiles
// into a ring of STAGES slots guarded by full/empty mbarriers with
// expect_tx byte counts.  Warpgroups 1 and 2 are the consumers (setmaxnreg
// 240), 64 q rows each: S = Q·Kᵀ is wgmma m64nBKk16 with both operands in
// shared memory (K-major, 128-byte swizzle, one box of 64 columns per
// 128-byte row); O += P·V is wgmma with P in registers (the S accumulator
// rounded to bf16 pairs in place: its fragment is the A operand's) and V
// read MN-major through the descriptor's transpose bit.  The online
// softmax keeps 4 lanes a row (shfl_xor 1, 2) in log2 units (exp2 with
// log2(e) folded into the scale); the row sum stays a per-thread partial
// until the end.  The mask runs only on tiles that cut the diagonal, the
// window's edge or Skv; the softcap's tanh is 1 - 2/(1 + 2^(2x·log2 e))
// from ex2.approx and rcp.approx (sign-safe; tanh.approx's error times
// the cap would move the LSE by up to ~0.025).  Tiles (BK kv rows, ring
// STAGES), inside 227 KB of shared memory with Q resident:
//   D = 256: BK 64, 2 stages: 64 KB + 2 x (32 + 32) KB = 192 KB
//   D = 128: BK 128, 2 stages: 32 KB + 2 x (32 + 32) KB = 160 KB
//   D = 64:  BK 128, 4 stages: 16 KB + 4 x (16 + 16) KB = 144 KB
// At D = 256 a consumer thread holds O (128 f32), S (32) and P (16).  The
// CTAs run heaviest q tile first, and the q heads of one kv group are
// adjacent in the grid, so their K and V tiles meet in L2.

constexpr int kBQ = 128;        // q rows a CTA: 64 a consumer warpgroup
constexpr int kWsThreads = 384; // producer warpgroup + 2 consumer ones

template <int D> struct Tile;   // kv rows a tile, ring stages
template <> struct Tile<64> { static constexpr int BK = 128, STAGES = 4; };
template <> struct Tile<128> { static constexpr int BK = 128, STAGES = 2; };
template <> struct Tile<256> { static constexpr int BK = 64, STAGES = 2; };

// Byte offsets in the CTA's shared memory, from a 1024-byte aligned base
// (the 128-byte swizzle repeats every 8 rows of 128 bytes).
template <int D> struct Layout {
  static constexpr int BK = Tile<D>::BK, STAGES = Tile<D>::STAGES;
  static constexpr int Q = kBQ * D * 2, KV = BK * D * 2;  // a tile's bytes
  static constexpr int BAR = Q + 2 * STAGES * KV;
  static constexpr int NBAR = 1 + 3 * STAGES;  // q_full; k/v_full, empty
  static constexpr int BYTES = BAR + 8 * NBAR + 1024;     // + alignment
};

struct HParams {
  int Hq, Sq, Skv, group;
  long long o_sb, o_sh, o_ss;
  int causal, window;  // window < 0: none
  float softcap;       // 0: none
  float qk_log2;       // scale·log2(e): a dot product to a log2 logit
  float cap_in;        // 2·scale·log2(e)/softcap: the exponent of e^(2x)
  float cap_out;       // softcap·log2(e)
};


template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
    fa_hopper_kernel(const __grid_constant__ CUtensorMap mq,
                     const __grid_constant__ CUtensorMap mk,
                     const __grid_constant__ CUtensorMap mv,
                     bf16* __restrict__ o, float* __restrict__ lse,
                     HParams p) {
  using L = Layout<D>;
  constexpr int BK = L::BK, STAGES = L::STAGES, NC = D / 64;
  extern __shared__ __align__(16) unsigned char smem_ws[];
  const uint32_t base = (smem_addr(smem_ws) + 1023u) & ~1023u;
  const uint32_t sq = base, bar = base + L::BAR;
  // slot s: K at sk(s), V at sk(s) + KV; each tile is NC boxes of
  // (rows x 128 bytes), one per 64 columns
  auto sk = [&](int s) { return base + L::Q + 2 * s * L::KV; };
  auto q_full = [&]() { return bar; };
  auto k_full = [&](int s) { return bar + 8 * (1 + s); };
  auto v_full = [&](int s) { return bar + 8 * (1 + STAGES + s); };
  auto empty = [&](int s) { return bar + 8 * (1 + 2 * STAGES + s); };

  const int nq = (p.Sq + kBQ - 1) / kBQ;
  const int h = (int)(blockIdx.x % p.Hq), b = blockIdx.y, hk = h / p.group;
  const int q0 = (nq - 1 - (int)(blockIdx.x / p.Hq)) * kBQ;  // heaviest first
  int lo, hi;
  kv_range(p, q0, min(q0 + kBQ, p.Sq) - 1, &lo, &hi);
  const int t_lo = lo / BK, t_hi = hi > lo ? (hi + BK - 1) / BK : t_lo;

  if (threadIdx.x == 0) {
    mbar_init(q_full(), 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
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
      mbar_expect_tx(q_full(), L::Q);
#pragma unroll
      for (int c = 0; c < NC; ++c)
        tma_load(sq + c * kBQ * 128, &mq, q_full(), 64 * c, q0, h, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int j = t_lo; j < t_hi; ++j) {
        mbar_wait(empty(stage), phase ^ 1);   // the first round passes
        mbar_expect_tx(k_full(stage), L::KV);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          tma_load(sk(stage) + c * BK * 128, &mk, k_full(stage), 64 * c,
                   j * BK, hk, b);
        mbar_expect_tx(v_full(stage), L::KV);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          tma_load(sk(stage) + L::KV + c * BK * 128, &mv, v_full(stage),
                   64 * c, j * BK, hk, b);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
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
    const uint32_t qa = sq + cw * 64 * 128;

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};   // running max, log2 units
    float l[2] = {0.f, 0.f};           // this thread's part of the row sum

    mbar_wait(q_full(), 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int j = t_lo; j < t_hi; ++j) {
      const int k0 = j * BK;
      mbar_wait(k_full(stage), phase);
      if (active && k0 < whi && k0 + BK > wlo) {
        // S = Q·Kᵀ: 64 rows x BK keys, D/16 steps of k16.
        float s[BK / 2];
        wg_fence();
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss(s,
                     sw128_desc(qa + c * kBQ * 128 + kk * 32, 16, 1024),
                     sw128_desc(sk(stage) + c * BK * 128 + kk * 32, 16, 1024),
                     (c | kk) != 0);
        wg_commit();
        wg_wait0();
        fence_regs(s);

        // Logits in log2 units; the mask only where the tile needs it.
        if (p.softcap != 0.f) {
#pragma unroll
          for (int i = 0; i < BK / 2; ++i) {
            const float e = ex2(s[i] * p.cap_in);
            s[i] = (1.f - 2.f * rcp(1.f + e)) * p.cap_out;
          }
        } else {
#pragma unroll
          for (int i = 0; i < BK / 2; ++i) s[i] *= p.qk_log2;
        }
        const bool interior = k0 + BK <= p.Skv &&
                              (!p.causal || k0 + BK - 1 <= ra) &&
                              (p.window < 0 || k0 >= ra + 63 - p.window);
        if (!interior) {
#pragma unroll
          for (int i = 0; i < BK / 2; ++i)
            if (!visible(p, row0 + 8 * ((i >> 1) & 1),
                         k0 + 8 * (i >> 2) + 2 * t + (i & 1)))
              s[i] = kNegInf;
        }
        float mx[2] = {m[0], m[1]}, alpha[2];
#pragma unroll
        for (int i = 0; i < BK / 2; ++i)
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          alpha[r] = ex2(m[r] - mx[r]);
          m[r] = mx[r];
          l[r] *= alpha[r];
        }
        if (interior) {
#pragma unroll
          for (int i = 0; i < BK / 2; ++i) {
            s[i] = ex2(s[i] - m[(i >> 1) & 1]);
            l[(i >> 1) & 1] += s[i];
          }
        } else {
#pragma unroll
          for (int i = 0; i < BK / 2; ++i) {
            const int r = (i >> 1) & 1;
            s[i] = visible(p, row0 + 8 * r,
                           k0 + 8 * (i >> 2) + 2 * t + (i & 1))
                       ? ex2(s[i] - m[r])
                       : 0.f;
            l[r] += s[i];
          }
        }
        uint32_t pa[BK / 16][4];
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
          for (int x = 0; x < 4; ++x)
            pa[kk][x] = pack_bf16(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

        // O += P·V: BK/16 steps of k16 over the whole head dim.
        mbar_wait(v_full(stage), phase);
        fence_regs(acc);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_rs(acc, pa[kk],
                   sw128_desc(sk(stage) + L::KV + kk * 16 * 128, BK * 128,
                              1024));
        wg_commit();
        wg_wait0();
        fence_regs(acc);
      } else {
        mbar_wait(v_full(stage), phase);   // the slot is free only once
      }                                    // both of its loads landed
      if (tid == 0) mbar_arrive(empty(stage));
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    bf16* og = o + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (!active || row >= p.Sq) continue;
      const float inv = l[r] == 0.f ? 1.f : 1.f / l[r];
      if (lse != nullptr && t == 0)
        lse[((long long)b * p.Hq + h) * p.Sq + row] =
            l[r] == 0.f ? kNegInf : (m[r] + log2f(l[r])) * kLn2;
      bf16* orow = og + row * p.o_ss;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n + 2 * t) =
            __floats2bfloat162_rn(acc[4 * n + 2 * r] * inv,
                                  acc[4 * n + 2 * r + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------- launch

template <int DP, int BK>
int launch_bf16(dim3 grid, cudaStream_t stream, const void* q, const void* k,
                const void* v, void* o, float* lse, const Params& p) {
  const size_t smem = (size_t)(64 + 2 * BK) * (DP + 8) * sizeof(bf16);
  cudaError_t e = cudaFuncSetAttribute(
      fa_bf16_kernel<DP, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  fa_bf16_kernel<DP, BK><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, p);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------- Hopper launch

template <int D>
int launch_hopper(cudaStream_t stream, int B, const void* q, const void* k,
                  const void* v, void* o, float* lse, const long long* maps,
                  const HParams& p) {
  using L = Layout<D>;
  const void* ptrs[3] = {q, k, v};
  const int rows[3] = {kBQ, L::BK, L::BK};
  CUtensorMap tm[3];
  for (int i = 0; i < 3; ++i) {
    const long long* g = maps + 11 * i;
    // the wrapper's geometry must be this instantiation's tiles
    if (g[0] != D || g[7] != 64 || g[8] != rows[i] || g[9] != 1 ||
        g[10] != 1)
      return (int)cudaErrorInvalidValue;
    const int e = encode_map(&tm[i], ptrs[i], g);
    if (e) return e;
  }
  cudaError_t e = cudaFuncSetAttribute(
      fa_hopper_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::BYTES);
  if (e != cudaSuccess) return (int)e;
  const long long ctas = (long long)((p.Sq + kBQ - 1) / kBQ) * p.Hq;
  fa_hopper_kernel<D><<<dim3((unsigned)ctas, B), kWsThreads, L::BYTES,
                        stream>>>(tm[0], tm[1], tm[2],
                                  static_cast<bf16*>(o), lse, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* roomy_fa_error_string(int code) {
  if (code >= kDriverError) {
    const char* s = nullptr;
    cuGetErrorString((CUresult)(code - kDriverError), &s);
    return s != nullptr ? s : "unknown driver error";
  }
  return cudaGetErrorString((cudaError_t)code);
}

// dtype 0: float32, 1: bfloat16.  strides: 12 element strides, (batch,
// head, seq) of q, k, v and o in that order; the last dim is contiguous.
// lse: nullptr, or B·Hq·Sq floats for the row log-sum-exp.
int roomy_flash_attention(const void* q, const void* k, const void* v,
                          void* o, float* lse, int dtype, int B, int Hq,
                          int Hkv, int Sq, int Skv, int D,
                          const long long* strides, int causal, int window,
                          float softcap, float scale, void* stream) {
  if (D < 1 || D > 256 || Hkv < 1 || Hq % Hkv != 0 || B < 0 || Sq < 0 ||
      Skv < 0 || B > 65535 || Hq > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0 || Hq == 0) return 0;
  Params p;
  p.Hq = Hq; p.Sq = Sq; p.Skv = Skv; p.D = D; p.group = Hq / Hkv;
  p.q_sb = strides[0]; p.q_sh = strides[1]; p.q_ss = strides[2];
  p.k_sb = strides[3]; p.k_sh = strides[4]; p.k_ss = strides[5];
  p.v_sb = strides[6]; p.v_sh = strides[7]; p.v_ss = strides[8];
  p.o_sb = strides[9]; p.o_sh = strides[10]; p.o_ss = strides[11];
  p.causal = causal; p.window = window; p.softcap = softcap; p.scale = scale;
  int vec = D % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  for (int i = 0; i < 9; ++i) vec = vec && strides[i] % 8 == 0;
  p.vec = vec;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    const size_t smem = (size_t)(kF32Rows * D + kF32Keys * (D + 1) +
                                 kF32Keys * D) * sizeof(float);
    cudaError_t e = cudaFuncSetAttribute(
        fa_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((Sq + kF32Rows - 1) / kF32Rows, Hq, B);
    fa_f32_kernel<<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, p);
    return (int)cudaGetLastError();
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  dim3 grid((Sq + 63) / 64, Hq, B);
  if (D <= 16) return launch_bf16<16, 64>(grid, s, q, k, v, o, lse, p);
  if (D <= 32) return launch_bf16<32, 64>(grid, s, q, k, v, o, lse, p);
  if (D <= 64) return launch_bf16<64, 64>(grid, s, q, k, v, o, lse, p);
  if (D <= 128) return launch_bf16<128, 64>(grid, s, q, k, v, o, lse, p);
  return launch_bf16<256, 32>(grid, s, q, k, v, o, lse, p);
}

// Dynamic shared memory of the Hopper route's kernel at head dim D, -1 for
// a head dim it does not take.
int roomy_flash_attention_tma_smem(int D) {
  return D == 64 ? Layout<64>::BYTES
         : D == 128 ? Layout<128>::BYTES
         : D == 256 ? Layout<256>::BYTES
                    : -1;
}

// The Hopper route: bf16, D in {64, 128, 256}, q/k/v/o 16-byte aligned and
// every stride a multiple of 8 elements (the wrapper's `route`).  maps: 3 x
// 11 values, the 4-D tensor-map geometry of q, k and v (dims D, S, H, B;
// byte strides of S, H, B; box 64 x rows x 1 x 1); o_strides: o's (batch,
// head, seq) element strides.  lse as for roomy_flash_attention.
int roomy_flash_attention_tma(const void* q, const void* k, const void* v,
                              void* o, float* lse, int B, int Hq, int Hkv,
                              int Sq, int Skv, int D,
                              const long long* o_strides,
                              const long long* maps, int causal, int window,
                              float softcap, float scale, void* stream) {
  if (Hkv < 1 || Hq < 1 || Hq % Hkv != 0 || B < 1 || B > 65535 || Sq < 1 ||
      Skv < 1 || !aligned16(q) || !aligned16(k) || !aligned16(v) ||
      !aligned16(o))
    return (int)cudaErrorInvalidValue;
  HParams p;
  p.Hq = Hq; p.Sq = Sq; p.Skv = Skv; p.group = Hq / Hkv;
  p.o_sb = o_strides[0]; p.o_sh = o_strides[1]; p.o_ss = o_strides[2];
  p.causal = causal; p.window = window; p.softcap = softcap;
  p.qk_log2 = scale * kLog2e;
  p.cap_in = softcap > 0.f ? 2.f * scale * kLog2e / softcap : 0.f;
  p.cap_out = softcap * kLog2e;
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 64) return launch_hopper<64>(s, B, q, k, v, o, lse, maps, p);
  if (D == 128) return launch_hopper<128>(s, B, q, k, v, o, lse, maps, p);
  if (D == 256) return launch_hopper<256>(s, B, q, k, v, o, lse, maps, p);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
