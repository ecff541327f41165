// Hopper (sm_90a) paged-decode attention (flash-decoding): K8 of the kernel
// table.
//
// Replaces the Pallas TPU kernel of repro/kernels/paged_decode.py:
//   paged_decode_attention (paged_decode.py:78, pallas_call at :116),
//   kernel body _kernel (:33-76).
//
// It computes, for q (B, Hq, hd), k, v pages (P, ps, kvh, hd), a page table
// (B, pps) of physical page ids and lengths (B,): each kv head's group of
// g = Hq / kvh query rows attends over the first n = min(lengths[b],
// pps·ps) positions of its sequence, position t living at row t % ps of
// page table[b, t / ps]:
//   s_t = q·k_t · scale, then tanh(s_t / c) · c when a softcap c is set;
//   out = sum_t softmax(s)_t · v_t, and 0 for a row with n = 0.
// q, k, v are read in their dtype (float32 or bfloat16, one for all
// three); scores, the softmax and the sums are float32; the output is
// written in q's dtype, contiguous (B, Hq, hd).  A table entry at or past
// the length is never read; an entry outside [0, P) within the length is
// skipped.  The output is the same bits run to run.
//
// What bounds it on an H100: each live K and V row is read once (2·n·kvh·hd
// elements a sequence) and each q row is used against it: 2·g FMAs a K/V
// element, far below the card's ~295 bf16 tensor-core operations a byte,
// so the bytes bind.  At nemotron-4-15b's decode after 32768 tokens (kvh 8,
// hd 128, bf16) that is 134 MB a layer, 0.040 ms at 3.35 TB/s.
//
// Two routes, chosen by the wrapper (paged_decode.py `route`) before
// launch; neither stands in for the other:
//
// * The TMA route (pd_hopper_kernel, the section at the end): bf16 at head
//   dims 64, 128 and 256 (minicpm-2b, nemotron-4-15b and granite-34b,
//   gemma2-2b) with pages of a multiple of TILE = 64 tokens and 16-byte
//   aligned pools.  One block per (split, 16-row m-tile of the group, kv
//   head, batch row): one producer warp and four consumer warps.
//   - The pools are one 4-D tensor map each, (hd, kvh, ps, P), box 64
//     columns x 1 head x 64 tokens x 1 page, 128-byte swizzle, so a box
//     never leaves its kv head or page.  One producer thread walks the
//     split's share of the page table (the Hopper form of the TPU kernel's
//     scalar-prefetch index map), skips an entry outside [0, P) before it
//     can reach a coordinate, and issues each tile's K and V boxes into a
//     ring of STAGES slots behind full/empty mbarriers, with the tile's
//     live token count beside it; a count of 0 ends the walk.
//   - Each consumer warp takes 16 of a tile's 64 tokens and keeps its own
//     online softmax: S = Q·Kᵀ and O += P·V are mma.sync m16n8k16 (bf16
//     in, f32 accumulate; ldmatrix over the swizzled tile, V through the
//     .trans form).  The group's rows are padded to 16 (g = 1, 2, 6) or
//     taken in m-tiles of 16 by separate blocks (g = 48) whose K/V reads
//     meet in L2.  mma.sync and not wgmma: wgmma's 64 rows would multiply
//     the products by 10 at g = 6, and the products are far below the
//     byte bound either way.  Softcap, mask and softmax stay in float32
//     registers, in log2 units (tanh from ex2.approx and rcp.approx, as
//     K6's wgmma route).  On the tile that holds the length's edge, P is
//     0 past it and the V fragments of those tokens are zeroed, so a stale
//     row (even a NaN) past the length adds nothing.
//   - The four warps' states merge in shared memory in a fixed order and
//     the block writes its (m, l, acc) partial (m in log2 units).  The
//     last block of its (batch row, kv head, m-tile) to finish (a ticket
//     from an atomic counter, which that block resets to 0, so no memset
//     runs) merges the splits' partials in their fixed order: one launch
//     in all.  merge_tma_kernel runs the same merge alone, for checks
//     that plant a fault between the two.
//   - Splits (paged_decode.py `tma_splits`, from the shapes alone): one
//     wave of blocks at the kernel's occupancy, at most 16 pages a split
//     (a batch of ragged lengths spreads over waves), and at most
//     sqrt(pps·ps / 16) splits, so the last block's merge stays small.
//
// * The classic route (partial_kernel + merge_kernel): everything else
//   (float32, the smoke configs' head dims 12/16/32, pages of 8 or 16
//   tokens, unaligned pools).  One block per (split, kv head, batch row)
//   runs the online softmax over its share of the live pages in tiles of
//   TILE tokens within one page: K and V rows loaded in 16-byte vectors
//   into shared memory (rows padded by 16 bytes), one (query row, token)
//   dot a thread, one warp a row's softmax, one (query row, column pair)
//   of P·V a thread, a float32 accumulator in shared memory; then
//   merge_kernel, one block per query row, adds the splits' partials in a
//   fixed order and divides by l (1 where l == 0, as the TPU kernel's
//   safe_l).
//
// Plain C interface, loaded with ctypes.  The launches go on the given
// stream, do not synchronise, and return cudaGetLastError() (a tensor-map
// encode failure returns kDriverError + its CUresult).

#include "hopper.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;    // as the TPU kernel's NEG_INF
constexpr int kMaxSmem = 232448;     // 227 KB a block on an H100

struct Params {
  const void* q;           // (B, Hq, hd), strides q_sb, q_sh, last dim 1
  const void* k;           // (P, ps, kvh, hd): token rows `row` apart
  const void* v;
  const int* table;        // (B, pps) contiguous
  const int* lengths;      // (B,)
  float* part_acc;         // (B, kvh, S, g, hd)
  float* part_ml;          // (B, kvh, S, g, 2): m, l
  void* out;               // (B, Hq, hd) contiguous
  long long q_sb, q_sh;
  long long row;           // elements token to token: kvh·hd for a whole
                           // pool, more for a kv-head view of a wider one
  int ps, kvh, hd, g, pps, splits, num_pages, vec;
  float scale, softcap;    // softcap 0: none
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

// Two consecutive elements of a shared row as floats.
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <typename T>
struct Layout {
  static constexpr int kVec = 16 / sizeof(T);           // elements a vector
  static constexpr int kTile = sizeof(T) == 2 ? 64 : 32;  // tokens a tile
};

template <typename T, int HDP>
__host__ __device__ constexpr int row_stride() {
  return HDP + Layout<T>::kVec;                          // 16-byte pad
}

// Shared memory of partial_kernel<T, HDP> for a group of g rows, bytes:
// float q_s, acc_s [g][HDP]; sc_s [g][TILE]; m_s, l_s, al_s [g]; then
// T k_s, v_s [TILE][HDP + VEC] on a 16-byte boundary.
template <typename T, int HDP>
__host__ __device__ int smem_bytes(int g) {
  const int floats = 2 * g * HDP + g * Layout<T>::kTile + 3 * g;
  const int head = ((floats * 4 + 15) / 16) * 16;
  return head + 2 * Layout<T>::kTile * row_stride<T, HDP>() * (int)sizeof(T);
}

template <typename T, int HDP>
__global__ void __launch_bounds__(kThreads)
partial_kernel(const Params p) {
  constexpr int TILE = Layout<T>::kTile;
  constexpr int VEC = Layout<T>::kVec;
  constexpr int RS = row_stride<T, HDP>();
  constexpr int PER_LANE = TILE / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const int g = p.g, hd = p.hd;
  float* q_s = reinterpret_cast<float*>(smem);
  float* acc_s = q_s + g * HDP;
  float* sc_s = acc_s + g * HDP;
  float* m_s = sc_s + g * TILE;
  float* l_s = m_s + g;
  float* al_s = l_s + g;
  const int head = (((2 * g * HDP + g * TILE + 3 * g) * 4 + 15) / 16) * 16;
  T* k_s = reinterpret_cast<T*>(smem + head);
  T* v_s = k_s + TILE * RS;

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // This split's share of the row's live pages.
  int n = p.lengths[b];
  n = n < 0 ? 0 : (n > p.pps * p.ps ? p.pps * p.ps : n);
  const int npages = (n + p.ps - 1) / p.ps;
  const int per = (npages + p.splits - 1) / p.splits;
  const int pg0 = split * per;
  const int pg1 = min(npages, pg0 + per);

  // q rows of this kv head's group as float32, zero past hd; acc = 0.
  const T* qb = static_cast<const T*>(p.q) + (long long)b * p.q_sb
                + (long long)h * g * p.q_sh;
  for (int e = tid; e < g * HDP; e += kThreads) {
    const int gi = e / HDP, d = e % HDP;
    q_s[e] = d < hd ? to_f(qb[(long long)gi * p.q_sh + d]) : 0.f;
    acc_s[e] = 0.f;
  }
  for (int gi = tid; gi < g; gi += kThreads) {
    m_s[gi] = kNegInf;
    l_s[gi] = 0.f;
  }
  if (hd < HDP) {   // the pad columns are read by the dots: keep them 0
    for (int e = tid; e < TILE * (HDP - hd); e += kThreads) {
      const int r = e / (HDP - hd), d = hd + e % (HDP - hd);
      from_f(k_s + r * RS + d, 0.f);
      from_f(v_s + r * RS + d, 0.f);
    }
  }
  __syncthreads();

  const long long row = p.row;                      // elements token to token
  for (int pg = pg0; pg < pg1; ++pg) {
    const int phys = p.table[(long long)b * p.pps + pg];
    if (phys < 0 || phys >= p.num_pages) continue;
    const int valid = min(p.ps, n - pg * p.ps);
    for (int t0 = 0; t0 < valid; t0 += TILE) {
      const int nt = min(TILE, valid - t0);
      const long long base = ((long long)phys * p.ps + t0) * row
                             + (long long)h * hd;
      const T* kg = static_cast<const T*>(p.k) + base;
      const T* vg = static_cast<const T*>(p.v) + base;
      if (p.vec) {
        const int nv = hd / VEC;
        for (int e = tid; e < nt * nv; e += kThreads) {
          const int r = e / nv, c = (e % nv) * VEC;
          const uint4 kx = *reinterpret_cast<const uint4*>(kg + r * row + c);
          const uint4 vx = *reinterpret_cast<const uint4*>(vg + r * row + c);
          *reinterpret_cast<uint4*>(k_s + r * RS + c) = kx;
          *reinterpret_cast<uint4*>(v_s + r * RS + c) = vx;
        }
      } else {
        for (int e = tid; e < nt * hd; e += kThreads) {
          const int r = e / hd, c = e % hd;
          k_s[r * RS + c] = kg[r * row + c];
          v_s[r * RS + c] = vg[r * row + c];
        }
      }
      __syncthreads();

      // Scores: one (query row, token) per thread; masked tokens -1e30.
      for (int e = tid; e < g * TILE; e += kThreads) {
        const int gi = e / TILE, t = e % TILE;
        float s = kNegInf;
        if (t < nt) {
          const float* qr = q_s + gi * HDP;
          const T* kr = k_s + t * RS;
          float acc = 0.f;
#pragma unroll 4
          for (int d = 0; d < HDP; d += VEC) {
            const uint4 kx = *reinterpret_cast<const uint4*>(kr + d);
            const T* kv = reinterpret_cast<const T*>(&kx);
#pragma unroll
            for (int j = 0; j < VEC; ++j) acc += qr[d + j] * to_f(kv[j]);
          }
          s = acc * p.scale;
          if (p.softcap > 0.f) s = tanhf(s / p.softcap) * p.softcap;
        }
        sc_s[e] = s;
      }
      __syncthreads();

      // Online softmax: one warp per query row.
      for (int gi = warp; gi < g; gi += kWarps) {
        float x[PER_LANE];
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < PER_LANE; ++j) {
          x[j] = sc_s[gi * TILE + lane + 32 * j];
          mx = fmaxf(mx, x[j]);
        }
#pragma unroll
        for (int o = 16; o; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_old = m_s[gi];
        const float m_new = fmaxf(m_old, mx);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < PER_LANE; ++j) {
          const int t = lane + 32 * j;
          const float pr = t < nt ? expf(x[j] - m_new) : 0.f;
          sc_s[gi * TILE + t] = pr;
          sum += pr;
        }
#pragma unroll
        for (int o = 16; o; o >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (lane == 0) {
          const float alpha = expf(m_old - m_new);
          al_s[gi] = alpha;
          l_s[gi] = l_s[gi] * alpha + sum;
          m_s[gi] = m_new;
        }
      }
      __syncthreads();

      // P·V: one (query row, column pair) per thread.
      for (int e = tid; e < g * (HDP / 2); e += kThreads) {
        const int gi = e / (HDP / 2), d = (e % (HDP / 2)) * 2;
        const float* pr = sc_s + gi * TILE;
        float a0 = 0.f, a1 = 0.f;
        for (int t = 0; t < nt; ++t) {
          const float w = pr[t];
          const float2 vv = load2(v_s + t * RS + d);
          a0 += w * vv.x;
          a1 += w * vv.y;
        }
        const float alpha = al_s[gi];
        float* acc = acc_s + gi * HDP + d;
        acc[0] = acc[0] * alpha + a0;
        acc[1] = acc[1] * alpha + a1;
      }
      __syncthreads();
    }
  }

  const long long slot = ((long long)b * p.kvh + h) * p.splits + split;
  float* pa = p.part_acc + slot * g * hd;
  for (int e = tid; e < g * hd; e += kThreads)
    pa[e] = acc_s[(e / hd) * HDP + e % hd];
  float* pml = p.part_ml + slot * g * 2;
  for (int gi = tid; gi < g; gi += kThreads) {
    pml[2 * gi] = m_s[gi];
    pml[2 * gi + 1] = l_s[gi];
  }
}

// One block per query row (b, hq): the splits' partials in a fixed order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
merge_kernel(const Params p) {
  extern __shared__ float w_s[];        // [splits] weights, then [kWarps]
  float* red = w_s + p.splits;
  const int row = blockIdx.x;           // b · Hq + hq
  const int hq_n = p.kvh * p.g;
  const int b = row / hq_n, hq = row % hq_n;
  const int h = hq / p.g, gi = hq % p.g;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long slot0 = ((long long)b * p.kvh + h) * p.splits;
  const float* ml = p.part_ml + slot0 * p.g * 2 + 2 * gi;

  float mx = kNegInf;
  for (int s = tid; s < p.splits; s += kThreads)
    mx = fmaxf(mx, ml[(long long)s * p.g * 2]);
#pragma unroll
  for (int o = 16; o; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  float m = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w]);
  __syncthreads();

  float lsum = 0.f;
  for (int s = tid; s < p.splits; s += kThreads) {
    const float w = expf(ml[(long long)s * p.g * 2] - m);
    w_s[s] = w;
    lsum += w * ml[(long long)s * p.g * 2 + 1];
  }
#pragma unroll
  for (int o = 16; o; o >>= 1)
    lsum += __shfl_xor_sync(0xffffffffu, lsum, o);
  if (lane == 0) red[warp] = lsum;
  __syncthreads();
  float l = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) l += red[w];
  const float inv = 1.f / (l == 0.f ? 1.f : l);

  const float* pa = p.part_acc + (slot0 * p.g + gi) * p.hd;
  T* out = static_cast<T*>(p.out) + (long long)row * p.hd;
  for (int d = tid; d < p.hd; d += kThreads) {
    float acc = 0.f;
    for (int s = 0; s < p.splits; ++s)
      acc += w_s[s] * pa[(long long)s * p.g * p.hd + d];
    from_f(out + d, acc * inv);
  }
}

template <typename T, int HDP>
int launch_partial(const Params& p, int B, cudaStream_t stream) {
  const int smem = smem_bytes<T, HDP>(p.g);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  static int allowed = 48 * 1024;       // raised once per instantiation
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        partial_kernel<T, HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    allowed = kMaxSmem;
  }
  dim3 grid(p.splits, p.kvh, B);
  partial_kernel<T, HDP><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Params& p, int B, int stage, cudaStream_t stream) {
  if (stage & 1) {
    int code;
    if (p.hd <= 64) code = launch_partial<T, 64>(p, B, stream);
    else if (p.hd <= 128) code = launch_partial<T, 128>(p, B, stream);
    else code = launch_partial<T, 256>(p, B, stream);
    if (code) return code;
  }
  if (stage & 2) {
    const int smem = (p.splits + kWarps) * (int)sizeof(float);
    merge_kernel<T><<<B * p.kvh * p.g, kThreads, smem, stream>>>(p);
    return (int)cudaGetLastError();
  }
  return 0;
}

// ------------------------------------------- bf16 on Hopper: the TMA route

constexpr int kTile = 64;               // tokens a TMA tile (a box's rows)
constexpr int kConsumers = 4;           // consumer warps, 16 tokens each
constexpr int kTmaThreads = 32 * (1 + kConsumers);   // + the producer warp
constexpr int kCThreads = 32 * kConsumers;           // the consumers
constexpr int kRows = 16;               // query rows a block: one m16 tile
constexpr int kMaxTmaSplits = 512;

template <int HD> struct TmaStages;      // ring depth by head dim
template <> struct TmaStages<64> { static constexpr int N = 4; };
template <> struct TmaStages<128> { static constexpr int N = 3; };
template <> struct TmaStages<256> { static constexpr int N = 2; };

// Byte offsets from a 1024-byte aligned base (the 128-byte swizzle repeats
// every 8 rows of 128 bytes).  After the walk the ring holds the four
// warps' accumulators, then the split merge's weights.
template <int HD> struct TmaLayout {
  static constexpr int STAGES = TmaStages<HD>::N;
  static constexpr int KV = kTile * HD * 2;             // a K or V tile
  static constexpr int RING = STAGES * 2 * KV;
  static constexpr int QLD = HD + 8;                    // q row, elements
  static constexpr int Q = RING;
  static constexpr int ML = Q + kRows * QLD * 2;        // [4][16][2] f32
  static constexpr int INV = ML + kConsumers * kRows * 2 * 4;  // [16] f32
  static constexpr int META = INV + kRows * 4;          // [STAGES] int
  static constexpr int FLAG = META + STAGES * 4;        // int
  static constexpr int BAR = (FLAG + 4 + 7) / 8 * 8;    // full, empty
  static constexpr int BYTES = BAR + 16 * STAGES + 1024;
  static_assert(kConsumers * kRows * HD * 4 <= RING, "warp accumulators");
  static_assert(kRows * kMaxTmaSplits * 4 <= RING, "merge weights");
};

struct TmaParams {
  const bf16* q;            // (B, Hq, hd), strides q_sb, q_sh, last dim 1
  const int* table;         // (B, pps) contiguous
  const int* lengths;       // (B,)
  float* part_acc;          // (B, kvh, S, g, hd)
  float* part_ml;           // (B, kvh, S, g, 2): m (log2 units), l
  int* counters;            // (B, kvh, mt) tickets, 0 between launches
  bf16* out;                // (B, Hq, hd) contiguous
  long long q_sb, q_sh;
  int ps, kvh, g, mt, pps, splits, num_pages, merge;
  float qk_log2;            // scale·log2(e)
  float cap_in;             // 2·scale·log2(e)/softcap; 0: no softcap
  float cap_out;            // softcap·log2(e)
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a · b for one m16n8k16 tile, bf16 in, f32 accumulate.
__device__ __forceinline__ void mma16816(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The shared address of (token r, column c) of a TMA tile: NC boxes of
// kTile rows x 128 bytes, 16-byte chunks swizzled by the row's low 3 bits.
__device__ __forceinline__ uint32_t swz(uint32_t tile, int r, int c) {
  return tile + (c >> 6) * (kTile * 128) + r * 128 +
         ((((c & 63) >> 3) ^ (r & 7)) << 4);
}

// Zero the bf16 halves of a .trans V fragment whose tokens are past nt.
__device__ __forceinline__ uint32_t keep_live(uint32_t v, int tok, int nt) {
  return v & ((tok < nt ? 0x0000FFFFu : 0u) |
              (tok + 1 < nt ? 0xFFFF0000u : 0u));
}

// The splits' partials of (b, h, m-tile mt), rows [0, rows), merged in
// their fixed order into out, by the kCThreads threads tid of the calling
// block (bar 1).  ws: kRows x splits floats; inv: kRows floats.
template <int HD>
__device__ void merge_splits(const TmaParams& p, int b, int h, int mt,
                             int rows, float* ws, float* inv, int tid) {
  const int S = p.splits;
  const int warp = tid >> 5, lane = tid & 31;
  const long long slot0 = ((long long)b * p.kvh + h) * S;
  for (int r = warp; r < rows; r += kConsumers) {
    // One pass over the splits' (m, l): each lane's running (max, sum) is
    // rescaled as the max grows, then the lanes' pairs merge in a fixed
    // tree; m waits in ws for the weights.
    const int gi = kRows * mt + r;
    float mx = kNegInf, lsum = 0.f;
    for (int s = lane; s < S; s += 32) {
      const float2 ml = __ldcg(reinterpret_cast<const float2*>(
          p.part_ml + ((slot0 + s) * p.g + gi) * 2));
      ws[r * S + s] = ml.x;
      const float mn = fmaxf(mx, ml.x);
      lsum = lsum * ex2(mx - mn) + ml.y * ex2(ml.x - mn);
      mx = mn;
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, mx, o);
      const float lo = __shfl_xor_sync(0xffffffffu, lsum, o);
      const float mn = fmaxf(mx, mo);
      lsum = lsum * ex2(mx - mn) + lo * ex2(mo - mn);
      mx = mn;
    }
    __syncwarp();
    for (int s = lane; s < S; s += 32) ws[r * S + s] = ex2(ws[r * S + s] - mx);
    if (lane == 0) inv[r] = lsum == 0.f ? 1.f : 1.f / lsum;
  }
  named_sync(1, kCThreads);
  const int hq_n = p.kvh * p.g;
  for (int e = tid; e < rows * (HD / 4); e += kCThreads) {
    const int r = e / (HD / 4), d = (e % (HD / 4)) * 4;
    const int gi = kRows * mt + r;
    const float* pa = p.part_acc + (slot0 * p.g + gi) * HD + d;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 16
    for (int s = 0; s < S; ++s) {
      const float w = ws[r * S + s];
      const float4 v = __ldcg(reinterpret_cast<const float4*>(
          pa + (long long)s * p.g * HD));
      acc.x += w * v.x;
      acc.y += w * v.y;
      acc.z += w * v.z;
      acc.w += w * v.w;
    }
    const float iv = inv[r];
    bf16* o = p.out + ((long long)b * hq_n + h * p.g + gi) * HD + d;
    *reinterpret_cast<__nv_bfloat162*>(o) =
        __floats2bfloat162_rn(acc.x * iv, acc.y * iv);
    *reinterpret_cast<__nv_bfloat162*>(o + 2) =
        __floats2bfloat162_rn(acc.z * iv, acc.w * iv);
  }
}

template <int HD>
__global__ void __launch_bounds__(kTmaThreads)
    pd_hopper_kernel(const __grid_constant__ CUtensorMap mk,
                     const __grid_constant__ CUtensorMap mv,
                     const TmaParams p) {
  using L = TmaLayout<HD>;
  constexpr int STAGES = L::STAGES, NC = HD / 64, NO = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_pd[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      ((uintptr_t)smem_pd + 1023) & ~(uintptr_t)1023);
  const uint32_t base = smem_addr(sm);
  volatile int* meta = reinterpret_cast<volatile int*>(sm + L::META);
  const uint32_t bar = base + L::BAR;
  auto full = [&](int s) { return bar + 8 * s; };
  auto empty = [&](int s) { return bar + 8 * (STAGES + s); };
  auto ktile = [&](int s) { return base + 2 * s * L::KV; };   // V at + KV

  const int mt = blockIdx.x % p.mt, split = blockIdx.x / p.mt;
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // This split's share of the row's live pages.
  int n = p.lengths[b];
  n = n < 0 ? 0 : (n > p.pps * p.ps ? p.pps * p.ps : n);
  const int npages = (n + p.ps - 1) / p.ps;
  const int per = (npages + p.splits - 1) / p.splits;
  const int pg0 = min(npages, split * per);
  const int pg1 = min(npages, pg0 + per);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers);   // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  if (warp == 0) {
    // ------------------------------------------------------------ producer
    if (lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int pg = pg0; pg < pg1; ++pg) {
        const int phys = p.table[(long long)b * p.pps + pg];
        if (phys < 0 || phys >= p.num_pages) continue;
        const int valid = min(p.ps, n - pg * p.ps);
        for (int t0 = 0; t0 < valid; t0 += kTile) {
          mbar_wait(empty(stage), phase ^ 1);   // the first round passes
          meta[stage] = min(kTile, valid - t0);
          mbar_expect_tx(full(stage), 2 * L::KV);
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            tma_load(ktile(stage) + c * kTile * 128, &mk, full(stage), 64 * c,
                     h, t0, phys);
            tma_load(ktile(stage) + L::KV + c * kTile * 128, &mv,
                     full(stage), 64 * c, h, t0, phys);
          }
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
      mbar_wait(empty(stage), phase ^ 1);
      meta[stage] = 0;                      // the end of the walk
      mbar_arrive(full(stage));
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  const int cw = warp - 1, tid = threadIdx.x - 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int rows = min(kRows, p.g - kRows * mt);   // real rows of the tile
  bf16* sq = reinterpret_cast<bf16*>(sm + L::Q);
  {
    const bf16* qb = p.q + (long long)b * p.q_sb +
                     (long long)(h * p.g + kRows * mt) * p.q_sh;
    for (int e = tid; e < kRows * HD; e += kCThreads) {
      const int r = e / HD, d = e % HD;
      sq[r * L::QLD + d] =
          r < rows ? qb[(long long)r * p.q_sh + d] : __float2bfloat16(0.f);
    }
  }
  named_sync(1, kCThreads);
  const uint32_t sq_a = smem_addr(sq) +
                        ((lane & 15) * L::QLD + (lane >> 4) * 8) * 2;
  const int tok0 = cw * 16;                        // this warp's 16 tokens
  const int krow = tok0 + (lane & 7) + (lane >> 4) * 8;
  const int kcol = ((lane >> 3) & 1) * 8;
  const int vrow = tok0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int vcol = (lane >> 4) * 8;

  float acc[NO][4];
#pragma unroll
  for (int i = 0; i < NO; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};   // running max, log2 units
  float l[2] = {0.f, 0.f};           // this thread's part of the row sum

  int stage = 0;
  uint32_t phase = 0;
  while (true) {
    mbar_wait(full(stage), phase);
    const int nt = meta[stage];
    if (nt == 0) break;
    const uint32_t kt = ktile(stage), vt = kt + L::KV;

    // S = Q·Kᵀ: 16 rows x this warp's 16 tokens, HD/16 steps of k16.
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      uint32_t a[4], bb[4];
      ldsm_x4(a, sq_a + ks * 32);
      ldsm_x4(bb, swz(kt, krow, ks * 16 + kcol));
      mma16816(s[0], a, bb[0], bb[1]);
      mma16816(s[1], a, bb[2], bb[3]);
    }

    // Logits in log2 units, masked past the tile's live tokens.
    const bool edge = nt < kTile;
#pragma unroll
    for (int nn = 0; nn < 2; ++nn)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = s[nn][i];
        if (p.cap_in != 0.f) {
          const float e = ex2(x * p.cap_in);
          x = (1.f - 2.f * rcp(1.f + e)) * p.cap_out;
        } else {
          x *= p.qk_log2;
        }
        s[nn][i] = (edge && tok0 + nn * 8 + 2 * tq + (i & 1) >= nt)
                       ? kNegInf : x;
      }
    float mx[2] = {m[0], m[1]}, alpha[2];
#pragma unroll
    for (int nn = 0; nn < 2; ++nn)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        mx[i >> 1] = fmaxf(mx[i >> 1], s[nn][i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = ex2(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int nn = 0; nn < 2; ++nn)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool dead = edge && tok0 + nn * 8 + 2 * tq + (i & 1) >= nt;
        const float e = dead ? 0.f : ex2(s[nn][i] - m[i >> 1]);
        s[nn][i] = e;
        l[i >> 1] += e;
      }
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      acc[i][0] *= alpha[0];
      acc[i][1] *= alpha[0];
      acc[i][2] *= alpha[1];
      acc[i][3] *= alpha[1];
    }

    // O += P·V: the two S accumulators are one A operand (k = 16 tokens).
    const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]),
                            pack_bf16(s[0][2], s[0][3]),
                            pack_bf16(s[1][0], s[1][1]),
                            pack_bf16(s[1][2], s[1][3])};
    const int vt0 = tok0 + 2 * tq;       // this thread's V fragment tokens
#pragma unroll
    for (int i = 0; i < NO; i += 2) {
      uint32_t bb[4];
      ldsm_x4_t(bb, swz(vt, vrow, i * 8 + vcol));
      if (edge) {
        bb[0] = keep_live(bb[0], vt0, nt);
        bb[1] = keep_live(bb[1], vt0 + 8, nt);
        bb[2] = keep_live(bb[2], vt0, nt);
        bb[3] = keep_live(bb[3], vt0 + 8, nt);
      }
      mma16816(acc[i], pa, bb[0], bb[1]);
      mma16816(acc[i + 1], pa, bb[2], bb[3]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(stage));
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }

  // The four warps' states: m, l a row, then the accumulators rescaled to
  // the block's max and added in warp order.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  float* wml = reinterpret_cast<float*>(sm + L::ML);      // [4][16][2]
  float* wacc = reinterpret_cast<float*>(sm);             // [4][16][HD]
  if (tq == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      wml[(cw * kRows + gq + 8 * r) * 2] = m[r];
      wml[(cw * kRows + gq + 8 * r) * 2 + 1] = l[r];
    }
  }
  named_sync(1, kCThreads);      // every warp is past the ring
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = gq + 8 * r;
    float mb = kNegInf;
#pragma unroll
    for (int w = 0; w < kConsumers; ++w)
      mb = fmaxf(mb, wml[(w * kRows + row) * 2]);
    const float sc = ex2(m[r] - mb);
    float* dst = wacc + (cw * kRows + row) * HD + 2 * tq;
#pragma unroll
    for (int i = 0; i < NO; ++i)
      *reinterpret_cast<float2*>(dst + 8 * i) =
          make_float2(acc[i][2 * r] * sc, acc[i][2 * r + 1] * sc);
  }
  named_sync(1, kCThreads);
  const long long slot = ((long long)b * p.kvh + h) * p.splits + split;
  float* part = p.part_acc + (slot * p.g + kRows * mt) * HD;
  for (int e = tid; e < rows * (HD / 4); e += kCThreads) {
    const int r = e / (HD / 4), d = (e % (HD / 4)) * 4;
    float4 sum = *reinterpret_cast<const float4*>(wacc + r * HD + d);
#pragma unroll
    for (int w = 1; w < kConsumers; ++w) {
      const float4 v =
          *reinterpret_cast<const float4*>(wacc + (w * kRows + r) * HD + d);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    *reinterpret_cast<float4*>(part + r * HD + d) = sum;
  }
  if (tid < rows) {
    float mb = kNegInf;
#pragma unroll
    for (int w = 0; w < kConsumers; ++w)
      mb = fmaxf(mb, wml[(w * kRows + tid) * 2]);
    float lb = 0.f;
#pragma unroll
    for (int w = 0; w < kConsumers; ++w)
      lb += ex2(wml[(w * kRows + tid) * 2] - mb) *
            wml[(w * kRows + tid) * 2 + 1];
    float* pml = p.part_ml + (slot * p.g + kRows * mt + tid) * 2;
    pml[0] = mb;
    pml[1] = lb;
  }
  if (!p.merge) return;

  // The last block of (b, h, mt) to get here merges the splits.
  volatile int* flag = reinterpret_cast<volatile int*>(sm + L::FLAG);
  __threadfence();
  named_sync(1, kCThreads);
  if (tid == 0) {
    int* cnt = p.counters + ((long long)b * p.kvh + h) * p.mt + mt;
    const int last = atomicAdd(cnt, 1) == p.splits - 1;
    if (last) *cnt = 0;                    // ready for the next launch
    *flag = last;
  }
  named_sync(1, kCThreads);
  if (!*flag) return;
  __threadfence();
  merge_splits<HD>(p, b, h, mt, rows, reinterpret_cast<float*>(sm),
                   reinterpret_cast<float*>(sm + L::INV), tid);
}

// The split merge alone, one block of kCThreads per (m-tile, kv head,
// batch row), over partials written by pd_hopper_kernel with merge = 0.
template <int HD>
__global__ void __launch_bounds__(kCThreads)
    merge_tma_kernel(const TmaParams p) {
  extern __shared__ float ms_pd[];   // [kRows][splits] weights, [kRows] inv
  const int mt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  merge_splits<HD>(p, b, h, mt, min(kRows, p.g - kRows * mt), ms_pd,
                   ms_pd + kRows * p.splits, threadIdx.x);
}

template <int HD>
int launch_tma(const TmaParams& p, int B, const void* k, const void* v,
               const long long* maps, int stage, cudaStream_t stream) {
  using L = TmaLayout<HD>;
  if (stage & 1) {
    const void* ptrs[2] = {k, v};
    CUtensorMap tm[2];
    for (int i = 0; i < 2; ++i) {
      const long long* g = maps + 11 * i;
      // the wrapper's geometry must be this instantiation's tile
      if (g[0] != HD || g[7] != 64 || g[8] != 1 || g[9] != kTile ||
          g[10] != 1 || g[2] % kTile != 0)
        return (int)cudaErrorInvalidValue;
      const int e = encode_map(&tm[i], ptrs[i], g);
      if (e) return e;
    }
    const cudaError_t e = cudaFuncSetAttribute(
        pd_hopper_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        L::BYTES);
    if (e != cudaSuccess) return (int)e;
    TmaParams q = p;
    q.merge = stage == 3;
    dim3 grid((unsigned)(p.splits * p.mt), p.kvh, B);
    pd_hopper_kernel<HD><<<grid, kTmaThreads, L::BYTES, stream>>>(
        tm[0], tm[1], q);
    const int code = (int)cudaGetLastError();
    if (code || stage == 3) return code;
  }
  if (stage == 2) {
    const int smem = kRows * (p.splits + 1) * (int)sizeof(float);
    merge_tma_kernel<HD><<<dim3(p.mt, p.kvh, B), kCThreads, smem, stream>>>(
        p);
    return (int)cudaGetLastError();
  }
  return 0;
}

template <int HD>
int tma_blocks_per_sm() {
  using L = TmaLayout<HD>;
  cudaError_t e = cudaFuncSetAttribute(
      pd_hopper_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::BYTES);
  if (e != cudaSuccess) return -(int)e;
  int n = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, pd_hopper_kernel<HD>, kTmaThreads, L::BYTES);
  return e == cudaSuccess ? n : -(int)e;
}

}  // namespace

extern "C" {

const char* roomy_pd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Shared memory a partial block needs, in bytes (0 for an unsupported hd).
int roomy_pd_smem_bytes(int dtype, int hd, int g) {
  if (hd < 1 || hd > 256 || g < 1) return 0;
  if (dtype == 0)
    return hd <= 64 ? smem_bytes<float, 64>(g)
         : hd <= 128 ? smem_bytes<float, 128>(g) : smem_bytes<float, 256>(g);
  return hd <= 64 ? smem_bytes<bf16, 64>(g)
       : hd <= 128 ? smem_bytes<bf16, 128>(g) : smem_bytes<bf16, 256>(g);
}

// dtype 0: float32, 1: bfloat16 (q, pages and out).  q_sb, q_sh: q's batch
// and head strides (its last dim contiguous); table, lengths and out
// contiguous.  The pages: hd contiguous, heads hd apart, tokens kv_row
// elements apart and pages ps·kv_row (a pool, kv_row = kvh·hd, or a
// kv-head range of a wider pool from its first head).  part_acc:
// B·kvh·splits·g·hd floats, part_ml: B·kvh·splits·g·2.  vec: 1 if hd and
// kv_row times sizeof(T) are multiples of 16 and the pages are 16-byte
// aligned.  stage: 1 the partials, 2 the merge, 3 both.
int roomy_paged_decode(const void* q, const void* k, const void* v,
                       const int* table, const int* lengths, float* part_acc,
                       float* part_ml, void* out, int dtype, int B, int Hq,
                       int kvh, int hd, int ps, int pps, int num_pages,
                       int splits, long long q_sb, long long q_sh,
                       long long kv_row, int vec, float scale, float softcap,
                       int stage, void* stream) {
  if (B < 0 || kvh < 1 || Hq % kvh || hd < 1 || hd > 256 || ps < 1 ||
      pps < 1 || splits < 1 || splits > 65535 || kvh > 65535 || B > 65535 ||
      stage < 1 || stage > 3 || kv_row < (long long)kvh * hd)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Hq == 0) return 0;
  Params p;
  p.q = q; p.k = k; p.v = v; p.table = table; p.lengths = lengths;
  p.part_acc = part_acc; p.part_ml = part_ml; p.out = out;
  p.q_sb = q_sb; p.q_sh = q_sh; p.row = kv_row;
  p.ps = ps; p.kvh = kvh; p.hd = hd; p.g = Hq / kvh; p.pps = pps;
  p.splits = splits; p.num_pages = num_pages; p.vec = vec;
  p.scale = scale; p.softcap = softcap;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return dispatch<float>(p, B, stage, s);
  if (dtype == 1) return dispatch<bf16>(p, B, stage, s);
  return (int)cudaErrorInvalidValue;
}

// The TMA route's dynamic shared memory at head dim hd, -1 for one it does
// not take.
int roomy_pd_tma_smem(int hd) {
  return hd == 64 ? TmaLayout<64>::BYTES
       : hd == 128 ? TmaLayout<128>::BYTES
       : hd == 256 ? TmaLayout<256>::BYTES : -1;
}

// Blocks of the TMA route's kernel an SM holds at head dim hd (the split
// plan's occupancy); <= 0 on an error or a head dim it does not take.
int roomy_pd_tma_blocks_per_sm(int hd) {
  return hd == 64 ? tma_blocks_per_sm<64>()
       : hd == 128 ? tma_blocks_per_sm<128>()
       : hd == 256 ? tma_blocks_per_sm<256>() : -1;
}

// The TMA route: bf16, hd in {64, 128, 256}, pages of a multiple of 64
// tokens, k and v 16-byte aligned (P, ps, kvh, hd) pools or kv-head views
// of them (the wrapper's `route`).  maps: 2 x 11 values, the 4-D tensor-map
// geometry of k and v from their bases (dims hd, kvh, ps, P; byte strides
// of kvh, ps, P; box 64 x 1 x 64 x 1).  counters: B·kvh·mt ints, 0 on entry, left 0 by stage 3.
// part_acc, part_ml as for roomy_paged_decode (m in log2 units).  stage: 1
// the partials, 2 their merge, 3 both in one launch.
int roomy_paged_decode_tma(const void* q, const void* k, const void* v,
                           const int* table, const int* lengths,
                           float* part_acc, float* part_ml, int* counters,
                           void* out, int B, int Hq, int kvh, int hd, int ps,
                           int pps, int num_pages, int splits, long long q_sb,
                           long long q_sh, const long long* maps, float scale,
                           float softcap, int stage, void* stream) {
  if (B < 0 || kvh < 1 || Hq % kvh || ps < kTile || ps % kTile || pps < 1 ||
      num_pages < 1 || splits < 1 || splits > kMaxTmaSplits || kvh > 65535 ||
      B > 65535 || stage < 1 || stage > 3 || !aligned16(k) || !aligned16(v))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Hq == 0) return 0;
  TmaParams p;
  p.q = static_cast<const bf16*>(q);
  p.table = table; p.lengths = lengths;
  p.part_acc = part_acc; p.part_ml = part_ml; p.counters = counters;
  p.out = static_cast<bf16*>(out);
  p.q_sb = q_sb; p.q_sh = q_sh;
  p.ps = ps; p.kvh = kvh; p.g = Hq / kvh; p.mt = (p.g + kRows - 1) / kRows;
  p.pps = pps; p.splits = splits; p.num_pages = num_pages; p.merge = 0;
  p.qk_log2 = scale * kLog2e;
  p.cap_in = softcap > 0.f ? 2.f * scale * kLog2e / softcap : 0.f;
  p.cap_out = softcap * kLog2e;
  cudaStream_t s = (cudaStream_t)stream;
  if (hd == 64) return launch_tma<64>(p, B, k, v, maps, stage, s);
  if (hd == 128) return launch_tma<128>(p, B, k, v, maps, stage, s);
  if (hd == 256) return launch_tma<256>(p, B, k, v, maps, stage, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
