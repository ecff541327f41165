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
// three); scores, probabilities and sums are float32; the output is
// written in q's dtype, contiguous (B, Hq, hd).
//
// What bounds it on an H100: each live K and V row is read once (2·n·kvh·hd
// elements a sequence) and each q row is used against it: 2·g FMAs a K/V
// element, below the card's ~20 float32 operations a byte for g <= 6
// (nemotron, gemma2, minicpm), so the bytes bind.  At nemotron-4-15b's
// decode after 32768 tokens (kvh 8, hd 128, bf16) that is 134 MB a layer,
// 0.040 ms at 3.35 TB/s.
//
// Design, simple and right first.  The TPU kernel walks a sequence's pages
// as the sequential grid axis of (batch, kv head, page), carrying the
// online softmax in VMEM.  Copied as it stands that is B·kvh blocks, 8 at
// nemotron's batch 1 for 132 SMs.  So the pages of each sequence are split
// (flash-decoding):
// * partial_kernel: one block per (split, kv head, batch row) takes an
//   even share of that row's live pages (the share is worked out from
//   lengths[b] on the card, so ragged lengths spread over all splits, and
//   a page table entry at or past the length is never read) and runs the
//   online softmax over them in tiles of TILE tokens within one page.  A
//   tile's K and V rows are loaded in 16-byte vectors along hd (a token
//   row of one kv head is hd contiguous elements; rows are kvh·hd apart),
//   kept in shared memory in their dtype with rows padded by 16 bytes so
//   that a quarter warp reading 8 rows at one column hits 32 distinct
//   banks.  Scores: one (query row, token) per thread, a full-hd dot
//   against q in float32 in shared memory (a broadcast); the row max and
//   sum: one warp a query row; P·V: one (query row, column pair) per
//   thread, summed over the tile in registers and folded into the float32
//   accumulator (g × hd, in shared memory, so granite's g = 48 costs no
//   registers).  The block writes its (m, l, acc) to a float32 workspace.
// * merge_kernel: one block per query row adds the splits' partials in a
//   fixed order (weights exp(m_s − m), a block reduction in a fixed tree
//   for l), so the output is the same bits every run, and divides by l
//   (1 where l == 0, as the TPU kernel's safe_l).
// * hd up to 256 (the block's layout is sized for 64, 128 or 256; a
//   smaller hd is zero-padded in shared memory and read with scalar loads
//   when its rows are not 16-byte multiples).
// * A table entry outside [0, P) within the length is skipped, not read.
// Later work (not here): cp.async or TMA double-buffering of the pages,
// tensor-core products for large groups.
//
// Plain C interface, loaded with ctypes.  The launches go on the given
// stream, do not synchronise, and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;    // as the TPU kernel's NEG_INF
constexpr int kMaxSmem = 232448;     // 227 KB a block on an H100

struct Params {
  const void* q;           // (B, Hq, hd), strides q_sb, q_sh, last dim 1
  const void* k;           // (P, ps, kvh, hd) contiguous
  const void* v;
  const int* table;        // (B, pps) contiguous
  const int* lengths;      // (B,)
  float* part_acc;         // (B, kvh, S, g, hd)
  float* part_ml;          // (B, kvh, S, g, 2): m, l
  void* out;               // (B, Hq, hd) contiguous
  long long q_sb, q_sh;
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

  const long long row = (long long)p.kvh * hd;     // elements token to token
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
// and head strides (its last dim contiguous); pages, table, lengths and out
// contiguous.  part_acc: B·kvh·splits·g·hd floats, part_ml:
// B·kvh·splits·g·2.  vec: 1 if hd·sizeof(T) is a multiple of 16 and the
// pages are 16-byte aligned.  stage: 1 the partials, 2 the merge, 3 both.
int roomy_paged_decode(const void* q, const void* k, const void* v,
                       const int* table, const int* lengths, float* part_acc,
                       float* part_ml, void* out, int dtype, int B, int Hq,
                       int kvh, int hd, int ps, int pps, int num_pages,
                       int splits, long long q_sb, long long q_sh, int vec,
                       float scale, float softcap, int stage, void* stream) {
  if (B < 0 || kvh < 1 || Hq % kvh || hd < 1 || hd > 256 || ps < 1 ||
      pps < 1 || splits < 1 || splits > 65535 || kvh > 65535 || B > 65535 ||
      stage < 1 || stage > 3)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Hq == 0) return 0;
  Params p;
  p.q = q; p.k = k; p.v = v; p.table = table; p.lengths = lengths;
  p.part_acc = part_acc; p.part_ml = part_ml; p.out = out;
  p.q_sb = q_sb; p.q_sh = q_sh;
  p.ps = ps; p.kvh = kvh; p.hd = hd; p.g = Hq / kvh; p.pps = pps;
  p.splits = splits; p.num_pages = num_pages; p.vec = vec;
  p.scale = scale; p.softcap = softcap;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return dispatch<float>(p, B, stage, s);
  if (dtype == 1) return dispatch<bf16>(p, B, stage, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
