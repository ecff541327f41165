// Hopper (sm_90a) selective scan (Mamba): K9 of the kernel table.
//
// Replaces the Pallas TPU kernel of repro/kernels/mamba_scan.py:
//   mamba_scan (mamba_scan.py:61, pallas_call at :83), kernel body
//   _scan_kernel (:36).
//
// It computes, for x, dt (B, L, Di), a (Di, N), b, c (B, L, N), d (Di,),
// per (batch, channel i, state j), with h = 0 before step 0:
//   h[i,j] <- exp(dt_t[i]·a[i,j])·h[i,j] + (dt_t[i]·x_t[i])·b_t[j]
//   y_t[i]  = sum_j c_t[j]·h[i,j] + d[i]·x_t[i]
// x, dt, b, c are read in their dtype (float32 or bfloat16, one dtype for
// all four), a and d in float32; h and every sum are float32; y is written
// in x's dtype, contiguous (B, L, Di); with an h_last pointer the final h
// is written as float32 (B, Di, N) (the prefill's decode state).
//
// What bounds it on an H100: per (t, i, j) one exponential and about four
// float32 FMAs; per (t, i) two reads and one write of a 2-byte value.  At
// the falcon-mamba prefill (L = 32768, Di = 8192, N = 16, bf16) that is
// 1.61 GB (0.48 ms at 3.35 TB/s), 1.7e10 FMAs (0.51 ms at 67 TFLOP/s) and
// 4.3e9 exponentials, which the special-function units take at 16 per
// clock per SM (about 1 ms at 1.98 GHz): the exponentials bind.
//
// Design, simple and right first.  The TPU kernel walks time as the
// sequential grid axis with h in VMEM scratch; here nothing carries across
// blocks, so one block owns (a tile of channels, one batch row) and loops
// over all of time itself, with h in registers:
// * Each channel's N states are split over TPC threads of SPT = 4 states
//   (TPC = next power of two of ceil(N/4), so N <= 64): four exponentials
//   per thread and step, independent of each other and of h, and TPC times
//   more threads than one per channel (at batch 1, Di = 8192 gives 256
//   warps with one thread a channel, under two a SM; with TPC = 4, 1024).
// * y's sum over the states is taken after each chunk: every thread writes
//   its partial sum of each step to shared memory and one pass adds the
//   TPC partials, so no shuffle sits in the chain from one step to the
//   next (a first version that shuffled every step was slower).
// * The state update is the plain version's arithmetic, rounding for
//   rounding: expf of the same product dt·a, then h·exp and (dt·x)·b each
//   rounded and added (no FMA contraction).  So h is the same bits as
//   ref.mamba_scan_seq_stateful's on the card, and the float32 tolerance
//   holds over any length; y's sum over the states is taken in another
//   order.  ex2.approx of a pre-scaled product costs fewer instructions,
//   but lets h drift from the plain version over long runs of decay near
//   1; it is the first lever for a faster kernel.
// * Time goes in chunks of CHUNK steps staged in shared memory as float32:
//   x and dt for the block's channels, b and c for all states.  The next
//   chunk's global loads are issued into registers before the current
//   chunk is computed and converted only after it, so their latency hides
//   behind it; y goes through shared memory so that its global stores are
//   coalesced.
// * No padding: the ragged time tail, channels past Di and states past N
//   are masked (masked states get a = b = c = 0, so h stays 0 and adds 0).
// * Strided x, dt, b, c (the model passes column slices of one
//   projection); only the last dim must be contiguous.
//
// Plain C interface, loaded with ctypes.  The launch goes on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;
constexpr int kSPT = 4;             // states per thread

struct Params {
  const void *x, *dt, *b, *c;
  const float *a, *d;
  void* y;
  float* h_last;
  long long x_sb, x_st, dt_sb, dt_st, b_sb, b_st, c_sb, c_st;
  int L, Di, N;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ bf16 zero<bf16>() {
  return __float2bfloat16(0.f);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

// TPC threads per channel; CH channels per block; CHUNK time steps staged.
template <typename T, int TPC>
__global__ void __launch_bounds__(kThreads) scan_kernel(Params p) {
  constexpr int CH = kThreads / TPC;
  constexpr int NP = TPC * kSPT;                       // padded states
  constexpr int CHUNK = (2048 / CH) < 32 ? (2048 / CH) : 32;
  constexpr int RX = (CHUNK * CH + kThreads - 1) / kThreads;   // x/dt loads
  constexpr int RB = (CHUNK * NP + kThreads - 1) / kThreads;   // b/c loads
  __shared__ float sx[CHUNK][CH], sdt[CHUNK][CH];
  __shared__ __align__(16) float sb[CHUNK][NP];
  __shared__ __align__(16) float sc[CHUNK][NP];
  __shared__ __align__(16) float sy[CHUNK][CH][TPC];   // partial sums of y

  const int tid = threadIdx.x;
  const int ch = tid / TPC, sub = tid % TPC;
  const int c0 = blockIdx.x * CH;
  const int bi = blockIdx.y;
  const int i = c0 + ch;
  const bool live = i < p.Di;
  const int L = p.L, Di = p.Di, N = p.N;

  const T* x = static_cast<const T*>(p.x) + bi * p.x_sb;
  const T* dt = static_cast<const T*>(p.dt) + bi * p.dt_sb;
  const T* bm = static_cast<const T*>(p.b) + bi * p.b_sb;
  const T* cm = static_cast<const T*>(p.c) + bi * p.c_sb;
  T* y = static_cast<T*>(p.y) + (long long)bi * L * Di;

  float av[kSPT], h[kSPT];
#pragma unroll
  for (int s = 0; s < kSPT; ++s) {
    const int j = sub * kSPT + s;
    av[s] = (live && j < N) ? p.a[(long long)i * N + j] : 0.f;
    h[s] = 0.f;
  }
  // D·x joins the partial sum of the channel's first thread only.
  const float dskip = (live && sub == 0) ? p.d[i] : 0.f;

  // The next chunk, raw: converted only when staged, after the current
  // chunk's steps, so the loads are not waited for before them.
  T rx[RX], rdt[RX], rb[RB], rc[RB];
  auto load = [&](int t0) {
#pragma unroll
    for (int r = 0; r < RX; ++r) {
      const int k = tid + r * kThreads;
      const int t = t0 + k / CH, cc = c0 + k % CH;
      if (k < CHUNK * CH && t < L && cc < Di) {
        rx[r] = x[t * p.x_st + cc];
        rdt[r] = dt[t * p.dt_st + cc];
      } else {
        rx[r] = rdt[r] = zero<T>();
      }
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int k = tid + r * kThreads;
      const int t = t0 + k / NP, j = k % NP;
      if (k < CHUNK * NP && t < L && j < N) {
        rb[r] = bm[t * p.b_st + j];
        rc[r] = cm[t * p.c_st + j];
      } else {
        rb[r] = rc[r] = zero<T>();
      }
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int r = 0; r < RX; ++r) {
      const int k = tid + r * kThreads;
      if (k < CHUNK * CH) {
        sx[k / CH][k % CH] = to_f32(rx[r]);
        sdt[k / CH][k % CH] = to_f32(rdt[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int k = tid + r * kThreads;
      if (k < CHUNK * NP) {
        sb[k / NP][k % NP] = to_f32(rb[r]);
        sc[k / NP][k % NP] = to_f32(rc[r]);
      }
    }
  };

  load(0);
  stage();
  __syncthreads();
  for (int t0 = 0; t0 < L; t0 += CHUNK) {
    const int steps = min(CHUNK, L - t0);
    if (t0 + CHUNK < L) load(t0 + CHUNK);
    // The steps: h carries from one to the next; the partial sums of y do
    // not, so nothing but h's FMA chains one step to the next.
#pragma unroll 4
    for (int t = 0; t < steps; ++t) {
      const float xv = sx[t][ch], dv = sdt[t][ch];
      const float dtx = __fmul_rn(dv, xv);
      const float4 bv = *reinterpret_cast<const float4*>(&sb[t][sub * kSPT]);
      const float4 cv = *reinterpret_cast<const float4*>(&sc[t][sub * kSPT]);
      const float bs[kSPT] = {bv.x, bv.y, bv.z, bv.w};
      const float cs[kSPT] = {cv.x, cv.y, cv.z, cv.w};
      float acc = dskip * xv;
#pragma unroll
      for (int s = 0; s < kSPT; ++s) {
        h[s] = __fadd_rn(__fmul_rn(h[s], expf(__fmul_rn(dv, av[s]))),
                         __fmul_rn(dtx, bs[s]));
        acc = fmaf(h[s], cs[s], acc);
      }
      sy[t][ch][sub] = acc;
    }
    __syncthreads();
    // y = the sum of each channel's TPC partial sums; coalesced stores.
    for (int k = tid; k < steps * CH; k += kThreads) {
      const int cc = c0 + k % CH;
      const float* part = sy[k / CH][k % CH];
      float v = 0.f;
      if constexpr (TPC % 4 == 0) {
#pragma unroll
        for (int s = 0; s < TPC; s += 4) {
          const float4 q = *reinterpret_cast<const float4*>(part + s);
          v += (q.x + q.y) + (q.z + q.w);
        }
      } else {
#pragma unroll
        for (int s = 0; s < TPC; ++s) v += part[s];
      }
      if (cc < Di) store(&y[(long long)(t0 + k / CH) * Di + cc], v);
    }
    if (t0 + CHUNK < L) stage();
    __syncthreads();
  }
  if (live && p.h_last != nullptr) {
    float* hl = p.h_last + ((long long)bi * Di + i) * N;
#pragma unroll
    for (int s = 0; s < kSPT; ++s) {
      const int j = sub * kSPT + s;
      if (j < N) hl[j] = h[s];
    }
  }
}

template <typename T, int TPC>
void launch(const Params& p, int B, cudaStream_t stream) {
  constexpr int CH = kThreads / TPC;
  dim3 grid((p.Di + CH - 1) / CH, B);
  scan_kernel<T, TPC><<<grid, kThreads, 0, stream>>>(p);
}

template <typename T>
int dispatch(const Params& p, int B, cudaStream_t stream) {
  const int tpc = (p.N + kSPT - 1) / kSPT;
  if (tpc <= 1) launch<T, 1>(p, B, stream);
  else if (tpc <= 2) launch<T, 2>(p, B, stream);
  else if (tpc <= 4) launch<T, 4>(p, B, stream);
  else if (tpc <= 8) launch<T, 8>(p, B, stream);
  else if (tpc <= 16) launch<T, 16>(p, B, stream);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* roomy_ms_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// dtype 0: float32, 1: bfloat16 (x, dt, b, c and y).  strides: 8 element
// strides, (batch, time) of x, dt, b and c in that order; the last dim of
// each is contiguous.  a: (Di, N) and d: (Di,) contiguous float32.  y:
// contiguous (B, L, Di).  h_last: nullptr, or B·Di·N floats.
int roomy_mamba_scan(const void* x, const void* dt, const float* a,
                     const void* b, const void* c, const float* d, void* y,
                     float* h_last, int dtype, int B, int L, int Di, int N,
                     const long long* strides, void* stream) {
  if (B < 0 || L < 0 || Di < 0 || N < 1 || N > 16 * kSPT || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Di == 0) return 0;
  Params p;
  p.x = x; p.dt = dt; p.b = b; p.c = c; p.a = a; p.d = d; p.y = y;
  p.h_last = h_last;
  p.x_sb = strides[0]; p.x_st = strides[1];
  p.dt_sb = strides[2]; p.dt_st = strides[3];
  p.b_sb = strides[4]; p.b_st = strides[5];
  p.c_sb = strides[6]; p.c_st = strides[7];
  p.L = L; p.Di = Di; p.N = N;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return dispatch<float>(p, B, s);
  if (dtype == 1) return dispatch<bf16>(p, B, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
