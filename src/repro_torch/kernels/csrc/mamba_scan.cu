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
// is written as float32 (B, Di, N) (the prefill's decode state), and with
// an h_chunks pointer the state after each chunk of CHUNK = 32 steps as
// float32 (B, ceil(L/32), Di, N) (the residual the backward kernel,
// mamba_scan_bwd.cu, recomputes each chunk's states from; y is the same
// bits with or without it).
//
// What bounds it on an H100: per (t, i, j) one exponential and about four
// float32 FMAs; per (t, i) two reads and one write of a 2-byte value.  At
// the falcon-mamba prefill (L = 32768, Di = 8192, N = 16, bf16) that is
// 1.61 GB (0.48 ms at 3.35 TB/s), 1.7e10 FMAs (0.51 ms at 67 TFLOP/s) and
// 4.3e9 exponentials, which the special-function units take at 16 per
// clock per SM (about 1 ms at 1.98 GHz): the exponentials bind.
//
// Design.  The TPU kernel walks time as the sequential grid axis with h in
// VMEM scratch.  Walking all of time in one thread per (channel, state
// group) leaves about 8 warps on an SM, too few to hide each step's chain
// of shared loads, exponential and dependent multiply-add.  So time is
// also split across the threads of a block, in the structure of the
// published Mamba selective-scan kernel (Gu & Dao, arXiv:2312.00752,
// §3.3), transposed to this layout (Di contiguous, time strided):
// * A block owns (CH channels, one batch row) and all of time; each of its
//   256 threads owns (a channel, a group of SPT = 4 states, one of SEG = 4
//   time segments).  TPC = ceil(N/4) threads (a power of two, N <= 64)
//   share a channel, CH = 64 / TPC channels a block.  At falcon-mamba's
//   Di = 8192, N = 16 that is 512 blocks, two an SM (16 warps) with up to
//   128 registers a thread: fewer, fatter warps ran faster here than four
//   blocks an SM at 64 registers, which spilled.
// * Time goes in chunks of CHUNK = SEG x SEG_LEN = 32 steps, staged in
//   shared memory as float32 with coalesced loads (x and dt for the
//   block's channels, b and c for all states).  Each thread's staged
//   elements keep their place from chunk to chunk, so their pointers step
//   a chunk at a time and no index is recomputed; the next chunk's loads
//   are issued into registers before a chunk's walks and staged after
//   them, so their latency hides behind the work.  Each thread then:
//   1. walks its segment's SEG_LEN = 8 steps from h = 0, composing their
//      affine maps h -> e·h + u, with e = exp(dt·a) and u = dt·x·b: the
//      composition (P1, B1) then (P2, B2) is (P1·P2, P2·B1 + B2),
//      associative.  On the way it forms its part of y_t from B_t (with
//      d·x_t in the first state group) and keeps the weights c_t[j]·P_t[j]
//      in registers: one exponential per (t, i, j), none computed twice.
//      It writes its segment's (P, B) to shared memory.
//   2. the first segment's thread of each (channel, state group) folds the
//      chunk's segments in time order from the state carried in from the
//      last chunk: the fold up to a segment is that segment's prefix h_in,
//      handed over in shared memory, and the fold over all of them is the
//      carry to the next chunk.
//   3. adds sum_j c_t[j]·P_t[j]·h_in[j] to each of its parts of y_t.
//   A last pass adds each channel's TPC parts of y in a fixed order and
//   stores y coalesced.  The order of the sums is the mirror's in
//   kernels/ref.py (`mamba_scan_segmented`): the kernel's h is no longer
//   the sequential plain version's bits, and agrees with it within the
//   float32 tolerance.
// * The exponential is expf of dt·a, the plain version's: ex2.approx of a
//   product pre-scaled by log2 e was tried and drifts from it by 3e-4 in
//   h over 2048 steps of slow decay (the float32 limit is 1e-4 abs +
//   rel).  The updates may contract to FMAs (one rounding per step
//   instead of two, a drift of a few ulp).
// * No padding: the ragged time tail, channels past Di and states past N
//   are staged as zeros (dt = 0 gives e = 1 and u = 0, so a padded step
//   leaves h as it was; a masked state has b = c = 0 and stays 0).
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

constexpr int kSPT = 4;               // states a thread
constexpr int kSeg = 4;               // time segments of a chunk
constexpr int kSegLen = 8;            // steps a segment
constexpr int kChunk = kSeg * kSegLen;
constexpr int kLanes = 64;            // (channel, state group) pairs a block
constexpr int kThreads = kLanes * kSeg;
constexpr int kBlocksPerSM = 2;

struct Params {
  const void *x, *dt, *b, *c;
  const float *a, *d;
  void* y;
  float* h_last;
  float* h_chunks;
  long long x_sb, x_st, dt_sb, dt_st, b_sb, b_st, c_sb, c_st;
  int L, Di, N;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ bf16 zero<bf16>() {
  return __float2bfloat16(0.f);
}

__device__ __forceinline__ void to_array(const float4& v, float (&o)[kSPT]) {
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}

// TPC threads a channel, CH = kLanes / TPC channels a block.  kChunks:
// the instantiation that writes h_chunks (training's forward); serving's
// (false) is the kernel without it, register for register.
template <typename T, int TPC, bool kChunks>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    scan_seg_kernel(Params p) {
  constexpr int CH = kLanes / TPC;
  constexpr int NP = TPC * kSPT;                        // padded states
  constexpr int NX = kChunk * CH, NB = kChunk * NP;     // staged a chunk
  constexpr int RX = (NX + kThreads - 1) / kThreads;    // x/dt a thread
  constexpr int RB = (NB + kThreads - 1) / kThreads;    // b/c a thread
  constexpr int RY = (NX + kThreads - 1) / kThreads;    // y a thread
  __shared__ float sx[kChunk][CH], sdt[kChunk][CH];
  __shared__ __align__(16) float sb[kChunk][NP];
  __shared__ __align__(16) float sc[kChunk][NP];
  __shared__ __align__(16) float4 sA[kSeg][kLanes];     // segment maps
  __shared__ __align__(16) float4 sB[kSeg][kLanes];
  __shared__ __align__(16) float sy[kChunk][kLanes];    // parts of y

  const int tid = threadIdx.x;
  const int lane = tid % kLanes, seg = tid / kLanes;
  const int ch = lane / TPC, sub = lane % TPC;
  const int c0 = blockIdx.x * CH;
  const int bi = blockIdx.y;
  const int i = c0 + ch;
  const bool live = i < p.Di;
  const int L = p.L, Di = p.Di, N = p.N;

  float av[kSPT], H[kSPT];     // a; the state carried into a chunk
#pragma unroll
  for (int s = 0; s < kSPT; ++s) {
    const int j = sub * kSPT + s;
    av[s] = (live && j < N) ? p.a[(long long)i * N + j] : 0.f;
    H[s] = 0.f;
  }
  // D·x joins the part of y of the channel's first state group only.
  const float dskip = (live && sub == 0) ? p.d[i] : 0.f;

  // This thread's staged elements keep their place in every chunk: their
  // pointers step a chunk at a time, and the time tail is the only check
  // that moves (a column past Di or N is dead for good).
  const T* gx[RX];
  const T* gdt[RX];
  int rx_t[RX];
  bool rx_ok[RX];
#pragma unroll
  for (int r = 0; r < RX; ++r) {
    const int k = tid + r * kThreads, t = k / CH, cc = c0 + k % CH;
    rx_t[r] = t;
    rx_ok[r] = k < NX && cc < Di;
    gx[r] = static_cast<const T*>(p.x) + bi * p.x_sb + t * p.x_st + cc;
    gdt[r] = static_cast<const T*>(p.dt) + bi * p.dt_sb + t * p.dt_st + cc;
  }
  const T* gb[RB];
  const T* gc[RB];
  int rb_t[RB];
  bool rb_ok[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    const int k = tid + r * kThreads, t = k / NP, j = k % NP;
    rb_t[r] = t;
    rb_ok[r] = k < NB && j < N;
    gb[r] = static_cast<const T*>(p.b) + bi * p.b_sb + t * p.b_st + j;
    gc[r] = static_cast<const T*>(p.c) + bi * p.c_sb + t * p.c_st + j;
  }
  const long long step_x = kChunk * p.x_st, step_dt = kChunk * p.dt_st;
  const long long step_b = kChunk * p.b_st, step_c = kChunk * p.c_st;

  // A chunk's inputs, raw, zeros past L, Di and N: loaded into registers
  // one chunk ahead, converted and staged after the current chunk's walks.
  T rx[RX], rdt[RX], rb[RB], rc[RB];
  auto load = [&](int t0) {
#pragma unroll
    for (int r = 0; r < RX; ++r) {
      const bool ok = rx_ok[r] && t0 + rx_t[r] < L;
      rx[r] = ok ? *gx[r] : zero<T>();
      rdt[r] = ok ? *gdt[r] : zero<T>();
      gx[r] += step_x;
      gdt[r] += step_dt;
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const bool ok = rb_ok[r] && t0 + rb_t[r] < L;
      rb[r] = ok ? *gb[r] : zero<T>();
      rc[r] = ok ? *gc[r] : zero<T>();
      gb[r] += step_b;
      gc[r] += step_c;
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int r = 0; r < RX; ++r) {
      const int k = tid + r * kThreads;
      if (k < NX) {
        (&sx[0][0])[k] = to_f32(rx[r]);
        (&sdt[0][0])[k] = to_f32(rdt[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int k = tid + r * kThreads;
      if (k < NB) {
        (&sb[0][0])[k] = to_f32(rb[r]);
        (&sc[0][0])[k] = to_f32(rc[r]);
      }
    }
  };

  // This thread's rows of the staged chunk and of the parts of y.
  const int ts = seg * kSegLen;
  const float* xs = &sx[ts][ch];
  const float* dts = &sdt[ts][ch];
  const float4* bs4 = reinterpret_cast<const float4*>(&sb[ts][sub * kSPT]);
  const float4* cs4 = reinterpret_cast<const float4*>(&sc[ts][sub * kSPT]);
  float* ys = &sy[ts][lane];
  // The y elements this thread adds up and stores, as x's staged ones.
  T* gy[RY];
  const long long step_y = (long long)kChunk * Di;
#pragma unroll
  for (int r = 0; r < RY; ++r) {
    const int k = tid + r * kThreads;
    gy[r] = static_cast<T*>(p.y) + ((long long)bi * L + k / CH) * Di + c0 +
            k % CH;
  }

  load(0);
  stage();
  __syncthreads();
  for (int t0 = 0; t0 < L; t0 += kChunk) {
    if (t0 + kChunk < L) load(t0 + kChunk);

    // 1. The segment's walk from h = 0: its composed map (P, B) (P the
    // product of the decays, B the state), its part of y_t from B, and
    // the weights c_t[j]·P_t[j] by which its prefix adds to y_t.
    float cP[kSegLen][kSPT], yB[kSegLen], P[kSPT], B[kSPT];
#pragma unroll
    for (int s = 0; s < kSPT; ++s) {
      P[s] = 1.f;
      B[s] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < kSegLen; ++k) {
      const float dv = dts[k * CH];
      const float xv = xs[k * CH];
      const float dtx = dv * xv;
      float bv[kSPT], cv[kSPT];
      to_array(bs4[k * NP / 4], bv);
      to_array(cs4[k * NP / 4], cv);
      float acc = dskip * xv;
#pragma unroll
      for (int s = 0; s < kSPT; ++s) {
        const float e = expf(dv * av[s]);
        P[s] *= e;
        B[s] = fmaf(B[s], e, dtx * bv[s]);
        acc = fmaf(cv[s], B[s], acc);
        cP[k][s] = cv[s] * P[s];
      }
      yB[k] = acc;
    }
    sA[seg][lane] = make_float4(P[0], P[1], P[2], P[3]);
    sB[seg][lane] = make_float4(B[0], B[1], B[2], B[3]);
    __syncthreads();

    // 2. The fold of the chunk's segments in time order from the carried
    // state, by the first segment's threads: segment q's prefix replaces
    // its map in sA, and the fold over all of them is the next carry.
    if (seg == 0) {
#pragma unroll
      for (int q = 0; q < kSeg; ++q) {
        float Aq[kSPT], Bq[kSPT];
        to_array(sA[q][lane], Aq);
        to_array(sB[q][lane], Bq);
        sA[q][lane] = make_float4(H[0], H[1], H[2], H[3]);
#pragma unroll
        for (int s = 0; s < kSPT; ++s) H[s] = fmaf(Aq[s], H[s], Bq[s]);
      }
      // The carry is the state after this chunk's last step.
      if (kChunks && live) {
        float* hc = p.h_chunks +
                    (((long long)bi * ((L + kChunk - 1) / kChunk) +
                      t0 / kChunk) * Di + i) * N;
#pragma unroll
        for (int s = 0; s < kSPT; ++s) {
          const int j = sub * kSPT + s;
          if (j < N) hc[j] = H[s];
        }
      }
    }
    __syncthreads();

    // 3. y_t's part: yB_t + sum_j c_t[j]·P_t[j]·h_in[j].
    float hin[kSPT];
    to_array(sA[seg][lane], hin);
#pragma unroll
    for (int k = 0; k < kSegLen; ++k) {
      float acc = yB[k];
#pragma unroll
      for (int s = 0; s < kSPT; ++s) acc = fmaf(cP[k][s], hin[s], acc);
      ys[k * kLanes] = acc;
    }
    __syncthreads();

    // y = the sum of each channel's TPC parts, in order; coalesced stores.
#pragma unroll
    for (int r = 0; r < RY; ++r) {
      const int k = tid + r * kThreads;
      const int t = k / CH, cc = k % CH;
      const float* part = &sy[t][cc * TPC];
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
      if (k < NX && t0 + t < L && c0 + cc < Di) store(gy[r], v);
      gy[r] += step_y;
    }
    if (t0 + kChunk < L) stage();
    __syncthreads();
  }
  if (live && seg == 0 && p.h_last != nullptr) {
    float* hl = p.h_last + ((long long)bi * Di + i) * N;
#pragma unroll
    for (int s = 0; s < kSPT; ++s) {
      const int j = sub * kSPT + s;
      if (j < N) hl[j] = H[s];
    }
  }
}

template <typename T, int TPC>
void launch(const Params& p, int B, cudaStream_t stream) {
  constexpr int CH = kLanes / TPC;
  dim3 grid((p.Di + CH - 1) / CH, B);
  if (p.h_chunks != nullptr)
    scan_seg_kernel<T, TPC, true><<<grid, kThreads, 0, stream>>>(p);
  else
    scan_seg_kernel<T, TPC, false><<<grid, kThreads, 0, stream>>>(p);
}

template <typename T>
int dispatch(const Params& p, int B, int tpc, cudaStream_t stream) {
  if (tpc == 1) launch<T, 1>(p, B, stream);
  else if (tpc == 2) launch<T, 2>(p, B, stream);
  else if (tpc == 4) launch<T, 4>(p, B, stream);
  else if (tpc == 8) launch<T, 8>(p, B, stream);
  else if (tpc == 16) launch<T, 16>(p, B, stream);
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
// contiguous (B, L, Di).  h_last: nullptr, or B·Di·N floats.  h_chunks:
// nullptr, or B·ceil(L/32)·Di·N floats (the state after each chunk).  tpc: the
// threads a channel (mamba_scan.py `geometry`): a power of two <= 16 with
// 4·tpc >= N.
int roomy_mamba_scan(const void* x, const void* dt, const float* a,
                     const void* b, const void* c, const float* d, void* y,
                     float* h_last, float* h_chunks, int dtype, int B, int L,
                     int Di, int N,
                     const long long* strides, int tpc, void* stream) {
  if (B < 0 || L < 0 || Di < 0 || N < 1 || N > kSPT * tpc || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Di == 0) return 0;
  Params p;
  p.x = x; p.dt = dt; p.b = b; p.c = c; p.a = a; p.d = d; p.y = y;
  p.h_last = h_last;
  p.h_chunks = h_chunks;
  p.x_sb = strides[0]; p.x_st = strides[1];
  p.dt_sb = strides[2]; p.dt_st = strides[3];
  p.b_sb = strides[4]; p.b_st = strides[5];
  p.c_sb = strides[6]; p.c_st = strides[7];
  p.L = L; p.Di = Di; p.N = N;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return dispatch<float>(p, B, tpc, s);
  if (dtype == 1) return dispatch<bf16>(p, B, tpc, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
