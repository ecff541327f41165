// Hopper (sm_90a) backward of the selective scan (Mamba): K9-bwd of the
// kernel table.
//
// The TPU kernel it stands beside, repro/kernels/mamba_scan.py:61
// (mamba_scan, pallas_call at :83), has no backward: the reference trains
// its SSMs through the plain scan (kernels="ref") under jax.grad.  The
// port's training path runs K9 on the card, so this kernel gives K9 the
// gradient jax.grad takes through ref.mamba_scan_ref / mamba_scan_seq_ref.
//
// For x, dt (B, L, Di), a (Di, N), b, c (B, L, N), d (Di,), the output's
// gradient dy (B, L, Di) and the forward's states after each chunk of
// CHUNK = 32 steps, h_chunks (B, ceil(L/32), Di, N) float32 (K9 writes them,
// csrc/mamba_scan.cu), with e_t = exp(dt_t[i]·a[i,j]) and h_t = e_t·h_{t-1}
// + dt_t·x_t·b_t[j], the adjoint g_t = dL/dh_t runs backwards in time,
//   g_t = dy_t[i]·c_t[j] + e_{t+1}·g_{t+1},
// and gives
//   dx_t[i]  = sum_j g_t·dt_t·b_t[j] + dy_t[i]·d[i]
//   ddt_t[i] = sum_j g_t·(a·e_t·h_{t-1} + x_t·b_t[j])
//   da[i,j]  = sum_{b,t} g_t·dt_t·e_t·h_{t-1}     dd[i] = sum_{b,t} dy·x
//   db_t[j]  = sum_i g_t·dt_t·x_t                 dc_t[j] = sum_i dy_t·h_t
// dx and ddt in x's dtype, the rest float32.  kernels/ref.py
// (mamba_scan_bwd_plain) is the same walk in plain PyTorch.
//
// What bounds it on an H100: per (t, i, j) one exponential, as the forward,
// and about 16 float32 FMAs (the state's recomputation and the five
// gradient terms); per (t, i) three reads and two writes of a 2-byte value,
// plus the chunk states (4 bytes per (i, j) every 32 steps).  At
// falcon-mamba's train shape (1 x 4096 x 8192 x 16, bf16) that is 5.4e8
// exponentials (0.13 ms at 16 a clock per SM), 8.6e9 FMAs (0.26 ms at
// 67 TFLOP/s) and about 0.4 GB (0.12 ms at 3.35 TB/s).
//
// Design (simple first; a later PR makes it fast):
// * One thread a (channel i, state j) pair, NP = the states padded to a
//   power of two (1..64) threads a channel, CH = 256 / NP channels a block,
//   one batch row a block: at falcon-mamba's Di = 8192, N = 16 that is 512
//   blocks of 256 threads.  Each thread walks all of time backwards, chunk
//   by chunk.
// * A chunk: its states h_t are recomputed from the state before it
//   (h_chunks[k - 1], zeros for the first) into shared memory, one column a
//   thread; then the reverse walk reads them back, carrying g and e_{t+1}
//   in registers across chunk boundaries.
// * Sums over the states of a channel (dx, ddt) go by warp shuffles, and
//   across the two warps of a channel at N > 32 through shared memory.
//   Sums over the channels (db, dc) are taken in shared memory every
//   SUB = 8 steps, in channel order, and each block writes its tile's part
//   to a scratch buffer (tiles, B, L, N).  A second kernel adds the tiles'
//   parts in tile order, and da and dd over the batch rows: a fixed order
//   of sums, so two runs give the same bits.  Atomics were the other way;
//   they would make the order, and the bits, vary from run to run.  The
//   scratch costs 8 bytes per (tile, b, t, state): 268 MB at falcon-mamba's
//   train shape, 2.1 GB at zamba2's K9 form (N = 64, 1 x 4096).
// * No padding: steps past L, channels past Di and states past N read as
//   zeros (dt = 0 gives e = 1 and no input, dy = c = 0 no adjoint), so they
//   add nothing; their outputs are never written.
// * Strided x, dt, b, c (the model passes column slices of one
//   projection); only the last dim must be contiguous.  dy is contiguous.
//
// Plain C interface, loaded with ctypes.  The launches go on the given
// stream, do not synchronise, and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kChunk = 32;            // the forward's chunk (h_chunks)
constexpr int kSub = 8;               // steps between two flushes of the sums
constexpr int kReduceThreads = 256;

struct Params {
  const void *x, *dt, *b, *c, *dy;
  const float *a, *d, *h_chunks;
  void *dx, *ddt;
  float *db_part, *dc_part;           // (tiles, B, L, N)
  float *da_part;                     // (B, Di, N)
  float *dd_part;                     // (B, Di)
  long long x_sb, x_st, dt_sb, dt_st, b_sb, b_st, c_sb, c_st;
  int B, L, Di, N;
};

struct ReduceParams {
  const float *db_part, *dc_part, *da_part, *dd_part;
  float *db, *dc, *da, *dd;
  int tiles, B, L, Di, N;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__device__ __forceinline__ float load(const T* base, long long off, bool ok) {
  return ok ? to_f32(base[off]) : 0.f;
}

template <int NP>
__host__ __device__ constexpr int channels() { return kThreads / NP; }
template <int NP>
__host__ __device__ constexpr int warps_a_channel() {
  return NP > 32 ? NP / 32 : 1;
}
template <int NP>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(float) * ((kChunk + 2 * kSub) * kThreads +
                          2 * kSub * channels<NP>() * warps_a_channel<NP>());
}

// NP threads a channel (one state each), CH = 256 / NP channels a block.
template <typename T, int NP>
__global__ void __launch_bounds__(kThreads) scan_bwd_kernel(Params p) {
  constexpr int CH = channels<NP>();
  constexpr int HW = warps_a_channel<NP>();
  constexpr int LW = NP < 32 ? NP : 32;     // lanes of a channel in a warp
  extern __shared__ __align__(16) float smem[];
  float (*sh)[kThreads] = reinterpret_cast<float (*)[kThreads]>(smem);
  float (*rdb)[kThreads] = sh + kChunk;     // per (step, thread) parts
  float (*rdc)[kThreads] = rdb + kSub;
  float (*rdx)[CH * HW] =
      reinterpret_cast<float (*)[CH * HW]>(smem + (kChunk + 2 * kSub) *
                                           kThreads);
  float (*rddt)[CH * HW] = rdx + kSub;

  const int tid = threadIdx.x;
  const int ch = tid / NP, j = tid % NP;
  const int c0 = blockIdx.x * CH, bi = blockIdx.y;
  const int i = c0 + ch;
  const int L = p.L, Di = p.Di, N = p.N;
  const bool live = i < Di, jok = j < N, on = live && jok;
  const int nch = (L + kChunk - 1) / kChunk;
  const float av = on ? p.a[(long long)i * N + j] : 0.f;

  const T* xi = static_cast<const T*>(p.x) + bi * p.x_sb + (live ? i : 0);
  const T* dti = static_cast<const T*>(p.dt) + bi * p.dt_sb + (live ? i : 0);
  const T* dyi = static_cast<const T*>(p.dy) + (long long)bi * L * Di +
                 (live ? i : 0);
  const T* bj = static_cast<const T*>(p.b) + bi * p.b_sb + (jok ? j : 0);
  const T* cj = static_cast<const T*>(p.c) + bi * p.c_sb + (jok ? j : 0);

  // The flush's thread for channel c0 + tid (tid < CH): its pointers.
  const int fc = c0 + tid;
  const bool flusher = tid < CH && fc < Di;
  const T* fx = static_cast<const T*>(p.x) + bi * p.x_sb + (flusher ? fc : 0);
  const T* fdy = static_cast<const T*>(p.dy) + (long long)bi * L * Di +
                 (flusher ? fc : 0);
  T* fdx = static_cast<T*>(p.dx) + (long long)bi * L * Di + (flusher ? fc : 0);
  T* fddt = static_cast<T*>(p.ddt) + (long long)bi * L * Di +
            (flusher ? fc : 0);
  const float dskip = flusher ? p.d[fc] : 0.f;

  float gn = 0.f, e_next = 1.f;   // g_{t+1} and e_{t+1}
  float da_acc = 0.f, dd_acc = 0.f;
  for (int k = nch - 1; k >= 0; --k) {
    const int t0 = k * kChunk;
    const int len = min(kChunk, L - t0);

    // 1. The chunk's states, recomputed from the state before it.
    const float h_start =
        (k > 0 && on)
            ? p.h_chunks[(((long long)bi * nch + k - 1) * Di + i) * N + j]
            : 0.f;
    float h = h_start;
    for (int r = 0; r < len; ++r) {
      const long long t = t0 + r;
      const float dv = load(dti, t * p.dt_st, live);
      const float xv = load(xi, t * p.x_st, live);
      const float bv = load(bj, t * p.b_st, jok);
      h = fmaf(h, expf(dv * av), dv * xv * bv);
      sh[r][tid] = h;
    }

    // 2. The reverse walk over the chunk; the sums flushed every kSub steps.
    for (int r = kChunk - 1; r >= 0; --r) {
      const int ks = r % kSub;
      if (r < len) {
        const long long t = t0 + r;
        const float dv = load(dti, t * p.dt_st, live);
        const float xv = load(xi, t * p.x_st, live);
        const float dyv = load(dyi, t * Di, live);
        const float bv = load(bj, t * p.b_st, jok);
        const float cv = load(cj, t * p.c_st, jok);
        const float e = expf(dv * av);
        const float g = fmaf(e_next, gn, dyv * cv);
        const float hp = r > 0 ? sh[r - 1][tid] : h_start;
        const float gdt = g * dv;
        float px = gdt * bv;
        float pt = g * fmaf(av * e, hp, xv * bv);
        da_acc = fmaf(gdt * e, hp, da_acc);
        rdb[ks][tid] = gdt * xv;
        rdc[ks][tid] = dyv * sh[r][tid];
#pragma unroll
        for (int off = LW / 2; off > 0; off >>= 1) {
          px += __shfl_xor_sync(0xffffffffu, px, off);
          pt += __shfl_xor_sync(0xffffffffu, pt, off);
        }
        if ((j & 31) == 0) {
          rdx[ks][ch * HW + (j >> 5)] = px;
          rddt[ks][ch * HW + (j >> 5)] = pt;
        }
        gn = g;
        e_next = e;
      }
      if (ks != 0) continue;
      __syncthreads();
      const int tb = t0 + r;
      // A channel's dx and ddt, and its part of dd, steps in order.
      if (flusher) {
        for (int s = 0; s < kSub && tb + s < L; ++s) {
          const long long t = tb + s;
          float sx = 0.f, st = 0.f;
#pragma unroll
          for (int q = 0; q < HW; ++q) {
            sx += rdx[s][tid * HW + q];
            st += rddt[s][tid * HW + q];
          }
          const float dyv = to_f32(fdy[t * Di]);
          store(fdx + t * Di, fmaf(dyv, dskip, sx));
          store(fddt + t * Di, st);
          dd_acc = fmaf(dyv, to_f32(fx[t * p.x_st]), dd_acc);
        }
      }
      // The tile's part of db and dc: each (step, state) over the block's
      // channels, in channel order.
      for (int q = tid; q < kSub * NP; q += kThreads) {
        const int s = q / NP, jj = q % NP;
        if (tb + s >= L || jj >= N) continue;
        float sb = 0.f, sc = 0.f;
#pragma unroll 4
        for (int cc = 0; cc < CH; ++cc) {
          sb += rdb[s][cc * NP + jj];
          sc += rdc[s][cc * NP + jj];
        }
        const long long o =
            (((long long)blockIdx.x * p.B + bi) * L + tb + s) * N + jj;
        p.db_part[o] = sb;
        p.dc_part[o] = sc;
      }
      __syncthreads();
    }
  }
  if (on) p.da_part[((long long)bi * Di + i) * N + j] = da_acc;
  if (flusher) p.dd_part[(long long)bi * Di + fc] = dd_acc;
}

// db and dc: the sum of the tiles' parts, in tile order; da and dd: the
// sum over the batch rows, in order.  One flat index over all four.
__global__ void __launch_bounds__(kReduceThreads)
    scan_bwd_reduce_kernel(ReduceParams p) {
  const long long bln = (long long)p.B * p.L * p.N;
  const long long dn = (long long)p.Di * p.N;
  const long long total = 2 * bln + dn + p.Di;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const float* src;
    float* dst;
    long long step;
    int n;
    if (e < bln) {
      src = p.db_part + e; n = p.tiles; step = bln; dst = p.db + e;
    } else if (e < 2 * bln) {
      const long long o = e - bln;
      src = p.dc_part + o; n = p.tiles; step = bln; dst = p.dc + o;
    } else if (e < 2 * bln + dn) {
      const long long o = e - 2 * bln;
      src = p.da_part + o; n = p.B; step = dn; dst = p.da + o;
    } else {
      const long long o = e - 2 * bln - dn;
      src = p.dd_part + o; n = p.B; step = p.Di; dst = p.dd + o;
    }
    float s = 0.f;
    for (int q = 0; q < n; ++q) s += src[q * step];
    *dst = s;
  }
}

template <typename T, int NP>
int launch(const Params& p, cudaStream_t stream) {
  constexpr int CH = channels<NP>();
  const int smem = (int)smem_bytes<NP>();
  cudaError_t err = cudaFuncSetAttribute(
      scan_bwd_kernel<T, NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.Di + CH - 1) / CH, p.B);
  scan_bwd_kernel<T, NP><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Params& p, int np, cudaStream_t stream) {
  switch (np) {
    case 1: return launch<T, 1>(p, stream);
    case 2: return launch<T, 2>(p, stream);
    case 4: return launch<T, 4>(p, stream);
    case 8: return launch<T, 8>(p, stream);
    case 16: return launch<T, 16>(p, stream);
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

long long tiles_of(int Di, int np) {
  const int ch = kThreads / np;
  return (Di + ch - 1) / ch;
}

}  // namespace

extern "C" {

const char* roomy_msb_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Floats of the scratch buffer a call needs: the tiles' parts of db and
// dc, and the batch rows' parts of da and dd.
long long roomy_mamba_scan_bwd_work(int B, int L, int Di, int N, int np) {
  return 2 * tiles_of(Di, np) * B * L * N + (long long)B * Di * N +
         (long long)B * Di;
}

// dtype 0: float32, 1: bfloat16 (x, dt, b, c, dy, dx and ddt).  strides: 8
// element strides, (batch, time) of x, dt, b and c in that order; the last
// dim of each is contiguous.  dy, dx, ddt: contiguous (B, L, Di).  a:
// (Di, N), d: (Di,), h_chunks: (B, ceil(L/32), Di, N), contiguous float32.
// da (Di, N), db, dc (B, L, N), dd (Di,): float32 outputs.  work:
// roomy_mamba_scan_bwd_work(...) floats.  np: the states padded to a power
// of two, N <= np <= 64.
int roomy_mamba_scan_bwd(const void* x, const void* dt, const float* a,
                         const void* b, const void* c, const float* d,
                         const void* dy, const float* h_chunks, void* dx,
                         void* ddt, float* da, float* db, float* dc,
                         float* dd, float* work, int dtype, int B, int L,
                         int Di, int N, const long long* strides, int np,
                         void* stream) {
  if (B < 1 || L < 1 || Di < 1 || N < 1 || N > np || np > 64 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  const long long tiles = tiles_of(Di, np);
  const long long part = tiles * B * L * N;
  Params p;
  p.x = x; p.dt = dt; p.b = b; p.c = c; p.dy = dy;
  p.a = a; p.d = d; p.h_chunks = h_chunks;
  p.dx = dx; p.ddt = ddt;
  p.db_part = work;
  p.dc_part = work + part;
  p.da_part = work + 2 * part;
  p.dd_part = work + 2 * part + (long long)B * Di * N;
  p.x_sb = strides[0]; p.x_st = strides[1];
  p.dt_sb = strides[2]; p.dt_st = strides[3];
  p.b_sb = strides[4]; p.b_st = strides[5];
  p.c_sb = strides[6]; p.c_st = strides[7];
  p.B = B; p.L = L; p.Di = Di; p.N = N;
  cudaStream_t s = (cudaStream_t)stream;
  int err;
  if (dtype == 0) err = dispatch<float>(p, np, s);
  else if (dtype == 1) err = dispatch<bf16>(p, np, s);
  else return (int)cudaErrorInvalidValue;
  if (err) return err;
  ReduceParams r;
  r.db_part = p.db_part; r.dc_part = p.dc_part;
  r.da_part = p.da_part; r.dd_part = p.dd_part;
  r.db = db; r.dc = dc; r.da = da; r.dd = dd;
  r.tiles = (int)tiles; r.B = B; r.L = L; r.Di = Di; r.N = N;
  const long long total = 2 * (long long)B * L * N + (long long)Di * N + Di;
  const long long blocks = (total + kReduceThreads - 1) / kReduceThreads;
  scan_bwd_reduce_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096),
                           kReduceThreads, 0, s>>>(r);
  return (int)cudaGetLastError();
}

}  // extern "C"
