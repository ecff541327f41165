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
// (mamba_scan_bwd_plain) is the same function walked step by step in plain
// PyTorch; mamba_scan_bwd_segmented is this kernel's order of sums.
//
// What bounds it on an H100: per (t, i, j) one exponential, as the forward,
// and about 10 float32 FMAs (the state's recomputation, the adjoint and
// the gradient terms); per (t, i) three reads and two writes of a 2-byte
// value, plus the chunk states (4 bytes per (i, j) every 32 steps).  At
// falcon-mamba's train shape (1 x 4096 x 8192 x 16, bf16) that is 5.4e8
// exponentials (0.13 ms at 16 a clock per SM), 5.4e9 FMAs (0.16 ms at
// 67 TFLOP/s) and about 0.4 GB (0.12 ms at 3.35 TB/s).
//
// Design.  The first port walked all of time in one thread per (channel,
// state), with global loads inside each step and a serial flush of the
// sums every 8 steps: one long chain of dependent loads a thread, about
// 37x its bound.  This one splits time across the threads of a block as
// K9's forward does (csrc/mamba_scan.cu), since both h and the adjoint are
// affine in their carry:
// * A block owns (CH channels, one batch row) and all of time; each of its
//   256 threads owns (a channel, a group of SPT = 4 states, one of SEG = 4
//   segments of SEG_LEN = 8 steps of a chunk).  TPC = NP / 4 threads share
//   a channel (NP: N padded to a power of two, at least 4), CH = 64 / TPC
//   channels a block.  At falcon-mamba's Di = 8192, N = 16: 512 blocks of
//   16 channels, two an SM (111.5 KB of shared memory each, 128 registers
//   a thread); other N one an SM.
// * The chunks are walked in reverse.  A chunk's x, dt, dy (CH x 32), b, c
//   (32 x NP) and start state h_chunks[k - 1] (CH x NP) are staged in
//   shared memory as float32, in one of two stages: the loads of the chunk
//   before it are issued into registers as a chunk begins and stored into
//   the other stage after its first walk, so their latency hides behind
//   that walk and no global load is left inside a walk.  The adjoint's
//   carry between chunks stays in shared memory, which keeps falcon's
//   instantiation within 128 registers.  The inputs are
//   column slices of one projection at any alignment, so the loads are of
//   one element, coalesced: 11 a thread a chunk at falcon's shape.
// * Each thread, over its segment:
//   1. walks forward from h = 0, keeping e_t (the chunk's one exponential
//      per (t, i, j)) in registers and composing the segment's two affine
//      maps: the state's, h_out = P·h_in + B (P the product of the decays),
//      and the adjoint's, w_out = P·w_in + G with G = sum_t P_t·dy_t·c_t
//      (P_t the product of the decays up to step t), where w is what flows
//      into a segment from the step after it: e_{t+1}·g_{t+1}.
//   2. Two groups of 64 threads fold the chunk's segments: the first in
//      time order from the staged start state (the fold up to a segment is
//      its h_in), the second in reverse from the adjoint carried in from
//      the later chunk (the fold down to a segment is its w_in; the fold
//      over all of them is the carry to the chunk before).  The other 128
//      threads meanwhile sum the later chunk's db and dc over the cluster
//      (below).
//   3. walks forward again from h_in with its e_t: e_t·h_{t-1} in
//      registers (both gradient terms that read the state before a step
//      read it so), and dc's terms dy_t·h_t.
//   4. walks back from w_in: g_t exact within the segment, dx's and ddt's
//      terms summed over the channel's TPC threads by shuffles, da in
//      registers, db's terms g_t·dt_t·x_t.
// * The order of sums is the mirror's (ref.mamba_scan_bwd_segmented): the
//   segment folds of h and of the adjoint are no longer the sequential
//   walk's bits, and agree with it within float32 rounding (3.7e-6 per
//   output at decay near 1 over 4101 steps, against a limit of 1e-5).
// * No serial flush: at a chunk's end every thread stores its share of the
//   chunk's dx and ddt (CH x 32) coalesced and adds its dd terms, and sums
//   db's and dc's terms (one a (t, i, j), in shared memory) over the
//   block's channels in channel order.
// * db and dc through a thread-block cluster.  The grid is a multiple of
//   the cluster, CL = 8 blocks (fewer when the channel tiles are fewer)
//   on neighbouring channel tiles of one batch row; blocks past Di add
//   zeros.  Each rank sums its slice of the cluster's block sums of a
//   chunk over the ranks, in rank order, through distributed shared
//   memory, and writes the cluster's part to scratch (clusters, B, L, N):
//   8x less than one part a tile, 33.5 MB at falcon's shape (268 MB at
//   zamba2's N = 64).  The block sums have two buffers by chunk parity and
//   the cluster's barrier is split: a block arrives at a chunk's end and
//   waits during the next chunk's fold, just before it reads the sums, so
//   the barrier's latency hides behind the next chunk's first walk.
//   (Taking the block sums and the stores of dx and ddt into that window
//   too, for two block barriers a chunk instead of three, ran slower.)  A
//   second kernel adds the clusters' parts in cluster order, and da and dd
//   over the batch rows.  No atomics: two launches give the same bits.
//   The cluster was chosen over a persistent walk of tiles per block
//   because it keeps a block's channels and the time split as they are.
// * The exponential is expf (ex2.approx drifted K9's h past its limit).
// * No padding: steps past L, channels past Di and states past N are
//   staged as zeros (dt = 0 gives e = 1 and no input, dy = c = 0 no
//   adjoint), so they add nothing; their outputs are never written.
// * Strided x, dt, b, c (the model passes column slices of one
//   projection); only the last dim must be contiguous.  dy is contiguous.
//
// Plain C interface, loaded with ctypes.  The launches go on the given
// stream, do not synchronise, and return cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kSPT = 4;               // states a thread
constexpr int kSeg = 4;               // time segments of a chunk
constexpr int kSegLen = 8;            // steps a segment
constexpr int kChunk = kSeg * kSegLen;  // the forward's chunk (h_chunks)
constexpr int kLanes = 64;            // (channel, state group) pairs a block
constexpr int kThreads = kLanes * kSeg;
constexpr int kCluster = 8;           // blocks of a cluster, at most
constexpr int kReduceThreads = 256;

struct Params {
  const void *x, *dt, *b, *c, *dy;
  const float *a, *d, *h_chunks;
  void *dx, *ddt;
  float *db_part, *dc_part;           // (clusters, B, L, N)
  float *da_part;                     // (B, Di, N)
  float *dd_part;                     // (B, Di)
  long long x_sb, x_st, dt_sb, dt_st, b_sb, b_st, c_sb, c_st;
  int B, L, Di, N;
};

struct ReduceParams {
  const float *db_part, *dc_part, *da_part, *dd_part;
  float *db, *dc, *da, *dd;
  int clusters, B, L, Di, N;
};

// The block's shared memory, TPC threads a channel.
template <int TPC>
struct Smem {
  static constexpr int CH = kLanes / TPC;
  static constexpr int NP = TPC * kSPT;
  static constexpr int ROW = kChunk * NP + 4;   // padded: no bank conflicts
  // The segments' maps (P; B, then h_in; G, then w_in), per (seg, lane).
  float4 P[kSeg][kLanes], Bh[kSeg][kLanes], G[kSeg][kLanes];
  float4 W[kLanes];                   // the adjoint's carry between chunks
  struct Stage {
    float b[kChunk][NP], c[kChunk][NP];
    float h[CH][NP];                  // the state before the chunk
    float x[kChunk][CH], dt[kChunk][CH], dy[kChunk][CH];
  } stage[2];
  float part[2][CH][ROW];             // db's (0) and dc's (1) terms
  float sum[2][2][kChunk][NP];        // [parity][db, dc]: over the channels
  float dx[kChunk][CH], ddt[kChunk][CH];
};

// The cluster's barrier, split: a thread arrives (its shared-memory writes
// released to the cluster) and later waits for every thread of every block
// of the cluster to have arrived.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

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

__device__ __forceinline__ float4 add4(float4 a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
  return a;
}

// Blocks an SM: two where their shared memory fits (TPC = 4, N 9-16:
// 111.5 KB each), else one, whose threads may then take 255 registers.
template <int TPC>
constexpr int blocks_per_sm() { return TPC == 4 ? 2 : 1; }

template <typename T, int TPC>
__global__ void __launch_bounds__(kThreads, blocks_per_sm<TPC>())
    scan_bwd_kernel(Params p) {
  using S = Smem<TPC>;
  constexpr int CH = S::CH, NP = S::NP, ROW = S::ROW;
  constexpr int NX = kChunk * CH, NB = kChunk * NP;     // staged a chunk
  constexpr int RX = (NX + kThreads - 1) / kThreads;    // x/dt/dy a thread
  constexpr int RB = (NB + kThreads - 1) / kThreads;    // b/c a thread
  constexpr int E4 = 2 * NB / 4;                        // float4s of sum
  static_assert(CH * NP == kThreads, "one start state a thread");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S& sm = *reinterpret_cast<S*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int ranks = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();

  const int tid = threadIdx.x;
  const int lane = tid % kLanes, seg = tid / kLanes;
  const int ch = lane / TPC, sub = lane % TPC;
  const int c0 = blockIdx.x * CH, bi = blockIdx.y;
  const int i = c0 + ch;
  const int L = p.L, Di = p.Di, N = p.N;
  const bool live = i < Di;
  const int nch = (L + kChunk - 1) / kChunk;

  float av[kSPT];
#pragma unroll
  for (int s = 0; s < kSPT; ++s) {
    const int j = sub * kSPT + s;
    av[s] = (live && j < N) ? p.a[(long long)i * N + j] : 0.f;
  }

  const T* xb = static_cast<const T*>(p.x) + bi * p.x_sb;
  const T* dtb = static_cast<const T*>(p.dt) + bi * p.dt_sb;
  const T* dyb = static_cast<const T*>(p.dy) + (long long)bi * L * Di;
  const T* bb = static_cast<const T*>(p.b) + bi * p.b_sb;
  const T* cb = static_cast<const T*>(p.c) + bi * p.c_sb;
  const float* hb = p.h_chunks + (long long)bi * nch * Di * N;

  // A chunk's inputs, raw, zeros past L, Di and N: loaded into registers
  // one chunk ahead, converted and staged after the current chunk's first
  // walk.
  T rx[RX], rdt[RX], rdy[RX], rb[RB], rc[RB];
  float rh;
  auto load = [&](int k) {
    const int t0 = k * kChunk;
#pragma unroll
    for (int r = 0; r < RX; ++r) {
      const int q = tid + r * kThreads, cc = c0 + q % CH;
      const long long t = t0 + q / CH;
      const bool ok = q < NX && cc < Di && t < L;
      rx[r] = ok ? xb[t * p.x_st + cc] : zero<T>();
      rdt[r] = ok ? dtb[t * p.dt_st + cc] : zero<T>();
      rdy[r] = ok ? dyb[t * Di + cc] : zero<T>();
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int q = tid + r * kThreads, j = q % NP;
      const long long t = t0 + q / NP;
      const bool ok = q < NB && j < N && t < L;
      rb[r] = ok ? bb[t * p.b_st + j] : zero<T>();
      rc[r] = ok ? cb[t * p.c_st + j] : zero<T>();
    }
    const int hc = c0 + tid / NP, hj = tid % NP;
    rh = (k > 0 && hc < Di && hj < N)
             ? hb[((long long)(k - 1) * Di + hc) * N + hj] : 0.f;
  };
  auto stage = [&](typename S::Stage& st) {
#pragma unroll
    for (int r = 0; r < RX; ++r) {
      const int q = tid + r * kThreads;
      if (q < NX) {
        (&st.x[0][0])[q] = to_f32(rx[r]);
        (&st.dt[0][0])[q] = to_f32(rdt[r]);
        (&st.dy[0][0])[q] = to_f32(rdy[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int q = tid + r * kThreads;
      if (q < NB) {
        (&st.b[0][0])[q] = to_f32(rb[r]);
        (&st.c[0][0])[q] = to_f32(rc[r]);
      }
    }
    (&st.h[0][0])[tid] = rh;
  };

  // The store pass's channel (the same for each of its elements), its D,
  // and its terms of dd.
  const int sc = tid % CH;
  const float dskip = c0 + sc < Di ? p.d[c0 + sc] : 0.f;
  float dd_acc = 0.f;
  float da[kSPT] = {0.f, 0.f, 0.f, 0.f};
  const int ts = seg * kSegLen;                 // the segment's first step
  T* dxb = static_cast<T*>(p.dx) + (long long)bi * L * Di;
  T* ddtb = static_cast<T*>(p.ddt) + (long long)bi * L * Di;
  const int cl = blockIdx.x / ranks;

  // The cluster's db and dc of chunk kk, once its block sums are complete
  // in every rank: this rank's slice, over the ranks in order (all loads
  // in flight at once), into the cluster's part.  Run by the threads of
  // segments 2 and 3 while those of segments 0 and 1 fold.
  auto cluster_sum = [&](int kk) {
    const int per = 2 * NB / ranks;
    const float* base = &sm.sum[kk & 1][0][0][0];
    for (int o = tid - 2 * kLanes; o < per; o += 2 * kLanes) {
      const int f = rank * per + o;
      float v[kCluster];
#pragma unroll
      for (int rr = 0; rr < kCluster; ++rr)
        v[rr] = rr < ranks ? *cluster.map_shared_rank(base + f, rr) : 0.f;
      float acc = v[0];
#pragma unroll
      for (int rr = 1; rr < kCluster; ++rr)
        if (rr < ranks) acc += v[rr];
      const int t = kk * kChunk + (f % NB) / NP, j = f % NP;
      if (t < L && j < N)
        (f < NB ? p.db_part : p.dc_part)[(((long long)cl * p.B + bi) * L +
                                          t) * N + j] = acc;
    }
  };

  if (seg == 1) sm.W[lane] = make_float4(0.f, 0.f, 0.f, 0.f);
  load(nch - 1);
  stage(sm.stage[(nch - 1) & 1]);
  __syncthreads();
  for (int k = nch - 1; k >= 0; --k) {
    const int t0 = k * kChunk;
    const typename S::Stage& cur = sm.stage[k & 1];
    if (k > 0) load(k - 1);

    // 1. The segment from h = 0: its e_t, and its maps (P, B) and (P, G).
    float e[kSegLen][kSPT];
    {
      float P[kSPT], B[kSPT], G[kSPT];
#pragma unroll
      for (int s = 0; s < kSPT; ++s) {
        P[s] = 1.f;
        B[s] = 0.f;
        G[s] = 0.f;
      }
#pragma unroll
      for (int r = 0; r < kSegLen; ++r) {
        const float dv = cur.dt[ts + r][ch], xv = cur.x[ts + r][ch];
        const float dyv = cur.dy[ts + r][ch];
        float bv[kSPT], cv[kSPT];
        to_array(*reinterpret_cast<const float4*>(&cur.b[ts + r][sub * kSPT]),
                 bv);
        to_array(*reinterpret_cast<const float4*>(&cur.c[ts + r][sub * kSPT]),
                 cv);
        const float dtx = dv * xv;
#pragma unroll
        for (int s = 0; s < kSPT; ++s) {
          e[r][s] = expf(dv * av[s]);
          P[s] *= e[r][s];
          B[s] = fmaf(B[s], e[r][s], dtx * bv[s]);
          G[s] = fmaf(P[s], dyv * cv[s], G[s]);
        }
      }
      sm.P[seg][lane] = make_float4(P[0], P[1], P[2], P[3]);
      sm.Bh[seg][lane] = make_float4(B[0], B[1], B[2], B[3]);
      sm.G[seg][lane] = make_float4(G[0], G[1], G[2], G[3]);
    }
    __syncthreads();
    if (k > 0) stage(sm.stage[(k - 1) & 1]);

    // 2. The folds: h in time order from the staged start state (each
    // segment's h_in replaces its B), the adjoint in reverse from the later
    // chunk's carry (each segment's w_in replaces its G).
    if (seg == 0) {
      float h[kSPT];
      to_array(*reinterpret_cast<const float4*>(&cur.h[ch][sub * kSPT]), h);
#pragma unroll
      for (int q = 0; q < kSeg; ++q) {
        float Pq[kSPT], Bq[kSPT];
        to_array(sm.P[q][lane], Pq);
        to_array(sm.Bh[q][lane], Bq);
        sm.Bh[q][lane] = make_float4(h[0], h[1], h[2], h[3]);
#pragma unroll
        for (int s = 0; s < kSPT; ++s) h[s] = fmaf(Pq[s], h[s], Bq[s]);
      }
    } else if (seg == 1) {
      float w[kSPT];
      to_array(sm.W[lane], w);
#pragma unroll
      for (int q = kSeg - 1; q >= 0; --q) {
        float Pq[kSPT], Gq[kSPT];
        to_array(sm.P[q][lane], Pq);
        to_array(sm.G[q][lane], Gq);
        sm.G[q][lane] = make_float4(w[0], w[1], w[2], w[3]);
#pragma unroll
        for (int s = 0; s < kSPT; ++s) w[s] = fmaf(Pq[s], w[s], Gq[s]);
      }
      sm.W[lane] = make_float4(w[0], w[1], w[2], w[3]);
    }
    // The later chunk's block sums, complete in every rank once the
    // cluster's barrier of that chunk is passed.
    if (k + 1 < nch) {
      cluster_wait();
      if (seg >= 2) cluster_sum(k + 1);
    }
    __syncthreads();

    // 3. Forward from h_in: e_t·h_{t-1} for each step, and dc's terms.
    float hq[kSegLen][kSPT];     // e_t·h_{t-1}
    {
      float h[kSPT];
      to_array(sm.Bh[seg][lane], h);
#pragma unroll
      for (int r = 0; r < kSegLen; ++r) {
        const float dv = cur.dt[ts + r][ch], xv = cur.x[ts + r][ch];
        const float dyv = cur.dy[ts + r][ch];
        float bv[kSPT];
        to_array(*reinterpret_cast<const float4*>(&cur.b[ts + r][sub * kSPT]),
                 bv);
        const float dtx = dv * xv;
        float dcv[kSPT];
#pragma unroll
        for (int s = 0; s < kSPT; ++s) {
          hq[r][s] = e[r][s] * h[s];
          h[s] = hq[r][s] + dtx * bv[s];
          dcv[s] = dyv * h[s];
        }
        *reinterpret_cast<float4*>(&sm.part[1][ch][(ts + r) * NP +
                                                   sub * kSPT]) =
            make_float4(dcv[0], dcv[1], dcv[2], dcv[3]);
      }
    }

    // 4. Back from w_in: g_t, and the gradient terms.
    {
      float g[kSPT], w[kSPT];
      to_array(sm.G[seg][lane], w);
#pragma unroll
      for (int r = kSegLen - 1; r >= 0; --r) {
        const float dv = cur.dt[ts + r][ch], xv = cur.x[ts + r][ch];
        const float dyv = cur.dy[ts + r][ch];
        float bv[kSPT], cv[kSPT];
        to_array(*reinterpret_cast<const float4*>(&cur.b[ts + r][sub * kSPT]),
                 bv);
        to_array(*reinterpret_cast<const float4*>(&cur.c[ts + r][sub * kSPT]),
                 cv);
        float px = 0.f, pt = 0.f, dbv[kSPT];
#pragma unroll
        for (int s = 0; s < kSPT; ++s) {
          const float dyc = dyv * cv[s];
          if (r == kSegLen - 1) g[s] = dyc + w[s];
          else g[s] = fmaf(e[r + 1][s], g[s], dyc);
          const float gdt = g[s] * dv;
          px = fmaf(gdt, bv[s], px);
          pt = fmaf(g[s], fmaf(av[s], hq[r][s], xv * bv[s]), pt);
          da[s] = fmaf(gdt, hq[r][s], da[s]);
          dbv[s] = gdt * xv;
        }
        *reinterpret_cast<float4*>(&sm.part[0][ch][(ts + r) * NP +
                                                   sub * kSPT]) =
            make_float4(dbv[0], dbv[1], dbv[2], dbv[3]);
        // dx and ddt of (t, i): over the channel's TPC neighbouring lanes.
#pragma unroll
        for (int off = TPC / 2; off > 0; off >>= 1) {
          px += __shfl_xor_sync(0xffffffffu, px, off);
          pt += __shfl_xor_sync(0xffffffffu, pt, off);
        }
        if (sub == 0) {
          sm.dx[ts + r][ch] = px;
          sm.ddt[ts + r][ch] = pt;
        }
      }
    }
    __syncthreads();

    // 5. The block's db and dc of the chunk: each (t, j) over the
    // channels, in channel order.
    for (int o = tid; o < E4; o += kThreads) {
      const int which = o / (NB / 4), r4 = (o % (NB / 4)) * 4;
      const float* src = &sm.part[which][0][0] + r4;
      float4 v = *reinterpret_cast<const float4*>(src);
#pragma unroll 8
      for (int cc = 1; cc < CH; ++cc)
        v = add4(v, *reinterpret_cast<const float4*>(src + cc * ROW));
      *reinterpret_cast<float4*>(&sm.sum[k & 1][which][0][0] + r4) = v;
    }
    // dx, ddt and dd's terms, coalesced: every thread its share.
#pragma unroll
    for (int r = 0; r < RX; ++r) {
      const int q = tid + r * kThreads, t = q / CH;
      if (q < NX && t0 + t < L && c0 + sc < Di) {
        const float dyv = cur.dy[t][sc];
        const long long o = (long long)(t0 + t) * Di + c0 + sc;
        store(dxb + o, fmaf(dyv, dskip, sm.dx[t][sc]));
        store(ddtb + o, sm.ddt[t][sc]);
        dd_acc = fmaf(dyv, cur.x[t][sc], dd_acc);
      }
    }
    cluster_arrive();
  }
  cluster_wait();
  if (seg >= 2) cluster_sum(0);
  cluster_arrive();   // no block leaves while the others read its sums
  cluster_wait();

  // da: the segments' parts in order; dd: the store pass's, in order.
  sm.P[seg][lane] = make_float4(da[0], da[1], da[2], da[3]);
  float* ddp = &sm.part[0][0][0];
  ddp[tid] = dd_acc;
  __syncthreads();
  if (seg == 0 && live) {
    float4 v = sm.P[0][lane];
#pragma unroll
    for (int q = 1; q < kSeg; ++q) v = add4(v, sm.P[q][lane]);
    const float vs[kSPT] = {v.x, v.y, v.z, v.w};
    float* dst = p.da_part + ((long long)bi * Di + i) * N;
#pragma unroll
    for (int s = 0; s < kSPT; ++s)
      if (sub * kSPT + s < N) dst[sub * kSPT + s] = vs[s];
  }
  if (tid < CH && c0 + tid < Di) {
    float v = ddp[tid];
    for (int q = tid + CH; q < kThreads; q += CH) v += ddp[q];
    p.dd_part[(long long)bi * Di + c0 + tid] = v;
  }
}

// db and dc: the sum of the clusters' parts, in cluster order; da and dd:
// the sum over the batch rows, in order.  One flat index over all four.
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
      src = p.db_part + e; n = p.clusters; step = bln; dst = p.db + e;
    } else if (e < 2 * bln) {
      const long long o = e - bln;
      src = p.dc_part + o; n = p.clusters; step = bln; dst = p.dc + o;
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

int tpc_of(int np) { return np <= 4 ? 1 : np / 4; }

long long tiles_of(int Di, int np) {
  const int ch = kLanes / tpc_of(np);
  return (Di + ch - 1) / ch;
}

// Blocks a cluster: kCluster, or the tiles rounded up to a power of two.
int cluster_of(long long tiles) {
  int cl = 1;
  while (cl < kCluster && cl < tiles) cl *= 2;
  return cl;
}

long long clusters_of(int Di, int np) {
  const long long tiles = tiles_of(Di, np);
  const int cl = cluster_of(tiles);
  return (tiles + cl - 1) / cl;
}

template <typename T, int TPC>
int launch(const Params& p, cudaStream_t stream) {
  const int smem = (int)sizeof(Smem<TPC>);
  cudaError_t err = cudaFuncSetAttribute(
      scan_bwd_kernel<T, TPC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = tiles_of(p.Di, TPC * kSPT);
  const int cl = cluster_of(tiles);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(((tiles + cl - 1) / cl) * cl), p.B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, scan_bwd_kernel<T, TPC>, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Params& p, int np, cudaStream_t stream) {
  switch (tpc_of(np)) {
    case 1: return launch<T, 1>(p, stream);
    case 2: return launch<T, 2>(p, stream);
    case 4: return launch<T, 4>(p, stream);
    case 8: return launch<T, 8>(p, stream);
    case 16: return launch<T, 16>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* roomy_msb_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Floats of the scratch buffer a call needs: the clusters' parts of db and
// dc, and the batch rows' parts of da and dd.
long long roomy_mamba_scan_bwd_work(int B, int L, int Di, int N, int np) {
  return 2 * clusters_of(Di, np) * B * L * N + (long long)B * Di * N +
         (long long)B * Di;
}

// Bytes of dynamic shared memory a block of the launch for np takes.
int roomy_mamba_scan_bwd_smem(int np) {
  switch (tpc_of(np)) {
    case 1: return (int)sizeof(Smem<1>);
    case 2: return (int)sizeof(Smem<2>);
    case 4: return (int)sizeof(Smem<4>);
    case 8: return (int)sizeof(Smem<8>);
    case 16: return (int)sizeof(Smem<16>);
    default: return -1;
  }
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
      B > 65535 || (np & (np - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const long long clusters = clusters_of(Di, np);
  const long long part = clusters * B * L * N;
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
  r.clusters = (int)clusters; r.B = B; r.L = L; r.Di = Di; r.N = N;
  const long long total = 2 * (long long)B * L * N + (long long)Di * N + Di;
  const long long blocks = (total + kReduceThreads - 1) / kReduceThreads;
  scan_bwd_reduce_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096),
                           kReduceThreads, 0, s>>>(r);
  return (int)cudaGetLastError();
}

}  // extern "C"
