// Hopper (sm_90a) kernels for the packed 2-bit arrays of the implicit BFS
// and of the distance oracle's lookup.
//
// 16 two-bit fields per 32-bit word, field j at bits [2j, 2j+2).  The
// kernels replace the Pallas TPU kernels of repro/kernels/bitpack.py:
//
//   roomy_scatter_mark_binned       K2  _scatter_mark_kernel (bitpack.py:142,
//   roomy_scatter_mark (atomic)         pallas_call at :201)
//   roomy_lut_count                 K3  _lut_count_kernel (bitpack.py:71,
//                                       pallas_call at :115)
//   roomy_mark_rotate_count_binned  K1  _mark_rotate_count_kernel
//   roomy_mark_rotate_count (atomic)    (bitpack.py:221, pallas_call at :297)
//   roomy_gather2_chunked           K4  _gather2_kernel (bitpack.py:327,
//   roomy_gather2 (one-entry table)     wrapper bitpack_gather2 at :389,
//                                       pallas_call at :426)
//
// What bounds them on an H100 is memory traffic, not arithmetic: a word
// needs a dozen integer operations, far below the ~300 operations per byte
// where the card stops being bandwidth-bound.
//   K3: read W words, write W words            -> 8W bytes
//   K1, K2: read and write W words once, read M targets -> 8W + 4M
//   K4: read M int64 ranks, write M uint8 codes, and read each distinct
//      32-byte sector of the words that the ranks touch
//      -> 9M + 32*sectors (the int32 form: 8M + 32*sectors)
// K4 is a random gather: at serving batch sizes it is bound by the
// latency of the dependent rank -> word load chain, not by bytes.
//
// K1 and K2, the binned route.  A mark sets a field to `mark` iff the field
// held `only_if` before the call (repro/kernels/ref.py:262-273), so the
// words do not depend on the order of the marks.  The words (120 MB at
// pancake n = 12) are more than twice L2, so a mark applied where it lands
// is a read-modify-write of a random sector in HBM; the binned route
// instead sorts the marks by word tile and applies each tile's marks in
// shared memory:
//   1. bin_count_kernel: each block counts its contiguous slice of targets
//      per tile of kTileWords words (65,536 fields) in a shared histogram
//      and writes it to a (tile, block) matrix.  Negative and >= 16*W
//      targets drop here and never reach a bin.
//   2. bin_scan_kernel: a warp a tile scans the matrix's row across blocks
//      (exclusive, in place) and writes the tile's total.
//   3. bin_scatter_kernel: each block scans the tile totals into shared
//      cursors (block 0 also writes each tile's start), then re-reads its
//      slice a chunk at a time, sorts the chunk by tile in shared memory
//      and writes each target's uint16 offset in its tile at its tile's
//      cursor, a tile's run of the chunk at once.  Order within a bin is
//      free.  At most kMaxTiles tiles (24,927: 102M words) fit its shared
//      memory; the wrapper's route sends wider arrays to the atomic route.
//   4. tile_pass_kernel: a persistent grid; each block brings in a tile's
//      words with one 1-D bulk async copy (cp.async.bulk), double-buffered
//      so that the next tile loads while this one is marked, sets a hit bit
//      a field in an 8 KB shared bitmap with shared atomicOr (the bin read
//      8 offsets a 16-byte load), applies `mark` where hit and the field
//      holds `only_if`, then (K1) maps each word through the LUT and
//      counts, and writes the tile back once (16 bytes a store).
//      Each tile has one owner, so K1 in place and out of place are the
//      same pass; counts add with one atomic a block.
// Bytes moved: 8W for the words, 4M twice for the targets, 2M written and
// read for the bins, 16 bytes a (tile, block) for the matrix: 8W + 12M.
// The bins take 2M bytes of workspace, which the wrapper allocates.  What
// bounds it at pancake n = 12's wide levels is the scatter's stores: the
// targets of a flip of a long prefix land in a tile of their own, so most
// runs of a chunk are one offset long, an L2 transaction each.
//
// The atomic route is the first port's design: each mark is an atomicCAS
// loop on its word in global memory (atomicOr would be wrong: CUR (01) |
// NEXT (10) = DONE (11)), then K1 rotates and counts every word in the same
// cooperative launch after grid.sync(), loading through L2 (__ldcg)
// because L1 is not coherent across SMs.  It takes the calls with fewer
// targets than half the words, where one pass over the words costs less
// than the binned route's launches and passes (kernels/bitpack.py: route).
//
// LUT + count works on all 16 fields of a word at once: the low and high
// bit planes give one mask per field value, the LUT picks which masks set
// the new low and high bits, and __popc of the mask of values that map to
// count_val counts the word.
//
// K4, the gather over a chunk table.  The TPU kernel sends each block of
// queries, through a scalar-prefetched page table, to the page that holds
// them, so that one call serves every page.  Here the pages are the
// distance oracle's cache chunks: the table holds one (word pointer,
// n_words) entry a chunk, null (n_words = -1) for a chunk that another
// launch serves, and one launch takes a whole batch of global ranks.  For
// rank r: chunk c = r / chunk_elems, local = r - c * chunk_elems; a null
// entry leaves the output byte as it was, a rank below 0 or past the last
// chunk and a local at or past 16 * n_words give 0.  The divide is by a
// constant: q = umulhi(r, floor((2^64 - 1) / chunk_elems)) is c or c - 1
// for 0 <= r < 2^63, and one compare fixes it.  Each thread takes
// kG2Per = 8 queries: its ranks in 16-byte loads, issued before the block
// stages the table in shared memory (up to kG2SmemChunks entries; else
// the table is read through __ldg), then all 8 word loads through the
// read-only path before any result is used, then its 8 codes in one
// 8-byte store (read first where a null entry keeps a byte).  What bounds
// it on an H100 is neither bytes nor the latency chain: at M = 1,048,576
// random ranks over the n = 12 oracle's chunks every design tried took
// 36.4-38.4 us (chip_variants.py), about 28G random sectors a second, and
// the same batch again, its sectors warm in L2, took as long (37.0); the
// same ranks sorted took 29.3, and at M = 8M 69.7 against 243.4.  16
// queries a thread (one 16-byte store) was the slowest at every size
// (9.5 against 7.8 us at M = 4096, where fewer threads land on fewer
// SMs).  The designs left behind (16 a thread; four a thread in a grid
// capped at the resident blocks, the first port's; cp.async gathers into
// a shared-memory ring) are variants in chip_variants.py.  roomy_gather2,
// the reference's single-array API (int32 indices and codes), is the same
// kernel with a one-entry table passed by value and chunk_elems = 2^31;
// int32 in and out is a template parameter and costs nothing else.
//
// Plain C interface, loaded with ctypes.  Each function launches on the
// given stream, does not synchronise, and returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kEven = 0x55555555u;

// The binned route.  A tile of kTileWords words holds 2^kTileShift fields,
// so a target's offset in its tile fits a uint16.
constexpr int kTileWords = 4096;
constexpr int kTileShift = 16;
constexpr int kBinThreads = 1024;
constexpr int kScanWarps = 8;
constexpr int kSortPer = 8;                         // a thread's targets
constexpr int kSortChunk = kBinThreads * kSortPer;  // a chunk of the scatter
// The scatter's shared memory, and the most tiles it holds.
constexpr size_t scatter_smem(int n_tiles) {
  return (size_t)(2 * n_tiles + 2) * 4 + (size_t)kSortChunk * 4;
}
// (232,448 bytes a block, less room for the kernel's static shared memory)
constexpr int kMaxTiles = (232448 - 256 - kSortChunk * 4 - 8) / 8;
// A stage holds a tile and the 16-byte granules around it: the bulk copy
// starts and ends on 16-byte boundaries whatever the words' alignment.
constexpr int kStageWords = kTileWords + 8;
constexpr int kTileSmem = (2 * kStageWords + kTileWords / 2) * 4 + 16;

// Map the 16 fields of w through lut; *match gets one bit (at 2j) per field
// whose new value is cval.
__device__ __forceinline__ uint32_t lut_word(uint32_t w, uint32_t lut,
                                             uint32_t cval, uint32_t* match) {
  const uint32_t lo = w & kEven;
  const uint32_t hi = (w >> 1) & kEven;
  const uint32_t is[4] = {~(lo | hi) & kEven, lo & ~hi, hi & ~lo, lo & hi};
  uint32_t nlo = 0, nhi = 0, m = 0;
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    const uint32_t t = (lut >> (2 * v)) & 3u;
    if (t & 1u) nlo |= is[v];
    if (t & 2u) nhi |= is[v];
    if (t == cval) m |= is[v];
  }
  *match = m;
  return nlo | (nhi << 1);
}

// 16 hit bits (bit j for field j) -> one bit at 2j.
__device__ __forceinline__ uint32_t spread16(uint32_t x) {
  x &= 0xFFFFu;
  x = (x | (x << 8)) & 0x00FF00FFu;
  x = (x | (x << 4)) & 0x0F0F0F0Fu;
  x = (x | (x << 2)) & 0x33333333u;
  return (x | (x << 1)) & kEven;
}

// Set the fields of w whose bit (at 2j) is in `hit` to `mark` where they
// hold `only_if`.
__device__ __forceinline__ uint32_t mark_word(uint32_t w, uint32_t hit,
                                              uint32_t mark,
                                              uint32_t only_if) {
  const uint32_t lo = w & kEven;
  const uint32_t hi = (w >> 1) & kEven;
  const uint32_t m = hit & ((only_if & 1u) ? lo : ~lo) &
                     ((only_if & 2u) ? hi : ~hi);
  return (w & ~(m | (m << 1))) | ((mark & 1u) ? m : 0u) |
         ((mark & 2u) ? (m << 1) : 0u);
}

__device__ __forceinline__ void mark_one(uint32_t* words, long long cap,
                                         int32_t e, uint32_t mark,
                                         uint32_t only_if) {
  if (e < 0 || (long long)e >= cap) return;
  uint32_t* p = words + (e >> 4);
  const uint32_t sh = 2u * (uint32_t)(e & 15);
  uint32_t old = __ldcg(p);
  while (((old >> sh) & 3u) == only_if) {
    const uint32_t nw = (old & ~(3u << sh)) | (mark << sh);
    const uint32_t prev = atomicCAS(p, old, nw);
    if (prev == old) break;
    old = prev;
  }
}

// Rotate+count words [0, n_words) of in into out; returns this thread's
// count.  vec: both pointers are 16-byte aligned, so whole uint4s are used.
__device__ __forceinline__ unsigned int lut_pass(const uint32_t* in,
                                                 uint32_t* out,
                                                 long long n_words, int vec,
                                                 uint32_t lut, uint32_t cval,
                                                 long long tid,
                                                 long long stride) {
  unsigned int cnt = 0;
  uint32_t m;
  const long long n_vec = vec ? (n_words >> 2) : 0;
  const uint4* in4 = reinterpret_cast<const uint4*>(in);
  uint4* out4 = reinterpret_cast<uint4*>(out);
  for (long long i = tid; i < n_vec; i += stride) {
    uint4 v = __ldcg(in4 + i);
    v.x = lut_word(v.x, lut, cval, &m); cnt += __popc(m);
    v.y = lut_word(v.y, lut, cval, &m); cnt += __popc(m);
    v.z = lut_word(v.z, lut, cval, &m); cnt += __popc(m);
    v.w = lut_word(v.w, lut, cval, &m); cnt += __popc(m);
    __stcg(out4 + i, v);
  }
  for (long long i = (n_vec << 2) + tid; i < n_words; i += stride) {
    __stcg(out + i, lut_word(__ldcg(in + i), lut, cval, &m));
    cnt += __popc(m);
  }
  return cnt;
}

// Sum v over the block (blockDim.x == kThreads) and add it to *total.
__device__ __forceinline__ void block_add(unsigned int v,
                                          unsigned int* total) {
  __shared__ unsigned int warp_sums[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (lane == 0) warp_sums[wid] = v;
  __syncthreads();
  if (wid == 0) {
    v = lane < kThreads / 32 ? warp_sums[lane] : 0u;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0 && v) atomicAdd(total, v);
  }
}

__global__ void __launch_bounds__(kThreads)
lut_count_kernel(const uint32_t* in, uint32_t* out, long long n_words,
                 int vec, uint32_t lut, uint32_t cval, unsigned int* count) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  block_add(lut_pass(in, out, n_words, vec, lut, cval, tid, stride), count);
}

__global__ void __launch_bounds__(kThreads)
scatter_mark_kernel(uint32_t* words, long long n_words, const int32_t* idx,
                    long long m, uint32_t mark, uint32_t only_if) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long cap = n_words * 16;
  for (long long i = tid; i < m; i += stride)
    mark_one(words, cap, idx[i], mark, only_if);
}

__global__ void __launch_bounds__(kThreads)
mark_rotate_count_kernel(const uint32_t* in, uint32_t* out, long long n_words,
                         int vec, const int32_t* idx, long long m,
                         uint32_t mark, uint32_t only_if, uint32_t lut,
                         uint32_t cval, unsigned int* count) {
  cg::grid_group grid = cg::this_grid();
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long cap = n_words * 16;
  if (in != out) {  // out of place: copy first, inside this launch
    for (long long i = tid; i < n_words; i += stride)
      __stcg(out + i, __ldcg(in + i));
    grid.sync();
  }
  for (long long i = tid; i < m; i += stride)
    mark_one(out, cap, idx[i], mark, only_if);
  grid.sync();
  block_add(lut_pass(out, out, n_words, vec, lut, cval, tid, stride), count);
}

// ------------------------------------------------------------ binned route

// Call f(target) for targets [lo, hi), the block's threads striding over
// them; vec: idx + lo is 16-byte aligned, so whole int4s are read, two at
// a time to keep loads in flight.  The targets stream through once a pass,
// so they are loaded evict-first (__ldcs).
template <typename F>
__device__ __forceinline__ void for_targets(const int32_t* idx, long long lo,
                                            long long hi, int vec, F f) {
  long long i = lo;
  if (vec) {
    const long long n4 = (hi - lo) >> 2;
    const int4* p = reinterpret_cast<const int4*>(idx + lo);
    long long j = threadIdx.x;
    for (; j + blockDim.x < n4; j += 2 * blockDim.x) {
      const int4 a = __ldcs(p + j), b = __ldcs(p + j + blockDim.x);
      f(a.x); f(a.y); f(a.z); f(a.w);
      f(b.x); f(b.y); f(b.z); f(b.w);
    }
    if (j < n4) {
      const int4 a = __ldcs(p + j);
      f(a.x); f(a.y); f(a.z); f(a.w);
    }
    i = lo + (n4 << 2);
  }
  for (i += threadIdx.x; i < hi; i += blockDim.x) f(__ldcs(idx + i));
}

// The tile of an in-range target; its offset there is e & 0xFFFF.
__device__ __forceinline__ int tile_of(int32_t e) { return e >> kTileShift; }

// Step 1: counts[t * gridDim.x + b] = block b's targets in tile t.
__global__ void __launch_bounds__(kBinThreads)
bin_count_kernel(const int32_t* __restrict__ idx, long long m, long long cap,
                 int vec, int n_tiles, long long per_block,
                 unsigned int* __restrict__ counts) {
  extern __shared__ unsigned int hist[];
  for (int t = threadIdx.x; t < n_tiles; t += blockDim.x) hist[t] = 0;
  __syncthreads();
  const long long lo = blockIdx.x * per_block;
  const long long hi = lo + per_block < m ? lo + per_block : m;
  for_targets(idx, lo, hi, vec, [&](int32_t e) {
    if (e >= 0 && (long long)e < cap) atomicAdd(&hist[tile_of(e)], 1u);
  });
  __syncthreads();
  for (int t = threadIdx.x; t < n_tiles; t += blockDim.x)
    counts[(long long)t * gridDim.x + blockIdx.x] = hist[t];
}

// Step 2: a warp a tile; the tile's row of counts becomes its exclusive
// scan across blocks, and tile_total[t] the row's sum.
__global__ void __launch_bounds__(kScanWarps * 32)
bin_scan_kernel(unsigned int* counts, int n_tiles, int g,
                unsigned int* tile_total) {
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * kScanWarps + (threadIdx.x >> 5);
  if (t >= n_tiles) return;  // the whole warp
  unsigned int* row = counts + (long long)t * g;
  unsigned int carry = 0;
  for (int b0 = 0; b0 < g; b0 += 32) {
    const int b = b0 + lane;
    const unsigned int v = b < g ? row[b] : 0u;
    unsigned int x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (b < g) row[b] = carry + x - v;
    carry += __shfl_sync(0xffffffffu, x, 31);
  }
  if (lane == 0) tile_total[t] = carry;
}

// Inclusive scan of v over the block (blockDim.x == kBinThreads).
__device__ __forceinline__ unsigned int block_scan(unsigned int v) {
  __shared__ unsigned int warp_sums[kBinThreads / 32];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned int y = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += y;
  }
  if (lane == 31) warp_sums[wid] = v;
  __syncthreads();
  if (wid == 0) {
    unsigned int s = warp_sums[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    warp_sums[lane] = s;
  }
  __syncthreads();
  return v + (wid ? warp_sums[wid - 1] : 0u);
}

// Exclusive scan of a[0, n) in place by the block (blockDim.x ==
// kBinThreads), each thread over a run of consecutive entries; a[n] gets
// the total, which every thread gets back.  Ends with __syncthreads.
__device__ __forceinline__ unsigned int scan_runs(unsigned int* a, int n) {
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int t0 = min(n, (int)threadIdx.x * per);
  const int t1 = min(n, t0 + per);
  unsigned int sum = 0;
  for (int t = t0; t < t1; ++t) sum += a[t];
  const unsigned int incl = block_scan(sum);
  unsigned int run = incl - sum;
  for (int t = t0; t < t1; ++t) {
    const unsigned int v = a[t];
    a[t] = run;
    run += v;
  }
  if (threadIdx.x == blockDim.x - 1) a[n] = incl;
  __syncthreads();
  return a[n];
}

// Step 3: bins[tile_start[t] ..) holds tile t's offsets, block by block.
// Each block scans the tile totals into shared cursors (block 0 also
// writes each tile's start), then takes its slice kSortChunk targets at a
// time: it sorts the chunk by tile in shared memory (the chunk's count a
// tile, their scan, each target at its tile's slot) and writes each
// tile's run of offsets at the tile's cursor, so that a warp's stores fill
// whole sectors where a run is long (where a tile's targets lie close, as
// a pancake flip of a short prefix puts them), not an L2 transaction a
// target.  The shared memory is 8 bytes a tile and 4 a chunk's target.
__global__ void __launch_bounds__(kBinThreads)
bin_scatter_kernel(const int32_t* __restrict__ idx, long long m,
                          long long cap, int vec, int n_tiles,
                          long long per_block,
                          const unsigned int* __restrict__ counts,
                          const unsigned int* __restrict__ tile_total,
                          unsigned int* __restrict__ tile_start,
                          uint16_t* __restrict__ bins) {
  extern __shared__ unsigned int cursor[];  // n_tiles, then:
  unsigned int* start = cursor + n_tiles;   // n_tiles + 1 (+ 1 pad)
  uint16_t* off_s = reinterpret_cast<uint16_t*>(start + n_tiles + 2);
  uint16_t* tile_s = off_s + kSortChunk;
  {
    const int per = (n_tiles + blockDim.x - 1) / blockDim.x;
    const int t0 = min(n_tiles, (int)threadIdx.x * per);
    const int t1 = min(n_tiles, t0 + per);
    unsigned int sum = 0;
    for (int t = t0; t < t1; ++t) sum += tile_total[t];
    const unsigned int incl = block_scan(sum);
    unsigned int run = incl - sum;
    for (int t = t0; t < t1; ++t) {
      if (blockIdx.x == 0) tile_start[t] = run;
      cursor[t] = run + counts[(long long)t * gridDim.x + blockIdx.x];
      run += tile_total[t];
    }
    if (blockIdx.x == 0 && threadIdx.x == blockDim.x - 1)
      tile_start[n_tiles] = incl;
  }
  const long long lo = blockIdx.x * per_block;
  const long long hi = lo + per_block < m ? lo + per_block : m;
  for (long long c0 = lo; c0 < hi; c0 += kSortChunk) {
    for (int t = threadIdx.x; t < n_tiles; t += blockDim.x) start[t] = 0;
    __syncthreads();
    int32_t e[kSortPer];
    unsigned int r[kSortPer];
#pragma unroll
    for (int j = 0; j < kSortPer; ++j) {
      const long long i = c0 + threadIdx.x + (long long)j * blockDim.x;
      e[j] = i < hi ? __ldcs(idx + i) : -1;
    }
#pragma unroll
    for (int j = 0; j < kSortPer; ++j)
      if (e[j] >= 0 && (long long)e[j] < cap)
        r[j] = atomicAdd(&start[tile_of(e[j])], 1u);
    __syncthreads();
    const unsigned int n = scan_runs(start, n_tiles);
#pragma unroll
    for (int j = 0; j < kSortPer; ++j)
      if (e[j] >= 0 && (long long)e[j] < cap) {
        const int t = tile_of(e[j]);
        const unsigned int p = start[t] + r[j];
        off_s[p] = (uint16_t)(e[j] & ((1 << kTileShift) - 1));
        tile_s[p] = (uint16_t)t;
      }
    __syncthreads();
    for (unsigned int p = threadIdx.x; p < n; p += blockDim.x) {
      const int t = tile_s[p];
      bins[cursor[t] + (p - start[t])] = off_s[p];
    }
    __syncthreads();
    for (int t = threadIdx.x; t < n_tiles; t += blockDim.x)
      cursor[t] += start[t + 1] - start[t];
    __syncthreads();
  }
}

// Step 4: mark, (K1) rotate and count, and write every tile once.
template <bool kLut>
__global__ void __launch_bounds__(kThreads)
tile_pass_kernel(const uint32_t* in, uint32_t* out, long long n_words,
                 int n_tiles, const unsigned int* __restrict__ tile_start,
                 const uint16_t* __restrict__ bins, uint32_t mark,
                 uint32_t only_if, uint32_t lut, uint32_t cval,
                 unsigned int* count) {
  extern __shared__ __align__(128) uint32_t smem[];  // two stages, then:
  uint32_t* hit = smem + 2 * kStageWords;  // a bit a field of the tile
  uint64_t* bar = reinterpret_cast<uint64_t*>(hit + kTileWords / 2);
  const int tid = threadIdx.x;
  // Every tile starts at the same offset in its first 16-byte granule;
  // vec: the staged words and out are both 16-byte aligned.
  const int shift = (int)(((uintptr_t)in & 15u) >> 2);
  const bool vec = shift == 0 && ((uintptr_t)out & 15u) == 0;
  if (tid == 0) {
    mbar_init(smem_addr(&bar[0]), 1);
    mbar_init(smem_addr(&bar[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // Thread 0: tile t's words, from the granule that holds the first to the
  // one that holds the last, into stage s.  The granules lie inside the
  // allocation, and words outside the tile are loaded but never used.
  auto load = [&](int t, int s) {
    const uint32_t* src = in + (long long)t * kTileWords;
    const long long left = n_words - (long long)t * kTileWords;
    const int nw = left < kTileWords ? (int)left : kTileWords;
    const uintptr_t a0 = (uintptr_t)src & ~(uintptr_t)15;
    const uintptr_t a1 = ((uintptr_t)(src + nw) + 15) & ~(uintptr_t)15;
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    mbar_expect_tx(smem_addr(&bar[s]), (uint32_t)(a1 - a0));
    bulk_load(smem_addr(smem + s * kStageWords), (const void*)a0,
              (uint32_t)(a1 - a0), smem_addr(&bar[s]));
  };
  auto set_hit = [&](uint32_t f) { atomicOr(&hit[f >> 5], 1u << (f & 31)); };
  auto set_hit8 = [&](uint4 u) {
    set_hit(u.x & 0xFFFFu); set_hit(u.x >> 16);
    set_hit(u.y & 0xFFFFu); set_hit(u.y >> 16);
    set_hit(u.z & 0xFFFFu); set_hit(u.z >> 16);
    set_hit(u.w & 0xFFFFu); set_hit(u.w >> 16);
  };
  if (tid == 0 && (int)blockIdx.x < n_tiles) load(blockIdx.x, 0);
  unsigned int cnt = 0;
  int k = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++k) {
    const int s = k & 1;
    // The other stage was last read before the previous iteration's final
    // __syncthreads, so it may be refilled now.
    if (tid == 0 && t + (int)gridDim.x < n_tiles) load(t + gridDim.x, s ^ 1);
    for (int i = tid; i < kTileWords / 2; i += blockDim.x) hit[i] = 0;
    __syncthreads();
    const long long b0 = tile_start[t];
    const long long b1 = tile_start[t + 1];
    // The bin: its head and tail an offset a load, the rest 8 offsets a
    // 16-byte load, two in flight a thread.
    const long long a0 = min(b1, (b0 + 7) & ~7ll);
    const long long a1 = max(a0, b1 & ~7ll);
    for (long long j = b0 + tid; j < a0; j += blockDim.x) set_hit(bins[j]);
    for (long long j = a1 + tid; j < b1; j += blockDim.x) set_hit(bins[j]);
    const uint4* b8 = reinterpret_cast<const uint4*>(bins + a0);
    const long long n8 = (a1 - a0) >> 3;
    long long q = tid;
    for (; q + blockDim.x < n8; q += 2 * blockDim.x) {
      const uint4 u = __ldcs(b8 + q), v = __ldcs(b8 + q + blockDim.x);
      set_hit8(u);
      set_hit8(v);
    }
    if (q < n8) set_hit8(__ldcs(b8 + q));
    __syncthreads();
    mbar_wait(smem_addr(&bar[s]), (uint32_t)(k >> 1) & 1u);
    const long long base = (long long)t * kTileWords;
    const long long left = n_words - base;
    const int nw = left < kTileWords ? (int)left : kTileWords;
    const uint32_t* words = smem + s * kStageWords + shift;
    // A word and its 16 hit bits -> the word to write.
    auto apply = [&](uint32_t w, uint32_t h16) {
      if (h16) w = mark_word(w, spread16(h16), mark, only_if);
      if (kLut) {
        uint32_t match;
        w = lut_word(w, lut, cval, &match);
        cnt += __popc(match);
      }
      return w;
    };
    int i = 0;
    if (vec) {  // 4 words a thread at a time, one 16-byte store
      const int n4 = nw >> 2;
      const uint4* w4 = reinterpret_cast<const uint4*>(words);
      const uint2* h2 = reinterpret_cast<const uint2*>(hit);
      uint4* o4 = reinterpret_cast<uint4*>(out + base);
      for (int q = tid; q < n4; q += blockDim.x) {
        uint4 v = w4[q];
        const uint2 h = h2[q];
        v.x = apply(v.x, h.x & 0xFFFFu);
        v.y = apply(v.y, h.x >> 16);
        v.z = apply(v.z, h.y & 0xFFFFu);
        v.w = apply(v.w, h.y >> 16);
        o4[q] = v;
      }
      i = n4 << 2;
    }
    for (i += tid; i < nw; i += blockDim.x)
      out[base + i] = apply(words[i], (hit[i >> 1] >> ((i & 1) << 4)) &
                                          0xFFFFu);
    __syncthreads();
  }
  if (kLut) block_add(cnt, count);
}

// K4.  A table entry is (word pointer, n_words); n_words < 0 is null.
constexpr int kG2Threads = 128;
constexpr int kG2Per = 8;              // queries a thread
constexpr int kG2SmemChunks = 2048;    // table entries held in shared memory
enum { kG2Load = 0, kG2Zero = 1, kG2Keep = 2 };

struct G2Table {
  const longlong2* table;    // device table, or null: `single` is the entry
  longlong2 single;
  int n_chunks;
  int in_smem;
  unsigned long long chunk_elems, magic;   // magic = floor((2^64 - 1) / ce)
};

// Copies a device table into shared memory where it goes there; every
// thread of the block calls it.
__device__ __forceinline__ void g2_stage_table(const G2Table& t,
                                               longlong2* s_tab) {
  if (!t.table || !t.in_smem) return;
  for (int i = threadIdx.x; i < t.n_chunks; i += blockDim.x)
    s_tab[i] = __ldg(t.table + i);
  __syncthreads();
}

// Where rank r's field lives: kG2Load with its word's address and shift,
// kG2Zero for code 0, kG2Keep for a null entry.
__device__ __forceinline__ int g2_locate(long long r, const G2Table& t,
                                         const longlong2* s_tab,
                                         const uint32_t** word,
                                         uint32_t* shift) {
  if (r < 0) return kG2Zero;
  const unsigned long long u = (unsigned long long)r;
  unsigned long long c = __umul64hi(u, t.magic);
  unsigned long long local = u - c * t.chunk_elems;
  if (local >= t.chunk_elems) {
    ++c;
    local -= t.chunk_elems;
  }
  if (c >= (unsigned long long)t.n_chunks) return kG2Zero;
  const longlong2 e = !t.table ? t.single
                      : t.in_smem ? s_tab[c] : __ldg(t.table + c);
  if (e.y < 0) return kG2Keep;
  if (local >= 16ull * (unsigned long long)e.y) return kG2Zero;
  *word = reinterpret_cast<const uint32_t*>(e.x) + (local >> 4);
  *shift = 2u * (uint32_t)(local & 15u);
  return kG2Load;
}

// The thread's kG2Per ranks: 16-byte streaming loads when `full` (a whole
// aligned run), else one at a time, -1 past the end.
template <typename Idx>
__device__ __forceinline__ void g2_load_ranks(const Idx* __restrict__ p,
                                              long long (&r)[kG2Per], int n,
                                              bool full) {
  if (!full) {
#pragma unroll
    for (int j = 0; j < kG2Per; ++j) r[j] = j < n ? (long long)p[j] : -1;
  } else if constexpr (sizeof(Idx) == 8) {
    const longlong2* p2 = reinterpret_cast<const longlong2*>(p);
#pragma unroll
    for (int k = 0; k < kG2Per / 2; ++k) {
      const longlong2 v = __ldcs(p2 + k);
      r[2 * k] = v.x;
      r[2 * k + 1] = v.y;
    }
  } else {
    const int4* p4 = reinterpret_cast<const int4*>(p);
#pragma unroll
    for (int k = 0; k < kG2Per / 4; ++k) {
      const int4 v = __ldcs(p4 + k);
      r[4 * k] = v.x;
      r[4 * k + 1] = v.y;
      r[4 * k + 2] = v.z;
      r[4 * k + 3] = v.w;
    }
  }
}

// Stores a thread's run of codes: 8 or 16 bytes at a time when `full`,
// else one at a time; a kG2Keep query's value stays.
template <typename Out>
__device__ __forceinline__ void g2_store(Out* o, const uint32_t (&code)[kG2Per],
                                         const int (&st)[kG2Per], int n,
                                         bool full) {
  if (!full) {
#pragma unroll
    for (int j = 0; j < kG2Per; ++j)
      if (j < n && st[j] != kG2Keep) o[j] = (Out)code[j];
    return;
  }
  if constexpr (sizeof(Out) == 1) {
    bool keep = false;
#pragma unroll
    for (int j = 0; j < kG2Per; ++j) keep |= st[j] == kG2Keep;
    constexpr int kWords = kG2Per / 4;   // four codes a 32-bit word
    static_assert(kWords % 2 == 0, "codes go out 8 or 16 bytes at a time");
    uint32_t v[kWords], old[kWords];
#pragma unroll
    for (int k = 0; k < kWords; ++k)
      v[k] = code[4 * k] | code[4 * k + 1] << 8 | code[4 * k + 2] << 16 |
             code[4 * k + 3] << 24;
    uint2* o2 = reinterpret_cast<uint2*>(o);
    uint4* o4 = reinterpret_cast<uint4*>(o);
    if (keep) {                          // null entries keep their bytes
#pragma unroll
      for (int k = 0; k < kWords; k += 2) {
        if constexpr (kWords % 4 == 0) {
          if (k % 4 == 0) {
            const uint4 x = o4[k / 4];
            old[k] = x.x, old[k + 1] = x.y, old[k + 2] = x.z;
            old[k + 3] = x.w;
          }
        } else {
          const uint2 x = o2[k / 2];
          old[k] = x.x, old[k + 1] = x.y;
        }
      }
#pragma unroll
      for (int j = 0; j < kG2Per; ++j)
        if (st[j] == kG2Keep)
          v[j / 4] = (v[j / 4] & ~(0xFFu << (8 * (j % 4)))) |
                     (old[j / 4] & (0xFFu << (8 * (j % 4))));
    }
#pragma unroll
    for (int k = 0; k < kWords; k += 2) {
      if constexpr (kWords % 4 == 0) {
        if (k % 4 == 0) o4[k / 4] = make_uint4(v[k], v[k + 1], v[k + 2],
                                               v[k + 3]);
      } else {
        o2[k / 2] = make_uint2(v[k], v[k + 1]);
      }
    }
  } else {            // the flat form: its one entry is never null
    int4* o4 = reinterpret_cast<int4*>(o);
#pragma unroll
    for (int k = 0; k < kG2Per / 4; ++k)
      o4[k] = make_int4((int)code[4 * k], (int)code[4 * k + 1],
                        (int)code[4 * k + 2], (int)code[4 * k + 3]);
  }
}

// K4: one thread a run of kG2Per queries, codes written in query order.
// The bound of one block an SM is no limit in practice (the kernel takes
// ~50 registers); without it ptxas spilled a word address of the int32
// instantiation to the stack at 48 registers.
template <typename Idx, typename Out>
__global__ void __launch_bounds__(kG2Threads, 1)
gather2_kernel(G2Table t, const Idx* __restrict__ ranks,
               Out* __restrict__ out, long long m, int vec) {
  extern __shared__ longlong2 s_tab[];
  const long long base =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) * kG2Per;
  const int n = base >= m ? 0 : m - base < kG2Per ? (int)(m - base) : kG2Per;
  const bool full = vec && n == kG2Per;
  long long r[kG2Per];
  g2_load_ranks(ranks + base, r, n, full);   // in flight while the table
  g2_stage_table(t, s_tab);                  // comes in
  if (n == 0) return;
  const uint32_t* addr[kG2Per];
  uint32_t shift[kG2Per];
  int st[kG2Per];
#pragma unroll
  for (int j = 0; j < kG2Per; ++j) {
    addr[j] = nullptr;
    shift[j] = 0;
    st[j] = j < n ? g2_locate(r[j], t, s_tab, &addr[j], &shift[j]) : kG2Keep;
  }
  uint32_t w[kG2Per];
#pragma unroll
  for (int j = 0; j < kG2Per; ++j)       // every load before any use
    w[j] = st[j] == kG2Load ? __ldg(addr[j]) : 0u;
  uint32_t code[kG2Per];
#pragma unroll
  for (int j = 0; j < kG2Per; ++j) code[j] = (w[j] >> shift[j]) & 3u;
  g2_store(out + base, code, st, n, full);
}

// Blocks of `kernel` that all SMs hold at once (occupancy x SM count) with
// `smem` bytes of dynamic shared memory and `threads` a block.  Grids
// never exceed it: a block that waited for a second wave would leave most
// of the card idle while it ran alone.
template <typename Kernel>
int resident_blocks(Kernel kernel, long long* blocks, int threads = kThreads,
                    size_t smem = 0) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (e == cudaSuccess && per_sm < 1) e = cudaErrorInvalidConfiguration;
  *blocks = (long long)sms * per_sm;
  return (int)e;
}

// Enough blocks for `work` items at one per thread, at most `resident`.
unsigned int grid_for(long long work, long long resident) {
  long long g = (work + kThreads - 1) / kThreads;
  if (g > resident) g = resident;
  return (unsigned int)(g < 1 ? 1 : g);
}

int aligned16(const void* a, const void* b) {
  return ((((uintptr_t)a) | ((uintptr_t)b)) & 15u) == 0;
}

// The launch's view of a chunk table: `table` on the device (n_chunks
// entries), or null with `single` its one entry.
G2Table g2_table(const void* table, int n_chunks, longlong2 single,
                 long long chunk_elems) {
  G2Table t;
  t.table = (const longlong2*)table;
  t.single = single;
  t.n_chunks = n_chunks;
  t.in_smem = table != nullptr && n_chunks <= kG2SmemChunks;
  t.chunk_elems = (unsigned long long)chunk_elems;
  t.magic = ~0ull / t.chunk_elems;
  return t;
}

template <typename Idx, typename Out>
int gather2(const void* table, int n_chunks, longlong2 single,
            long long chunk_elems, const void* ranks, long long m, void* out,
            cudaStream_t s) {
  if (m <= 0) return 0;
  if (n_chunks < 1 || chunk_elems < 1) return (int)cudaErrorInvalidValue;
  const G2Table t = g2_table(table, n_chunks, single, chunk_elems);
  const size_t smem = t.in_smem ? (size_t)n_chunks * sizeof(longlong2) : 0;
  const long long per_block = (long long)kG2Threads * kG2Per;
  gather2_kernel<Idx, Out>
      <<<(unsigned int)((m + per_block - 1) / per_block), kG2Threads, smem,
         s>>>(t, (const Idx*)ranks, (Out*)out, m, aligned16(ranks, out));
  return (int)cudaGetLastError();
}

// Steps 1-4 of the binned route; the workspace comes from the wrapper's
// plan (kernels/bitpack.py: bin_plan): g blocks of per_block targets,
// counts (n_tiles x g), tile_total (n_tiles), tile_start (n_tiles + 1) and
// the bins (m uint16).
template <bool kLut>
int binned(const void* in, void* out, long long n_words, const void* idx,
           long long m, int g, long long per_block, void* counts,
           void* tile_total, void* tile_start, void* bins, uint32_t mark,
           uint32_t only_if, uint32_t lut, uint32_t cval, void* count,
           cudaStream_t s) {
  const int n_tiles = (int)((n_words + kTileWords - 1) / kTileWords);
  if (n_tiles == 0) return 0;
  if (n_tiles > kMaxTiles) return (int)cudaErrorInvalidValue;
  const size_t hist = (size_t)n_tiles * 4;
  if (hist > 48 * 1024) {
    const cudaError_t e1 = cudaFuncSetAttribute(
        bin_count_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)hist);
    if (e1 != cudaSuccess) return (int)e1;
  }
  const cudaError_t e2 = cudaFuncSetAttribute(
      bin_scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)scatter_smem(n_tiles));
  if (e2 != cudaSuccess) return (int)e2;
  long long resident = 0;
  int e = resident_blocks(tile_pass_kernel<kLut>, &resident, kThreads,
                          kTileSmem);
  if (e) return e;
  const long long cap = n_words * 16;
  const int32_t* idx_p = (const int32_t*)idx;
  const int vec = ((uintptr_t)idx & 15u) == 0 && per_block % 4 == 0;
  bin_count_kernel<<<g, kBinThreads, hist, s>>>(
      idx_p, m, cap, vec, n_tiles, per_block, (unsigned int*)counts);
  bin_scan_kernel<<<(n_tiles + kScanWarps - 1) / kScanWarps,
                    kScanWarps * 32, 0, s>>>(
      (unsigned int*)counts, n_tiles, g, (unsigned int*)tile_total);
  bin_scatter_kernel<<<g, kBinThreads, scatter_smem(n_tiles), s>>>(
      idx_p, m, cap, vec, n_tiles, per_block, (const unsigned int*)counts,
      (const unsigned int*)tile_total, (unsigned int*)tile_start,
      (uint16_t*)bins);
  const long long grid = resident < n_tiles ? resident : n_tiles;
  tile_pass_kernel<kLut><<<(unsigned int)grid, kThreads, kTileSmem, s>>>(
      (const uint32_t*)in, (uint32_t*)out, n_words, n_tiles,
      (const unsigned int*)tile_start, (const uint16_t*)bins, mark, only_if,
      lut, cval, (unsigned int*)count);
  return (int)cudaGetLastError();
}

}  // namespace

#define ROOMY_TRY(expr)                        \
  do {                                         \
    const int _e = (int)(expr);                \
    if (_e != 0) return _e;                    \
  } while (0)

extern "C" {

const char* roomy_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Words a tile of the binned route holds, and the tile pass's dynamic
// shared memory.
int roomy_bin_tile_words() { return kTileWords; }
int roomy_bin_tile_smem() { return kTileSmem; }
int roomy_bin_max_tiles() { return kMaxTiles; }
// K4's table entries held in shared memory; a longer table is read
// through __ldg.
int roomy_gather2_smem_chunks() { return kG2SmemChunks; }

int roomy_lut_count(const void* in, void* out, long long n_words, int lut,
                    int count_val, void* count, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  long long resident = 0;
  ROOMY_TRY(resident_blocks(lut_count_kernel, &resident));
  ROOMY_TRY(cudaMemsetAsync(count, 0, sizeof(unsigned int), s));
  const int vec = aligned16(in, out);
  lut_count_kernel<<<grid_for(vec ? (n_words + 3) / 4 : n_words, resident),
                     kThreads, 0, s>>>(
      (const uint32_t*)in, (uint32_t*)out, n_words, vec, (uint32_t)lut,
      (uint32_t)count_val, (unsigned int*)count);
  return (int)cudaGetLastError();
}

int roomy_scatter_mark(const void* in, void* out, long long n_words,
                       const void* idx, long long m, int mark, int only_if,
                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  long long resident = 0;
  ROOMY_TRY(resident_blocks(scatter_mark_kernel, &resident));
  if (in != out)
    ROOMY_TRY(cudaMemcpyAsync(out, in, (size_t)n_words * 4,
                              cudaMemcpyDeviceToDevice, s));
  scatter_mark_kernel<<<grid_for(m, resident), kThreads, 0, s>>>(
      (uint32_t*)out, n_words, (const int32_t*)idx, m, (uint32_t)mark,
      (uint32_t)only_if);
  return (int)cudaGetLastError();
}

int roomy_mark_rotate_count(const void* in, void* out, long long n_words,
                            const void* idx, long long m, int mark,
                            int only_if, int lut, int count_val, void* count,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  long long resident = 0;  // a cooperative grid must be all resident
  ROOMY_TRY(resident_blocks(mark_rotate_count_kernel, &resident));
  ROOMY_TRY(cudaMemsetAsync(count, 0, sizeof(unsigned int), s));
  const uint32_t* in_p = (const uint32_t*)in;
  uint32_t* out_p = (uint32_t*)out;
  const int32_t* idx_p = (const int32_t*)idx;
  int vec = aligned16(out, out);  // phase 2 reads and writes out only
  uint32_t mark_u = (uint32_t)mark, only_u = (uint32_t)only_if;
  uint32_t lut_u = (uint32_t)lut, cval_u = (uint32_t)count_val;
  unsigned int* count_p = (unsigned int*)count;
  void* args[] = {&in_p, &out_p, &n_words, &vec, &idx_p, &m,
                  &mark_u, &only_u, &lut_u, &cval_u, &count_p};
  ROOMY_TRY(cudaLaunchCooperativeKernel((const void*)mark_rotate_count_kernel,
                                        dim3((unsigned int)resident),
                                        dim3(kThreads),
                                        args, 0, s));
  return (int)cudaGetLastError();
}

int roomy_scatter_mark_binned(const void* in, void* out, long long n_words,
                              const void* idx, long long m, int mark,
                              int only_if, int g, long long per_block,
                              void* counts, void* tile_total,
                              void* tile_start, void* bins, void* stream) {
  return binned<false>(in, out, n_words, idx, m, g, per_block, counts,
                       tile_total, tile_start, bins, (uint32_t)mark,
                       (uint32_t)only_if, 0u, 0u, nullptr,
                       (cudaStream_t)stream);
}

int roomy_mark_rotate_count_binned(const void* in, void* out,
                                   long long n_words, const void* idx,
                                   long long m, int mark, int only_if,
                                   int lut, int count_val, void* count,
                                   int g, long long per_block, void* counts,
                                   void* tile_total, void* tile_start,
                                   void* bins, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  ROOMY_TRY(cudaMemsetAsync(count, 0, sizeof(unsigned int), s));
  return binned<true>(in, out, n_words, idx, m, g, per_block, counts,
                      tile_total, tile_start, bins, (uint32_t)mark,
                      (uint32_t)only_if, (uint32_t)lut, (uint32_t)count_val,
                      count, s);
}

// K4 over one flat array (the reference's API): int32 indices, int32 codes.
int roomy_gather2(const void* words, long long n_words, const void* idx,
                  long long m, void* out, void* stream) {
  return gather2<int32_t, int32_t>(
      nullptr, 1, make_longlong2((long long)(uintptr_t)words, n_words),
      1ll << 31, idx, m, out, (cudaStream_t)stream);
}

// K4 over a device table of n_chunks (word pointer, n_words) entries:
// int64 ranks, uint8 codes; a null entry's bytes are left as they were.
int roomy_gather2_chunked(const void* table, int n_chunks,
                          long long chunk_elems, const void* ranks,
                          long long m, void* out, void* stream) {
  return gather2<long long, uint8_t>(table, n_chunks, make_longlong2(0, 0),
                                     chunk_elems, ranks, m, out,
                                     (cudaStream_t)stream);
}

}  // extern "C"
