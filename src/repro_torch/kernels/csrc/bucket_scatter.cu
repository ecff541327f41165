// Hopper (sm_90a) segment scatter-add: the apply phase of a Roomy sync.
//
//   roomy_bucket_scatter_add  K5  replaces _scatter_kernel of
//                                 repro/kernels/bucket_scatter.py (wrapper
//                                 bucket_scatter_add at :65, pallas_call at
//                                 :90)
//
// out = table; out[idx[i]] += payload[i] for every op i, in float32.
// table (N, D) float32 with a row stride, idx (M,) int32, payload (M, D)
// float32 with a row stride; out (N, D) float32, contiguous.
//
// The contract for indices is the oracle's (repro/kernels/ref.py:240,
// `.at[idx].add(mode="drop")`): an index in [-N, 0) wraps to idx + N, and
// an index below -N or at or above N is dropped.
//
// What bounds it on an H100 is memory traffic: the table read and the
// output written once (8ND bytes), the indices and the payload read once
// (4M + 4MD).  One float add per payload element is far below the ~300
// operations a byte where the card stops being bandwidth-bound.
//
// The order of the sums, the same bits on every run for every input.  A
// row's ops, in op order, fall into chunks of kChunk (G = 256) consecutive
// ops.  Each chunk's sum s_k = ((p_kG + p_kG+1) + ...) is taken left to
// right from its first payload, and the row's output is
//   out[r] = table[r] + (((s_0 + s_1) + s_2) + ...),
// so a row of at most G ops gets the TPU kernel's own arithmetic for a
// sorted run, table + (p0 + p1 + ...); a row with no op is copied.  No
// atomic touches a float.  ref.bucket_scatter_add_ordered is the plain
// mirror of this order.
//
// Where a row's ops are.  The kept ops, grouped by row with op order kept
// within a row, form a position list; row r's ops are the positions
// [start(r), end(r)), and position p's row is its key.
// * Sorted route (idx nondecreasing and no index in [-N, 0): a sync's
//   sorted queue, a prefix or chain round): the list is idx itself,
//   position p is op p and its key idx[p].  check_kernel reads idx once and
//   sets the header's binned flag where the input is not of this form;
//   tile_bounds_kernel finds each row tile's first position by binary
//   search.
// * Binned route (everything else, e.g. a roomy embedding's unsorted token
//   ids): bin_kernel, one cooperative launch, sorts the kept ops by row
//   with stable counting-sort passes (no sort call); position p is op
//   bins[p] and its key that op's row.  A pass sorts by a digit of the
//   row: W warps take contiguous slices of the pass's input; mat[b * W + w]
//   counts slice w's ops of digit b (one warp-aggregated atomicAdd per digit
//   a 32-op step, __match_any_sync); an exclusive scan in (digit, slice)
//   order gives each its first slot; each slice is walked again and op p
//   goes to its slot plus its rank among the step's lanes of its digit, the
//   leader advancing the cursor with an atomic whose return the warp waits
//   for.  One warp walks a slice in order and slices are ordered by w, so a
//   pass is stable.  One pass takes the row itself as the digit while the
//   matrix (rows x W) fits its budget; past that (N >= 2^22 rows, say) the
//   passes take the row's bits from the lowest, `bits` a pass (LSD), so the
//   matrix stays at most 2^bits x W and every pass keeps W warps however
//   large N is.  The passes ping-pong between bins and a second list that
//   lies in the tasks' space (the tasks are made after the last pass).
//   The same launch then takes the tile bounds from the last pass's counts
//   (a bucket's end is its last slice's cursor; where the last digit is
//   not the whole row, a binary search within the bucket) and makes the
//   tasks (below).
// The kernels of the route not taken read the flag and return at once:
// the route is chosen on the device and nothing synchronises with the
// host.
//
// Rows of two ops or more are tasks, summed before the pass over the table
// by chunk_sum_kernel (blocks over (task, 256 column vectors); 32 payload
// loads in flight a thread, the binned route's next 32 op numbers loading
// with them, then the adds in order).  A row of at most G ops is one task,
// which reads its table row, adds its sum and stores its output row.  A
// longer row's chunks are tasks of their own: chunk 0 into heads[s / G],
// chunk k >= 1 into partials[(s + kG) / G] (chunk starts of one row lie G
// apart and those of two rows more than G apart, so each slot has one
// owner).  A task starts at the position s + 1 of a row [s, e) of two ops
// or more, where key(p) == key(p - 1) != key(p - 2); its thread finds the
// row's end by galloping: check_kernel's threads do this for the sorted
// route, bin_kernel's for the binned one.
//
// The pass over the table, tile_kernel: a persistent grid (the blocks the
// SMs hold at once) walks tiles of tile_rows rows, at most kTileVecs
// vectors and kMaxTileRows rows (D = 1 takes 4096 rows a tile, D = 1536
// twenty-one, D = 2304 fourteen), V = 4 floats a vector where D, both row
// strides and the base pointers allow 16-byte access, else 1.  Per tile:
// the first pass's table loads; each row's bounds into shared memory (the
// tile's keys staged in shared memory, each position marking its run's
// first and last; by binary search where the tile has more than kScanMax
// positions); then passes of P vectors a thread, consecutive threads on
// consecutive vectors (so at D = 1 a warp's lanes take 32 consecutive
// rows, at wide D the threads take columns): the table loads and each
// one-op row's payload in flight together, then a row with no op is
// copied, a row of one op added to, a long row's head and partials added
// in order, and a row of two to G ops left to its task.  Each table row is
// read once and each output row written once.  D = 1 with a contiguous,
// aligned table takes four rows a 16-byte vector (tile_pass_quad).  Each
// route has its own kernel, both launched, the other returning at once,
// so each holds only its own registers; a multiply by a magic number (Div)
// keeps 64-bit divides out of the per-element path.
//
// Launches, all on the given stream, none synchronising: a memset of the
// header, check_kernel, tile_bounds_kernel, bin_kernel (cooperative),
// chunk_sum_kernel, tile_kernel (both routes).  The wrapper allocates all
// scratch with torch.empty (the int workspace laid out by `carve`, and the
// partials and heads); the kernels allocate nothing.
//
// Plain C interface, loaded with ctypes.  The function returns the first
// launch error or cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr long long kChunk = 256;     // G: ops a chunk of a row's sum
constexpr int kMaxTileRows = 4096;    // rows a tile at most
// Vectors a thread takes in a pass over a tile: 4 of 4 floats, or 8
// single floats.
template <int V> struct Per { static constexpr int value = V == 4 ? 4 : 8; };
constexpr int kTileBlocks = 3;        // tile-kernel blocks an SM holds
constexpr int kScanMax = 4096;        // positions a tile's scan stages
constexpr int kScanChunk = 2048;      // matrix entries a scan step
constexpr int kScanPer = kScanChunk / kThreads;
constexpr int kTileVecs = 8192;       // vectors a tile at most (2 passes
                                      // of single floats, 8 of float4)
// [0] binned, [1] sorted tasks, [2] binned tasks, [3] binned positions
constexpr int kHeaderInts = 4;
constexpr int kTaskInts = 2;          // first position, row end (~end:
                                      // a chunk past the row's first)
constexpr int kBlocksPerSm = 16;      // grids of the small kernels
constexpr int kBinBlocksPerSm = 2;    // bin_kernel's cooperative grid
constexpr long long kMatBudget = 1LL << 22;  // digit x slice counts

template <int V> struct Vec;
template <> struct Vec<4> { typedef float4 T; };
template <> struct Vec<1> { typedef float T; };

__device__ __forceinline__ float4 vadd(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float vadd(float a, float b) { return a + b; }

template <int V>
__device__ __forceinline__ typename Vec<V>::T vld(const float* p) {
  return __ldg(reinterpret_cast<const typename Vec<V>::T*>(p));
}
template <int V>
__device__ __forceinline__ typename Vec<V>::T vld_stream(const float* p) {
  return __ldcs(reinterpret_cast<const typename Vec<V>::T*>(p));
}
template <int V>
__device__ __forceinline__ void vst_stream(float* p, typename Vec<V>::T v) {
  __stcs(reinterpret_cast<typename Vec<V>::T*>(p), v);
}
template <int V>
__device__ __forceinline__ void vst(float* p, typename Vec<V>::T v) {
  *reinterpret_cast<typename Vec<V>::T*>(p) = v;
}

// x / d for 0 <= x < 2^31 as (x * m) >> (32 + s), s = ceil(log2 d),
// m = ceil(2^(32+s) / d): a multiply where a 64-bit division by a runtime
// value would cost ~100 instructions an element.
struct Div {
  unsigned long long m;
  int s;
};
__device__ __forceinline__ long long fdiv(long long x, Div q) {
  return (long long)(((unsigned long long)x * q.m) >> (32 + q.s));
}

// Row of index v, or -1 where the op drops.
__device__ __forceinline__ long long row_of(int v, long long n) {
  const long long r = v < 0 ? (long long)v + n : (long long)v;
  return (r >= 0 && r < n) ? r : -1;
}

__device__ __forceinline__ bool binned_route(const int* header) {
  return *(volatile const int*)header != 0;
}

__device__ __forceinline__ long long grid_start() {
  return (long long)blockIdx.x * blockDim.x + threadIdx.x;
}
__device__ __forceinline__ long long grid_step() {
  return (long long)gridDim.x * blockDim.x;
}

// A position's op and key (its row, or an index past the rows on the
// sorted route): op p and idx[p] on the sorted route, op bins[p] and its
// row on the binned one.
// bins is read with plain loads: bin_kernel reads it after other blocks
// of its own launch wrote it.
template <bool kBinned>
struct Keys {
  const int* idx;
  const int* bins;
  long long n;
  __device__ __forceinline__ int operator()(long long p) const {
    return kBinned ? (int)row_of(__ldg(idx + bins[p]), n) : __ldg(idx + p);
  }
};

// First position in [lo, hi) whose key is >= v (or > v when kAfter).
template <bool kAfter, class K>
__device__ __forceinline__ long long search(const K& key, long long lo,
                                            long long hi, int v) {
  while (lo < hi) {
    const long long mid = lo + (hi - lo) / 2;
    const int x = key(mid);
    if (kAfter ? x <= v : x < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Row [s, e) has two ops or more.  Up to kChunk ops it is one task: its
// output row, summed and written whole by chunk_sum_kernel.  Longer, each
// chunk is a task: chunk 0 (q = s, end e) into heads[s / kChunk], chunks
// 1, 2, ... (q, ~e) into partials[q / kChunk].  One atomic claims the
// row's slots; at most `cap` in all.
__device__ void emit_row(int* count, int* __restrict__ tasks, long long cap,
                         long long s, long long e) {
  const long long k = e - s <= kChunk ? 1 : (e - s + kChunk - 1) / kChunk;
  const long long slot = atomicAdd(count, (int)(k < cap ? k : cap));
  for (long long i = 0; i < k && slot >= 0 && slot + i < cap; ++i) {
    tasks[kTaskInts * (slot + i)] = (int)(s + i * kChunk);
    tasks[kTaskInts * (slot + i) + 1] = i == 0 ? (int)e : ~(int)e;
  }
}

// First position in [p, m) whose key is not v (key(p) == v, keys
// nondecreasing): galloping, then binary search.
template <class K>
__device__ __forceinline__ long long run_end(const K& key, long long p,
                                             long long m, int v) {
  long long step = 1, lo = p;
  while (lo + step < m && key(lo + step) == v) {
    lo += step;
    step *= 2;
  }
  const long long hi = lo + step < m ? lo + step : m;
  return search<true>(key, lo, hi, v);
}

// Position p (1 <= p < m) of nondecreasing keys, u = key(p - 1) and
// v = key(p): where p is the second position of a row (v a row, u == v,
// and key(p - 2) != v), the row's tasks.
template <class K>
__device__ __forceinline__ void row_tasks(const K& key, long long m,
                                          long long n, long long p, int u,
                                          int v, int* count,
                                          int* __restrict__ tasks,
                                          long long cap) {
  if (u == v && p >= 1 && v >= 0 && (long long)v < n &&
      (p == 1 || key(p - 2) != v))
    emit_row(count, tasks, cap, p - 1, run_end(key, p, m, v));
}

// ------------------------------------------------------------ the check

// One read of idx: the binned flag (an index in [-N, 0), or a step down)
// and the sorted route's tasks (row_tasks).  Only where idx[p] ==
// idx[p - 1] does a thread look further.
__device__ __forceinline__ void check_one(const int* __restrict__ idx,
                                          long long m, long long n,
                                          long long p, int u, int v,
                                          bool& bad, int* header,
                                          int* __restrict__ tasks,
                                          long long cap) {
  bad |= u > v || (v < 0 && (long long)v >= -n);
  const Keys<false> key{idx, nullptr, n};
  row_tasks(key, m, n, p, u, v, header + 1, tasks, cap);
}

// kVec: idx 16-byte aligned, read four positions a thread with one load.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
check_kernel(const int* __restrict__ idx, long long m, long long n,
             int* header, int* __restrict__ tasks, long long cap) {
  bool bad = false;
  if (kVec) {
    const long long groups = m / 4;
    for (long long g = grid_start(); g < groups; g += grid_step()) {
      const int4 q = __ldg(reinterpret_cast<const int4*>(idx) + g);
      const long long p = 4 * g;
      const int prev = p > 0 ? __ldg(idx + p - 1) : q.x;
      check_one(idx, m, n, p, prev, q.x, bad, header, tasks, cap);
      check_one(idx, m, n, p + 1, q.x, q.y, bad, header, tasks, cap);
      check_one(idx, m, n, p + 2, q.y, q.z, bad, header, tasks, cap);
      check_one(idx, m, n, p + 3, q.z, q.w, bad, header, tasks, cap);
    }
    for (long long p = 4 * groups + grid_start(); p < m; p += grid_step())
      check_one(idx, m, n, p, p > 0 ? __ldg(idx + p - 1) : __ldg(idx + p),
                __ldg(idx + p), bad, header, tasks, cap);
  } else {
    for (long long p = grid_start(); p < m; p += grid_step())
      check_one(idx, m, n, p, p > 0 ? __ldg(idx + p - 1) : __ldg(idx + p),
                __ldg(idx + p), bad, header, tasks, cap);
  }
  if (__syncthreads_or(bad) && threadIdx.x == 0) atomicOr(header, 1);
}

// The sorted route's tile bounds: tile t's ops are the positions
// [tile_start[t], tile_start[t + 1]), by binary search over idx, a thread
// a tile.
__global__ void __launch_bounds__(kThreads)
tile_bounds_kernel(const int* __restrict__ idx, long long m, long long n,
                   long long tile_rows, long long n_tiles,
                   int* __restrict__ tile_start, const int* header) {
  if (binned_route(header)) return;
  const Keys<false> key{idx, nullptr, n};
  for (long long t = grid_start(); t <= n_tiles; t += grid_step()) {
    const long long r = t * tile_rows < n ? t * tile_rows : n;
    tile_start[t] = (int)search<false>(key, 0, m, (int)r);
  }
}

// ------------------------------------------------ the binned route: bins

// Block-wide exclusive scan of one int a thread; *total gets the sum.
__device__ __forceinline__ int block_exclusive(int x, int* total) {
  __shared__ int warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int s = lane < kThreads / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < kThreads / 32) warp_sums[lane] = s;
  }
  __syncthreads();
  const int before = warp > 0 ? warp_sums[warp - 1] : 0;
  *total = warp_sums[kThreads / 32 - 1];
  __syncthreads();                               // warp_sums reused
  return before + inc - x;
}

// One pass's walk of the slices: warp w takes positions [w * per,
// min((w + 1) * per, m)) of the pass's input (op p itself in the first
// pass, src[p] after it; positions from `len` on are empty) and counts
// each op's digit of its row (kScatter false) or puts the op at its slot
// in dst (true).
template <bool kScatter>
__device__ __forceinline__ void bin_walk(
    const int* __restrict__ idx, long long m, long long n, long long len,
    const int* src, int* dst, int* mat, long long warps, int shift,
    int mask) {
  const int lane = threadIdx.x & 31;
  const long long per = (m + warps - 1) / warps;
  for (long long w = grid_start() / 32; w < warps; w += grid_step() / 32) {
    const long long begin = w * per;
    const long long end = begin + per < len ? begin + per : len;
    for (long long base = begin; base < end; base += 32) {
      const long long p = base + lane;
      int op = -1, b = -1;
      if (p < end) {
        op = src == nullptr ? (int)p : src[p];
        const long long r = row_of(__ldg(idx + op), n);
        if (r >= 0) b = (int)(r >> shift) & mask;
      }
      const unsigned peers = __match_any_sync(0xffffffffu, b);
      const int leader = __ffs(peers) - 1;
      const bool lead = b >= 0 && lane == leader;
      if (!kScatter) {
        if (lead) atomicAdd(mat + (long long)b * warps + w, __popc(peers));
        continue;
      }
      int slot = 0;
      if (lead) slot = atomicAdd(mat + (long long)b * warps + w,
                                 __popc(peers));
      slot = __shfl_sync(0xffffffffu, slot, leader);
      if (b >= 0) dst[slot + __popc(peers & ((1u << lane) - 1u))] = op;
    }
  }
}

// a[0, len) becomes its exclusive scan across the grid; *total gets the
// sum.  sums holds a step's sum, a step kScanChunk entries.
__device__ void grid_exclusive(cg::grid_group& grid, int* a, long long len,
                               int* sums, int* total) {
  __shared__ int buf[kScanChunk];
  const long long steps = (len + kScanChunk - 1) / kScanChunk;
  for (long long c = blockIdx.x; c < steps; c += gridDim.x) {
    int s = 0;
    for (int i = threadIdx.x; i < kScanChunk; i += kThreads) {
      const long long j = c * kScanChunk + i;
      if (j < len) s += a[j];
    }
    int t;
    block_exclusive(s, &t);
    if (threadIdx.x == 0) sums[c] = t;
  }
  grid.sync();
  if (blockIdx.x == 0) {
    int carry = 0;
    for (long long base = 0; base < steps; base += kThreads) {
      const long long j = base + threadIdx.x;
      const int x = j < steps ? sums[j] : 0;
      int t;
      const int ex = block_exclusive(x, &t);
      if (j < steps) sums[j] = carry + ex;
      carry += t;
    }
    if (threadIdx.x == 0) *total = carry;
  }
  grid.sync();
  // each step read coalesced into shared memory, scanned kScanPer
  // consecutive entries a thread, written back coalesced
  for (long long c = blockIdx.x; c < steps; c += gridDim.x) {
    const long long base = c * kScanChunk;
    for (int i = threadIdx.x; i < kScanChunk; i += kThreads)
      buf[i] = base + i < len ? a[base + i] : 0;
    __syncthreads();
    int x[kScanPer];
    int s = 0;
#pragma unroll
    for (int u = 0; u < kScanPer; ++u) {
      x[u] = buf[threadIdx.x * kScanPer + u];
      s += x[u];
    }
    int t;
    int run = sums[c] + block_exclusive(s, &t);
#pragma unroll
    for (int u = 0; u < kScanPer; ++u) {
      buf[threadIdx.x * kScanPer + u] = run;
      run += x[u];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kScanChunk; i += kThreads)
      if (base + i < len) a[base + i] = buf[i];
    __syncthreads();
  }
  grid.sync();
}

// The binned route, one cooperative launch: `passes` stable counting
// sorts of the kept ops by a digit of their row, `bits` bits a pass from
// the lowest (the last pass takes the rest; one pass takes the whole row),
// into bins, header[3] the number of kept ops; then the tile bounds from
// the last pass's counts and the tasks over the keys of bins.
__global__ void __launch_bounds__(kThreads)
bin_kernel(const int* __restrict__ idx, long long m, long long n,
           long long warps, int passes, int bits, int* mat, int* sums,
           int* bins, int* alt, int* header, int* __restrict__ tasks,
           long long cap, long long tile_rows, long long n_tiles,
           int* __restrict__ tile_start) {
  if (!binned_route(header)) return;
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < passes; ++i) {
    const bool last = i == passes - 1;
    const int shift = i * bits;
    const long long buckets = last ? ((n - 1) >> shift) + 1 : 1LL << bits;
    const long long len = buckets * warps;
    int* dst = (passes - 1 - i) % 2 == 0 ? bins : alt;
    const int* src = i == 0 ? nullptr : (passes - i) % 2 == 0 ? bins : alt;
    const long long kept = i == 0 ? m : *(volatile int*)(header + 3);
    const int mask = last ? -1 : (1 << bits) - 1;
    for (long long j = grid_start(); j < len; j += grid_step()) mat[j] = 0;
    grid.sync();
    bin_walk<false>(idx, m, n, kept, src, dst, mat, warps, shift, mask);
    grid.sync();
    grid_exclusive(grid, mat, len, sums, header + 3);
    bin_walk<true>(idx, m, n, kept, src, dst, mat, warps, shift, mask);
    grid.sync();
  }
  // Tile t's first position: the last pass's digit bucket b of its first
  // row r spans [end(b - 1), end(b)), an end being the cursor of the
  // bucket's last slice; within it, the first key >= r (b itself where
  // the digit is the row).
  const long long kept = *(volatile int*)(header + 3);
  const Keys<true> key{idx, bins, n};
  const int top = (passes - 1) * bits;
  for (long long t = grid_start(); t <= n_tiles; t += grid_step()) {
    const long long r = t * tile_rows;
    long long p = kept;
    if (r < n) {
      const long long b = r >> top;
      p = b > 0 ? mat[(b - 1) * warps + warps - 1] : 0;
      if (top > 0)
        p = search<false>(key, p, mat[b * warps + warps - 1], (int)r);
    }
    tile_start[t] = (int)p;
  }
  for (long long p = grid_start() + 1; p < kept; p += grid_step())
    row_tasks(key, kept, n, p, key(p - 1), key(p), header + 2, tasks, cap);
}

// ------------------------------------------------------ chunk sums

// acc + the payload rows at positions [p, e), column c (in vectors), left
// to right: U loads in flight, then the adds in order.  Position p is op
// bins[p] (binned: the next U op numbers load while these U rows do) or op
// p (sorted).
template <int V, int U, bool kBinned>
__device__ __forceinline__ typename Vec<V>::T add_run(
    typename Vec<V>::T acc, const float* __restrict__ pay, long long ps,
    long long c, long long p, long long e, const int* __restrict__ bins) {
  typedef typename Vec<V>::T T;
  const float* col = pay + c * V;
  int op[U];
#pragma unroll
  for (int u = 0; u < U; ++u)
    op[u] = kBinned && p + U <= e ? __ldg(bins + p + u) : (int)(p + u);
  for (; p + U <= e; p += U) {
    T x[U];
#pragma unroll
    for (int u = 0; u < U; ++u) x[u] = vld<V>(col + (long long)op[u] * ps);
#pragma unroll
    for (int u = 0; u < U; ++u)
      op[u] = kBinned && p + 2 * U <= e ? __ldg(bins + p + U + u)
                                        : (int)(p + U + u);
#pragma unroll
    for (int u = 0; u < U; ++u) acc = vadd(acc, x[u]);
  }
  for (; p < e; ++p)
    acc = vadd(acc, vld<V>(col + (kBinned ? (long long)__ldg(bins + p) : p) *
                                     ps));
  return acc;
}

// Blocks over (task, block of kThreads column vectors); a thread sums its
// column of the task's ops from the first, left to right.  A whole row
// (two to kChunk ops) is added to its table row and stored; a chunk of a
// longer row goes to heads or partials.
template <int V, bool kBinned>
__device__ __forceinline__ void task_sums(
    const float* __restrict__ table, long long ts, float* __restrict__ out,
    long long n, long long d, const int* __restrict__ idx,
    const float* __restrict__ pay, long long ps, const int* __restrict__ bins,
    const int* __restrict__ tasks, long long ntask,
    float* __restrict__ partials, float* __restrict__ heads) {
  const long long dv = d / V;
  const long long ncb = (dv + kThreads - 1) / kThreads;
  for (long long w = blockIdx.x; w < ntask * ncb; w += gridDim.x) {
    const long long t = w / ncb;
    const long long c = (w - t * ncb) * kThreads + threadIdx.x;
    if (c >= dv) continue;
    const long long q = __ldg(tasks + kTaskInts * t);
    const int x = __ldg(tasks + kTaskInts * t + 1);
    const long long end = x < 0 ? ~x : x;
    const long long e = q + kChunk < end ? q + kChunk : end;
    const long long op = kBinned ? (long long)__ldg(bins + q) : q;
    const typename Vec<V>::T acc = add_run<V, 32, kBinned>(
        vld<V>(pay + op * ps + c * V), pay, ps, c, q + 1, e, bins);
    if (x < 0) {
      vst<V>(partials + (q / kChunk) * d + c * V, acc);
    } else if (end - q > kChunk) {
      vst<V>(heads + (q / kChunk) * d + c * V, acc);
    } else {
      const long long r = row_of(__ldg(idx + op), n);
      vst_stream<V>(out + r * d + c * V,
                    vadd(vld_stream<V>(table + r * ts + c * V), acc));
    }
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads)
chunk_sum_kernel(const float* __restrict__ table, long long ts,
                 float* __restrict__ out, long long n, long long d,
                 const int* __restrict__ idx, const float* __restrict__ pay,
                 long long ps, const int* __restrict__ bins,
                 const int* header, const int* __restrict__ tasks,
                 long long cap, float* __restrict__ partials,
                 float* __restrict__ heads) {
  const bool binned = binned_route(header);
  long long ntask = *(volatile const int*)(header + (binned ? 2 : 1));
  if (ntask > cap) ntask = cap;
  if (binned)
    task_sums<V, true>(table, ts, out, n, d, idx, pay, ps, bins, tasks, ntask,
                       partials, heads);
  else
    task_sums<V, false>(table, ts, out, n, d, idx, pay, ps, bins, tasks,
                        ntask, partials, heads);
}

// ------------------------------------------------------ the table pass

// The row's chunks 1, 2, ... (partials) added to acc in order.
template <int V>
__device__ __forceinline__ typename Vec<V>::T add_partials(
    typename Vec<V>::T acc, const float* partials, long long d, long long c,
    long long s, long long e) {
  typedef typename Vec<V>::T T;
  long long q = s + kChunk;
  for (; q + 3 * kChunk < e; q += 4 * kChunk) {
    T x[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      x[k] = vld<V>(partials + (q / kChunk + k) * d + c * V);
#pragma unroll
    for (int k = 0; k < 4; ++k) acc = vadd(acc, x[k]);
  }
  for (; q < e; q += kChunk)
    acc = vadd(acc, vld<V>(partials + (q / kChunk) * d + c * V));
  return acc;
}

// The bounds of the rows of a tile whose positions are [lo, hi): where
// hi - lo <= kScanMax, the keys staged in shared memory with their loads
// in flight together, then each position marks its run's first and last
// (rows start empty); else each row's bounds by binary search.
template <int K, class Keys_>
__device__ __forceinline__ void tile_row_bounds(const Keys_& key, int lo,
                                                int hi, int rows,
                                                long long r0, int* row_lo,
                                                int* row_hi, int* buf) {
  if (hi - lo > kScanMax) {
    for (int r = threadIdx.x; r < rows; r += kThreads) {
      const int s = (int)search<false>(key, lo, hi, (int)(r0 + r));
      row_lo[r] = s;
      row_hi[r] = (int)search<true>(key, s, hi, (int)(r0 + r));
    }
    return;
  }
  for (int base = 0; base < hi - lo; base += K * kThreads) {
    int v[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int p = lo + base + (int)threadIdx.x + k * kThreads;
      if (p < hi) v[k] = key(p);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = base + (int)threadIdx.x + k * kThreads;
      if (lo + i < hi) buf[i] = v[k];
    }
  }
  for (int r = threadIdx.x; r < rows; r += kThreads) row_lo[r] = row_hi[r] = 0;
  __syncthreads();
  const int len = hi - lo;
  for (int i = threadIdx.x; i < len; i += kThreads) {
    const int x = buf[i];
    const int r = (int)(x - r0);
    if (i == 0 || buf[i - 1] != x) row_lo[r] = lo + i;
    if (i == len - 1 || buf[i + 1] != x) row_hi[r] = lo + i + 1;
  }
}

// The tiles of this block.  Per tile: the rows' bounds into shared
// memory; then passes of P vectors a thread: the table loads and every
// vector's operand (its row's one payload, or a long row's head) in flight
// together, then a vector at a time: a row with no op is copied, one op
// added, a long row's partials added in order after its head; a row of two
// to kChunk ops is left to its task.
template <int V, bool kBinned>
__device__ __forceinline__ void tile_pass(
    int* row_lo, int* row_hi, int* buf, const float* __restrict__ table,
    long long ts,
    float* __restrict__ out, long long n, long long d,
    const int* __restrict__ idx, const float* __restrict__ pay, long long ps,
    long long tile_rows, long long n_tiles, Div cols,
    const int* __restrict__ tile_start, const int* __restrict__ bins,
    const float* __restrict__ partials, const float* __restrict__ heads) {
  typedef typename Vec<V>::T T;
  constexpr int P = Per<V>::value;
  const int dv = (int)(d / V);
  // element el of a tile is row el / dv, column vector el % dv
  auto row = [&](int el) { return (int)fdiv(el, cols); };
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long r0 = t * tile_rows;
    const int rows = (int)(n - r0 < tile_rows ? n - r0 : tile_rows);
    const int nel = rows * dv;
    T tv[P], first[P];
    // the first pass's table loads, in flight while the bounds come in
#pragma unroll
    for (int u = 0; u < P; ++u) {
      const int el = (int)threadIdx.x + u * kThreads;
      const long long r = row(el);
      if (el < nel)
        tv[u] = vld_stream<V>(table + (r0 + r) * ts + (el - r * dv) * V);
    }
    tile_row_bounds<2>(Keys<kBinned>{idx, bins, n}, __ldg(tile_start + t),
                       __ldg(tile_start + t + 1), rows, r0, row_lo, row_hi,
                       buf);
    __syncthreads();
    for (int base = 0; base < nel; base += P * kThreads) {
      int op[P];
      if (kBinned) {
#pragma unroll
        for (int u = 0; u < P; ++u) {
          const int el = base + (int)threadIdx.x + u * kThreads;
          const int r = el < nel ? row(el) : 0;
          const int s = row_lo[r], e = row_hi[r];
          op[u] = el < nel && e - s == 1 ? __ldg(bins + s) : 0;
        }
      }
#pragma unroll
      for (int u = 0; u < P; ++u) {
        const int el = base + (int)threadIdx.x + u * kThreads;
        const int r = el < nel ? row(el) : 0;
        const long long c = el - (long long)r * dv;
        const int s = row_lo[r], e = row_hi[r];
        const bool mine = el < nel && (e - s < 2 || e - s > kChunk);
        if (mine && base > 0)
          tv[u] = vld_stream<V>(table + (r0 + r) * ts + c * V);
        if (mine && e - s == 1)
          first[u] = vld<V>(pay + c * V + (kBinned ? (long long)op[u]
                                                   : (long long)s) * ps);
        if (mine && e - s > kChunk)
          first[u] = vld<V>(heads + (long long)(s / kChunk) * d + c * V);
      }
#pragma unroll
      for (int u = 0; u < P; ++u) {
        const int el = base + (int)threadIdx.x + u * kThreads;
        if (el >= nel) break;
        const int r = row(el);
        const long long c = el - (long long)r * dv;
        const int s = row_lo[r], e = row_hi[r];
        if (e - s >= 2 && e - s <= kChunk) continue;  // its task's row
        T v = tv[u];
        if (e - s == 1)
          v = vadd(v, first[u]);
        else if (e - s > kChunk)
          v = vadd(v, add_partials<V>(first[u], partials, d, c, s, e));
        vst_stream<V>(out + (r0 + r) * d + c * V, v);
      }
    }
    __syncthreads();                 // row_lo / row_hi serve the next tile
  }
}

// D = 1 with a contiguous, 16-byte aligned table and rows a multiple of
// four: a thread takes four consecutive rows as one 16-byte vector of the
// table and of the output (a row of two to kChunk ops, its task's, is
// left as the task stored it: the other rows are then stored singly).
// Tiles of kMaxTileRows rows: the tile's positions in one round trip,
// then one pass.
template <bool kBinned>
__device__ __forceinline__ void tile_pass_quad(
    int* row_lo, int* row_hi, int* buf, const float* __restrict__ table,
    float* __restrict__ out, long long n, const int* __restrict__ idx,
    const float* __restrict__ pay, long long ps, long long n_tiles,
    const int* __restrict__ tile_start, const int* __restrict__ bins,
    const float* __restrict__ partials, const float* __restrict__ heads) {
  constexpr int Q = kMaxTileRows / 4 / kThreads;   // quads a thread
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long r0 = t * kMaxTileRows;
    const int rows = (int)(n - r0 < kMaxTileRows ? n - r0 : kMaxTileRows);
    const int nq = rows / 4;
    float4 tv[Q];
#pragma unroll
    for (int u = 0; u < Q; ++u) {
      const int q = (int)threadIdx.x + u * kThreads;
      if (q < nq) tv[u] = __ldcs(reinterpret_cast<const float4*>(table + r0) + q);
    }
    tile_row_bounds<kScanMax / kThreads>(
        Keys<kBinned>{idx, bins, n}, __ldg(tile_start + t),
        __ldg(tile_start + t + 1), rows, r0, row_lo, row_hi, buf);
    __syncthreads();
    float first[Q][4];
#pragma unroll
    for (int u = 0; u < Q; ++u) {
      const int q = (int)threadIdx.x + u * kThreads;
      const int4 lo4 = q < nq ? reinterpret_cast<const int4*>(row_lo)[q]
                              : make_int4(0, 0, 0, 0);
      const int4 hi4 = q < nq ? reinterpret_cast<const int4*>(row_hi)[q]
                              : make_int4(0, 0, 0, 0);
      const int s4[4] = {lo4.x, lo4.y, lo4.z, lo4.w};
      const int e4[4] = {hi4.x, hi4.y, hi4.z, hi4.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = s4[j], e = e4[j];
        if (e - s == 1)
          first[u][j] = __ldg(pay + (kBinned ? (long long)__ldg(bins + s)
                                             : (long long)s) * ps);
        else if (e - s > kChunk)
          first[u][j] = __ldg(heads + s / kChunk);
      }
    }
#pragma unroll
    for (int u = 0; u < Q; ++u) {
      const int q = (int)threadIdx.x + u * kThreads;
      if (q >= nq) break;
      const int4 lo4 = reinterpret_cast<const int4*>(row_lo)[q];
      const int4 hi4 = reinterpret_cast<const int4*>(row_hi)[q];
      const int s4[4] = {lo4.x, lo4.y, lo4.z, lo4.w};
      const int e4[4] = {hi4.x, hi4.y, hi4.z, hi4.w};
      float v[4] = {tv[u].x, tv[u].y, tv[u].z, tv[u].w};
      bool all = true;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = s4[j], e = e4[j];
        if (e - s == 1)
          v[j] = v[j] + first[u][j];
        else if (e - s > kChunk)
          v[j] = v[j] + add_partials<1>(first[u][j], partials, 1, 0, s, e);
        else if (e - s >= 2)
          all = false;
      }
      float* dst = out + r0 + 4 * (long long)q;
      if (all) {
        __stcs(reinterpret_cast<float4*>(dst), make_float4(v[0], v[1], v[2], v[3]));
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (e4[j] - s4[j] < 2 || e4[j] - s4[j] > kChunk) dst[j] = v[j];
      }
    }
    __syncthreads();                 // row_lo / row_hi serve the next tile
  }
}

// One kernel a route, each launched and each returning at once unless the
// header names its route, so that each holds only its own registers.
template <int V, bool kBinned, bool kQuad>
__global__ void __launch_bounds__(kThreads, kTileBlocks)
tile_kernel(const float* __restrict__ table, long long ts,
            float* __restrict__ out, long long n, long long d,
            const int* __restrict__ idx, const float* __restrict__ pay,
            long long ps, long long tile_rows, long long n_tiles, Div cols,
            const int* header, const int* __restrict__ tile_start,
            const int* __restrict__ bins, const float* __restrict__ partials,
            const float* __restrict__ heads) {
  __shared__ __align__(16) int row_lo[kMaxTileRows];
  __shared__ __align__(16) int row_hi[kMaxTileRows];
  __shared__ int buf[kScanMax];
  if (binned_route(header) != kBinned) return;
  if (kQuad)
    tile_pass_quad<kBinned>(row_lo, row_hi, buf, table, out, n, idx, pay, ps,
                            n_tiles, tile_start, bins, partials, heads);
  else
    tile_pass<V, kBinned>(row_lo, row_hi, buf, table, ts, out, n, d, idx, pay,
                          ps, tile_rows, n_tiles, cols, tile_start, bins,
                          partials, heads);
}

// ---------------------------------------------------------------- host

Div make_div(long long d) {
  Div q;
  q.s = 0;
  while ((1LL << q.s) < d) ++q.s;
  const unsigned long long num = 1ULL << (32 + q.s);
  q.m = num / (unsigned long long)d + (num % (unsigned long long)d != 0);
  return q;
}

struct Workspace {
  int *header, *tile_start, *mat, *sums, *bins, *tasks;
  long long ints;
};

// Entries of the count matrix: W x the rows (one pass) or W x 2^bits.
long long mat_len(long long n, long long warps, int passes, int bits) {
  return warps * (passes == 1 ? n : 1LL << bits);
}

// The int workspace's layout; the wrapper's `geometry` mirrors it.
Workspace carve(int* ws, long long m, long long n_tiles, long long mat,
                long long cap) {
  Workspace w;
  long long o = 0;
  w.header = ws + o; o += kHeaderInts;
  w.tile_start = ws + o; o += n_tiles + 1;
  w.mat = ws + o; o += mat;
  w.sums = ws + o; o += (mat + kScanChunk - 1) / kScanChunk;
  w.bins = ws + o; o += m;
  w.tasks = ws + o; o += kTaskInts * cap;
  w.ints = o;
  return w;
}

// Rows of two ops or more (m / 2), and a long row's chunks (2m / kChunk).
// kTaskInts * cap >= m: the binned passes' second list fits the tasks.
long long task_cap(long long m) {
  return m / 2 + 2 * ((m + kChunk - 1) / kChunk);
}

constexpr int kMaxDevices = 64;

// The blocks of kKernel an SM holds at once on device dev (with the
// shared-memory carveout at its most where max_shared), looked up once a
// device: the queries cost the host more than a launch does.
template <auto kKernel>
cudaError_t per_sm(int dev, bool max_shared, int* out) {
  static int cache[kMaxDevices];
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cache[dev] == 0) {
    cudaError_t e = cudaSuccess;
    if (max_shared)
      e = cudaFuncSetAttribute(kKernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    int blocks = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kKernel,
                                                        kThreads, 0);
    if (e != cudaSuccess) return e;
    if (blocks < 1) return cudaErrorInvalidConfiguration;
    cache[dev] = blocks;
  }
  *out = cache[dev];
  return cudaSuccess;
}

// The current device and its SMs, the count looked up once a device.
cudaError_t device_sms(int* dev, int* sms) {
  static int cache[kMaxDevices];
  cudaError_t e = cudaGetDevice(dev);
  if (e != cudaSuccess) return e;
  if (*dev < 0 || *dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cache[*dev] == 0) {
    e = cudaDeviceGetAttribute(&cache[*dev], cudaDevAttrMultiProcessorCount,
                               *dev);
    if (e != cudaSuccess) return e;
  }
  *sms = cache[*dev];
  return cudaSuccess;
}

unsigned grid(long long work, long long cap) {
  long long g = (work + kThreads - 1) / kThreads;
  if (g > cap) g = cap;
  return (unsigned)(g < 1 ? 1 : g);
}

// The route's tile kernel over a grid of the blocks the SMs hold at once.
template <int V, bool kBinned, bool kQuad>
cudaError_t launch_tiles(const float* table, long long ts, float* out,
                         long long n, long long d, const int* idx,
                         const float* pay, long long ps, long long tile_rows,
                         long long n_tiles, const Workspace& w,
                         const float* partials, const float* heads, int dev,
                         int sms, cudaStream_t s) {
  int resident = 0;
  const cudaError_t e =
      per_sm<tile_kernel<V, kBinned, kQuad>>(dev, true, &resident);
  if (e != cudaSuccess) return e;
  long long blocks = (long long)sms * resident;
  if (blocks > n_tiles) blocks = n_tiles;
  tile_kernel<V, kBinned, kQuad><<<(unsigned)blocks, kThreads, 0, s>>>(
      table, ts, out, n, d, idx, pay, ps, tile_rows, n_tiles,
      make_div(d / V), w.header, w.tile_start, w.bins, partials, heads);
  return cudaGetLastError();
}

// bin_kernel over a grid whose blocks are all resident at once, as
// grid.sync() needs.
cudaError_t launch_bins(const int* idx, long long m, long long n,
                        long long warps, int passes, int bits,
                        const Workspace& w, long long cap, long long tile_rows,
                        long long n_tiles, int dev, int sms,
                        cudaStream_t s) {
  int resident = 0;
  const cudaError_t e = per_sm<bin_kernel>(dev, false, &resident);
  if (e != cudaSuccess) return e;
  const unsigned blocks =
      (unsigned)sms * (unsigned)(resident < kBinBlocksPerSm ? resident
                                                            : kBinBlocksPerSm);
  int* alt = w.tasks;
  void* args[] = {(void*)&idx, (void*)&m, (void*)&n, (void*)&warps,
                  (void*)&passes, (void*)&bits, (void*)&w.mat,
                  (void*)&w.sums, (void*)&w.bins, (void*)&alt,
                  (void*)&w.header, (void*)&w.tasks, (void*)&cap,
                  (void*)&tile_rows, (void*)&n_tiles, (void*)&w.tile_start};
  return cudaLaunchCooperativeKernel((const void*)bin_kernel, blocks,
                                     kThreads, args, 0, s);
}

template <int V>
int launch(const float* table, long long ts, float* out, long long n,
           long long d, const int* idx, long long m, const float* pay,
           long long ps, long long tile_rows, long long n_tiles,
           long long warps, int passes, int bits, const Workspace& w,
           float* partials, float* heads, int dev, int sms, cudaStream_t s) {
  const long long small = (long long)sms * kBlocksPerSm;
  const long long few = (long long)sms * 2;   // kernels that may not run
  const long long cap = task_cap(m);
  cudaError_t e = cudaMemsetAsync(w.header, 0, kHeaderInts * sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  if (((uintptr_t)idx & 15) == 0)
    check_kernel<true><<<grid((m + 3) / 4, small), kThreads, 0, s>>>(
        idx, m, n, w.header, w.tasks, cap);
  else
    check_kernel<false><<<grid(m, small), kThreads, 0, s>>>(
        idx, m, n, w.header, w.tasks, cap);
  tile_bounds_kernel<<<grid(n_tiles + 1, few), kThreads, 0, s>>>(
      idx, m, n, tile_rows, n_tiles, w.tile_start, w.header);
  e = cudaGetLastError();
  if (e == cudaSuccess)
    e = launch_bins(idx, m, n, warps, passes, bits, w, cap, tile_rows,
                    n_tiles, dev, sms, s);
  if (e != cudaSuccess) return (int)e;
  chunk_sum_kernel<V><<<(unsigned)small, kThreads, 0, s>>>(
      table, ts, out, n, d, idx, pay, ps, w.bins, w.header, w.tasks, cap,
      partials, heads);
  const bool quad = V == 1 && d == 1 && ts == 1 && n % 4 == 0 &&
                    tile_rows == kMaxTileRows && ((uintptr_t)table & 15) == 0;
  if (V == 1 && quad) {
    e = launch_tiles<1, false, true>(table, ts, out, n, d, idx, pay, ps,
                                     tile_rows, n_tiles, w, partials, heads,
                                     dev, sms, s);
    if (e == cudaSuccess)
      e = launch_tiles<1, true, true>(table, ts, out, n, d, idx, pay, ps,
                                      tile_rows, n_tiles, w, partials, heads,
                                      dev, sms, s);
  } else {
    e = launch_tiles<V, false, false>(table, ts, out, n, d, idx, pay, ps,
                                      tile_rows, n_tiles, w, partials, heads,
                                      dev, sms, s);
    if (e == cudaSuccess)
      e = launch_tiles<V, true, false>(table, ts, out, n, d, idx, pay, ps,
                                       tile_rows, n_tiles, w, partials, heads,
                                       dev, sms, s);
  }
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

extern "C" {

const char* roomy_scatter_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// table: (n, d) float32, row stride table_stride, column stride 1; out:
// (n, d) float32, contiguous; idx: (m,) int32; pay: (m, d) float32, row
// stride pay_stride, column stride 1.  1 <= n, d, m < 2^31.  vec 4 takes
// 16-byte vectors (d and both strides multiples of 4, every pointer
// 16-byte aligned) or 1.  tile_rows * d / vec <= kTileVecs (or
// tile_rows = 1).  The binned route's passes: `warps` slices, `passes`
// passes of `bits` bits (the last the rest; one pass the whole row), the
// count matrix within kMatBudget.  ws: ws_ints ints, laid out by `carve`;
// scratch: scratch_floats floats, the partials then the heads.
int roomy_bucket_scatter_add(const void* table, long long table_stride,
                             void* out, long long n, long long d,
                             const void* idx, long long m, const void* pay,
                             long long pay_stride, long long vec,
                             long long tile_rows, long long warps,
                             long long passes, long long bits, void* ws,
                             long long ws_ints, void* scratch,
                             long long scratch_floats, void* stream) {
  const long long lim = 1LL << 31;
  if (n < 1 || d < 1 || m < 1 || n >= lim || d >= lim || m >= lim ||
      warps < 1 || tile_rows < 1 || (vec != 1 && vec != 4) ||
      d % vec != 0 || tile_rows > kMaxTileRows ||
      (tile_rows > 1 && tile_rows * (d / vec) > kTileVecs) ||
      passes < 1 || passes > 31 || bits < 1 || bits > 30 ||
      (passes - 1) * bits > 30 ||
      (passes > 1 && ((n - 1) >> ((passes - 1) * bits)) >= (1LL << bits)) ||
      mat_len(n, warps, (int)passes, (int)bits) > kMatBudget)
    return (int)cudaErrorInvalidValue;
  if (vec == 4 && (table_stride % 4 != 0 || pay_stride % 4 != 0 ||
                   ((uintptr_t)table | (uintptr_t)pay | (uintptr_t)out |
                    (uintptr_t)scratch) % 16 != 0))
    return (int)cudaErrorMisalignedAddress;
  const long long n_tiles = (n + tile_rows - 1) / tile_rows;
  const Workspace w = carve((int*)ws, m, n_tiles,
                            mat_len(n, warps, (int)passes, (int)bits),
                            task_cap(m));
  const long long windows = (m + kChunk - 1) / kChunk;
  if (w.ints != ws_ints || scratch_floats != 2 * windows * d)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  const cudaError_t e = device_sms(&dev, &sms);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  float* partials = (float*)scratch;
  float* heads = partials + windows * d;
  if (vec == 4)
    return launch<4>((const float*)table, table_stride, (float*)out, n, d,
                     (const int*)idx, m, (const float*)pay, pay_stride,
                     tile_rows, n_tiles, warps, (int)passes, (int)bits, w,
                     partials, heads, dev, sms, s);
  return launch<1>((const float*)table, table_stride, (float*)out, n, d,
                   (const int*)idx, m, (const float*)pay, pay_stride,
                   tile_rows, n_tiles, warps, (int)passes, (int)bits, w,
                   partials, heads, dev, sms, s);
}

}  // extern "C"
