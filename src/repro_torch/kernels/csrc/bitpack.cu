// Hopper (sm_90a) kernels for the packed 2-bit arrays of the implicit BFS
// and of the distance oracle's lookup.
//
// 16 two-bit fields per 32-bit word, field j at bits [2j, 2j+2).  The four
// kernels replace the Pallas TPU kernels of repro/kernels/bitpack.py:
//
//   roomy_scatter_mark       K2  _scatter_mark_kernel (bitpack.py:142,
//                                pallas_call at :201)
//   roomy_lut_count          K3  _lut_count_kernel (bitpack.py:71,
//                                pallas_call at :115)
//   roomy_mark_rotate_count  K1  _mark_rotate_count_kernel (bitpack.py:221,
//                                pallas_call at :297)
//   roomy_gather2            K4  _gather2_kernel (bitpack.py:327, wrapper
//                                bitpack_gather2 at :389, pallas_call at
//                                :426)
//
// What bounds them on an H100 is memory traffic, not arithmetic: a word
// needs a dozen integer operations, far below the ~300 operations per byte
// where the card stops being bandwidth-bound.
//   K3: read W words, write W words            -> 8W bytes
//   K2: copy W words, read M indices           -> 8W + 4M bytes
//   K1 in place: read and write W words once, read M indices -> 8W + 4M
//      (out of place the copy adds 8W more, inside the same launch)
// The marks are random single-word read-modify-writes, so for large M the
// real limit is the L2 atomic rate; that is later work (tile-binned marks
// in shared memory, ROADMAP).
//   K4: read M indices, write M fields, and read each distinct 32-byte
//      sector of the words that the indices touch -> 8M + 32*sectors
// K4 is a random gather: at serving batch sizes it is bound by the
// latency of the dependent index -> word load chain, not by bytes.
//
// Design, simple and right first:
// * A mark is an atomicCAS loop that sets the field only while it still
//   holds only_if.  atomicOr would be wrong: CUR (01) | NEXT (10) = DONE
//   (11).  A field is therefore marked iff it initially held only_if, so
//   the result does not depend on the order of the marks, as in the
//   reference (repro/kernels/ref.py:262-273).  Negative or >= 16*W indices
//   are dropped; the TPU kernel's trash row is not needed.
// * LUT + count works on all 16 fields of a word at once: the low and high
//   bit planes give one mask per field value, the LUT picks which masks
//   set the new low and high bits, and __popc of the mask of values that
//   map to count_val counts the word.  Counts reduce in the block and add
//   with one atomic per block.  No tile padding, so no padding correction.
// * K1 is one cooperative launch: the marks, grid.sync(), then the rotate
//   and count of every word in place.  All loads of the words go through
//   L2 (__ldcg): phase 2 must see marks that other SMs made with atomics,
//   and L1 is not coherent across SMs.
// * K4 needs none of the TPU kernel's page table: there the host bins the
//   queries by page so that one page at a time fits VMEM.  Here each
//   thread takes four queries (one 16-byte load of indices when both
//   buffers are 16-byte aligned), reads each word through the read-only
//   path (__ldg), and writes its four fields with one 16-byte store.  The
//   four word loads are independent, so a warp keeps 128 in flight.
//   Negative and >= 16*W indices give 0; duplicates are harmless.
//
// Plain C interface, loaded with ctypes.  Each function launches on the
// given stream, does not synchronise, and returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kEven = 0x55555555u;

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

__device__ __forceinline__ int32_t field2(const uint32_t* __restrict__ words,
                                          long long cap, int32_t e) {
  if (e < 0 || (long long)e >= cap) return 0;
  return (int32_t)((__ldg(words + (e >> 4)) >> (2u * (uint32_t)(e & 15))) &
                   3u);
}

__global__ void __launch_bounds__(kThreads)
gather2_kernel(const uint32_t* __restrict__ words, long long n_words,
               const int32_t* __restrict__ idx, int32_t* __restrict__ out,
               long long m, int vec) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long cap = n_words * 16;
  const long long n_vec = vec ? (m >> 2) : 0;
  const int4* idx4 = reinterpret_cast<const int4*>(idx);
  int4* out4 = reinterpret_cast<int4*>(out);
  for (long long i = tid; i < n_vec; i += stride) {
    const int4 e = __ldg(idx4 + i);
    int4 r;
    r.x = field2(words, cap, e.x);
    r.y = field2(words, cap, e.y);
    r.z = field2(words, cap, e.z);
    r.w = field2(words, cap, e.w);
    out4[i] = r;
  }
  for (long long i = (n_vec << 2) + tid; i < m; i += stride)
    out[i] = field2(words, cap, __ldg(idx + i));
}

// Blocks of `kernel` that all SMs hold at once (occupancy x SM count).
// Grids never exceed it: a block that waited for a second wave would
// leave most of the card idle while it ran alone.
template <typename Kernel>
int resident_blocks(Kernel kernel, long long* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0);
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

int roomy_gather2(const void* words, long long n_words, const void* idx,
                  long long m, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  long long resident = 0;
  ROOMY_TRY(resident_blocks(gather2_kernel, &resident));
  const int vec = aligned16(idx, out);
  gather2_kernel<<<grid_for(vec ? (m + 3) / 4 : m, resident), kThreads, 0,
                   s>>>((const uint32_t*)words, n_words,
                        (const int32_t*)idx, (int32_t*)out, m, vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
