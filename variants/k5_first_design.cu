// K5's first design, kept as it was so that `python3 chip_variants.py k5`
// can time it beside csrc/bucket_scatter.cu in one run: the table copied
// with cudaMemcpy, then one block a 32 ops adding each segment's sum with
// float atomics.  The package does not build it.
//
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
// `.at[idx].add(mode="drop")`), so that a sync can hand the kernel its
// queue unchanged: an index in [-N, 0) wraps to idx + N, and an index
// below -N or at or above N is dropped.  (The TPU kernel clamps only
// idx >= N to its trash row and leaves a negative row undefined; here no
// trash row is needed.)
//
// What bounds it on an H100 is memory traffic: the table is read and the
// output written once (8ND bytes, the copy), the indices and the payload
// read once (4M + 4MD).  At the main path's shape (gemma2-2b's embedding
// gradient, N 256000, D 2304, M 131072) that is 5.93 GB, 1.77 ms at
// 3.35 TB/s, and the copy is 80% of it.  There is one float add per
// payload element, far below the ~300 operations a byte where the card
// stops being bandwidth-bound.
//
// Design, simple and right first (the TPU kernel's shape, the whole table
// in VMEM and one op at a time on a sequential grid with a run register in
// SMEM, is a VMEM limit and is not copied):
// * The copy of the table into the output is one cudaMemcpy2DAsync on the
//   stream, before the kernel: the result is out of place, as the
//   reference's is.
// * A segment is a run of equal consecutive indices: i starts one where
//   i == 0 or idx[i] != idx[i-1].  Block b takes the segments that start
//   in ops [b*kChunk, (b+1)*kChunk), one after another; its threads stride
//   over the D columns, each sums the segment's payload column in op
//   order in a float32 register (eight independent loads, then the eight
//   adds in order), and adds the sum to the output with one atomicAdd per
//   (segment, column).  Sorted input (each index one run, as a sync's
//   sorted queue gives) thus touches each output row once.  Unsorted
//   input is right as well: one index may form several segments, each of
//   which adds its own sum.
// * A very long run is split: one Zipf head token can own ~10% of a batch,
//   and one block summing it alone would be the whole kernel's time.  A
//   run is cut at every op i with i % kSplit == 0 that lies kSplit or more
//   ops past the start of the run's current segment; the block that owns
//   i sees the cut by checking that idx[i-kSplit .. i] are all equal
//   (which holds exactly when the segment began at or before i - kSplit).
//   So a run of at most kSplit ops is never cut, and a segment holds at
//   most 2*kSplit - 1 ops.
// * Determinism: the result is the same bits from run to run whenever
//   each index forms one run of at most kSplit ops (each output element
//   then gets one atomicAdd onto the copied table value), in particular
//   wherever each index receives at most one op, where out = table +
//   payload exactly.  The pieces of a longer run, and the runs of an index
//   that recurs in unsorted input, add in the order the atomics land.
//
// Plain C interface, loaded with ctypes.  The function launches on the
// given stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 32;      // ops whose segment starts a block takes
constexpr long long kSplit = 256;   // the longest run that is never cut
constexpr int kUnroll = 8;

__device__ __forceinline__ bool starts_segment(const int* __restrict__ idx,
                                               long long i) {
  if (i == 0) return true;
  const int v = idx[i];
  if (v != idx[i - 1]) return true;
  if (i % kSplit != 0 || i < kSplit) return false;
  // mid-run at a multiple of kSplit: cut iff idx[i-kSplit .. i] are equal,
  // checked by the whole block (every thread reaches here together)
  bool same = true;
  for (long long j = i - kSplit + threadIdx.x; j < i; j += blockDim.x)
    same &= (idx[j] == v);
  return __syncthreads_and(same);
}

__global__ void __launch_bounds__(256)
scatter_add_kernel(float* __restrict__ out, long long n, long long d,
                   const int* __restrict__ idx, long long m,
                   const float* __restrict__ pay, long long pay_stride) {
  const long long begin = (long long)blockIdx.x * kChunk;
  const long long end = begin + kChunk < m ? begin + kChunk : m;
  for (long long h = begin; h < end; ++h) {
    if (!starts_segment(idx, h)) continue;       // uniform over the block
    const int v = idx[h];
    // the segment's end: the run's end, or the first cut after h
    long long e = h + 1;
    while (e < m && idx[e] == v && !(e % kSplit == 0 && e - h >= kSplit))
      ++e;
    long long row = v < 0 ? (long long)v + n : (long long)v;
    if (row < 0 || row >= n) continue;           // dropped
    float* __restrict__ dst = out + row * d;
    const float* __restrict__ src = pay + h * pay_stride;
    const long long len = e - h;
    for (long long c = threadIdx.x; c < d; c += blockDim.x) {
      float acc = 0.f;
      long long j = 0;
      for (; j + kUnroll <= len; j += kUnroll) {
        float x[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          x[u] = __ldg(src + (j + u) * pay_stride + c);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) acc += x[u];
      }
      for (; j < len; ++j) acc += __ldg(src + j * pay_stride + c);
      atomicAdd(dst + c, acc);
    }
  }
}

}  // namespace

extern "C" {

const char* roomy_scatter_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// table: (n, d) float32, row stride table_stride elements, column stride 1;
// out: (n, d) float32, contiguous; idx: (m,) int32; pay: (m, d) float32,
// row stride pay_stride elements, column stride 1.  m >= 1.
int roomy_bucket_scatter_add(const void* table, long long table_stride,
                             void* out, long long n, long long d,
                             const void* idx, long long m, const void* pay,
                             long long pay_stride, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (n > 0 && d > 0) {
    if (table_stride == d)
      err = cudaMemcpyAsync(out, table, (size_t)(n * d) * sizeof(float),
                            cudaMemcpyDeviceToDevice, s);
    else
      err = cudaMemcpy2DAsync(out, (size_t)d * sizeof(float), table,
                              (size_t)table_stride * sizeof(float),
                              (size_t)d * sizeof(float), (size_t)n,
                              cudaMemcpyDeviceToDevice, s);
    if (err != cudaSuccess) return (int)err;
  }
  if (n == 0 || d == 0 || m == 0) return (int)cudaGetLastError();
  long long threads = (d + 31) / 32 * 32;
  if (threads > 256) threads = 256;
  const long long blocks = (m + kChunk - 1) / kChunk;
  scatter_add_kernel<<<(unsigned)blocks, (unsigned)threads, 0, s>>>(
      (float*)out, n, d, (const int*)idx, m, (const float*)pay, pay_stride);
  return (int)cudaGetLastError();
}

}  // extern "C"
