#!/usr/bin/env python3
"""K1/K2, K4, K5, K8, K9 and K9-bwd beside the designs their sources left
behind, on one NVIDIA GPU.

    python3 chip_variants.py [bitpack] [k4] [k5] [k8] [k9] [k9b]

(no argument: every section, in that order)

Times, by CUDA events behind a spin kernel (median of 20), at the main
paths' shapes:

* K8 (paged decode attention) at nemotron-4-15b's decode layer (q 1 or 8 x
  48 x 128 bf16, 8 kv heads, pages of 128, 32k-token caches): the TMA route
  as it launches (the splits' merge in the same launch), the same route
  with the merge as a second launch (stage 1, then stage 2), and the
  classic route on the same bf16 inputs; each held to the plain version.
* K9 (the selective scan) at falcon-mamba-7b's prefill shape (1 x 32768 x
  8192, N 16, bf16, strided, with the final state): the kernel as built,
  and copies of its source with one design choice undone (``VARIANTS``),
  each built here with nvcc; each also run in float32 at (1, 2048, 8192,
  16) against the plain sequential scan, with ``chip_smoke.py``'s K9_TOL
  (1e-4 abs + rel on y and h) read as passed or broken.

* K1 and K2 (the marks of the implicit BFS) at every level of pancake
  n = 12, on the level's words and targets: the binned route as it
  launches, beside the designs in ``BITPACK_VARIANTS`` (source appended to
  ``csrc/bitpack.cu``, built here with nvcc, each held bit for bit to the
  binned route at every level); per level and summed over a fused BFS (K1),
  an unfused one (K2) and a publish (``chip_smoke.level_sums``); at levels
  8-13 also the binned route's steps (``BINNED_STEPS``).

* K4 (the 2-bit gather over a chunk table) over 16 chunks of random
  words shaped as the pancake n = 12 oracle's, at M = 4096, 45,056,
  1,048,576 and 8,388,608 random ranks: the kept kernel (8 queries a
  thread) beside the designs in ``K4_VARIANTS`` (substitutions in and a
  source appended to ``csrc/bitpack.cu``): 16 a thread, the first port's
  four a thread, and cp.async gathers into a shared-memory ring; each held
  bit for bit to the kept kernel; and the kept kernel over one batch again
  (warm in L2) and over that batch sorted.

* K5 (the segment scatter-add) beside its first design, kept as it was in
  ``variants/k5_first_design.cu`` (the table copied with cudaMemcpy, then a block
  a 32 ops adding each segment's sum with float atomics), built here with
  nvcc and called through a wrapper of the same contract: at gemma2-2b's
  sync (256,000 x 2304 float32, 131,072 sorted Zipf ids), a roomy
  embedding fold (a zero 49,408 x 1536 table, 4,096 unsorted Zipf ids, a
  tenth of them past the shard) and a prefix round (N = M = 2^27, D = 1,
  stride 2^20); each held to the plain version (the kept kernel also bit
  for bit to its mirror), timed in turns (first, kept, kept, first) with
  ``chip_smoke.device_ms`` (device time) and ``chip_smoke.median_ms``
  (with the host's launch time) beside the bound and ``torch.index_add``;
  then the walls of the sync (update + sync again), ``parallel_prefix`` and
  ``chain_reduce`` over 2^27, each design in turns (a warm-up, then the
  median of four), and each path's peak allocation over what it held
  before; and the kept kernel's device time a call by CUDA kernel
  (``torch.profiler``) at each shape.

* K9-bwd (the selective scan's backward) at falcon-mamba-7b's train layer
  (1 x 4096 x 8192, N 16) and zamba2-1.2b's K9-form layer (1 x 4096 x
  4096, N 64), bf16, strided: the kernel as built beside an earlier
  design's source, read from ``K9B_PARENT`` (absent from the repository;
  make it with ``git show <commit>:src/repro_torch/kernels/csrc/
  mamba_scan_bwd.cu > build/k9b_parent.cu``), built here with nvcc and
  launched through the same wrapper; timed in turns (earlier, kept, kept,
  earlier) with ``chip_smoke.median_ms``, each held to the plain version
  at ``chip_smoke``'s K9-bwd limits, with each one's scratch bytes.

A variant is its source with text substitutions; if the committed source no
longer holds a substitution's text, the script says which and exits
non-zero.  It prints one JSON line and exits non-zero without CUDA.
"""
import ctypes
import itertools
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as CS  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.core import array as RA  # noqa: E402
from repro_torch.core import constructs as C  # noqa: E402
from repro_torch.kernels import bitpack as K  # noqa: E402
from repro_torch.kernels import bucket_scatter as BS  # noqa: E402
from repro_torch.kernels import mamba_scan as MS  # noqa: E402
from repro_torch.kernels import paged_decode as PD  # noqa: E402
from repro_torch.kernels import ref as R  # noqa: E402

REPS = 20
K9_TOL = 1e-4
EX2 = ('__device__ __forceinline__ float ex2f_(float x) {\n  float y;\n'
       '  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));\n'
       '  return y;\n}\n\n')
VARIANTS = {
    # the exponential as ex2.approx of dt·a·log2(e), two instructions
    "ex2.approx exponential": [
        ("const float e = expf(dv * av[s]);",
         "const float e = ex2f_(dv * av[s] * 1.4426950408889634f);"),
        ("// TPC threads a channel, CH", EX2 + "// TPC threads a channel, CH")],
    # four blocks an SM (64 registers a thread), segments of 4 steps
    "4 blocks an SM, segments of 4 steps": [
        ("constexpr int kBlocksPerSM = 2;", "constexpr int kBlocksPerSM = 4;"),
        ("constexpr int kSegLen = 8;", "constexpr int kSegLen = 4;")],
    # two blocks an SM, segments of 4 steps
    "segments of 4 steps": [
        ("constexpr int kSegLen = 8;", "constexpr int kSegLen = 4;")],
}


def device_ms(fn, reps=REPS, setup=None) -> float:
    fn()
    times = []
    for _ in range(reps):
        if setup is not None:
            setup()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def k8_inputs(batch, dev, seed):
    ps, kvh, hd, hq, n = 128, 8, 128, 48, 32769
    pps = -(-(n + 16) // ps)
    gen = torch.Generator(device=dev).manual_seed(seed)
    kp = torch.randn((batch * pps, ps, kvh, hd), generator=gen, device=dev,
                     dtype=torch.bfloat16)
    vp = torch.randn_like(kp)
    q = torch.randn((batch, hq, hd), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    table = torch.randperm(batch * pps, generator=gen, device=dev).reshape(
        batch, pps).to(torch.int32)
    lengths = [n] + [n // 2 + 997 * i for i in range(1, batch)]
    return q, kp, vp, table, torch.tensor(lengths, dtype=torch.int32,
                                          device=dev)


def k8(dev) -> dict:
    out = {}
    for batch in (1, 8):
        q, kp, vp, table, lengths = k8_inputs(batch, dev, batch)
        scale = 1 / math.sqrt(q.shape[-1])
        want = R.paged_decode_attention_ref(q, kp, vp, table, lengths).float()
        _, tparts = PD._launch(q, kp, vp, table, lengths, None, scale, 1,
                               path="tma")
        _, cparts = PD._launch(q, kp, vp, table, lengths, None, scale, 1,
                               path="classic")
        runs = {
            "tma, one launch": lambda: PD._launch(
                q, kp, vp, table, lengths, None, scale, 3, parts=tparts,
                path="tma")[0],
            "tma, merge as a second launch": lambda: PD._launch(
                q, kp, vp, table, lengths, None, scale, 2, parts=PD._launch(
                    q, kp, vp, table, lengths, None, scale, 1, parts=tparts,
                    path="tma")[1], path="tma")[0],
            "classic": lambda: PD._launch(
                q, kp, vp, table, lengths, None, scale, 3, parts=cparts,
                path="classic")[0]}
        for name, fn in runs.items():
            got = fn().float()
            rel = float(((got - want).norm(dim=-1) / want.norm(dim=-1)).max())
            if rel > 1e-2:
                raise SystemExit(f"K8 {name} at batch {batch}: rel {rel}")
            out[f"batch {batch}, {name}"] = {"ms": device_ms(fn),
                                             "rel_per_bh": rel}
            print(f"K8 nemotron decode batch {batch}, {name}: "
                  f"{out[f'batch {batch}, {name}']}", flush=True)
        del kp, vp
    return out


def variant_lib(name, subs) -> ctypes.CDLL:
    text = (_build.CSRC / "mamba_scan.cu").read_text()
    for old, new in subs:
        if old not in text:
            raise SystemExit(f"variant {name!r}: the source no longer holds "
                             f"{old!r}")
        text = text.replace(old, new)
    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    stem = out / ("mamba_scan_" + "".join(c if c.isalnum() else "_"
                                          for c in name))
    stem.with_suffix(".cu").write_text(text)
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                        str(stem.with_suffix(".so")),
                        str(stem.with_suffix(".cu"))],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"variant {name!r} failed to build:\n{r.stderr}")
    spills = [ln.strip() for ln in (r.stdout + r.stderr).splitlines()
              if "spill" in ln]
    lib = ctypes.CDLL(str(stem.with_suffix(".so")))
    base = MS._lib()
    for fn in ("roomy_mamba_scan", "roomy_ms_error_string"):
        getattr(lib, fn).argtypes = getattr(base, fn).argtypes
        getattr(lib, fn).restype = getattr(base, fn).restype
    lib.spills = max((int(s.split(" bytes spill stores")[0].split()[-1])
                      for s in spills), default=0)
    return lib


def k9_inputs(dev, shape, dtype, seed):
    b, l, di, n = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    xz = torch.randn((b, l, 2 * di), generator=gen, device=dev)
    xz[..., di:].abs_().mul_(0.1)
    xp = torch.randn((b, l, 256 + 2 * n), generator=gen, device=dev)
    x, dt = xz.to(dtype).split(di, -1)
    bb, cc = xp.to(dtype)[..., 256:].split(n, -1)
    a = -torch.rand((di, n), generator=gen, device=dev) * 16
    return x, dt, a, bb, cc, torch.randn((di,), generator=gen, device=dev)


def k9(dev) -> dict:
    libs = {"as built": MS._lib()}
    libs.update((name, variant_lib(name, subs))
                for name, subs in VARIANTS.items())
    big = k9_inputs(dev, (1, 32768, 8192, 16), torch.bfloat16, 7)
    small = k9_inputs(dev, (1, 2048, 8192, 16), torch.float32, 5)
    wy, wh = R.mamba_scan_seq_stateful(*small)
    out = {}
    for name in list(libs) + ["as built"]:
        MS._LIB = libs[name]
        gy, gh = MS.mamba_scan(*small, return_state=True)
        dy, dh = (gy - wy).abs(), (gh - wh).abs()
        ok = bool((dy <= K9_TOL + K9_TOL * wy.abs()).all()) and bool(
            (dh <= K9_TOL + K9_TOL * wh.abs()).all())
        ms = device_ms(lambda: MS.mamba_scan(*big, return_state=True))
        rec = {"ms": ms, "f32_max_abs_y": float(dy.max()),
               "f32_max_abs_h": float(dh.max()), "within_K9_TOL": ok,
               "spill_store_bytes_max": getattr(libs[name], "spills", None)}
        out.setdefault(name, []).append(rec)
        print(f"K9 falcon-mamba prefill shape, {name}: {rec}", flush=True)
    MS._LIB = libs["as built"]
    return out


# Each variant defines roomy_mark_variant(in, out, n_words, idx, m, mark,
# only_if, lut, count_val, count, work, stream), K1 when count is not null
# and K2 otherwise, with `work` of roomy_variant_work_bytes(n_words, m).
BITPACK_VARIANTS = {
    # every mark sets its field's bit in a W*16-bit bitmap in global memory
    # (atomicOr, a RED, into 2W bytes: about L2's size at n = 12); then one
    # streaming pass marks where hit and the field held only_if, rotates,
    # counts and writes every word
    "hit bitmap": r"""
namespace {

__global__ void __launch_bounds__(kThreads)
hit_set_kernel(const int32_t* __restrict__ idx, long long m, long long cap,
               uint32_t* hit) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = tid; i < m; i += stride) {
    const int32_t e = __ldcs(idx + i);
    if (e >= 0 && (long long)e < cap)
      atomicOr(hit + (e >> 5), 1u << (e & 31));
  }
}

template <bool kLut>
__global__ void __launch_bounds__(kThreads)
hit_apply_kernel(const uint32_t* in, uint32_t* out, long long n_words,
                 const uint32_t* __restrict__ hit, uint32_t mark,
                 uint32_t only_if, uint32_t lut, uint32_t cval,
                 unsigned int* count) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  unsigned int cnt = 0;
  for (long long i = tid; i < n_words; i += stride) {
    uint32_t w = mark_word(in[i], spread16(hit[i >> 1] >> ((i & 1) << 4)),
                           mark, only_if);
    if (kLut) {
      uint32_t match;
      w = lut_word(w, lut, cval, &match);
      cnt += __popc(match);
    }
    out[i] = w;
  }
  if (kLut) block_add(cnt, count);
}

}  // namespace

extern "C" long long roomy_variant_work_bytes(long long n_words, long long m) {
  return (n_words + 1) / 2 * 4;
}

extern "C" int roomy_mark_variant(const void* in, void* out,
                                  long long n_words, const void* idx,
                                  long long m, int mark, int only_if, int lut,
                                  int count_val, void* count, void* work,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  long long set = 0, apply = 0;
  ROOMY_TRY(resident_blocks(hit_set_kernel, &set));
  ROOMY_TRY(resident_blocks(hit_apply_kernel<true>, &apply));
  ROOMY_TRY(cudaMemsetAsync(work, 0, (size_t)((n_words + 1) / 2) * 4, s));
  hit_set_kernel<<<grid_for(m, set), kThreads, 0, s>>>(
      (const int32_t*)idx, m, n_words * 16, (uint32_t*)work);
  if (count) {
    ROOMY_TRY(cudaMemsetAsync(count, 0, sizeof(unsigned int), s));
    hit_apply_kernel<true><<<grid_for(n_words, apply), kThreads, 0, s>>>(
        (const uint32_t*)in, (uint32_t*)out, n_words, (const uint32_t*)work,
        (uint32_t)mark, (uint32_t)only_if, (uint32_t)lut,
        (uint32_t)count_val, (unsigned int*)count);
  } else {
    hit_apply_kernel<false><<<grid_for(n_words, apply), kThreads, 0, s>>>(
        (const uint32_t*)in, (uint32_t*)out, n_words, (const uint32_t*)work,
        (uint32_t)mark, (uint32_t)only_if, 0u, 0u, nullptr);
  }
  return (int)cudaGetLastError();
}
""",
    # the binned route with the first port's scatter: no sort in shared
    # memory, each target's offset stored at its tile's cursor on its own
    # (an L2 transaction a target)
    "binned, a store a target": r"""
namespace {

__global__ void __launch_bounds__(kBinThreads)
scatter_unsorted_kernel(const int32_t* __restrict__ idx, long long m,
                        long long cap, int vec, int n_tiles,
                        long long per_block,
                        const unsigned int* __restrict__ counts,
                        const unsigned int* __restrict__ tile_total,
                        unsigned int* __restrict__ tile_start,
                        uint16_t* __restrict__ bins) {
  extern __shared__ unsigned int cursor[];
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
  __syncthreads();
  const long long lo = blockIdx.x * per_block;
  const long long hi = lo + per_block < m ? lo + per_block : m;
  for_targets(idx, lo, hi, vec, [&](int32_t e) {
    if (e >= 0 && (long long)e < cap) {
      const unsigned int pos = atomicAdd(&cursor[tile_of(e)], 1u);
      bins[pos] = (uint16_t)(e & ((1 << kTileShift) - 1));
    }
  });
}

struct Plan {
  int n_tiles, g;
  long long per_block;
};

Plan plan_of(long long n_words, long long m) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  Plan p;
  p.n_tiles = (int)((n_words + kTileWords - 1) / kTileWords);
  long long g = (m + (1 << 14) - 1) >> 14;
  p.g = (int)(g < 1 ? 1 : (g > sms ? sms : g));
  p.per_block = ((m + p.g - 1) / p.g + 3) / 4 * 4;
  return p;
}

}  // namespace

extern "C" long long roomy_variant_work_bytes(long long n_words, long long m) {
  const Plan p = plan_of(n_words, m);
  return 4 * ((long long)p.n_tiles * p.g + 2 * p.n_tiles + 1) + 2 * m + 64;
}

extern "C" int roomy_mark_variant(const void* in, void* out,
                                  long long n_words, const void* idx,
                                  long long m, int mark, int only_if, int lut,
                                  int count_val, void* count, void* work,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Plan p = plan_of(n_words, m);
  unsigned int* counts = (unsigned int*)work;
  unsigned int* tile_total = counts + (long long)p.n_tiles * p.g;
  unsigned int* tile_start = tile_total + p.n_tiles;
  uint16_t* bins = (uint16_t*)(((uintptr_t)(tile_start + p.n_tiles + 1) +
                                15) & ~(uintptr_t)15);
  const size_t hist = (size_t)p.n_tiles * 4;
  ROOMY_TRY(cudaFuncSetAttribute(bin_count_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)hist));
  ROOMY_TRY(cudaFuncSetAttribute(scatter_unsorted_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)hist));
  long long resident = 0;
  ROOMY_TRY(resident_blocks(tile_pass_kernel<true>, &resident, kThreads,
                            kTileSmem));
  const long long cap = n_words * 16;
  const int vec = ((uintptr_t)idx & 15u) == 0;
  bin_count_kernel<<<p.g, kBinThreads, hist, s>>>(
      (const int32_t*)idx, m, cap, vec, p.n_tiles, p.per_block, counts);
  bin_scan_kernel<<<(p.n_tiles + kScanWarps - 1) / kScanWarps,
                    kScanWarps * 32, 0, s>>>(counts, p.n_tiles, p.g,
                                             tile_total);
  scatter_unsorted_kernel<<<p.g, kBinThreads, hist, s>>>(
      (const int32_t*)idx, m, cap, vec, p.n_tiles, p.per_block, counts,
      tile_total, tile_start, bins);
  const unsigned int grid =
      (unsigned int)(resident < p.n_tiles ? resident : p.n_tiles);
  if (count) {
    ROOMY_TRY(cudaMemsetAsync(count, 0, sizeof(unsigned int), s));
    tile_pass_kernel<true><<<grid, kThreads, kTileSmem, s>>>(
        (const uint32_t*)in, (uint32_t*)out, n_words, p.n_tiles, tile_start,
        bins, (uint32_t)mark, (uint32_t)only_if, (uint32_t)lut,
        (uint32_t)count_val, (unsigned int*)count);
  } else {
    tile_pass_kernel<false><<<grid, kThreads, kTileSmem, s>>>(
        (const uint32_t*)in, (uint32_t*)out, n_words, p.n_tiles, tile_start,
        bins, (uint32_t)mark, (uint32_t)only_if, 0u, 0u, nullptr);
  }
  return (int)cudaGetLastError();
}
""",
}



# K4's designs left behind, each over the same chunk table as the kept
# kernel (gather2_kernel<long long, uint8_t>: 8 queries a thread, every
# word load issued before any use, one 8-byte store): substitutions in
# csrc/bitpack.cu and a source appended to it that exports
# roomy_gather2_variant with roomy_gather2_chunked's signature.
K4_SAME = r"""
extern "C" int roomy_gather2_variant(const void* table, int n_chunks,
                                     long long ce, const void* ranks,
                                     long long m, void* out, void* stream) {
  return roomy_gather2_chunked(table, n_chunks, ce, ranks, m, out, stream);
}
"""
K4_VARIANTS = {
    # 16 queries a thread, their codes in one 16-byte store
    "16 a thread": ([("constexpr int kG2Per = 8; ",
                      "constexpr int kG2Per = 16;")], K4_SAME),
    # the first port's design: four queries a thread (two 16-byte rank
    # loads, four dependent word loads, one 4-byte store) in a grid-stride
    # loop over a grid capped at the resident blocks
    "four a thread (the first port's)": ([], r"""
namespace {

__device__ __forceinline__ uint32_t g2_one(long long r, const G2Table& t,
                                           const longlong2* s_tab,
                                           uint32_t old) {
  const uint32_t* a = nullptr;
  uint32_t sh = 0;
  const int st = g2_locate(r, t, s_tab, &a, &sh);
  if (st == kG2Keep) return old;
  return st == kG2Load ? (__ldg(a) >> sh) & 3u : 0u;
}

__global__ void __launch_bounds__(kThreads)
gather2_four_kernel(G2Table t, const long long* __restrict__ ranks,
                    uint8_t* __restrict__ out, long long m, int vec) {
  extern __shared__ longlong2 s_tab[];
  g2_stage_table(t, s_tab);
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long n4 = vec ? (m >> 2) : 0;
  const longlong2* r2 = reinterpret_cast<const longlong2*>(ranks);
  uint32_t* o4 = reinterpret_cast<uint32_t*>(out);
  for (long long i = tid; i < n4; i += stride) {
    const longlong2 a = __ldg(r2 + 2 * i), b = __ldg(r2 + 2 * i + 1);
    const uint32_t old = o4[i];
    o4[i] = g2_one(a.x, t, s_tab, old & 0xFFu) |
            g2_one(a.y, t, s_tab, (old >> 8) & 0xFFu) << 8 |
            g2_one(b.x, t, s_tab, (old >> 16) & 0xFFu) << 16 |
            g2_one(b.y, t, s_tab, old >> 24) << 24;
  }
  for (long long i = (n4 << 2) + tid; i < m; i += stride)
    out[i] = (uint8_t)g2_one(__ldg(ranks + i), t, s_tab, out[i]);
}

}  // namespace

extern "C" int roomy_gather2_variant(const void* table, int n_chunks,
                                     long long ce, const void* ranks,
                                     long long m, void* out, void* stream) {
  if (m <= 0) return 0;
  const G2Table t = g2_table(table, n_chunks, make_longlong2(0, 0), ce);
  const size_t smem = t.in_smem ? (size_t)n_chunks * sizeof(longlong2) : 0;
  long long resident = 0;
  ROOMY_TRY(resident_blocks(gather2_four_kernel, &resident, kThreads, smem));
  const int vec = aligned16(ranks, out);
  gather2_four_kernel<<<grid_for(vec ? (m + 3) / 4 : m, resident), kThreads,
                        smem, (cudaStream_t)stream>>>(
      t, (const long long*)ranks, (uint8_t*)out, m, vec);
  return (int)cudaGetLastError();
}
"""),
    # one block an SM walks its tiles of 256 x 8 queries through a ring of
    # two stages in shared memory: each query's word comes in by a 4-byte
    # cp.async, so a tile's 2048 loads are in flight while the thread
    # drains the tile before it, with no registers held for them
    "cp.async ring in shared memory": ([], r"""
namespace {

constexpr int kRingThreads = 256;

__device__ __forceinline__ void ring_issue(const G2Table& t,
                                           const longlong2* s_tab,
                                           const long long* ranks,
                                           uint32_t* slots, long long base,
                                           long long m, int vec,
                                           uint8_t (&meta)[kG2Per]) {
  const int n = m - base < kG2Per ? (int)(m - base) : kG2Per;
  long long r[kG2Per];
  g2_load_ranks(ranks + base, r, n, vec && n == kG2Per);
#pragma unroll
  for (int j = 0; j < kG2Per; ++j) {
    const uint32_t* a = nullptr;
    uint32_t sh = 0;
    const int st = j < n ? g2_locate(r[j], t, s_tab, &a, &sh) : kG2Keep;
    if (st == kG2Load)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                       smem_addr(slots + j * kRingThreads)),
                   "l"(a));
    meta[j] = (uint8_t)(st | sh << 2);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void ring_drain(const uint32_t* slots,
                                           uint8_t* out, long long base,
                                           long long m, int vec,
                                           const uint8_t (&meta)[kG2Per]) {
  const int n = m - base < kG2Per ? (int)(m - base) : kG2Per;
  uint32_t code[kG2Per];
  int st[kG2Per];
#pragma unroll
  for (int j = 0; j < kG2Per; ++j) {
    st[j] = meta[j] & 3;
    code[j] = st[j] == kG2Load
                  ? (slots[j * kRingThreads] >> (meta[j] >> 2)) & 3u : 0u;
  }
  g2_store(out + base, code, st, n, vec && n == kG2Per);
}

__global__ void __launch_bounds__(kRingThreads)
gather2_ring_kernel(G2Table t, const long long* __restrict__ ranks,
                    uint8_t* __restrict__ out, long long m, int vec) {
  extern __shared__ longlong2 s_tab[];
  g2_stage_table(t, s_tab);
  uint32_t* ring = reinterpret_cast<uint32_t*>(
      s_tab + (t.in_smem ? t.n_chunks : 0));
  const long long per_tile = (long long)kRingThreads * kG2Per;
  const long long n_tiles = (m + per_tile - 1) / per_tile;
  long long tile = blockIdx.x;
  if (tile >= n_tiles) return;
  uint8_t cur[kG2Per], nxt[kG2Per];
  const long long lane = (long long)threadIdx.x * kG2Per;
  // a thread's slot j of stage s: ring[(s * kG2Per + j) * kRingThreads + tid]
  uint32_t* const mine = ring + threadIdx.x;
  const int stage_words = kG2Per * kRingThreads;
  ring_issue(t, s_tab, ranks, mine, tile * per_tile + lane, m, vec, cur);
  int stage = 0;
  for (;;) {
    const long long next = tile + gridDim.x;
    const bool more = next < n_tiles;
    if (more) {
      ring_issue(t, s_tab, ranks, mine + (stage ^ 1) * stage_words,
                 next * per_tile + lane, m, vec, nxt);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    if (tile * per_tile + lane < m)
      ring_drain(mine + stage * stage_words, out, tile * per_tile + lane, m,
                 vec, cur);
    if (!more) break;
#pragma unroll
    for (int j = 0; j < kG2Per; ++j) cur[j] = nxt[j];
    tile = next;
    stage ^= 1;
  }
}

}  // namespace

extern "C" int roomy_gather2_variant(const void* table, int n_chunks,
                                     long long ce, const void* ranks,
                                     long long m, void* out, void* stream) {
  if (m <= 0) return 0;
  const G2Table t = g2_table(table, n_chunks, make_longlong2(0, 0), ce);
  const size_t smem = (t.in_smem ? (size_t)n_chunks * sizeof(longlong2) : 0)
                      + 2 * kG2Per * kRingThreads * 4;
  if (smem > 48 * 1024)
    ROOMY_TRY(cudaFuncSetAttribute(
        gather2_ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem));
  int dev = 0, sms = 0;
  ROOMY_TRY(cudaGetDevice(&dev));
  ROOMY_TRY(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   dev));
  const long long tiles = (m + kRingThreads * kG2Per - 1) /
                          (kRingThreads * kG2Per);
  gather2_ring_kernel<<<(unsigned int)(tiles < sms ? tiles : sms),
                        kRingThreads, smem, (cudaStream_t)stream>>>(
      t, (const long long*)ranks, (uint8_t*)out, m, aligned16(ranks, out));
  return (int)cudaGetLastError();
}
"""),
}

# The binned route's steps: copies of its source with the later launches
# cut out (the count alone; the count, scan and scatter), timed as K2 at
# the wide levels; the whole route less the latter is the tile pass.
CUT = {k: (f"  {k}<<<", f"  if (0) {k}<<<") for k in (
    "bin_scan_kernel", "bin_scatter_kernel", "tile_pass_kernel<kLut>")}
BINNED_STEPS = {
    "count": list(CUT.values()),
    "count, scan, scatter": [CUT["tile_pass_kernel<kLut>"]],
}
STEP_LEVELS = range(8, 14)


def step_libs() -> dict:
    text = (_build.CSRC / "bitpack.cu").read_text()
    libs = {}
    for i, (name, subs) in enumerate(BINNED_STEPS.items()):
        t = text
        for old, new in subs:
            if t.count(old) != 1:
                raise SystemExit(f"step {name!r}: csrc/bitpack.cu no longer "
                                 f"holds {old!r} once")
            t = t.replace(old, new)
        libs[name] = CS.build_variant(f"bitpack_steps{i}", t)
    return libs


def bitpack_variant_lib(name, source) -> ctypes.CDLL:
    stem = "bitpack_" + "".join(c if c.isalnum() else "_" for c in name)
    lib = CS.build_variant(stem, (_build.CSRC / "bitpack.cu").read_text()
                           + source)
    lib.roomy_variant_work_bytes.argtypes = [ctypes.c_longlong] * 2
    lib.roomy_variant_work_bytes.restype = ctypes.c_longlong
    lib.roomy_mark_variant.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
    lib.roomy_mark_variant.restype = ctypes.c_int
    return lib


def variant_mark(lib, words, tgt, out, lut=None, cval=0):
    """K1 (``lut`` given; returns the count) or K2 through a variant."""
    w, m = words.shape[0], tgt.shape[0]
    work = torch.empty(lib.roomy_variant_work_bytes(w, m), dtype=torch.uint8,
                       device=words.device)
    cnt = None if lut is None else torch.empty(
        (), dtype=torch.int32, device=words.device)
    code = lib.roomy_mark_variant(
        words.data_ptr(), out.data_ptr(), w, tgt.data_ptr(), m, 2, 0,
        lut or 0, cval, None if cnt is None else cnt.data_ptr(),
        work.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if code:
        raise SystemExit(f"variant launch failed: CUDA error {code}")
    return cnt


def bitpack(dev) -> dict:
    libs = {name: bitpack_variant_lib(name, src)
            for name, src in BITPACK_VARIANTS.items()}
    steps = step_libs()
    rot, cur = CS.ROTATE, CS.BA.CUR
    levels = []
    for level, n_cur, data, tgt in CS.bfs_levels(dev):
        work, out, ref = (torch.empty_like(data) for _ in range(3))
        ref.copy_(data)
        wc = K._mark(ref, tgt, ref, 2, 0, rot, cur, path="binned")
        want2 = torch.empty_like(data)
        K._mark(data, tgt, want2, 2, 0, path="binned")
        runs = {"binned": (
            lambda: K._mark(work, tgt, work, 2, 0, rot, cur, path="binned"),
            lambda: K._mark(data, tgt, out, 2, 0, path="binned"))}
        for name, lib in libs.items():
            work.copy_(data)
            gc = variant_mark(lib, work, tgt, work, rot, cur)
            variant_mark(lib, data, tgt, out)
            torch.cuda.synchronize()
            if not (torch.equal(work, ref) and int(gc) == int(wc)
                    and torch.equal(out, want2)):
                raise SystemExit(f"variant {name!r} differs from the binned "
                                 f"route at n=12 level {level}")
            runs[name] = (
                lambda lib=lib: variant_mark(lib, work, tgt, work, rot, cur),
                lambda lib=lib: variant_mark(lib, data, tgt, out))
        rec = {"level": level, "M": tgt.shape[0], "k1_ms": {}, "k2_ms": {}}
        for name, (k1, k2) in runs.items():
            rec["k1_ms"][name] = device_ms(k1, setup=lambda: work.copy_(data))
            rec["k2_ms"][name] = device_ms(k2)
        if level in STEP_LEVELS:
            good = K._lib()
            try:
                for name, lib in steps.items():
                    K._LIB = lib
                    rec["k2_ms"][f"binned: {name}"] = device_ms(
                        lambda: K._mark(data, tgt, out, 2, 0, path="binned"))
            finally:
                K._LIB = good
        print(f"K1/K2 n=12 level {level} (M={rec['M']}): {rec}", flush=True)
        levels.append(rec)
        del work, out, ref, want2
    names = ["binned"] + list(libs)
    sums = {n: CS.level_sums([r["k1_ms"][n] for r in levels],
                             [r["k2_ms"][n] for r in levels]) for n in names}
    print(f"K1/K2 summed over n=12: {sums}", flush=True)
    return {"levels": levels, "sums": sums}



K4_CHUNKS, K4_CE = 16, 29_937_600     # the pancake n = 12 oracle's chunks
K4_BATCHES = (4096, 45056, 1 << 20, 1 << 23)


def k4_variant_lib(name, subs, source) -> ctypes.CDLL:
    text = (_build.CSRC / "bitpack.cu").read_text()
    for old, new in subs:
        if text.count(old) != 1:
            raise SystemExit(f"K4 variant {name!r}: csrc/bitpack.cu no "
                             f"longer holds {old!r} once")
        text = text.replace(old, new)
    stem = "bitpack_k4_" + "".join(c if c.isalnum() else "_" for c in name)
    lib = CS.build_variant(stem, text + source)
    lib.roomy_gather2_variant.argtypes = \
        K._lib().roomy_gather2_chunked.argtypes
    lib.roomy_gather2_variant.restype = ctypes.c_int
    return lib


def k4(dev) -> dict:
    """K4 as kept and its dropped designs over 16 chunks of random words
    shaped as the n = 12 oracle's (29,937,600 fields each), at M = 4096,
    45,056 (a distance step's 4096 walkers x 11 neighbours), 1,048,576 and
    8,388,608 random ranks with every chunk boundary; each design held bit
    for bit to the kept kernel, then timed over a fresh batch each
    repetition (the words cold, as a new query finds them).  Beside them,
    the kept kernel over one batch again and again (its sectors warm in
    L2) and over that batch sorted (the sort untimed)."""
    libs = {name: k4_variant_lib(name, subs, src)
            for name, (subs, src) in K4_VARIANTS.items()}
    gen = torch.Generator(device=dev).manual_seed(23)
    words = K4_CE // 16
    table = [torch.randint(-(1 << 31), 1 << 31, (words,), dtype=torch.int32,
                           device=dev, generator=gen)
             for _ in range(K4_CHUNKS)]
    dev_table = K.chunk_table(table, dev)
    total = K4_CHUNKS * K4_CE
    edges = CS.chunk_edges(K4_CHUNKS, K4_CE, dev)
    stream = torch.cuda.current_stream().cuda_stream

    def variant(lib, ranks, out):
        code = lib.roomy_gather2_variant(dev_table.data_ptr(), K4_CHUNKS,
                                         K4_CE, ranks.data_ptr(),
                                         ranks.numel(), out.data_ptr(),
                                         stream)
        if code:
            raise SystemExit(f"K4 variant launch failed: CUDA error {code}")

    def kept(lib, ranks, out):
        K.launch_gather2_chunked(dev_table, K4_CE, ranks, out)

    designs = {"8 a thread (kept)": (None, kept)}
    designs.update({name: (lib, variant) for name, lib in libs.items()})
    res = {}
    for m in K4_BATCHES:
        batches = [torch.randint(0, total, (m,), device=dev, generator=gen)
                   for _ in range(REPS + 1)]
        batches[0][-edges.numel():] = edges
        want = torch.full((m,), 0xAB, dtype=torch.uint8, device=dev)
        kept(None, batches[0], want)
        out = torch.empty(m, dtype=torch.uint8, device=dev)
        rec = {}
        for name, (lib, fn) in designs.items():
            got = torch.full((m,), 0xAB, dtype=torch.uint8, device=dev)
            fn(lib, batches[0], got)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise SystemExit(f"K4 {name} differs from the kept kernel "
                                 f"at M={m}")
            fresh = itertools.cycle(batches)
            rec[name] = device_ms(lambda: fn(lib, next(fresh), out))
        one = batches[1]
        rec["kept, one batch again"] = device_ms(lambda: kept(None, one, out))
        ordered = torch.sort(one).values
        rec["kept, that batch sorted"] = device_ms(
            lambda: kept(None, ordered, out))
        rec["bound_ms"] = CS.k4c_bound(table, K4_CE, batches[0])["bound_ms"]
        print(f"K4 over 16 chunks of {K4_CE} fields, M={m}: {rec}",
              flush=True)
        res[str(m)] = rec
        del batches, ordered
    return res

K5_FIRST = ROOT / "variants" / "k5_first_design.cu"
K5_VOCAB, K5_DIM, K5_M = 256_000, 2304, 32 * 4096     # the sync
K5_FOLD = (49_408, 1536, 4096)                         # the fold
K5_PREFIX, K5_STRIDE = 1 << 27, 1 << 20               # a prefix round
K5_WALL_TURNS = 4                 # turns of each design a path's wall


def k5_first_design():
    """K5's first design built with nvcc, and a call with the kernel
    wrapper's contract that launches it (one launch booked a call)."""
    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "k5_first.so"
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                        str(K5_FIRST)], capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"k5: {K5_FIRST.name} failed to build:\n{r.stderr}")
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_longlong
    lib.roomy_bucket_scatter_add.argtypes = [P, I, P, I, I, P, I, P, I, P]
    lib.roomy_bucket_scatter_add.restype = ctypes.c_int

    def call(table, idx, payload):
        table, payload = BS._rows(table), BS._rows(payload)
        idx = idx.contiguous()
        n, d = table.shape
        out_ = torch.empty((n, d), dtype=torch.float32, device=table.device)
        code = lib.roomy_bucket_scatter_add(
            table.data_ptr(), table.stride(0), out_.data_ptr(), n, d,
            idx.data_ptr(), idx.numel(), payload.data_ptr(),
            payload.stride(0), torch.cuda.current_stream().cuda_stream)
        if code:
            raise SystemExit(f"k5: the first design's launch failed: {code}")
        BS.LAUNCHES["bucket_scatter_add"] += 1
        return out_
    return call


def k5_shapes(dev) -> dict:
    """(table, idx, payload) of the sync, the fold and a prefix round."""
    rng = np.random.default_rng(CS.SEED)
    gen = torch.Generator(device=dev).manual_seed(CS.SEED)
    data = torch.randn(K5_VOCAB, K5_DIM, generator=gen, device=dev)
    pay = torch.randn(K5_M, K5_DIM, generator=gen, device=dev)
    ids = torch.from_numpy(CS.zipf_tokens(rng, K5_VOCAB, K5_M)).to(dev)
    idx_s, order = torch.sort(ids, stable=True)
    rows, d, m = K5_FOLD
    fold = CS.zipf_tokens(rng, rows, m)
    fold[rng.random(m) < 0.1] = rows              # past the shard: dropped
    pidx = torch.arange(K5_PREFIX, dtype=torch.int32, device=dev) + K5_STRIDE
    pidx[pidx >= K5_PREFIX] = K5_PREFIX
    return {"sync": (data, idx_s, pay[order]),
            "fold": (torch.zeros(rows, d, device=dev),
                     torch.from_numpy(fold).to(dev),
                     torch.randn(m, d, generator=gen, device=dev)),
            "prefix round": (torch.rand(K5_PREFIX, 1, generator=gen,
                                        device=dev), pidx,
                             torch.rand(K5_PREFIX, 1, generator=gen,
                                        device=dev))}


def k5_walls(dev, first) -> dict:
    """The walls of the sync (update + sync(add, add, pred) of the 131,072
    rows, as ``chip_smoke.phase_embedding_sync`` reads it again),
    parallel_prefix and chain_reduce over 2^27, each design in turns."""
    rng = np.random.default_rng(CS.SEED)
    gen = torch.Generator(device=dev).manual_seed(CS.SEED)
    data = torch.randn(K5_VOCAB, K5_DIM, generator=gen, device=dev)
    pay = torch.randn(K5_M, K5_DIM, generator=gen, device=dev)
    ids = torch.from_numpy(CS.zipf_tokens(rng, K5_VOCAB, K5_M)).to(dev)
    pred = lambda rows: rows[..., 0] > 0          # noqa: E731
    ra = RA.make(data, K5_M, payload_shape=(K5_DIM,),
                 payload_dtype=torch.float32, pred=pred)
    x = torch.rand(K5_PREFIX, generator=gen, device=dev)
    pa = RA.make(x, K5_PREFIX, payload_dtype=torch.float32)

    peaks = {"first": {}, "kept": {}}

    def timed(fn, what, name):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peaks[name][what] = torch.cuda.max_memory_allocated() - base
        return wall
    paths = {
        "sync_ms": lambda name: 1e3 * timed(lambda: RA.sync(
            RA.update(ra, ids, pay)[0], RA.add, RA.add, pred=pred),
            "sync", name),
        "prefix_s": lambda name: timed(
            lambda: C.parallel_prefix(pa, RA.add), "prefix", name),
        "chain_s": lambda name: timed(
            lambda: C.chain_reduce(pa, RA.add), "chain", name)}
    res = {}
    for what, fn in paths.items():
        rec = {"first": [], "kept": []}
        for name in ("first", "kept") * (1 + K5_WALL_TURNS):
            if name == "first":
                with CS.patched(BS, "bucket_scatter_add", first):
                    rec[name].append(fn(name))
            else:
                rec[name].append(fn(name))
        for name in rec:                  # the first turn of each warms up
            rec[name] = {"runs": rec[name][1:],
                         "median": statistics.median(rec[name][1:])}
        res[what] = rec
        print(f"K5 wall {what}: {rec}", flush=True)
    # bytes allocated at the peak of the last run beyond those held before
    res["peak_bytes_over_base"] = peaks
    print(f"K5 peak bytes over the allocations before the call: {peaks}",
          flush=True)
    return res


def k5_profile(fn, calls=10) -> dict:
    """Device microseconds a call of each CUDA kernel ``fn`` runs
    (torch.profiler over ``calls`` calls)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.device_time_total / calls
            for e in prof.key_averages() if e.device_time_total > 0}


def k5(dev) -> dict:
    first = k5_first_design()
    res = {}
    for what, (table, idx, pay) in k5_shapes(dev).items():
        want = R.bucket_scatter_add_ref(table, idx, pay)
        kept = BS.bucket_scatter_add(table, idx, pay)
        old = first(table, idx, pay)
        torch.cuda.synchronize()
        if not torch.equal(kept, R.bucket_scatter_add_ordered(table, idx,
                                                               pay)):
            raise SystemExit(f"K5 {what}: the kernel != its mirror")
        hit = torch.linalg.vector_norm(want, dim=1) > 0   # 0/0 elsewhere
        rels = {name: CS.row_rel(got[hit], want[hit]) for name, got in
                (("kept", kept), ("first", old))}
        if not all(math.isfinite(r) for r in rels.values()):
            raise SystemExit(f"K5 {what}: {rels}")
        if max(rels.values()) > CS.K5_ROW_REL_TOL:
            raise SystemExit(f"K5 {what}: {rels} past {CS.K5_ROW_REL_TOL}")
        del want, kept, old
        n, d = table.shape
        m = idx.numel()
        rec = {"shape": (n, d, m), "row_rel": rels,
               "bound_ms": (8 * n * d + 4 * m + 4 * m * d)
               / CS.HBM_BYTES_PER_S * 1e3, "ms": {"first": [], "kept": []},
               "ms_host": {"first": [], "kept": []}}
        calls = {"first": lambda: first(table, idx, pay),
                 "kept": lambda: BS.bucket_scatter_add(table, idx, pay)}
        for name in ("first", "kept", "kept", "first"):
            rec["ms"][name].append(CS.device_ms(calls[name]))
            rec["ms_host"][name].append(CS.median_ms(calls[name]))
        keep = (idx >= 0) & (idx < n)
        trash = torch.cat([table, table[:1]])
        lib_idx = torch.where(keep, idx, n).long()
        rec["index_add_ms"] = CS.device_ms(
            lambda: torch.index_add(trash, 0, lib_idx, pay))
        rec["index_add_ms_host"] = CS.median_ms(
            lambda: torch.index_add(trash, 0, lib_idx, pay))
        rec["kept_us_by_kernel"] = k5_profile(calls["kept"])
        for name in ("first", "kept"):
            rec[f"{name}_ms_mean_of_two"] = statistics.mean(rec["ms"][name])
            rec[f"{name}_ms_host_mean_of_two"] = statistics.mean(
                rec["ms_host"][name])
        print(f"K5 {what}: {rec}", flush=True)
        res[what] = rec
        del table, idx, pay, trash, lib_idx
        torch.cuda.empty_cache()
    res["walls"] = k5_walls(dev, first)
    return res


K9B_PARENT = ROOT / "build" / "k9b_parent.cu"
K9B_SHAPES = {"falcon-mamba-7b train layer": (1, 4096, 8192, 16),
              "zamba2-1.2b K9-form layer": (1, 4096, 4096, 64)}


def k9b(dev) -> dict:
    if not K9B_PARENT.exists():
        raise SystemExit(f"k9b: {K9B_PARENT} is missing (git show "
                         "<commit>:src/repro_torch/kernels/csrc/"
                         "mamba_scan_bwd.cu > build/k9b_parent.cu)")
    kept = MS._bwd_lib()
    libs = {"earlier": CS.bwd_variant("mamba_scan_bwd_earlier",
                                      K9B_PARENT.read_text()),
            "kept": kept}
    res = {}
    for what, shape in K9B_SHAPES.items():
        args, dy = CS.k9b_inputs((*shape, "strided"), torch.bfloat16, dev, 70)
        _, hc = MS.mamba_scan(*args, return_chunks=True)
        want = R.mamba_scan_bwd_plain(*args, dy, hc)
        bsz, seq, di, n = shape
        rec = {"shape": shape}
        for name, lib in libs.items():
            with CS.k9b_lib(lib):
                got = MS.mamba_scan_bwd(*args, dy, hc)
                work = lib.roomy_mamba_scan_bwd_work(
                    bsz, seq, di, n, MS.bwd_geometry(*shape)["np"])
            rels = CS.k9b_rels(got, want)
            rec[name] = {"over_limit": CS.k9b_over(rels, torch.bfloat16),
                         "scratch_bytes": 4 * (work - bsz * di * (n + 1)),
                         "ms": []}
            del got
        for name in ("earlier", "kept", "kept", "earlier"):
            with CS.k9b_lib(libs[name]):
                rec[name]["ms"].append(CS.median_ms(
                    lambda: MS.mamba_scan_bwd(*args, dy, hc)))
        for name in libs:
            rec[name]["ms_mean_of_two"] = statistics.mean(rec[name]["ms"])
        rec["speedup"] = (rec["earlier"]["ms_mean_of_two"]
                          / rec["kept"]["ms_mean_of_two"])
        print(f"K9-bwd {what} {shape}: {rec}", flush=True)
        res[what] = rec
        del args, dy, hc, want
        torch.cuda.empty_cache()
    return res


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_variants: torch.cuda.is_available() is False")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _build.build(["bitpack", "bucket_scatter", "paged_decode", "mamba_scan"])
    sections = {"bitpack": bitpack, "k4": k4, "k5": k5, "k8": k8, "k9": k9,
                "k9b": k9b}
    wanted = sys.argv[1:] or list(sections)
    unknown = sorted(set(wanted) - set(sections))
    if unknown:
        raise SystemExit(f"unknown sections {unknown}; pick from "
                         f"{list(sections)}")
    res = {"card": card}
    for name in wanted:
        res[name] = sections[name](dev)
    print(json.dumps({"variants": res}))


if __name__ == "__main__":
    main()
