#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero, and no phase's error is
caught:

1. card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
   exits non-zero when ``torch.cuda.is_available()`` is false.
2. build: nvcc builds every ``src/repro_torch/kernels/csrc/*.cu`` for
   sm_90a into ``build/`` (one nvcc per source, all started together).
3. parity: K1–K3 against their plain PyTorch versions on the card,
   bit-exact (tolerance 0: the results are packed words and integer
   counts) — edge cases at small widths, then W = 29,937,600 words (12!
   states) with the real level-6 targets of pancake n = 12, K1 in place vs
   out of place.
4. times: CUDA events, median of 20 launches, at those n = 12 shapes, beside
   the byte bound at 3.35 TB/s and the plain version's time.
5. main path: pancake n = 12 through ``repro_torch.apps.pancake_bits.run``,
   fused (the default: 15 levels summing to 12!, diameter 14, K1 launched
   15 times, K2 once, K3 never), then unfused (K2 16 times, K3 15 times;
   the same levels and bit-identical words).  Launch counts are set to 0
   just before each run and read just after; the ``kernels`` line adds
   the two runs up.
6. fused ≡ unfused at n = 11 (bit-identical words), kernels ≡ plain
   versions at n = 9, both on the card.
7. the ``kernels`` JSON line, the card line, and last
   ``{"ok": true, "device": {...}}``.
"""
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

from repro_torch.apps import pancake_bits as P  # noqa: E402
from repro_torch.core import bitarray as BA  # noqa: E402
from repro_torch.core import constructs as C  # noqa: E402
from repro_torch.core import obs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import bitpack as K  # noqa: E402
from repro_torch.kernels import ref as R  # noqa: E402

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
REPS = 20
LEVEL = 6                     # the n = 12 level whose targets set M
ROTATE = BA.ROTATE_LUT
LUTS = [(ROTATE, BA.CUR), (K.make_lut([0, 0, 2, 1]), 0),
        (K.make_lut([3, 2, 1, 0]), 3), (K.make_lut([1, 1, 1, 1]), 1)]
MARKS = [(2, 0), (1, 0), (3, 1), (0, 2), (2, 2)]
SOURCE = "src/repro_torch/kernels/csrc/bitpack.cu"
KERNELS = [  # (launch-counter name, TPU kernel it replaces)
    ("mark_rotate_count", "src/repro/kernels/bitpack.py:221"),
    ("scatter_mark", "src/repro/kernels/bitpack.py:142"),
    ("lut_count", "src/repro/kernels/bitpack.py:71"),
]
MAX_ERR = {name: 0 for name, _ in KERNELS}


def expect(ok: bool, what) -> None:
    """A check that holds under ``python -O`` too."""
    if not ok:
        raise AssertionError(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def phase_card() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    line = card_line()
    print(f"card: {line}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s)")
    return line


def phase_build() -> None:
    names = _build.sources()
    secs = _build.build(names)
    print(f"build: {secs:.3f} s for {names} "
          f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    for name, log in _build.BUILD_LOGS.items():
        print(f"[{name}] {log.strip()}")
    K._lib()


# ------------------------------------------------------------------ parity

def _err(got, want) -> int:
    """Max |difference| of two word tensors read as uint32."""
    if got.numel() == 0:
        return 0
    return int(((got.long() & 0xFFFFFFFF) - (want.long() & 0xFFFFFFFF))
               .abs().max())


def check(name, got, want, gcnt=None, wcnt=None, what="") -> None:
    torch.cuda.synchronize()
    err = _err(got, want)
    if gcnt is not None:
        err = max(err, abs(int(gcnt) - int(wcnt)))
    MAX_ERR[name] = max(MAX_ERR[name], err)
    if err:
        raise AssertionError(f"{name} disagrees with its plain version "
                             f"({what}): max abs err {err}")


def check_all(words, idx, what, luts=LUTS, marks=MARKS) -> None:
    for lut, cval in luts:
        got, gc = K.bitpack_lut_count(words, lut, cval)
        want, wc = R.bitpack_lut_count_ref(words, lut, cval)
        check("lut_count", got, want, gc, wc, what)
        for mark, only_if in marks:
            want, wc = R.bitpack_mark_rotate_count_ref(words, idx, lut, cval,
                                                       mark, only_if)
            got, gc = K.bitpack_mark_rotate_count(words, idx, lut, cval,
                                                  mark=mark, only_if=only_if)
            check("mark_rotate_count", got, want, gc, wc, what)
            work = words.clone()
            got, gc = K.bitpack_mark_rotate_count(work, idx, lut, cval,
                                                  mark=mark, only_if=only_if,
                                                  inplace=True)
            check("mark_rotate_count", work, want, gc, wc, what + " inplace")
    for mark, only_if in marks:
        got = K.bitpack_scatter_mark(words, idx, mark=mark, only_if=only_if)
        want = R.bitpack_scatter_mark_ref(words, idx, mark, only_if)
        check("scatter_mark", got, want, what=what)


def random_words(rng, w, dev):
    raw = rng.integers(0, 1 << 32, w, dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(raw.view(np.int32)).to(dev)


def phase_parity_edges(dev) -> None:
    rng = np.random.default_rng(0)
    for w in (1, 3, 37, 129, 1000, 4099):
        cap = 16 * w
        idx = np.concatenate([rng.integers(-20, cap + 20, 4 * w + 5),
                              [0, 0, cap - 1, cap - 1, cap, cap + 1,
                               cap + 1000, -1, -cap]]).astype(np.int32)
        idx = torch.from_numpy(idx).to(dev)
        words = random_words(rng, w + 1, dev)
        check_all(words[:w], idx, f"W={w}")
        check_all(words[1:], idx, f"W={w} misaligned")   # scalar path
        check_all(words[:w], idx[:0], f"W={w} no targets")
    print("parity: edge cases bit-exact (widths 1..4099, duplicate, == cap, "
          "> cap and negative indices, only_if != 0, lut[0] == count_val, "
          "misaligned words, no targets)")


def phase_parity_full(dev):
    """Real n = 12 state at LEVEL and its targets; returns (data, tgt)."""
    n, total = 12, math.factorial(12)
    sizes, bits = C.implicit_bfs(total, [P.start_rank(n)], P.neighbors(n),
                                 max_levels=LEVEL, device=dev)
    data = bits.data
    tgt = C.frontier_targets(data, total, sizes[-1], P.neighbors(n))
    torch.cuda.synchronize()
    print(f"parity: n=12 W={data.shape[0]} words, level {LEVEL} has "
          f"{sizes[-1]} states -> M={tgt.shape[0]} targets")
    rot = [(ROTATE, BA.CUR)]
    check_all(data, tgt, "n=12 level state", luts=rot, marks=[(2, 0)])
    rng = np.random.default_rng(1)
    check_all(random_words(rng, data.shape[0], dev), tgt,
              "n=12 random words", luts=rot + [LUTS[1]],
              marks=[(2, 0), (3, 1)])
    print("parity: n=12 shapes bit-exact (K1 in place == out of place == "
          "plain; K2, K3 == plain)")
    return data, tgt


# ------------------------------------------------------------------- times

def median_ms(fn, setup=None) -> float:
    fn()                                   # warm-up
    times = []
    for _ in range(REPS):
        if setup is not None:
            setup()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase_times(data, tgt):
    w, m = data.shape[0], tgt.shape[0]
    work = torch.empty_like(data)
    restore = lambda: work.copy_(data)     # noqa: E731 — in-place K1 input
    bytes_ = {"mark_rotate_count": 8 * w + 4 * m,
              "scatter_mark": 8 * w + 4 * m, "lut_count": 8 * w}
    kernel = {
        "mark_rotate_count": lambda: K.bitpack_mark_rotate_count(
            work, tgt, ROTATE, BA.CUR, inplace=True),
        "scatter_mark": lambda: K.bitpack_scatter_mark(data, tgt),
        "lut_count": lambda: K.bitpack_lut_count(data, ROTATE, BA.CUR),
    }
    plain = {
        "mark_rotate_count": lambda: R.bitpack_mark_rotate_count_ref(
            data, tgt, ROTATE, BA.CUR, 2, 0),
        "scatter_mark": lambda: R.bitpack_scatter_mark_ref(data, tgt, 2, 0),
        "lut_count": lambda: R.bitpack_lut_count_ref(data, ROTATE, BA.CUR),
    }
    out = {}
    for name, _ in KERNELS:
        setup = restore if name == "mark_rotate_count" else None
        out[name] = {
            "ms": median_ms(kernel[name], setup),
            "plain_ms": median_ms(plain[name]),
            "bound_ms": bytes_[name] / HBM_BYTES_PER_S * 1e3,
        }
        print(f"time: {name}: {out[name]['ms']:.4f} ms, bound "
              f"{out[name]['bound_ms']:.4f} ms ({bytes_[name]} bytes at "
              f"3.35 TB/s), plain {out[name]['plain_ms']:.4f} ms, "
              f"library n/a")
    return out


# --------------------------------------------------------------- main path

def drive(n, fused, dev, spans=None):
    """One run of the user's entry point with every launch count set to 0
    just before it; returns (sizes, bits, secs, launches)."""
    K.reset_launches()
    if spans is not None:
        obs.enable(sink=spans.append)
    sizes, bits, secs = P.run(n, fused=fused, device=dev)
    obs.disable()
    return sizes, bits, secs, dict(K.LAUNCHES)


def phase_main_path(dev):
    """Pancake n = 12 fused (the default path: K1 per level, K2 for the
    start mark), then unfused (K2 then K3 per level); returns the launches
    of both runs added up."""
    n, total = 12, math.factorial(12)
    spans = []
    sizes, bits, secs, fused = drive(n, True, dev, spans)
    peak = torch.cuda.max_memory_allocated(dev)
    expect(len(sizes) == 15 and sum(sizes) == total, sizes)
    expect(len(sizes) - 1 == P.DIAMETERS[n] == 14, sizes)
    expect(fused == {"mark_rotate_count": 15, "scatter_mark": 1,
                     "lut_count": 0}, fused)
    expect(BA.count_value(bits, BA.DONE, total) == total, "unreached states")
    levels = []
    expands = [s for s in spans if s["sid"] == "bfs.expand"]
    for s, e in zip([s for s in spans if s["sid"] == "bfs.level"], expands):
        n_cur = e["attrs"]["n_cur"]
        levels.append({"level": s["attrs"]["level"], "n_cur": n_cur,
                       "M": n_cur * (n - 1), "level_ms": s["dur_us"] / 1e3,
                       "expand_ms": e["dur_us"] / 1e3,
                       "launches": s.get("metrics", {})})
    print(f"main path: pancake n=12 fused, {secs:.3f} s wall, "
          f"{total / secs:.0f} states/s, peak {peak} bytes, launches {fused}")
    sizes_u, bits_u, secs_u, unfused = drive(n, False, dev)
    expect(sizes_u == sizes, (sizes_u, sizes))
    expect(torch.equal(bits_u.data, bits.data), "fused and unfused differ")
    expect(unfused == {"mark_rotate_count": 0, "scatter_mark": 16,
                       "lut_count": 15}, unfused)
    print(f"main path: pancake n=12 unfused, {secs_u:.3f} s wall, "
          f"launches {unfused}; levels and words == fused")
    print(json.dumps({"main_path": {
        "n": n, "level_sizes": sizes, "wall_s": secs,
        "states_per_s": total / secs, "peak_bytes": peak,
        "launches": fused, "unfused_wall_s": secs_u,
        "unfused_launches": unfused, "levels": levels}}))
    return {k: fused[k] + unfused[k] for k in fused}


def phase_equivalence(dev) -> None:
    sf, bf, _ = P.run(11, fused=True, device=dev)
    su, bu, _ = P.run(11, fused=False, device=dev)
    expect(sf == su, (sf, su))
    expect(len(sf) - 1 == 13 and sum(sf) == math.factorial(11), sf)
    expect(torch.equal(bf.data, bu.data), "fused and unfused words differ")
    n, total = 9, math.factorial(9)
    sk, bk = C.implicit_bfs(total, [P.start_rank(n)], P.neighbors(n),
                            device=dev)
    sr, br = C.implicit_bfs(total, [P.start_rank(n)], P.neighbors(n),
                            impl="ref", device=dev)
    expect(sk == sr and len(sk) - 1 == 10, (sk, sr))
    expect(torch.equal(bk.data, br.data), "kernel and plain words differ")
    print("equivalence: n=11 fused == unfused (levels and words), "
          "n=9 kernels == plain versions on the card")


def main() -> None:
    t0 = time.perf_counter()
    phase_card()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    phase_parity_edges(dev)
    data, tgt = phase_parity_full(dev)
    times = phase_times(data, tgt)
    del data, tgt
    torch.cuda.empty_cache()
    launches = phase_main_path(dev)
    phase_equivalence(dev)
    kernels = [{"name": f"bitpack_{name}", "route": "cuda", "source": SOURCE,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": MAX_ERR[name], "ms": times[name]["ms"],
                "plain_ms": times[name]["plain_ms"],
                "bound_ms": times[name]["bound_ms"], "bound_by": "bytes",
                "library_ms": None}
               for name, replaces in KERNELS]
    print(f"total: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
