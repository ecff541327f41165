"""Out-of-core set algebra (paper §3 'Set Operations'), genuinely on disk.

Port of ``examples/outofcore_setops.py``: builds two multisets far larger
than the RAM budget (one chunk), turns them into sets and computes union,
difference and intersection with the paper's recipes through
``core.disk.DiskList`` — every pass streaming, on the host, RAM held at
O(chunk) — then checks them against an in-RAM oracle.

  PYTHONPATH=src python -m repro_torch.apps.outofcore_setops --n 2000000 \\
      --chunk-rows 65536
"""
from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np

from ..core.disk import DiskList


def run(n: int = 500_000, chunk_rows: int = 1 << 14) -> dict:
    """The paper's set recipes over two seeded multisets of ``n`` rows,
    checked against the in-RAM oracle; returns the sizes and the seconds
    of each step."""
    rng = np.random.default_rng(0)
    out = {}
    with tempfile.TemporaryDirectory() as wd:
        A = DiskList(wd, width=1, chunk_rows=chunk_rows)
        B = DiskList(wd, width=1, chunk_rows=chunk_rows)
        a_vals = rng.integers(0, n, n).astype(np.uint32)
        b_vals = rng.integers(n // 2, 3 * n // 2, n).astype(np.uint32)
        A.add(a_vals[:, None])
        B.add(b_vals[:, None])
        print(f"|A|={A.size()} |B|={B.size()} rows on disk; "
              f"RAM budget ≈ {chunk_rows * 4 / 1e6:.2f} MB/chunk")

        t0 = time.perf_counter()
        A.remove_dupes(run_rows=chunk_rows)           # A := set(A)
        B.remove_dupes(run_rows=chunk_rows)
        out["dedupe_s"] = time.perf_counter() - t0
        print(f"as sets: |A|={A.size()} |B|={B.size()} "
              f"({out['dedupe_s']:.2f}s)")

        # paper recipe: A∩B = (A+B) − (A−B) − (B−A)
        t0 = time.perf_counter()
        AB = DiskList(wd, width=1, chunk_rows=chunk_rows)
        AB.add_all(A)
        AB.add_all(B)
        AB.remove_dupes(run_rows=chunk_rows)          # union
        AmB = DiskList(wd, width=1, chunk_rows=chunk_rows)
        AmB.add_all(A)
        AmB.remove_all(B)                             # A − B
        BmA = DiskList(wd, width=1, chunk_rows=chunk_rows)
        BmA.add_all(B)
        BmA.remove_all(A)                             # B − A
        inter = DiskList(wd, width=1, chunk_rows=chunk_rows)
        inter.add_all(AB)
        inter.remove_all(AmB)
        inter.remove_all(BmA)
        out["setops_s"] = dt = time.perf_counter() - t0
        out.update(union=AB.size(), a_minus_b=AmB.size(),
                   b_minus_a=BmA.size(), intersection=inter.size())
        print(f"|A∪B|={AB.size()} |A−B|={AmB.size()} |B−A|={BmA.size()} "
              f"|A∩B|={inter.size()}  ({dt:.2f}s, "
              f"{(A.size() + B.size()) / dt:.0f} elt/s)")

        sa, sb = set(a_vals.tolist()), set(b_vals.tolist())
        if (AB.size(), AmB.size(), BmA.size(), inter.size()) != (
                len(sa | sb), len(sa - sb), len(sb - sa), len(sa & sb)):
            raise SystemExit("set sizes disagree with the in-RAM oracle")
        if set(inter.read_all()[:, 0].tolist()) != (sa & sb):
            raise SystemExit("A∩B disagrees with the in-RAM oracle")
        print("verified against in-RAM oracle ✓")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=500_000)
    ap.add_argument("--chunk-rows", type=int, default=1 << 14)
    args = ap.parse_args(argv)
    run(args.n, args.chunk_rows)


if __name__ == "__main__":
    main()
