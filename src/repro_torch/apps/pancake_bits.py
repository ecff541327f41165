"""Pancake numbers via the implicit 2-bit BFS on the GPU (the paper's Table 1).

Port of the Tier J part of ``examples/pancake_bits.py``: each stack of n
pancakes is a permutation, its Myrvold–Ruskey rank indexes a packed 2-bit
array, and every level is one fused kernel pass over that array.

  PYTHONPATH=src python -m repro_torch.apps.pancake_bits --n 12
  PYTHONPATH=src python -m repro_torch.apps.pancake_bits --n 7 --device cpu
  PYTHONPATH=src python -m repro_torch.apps.pancake_bits --n 11 --unfused

n ≤ 12: the packed kernels index elements with int32 (16·W < 2³¹).
Known diameters (OEIS A058986):
4→4 5→5 6→7 7→8 8→9 9→10 10→11 11→13 12→14.
"""
from __future__ import annotations

import argparse
import math
import time

import torch

from .. import device as _device
from ..core import constructs as C
from ..core import ranking as R

DIAMETERS = {4: 4, 5: 5, 6: 7, 7: 8, 8: 9, 9: 10, 10: 11, 11: 13, 12: 14}


class PancakeNeighbors:
    """(m,) int64 ranks → (m, n-1) int64 ranks of all n-1 prefix flips."""

    def __init__(self, n: int):
        self.n = n
        # row k-2 of the table reverses the first k positions (k = 2..n)
        self.flips = torch.tensor(
            [list(range(k - 1, -1, -1)) + list(range(k, n))
             for k in range(2, n + 1)], dtype=torch.int64)

    def __call__(self, states: torch.Tensor) -> torch.Tensor:
        perms = R.unrank(self.n, states)                    # (m, n)
        flipped = perms[:, self.flips.to(perms.device)]     # (m, n-1, n)
        return R.rank(flipped.reshape(-1, self.n)).view(-1, self.n - 1)


def neighbors(n: int) -> PancakeNeighbors:
    return PancakeNeighbors(n)


def start_rank(n: int) -> int:
    """Rank of the sorted stack."""
    return int(R.rank(torch.arange(n).unsqueeze(0))[0])


def run(n: int, fused: bool = True, device=None):
    """Full pancake BFS for n; prints the level table, states/s and peak
    device memory.  Returns (level_sizes, RoomyBitArray, wall seconds)."""
    if not 3 <= n <= R.MAX_N_1WORD:
        raise ValueError(f"n={n}: int32 element indices support "
                         f"3 <= n <= {R.MAX_N_1WORD}")
    dev = _device.resolve(device)
    total = math.factorial(n)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    sizes, bits = C.implicit_bfs(total, [start_rank(n)], neighbors(n),
                                 fused=fused, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    assert sum(sizes) == total, "did not enumerate the full graph!"
    print(f"pancake n={n}: {total} states on {dev} "
          f"({'fused' if fused else 'unfused'}), bit array = "
          f"{bits.data.numel() * 4} bytes packed")
    print(f"{'flips':>6} {'states':>12} {'cumulative':>12}")
    cum = 0
    for lev, c in enumerate(sizes):
        cum += c
        print(f"{lev:>6} {c:>12} {cum:>12}")
    print(f"diameter (pancake number): {len(sizes) - 1}")
    peak = (f"{torch.cuda.max_memory_allocated(dev)} bytes"
            if dev.type == "cuda" else "not measured (cpu)")
    print(f"{total / dt:.0f} states/s ({dt:.3f}s), peak device memory {peak}")
    return sizes, bits, dt


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=12)
    ap.add_argument("--unfused", action="store_true",
                    help="mark scatter then rotate+count (two kernels per "
                         "level) instead of the fused kernel")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "PyTorch versions of the kernels)")
    args = ap.parse_args(argv)
    sizes, _, _ = run(args.n, fused=not args.unfused, device=args.device)
    want = DIAMETERS.get(args.n)
    if want is not None and len(sizes) - 1 != want:
        raise SystemExit(f"diameter {len(sizes) - 1} != known {want}")


if __name__ == "__main__":
    main()
