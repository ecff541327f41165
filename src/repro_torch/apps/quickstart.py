"""Quickstart: the Roomy programming model on the port, on both tiers.

Port of ``examples/quickstart.py``: ``tier_j_tour`` (device tensors) — a
RoomyList with removeDupes and reduce, a RoomyArray's delayed updates and
sync, chain reduction and the hash table; ``tier_d_tour`` (real disk,
streaming, on the host) — a ``DiskList`` of 20,000 rows in chunks of
1024 with an external-sort removeDupes and a streaming reduce.  Both
print the reference's lines.

  PYTHONPATH=src python -m repro_torch.apps.quickstart
  PYTHONPATH=src python -m repro_torch.apps.quickstart --device cpu
"""
from __future__ import annotations

import argparse
import tempfile

import numpy as np
import torch

from .. import device as _device
from ..core import array as RA
from ..core import constructs as C
from ..core import hashtable as HT
from ..core import rlist as RL
from ..core.disk import DiskList


def tier_j_tour(device=None) -> None:
    dev = _device.resolve(device)
    print("== Tier J (device) ==")
    # RoomyList: multiset with streaming dedup / difference
    rl = RL.from_rows(np.array([[3], [1], [3], [7], [1]], np.uint32),
                      capacity=16, device=dev)
    print("size:", int(rl.count))
    rl = RL.remove_dupes(rl)
    print("after removeDupes:", sorted(RL.to_numpy(rl)[:, 0].tolist()))

    # paper's reduce example: sum of squares (uint32 arithmetic: the words'
    # low 32 bits, read unsigned)
    s = RL.reduce(rl, lambda r: r[:, 0] * r[:, 0], lambda a, b: a + b, 0)
    print("sum of squares:", int(s) & 0xFFFFFFFF)

    # RoomyArray: delayed updates + sync (scatter-gather)
    ra = RA.make(torch.zeros(8, dtype=torch.int32, device=dev),
                 queue_capacity=16, payload_dtype=torch.int32)
    ra, _ = RA.update(ra, torch.tensor([2, 2, 5], dtype=torch.int32,
                                       device=dev),
                      torch.tensor([10, 20, 7], dtype=torch.int32,
                                   device=dev))
    ra = RA.sync(ra, combine=lambda a, b: a + b,
                 apply=lambda old, agg: old + agg)
    print("array after sync:", ra.data.tolist())

    # chain reduction (paper §3): a[i] += a[i-1], old values throughout
    ra2 = RA.make(torch.arange(6, dtype=torch.int32, device=dev),
                  queue_capacity=8, payload_dtype=torch.int32)
    ra2 = C.chain_reduce(ra2, lambda old, prev: old + prev)
    print("chain reduction:", ra2.data.tolist())

    # RoomyHashTable: delayed inserts merged at sync
    ht = HT.make(capacity=16, key_width=1, queue_capacity=8,
                 val_dtype=torch.int32, device=dev)
    ht, _ = HT.insert(ht, torch.tensor([[5], [9], [5]], dtype=torch.int32,
                                       device=dev),
                      torch.tensor([1, 2, 3], dtype=torch.int32, device=dev))
    ht, _ = HT.sync(ht, combine=lambda a, b: a + b,
                    apply=lambda o, g, p: torch.where(p, o + g, g))
    vals, found = HT.lookup(ht, torch.tensor([[5], [9], [0]],
                                             dtype=torch.int32, device=dev))
    print("hashtable lookups:", vals.tolist(), found.tolist())


def tier_d_tour() -> None:
    print("\n== Tier D (real disk, streaming) ==")
    with tempfile.TemporaryDirectory() as wd:
        dl = DiskList(wd, width=1, chunk_rows=1024)   # tiny chunks
        rng = np.random.default_rng(0)
        dl.add(rng.integers(0, 5000, (20_000, 1)).astype(np.uint32))
        print("disk list size:", dl.size())
        dl.remove_dupes(run_rows=2048)                # external merge sort
        print("unique elements:", dl.size())
        total = dl.reduce(lambda c: int(c[:, 0].astype(np.int64).sum()),
                          lambda a, b: a + b, 0)
        print("streaming reduce (sum):", total)
        dl.destroy()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs on the CPU)")
    tier_j_tour(ap.parse_args(argv).device)
    tier_d_tour()


if __name__ == "__main__":
    main()
