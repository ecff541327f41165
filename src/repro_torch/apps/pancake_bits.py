"""Pancake numbers via the implicit 2-bit BFS (the paper's Table 1), in
device memory (Tier J, the default ``--tier j``) or on disk (``--tier
disk``).

Port of ``examples/pancake_bits.py``: each stack of n pancakes is a
permutation, its Myrvold–Ruskey rank indexes a packed 2-bit array, and
every level is one fused kernel pass over that array.  On Tier D the
array is a ``DiskBitArray`` of chunk files and each level is one
read-write pass over them, one K1 launch a chunk on the card; its op
logs, checkpoints (``--checkpoint-dir``, ``--resume``, ``--stop-after``)
and fault storm (``--chaos``) are the reference's.  ``--shards N`` spreads
the array over N shard workers (``--shard-mode spawn|inline``), each
running its level pass over its own block, one K1 launch a chunk, with
the marks for other shards on the bucket wire (``--transport
fs|tcp|loopback``, ``--exchange barrier|pipelined``); ``--trace PATH``
writes the run's JSONL trace and prints its per-level report.
``--publish DIR`` then seals the search as a distance-oracle artifact
(``core/disk/oracle.py``), labelled on the device; ``--check`` (n ≤ 8)
holds the level sizes against the sorted-list engine
(``apps.pancake_bfs``) and an in-memory BFS distance table, and the
published oracle's distances against that table.

  PYTHONPATH=src python -m repro_torch.apps.pancake_bits --n 12
  PYTHONPATH=src python -m repro_torch.apps.pancake_bits --n 12 --publish DIR
  PYTHONPATH=src python -m repro_torch.apps.pancake_bits --n 7 --device cpu \
      --publish DIR --check
  PYTHONPATH=src python -m repro_torch.apps.pancake_bits --n 11 --unfused
  PYTHONPATH=src python -m repro_torch.apps.pancake_bits --n 11 --tier disk
  PYTHONPATH=src python -m repro_torch.apps.pancake_bits --n 11 --tier disk \
      --checkpoint-dir CK --stop-after 6      # then again with --resume
  PYTHONPATH=src python -m repro_torch.apps.pancake_bits --n 8 --tier disk \
      --device cpu --chaos 3 --check
  PYTHONPATH=src python -m repro_torch.apps.pancake_bits --n 11 --tier disk \
      --shards 4 [--transport tcp] [--exchange pipelined] [--trace run.jsonl]

Tier J: n ≤ 12, the packed kernels index elements with int32 (16·W <
2³¹).  Tier D indexes a chunk's fields locally, so n runs to 20 (int64
ranks); the op log (16 bytes a mark, fanout marks a state) sets its pace
and its disk.
Known diameters (OEIS A058986):
4→4 5→5 6→7 7→8 8→9 9→10 10→11 11→13 12→14.
"""
from __future__ import annotations

import argparse
import math
import os
import tempfile
import time

import numpy as np
import torch

from .. import device as _device
from ..core import constructs as C
from ..core import ranking as R
from ..core.disk import bitarray as DBA
from ..core.disk import extsort, faults, trace
from ..core.disk import oracle as O
from ..core.disk.bfs import implicit_bfs as disk_implicit_bfs
from ..core.disk.config import (CheckpointConfig, ClusterConfig,
                                RecoveryConfig)

DIAMETERS = {4: 4, 5: 5, 6: 7, 7: 8, 8: 9, 9: 10, 10: 11, 11: 13, 12: 14}


def prefix_flip_table(n: int) -> list:
    """Row k-2 reverses the first k positions (k = 2..n): the n − 1 moves
    of the pancake graph, as the positions each move reads."""
    return [list(range(k - 1, -1, -1)) + list(range(k, n))
            for k in range(2, n + 1)]


class RankNeighbors:
    """(m,) int64 ranks → (m, k) int64 ranks of the permutations that the
    k moves of ``table`` (rows of n positions, as ``prefix_flip_table``
    gives them) take each state to: unrank, permute, rank."""

    def __init__(self, n: int, table):
        self.n = n
        self.moves = torch.tensor(table, dtype=torch.int64)

    def __call__(self, states: torch.Tensor) -> torch.Tensor:
        perms = R.unrank(self.n, states)                    # (m, n)
        moved = perms[:, self.moves.to(perms.device)]       # (m, k, n)
        return R.rank(moved.reshape(-1, self.n)).view(-1, len(self.moves))


def neighbors(n: int) -> RankNeighbors:
    """The pancake graph's neighbour function: all n − 1 prefix flips."""
    return RankNeighbors(n, prefix_flip_table(n))


def start_rank(n: int) -> int:
    """Rank of the sorted stack."""
    return int(R.rank(torch.arange(n).unsqueeze(0))[0])


def ram_distances(n: int, device=None) -> torch.Tensor:
    """In-memory BFS distance table of all n! ranks (-1 = unreached), int64
    on ``device``: the independent check of the oracle's distances (the
    counterpart of ``examples/pancake_bits.py:94-108``)."""
    dev = _device.resolve(device)
    gen = neighbors(n)
    dist = torch.full((math.factorial(n),), -1, dtype=torch.int64,
                      device=dev)
    frontier = torch.tensor([start_rank(n)], dtype=torch.int64, device=dev)
    dist[frontier] = 0
    d = 0
    while frontier.numel():
        nb = torch.unique(gen(frontier).reshape(-1))
        nb = nb[dist[nb] < 0]
        d += 1
        dist[nb] = d
        frontier = nb
    return dist


def oracle_chunk_elems(total: int) -> int:
    """About 16 chunks whatever n, so that a cache budget below the artifact
    evicts (a multiple of 4, as the packing needs), as the reference's
    ``examples/pancake_bits.py`` chunks its artifacts."""
    return max(4, (-(-total // 16) + 3) // 4 * 4)


def publish(n: int, sizes, publish_dir: str, compress: bool = False,
            device=None) -> dict:
    """Seal a completed pancake search as a distance-oracle artifact."""
    meta = O.publish_oracle(
        publish_dir, math.factorial(n), [start_rank(n)], neighbors(n),
        level_sizes=sizes, chunk_elems=oracle_chunk_elems(math.factorial(n)),
        compress=compress, device=device,
        codec={"space": "pancake", "n": n, "ranking": "myrvold-ruskey"})
    print(f"published distance oracle v{meta['version']:06d} -> "
          f"{publish_dir} ({meta['n_chunks']} chunks, diameter "
          f"{len(meta['level_sizes']) - 1}; serve it with "
          "repro_torch.core.disk.oracle.DistanceOracle)")
    return meta


def check(n: int, sizes, publish_dir=None, device=None,
          disk: bool = False) -> None:
    """Hold the level sizes against the sorted-list engine (with ``disk``
    also the disk one's, on the host) and ``ram_distances``, and the
    published oracle's distances against ``ram_distances`` (meant for
    n ≤ 8): every rank up to n = 7, 4096 sampled ones above."""
    from . import pancake_bfs   # it imports this module
    total = math.factorial(n)
    res, _, _ = pancake_bfs.search(n, pancake_bfs.prefix_flips(n),
                                   device=device)
    if res.level_sizes != list(sizes):
        raise SystemExit(f"check: level sizes {list(sizes)} != the "
                         f"sorted-list engine's {res.level_sizes}")
    print("check: level sizes match the sorted-list BFS")
    if disk:
        want, _ = pancake_bfs.disk_search(
            n, pancake_bfs.HostMoves(n, prefix_flip_table(n)))
        if want != list(sizes):
            raise SystemExit(f"check: level sizes {list(sizes)} != the "
                             f"disk sorted-list engine's {want}")
        print("check: level sizes match the disk sorted-list BFS")
    ref = ram_distances(n, device)
    hist = torch.bincount(ref[ref >= 0]).tolist()
    if hist != list(sizes):
        raise SystemExit(f"check: level sizes {list(sizes)} != the "
                         f"in-memory BFS's {hist}")
    print("check: level sizes match the in-memory BFS distance table")
    if publish_dir is None:
        return
    with O.DistanceOracle(publish_dir, cache_bytes=1 << 16,
                          gen_neighbors=neighbors(n), device=device) as orc:
        if orc.level_sizes != list(sizes):
            raise SystemExit("check: the published histogram drifted from "
                             "the search's")
        if total <= math.factorial(7):
            sample = torch.arange(total, dtype=torch.int64)
        else:
            sample = torch.from_numpy(np.random.default_rng(0).choice(
                total, 4096, replace=False).astype(np.int64))
        sample = sample.to(ref.device)
        if not torch.equal(orc.lookup(sample), ref[sample]):
            raise SystemExit("check: oracle distances disagree with the "
                             "in-memory BFS")
    print(f"check: oracle distances match the in-memory BFS on "
          f"{sample.numel()} ranks")


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


def run_disk(n: int, chunk_elems: int = 1 << 20, fused: bool = True,
             compress: bool = False, checkpoint_dir=None,
             checkpoint_every: int = 1, resume: bool = False,
             stop_after=None, chaos=None, device=None, shards: int = 1,
             shard_mode: str = "spawn", transport: str = "fs",
             exchange=None, trace_path=None):
    """Pancake BFS for n on disk (Tier D): ``core.disk.implicit_bfs`` in a
    temporary directory, each chunk pass on ``device``, over ``shards``
    shard workers when it is above 1 (``shard_mode``, ``transport``,
    ``exchange``: the ``ClusterConfig``'s).  Prints the level table (or
    the levels so far, with ``stop_after``), states/s and the bytes the
    array and its logs moved (the workers' included).  ``chaos=SEED``
    runs under the reference's seeded I/O-fault storm
    (``faults.default_chaos_spec``, or ``$ROOMY_FAULTS`` when set; with
    shards, one worker is also killed mid-search and the run heals from
    its checkpoints, up to 8 times), with checkpoints in the temporary
    directory unless ``checkpoint_dir`` names some.  ``trace_path``
    writes the run's JSONL trace there and prints its report.  Returns
    (level_sizes, wall seconds)."""
    if not 3 <= n <= R.MAX_N:
        raise ValueError(f"n={n}: the rank encoding takes 3 <= n <= "
                         f"{R.MAX_N}")
    dev = _device.resolve(device)
    total = math.factorial(n)
    print(f"pancake n={n}: {total} states on disk, chunk passes on {dev} "
          f"({'fused' if fused else 'unfused'}), bit array = "
          f"{-(-total // 4)} bytes packed"
          + (f", shards={shards}" if shards > 1 else ""))
    before = dict(DBA.STATS)
    io_before = {k: extsort.STATS[k] for k in ("io_retries", "io_giveups",
                                                "recoveries",
                                                "replayed_levels")}
    if chaos is not None and not os.environ.get(faults.ENV_VAR):
        # The environment is how spawn workers inherit the plan.
        os.environ[faults.ENV_VAR] = faults.default_chaos_spec(chaos, shards)
    if trace_path:
        # Before the runtime spawns: workers read $ROOMY_TRACE at startup.
        trace.start(trace_path, meta={"example": "pancake_bits", "n": n,
                                      "tier": "disk", "nshards": shards})
    try:
        with tempfile.TemporaryDirectory() as wd:
            if chaos is not None:
                if shards == 1:
                    # A sharded run's runtime installs the plan itself.
                    faults.install_from_env(
                        state_dir=os.path.join(wd, "_faults"))
                if checkpoint_dir is None:
                    checkpoint_dir = os.path.join(wd, "chaos_ck")
            t0 = time.perf_counter()
            sizes, bits = disk_implicit_bfs(
                wd, total, [start_rank(n)], neighbors(n),
                chunk_elems=chunk_elems,
                max_levels=10_000 if stop_after is None else stop_after,
                fused=fused, compress=compress, device=dev,
                cluster=ClusterConfig(nshards=shards, mode=shard_mode,
                                      transport=transport,
                                      exchange=exchange),
                checkpoint=CheckpointConfig(dir=checkpoint_dir,
                                            every=checkpoint_every,
                                            resume=resume),
                recovery=RecoveryConfig(
                    max_recoveries=8 if chaos is not None else 0))
            if stop_after is None and int(bits.count_values()[0]):
                raise SystemExit("unreached states — graph not connected?")
            secs = time.perf_counter() - t0
            bits.destroy()
    finally:
        if chaos is not None:
            print(f"chaos: {faults.ENV_VAR}="
                  f"{os.environ.pop(faults.ENV_VAR)!r}")
            print("chaos: " + " ".join(
                f"{k}={extsort.STATS[k] - v}"
                for k, v in io_before.items()))
            faults.uninstall()
        if trace_path:
            trace.report(trace.stop())
    moved = {k: DBA.STATS[k] - before[k] for k in DBA.STATS}
    io = (f"array {moved['bytes_read'] - moved['log_bytes_read']} B read, "
          f"{moved['bytes_written'] - moved['log_bytes_written']} written; "
          f"op log {moved['log_bytes_written']} B written, "
          f"{moved['log_bytes_read']} read")
    if stop_after is not None and sum(sizes) < total:
        print("level sizes so far:", sizes)
        print(f"stopped after level {len(sizes) - 1} (checkpoint kept in "
              f"{checkpoint_dir}) — rerun with --resume to finish")
        return sizes, secs
    if sum(sizes) != total:
        raise SystemExit("did not enumerate the full graph!")
    print(f"{'flips':>6} {'states':>12} {'cumulative':>12}")
    cum = 0
    for lev, c in enumerate(sizes):
        cum += c
        print(f"{lev:>6} {c:>12} {cum:>12}")
    print(f"diameter (pancake number): {len(sizes) - 1}")
    print(f"{total / secs:.0f} states/s ({secs:.3f}s); {io}")
    return sizes, secs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=12)
    ap.add_argument("--tier", choices=("j", "disk"), default="j",
                    help="j: the array in device memory (default); disk: a "
                         "DiskBitArray of chunk files, each pass on the "
                         "device")
    ap.add_argument("--chunk-elems", type=int, default=1 << 20,
                    help="elements a chunk file holds (disk tier; a "
                         "multiple of 4)")
    ap.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                    help="persist mid-search checkpoints to DIR (disk "
                         "tier)")
    ap.add_argument("--checkpoint-every", type=int, default=1, metavar="N",
                    help="checkpoint every N completed levels")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the latest checkpoint in "
                         "--checkpoint-dir instead of starting over")
    ap.add_argument("--stop-after", type=int, default=None, metavar="LEVEL",
                    help="stop the search after LEVEL completed levels — "
                         "pair with --checkpoint-dir, then rerun with "
                         "--resume")
    ap.add_argument("--chaos", type=int, default=None, metavar="SEED",
                    help="run under a seeded I/O-fault storm (torn op-log "
                         "appends, transient flakes; $ROOMY_FAULTS when "
                         "set): the search must heal to the fault-free "
                         "level counts (disk tier)")
    ap.add_argument("--shards", type=int, default=1,
                    help="spread the disk tier's array over N shard "
                         "workers, each pass on --device")
    ap.add_argument("--shard-mode", choices=("spawn", "inline"),
                    default="spawn",
                    help="shard workers as processes (default) or in this "
                         "process")
    ap.add_argument("--transport", choices=("fs", "tcp", "loopback"),
                    default="fs",
                    help="bucket wire between shards: shared files "
                         "(default), TCP sockets, or the in-process "
                         "loopback store (inline mode only)")
    ap.add_argument("--exchange", choices=("barrier", "pipelined"),
                    default=None,
                    help="exchange discipline: two-phase barrier (default) "
                         "or overlapped produce/apply")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a JSONL trace of the disk tier's run to "
                         "PATH and print its per-level report (read it "
                         "again with python -m repro_torch.core.disk.trace "
                         "report PATH)")
    ap.add_argument("--unfused", action="store_true",
                    help="mark scatter then rotate+count (two kernels per "
                         "level) instead of the fused kernel")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "PyTorch versions of the kernels)")
    ap.add_argument("--publish", default=None, metavar="DIR",
                    help="after the search, seal it as an immutable "
                         "versioned distance-oracle artifact under DIR "
                         "(labelled on the device)")
    ap.add_argument("--compress", action="store_true",
                    help="store the disk tier's chunks and seal --publish "
                         "artifacts rle2-coded (format 2)")
    ap.add_argument("--check", action="store_true",
                    help="n <= 8: hold the level sizes against the "
                         "sorted-list engines and an in-memory BFS distance "
                         "table, and with --publish the oracle's distances "
                         "against that table")
    args = ap.parse_args(argv)
    disk = args.tier == "disk"
    if args.compress and args.publish is None and not disk:
        ap.error("--compress seals --publish artifacts (or the disk "
                 "tier's chunks); give --publish DIR or --tier disk")
    if args.check and args.n > 8:
        ap.error("--check needs n <= 8")
    if not disk and (args.checkpoint_dir or args.resume
                     or args.stop_after is not None
                     or args.chaos is not None or args.shards != 1
                     or args.transport != "fs" or args.exchange
                     or args.trace):
        ap.error("--checkpoint-dir, --resume, --stop-after, --chaos, "
                 "--shards, --transport, --exchange and --trace are the "
                 "disk tier's")
    if args.checkpoint_dir is None and (args.resume
                                        or args.stop_after is not None):
        ap.error("--resume and --stop-after need --checkpoint-dir")
    if args.stop_after is not None and (args.check or args.publish):
        ap.error("--check and --publish take a complete search; drop "
                 "--stop-after")
    if args.unfused and disk and (args.shards != 1 or args.transport != "fs"
                                  or args.exchange):
        ap.error("--unfused is the one-process pass; it cannot shard")
    if disk:
        sizes, _ = run_disk(args.n, args.chunk_elems, not args.unfused,
                            args.compress, args.checkpoint_dir,
                            args.checkpoint_every, args.resume,
                            args.stop_after, args.chaos, args.device,
                            args.shards, args.shard_mode, args.transport,
                            args.exchange, args.trace)
        if args.stop_after is not None and sum(sizes) < math.factorial(
                args.n):
            return
    else:
        sizes, _, _ = run(args.n, fused=not args.unfused, device=args.device)
    want = DIAMETERS.get(args.n)
    if want is not None and len(sizes) - 1 != want:
        raise SystemExit(f"diameter {len(sizes) - 1} != known {want}")
    if args.publish is not None:
        publish(args.n, sizes, args.publish, args.compress, args.device)
    if args.check:
        check(args.n, sizes, args.publish, args.device, disk=disk)


if __name__ == "__main__":
    main()
