"""ShardRuntime — the multiprocess sharded Tier D runtime: the port's own
copy of ``repro/core/disk/cluster.py``, the same protocol, files,
counters and checkpoints.

Invariant: partitions are disjoint under the static owner functions and
every delayed op reaches its owner exactly once through sealed buckets,
so for ANY nshards the sharded structures and both sharded BFS engines
are element-wise equivalent to their single-process forms, and the
per-level pass budgets hold PER SHARD (the exchange adds bucket I/O,
never a sort or an extra traversal).  A completed ``map`` is the
collective barrier; checkpoint epochs snapshot every shard at that
barrier before the coordinator publishes.

The paper's promise is that "all aspects of parallelism and remote I/O are
hidden within the library": a structure is partitioned over workers by a
static owner function, delayed operations are buffered into per-(src,dst)
buckets (``buckets.py``, on the wire of ``transport.py``), and a ``sync``
ships and applies them on the owner:

  * :class:`ShardRuntime` — N workers, each with its own shard root
    directory, driven by a coordinator over command queues.  Two worker
    modes: ``"spawn"`` (real processes, spawn start method, so every
    function and argument crossing the queue must be picklable) and
    ``"inline"`` (the same code in the coordinator process, sequentially,
    or in a thread a shard for the pipelined exchange).

  * Sharded wrappers — :class:`ShardedDiskList` and
    :class:`ShardedDiskHashTable` (hash-distributed, on the host as in
    the reference) and :class:`ShardedDiskBitArray` (block-distributed;
    each shard's block is a port ``DiskBitArray`` whose chunk passes run
    on the structure's device).  Bucket overflow is dropped and counted
    exactly; :meth:`ShardRuntime.sync` surfaces the totals per structure.

  * Distributed BFS on both engines — :func:`sharded_bfs` (sorted-list,
    on the host) and :func:`sharded_implicit_bfs` (2-bit array), reached
    through ``disk.breadth_first_search(..., cluster=)`` /
    ``disk.implicit_bfs``.  A sharded implicit level is ONE fused
    read-write pass over each shard's block, one K1 launch a chunk (marks,
    rotate, count), with the expansion of the new frontier on the device;
    marks for other shards ride the bucket wire to their owner.

What crosses a process boundary is numpy arrays and plain Python values,
never a CUDA tensor: workers hand the coordinator host copies, and the
coordinator moves results to the structure's device.  A spawn worker's
kernel launches (``kernels.bitpack.LAUNCHES``) reach the coordinator's
registry through :meth:`ShardRuntime.collect_obs`'s counter deltas, and
:func:`_w_get_stats` reports them per worker.

Sync protocol (one structure, one epoch): the coordinator seals its own
outgoing buckets, then runs two collective phases over the workers —
*seal* (every worker publishes its outgoing buckets for the epoch; the
phase completion is the barrier) and *apply* (every worker streams the
buckets addressed to it into its local structure's op log and syncs).
A worker killed mid-epoch leaves only ``.tmp`` bucket files, which
readers ignore and a fresh runtime sweeps away.
"""
from __future__ import annotations

import errno
import os
import shutil
import threading
import traceback
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ... import device as _device
from ...kernels import bitpack as _kbp
from .. import bitarray as BA
from .. import obs
from . import checkpoint as ckpt
from . import extsort, faults
from .bitarray import CUR, NEXT, UNSEEN, DiskBitArray
from .bitarray import STATS as BITS_STATS
from .buckets import (BucketSender, block_owner, block_owner_np,
                      block_size, hash_owner_np)
from .checkpoint import SearchCheckpoint
from .transport import (LoopbackStore, Transport, TransportAborted,
                        make_transport)
from .dhash import DiskHashTable
from .dlist import DiskList
from .lsm import SortedRunSet
from .passes import PassPlan
from .store import ChunkStore

__all__ = [
    "ShardContext", "ShardRuntime", "ShardFailure", "WorkerLost",
    "ShardedDiskList", "ShardedDiskHashTable",
    "ShardedDiskBitArray", "sharded_bfs", "sharded_implicit_bfs",
]

_MAP_TIMEOUT = 600.0          # seconds a collective phase may take


class WorkerLost(RuntimeError):
    """A shard worker died or timed out mid-collective.  Carries the shard
    id and the collective's name so the recovery path (and a human reading
    the log) knows exactly where the pool broke."""

    def __init__(self, msg: str, shard: Optional[int] = None,
                 phase: Optional[str] = None):
        super().__init__(msg)
        self.shard = shard
        self.phase = phase


class ShardFailure(RuntimeError):
    """Unrecoverable sharded-run failure — the loud, structured end state.

    Raised when in-run recovery is impossible (no adoptable coordinated
    checkpoint, ``max_recoveries`` budget exhausted, or a fatal errno
    survived the retry layer): the run stops HERE, naming the shard, the
    fault site/phase, the exchange epoch and the BFS level, instead of
    hanging on a dead queue or silently desynchronizing partitions."""

    def __init__(self, reason: str, *, shard=None, site=None, epoch=None,
                 level=None, recoveries: int = 0):
        self.shard = shard
        self.site = site
        self.epoch = epoch
        self.level = level
        self.recoveries = recoveries
        detail = ", ".join(
            f"{k}={v}" for k, v in (("shard", shard), ("site", site),
                                    ("epoch", epoch), ("level", level),
                                    ("recoveries", recoveries))
            if v is not None)
        super().__init__(f"{reason} [{detail}]")


def _recoverable(exc: BaseException) -> bool:
    """Whether in-run recovery may heal ``exc``: a lost or killed worker,
    a peer's wire aborted or timed out under a live one, or an I/O errno
    that outlived the retry layer.  Anything else — a kernel that cannot
    build or launch, the card out of memory, a bug — is raised as it
    came: a respawn would only hide it."""
    if isinstance(exc, (WorkerLost, faults.WorkerKilled, TransportAborted,
                        TimeoutError)):
        return True
    return isinstance(exc, OSError) and exc.errno is not None


# ============================================================== worker side

class ShardContext:
    """One worker's view of the runtime: its shard id, its private root
    directory (every local ChunkStore/op-log lives under it), its
    transport endpoint with its cached outgoing :class:`BucketSender` per
    structure, and the registry of local structure shards built up by
    coordinator commands."""

    def __init__(self, shard: int, nshards: int, root: str,
                 tspec: Optional[dict] = None, exchange: str = "barrier",
                 timeout: float = _MAP_TIMEOUT, store=None, abort=None):
        self.shard = int(shard)
        self.nshards = int(nshards)
        self.root = root
        self.exchange = exchange
        self.dir = os.path.join(root, f"shard{shard:03d}")
        os.makedirs(self.dir, exist_ok=True)
        self.objects: dict = {}
        self._writers: dict = {}
        self.transport: Transport = make_transport(
            tspec or {"kind": "fs"}, shard, nshards, root,
            abort=abort, store=store, timeout=timeout)

    @property
    def pipelined(self) -> bool:
        return self.exchange == "pipelined"

    def exchange_dir(self, name: str) -> str:
        return os.path.join(self.root, "exchange", name)

    def writer(self, spec: dict) -> BucketSender:
        """The (cached) outgoing bucket sender for one structure."""
        name = spec["name"]
        if name not in self._writers:
            self._writers[name] = self.transport.sender(spec)
        return self._writers[name]

    def recv(self, spec: dict, epoch: int, srcs, ordered: bool = True):
        """Stream (src, rows) addressed to this shard for one epoch,
        through the runtime's exchange discipline: barrier mode consumes
        a completed epoch, pipelined mode consumes each source as its
        completion marker lands."""
        return self.transport.recv(spec, epoch, tuple(srcs),
                                   live=self.pipelined, ordered=ordered)


def _worker_main(shard: int, nshards: int, root: str, cmd_q, res_q,
                 tspec: Optional[dict] = None,
                 exchange: str = "barrier",
                 timeout: float = _MAP_TIMEOUT) -> None:
    """Command loop of one spawned worker.  Every command is a picklable
    ``(fn, args)`` executed against the persistent :class:`ShardContext`;
    exceptions travel back as formatted strings (tracebacks don't
    pickle), with the errno of a failure :func:`_recoverable` heals.
    The fault plan (if ``$ROOMY_FAULTS`` is set) is installed with
    ``allow_exit=True``: ``kill`` rules here are a real ``os._exit``, the
    hard-death shape the coordinator's recovery must survive."""
    ctx = ShardContext(shard, nshards, root, tspec=tspec, exchange=exchange,
                       timeout=timeout)
    faults.install_from_env(state_dir=os.path.join(root, "_faults"),
                            shard=shard, allow_exit=True)
    # Tracing rides the environment exactly like the fault plan: trace.start
    # exports $ROOMY_TRACE before the pool spawns (and before recovery
    # respawns), so every worker buffers shard-tagged spans for the
    # coordinator to collect at the level barrier (_w_obs_collect).
    if os.environ.get(obs.ENV_VAR):
        obs.enable(shard=shard)
    while True:
        msg = cmd_q.get()
        if msg is None:
            ctx.transport.close()
            return
        fn, args = msg
        try:
            if faults.ACTIVE:     # barrier site: delay/kill before dispatch
                faults.fire("barrier", shard=shard,
                            fn=getattr(fn, "__name__", str(fn)))
            res_q.put((True, fn(ctx, *args)))
        except BaseException as exc:
            code = (getattr(exc, "errno", None) or errno.EIO
                    if _recoverable(exc) else None)
            res_q.put((False, (traceback.format_exc(), code)))


def _w_noop(ctx: ShardContext) -> int:
    return ctx.shard


def _w_seal(ctx: ShardContext, spec: dict, epoch: int) -> int:
    """Publish this worker's outgoing buckets for one structure/epoch.

    On wires with explicit completion (tcp, loopback — and the fs wire's
    pipelined markers) this seals even with nothing queued: an empty seal
    is cheap, a missing one hangs the receiver.  In fs barrier mode a
    shard that never wrote skips instead — absence IS the empty bucket
    there, and an unforced seal would adopt a killed peer's stray
    ``.tmp`` as real traffic (pinned by the abort-safety tests)."""
    if (spec["name"] not in ctx._writers and not ctx.pipelined
            and not ctx.transport.explicit_completion):
        return 0
    return int(ctx.writer(spec).seal(epoch,
                                     publish_done=ctx.pipelined).sum())


def _w_transport_addr(ctx: ShardContext):
    """This worker's receive endpoint (handshake round, tcp)."""
    return ctx.transport.handshake()


def _w_transport_connect(ctx: ShardContext, peers: dict) -> int:
    ctx.transport.connect(peers)
    return ctx.shard


def _w_exchange(ctx: ShardContext, spec: dict, epoch: int, apply_fn,
                *apply_args) -> tuple:
    """Pipelined sync of one structure on one worker: seal the outgoing
    buckets with completion markers, then apply inbound as each peer's
    marker lands (the apply_fn's ``ctx.recv`` is live here) — producing
    and applying overlap across shards, the barrier is only the map
    completing.  Returns (dropped, applied)."""
    dropped = int(ctx.writer(spec).seal(epoch, publish_done=True).sum())
    return dropped, apply_fn(ctx, spec, epoch, *apply_args)


def _w_get_stats(ctx: ShardContext) -> dict:
    """This worker's pass/byte ledgers (per-shard budget assertions) and
    its bit-pack kernel launches, in all and by route."""
    return {"extsort": dict(extsort.STATS), "bits": dict(BITS_STATS),
            "kernels": dict(_kbp.LAUNCHES),
            "bitpack_route": dict(_kbp.ROUTE_LAUNCHES)}


def _w_obs_collect(ctx: ShardContext) -> tuple:
    """This worker's registry snapshot plus its buffered spans, for the
    coordinator's telemetry fold (:meth:`ShardRuntime.collect_obs`).
    Counters are NOT reset — the coordinator folds deltas against its
    last collection, so ``_w_get_stats`` budget assertions keep seeing
    the worker's cumulative totals."""
    return obs.snapshot(), obs.drain_spans()


def _w_destroy(ctx: ShardContext, name: str) -> None:
    obj = ctx.objects.pop(name, None)
    if obj is not None:
        obj.destroy()
    ctx._writers.pop(name, None)


# ========================================================== coordinator side

class ShardRuntime:
    """N shard workers plus the coordinator-side bucket plumbing.

    mode="spawn"   real worker processes (multiprocessing spawn start
                   method — safe under CUDA and threads).  Functions, specs
                   and payloads crossing the queues must be picklable.
    mode="inline"  the same worker functions run sequentially in this
                   process — zero startup cost, closure-friendly; shard
                   state still lives in per-shard directories and all
                   exchange traffic still goes through bucket files, so
                   it exercises the identical on-disk protocol.

    The runtime owns ``root``: per-shard directories ``shard{k:03d}/``
    and the transport's exchange area (a shared ``exchange/`` directory
    for the fs wire; sockets/in-process mailboxes elsewhere).
    ``fresh=True`` (default) wipes leftovers from a previous (possibly
    killed) run; otherwise only ignorable ``.tmp``/``.pass`` strays are
    swept — and what the sweep cleaned is booked in ``extsort.STATS``
    (``stray_files_swept`` / ``stray_bytes_swept``), never silently
    discarded.

    ``transport=`` picks the wire (docs/transports.md): ``"fs"``
    (default, shared filesystem, byte-compatible layout), ``"tcp"``
    (sockets, no shared exchange dir), ``"loopback"`` (in-process
    mailbox, inline only).  ``exchange=`` picks the sync discipline:
    ``"barrier"`` (default, the legacy two-phase seal-all-then-apply-all)
    or ``"pipelined"`` (workers apply inbound buckets while peers are
    still producing; inline mode then runs its workers in a thread pool —
    the GIL-releasing numpy passes and device work overlap).
    """

    def __init__(self, root: str, nshards: int, mode: str = "spawn",
                 fresh: bool = True, timeout: float = _MAP_TIMEOUT,
                 transport: str = "fs", exchange: Optional[str] = None,
                 host: str = "127.0.0.1", wire_compress: bool = False):
        assert nshards >= 1
        assert mode in ("spawn", "inline"), mode
        assert exchange in (None, "barrier", "pipelined"), exchange
        if transport == "loopback" and mode != "inline":
            raise ValueError(
                "transport='loopback' is the in-process wire for "
                "mode='inline' — spawn workers cannot share its store")
        if wire_compress and transport == "fs":
            raise ValueError(
                "wire_compress=True needs a mailbox wire (tcp/loopback) — "
                "the fs bucket layout is a byte-compatibility contract")
        self.root = root
        self.nshards = int(nshards)
        self.mode = mode
        self.timeout = timeout
        self.exchange_mode = exchange or "barrier"
        self.tspec = {"kind": transport, "host": host,
                      "wire_compress": bool(wire_compress)}
        self._broken = False     # set when a collective desynchronizes
        self.epoch = 0
        self._seq = 0
        self._structs: dict = {}
        # Per-shard last-seen counter values (ns -> {key: value}), the
        # baselines collect_obs folds deltas against.  Spawn mode only:
        # inline workers mutate this process's registry directly.
        self._obs_base: List[dict] = [dict() for _ in range(self.nshards)]
        # The coordinator runs the same fault plan as the workers (if any)
        # but never exits the process: kill rules become WorkerKilled
        # raises, which inline mode and the BFS recovery path catch.
        faults.install_from_env(state_dir=os.path.join(root, "_faults"),
                                allow_exit=False)
        self._store = LoopbackStore() if transport == "loopback" else None
        # Inline workers share one abort flag: the first thread to fail a
        # pipelined level unblocks every peer's live recv.
        self._abort = threading.Event()
        # The coordinator acts as bucket source ``nshards`` (one past the
        # worker ids) — its delayed ops ride the same wire.
        self.driver = self._make_ctx(self.nshards)
        self.driver.transport.startup(fresh)
        self._procs: List = []
        self._cmd_qs: List = []
        self._res_qs: List = []
        self._inline_ctxs: List[ShardContext] = []
        if mode == "inline":
            self._inline_ctxs = [self._make_ctx(s)
                                 for s in range(self.nshards)]
        else:
            self._spawn_workers()
        self._handshake()

    @property
    def pipelined(self) -> bool:
        return self.exchange_mode == "pipelined"

    def _make_ctx(self, shard: int) -> ShardContext:
        return ShardContext(shard, self.nshards, self.root,
                            tspec=self.tspec, exchange=self.exchange_mode,
                            timeout=self.timeout, store=self._store,
                            abort=self._abort)

    def _spawn_workers(self) -> None:
        import multiprocessing as mp
        mpctx = mp.get_context("spawn")
        for s in range(self.nshards):
            cq, rq = mpctx.Queue(), mpctx.Queue()
            p = mpctx.Process(target=_worker_main,
                              args=(s, self.nshards, self.root, cq, rq,
                                    self.tspec, self.exchange_mode,
                                    self.timeout),
                              daemon=True)
            p.start()
            self._procs.append(p)
            self._cmd_qs.append(cq)
            self._res_qs.append(rq)

    def _handshake(self) -> None:
        """Endpoint-exchange round for transports with real addresses
        (tcp): collect every worker's receive endpoint, broadcast the
        peer map, and wire the coordinator's own sender.  Runs after
        every (re)spawn, before any seal."""
        if self.tspec["kind"] != "tcp":
            return
        if self.mode == "inline":
            peers = {c.shard: c.transport.handshake()
                     for c in self._inline_ctxs}
            for c in self._inline_ctxs:
                c.transport.connect(peers)
        else:
            addrs = self.bcast(_w_transport_addr)
            peers = {s: a for s, a in enumerate(addrs)}
            self.bcast(_w_transport_connect, peers)
        self.driver.transport.connect(peers)

    # ------------------------------------------------------------ plumbing
    def next_epoch(self) -> int:
        self.epoch += 1
        return self.epoch

    def next_name(self, prefix: str) -> str:
        self._seq += 1
        return f"{prefix}{self._seq}"

    def _get_result(self, s: int, fn_name: str):
        """Blocking result read from shard s, polling in short slices so a
        dead worker is reported within seconds, not after the full
        collective timeout."""
        import queue as _queue
        import time as _time
        deadline = _time.monotonic() + self.timeout
        while True:
            try:
                return self._res_qs[s].get(timeout=2.0)
            except _queue.Empty:
                # Check the WHOLE pool, not just shard s: in a pipelined
                # exchange a live worker blocks on a dead peer's buckets,
                # so the stall surfaces on the wrong queue first.
                for i, p in enumerate(self._procs):
                    if not p.is_alive():
                        raise WorkerLost(
                            f"shard {i} died during {fn_name}",
                            shard=i, phase=fn_name) from None
                if _time.monotonic() >= deadline:
                    raise WorkerLost(
                        f"shard {s} timed out during {fn_name}",
                        shard=s, phase=fn_name) from None

    def map(self, fn: Callable, args: Optional[Sequence[tuple]] = None
            ) -> list:
        """Run ``fn(ctx, *args[s])`` on every shard; a completed map is the
        runtime's collective barrier.  ``args`` is one tuple per shard
        (or None for no arguments)."""
        argl = list(args) if args is not None else [()] * self.nshards
        assert len(argl) == self.nshards
        if self.mode == "inline":
            if self.pipelined and self.nshards > 1:
                return self._map_threaded(fn, argl)
            outs = []
            for ctx, a in zip(self._inline_ctxs, argl):
                if faults.ACTIVE:     # same barrier site the workers fire
                    faults.fire("barrier", shard=ctx.shard,
                                fn=getattr(fn, "__name__", str(fn)))
                outs.append(fn(ctx, *a))
            return outs
        if self._broken:
            raise RuntimeError(
                "ShardRuntime is desynchronized (a previous collective "
                "timed out or lost a worker) — recover() or build a "
                "fresh runtime")
        fn_name = getattr(fn, "__name__", str(fn))
        for q, a in zip(self._cmd_qs, argl):
            q.put((fn, tuple(a)))
        outs, errors, codes = [], [], []
        for s in range(self.nshards):
            try:
                ok, val = self._get_result(s, fn_name)
            except RuntimeError:
                # Results may still be in flight: any further command
                # would pair stale replies with new requests, so poison
                # the runtime instead of silently desynchronizing.
                self._broken = True
                raise
            if ok:
                outs.append(val)
            else:
                errors.append(f"shard {s}:\n{val[0]}")
                codes.append(val[1])
        if errors:
            # Every shard answered — queues are still aligned, the
            # runtime stays usable.  A worker's I/O failure comes back an
            # OSError (recovery may heal it); any other error is final.
            msg = f"worker failure in {fn_name}:\n" + "\n".join(errors)
            io = [c for c in codes if c is not None]
            if len(io) == len(codes):
                raise OSError(io[0], msg)
            raise RuntimeError(msg)
        return outs

    def _map_threaded(self, fn: Callable, argl: list) -> list:
        """Pipelined inline map: every shard's worker function runs in
        its own thread (the carried ROADMAP item — the numpy passes and
        file I/O release the GIL, so inline mode finally overlaps).
        Necessary for correctness too: a pipelined level blocks on peer
        buckets, which a sequential loop would deadlock on.  The FIRST
        failure sets the shared abort flag immediately (waiting for
        earlier futures first would stall every live peer until its recv
        timeout); the lowest failing shard's ORIGINAL exception
        propagates — abort-induced :class:`~.transport.TransportAborted`
        secondaries are only raised when nothing better exists."""
        from concurrent.futures import (FIRST_EXCEPTION, ThreadPoolExecutor,
                                        wait as _futwait)

        def run(ctx, a):
            if faults.ACTIVE:     # same barrier site the workers fire
                faults.fire("barrier", shard=ctx.shard,
                            fn=getattr(fn, "__name__", str(fn)))
            return fn(ctx, *a)

        self._abort.clear()
        outs: list = [None] * self.nshards
        errs: list = [None] * self.nshards
        with ThreadPoolExecutor(max_workers=self.nshards,
                                thread_name_prefix="shard") as pool:
            futs = [pool.submit(run, ctx, a)
                    for ctx, a in zip(self._inline_ctxs, argl)]
            done, _pending = _futwait(futs, return_when=FIRST_EXCEPTION)
            if any(f.exception() is not None for f in done):
                self._abort.set()        # unblock peers' live recvs NOW
            _futwait(futs)
            for s, fut in enumerate(futs):
                exc = fut.exception()
                if exc is not None:
                    errs[s] = exc
                    self._abort.set()
                else:
                    outs[s] = fut.result()
        real = [e for e in errs
                if e is not None and not isinstance(e, TransportAborted)]
        for exc in real or [e for e in errs if e is not None]:
            raise exc
        return outs

    def bcast(self, fn: Callable, *args) -> list:
        """map() with the same (picklable) arguments on every shard."""
        return self.map(fn, [tuple(args)] * self.nshards)

    def barrier(self) -> None:
        self.bcast(_w_noop)

    # ------------------------------------------------------------ exchange
    def seal_driver(self, spec: dict, epoch: int) -> int:
        """Seal the coordinator's outgoing buckets for one epoch
        (publishing completion markers in pipelined mode); returns the
        exact overflow-drop count."""
        return int(self.driver.writer(spec)
                   .seal(epoch, publish_done=self.pipelined).sum())

    def exchange(self, spec: dict, apply_fn: Callable, *apply_args) -> dict:
        """One delayed-op sync of one structure.  Barrier mode: seal
        everywhere (the completed seal map IS the barrier), then apply
        everywhere.  Pipelined mode: one collective in which each worker
        seals with completion markers and applies peers' buckets as they
        land — produce and apply overlap, the barrier is only the map
        completing.  Both return {"dropped": n, "applied": [...]} with
        the EXACT count of rows lost to bucket-capacity overflow
        (coordinator + all workers), mirroring ``bin_by_dest``."""
        epoch = self.next_epoch()
        dropped = self.seal_driver(spec, epoch)
        if self.pipelined:
            res = self.bcast(_w_exchange, spec, epoch, apply_fn,
                             *apply_args)
            dropped += sum(d for d, _a in res)
            return {"dropped": dropped, "applied": [a for _d, a in res]}
        dropped += sum(self.bcast(_w_seal, spec, epoch))
        applied = self.bcast(apply_fn, spec, epoch, *apply_args)
        return {"dropped": dropped, "applied": applied}

    def wipe_exchange(self, name: str) -> None:
        """Discard every queued/sealed bucket of one structure, on
        whatever wire this runtime runs (rollback and destroy: in-flight
        buckets of a failed epoch are dead traffic)."""
        self.driver.transport.wipe(name)
        for ctx in self._inline_ctxs:
            ctx.transport.wipe(name)

    def register(self, struct) -> None:
        self._structs[struct.name] = struct

    def sync(self) -> dict:
        """Sync every registered sharded structure (default combine/apply);
        returns {structure_name: exact_dropped_count}."""
        out = {name: s.sync() for name, s in self._structs.items()}
        self.collect_obs()
        return out

    # ------------------------------------------------------------ telemetry
    def collect_obs(self) -> None:
        """Fold the spawn workers' counter deltas (and, when tracing,
        their buffered spans) into the coordinator's obs registry, so
        pass/byte totals survive worker process exit and a distributed
        run produces ONE coherent trace.

        Spawn mode only: inline workers run in this process and mutate
        the shared module registries directly — folding would double
        count.  Deltas are taken against the last collection per shard
        (``_obs_base``); :meth:`recover` resets the baselines because
        respawned workers restart their counters at zero.  Never raises:
        a dying pool must not turn telemetry into the crash."""
        if self.mode != "spawn" or self._broken or not self._procs:
            return
        try:
            snaps = self.bcast(_w_obs_collect)
        except (RuntimeError, OSError):
            return
        for shard, (snap, spans) in enumerate(snaps):
            base = self._obs_base[shard]
            for ns, vals in snap["counters"].items():
                prev = base.setdefault(ns, {})
                live = obs.counters(ns, {})
                for k, v in vals.items():
                    d = v - prev.get(k, 0)
                    if d:
                        live[k] = live.get(k, 0) + d
                    prev[k] = v
            if obs.ACTIVE and spans:
                obs.ingest(spans, shard=shard)

    # ------------------------------------------------------------ lifecycle
    def shutdown(self) -> None:
        """Stop the workers (spawn mode).  Shard directories stay on disk.
        Always returns, even for a broken pool: see _teardown_workers.
        Final telemetry sweep first — pass/byte totals booked since the
        last barrier would otherwise die with the worker processes."""
        self.collect_obs()
        self._teardown_workers()
        for ctx in self._inline_ctxs:
            ctx.transport.close()
        self.driver.transport.close()

    def _teardown_workers(self) -> None:
        """Tear the worker pool down without ever hanging.

        A worker blocked writing a large result cannot exit until its
        result queue drains, and a Queue's feeder thread will block
        interpreter exit unless cancelled — so the order is: send stop
        sentinels (non-blocking), drain every result queue, escalate
        join → terminate → kill, then close and ``cancel_join_thread()``
        every queue.  Safe on an already-dead or desynchronized pool."""
        if not self._procs and not self._cmd_qs:
            return
        import queue as _queue
        for q in self._cmd_qs:
            try:
                q.put_nowait(None)
            except Exception:
                pass
        for rq in self._res_qs:
            while True:
                try:
                    rq.get_nowait()
                except (_queue.Empty, OSError, ValueError):
                    break
        for p in self._procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        for q in list(self._cmd_qs) + list(self._res_qs):
            try:
                q.close()
                q.cancel_join_thread()
            except Exception:
                pass
        self._procs, self._cmd_qs, self._res_qs = [], [], []

    def recover(self) -> None:
        """Return a broken runtime to a usable state after a failed
        collective: tear down the (dead, wedged, or desynchronized) worker
        pool, respawn it, and drop coordinator-side buffered bucket
        writers.  Shard directories are NOT touched — the caller is
        expected to re-adopt a coordinated checkpoint (the BFS recovery
        path) or rebuild its structures before issuing new collectives:
        respawned workers start with empty object registries.  The
        counter deltas and spans the old workers booked since the last
        :meth:`collect_obs` go with them (a dead worker cannot report and
        a survivor's reply queue is out of step), so after a recovery the
        coordinator's totals are short by that much."""
        self.driver._writers = {}
        self._abort.clear()
        if self.mode == "inline":
            for ctx in self._inline_ctxs:
                ctx.transport.close()     # tcp receiver threads would leak
            self._inline_ctxs = [self._make_ctx(s)
                                 for s in range(self.nshards)]
        else:
            self._teardown_workers()
            self._spawn_workers()
        # Respawned workers restart their counters at zero: reset the
        # delta baselines or the next collect_obs would fold negatives.
        self._obs_base = [dict() for _ in range(self.nshards)]
        self._broken = False
        self._handshake()                 # fresh pool, fresh endpoints

    def destroy(self) -> None:
        """Shutdown and remove every shard/exchange directory."""
        self.shutdown()
        shutil.rmtree(self.root, ignore_errors=True)

    def __enter__(self) -> "ShardRuntime":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()


# =============================================================== make/apply

def _w_make(ctx: ShardContext, spec: dict) -> None:
    kind, name = spec["kind"], spec["name"]
    if kind == "list":
        ctx.objects[name] = DiskList(ctx.dir, spec["width"],
                                     spec["chunk_rows"], name=name)
    elif kind == "hash":
        ctx.objects[name] = DiskHashTable(ctx.dir, spec["key_width"],
                                          spec["val_width"],
                                          nbuckets=spec["nbuckets"], name=name)
    elif kind == "bits":
        per = spec["per"]
        n_local = max(0, min(per, spec["n"] - ctx.shard * per))
        # Each worker resolves the spec's device itself ("cuda" is the
        # host's first card).
        ctx.objects[name] = DiskBitArray(
            ctx.dir, n_local, chunk_elems=spec["chunk_elems"], name=name,
            log_buf_rows=spec["log_buf_rows"],
            init_chunks=spec.get("init_chunks", True),
            compress=spec.get("compress", False),
            device=spec.get("device"), impl=spec.get("impl", "auto"))
    else:
        raise ValueError(f"unknown structure kind {kind!r}")


class _ShardedBase:
    """Coordinator-side handle: a name, a picklable spec, and the routing
    of driver-issued delayed ops into the driver's bucket writer."""

    def __init__(self, runtime: ShardRuntime, spec: dict):
        self.runtime = runtime
        self.spec = spec
        self.name = spec["name"]
        self._own_runtime = False     # set by the bfs.py wrappers: destroy()
        runtime.bcast(_w_make, spec)  # then also shuts the runtime down
        runtime.register(self)

    def _put(self, dest: np.ndarray, rows: np.ndarray) -> None:
        self.runtime.driver.writer(self.spec).put(dest, rows)

    def destroy(self) -> None:
        self.runtime.bcast(_w_destroy, self.name)
        self.runtime._structs.pop(self.name, None)
        self.runtime.driver._writers.pop(self.name, None)
        self.runtime.wipe_exchange(self.name)
        if self._own_runtime:
            self.runtime.shutdown()


# ------------------------------------------------------------- DiskList

def _w_list_apply(ctx: ShardContext, spec: dict, epoch: int) -> int:
    obj = ctx.objects[spec["name"]]
    got = 0
    for _src, rows in ctx.recv(spec, epoch, range(ctx.nshards + 1)):
        obj.add(rows)
        got += rows.shape[0]
    obj.store.flush()
    return got


def _w_list_size(ctx: ShardContext, name: str) -> int:
    return ctx.objects[name].size()


def _w_list_read(ctx: ShardContext, name: str) -> np.ndarray:
    return ctx.objects[name].read_all()


def _w_list_remove_dupes(ctx: ShardContext, name: str) -> None:
    ctx.objects[name].remove_dupes()


def _w_list_remove_all(ctx: ShardContext, name: str, other: str) -> None:
    ctx.objects[name].remove_all(ctx.objects[other])


def _w_list_add_all(ctx: ShardContext, name: str, other: str) -> None:
    ctx.objects[name].add_all(ctx.objects[other])


class ShardedDiskList(_ShardedBase):
    """RoomyList partitioned by ``hash_owner`` across the shard workers.

    ``add`` is delayed: rows land in per-destination bucket files and
    reach their owner's DiskList at :meth:`sync`.  Set algebra
    (remove_dupes / remove_all / add_all between equally-sharded lists)
    is purely shard-local — the owner function makes the partitions
    disjoint, so local ops compose to the global op."""

    def __init__(self, runtime: ShardRuntime, width: int,
                 name: str | None = None, chunk_rows: int = 1 << 16,
                 capacity: Optional[int] = None):
        spec = {"kind": "list", "name": name or runtime.next_name("slist"),
                "width": width, "chunk_rows": chunk_rows,
                "rec_width": width, "rec_dtype": "uint32",
                "capacity": capacity}
        super().__init__(runtime, spec)
        self.width = width

    def add(self, rows: np.ndarray) -> None:
        rows = np.ascontiguousarray(rows, np.uint32).reshape(-1, self.width)
        self._put(hash_owner_np(rows, self.runtime.nshards), rows)

    def sync(self) -> int:
        return self.runtime.exchange(self.spec, _w_list_apply)["dropped"]

    def size(self) -> int:
        return sum(self.runtime.bcast(_w_list_size, self.name))

    def remove_dupes(self) -> None:
        self.runtime.bcast(_w_list_remove_dupes, self.name)

    def remove_all(self, other: "ShardedDiskList") -> None:
        assert other.runtime is self.runtime
        self.runtime.bcast(_w_list_remove_all, self.name, other.name)

    def add_all(self, other: "ShardedDiskList") -> None:
        assert other.runtime is self.runtime
        self.runtime.bcast(_w_list_add_all, self.name, other.name)

    def read_all(self) -> np.ndarray:
        """Gathered rows, sorted for comparability (tests/small data)."""
        parts = self.runtime.bcast(_w_list_read, self.name)
        rows = np.concatenate(parts, axis=0) if parts else \
            np.zeros((0, self.width), np.uint32)
        return extsort.sort_rows(rows) if rows.shape[0] else rows


# --------------------------------------------------------- DiskHashTable

def _w_hash_apply(ctx: ShardContext, spec: dict, epoch: int,
                  combine, apply) -> int:
    kw, vw = spec["key_width"], spec["val_width"]
    obj = ctx.objects[spec["name"]]
    got = 0
    # Ascending-src consumption (ordered even when pipelined) keeps each
    # key's PUT/DEL interleaving deterministic across sources.
    for _src, rec in ctx.recv(spec, epoch, range(ctx.nshards + 1)):
        got += rec.shape[0]
        ops = rec[:, 0]
        keys = rec[:, 1:1 + kw].astype(np.uint32)
        vals = rec[:, 1 + kw:]
        # Replay in record order, splitting at op changes so each key's
        # PUT/DEL interleaving reaches the table's sequential op log
        # exactly as issued.
        bnd = np.flatnonzero(np.diff(ops)) + 1
        for lo, hi in zip(np.r_[0, bnd], np.r_[bnd, ops.shape[0]]):
            if ops[lo] == DiskHashTable.OP_PUT:
                obj.insert(keys[lo:hi], vals[lo:hi])
            else:
                obj.remove(keys[lo:hi])
    obj.sync(combine=combine, apply=apply)
    return got


def _w_hash_lookup(ctx: ShardContext, name: str, keys: np.ndarray):
    return ctx.objects[name].lookup(keys)


def _w_hash_size(ctx: ShardContext, name: str) -> int:
    return ctx.objects[name].size()


def _w_hash_items(ctx: ShardContext, name: str):
    return list(ctx.objects[name].items())


class ShardedDiskHashTable(_ShardedBase):
    """RoomyHashTable partitioned by ``hash_owner`` of the key row.

    Delayed inserts/removes are encoded as int64 records
    ``[op, key_words..., val_words...]`` in the bucket files and replayed
    on the owner in deterministic order (ascending source id, issue order
    within a source), feeding DiskHashTable's sequential per-key op log —
    so DEL→PUT resurrects and PUT→DEL removes exactly as in the
    single-process table.  ``lookup`` is the delayed-access round trip:
    queries scatter to owners, results gather back in issue order."""

    def __init__(self, runtime: ShardRuntime, key_width: int, val_width: int,
                 name: str | None = None, nbuckets: int = 16,
                 capacity: Optional[int] = None):
        spec = {"kind": "hash", "name": name or runtime.next_name("shash"),
                "key_width": key_width, "val_width": val_width,
                "nbuckets": nbuckets,
                "rec_width": 1 + key_width + val_width, "rec_dtype": "int64",
                "capacity": capacity}
        super().__init__(runtime, spec)
        self.kw, self.vw = key_width, val_width

    def _queue(self, keys, vals, op: int) -> None:
        keys = np.ascontiguousarray(keys, np.uint32).reshape(-1, self.kw)
        vals = np.ascontiguousarray(vals, np.int64).reshape(keys.shape[0],
                                                            self.vw)
        rec = np.empty((keys.shape[0], 1 + self.kw + self.vw), np.int64)
        rec[:, 0] = op
        rec[:, 1:1 + self.kw] = keys
        rec[:, 1 + self.kw:] = vals
        self._put(hash_owner_np(keys, self.runtime.nshards), rec)

    def insert(self, keys, vals) -> None:
        self._queue(keys, vals, DiskHashTable.OP_PUT)

    def remove(self, keys) -> None:
        keys = np.asarray(keys, np.uint32).reshape(-1, self.kw)
        self._queue(keys, np.zeros((keys.shape[0], self.vw), np.int64),
                    DiskHashTable.OP_DEL)

    def sync(self, combine=None, apply=None) -> int:
        """In spawn mode ``combine``/``apply`` must be picklable."""
        return self.runtime.exchange(self.spec, _w_hash_apply,
                                     combine, apply)["dropped"]

    def lookup(self, keys):
        keys = np.asarray(keys, np.uint32).reshape(-1, self.kw)
        owner = hash_owner_np(keys, self.runtime.nshards)
        args = [(self.name, keys[owner == s])
                for s in range(self.runtime.nshards)]
        res = self.runtime.map(_w_hash_lookup, args)
        out = np.zeros((keys.shape[0], self.vw), np.int64)
        found = np.zeros(keys.shape[0], bool)
        for s, (vals, ok) in enumerate(res):
            sel = np.flatnonzero(owner == s)
            out[sel], found[sel] = vals, ok
        return out, found

    def size(self) -> int:
        return sum(self.runtime.bcast(_w_hash_size, self.name))

    def items(self):
        for shard_items in self.runtime.bcast(_w_hash_items, self.name):
            for tk, tv in shard_items:
                yield tk, tv


# --------------------------------------------------------- DiskBitArray

def _host(x, dtype) -> np.ndarray:
    """A tensor (on any device) or array-like as a flat numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype).reshape(-1)


def _absorb(ctx: ShardContext, obj: DiskBitArray, spec: dict, epoch: int,
            srcs) -> int:
    """Queue the (global_idx, val) records bucket-shipped to this shard at
    ``epoch`` into its block's op log, ascending src; returns the rows.
    A bucket goes to the device ``log_buf_rows`` records at a time, so
    the device holds a slice, not the frontier (the op log's bytes are
    the same: each chunk's records keep their order)."""
    base = ctx.shard * spec["per"]
    step = spec["log_buf_rows"]
    got = 0
    for _src, rec in ctx.recv(spec, epoch, srcs):
        for lo in range(0, rec.shape[0], step):
            part = rec[lo:lo + step]
            obj.update(part[:, 0] - base, part[:, 1].astype(np.uint8))
        got += rec.shape[0]
    return got


def _w_bits_apply(ctx: ShardContext, spec: dict, epoch: int,
                  combine, apply) -> int:
    obj = ctx.objects[spec["name"]]
    got = _absorb(ctx, obj, spec, epoch, range(ctx.nshards + 1))
    obj.sync(combine=combine, apply=apply)
    return got


def _w_bits_count(ctx: ShardContext, name: str) -> np.ndarray:
    return ctx.objects[name].count_values().cpu().numpy()


def _w_bits_read(ctx: ShardContext, name: str) -> np.ndarray:
    return ctx.objects[name].read_all().cpu().numpy()


def _w_bits_get(ctx: ShardContext, name: str, base: int,
                idx: np.ndarray) -> np.ndarray:
    return ctx.objects[name].get(np.asarray(idx, np.int64) - base
                                 ).cpu().numpy()


class ShardedDiskBitArray(_ShardedBase):
    """2-bit RoomyArray block-distributed over the shard workers.

    Shard s owns global indices [s·per, (s+1)·per) with
    per = ceil(n / nshards) (``buckets.block_owner_np``).  Delayed
    ``update`` records are (global_idx, val) int64 pairs on the bucket
    wire; sync applies them through each local DiskBitArray's
    snapshot-isolated op log.  Each shard's block lives on ``device``
    (default ``"cuda"``; every worker resolves it itself, and ``impl`` is
    the bit-pack kernels' choice there); ``get``, ``read_all`` and
    ``count_values`` return tensors on that device.  ``sync``'s
    ``combine`` / ``apply`` take and return tensors on it (in spawn mode
    they must be picklable)."""

    def __init__(self, runtime: ShardRuntime, n: int,
                 name: str | None = None, chunk_elems: int = 1 << 22,
                 log_buf_rows: int = 1 << 20,
                 capacity: Optional[int] = None, init_chunks: bool = True,
                 compress: bool = False, device=None, impl: str = "auto"):
        self.device = _device.resolve(device)
        spec = {"kind": "bits", "name": name or runtime.next_name("sbits"),
                "n": int(n), "per": block_size(int(n), runtime.nshards),
                "chunk_elems": chunk_elems, "log_buf_rows": log_buf_rows,
                "rec_width": 2, "rec_dtype": "int64", "capacity": capacity,
                "init_chunks": init_chunks, "compress": compress,
                "device": str(self.device), "impl": impl}
        super().__init__(runtime, spec)
        self.n = int(n)
        self.per = spec["per"]

    def update(self, idx, vals) -> None:
        idx = _host(idx, np.int64)
        vals = _host(vals, np.uint8)
        ok = (idx >= 0) & (idx < self.n)    # out-of-range drops, as ever
        idx, vals = idx[ok], vals[ok]
        rec = np.empty((idx.shape[0], 2), np.int64)
        rec[:, 0] = idx
        rec[:, 1] = vals
        self._put(block_owner_np(idx, self.n, self.runtime.nshards), rec)

    def sync(self, combine=None, apply=None) -> int:
        """In spawn mode ``combine``/``apply`` must be picklable."""
        return self.runtime.exchange(self.spec, _w_bits_apply,
                                     combine, apply)["dropped"]

    def count_values(self) -> torch.Tensor:
        """(4,) int64 histogram of element values, on the device."""
        counts = self.runtime.bcast(_w_bits_count, self.name)
        return torch.from_numpy(np.sum(np.stack(counts, axis=0), axis=0)
                                ).to(self.device)

    def get(self, idx) -> torch.Tensor:
        """(m,) uint8 values at global indices, on the device."""
        idx = _host(idx, np.int64)
        if idx.size:
            assert idx.min() >= 0 and idx.max() < self.n, \
                "get: index out of range"
        owner = block_owner_np(idx, self.n, self.runtime.nshards)
        args = [(self.name, s * self.per, idx[owner == s])
                for s in range(self.runtime.nshards)]
        out = np.empty(idx.shape[0], np.uint8)
        for s, vals in enumerate(self.runtime.map(_w_bits_get, args)):
            out[owner == s] = vals
        return torch.from_numpy(out).to(self.device)

    def read_all(self) -> torch.Tensor:
        """(n,) values on the device — shard order IS global order (block
        layout)."""
        parts = self.runtime.bcast(_w_bits_read, self.name)
        out = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
        return torch.from_numpy(out).to(self.device)


# ==================================================== distributed BFS (sorted)

def _w_bfs_init(ctx: ShardContext, spec: dict) -> None:
    name = spec["name"]
    ctx.objects[name] = {
        "all": SortedRunSet(ctx.dir, spec["width"], spec["chunk_rows"],
                            max_runs=spec["max_runs"], name=f"{name}_all",
                            policy=spec["compaction"],
                            size_ratio=spec["size_ratio"],
                            codec=spec.get("codec")),
        "cur": None, "builder": None, "lev": 0,
    }


def _w_bfs_seed(ctx: ShardContext, spec: dict, epoch: int) -> int:
    """Sort+dedupe the seed rows routed to this shard into level 0."""
    st = ctx.objects[spec["name"]]
    builder = extsort.RunBuilder(os.path.join(ctx.dir, f"{spec['name']}_tmp"),
                                 spec["width"], chunk_rows=spec["chunk_rows"],
                                 run_rows=spec["run_rows"],
                                 codec=spec.get("codec"))
    # Seed rows come from the coordinator alone (source id nshards).
    for _src, rows in ctx.recv(spec, epoch, (ctx.nshards,)):
        builder.add(rows)
    runs = builder.finish()
    lev0 = ChunkStore(os.path.join(ctx.dir, f"{spec['name']}_lev0"),
                      spec["width"], chunk_rows=spec["chunk_rows"], fresh=True,
                      codec=spec.get("codec"))
    try:
        extsort.merge_runs(runs, lev0, dedupe=True)
    finally:
        for r in runs:
            r.destroy()
    st["all"].add_run(lev0)
    st["cur"] = lev0
    return lev0.size


def _w_bfs_expand(ctx: ShardContext, spec: dict, gen_next, epoch: int,
                  lev: int = 0) -> int:
    """Expand the local frontier: locally-owned neighbours stream straight
    into this shard's RunBuilder (the level's ONE sort pass, paid as the
    rows are generated); remote neighbours go to the owner's bucket.
    Seals the epoch's buckets — map completion is the barrier."""
    if faults.ACTIVE:     # the worker-kill-at-level-k site
        faults.fire("worker_level", shard=ctx.shard, level=lev)
    st = ctx.objects[spec["name"]]
    with obs.span("bfs.level", level=lev, shard=ctx.shard, phase="expand"):
        builder = extsort.RunBuilder(
            os.path.join(ctx.dir, f"{spec['name']}_tmp"), spec["width"],
            chunk_rows=spec["chunk_rows"], run_rows=spec["run_rows"],
            codec=spec.get("codec"))
        writer = ctx.writer(spec)
        for chunk in st["cur"].iter_chunks():
            nbrs = np.ascontiguousarray(gen_next(np.asarray(chunk)),
                                        np.uint32).reshape(-1, spec["width"])
            owner = hash_owner_np(nbrs, ctx.nshards)
            local = owner == ctx.shard
            if local.any():
                builder.add(nbrs[local])
            if not local.all():
                writer.put(owner[~local], nbrs[~local])
        st["builder"] = builder
        return int(writer.seal(epoch, publish_done=ctx.pipelined).sum())


def _w_bfs_absorb(ctx: ShardContext, spec: dict, epoch: int) -> int:
    """Finish the level: received frontier rows join the SAME RunBuilder
    (still the one sort pass), then merge+dedupe+subtract against the
    local visited runs — the shard-local copy of bfs.level_step."""
    from .bfs import _merge_subtract
    st = ctx.objects[spec["name"]]
    with obs.span("bfs.level", level=st["lev"] + 1, shard=ctx.shard,
                  phase="absorb"):
        builder = st.pop("builder")
        # Expansion rows come from the workers (the coordinator only ever
        # seeds); in pipelined mode this recv is live — each peer's rows
        # join the builder as soon as its markers land.
        for _src, rows in ctx.recv(spec, epoch, range(ctx.nshards)):
            builder.add(rows)
        runs = builder.finish()
        st["all"].maybe_compact()
        st["lev"] += 1
        nxt = ChunkStore(
            os.path.join(ctx.dir, f"{spec['name']}_lev{st['lev']}"),
            spec["width"], chunk_rows=spec["chunk_rows"], fresh=True,
            codec=spec.get("codec"))
        try:
            _merge_subtract(runs, st["all"].runs, nxt)
        finally:
            for r in runs:
                r.destroy()
        if nxt.size:
            st["all"].add_run(nxt)
            st["cur"] = nxt
        else:
            nxt.destroy()
            st["cur"] = ChunkStore(
                os.path.join(ctx.dir, f"{spec['name']}_empty"), spec["width"],
                chunk_rows=spec["chunk_rows"], fresh=True)
            st["cur"].flush(mark_sorted=True)
        return nxt.size


def _w_bfs_level(ctx: ShardContext, spec: dict, gen_next, epoch: int,
                 lev: int) -> tuple:
    """One whole pipelined level: expand + seal with completion markers,
    then absorb peers' rows as their markers land — this shard applies
    inbound buckets while slower shards are still producing, and the only
    barrier left is the map completing at the level boundary.  Returns
    (dropped, next_frontier_size); budgets unchanged (the level's one
    sort pass is the same RunBuilder the barrier path fills)."""
    dropped = _w_bfs_expand(ctx, spec, gen_next, epoch, lev)
    return dropped, _w_bfs_absorb(ctx, spec, epoch)


def _w_bfs_snapshot(ctx: ShardContext, spec: dict, stage_root: str,
                    prev_root: Optional[str]) -> dict:
    """Snapshot this shard's partition of a sorted-list search — the
    visited run stack and the current frontier — into its subdirectory of
    the coordinator's staging dir.  Runs at the level barrier (a completed
    map IS the barrier), so every shard's snapshot describes the same
    level.  Runs this worker already exported into the previous published
    snapshot (``prev_root``, tracked worker-side in ``st["ckpt_names"]``)
    hard-link instead of re-copying.  Returns the picklable per-shard
    state for the manifest."""
    st = ctx.objects[spec["name"]]
    sub = f"shard{ctx.shard:03d}"
    prev_dir = os.path.join(prev_root, sub) if prev_root else None
    state = ckpt.snapshot_sorted_state(
        os.path.join(stage_root, sub), st["all"], st["cur"],
        prev_dir=prev_dir, prev_names=st.get("ckpt_names"))
    st["ckpt_names"] = set(state["runs"])
    state["lev"] = st["lev"]
    return state


def _w_bfs_restore(ctx: ShardContext, spec: dict, snap_root: str,
                   state: dict) -> None:
    """Rebuild this shard's search state from a sealed snapshot (the
    inverse of :func:`_w_bfs_snapshot`); a ``cur_index`` of None means the
    shard's frontier was empty at snapshot time."""
    _w_bfs_init(ctx, spec)
    st = ctx.objects[spec["name"]]
    cur = ckpt.restore_sorted_state(
        os.path.join(snap_root, f"shard{ctx.shard:03d}"), state, st["all"],
        ctx.dir, spec["width"], spec["chunk_rows"])
    if cur is None:
        cur = ChunkStore(os.path.join(ctx.dir, f"{spec['name']}_empty"),
                         spec["width"], chunk_rows=spec["chunk_rows"],
                         fresh=True)
        cur.flush(mark_sorted=True)
    st["cur"] = cur
    st["lev"] = int(state["lev"])


def _w_bfs_visited_size(ctx: ShardContext, name: str) -> int:
    return ctx.objects[name]["all"].size()


def _w_bfs_visited_read(ctx: ShardContext, name: str) -> np.ndarray:
    return ctx.objects[name]["all"].read_all()


def _w_bfs_destroy(ctx: ShardContext, name: str) -> None:
    st = ctx.objects.pop(name, None)
    if st is not None:
        st["all"].destroy()
    shutil.rmtree(os.path.join(ctx.dir, f"{name}_tmp"), ignore_errors=True)
    ctx._writers.pop(name, None)


class ShardedVisited:
    """Handle over the per-shard visited SortedRunSets (size/read_all/
    destroy — the same surface the single-process engines return)."""

    def __init__(self, runtime: ShardRuntime, spec: dict, dropped: int):
        self.runtime = runtime
        self.spec = spec
        self.name = spec["name"]
        self.dropped = dropped        # exact bucket-overflow loss, whole search
        self._own_runtime = False

    def size(self) -> int:
        return sum(self.runtime.bcast(_w_bfs_visited_size, self.name))

    def read_all(self) -> np.ndarray:
        parts = self.runtime.bcast(_w_bfs_visited_read, self.name)
        rows = np.concatenate(parts, axis=0)
        return extsort.sort_rows(rows) if rows.shape[0] else rows

    def destroy(self) -> None:
        self.runtime.bcast(_w_bfs_destroy, self.name)
        self.runtime.wipe_exchange(self.name)
        if self._own_runtime:
            self.runtime.shutdown()


def _ckpt_sharded_sorted(ck: SearchCheckpoint, runtime: ShardRuntime,
                         spec: dict, level_sizes: List[int],
                         dropped: int, prev: dict) -> None:
    """One coordinated checkpoint epoch (sorted engine): every shard
    snapshots its partition at the level barrier, then the coordinator
    seals and publishes — so the manifest is either absent (crash
    mid-stage: previous checkpoint adoptable) or names a snapshot every
    shard completed.  ``prev`` carries this search's previous sealed
    snapshot dir so shards hard-link unchanged runs; updated in place."""
    version = ck.next_version()
    stage = ck.begin(version)
    shards = runtime.bcast(_w_bfs_snapshot, spec, stage, prev.get("dir"))
    prev["dir"] = ck.publish(version, {
        "engine": "sorted", "sharded": True, "nshards": runtime.nshards,
        "width": spec["width"], "n_states": 0,
        "level_sizes": list(level_sizes), "dropped": int(dropped),
        "golden": ckpt.golden_owner_values(runtime.nshards, spec["width"], 0),
        "shards": shards})


def _roll_back(runtime: ShardRuntime, ck: Optional[SearchCheckpoint],
               spec: dict, exc: BaseException, lev: int,
               recoveries: int, max_recoveries: int) -> dict:
    """In-run recovery shared by both sharded BFS engines.

    Called when a level's collective (or its checkpoint publish) failed
    with ``exc``.  Either readies the runtime for re-adoption of the last
    coordinated checkpoint and returns its manifest state (the caller
    rebuilds every shard from it), or raises a structured
    :class:`ShardFailure` — never hangs, never leaves the pool
    desynchronized.  Steps: validate that recovery is possible (an
    adoptable checkpoint exists, the ``max_recoveries`` budget is not
    exhausted), drain and respawn the worker pool (:meth:`ShardRuntime.
    recover`), wipe the structure's exchange dir (in-flight buckets of
    the failed epoch are dead traffic).  Books the rollback under
    ``extsort.STATS['recoveries']`` and the levels that must be re-run
    under ``'replayed_levels'`` — separate from the pass ledgers, so the
    per-level pass budgets still hold for the non-replayed work."""
    shard = getattr(exc, "shard", None)
    site = getattr(exc, "phase", None) or type(exc).__name__
    # The span closes on the failure raises too — an unrecoverable run
    # still traces WHERE it died (shard_lost / site / level attrs).
    with obs.span("recovery.rollback", level=lev, shard_lost=shard,
                  site=site, attempt=recoveries + 1):
        state = None
        if ck is not None:
            try:
                state = ck.latest()
            except ckpt.CheckpointError:
                state = None
        if state is None:
            raise ShardFailure(
                "sharded BFS failed and no coordinated checkpoint is "
                "adoptable — enable checkpoint_dir= to make runs recoverable",
                shard=shard, site=site, epoch=runtime.epoch, level=lev,
                recoveries=recoveries) from exc
        if recoveries >= max_recoveries:
            raise ShardFailure(
                f"sharded BFS failed and the recovery budget is exhausted "
                f"({recoveries}/{max_recoveries} used) — raise "
                "max_recoveries= to keep self-healing",
                shard=shard, site=site, epoch=runtime.epoch, level=lev,
                recoveries=recoveries) from exc
        obs.add(extsort.STATS, "recoveries", 1)
        runtime.recover()
        runtime.wipe_exchange(spec["name"])
        obs.add(extsort.STATS, "replayed_levels",
                max(0, lev - (len(state["level_sizes"]) - 1)))
        return state


def sharded_bfs(runtime: ShardRuntime, start_rows: np.ndarray, gen_next,
                width: int, chunk_rows: int = 1 << 16,
                max_levels: int = 10_000, run_rows: int = 1 << 18,
                max_runs: int = 8, compaction: str = "full",
                size_ratio: int = 2, bucket_capacity: Optional[int] = None,
                checkpoint_dir: Optional[str] = None,
                checkpoint_every: int = 1, resume: bool = False,
                max_recoveries: int = 0, compress: bool = False):
    """Distributed sorted-list BFS: each shard owns the states hashing to
    it, sorts only its own partition (one sort pass per level per shard),
    and ships cross-shard expansion rows through the bucket exchange.

    In spawn mode ``gen_next`` must be picklable (a module-level class
    instance — see ``apps/pancake_bfs.py``'s ``HostMoves``).  Returns
    (level_sizes, ShardedVisited); level counts are exactly the
    single-process engine's for any nshards.

    ``checkpoint_dir=`` adds the coordinated checkpoint epoch of
    docs/checkpointing.md: each shard snapshots its partition at the
    level (sync) barrier, the coordinator publishes atomically.  Resume
    re-validates nshards and the owner-function golden values before any
    shard adopts its partition.

    ``max_recoveries=`` > 0 arms in-run self-healing: a worker death,
    collective timeout, or fatal I/O error rolls every shard back to the
    last coordinated checkpoint and resumes from that level (respawning
    the spawn pool), up to the budget — with level counts provably equal
    to the fault-free run (docs/fault-tolerance.md).  When recovery is
    impossible the run raises a structured :class:`ShardFailure`.
    """
    spec = {"kind": "bfs", "name": runtime.next_name("bfs"), "width": width,
            "chunk_rows": chunk_rows, "run_rows": run_rows,
            "max_runs": max_runs, "compaction": compaction,
            "size_ratio": size_ratio, "rec_width": width,
            "rec_dtype": "uint32", "capacity": bucket_capacity,
            "codec": "keys" if compress else None}
    ck = SearchCheckpoint(checkpoint_dir) if checkpoint_dir else None
    ck_prev: dict = {}

    def _adopt(st: dict):
        """Rebuild every shard from a sealed snapshot; returns the
        (level_sizes, dropped) the manifest pins."""
        snap = ck.snapshot_dir(st)
        runtime.map(_w_bfs_restore,
                    [(spec, snap, st["shards"][s])
                     for s in range(runtime.nshards)])
        return [int(x) for x in st["level_sizes"]], int(st.get("dropped", 0))

    state = ck.latest() if (ck is not None and resume) else None
    if state is not None:
        ckpt.validate_resume(state, "sorted", runtime.nshards, width, 0,
                             sharded=True)
        runtime.bcast(_w_bfs_init, spec)
        level_sizes, dropped = _adopt(state)
    else:
        runtime.bcast(_w_bfs_init, spec)
        start_rows = np.ascontiguousarray(start_rows,
                                          np.uint32).reshape(-1, width)
        with obs.span("bfs.level", level=0, engine="sorted",
                      nshards=runtime.nshards):
            writer = runtime.driver.writer(spec)
            writer.put(hash_owner_np(start_rows, runtime.nshards), start_rows)
            epoch = runtime.next_epoch()
            dropped = runtime.seal_driver(spec, epoch)
            sizes = runtime.bcast(_w_bfs_seed, spec, epoch)
            runtime.collect_obs()
        level_sizes = [sum(sizes)]
        if level_sizes[0] == 0:
            return [], ShardedVisited(runtime, spec, dropped)
        if ck is not None:      # level-0 snapshot: any kill is resumable
            _ckpt_sharded_sorted(ck, runtime, spec, level_sizes, dropped,
                                 ck_prev)
    recoveries = 0
    lev = len(level_sizes)
    high = lev - 1            # highest level ever started (replay tagging)
    while lev <= max_levels:
        # Coordinator-side level span: closes at the barrier, so its
        # metric deltas include the worker totals collect_obs folds in.
        # Levels re-run after a rollback carry replay=True.
        attrs = {"level": lev, "engine": "sorted", "nshards": runtime.nshards}
        if lev <= high:
            attrs["replay"] = True
        high = max(high, lev)
        try:
            with obs.span("bfs.level", **attrs):
                epoch = runtime.next_epoch()
                if runtime.pipelined:
                    res = runtime.bcast(_w_bfs_level, spec, gen_next,
                                        epoch, lev)
                    dropped += sum(d for d, _t in res)
                    total = sum(t for _d, t in res)
                else:
                    dropped += sum(runtime.bcast(_w_bfs_expand, spec,
                                                 gen_next, epoch, lev))
                    total = sum(runtime.bcast(_w_bfs_absorb, spec, epoch))
                runtime.collect_obs()
                if total == 0:
                    break
                level_sizes.append(total)
                if ck is not None and lev % checkpoint_every == 0:
                    _ckpt_sharded_sorted(ck, runtime, spec, level_sizes,
                                         dropped, ck_prev)
        except (RuntimeError, OSError) as exc:
            # Worker death/timeout (WorkerLost), a killed worker, or a fatal
            # I/O error: roll back to the last coordinated checkpoint and
            # replay, or die loudly.  Any other error is final.
            if not _recoverable(exc):
                raise
            state = _roll_back(runtime, ck, spec, exc, lev, recoveries,
                               max_recoveries)
            runtime.bcast(_w_bfs_init, spec)
            level_sizes, dropped = _adopt(state)
            recoveries += 1
            # Respawned workers carry no incremental-link history: the next
            # snapshot full-copies (safe; linking resumes after it).
            ck_prev.clear()
            lev = len(level_sizes)
            continue
        lev += 1
    return level_sizes, ShardedVisited(runtime, spec, dropped)


# ================================================= distributed BFS (implicit)

def _w_ibfs_pass(ctx: ShardContext, spec: dict, gen_neighbors,
                 epoch_in: int, srcs_in: tuple, epoch_out: int, seed: bool,
                 lev: int = 0) -> tuple:
    """One fused BFS level on this shard's block of the bit array.

    Absorbs the marks bucket-shipped here at epoch_in (they join the
    locally queued marks in the op-log snapshot), then runs the SAME
    single fused read-write pass as the single-process engine: one K1
    launch a chunk applies the marks (UNSEEN→NEXT), rotates (CUR→DONE,
    NEXT→CUR) and counts CUR, and the freshly rotated CUR fields expand
    on the device.  Expansion marks for local states queue straight into
    the (snapshot-isolated) op log; marks for remote states go to the
    owner's bucket (one device-to-host copy a batch), sealed at
    epoch_out.  Per-shard budget: exactly ONE rw pass over the local
    array per level, zero sorts."""
    if faults.ACTIVE:     # the worker-kill-at-level-k site
        faults.fire("worker_level", shard=ctx.shard, level=lev)
    with obs.span("bfs.level", level=lev, shard=ctx.shard, phase="pass"):
        obj: DiskBitArray = ctx.objects[spec["name"]]
        base = ctx.shard * spec["per"]
        n, nshards = spec["n"], ctx.nshards
        expand_batch = spec["expand_batch"]
        writer = ctx.writer(spec)
        _absorb(ctx, obj, spec, epoch_in, srcs_in)

        count = 0

        def count_cur(chunk_start: int, k: int) -> None:
            nonlocal count
            count += k

        def expand(chunk_start: int, vals: torch.Tensor) -> None:
            cur_pos = torch.nonzero(vals == CUR).flatten()
            for lo in range(0, cur_pos.shape[0], expand_batch):
                idx = base + chunk_start + cur_pos[lo:lo + expand_batch]
                nbrs = gen_neighbors(idx).reshape(-1).to(torch.int64)
                nbrs = nbrs[(nbrs >= 0) & (nbrs < n)]
                owner = block_owner(nbrs, n, nshards)
                local = owner == ctx.shard
                # snapshot-isolated: the local marks defer to the next pass
                loc = nbrs[local] - base
                obj.update(loc, torch.full(loc.shape, NEXT,
                                           dtype=torch.uint8,
                                           device=loc.device))
                remote = torch.stack([nbrs[~local], owner[~local].to(
                    torch.int64)], dim=1).cpu().numpy()
                if remote.shape[0]:
                    rec = np.empty((remote.shape[0], 2), np.int64)
                    rec[:, 0] = remote[:, 0]
                    rec[:, 1] = NEXT
                    writer.put(remote[:, 1], rec)

        if seed:
            # Fresh zeroed array: CUR lives only in chunks with queued
            # seed ops (the generic route: the seeds overwrite).
            obj.run_pass(PassPlan("bfs-seed", dirty_only=True)
                         .counts(CUR, count_cur).reads(expand))
        else:
            obj.run_pass(PassPlan("bfs-level").rotates(BA.ROTATE_LUT)
                         .counts(CUR, count_cur).reads(expand),
                         mark=(NEXT, UNSEEN))
        return count, int(writer.seal(epoch_out,
                                      publish_done=ctx.pipelined).sum())


def _w_ibfs_level(ctx: ShardContext, spec: dict, gen_neighbors,
                  epoch_in: int, srcs_in: tuple, epoch_out: int,
                  seed: bool, lev: int) -> tuple:
    """One whole pipelined implicit level: (seed only) absorb the
    coordinator's sealed marks, run the fused pass + seal with markers,
    then absorb peers' epoch_out marks as their markers land — they queue
    into the snapshot-isolated op log for the NEXT pass, exactly where
    the barrier path's start-of-next-level absorb puts them (local marks
    first, then remote ascending src), so the op-log order and the one
    rw-pass-per-level budget are unchanged.  Returns (count, dropped)."""
    count, dropped = _w_ibfs_pass(ctx, spec, gen_neighbors, epoch_in,
                                  srcs_in, epoch_out, seed, lev)
    _absorb(ctx, ctx.objects[spec["name"]], spec, epoch_out,
            range(ctx.nshards))
    return count, dropped


def _w_ibfs_snapshot(ctx: ShardContext, spec: dict, stage_root: str,
                     epoch_pending: int, srcs_pending: tuple) -> dict:
    """Snapshot this shard's block of the bit array at the level barrier.

    Marks bucket-shipped here at ``epoch_pending`` (the epoch the pass we
    just ran sealed, not yet absorbed) are folded into the local op log
    FIRST, so the snapshot is self-contained: bucket files are consumed,
    and the live run's next pass simply finds that epoch already drained.
    In pipelined mode the level's tail absorb already drained it —
    ``srcs_pending`` is empty and this absorbs nothing."""
    obj: DiskBitArray = ctx.objects[spec["name"]]
    _absorb(ctx, obj, spec, epoch_pending, srcs_pending)
    return ckpt.snapshot_implicit_state(
        os.path.join(stage_root, f"shard{ctx.shard:03d}"), obj)


def _w_ibfs_restore(ctx: ShardContext, spec: dict, snap_root: str) -> None:
    """Adopt this shard's block (packed chunks + queued-mark logs) from a
    sealed snapshot, replacing the freshly zeroed local array."""
    ckpt.restore_implicit_state(
        os.path.join(snap_root, f"shard{ctx.shard:03d}"),
        ctx.objects[spec["name"]])


def sharded_implicit_bfs(runtime: ShardRuntime, n_states: int, start_idx,
                         gen_neighbors, chunk_elems: int = 1 << 22,
                         max_levels: int = 10_000,
                         expand_batch: int = 1 << 16,
                         log_buf_rows: int = 1 << 20,
                         bucket_capacity: Optional[int] = None,
                         checkpoint_dir: Optional[str] = None,
                         checkpoint_every: int = 1, resume: bool = False,
                         max_recoveries: int = 0, compress: bool = False,
                         device=None, impl: str = "auto"):
    """Distributed implicit BFS: the 2-bit array is block-distributed,
    each shard runs ONE fused mark/rotate/count/expand pass per level
    over its own block (one K1 launch a chunk on ``device``, default
    ``"cuda"``; ``impl="ref"`` runs the kernels' plain versions there),
    and cross-shard marks ride the bucket exchange into the owner's
    snapshot-isolated op log.

    gen_neighbors(idx (m,) int64 on the device) -> (m, fanout) int64
    global neighbour indices; in spawn mode it must be picklable.
    Returns (level_sizes, ShardedDiskBitArray).

    ``checkpoint_dir=`` adds the coordinated checkpoint epoch
    (docs/checkpointing.md): each shard absorbs its pending bucket marks
    into the local op log and snapshots its block at the level barrier;
    the coordinator publishes atomically.  Resume re-validates nshards,
    n_states, the chunk layout, and the owner-function golden values
    before any shard adopts its block.

    ``max_recoveries=`` > 0 arms in-run self-healing exactly as in
    :func:`sharded_bfs`: roll back to the last coordinated checkpoint,
    respawn the pool, replay — or raise :class:`ShardFailure` loudly.
    """
    ck = SearchCheckpoint(checkpoint_dir) if checkpoint_dir else None
    state = ck.latest() if (ck is not None and resume) else None
    if state is not None:
        ckpt.validate_resume(state, "implicit", runtime.nshards, 1,
                             n_states, sharded=True)
        # The snapshot pins the chunk layout: adopt with ITS chunk_elems.
        chunk_elems = int(state["chunk_elems"])
    # On resume every chunk arrives from the snapshot: skip the zero-fill.
    bits = ShardedDiskBitArray(runtime, n_states, chunk_elems=chunk_elems,
                               log_buf_rows=log_buf_rows,
                               capacity=bucket_capacity,
                               init_chunks=state is None,
                               compress=compress, device=device, impl=impl)
    spec = dict(bits.spec)
    spec["expand_batch"] = expand_batch
    if state is not None:
        runtime.bcast(_w_ibfs_restore, spec, ck.snapshot_dir(state))
        level_sizes: List[int] = [int(x) for x in state["level_sizes"]]
        dropped = int(state.get("dropped", 0))
        seed = False
        # All queued marks live in the adopted op logs; a fresh epoch has
        # no sealed traffic, so the first resumed pass absorbs nothing.
        epoch_in = runtime.next_epoch()
        srcs_in: tuple = ()
    else:
        start = np.unique(_host(start_idx, np.int64))
        assert start.size and start.min() >= 0 and start.max() < n_states
        bits.update(start, np.full(start.shape, CUR, np.uint8))
        epoch = runtime.next_epoch()
        dropped = runtime.seal_driver(bits.spec, epoch)
        # The first worker pass absorbs the sealed seed buckets itself
        # (epoch_in == the seed epoch, source = the coordinator): seeds
        # queue as delayed ops, the dirty-only seed pass
        # applies/counts/expands them.
        level_sizes = []
        seed = True
        epoch_in = epoch
        srcs_in = (runtime.nshards,)
    recoveries = 0
    high = len(level_sizes) - 1   # highest level ever computed (replay tag)
    while len(level_sizes) - 1 < max_levels:
        lev_now = len(level_sizes)     # the level this pass computes
        attrs = {"level": lev_now, "engine": "implicit",
                 "nshards": runtime.nshards}
        if lev_now <= high:
            attrs["replay"] = True
        high = max(high, lev_now)
        try:
            with obs.span("bfs.level", **attrs):
                epoch_out = runtime.next_epoch()
                fn = _w_ibfs_level if runtime.pipelined else _w_ibfs_pass
                res = runtime.map(fn,
                                  [(spec, gen_neighbors, epoch_in, srcs_in,
                                    epoch_out, seed, lev_now)]
                                  * runtime.nshards)
                runtime.collect_obs()
                total = sum(c for c, _d in res)
                dropped += sum(d for _c, d in res)
                if not seed and total == 0:
                    break
                level_sizes.append(total)
                seed = False
                epoch_in = epoch_out
                # Pipelined levels tail-absorb their own epoch: the next
                # pass (and any snapshot) finds it already drained.
                srcs_in = (() if runtime.pipelined
                           else tuple(range(runtime.nshards)))
                lev = len(level_sizes) - 1
                if ck is not None and lev % checkpoint_every == 0:
                    version = ck.next_version()
                    stage = ck.begin(version)
                    runtime.bcast(_w_ibfs_snapshot, spec, stage, epoch_in,
                                  srcs_in)
                    ck.publish(version, {
                        "engine": "implicit", "sharded": True,
                        "nshards": runtime.nshards,
                        "width": 1, "n_states": int(n_states),
                        "chunk_elems": int(chunk_elems),
                        "level_sizes": list(level_sizes),
                        "dropped": int(dropped),
                        "golden": ckpt.golden_owner_values(runtime.nshards, 1,
                                                           int(n_states))})
        except (RuntimeError, OSError) as exc:
            if not _recoverable(exc):     # a kernel's failure is final
                raise
            state = _roll_back(runtime, ck, spec, exc, len(level_sizes),
                               recoveries, max_recoveries)
            # Respawned workers re-make their (empty) blocks and adopt the
            # snapshot: packed chunks + queued-mark op logs.  The adopted
            # logs carry all in-flight marks, and a fresh epoch has no
            # bucket files, so the replayed pass absorbs nothing stale.
            rspec = dict(spec)
            rspec["init_chunks"] = False
            runtime.bcast(_w_make, rspec)
            runtime.bcast(_w_ibfs_restore, spec, ck.snapshot_dir(state))
            level_sizes = [int(x) for x in state["level_sizes"]]
            dropped = int(state.get("dropped", 0))
            seed = False
            epoch_in = runtime.next_epoch()
            srcs_in = ()
            recoveries += 1
            continue
    bits.dropped = dropped
    return level_sizes, bits
