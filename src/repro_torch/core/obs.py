"""Process-local metrics registry and structured span tracer, stdlib
only: the port's own copy of ``repro/core/obs.py``.

* ``counters(namespace, defaults)`` registers a live dict that callers
  bump with ``add(d, k, n)``, exact across threads (the kernel wrappers
  book their launches in the ``"kernels"`` namespace this way); the
  registry holds counters only (the reference's gauges, histograms and
  scopes have no reader in the port).  ``snapshot`` / ``merge`` /
  ``counter_deltas`` copy, fold and difference the whole registry, which
  is how spawn-mode shard workers ship their counters to the coordinator.
* ``span(sid, **attrs)`` times a phase and records the counter deltas
  that occurred inside it.  ``implicit_bfs`` opens one ``bfs.level`` span
  per level (``tier="torch"`` on the in-memory engine), so a traced level
  carries its kernel launches in ``metrics``
  (``kernels.mark_rotate_count: 1``).  Finished spans go to a sink
  (``core/disk/trace.py``'s JSONL writer) or, in shard workers, to a
  buffer drained over the result queue at each level barrier
  (``drain_spans`` / ``ingest``); ``$ROOMY_TRACE`` (:data:`ENV_VAR`)
  turns that buffered tracing on in a freshly spawned worker.

Zero-cost contract, as in the JAX package: ``ACTIVE`` is False by default
and ``span()`` then returns a shared no-op after one attribute test.
Counters count whether or not tracing is on.  Spawn-mode shard workers
import this module, so it stays stdlib only.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

ACTIVE = False

#: Presence of this env var in a freshly spawned (or recovery-respawned)
#: shard worker turns on buffered tracing there — disk/trace.py sets it.
ENV_VAR = "ROOMY_TRACE"

# ----------------------------------------------------------------- registry

_COUNTERS: Dict[str, Dict[str, int]] = {}


def counters(namespace: str, defaults: Dict[str, int]) -> Dict[str, int]:
    """Register (or re-attach to) a counter namespace.

    Returns the LIVE dict: callers bump it (``add(d, k, n)``) and the
    registry holds the same object, so snapshots and spans see every
    update.  This is how the modules' ``STATS`` dicts join the registry.
    """
    d = _COUNTERS.setdefault(namespace, {})
    for k, v in defaults.items():
        d.setdefault(k, v)
    return d


_ADD_LOCK = threading.Lock()


def add(d: Dict[str, int], key: str, n) -> None:
    """``d[key] += n`` under one lock.  The inline runtime's pipelined
    exchange runs a thread a shard, and a plain ``+=`` can lose an update
    when another thread's lands between its read and its write; every
    shared counter of the shard paths is bumped through here."""
    with _ADD_LOCK:
        d[key] = d.get(key, 0) + n


def snapshot() -> dict:
    """Picklable point-in-time copy of the counters — what spawn workers
    ship to the coordinator at each level barrier."""
    return {"counters": {ns: dict(d) for ns, d in _COUNTERS.items()}}


def merge(a: dict, b: dict) -> dict:
    """Combine two snapshots: counters add.  Associative with the empty
    snapshot as identity — the property the coordinator relies on when
    folding per-shard snapshots in whatever order the result queue
    delivers them."""
    out: Dict[str, Dict[str, int]] = {}
    for src in (a, b):
        for ns, d in src.get("counters", {}).items():
            od = out.setdefault(ns, {})
            for k, v in d.items():
                od[k] = od.get(k, 0) + v
    return {"counters": out}


def counter_deltas(after: dict, before: dict) -> Dict[str, int]:
    """Flat non-zero counter deltas between two snapshots, keyed
    ``namespace.counter`` — the span metric format."""
    out: Dict[str, int] = {}
    for ns, d in after.get("counters", {}).items():
        base = before.get("counters", {}).get(ns, {})
        for k, v in d.items():
            dv = v - base.get(k, 0)
            if dv:
                out[ns + "." + k] = dv
    return out


# -------------------------------------------------------------------- spans

_SHARD: Optional[int] = None          # default shard tag for new spans
_STACK: List["Span"] = []             # open spans (runtime is 1 thread/proc)
_SPANS: List[dict] = []               # finished spans awaiting drain/sink
_SINK: Optional[Callable[[dict], None]] = None


class _NullSpan:
    """Shared no-op for the ACTIVE=False fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class Span:
    __slots__ = ("sid", "attrs", "shard", "ts_us", "parent", "depth",
                 "_t0", "_base")

    def __init__(self, sid: str, attrs: dict):
        self.sid = sid
        self.shard = attrs.pop("shard", _SHARD)
        self.attrs = attrs

    def __enter__(self) -> "Span":
        self.parent = _STACK[-1].sid if _STACK else None
        self.depth = len(_STACK)
        _STACK.append(self)
        self._base = {ns: dict(d) for ns, d in _COUNTERS.items()}
        self.ts_us = int(time.time() * 1e6)   # epoch µs: cross-process order
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur_us = int((time.perf_counter() - self._t0) * 1e6)
        # Generator-held spans (merge streams, bucket application) can
        # close out of LIFO order — remove by identity, top down.
        for i in range(len(_STACK) - 1, -1, -1):
            if _STACK[i] is self:
                del _STACK[i]
                break
        metrics: Dict[str, int] = {}
        for ns, d in _COUNTERS.items():
            base = self._base.get(ns, {})
            for k, v in d.items():
                dv = v - base.get(k, 0)
                if dv:
                    metrics[ns + "." + k] = dv
        rec = {"type": "span", "sid": self.sid, "ts_us": self.ts_us,
               "dur_us": dur_us, "shard": self.shard,
               "parent": self.parent, "depth": self.depth}
        if self.attrs:
            rec["attrs"] = self.attrs
        if metrics:
            rec["metrics"] = metrics
        _emit(rec)
        return False


def span(sid: str, **attrs):
    """Open a traced span (context manager).  The hook cost when tracing
    is off is this single attribute test.  ``shard=`` is split out as
    the span's shard tag (inline-mode worker fns pass it explicitly;
    spawn workers inherit it from ``enable(shard=...)``)."""
    if not ACTIVE:
        return _NULL
    return Span(sid, attrs)


def _emit(rec: dict) -> None:
    if _SINK is not None:
        _SINK(rec)
    else:
        _SPANS.append(rec)


def drain_spans() -> List[dict]:
    """Pop and return buffered finished spans (plain picklable dicts) —
    what a spawn worker returns over the result queue at a barrier."""
    out = _SPANS[:]
    del _SPANS[:]
    return out


def ingest(spans: List[dict], shard: Optional[int] = None) -> None:
    """Coordinator side: file spans collected from a worker, tagging
    untagged ones with that worker's shard id."""
    for rec in spans:
        if shard is not None and rec.get("shard") is None:
            rec["shard"] = shard
        _emit(rec)


def enable(shard: Optional[int] = None,
           sink: Optional[Callable[[dict], None]] = None) -> None:
    """Turn tracing on.  ``sink`` (the coordinator's JSONL writer)
    receives finished spans immediately; without one (shard workers)
    spans buffer for ``drain_spans()``."""
    global ACTIVE, _SHARD, _SINK
    _SHARD = shard
    _SINK = sink
    ACTIVE = True


def disable() -> None:
    """Turn tracing off and drop all tracing state.  Counters are NOT
    touched — they belong to their owning modules (``reset_stats()``)."""
    global ACTIVE, _SHARD, _SINK
    ACTIVE = False
    _SHARD = None
    _SINK = None
    del _STACK[:]
    del _SPANS[:]
