"""Counters and the span tracer, stdlib only — the port's own copy of the
part of ``repro/core/obs.py`` that the implicit BFS uses.

* ``counters(namespace, defaults)`` registers a live dict that callers
  bump with plain ``d[k] += n``; the kernel wrappers book their launches
  in the ``"kernels"`` namespace this way.
* ``span(sid, **attrs)`` times a phase and records the counter deltas that
  occurred inside it.  ``implicit_bfs`` opens one ``bfs.level`` span per
  level with ``tier="torch"``, so a traced level carries its kernel
  launches in ``metrics`` (``kernels.mark_rotate_count: 1``).

Zero-cost contract, as in the JAX package: ``ACTIVE`` is False by default
and ``span()`` then returns a shared no-op after one attribute test.
Counters count whether or not tracing is on.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

ACTIVE = False

_COUNTERS: Dict[str, Dict[str, int]] = {}


def counters(namespace: str, defaults: Dict[str, int]) -> Dict[str, int]:
    """Register (or re-attach to) a counter namespace; returns the LIVE dict."""
    d = _COUNTERS.setdefault(namespace, {})
    for k, v in defaults.items():
        d.setdefault(k, v)
    return d


_STACK: List["Span"] = []
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
    __slots__ = ("sid", "attrs", "ts_us", "parent", "depth", "_t0", "_base")

    def __init__(self, sid: str, attrs: dict):
        self.sid = sid
        self.attrs = attrs

    def __enter__(self) -> "Span":
        self.parent = _STACK[-1].sid if _STACK else None
        self.depth = len(_STACK)
        _STACK.append(self)
        self._base = {ns: dict(d) for ns, d in _COUNTERS.items()}
        self.ts_us = int(time.time() * 1e6)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur_us = int((time.perf_counter() - self._t0) * 1e6)
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
               "dur_us": dur_us, "parent": self.parent, "depth": self.depth}
        if self.attrs:
            rec["attrs"] = self.attrs
        if metrics:
            rec["metrics"] = metrics
        _SINK(rec)
        return False


def span(sid: str, **attrs):
    """Open a traced span (context manager); a no-op while tracing is off."""
    if not ACTIVE:
        return _NULL
    return Span(sid, attrs)


def enable(sink: Callable[[dict], None]) -> None:
    """Turn tracing on; ``sink`` receives each finished span record."""
    global ACTIVE, _SINK
    _SINK = sink
    ACTIVE = True


def disable() -> None:
    """Turn tracing off (counters stay)."""
    global ACTIVE, _SINK
    ACTIVE = False
    _SINK = None
    del _STACK[:]
