"""Straggler detection (``repro/runtime/watchdog.py``).

A step whose wall time exceeds ``threshold × EWMA`` of the earlier steps
is a strike; ``strikes_to_evict`` strikes without enough good steps
between them call for the elastic path (checkpoint → shrink → resume),
which waits for the distributed slice.  Pure host-side logic.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class StragglerWatchdog:
    ewma_alpha: float = 0.2
    threshold: float = 2.5          # a step is "slow" above threshold×EWMA
    strikes_to_evict: int = 3
    warmup_steps: int = 5           # first steps (builds, warm-up) excluded

    _ewma: Optional[float] = None
    _seen: int = 0
    strikes: int = 0
    events: List[str] = field(default_factory=list)

    def observe(self, step: int, seconds: float) -> str:
        """Returns one of: 'warmup' | 'ok' | 'slow' | 'evict'."""
        self._seen += 1
        if self._seen <= self.warmup_steps:
            return "warmup"
        if self._ewma is None:
            self._ewma = seconds
            return "ok"
        slow = seconds > self.threshold * self._ewma
        if not slow:                 # slow steps do not poison the EWMA
            self._ewma = (1 - self.ewma_alpha) * self._ewma \
                + self.ewma_alpha * seconds
            self.strikes = max(0, self.strikes - 1)
            return "ok"
        self.strikes += 1
        self.events.append(
            f"step {step}: {seconds:.3f}s > {self.threshold:.1f}×"
            f"{self._ewma:.3f}s (strike {self.strikes})")
        if self.strikes >= self.strikes_to_evict:
            self.strikes = 0
            return "evict"
        return "slow"

    @property
    def ewma(self) -> Optional[float]:
        return self._ewma


class StepTimer:
    """Wall seconds of a ``with`` block; the block ends in a device
    synchronisation (the loss read back to the host), so this is the
    step's own time."""

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.t0
        return False
