"""Deterministic fault injection + transient-I/O retry (Tier D stack):
the port's own copy of ``repro/core/disk/faults.py``, the same rules,
spec grammar, marker files and firing sequence.

Invariant: with no plan installed the fault hooks are a single module
attribute test (``faults.ACTIVE``) — no allocation, no call — so the
pass/byte budgets and the bench baseline are untouched by this layer
(the CI bench gate pins that); with a plan installed, every injection is
a deterministic function of the ``ROOMY_FAULTS`` spec, the seed, and the
per-site hit sequence, so a failing chaos run replays exactly.

Roomy's target computations run for days to months on clusters where
disk and worker failures are expected, not exceptional (paper §2–3).
This module gives the runtime two things:

  1. **Named fault sites.**  The I/O hot spots (bucket spill/seal, chunk
     flush, op-log append, checkpoint publish, worker per-level entry,
     worker command barrier) call :func:`fire` with their site name and
     context.  An installed :class:`FaultPlan` decides — deterministically
     — whether that hit raises a transient ``OSError``, a fatal
     ``OSError``, kills the process (``os._exit`` in spawn workers, a
     :class:`WorkerKilled` raise in-process), sleeps past a collective
     timeout, or tears the write in progress.

  2. **Transient-I/O retry.**  :func:`retry_io` wraps an idempotent I/O
     operation: transient errnos (EIO, EAGAIN, EBUSY, EINTR, ETIMEDOUT,
     ESTALE — the shared-filesystem flake set) retry with bounded
     exponential backoff, fatal errnos re-raise immediately, and both
     outcomes are booked in :data:`STATS` (``io_retries`` /
     ``io_giveups``, the ``extsort`` namespace, as in the reference).
     :func:`append_bytes` makes file *appends* retry-safe: the
     pre-append size is recorded and every attempt truncates back to it
     first, so a torn write from a failed attempt can never leave
     duplicate or partial records.

``ROOMY_FAULTS`` spec grammar (rules separated by ``;``)::

    seed=42;bucket_seal:transient:every=2:times=2;worker_level:kill:shard=1:level=2

Each rule is ``site:kind[:key=val]*`` with

  kind   transient | fatal | kill | delay | torn
  shard  only fire in the worker with this shard id
  level  only fire when the site reports this BFS level
  at     fire on the Nth matching hit of the site (1-based)
  every  fire on every Nth matching hit
  p      fire with this probability (seeded, per-rule RNG)
  times  consecutive hits that fail once triggered (transient bursts)
  once   fire at most once per (site, rule, level) — persisted via
         marker files in the bound state dir so a respawned worker does
         not re-fire on replay; defaults ON for kill/fatal/delay
  secs   sleep length for ``delay`` rules

A process installs the plan from the environment
(:func:`install_from_env`), bound to a marker dir; with
``allow_exit=True`` ``kill`` is a real ``os._exit``, with
``allow_exit=False`` a :class:`WorkerKilled` raise a recovery path
catches.
"""
from __future__ import annotations

import errno
import os
import time
from typing import Dict, List, Optional

import numpy as np

from .. import obs

__all__ = [
    "ACTIVE", "FaultPlan", "FaultRule", "WorkerKilled", "append_bytes",
    "default_chaos_spec", "fire", "install", "install_from_env", "parse",
    "retry_io", "STATS", "uninstall",
]

ENV_VAR = "ROOMY_FAULTS"

# Errnos worth retrying: the transient flake set of a shared filesystem.
# Everything else (ENOSPC, EROFS, EACCES, ...) is fatal — retrying cannot
# help and would only hide a real operational problem.
TRANSIENT_ERRNOS = frozenset({
    errno.EIO, errno.EAGAIN, errno.EBUSY, errno.EINTR, errno.ETIMEDOUT,
    errno.ESTALE,
})

KINDS = ("transient", "fatal", "kill", "delay", "torn")

# Module-level switch the hot sites test BEFORE calling anything: with no
# plan installed a fault hook costs one attribute read and a branch.
ACTIVE = False
_PLAN: Optional["FaultPlan"] = None


class WorkerKilled(RuntimeError):
    """In-process stand-in for hard worker death (inline mode / tests):
    ``kill`` rules raise this instead of ``os._exit`` when the plan was
    installed with ``allow_exit=False``."""


# The reference books retries into ``extsort.STATS``, the ``extsort``
# counter namespace; the port registers the two counters there itself
# (``obs.counters`` re-attaches, so a ported extsort shares them).
STATS = obs.counters("extsort", {"io_retries": 0, "io_giveups": 0})


# ---------------------------------------------------------------- the plan

class FaultRule:
    """One ``site:kind:...`` rule of a :class:`FaultPlan` (see module
    docstring for the selector/trigger semantics)."""

    def __init__(self, site: str, kind: str, *, shard: Optional[int] = None,
                 level: Optional[int] = None, at: Optional[int] = None,
                 every: Optional[int] = None, p: Optional[float] = None,
                 times: int = 1, once: Optional[bool] = None,
                 secs: float = 30.0):
        assert kind in KINDS, f"unknown fault kind {kind!r}"
        self.site = site
        self.kind = kind
        self.shard = shard
        self.level = level
        self.at = at
        self.every = every
        self.p = p
        self.times = max(1, int(times))
        # kill/fatal/delay default to once-per-(site,level): without the
        # marker a recovered run would re-fire on replay and never converge.
        self.once = (kind in ("kill", "fatal", "delay")
                     if once is None else bool(once))
        self.secs = float(secs)
        # Bound at plan bind time.
        self.idx = 0
        self._rng: Optional[np.random.Generator] = None
        self._hits = 0
        self._burst = 0
        self._fired_keys: set = set()   # in-process `once` fallback

    def _matches_ctx(self, ctx: dict) -> bool:
        if self.shard is not None and ctx.get("shard") != self.shard:
            return False
        if self.level is not None and ctx.get("level") != self.level:
            return False
        return True

    def _triggered(self) -> bool:
        if self.at is not None:
            return self._hits == self.at
        if self.every is not None:
            return self._hits % self.every == 0
        if self.p is not None:
            return bool(self._rng.random() < self.p)
        return True

    def _marker_key(self, ctx: dict) -> str:
        key = f"{self.site}.{self.idx}"
        if "level" in ctx:
            key += f".l{int(ctx['level'])}"
        return key


class FaultPlan:
    """A seeded, deterministic set of :class:`FaultRule`\\ s.

    ``fire(site, **ctx)`` is the single entry point: it walks the rules
    registered for the site, and the first one that matches acts —
    raising, killing, sleeping, or returning an action dict
    (``{"torn": True}``) the call site interprets.  Hit counters are
    per-process; ``once`` rules persist marker files under ``state_dir``
    so they stay fired across worker respawns and coordinator restarts.
    """

    def __init__(self, rules: List[FaultRule], seed: int = 0):
        self.rules = list(rules)
        self.seed = int(seed)
        self.state_dir: Optional[str] = None
        self.allow_exit = False
        self._by_site: Dict[str, List[FaultRule]] = {}
        for i, r in enumerate(self.rules):
            r.idx = i
            self._by_site.setdefault(r.site, []).append(r)

    def bind(self, state_dir: Optional[str] = None,
             shard: Optional[int] = None, allow_exit: bool = False
             ) -> "FaultPlan":
        """Attach per-process identity: the cross-process marker dir, the
        shard id salt for the per-rule RNGs, and whether ``kill`` may
        really ``os._exit``."""
        self.state_dir = state_dir
        self.allow_exit = bool(allow_exit)
        if state_dir:
            os.makedirs(state_dir, exist_ok=True)
        salt = 0 if shard is None else (int(shard) + 1)
        for r in self.rules:
            r._rng = np.random.default_rng(
                (self.seed * 1_000_003 + r.idx * 9_176 + salt) & 0xFFFFFFFF)
        return self

    # ------------------------------------------------------------- firing
    def _fired_before(self, rule: FaultRule, key: str) -> bool:
        if self.state_dir:
            return os.path.exists(os.path.join(self.state_dir, key))
        return key in rule._fired_keys

    def _mark_fired(self, rule: FaultRule, key: str) -> None:
        if self.state_dir:
            with open(os.path.join(self.state_dir, key), "w"):
                pass
        rule._fired_keys.add(key)

    def _act(self, rule: FaultRule, site: str, ctx: dict) -> Optional[dict]:
        where = f"injected at {site}" + (
            f" (shard={ctx['shard']})" if "shard" in ctx else "")
        if rule.kind == "transient":
            raise OSError(errno.EIO, f"transient fault {where}")
        if rule.kind == "fatal":
            raise OSError(errno.ENOSPC, f"fatal fault {where}")
        if rule.kind == "kill":
            if self.allow_exit:
                # Marker already written by fire(); die without cleanup —
                # the hard-death shape recovery must survive.
                os._exit(17)
            raise WorkerKilled(f"worker killed {where}")
        if rule.kind == "delay":
            time.sleep(rule.secs)
            return None
        return {"torn": True}          # interpreted by append_bytes

    def fire(self, site: str, **ctx) -> Optional[dict]:
        """One hit at ``site``.  May raise (transient/fatal/kill), sleep
        (delay), or return an action dict (torn); returns None when no
        rule acts."""
        for rule in self._by_site.get(site, ()):
            if not rule._matches_ctx(ctx):
                continue
            if rule._burst > 0:        # mid-burst: keep failing
                rule._burst -= 1
                return self._act(rule, site, ctx)
            rule._hits += 1
            if not rule._triggered():
                continue
            if rule.once:
                key = rule._marker_key(ctx)
                if self._fired_before(rule, key):
                    continue
                self._mark_fired(rule, key)
            rule._burst = rule.times - 1
            return self._act(rule, site, ctx)
        return None


# --------------------------------------------------------------- (un)install

def parse(spec: str) -> FaultPlan:
    """Parse a ``ROOMY_FAULTS`` spec string (grammar in module docstring)."""
    seed = 0
    rules: List[FaultRule] = []
    for token in spec.split(";"):
        token = token.strip()
        if not token:
            continue
        if token.startswith("seed="):
            seed = int(token[len("seed="):])
            continue
        parts = token.split(":")
        if len(parts) < 2:
            raise ValueError(f"fault rule {token!r} needs site:kind")
        site, kind, kv = parts[0], parts[1], parts[2:]
        kwargs: dict = {}
        for item in kv:
            k, _, v = item.partition("=")
            if k in ("shard", "level", "at", "every", "times"):
                kwargs[k] = int(v)
            elif k in ("p", "secs"):
                kwargs[k] = float(v)
            elif k == "once":
                kwargs[k] = v not in ("0", "false", "no")
            else:
                raise ValueError(f"unknown fault rule key {k!r} in {token!r}")
        rules.append(FaultRule(site, kind, **kwargs))
    return FaultPlan(rules, seed=seed)


def default_chaos_spec(seed: int, shards: int = 1) -> str:
    """The examples' ``--chaos SEED`` storm (also the CI chaos job):
    torn appends plus transient flakes on every retry-wrapped site, and —
    when sharded — one real worker kill mid-search, so the run exercises
    both the retry layer and the checkpoint-rollback recovery path."""
    spec = (f"seed={int(seed)};"
            "bucket_spill:torn:every=7:once=0;"
            "oplog_append:torn:every=9:once=0;"
            "bucket_seal:transient:every=5:times=2:once=0;"
            "chunk_flush:transient:every=6:once=0;"
            "meta_write:transient:every=4:once=0;"
            "ckpt_publish:transient:every=3:once=0")
    if shards > 1:
        spec += ";worker_level:kill:shard=1:level=2"
    return spec


def install(plan: Optional[FaultPlan]) -> None:
    global _PLAN, ACTIVE
    _PLAN = plan
    ACTIVE = plan is not None


def uninstall() -> None:
    install(None)


def install_from_env(state_dir: Optional[str] = None,
                     shard: Optional[int] = None,
                     allow_exit: bool = False) -> bool:
    """Install the plan named by ``$ROOMY_FAULTS`` (binding it to this
    process's identity); a missing/empty variable leaves the current
    installation untouched.  Returns True if a plan was installed."""
    spec = os.environ.get(ENV_VAR, "").strip()
    if not spec:
        return False
    install(parse(spec).bind(state_dir=state_dir, shard=shard,
                             allow_exit=allow_exit))
    return True


def fire(site: str, **ctx) -> Optional[dict]:
    """Module-level dispatch to the installed plan (no-op when none)."""
    plan = _PLAN
    if plan is None:
        return None
    return plan.fire(site, **ctx)


# ------------------------------------------------------------ retry wrappers

def retry_io(site: str, fn, attempts: int = 6, base_delay: float = 0.002,
             max_delay: float = 0.1, fire_site: bool = True, **ctx):
    """Run an *idempotent* I/O operation with transient-errno retry.

    Transient OSErrors (:data:`TRANSIENT_ERRNOS`) — whether injected at
    ``site`` or raised by the real filesystem — retry up to ``attempts``
    total tries with bounded exponential backoff, booking each retry in
    ``STATS['io_retries']``.  A fatal errno, or exhaustion of the
    attempt budget, books ``io_giveups`` and re-raises: the caller (BFS
    recovery, or the user) decides what dies.  ``fn`` must be safe to
    re-execute — whole-file rewrites and atomic renames are; bare appends
    are not (use :func:`append_bytes`)."""
    attempt = 0
    while True:
        try:
            if fire_site and ACTIVE:
                act = _PLAN.fire(site, **ctx)
                if act:                # torn rule on a non-append site:
                    raise OSError(     # degrade to a transient failure
                        errno.EIO, f"torn fault at {site} (as transient)")
            return fn()
        except OSError as exc:
            attempt += 1
            if exc.errno not in TRANSIENT_ERRNOS or attempt >= attempts:
                obs.add(STATS, "io_giveups", 1)
                raise
            obs.add(STATS, "io_retries", 1)
            time.sleep(min(base_delay * (2 ** (attempt - 1)), max_delay))


def append_bytes(site: str, path: str, data: bytes, **ctx) -> None:
    """Retry-safe append: record the pre-append size, and have EVERY
    attempt truncate back to it before writing — so a torn write from a
    failed attempt (transient error, injected tear) can never leave
    partial or duplicated records behind.  This is what makes the op-log
    and bucket-spill appends idempotent under :func:`retry_io`."""
    try:
        pos = os.path.getsize(path)
    except OSError:
        pos = 0

    def _do() -> None:
        with open(path, "r+b" if os.path.exists(path) else "wb") as f:
            f.truncate(pos)
            f.seek(pos)
            act = _PLAN.fire(site, **ctx) if ACTIVE else None
            if act and act.get("torn"):
                f.write(data[:max(1, len(data) // 2)])
                f.flush()
                raise OSError(errno.EIO, f"torn write injected at {site}")
            f.write(data)

    retry_io(site, _do, fire_site=False, **ctx)
