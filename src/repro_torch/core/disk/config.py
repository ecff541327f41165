"""Cluster / checkpoint / recovery configuration of the Tier D engines: the
port's own copy of ``repro/core/disk/config.py``.

Three small frozen dataclasses and ``resolve_configs``, the one shared
checker behind every engine entry point::

    disk.implicit_bfs(wd, n, start, gen,
                      cluster=ClusterConfig(nshards=4, transport="tcp"),
                      checkpoint=CheckpointConfig(dir=ck, every=2),
                      recovery=RecoveryConfig(max_recoveries=1))

A sharded config (``ClusterConfig(nshards > 1)``, a ``runtime=``, or a
non-default wire or exchange, which makes a one-shard cluster) builds or
adopts a :class:`~.cluster.ShardRuntime`; the validation and its errors
are the reference's.  ``RecoveryConfig.max_recoveries`` arms the sharded
engines' self-healing and is unused in one process, as in the
reference.  The reference's legacy keywords (``nshards=``,
``checkpoint_dir=``, …) and their deprecation shim are not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["ClusterConfig", "CheckpointConfig", "RecoveryConfig",
           "resolve_configs"]

#: transports and exchanges a ClusterConfig accepts (the reference's).
_KINDS = ("fs", "tcp", "loopback")
_EXCHANGES = ("barrier", "pipelined")
_MODES = ("spawn", "inline")

@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    """How the search is sharded and how buckets travel between shards
    (the reference's fields and validation).

    exchange=None resolves to "barrier", the two-phase discipline;
    exchange="pipelined" overlaps produce and apply (and runs inline
    workers in a thread each).  wire_compress=True zlib-frames each
    sealed bucket payload on the mailbox wires (tcp, loopback); the fs
    wire refuses it, since its on-disk bucket layout is a
    byte-compatibility contract."""

    nshards: int = 1
    mode: str = "spawn"
    transport: str = "fs"
    exchange: Optional[str] = None
    bucket_capacity: Optional[int] = None
    runtime: Optional[object] = None       # adopt an existing ShardRuntime
    timeout: float = 600.0
    host: str = "127.0.0.1"
    wire_compress: bool = False

    def resolved_exchange(self) -> str:
        return self.exchange if self.exchange is not None else "barrier"

    def validate(self) -> "ClusterConfig":
        if self.transport not in _KINDS:
            raise ValueError(
                f"ClusterConfig.transport={self.transport!r}: choose from "
                f"{_KINDS}")
        if self.exchange is not None and self.exchange not in _EXCHANGES:
            raise ValueError(
                f"ClusterConfig.exchange={self.exchange!r}: choose from "
                f"{_EXCHANGES} (or None to resolve per mode)")
        if self.mode not in _MODES:
            raise ValueError(
                f"ClusterConfig.mode={self.mode!r}: choose from {_MODES}")
        if self.nshards < 1:
            raise ValueError(f"ClusterConfig.nshards={self.nshards} < 1")
        if self.wire_compress and self.transport == "fs":
            raise ValueError(
                "ClusterConfig: wire_compress=True needs a mailbox wire "
                "(transport='tcp' or 'loopback') — the fs wire's on-disk "
                "bucket layout is a byte-compatibility contract")
        if self.transport == "loopback" and self.mode == "spawn":
            raise ValueError(
                "ClusterConfig: transport='loopback' is the in-process wire "
                "for mode='inline'; spawn workers live in other processes "
                "and cannot share its store — use transport='tcp' or 'fs'")
        if self.runtime is not None:
            rt_n = getattr(self.runtime, "nshards", None)
            if self.nshards not in (1, rt_n):
                raise ValueError(
                    f"ClusterConfig: runtime= has nshards={rt_n} but "
                    f"nshards={self.nshards} was also passed — drop one "
                    "(an adopted runtime brings its own shard count)")
            rt_kind = getattr(getattr(self.runtime, "transport", None),
                              "kind", "fs")
            if self.transport != "fs" and self.transport != rt_kind:
                raise ValueError(
                    f"ClusterConfig: runtime= runs transport={rt_kind!r} "
                    f"but transport={self.transport!r} was also passed — "
                    "an adopted runtime brings its own wire")
        return self

    @property
    def sharded(self) -> bool:
        # An explicit non-default wire or exchange discipline opts into
        # the sharded runtime even at nshards=1 (a one-shard cluster is a
        # real cluster: same protocol, same transport).
        return (self.runtime is not None or self.nshards > 1
                or self.transport != "fs" or self.exchange is not None)

    def build_runtime(self, workdir: str):
        """Adopt ``runtime=`` or build a fresh ShardRuntime under
        ``workdir/cluster``.  Returns ``(runtime, owns)`` — the engine
        destroys the runtime only when it owns it."""
        if self.runtime is not None:
            return self.runtime, False
        import os

        from .cluster import ShardRuntime
        rt = ShardRuntime(os.path.join(workdir, "cluster"), self.nshards,
                          mode=self.mode, timeout=self.timeout,
                          transport=self.transport,
                          exchange=self.resolved_exchange(),
                          host=self.host,
                          wire_compress=self.wire_compress)
        return rt, True


@dataclasses.dataclass(frozen=True)
class CheckpointConfig:
    """Where and how often level snapshots publish."""

    dir: Optional[str] = None
    every: int = 1
    resume: bool = False

    def validate(self) -> "CheckpointConfig":
        if self.every < 1:
            raise ValueError(f"CheckpointConfig.every={self.every} < 1")
        if self.dir is None and self.resume:
            raise ValueError(
                "CheckpointConfig: resume=True needs dir= (nowhere to "
                "resume from)")
        return self

    @property
    def enabled(self) -> bool:
        return self.dir is not None


@dataclasses.dataclass(frozen=True)
class RecoveryConfig:
    """In-run self-healing budget of the sharded engines (unused in one
    process)."""

    max_recoveries: int = 0

    def validate(self) -> "RecoveryConfig":
        if self.max_recoveries < 0:
            raise ValueError(
                f"RecoveryConfig.max_recoveries={self.max_recoveries} < 0")
        return self


def resolve_configs(entry: str, *,
                    cluster: Optional[ClusterConfig] = None,
                    checkpoint: Optional[CheckpointConfig] = None,
                    recovery: Optional[RecoveryConfig] = None,
                    fused: bool = True):
    """Validate each config and reject the cross-cutting conflicts, in the
    reference's order: ``fused=False`` with any sharding or with a
    checkpoint (the unfused reference paths are single-process and have no
    level snapshot points) is a ``ValueError``.  ``max_recoveries > 0``
    without a checkpoint dir is deliberately not an error: rolling back
    with nothing to adopt is the sharded engines' loud ``ShardFailure``.
    Returns the validated ``(ClusterConfig, CheckpointConfig,
    RecoveryConfig)`` triple."""
    cluster = (cluster or ClusterConfig()).validate()
    checkpoint = (checkpoint or CheckpointConfig()).validate()
    recovery = (recovery or RecoveryConfig()).validate()
    if not fused:
        if cluster.sharded:
            raise ValueError(
                f"{entry}: fused=False is the single-process reference "
                "path — it cannot run sharded (drop cluster config or "
                "set fused=True)")
        if checkpoint.enabled:
            raise ValueError(
                f"{entry}: checkpointing requires the fused pass "
                "(fused=False has no level snapshot points)")
    return cluster, checkpoint, recovery
