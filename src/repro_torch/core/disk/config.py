"""Cluster / checkpoint / recovery configuration of the Tier D engines: the
port's own copy of ``repro/core/disk/config.py``.

Three small frozen dataclasses and ``resolve_configs``, the one shared
checker behind every engine entry point::

    disk.implicit_bfs(wd, n, start, gen,
                      checkpoint=CheckpointConfig(dir=ck, every=2))

The port runs the single-process half of Tier D.  A sharded config
(``ClusterConfig(nshards > 1)``, a ``runtime=``, or a non-default wire or
exchange, which the reference treats as a one-shard cluster) raises
``NotImplementedError``: the sharded runtime (``cluster.py`` with
``transport.py``) is the last step of ROADMAP item 8.
``RecoveryConfig.max_recoveries`` is accepted and unused in one process,
as in the reference.  The reference's legacy keywords (``nshards=``,
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

SHARDED_MISSING = ("the sharded Tier D runtime (cluster.py with "
                   "transport.py, the last step of ROADMAP item 8) is not "
                   "ported yet; run with one shard")


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    """How the search is sharded and how buckets travel between shards
    (the reference's fields and validation)."""

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
        return self

    @property
    def sharded(self) -> bool:
        # An explicit non-default wire or exchange discipline opts into
        # the sharded runtime even at nshards=1 (a one-shard cluster is a
        # real cluster: same protocol, same transport).
        return (self.runtime is not None or self.nshards > 1
                or self.transport != "fs" or self.exchange is not None)

    def build_runtime(self, workdir: str):
        """The reference builds or adopts a ShardRuntime here; the port
        has none yet."""
        raise NotImplementedError(SHARDED_MISSING)


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
    """In-run self-healing budget (sharded runs only; unused in one
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
    level snapshot points) is a ``ValueError``; then a sharded config
    raises ``NotImplementedError``.  Returns the validated
    ``(ClusterConfig, CheckpointConfig, RecoveryConfig)`` triple."""
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
    if cluster.sharded:
        raise NotImplementedError(f"{entry}: {SHARDED_MISSING}")
    return cluster, checkpoint, recovery
