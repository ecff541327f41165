"""Tier D on the port — the paper-faithful out-of-core Roomy, the port's
own copy of ``repro/core/disk``: real chunked disk files, streaming
passes, the external merge sort, checkpoints, fault injection and the
sharded runtime, with the bytes on disk and the counters of the
reference.  The host parts run in numpy as in the reference; the 2-bit
array's chunk passes and the distance oracle's labels and lookups run on
the device through the bit-pack kernels.

  structures   ChunkStore, DiskArray, DiskBitArray, DiskHashTable,
               DiskList, SortedRunSet, PassPlan, MembershipProbe
  search       breadth_first_search, implicit_bfs, level_step
               (single-process or sharded via ``cluster=``)
  config       ClusterConfig, CheckpointConfig, RecoveryConfig
  cluster      ShardRuntime, sharded_bfs, sharded_implicit_bfs, the
               Sharded* structures, ShardFailure, WorkerLost
  transport    Transport, make_transport, TRANSPORT_KINDS
               (the bucket wire: "fs", "tcp", "loopback")
  checkpoint   SearchCheckpoint, CheckpointError
  serving      publish_oracle, DistanceOracle, ShardedOracle, OracleError
  compression  codec (submodule), CodecError
  submodules   faults, trace (run traces), extsort, buckets, passes, ...
"""
# trace is not imported here: pre-importing it makes
# ``python -m repro_torch.core.disk.trace`` warn about the double import.
from . import codec, faults
from .bfs import breadth_first_search, implicit_bfs, level_step
from .bitarray import DiskBitArray
from .checkpoint import CheckpointError, SearchCheckpoint
from .cluster import (ShardedDiskBitArray, ShardedDiskHashTable,
                      ShardedDiskList, ShardFailure, ShardRuntime,
                      WorkerLost, sharded_bfs, sharded_implicit_bfs)
from .codec import CodecError
from .config import CheckpointConfig, ClusterConfig, RecoveryConfig
from .darray import DiskArray
from .dhash import DiskHashTable
from .dlist import DiskList
from .extsort import (MembershipProbe, external_sort, merge_difference,
                      row_keys, sort_rows, stream_dedupe)
from .lsm import SortedRunSet
from .oracle import (DistanceOracle, OracleError, ShardedOracle,
                     publish_oracle)
from .passes import PassPlan
from .store import ChunkStore
from .transport import TRANSPORT_KINDS, Transport, make_transport

__all__ = [
    "CheckpointConfig", "CheckpointError", "ChunkStore", "ClusterConfig",
    "CodecError", "DiskArray", "DiskBitArray", "DiskHashTable", "DiskList",
    "DistanceOracle", "MembershipProbe", "OracleError", "PassPlan",
    "RecoveryConfig", "SearchCheckpoint", "ShardFailure", "ShardRuntime",
    "ShardedDiskBitArray", "ShardedDiskHashTable", "ShardedDiskList",
    "ShardedOracle", "SortedRunSet", "TRANSPORT_KINDS", "Transport",
    "WorkerLost", "breadth_first_search", "codec", "external_sort", "faults",
    "implicit_bfs", "level_step", "make_transport", "merge_difference",
    "publish_oracle", "row_keys", "sharded_bfs", "sharded_implicit_bfs",
    "sort_rows", "stream_dedupe",
]
