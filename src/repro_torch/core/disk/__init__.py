"""Tier D on the port — the paper-faithful out-of-core Roomy, the port's
own copy of ``repro/core/disk``: real chunked disk files, streaming
passes, the external merge sort, checkpoints and fault injection, with
the bytes on disk and the counters of the reference.  The host parts run
in numpy as in the reference; the 2-bit array's chunk passes and the
distance oracle's labels and lookups run on the device through the
bit-pack kernels.

  structures   ChunkStore, DiskArray, DiskBitArray, DiskHashTable,
               DiskList, SortedRunSet, PassPlan, MembershipProbe
  search       breadth_first_search, implicit_bfs, level_step
               (single-process; a sharded ``cluster=`` raises)
  config       ClusterConfig, CheckpointConfig, RecoveryConfig
  checkpoint   SearchCheckpoint, CheckpointError
  serving      publish_oracle, DistanceOracle, ShardedOracle, OracleError
  compression  codec (submodule), CodecError
  submodules   faults, extsort, buckets, passes, ...

The sharded runtime (``cluster``, ``transport``, ``trace``, and
``buckets``' senders) is the last step of ROADMAP item 8; its names are
not exported yet.
"""
from . import codec, faults
from .bfs import breadth_first_search, implicit_bfs, level_step
from .bitarray import DiskBitArray
from .checkpoint import CheckpointError, SearchCheckpoint
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

__all__ = [
    "CheckpointConfig", "CheckpointError", "ChunkStore", "ClusterConfig",
    "CodecError", "DiskArray", "DiskBitArray", "DiskHashTable", "DiskList",
    "DistanceOracle", "MembershipProbe", "OracleError", "PassPlan",
    "RecoveryConfig", "SearchCheckpoint", "ShardedOracle", "SortedRunSet",
    "breadth_first_search", "codec", "external_sort", "faults",
    "implicit_bfs", "level_step", "merge_difference", "publish_oracle",
    "row_keys", "sort_rows", "stream_dedupe",
]
