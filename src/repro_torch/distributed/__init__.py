"""Distribution: per-arch sharding rules and mesh placement helpers."""
from .sharding_rules import PartitionSpec, ShardingRules, named
__all__ = ["PartitionSpec", "ShardingRules", "named"]
