"""Per-architecture configs of the port and their registry."""
from .registry import ARCH_IDS, get_config

__all__ = ["ARCH_IDS", "get_config"]
