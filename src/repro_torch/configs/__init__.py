"""Per-architecture configs of the port, their registry and the assigned
input shapes."""
from .registry import ARCH_IDS, get_config
from .shapes import SHAPES, ShapeSpec, shape_applicable

__all__ = ["ARCH_IDS", "SHAPES", "ShapeSpec", "get_config",
           "shape_applicable"]
