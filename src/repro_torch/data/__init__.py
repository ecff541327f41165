"""Data pipeline of the port (``repro/data``)."""
from .pipeline import DiskTokenStream, SyntheticStream, make_batch, synth_tokens

__all__ = ["DiskTokenStream", "SyntheticStream", "make_batch", "synth_tokens"]
