"""Atomic checkpointing with async writes (``repro/checkpoint``)."""
from .manager import AsyncCheckpointer, latest_step, restore, save

__all__ = ["AsyncCheckpointer", "latest_step", "restore", "save"]
