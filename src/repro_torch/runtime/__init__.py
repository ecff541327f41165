"""Serving runtime of the port."""
from .serve_loop import Request, Server

__all__ = ["Request", "Server"]
