"""Device resolution for every entry point of the port.

The default device is ``"cuda"``.  A missing card is an error, never a
silent move to the CPU: the CPU runs only when the caller names it.
"""
from __future__ import annotations

import torch

DEFAULT = "cuda"


def resolve(device=None) -> torch.device:
    """``None`` → ``"cuda"``; raise if a CUDA device is asked for and absent."""
    dev = torch.device(DEFAULT if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: a CUDA device was requested (the default) but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch versions on the CPU")
    return dev
