"""Architecture registry — maps ``--arch`` ids to (FULL, SMOKE) configs.

The reference knows ten architectures (``repro/configs/registry.py``).
The port knows those whose path it carries; for the others
``get_config`` raises and names the ROADMAP item that ports them.
"""
from __future__ import annotations

from ..models.config import ModelConfig
from . import (falcon_mamba_7b, gemma2_2b, granite_34b, granite_moe_3b,
               minicpm_2b, nemotron4_15b, phi35_moe_42b, zamba2_1p2b)

_MODULES = {"gemma2-2b": gemma2_2b, "falcon-mamba-7b": falcon_mamba_7b,
            "nemotron-4-15b": nemotron4_15b, "minicpm-2b": minicpm_2b,
            "granite-34b": granite_34b,
            "granite-moe-3b-a800m": granite_moe_3b,
            "phi3.5-moe-42b-a6.6b": phi35_moe_42b,
            "zamba2-1.2b": zamba2_1p2b}

#: Architectures of the reference not ported yet → the ROADMAP item that
#: ports each one.
NOT_PORTED = {
    "musicgen-medium": "9.6 (frontend-stub audio)",
    "qwen2-vl-2b": "9.6 (frontend-stub vision, M-RoPE)",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch in NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not ported to repro_torch yet: ROADMAP item "
            f"{NOT_PORTED[arch]}")
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = _MODULES[arch]
    return mod.SMOKE if smoke else mod.FULL
