"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface, ``build/lib<name>-<hash>.so`` at the root of the checkout; the
hash covers the source, the headers under ``csrc/`` and the flags, so an
edited source builds anew and an unchanged one loads from the earlier
build.  The build happens at first use, never at import: the CPU tests
import every module, and this machine may have no nvcc.  A failed build raises with nvcc's stderr.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

#: Libraries a source links beyond the runtime: the flash-attention sources
#: (forward and backward) encode TMA tensor maps with the driver API
#: (cuTensorMapEncodeTiled); nvcc's own library path holds the toolkit's
#: libcuda stub.
LINK = {"flash_attention": ["-lcuda"], "flash_attention_bwd": ["-lcuda"]}

_LIBS: Dict[str, ctypes.CDLL] = {}
#: ptxas report (registers, shared memory, spills) of each build this process ran.
BUILD_LOGS: Dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("repro_torch: nvcc not found (PATH or "
                           "/usr/local/cuda/bin); the CUDA kernels are built "
                           "from source at first use")
    return path


def lib_path(name: str) -> Path:
    """The library's path; its hash covers the source, every header under
    ``csrc/`` (a source may include any of them) and the flags."""
    src = CSRC / f"{name}.cu"
    flags = NVCC_FLAGS + LINK.get(name, [])
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    h = hashlib.sha256(src.read_bytes() + headers + " ".join(flags).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> float:
    """Build every named source that has no current library, one nvcc each,
    all started together.  Returns the wall seconds spent."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu"),
               *LINK.get(name, [])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        stdout, stderr = proc.communicate()
        BUILD_LOGS[name] = stdout + stderr
        if proc.returncode != 0:
            failed.append(f"nvcc {name}.cu exited {proc.returncode}:\n{stderr}")
            continue
        os.replace(tmp, out)          # atomic: a concurrent build is harmless
    if failed:
        raise RuntimeError("\n".join(failed))
    return time.perf_counter() - t0


def sources() -> list:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = _LIBS[name] = ctypes.CDLL(str(lib_path(name)))
    return lib
