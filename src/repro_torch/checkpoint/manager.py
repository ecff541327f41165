"""Atomic, async checkpointing (``repro/checkpoint/manager.py``).

Layout, as in the reference: one ``.npy`` per leaf of the tree (its path
joined by ``__`` as the file name) and a ``manifest.json``, written to
``step_XXXXXXXX.tmp`` and then renamed at once, so a crashed writer never
leaves a broken latest checkpoint; the three newest are kept.  The
``AsyncCheckpointer`` fetches the leaves to the host first (the only part
that blocks the train loop) and writes them from a background thread.

Leaves are tensors (saved as numpy arrays; bfloat16 as float32, since
numpy has no bfloat16, and cast back on restore) and Python numbers (the
optimizer's step), saved as 0-d arrays.  ``restore`` rebuilds the
template's structure, each tensor on its template leaf's device and in
its dtype.

On a mesh (``shardings=``: a tree of ``distributed.sharding_rules
.Placement`` mirroring the tree, None where a leaf is whole) leaves are
this rank's shards.  ``save`` gathers each to its logical array and world
rank 0 writes the files, so the format is unchanged and a mesh save is
byte for byte the save of the same whole tree; every rank returns once
the files are there.  ``restore`` reads each logical array and keeps this
rank's block: the reference's elastic restore (``repro/checkpoint/
manager.py:9-14,76-91``), so a run comes back on another mesh, or on none.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import tree as T

_SEP = "__"


def _to_host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(leaf)


def _write(ckpt_dir: str, step: int, host: dict) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": {}}
    for name, arr in host.items():
        np.save(os.path.join(tmp, name + ".npy"), arr)
        manifest["leaves"][name] = {"shape": list(arr.shape),
                                    "dtype": str(arr.dtype)}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.isdir(final):
        shutil.rmtree(final)
    os.replace(tmp, final)                      # atomic
    _gc(ckpt_dir, keep=3)
    return final


def _placed(tree, shardings) -> list:
    """(path, leaf, its placement or None) in leaf order."""
    places = (T.leaves(shardings) if shardings is not None
              else [None] * len(T.leaves(tree)))
    return [(path, leaf, place) for (path, leaf), place in
            zip(T.flatten_with_path(tree), places)]


def _fetch(tree: Any, shardings=None) -> dict:
    """Every leaf on the host, whole (a placed leaf gathered first)."""
    return {_SEP.join(path): _to_host(leaf if place is None
                                      else place.gather(leaf))
            for path, leaf, place in _placed(tree, shardings)}


def _mesh_of(shardings):
    """The mesh of a tree of placements, or None."""
    if shardings is None:
        return None
    for place in T.leaves(shardings):
        if place is not None:
            return place.mesh
    return None


def _writes(shardings) -> bool:
    """Off a mesh the caller writes; on one, world rank 0 alone."""
    return _mesh_of(shardings) is None or dist.get_rank() == 0


def barrier(shardings) -> None:
    """Every rank of the placements' mesh waits for the others (none off
    a mesh)."""
    if _mesh_of(shardings) is not None:
        dist.barrier()


def save(ckpt_dir: str, step: int, tree: Any, shardings=None) -> str:
    """Blocking save; returns the checkpoint's directory."""
    host = _fetch(tree, shardings)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if _writes(shardings):
        final = _write(ckpt_dir, step, host)
    barrier(shardings)
    return final


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, template: Any,
            shardings=None) -> Any:
    """The checkpoint of ``step`` in ``template``'s structure: tensors on
    their template leaf's device, in its dtype; numbers as numbers.  With
    ``shardings`` each placed leaf is this rank's block of the logical
    array (elastic: the files hold logical arrays, so any mesh works)."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    out = []
    for kp, leaf, place in _placed(template, shardings):
        arr = np.load(os.path.join(path, _SEP.join(kp) + ".npy"))
        if isinstance(leaf, torch.Tensor):
            t = torch.from_numpy(arr)
            if place is not None:
                t = place(t)
            out.append(t.to(device=leaf.device, dtype=leaf.dtype,
                            copy=True))
        else:
            out.append(type(leaf)(arr.item()))
    return T.unflatten(template, out)


class AsyncCheckpointer:
    """Fetch to the host synchronously, write in a background thread."""

    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = ckpt_dir
        self._q: queue.Queue = queue.Queue(maxsize=1)
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            step, host = item
            try:
                _write(self.ckpt_dir, step, host)
            except BaseException as e:          # surfaced on the next call
                self._err = e
            finally:
                self._q.task_done()

    def save(self, step: int, tree: Any, shardings=None) -> None:
        """Fetch now (a mesh's leaves gathered, collective), write later:
        world rank 0 alone on a mesh."""
        if self._err is not None:
            raise self._err
        host = _fetch(tree, shardings)
        if _writes(shardings):
            self._q.put((step, host))           # blocks if one is in flight

    def wait(self) -> None:
        self._q.join()
        if self._err is not None:
            raise self._err

    def close(self) -> None:
        self._q.join()
        self._q.put(None)
        self._thread.join(timeout=60)
