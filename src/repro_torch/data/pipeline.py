"""Data pipeline: the deterministic synthetic LM stream
(``repro/data/pipeline.py``).

Determinism contract (fault tolerance rests on it): a batch is a pure
function of (seed, step), drawn from numpy's generator keyed exactly as
the reference keys it, so the two packages give bit-identical batches and
a restore replays the stream from the restored step with no iterator
state to persist.  Batches are numpy arrays; ``batch_to_torch`` moves one
to a device.

``DiskTokenStream`` stores its corpus in the Tier-D ``ChunkStore``
(``repro/core/disk/store.py``), which the port does not have yet: it
raises ``NotImplementedError`` naming ROADMAP item 8.  The frontend-stub
(audio/vlm) embeddings and M-RoPE positions come with the slices that port
those families (item 9.6).
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch


def synth_tokens(seed: int, step: int, batch: int, seq: int,
                 vocab: int) -> np.ndarray:
    """(batch, seq) int32 tokens keyed by (seed, step): a Markov-ish walk,
    so the loss is learnable (the next token correlates with the current)."""
    rng = np.random.default_rng(np.uint64(seed) * np.uint64(1_000_003)
                                + np.uint64(step))
    base = rng.integers(0, vocab, size=(batch, 1), dtype=np.int64)
    steps = rng.integers(1, 7, size=(batch, seq), dtype=np.int64)
    toks = (base + np.cumsum(steps, axis=1)) % vocab
    return toks.astype(np.int32)


def make_batch(cfg, seed: int, step: int, batch: int, seq: int) -> Dict:
    """{"inputs": {"tokens", "positions"}, "labels"}: int32 numpy arrays of
    (batch, seq); the labels are the tokens shifted by one."""
    toks = synth_tokens(seed, step, batch, seq + 1, cfg.vocab_size)
    pos = np.tile(np.arange(seq, dtype=np.int32)[None, :], (batch, 1))
    return {"inputs": {"positions": pos, "tokens": toks[:, :seq]},
            "labels": toks[:, 1:seq + 1]}


def batch_to_torch(batch: Dict, device) -> Dict:
    """A ``make_batch`` batch as tensors on ``device``; tokens and labels
    as int64 (the embedding take and the loss's gather index with them)."""
    inp = batch["inputs"]
    return {"inputs": {
                "tokens": torch.from_numpy(inp["tokens"]).long().to(device),
                "positions": torch.from_numpy(inp["positions"]).to(device)},
            "labels": torch.from_numpy(batch["labels"]).long().to(device)}


class SyntheticStream:
    """``make_batch`` for steps ``start_step``, ``start_step + 1``, …, made
    ahead by a background thread (``prefetch`` batches deep)."""

    def __init__(self, cfg, batch: int, seq: int, seed: int = 0,
                 start_step: int = 0, prefetch: int = 2):
        self.cfg, self.batch, self.seq, self.seed = cfg, batch, seq, seed
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self.step
        while not self._stop.is_set():
            b = make_batch(self.cfg, self.seed, step, self.batch, self.seq)
            while not self._stop.is_set():
                try:
                    self._q.put((step, b), timeout=0.2)
                    break
                except queue.Full:
                    continue
            step += 1

    def __next__(self) -> Dict:
        step, b = self._q.get()
        self.step = step + 1
        return b

    def __iter__(self) -> Iterator[Dict]:
        return self

    def close(self):
        self._stop.set()


class DiskTokenStream:
    """A corpus in a Roomy Tier-D ``ChunkStore``, streamed chunk by chunk:
    waits for the port of the disk tier."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "DiskTokenStream reads a Tier-D ChunkStore, which is not ported "
            "to repro_torch yet: ROADMAP item 8")

    @staticmethod
    def write_corpus(*args, **kwargs) -> None:
        raise NotImplementedError(
            "DiskTokenStream.write_corpus writes a Tier-D ChunkStore, which "
            "is not ported to repro_torch yet: ROADMAP item 8")
