"""Data pipeline: the deterministic synthetic LM stream and the disk-backed
corpus (``repro/data/pipeline.py``).

Determinism contract (fault tolerance rests on it): a batch is a pure
function of (seed, step), drawn from numpy's generator keyed exactly as
the reference keys it, so the two packages give bit-identical batches and
a restore replays the stream from the restored step with no iterator
state to persist.  Batches are numpy arrays; ``batch_to_torch`` moves one
to a device.

Two sources:
  SyntheticStream   hash-keyed token synthesis (no storage at all), made
                    ahead by a background thread
  DiskTokenStream   tokens stored in a Roomy Tier-D ``ChunkStore`` and read
                    a chunk a step (larger-than-RAM corpora)

A batch is {"inputs": {"tokens" or "embeds", "positions"}, "labels"}:
a frontend-stub config (audio, vlm) gets embeddings from a fixed codebook
in place of token ids, and an M-RoPE config (B, S, 3) positions.
"""
from __future__ import annotations

import functools
import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch

from ..core.disk.store import ChunkStore


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


def _positions(cfg, batch: int, seq: int) -> np.ndarray:
    """(batch, seq) int32 positions 0..seq-1; (batch, seq, 3) under M-RoPE,
    a text position repeated in all three streams."""
    pos = np.tile(np.arange(seq, dtype=np.int32)[None, :], (batch, 1))
    if cfg.mrope:
        return np.tile(pos[:, :, None], (1, 1, 3))
    return pos


@functools.lru_cache(maxsize=4)
def codebook(vocab: int, d: int) -> np.ndarray:
    """The stub frontend's (vocab, d) float32 codebook: normals from
    ``default_rng(1234)`` scaled by 0.02, the reference's bits
    (``repro/data/pipeline.py:51-56``).  The reference draws it anew for
    every batch (233M normals at qwen2-vl's vocab); here it is drawn once
    per shape and kept read-only."""
    rng = np.random.default_rng(1234)
    book = rng.standard_normal((vocab, d)).astype(np.float32) * 0.02
    book.flags.writeable = False
    return book


def make_batch(cfg, seed: int, step: int, batch: int, seq: int) -> Dict:
    """{"inputs": {"tokens" | "embeds", "positions"}, "labels"}: numpy
    arrays; the labels (int32, (batch, seq)) are the tokens shifted by
    one.  A frontend stub's inputs are the codebook rows of the tokens,
    float32 (batch, seq, d)."""
    toks = synth_tokens(seed, step, batch, seq + 1, cfg.vocab_size)
    inputs = {"positions": _positions(cfg, batch, seq)}
    if cfg.frontend_stub:
        inputs["embeds"] = codebook(cfg.vocab_size, cfg.d_model)[
            toks[:, :seq]]
    else:
        inputs["tokens"] = toks[:, :seq]
    return {"inputs": inputs, "labels": toks[:, 1:seq + 1]}


def batch_to_torch(batch: Dict, device) -> Dict:
    """A ``make_batch`` batch as tensors on ``device``: tokens and labels
    as int64 (the embedding take and the loss's gather index with them),
    embeds as float32, positions of either rank as they are."""
    inp = batch["inputs"]
    out = {"positions": torch.from_numpy(inp["positions"]).to(device)}
    if "tokens" in inp:
        out["tokens"] = torch.from_numpy(inp["tokens"]).long().to(device)
    if "embeds" in inp:
        out["embeds"] = torch.from_numpy(inp["embeds"]).float().to(device)
    return {"inputs": out,
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
    """A corpus in a Roomy Tier-D ``ChunkStore`` (width 1, uint32, one
    chunk of (seq + 1) · batch tokens a step), streamed chunk by chunk.

    Build it once with ``write_corpus``; batch i is chunk i mod n_chunks,
    still a pure function of the step, so replay after a restore holds.
    As in the reference, a batch carries token ids (and the config's
    positions) whatever the config's frontend."""

    def __init__(self, store_dir: str, cfg, batch: int, seq: int,
                 start_step: int = 0):
        self.store = ChunkStore(store_dir, width=1, dtype="uint32",
                                chunk_rows=(seq + 1) * batch)
        self.cfg, self.batch, self.seq = cfg, batch, seq
        self.step = start_step
        assert self.store.n_chunks > 0, "corpus empty — run write_corpus"

    @staticmethod
    def write_corpus(store_dir: str, cfg, batch: int, seq: int,
                     n_steps: int, seed: int = 0) -> None:
        """Writes ``synth_tokens(seed, step, batch, seq + 1)`` for steps
        0..n_steps-1, one chunk each, replacing any store there."""
        store = ChunkStore(store_dir, width=1, dtype="uint32",
                           chunk_rows=(seq + 1) * batch, fresh=True)
        for step in range(n_steps):
            toks = synth_tokens(seed, step, batch, seq + 1, cfg.vocab_size)
            store.append(toks.reshape(-1, 1).astype(np.uint32))
        store.flush()

    def __next__(self) -> Dict:
        chunk_i = self.step % self.store.n_chunks
        rows = np.asarray(self.store.load_chunk(chunk_i))
        toks = rows.reshape(self.batch, self.seq + 1).astype(np.int32)
        inputs = {"positions": _positions(self.cfg, self.batch, self.seq),
                  "tokens": toks[:, :self.seq]}
        self.step += 1
        return {"inputs": inputs, "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict]:
        return self
