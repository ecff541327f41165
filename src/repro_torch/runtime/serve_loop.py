"""Batched serving runtime: continuous-batching scheduler over paged KV.

Port of ``repro/runtime/serve_loop.py``, with its behaviour kept as it is:
requests arrive as prompt token lists; up to ``max_batch`` sequences are
active; a new arrival is prefilled by decode steps, one per prompt token,
in which only its slot's caches advance (the per-slot merge of
``_masked_step``: pages, table row and length of a paged KV cache; the
conv tail and scan state of an SSM cache); then all slots decode in
lockstep, one token a wave, until each request has ``max_new`` tokens.  A
freed slot is reused as it stands — its lengths and pages, or its SSM
state, are not reset, as in the reference.
Greedy sampling (argmax, first index on ties).

The Server never calls ``lm.prefill``: the reference's does not either.
It serves the token-input archs only and refuses a frontend-stub config
(musicgen, qwen2-vl), as the reference does.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from .. import device as _device
from ..core import paged
from ..models import lm
from ..models.config import ModelConfig
from ..models.ssm import SSMState


@dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int = 16
    out: List[int] = field(default_factory=list)
    done: bool = False


def _merge(new: paged.PagedKV, old: paged.PagedKV, slot: int,
           batch: int) -> paged.PagedKV:
    """``new`` for slot ``slot``'s pages, table row and length; ``old`` for
    every other slot's."""
    pps = old.k_pages.shape[0] // batch             # num_pages = B·pps
    dev = old.k_pages.device
    page_m = (torch.arange(old.k_pages.shape[0], device=dev) // pps
              == slot)[:, None, None, None]
    row_m = torch.arange(batch, device=dev) == slot
    return paged.PagedKV(
        k_pages=torch.where(page_m, new.k_pages, old.k_pages),
        v_pages=torch.where(page_m, new.v_pages, old.v_pages),
        page_table=torch.where(row_m[:, None], new.page_table,
                               old.page_table),
        lengths=torch.where(row_m, new.lengths, old.lengths))


def _merge_ssm(new: SSMState, old: SSMState, slot: int) -> SSMState:
    """``new``'s conv tail (B, k-1, C) and state (B, Di, N) for row
    ``slot``, ``old``'s for every other row
    (``repro/runtime/serve_loop.py:84-91``)."""
    row_m = (torch.arange(old.h.shape[0], device=old.h.device)
             == slot)[:, None, None]
    return SSMState(conv=torch.where(row_m, new.conv, old.conv),
                    h=torch.where(row_m, new.h, old.h))


class Server:
    def __init__(self, cfg: ModelConfig, params, max_batch: int = 4,
                 max_len: int = 256, greedy: bool = True, device=None):
        if cfg.frontend_stub:
            # repro/runtime/serve_loop.py:39 asserts the same
            raise ValueError(f"{cfg.name}: the serving demo uses token-input "
                             "archs; a frontend stub takes embeddings")
        self.cfg, self.params = cfg, params
        self.max_batch, self.max_len = max_batch, max_len
        self.greedy = greedy
        self.device = _device.resolve(device)
        self.stats = {"prefills": 0, "decode_steps": 0, "tokens_out": 0}

    # ----------------------------------------------------------- engine
    def _tokens(self, toks) -> Dict[str, torch.Tensor]:
        t = torch.as_tensor(toks, dtype=torch.int64, device=self.device)
        t = t.expand(self.max_batch).reshape(self.max_batch, 1)
        return {"tokens": t, "positions": torch.zeros_like(t)}

    def _prefill_one(self, req: Request, caches, slot: int):
        """Prefill via decode steps (exact for every family)."""
        for tok in req.prompt:
            logits, caches = self._masked_step(self._tokens(tok), caches,
                                               slot)
        self.stats["prefills"] += 1
        return logits, caches

    def _masked_step(self, inputs, caches, slot: Optional[int] = None):
        """One decode step; when ``slot`` is given, only that row's caches
        advance — other active rows keep their pre-step state (otherwise a
        mid-flight prefill would pollute their pages)."""
        logits, new = lm.decode_step(self.params, inputs, caches, self.cfg)
        if slot is None:
            return logits, new
        merged = {}
        if "ssm" in new:
            merged["ssm"] = [_merge_ssm(n, o, slot) for n, o in
                             zip(new["ssm"], caches["ssm"])]
        if "kv" in new:
            merged["kv"] = [_merge(n, o, slot, self.max_batch)
                            for n, o in zip(new["kv"], caches["kv"])]
        return logits, merged

    def run(self, requests: List[Request]) -> Dict[int, List[int]]:
        waiting = list(requests)
        active: List[Optional[Request]] = [None] * self.max_batch
        caches = lm.make_cache(self.cfg, self.max_batch, self.max_len,
                               device=self.device)
        last_tok = [0] * self.max_batch

        while waiting or any(a is not None for a in active):
            # ----- admission
            for slot in range(self.max_batch):
                if active[slot] is None and waiting:
                    req = waiting.pop(0)
                    logits, caches = self._prefill_one(req, caches, slot)
                    last = int(logits[slot, 0].argmax()) if self.greedy \
                        else 0
                    req.out.append(last)
                    last_tok[slot] = last
                    active[slot] = req
            if not any(a is not None for a in active):
                break
            # ----- one lockstep decode wave
            logits, caches = self._masked_step(self._tokens(last_tok),
                                               caches)
            self.stats["decode_steps"] += 1
            nxt = logits[:, 0].argmax(dim=-1).tolist()
            for slot, req in enumerate(active):
                if req is None:
                    continue
                req.out.append(nxt[slot])
                last_tok[slot] = nxt[slot]
                self.stats["tokens_out"] += 1
                if len(req.out) >= req.max_new:
                    req.done = True
                    active[slot] = None
        return {r.rid: r.out for r in requests}
