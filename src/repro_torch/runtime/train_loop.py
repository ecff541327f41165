"""Fault-tolerant training runtime (``repro/runtime/train_loop.py``).

The step function composes, per ``TrainSettings``:
  * microbatched gradient accumulation in float32;
  * optional int8 / top-k gradient compression with error feedback (the
    codec round trip of the cross-pod reduction; the reduction itself
    waits for ROADMAP item 9.8);
  * AdamW with its schedule (WSD by default) and global-norm clipping,
    updating params and optimizer state in place.

The host loop adds deterministic (seed, step)-keyed data, periodic async
checkpoints, crash → restore → replay supervision (a fault injectable from
the environment for tests) and the straggler watchdog.  Each step runs in
an ``obs`` span ``train.step``, so a traced run carries each step's kernel
launches (``attention.flash_attention_lse``, ``attention
.flash_attention_bwd``).

Params are float32 master copies on ``device`` (default "cuda"); the model
computes in ``cfg.dtype``.  The gradient comes from ``torch.autograd``
through ``lm.loss_fn``, whose attention is K6 with its LSE output forward
and K7 backward (``kernels/ops.py``).

A checkpoint is labelled with the next step to run, so a restore replays
exactly the steps after it; the reference labels it with the step just
run and resumes there, which trains that step's batch twice.
"""
from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass
from typing import Dict, Optional

import torch

from .. import device as _device
from .. import optim
from .. import tree as T
from ..checkpoint import manager as ckpt
from ..core import obs
from ..data.pipeline import batch_to_torch, make_batch
from ..models import lm
from ..models.config import ModelConfig
from ..optim import compress as compress_lib
from ..optim import schedule as sched_lib
from .watchdog import StepTimer, StragglerWatchdog


@dataclass(frozen=True)
class TrainSettings:
    batch: int = 8
    seq: int = 128
    steps: int = 50
    lr: float = 3e-4
    warmup_steps: int = 10
    schedule: str = "wsd"            # wsd | cosine | constant
    num_microbatches: int = 1
    grad_compression: str = "none"   # none | int8 | topk
    ckpt_every: int = 0              # 0 = off
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    seed: int = 0
    clip_norm: float = 1.0
    weight_decay: float = 0.1
    log_every: int = 10


def make_lr_fn(s: TrainSettings):
    if s.schedule == "wsd":
        stable = max(1, int(s.steps * 0.7) - s.warmup_steps)
        decay = max(1, s.steps - s.warmup_steps - stable)
        return sched_lib.wsd(s.lr, s.warmup_steps, stable, decay)
    if s.schedule == "cosine":
        return sched_lib.cosine(s.lr, s.warmup_steps, s.steps)
    return sched_lib.constant(s.lr)


def loss_and_grads(params, batch, cfg: ModelConfig):
    """(loss, grads) of ``lm.loss_fn`` at ``params``: the loss detached, the
    gradients a list in ``T.leaves(params)`` order."""
    with torch.enable_grad():
        loss = lm.loss_fn(params, batch, cfg)
        grads = torch.autograd.grad(loss, T.leaves(params))
    return loss.detach(), list(grads)


def make_train_step(cfg: ModelConfig, s: TrainSettings):
    """Returns step_fn(params, opt_state, residual, batch, step) →
    (params, opt_state, residual, metrics).  ``params`` are leaf tensors
    that require grad; ``batch`` is on their device."""
    lr_fn = make_lr_fn(s)
    if s.grad_compression not in ("none", "int8", "topk"):
        raise ValueError(f"grad_compression {s.grad_compression!r}")

    def step_fn(params, opt_state, residual, batch, step):
        n = s.num_microbatches
        if n > 1:
            gsum = lsum = None
            for i in range(n):
                mb = T.tree_map(lambda x: x.reshape(
                    (n, x.shape[0] // n) + x.shape[1:])[i], batch)
                loss, g = loss_and_grads(params, mb, cfg)
                if gsum is None:
                    gsum, lsum = [x.float() for x in g], loss.float()
                else:
                    for acc, x in zip(gsum, g):
                        acc.add_(x.float())
                    lsum = lsum + loss
                del g
            grads, loss = [x.div_(n) for x in gsum], lsum / n
        else:
            loss, grads = loss_and_grads(params, batch, cfg)
        grads = T.unflatten(params, grads)

        if s.grad_compression == "int8":
            msg, residual = compress_lib.int8_compress(grads, residual)
            grads = compress_lib.int8_decompress(msg, grads)
        elif s.grad_compression == "topk":
            msg, residual = compress_lib.topk_compress(grads, residual)
            grads = compress_lib.topk_decompress(msg, grads)

        lr = lr_fn(step)
        params, opt_state, gnorm = optim.update(
            grads, opt_state, params, lr=lr, clip_norm=s.clip_norm,
            weight_decay=s.weight_decay)
        return params, opt_state, residual, {"loss": loss, "gnorm": gnorm,
                                             "lr": lr}

    return step_fn


class FaultInjector:
    """Deterministic crash for supervision tests: raises at a given step
    once, set by the constructor or the environment's REPRO_FAULT_STEP."""

    def __init__(self, fault_step: Optional[int] = None):
        env = os.environ.get("REPRO_FAULT_STEP")
        self.fault_step = fault_step if fault_step is not None else (
            int(env) if env else None)
        self.fired = False

    def maybe_fire(self, step: int):
        if self.fault_step is not None and step == self.fault_step \
                and not self.fired:
            self.fired = True
            raise RuntimeError(f"injected fault at step {step}")


def init_state(cfg: ModelConfig, s: TrainSettings, device):
    """(params, opt_state, residual) of a fresh run: float32 params from
    ``s.seed`` that require grad, zero AdamW moments, and a zero
    compression residual (None without compression)."""
    params = lm.init_params(cfg, s.seed, device=device, dtype=torch.float32)
    params = T.tree_map(lambda p: p.requires_grad_(True), params)
    residual = (T.tree_map(lambda p: torch.zeros_like(p, requires_grad=False),
                           params)
                if s.grad_compression != "none" else None)
    return params, optim.init(params), residual


@torch.no_grad()
def _restore(s: TrainSettings, step: int, params, opt_state):
    """The checkpoint of ``step`` copied into ``params`` and ``opt_state``'s
    tensors in place (so the params keep requiring grad)."""
    tree = ckpt.restore(s.ckpt_dir, step, {"params": params, "opt": opt_state})
    for dst, src in zip(T.leaves((params, opt_state.m, opt_state.v)),
                        T.leaves((tree["params"], tree["opt"].m,
                                  tree["opt"].v))):
        dst.copy_(src)
    return params, opt_state._replace(step=tree["opt"].step)


def train(cfg: ModelConfig, s: TrainSettings,
          fault: Optional[FaultInjector] = None, verbose: bool = True,
          device=None) -> Dict:
    """Supervised train loop: run → (crash → restore → replay) → done.

    Returns {"losses", "restarts", "final_params", "watchdog_events",
    "step_seconds"}; a replayed step appears in ``losses`` and
    ``step_seconds`` again."""
    dev = _device.resolve(device)
    fault = fault or FaultInjector()
    watchdog = StragglerWatchdog()
    step_fn = make_train_step(cfg, s)

    params, opt_state, residual = init_state(cfg, s, dev)
    start_step = 0
    ckpt_mgr = ckpt.AsyncCheckpointer(s.ckpt_dir) if s.ckpt_every else None
    if s.ckpt_every:
        last = ckpt.latest_step(s.ckpt_dir)
        if last is not None:
            params, opt_state = _restore(s, last, params, opt_state)
            start_step = last

    losses, seconds, restarts = [], [], 0
    step = start_step
    while step < s.steps:
        try:
            batch = batch_to_torch(make_batch(cfg, s.seed, step, s.batch,
                                              s.seq), dev)
            fault.maybe_fire(step)
            with obs.span("train.step", step=step), StepTimer() as t:
                params, opt_state, residual, metrics = step_fn(
                    params, opt_state, residual, batch, step)
                loss = float(metrics["loss"])      # synchronises the device
            verdict = watchdog.observe(step, t.seconds)
            losses.append(loss)
            seconds.append(t.seconds)
            if verbose and (step % s.log_every == 0 or step == s.steps - 1):
                print(f"step {step:5d} loss {loss:8.4f} "
                      f"gnorm {float(metrics['gnorm']):8.3f} "
                      f"lr {metrics['lr']:.2e} "
                      f"{t.seconds * 1e3:7.1f} ms [{verdict}]")
            step += 1
            if ckpt_mgr and step - 1 and (step - 1) % s.ckpt_every == 0:
                ckpt_mgr.save(step, {"params": params, "opt": opt_state})
        except RuntimeError as e:
            if "injected fault" not in str(e):
                raise
            restarts += 1
            if verbose:
                print(f"!! {e} — restoring and replaying")
            if ckpt_mgr:
                ckpt_mgr.wait()
            last = ckpt.latest_step(s.ckpt_dir) if s.ckpt_every else None
            params = opt_state = residual = None
            params, opt_state, residual = init_state(cfg, s, dev)
            step = 0
            if last is not None:
                params, opt_state = _restore(s, last, params, opt_state)
                step = last
    if ckpt_mgr:
        ckpt_mgr.wait()
        ckpt_mgr.close()
    return {"losses": losses, "restarts": restarts, "final_params": params,
            "watchdog_events": watchdog.events, "step_seconds": seconds}
