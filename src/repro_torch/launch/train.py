"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \\
        --smoke --steps 20 --batch 8 --seq 128 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \\
        --batch 1 --seq 4096 --steps 6

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch falcon-mamba-7b --smoke --steps 3 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-vl-2b \
        --batch 1 --seq 4096 --steps 6

The flags and defaults of ``repro/launch/train.py``, plus ``--device``
(default "cuda"; raises without a card).  All ten archs of the reference
train: dense (gemma2-2b, nemotron-4-15b, minicpm-2b, granite-34b), MoE
(granite-moe-3b-a800m, phi3.5-moe-42b-a6.6b), ssm (falcon-mamba-7b),
hybrid (zamba2-1.2b) and the frontend stubs (musicgen-medium: audio;
qwen2-vl-2b: vision, M-RoPE), whose batches carry codebook embeddings.
The reference runs ``--smoke`` with its plain attention and scan (the
Pallas kernels do not run on its CPU); the port
keeps ``kernels="auto"``, which runs the plain versions for CPU tensors
and, on the card, K6-with-LSE and K7 for attention, K9 and K9-bwd for the
selective scan.

``--tp > 1`` trains on a ("data", "model") mesh of the world's ranks,
``tp`` a model group (``launch/mesh.make_host_mesh``): params and AdamW
state are each rank's shards, the batch splits over the data ranks.  It
needs a process group initialised from the environment, as ``torchrun``
sets it (NCCL on the card, gloo with ``--device cpu``); it raises if there
is none, or if ``tp`` does not divide the world:

    torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --arch gemma2-2b --smoke --tp 2 --device cpu
"""
from __future__ import annotations

import argparse
import os

import torch
import torch.distributed as dist

from .. import device as _device
from ..configs import get_config
from ..runtime import TrainSettings, train
from .mesh import make_host_mesh


def _init_group(device) -> None:
    """The process group ``torchrun``'s environment describes: NCCL for
    the card (this rank's ``LOCAL_RANK`` device), gloo for the CPU."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        raise RuntimeError(
            "--tp > 1 trains on a mesh: initialise a process group first "
            "(run under torchrun, which sets RANK, WORLD_SIZE, MASTER_ADDR "
            "and MASTER_PORT)")
    if _device.resolve(device).type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl")
    else:
        dist.init_process_group("gloo")


def main(argv=None):
    """Returns the ``train`` result."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--schedule", default="wsd",
                    choices=("wsd", "cosine", "constant"))
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", default="none",
                    choices=("none", "int8", "topk"))
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=TrainSettings.ckpt_dir)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel size: ranks a model group")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    settings = TrainSettings(
        batch=args.batch, seq=args.seq, steps=args.steps, lr=args.lr,
        schedule=args.schedule, num_microbatches=args.microbatches,
        grad_compression=args.grad_compression,
        ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir, seed=args.seed)
    mesh, owned = None, False
    if args.tp > 1:
        if not dist.is_initialized():
            _init_group(args.device)
            owned = True
        mesh = make_host_mesh(args.tp, args.device)
    try:
        out = train(cfg, settings, device=args.device, mesh=mesh)
    finally:
        if owned:
            dist.destroy_process_group()
    print(f"final loss {out['losses'][-1]:.6f} "
          f"({len(out['losses'])} steps, {out['restarts']} restarts)")
    return out


if __name__ == "__main__":
    main()
