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
selective scan.  ``--tp > 1`` (a tensor-parallel mesh) waits for the
training half of the distributed slice, ROADMAP item 9.8b.
"""
from __future__ import annotations

import argparse

from ..configs import get_config
from ..runtime import TrainSettings, train


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
                    help="tensor-parallel size (not ported)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    if args.tp > 1:
        raise NotImplementedError(
            "--tp > 1 trains on a device mesh, which repro_torch serves "
            "on but does not train on yet: ROADMAP item 9.8b")

    cfg = get_config(args.arch, smoke=args.smoke)
    settings = TrainSettings(
        batch=args.batch, seq=args.seq, steps=args.steps, lr=args.lr,
        schedule=args.schedule, num_microbatches=args.microbatches,
        grad_compression=args.grad_compression,
        ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir, seed=args.seed)
    out = train(cfg, settings, device=args.device)
    print(f"final loss {out['losses'][-1]:.4f} "
          f"({len(out['losses'])} steps, {out['restarts']} restarts)")
    return out


if __name__ == "__main__":
    main()
