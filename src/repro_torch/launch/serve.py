"""Serving launcher: batched requests through the continuous-batching
server (``runtime/serve_loop.py``) over Roomy paged KV caches.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \\
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch nemotron-4-15b
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch granite-moe-3b-a800m
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b

``--arch``: gemma2-2b, falcon-mamba-7b, nemotron-4-15b, minicpm-2b,
granite-34b, granite-moe-3b-a800m, phi3.5-moe-42b-a6.6b or zamba2-1.2b.
The frontend-stub archs (musicgen-medium, qwen2-vl-2b) take embeddings,
not prompt tokens: the Server refuses them with ``ValueError``, where the
reference's asserts.
granite-34b's 93.9 GB and phi3.5-moe's 83.7 GB of bfloat16 params no
single 80 GB card holds: ``--smoke`` only for those two.  As in the
reference, the Server takes no mesh; ``lm.prefill`` / ``lm.decode_step``
on a mesh take each rank's param shards, so those two serve FULL on two
or more cards through those calls.
The flags and defaults of ``repro/launch/serve.py``, plus ``--device``
(default "cuda"; raises without a card).  A full config keeps its params
in bfloat16 (falcon-mamba-7b: 14.0 GB, nemotron-4-15b: 31.3 GB,
granite-moe-3b-a800m: 7.8 GB with its padded experts, zamba2-1.2b: 2.2
GB); a smoke config runs in float32.
Params are random, from ``--seed``; the prompts come from numpy's
generator on the same seed, as in the reference.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import device as _device
from ..configs import get_config
from ..models import lm
from ..models.layers import cdtype
from ..runtime import Request, Server


def main(argv=None):
    """Returns (tokens by request id, the Server, wall seconds)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)

    dev = _device.resolve(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    params = lm.init_params(cfg, args.seed, device=dev, dtype=cdtype(cfg))
    server = Server(cfg, params, max_batch=args.max_batch,
                    max_len=args.max_len, device=dev)
    rng = np.random.default_rng(args.seed)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size, 8).tolist(),
                    max_new=args.max_new)
            for i in range(args.requests)]
    t0 = time.perf_counter()
    outs = server.run(reqs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    toks = sum(len(v) for v in outs.values())
    for rid, toks_out in sorted(outs.items()):
        print(f"req {rid}: {toks_out}")
    print(f"{toks} tokens in {dt:.2f}s = {toks/dt:.1f} tok/s on {dev} "
          f"(stats: {server.stats})")
    return outs, server, dt


if __name__ == "__main__":
    main()
