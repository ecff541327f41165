"""Roofline analysis over the dry run's JSON results (port of
``repro/launch/roofline.py``), with one NVIDIA H100's constants.

Per (arch x shape x mesh) cell, each term is a time in seconds:

  compute term    = FLOPs_per_device / PEAK_FLOPS
  memory term     = bytes_per_device / HBM_BW
  collective term = wire_bytes_per_device / LINK_BW

FLOPs come from the dry run's twin count (``dryrun._counted_flops``:
``FlopCounterMode`` at two depths, extrapolated, plus the analytic
correction for the mamba recurrence) where the cell has it, else the
full-depth count.  bytes_per_device is the dry run's sum of every
dispatched op's input and output bytes: an unfused upper bound, where
the reference reads XLA's fused "bytes accessed" (``dryrun.py`` says
how they differ).  Collective wire bytes come from the algebra of
``dryrun.collective_stats`` over the c10d ops the traced step issued.

MODEL_FLOPS = 6·N_active·D for train (2·N_active·D for decode and
prefill); the MODEL/FLOPs ratio exposes remat and replicated compute.

The link term charges every collective to NVLink, the link between the
cards of one node.  The production meshes (16 x 16, 2 x 16 x 16) span
many 8-card nodes, and across nodes a collective crosses the network,
which is several times slower than NVLink; so the collective term, and
the multi-pod one most of all, is optimistic.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List

# NVIDIA H100 SXM5 80GB at its 700 W power limit (NVIDIA's data sheet, the
# rates the kernel table's bounds in PERF.md use):
PEAK_FLOPS = 989e12          # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12             # HBM3 bytes/s
LINK_BW = 450e9              # NVLink 4 bytes/s, one direction, per GPU,
#                              within a node (900 GB/s both ways)


def analyze(cell: Dict) -> Dict:
    if "skipped" in cell:
        return {**cell, "dominant": "skipped"}
    if cell.get("failed"):                  # run_all's record of a failure
        return {**cell, "dominant": "failed"}
    n_dev = cell["devices"]
    flops = cell.get("flops_per_device_counted",
                     cell.get("flops_per_device", 0.0))
    t_compute = flops / PEAK_FLOPS
    t_memory = cell["bytes_per_device"] / HBM_BW
    wire = cell["collectives"]["total_wire_bytes"]
    t_coll = wire / LINK_BW

    tokens = cell["global_batch"] * (cell["seq_len"]
                                     if cell["kind"] != "decode"
                                     else 1)
    mult = 6.0 if cell["kind"] == "train" else 2.0
    model_flops = mult * cell["active_params"] * tokens / n_dev
    terms = {"compute": t_compute, "memory": t_memory,
             "collective": t_coll}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    return {
        **cell,
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "model_flops_per_device": model_flops,
        "model_over_hlo": model_flops / flops if flops else 0.0,
        "roofline_fraction": (model_flops / PEAK_FLOPS) / bound
        if bound else 0.0,
    }


def _fmt_row(r: Dict) -> str:
    if r.get("dominant") in ("skipped", "failed"):
        mark = "SKIP" if r["dominant"] == "skipped" else "FAIL"
        return (f"| {r['arch']} | {r['shape']} | {r['mesh']} | — | — | — | "
                f"{mark} | — | — |")
    return ("| {arch} | {shape} | {mesh} | {tc:.4f} | {tm:.4f} | {tl:.4f} "
            "| {dom} | {ratio:.2f} | {frac:.2f} |").format(
        arch=r["arch"], shape=r["shape"], mesh=r["mesh"],
        tc=r["t_compute_s"], tm=r["t_memory_s"], tl=r["t_collective_s"],
        dom=r["dominant"], ratio=r["model_over_hlo"],
        frac=r["roofline_fraction"])


def table(results: List[Dict]) -> str:
    head = ("| arch | shape | mesh | compute (s) | memory (s) | "
            "collective (s) | bound | MODEL/HLO | roofline frac |\n"
            "|---|---|---|---|---|---|---|---|---|")
    rows = [_fmt_row(analyze(r)) for r in results]
    return "\n".join([head] + rows)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--in-dir", default="experiments/dryrun")
    ap.add_argument("--glob", default="*.json")
    ap.add_argument("--out")
    args = ap.parse_args()
    results = []
    for f in sorted(glob.glob(os.path.join(args.in_dir, args.glob))):
        with open(f) as fh:
            results.append(json.load(fh))
    t = table(results)
    print(t)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(t + "\n")


if __name__ == "__main__":
    main()
