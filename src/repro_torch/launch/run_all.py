"""Drive the full dry-run matrix: every (arch x shape) x {single, multi}
(port of ``repro/launch/run_all.py``).

Runs each cell in its own subprocess (``python -m
repro_torch.launch.dryrun``: each cell gets its own fake world, and a
failure stays in its cell), a few at a time.  Results land as JSON in
--out-dir; failures are recorded as JSON too, so the roofline table shows
them.  Resume-safe: existing result files are skipped unless --force.

  PYTHONPATH=src python -m repro_torch.launch.run_all --out-dir experiments/dryrun
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor, as_completed


def _cells():
    # import here: keep module import cheap
    from ..configs.registry import ARCH_IDS
    from ..configs.shapes import SHAPES
    out = []
    for arch in ARCH_IDS:
        for shape in SHAPES:
            for mesh in ("single", "multi"):
                out.append((arch, shape, mesh))
    return out


def run_one(arch: str, shape: str, mesh: str, out_dir: str,
            timeout_s: int, extra: list) -> dict:
    name = f"{arch}__{shape}__{mesh}"
    out_file = os.path.join(out_dir, f"{name}.json")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", arch, "--shape", shape, "--mesh", mesh,
           "--out-dir", out_dir] + extra
    t0 = time.time()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout_s)
        ok = proc.returncode == 0 and os.path.exists(out_file)
        if not ok:
            err = (proc.stderr or "")[-2000:]
            with open(out_file, "w") as f:
                json.dump({"arch": arch, "shape": shape,
                           "mesh": "2x16x16" if mesh == "multi" else "16x16",
                           "failed": True, "returncode": proc.returncode,
                           "stderr_tail": err}, f, indent=2)
        return {"cell": name, "ok": ok, "wall_s": round(time.time() - t0, 1)}
    except subprocess.TimeoutExpired:
        with open(out_file, "w") as f:
            json.dump({"arch": arch, "shape": shape,
                       "mesh": "2x16x16" if mesh == "multi" else "16x16",
                       "failed": True, "timeout_s": timeout_s}, f, indent=2)
        return {"cell": name, "ok": False, "wall_s": timeout_s,
                "timeout": True}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out-dir", default="experiments/dryrun")
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--timeout", type=int, default=1200)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--only-mesh", choices=("single", "multi"))
    ap.add_argument("extra", nargs="*",
                    help="extra dryrun flags, e.g. --skip-flops")
    args = ap.parse_args()

    os.makedirs(args.out_dir, exist_ok=True)
    todo = []
    for arch, shape, mesh in _cells():
        if args.only_mesh and mesh != args.only_mesh:
            continue
        out_file = os.path.join(args.out_dir, f"{arch}__{shape}__{mesh}.json")
        if not args.force and os.path.exists(out_file):
            continue
        todo.append((arch, shape, mesh))
    print(f"{len(todo)} cells to run, {args.jobs} at a time", flush=True)

    results = []
    with ThreadPoolExecutor(max_workers=args.jobs) as ex:
        futs = {ex.submit(run_one, a, s, m, args.out_dir, args.timeout,
                          list(args.extra)): (a, s, m)
                for (a, s, m) in todo}
        for fut in as_completed(futs):
            r = fut.result()
            results.append(r)
            print(f"[{len(results)}/{len(todo)}] "
                  f"{'OK ' if r['ok'] else 'FAIL'} {r['cell']} "
                  f"({r['wall_s']}s)", flush=True)
    bad = [r for r in results if not r["ok"]]
    print(f"done: {len(results) - len(bad)} ok, {len(bad)} failed")
    for r in bad:
        print("FAILED:", r["cell"])


if __name__ == "__main__":
    main()
