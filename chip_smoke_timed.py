"""Run ``chip_smoke.main()`` with each module-level function of
``chip_smoke`` wrapped in a wall-clock timer, and write the inclusive
seconds and calls of every (caller, callee) pair, largest first, to
``chiprun_out/timing.json``: where the script's time goes.

    python3 chip_smoke_timed.py

Needs what ``chip_smoke.py`` needs (one NVIDIA GPU).  Functions called in
other threads start at ``<root>``; the spawn workers' entry points
(``_w_*``) and generators are left unwrapped."""
import functools
import inspect
import json
import sys
import threading
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

TOTALS = defaultdict(lambda: [0.0, 0])
STACK = threading.local()


def timed(name, fn):
    @functools.wraps(fn)
    def inner(*a, **kw):
        stack = STACK.__dict__.setdefault("names", [])
        key = f"{stack[-1] if stack else '<root>'} > {name}"
        stack.append(name)
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            stack.pop()
            TOTALS[key][0] += time.perf_counter() - t0
            TOTALS[key][1] += 1
    return inner


def main() -> None:
    for name, fn in list(vars(cs).items()):
        if (inspect.isfunction(fn) and fn.__module__ == cs.__name__
                and not name.startswith("_w_") and name != "main"
                and not inspect.isgeneratorfunction(fn)):
            setattr(cs, name, timed(name, fn))
    t0 = time.perf_counter()
    try:
        cs.main()
    finally:
        for child in cs.CHILDREN:
            child.kill()
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        rows = sorted(((s, n, k) for k, (s, n) in TOTALS.items()),
                      reverse=True)
        (out / "timing.json").write_text(json.dumps(
            {"total_s": time.perf_counter() - t0,
             "rows": [[round(s, 2), n, k] for s, n, k in rows]}, indent=0))


if __name__ == "__main__":
    main()
