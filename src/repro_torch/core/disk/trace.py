"""JSONL trace sessions for obs.py spans, with a report/export CLI: the
port's own copy of ``repro/core/disk/trace.py``, the same records and
reports.

A trace file is JSON Lines: a ``meta`` record, then one record per
finished span (coordinator spans plus worker spans merged in at every
level barrier, tagged ``shard=k``), then a final ``summary`` record
holding the merged registry snapshot.  One distributed run — one file.

    from repro_torch.core.disk import trace
    trace.start("run.jsonl")
    ... search ...
    trace.stop()

CLI (PYTHONPATH=src):

    python -m repro_torch.core.disk.trace report run.jsonl
    python -m repro_torch.core.disk.trace export-chrome run.jsonl -o run.json

``report`` prints the per-level table (wall time, passes, bytes,
bytes/s, retries, recoveries, per-shard skew); ``export-chrome`` writes
Chrome trace-event JSON loadable in Perfetto (ui.perfetto.dev) or
chrome://tracing, one track per shard.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional

from .. import obs


class TraceSession:
    """Line-buffered JSONL writer wired in as the obs span sink."""

    def __init__(self, path: str, meta: Optional[dict] = None):
        self.path = path
        self._f = open(path, "w", buffering=1)
        rec = {"type": "meta", "version": 1, "pid": os.getpid(),
               "unix_time": time.time()}
        if meta:
            rec.update(meta)
        self.write(rec)

    def write(self, rec: dict) -> None:
        self._f.write(json.dumps(rec, separators=(",", ":"),
                                 sort_keys=True) + "\n")

    def close(self) -> None:
        self.write({"type": "summary", **obs.snapshot()})
        self._f.close()


_SESSION: Optional[TraceSession] = None


def start(path: str, meta: Optional[dict] = None) -> TraceSession:
    """Begin tracing this process into ``path`` and export
    ``ROOMY_TRACE=1`` so shard workers spawned (or recovery-respawned)
    after this call turn on buffered tracing and ship their spans back
    at each level barrier."""
    global _SESSION
    if _SESSION is not None:
        raise RuntimeError(f"trace already active: {_SESSION.path}")
    _SESSION = TraceSession(path, meta=meta)
    os.environ[obs.ENV_VAR] = "1"
    obs.enable(sink=_SESSION.write)
    return _SESSION


def stop() -> Optional[str]:
    """Finish the active session: flush, write the summary record, turn
    tracing off.  Returns the trace path (None if nothing was active)."""
    global _SESSION
    if _SESSION is None:
        return None
    for rec in obs.drain_spans():      # belt and braces: sink mode buffers 0
        _SESSION.write(rec)
    path = _SESSION.path
    _SESSION.close()
    _SESSION = None
    os.environ.pop(obs.ENV_VAR, None)
    obs.disable()
    return path


# ------------------------------------------------------------------ reading

def read(path: str):
    """Parse a trace file -> (meta, spans, summary)."""
    meta, spans, summary = {}, [], {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            kind = rec.get("type")
            if kind == "meta":
                meta = rec
            elif kind == "span":
                spans.append(rec)
            elif kind == "summary":
                summary = rec
    return meta, spans, summary


def _metric(rec: dict, *keys: str) -> int:
    m = rec.get("metrics") or {}
    return sum(m.get(k, 0) for k in keys)


_PASS_KEYS = ("extsort.sort_passes", "extsort.merge_passes",
              "extsort.rw_passes", "extsort.read_passes")
_BYTE_KEYS = ("bits.bytes_read", "bits.bytes_written")


def level_rows(spans: List[dict]) -> List[dict]:
    """Aggregate ``bfs.level`` spans into one row per level.

    Counter metrics come from the coordinator span only (``shard`` is
    None there): in spawn mode the coordinator folds worker counter
    deltas inside the level barrier, and in inline mode workers share
    the coordinator's registry — either way the coordinator span's
    deltas already include the workers', so adding worker spans on top
    would double-count.  Worker spans contribute the per-shard wall
    times the skew column is computed from.

    ``recovery.rollback`` spans fold into their level's retries /
    recoveries columns: a rollback happens OUTSIDE any ``bfs.level``
    span (the failed level's span already closed when its collective
    raised), so its counters would otherwise be invisible here.
    """
    levels: Dict[int, dict] = {}
    for s in spans:
        if s.get("sid") not in ("bfs.level", "recovery.rollback"):
            continue
        attrs = s.get("attrs") or {}
        lev = attrs.get("level")
        if lev is None:
            continue
        row = levels.setdefault(int(lev), {
            "level": int(lev), "wall_us": 0, "shard_us": {}, "passes": 0,
            "bytes": 0, "retries": 0, "recoveries": 0, "replay": False})
        if s.get("sid") == "recovery.rollback":
            row["retries"] += _metric(s, "extsort.io_retries")
            row["recoveries"] += max(1, _metric(s, "extsort.recoveries"))
            continue
        if s.get("shard") is None:
            row["wall_us"] += s.get("dur_us", 0)
            row["passes"] += _metric(s, *_PASS_KEYS)
            row["bytes"] += _metric(s, *_BYTE_KEYS)
            row["retries"] += _metric(s, "extsort.io_retries")
            row["recoveries"] += _metric(s, "extsort.recoveries")
        else:
            sh = row["shard_us"]
            k = int(s["shard"])
            sh[k] = sh.get(k, 0) + s.get("dur_us", 0)
        if attrs.get("replay"):
            row["replay"] = True
    out = []
    for lev in sorted(levels):
        row = levels[lev]
        walls = list(row["shard_us"].values())
        row["skew_pct"] = (100.0 * (max(walls) - min(walls)) / max(walls)
                          if len(walls) >= 2 and max(walls) > 0 else 0.0)
        # single-process runs have no coordinator/worker split: the one
        # bfs.level span per level carries both the wall time and metrics
        if row["wall_us"] == 0 and walls:
            row["wall_us"] = max(walls)
        out.append(row)
    return out


def _human_bytes(n: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(n) < 1024.0 or unit == "TB":
            return f"{n:.0f}{unit}" if unit == "B" else f"{n:.1f}{unit}"
        n /= 1024.0
    return f"{n:.1f}TB"


def report_json(path: str) -> dict:
    """Machine-readable form of :func:`report`: the same per-level rows
    plus totals, as one JSON-serializable dict.  The serve bench and CI
    assertions consume this instead of scraping the printed table
    (``shard_us`` keys become strings in transit — JSON has no int keys).
    """
    meta, spans, summary = read(path)
    rows = level_rows(spans)
    tot = {k: sum(r[k] for r in rows)
           for k in ("wall_us", "passes", "bytes", "retries", "recoveries")}
    return {
        "trace": path,
        "meta": meta,
        "levels": rows,
        "totals": tot,
        "replayed_levels": [r["level"] for r in rows if r["replay"]],
        "rollback_spans": sum(1 for s in spans
                              if s.get("sid") == "recovery.rollback"),
    }


def report(path: str, out=None) -> List[dict]:
    """Print the per-level table for a trace file; returns the rows."""
    out = out or sys.stdout
    meta, spans, summary = read(path)
    rows = level_rows(spans)
    shards = sorted({s["shard"] for s in spans if s.get("shard") is not None})
    src = meta.get("example") or meta.get("argv") or path
    line = (f"trace: {src}  spans={len(spans)}"
            + (f"  shards={len(shards)}" if shards else ""))
    print(line, file=out)
    hdr = (f"{'level':>6} {'wall_s':>8} {'passes':>7} {'bytes':>10} "
           f"{'bytes/s':>10} {'retries':>8} {'recov':>6} {'skew%':>6}")
    print(hdr, file=out)
    tot = {"wall_us": 0, "passes": 0, "bytes": 0, "retries": 0,
           "recoveries": 0}
    replay_seen = False
    for r in rows:
        wall_s = r["wall_us"] / 1e6
        bps = r["bytes"] / wall_s if wall_s > 0 else 0.0
        mark = "*" if r["replay"] else " "
        replay_seen = replay_seen or r["replay"]
        print(f"{r['level']:>5}{mark} {wall_s:>8.3f} {r['passes']:>7} "
              f"{_human_bytes(r['bytes']):>10} {_human_bytes(bps):>9}/s "
              f"{r['retries']:>8} {r['recoveries']:>6} "
              f"{r['skew_pct']:>6.1f}", file=out)
        for k in tot:
            tot[k] += r[k]
    wall_s = tot["wall_us"] / 1e6
    bps = tot["bytes"] / wall_s if wall_s > 0 else 0.0
    print(f"{'total':>6} {wall_s:>8.3f} {tot['passes']:>7} "
          f"{_human_bytes(tot['bytes']):>10} {_human_bytes(bps):>9}/s "
          f"{tot['retries']:>8} {tot['recoveries']:>6} {'':>6}", file=out)
    if replay_seen:
        print("(* = level replayed by rollback-and-replay recovery)",
              file=out)
    n_rollbacks = sum(1 for s in spans if s.get("sid") == "recovery.rollback")
    if n_rollbacks:
        print(f"recovery.rollback spans: {n_rollbacks}", file=out)
    return rows


# ----------------------------------------------------------- chrome export

def export_chrome(path: str, out_path: Optional[str] = None) -> str:
    """Write Chrome trace-event JSON (Perfetto-loadable).  Spans map to
    complete ("X") events; each shard gets its own pid track (pid 0 is
    the coordinator), nesting is recovered from ts/dur containment."""
    meta, spans, summary = read(path)
    t0 = min((s["ts_us"] for s in spans), default=0)
    events = []
    pids = set()
    for s in spans:
        pid = 0 if s.get("shard") is None else int(s["shard"]) + 1
        pids.add(pid)
        args = dict(s.get("attrs") or {})
        args.update(s.get("metrics") or {})
        events.append({"ph": "X", "name": s["sid"], "cat": "roomy",
                       "ts": s["ts_us"] - t0, "dur": s.get("dur_us", 0),
                       "pid": pid, "tid": 0, "args": args})
    for pid in sorted(pids):
        name = "coordinator" if pid == 0 else f"shard {pid - 1}"
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0, "ts": 0, "args": {"name": name}})
    out_path = out_path or (os.path.splitext(path)[0] + ".chrome.json")
    with open(out_path, "w") as f:
        json.dump({"traceEvents": events,
                   "displayTimeUnit": "ms",
                   "otherData": {k: v for k, v in meta.items()
                                 if k != "type"}}, f)
    return out_path


# ---------------------------------------------------------------------- CLI

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.core.disk.trace",
        description="Inspect Roomy JSONL trace files (docs/observability.md)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    rp = sub.add_parser("report", help="per-level wall/pass/byte table")
    rp.add_argument("trace")
    rp.add_argument("--json", action="store_true",
                    help="emit the report as one JSON object (levels + "
                         "totals) instead of the human table")
    ep = sub.add_parser("export-chrome",
                        help="write Chrome trace-event JSON for Perfetto")
    ep.add_argument("trace")
    ep.add_argument("-o", "--out", default=None,
                    help="output path (default: <trace>.chrome.json)")
    args = ap.parse_args(argv)
    if args.cmd == "report":
        if args.json:
            json.dump(report_json(args.trace), sys.stdout)
            print()
        else:
            report(args.trace)
    else:
        out = export_chrome(args.trace, args.out)
        print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
