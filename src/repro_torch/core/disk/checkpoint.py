"""SearchCheckpoint — durable checkpoint/restart of an in-progress BFS: the
port's own copy of ``repro/core/disk/checkpoint.py``.  Manifests, META and
snapshot payloads are the reference's bytes, so a checkpoint written by
one package resumes in the other.

Roomy's premise is that the authoritative state of a computation lives on
disk, which makes long-running searches restartable "for free" — this
module is that promise made real for both Tier D BFS engines.  A
checkpoint directory holds monotonically versioned snapshot directories::

    <checkpoint_dir>/
        CHECKPOINT            # JSON manifest: the one adoptable version
        v000007/              # a sealed (complete, immutable) snapshot
            META.json         # copy of the manifest payload for v7
            ...engine state...
        v000008.tmp/          # in-flight snapshot of a killed writer: GARBAGE

Publish discipline (the same ``.tmp``-then-atomic-rename rule the bucket
exchange and ChunkStore manifests use):

  1. stage everything into ``v{k}.tmp/`` (including ``META.json``, last),
  2. ``os.rename`` the directory to ``v{k}`` — the atomic seal,
  3. rewrite ``CHECKPOINT`` via its own tmp + ``os.replace``,
  4. best-effort GC of older ``v*`` dirs and stray ``.tmp`` dirs.

A crash at ANY point leaves the previous checkpoint adoptable: before (2)
only a ``.tmp`` stray exists; between (2) and (3) a sealed-but-unpublished
``v{k}`` exists which adoption ignores (the manifest rules); after (3) the
new version is live.  Adoption (:meth:`SearchCheckpoint.latest`):

  * no manifest and no sealed snapshots → ``None`` (nothing to resume);
  * unreadable/truncated manifest → fall back to the highest sealed
    snapshot with a valid ``META.json`` (adopt the previous checkpoint);
    if none exists either, raise :class:`CheckpointError` (fail loudly);
  * manifest names a version whose directory is missing or torn (a
    version rollback / tampering) → raise :class:`CheckpointError` —
    NEVER silently resume from some other state.

Resume re-validates the engine kind, the structural parameters (row
width / state count / chunk layout), the shard count, and the owner-
function golden values recorded at snapshot time — a resumed sharded run
whose owner function disagrees with the checkpointing run would silently
corrupt every partition, so that mismatch is an error, not a warning.

Checkpoint I/O is booked in ``extsort.STATS`` under the dedicated
``ckpt_bytes_read`` / ``ckpt_bytes_written`` / ``ckpt_snapshots`` /
``ckpt_restores`` counters — NEVER in the sort/merge/pass ledgers — so
the per-level pass budgets are unchanged by
checkpointing, and a resumed run pays exactly the remaining levels'
budgets.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import List, Optional

import numpy as np

from .. import obs
from . import extsort, faults
from .buckets import block_owner_np, hash_owner_np
from .lsm import SortedRunSet
from .store import ChunkStore

__all__ = ["CheckpointError", "SearchCheckpoint", "golden_owner_values",
           "validate_resume"]

MANIFEST = "CHECKPOINT"
META = "META.json"
_VDIR_RE = re.compile(r"^v(\d{6,})$")   # {:06d} grows past 6 digits


class CheckpointError(RuntimeError):
    """An unadoptable or inconsistent checkpoint — resuming would either
    lose the search or corrupt it, so we fail loudly instead."""


# ----------------------------------------------------------- owner goldens

def golden_owner_values(nshards: int, width: int, n_states: int) -> dict:
    """Owner-function fingerprints pinned into every checkpoint manifest.

    A resumed run must route rows/indices to the SAME shards the
    checkpointing run did; these fixed-input golden values are recomputed
    at resume and compared: an ownership disagreement is silent
    corruption.
    """
    rows = (np.arange(1, 8 * max(width, 1) + 1, dtype=np.uint32)
            .reshape(8, max(width, 1)))
    golden = {"hash": hash_owner_np(rows, nshards).tolist()}
    if n_states > 0:
        idx = np.linspace(0, n_states - 1, num=min(9, n_states)).astype(np.int64)
        golden["block"] = block_owner_np(idx, n_states, nshards).tolist()
    return golden


def validate_resume(meta: dict, engine: str, nshards: int, width: int,
                    n_states: int, sharded: bool) -> None:
    """Fail loudly on any structural mismatch between the checkpoint and
    the resuming call: engine kind, snapshot format (single-process vs
    sharded — their payload layouts differ), shard count, row width /
    state count, and the owner-function golden values.  A manifest
    MISSING one of the structural keys is corruption, not a pass —
    defaulting a missing key to the caller's own value would vacuously
    validate it."""
    for key in ("engine", "sharded", "nshards", "width", "n_states",
                "golden", "level_sizes"):
        if key not in meta:
            raise CheckpointError(
                f"checkpoint manifest is missing the structural key "
                f"{key!r} — corrupt or foreign META, refusing to resume")
    if meta["engine"] != engine:
        raise CheckpointError(
            f"checkpoint is for engine {meta['engine']!r}, "
            f"resume requested {engine!r}")
    if bool(meta["sharded"]) != sharded:
        want = "sharded" if meta["sharded"] else "single-process"
        got = "sharded" if sharded else "single-process"
        raise CheckpointError(
            f"checkpoint was written by the {want} runtime, resume is "
            f"{got} — the snapshot layouts are not interchangeable "
            "(even at nshards=1)")
    if int(meta["nshards"]) != nshards:
        raise CheckpointError(
            f"checkpoint was taken with nshards={meta['nshards']}, "
            f"resume runs nshards={nshards} — repartitioning a mid-search "
            "checkpoint is not supported")
    if int(meta["width"]) != width:
        raise CheckpointError(
            f"checkpoint row width {meta['width']} != {width}")
    if int(meta["n_states"]) != n_states:
        raise CheckpointError(
            f"checkpoint n_states {meta['n_states']} != {n_states}")
    want = golden_owner_values(nshards, width, n_states)
    got = meta["golden"]
    for key, vals in want.items():
        if got.get(key) != vals:
            raise CheckpointError(
                f"owner-function golden values diverged ({key}: checkpoint "
                f"{got.get(key)} vs resume {vals}) — the owner maps changed "
                "since this checkpoint was written")


# ------------------------------------------------------------ booked copies

def _copy_file_booked(src: str, dst: str, counter: str) -> int:
    shutil.copyfile(src, dst)
    n = os.path.getsize(dst)
    obs.add(extsort.STATS, counter, n)
    return n


def copy_dir_booked(src: str, dst: str, counter: str) -> int:
    """Copy every regular file of ``src`` into ``dst`` (flat), booking the
    bytes under the given ckpt counter.  Returns bytes copied."""
    os.makedirs(dst, exist_ok=True)
    total = 0
    for fn in sorted(os.listdir(src)):
        p = os.path.join(src, fn)
        if os.path.isfile(p):
            total += _copy_file_booked(p, os.path.join(dst, fn), counter)
    return total


def _link_or_copy_dir(src: str, dst: str) -> int:
    """Populate ``dst`` with hard links to ``src``'s files — both live
    under the same checkpoint root, so linking normally succeeds and costs
    no data I/O (sealed snapshots are immutable, and GC's rmtree just
    drops link counts).  Falls back to copying per file; returns the bytes
    physically copied (0 when every link landed)."""
    os.makedirs(dst, exist_ok=True)
    copied = 0
    for fn in sorted(os.listdir(src)):
        p = os.path.join(src, fn)
        if not os.path.isfile(p):
            continue
        q = os.path.join(dst, fn)
        try:
            os.link(p, q)
        except OSError:
            shutil.copyfile(p, q)
            copied += os.path.getsize(q)
    return copied


# ---------------------------------------------------------------- the layer

class SearchCheckpoint:
    """Versioned snapshot directory with atomic publish and crash adoption
    (module docstring has the full format and rules)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._next = None       # lazily derived from latest()

    # ------------------------------------------------------------ layout
    def _vdir(self, version: int) -> str:
        return os.path.join(self.root, f"v{version:06d}")

    def _manifest_path(self) -> str:
        return os.path.join(self.root, MANIFEST)

    def _sealed_versions(self) -> List[int]:
        out = []
        for fn in os.listdir(self.root):
            m = _VDIR_RE.match(fn)
            if m and os.path.isdir(os.path.join(self.root, fn)):
                out.append(int(m.group(1)))
        return sorted(out)

    def _read_meta(self, version: int) -> Optional[dict]:
        try:
            with open(os.path.join(self._vdir(version), META)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    # ---------------------------------------------------------- adoption
    def latest(self) -> Optional[dict]:
        """The adoptable checkpoint's manifest payload, or None if no
        checkpoint has ever been published.  Raises CheckpointError when
        state exists but none of it is safely adoptable (see module
        docstring for the exact rules)."""
        sealed = self._sealed_versions()
        mpath = self._manifest_path()
        if not os.path.exists(mpath):
            if not sealed:
                return None
            # Crash between seal and first manifest write: the highest
            # sealed snapshot is complete by construction — adopt it.
            return self._adopt_fallback(sealed)
        try:
            with open(mpath) as f:
                manifest = json.load(f)
            version = int(manifest["version"])
        except (OSError, ValueError, KeyError, TypeError):
            # Truncated/garbled manifest: the snapshots themselves carry
            # META.json, so fall back to the newest sealed one.
            if sealed:
                return self._adopt_fallback(sealed)
            raise CheckpointError(
                f"corrupt checkpoint manifest {mpath} and no sealed "
                "snapshot to fall back to") from None
        meta = self._read_meta(version)
        if meta is None:
            raise CheckpointError(
                f"checkpoint manifest names version {version} but "
                f"{self._vdir(version)} is missing or torn (version "
                "rollback?) — refusing to guess")
        if int(meta.get("version", version)) != version:
            raise CheckpointError(
                f"snapshot v{version} carries META version "
                f"{meta.get('version')} — manifest/snapshot mismatch")
        return meta

    def _adopt_fallback(self, sealed: List[int]) -> dict:
        for version in reversed(sealed):
            meta = self._read_meta(version)
            if meta is not None and int(meta.get("version", -1)) == version:
                return meta
        raise CheckpointError(
            f"no adoptable snapshot under {self.root}: manifest unreadable "
            f"and sealed dirs {sealed} all lack a valid {META}")

    def snapshot_dir(self, meta: dict) -> str:
        """The sealed directory holding an adopted checkpoint's payload."""
        return self._vdir(int(meta["version"]))

    # ----------------------------------------------------------- publish
    def next_version(self) -> int:
        if self._next is None:
            sealed = self._sealed_versions()
            base = sealed[-1] if sealed else 0
            try:
                published = self.latest()
            except CheckpointError:
                published = None
            if published is not None:
                base = max(base, int(published["version"]))
            self._next = base + 1
        v, self._next = self._next, self._next + 1
        return v

    def begin(self, version: int) -> str:
        """Open a staging directory for ``version`` (clearing any stale
        seal or stray .tmp of the same version from a previous life)."""
        stage = self._vdir(version) + ".tmp"
        shutil.rmtree(stage, ignore_errors=True)
        shutil.rmtree(self._vdir(version), ignore_errors=True)
        os.makedirs(stage)
        return stage

    def publish(self, version: int, meta: dict) -> str:
        """Seal ``v{version}.tmp`` and move the manifest forward, atomically
        at every step; GC older snapshots only after the manifest points at
        the new one.  Returns the sealed snapshot directory (callers
        thread it as ``prev_dir`` for the next incremental snapshot)."""
        meta = dict(meta)
        meta["version"] = version
        stage = self._vdir(version) + ".tmp"
        with open(os.path.join(stage, META), "w") as f:
            json.dump(meta, f)
        # Both steps are atomic renames (idempotent: re-running a rename
        # whose source already moved is caught by the exists() guard in the
        # closure), so transient-errno retry is safe; a giveup here leaves
        # the previous checkpoint adoptable per the crash rules above.
        faults.retry_io(
            "ckpt_publish",
            lambda: (os.path.isdir(stage)
                     and os.rename(stage, self._vdir(version))),
            version=version)                           # atomic seal

        def _point_manifest() -> None:
            tmp = self._manifest_path() + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"version": version}, f)
            os.replace(tmp, self._manifest_path())     # atomic publish
        faults.retry_io("ckpt_publish", _point_manifest, version=version)
        obs.add(extsort.STATS, "ckpt_snapshots", 1)
        for fn in os.listdir(self.root):               # best-effort GC
            m = _VDIR_RE.match(fn)
            if (m and int(m.group(1)) < version) or fn.endswith(".tmp"):
                if fn != MANIFEST + ".tmp":
                    shutil.rmtree(os.path.join(self.root, fn),
                                  ignore_errors=True)
        return self._vdir(version)


# ================================================== sorted-list engine state
#
# Snapshot payload: one directory per visited run, keyed by the run's
# directory basename (ChunkStore chunks + meta.json manifest copied
# verbatim), plus which run is the current frontier.  Restore copies the
# runs back under the resuming workdir and rebuilds the SortedRunSet
# around them.

def snapshot_sorted_state(stage_dir: str, all_runs: SortedRunSet,
                          cur: Optional[ChunkStore],
                          prev_dir: Optional[str] = None,
                          prev_names=None) -> dict:
    """Stage the visited run set (and frontier identity) into
    ``stage_dir``; returns the engine-state meta to embed in the manifest.

    Incremental rule: a run whose basename appears in ``prev_names`` —
    the runs THIS live search exported into the previous published
    snapshot (``prev_dir``) — is hard-linked from there instead of
    re-copied.  Runs are immutable once added (only compaction replaces
    them, under a fresh name), so total checkpoint I/O across a search is
    O(|visited| + compaction output), not O(levels × |visited|).
    ``prev_names`` must be threaded by the caller from its OWN previous
    snapshot, never read out of an adopted manifest: linking against a
    foreign snapshot could resurrect stale bytes under a recycled run
    name (e.g. a restarted-without-resume search in a reused checkpoint
    directory).
    """
    with obs.span("ckpt.snapshot", engine="sorted", runs=len(all_runs.runs)):
        names: List[str] = []
        cur_name = None
        os.makedirs(stage_dir, exist_ok=True)
        reuse = prev_names if (prev_dir is not None and prev_names) else ()
        for run in all_runs.runs:
            dname = os.path.basename(run.path)
            assert dname not in names, f"duplicate run basename {dname}"
            dst = os.path.join(stage_dir, dname)
            if dname in reuse and os.path.isdir(os.path.join(prev_dir,
                                                             dname)):
                obs.add(extsort.STATS, "ckpt_bytes_written",
                        _link_or_copy_dir(os.path.join(prev_dir, dname),
                                          dst))
            else:
                obs.add(extsort.STATS, "ckpt_bytes_written",
                        run.export_to(dst))
            names.append(dname)
            if cur is not None and run is cur:
                cur_name = dname
        return {"runs": names, "cur": cur_name, "runset_seq": all_runs._seq}


def restore_sorted_state(snap_dir: str, state: dict, all_runs: SortedRunSet,
                         workdir: str, width: int, chunk_rows: int):
    """Rebuild the visited runs under ``workdir`` from a sealed snapshot;
    returns the current-frontier store (None when the shard's frontier was
    empty at snapshot time).  Restored run directories get a fresh
    ``{runset}.ckpt.`` prefix so they can never collide with (or be wiped
    by) the level/compaction stores the resumed loop will create."""
    with obs.span("ckpt.restore", engine="sorted", runs=len(state["runs"])):
        obs.add(extsort.STATS, "ckpt_restores", 1)
        runs: List[ChunkStore] = []
        cur = None
        for dname in state["runs"]:
            dst = os.path.join(workdir, f"{all_runs.name}.ckpt.{dname}")
            shutil.rmtree(dst, ignore_errors=True)
            copy_dir_booked(os.path.join(snap_dir, dname), dst,
                            "ckpt_bytes_read")
            run = ChunkStore(dst, width, chunk_rows=chunk_rows)
            assert run.sorted, \
                f"restored run {dname} lost its sortedness claim"
            runs.append(run)
            if state.get("cur") == dname:
                cur = run
        all_runs.adopt_runs(runs, seq=int(state["runset_seq"]))
        return cur


# ==================================================== implicit engine state

def snapshot_implicit_state(stage_dir: str, bits) -> dict:
    """Snapshot a DiskBitArray (packed chunks + pending op logs) into
    ``stage_dir/bits``; returns the engine-state meta."""
    with obs.span("ckpt.snapshot", engine="implicit"):
        nbytes = bits.snapshot_to(os.path.join(stage_dir, "bits"))
        return {"bits_bytes": nbytes, "chunk_elems": bits.chunk_elems}


def restore_implicit_state(snap_dir: str, bits) -> None:
    with obs.span("ckpt.restore", engine="implicit"):
        obs.add(extsort.STATS, "ckpt_restores", 1)
        bits.adopt_snapshot(os.path.join(snap_dir, "bits"))
