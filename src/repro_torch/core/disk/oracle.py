"""Distance-oracle serving tier on the device (port of
``repro/core/disk/oracle.py``): sealed artifacts and a batched query server.

A completed implicit BFS is *published* as an immutable, versioned,
checksummed artifact, and a read-only :class:`DistanceOracle` serves
batched ``rank → distance`` lookups (and paths) over it through an LRU
chunk cache whose budget can be a fraction of the artifact.  The chunks
live on the oracle's device as int32 words, and each batch gathers its
codes there with the 2-bit gather kernel (K4) over a table of the chunks
it touches: one launch a batch when the budget holds them all, else one
per group of chunks that fits the budget.

Labels: code 0 = unreached, code ``(d % 3) + 1`` = reached at distance
``d``.  :func:`label_distances_mod3` runs the port's implicit BFS array A
(``core/constructs.py``: K1 per level) and beside it the label array L:
at each level, one K2 applies to L the same target buffer that K1 applies
to A, with ``mark = code(d + 1)`` and ``only_if = UNSEEN``.  A's CUR
fields are exactly the states at distance d, so no state is expanded
twice (the reference re-expands the distance ``d − 3`` states that share
the code, ``repro/core/disk/oracle.py:21-25``).  The per-level counts come
from K1 and must equal the completed search's ``level_sizes``.

Artifact layout, byte for byte the reference's::

    <root>/ORACLE              manifest: {"format", "version", "meta_sha256"}
    <root>/v000001/META.json   format, n_states, chunking, start ranks,
                               level_sizes, codec params, owner-function
                               goldens, per-chunk sha256 fingerprints
    <root>/v000001/b000000.npy packed 2-bit code chunks, 4 fields a byte
                               (``.rmz`` through the rle2 codec, format 2)

Chunk c is bytes ``[c·chunk_elems/4, c·chunk_elems/4 + ceil(rows/4))`` of
the label words' little-endian byte view: 16 fields a word at bits 2j is 4
fields a byte at bits 2j.  Staging (``v*.tmp`` → ``os.rename`` seal →
manifest ``.tmp`` + ``os.replace``) makes every step atomic, and both
the seal and the manifest write run under ``faults.retry_io`` at the
``oracle_publish`` site, as in the reference: a transient fault retries
to the same artifact, a fatal one raises.

Exact distances from mod-3 codes: **greedy descent**.  A walker at code c
moves to the first neighbour, in generator order, with code
``((c - 2) % 3) + 1``; with a symmetric neighbour relation that neighbour
is exactly one step closer.  Steps until a start state = the distance.
Every active walker advances with one ``gen_neighbors`` call and one
batched code gather a step.  ``gen_neighbors`` maps (m,) int64 ranks on
the oracle's device to (m, deg) int64 ranks, e.g.
``repro_torch.apps.pancake_bits.neighbors(n)``.

Cache accounting lives in the ``oracle`` counter namespace (exact,
thread-locked), with the reference's names and values: bytes are the raw
chunk bytes, whatever the device words take.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import threading
from collections import OrderedDict
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ... import device as _device
from ...kernels import ops as K
from .. import bitarray as BA
from .. import constructs as C
from .. import obs
from . import codec as _codec
from . import faults
from .buckets import block_owner

__all__ = ["OracleError", "DistanceOracle", "ShardedOracle", "Chunk",
           "LRUChunkCache", "publish_oracle", "label_distances_mod3",
           "reset_stats", "STATS"]

MANIFEST = "ORACLE"
META = "META.json"
FORMAT = 1                    # raw .npy chunk payloads
FORMAT_COMPRESSED = 2         # rle2-coded .rmz chunk payloads (codec.py)
SUPPORTED_FORMATS = (FORMAT, FORMAT_COMPRESSED)
VALS_PER_BYTE = 4
_VDIR_RE = re.compile(r"^v(\d{6,})$")
# Owner-function goldens are pinned for these shard counts at publish time;
# ShardedOracle recomputes and compares them at open.
_GOLDEN_NSHARDS = (1, 2, 4, 8)
# K3's lut that maps every field to itself: the per-code counts.
_IDENTITY_LUT = 0b11100100

STATS = obs.counters("oracle", {
    "lookups": 0, "batches": 0, "hits": 0, "misses": 0,
    "chunk_loads": 0, "evictions": 0, "bytes_read": 0,
    "resident_bytes": 0, "resident_peak": 0,
})
_STATS_LOCK = threading.Lock()


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = 0


class OracleError(RuntimeError):
    """Artifact missing, torn, tampered, or structurally incompatible."""


def _code_of(level: int) -> int:
    return (level % 3) + 1


def _sha256_bytes(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


# ===================================================== mod-3 labelling pass
def label_distances_mod3(n_states: int, start, neighbor_fn: Callable, *,
                         expect_level_sizes: Optional[Sequence[int]] = None,
                         impl: str = "auto", device=None
                         ) -> Tuple[List[int], torch.Tensor]:
    """BFS from ``start`` writing code ``(d % 3) + 1`` at every reached
    state.  Returns ``(level_sizes, words)``: the per-level newly labelled
    counts and the (ceil(n/16),) int32 label words on ``device``.

    ``expect_level_sizes``: the completed search's histogram; any
    per-level disagreement raises :class:`OracleError`.  After the last
    level, K3 counts each code, which must equal the levels it stands for.
    ``impl`` goes to every K1/K2/K3 call, as in ``implicit_bfs``: "ref"
    labels through their plain versions on any device, which is how the
    kernels' labels are held to the plain ones on the card.
    """
    dev = _device.resolve(device)
    start = torch.as_tensor(start, dtype=torch.int64).reshape(-1).to(dev)
    if start.numel() == 0:
        raise OracleError("empty start set")
    search = BA.mark_packed(BA.make(n_states, device=dev).data, start,
                            mark=BA.CUR, impl=impl)
    labels = BA.mark_packed(BA.make(n_states, device=dev).data, start,
                            mark=_code_of(0), impl=impl)
    newly = BA.count_value(BA.RoomyBitArray(search), BA.CUR, n_states)
    level_sizes: List[int] = []
    level = 0
    while newly:
        if expect_level_sizes is not None:
            if (level >= len(expect_level_sizes)
                    or newly != int(expect_level_sizes[level])):
                want = (int(expect_level_sizes[level])
                        if level < len(expect_level_sizes) else "<end>")
                raise OracleError(
                    f"labeling level {level} marked {newly} states but the "
                    f"completed search recorded {want} — refusing to "
                    "publish a run the labeler cannot reproduce")
        level_sizes.append(newly)
        level += 1
        if level > n_states:
            raise OracleError("labeling did not terminate (neighbor "
                              "function not symmetric/closed?)")
        with obs.span("oracle.label", level=level):
            tgt = C.frontier_targets(search, n_states, newly, neighbor_fn)
            search, cnt = BA.mark_rotate_count(search, tgt, n_states,
                                               impl=impl, inplace=True)
            newly = int(cnt)
            if newly:
                labels = BA.mark_packed(labels, tgt, mark=_code_of(level),
                                        impl=impl)
    if (expect_level_sizes is not None
            and len(level_sizes) != len(expect_level_sizes)):
        raise OracleError(
            f"labeling found {len(level_sizes)} levels but the completed "
            f"search recorded {len(expect_level_sizes)}")
    for code in range(4):
        want = (n_states - sum(level_sizes) if code == 0
                else sum(level_sizes[code - 1::3]))
        _, got = BA.rotate_count(labels, n_states, lut=_IDENTITY_LUT,
                                 count_val=code, impl=impl)
        if int(got) != want:
            raise OracleError(f"{int(got)} states carry code {code} but the "
                              f"levels give {want} — labels corrupt")
    return level_sizes, labels


# ================================================================ publish
def _sealed_versions(root: str) -> List[int]:
    out = []
    for fn in os.listdir(root):
        m = _VDIR_RE.match(fn)
        if m and os.path.isdir(os.path.join(root, fn)):
            out.append(int(m.group(1)))
    return sorted(out)


def _chunk_rows(n_states: int, chunk_elems: int, c: int) -> int:
    return min(chunk_elems, n_states - c * chunk_elems)


def publish_oracle(dst: str, n_states: int, start, neighbor_fn: Callable, *,
                   level_sizes: Optional[Sequence[int]] = None,
                   chunk_elems: int = 1 << 22, codec: Optional[dict] = None,
                   compress: bool = False, device=None) -> dict:
    """Seal a completed search as an immutable versioned oracle artifact.

    Labels on ``device`` (:func:`label_distances_mod3`, checked against
    ``level_sizes``), then publishes under ``dst``.  ``codec`` is an
    opaque dict recorded in META describing the rank codec.
    ``compress=True`` writes the chunks through the rle2 codec (``.rmz``,
    format 2); the sha256 fingerprints are always over the RAW chunk
    bytes, so both formats carry identical ones.  Returns the sealed META
    dict (includes ``version``).
    """
    n_states = int(n_states)
    chunk_elems = int(chunk_elems)
    if chunk_elems % VALS_PER_BYTE:
        raise ValueError(f"chunk_elems {chunk_elems} is not a multiple of "
                         f"{VALS_PER_BYTE}")
    start = torch.as_tensor(start, dtype=torch.int64).reshape(-1)
    os.makedirs(dst, exist_ok=True)
    sizes, words = label_distances_mod3(
        n_states, start, neighbor_fn, expect_level_sizes=level_sizes,
        device=device)
    raw = words.cpu().numpy().astype("<i4", copy=False).view(np.uint8)

    version = (_sealed_versions(dst) or [0])[-1] + 1
    vdir = os.path.join(dst, f"v{version:06d}")
    stage = vdir + ".tmp"
    shutil.rmtree(stage, ignore_errors=True)
    os.makedirs(stage)
    fmt = FORMAT_COMPRESSED if compress else FORMAT
    n_chunks = -(-n_states // chunk_elems)
    chunk_sha = {}
    for c in range(n_chunks):
        lo = c * chunk_elems // VALS_PER_BYTE
        rows = _chunk_rows(n_states, chunk_elems, c)
        packed = raw[lo:lo + -(-rows // VALS_PER_BYTE)]
        chunk_sha[str(c)] = _sha256_bytes(packed.tobytes())
        if compress:
            enc = _codec.encode_rle2(packed, tag="oracle")
            with open(os.path.join(stage, f"b{c:06d}.rmz"), "wb") as f:
                f.write(enc)
        else:
            np.save(os.path.join(stage, f"b{c:06d}.npy"), packed)
    probe = np.linspace(0, n_states - 1,
                        num=min(9, n_states)).astype(np.int64)
    meta = {
        "format": fmt,
        "kind": "distance_oracle_mod3",
        "version": version,
        "n_states": n_states,
        "chunk_elems": chunk_elems,
        "n_chunks": n_chunks,
        "start": start.tolist(),
        "level_sizes": [int(s) for s in sizes],
        "codec": dict(codec or {}),
        "chunk_sha256": chunk_sha,
        "owner_probe": probe.tolist(),
        "owner_golden": {
            str(ns): block_owner(probe, n_states, ns).tolist()
            for ns in _GOLDEN_NSHARDS},
    }
    if compress:        # format-1 METAs never carry the key
        meta["chunk_codec"] = "rle2"
    meta_blob = json.dumps(meta, sort_keys=True).encode()
    # META lands last inside the stage: a sealed dir always carries it.
    with open(os.path.join(stage, META), "wb") as f:
        f.write(meta_blob)
    faults.retry_io(
        "oracle_publish",
        lambda: os.path.isdir(stage) and os.rename(stage, vdir),
        version=version)                                    # atomic seal

    def _point_manifest() -> None:
        tmp = os.path.join(dst, MANIFEST + ".tmp")
        with open(tmp, "w") as f:
            json.dump({"format": fmt, "version": version,
                       "meta_sha256": _sha256_bytes(meta_blob)}, f)
        os.replace(tmp, os.path.join(dst, MANIFEST))
    faults.retry_io("oracle_publish", _point_manifest, version=version)
    # Versions are immutable — only stray staging dirs are collected.
    for fn in os.listdir(dst):
        if fn.endswith(".tmp") and fn != MANIFEST + ".tmp":
            shutil.rmtree(os.path.join(dst, fn), ignore_errors=True)
    return meta


# ============================================================== LRU cache
class Chunk(NamedTuple):
    """One loaded chunk: its fields as int32 words on the oracle's device,
    and the raw chunk bytes it came from (what the counters book)."""
    words: torch.Tensor
    nbytes: int


class LRUChunkCache:
    """Byte-budgeted LRU over loaded chunks, exact accounting.

    ``get`` serves hits by reference (eviction only drops the cache's
    reference, so a reader holding a chunk keeps it alive).  A chunk
    larger than the whole budget is served UNCACHED.  The loader runs
    outside the entry lock so distinct chunks load in parallel; a lost
    race books its load but keeps the winner's entry.  Entries are
    anything with ``nbytes`` (the oracle's :class:`Chunk`).
    """

    def __init__(self, budget_bytes: int, loader: Callable[[int], Chunk]):
        self.budget = int(budget_bytes)
        self._loader = loader
        self._lock = threading.Lock()
        self._entries: "OrderedDict[int, Chunk]" = OrderedDict()
        self.resident = 0

    def keys(self) -> List[int]:
        """Cached chunk ids, LRU first (test hook)."""
        with self._lock:
            return list(self._entries)

    def get(self, key: int) -> Chunk:
        with self._lock:
            arr = self._entries.get(key)
            if arr is not None:
                self._entries.move_to_end(key)
                with _STATS_LOCK:
                    STATS["hits"] += 1
                return arr
        with _STATS_LOCK:
            STATS["misses"] += 1
        arr = self._loader(key)
        with self._lock:
            with _STATS_LOCK:
                STATS["chunk_loads"] += 1
                STATS["bytes_read"] += arr.nbytes
            have = self._entries.get(key)
            if have is not None:
                self._entries.move_to_end(key)
                return have
            while self._entries and self.resident + arr.nbytes > self.budget:
                _, old = self._entries.popitem(last=False)
                self.resident -= old.nbytes
                with _STATS_LOCK:
                    STATS["evictions"] += 1
                    STATS["resident_bytes"] -= old.nbytes
            if arr.nbytes <= self.budget:
                self._entries[key] = arr
                self.resident += arr.nbytes
                with _STATS_LOCK:
                    STATS["resident_bytes"] += arr.nbytes
                    STATS["resident_peak"] = max(STATS["resident_peak"],
                                                 STATS["resident_bytes"])
            return arr

    def close(self) -> None:
        with self._lock:
            freed = self.resident
            self._entries.clear()
            self.resident = 0
        if freed:
            with _STATS_LOCK:
                STATS["resident_bytes"] -= freed


# ======================================================== batched descent
def _descend(codes_fn: Callable, gen_neighbors: Callable,
             ranks: torch.Tensor, start: torch.Tensor, max_dist: int,
             record: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Batched greedy descent: exact distances, and with ``record`` the
    (steps + 1, M) trail of every walker's rank after each step.

    Unreached ranks (code 0) get distance -1.  ``torch.argmax`` takes no
    bool, so the first neighbour with the wanted code is the argmax of the
    hits cast to int32 (first occurrence, as ``np.argmax``).
    """
    dist = torch.full_like(ranks, -1)
    cur = ranks.clone()
    code = codes_fn(cur)
    active = code != 0
    at_start = active & torch.isin(cur, start)
    dist[at_start] = 0
    active &= ~at_start
    trail = [cur.clone()] if record else None
    steps = 0
    while bool(active.any()):
        steps += 1
        if steps > max_dist:
            raise OracleError(
                f"greedy descent exceeded the published diameter "
                f"{max_dist} — artifact corrupt or neighbor function "
                "mismatched")
        pos = torch.nonzero(active).squeeze(1)
        want = (code[pos].to(torch.int64) - 2) % 3 + 1
        nb = gen_neighbors(cur[pos]).to(torch.int64).reshape(
            pos.shape[0], -1)
        ncode = codes_fn(nb.reshape(-1)).reshape(nb.shape)
        hit = ncode.to(torch.int64) == want[:, None]
        if not bool(hit.any(dim=1).all()):
            raise OracleError(
                "greedy descent found a state with no neighbor one level "
                "closer — artifact corrupt or neighbor function mismatched")
        pick = torch.argmax(hit.to(torch.int32), dim=1)
        rows = torch.arange(pos.shape[0], device=pos.device)
        cur[pos] = nb[rows, pick]
        code[pos] = ncode[rows, pick]
        if trail is not None:
            trail.append(cur.clone())
        arrived = pos[torch.isin(cur[pos], start)]
        dist[arrived] = steps
        active[arrived] = False
    return dist, (torch.stack(trail) if record else None)


class _Serving:
    """``distance`` / ``paths`` over ``self.codes`` by greedy descent."""

    def _ranks(self, ranks) -> torch.Tensor:
        return torch.as_tensor(ranks, dtype=torch.int64).reshape(-1).to(
            self.device).contiguous()

    def _check_range(self, idx: torch.Tensor) -> None:
        lo, hi = torch.aminmax(idx)
        if int(lo) < 0 or int(hi) >= self.n_states:
            raise ValueError(f"rank out of range [0, {self.n_states}) in "
                             "oracle query")

    def _gen(self, gen_neighbors, what: str) -> Callable:
        gen = gen_neighbors or self.gen_neighbors
        if gen is None:
            raise ValueError(f"{what} queries need gen_neighbors "
                             "(constructor or argument)")
        return gen

    def distance(self, ranks, gen_neighbors: Optional[Callable] = None
                 ) -> torch.Tensor:
        """Batched EXACT distances via greedy descent (-1 = unreached),
        int64 on the oracle's device."""
        gen = self._gen(gen_neighbors, "distance")
        dist, _ = _descend(self.codes, gen, self._ranks(ranks), self.start,
                           self.max_dist, record=False)
        return dist

    # The serving-tier entry point name; distance IS the lookup product.
    lookup = distance

    def paths(self, ranks, gen_neighbors: Optional[Callable] = None
              ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """Batched path reconstruction: ``(distances, [rank chains])``.

        Each chain is an int64 tensor running query rank → ... → a start
        rank, consecutive entries neighbours, of length ``distance + 1``;
        unreached ranks get distance -1 and the chain ``[rank]``."""
        gen = self._gen(gen_neighbors, "path")
        dist, trail = _descend(self.codes, gen, self._ranks(ranks),
                               self.start, self.max_dist, record=True)
        return dist, [trail[:max(d, 0) + 1, p]
                      for p, d in enumerate(dist.tolist())]

    def path(self, rank: int, gen_neighbors: Optional[Callable] = None
             ) -> torch.Tensor:
        return self.paths([rank], gen_neighbors)[1][0]

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ========================================================== DistanceOracle
class DistanceOracle(_Serving):
    """Read-only batched ``rank → distance`` server over a sealed artifact.

    Opens the manifest-designated version (crash-adopting the newest
    sealed version when the manifest is missing), verifies the META
    fingerprint, and serves through an :class:`LRUChunkCache` of
    ``cache_bytes``.  A chunk is sha256-verified against META when it is
    loaded, before a single value is served from it, then moved to
    ``device`` (default ``"cuda"``) as int32 words.

    ``gen_neighbors`` is only needed for :meth:`distance` / :meth:`paths`;
    :meth:`codes` serves raw mod-3 codes without it.
    """

    def __init__(self, root: str, cache_bytes: int = 1 << 20,
                 version: Optional[int] = None,
                 gen_neighbors: Optional[Callable] = None, device=None):
        self.root = root
        self.gen_neighbors = gen_neighbors
        self.device = _device.resolve(device)
        if not os.path.isdir(root):
            raise OracleError(f"no oracle artifact at {root}")
        version, want_sha = self._resolve_version(version)
        self.version = version
        self._vdir = os.path.join(root, f"v{version:06d}")
        meta_path = os.path.join(self._vdir, META)
        try:
            with open(meta_path, "rb") as f:
                blob = f.read()
            meta = json.loads(blob)
        except (OSError, ValueError) as e:
            raise OracleError(f"unreadable oracle META {meta_path}: {e}"
                              ) from None
        if want_sha is not None and _sha256_bytes(blob) != want_sha:
            raise OracleError(
                f"META fingerprint mismatch for v{version:06d} — manifest "
                "says someone rewrote the sealed META (tamper?)")
        if meta.get("format") not in SUPPORTED_FORMATS:
            raise OracleError(
                f"oracle format {meta.get('format')!r} is not one of the "
                f"supported formats {SUPPORTED_FORMATS} — refusing to "
                "guess at the layout (was this artifact published by a "
                "newer release?)")
        self._chunk_codec = meta.get("chunk_codec")
        if meta["format"] == FORMAT_COMPRESSED:
            if self._chunk_codec != "rle2":
                raise OracleError(
                    f"format-{FORMAT_COMPRESSED} oracle META names chunk "
                    f"codec {self._chunk_codec!r}; this build only decodes "
                    "'rle2'")
        elif self._chunk_codec is not None:
            raise OracleError(
                f"format-{FORMAT} oracle META unexpectedly names a chunk "
                f"codec ({self._chunk_codec!r}) — artifact inconsistent")
        if int(meta.get("version", -1)) != version:
            raise OracleError(
                f"sealed dir v{version:06d} carries META version "
                f"{meta.get('version')} — manifest/artifact mismatch")
        self.meta = meta
        self.n_states = int(meta["n_states"])
        self.chunk_elems = int(meta["chunk_elems"])
        self.n_chunks = int(meta["n_chunks"])
        self.level_sizes = [int(s) for s in meta["level_sizes"]]
        self.max_dist = len(self.level_sizes) - 1
        self.start = torch.as_tensor(meta["start"], dtype=torch.int64,
                                     device=self.device)
        self.cache = LRUChunkCache(cache_bytes, self._load_chunk)

    # --------------------------------------------------------- open rules
    def _resolve_version(self, version: Optional[int]
                         ) -> Tuple[int, Optional[str]]:
        sealed = _sealed_versions(self.root)
        mpath = os.path.join(self.root, MANIFEST)
        manifest = None
        if os.path.exists(mpath):
            try:
                with open(mpath) as f:
                    manifest = json.load(f)
                int(manifest["version"])
            except (OSError, ValueError, KeyError, TypeError):
                raise OracleError(
                    f"corrupt oracle manifest {mpath}") from None
            if manifest.get("format") not in SUPPORTED_FORMATS:
                raise OracleError(
                    f"oracle manifest format {manifest.get('format')!r} is "
                    f"not one of the supported formats {SUPPORTED_FORMATS}")
        if version is None:
            if manifest is not None:
                version = int(manifest["version"])
                if version not in sealed:
                    raise OracleError(
                        f"manifest names v{version:06d} but no such sealed "
                        "version exists (torn publish / rollback?) — "
                        "refusing to guess")
            elif sealed:
                version = sealed[-1]    # crash between seal and manifest
            else:
                raise OracleError(f"no sealed oracle version under "
                                  f"{self.root}")
        elif version not in sealed:
            raise OracleError(f"requested v{version:06d} is not sealed "
                              f"under {self.root} (have {sealed})")
        want_sha = None
        if manifest is not None and int(manifest["version"]) == version:
            want_sha = manifest.get("meta_sha256")
        return version, want_sha

    def _chunk_rows(self, c: int) -> int:
        return _chunk_rows(self.n_states, self.chunk_elems, c)

    def _load_chunk(self, c: int) -> Chunk:
        if self._chunk_codec == "rle2":
            path = os.path.join(self._vdir, f"b{c:06d}.rmz")
            try:
                with open(path, "rb") as f:
                    buf = f.read()
                packed = _codec.decode_rle2(buf, tag="oracle")
            except OSError as e:
                raise OracleError(f"unreadable oracle chunk {path}: {e}"
                                  ) from None
            except _codec.CodecError as e:
                raise OracleError(
                    f"oracle chunk {path} fails to decode ({e}) — "
                    "tampered or torn; refusing to serve from it") from None
        else:
            path = os.path.join(self._vdir, f"b{c:06d}.npy")
            try:
                packed = np.ascontiguousarray(np.load(path, mmap_mode="r"))
            except (OSError, ValueError) as e:
                raise OracleError(f"unreadable oracle chunk {path}: {e}"
                                  ) from None
        rows = self._chunk_bytes(c)
        if packed.dtype != np.uint8 or packed.shape != (rows,):
            raise OracleError(
                f"oracle chunk {path} has shape {packed.shape} "
                f"{packed.dtype}, expected ({rows},) uint8")
        want = self.meta["chunk_sha256"].get(str(c))
        if _sha256_bytes(packed.tobytes()) != want:
            raise OracleError(
                f"oracle chunk {path} fails its sha256 fingerprint — "
                "tampered or torn; refusing to serve from it")
        pad = np.zeros((-rows) % 4, np.uint8)
        words = np.frombuffer(np.concatenate([packed, pad]).tobytes(), "<i4")
        return Chunk(torch.from_numpy(words.astype(np.int32)).to(self.device),
                     packed.nbytes)

    def _chunk_bytes(self, c: int) -> int:
        return -(-self._chunk_rows(c) // VALS_PER_BYTE)

    @property
    def artifact_bytes(self) -> int:
        """Total packed chunk bytes of the open version."""
        return sum(self._chunk_bytes(c) for c in range(self.n_chunks))

    # ------------------------------------------------------------ serving
    def _touched(self, idx: torch.Tensor) -> Tuple[int, int, List[int]]:
        """The batch's min and max rank and its touched chunks, ascending:
        a few ops on the device and one host sync.  Ranks out of range are
        clamped here; the caller raises on them."""
        chunk = torch.div(idx.clamp(0, self.n_states - 1), self.chunk_elems,
                          rounding_mode="floor")
        flags = torch.zeros(self.n_chunks, dtype=torch.int64,
                            device=idx.device).index_fill_(0, chunk, 1)
        lo, hi = torch.aminmax(idx)
        got = torch.cat((lo.view(1), hi.view(1), flags)).tolist()
        return got[0], got[1], [c for c, f in enumerate(got[2:]) if f]

    def _groups(self, touched: List[int]) -> List[List[int]]:
        """The touched chunks cut into ascending runs whose bytes fit the
        cache budget; a chunk larger than the budget is a run of its own."""
        groups, size = [], 0
        for c in touched:
            nbytes = self._chunk_bytes(c)
            if not groups or size + nbytes > self.cache.budget:
                groups.append([])
                size = 0
            groups[-1].append(c)
            size += nbytes
        return groups

    def codes(self, ranks) -> torch.Tensor:
        """Batched raw mod-3 codes (0 = unreached) for int64 ranks, as
        uint8 on the oracle's device.  One cache lookup per distinct chunk
        in ascending chunk order, and one K4 launch per group of chunks
        that fits the cache budget: one a batch when the budget holds the
        artifact."""
        idx = self._ranks(ranks)
        with _STATS_LOCK:
            STATS["lookups"] += int(idx.numel())
            STATS["batches"] += 1
        out = torch.empty(idx.shape, dtype=torch.uint8, device=self.device)
        if idx.numel() == 0:
            return out
        lo, hi, touched = self._touched(idx)
        if lo < 0 or hi >= self.n_states:
            raise ValueError(f"rank out of range [0, {self.n_states}) in "
                             "oracle query")
        stream = (torch.cuda.current_stream(self.device)
                  if self.device.type == "cuda" else None)
        for group in self._groups(touched):
            # The table holds the group's chunks until K4 is enqueued: an
            # evicted chunk's memory goes back to the caching allocator,
            # and only stream order keeps it from reuse while K4 reads it.
            # A chunk loaded on another stream is recorded on this one.
            table: List[Optional[torch.Tensor]] = [None] * self.n_chunks
            for c in group:
                table[c] = self.cache.get(c).words
                if stream is not None:
                    table[c].record_stream(stream)
            K.bitpack_gather2_chunked(table, self.chunk_elems, idx, out)
        return out

    def close(self) -> None:
        self.cache.close()


# =========================================================== ShardedOracle
class ShardedOracle(_Serving):
    """Shard-aware front: bins query batches by ``block_owner`` and fans
    them to per-shard :class:`DistanceOracle` caches.

    Every shard opens the same sealed artifact; sharding partitions CACHE
    LOCALITY, not data.  The per-shard budget is ``cache_bytes //
    nshards``.  Opening validates the published owner-function goldens for
    ``nshards`` when META pinned them.
    """

    def __init__(self, root: str, nshards: int, cache_bytes: int = 1 << 20,
                 version: Optional[int] = None,
                 gen_neighbors: Optional[Callable] = None, device=None):
        if nshards < 1:
            raise ValueError("nshards must be >= 1")
        self.nshards = int(nshards)
        self.gen_neighbors = gen_neighbors
        per = max(1, int(cache_bytes) // self.nshards)
        self.shards = [DistanceOracle(root, cache_bytes=per, version=version,
                                      gen_neighbors=gen_neighbors,
                                      device=device)
                       for _ in range(self.nshards)]
        first = self.shards[0]
        meta = first.meta
        self.device = first.device
        self.n_states = first.n_states
        self.start = first.start
        self.max_dist = first.max_dist
        self.level_sizes = first.level_sizes
        golden = meta.get("owner_golden", {}).get(str(self.nshards))
        if golden is not None:
            got = block_owner(meta["owner_probe"], self.n_states,
                              self.nshards).tolist()
            if got != golden:
                raise OracleError(
                    f"block owner function for nshards={self.nshards} "
                    f"disagrees with the published golden values "
                    f"({got} != {golden}) — routing would silently "
                    "misdirect queries")

    def codes(self, ranks) -> torch.Tensor:
        idx = self._ranks(ranks)
        out = torch.zeros(idx.shape, dtype=torch.uint8, device=self.device)
        if idx.numel() == 0:
            return out
        self._check_range(idx)     # the reference routes them nowhere
        own = block_owner(idx, self.n_states, self.nshards).to(torch.int64)
        order = torch.argsort(own, stable=True)
        counts = torch.bincount(own, minlength=self.nshards).tolist()
        first = 0
        for s, k in enumerate(counts):
            if k:
                sel = order[first:first + k]
                first += k
                out[sel] = self.shards[s].codes(idx[sel])
        return out

    def close(self) -> None:
        for sh in self.shards:
            sh.close()
