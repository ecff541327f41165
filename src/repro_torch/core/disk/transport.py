"""Pluggable bucket transports — how sealed buckets travel between shards:
the port's own copy of ``repro/core/disk/transport.py``, the same wires,
frames, files and counters.  Rows stay numpy on the host.

The paper's cluster model (§2–3) promises that "all aspects of
parallelism and remote I/O are hidden within the library": a delayed
operation is routed to the shard that owns its target and applied there
at sync, and the *wire* those operations ride is an implementation
detail.  This module makes the wire a real interface.  The contracts
every backend preserves:

  atomic publish     a receiver sees an epoch's bucket either complete or
                     not at all; a sender killed mid-epoch leaves only
                     ignorable strays (``.tmp`` files, half-written
                     socket frames, unpublished in-memory buffers).
  exact overflow     rows past a destination's per-epoch capacity are
                     dropped AND counted, never silently
                     (:class:`~.buckets.BucketSender`).
  ascending-src apply in barrier mode (and ordered pipelined mode) a
                     destination consumes sources in ascending id order —
                     the deterministic sequencing the sharded hash
                     table's per-key op order relies on.
  stray cleanup      a fresh runtime can always sweep what a killed run
                     left behind, and books what it swept.

Backends (selected via ``ClusterConfig(transport=...)``):

  fs        the shared-filesystem layout of ``buckets.py`` — the default,
            byte-compatible on disk with the pre-transport protocol in
            barrier mode (pipelined mode adds ``.done`` markers).
  tcp       length-prefixed frames over sockets, one receiver thread per
            shard: spawn workers exchange buckets with NO shared exchange
            directory (the real multi-host shape).  Spills spool to the
            worker's private node-local scratch, never a shared path.
  loopback  an in-process mailbox for the thread-parallel ``inline``
            mode: zero file I/O on the exchange path, senders publish
            byte payloads straight into the shared store.

Pipelined exchange (``ClusterConfig(exchange="pipelined")``) overlaps
produce and apply: a worker seals with completion markers and its peers
begin absorbing its buckets while slower shards are still expanding —
the only barrier left is the level boundary.  ``recv(..., live=True)``
is that incremental consumption; ``ordered=True`` preserves the
ascending-src apply order where per-key sequencing demands it.

See docs/transports.md for the backend matrix and the full contract.
"""
from __future__ import annotations

import os
import shutil
import socket
import struct
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from .. import obs
from . import faults
from . import codec as _codec
from .buckets import (TRANSPORT_STATS, BucketSender, BucketWriter,
                      _bucket_name, _done_name, cleanup_strays,
                      iter_incoming)

__all__ = ["Transport", "TransportAborted", "FsTransport", "TcpTransport",
           "LoopbackTransport", "LoopbackStore", "make_transport",
           "TRANSPORT_KINDS"]

TRANSPORT_KINDS = ("fs", "tcp", "loopback")

_POLL = 0.02              # seconds between stray polls / cond waits


class TransportAborted(RuntimeError):
    """A live recv was unblocked by the runtime's abort flag — a PEER
    failed, not this shard.  Distinct so the threaded map can prefer the
    original failure (which carries shard/site attribution) over the
    secondary aborts it caused."""


class Transport:
    """One shard's view of the bucket wire.

    Every process (each worker plus the coordinator, which sends as
    source id ``nshards``) holds exactly one instance per runtime.  The
    surface the runtime drives:

      sender(spec)     a fresh :class:`~.buckets.BucketSender` for one
                       structure (the runtime caches it per name).
      recv(spec, epoch, srcs, live=, ordered=)
                       stream (src, rows) pairs addressed to this shard.
                       Barrier mode (``live=False``) yields only after
                       every source in ``srcs`` sealed, ascending src.
                       Pipelined mode (``live=True``) yields each source
                       as soon as its completion marker lands;
                       ``ordered=True`` still consumes ascending.
      handshake()/connect(peers)
                       address exchange for backends with real endpoints
                       (tcp); no-ops elsewhere.
      startup(fresh)/wipe(name)/wipe_all()/close()
                       lifecycle: stray sweep or full wipe at runtime
                       construction, per-structure wipe at destroy and
                       rollback (in-flight buckets of a failed epoch are
                       dead traffic), teardown.
    """

    kind = "abstract"

    #: True when receivers on this wire WAIT for every source's sealed
    #: flag (mailbox semantics) — every source must then seal every
    #: epoch, even an empty one.  False for the fs wire's barrier mode,
    #: where absence of a bucket file IS the empty bucket (and where an
    #: unforced seal would adopt a killed peer's stray ``.tmp``).
    explicit_completion = True

    def __init__(self, root: str, me: int, nshards: int,
                 abort: Optional[threading.Event] = None,
                 timeout: float = 600.0, wire_compress: bool = False):
        self.root = root
        self.me = int(me)
        self.nshards = int(nshards)
        self.abort = abort
        self.timeout = timeout
        # Mailbox wires only: zlib-frame sealed payloads at publish.
        # Receivers ALWAYS auto-detect (wire_decode passes plain payloads
        # through), so the flag is a sender-side choice and mixed
        # sender/receiver configurations interoperate.
        self.wire_compress = bool(wire_compress)

    # ------------------------------------------------------------- sending
    def sender(self, spec: dict) -> BucketSender:
        raise NotImplementedError

    # ----------------------------------------------------------- receiving
    def recv(self, spec: dict, epoch: int,
             srcs: Optional[Tuple[int, ...]] = None, *, live: bool = False,
             ordered: bool = True, timeout: Optional[float] = None
             ) -> Iterator[Tuple[int, np.ndarray]]:
        raise NotImplementedError

    # ------------------------------------------------------------ topology
    def handshake(self):
        """This shard's receive endpoint, or None for endpoint-free
        backends.  Called once per (re)spawn, before any seal."""
        return None

    def connect(self, peers: dict) -> None:
        """Install the peer endpoint map from the coordinator's
        handshake round (``{shard: endpoint}``)."""

    # ----------------------------------------------------------- lifecycle
    def startup(self, fresh: bool) -> None:
        """Coordinator-side stray policy at runtime construction:
        ``fresh=True`` discards ALL queued exchange traffic, otherwise
        only ignorable strays are swept (and booked)."""

    def wipe(self, name: str) -> None:
        """Discard every queued/sealed bucket of one structure."""

    def wipe_all(self) -> None:
        raise NotImplementedError

    def close(self) -> None:
        """Release sockets/threads.  Idempotent."""

    # ------------------------------------------------------------- helpers
    def _check_abort(self) -> None:
        if self.abort is not None and self.abort.is_set():
            raise TransportAborted(
                f"{self.kind} transport: recv aborted (runtime recovering)")


# =============================================================== shared FS

class FsTransport(Transport):
    """The paper-original shared-filesystem wire (buckets.py).

    Barrier mode is byte-identical on disk to the pre-transport protocol:
    ``.tmp`` in-flight files, epoch-stamped sealed files, absence = empty
    bucket.  Pipelined mode adds per-(src,dst) ``.done`` markers written
    strictly after the data rename, so a receiver polls markers and
    consumes sources incrementally."""

    kind = "fs"
    explicit_completion = False

    def _dir(self, name: str) -> str:
        return os.path.join(self.root, "exchange", name)

    def sender(self, spec: dict) -> BucketWriter:
        return BucketWriter(self._dir(spec["name"]), src=self.me,
                            nshards=self.nshards, width=spec["rec_width"],
                            dtype=spec["rec_dtype"],
                            capacity=spec.get("capacity"))

    def recv(self, spec, epoch, srcs=None, *, live=False, ordered=True,
             timeout=None):
        root = self._dir(spec["name"])
        if not live:
            return self._recv_barrier(spec, root, epoch)
        assert srcs is not None, "pipelined recv needs explicit sources"
        return self._recv_live(spec, root, epoch, srcs, ordered,
                               timeout or self.timeout)

    def _recv_barrier(self, spec, root, epoch):
        # Exactly the legacy scan: whatever is sealed for this epoch IS
        # the epoch's traffic (the completed seal map was the barrier).
        with obs.span("bucket.recv", epoch=epoch, dst=self.me,
                      transport="fs"):
            for src, rows in iter_incoming(root, self.me, epoch,
                                           spec["rec_width"],
                                           spec["rec_dtype"]):
                obs.add(TRANSPORT_STATS, "fs_bytes_in", rows.nbytes)
                obs.add(TRANSPORT_STATS, "fs_buckets_in", 1)
                yield src, rows

    def _recv_live(self, spec, root, epoch, srcs, ordered, timeout):
        dt = np.dtype(spec["rec_dtype"])
        width = spec["rec_width"]
        pending = sorted(set(srcs))
        deadline = time.monotonic() + timeout
        with obs.span("bucket.recv", epoch=epoch, dst=self.me,
                      transport="fs", live=True):
            while pending:
                ready: List[int] = []
                for src in list(pending):
                    marker = os.path.join(root,
                                          _done_name(epoch, src, self.me))
                    if os.path.exists(marker):
                        ready.append(src)
                    elif ordered:
                        break      # ascending-src order: wait for this one
                for src in ready:
                    path = os.path.join(root,
                                        _bucket_name(epoch, src, self.me))
                    if os.path.exists(path):
                        raw = np.fromfile(path, dtype=dt)
                        assert raw.size % width == 0, \
                            f"torn bucket file {path}"
                        # Consume BEFORE yielding (matching the mailbox
                        # wires' take-then-yield): an abandoned receiver
                        # must not leave the payload re-deliverable.
                        os.remove(path)
                        obs.add(TRANSPORT_STATS, "fs_bytes_in", raw.nbytes)
                        obs.add(TRANSPORT_STATS, "fs_buckets_in", 1)
                        yield src, raw.reshape(-1, width)
                    pending.remove(src)
                if not pending:
                    break
                if ready:          # progress resets the straggler clock
                    deadline = time.monotonic() + timeout
                    continue
                self._check_abort()
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"fs transport: shard {self.me} timed out waiting "
                        f"for sources {pending} (epoch {epoch}, "
                        f"{spec['name']})")
                time.sleep(_POLL)

    def startup(self, fresh: bool) -> None:
        exch = os.path.join(self.root, "exchange")
        if fresh and os.path.isdir(exch):
            shutil.rmtree(exch)
        os.makedirs(exch, exist_ok=True)
        for sub in sorted(os.listdir(exch)):
            cleanup_strays(os.path.join(exch, sub))

    def wipe(self, name: str) -> None:
        shutil.rmtree(self._dir(name), ignore_errors=True)

    def wipe_all(self) -> None:
        exch = os.path.join(self.root, "exchange")
        shutil.rmtree(exch, ignore_errors=True)
        os.makedirs(exch, exist_ok=True)


# ================================================================= mailbox

class _Mailbox:
    """Sealed-bucket store shared by the socket and loopback wires:
    payload bytes plus per-(structure, epoch, dst) sealed-source flags,
    guarded by one condition variable.  Payloads are consumed exactly
    once; sealed flags persist until the structure is wiped, so a second
    recv of a drained epoch yields nothing instead of hanging."""

    def __init__(self):
        self.cond = threading.Condition()
        self._payloads: Dict[tuple, List[Tuple[int, bytes]]] = {}
        self._sealed: Dict[tuple, set] = {}

    def publish(self, name: str, epoch: int, src: int,
                dst_payloads: Dict[int, bytes], dsts) -> None:
        with self.cond:
            for dst, data in dst_payloads.items():
                # Replace, don't append: a sender retry re-publishes the
                # same bytes, and last-write-wins keeps that idempotent.
                lst = self._payloads.setdefault((name, epoch, dst), [])
                lst[:] = [(s, d) for s, d in lst if s != src]
                lst.append((src, data))
            for dst in dsts:
                self._sealed.setdefault((name, epoch, dst), set()).add(src)
            self.cond.notify_all()

    def sealed_set(self, name: str, epoch: int, dst: int) -> set:
        return self._sealed.get((name, epoch, dst), set())

    def take(self, name: str, epoch: int, dst: int, src: int) -> List[bytes]:
        lst = self._payloads.get((name, epoch, dst))
        if not lst:
            return []
        out = [data for s, data in lst if s == src]
        lst[:] = [(s, data) for s, data in lst if s != src]
        return out

    def wipe(self, name: Optional[str] = None) -> None:
        with self.cond:
            for d in (self._payloads, self._sealed):
                for k in [k for k in d if name is None or k[0] == name]:
                    del d[k]
            self.cond.notify_all()


def _mailbox_recv(box: _Mailbox, kind: str, spec: dict, epoch: int, dst: int,
                  srcs, live: bool, ordered: bool, timeout: float,
                  check_abort) -> Iterator[Tuple[int, np.ndarray]]:
    """The shared consumption loop over a :class:`_Mailbox`: barrier mode
    waits for every source's sealed flag then yields ascending; live mode
    yields each source as its flag lands (ascending when ``ordered``)."""
    dt = np.dtype(spec["rec_dtype"])
    width = spec["rec_width"]
    name = spec["name"]
    pending = sorted(set(srcs))
    deadline = time.monotonic() + timeout
    with obs.span("bucket.recv", epoch=epoch, dst=dst, transport=kind,
                  live=live):
        while pending:
            got: List[Tuple[int, List[bytes]]] = []
            with box.cond:
                while True:
                    check_abort()
                    sealed = box.sealed_set(name, epoch, dst)
                    if live and not ordered:
                        avail = [s for s in pending if s in sealed]
                    elif live:
                        avail = []
                        for s in pending:
                            if s not in sealed:
                                break
                            avail.append(s)
                    else:
                        avail = (list(pending)
                                 if all(s in sealed for s in pending)
                                 else [])
                    if avail:
                        for s in avail:
                            got.append((s, box.take(name, epoch, dst, s)))
                            pending.remove(s)
                        break
                    if time.monotonic() >= deadline:
                        raise TimeoutError(
                            f"{kind} transport: shard {dst} timed out "
                            f"waiting for sources {pending} (epoch "
                            f"{epoch}, {name})")
                    box.cond.wait(_POLL)
            for s, payloads in got:
                for data in payloads:
                    # Wire bytes are what traveled (possibly compressed);
                    # wire_decode auto-detects and books the raw/stored
                    # ratio in the codec ledger under tag "transport".
                    wire_len = len(data)
                    data = _codec.wire_decode(data)
                    raw = np.frombuffer(data, dtype=dt)
                    assert raw.size % width == 0, "torn bucket payload"
                    obs.add(TRANSPORT_STATS, f"{kind}_bytes_in", wire_len)
                    obs.add(TRANSPORT_STATS, f"{kind}_buckets_in", 1)
                    yield s, raw.reshape(-1, width)
            deadline = time.monotonic() + timeout


# ================================================================ loopback

class LoopbackStore(_Mailbox):
    """The shared in-process mailbox of a loopback runtime — one instance
    per :class:`~.cluster.ShardRuntime`, handed to every inline context's
    transport.  Lives entirely in RAM: the thread-parallel inline mode's
    exchange path does zero file I/O."""


class _LoopbackSender(BucketSender):
    """Sender half of the loopback wire: spills accumulate in per-dst
    byte buffers (truncate-on-retry, so the ``bucket_spill`` fault site
    keeps its idempotence contract), seal publishes them into the shared
    store in one atomic (lock-held) step."""

    kind = "loopback"

    def __init__(self, store: LoopbackStore, name: str, src: int,
                 nshards: int, width: int, dtype="int64",
                 capacity: Optional[int] = None, buf_rows: int = 1 << 15,
                 wire_compress: bool = False):
        super().__init__(src, nshards, width, dtype=dtype,
                         capacity=capacity, buf_rows=buf_rows)
        self._store = store
        self._name = name
        self._wire_compress = wire_compress
        self._pend: List[bytearray] = [bytearray() for _ in range(nshards)]

    def _append(self, dst: int, data: bytes) -> None:
        buf = self._pend[dst]
        pre = len(buf)

        def _do(buf=buf, pre=pre, data=data):
            del buf[pre:]          # truncate-on-retry: never duplicates
            buf.extend(data)
        faults.retry_io("bucket_spill", _do, shard=self.src, dst=dst)

    def _publish(self, epoch: int, publish_done: bool) -> None:
        # The sealed flag IS the completion marker on this wire, published
        # in both modes (a mailbox receiver cannot scan for absence).
        payloads = {d: (_codec.wire_encode(bytes(b)) if self._wire_compress
                        else bytes(b))
                    for d, b in enumerate(self._pend) if b}

        def _do():
            self._store.publish(self._name, epoch, self.src, payloads,
                                range(self.nshards))
        faults.retry_io("bucket_seal", _do, shard=self.src)
        self._pend = [bytearray() for _ in range(self.nshards)]


class LoopbackTransport(Transport):
    """In-process mailbox wire for thread-parallel ``inline`` mode.

    Requires every shard to live in one process (the store is a shared
    Python object): ``ClusterConfig`` validation rejects
    ``transport="loopback"`` with ``mode="spawn"`` loudly."""

    kind = "loopback"

    def __init__(self, root, me, nshards, store: LoopbackStore,
                 abort=None, timeout: float = 600.0,
                 wire_compress: bool = False):
        super().__init__(root, me, nshards, abort=abort, timeout=timeout,
                         wire_compress=wire_compress)
        self.store = store

    def sender(self, spec: dict) -> _LoopbackSender:
        return _LoopbackSender(self.store, spec["name"], src=self.me,
                               nshards=self.nshards,
                               width=spec["rec_width"],
                               dtype=spec["rec_dtype"],
                               capacity=spec.get("capacity"),
                               wire_compress=self.wire_compress)

    def recv(self, spec, epoch, srcs=None, *, live=False, ordered=True,
             timeout=None):
        assert srcs is not None, \
            "loopback recv needs explicit sources (nothing to scan)"
        return _mailbox_recv(self.store, "loopback", spec, epoch, self.me,
                             srcs, live, ordered, timeout or self.timeout,
                             self._check_abort)

    def startup(self, fresh: bool) -> None:
        if fresh:
            self.store.wipe()

    def wipe(self, name: str) -> None:
        self.store.wipe(name)

    def wipe_all(self) -> None:
        self.store.wipe()


# ===================================================================== tcp

# Frame header: magic | kind | src | epoch | name-length | payload-length.
# DATA frames carry one destination's complete sealed bucket; a SEALED
# frame is the epoch completion marker (payload-length 0).  A connection
# that dies mid-frame is discarded whole — the receiver records nothing
# for a partial frame, which is exactly the killed-writer guarantee the
# ``.tmp`` discipline gives the fs wire.
_MAGIC = b"RMYB"
_DATA, _SEALED = 0, 1
_HEADER = struct.Struct("<4sBiqHQ")


def _frame(kind: int, src: int, epoch: int, name: str,
           payload: bytes) -> bytes:
    nb = name.encode()
    return _HEADER.pack(_MAGIC, kind, src, epoch, len(nb),
                        len(payload)) + nb + payload


def _recv_exact(conn: socket.socket, n: int) -> Optional[bytes]:
    """Read exactly n bytes, or None on a short read (dead sender)."""
    chunks = []
    while n:
        try:
            b = conn.recv(min(n, 1 << 20))
        except OSError:
            return None
        if not b:
            return None
        chunks.append(b)
        n -= len(b)
    return b"".join(chunks)


class _TcpReceiver(threading.Thread):
    """One listening socket per shard; every inbound connection is framed
    into the shard's mailbox.  Partial/garbage frames are dropped with
    the connection (killed-writer safety); daemon threads, so a killed
    worker process takes its receiver with it."""

    def __init__(self, host: str, me: int):
        super().__init__(daemon=True, name="bucket-tcp-recv")
        self.me = int(me)
        self.box = _Mailbox()
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((host, 0))
        self._lsock.listen(64)
        self.addr = self._lsock.getsockname()
        self._closed = False
        self.start()

    def run(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._lsock.accept()
            except OSError:
                return                    # listener closed: shut down
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn: socket.socket) -> None:
        with conn:
            while True:
                head = _recv_exact(conn, _HEADER.size)
                if head is None:
                    return
                magic, kind, src, epoch, nlen, plen = _HEADER.unpack(head)
                if magic != _MAGIC:
                    return                # garbage stream: drop it whole
                name_b = _recv_exact(conn, nlen)
                if name_b is None:
                    return
                payload = b""
                if plen:
                    payload = _recv_exact(conn, plen)
                    if payload is None:
                        return            # torn frame: record NOTHING
                name = name_b.decode()
                if kind == _DATA:
                    self.box.publish(name, epoch, src,
                                     {self.me: payload}, ())
                elif kind == _SEALED:
                    self.box.publish(name, epoch, src, {}, (self.me,))

    def close(self) -> None:
        self._closed = True
        try:
            self._lsock.close()
        except OSError:
            pass


class _TcpSender(BucketSender):
    """Sender half of the socket wire.  Spills spool to the worker's
    private node-local scratch (same truncate-on-retry append as the fs
    ``.tmp`` files — ``bucket_spill`` keeps its fault semantics); seal
    streams each destination's spool as ONE framed message followed by
    the SEALED marker, over a fresh connection per destination.  A retry
    reconnects, so a partial earlier attempt is discarded by the receiver
    with its dead connection — never duplicated."""

    kind = "tcp"

    def __init__(self, transport: "TcpTransport", name: str, src: int,
                 nshards: int, width: int, dtype="int64",
                 capacity: Optional[int] = None, buf_rows: int = 1 << 15):
        super().__init__(src, nshards, width, dtype=dtype,
                         capacity=capacity, buf_rows=buf_rows)
        self._transport = transport
        self._name = name
        self._scratch = os.path.join(transport.scratch, name)
        os.makedirs(self._scratch, exist_ok=True)

    def _tmp_path(self, dst: int) -> str:
        return os.path.join(self._scratch,
                            f"s{self.src:03d}_d{dst:03d}.bin.tmp")

    def _append(self, dst: int, data: bytes) -> None:
        faults.append_bytes("bucket_spill", self._tmp_path(dst), data,
                            shard=self.src, dst=dst)

    def _publish(self, epoch: int, publish_done: bool) -> None:
        # The SEALED frame is this wire's completion marker, sent to every
        # destination in both modes (a socket receiver cannot scan for
        # absence the way the fs reader does).
        peers = self._transport.peers
        assert peers is not None, \
            "tcp transport: seal before the handshake/connect round"
        for d in range(self.nshards):
            tmp = self._tmp_path(d)
            payload = b""
            if os.path.exists(tmp):
                with open(tmp, "rb") as f:
                    payload = f.read()
            if payload and self._transport.wire_compress:
                payload = _codec.wire_encode(payload)

            def _send(d=d, payload=payload, epoch=epoch):
                with socket.create_connection(
                        tuple(peers[d]), timeout=30.0) as s:
                    if payload:
                        s.sendall(_frame(_DATA, self.src, epoch,
                                         self._name, payload))
                    s.sendall(_frame(_SEALED, self.src, epoch,
                                     self._name, b""))
            faults.retry_io("bucket_seal", _send, shard=self.src, dst=d)
            if payload:
                os.remove(tmp)


class TcpTransport(Transport):
    """Socket wire: spawn workers exchange buckets over TCP streams with
    no shared exchange directory.  Each shard runs one receiver thread
    bound to ``(host, 0)``; the coordinator collects the addresses in a
    handshake round after every (re)spawn and broadcasts the peer map
    before any seal."""

    kind = "tcp"

    def __init__(self, root, me, nshards, host: str = "127.0.0.1",
                 abort=None, timeout: float = 600.0,
                 wire_compress: bool = False):
        super().__init__(root, me, nshards, abort=abort, timeout=timeout,
                         wire_compress=wire_compress)
        self.host = host
        self.peers: Optional[Dict[int, tuple]] = None
        # Node-local spool for pre-seal spills: under THIS shard's private
        # directory, never a shared exchange path.
        self.scratch = os.path.join(root, f"shard{me:03d}", "_spool")
        if os.path.isdir(self.scratch):
            for sub in sorted(os.listdir(self.scratch)):
                cleanup_strays(os.path.join(self.scratch, sub))
        self._receiver = _TcpReceiver(host, me)

    def sender(self, spec: dict) -> _TcpSender:
        return _TcpSender(self, spec["name"], src=self.me,
                          nshards=self.nshards, width=spec["rec_width"],
                          dtype=spec["rec_dtype"],
                          capacity=spec.get("capacity"))

    def recv(self, spec, epoch, srcs=None, *, live=False, ordered=True,
             timeout=None):
        assert srcs is not None, \
            "tcp recv needs explicit sources (nothing to scan)"
        return _mailbox_recv(self._receiver.box, "tcp", spec, epoch,
                             self.me, srcs, live, ordered,
                             timeout or self.timeout, self._check_abort)

    def handshake(self):
        return self._receiver.addr

    def connect(self, peers: dict) -> None:
        self.peers = {int(k): tuple(v) for k, v in peers.items()}

    def startup(self, fresh: bool) -> None:
        if fresh:
            self._receiver.box.wipe()

    def wipe(self, name: str) -> None:
        self._receiver.box.wipe(name)
        shutil.rmtree(os.path.join(self.scratch, name), ignore_errors=True)

    def wipe_all(self) -> None:
        self._receiver.box.wipe()
        shutil.rmtree(self.scratch, ignore_errors=True)

    def close(self) -> None:
        self._receiver.close()


# ================================================================= factory

def make_transport(tspec: dict, me: int, nshards: int, root: str,
                   abort: Optional[threading.Event] = None,
                   store: Optional[LoopbackStore] = None,
                   timeout: float = 600.0) -> Transport:
    """Build one shard's transport from its picklable spec
    (``{"kind": ..., "host": ...}`` — what crosses the spawn queue)."""
    kind = tspec.get("kind", "fs")
    wire_compress = bool(tspec.get("wire_compress", False))
    if kind == "fs":
        if wire_compress:
            raise ValueError(
                "wire_compress=True needs a mailbox wire (tcp/loopback) — "
                "the fs bucket layout is a byte-compatibility contract")
        return FsTransport(root, me, nshards, abort=abort, timeout=timeout)
    if kind == "tcp":
        return TcpTransport(root, me, nshards,
                            host=tspec.get("host", "127.0.0.1"),
                            abort=abort, timeout=timeout,
                            wire_compress=wire_compress)
    if kind == "loopback":
        if store is None:
            raise ValueError(
                "transport='loopback' needs the runtime's shared in-process "
                "store — it only works with mode='inline' (spawn workers "
                "live in other processes)")
        return LoopbackTransport(root, me, nshards, store, abort=abort,
                                 timeout=timeout,
                                 wire_compress=wire_compress)
    raise ValueError(
        f"unknown transport kind {kind!r} (choose from {TRANSPORT_KINDS})")
