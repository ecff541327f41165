"""DiskHashTable — the paper's RoomyHashTable on real disk (Tier D): the
port's own copy of ``repro/core/disk/dhash.py``, on the host in numpy.

(key, value) pairs are bucketed by ``hash(key) % nbuckets`` into per-bucket
files kept sorted by key; delayed inserts/updates/removes append to
per-bucket op logs. ``sync`` merges each bucket's log into its table file in
one pass — the same sorted merge Tier J's hashtable.py performs on device.
"""
from __future__ import annotations

import os
import shutil
import uuid
from typing import Callable

import numpy as np

# The canonical numpy row hash (buckets.py) — the sharded runtime buckets
# keys with the SAME function, so a key's table bucket and its owner shard
# are derived from one hash definition, pinned by golden-value tests.
from .buckets import hash_rows_np as _hash_rows


def _keycols(kw: int):
    return [f"k{j}" for j in range(kw)]


class DiskHashTable:
    OP_PUT, OP_DEL = 0, 1

    def __init__(self, workdir: str, key_width: int, val_width: int,
                 nbuckets: int = 64, name: str | None = None):
        self.kw, self.vw = key_width, val_width
        self.nbuckets = nbuckets
        name = name or f"dhash_{uuid.uuid4().hex[:8]}"
        self.path = os.path.join(workdir, name)
        if os.path.isdir(self.path):
            shutil.rmtree(self.path)
        os.makedirs(self.path)
        self._logs = [[] for _ in range(nbuckets)]

    def _tab_path(self, b):
        return os.path.join(self.path, f"t{b:04d}.npz")

    # ------------------------------------------------------ delayed ops
    def _queue(self, keys, vals, op):
        keys = np.asarray(keys, np.uint32).reshape(-1, self.kw)
        vals = np.asarray(vals, np.int64).reshape(keys.shape[0], self.vw)
        ops = np.full(keys.shape[0], op, np.int64)
        b = _hash_rows(keys) % np.uint32(self.nbuckets)
        order = np.argsort(b, kind="stable")
        keys, vals, ops, b = keys[order], vals[order], ops[order], b[order]
        bounds = np.searchsorted(b, np.arange(self.nbuckets + 1))
        for i in range(self.nbuckets):
            lo, hi = bounds[i], bounds[i + 1]
            if hi > lo:
                self._logs[i].append((keys[lo:hi], vals[lo:hi], ops[lo:hi]))

    def insert(self, keys, vals):
        self._queue(keys, vals, self.OP_PUT)

    def remove(self, keys):
        self._queue(keys, np.zeros((np.asarray(keys).reshape(-1, self.kw).shape[0],
                                    self.vw), np.int64), self.OP_DEL)

    # -------------------------------------------------------------- sync
    def _load_bucket(self, b):
        if os.path.exists(self._tab_path(b)):
            z = np.load(self._tab_path(b))
            return z["keys"], z["vals"]
        return (np.zeros((0, self.kw), np.uint32),
                np.zeros((0, self.vw), np.int64))

    def sync(self, combine: Callable = None, apply: Callable = None) -> None:
        """combine(v1, v2) merges queued payloads per key; apply(old, agg,
        present_mask) produces the stored value. Defaults: overwrite.

        Op-log ORDER is honoured per key (the queue's stable sort keeps
        issue order within a key): a DEL wipes the key *and every earlier
        queued PUT*, and PUTs after the last DEL resurrect the key — their
        combine-fold applies against ``present=False`` (the old value is
        gone). A key whose last op is DEL is removed. This is exactly
        sequential execution of the log; Tier J's hashtable.py applies the
        same rule (TestRoomyHashTableOpOrder mirrors the pins here).
        """
        if combine is None:
            combine = lambda a, b: b
        if apply is None:
            apply = lambda old, agg, present: agg
        for b in range(self.nbuckets):
            if not self._logs[b]:
                continue
            qk = np.concatenate([x[0] for x in self._logs[b]], axis=0)
            qv = np.concatenate([x[1] for x in self._logs[b]], axis=0)
            qo = np.concatenate([x[2] for x in self._logs[b]], axis=0)
            self._logs[b] = []
            tk, tv = self._load_bucket(b)

            # sort queue by key (stable keeps op order within key)
            from .extsort import row_keys
            order = np.argsort(row_keys(qk), kind="stable")
            qk, qv, qo = qk[order], qv[order], qo[order]
            kk = row_keys(qk)
            starts = np.ones(kk.shape[0], bool)
            starts[1:] = kk[1:] != kk[:-1]
            seg = np.cumsum(starts) - 1
            nseg = int(starts.sum())
            uniq_k = qk[starts]
            run_pos = np.arange(kk.shape[0]) - np.maximum.accumulate(
                np.where(starts, np.arange(kk.shape[0]), 0))
            # Position of each key's last DEL (-1 if none): PUTs strictly
            # after it are "live"; everything at or before it is wiped.
            is_del = qo == self.OP_DEL
            last_del = np.full(nseg, -1, np.int64)
            np.maximum.at(last_del, seg, np.where(is_del, run_pos, -1))
            had_del = last_del >= 0
            live_op = (~is_del) & (run_pos > last_del[seg])
            # A key with no surviving PUT is deleted (it must have a DEL:
            # no-DEL keys keep all their PUTs).
            deleted = np.bincount(seg, weights=live_op.astype(np.int64),
                                  minlength=nseg) == 0
            # combine-fold over the live PUTs only, in issue order.
            from .extsort import segment_combine_ordered
            agg = np.zeros_like(qv[:nseg])
            if live_op.any():
                uniq_seg, agg_l = segment_combine_ordered(
                    seg[live_op], qv[live_op], combine)
                agg[uniq_seg] = agg_l

            # merge with table bucket
            tkk = row_keys(tk) if tk.shape[0] else np.zeros(0, row_keys(uniq_k).dtype)
            ukk = row_keys(uniq_k)
            pos = np.searchsorted(tkk, ukk)
            present = np.zeros(ukk.shape[0], bool)
            inb = pos < tkk.shape[0]
            present[inb] = tkk[pos[inb]] == ukk[inb]
            # A DEL before the surviving PUTs wiped the stored value: the
            # resurrecting fold applies as an insert, not an update.
            present_eff = present & ~had_del
            old = np.zeros_like(agg)
            old[present_eff] = tv[pos[present_eff]]
            newv = apply(old, agg, present_eff)

            keep_tab = np.ones(tk.shape[0], bool)
            keep_tab[pos[present]] = False       # replaced or deleted
            live = ~deleted
            mk = np.concatenate([tk[keep_tab], uniq_k[live]], axis=0)
            mv = np.concatenate([tv[keep_tab], newv[live]], axis=0)
            o2 = np.argsort(row_keys(mk), kind="stable")
            np.savez(self._tab_path(b), keys=mk[o2], vals=mv[o2])

    # ------------------------------------------------------------- read
    def lookup(self, keys):
        keys = np.asarray(keys, np.uint32).reshape(-1, self.kw)
        from .extsort import row_keys
        out = np.zeros((keys.shape[0], self.vw), np.int64)
        found = np.zeros(keys.shape[0], bool)
        b = _hash_rows(keys) % np.uint32(self.nbuckets)
        for bb in np.unique(b):
            sel = b == bb
            tk, tv = self._load_bucket(int(bb))
            if not tk.shape[0]:
                continue
            tkk, qkk = row_keys(tk), row_keys(keys[sel])
            pos = np.searchsorted(tkk, qkk)
            inb = pos < tkk.shape[0]
            hit = np.zeros(qkk.shape[0], bool)
            hit[inb] = tkk[pos[inb]] == qkk[inb]
            idx = np.where(sel)[0]
            found[idx[hit]] = True
            out[idx[hit]] = tv[pos[hit]]
        return out, found

    def size(self) -> int:
        n = 0
        for b in range(self.nbuckets):
            tk, _ = self._load_bucket(b)
            n += tk.shape[0]
        return n

    def items(self):
        for b in range(self.nbuckets):
            tk, tv = self._load_bucket(b)
            if tk.shape[0]:
                yield tk, tv

    def destroy(self) -> None:
        shutil.rmtree(self.path, ignore_errors=True)
