"""Streaming pass planner (Tier D) — one traversal, many stages: the port's
own copy of ``repro/core/disk/passes.py``.

Invariant: a pass applies exactly the updates queued strictly BEFORE it
opened (op logs are promoted to a read-only snapshot at open; stages'
mid-pass updates land in the next pass's log), and every planned
traversal is booked once in ``extsort.STATS`` — so "one fused read-write
pass per BFS level" is countable.

A :class:`PassPlan` names the stages that want to see each chunk of ONE
storage object during ONE traversal and fuses them:

  * a **write** stage rewrites the chunk values (the producer — e.g. the
    implicit BFS's rotate step);
  * a **read** stage only observes the values flowing past (a consumer —
    e.g. the next level's expand read, or a frontier count).

Stages run in registration order, each seeing the output of the stages
before it.  Accounting lands in :data:`extsort.STATS` (``rw_passes`` /
``read_passes`` per traversal, ``piggybacked_stages`` for every stage
beyond the first that shared one), with the reference's values.

Stage values are torch tensors on the storage's device: a chunk's
fields as (rows,) uint8 in 0..3.  Besides the reference's value stages
(:meth:`writes`, :meth:`reads`) a plan takes two stages that a 2-bit
array can also run on its packed words: :meth:`rotates` (map every field
through a 4-entry table, and optionally count a value) and
:meth:`counts` (count a value).  ``DiskBitArray.run_pass`` with
``mark=`` runs a plan that opens with them through the bit-pack kernels —
the pass's marks, the rotate and the count in one K1 launch a chunk, or
K2 then K3 — and each stays one stage of the plan for the ledger.
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Tuple

import torch

from .. import obs
from . import extsort

__all__ = ["PassPlan", "Stage", "record_pass"]


class Stage(NamedTuple):
    """One stage of a plan.  ``kind`` is ``"values"`` (``fn(chunk_start,
    vals)``; a write stage returns the replacement values), ``"rotate"``
    (a write stage: ``lut`` maps every field, then, if ``count`` is not
    None, ``into(chunk_start, n)`` receives the number of fields equal to
    ``count``) or ``"count"`` (a read stage: ``into(chunk_start, n)`` for
    the fields equal to ``count``)."""
    kind: str
    writes: bool
    fn: Optional[Callable] = None
    lut: int = 0
    count: Optional[int] = None
    into: Optional[Callable[[int, int], None]] = None


def record_pass(n_stages: int, writes: bool) -> None:
    """Book one fused traversal into the shared pass ledger."""
    obs.add(extsort.STATS, "rw_passes" if writes else "read_passes", 1)
    obs.add(extsort.STATS, "piggybacked_stages", max(0, n_stages - 1))


def lut_table(lut: int, device) -> torch.Tensor:
    """The 4-entry map encoded in ``lut`` (entry v at bits [2v, 2v+2)), as
    a uint8 table on ``device``."""
    return torch.tensor([(lut >> (2 * v)) & 3 for v in range(4)],
                        dtype=torch.uint8, device=device)


class PassPlan:
    """An ordered bundle of stages to fuse into a single streaming pass.

    Build with the chainable :meth:`writes` / :meth:`reads` /
    :meth:`rotates` / :meth:`counts`, then hand to a storage object's pass
    runner (``DiskBitArray.run_pass``).  The plan itself is
    storage-agnostic: it threads one chunk's values through its stages
    (:meth:`apply_chunk`) and says what the fused traversal costs
    (:attr:`writes_chunks` decides read vs read-write).
    """

    def __init__(self, name: str = "pass", dirty_only: bool = False):
        """``dirty_only=True`` restricts the traversal to chunks with
        queued ops — for stages whose work provably lives only where
        updates land (e.g. the implicit BFS seed pass: a fresh array is
        all-UNSEEN, so counting/expanding CUR outside the seeds' chunks
        is a guaranteed no-op and the read would be pure waste)."""
        self.name = name
        self.dirty_only = dirty_only
        self.stages: List[Stage] = []

    # ------------------------------------------------------------ build
    def writes(self, fn: Callable[[int, torch.Tensor], torch.Tensor]
               ) -> "PassPlan":
        """Add a producer stage: vals = fn(chunk_start, vals)."""
        self.stages.append(Stage("values", True, fn))
        return self

    def reads(self, fn: Callable[[int, torch.Tensor], None]) -> "PassPlan":
        """Add a consumer stage: fn(chunk_start, vals), observation only."""
        self.stages.append(Stage("values", False, fn))
        return self

    def rotates(self, lut: int, count: Optional[int] = None,
                into: Optional[Callable[[int, int], None]] = None
                ) -> "PassPlan":
        """Add a producer stage mapping every field through ``lut`` (a
        4-entry map, ``kernels.bitpack.make_lut``'s encoding); with
        ``count``, ``into(chunk_start, n)`` then gets the number of the
        chunk's fields equal to ``count``."""
        if not 0 <= lut < 256:
            raise ValueError(f"lut {lut} is not a 4-entry 2-bit map")
        if (count is None) != (into is None):
            raise ValueError("rotates: give count and into together")
        self.stages.append(Stage("rotate", True, lut=lut, count=count,
                                 into=into))
        return self

    def counts(self, value: int, into: Callable[[int, int], None]
               ) -> "PassPlan":
        """Add a consumer stage: ``into(chunk_start, n)`` with the number
        of the chunk's fields equal to ``value``."""
        self.stages.append(Stage("count", False, count=value, into=into))
        return self

    # ---------------------------------------------------------- queries
    @property
    def n_stages(self) -> int:
        return len(self.stages)

    @property
    def writes_chunks(self) -> bool:
        """True if any stage rewrites chunk values (forces a write-back)."""
        return any(s.writes for s in self.stages)

    @property
    def forces_full_traversal(self) -> bool:
        """A non-empty plan must see EVERY chunk, not just dirty ones —
        unless it opted into ``dirty_only``."""
        return bool(self.stages) and not self.dirty_only

    def packed_head(self) -> Tuple[Optional[Stage], int, Optional[Stage]]:
        """The stages a packed-word pass runs in one kernel launch: a
        leading ``rotate`` stage, and the ``count`` stage right after it
        when the rotate counts nothing itself.  Returns (rotate stage or
        None, stages consumed, the stage whose count the launch gives or
        None)."""
        if not self.stages or self.stages[0].kind != "rotate":
            return None, 0, None
        head = self.stages[0]
        if head.count is not None:
            return head, 1, head
        if len(self.stages) > 1 and self.stages[1].kind == "count":
            return head, 2, self.stages[1]
        return head, 1, None

    # --------------------------------------------------------- execution
    def apply_chunk(self, chunk_start: int, vals: torch.Tensor,
                    first: int = 0) -> torch.Tensor:
        """Thread one chunk's values through the stages from ``first`` on,
        in order."""
        for st in self.stages[first:]:
            if st.kind == "values":
                if st.writes:
                    vals = torch.as_tensor(st.fn(chunk_start, vals),
                                           dtype=vals.dtype,
                                           device=vals.device)
                else:
                    st.fn(chunk_start, vals)
                continue
            if st.kind == "rotate":
                vals = lut_table(st.lut, vals.device)[vals.long()]
            if st.count is not None:
                st.into(chunk_start, int((vals == st.count).sum()))
        return vals
