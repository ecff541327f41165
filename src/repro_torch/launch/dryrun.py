"""Multi-pod dry run: trace every (arch x shape x mesh) cell's step on a
fake world of 256 or 512 ranks, with no card (port of
``repro/launch/dryrun.py``).

The reference lowers and compiles each cell on 512 placeholder XLA CPU
devices and reads XLA's memory and cost analyses and the partitioned HLO.
The port has no compiler to ask, so it runs the step itself, as rank 0
(or ``--rank``) of a ``torch.distributed`` world of the ``fake`` backend
(every collective returns at once), under ``FakeTensorMode`` (tensors
carry shapes and dtypes and no data: nothing is allocated and nothing is
computed).  The mesh and its process groups are real objects of that
world, built before the fake mode is entered (``core/sharding.py`` reads
the mesh's rank table to make its flattened groups).  Params and AdamW moments are this
rank's ``ShardingRules`` shards; the config runs the plain versions of
the kernels (``kernels="ref"``, as the reference's dry run).

Per cell the JSON holds the reference's keys where the port has their
counterpart:

* ``flops_per_device``: ``FlopCounterMode``'s total over the full-depth
  step (matrix products, attention and convolutions; elementwise work is
  not counted, where XLA counts it).
* ``bytes_per_device``: the sum, over every op the step dispatched, of
  its tensor inputs' and outputs' bytes, views and allocations with no
  write left out.  Every op is charged as if it ran alone, so this is an
  unfused upper bound: XLA's "bytes accessed" is taken after fusion,
  where an elementwise chain reads and writes device memory once.
* ``memory``: ``argument_bytes`` (the params, optimiser state, inputs
  and caches this rank holds when the step starts), ``output_bytes``
  (storages the step's outputs hold that it did not get as arguments)
  and ``peak_estimate_bytes`` (the most bytes of fake storage alive at
  once during the step, arguments included, tracked by weak references
  to the storages the ops return), with ``donated``.  XLA's
  ``temp_size_in_bytes`` and ``alias_size_in_bytes`` have no
  counterpart here (an eager step has no buffer plan) and are left out.
  Donation as in the reference: the train step updates the params and
  moments in place (``--no-donate`` updates copies made in the step), and
  decode runs with ``donate=True`` (the caches' pages are written in
  place).
* ``collectives``: every ``c10d`` op the step issued, as a record (kind,
  result bytes, group size), summed by ``collective_stats`` with the
  reference's algebra (``repro/launch/dryrun.py:60-101``).
* ``flops_k1`` … ``flops_per_device_counted``: the reference's twin count
  (``_counted_flops``) at ``_flops_points``' two depths, extrapolated to
  the config's, plus its analytic time-scan correction for the mamba
  recurrence.
* ``sharding_notes``: ``ShardingRules.describe()``.

The plain selective scan walks time in Python (``kernels/ref.py``), which
under fake tensors would dispatch millions of ops at falcon-mamba's 64
layers.  The dry run replaces its three plain functions with one op each
(``repro_dryrun::scan_fwd`` / ``scan_bwd``) whose outputs have the plain
version's shapes and dtypes: the op reads its inputs and writes its
outputs once, as K9 and K9-bwd do, and counts no FLOPs (the correction
adds the recurrence's, as the reference adds what XLA's scan body leaves
out).  So a cell with the mamba1 scan, or zamba2 with ``--ssm-impl seq``,
leaves out the plain scan's per-step temporaries from bytes and peak.

The port's collective schedule is its own, so its counts are not the
reference's HLO counts: each rank computes its share of a train step and
of a serving call (its data rank's rows, its heads, ff, ``d_inner`` and
vocab columns over ``model``, ``models/lm.py``; serving passes the
global inputs to every rank), so a cell's FLOPs and peak are one rank's
share of the step.  Where the heads do not divide ``model`` and the
batch does not tile the grid, attention splits the sequence, and the
last model rank's query block sees the most keys: ``--rank 15`` reads
that rank of a 16 × 16 or 2 × 16 × 16 world.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch minicpm-2b \\
      --shape train_4k --mesh single --out-dir experiments/dryrun
  ... --list  prints all runnable cells.
"""
from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import os
import time
import weakref
from typing import Dict, Iterable, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from .. import optim
from .. import tree as T
from ..configs import SHAPES, get_config, shape_applicable
from ..configs.inputs import input_specs
from ..configs.registry import ARCH_IDS
from ..core import sharding as SH
from ..distributed.sharding_rules import ShardingRules
from ..kernels import ref as kref
from ..models import lm
from ..runtime import train_loop
from .mesh import make_production_mesh

# ------------------------------------------------------ collective algebra

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")

# The c10d ops the port's collectives dispatch (``dist.all_reduce``,
# ``all_gather_single``, ``reduce_scatter_single``, ``all_to_all_single``)
# → the HLO kind of the same collective; the first tensor argument is the
# result, written in place.  Any other c10d op but a barrier stops the
# trace, rather than go uncounted.
_C10D_KINDS = {"allreduce_": "all-reduce",
               "_allgather_base_": "all-gather",
               "_reduce_scatter_base_": "reduce-scatter",
               "alltoall_base_": "all-to-all"}
_C10D_UNCOUNTED = ("barrier", "monitored_barrier")


def collective_stats(records: Iterable[Tuple[str, int, int]]) -> Dict:
    """Per-device operand bytes and a wire-bytes estimate per collective
    kind, from records (kind, result bytes, group size) of this rank's
    collectives: the reference's algebra (``repro/launch/dryrun.py:60-101``,
    which reads the records from the partitioned HLO):

      all-reduce         operand = result;      wire ≈ 2·B·(g-1)/g
      all-gather         operand = result/g;    wire ≈ (result/g)·(g-1)
      reduce-scatter     operand = result·g;    wire ≈ result·(g-1)
      all-to-all         operand = result;      wire ≈ B·(g-1)/g
      collective-permute operand = result;      wire = B
    """
    stats = {k: {"count": 0, "operand_bytes": 0, "wire_bytes": 0.0}
             for k in COLLECTIVE_KINDS}
    for kind, b, g in records:
        g = max(g, 1)
        if kind == "all-reduce":
            op_b, wire = b, 2.0 * b * (g - 1) / g
        elif kind == "all-gather":
            op_b, wire = b // g, (b // g) * (g - 1)
        elif kind == "reduce-scatter":
            op_b, wire = b * g, b * (g - 1)
        elif kind == "all-to-all":
            op_b, wire = b, b * (g - 1) / g
        else:
            op_b, wire = b, float(b)
        s = stats[kind]
        s["count"] += 1
        s["operand_bytes"] += op_b
        s["wire_bytes"] += wire
    stats["total_operand_bytes"] = sum(
        s["operand_bytes"] for s in stats.values() if isinstance(s, dict))
    stats["total_wire_bytes"] = sum(
        s["wire_bytes"] for s in stats.values() if isinstance(s, dict))
    return stats


def _tensors(tree):
    """The tensors of ``tree`` that hold bytes: ``meta`` tensors (shapes
    the code computes specs from, such as ``ShardingRules``' params)
    hold none."""
    return [x for x in tree_flatten(tree)[0]
            if isinstance(x, torch.Tensor) and x.device.type != "meta"]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_of(args):
    from torch._C._distributed_c10d import ProcessGroup
    for a in args:
        if isinstance(a, torch.ScriptObject) and "ProcessGroup" in str(
                a._type()):
            return ProcessGroup.unbox(a)
    raise ValueError("a c10d op with no process group")


# -------------------------------------------------------------- the tracer

_FREE = {"empty", "empty_strided", "empty_like", "new_empty",
         "new_empty_strided", "detach", "lift_fresh", "_local_scalar_dense"}


class StepRecorder(TorchDispatchMode):
    """Watches every op dispatched below it: the bytes each reads and
    writes, the storages alive (for the peak), the c10d collectives, and
    with ``lines`` a text line an op.  ``track`` registers tensors that
    exist before the step (the arguments)."""

    def __init__(self, lines: bool = False):
        super().__init__()
        self.bytes = 0
        self.ops = 0
        self.collectives = []            # (kind, result bytes, group size)
        self.groups = []                 # the ranks of each one's group
        self.lines = [] if lines else None
        self.live = 0
        self.peak = 0
        self._storages = {}              # storage key → [bytes, refs]

    @staticmethod
    def _key(t):
        return t.untyped_storage()._cdata

    def track(self, tensors) -> None:
        """Count ``tensors``' storages as alive until the tensors die."""
        for t in tensors:
            key = self._key(t)
            rec = self._storages.get(key)
            if rec is None:
                rec = self._storages[key] = [t.untyped_storage().nbytes(), 0]
                self.live += rec[0]
            rec[1] += 1
            weakref.finalize(t, self._release, key)
        self.peak = max(self.peak, self.live)

    def _release(self, key) -> None:
        rec = self._storages.get(key)
        if rec is None:
            return
        rec[1] -= 1
        if rec[1] == 0:
            self.live -= rec[0]
            del self._storages[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._schema.name.split("::")[-1]
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if func.namespace == "c10d":
            if name in _C10D_UNCOUNTED:
                return out
            kind = _C10D_KINDS.get(name)
            if kind is None:
                raise NotImplementedError(f"the dry run counts no c10d.{name}")
            group = _group_of(args)
            self.collectives.append((kind, sum(map(_nbytes, _tensors(
                args[0]))), group.size()))
            self.groups.append(dist.get_process_group_ranks(group))
        elif func.namespace == "prim" or not outs:  # metadata queries
            return out
        self.ops += 1
        view = func.is_view or any(
            r.alias_info is not None and not r.alias_info.is_write
            for r in func._schema.returns)
        if not view and name not in _FREE:
            self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        self.track(outs)
        if self.lines is not None:
            self.lines.append(
                f"{func} in={[tuple(t.shape) for t in ins]} out="
                f"{[(tuple(t.shape), str(t.dtype)) for t in outs]}")
        return out


# ----------------------------------------------- the plain scan as one op

def _scan_ops():
    """``repro_dryrun::scan_fwd`` / ``scan_bwd``: the selective scan's
    forward (y, and ``n_states`` float32 states) and backward, each one
    op with the plain versions' output shapes, for fake tensors only."""
    ns = torch.ops.repro_dryrun
    if not hasattr(ns, "scan_fwd"):
        @torch.library.custom_op("repro_dryrun::scan_fwd", mutates_args=())
        def scan_fwd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                     b: torch.Tensor, c: torch.Tensor, d: torch.Tensor,
                     n_states: int) -> Tuple[torch.Tensor, torch.Tensor]:
            raise RuntimeError("the dry run's scan runs on fake tensors only")

        @scan_fwd.register_fake
        def _(x, dt, a, b, c, d, n_states):
            return (x.new_empty(x.shape),
                    x.new_empty((x.shape[0], n_states, x.shape[2],
                                 a.shape[1]), dtype=torch.float32))

        @torch.library.custom_op("repro_dryrun::scan_bwd", mutates_args=())
        def scan_bwd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                     b: torch.Tensor, c: torch.Tensor, d: torch.Tensor,
                     dy: torch.Tensor, h_chunks: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor, torch.Tensor, torch.Tensor]:
            raise RuntimeError("the dry run's scan runs on fake tensors only")

        @scan_bwd.register_fake
        def _(x, dt, a, b, c, d, dy, h_chunks):
            f32 = dict(dtype=torch.float32)
            bsz, seq, _ = x.shape
            n = a.shape[1]
            return (x.new_empty(x.shape), dt.new_empty(dt.shape),
                    a.new_empty(a.shape, **f32),
                    b.new_empty((bsz, seq, n), **f32),
                    c.new_empty((bsz, seq, n), **f32),
                    d.new_empty(d.shape, **f32))
    return ns.scan_fwd, ns.scan_bwd


@contextlib.contextmanager
def _scan_as_one_op():
    """The plain scan's three entry points (``kernels/ref.py``) as the
    one-op stand-ins, for the duration of a trace."""
    fwd, bwd = _scan_ops()

    def plain(x, dt, a, b, c, d, return_state=False):
        y, h = fwd(x, dt, a, b, c, d, 1 if return_state else 0)
        return (y, h[:, 0]) if return_state else y

    def chunks(x, dt, a, b, c, d, chunk=kref.SCAN_CHUNK):
        return fwd(x, dt, a, b, c, d, -(-x.shape[1] // chunk))

    def backward(x, dt, a, b, c, d, dy, h_chunks, chunk=kref.SCAN_CHUNK):
        return bwd(x, dt, a, b, c, d, dy, h_chunks)
    saved = {k: getattr(kref, k) for k in (
        "mamba_scan_plain", "mamba_scan_chunks_plain",
        "mamba_scan_bwd_plain")}
    kref.mamba_scan_plain = plain
    kref.mamba_scan_chunks_plain = chunks
    kref.mamba_scan_bwd_plain = backward
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(kref, k, v)


# ----------------------------------------------------------- the world

def fake_world(world: int, rank: int = 0) -> None:
    """This process as rank ``rank`` of a ``fake`` world of ``world`` ranks
    (a world already there is left as it is, if it has that size)."""
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(f"a process group of {dist.get_world_size()} "
                               f"ranks is up; the dry run needs {world}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)


def build_groups(mesh) -> None:
    """Every flattened group ``core/sharding.py`` may ask for (each subset
    of the mesh's axes, in the mesh's order), made now: making one reads
    the mesh's rank table, which a fake tensor does not carry."""
    names = list(SH.mesh_axes(mesh))
    for r in range(1, len(names) + 1):
        for pick in itertools.combinations(names, r):
            SH.axis_group(mesh, pick)


# ---------------------------------------------------------- cell runner

def _batch_rows(b: int, rules: ShardingRules) -> int:
    """The rows of a batch-leading input this rank holds: its block over
    the dp axes when the batch tiles them, else all
    (``repro/launch/dryrun.py:109-121``)."""
    if rules.dp_axes and b % rules.fsdp == 0 and b > 0:
        return b // rules.fsdp
    return b


def _fake_like(meta_tree, rows=None):
    """``meta_tree``'s tensors as fake ones (zeros) on the CPU; a leading
    dim cut to ``rows`` where given."""
    def mk(x):
        shape = tuple(x.shape)
        if rows is not None and shape:
            shape = (rows,) + shape[1:]
        return torch.zeros(shape, dtype=x.dtype)
    return T.tree_map(mk, meta_tree)


def _param_shards(pspecs, mesh, meta):
    """This rank's float32 shards of every param (fake), as the
    reference's ``lm.init_params`` leaves are float32."""
    return T.tree_map(lambda x, spec: torch.zeros(
        SH.shard_param(x, spec, mesh).shape, dtype=torch.float32),
        meta, pspecs)


def make_args(cfg, shape, mesh, rules) -> tuple:
    """The cell step's arguments on fake tensors: this rank's param shards
    under ``rules`` (and AdamW state for a train step), its batch rows or
    the global serving inputs, and for decode its shard of empty
    caches."""
    meta = lm.init_params(cfg, 0, device="meta")
    specs_in = input_specs(cfg, shape)
    params = _param_shards(rules.param_specs(meta), mesh, meta)
    if shape.kind == "train":
        params = T.tree_map(lambda p: p.requires_grad_(True), params)
        rows = _batch_rows(shape.global_batch, rules)
        return params, optim.init(params), _fake_like(specs_in, rows)
    inputs = _fake_like(specs_in["inputs"])     # serving: the global batch
    if shape.kind == "prefill":
        return params, inputs
    return params, inputs, lm.make_cache(cfg, shape.global_batch,
                                         shape.seq_len, device="cpu",
                                         mesh=mesh)


def run_step(cfg, shape, mesh, args, *, donate=True, microbatches=1):
    """The cell's step on ``make_args``' arguments; returns its outputs.
    Train: ``train_loop.make_train_step`` (``--no-donate``: on copies of
    the params and moments, made in the step); prefill: ``lm.prefill``;
    decode: ``lm.decode_step`` with ``donate``."""
    if shape.kind == "train":
        params, opt_state, batch = args
        s = train_loop.TrainSettings(batch=shape.global_batch,
                                     seq=shape.seq_len,
                                     num_microbatches=microbatches)
        if not donate:
            params = T.tree_map(lambda p: p.detach().clone()
                                .requires_grad_(True), params)
            opt_state = optim.AdamWState(
                step=opt_state.step, m=T.tree_map(torch.clone, opt_state.m),
                v=T.tree_map(torch.clone, opt_state.v))
        step = train_loop.make_train_step(cfg, s, mesh)
        return step(params, opt_state, None, batch, 0)
    with torch.no_grad():
        if shape.kind == "prefill":
            return lm.prefill(*args, cfg, mesh)
        params, inputs, caches = args
        return lm.decode_step(params, inputs, caches, cfg, mesh,
                              donate=donate)


def _fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode(allow_non_fake_inputs=True)


def trace_cell(cfg, shape, mesh, rules, *, donate=True,
               microbatches=1, lines=False) -> Dict:
    """The full-depth trace: FLOPs, bytes, memory and collectives."""
    rec = StepRecorder(lines=lines)
    with _fake_mode(), _scan_as_one_op():
        args = make_args(cfg, shape, mesh, rules)
        arg_ts = _tensors(args)
        arg_bytes = sum(_storage_bytes(arg_ts))
        arg_keys = {StepRecorder._key(t) for t in arg_ts}
        rec.track(arg_ts)
        del arg_ts
        flops = FlopCounterMode(display=False)
        with flops, rec:
            out = run_step(cfg, shape, mesh, args, donate=donate,
                           microbatches=microbatches)
        out_bytes = sum(_storage_bytes(
            [t for t in _tensors(out)
             if StepRecorder._key(t) not in arg_keys]))
    return {"flops": float(flops.get_total_flops()), "bytes": rec.bytes,
            "ops": rec.ops, "argument_bytes": arg_bytes,
            "output_bytes": out_bytes, "peak_bytes": rec.peak,
            "collectives": rec.collectives, "groups": rec.groups,
            "lines": rec.lines}


def _storage_bytes(tensors):
    """Each distinct storage's bytes once."""
    seen = {}
    for t in tensors:
        seen.setdefault(StepRecorder._key(t), t.untyped_storage().nbytes())
    return list(seen.values())


def count_flops(cfg, shape, mesh, rules, *, microbatches=1) -> float:
    """FlopCounterMode's total for ``cfg``'s step (no other tracking).
    ``cfg``'s params are placed by rules of its own that report their
    fallbacks into ``rules``, as the reference's twin lowerings add theirs
    to the cell's ``describe()``."""
    own = ShardingRules(cfg, mesh)
    own.fallbacks = rules.fallbacks
    with _fake_mode(), _scan_as_one_op():
        args = make_args(cfg, shape, mesh, own)
        flops = FlopCounterMode(display=False)
        with flops:
            run_step(cfg, shape, mesh, args, microbatches=microbatches)
    return float(flops.get_total_flops())


def _flops_points(cfg) -> tuple:
    """(k1, k2) depths for per-layer FLOP extrapolation."""
    if cfg.family == "hybrid" and cfg.shared_attn_every:
        k = cfg.shared_attn_every
        return k, 2 * k
    return 2, 4


def _counted_flops(cfg, shape, mesh, rules, microbatches=1) -> Dict:
    """The reference's twin count (``repro/launch/dryrun.py:198-235``):
    the step traced at depths k1 and k2, the per-layer difference
    extrapolated to the config's depth, plus the analytic FLOPs of the
    mamba recurrence over time (the scan op counts none)."""
    k1, k2 = _flops_points(cfg)
    fs = [count_flops(cfg.replace(n_layers=k), shape, mesh, rules,
                      microbatches=microbatches) for k in (k1, k2)]
    per_layer = (fs[1] - fs[0]) / (k2 - k1)
    total = fs[0] + per_layer * (cfg.n_layers - k1)
    corr = 0.0
    if cfg.mamba_version and shape.kind != "decode":
        tokens = shape.global_batch * shape.seq_len
        per_tok_layer = 7.0 * cfg.d_inner * cfg.ssm_state
        mult = 3.0 if shape.kind == "train" else 1.0   # fwd+bwd(≈2×)
        if shape.kind == "train" and cfg.remat:
            mult += 1.0                                # remat refwd
        corr = (tokens * per_tok_layer * cfg.n_layers * mult
                / dist.get_world_size())
    return {"flops_k1": fs[0], "flops_k2": fs[1],
            "flops_per_layer": per_layer,
            "scan_time_correction": corr,
            "flops_per_device_counted": total + corr}


SKIP_TEXT = ("long_500k needs sub-quadratic attention (full-attention "
             "arch) — see DESIGN.md §6")


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             moe_dispatch: Optional[str] = None,
             embed_dispatch: Optional[str] = None,
             remat: Optional[bool] = None,
             donate: bool = True,
             count_flops_twin: bool = True,
             microbatches: int = 1,
             attn_shard: Optional[str] = None,
             ssm_impl: Optional[str] = None,
             save_hlo: Optional[str] = None, rank: int = 0) -> Dict:
    shape = SHAPES[shape_name]
    cfg = get_config(arch).replace(kernels="ref")
    if moe_dispatch:
        cfg = cfg.replace(moe_dispatch=moe_dispatch)
    if embed_dispatch:
        cfg = cfg.replace(embedding_dispatch=embed_dispatch)
    if remat is not None:
        cfg = cfg.replace(remat=remat)
    if attn_shard is not None:
        cfg = cfg.replace(attn_activation_shard=attn_shard)
    if ssm_impl is not None:
        cfg = cfg.replace(mamba2_use_ssd=(ssm_impl == "ssd"))

    meta = {"arch": arch, "shape": shape_name, "microbatches": microbatches,
            "mesh": "2x16x16" if multi_pod else "16x16",
            "kind": shape.kind, "seq_len": shape.seq_len,
            "global_batch": shape.global_batch,
            "moe_dispatch": cfg.moe_dispatch,
            "embed_dispatch": cfg.embedding_dispatch,
            "remat": cfg.remat,
            "params": cfg.param_count(),
            "active_params": cfg.active_param_count()}
    if not shape_applicable(shape, cfg.family):
        return {**meta, "skipped": SKIP_TEXT}

    fake_world(512 if multi_pod else 256, rank)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    return {**meta, **dry_run(cfg, shape, mesh, donate=donate,
                              microbatches=microbatches,
                              count_flops_twin=count_flops_twin,
                              save_hlo=save_hlo)}


def dry_run(cfg, shape, mesh, *, donate: bool = True, microbatches: int = 1,
            count_flops_twin: bool = True,
            save_hlo: Optional[str] = None) -> Dict:
    """One cell's record on ``mesh`` (rank 0 of a fake world the caller
    made): the trace's FLOPs, bytes, memory and collectives, the twin
    count, the sharding notes."""
    build_groups(mesh)
    rules = ShardingRules(cfg, mesh)

    t0 = time.time()
    tr = trace_cell(cfg, shape, mesh, rules, donate=donate,
                    microbatches=microbatches, lines=bool(save_hlo))
    t_trace = time.time() - t0
    if save_hlo:
        with open(save_hlo, "w") as f:
            f.write("\n".join(tr["lines"]) + "\n")

    flops_info = {}
    if count_flops_twin:
        flops_info = _counted_flops(cfg, shape, mesh, rules, microbatches)

    donated = ([] if not donate else ["params", "opt_state"]
               if shape.kind == "train" else ["caches"]
               if shape.kind == "decode" else [])
    return {
        "devices": dist.get_world_size(),
        "trace_s": round(t_trace, 2),
        "ops": tr["ops"],
        "flops_per_device": tr["flops"],
        "bytes_per_device": float(tr["bytes"]),
        "memory": {
            "argument_bytes": tr["argument_bytes"],
            "output_bytes": tr["output_bytes"],
            "peak_estimate_bytes": tr["peak_bytes"],
            "donated": donated,
        },
        "collectives": collective_stats(tr["collectives"]),
        **flops_info,
        "sharding_notes": rules.describe(),
    }


def cells(include_multi: bool = True):
    for arch in ARCH_IDS:
        for shape_name in SHAPES:
            yield arch, shape_name, False
            if include_multi:
                yield arch, shape_name, True


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--mesh", choices=("single", "multi"), default="single")
    ap.add_argument("--moe-dispatch", choices=("roomy", "einsum"))
    ap.add_argument("--embed-dispatch", choices=("gspmd", "roomy"))
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--no-donate", action="store_true")
    ap.add_argument("--skip-flops", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--attn-shard", choices=("auto", "none"))
    ap.add_argument("--ssm-impl", choices=("ssd", "seq"))
    ap.add_argument("--tag", default="")
    ap.add_argument("--save-hlo",
                    help="write a text dump of the traced ops (one line an "
                         "op: its name, input shapes, output shapes and "
                         "dtypes) to this file; the port has no HLO")
    ap.add_argument("--rank", type=int, default=0,
                    help="trace the step as this rank of the fake world "
                         "(beyond the reference, whose compiler sees every "
                         "device: a rank's share can depend on its place, "
                         "as the sequence branch of _attn_act_spec's does)")
    ap.add_argument("--out-dir", default="experiments/dryrun")
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args()

    if args.list:
        for arch, shape, multi in cells():
            print(f"{arch} {shape} {'multi' if multi else 'single'}")
        return

    os.makedirs(args.out_dir, exist_ok=True)
    res = run_cell(args.arch, args.shape, args.mesh == "multi",
                   moe_dispatch=args.moe_dispatch,
                   embed_dispatch=args.embed_dispatch,
                   remat=False if args.no_remat else None,
                   donate=not args.no_donate,
                   count_flops_twin=not args.skip_flops,
                   microbatches=args.microbatches,
                   attn_shard=args.attn_shard,
                   ssm_impl=args.ssm_impl,
                   save_hlo=args.save_hlo, rank=args.rank)
    tag = f"__{args.tag}" if args.tag else ""
    out = os.path.join(
        args.out_dir,
        f"{args.arch}__{args.shape}__{args.mesh}{tag}.json")
    with open(out, "w") as f:
        json.dump(res, f, indent=2)
    print(json.dumps({k: v for k, v in res.items()
                      if k not in ("sharding_notes",)}, indent=2))
    print(res.get("sharding_notes", ""))
    print(f"wrote {out}")
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
