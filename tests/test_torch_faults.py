"""Port parity: the fault-injection and I/O-retry layer,
``repro_torch.core.disk.faults`` against ``repro.core.disk.faults``, and
the fault sites of the port's oracle publish.

Tolerance: none.  The same spec parses to the same rules; under one seed
the same hits at the same sites fire the same way (the same exception
type and errno, the same torn action, or nothing), ``once`` markers are
the same files and are honoured across processes and across the two
packages, ``retry_io`` retries and gives up as often, and
``append_bytes`` leaves the same file after torn writes.
"""
import errno
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.core.disk import faults as jf
from repro.core.disk import oracle as J
from repro_torch.apps import pancake_bits as P
from repro_torch.core.disk import faults as tf
from repro_torch.core.disk import oracle as O

sys.path.append(str(Path(__file__).resolve().parents[1] / "examples"))
from pancake_bits import neighbors_np  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MODS = {"ref": jf, "port": tf}
RULE_FIELDS = ("site", "kind", "shard", "level", "at", "every", "p", "times",
               "once", "secs", "idx")

SPECS = [
    "seed=42;bucket_seal:transient:every=2:times=2;"
    "worker_level:kill:shard=1:level=2",
    "chunk_flush:fatal:at=3;meta_write:delay:secs=0.5:once=0",
    "seed=7;x:transient:p=0.3:times=3:once=1;x:torn:every=4;y:kill",
    " ; seed=9 ; a:transient ;",
    "",
]


def _stats(mod):
    return jf._stats() if mod is jf else tf.STATS


@pytest.fixture(autouse=True)
def _no_plan():
    yield
    jf.uninstall()
    tf.uninstall()


@pytest.mark.parametrize("spec", SPECS + [jf.default_chaos_spec(5),
                                          jf.default_chaos_spec(11, 4)])
def test_parse_gives_the_same_rules(spec):
    want, got = jf.parse(spec), tf.parse(spec)
    assert got.seed == want.seed
    assert len(got.rules) == len(want.rules)
    for a, b in zip(got.rules, want.rules):
        assert {f: getattr(a, f) for f in RULE_FIELDS} == \
            {f: getattr(b, f) for f in RULE_FIELDS}
    assert sorted(got._by_site) == sorted(want._by_site)


@pytest.mark.parametrize("seed,shards", [(0, 1), (3, 2), (17, 4)])
def test_default_chaos_spec(seed, shards):
    assert tf.default_chaos_spec(seed, shards) == \
        jf.default_chaos_spec(seed, shards)


@pytest.mark.parametrize("bad", ["nokind", "a:transient:zzz=1",
                                 "a:meteor"])
def test_bad_specs_are_refused_alike(bad):
    for mod in MODS.values():
        with pytest.raises((ValueError, AssertionError)):
            mod.parse(bad)


def _outcome(plan, site, ctx):
    try:
        act = plan.fire(site, **ctx)
    except OSError as e:
        return ("OSError", e.errno)
    except (jf.WorkerKilled, tf.WorkerKilled) as e:
        return ("WorkerKilled", str(e))
    return ("act", act)


HITS = ([("a", {})] * 9 + [("b", {"level": lv}) for lv in (0, 1, 2, 2, 3)]
        + [("c", {"shard": s}) for s in (0, 1, 1, 2)] + [("d", {})] * 12)


@pytest.mark.parametrize("shard", [None, 0, 3])
def test_the_firing_sequence_is_the_same(shard):
    spec = ("seed=21;a:transient:every=3:times=2:once=0;"
            "b:fatal:level=2;b:torn:every=2:once=0;"
            "c:kill:shard=1;d:transient:p=0.4:once=0;d:torn:p=0.5:once=0")
    seqs = {}
    for k, mod in MODS.items():
        plan = mod.parse(spec).bind(shard=shard)
        seqs[k] = [_outcome(plan, site, ctx) for site, ctx in HITS]
    assert seqs["port"] == seqs["ref"]
    kinds = {o[0] for o in seqs["port"]}
    assert {"OSError", "WorkerKilled", "act"} <= kinds
    assert ("act", {"torn": True}) in seqs["port"]


def test_once_markers_hold_across_processes_and_packages(tmp_path):
    """A ``fatal`` rule (once by default) fired in one process leaves a
    marker file named ``site.rule.l<level>``; another process — of either
    package — bound to the same directory does not fire it again."""
    spec = "worker_level:fatal:level=2;worker_level:kill:level=5"
    code = ("import sys; from {pkg}.core.disk import faults as f\n"
            "p = f.parse({spec!r}).bind(state_dir=sys.argv[1])\n"
            "try:\n"
            "    p.fire('worker_level', level=int(sys.argv[2]))\n"
            "    print('none')\n"
            "except OSError as e:\n"
            "    print('fired', e.errno)\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}

    def run(pkg, d, level):
        out = subprocess.run(
            [sys.executable, "-c", code.format(pkg=pkg, spec=spec),
             str(d), str(level)], env=env, capture_output=True, text=True,
            check=True)
        return out.stdout.strip()
    for first, second in (("repro_torch", "repro"), ("repro", "repro_torch")):
        d = tmp_path / first
        assert run(first, d, 2) == f"fired {errno.ENOSPC}"
        assert sorted(os.listdir(d)) == ["worker_level.0.l2"]
        assert run(second, d, 2) == "none"
        assert run(first, d, 2) == "none"
        assert run(second, d, 3) == "none"          # no rule at level 3
    # in one process without a directory the marker is kept in memory
    for mod in MODS.values():
        plan = mod.parse(spec).bind()
        assert _outcome(plan, "worker_level", {"level": 2})[0] == "OSError"
        assert _outcome(plan, "worker_level", {"level": 2}) == ("act", None)
        assert _outcome(plan, "worker_level", {"level": 5})[0] == \
            "WorkerKilled"


def test_install_from_env(tmp_path, monkeypatch):
    monkeypatch.delenv(tf.ENV_VAR, raising=False)
    assert not tf.install_from_env() and not tf.ACTIVE
    monkeypatch.setenv(tf.ENV_VAR, "seed=4;s:transient:at=1")
    for mod in MODS.values():
        assert mod.install_from_env(state_dir=str(tmp_path / "m"), shard=2)
        assert mod.ACTIVE and mod._PLAN.seed == 4
        assert mod._PLAN.state_dir == str(tmp_path / "m")
        with pytest.raises(OSError):
            mod.fire("s")
        assert mod.fire("s") is None
        mod.uninstall()
        assert not mod.ACTIVE and mod.fire("s") is None


@pytest.mark.parametrize("spec,fails,want", [
    ("s:transient:at=1:times=3", 0, (3, 0, "ok")),
    ("s:transient:every=1:once=0", 0, (5, 1, errno.EIO)),
    ("s:fatal:at=2", 0, (0, 0, "ok")),
    ("s:fatal", 0, (0, 1, errno.ENOSPC)),
    ("", 2, (2, 0, "ok")),                      # the filesystem's own flakes
    ("s:torn:at=1", 0, (1, 0, "ok")),           # torn on a plain site
])
def test_retry_io_retries_and_gives_up_alike(spec, fails, want):
    """``retry_io`` around a function that also raises ``fails`` real EIO
    errors first: retries, give-ups and the outcome are the same in both
    packages."""
    for mod in MODS.values():
        mod.install(mod.parse(spec).bind() if spec else None)
        stats = _stats(mod)
        before = dict(stats)
        left = [fails]

        def fn():
            if left[0]:
                left[0] -= 1
                raise OSError(errno.EIO, "flaky disk")
            return "ok"
        try:
            out = mod.retry_io("s", fn, base_delay=0.0, max_delay=0.0)
        except OSError as e:
            out = e.errno
        got = (stats["io_retries"] - before["io_retries"],
               stats["io_giveups"] - before["io_giveups"], out)
        assert got == want, mod.__name__
        mod.uninstall()


def test_append_bytes_survives_torn_writes(tmp_path):
    """Torn and transient faults at an append site: the file holds each
    record once, whole, in both packages."""
    spec = "seed=2;log:torn:every=2:once=0;log:transient:every=5:once=0"
    files = {}
    for k, mod in MODS.items():
        mod.install(mod.parse(spec).bind())
        path = str(tmp_path / f"{k}.log")
        for i in range(12):
            mod.append_bytes("log", path, bytes([i]) * (i + 3))
        mod.uninstall()
        files[k] = Path(path).read_bytes()
    assert files["port"] == files["ref"] == b"".join(
        bytes([i]) * (i + 3) for i in range(12))


# ----------------------------------------------- the oracle's publish

def _publish(mod, root, n=6):
    total = math.factorial(n)
    start = P.start_rank(n)
    if mod is J:
        return J.publish_oracle(root, total, [start], neighbors_np(n),
                                chunk_elems=48, codec={"n": n})
    return O.publish_oracle(root, total, [start], P.neighbors(n),
                            chunk_elems=48, codec={"n": n},
                            device=torch.device("cpu"))


def _tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for fn in files:
            p = os.path.join(dirpath, fn)
            out[os.path.relpath(p, root)] = Path(p).read_bytes()
    return out


def test_oracle_publish_retries_a_transient_fault(tmp_path):
    """A transient burst at ``oracle_publish`` (the seal, then the
    manifest) is retried to the artifact of a publish with no faults, as
    often as the reference retries it."""
    torch.set_num_threads(1)
    _publish(O, str(tmp_path / "clean"))
    clean = _tree(tmp_path / "clean")
    spec = "oracle_publish:transient:at=1:times=2;" \
           "oracle_publish:transient:at=2:once=0"
    retries = {}
    for k, mod, fmod in (("ref", J, jf), ("port", O, tf)):
        stats = _stats(fmod)
        before = stats["io_retries"]
        fmod.install(fmod.parse(spec).bind())
        try:
            meta = _publish(mod, str(tmp_path / k))
        finally:
            fmod.uninstall()
        retries[k] = stats["io_retries"] - before
        assert meta["version"] == 1
    assert retries["port"] == retries["ref"] == 3
    assert _tree(tmp_path / "port") == clean
    assert _tree(tmp_path / "port") == _tree(tmp_path / "ref")


def test_oracle_publish_raises_a_fatal_fault(tmp_path):
    """A fatal fault at the seal raises ``OSError`` (ENOSPC) and leaves the
    staged version unsealed with no manifest, in both packages; a fatal one
    at the manifest leaves the sealed version and no manifest."""
    torch.set_num_threads(1)
    for at, left in ((1, ["v000001.tmp"]), (2, ["v000001"])):
        for k, mod, fmod in (("ref", J, jf), ("port", O, tf)):
            giveups = _stats(fmod)["io_giveups"]
            fmod.install(fmod.parse(f"oracle_publish:fatal:at={at}").bind())
            root = str(tmp_path / f"{k}{at}")
            try:
                with pytest.raises(OSError) as e:
                    _publish(mod, root)
            finally:
                fmod.uninstall()
            assert e.value.errno == errno.ENOSPC
            assert _stats(fmod)["io_giveups"] == giveups + 1
            assert sorted(os.listdir(root)) == left, k
        assert _tree(tmp_path / f"port{at}") == _tree(tmp_path / f"ref{at}")
