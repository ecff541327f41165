"""Port parity: ``repro_torch.data.pipeline`` against ``repro.data.pipeline``.

Batches are a pure function of (seed, step) in both packages, drawn from
numpy's generator keyed the same way, so they must be bit-identical.
"""
import os

import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data import pipeline as jdata
from repro_torch.configs import get_config
from repro_torch.data import pipeline as tdata

KEYS = [(0, 0), (0, 1), (0, 1000), (1, 0), (7, 3), (12345, 99)]


@pytest.mark.parametrize("seed,step", KEYS)
def test_synth_tokens_bit_identical(seed, step):
    got = tdata.synth_tokens(seed, step, 3, 17, 199)
    want = jdata.synth_tokens(seed, step, 3, 17, 199)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("seed,step", KEYS[:3])
def test_make_batch_bit_identical(smoke, seed, step):
    cfg, jcfg = get_config("gemma2-2b", smoke), jget_config("gemma2-2b", smoke)
    got = tdata.make_batch(cfg, seed, step, 2, 24)
    want = jdata.make_batch(jcfg, seed, step, 2, 24)
    assert sorted(got["inputs"]) == sorted(want["inputs"])
    for k in got["inputs"]:
        assert got["inputs"][k].dtype == want["inputs"][k].dtype
        np.testing.assert_array_equal(got["inputs"][k], want["inputs"][k])
    np.testing.assert_array_equal(got["labels"], want["labels"])
    assert (got["labels"][:, :-1] == got["inputs"]["tokens"][:, 1:]).all()


def test_batch_to_torch():
    cfg = get_config("gemma2-2b", smoke=True)
    b = tdata.make_batch(cfg, 0, 5, 2, 8)
    t = tdata.batch_to_torch(b, "cpu")
    assert t["inputs"]["tokens"].dtype == t["labels"].dtype == torch.int64
    assert t["inputs"]["positions"].dtype == torch.int32
    np.testing.assert_array_equal(t["labels"].numpy(), b["labels"])


def test_stream_order_and_prefetch():
    """The stream yields steps start, start + 1, … in order, equal to
    make_batch, whatever the prefetch depth; a stream started at a later
    step (after a restore) continues the same sequence."""
    cfg = get_config("gemma2-2b", smoke=True)
    for prefetch in (1, 3):
        s = tdata.SyntheticStream(cfg, 2, 8, seed=4, start_step=2,
                                  prefetch=prefetch)
        try:
            for step in range(2, 8):
                b = next(s)
                assert s.step == step + 1
                want = jdata.make_batch(jget_config("gemma2-2b", True), 4,
                                        step, 2, 8)
                np.testing.assert_array_equal(b["labels"], want["labels"])
            assert s._q.qsize() <= prefetch
        finally:
            s.close()
    replay = tdata.SyntheticStream(cfg, 2, 8, seed=4, start_step=5)
    try:
        np.testing.assert_array_equal(
            next(replay)["inputs"]["tokens"],
            tdata.make_batch(cfg, 4, 5, 2, 8)["inputs"]["tokens"])
    finally:
        replay.close()


@pytest.mark.parametrize("writer", ["ref", "port"])
@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen2-vl-2b"])
def test_disk_stream_gives_the_reference_batches(tmp_path, writer, arch):
    """A corpus written by either package streams the reference's batches
    through both, in order, wrapping past the last chunk; the corpus files
    are the same bytes whichever package wrote them; a stream started at a
    later step (after a restore) continues the same sequence."""
    cfg, jcfg = get_config(arch, smoke=True), jget_config(arch, smoke=True)
    b, s, n = 3, 16, 4
    for k, mod, c in (("port", tdata, cfg), ("ref", jdata, jcfg)):
        mod.DiskTokenStream.write_corpus(str(tmp_path / k), c, b, s, n,
                                         seed=5)
    files = {k: {fn: (tmp_path / k / fn).read_bytes()
                 for fn in sorted(os.listdir(tmp_path / k))}
             for k in ("port", "ref")}
    assert files["port"] == files["ref"] and len(files["port"]) == n + 1
    d = str(tmp_path / writer)
    mine = tdata.DiskTokenStream(d, cfg, b, s)
    theirs = jdata.DiskTokenStream(d, jcfg, b, s)
    assert iter(mine) is mine
    for step in range(n + 2):
        got, want = next(mine), next(theirs)
        assert sorted(got["inputs"]) == sorted(want["inputs"])
        for key in got["inputs"]:
            assert got["inputs"][key].dtype == want["inputs"][key].dtype
            np.testing.assert_array_equal(got["inputs"][key],
                                          want["inputs"][key])
        np.testing.assert_array_equal(got["labels"], want["labels"])
        toks = tdata.synth_tokens(5, step % n, b, s + 1, cfg.vocab_size)
        np.testing.assert_array_equal(got["inputs"]["tokens"], toks[:, :s])
        np.testing.assert_array_equal(got["labels"], toks[:, 1:])
    assert mine.step == n + 2
    later = tdata.DiskTokenStream(d, cfg, b, s, start_step=n + 1)
    np.testing.assert_array_equal(next(later)["labels"],
                                  next(jdata.DiskTokenStream(
                                      d, jcfg, b, s, start_step=n + 1))[
                                      "labels"])
    t = tdata.batch_to_torch(next(later), "cpu")
    assert t["inputs"]["tokens"].shape == (b, s)


def test_disk_stream_refuses_an_empty_corpus(tmp_path):
    cfg = get_config("gemma2-2b", smoke=True)
    with pytest.raises(AssertionError, match="write_corpus"):
        tdata.DiskTokenStream(str(tmp_path / "none"), cfg, 2, 8)
