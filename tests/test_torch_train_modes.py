"""The port's explicit training routes on the CPU against minbpe_tpu's:
train_merges_select ("sort", "dense", "pallas") against ops/train.py's
train_merges ("sort", "dense", "pallas_interpret"), the stepped and
incremental trainers against ops/train_inc.py on the corpora of
tests/test_train_inc.py, every accepted select_mode through the public API
on the text of tests/test_engine_modes.py, and the route choice of
``run_train``. Merges, counts and fail rounds must be equal."""

import random

import numpy as np
import pytest
import torch

# The suite runs in several worker processes at once: one intra-op
# thread each keeps the plain PyTorch paths from contending for cores.
torch.set_num_threads(1)

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import minbpe_tpu  # noqa: E402
from minbpe_tpu.ops import stream as jstream  # noqa: E402
from minbpe_tpu.ops import train as jtrain  # noqa: E402
from minbpe_tpu.ops import train_inc as jinc  # noqa: E402

import minbpe_tpu_torch as port  # noqa: E402
from minbpe_tpu_torch import engine  # noqa: E402
from minbpe_tpu_torch.ops import train_inc, train_select  # noqa: E402

# one padded size for every corpus: minbpe_tpu compiles once per merge count
CAPACITY = 1024
TEXT = ("mode selection must never change results. " * 40
        + "aaaa bbbb aaab abab " * 10)


def _pack(seqs):
    ids, seg, n = jstream.pack_chunks([bytes(s) for s in seqs], CAPACITY)
    j = (jnp.asarray(ids), jnp.asarray(seg), jnp.asarray(n))
    k = int(n)
    return j, (torch.from_numpy(ids[:k].copy()),
               torch.from_numpy(seg[:k].copy()))


def _same(want, got):
    p1, c1, f1 = (np.asarray(x) for x in want)
    p2, c2, f2 = got
    assert int(f1) == f2
    assert np.array_equal(p1, p2) and np.array_equal(c1, c2)
    return f2


def _corpus(seed):
    """tests/test_train_inc.py's random corpora."""
    rng = random.Random(seed * 7 + 1)
    seqs = [
        [rng.randint(0, rng.choice([2, 4, 8]))
         for _ in range(rng.randint(0, 40))]
        for _ in range(rng.randint(1, 8))
    ]
    seqs.append([1, 1, 1, 1, 2, 1, 1, 1])  # overlap-run stress
    return seqs, rng.randint(1, 12)


CORPORA = [_corpus(s) for s in range(6)] + [
    ([[7] * 25, [7] * 6, [7, 8] * 10, [8] * 3], 8),  # overlapping runs
    ([[1, 2]], 5),                                    # fails at round 1
    ([[7] * 40, [1, 2, 3] * 3], 14),                  # fails mid-run
]


@pytest.mark.parametrize("mode, jmode", [("sort", "sort"), ("dense", "dense"),
                                         ("pallas", "pallas_interpret")])
@pytest.mark.parametrize("k", range(len(CORPORA)))
def test_select_modes_match(mode, jmode, k):
    seqs, M = CORPORA[k]
    j, p = _pack(seqs)
    want = jtrain.train_merges(*j, M, select_mode=jmode)
    _same(want, train_select.train_merges_select(*p, M, mode))


def test_a_corpus_fails_mid_run():
    seqs, M = CORPORA[-1]
    _, p = _pack(seqs)
    for mode in ("sort", "dense", "pallas"):
        _, counts, fail = train_select.train_merges_select(*p, M, mode)
        assert 0 < fail < M and counts[fail - 1] > 0
        assert not counts[fail:].any()


@pytest.mark.parametrize("k", range(len(CORPORA)))
def test_incremental_and_stepped_match(k):
    seqs, M = CORPORA[k]
    j, p = _pack(seqs)
    want = jinc.train_merges_incremental(*j, M)
    _same(want, train_inc.train_merges_incremental(*p, M))
    _same(jinc.train_merges_stepped(*j, M, unroll=3),
          train_inc.train_merges_stepped(*p, M, unroll=3))
    _same(want, train_inc.train_merges_stepped(*p, M))


@pytest.mark.parametrize("mode", ["auto", "fused", "fused_xl", "sort",
                                  "dense", "pallas", "pallas_interpret",
                                  "stepped", "incremental"])
def test_public_api_modes(mode):
    """tests/test_engine_modes.py's text: every accepted mode gives
    minbpe_tpu's merges, with BasicTokenizer and RegexTokenizer."""
    for cls in ("BasicTokenizer", "RegexTokenizer"):
        base = getattr(minbpe_tpu, cls)()
        base.train(TEXT, 256 + 32)
        other = getattr(port, cls)(device="cpu")
        other.train(TEXT, 256 + 32, select_mode=mode)
        assert other.merges == base.merges


def test_route_choice():
    """minbpe_tpu/engine.py:87-120 with its TPU test read as true."""
    route = engine.train_route
    assert route("auto", 1000, 768) == "whole"                # V = 1024
    assert route("auto", 1000, 769) == "stepped"              # V = 1025
    assert route("auto", 1000, 768, plain=False) == "stepped"
    assert route("auto", 1000, 1792) == "stepped"             # V = 2048
    assert route("auto", 48 << 20, 768) == "whole"
    assert route("auto", 4 << 20, 769) == "stepped"
    for mode, want in (("sort", "sort"), ("dense", "dense"),
                       ("pallas", "pallas"), ("pallas_interpret", "pallas"),
                       ("stepped", "stepped"),
                       ("incremental", "incremental")):
        assert route(mode, 1000, 1800) == want
    assert route("fused", 1000, 768) == "whole"
    assert route("fused_xl", 48 << 20, 768) == "whole"
    # vocab above 2048, above 4·2^20 tokens past vocab 1024, above 48·2^20
    # tokens, and above 4·2^20 tokens with a checkpoint or progress option
    for n, m in ((1000, 1793), ((4 << 20) + 1, 769), ((48 << 20) + 1, 10)):
        assert route("auto", n, m) == "sortloop"
    assert route("auto", (4 << 20) + 1, 768, plain=False) == "sortloop"
    assert route("auto", 4 << 20, 1792, plain=False) == "stepped"
    for mode in ("sortloop", "sortloop_inc", "sparse", "sparse_inc"):
        assert route(mode, 1000, 8000) == mode
    with pytest.raises(ValueError, match="'fused'"):
        route("fused", 1000, 769)


class _Spy:
    """Stands in for the trainers: records the route, returns a run that
    found every merge."""

    def __init__(self, monkeypatch):
        self.calls = []
        for name in ("train_merges", "train_merges_select",
                     "train_merges_stepped", "train_merges_incremental",
                     "train_merges_sortloop", "train_merges_sortloop_stepped",
                     "train_merges_sparse", "train_merges_sparse_stepped"):
            monkeypatch.setattr(engine, name, self._fake(name))

    def _fake(self, name):
        def run(ids, seg, num_merges, *args, **kwargs):
            self.calls.append((name, kwargs))
            pairs = np.stack([np.arange(num_merges), np.arange(num_merges)],
                             axis=1).astype(np.int32)
            return pairs, np.ones(num_merges, np.int32), num_merges
        return run


@pytest.mark.parametrize("vocab, opts, want", [
    (1024, {}, "train_merges"),
    (1025, {}, "train_merges_stepped"),
    (1024, {"checkpoint_path": "unused.npz", "checkpoint_every": 8},
     "train_merges_stepped"),
    (1024, {"progress": print}, "train_merges_stepped"),
    (1024, {"select_mode": "pallas"}, "train_merges_select"),
    (2048, {"select_mode": "incremental"}, "train_merges_incremental"),
])
def test_route_spied(monkeypatch, vocab, opts, want):
    spy = _Spy(monkeypatch)
    port.RegexTokenizer(device="cpu").train(TEXT, vocab, **opts)
    assert [name for name, _ in spy.calls] == [want]
    if "checkpoint_path" in opts:
        kw = spy.calls[0][1]
        assert kw["checkpoint_path"] == "unused.npz"
        assert len(kw["fingerprint"]) == 32


@pytest.mark.parametrize("mode", ["sortloop", "sortloop_inc", "sparse",
                                  "sparse_inc"])
def test_sortloop_modes_raise_a11(mode):
    """The sort-round and sparse modes (which raised NotImplementedError
    before they were ported) train as minbpe_tpu's same mode does."""
    for cls in ("BasicTokenizer", "RegexTokenizer"):
        want = getattr(minbpe_tpu, cls)()
        want.train(TEXT, 260, select_mode=mode)
        got = getattr(port, cls)(device="cpu")
        got.train(TEXT, 260, select_mode=mode)
        assert got.merges == want.merges


def test_unknown_mode_raises():
    """minbpe_tpu runs the sort path for an unknown string (ROADMAP C)."""
    with pytest.raises(ValueError, match="unknown select_mode"):
        port.BasicTokenizer(device="cpu").train(TEXT, 260,
                                                select_mode="sorted")
