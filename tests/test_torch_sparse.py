"""The port's sparse slot-table trainer (ops/train_sparse.py) on the CPU
against minbpe_tpu's (ops/train_sparse.py), on the same input: pairs,
counts and fail round, exactly, for the whole-run and the stepped loop;
tests/test_train_sparse.py's corpora, overlapping runs, ties, fail rounds
before M, a vocab above 2048, the capacity argument, the progress calls
and checkpoints across the two packages."""

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
from minbpe_tpu.ops import train_sparse as jsp  # noqa: E402

import minbpe_tpu_torch as port  # noqa: E402
from minbpe_tpu_torch.ops import train_sparse as psp  # noqa: E402
from minbpe_tpu_torch.utils import checkpoint as ckpt  # noqa: E402

# one padded size for the small corpora: minbpe_tpu compiles once per
# shape, merge count and capacity
CAPACITY = 1024


def _corpus(seed):
    """tests/test_train_sparse.py's random corpora."""
    rng = random.Random(seed * 13 + 5)
    seqs = [[rng.randint(0, rng.choice([2, 4, 8]))
             for _ in range(rng.randint(0, 40))]
            for _ in range(rng.randint(1, 8))]
    seqs.append([1, 1, 1, 1, 2, 1, 1, 1])  # overlap-run stress
    return seqs, rng.randint(1, 12)


CORPORA = [_corpus(s) for s in range(6)] + [
    ([[7] * 25, [7] * 6, [7, 8] * 10, [8] * 3], 8),  # overlapping runs
    ([[1, 2, 1, 2], [3, 4, 3, 4], [5, 6, 5, 6]], 8),  # ties, fails at 6
    ([[1, 2]], 5),                                    # fails at round 1
    ([[7] * 40, [1, 2, 3] * 3], 14),                  # fails mid-run
]


def _pack(seqs, capacity=CAPACITY):
    ids, seg, n = jstream.pack_chunks([bytes(s) for s in seqs], capacity)
    k = int(n)
    j = (jnp.asarray(ids), jnp.asarray(seg), jnp.asarray(n))
    return (ids, seg, n), j, (torch.from_numpy(ids[:k].copy()),
                              torch.from_numpy(seg[:k].copy()))


def _same(want, got):
    p1, c1, f1 = (np.asarray(x) for x in want)
    p2, c2, f2 = got
    assert int(f1) == f2
    assert np.array_equal(p1, p2) and np.array_equal(c1, c2)
    return f2


@pytest.mark.parametrize("k", range(len(CORPORA)))
def test_whole_run_matches_minbpe_tpu(k):
    seqs, M = CORPORA[k]
    _, j, p = _pack(seqs)
    _same(jsp.train_merges_sparse(*j, M), psp.train_merges_sparse(*p, M))


@pytest.mark.parametrize("k", range(len(CORPORA)))
def test_stepped_matches_minbpe_tpu(k):
    seqs, M = CORPORA[k]
    _, j, p = _pack(seqs)
    want = jsp.train_merges_sparse_stepped(*j, M, unroll=3)
    _same(want, psp.train_merges_sparse_stepped(*p, M, unroll=3))


def test_fail_rounds_before_m():
    for seqs, M in CORPORA[-3:]:
        _, _, p = _pack(seqs)
        pairs, counts, fail = psp.train_merges_sparse(*p, M)
        assert 0 < fail < M and counts[fail - 1] > 0
        assert not counts[fail:].any() and not pairs[fail:].any()


def test_above_vocab_2048_matches_minbpe_tpu():
    """1,800 merges (vocab 2,056) on 16 KB of seeded ids, both loops."""
    rng = np.random.default_rng(0)
    seqs = [rng.integers(0, 8, 4096).tolist() for _ in range(4)]
    M = 1800
    _, j, p = _pack(seqs, 16384)
    want = jsp.train_merges_sparse(*j, M)
    assert _same(want, psp.train_merges_sparse(*p, M)) == M
    _same(want, psp.train_merges_sparse_stepped(*p, M, unroll=64))


def test_capacity_is_honoured():
    """A given capacity is the table's size: one larger than the default
    trains as minbpe_tpu's with it, and one too small raises where
    minbpe_tpu drops the writes."""
    seqs, M = CORPORA[6]
    _, j, p = _pack(seqs)
    big = 4 * psp.table_capacity(CAPACITY)
    want = jsp.train_merges_sparse_stepped(*j, M, unroll=3, capacity=big)
    _same(want, psp.train_merges_sparse_stepped(*p, M, unroll=3,
                                                capacity=big))
    _same(want, psp.train_merges_sparse(*p, M, capacity=big))
    with pytest.raises(RuntimeError, match="capacity is 8"):
        psp.train_merges_sparse(*p, M, capacity=8)
    assert psp.table_capacity(1000) == 3072 == jsp.table_capacity(1000)
    assert psp.table_capacity(0) == 128 == jsp.table_capacity(0)


def test_progress_calls_and_checkpoints_match_minbpe_tpu(tmp_path):
    seqs = [list(b"the quick brown fox jumps over the lazy dog " * 8)]
    (ids, seg, n), j, p = _pack(seqs)
    fp = ckpt.corpus_fingerprint(ids, seg, n)
    M = 24
    seen = {"j": [], "p": []}
    paths = {w: str(tmp_path / f"{w}.ckpt.npz") for w in seen}
    kw = dict(unroll=5, checkpoint_every=10)
    jsp.train_merges_sparse_stepped(
        *j, M, checkpoint_path=paths["j"],
        progress=lambda d, t: seen["j"].append((d, t)), **kw)
    psp.train_merges_sparse_stepped(
        *p, M, checkpoint_path=paths["p"], fingerprint=fp,
        progress=lambda d, t: seen["p"].append((d, t)), **kw)
    assert seen["j"] == seen["p"] == [(5, 24), (10, 24), (15, 24), (20, 24),
                                      (24, 24)]
    a, b = ckpt.load(paths["j"]), ckpt.load(paths["p"])
    assert a["round_idx"] == b["round_idx"] == 20
    assert np.array_equal(a["pairs"], b["pairs"])
    assert np.array_equal(a["counts"], b["counts"])
    assert a["fingerprint"] == b["fingerprint"] == fp


@pytest.mark.parametrize("writer", ["minbpe_tpu", "port"])
def test_checkpoints_resume_across_packages(tmp_path, writer):
    seqs = [list(b"the quick brown fox jumps over the lazy dog " * 8)]
    (ids, seg, n), j, p = _pack(seqs)
    fp = ckpt.corpus_fingerprint(ids, seg, n)
    M = 24
    ck = str(tmp_path / "sp.ckpt.npz")
    full = jsp.train_merges_sparse(*j, M)
    kw = dict(unroll=5, checkpoint_path=ck, checkpoint_every=10)
    if writer == "minbpe_tpu":
        jsp.train_merges_sparse_stepped(*j, M, **kw)
        got = psp.train_merges_sparse_stepped(*p, M, unroll=5,
                                              resume_from=ck, fingerprint=fp)
    else:
        psp.train_merges_sparse_stepped(*p, M, fingerprint=fp, **kw)
        got = jsp.train_merges_sparse_stepped(*j, M, unroll=5,
                                              resume_from=ck)
        got = (np.asarray(got[0]), np.asarray(got[1]), int(got[2]))
    assert ckpt.load(ck)["round_idx"] == 20
    assert _same(full, got) == M


@pytest.mark.parametrize("cls", ["BasicTokenizer", "RegexTokenizer"])
def test_public_api_modes(cls):
    """select_mode "sparse" and "sparse_inc" through the tokenizers equal
    minbpe_tpu's merges."""
    text = ("sparse slot tables keep exact counts at any vocab. " * 30
            + "aaaa bbbb aaab abab " * 10)
    want = getattr(minbpe_tpu, cls)()
    want.train(text, 256 + 40, select_mode="sparse")
    for mode in ("sparse", "sparse_inc"):
        got = getattr(port, cls)(device="cpu")
        got.train(text, 256 + 40, select_mode=mode)
        assert got.merges == want.merges


def test_too_little_device_memory_raises(monkeypatch):
    """The check the trainer makes on the card before any work: 2^20
    tokens and their 3N slots fit in 1 GiB, 12·2^20 do not."""
    class CudaIds:
        is_cuda = True
        device = torch.device("cuda")

        def __init__(self, n):
            self.n = n

        def numel(self):
            return self.n

    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (1 << 30, 80 << 30))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda device=None: 0)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda device=None: 0)
    assert psp._capacity(CudaIds(1 << 20), None) == 3 << 20
    with pytest.raises(MemoryError, match="B/slot"):
        psp._capacity(CudaIds(12 << 20), None)
