"""The CUDA kernels against their plain versions, on the card.

These need an NVIDIA GPU with nvcc; without one every test skips. On the
machine with the card:

    python -m pytest -m cuda tests/test_torch_cuda.py -q

The edge cases here are the ones a single smoke run does not reach: streams
shorter than one tile or not a multiple of it, runs of one id that cross
tiles and chunk ends, an empty stream, and whole training and encode runs
on the card against the CPU."""

import random

import numpy as np
import pytest
import torch

from minbpe_tpu_torch import BasicTokenizer, RegexTokenizer, kernels

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    kernels.build()
    return torch.device("cuda")


def _stream(seed, n, hi, run_at=None, run_len=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, hi, n).astype(np.int32)
    seg = np.cumsum(rng.random(n) < 0.25).astype(np.int32)
    if run_at is not None:
        ids[run_at:run_at + run_len] = 3
        seg[run_at:run_at + run_len] = seg[run_at]
        seg[run_at + run_len:] += 1
    return ids, seg


def _both(dev, *arrays):
    cpu = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    return cpu, [t.to(dev) for t in cpu]


CASES = [(0, 1, 0), (1, 1, 0), (2, 2, 0), (3, 1023, 500), (4, 1024, 1000),
         (5, 1025, 1020), (6, 5000, 900), (7, 70_000, 2047), (8, 0, 0)]


@pytest.mark.parametrize("seed, n, run_at", CASES)
def test_kernels_match_plain(dev, seed, n, run_at):
    W = 300
    run_len = min(3000, max(n - run_at, 0))
    ids, seg = _stream(seed, max(n, 1), 6, run_at, run_len)
    nt = np.array([n], np.int32)
    (ci, cs, cn), (gi, gs, gn) = _both(dev, ids, seg, nt)
    stop_c = torch.tensor([99], dtype=torch.int32)
    stop_g = stop_c.to(dev)

    cc, cf = kernels.pair_stats(ci, cs, cn, W, stop_c, 0)
    gc, gf = kernels.pair_stats(gi, gs, gn, W, stop_g, 0)
    assert torch.equal(cc, gc.cpu()) and torch.equal(cf, gf.cpu())

    rc = torch.zeros(4, dtype=torch.int32)
    rg = rc.to(dev)
    kernels.select_best(cc, cf, ci, stop_c, 0, rc)
    kernels.select_best(gc, gf, gi, stop_g, 0, rg)
    assert torch.equal(rc, rg.cpu()) and torch.equal(stop_c, stop_g.cpu())

    for pair in ((3, 3), (0, 1), tuple(rc[:2].tolist())):
        pc = torch.tensor(pair, dtype=torch.int32)
        kc = torch.zeros(1, dtype=torch.int32)
        kg = kc.to(dev)
        oc, lc = kernels.merge_apply(ci, cs, cn, pc, 777, kept=kc)
        og, lg = kernels.merge_apply(gi, gs, gn, pc.to(dev), 777, kept=kg)
        assert torch.equal(oc[:n], og[:n].cpu())
        assert torch.equal(lc[:n], lg[:n].cpu())
        assert torch.equal(kc, kg.cpu())
        xc = kernels.compact(oc, cs, lc, cn)
        xg = kernels.compact(og, gs, lg, gn)
        k = int(xc[2])
        assert int(xg[2]) == k
        assert torch.equal(xc[0][:k], xg[0][:k].cpu())
        assert torch.equal(xc[1][:k], xg[1][:k].cpu())


def test_stopped_rounds_do_nothing(dev):
    ids, seg = _stream(1, 3000, 5)
    (ci, cs), (gi, gs) = _both(dev, ids, seg)
    n = torch.tensor([3000], dtype=torch.int32, device=dev)
    stop = torch.tensor([2], dtype=torch.int32, device=dev)
    cnt, first = kernels.pair_stats(gi, gs, n, 256, stop, 2)
    assert int(cnt.sum()) == 0 and int(first.max()) == -1
    row = torch.zeros(4, dtype=torch.int32, device=dev)
    kernels.select_best(cnt, first, gi, stop, 3, row)
    assert row.tolist() == [0, 0, 0, 0] and int(stop) == 2


def _words(seed, n):
    rng = random.Random(seed)
    words = ["the ", "cat ", "sat ", "on ", "mat. ", "\n", "héllo ", "😉 "]
    return "".join(rng.choice(words) for _ in range(n))


# corpus -> (text, vocab size it can reach)
CORPORA = {
    "toy": ("aaabdaaabac", 259),
    "runs": ("a" * 5000 + "b" * 3 + "ab" * 700, 280),
    "text": (_words(3, 4000), 280),
}


@pytest.mark.parametrize("name", sorted(CORPORA))
@pytest.mark.parametrize("cls", [BasicTokenizer, RegexTokenizer])
def test_tokenizer_on_card_matches_cpu(dev, name, cls):
    text, vocab = CORPORA[name]
    g, c = cls(device="cuda"), cls(device="cpu")
    g.train(text, vocab)
    c.train(text, vocab)
    assert g.merges == c.merges
    ids = g.encode(text)
    assert ids == c.encode(text)
    assert g.decode(ids) == text
    docs = [text[:17], "", text[100:900], text]
    assert g.encode_batch(docs) == c.encode_batch(docs)


def test_too_small_corpus_fails_on_card(dev):
    with pytest.raises(ValueError, match="merge round 1"):
        BasicTokenizer(device="cuda").train("ab", 300)
    with pytest.raises(ValueError, match="merge round 0"):
        BasicTokenizer(device="cuda").train("", 300)
