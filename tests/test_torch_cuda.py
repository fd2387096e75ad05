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

    cc, cf = kernels.pair_stats(ci, cs, cn, W)
    gc, gf = kernels.pair_stats(gi, gs, gn, W)
    assert torch.equal(cc, gc.cpu()) and torch.equal(cf, gf.cpu())

    # K5 at i = W - 256 of a 100-merge run
    (ctl_c, slot_c, log_c), (ctl_g, slot_g, log_g) = _state(dev, 100, W)
    kernels.select_batch(cc, cf, ci, ctl_c, slot_c, log_c)
    kernels.select_batch(gc, gf, gi, ctl_g, slot_g, log_g)
    assert torch.equal(slot_c, slot_g.cpu()) and torch.equal(ctl_c,
                                                             ctl_g.cpu())
    assert torch.equal(log_c, log_g.cpu())
    rc = slot_c[:2]

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


def _state(dev, M, W):
    """(ctl, slot, log) of an M-merge run at i = W - 256, on the CPU and on
    the card."""
    ctl = kernels.new_ctl(M, "cpu")
    ctl[kernels.CTL_I] = W - 256
    slot = kernels.new_slot("cpu")
    log = torch.zeros((M, 4), dtype=torch.int32)
    cpu = (ctl, slot, log)
    return cpu, tuple(t.to(dev) for t in cpu)


def test_stopped_rounds_do_nothing(dev):
    ids, seg = _stream(1, 3000, 5)
    (ci, cs), (gi, gs) = _both(dev, ids, seg)
    n = torch.tensor([3000], dtype=torch.int32, device=dev)
    _, (ctl, slot, log) = _state(dev, 4, 258)
    ctl[kernels.CTL_FAIL] = 2
    cnt, first = kernels.pair_stats(gi, gs, n, 260, ctl)
    assert int(cnt.sum()) == 0 and int(first.max()) == -1
    slot[kernels.SLOT_BSEL] = 1
    kernels.select_batch(cnt, first, gi, ctl, slot, log)
    assert int(slot[kernels.SLOT_BSEL]) == 0
    assert ctl.tolist()[:3] == [2, 2, 0] and int(log.abs().sum()) == 0


def _batch_slot(dev, pairs, zbase):
    slot = kernels.new_slot("cpu")
    for j, (a, b) in enumerate(pairs):
        slot[2 * j], slot[2 * j + 1] = a, b
        slot[kernels.SLOT_COUNT + j] = 1000 - j
    slot[kernels.SLOT_BSEL] = len(pairs)
    slot[kernels.SLOT_ZBASE] = zbase
    slot[kernels.SLOT_I] = zbase - 256
    return slot, slot.to(dev)


@pytest.mark.parametrize("seed, n, k", [(0, 1, 2), (1, 2, 2), (2, 1500, 5),
                                        (3, 70_000, 16), (4, 0, 3)])
def test_batch_kernels_match_plain(dev, seed, n, k):
    """K6, K7, K8 and K4 on a slot of k disjoint candidates, against the
    plain versions; streams shorter than three tokens and empty included."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(100, 140, max(n, 2)).astype(np.int32)
    seg = np.cumsum(rng.random(max(n, 2)) < 0.2).astype(np.int32)
    pairs = list(zip(range(100, 100 + k), range(120, 120 + k)))
    ids[:2] = pairs[0]
    nt = np.array([n], np.int32)
    (ci, cs, cn), (gi, gs, gn) = _both(dev, ids, seg, nt)
    M = 40
    sc, sg = _batch_slot(dev, pairs, 290)
    (ctl_c, _, log_c), (ctl_g, _, log_g) = _state(dev, M, 290)
    acc_c, acc_g = kernels.new_hist("cpu"), kernels.new_hist(dev)
    cand_c, F_c = kernels.batch_mark(ci, cs, cn, sc, acc_c[0])
    cand_g, F_g = kernels.batch_mark(gi, gs, gn, sg, acc_g[0])
    assert torch.equal(cand_c[:n], cand_g[:n].cpu())
    assert torch.equal(F_c[:n], F_g[:n].cpu())
    kernels.batch_hist_rev(ci, cs, cn, cand_c, F_c, sc, acc_c[1])
    kernels.batch_hist_rev(gi, gs, gn, cand_g, F_g, sg, acc_g[1])
    assert torch.equal(acc_c, acc_g.cpu())
    out_c, live_c = torch.empty_like(ci), torch.empty(ci.shape, dtype=bool)
    out_g, live_g = torch.empty_like(gi), torch.empty(gi.shape, dtype=bool,
                                                      device=dev)
    kernels.batch_apply(ci, cn, cand_c, sc, acc_c, ctl_c, log_c, M, out_c,
                        live_c)
    kernels.batch_apply(gi, gn, cand_g, sg, acc_g, ctl_g, log_g, M, out_g,
                        live_g)
    assert torch.equal(out_c[:n], out_g[:n].cpu())
    assert torch.equal(live_c[:n], live_g[:n].cpu())
    assert torch.equal(sc, sg.cpu()) and torch.equal(ctl_c, ctl_g.cpu())
    assert torch.equal(log_c, log_g.cpu()) and int(acc_g.abs().sum()) == 0
    xc = kernels.compact(out_c, cs, live_c, cn, sc)
    xg = kernels.compact(out_g, gs, live_g, gn, sg)
    m = int(xc[2])
    assert int(xg[2]) == m
    assert torch.equal(xc[0][:m], xg[0][:m].cpu())
    assert torch.equal(xc[1][:m], xg[1][:m].cpu())


@pytest.mark.parametrize("seed", range(3))
def test_trainer_on_card_matches_cpu(dev, seed):
    """Whole batched runs: merges, counts, fail round and rebuilds."""
    from minbpe_tpu_torch.ops import train

    ids, seg = _stream(seed, 60_000, 40, 20_000, 3000)
    (ci, cs), (gi, gs) = _both(dev, ids, seg)
    want = train.train_merges(ci, cs, 200)
    rebuilds = train.LAST_REBUILDS
    got = train.train_merges(gi, gs, 200)
    assert all(np.array_equal(a, b) for a, b in zip(want[:2], got[:2]))
    assert want[2] == got[2] and train.LAST_REBUILDS == rebuilds < 200


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


@pytest.mark.parametrize("seed, n, V", [(0, 0, 300), (1, 1, 300),
                                        (2, 1025, 300), (3, 70_000, 1024),
                                        (4, 70_000, 2048), (5, 5000, 40)])
def test_pair_count_matches_plain(dev, seed, n, V):
    """K9 on short, tile-crossing and long streams, with a run of one id
    and, at V = 40, ids outside [0, V) that count nowhere."""
    ids, seg = _stream(seed, max(n, 1), 300, n // 2, min(3000, n // 3))
    nt = np.array([n], np.int32)
    (ci, cs, cn), (gi, gs, gn) = _both(dev, ids, seg, nt)
    got = kernels.pair_count(gi, gs, gn, V)
    assert torch.equal(kernels.pair_count_plain(ci, cs, cn, V), got.cpu())
    assert int(got.sum()) == int(((seg[:max(n - 1, 0)] == seg[1:n])
                                  & (ids[:max(n - 1, 0)] < V)
                                  & (ids[1:n] < V)).sum())


@pytest.mark.parametrize("mode", ["pallas", "sort", "dense", "stepped",
                                  "incremental"])
def test_selection_routes_on_card_match_cpu(dev, mode):
    """The explicit routes on the card against the CPU: merges, and K9
    launched on the pallas and stepped routes."""
    text = _words(5, 3000)
    g, c = BasicTokenizer(device="cuda"), BasicTokenizer(device="cpu")
    kernels.reset_launches()
    g.train(text, 300, select_mode=mode)
    c.train(text, 300, select_mode=mode)
    assert g.merges == c.merges
    want = {"pallas": 44, "stepped": 1, "incremental": 1}.get(mode, 0)
    assert kernels.PAIR_COUNT.launches == want


def test_checkpoint_resume_on_card(dev, tmp_path):
    text = _words(6, 3000)
    ck = str(tmp_path / "ck.npz")
    full = BasicTokenizer(device="cpu")
    full.train(text, 300)
    cut = BasicTokenizer(device="cuda")

    def stop(done, total):
        if done > 16:
            raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        cut.train(text, 300, checkpoint_path=ck, checkpoint_every=8,
                  progress=stop)
    resumed = BasicTokenizer(device="cuda")
    resumed.train(text, 300, resume_from=ck)
    assert resumed.merges == full.merges
