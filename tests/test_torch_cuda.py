"""The CUDA kernels against their plain versions, on the card.

These need an NVIDIA GPU with nvcc; without one every test skips. On the
machine with the card:

    python -m pytest -m cuda tests/test_torch_cuda.py -q

The edge cases here are the ones a single smoke run does not reach: streams
shorter than one tile or not a multiple of it, runs of one id that cross
tiles and chunk ends, an empty stream, and whole training and encode runs
on the card against the CPU."""

import os
import random

import numpy as np
import pytest
import torch

from minbpe_tpu_torch import BasicTokenizer, RegexTokenizer, kernels

pytestmark = pytest.mark.cuda
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _batch_case(seed, n, k, kind):
    """(ids, seg, pairs) of a batch case: ids in [100, 140) with k disjoint
    candidates (100 + j, 120 + j); "hot": most positions one word whose
    pairs are candidate 0's site and its partners; "alias": ids also above
    1024, where id & 1023 names a candidate's id and the match table's
    hits are checked against the pairs."""
    rng = np.random.default_rng(seed)
    size = max(n, 2)
    ids = rng.integers(100, 140, size).astype(np.int32)
    seg = np.cumsum(rng.random(size) < 0.2).astype(np.int32)
    pairs = list(zip(range(100, 100 + k), range(120, 120 + k)))
    if kind == "hot":
        word = np.array([139, 100, 120, 139], np.int32)
        hot = rng.random(size // 4) < 0.9
        ids[:4 * (size // 4)] = np.where(
            hot[:, None], word, ids[:4 * (size // 4)].reshape(-1, 4)
        ).reshape(-1)
    elif kind == "alias":
        ids += 1024 * rng.integers(0, 2, size).astype(np.int32)
        pairs[1] = (1024 + pairs[1][0], pairs[1][1])
    ids[:2] = pairs[0]
    return ids, seg, pairs


@pytest.mark.parametrize("seed, n, k, cap, kind", [
    (0, 1, 2, 1, ""), (1, 2, 2, 2, ""), (2, 1500, 5, 1500, ""),
    (3, 70_000, 16, 70_000, ""), (4, 0, 3, 0, ""),
    (5, 70_000, 16, 70_000, "hot"), (6, 3000, 16, 400_000, ""),
    (7, 30_000, 8, 30_000, "alias")])
def test_batch_kernels_match_plain(dev, seed, n, k, cap, kind):
    """K6, K8 and K4 on a slot of k disjoint candidates, against the plain
    versions; streams shorter than three tokens and empty included, one
    where one word (candidate 0's site) is most of the stream, one whose n
    is far below its capacity (K6's blocks past n return at once), and one
    with ids above 1024."""
    ids, seg, pairs = _batch_case(seed, cap, k, kind)
    nt = np.array([n], np.int32)
    (ci, cs, cn), (gi, gs, gn) = _both(dev, ids, seg, nt)
    zbase = 2100 if kind == "alias" else 290  # above every id
    M = zbase - 256 + 40
    sc, sg = _batch_slot(dev, pairs, zbase)
    (ctl_c, _, log_c), (ctl_g, _, log_g) = _state(dev, M, zbase)
    acc_c, acc_g = kernels.new_hist("cpu"), kernels.new_hist(dev)
    cand_c = kernels.batch_hist(ci, cs, cn, sc, acc_c,
                                torch.full_like(ci, 777))
    cand_g = kernels.batch_hist(gi, gs, gn, sg, acc_g,
                                torch.full_like(gi, 777))
    assert torch.equal(cand_c, cand_g.cpu())  # from n on: left as it was
    assert torch.equal(acc_c, acc_g.cpu())
    if kind == "hot":
        assert int(acc_c[1, 139 & 127, 0]) > n // 16
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


# K1 and K9's counting core: each block of a persistent grid counts one
# contiguous range of chunks of TILE pair positions into a shared-memory
# table of 1 << log2 slots. Each case: (ids, seg, n, V, ctl's i or None,
# log2, grid), 0 in log2 or grid for the kernels' own choice.
def _uniform(seed, n, hi):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, hi, n).astype(np.int32),
            np.cumsum(rng.random(n) < 0.01).astype(np.int32))


def _one_pair(n, ends):
    """One pair, (5, 5), over the whole stream, its chunk cut before each
    position of ``ends``."""
    seg = np.zeros(n, np.int32)
    for e in ends:
        seg[e:] += 1
    return np.full(n, 5, np.int32), seg


def _hist_case(name):
    T = kernels.TILE
    if name == "overflow":  # ~10^6 distinct pairs: every table overflows
        return (*_uniform(40, 1 << 20, 1024), 1 << 20, 1024, None, 0, 0)
    if name == "overflow_tiny_table":  # 32 slots: most inserts go global
        return (*_uniform(41, 100_000, 1024), 100_000, 1024, None, 5, 0)
    if name == "one_pair_ranges":  # 3 blocks of 3 chunks; chunk ends on
        n = 9 * T + 1               # range ends, a chunk end and mid-chunk
        return (*_one_pair(n, (T, 3 * T, 6 * T, 7 * T + 100)), n, 300, None,
                0, 3)
    if name == "one_pair_default":
        n = 40 * T + 5
        return (*_one_pair(n, (T, 8 * T, 8 * T + 1, 33 * T)), n, 300, None,
                0, 0)
    if name.startswith("n_"):  # n at a range length (one chunk) +- 1
        n = T + int(name[2:])
        ids, seg = _stream(42, n, 6, T - 40, 80)
        return ids, seg, n, 300, None, 0, 0
    if name == "ctl_w_below_v":  # W = 300 < V = 1024; ids up to 400
        ids, seg = _stream(43, 50_000, 400, 10_000, 3000)
        return ids, seg, 50_000, 1024, 44, 0, 0
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "overflow", "overflow_tiny_table", "one_pair_ranges", "one_pair_default",
    "n_-1", "n_0", "n_1", "n_2", "ctl_w_below_v"])
def test_pair_hist_matches_plain(dev, name):
    """K1 (with ctl: into matrices that hold other values outside the
    W x W corner) and K9 against their plain versions."""
    ids, seg, n, V, i, log2, grid = _hist_case(name)
    nt = np.array([n], np.int32)
    (ci, cs, cn), (gi, gs, gn) = _both(dev, ids, seg, nt)
    rng = np.random.default_rng(7)
    junk = [torch.from_numpy(rng.integers(-9, 9, (V, V)).astype(np.int32))
            for _ in range(2)]
    ctl_c = ctl_g = None
    if i is not None:
        (ctl_c, _, _), (ctl_g, _, _) = _state(dev, 1000, 256 + i)
    want = kernels.pair_stats(ci, cs, cn, V, ctl_c,
                              out=tuple(j.clone() for j in junk))
    got = tuple(j.to(dev) for j in junk)
    lib = kernels._load()
    p = kernels._ptr
    kernels._run(dev, lib.bpe_pair_stats, p(gi), p(gs), p(gn), p(ctl_g),
                 p(got[0]), p(got[1]), V, n, log2, grid)
    assert torch.equal(want[0], got[0].cpu())
    assert torch.equal(want[1], got[1].cpu())
    if i is None:
        cnt = torch.empty((V, V), dtype=torch.int32, device=dev)
        kernels._run(dev, lib.bpe_pair_count, p(gi), p(gs), p(gn), p(cnt), V,
                     n, log2, grid)
        assert torch.equal(kernels.pair_count_plain(ci, cs, cn, V),
                           cnt.cpu())
        assert torch.equal(kernels.pair_count(gi, gs, gn, V), cnt)


def test_pair_stats_idle_ctl_leaves_matrices(dev):
    """An idle ctl (i at the fail round): neither the clear nor the count
    writes anything."""
    ids, seg = _stream(44, 30_000, 300)
    _, (gi, gs) = _both(dev, ids, seg)
    n = torch.tensor([30_000], dtype=torch.int32, device=dev)
    _, (ctl, _, _) = _state(dev, 100, 300)
    ctl[kernels.CTL_FAIL] = 44
    rng = np.random.default_rng(8)
    before = [torch.from_numpy(rng.integers(-9, 9, (300, 300)).astype(
        np.int32)).to(dev) for _ in range(2)]
    out = tuple(t.clone() for t in before)
    kernels.pair_stats(gi, gs, n, 300, ctl, out=out)
    assert torch.equal(out[0], before[0]) and torch.equal(out[1], before[1])


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


# ---------------------------------------------------------------------------
# K3 and K4 as single-pass kernels, K10 encode_sweep
# ---------------------------------------------------------------------------

TILE = kernels.TILE


def _apply_compact(dev, ids, seg, n, pair, z=777):
    """K3 then K4 on the card against their plain versions on the CPU."""
    nt = np.array([n], np.int32)
    (ci, cs, cn), (gi, gs, gn) = _both(dev, ids, seg, nt)
    pc = torch.tensor(pair, dtype=torch.int32)
    kc = torch.zeros(1, dtype=torch.int32)
    kg = kc.to(dev)
    oc, lc = kernels.merge_apply(ci, cs, cn, pc, z, kept=kc)
    og, lg = kernels.merge_apply(gi, gs, gn, pc.to(dev), z, kept=kg)
    assert torch.equal(oc[:n], og[:n].cpu())
    assert torch.equal(lc[:n], lg[:n].cpu())
    assert torch.equal(kc, kg.cpu())
    xc = kernels.compact(oc, cs, lc, cn)
    xg = kernels.compact(og, gs, lg, gn)
    k = int(xc[2])
    assert int(xg[2]) == k
    assert torch.equal(xc[0][:k], xg[0][:k].cpu())
    assert torch.equal(xc[1][:k], xg[1][:k].cpu())
    return int(kc)


@pytest.mark.parametrize("n", [0, 1, 2, TILE - 1, TILE, TILE + 1, 400_000])
def test_apply_compact_sizes(dev, n):
    """Streams of 0-2 tokens, one tile and a position either side of it,
    and the main path's 400K, each with a run of one id across its end."""
    ids, seg = _stream(n, max(n, 1), 5, max(n - 3000, 0), min(n, 2999))
    for pair in ((3, 3), (0, 1), (4, 4)):
        _apply_compact(dev, ids, seg, n, pair)


@pytest.mark.parametrize("tiles", [1, 2, 5])
def test_runs_spanning_tiles(dev, tiles):
    """A run of one id inside one chunk that covers parts of 1, 2 and 5
    tiles, odd and even lengths, starting mid-tile."""
    n = (tiles + 2) * TILE + 77
    for start, extra in ((TILE // 2 + 1, 0), (TILE + 5, 1)):
        length = max((tiles - 1) * TILE + 3 + extra, 2)
        ids, seg = _stream(tiles, n, 6, start, length)
        kept = _apply_compact(dev, ids, seg, n, (3, 3))
        assert kept >= length // 2


@pytest.mark.parametrize("bsel", [0, 1, 2])
def test_apply_compact_slot_mode(dev, bsel):
    """Slot mode: K3 runs for bsel == 1 only (the kept count to log row
    i), K4 for bsel >= 1; gated calls leave the log and the tile counter
    as they were, so the next call is still right."""
    n = 3 * TILE + 11
    ids, seg = _stream(11, n, 4, TILE - 7, 2 * TILE)
    nt = np.array([n], np.int32)
    (ci, cs, cn), (gi, gs, gn) = _both(dev, ids, seg, nt)
    sc, sg = _batch_slot(dev, [(3, 3), (0, 1)][:max(bsel, 1)], 290)
    sc[kernels.SLOT_BSEL] = bsel
    sg[kernels.SLOT_BSEL] = bsel
    (_, _, log_c), (_, _, log_g) = _state(dev, 40, 290)
    oc, lc = kernels.merge_apply(ci, cs, cn, slot=sc, log=log_c)
    og, lg = kernels.merge_apply(gi, gs, gn, slot=sg, log=log_g)
    assert torch.equal(log_c, log_g.cpu())
    if bsel == 1:
        assert torch.equal(oc[:n], og[:n].cpu())
        assert torch.equal(lc[:n], lg[:n].cpu())
        assert int(log_g[34, 3]) > 0
    else:  # the batch kernels write these in the trainer
        lc = torch.from_numpy(np.random.default_rng(bsel).random(n) < 0.7)
        lg = lc.to(dev)
        oc, og = ci, gi
    xc = kernels.compact(oc, cs, lc, cn, sc)
    xg = kernels.compact(og, gs, lg, gn, sg)
    if bsel >= 1:
        k = int(xc[2])
        assert int(xg[2]) == k
        assert torch.equal(xc[0][:k], xg[0][:k].cpu())
        assert torch.equal(xc[1][:k], xg[1][:k].cpu())
    _apply_compact(dev, ids, seg, n, (3, 3))
    state, _ = kernels._lookback_state(gi.device, n)
    assert int(state[0]) == 0


def test_status_words_across_calls(dev):
    """Three K3 / K4 rounds back to back on one status scratch, each over
    other data and sizes: the generation tag keeps every launch from
    reading an earlier launch's words."""
    for r, n in enumerate((5 * TILE + 3, 2 * TILE, 7 * TILE - 1)):
        ids, seg = _stream(20 + r, n, 3, r * TILE + 9, 3 * TILE)
        for pair in ((3, 3), (r % 3, r % 3), (1, 2)):
            _apply_compact(dev, ids, seg, n, pair)
    state, gen = kernels._lookback_state(
        torch.empty(0, device=dev).device, 7 * TILE)
    assert int(state[0]) == 0 and gen > 18


def test_status_words_per_stream(dev):
    """K3 and K4 enqueued on two streams before either is read: each stream
    has its own status words and tile counter, and both equal the plain
    versions."""
    n = 5 * TILE + 3
    ids, seg = _stream(21, n, 3, TILE + 9, 3 * TILE)
    (ci, cs, cn), (gi, gs, gn) = _both(dev, ids, seg, np.array([n], np.int32))
    pc = torch.tensor((3, 3), dtype=torch.int32)
    oc, lc = kernels.merge_apply(ci, cs, cn, pc, 777)
    want = kernels.compact(oc, cs, lc, cn)
    k = int(want[2])
    streams = [torch.cuda.Stream(dev), torch.cuda.Stream(dev)]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(dev))
    got, states = [], []
    for _ in range(3):
        for s in streams:
            with torch.cuda.stream(s):
                og, lg = kernels.merge_apply(gi, gs, gn, pc.to(dev), 777)
                got.append(kernels.compact(og, gs, lg, gn))
                states.append(kernels._lookback_state(gi.device, n)[0])
    torch.cuda.synchronize()
    assert states[0].data_ptr() != states[1].data_ptr()
    for xi, xs, xn in got:
        assert int(xn) == k
        assert torch.equal(xi[:k].cpu(), want[0][:k])
        assert torch.equal(xs[:k].cpu(), want[1][:k])
    assert all(int(st[0]) == 0 for st in states)


def _sweep_both(dev, ids, seg, pairs, new_ids):
    """K10 on the card against the plain rank loop on the CPU."""
    ci, cs = torch.from_numpy(ids), torch.from_numpy(seg)
    cp = torch.from_numpy(np.asarray(pairs, np.int32).reshape(-1, 2))
    cz = torch.from_numpy(np.asarray(new_ids, np.int32))
    wi, ws, wn = kernels.encode_sweep_plain(ci, cs, cp, cz)
    kernels.reset_launches()
    gi, gs, gn = kernels.encode_sweep(ci.to(dev), cs.to(dev), cp.to(dev),
                                      cz.to(dev))
    assert kernels.ENCODE_SWEEP.launches == 1
    assert kernels.MERGE_APPLY.launches == kernels.COMPACT.launches == 0
    k = int(wn)
    assert int(gn) == k
    assert torch.equal(wi[:k], gi[:k].cpu()) and torch.equal(ws[:k],
                                                              gs[:k].cpu())
    return k


def test_encode_sweep_smoke_size(dev):
    """A 400K-token stream and a 300-merge table trained on it."""
    from minbpe_tpu_torch.ops import train

    ids, seg = _stream(30, 400_000, 40, 100_000, 5001)
    _, (gi, gs) = _both(dev, ids, seg)
    pairs, _, fail = train.train_merges(gi, gs, 300)
    assert fail == 300
    assert _sweep_both(dev, ids, seg, pairs, 256 + np.arange(300)) < 400_000


def test_encode_sweep_run_of_one_byte(dev):
    """BasicTokenizer's 1 MiB of "a": one chunk, (97, 97) across every
    tile, then the pairs of its doubled tokens; a rank whose pair never
    occurs, and M = 0."""
    n = 1 << 20
    ids = np.full(n, 97, np.int32)
    seg = np.zeros(n, np.int32)
    pairs = [(97, 97), (5, 6)] + [(256 + r, 256 + r) for r in range(7)]
    new_ids = [256, 300] + [257 + r for r in range(7)]
    assert _sweep_both(dev, ids, seg, pairs, new_ids) == n >> 8
    assert _sweep_both(dev, ids[:5000], seg[:5000], np.zeros((0, 2)),
                       []) == 5000


def test_encode_sweep_one_block(dev):
    """A 1.5 KB document runs one block."""
    text = _words(8, 300).encode()[:1500]
    ids = np.frombuffer(text, np.uint8).astype(np.int32)
    seg = np.cumsum(ids == 32).astype(np.int32)
    assert kernels._load().bpe_encode_grid(ids.size, 0) == 1
    tok = BasicTokenizer(device="cpu")
    tok.train(_words(9, 2000), 320)
    pairs, new_ids = tok._merge_arrays()
    _sweep_both(dev, ids, seg, pairs, new_ids)


def test_encode_launches_once(dev):
    """encode, encode_batch and encode with specials: one K10 launch per
    device stream, no K3 or K4."""
    tok = RegexTokenizer(device="cuda")
    text = _words(10, 2000)
    tok.train(text, 270)
    tok.register_special_tokens({"<|x|>": 270})
    for fn, want in ((lambda: tok.encode(text), 1),
                     (lambda: tok.encode_batch([text[:50], text]), 1),
                     (lambda: tok.encode(text + "<|x|>" + text,
                                         allowed_special="all"), 1)):
        kernels.reset_launches()
        fn()
        assert kernels.ENCODE_SWEEP.launches == want
        assert kernels.MERGE_APPLY.launches == kernels.COMPACT.launches == 0


@pytest.mark.parametrize("n", [1, 2, TILE - 1, TILE, TILE + 1, 3 * TILE])
def test_encode_sweep_one_tile_edge(dev, n):
    """Streams of one tile stay in shared memory, longer ones take the
    grid path: both sides of the edge, on one chunk of "a" and on text."""
    tok = BasicTokenizer(device="cpu")
    tok.train(_words(11, 3000), 330)
    pairs, new_ids = tok._merge_arrays()
    text = np.frombuffer(_words(12, n).encode()[:n], np.uint8)
    for ids in (np.full(n, 97, np.int32), text.astype(np.int32)):
        seg = np.zeros(n, np.int32)
        run = [(97, 97), (256, 256), (257, 257)]
        _sweep_both(dev, ids, seg, run, [256, 257, 258])
        _sweep_both(dev, ids, seg, pairs, new_ids)


# ---------------------------------------------------------------------------
# K5 select_batch and K8 batch_apply as redesigned for Hopper
# ---------------------------------------------------------------------------

def _pair_stream(seed, pairs, counts, V, noise=0):
    """A stream of two-token chunks: pair j occurs counts[j] times, in a
    seeded order, after ``noise`` random ids below V in chunks of one
    (which count nowhere). K1's plain version gives its matrices, so
    ids[first] and ids[first + 1] are the pair, as in the trainer."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(np.repeat(np.arange(len(pairs)),
                                      np.asarray(counts, np.int64)))
    body = np.asarray(pairs, np.int32).reshape(-1, 2)[order].reshape(-1)
    ids = np.concatenate([rng.integers(0, V, noise).astype(np.int32), body])
    seg = np.concatenate([np.arange(noise),
                          noise + np.arange(body.size) // 2]).astype(np.int32)
    if ids.size == 0:
        ids, seg = np.zeros(1, np.int32), np.zeros(1, np.int32)
    t = [torch.from_numpy(a) for a in (ids, seg)]
    n = torch.tensor([body.size + noise], dtype=torch.int32)
    cnt, first = kernels.pair_stats_plain(t[0], t[1], n, V)
    return t[0], cnt, first


def _select_both(dev, ids, cnt, first, W, M=1000, scratch=None, junk=0):
    """K5 on the card against its plain version at W = 256 + i of an
    M-merge run; entries outside the W x W corner hold junk (both sides).
    Returns the CPU's (slot, ctl, log)."""
    V = cnt.shape[0]
    if junk:
        rng = np.random.default_rng(junk)
        cnt, first = cnt.clone(), first.clone()
        outer = torch.ones((V, V), dtype=torch.bool)
        outer[:W, :W] = False
        cnt[outer] = torch.from_numpy(
            rng.integers(1 << 20, 1 << 30, int(outer.sum())).astype(np.int32))
        first[outer] = 0
    (ctl_c, slot_c, log_c), (ctl_g, slot_g, log_g) = _state(dev, M, W)
    kernels.select_batch_plain(cnt, first, ids, ctl_c, slot_c, log_c)
    kernels.select_batch(cnt.to(dev), first.to(dev), ids.to(dev), ctl_g,
                         slot_g, log_g, scratch)
    assert torch.equal(slot_c, slot_g.cpu())
    assert torch.equal(ctl_c, ctl_g.cpu())
    assert torch.equal(log_c, log_g.cpu())
    return slot_c, ctl_c, log_c


def _spread(seed, k, W, rows=None):
    """k distinct pairs (a, b) below W, in rows ``rows`` (all rows if
    None), their counts between 2 and 9."""
    rng = np.random.default_rng(seed)
    rows = np.arange(W) if rows is None else np.asarray(rows)
    cells = set()
    while len(cells) < k:
        cells.add((int(rng.choice(rows)), int(rng.integers(0, W))))
    return sorted(cells), rng.integers(2, 10, k)


@pytest.mark.parametrize("V, W", [(1024, 256), (1024, 257), (1024, 1000),
                                  (1024, 1024), (1001, 1001), (300, 259)])
def test_select_widths(dev, V, W):
    """Corner widths that are and are not a multiple of 4, V not a multiple
    of 4 (the scalar loads), junk outside the corner; the Zipf stream of
    phase 2 at its width."""
    rng = np.random.default_rng(W)
    n = 60_000
    ids = np.minimum(rng.zipf(1.3, n) - 1, W - 1).astype(np.int32)
    seg = np.cumsum(rng.random(n) < 0.3).astype(np.int32)
    t_ids, t_seg = torch.from_numpy(ids), torch.from_numpy(seg)
    cnt, first = kernels.pair_stats_plain(
        t_ids, t_seg, torch.tensor([n], dtype=torch.int32), V)
    slot, _, _ = _select_both(dev, t_ids, cnt, first, W, junk=V + W)
    assert int(slot[kernels.SLOT_BSEL]) >= 1


@pytest.mark.parametrize("case", ["equal_counts", "one_row", "one_column",
                                  "spread", "fifteen", "one", "none",
                                  "homogeneous_first"])
def test_select_cases(dev, case):
    """Equal counts (first decides), the top 16 in one row or column or
    over many blocks, fewer than 16 non-zero entries, one, none (the fail
    round), and a homogeneous candidate 0 (a batch of one)."""
    V = W = 1024
    if case == "equal_counts":
        pairs, counts = _spread(1, 300, W)
        counts[:] = 3
    elif case == "one_row":
        pairs, counts = _spread(2, 40, W, rows=[517])
    elif case == "one_column":
        pairs = [(a, 77) for a in range(0, 1000, 25)]
        counts = np.random.default_rng(3).integers(2, 10, len(pairs))
    elif case == "spread":
        pairs, counts = _spread(4, 2000, W)
    elif case == "fifteen":
        pairs, counts = _spread(5, 15, W)
    elif case == "one":
        pairs, counts = [(900, 3)], [4]
    elif case == "none":
        pairs, counts = [], []
    else:
        pairs, counts = [(8, 8), (1, 2), (3, 4)], [9, 5, 4]
    ids, cnt, first = _pair_stream(6, pairs, counts, V, noise=500)
    slot, ctl, _ = _select_both(dev, ids, cnt, first, W)
    bsel = int(slot[kernels.SLOT_BSEL])
    if case == "none":
        assert bsel == 0 and int(ctl[kernels.CTL_FAIL]) == W - 256
    elif case in ("one", "homogeneous_first"):
        assert bsel == 1
    else:
        assert bsel >= 1


def test_select_idle_ctl(dev):
    """An idle ctl: only bsel = 0, nothing else written, the scratch left
    zero."""
    ids, cnt, first = _pair_stream(7, *_spread(7, 50, 300), 300)
    _, (ctl, slot, log) = _state(dev, 100, 300)
    ctl[kernels.CTL_FAIL] = 44
    slot[:] = 5
    scratch = kernels.select_scratch(300, dev)
    kernels.select_batch(cnt.to(dev), first.to(dev), ids.to(dev), ctl, slot,
                         log, scratch)
    assert int(slot[kernels.SLOT_BSEL]) == 0
    assert int((slot != 5).sum()) == 1
    assert ctl.tolist()[:3] == [44, 44, 0] and int(log.abs().sum()) == 0
    assert int(scratch.abs().sum()) == 0


def test_select_fifty_calls_one_scratch(dev):
    """50 calls in a row on one scratch, each at another width and on
    other matrices: each equals the plain version, and the done counter
    is back at 0 after every launch."""
    V = 1024
    scratch = kernels.select_scratch(V, dev)
    rng = np.random.default_rng(8)
    for r in range(50):
        W = int(rng.integers(256, V + 1))
        k = int(rng.integers(0, 60))
        ids, cnt, first = _pair_stream(100 + r, *_spread(100 + r, k, W), V,
                                       noise=int(rng.integers(0, 300)))
        _select_both(dev, ids, cnt, first, W, scratch=scratch)
        assert int(scratch[0]) == 0


def _apply_case(seed, n, bsel, stop=None, sites=(), density=0.1):
    """(ids, cand, slot, acc) of a batch of bsel candidates over n
    positions: random sites (adjacent ones too) plus ``sites``; counts
    1000 - j; the histograms crafted so that the trim stops after ``stop``
    candidates (None: no stop)."""
    rng = np.random.default_rng(seed)
    m = max(n, 1)
    ids = rng.integers(0, 256, m).astype(np.int32)
    cand = np.where(rng.random(m) < density, rng.integers(0, bsel, m),
                    -1).astype(np.int32)
    for p in sites:
        if p < m:
            cand[p] = int(rng.integers(0, bsel))
    slot = kernels.new_slot("cpu")
    for j in range(bsel):
        slot[2 * j], slot[2 * j + 1] = 100 + j, 130 + j
        slot[kernels.SLOT_COUNT + j] = 1000 - j
    slot[kernels.SLOT_BSEL] = bsel
    slot[kernels.SLOT_ZBASE] = 290
    slot[kernels.SLOT_I] = 34
    acc = rng.integers(0, 10, (2, kernels.HIST_BUCKETS, kernels.K_CAP))
    acc = np.where(rng.random(acc.shape) < 0.3, acc, 0).astype(np.int32)
    if stop is not None and stop < kernels.K_CAP:
        # cm[stop - 1] = count[stop]: candidate stop no longer beats it
        acc[rng.integers(0, 2), rng.integers(0, kernels.HIST_BUCKETS),
            stop - 1] = 1000 - stop
    return (torch.from_numpy(ids), torch.from_numpy(cand), slot,
            torch.from_numpy(acc))


def _apply_both(dev, ids, cand, n, slot, acc, M=100, scratch=None,
                offset=0):
    """K8 on the card against its plain version; with ``offset`` the
    outputs are views that many elements into their buffers (unaligned).
    Returns the trim's bstar."""
    cap = ids.numel()
    (ctl_c, _, log_c), (ctl_g, _, log_g) = _state(dev, M, 290)
    nt = torch.tensor([n], dtype=torch.int32)
    out_c = torch.full((cap,), -7, dtype=torch.int32)
    live_c = torch.zeros(cap, dtype=torch.bool)
    sc, ac = slot.clone(), acc.clone()
    kernels.batch_apply_plain(ids, nt, cand, sc, ac, ctl_c, log_c, M, out_c,
                              live_c)
    buf = torch.full((cap + offset,), -7, dtype=torch.int32, device=dev)
    lbuf = torch.zeros(cap + offset, dtype=torch.bool, device=dev)
    out_g, live_g = buf[offset:], lbuf[offset:]
    sg, ag = slot.to(dev), acc.to(dev)
    kernels.batch_apply(ids.to(dev), nt.to(dev), cand.to(dev), sg, ag, ctl_g,
                        log_g, M, out_g, live_g, scratch)
    assert torch.equal(out_c, out_g.cpu()) and torch.equal(live_c,
                                                           live_g.cpu())
    assert torch.equal(sc, sg.cpu()) and torch.equal(ctl_c, ctl_g.cpu())
    assert torch.equal(log_c, log_g.cpu())
    assert int(ag.abs().sum()) == 0 and int(ac.abs().sum()) == 0
    return int(sc[kernels.SLOT_BSTAR])


@pytest.mark.parametrize("stop", range(1, kernels.K_CAP + 1))
def test_batch_apply_trim_stops(dev, stop):
    """Histograms crafted so that the trim keeps exactly 1 .. 16
    candidates."""
    ids, cand, slot, acc = _apply_case(stop, 3 * TILE + 77, kernels.K_CAP,
                                       stop)
    assert _apply_both(dev, ids, cand, 3 * TILE + 77, slot, acc) == stop


@pytest.mark.parametrize("n, bsel, M", [(0, 3, 40), (1, 3, 40), (2, 2, 40),
                                        (5000, 16, 37), (5000, 5, 35),
                                        (400_000, 16, 40)])
def test_batch_apply_sizes(dev, n, bsel, M):
    """Streams of 0-2 tokens, M - i below bsel (the trim capped at 3 and
    1), and the main path's 400K tokens."""
    ids, cand, slot, acc = _apply_case(n + bsel, n, bsel)
    got = _apply_both(dev, ids, cand, n, slot, acc, M=M)
    assert got == min(bsel, M - 34)


@pytest.mark.parametrize("offset", [0, 1, 3])
def test_batch_apply_tile_edges(dev, offset):
    """Sites on either side of every warp boundary (256 positions) and
    tile boundary (2048), at the stream's last position, n not a multiple
    of 8; outputs 16-byte aligned and not (offset), and a stream longer
    than its n."""
    n = 2 * TILE + 5
    edges = [p + d for p in range(256, 2 * TILE + 1, 256) for d in (-1, 0)]
    ids, cand, slot, acc = _apply_case(9, n + 100, 7, sites=edges + [n - 1],
                                       density=0.02)
    assert _apply_both(dev, ids, cand, n, slot, acc, offset=offset) == 7


def test_batch_apply_fifty_calls_one_scratch(dev):
    """50 calls in a row on one scratch, over other sizes and trims: each
    equals the plain version, and the scratch is zero after every one."""
    scratch = kernels.batch_scratch(dev)
    rng = np.random.default_rng(10)
    for r in range(50):
        n = int(rng.integers(0, 30_000))
        bsel = int(rng.integers(2, kernels.K_CAP + 1))
        stop = int(rng.integers(1, bsel + 1))
        ids, cand, slot, acc = _apply_case(200 + r, n, bsel, stop)
        assert _apply_both(dev, ids, cand, n, slot, acc,
                           scratch=scratch) == stop
        assert int(scratch.abs().sum()) == 0


# ---------------------------------------------------------------------------
# K11 chunk_encode and K12 encode_min_sweep (the sorted route) against their
# plain version, and K10 on the dense route's new sizes
# ---------------------------------------------------------------------------

EDGE = kernels.CHUNK_WARP_MAX
# (97, 97) -> 256, its doublings, (z, 97) tails: homogeneous runs across
# lanes, words and chunks
RUN_TABLE = [(97, 97), (256, 256), (257, 257), (256, 97), (258, 97),
             (98, 97), (97, 98)]


def _flat_both(dev, chunks, pairs, new_ids):
    """The sorted route on the card against the plain one on the CPU, then
    K11 and K12 each against the plain version on the card's tensors.
    Returns the tokens."""
    from minbpe_tpu_torch.ops import flat_encode
    from minbpe_tpu_torch.ops.ranktab import CuckooPairTable

    data = np.frombuffer(b"".join(chunks), np.uint8)
    ends = np.cumsum([len(c) for c in chunks]).astype(np.int64)
    tg = CuckooPairTable(pairs, new_ids, dev)
    tc = CuckooPairTable(pairs, new_ids, "cpu")
    kernels.reset_launches()
    got = flat_encode.encode_offsets_arrays(data, ends, tg)
    L = np.diff(ends, prepend=0)
    short = L <= EDGE
    assert kernels.CHUNK_ENCODE.launches == int(short.any())
    assert kernels.ENCODE_MIN_SWEEP.launches == int((~short).any())
    assert kernels.ENCODE_SWEEP.launches == 0
    want = flat_encode.encode_offsets_arrays(data, ends, tc)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    N, C = len(data), len(ends)
    ids = torch.from_numpy(data.astype(np.int32)).to(dev)
    bounds = torch.from_numpy(np.r_[0, ends].astype(np.int32)).to(dev)
    if short.any():
        which = torch.from_numpy(np.flatnonzero(short).astype(np.int32)).to(
            dev)
        outs = []
        for fn in (kernels.chunk_encode, kernels.chunk_encode_plain):
            out = torch.full((N + 1,), -1, dtype=torch.int32, device=dev)
            lens = torch.zeros(C + 1, dtype=torch.int32, device=dev)
            fn(ids, bounds, which, tg, out, lens)
            outs.append((out, lens))
        assert torch.equal(outs[0][0], outs[1][0])
        assert torch.equal(outs[0][1], outs[1][1])
    if (~short).any():
        at = torch.from_numpy(np.flatnonzero(np.repeat(~short, L))).to(dev)
        seg = torch.from_numpy(np.repeat(np.arange(C, dtype=np.int32),
                                         L)).to(dev)
        gi, gs, gn = kernels.encode_min_sweep(ids[at], seg[at], tg)
        wi, ws, wn = kernels.encode_min_sweep_plain(ids[at], seg[at], tg)
        k = int(wn)
        assert int(gn) == k
        assert torch.equal(gi[:k], wi[:k]) and torch.equal(gs[:k], ws[:k])
    return got[0]


@pytest.mark.parametrize("sizes", [
    [EDGE - 1, EDGE, EDGE + 1],
    [1, EDGE, 1, EDGE + 1, 2, EDGE - 1],
    [EDGE + 1] * 3,
    [EDGE] * 3 + [3, 1],
    [1] * 3000 + [EDGE] * 40 + [33] * 500,
    [TILE - 1, TILE, TILE + 1, 5 * TILE + 3],
    [1 << 20],
])
@pytest.mark.parametrize("fill", ["run", "mixed"])
def test_sorted_route_kernels_match_plain(dev, sizes, fill):
    rng = np.random.default_rng(len(sizes))
    pairs = np.array(RUN_TABLE, np.int32)
    new_ids = 256 + np.arange(len(pairs), dtype=np.int32)
    chunks = [b"a" * n if fill == "run" else
              bytes(rng.choice([97, 98], n, p=[0.8, 0.2]).tolist())
              for n in sizes]
    _flat_both(dev, chunks, pairs, new_ids)


def test_sorted_route_ids_above_2_16(dev):
    pairs = np.array([(97, 98), (70_000, 99), (70_001, 97)], np.int32)
    new_ids = np.array([70_000, 70_001, 100_260], np.int32)
    got = _flat_both(dev, [b"abca", b"ab", b"abcabcab" * 40, b"abca" * 100],
                     pairs, new_ids)
    assert 100_260 in got.tolist()


@pytest.fixture(scope="module")
def gpt4_100k():
    from minbpe_tpu_torch import GPT4Tokenizer
    from minbpe_tpu_torch.utils.synthranks import synthetic_ranks

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ranks, _, specials = synthetic_ranks(100_256, seed=7)
    return (GPT4Tokenizer.from_mergeable_ranks(ranks, specials,
                                               device="cuda"),
            GPT4Tokenizer.from_mergeable_ranks(ranks, specials,
                                               device="cpu"))


def test_gpt4_100k_on_card_matches_cpu(dev, gpt4_100k):
    """GPT-4 width: the 100,000-merge cuckoo table (2^18 rows a table), the
    smoke corpus split and shuffled, and its first 64 KB as one chunk."""
    from minbpe_tpu_torch.engine import device_table
    from minbpe_tpu_torch.utils import golden

    g, c = gpt4_100k
    assert device_table(g).cuckoo.H <= 1 << 18
    text = golden.smoke_corpus(ROOT)
    ids = g.encode(text)
    assert ids == c.encode(text) and g.decode(ids) == text
    data, ends = g._split_arrays(text)
    chunks = [bytes(data[s:e]) for s, e in zip(np.r_[0, ends[:-1]], ends)]
    tab = device_table(c).cuckoo
    pairs, new_ids = tab.pairs.numpy(), tab.new_ids.numpy()
    _flat_both(dev, chunks[:5000], pairs, new_ids)
    _flat_both(dev, [bytes(data[:65536])], pairs, new_ids)


def test_sorted_route_launches(dev, gpt4_100k):
    """encode, encode_batch and specials: one K11 launch per device stream,
    K12 only for a chunk of more than 256 tokens, K10 never."""
    g, c = gpt4_100k
    text = _words(13, 3000)
    name = next(iter(g.special_tokens))
    for fn, k11, k12 in ((lambda t: t.encode(text), 1, 0),
                         (lambda t: t.encode_batch([text[:50], text]), 1, 0),
                         (lambda t: t.encode(text + name + "x" * 600,
                                             allowed_special="all"), 1, 1)):
        kernels.reset_launches()
        got = fn(g)
        assert (kernels.CHUNK_ENCODE.launches,
                kernels.ENCODE_MIN_SWEEP.launches,
                kernels.ENCODE_SWEEP.launches) == (k11, k12, 0)
        assert got == fn(c)


def test_encode_sweep_dense_table_limits(dev):
    """K10 past the fused Pallas encoder's bounds: 3,840 ranks (vocab
    4,096) on the smoke corpus, and the 12,588,338-byte XL corpus with the
    golden's 768 merges."""
    from minbpe_tpu_torch.utils import golden

    tok = RegexTokenizer(device="cpu")
    pairs, new_ids = golden.smoke_plus_merges(golden.DENSE_VOCAB)
    assert len(pairs) == 3840
    for text, p, z in ((golden.smoke_corpus(ROOT), pairs, new_ids),
                       (golden.xl_corpus(ROOT), golden.load_golden()["merges"],
                        256 + np.arange(768))):
        data, ends = tok._split_arrays(text)
        ids = torch.from_numpy(data.astype(np.int32)).to(dev)
        seg = torch.from_numpy(np.repeat(np.arange(len(ends), dtype=np.int32),
                                         np.diff(ends, prepend=0))).to(dev)
        pt = torch.from_numpy(np.asarray(p, np.int32)).to(dev)
        zt = torch.from_numpy(np.asarray(z, np.int32)).to(dev)
        wi, ws, wn = kernels.encode_sweep_plain(ids, seg, pt, zt)
        gi, gs, gn = kernels.encode_sweep(ids, seg, pt, zt)
        k = int(wn)
        assert int(gn) == k < len(data) // 2
        assert torch.equal(gi[:k], wi[:k]) and torch.equal(gs[:k], ws[:k])


# ---------------------------------------------------------------------------
# K13 pair_table, K14 table_select
# ---------------------------------------------------------------------------

def _table_round(t, ids, seg, n, fail, i, M=8):
    sel = torch.zeros(4, dtype=torch.int32, device=ids.device)
    pairs = torch.zeros((M, 2), dtype=torch.int32, device=ids.device)
    counts = torch.zeros(M, dtype=torch.int32, device=ids.device)
    kernels.pair_table(ids, seg, n, t, fail, i)
    contents = [x.cpu() for x in kernels.table_contents(t)]
    kernels.table_select(t, sel, pairs, counts, fail, i)
    return contents, sel.cpu(), pairs[i].cpu(), counts[i].cpu()


def _table_empty(t):
    return (int(t.used) == 0 and bool((t.key == -1).all())
            and not bool(t.cnt.any())
            and bool((t.first == kernels.EMPTY_FIRST).all()))


TABLE_CASES = {
    "hot_pair": lambda rng: (np.full(1 << 20, 97), np.zeros(1 << 20)),
    "all_distinct": lambda rng: (np.arange(1 << 20), np.zeros(1 << 20)),
    "ids_above_2_16": lambda rng: (rng.integers(60_000, 100_260, 300_000),
                                   np.cumsum(rng.random(300_000) < 0.2)),
    # more than 2048 of the counting core's 2048-position chunks, shared by
    # the persistent grid's blocks
    "many_chunks": lambda rng: (np.minimum(rng.zipf(1.3, (1 << 22) + 999),
                                           5000),
                                np.cumsum(rng.random((1 << 22) + 999)
                                          < 0.3)),
    "short": lambda rng: (np.array([4, 4, 4]), np.zeros(3)),
    "no_pair": lambda rng: (np.array([4, 5]), np.array([0, 1])),
}


@pytest.mark.parametrize("case", sorted(TABLE_CASES))
def test_pair_table_matches_plain(dev, case):
    from minbpe_tpu_torch.ops.select import select_max_pair

    a, s = TABLE_CASES[case](np.random.default_rng(11))
    ids = torch.from_numpy(np.asarray(a, np.int32)).to(dev)
    seg = torch.from_numpy(np.asarray(s, np.int32)).to(dev)
    n = torch.full((1,), ids.numel(), dtype=torch.int32, device=dev)
    fail = torch.full((1,), 8, dtype=torch.int32, device=dev)
    t = kernels.PairTable(ids.numel(), dev)
    plain = kernels.PairTable(ids.numel(), "cpu")
    pc = [x.cpu() for x in (ids, seg, n)]
    kernels.pair_table(*pc, plain)
    want = kernels.table_contents(plain)
    pa, pb, c, ok = select_max_pair(ids, seg, n)
    ref = ([int(pa), int(pb), int(c), 1] if bool(ok) else [-1, -1, 0, 0])
    for i in range(2):  # the second round reuses the table K14 emptied
        got, sel, row, cnt = _table_round(t, ids, seg, n, fail, i)
        assert all(torch.equal(x, y) for x, y in zip(got, want))
        assert sel.tolist() == ref
        assert row.tolist() == (ref[:2] if bool(ok) else [0, 0])
        assert int(cnt) == ref[2]
        assert _table_empty(t)
    assert int(fail) == (8 if bool(ok) else 0)


def test_table_second_round_sees_only_its_stream(dev):
    """Two rounds on different streams through one table: the second's
    table holds none of the first's keys."""
    rng = np.random.default_rng(2)
    t = kernels.PairTable(50_000, dev)
    fail = torch.full((1,), 8, dtype=torch.int32, device=dev)
    for i, hi in enumerate((300, 90_000)):
        a = rng.integers(0, hi, 50_000).astype(np.int32)
        if i == 1:
            a += 10_000  # no pair of round 0 can recur
        ids = torch.from_numpy(a).to(dev)
        seg = torch.zeros_like(ids)
        n = torch.full((1,), ids.numel(), dtype=torch.int32, device=dev)
        plain = kernels.PairTable(ids.numel(), "cpu")
        kernels.pair_table(ids.cpu(), seg.cpu(), n.cpu(), plain)
        got, _, _, _ = _table_round(t, ids, seg, n, fail, i)
        want = kernels.table_contents(plain)
        assert all(torch.equal(x, y) for x, y in zip(got, want))
        assert _table_empty(t)


def test_table_gated_after_fail(dev):
    ids = torch.tensor([1, 2, 1, 2], dtype=torch.int32, device=dev)
    n = torch.full((1,), 4, dtype=torch.int32, device=dev)
    t = kernels.PairTable(4, dev)
    fail = torch.full((1,), 2, dtype=torch.int32, device=dev)
    got, sel, _, _ = _table_round(t, ids, torch.zeros_like(ids), n, fail, 3)
    assert got[0].numel() == 0 and sel.tolist() == [-1, -1, 0, 0]
    assert int(fail) == 2 and _table_empty(t)


def test_table_refuses_a_small_table(dev):
    ids = torch.zeros(1000, dtype=torch.int32, device=dev)
    n = torch.full((1,), 1000, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="slots"):
        kernels.pair_table(ids, ids, n, kernels.PairTable(100, dev))


@pytest.fixture(scope="module")
def basic_3000_cpu():
    """3,000 merges on the smoke corpus's first 64 KB, BasicTokenizer on the
    CPU (the sort-round route's plain versions)."""
    from minbpe_tpu_torch.utils import golden

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    text = golden.smoke_corpus(ROOT)[:65536]
    tok = BasicTokenizer(device="cpu")
    tok.train(text, 256 + 3000, select_mode="sortloop_inc")
    return text, tok.merges


@pytest.mark.parametrize("mode", ["sortloop", "sortloop_inc", "sparse",
                                  "sparse_inc"])
def test_large_vocab_modes_match_cpu(dev, mode, basic_3000_cpu):
    """Each large-vocab mode on the card equals the CPU; the sort-round
    modes launch K13, K14, K3 and K4 once a round."""
    text, want = basic_3000_cpu
    tok = BasicTokenizer(device="cuda")
    kernels.reset_launches()
    tok.train(text, 256 + 3000, select_mode=mode)
    launches = {k.name: k.launches for k in kernels.KERNELS}
    if mode.startswith("sortloop"):
        assert launches["pair_table"] == launches["table_select"] >= 3000
        assert launches["merge_apply"] == launches["compact"] >= 3000
    else:
        assert not any(launches.values())
    assert tok.merges == want
