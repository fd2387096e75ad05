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
    assert kernels._load().bpe_encode_grid(ids.size) == 1
    tok = BasicTokenizer(device="cpu")
    tok.train(_words(9, 2000), 320)
    pairs, new_ids = tok._merge_arrays()
    _sweep_both(dev, ids, seg, pairs, new_ids)


def test_encode_launches_once(dev):
    """encode, encode_batch and encode with specials: one launch per device
    stream, K17 for a split text, K10 for a text of one chunk, no K3 or
    K4."""
    tok = RegexTokenizer(device="cuda")
    text = _words(10, 2000)
    tok.train(text, 270)
    tok.register_special_tokens({"<|x|>": 270})
    for fn, k17, k10 in ((lambda: tok.encode(text), 1, 0),
                         (lambda: tok.encode_batch([text[:50], text]), 1, 0),
                         (lambda: tok.encode(text + "<|x|>" + text,
                                             allowed_special="all"), 1, 0),
                         (lambda: tok.encode("hello"), 0, 1)):
        kernels.reset_launches()
        fn()
        assert kernels.SEGMENT_ENCODE.launches == k17
        assert kernels.ENCODE_SWEEP.launches == k10
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
    K11 and K12 each against the plain version on the card's tensors (K12
    also its rounds against the chunks' own: each chunk runs its own
    sweep). Returns the tokens."""
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
    at, long = np.flatnonzero(short), np.flatnonzero(~short)
    order, lanes = flat_encode.k11_order(L, short)
    # K11 with the short chunks first, with each a warp, and with all 32 to
    # a warp (a warp takes a lane's longer chunk); K12
    for kernel, pick, kw in (
            (kernels.chunk_encode, order, {"lanes": lanes}),
            (kernels.chunk_encode, at, {"lanes": 0}),
            (kernels.chunk_encode, at, {"lanes": at.size}),
            (kernels.encode_min_sweep, long, {"lengths": L[long].tolist()})):
        if not pick.size:
            continue
        which = torch.from_numpy(pick.astype(np.int32)).to(dev)
        outs = []
        for fn in (kernel, kernels.chunk_encode_plain):
            out = torch.full((N + 1,), -1, dtype=torch.int32, device=dev)
            lens = torch.zeros(C + 1, dtype=torch.int32, device=dev)
            fn(ids, bounds, which, tg, out, lens,
               **(kw if fn is kernel else {}))
            outs.append((out, lens))
        assert torch.equal(outs[0][0], outs[1][0])
        assert torch.equal(outs[0][1], outs[1][1])
    if (~short).any():
        rounds = torch.full((C,), -1, dtype=torch.int32, device=dev)
        out = torch.full((N + 1,), -1, dtype=torch.int32, device=dev)
        lens = torch.zeros(C + 1, dtype=torch.int32, device=dev)
        kernels.encode_min_sweep(ids, bounds, torch.from_numpy(
            long.astype(np.int32)).to(dev), tg, out, lens,
            lengths=L[long].tolist(), rounds=rounds)
        own, _ = kernels.sweep_rounds(ids, torch.from_numpy(
            np.repeat(np.arange(C, dtype=np.int32), L)).to(dev), tg)
        assert rounds[long].tolist() == own[long].tolist()
    return got[0]


@pytest.mark.parametrize("sizes", [
    [EDGE - 1, EDGE, EDGE + 1],
    [1, EDGE, 1, EDGE + 1, 2, EDGE - 1],
    [EDGE + 1] * 3,
    [EDGE] * 3 + [3, 1],
    [1] * 3000 + [EDGE] * 40 + [33] * 500,
    [TILE - 1, TILE, TILE + 1, 5 * TILE + 3],
    [1 << 20],
    [EDGE, EDGE + 1, EDGE + 2],
    [kernels.K11_LANE_MAX, kernels.K11_LANE_MAX + 1, 31, 32, 33, EDGE - 1],
    [kernels.K12_BLOCK_CAP, kernels.K12_BLOCK_CAP + 1],
    [kernels.K12_ONCHIP_CAP],
    [kernels.K12_ONCHIP_CAP + 1],
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


@pytest.mark.parametrize("length", [5000, 30_000, 100_000])
def test_k12_runs_across_borders(dev, length):
    """Runs of one byte (a, a) of odd and even lengths across a thread's,
    a warp's and a block's first positions (from the plan's slots a thread),
    in text of other bytes: the left-first parity crosses each."""
    jobs, cs, *_ = kernels.k12_plan([length])
    P = jobs[0][2]
    rng = np.random.default_rng(length)
    buf = bytearray(rng.choice([98, 99], length).tolist())
    for at, run in ((P, 5), (2 * P, 6), (32 * P, 9), (32 * P * 3, 10),
                    (kernels.K12_TPB * P, 13), (kernels.K12_TPB * P * 2, 4)):
        lo = max(0, at - run // 2)
        buf[lo:min(length, lo + run)] = b"a" * len(buf[lo:lo + run])
    pairs = np.array(RUN_TABLE + [(98, 99), (99, 98), (262, 262)], np.int32)
    new_ids = 256 + np.arange(len(pairs), dtype=np.int32)
    _flat_both(dev, [bytes(buf)], pairs, new_ids)


def test_k12_many_long_chunks(dev):
    """Many chunks of seeded lengths, from just past K11's tier to a
    cluster's, in one launch."""
    rng = np.random.default_rng(11)
    lengths = rng.integers(EDGE + 1, 3 * kernels.K12_BLOCK_CAP, 40)
    text = _words(12, 60_000).encode()
    chunks = [text[o:o + n] for o, n in
              zip(rng.integers(0, len(text) - lengths.max(), 40), lengths)]
    tok = BasicTokenizer(device="cpu")
    tok.train(_words(13, 20_000), 256 + 300)
    pairs, new_ids = tok._merge_arrays()
    _flat_both(dev, chunks + [b"x" * 300], pairs, new_ids)


def test_k12_refused_launch_raises(dev, monkeypatch):
    """A plan whose cluster is larger than the card takes: the launch is
    refused, the wrapper raises, and the next launch runs."""
    from minbpe_tpu_torch.ops.ranktab import CuckooPairTable

    plan = kernels.k12_plan

    t = CuckooPairTable(np.array(RUN_TABLE, np.int32),
                        256 + np.arange(len(RUN_TABLE), dtype=np.int32), dev)
    ids = torch.full((3000,), 97, dtype=torch.int32, device=dev)
    bounds = torch.tensor([0, 3000], dtype=torch.int32, device=dev)
    which = torch.zeros(1, dtype=torch.int32, device=dev)
    out = torch.full((3001,), -1, dtype=torch.int32, device=dev)
    lens = torch.zeros(2, dtype=torch.int32, device=dev)
    kernels.reset_launches()

    def too_large(lengths):
        jobs, _, ns, base, modes = plan(lengths)
        return [jobs[0]] * 64, 64, ns, base, modes

    monkeypatch.setattr(kernels, "k12_plan", too_large)
    with pytest.raises(RuntimeError, match="CUDA error"):
        kernels.encode_min_sweep(ids, bounds, which, t, out, lens,
                                 lengths=[3000])
    assert kernels.ENCODE_MIN_SWEEP.launches == 0
    monkeypatch.setattr(kernels, "k12_plan", plan)
    kernels.encode_min_sweep(ids, bounds, which, t, out, lens,
                             lengths=[3000])
    torch.cuda.synchronize()
    want_out = torch.full_like(out, -1)
    want_lens = torch.zeros_like(lens)
    kernels.chunk_encode_plain(ids, bounds, which, t, want_out, want_lens)
    assert torch.equal(out, want_out) and torch.equal(lens, want_lens)


def test_sorted_route_ids_above_2_16(dev):
    pairs = np.array([(97, 98), (70_000, 99), (70_001, 97)], np.int32)
    new_ids = np.array([70_000, 70_001, 100_260], np.int32)
    got = _flat_both(dev, [b"abca", b"ab", b"abcabcab" * 40, b"abca" * 100,
                           b"abca" * 10_000], pairs, new_ids)
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
# K13 pair_select
# ---------------------------------------------------------------------------

def _record(dev, M=8):
    return (torch.zeros(4, dtype=torch.int32, device=dev),
            torch.zeros((M, 2), dtype=torch.int32, device=dev),
            torch.zeros(M, dtype=torch.int32, device=dev))


def _select_round(t, ids, seg, n, fail, i, M=8):
    """One pair_select launch: (sel, log row i, count i) on the host."""
    sel, pairs, counts = _record(ids.device, M)
    kernels.pair_select(ids, seg, n, t, sel, pairs, counts, fail, i)
    return sel.cpu(), pairs[i].cpu(), counts[i].cpu()


def _plain_round(ids, seg, n, fail, i, M=8):
    """The same round by pair_select_plain on the CPU; fail is updated."""
    t = kernels.PairTable(ids.numel(), "cpu")
    sel, pairs, counts = _record("cpu", M)
    f = fail.cpu()
    kernels.pair_select_plain(ids.cpu(), seg.cpu(), n.cpu(), t, sel, pairs,
                              counts, f, i)
    return sel, pairs[i], counts[i], f


def _table_empty(t):
    return (int(t.used) == 0 and bool((t.key == -1).all())
            and not bool(t.cnt.any())
            and bool((t.first == kernels.EMPTY_FIRST).all()))


def _direct_stream(rng):
    """2^22 distinct ids, so each block's first chunk claims a shared slot
    for every pair and the block sends the rest of its range straight to
    the device table, with one hot pair (5, 6) at every 97th position from
    the second chunk on, so the winning count is the sum of those sends."""
    ids = np.arange(1 << 22) + 7
    at = np.arange(2048, 1 << 22, 97)
    ids[at], ids[at + 1] = 5, 6
    return ids, np.zeros(1 << 22)


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
    "direct": _direct_stream,
    "short": lambda rng: (np.array([4, 4, 4]), np.zeros(3)),
    "no_pair": lambda rng: (np.array([4, 5]), np.array([0, 1])),
}


@pytest.mark.parametrize("case", sorted(TABLE_CASES))
def test_pair_select_matches_plain(dev, case):
    """Two rounds on one table: each record equals pair_select_plain's and
    select_max_pair's, and the table is empty after each."""
    from minbpe_tpu_torch.ops.select import select_max_pair

    a, s = TABLE_CASES[case](np.random.default_rng(11))
    ids = torch.from_numpy(np.asarray(a, np.int32)).to(dev)
    seg = torch.from_numpy(np.asarray(s, np.int32)).to(dev)
    n = torch.full((1,), ids.numel(), dtype=torch.int32, device=dev)
    fail = torch.full((1,), 8, dtype=torch.int32, device=dev)
    t = kernels.PairTable(ids.numel(), dev)
    pa, pb, c, ok = select_max_pair(ids, seg, n)
    ref = ([int(pa), int(pb), int(c), 1] if bool(ok) else [-1, -1, 0, 0])
    for i in range(2):  # the second round reuses the table the first emptied
        want = _plain_round(ids, seg, n, fail, i)
        got = _select_round(t, ids, seg, n, fail, i)
        assert all(torch.equal(x, y) for x, y in zip(got, want))
        assert got[0].tolist() == ref
        assert _table_empty(t)
        assert torch.equal(fail.cpu(), want[3])
    assert int(fail) == (8 if bool(ok) else 0)
    if case == "direct":
        assert ref[:2] == [5, 6] and ref[2] > 40_000


def test_pair_select_second_round_sees_only_its_stream(dev):
    """Two rounds on different streams through one table: the second's
    record is its own stream's."""
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
        want = _plain_round(ids, seg, n, fail, i)
        got = _select_round(t, ids, seg, n, fail, i)
        assert all(torch.equal(x, y) for x, y in zip(got, want))
        assert _table_empty(t)


def test_pair_select_shrinking_stream(dev):
    """A table sized for 300,000 tokens, then rounds on live prefixes of
    the same buffers down to 1,000 tokens (a smaller hashed part of the
    table each round): each record equals the plain version's."""
    rng = np.random.default_rng(4)
    a = np.minimum(rng.zipf(1.2, 300_000) - 1, 100_000).astype(np.int32)
    s = np.cumsum(rng.random(300_000) < 0.2).astype(np.int32)
    ids = torch.from_numpy(a).to(dev)
    seg = torch.from_numpy(s).to(dev)
    t = kernels.PairTable(ids.numel(), dev)
    fail = torch.full((1,), 8, dtype=torch.int32, device=dev)
    for i, k in enumerate((300_000, 40_000, 5_000, 1_000, 300_000)):
        n = torch.full((1,), k, dtype=torch.int32, device=dev)
        want = _plain_round(ids, seg, n, fail, i)
        got = _select_round(t, ids, seg, n, fail, i)
        assert all(torch.equal(x, y) for x, y in zip(got, want))
        assert _table_empty(t)


def test_pair_select_fifty_rounds_one_table(dev):
    """50 rounds of the sort-round trainer (pair_select, merge_apply,
    compact) on one table and one scratch: the log, the counts and the
    fail round equal the CPU's, and the table is empty after the run."""
    from minbpe_tpu_torch.ops import train_sortloop as psl

    rng = np.random.default_rng(50)
    a = np.minimum(rng.zipf(1.3, 200_000) - 1, 3000).astype(np.int32)
    s = np.cumsum(rng.random(200_000) < 0.25).astype(np.int32)
    (ci, cs), (gi, gs) = _both(dev, a, s)
    states = []
    for ids, seg in ((ci, cs), (gi, gs)):
        st = psl._State(ids, seg, torch.full((1,), ids.numel(),
                                             dtype=torch.int32,
                                             device=ids.device), 50)
        for i in range(50):
            psl._round(st, i)
        states.append(st)
    cpu, card = states
    assert torch.equal(card.pairs.cpu(), cpu.pairs)
    assert torch.equal(card.cnts.cpu(), cpu.cnts)
    assert int(card.fail) == int(cpu.fail) == 50
    assert _table_empty(card.table)


def test_pair_select_gated_after_fail(dev):
    ids = torch.tensor([1, 2, 1, 2], dtype=torch.int32, device=dev)
    n = torch.full((1,), 4, dtype=torch.int32, device=dev)
    t = kernels.PairTable(4, dev)
    fail = torch.full((1,), 2, dtype=torch.int32, device=dev)
    sel, row, cnt = _select_round(t, ids, torch.zeros_like(ids), n, fail, 3)
    assert sel.tolist() == [-1, -1, 0, 0]
    assert row.tolist() == [0, 0] and int(cnt) == 0
    assert int(fail) == 2 and _table_empty(t)


def test_pair_select_refuses_a_small_table(dev):
    ids = torch.zeros(1000, dtype=torch.int32, device=dev)
    n = torch.full((1,), 1000, dtype=torch.int32, device=dev)
    fail = torch.full((1,), 8, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="slots"):
        kernels.pair_select(ids, ids, n, kernels.PairTable(100, dev),
                            *_record(dev), fail, 0)


def test_pair_select_refused_launch_raises(dev):
    """A grid larger than the blocks that fit at once: the cooperative
    launch is refused, and the wrapper raises instead of running
    anything else."""
    ids = torch.arange(1000, dtype=torch.int32, device=dev)
    n = torch.full((1,), 1000, dtype=torch.int32, device=dev)
    fail = torch.full((1,), 8, dtype=torch.int32, device=dev)
    t = kernels.PairTable(1000, dev)
    t.grid *= 4
    t.scratch = torch.zeros(2 * t.grid, dtype=torch.int64, device=dev)
    kernels.reset_launches()
    with pytest.raises(RuntimeError, match="CUDA error"):
        kernels.pair_select(ids, torch.zeros_like(ids), n, t, *_record(dev),
                            fail, 0)
    assert kernels.PAIR_SELECT.launches == 0 and _table_empty(t)


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
    modes launch K13, K3 and K4 once a round."""
    text, want = basic_3000_cpu
    tok = BasicTokenizer(device="cuda")
    kernels.reset_launches()
    tok.train(text, 256 + 3000, select_mode=mode)
    launches = {k.name: k.launches for k in kernels.KERNELS}
    if mode.startswith("sortloop"):
        assert launches["pair_select"] >= 3000
        assert (launches["merge_apply"] == launches["compact"]
                == launches["pair_select"])
    else:
        assert not any(launches.values())
    assert tok.merges == want


# ---------------------------------------------------------------------------
# K15 presplit_succ and presplit_orbit, and presplit_cluster
# (ops/device_presplit.py)
# ---------------------------------------------------------------------------

def _presplit_texts():
    """name -> text: the shapes of tests/test_torch_device_presplit.py, and
    runs of 2^20 bytes."""
    from minbpe_tpu_torch.utils import golden

    rng = random.Random(11)
    alpha = list("abcXYZ 019'\t\n\r!.,;-_é你٦\U0001F600\U0001D11E  ſK　٣")
    corpus = golden.smoke_corpus(ROOT)
    texts = {
        "cases": " | ".join([
            "Hello's world IT'S you'LL we've THEY'RE", "abc123456789def",
            "  spaces   and\t tabs ", "\n\nnewlines\r\n mix \n",
            "héllo wörld 你好世界 😊🎉 test", "x'll !'ll ''ll \n'll 12'll  'll",
            "word  \n  word", "\r\n\r\n", "𝕏 astral 𝄞 chars 🚀", "( )",
            "a  'b", " \r\n ", "'t"]),
        "fuzz": "".join(rng.choice(alpha) for _ in range(20_000)),
        "smoke": corpus,
        "one_char": "x",
        "astral": "𝕏𝕐 astral 𝄞 🚀🚀 x🚀y 𐐀𐐨 '𐐀 1𝟙2 \U0001F600  " * 300,
    }
    for log2 in (12, 16, 20):
        k = 1 << log2
        texts.update({
            f"spaces_{log2}": " " * k + "x",
            f"spaces_at_end_{log2}": "ab" + " " * k,
            f"letters_{log2}": " " + "a" * k + "!",
            f"digits_{log2}": "1" * k + " 22",
            f"crlf_{log2}": "x" + "\r\n" * (k // 2) + "  y",
            f"apostrophes_{log2}": "'" * k + "ll",
            f"o_before_letters_{log2}": "a " + "!" * k + "abc d",
        })
    return texts


PRESPLIT_TEXTS = ["cases", "fuzz", "smoke", "one_char", "astral"] + [
    f"{kind}_{log2}" for log2 in (12, 16, 20)
    for kind in ("spaces", "spaces_at_end", "letters", "digits", "crlf",
                 "apostrophes", "o_before_letters")]


@pytest.fixture(scope="module")
def presplit_texts():
    return _presplit_texts()


@pytest.mark.parametrize("mode", ["gpt4", "gpt2"])
@pytest.mark.parametrize("name", PRESPLIT_TEXTS)
def test_presplit_matches_plain(dev, presplit_texts, mode, name):
    """K15 against its plain twin (presplit_plain, on the CPU), each kernel
    against its own step's plain version on the same inputs, and the ends
    against the host scanner's: exact. The input is padded past n. A text
    of at most 8 tiles takes presplit_cluster, a longer one the pair;
    the pair also splits a short one, equal to the cluster's."""
    from minbpe_tpu_torch.ops import device_presplit as pdp
    from minbpe_tpu_torch.utils import native

    raw = presplit_texts[name].encode("utf-8")
    n = len(raw)
    data = torch.frombuffer(bytearray(raw + b" 1a" * 7), dtype=torch.uint8)
    gdata = data.to(dev)
    kernels.reset_launches()
    gb, gs = pdp.presplit_seg_ids(gdata, n, mode)
    torch.cuda.synchronize()
    short = n <= pdp.CLUSTER_MAX_N
    assert kernels.PRESPLIT_CLUSTER.launches == int(short)
    assert kernels.PRESPLIT_SUCC.launches == kernels.PRESPLIT_ORBIT.launches \
        == int(not short)
    cb, cs = pdp.presplit_plain(data, n, mode)
    assert torch.equal(gb[:n].cpu(), cb[:n])
    assert torch.equal(gs[:n].cpu(), cs[:n])
    # with a byte table the same launches write each byte's token id too
    byte_ids = _byte_table(dev, 5)
    kernels.reset_launches()
    tb, ts, ids = pdp.presplit_seg_ids(gdata, n, mode, byte_ids)
    assert kernels.PRESPLIT_CLUSTER.launches == int(short)
    assert kernels.PRESPLIT_ORBIT.launches == int(not short)
    assert torch.equal(tb[:n], gb[:n]) and torch.equal(ts[:n], gs[:n])
    assert torch.equal(ids[:n], byte_ids[gdata[:n].long()])
    pb, ps = pdp.presplit_orbit(pdp.presplit_succ(gdata, n, mode), n)
    assert torch.equal(pb[:n], gb[:n]) and torch.equal(ps[:n], gs[:n])
    f = pdp.presplit_succ(gdata, n, mode)
    cf = pdp.successor_plain(gdata, n, mode)
    assert torch.equal(f[:n], cf[:n])
    ob, os_ = pdp.presplit_orbit(cf, n)
    pb, ps = pdp.orbit_plain(cf, n)
    assert torch.equal(ob[:n], pb[:n]) and torch.equal(os_[:n], ps[:n])
    ends = np.flatnonzero(cb[:n].numpy()).tolist()[1:] + [n]
    assert ends == native.split_offsets(raw, 4 if mode == "gpt4" else 2
                                        ).tolist()


def _byte_table(dev, seed: int):
    """A byte table (int32[256]) on dev: a permutation of 256 ids past 255,
    so that an id left unwritten or taken from the wrong byte shows."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.permutation(256) * 7 + 300).astype(
        np.int32)).to(dev)


@pytest.mark.parametrize("n", [1, 4095, 4096, 4097, 32767, 32768, 32769])
def test_presplit_ids_edges(dev, presplit_texts, n):
    """K15 with a byte table at the tile and cluster edges (the cluster up
    to 32,768 bytes, the cooperative pair at 32,769), on the fuzz text and
    on 4-byte chars that straddle every tile edge, from an aligned and an
    unaligned start: the ids equal the gather through the table, and the
    boundaries and segment ids the split's without it."""
    from minbpe_tpu_torch.ops import device_presplit as pdp

    byte_ids = _byte_table(dev, n)
    fuzz = presplit_texts["fuzz"].encode("utf-8") * 2
    astral = ("a" * (4096 - (n % 4) - 1) + "😊" * 9000).encode("utf-8")
    for raw in (fuzz, astral):
        raw = raw[:n].decode("utf-8", errors="ignore").encode("utf-8")
        raw += b"x" * (n - len(raw))
        for lead in (0, 3):
            buf = torch.frombuffer(bytearray(b"\xff" * lead + raw + b"\n 7"),
                                   dtype=torch.uint8).to(dev)
            gdata = buf[lead:]
            for mode in ("gpt4", "gpt2"):
                gb, gs = pdp.presplit_seg_ids(gdata, n, mode)
                kernels.reset_launches()
                tb, ts, ids = pdp.presplit_seg_ids(gdata, n, mode, byte_ids)
                assert kernels.PRESPLIT_CLUSTER.launches == int(n <= 32768)
                assert torch.equal(tb[:n], gb[:n]), (n, lead, mode)
                assert torch.equal(ts[:n], gs[:n]), (n, lead, mode)
                assert torch.equal(ids[:n], byte_ids[gdata[:n].long()]), (
                    n, lead, mode)


@pytest.mark.parametrize("config", ["regex", "cl100k"])
def test_presplit_ids_cell_documents(dev, config):
    """K15's ids on each of an encode cell's 4,096 documents, through the
    byte table of the cell's tokenizer (the identity for
    minbpe-regex-v512, the byte shuffle of gpt4-cl100k's ranks), equal the
    gather through that table that the engine ran after K15 before it
    wrote them; its boundaries and segment ids equal those it writes
    without the table."""
    import json

    import chip_smoke
    from minbpe_tpu_torch.gpt4 import load_cl100k_ranks
    from minbpe_tpu_torch.ops import device_presplit as pdp

    if config == "regex":
        table = np.arange(256)
        traffic = chip_smoke.CELL_TRAFFIC
    else:
        with open(os.path.join(ROOT, "bpebench", "configs-ranks",
                               "gpt4-cl100k.json")) as f:
            ranks = load_cl100k_ranks(os.path.join(ROOT,
                                                   json.load(f)["ranks"]))
        table = np.array([ranks[bytes([b])] for b in range(256)])
        assert not np.array_equal(table, np.arange(256))
        traffic = chip_smoke.CL100K_TRAFFIC
    byte_ids = torch.from_numpy(table.astype(np.int32)).to(dev)
    data, lengths, starts = chip_smoke.cell_documents(np, 2**31 + 4242,
                                                      traffic)
    assert len(lengths) == 4096
    bad = []
    for i, (s, n) in enumerate(zip(starts.tolist(), lengths.tolist())):
        gdata = torch.frombuffer(bytearray(data[s:s + n]),
                                 dtype=torch.uint8).to(dev)
        gb, gs = pdp.presplit_seg_ids(gdata, n, 4)
        tb, ts, ids = pdp.presplit_seg_ids(gdata, n, 4, byte_ids)
        if not (torch.equal(ids, byte_ids[gdata.long()])
                and torch.equal(tb, gb) and torch.equal(ts, gs)):
            bad.append((i, n))
    assert not bad, bad[:10]


@pytest.mark.parametrize("case", ["regex", "gpt4_dense_synthetic"])
def test_device_split_runs_no_gather(dev, case):
    """A warm device-split encode under torch.profiler, in a process of its
    own: K15 and K17 run, and no index_elementwise or direct_copy kernel
    (the ids come from K15); one copy to the device (the text's bytes)."""
    import json
    import subprocess
    import sys

    code = f"""
import json, os, torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from minbpe_tpu_torch import GPT4Tokenizer, RegexTokenizer
from minbpe_tpu_torch.utils import golden
from minbpe_tpu_torch.utils.synthranks import synthetic_ranks
root = {ROOT!r}
if {case!r} == "regex":
    tok = RegexTokenizer(device="cuda")
    tok.load(os.path.join(root, "bpebench", "data", "minbpe-regex-v512.model"))
else:
    tok = GPT4Tokenizer.from_mergeable_ranks(
        synthetic_ranks(1000, seed=3)[0], device="cuda")
tok.device_presplit = True
text = golden.smoke_corpus(root)[:20_000]
want = tok.encode(text)
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
    got = tok.encode(text)
    torch.cuda.synchronize()
assert got == want
print(json.dumps([[e.key, e.count] for e in p.key_averages()
                  if e.device_type != DeviceType.CPU]))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=300)
    ops = dict(json.loads(out.stdout.strip().splitlines()[-1]))
    names = " ".join(ops)
    assert "presplit_cluster_kernel" in names, ops
    assert "segment_encode" in names, ops
    assert "index_elementwise" not in names, ops
    assert "direct_copy" not in names, ops
    assert sum(c for k, c in ops.items() if "HtoD" in k) == 1, ops


@pytest.mark.parametrize("mode", ["gpt4", "gpt2"])
def test_presplit_xl4_matches_plain(dev, mode):
    """The XL corpus four times over (50,353,352 bytes): K15 equals its
    plain twin run on the card, and its orbit lists more nodes than the
    one-block tier takes, so the path is marked grid-wide."""
    from minbpe_tpu_torch.ops import device_presplit as pdp
    from minbpe_tpu_torch.utils import golden

    raw = (golden.xl_corpus(ROOT) * 4).encode("utf-8")
    n = len(raw)
    data = torch.frombuffer(bytearray(raw), dtype=torch.uint8).to(dev)
    del raw
    kernels.reset_launches()
    gb, gs = pdp.presplit_seg_ids(data, n, mode)
    assert kernels.PRESPLIT_SUCC.launches == kernels.PRESPLIT_ORBIT.launches \
        == 1
    cb, cs = pdp.presplit_plain(data, n, mode)
    assert torch.equal(gb[:n], cb[:n]) and torch.equal(gs[:n], cs[:n])
    del cb, cs
    f = pdp.successor_plain(data, n, mode)
    assert torch.equal(pdp.presplit_succ(data, n, mode)[:n], f[:n])
    assert pdp.orbit_nodes(f, n) > kernels.PRESPLIT_BLOCK_NODES
    ob, os_ = pdp.presplit_orbit(f, n)
    assert torch.equal(ob[:n], gb[:n]) and torch.equal(os_[:n], gs[:n])


@pytest.mark.parametrize("seed, n", [(0, 1 << 20), (1, 3 * 4096 + 17),
                                     (2, 100)])
def test_presplit_orbit_forward_jumps(dev, seed, n):
    """presplit_orbit on any forward successor (random jumps up to four
    tiles long, a fifth of the bytes off a char start), against
    orbit_plain on the card: walks seldom merge, so a tile lists hundreds
    of exits, and past the one-block tier the path is marked grid-wide."""
    from minbpe_tpu_torch.ops import device_presplit as pdp

    rng = np.random.default_rng(seed)
    f = np.arange(n) + 1 + rng.integers(0, 4 * kernels.PRESPLIT_TILE, n)
    f[rng.random(n) < 0.2] = -1
    f[0] = 1 + rng.integers(0, 4 * kernels.PRESPLIT_TILE)
    f = torch.from_numpy(np.r_[f, [-1] * 3].astype(np.int32)).to(dev)
    kernels.reset_launches()
    gb, gs = pdp.presplit_orbit(f, n)
    assert kernels.PRESPLIT_ORBIT.launches == 1
    pb, ps = pdp.orbit_plain(f, n)
    assert torch.equal(gb[:n], pb[:n]) and torch.equal(gs[:n], ps[:n])
    if seed == 0:
        assert pdp.orbit_nodes(f, n) > kernels.PRESPLIT_BLOCK_NODES


def test_presplit_cuda_never_takes_plain(dev, monkeypatch):
    """A CUDA tensor goes to the kernels, never to a plain version: a
    short text to presplit_cluster, a long one to the pair."""
    from minbpe_tpu_torch.ops import device_presplit as pdp
    from minbpe_tpu_torch.utils import native

    def refuse(*a, **k):
        raise AssertionError("a plain version ran on a CUDA tensor")

    for name in ("presplit_plain", "successor_plain", "orbit_plain"):
        monkeypatch.setattr(pdp, name, refuse)
    raw = "Hello's world 123456 !!\r\n  x".encode()
    data = torch.frombuffer(bytearray(raw), dtype=torch.uint8).to(dev)
    kernels.reset_launches()
    b, s = pdp.presplit_seg_ids(data, len(raw), "gpt4")
    assert int(s[-1]) == 8 and bool(b[0])
    assert kernels.PRESPLIT_CLUSTER.launches == 1
    long = torch.frombuffer(bytearray(raw * 2000), dtype=torch.uint8).to(dev)
    b, s = pdp.presplit_seg_ids(long, long.numel(), "gpt4")
    chunks = len(native.split_offsets(raw * 2000, 4))
    assert int(s[-1]) == chunks - 1 and bool(b[0])
    assert kernels.PRESPLIT_SUCC.launches == kernels.PRESPLIT_ORBIT.launches \
        == 1


@pytest.mark.parametrize("mode", ["gpt4", "gpt2"])
@pytest.mark.parametrize("n", [1, 4095, 4096, 4097, 32767, 32768])
def test_presplit_cluster_edges(dev, presplit_texts, mode, n):
    """presplit_cluster at the tile and cluster edges equals presplit_plain
    and the cooperative pair, on the fuzz text (astral chars, CR/LF, digit
    runs) and on a text of 4-byte chars that straddle every tile edge."""
    from minbpe_tpu_torch.ops import device_presplit as pdp

    fuzz = presplit_texts["fuzz"].encode("utf-8")
    astral = ("a" * (4096 - (n % 4) - 1) + "😊" * 9000).encode("utf-8")
    for raw in (fuzz, astral):
        raw = raw[:n].decode("utf-8", errors="ignore").encode("utf-8")
        raw += b"x" * (n - len(raw))
        data = torch.frombuffer(bytearray(raw + b"\n 7"), dtype=torch.uint8)
        gdata = data.to(dev)
        kernels.reset_launches()
        gb, gs = pdp.presplit_cluster(gdata, n, mode)
        assert kernels.PRESPLIT_CLUSTER.launches == 1
        cb, cs = pdp.presplit_plain(data, n, mode)
        assert torch.equal(gb[:n].cpu(), cb[:n])
        assert torch.equal(gs[:n].cpu(), cs[:n])
        pb, ps = pdp.presplit_orbit(pdp.presplit_succ(gdata, n, mode), n)
        assert torch.equal(pb[:n], gb[:n]) and torch.equal(ps[:n], gs[:n])


@pytest.mark.parametrize("mode", ["gpt4", "gpt2"])
def test_presplit_cluster_cell_documents(dev, mode):
    """presplit_cluster on the regex512-encode-docs cell's documents, every
    eighth by length (128 to 32,768 bytes, every length band), equals
    presplit_plain and the cooperative pair."""
    import chip_smoke
    from minbpe_tpu_torch.ops import device_presplit as pdp

    data, lengths, starts = chip_smoke.cell_documents(np, 2**31 + 99)
    for i in np.argsort(lengths, kind="stable")[::8].tolist() + [
            int(np.argmax(lengths))]:
        raw = bytes(data[starts[i]:starts[i] + lengths[i]])
        n = len(raw)
        cpu = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
        gdata = cpu.to(dev)
        gb, gs = pdp.presplit_cluster(gdata, n, mode)
        cb, cs = pdp.presplit_plain(cpu, n, mode)
        assert torch.equal(gb.cpu(), cb) and torch.equal(gs.cpu(), cs), n
        pb, ps = pdp.presplit_orbit(pdp.presplit_succ(gdata, n, mode), n)
        assert torch.equal(pb, gb) and torch.equal(ps, gs), n


def test_presplit_route_launches(dev):
    """32,768 bytes launch presplit_cluster once and neither cooperative
    kernel; 32,769 launch the pair once each and no cluster; each call
    counts its route."""
    from minbpe_tpu_torch import trace
    from minbpe_tpu_torch.ops import device_presplit as pdp

    text = ("Hello's world 123 \r\n" * 2000).encode()
    for n, route in ((32768, "cluster"), (32769, "grid")):
        data = torch.frombuffer(bytearray(text[:n]), dtype=torch.uint8).to(dev)
        kernels.reset_launches()
        trace.reset()
        pdp.presplit_seg_ids(data, n, "gpt4")
        cluster = route == "cluster"
        assert kernels.PRESPLIT_CLUSTER.launches == int(cluster)
        assert kernels.PRESPLIT_SUCC.launches == int(not cluster)
        assert kernels.PRESPLIT_ORBIT.launches == int(not cluster)
        assert trace.COUNTERS == {f"presplit.route.{route}": 1}


@pytest.mark.parametrize("mode", ["gpt4", "gpt2"])
def test_split_spans_host_on_card(dev, presplit_texts, mode):
    """split_spans_host runs on the card by default (K15 once each) and
    gives the host scanner's spans."""
    from minbpe_tpu_torch.ops import device_presplit as pdp
    from minbpe_tpu_torch.utils import native

    text = presplit_texts["cases"] + presplit_texts["fuzz"]
    raw = text.encode("utf-8")
    kernels.reset_launches()
    spans = pdp.split_spans_host(text, mode)
    assert kernels.PRESPLIT_SUCC.launches == kernels.PRESPLIT_ORBIT.launches \
        == 1 - kernels.PRESPLIT_CLUSTER.launches
    ends = native.split_offsets(raw, 4 if mode == "gpt4" else 2).tolist()
    assert spans == list(zip([0] + ends[:-1], ends))
    assert pdp.split_spans_host("", mode) == []


@pytest.mark.parametrize("case", ["gpt4", "gpt2", "gpt4_dense_synthetic"])
def test_device_split_encode_on_card(dev, case, monkeypatch):
    """The opted-in encode on the card equals the host-split encode: K15
    once each, K17 once, no host scanner."""
    from minbpe_tpu_torch import GPT4Tokenizer
    from minbpe_tpu_torch.convert import tokenizer_from_arrays
    from minbpe_tpu_torch.regex import GPT2_SPLIT_PATTERN
    from minbpe_tpu_torch.utils import golden, native
    from minbpe_tpu_torch.utils.synthranks import synthetic_ranks

    text = golden.smoke_corpus(ROOT)
    if case == "gpt4_dense_synthetic":
        ranks, _, specials = synthetic_ranks(1000, seed=3)
        tok = GPT4Tokenizer.from_mergeable_ranks(ranks, specials,
                                                 device="cuda")
    else:
        merges = golden.load_golden()["merges"]
        tok = tokenizer_from_arrays(
            RegexTokenizer, merges, 256 + np.arange(len(merges)),
            pattern=GPT2_SPLIT_PATTERN if case == "gpt2" else None,
            device="cuda")
    want = tok.encode_ordinary(text)
    tok.device_presplit = True
    calls = []
    real = native.split_offsets
    monkeypatch.setattr(native, "split_offsets",
                        lambda *a: calls.append(1) or real(*a))
    kernels.reset_launches()
    got = tok.encode_ordinary(text)
    launches = {k.name: k.launches for k in kernels.KERNELS}
    assert got == want
    assert not calls
    assert launches == {**{k: 0 for k in launches}, "presplit_succ": 1,
                        "presplit_orbit": 1, "segment_encode": 1}


# ---------------------------------------------------------------------------
# K3's carry-in and K16 pair_summaries (the distributed trainer)
# ---------------------------------------------------------------------------

CARRY_CASES = [(0, 0, 0), (1, 1, 0), (2, 2, 0), (3, 5, 0), (4, 2047, 0),
               (5, 2048, 100), (6, 2049, 2040), (7, 70_000, 2047),
               (8, 6000, 0)]


@pytest.mark.parametrize("seed, n, run_at", CARRY_CASES)
@pytest.mark.parametrize("start", [0, 1])
def test_merge_apply_carry_in_matches_plain(dev, seed, n, run_at, start):
    """K3 from a carry-in of 0 and 1, with its transfer bits: equal to
    merge_apply_plain on a run pair (runs from token 0 and across tiles)
    and on a heterogeneous pair, and the gated launch that redoes carry-in
    1 over carry-in 0's output."""
    run_len = min(3000, max(n - run_at, 0))
    ids, seg = _stream(seed, max(n, 1), 6, run_at, run_len)
    nt = np.array([n], np.int32)
    (ci, cs, cn), (gi, gs, gn) = _both(dev, ids, seg, nt)
    carry = torch.tensor([start], dtype=torch.int32)
    for pair in ((3, 3), (0, 1)):
        pc = torch.tensor(pair, dtype=torch.int32)
        tc = torch.zeros(2, dtype=torch.int32)
        tg = torch.full((2,), 7, dtype=torch.int32, device=dev)
        want = kernels.merge_apply(ci, cs, cn, pc, 777, carry=carry, tf=tc)
        got = kernels.merge_apply(gi, gs, gn, pc.to(dev), 777,
                                  carry=carry.to(dev), tf=tg)
        assert torch.equal(want[0][:n], got[0].cpu()[:n])
        assert torch.equal(want[1][:n], got[1].cpu()[:n])
        assert torch.equal(tc, tg.cpu())
        # carry-in 0's output, then the gated launch at this carry-in
        out = kernels.merge_apply(gi, gs, gn, pc.to(dev), 777)
        kernels.merge_apply(gi, gs, gn, pc.to(dev), 777, carry=carry.to(dev),
                            gate=True, out=out)
        assert torch.equal(out[0].cpu()[:n], want[0][:n])
        assert torch.equal(out[1].cpu()[:n], want[1][:n])


def _summary_table(dev, n_rows):
    return kernels.PairTable(n_rows, dev, kernel="pair_summaries")


def _summaries(ids, seg, n, base, K):
    """K16's count on ids' device: (rows sorted by key, used, overflow)."""
    dev = ids.device
    t = _summary_table(dev, ids.numel())
    out = torch.zeros((K, 4), dtype=torch.int32, device=dev)
    used = torch.zeros(1, dtype=torch.int32, device=dev)
    over = torch.zeros(1, dtype=torch.int32, device=dev)
    kernels.pair_summaries(ids, seg, n, t, base, out, used, over)
    u = int(used)
    rows = out[:u].cpu().long()
    order = torch.argsort((rows[:, 0] << 32) | rows[:, 1])
    return rows[order], u, int(over), t


SUMMARY_CASES = dict(TABLE_CASES, empty=lambda rng: (np.zeros(1),
                                                     np.zeros(1)))


@pytest.mark.parametrize("case", sorted(SUMMARY_CASES))
@pytest.mark.parametrize("K", [1 << 17, 4])
def test_pair_summaries_match_plain(dev, case, K):
    """K16's count: the rows (in key order), the rows written and the
    overflow flag equal pair_summaries_plain's, the table is empty after
    it; K = 2^17 overflows on the 2^20 and 2^22 distinct ids."""
    a, s = SUMMARY_CASES[case](np.random.default_rng(11))
    n_val = 0 if case == "empty" else len(a)
    ids = torch.from_numpy(np.asarray(a, np.int32))
    seg = torch.from_numpy(np.asarray(s, np.int32))
    n = torch.full((1,), n_val, dtype=torch.int32)
    base = 3 * ids.numel()
    want, wu, wo, _ = _summaries(ids, seg, n, base, K)
    got, gu, go, t = _summaries(ids.to(dev), seg.to(dev), n.to(dev), base, K)
    assert (gu, go) == (wu, wo)
    if not wo:
        assert torch.equal(got, want)
    assert _table_empty(t)


@pytest.mark.parametrize("nb, bs, fill", [(1, 1, 0), (4, 100, 60),
                                          (4, 1 << 17, 90_000),
                                          (8, 3000, 3000)])
def test_pair_summaries_merge_matches_plain(dev, nb, bs, fill):
    """K16's merge of nb blocks of summary rows (pairs repeated across
    blocks with counts that tie): the champion equals
    pair_summaries_merge_plain's, and the table is empty after it."""
    rng = np.random.default_rng(nb * bs)
    rows = np.zeros((nb * bs, 4), np.int32)
    lens = np.full(nb, fill, np.int32)
    for j in range(nb):
        k = rng.choice(max(4 * fill, 1), fill, replace=False)
        r = rows[j * bs:j * bs + fill]
        r[:, 0], r[:, 1] = k // 300, k % 300
        r[:, 2] = rng.integers(1, 4, fill)
        r[:, 3] = rng.permutation(10 * fill + 10)[:fill] + j * 10 * fill
    rows_c = torch.from_numpy(rows)
    lens_c = torch.from_numpy(lens)
    want = torch.zeros(4, dtype=torch.int32)
    kernels.pair_summaries_merge(rows_c, lens_c, None, want)
    t = _summary_table(dev, nb * bs)
    got = torch.zeros(4, dtype=torch.int32, device=dev)
    kernels.pair_summaries_merge(rows_c.to(dev), lens_c.to(dev), t, got)
    assert got.cpu().tolist() == want.tolist()
    if fill == 0:
        assert want.tolist() == list(kernels.NO_CHAMPION)
    assert _table_empty(t)


def test_pair_summaries_needs_its_own_table(dev):
    ids = torch.zeros(8, dtype=torch.int32, device=dev)
    n = torch.full((1,), 8, dtype=torch.int32, device=dev)
    one = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="kernel='pair_summaries'"):
        kernels.pair_summaries(ids, ids, n, kernels.PairTable(8, dev), 0,
                               torch.zeros((4, 4), dtype=torch.int32,
                                           device=dev), one, one.clone())


@pytest.fixture
def nccl_world1(dev, tmp_path):
    """A world of one rank over NCCL on this card (a file store), with a
    timeout; destroyed after the test."""
    import datetime

    import torch.distributed as dist

    dist.init_process_group(
        "nccl", init_method=f"file://{tmp_path / 'store'}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=120),
        device_id=torch.device("cuda", 0))
    yield dev
    dist.destroy_process_group()


def test_distributed_world1_nccl_matches_single_device(nccl_world1):
    """World 1 over NCCL: every selection, the Basic byte path and the
    sharded encode equal the single-device route on the card, with the
    distributed round's launches (K1 or K16 twice, K3 twice, K4)."""
    from minbpe_tpu_torch.parallel import encode as pencode
    from minbpe_tpu_torch.parallel import train as ptrain
    from minbpe_tpu_torch.utils import golden

    text = golden.smoke_corpus(ROOT)[:50_000]
    single = RegexTokenizer(device="cuda")
    single.train(text, 256 + 200)
    data, ends = single._split_arrays(text)
    per_round = {"dense": {"pair_stats": 1, "merge_apply": 2, "compact": 1},
                 "sparse": {"pair_summaries": 2, "merge_apply": 2,
                            "compact": 1},
                 "owner": {"pair_summaries": 2, "merge_apply": 2,
                           "compact": 1}}
    for sel, each in per_round.items():
        kernels.reset_launches()
        got = ptrain.train_offsets_distributed(data, ends, 200,
                                               selection=sel)[0]
        assert got == single.merges, sel
        launches = {k.name: k.launches for k in kernels.KERNELS}
        assert launches == {**{k: 0 for k in launches},
                            **{k: 200 * c for k, c in each.items()}}
    raw = text.encode("utf-8")[:8000].decode("utf-8", "ignore")
    basic = BasicTokenizer(device="cuda")
    basic.train(raw, 256 + 60)
    assert ptrain.train_bytes_distributed(raw.encode("utf-8"),
                                          60)[0] == basic.merges
    assert pencode.encode_text_distributed(single, text) == \
        single.encode_ordinary(text)


@pytest.mark.parametrize("selection", ["dense", "sparse", "owner"])
def test_distributed_rounds_never_sync(nccl_world1, selection):
    """A run's rounds read nothing back to the host (CUDA's sync debug mode
    set to raise around them): the fail round and the overflow flag stay
    on the device until the run's end, as the JAX program is one jit."""
    from minbpe_tpu_torch.parallel import train as ptrain
    from minbpe_tpu_torch.parallel.comm import Comm
    from minbpe_tpu_torch.utils import golden

    text = golden.smoke_corpus(ROOT)[:50_000]
    data, ends = RegexTokenizer(device="cpu")._split_arrays(text)
    ids, seg, lens = ptrain.shard_offsets(data, ends, 1)
    M = 100
    st = ptrain._Rank(Comm(), ids, seg, int(lens[0]), ids.shape[0], M,
                      selection)
    pairs = torch.zeros((M, 2), dtype=torch.int32, device="cuda")
    counts = torch.zeros(M, dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(M):
            st.round(i, pairs, counts, i)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    single = RegexTokenizer(device="cuda")
    single.train(text, 256 + M)
    got = {tuple(p): 256 + i for i, p in enumerate(pairs.tolist())}
    assert int(st.fail) == M and got == single.merges


def test_precompile_launches_train_and_encode(dev):
    """precompile on the card builds and loads both libraries, then trains
    (K1 among the whole-run trainer's kernels) and encodes (K17 a split
    text, K10 a text of one chunk)."""
    from minbpe_tpu_torch import precompile
    from minbpe_tpu_torch.utils.precompile import fused_capacity

    kernels.reset_launches()
    done = precompile([5000], vocab_size=300)
    assert [b for b, _ in done] == [fused_capacity(5000)]
    assert kernels.PAIR_STATS.launches > 0
    assert kernels.ENCODE_SWEEP.launches > 0
    assert kernels.SEGMENT_ENCODE.launches > 0


def _sorted_tables(dev):
    from minbpe_tpu_torch.ops.ranktab import SortedPairTable
    from minbpe_tpu_torch.utils import golden

    m = golden.load_golden()["merges"]
    new_ids = 256 + np.arange(len(m))
    return (SortedPairTable(m, new_ids, device="cpu"),
            SortedPairTable(m, new_ids, device=dev))


def test_chunk_encoder_on_card_matches_cpu(dev):
    """Every bucket, empty chunks and one chunk past the largest bucket."""
    from minbpe_tpu_torch.ops import chunk_encode
    from minbpe_tpu_torch.utils import golden

    corpus = golden.smoke_corpus(ROOT).encode("utf-8")
    lengths = [0, 1, 16, 17, 40, 100, 200, 400, 900, 2000, 4000, 8000, 9000]
    rng = np.random.default_rng(3)
    chunks = []
    for ln in lengths:
        at = int(rng.integers(0, len(corpus) - ln))
        chunks.append(corpus[at:at + ln])
    data = np.frombuffer(b"".join(chunks), np.uint8)
    ends = np.cumsum(lengths)
    cpu, gpu = _sorted_tables(dev)
    kernels.reset_launches()
    got = chunk_encode.encode_offsets_arrays(data, ends, gpu)
    want = chunk_encode.encode_offsets_arrays(data, ends, cpu)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    # the oversized chunk went through K3 and K4, one launch a round each
    assert kernels.MERGE_APPLY.launches == kernels.COMPACT.launches > 0
    assert chunk_encode.encode_chunk_list(chunks, gpu) == want[0].tolist()


@pytest.mark.parametrize("nbytes", [1, 2, 9000, 20_000])
def test_encode_stream_sorted_launches(dev, nbytes):
    """K3 and K4 once a round: every applied round, then the rest of the
    last group of 8 (the first round that finds no pair among them)."""
    from minbpe_tpu_torch.ops.encode import encode_stream_sorted
    from minbpe_tpu_torch.ops.ranktab import CuckooPairTable
    from minbpe_tpu_torch.ops.stream import pack_bytes
    from minbpe_tpu_torch.utils import golden

    data = golden.smoke_corpus(ROOT).encode("utf-8")[:nbytes]
    cpu, gpu = _sorted_tables(dev)
    ids, seg, n = pack_bytes(data)
    want_ids, want_n = encode_stream_sorted(ids, seg, n, cpu)
    kernels.reset_launches()
    got_ids, got_n = encode_stream_sorted(ids, seg, n, gpu)
    launches = {k.name: k.launches for k in kernels.KERNELS}
    k = int(want_n)
    assert int(got_n) == k
    assert torch.equal(got_ids[:k].cpu(), want_ids[:k])
    m = golden.load_golden()["merges"]
    table = CuckooPairTable(m, 256 + np.arange(len(m)), "cpu")
    t = torch.from_numpy(ids[:nbytes].astype(np.int32))
    rounds = int(kernels.sweep_rounds(t, torch.zeros_like(t), table)[0][0])
    each = 8 * (rounds // 8 + 1)
    assert launches == {**{name: 0 for name in launches},
                        "merge_apply": each,
                        "compact": each}


# ---------------------------------------------------------------------------
# K17 segment_encode: each segment's own loop, against its plain twin and K10
# ---------------------------------------------------------------------------

def _smoke_tables(dev, pairs=None, new_ids=None):
    from minbpe_tpu_torch.ops.ranktab import CuckooPairTable
    from minbpe_tpu_torch.utils import golden

    if pairs is None:
        pairs = golden.load_golden()["merges"]
        new_ids = 256 + np.arange(len(pairs))
    return (CuckooPairTable(pairs, new_ids, "cpu"),
            CuckooPairTable(pairs, new_ids, dev))


def _segments(lengths, text=None):
    """(ids, seg) of consecutive text bytes cut into segments of these
    lengths (the smoke corpus over and over where text is None)."""
    from minbpe_tpu_torch.utils import golden

    n = int(np.sum(lengths))
    data = (text or golden.smoke_corpus(ROOT)).encode("utf-8")
    data = (data * (n // len(data) + 1))[:n]
    ids = np.frombuffer(data, np.uint8).astype(np.int32)
    seg = np.repeat(np.arange(len(lengths), dtype=np.int32),
                    np.asarray(lengths, np.int64))
    return ids, seg


def _k17_both(dev, ids, seg, tables):
    """K17 on the card against its plain twin on the CPU and K10 on the
    card, bit for bit: ids, seg and the count."""
    cpu, gpu = tables
    ci, cs = torch.from_numpy(ids), torch.from_numpy(seg)
    wi, ws, wn = kernels.segment_encode_plain(ci, cs, cpu)
    kernels.reset_launches()
    gi, gs, gn = kernels.segment_encode(ci.to(dev), cs.to(dev), gpu)
    si, ss, sn = kernels.encode_sweep(ci.to(dev), cs.to(dev), gpu.pairs,
                                      gpu.new_ids)
    assert kernels.SEGMENT_ENCODE.launches == 1
    k = int(wn)
    assert int(gn) == int(sn) == k
    for got in ((gi, gs), (si, ss)):
        assert torch.equal(got[0][:k].cpu(), wi[:k])
        assert torch.equal(got[1][:k].cpu(), ws[:k])
    return k


@pytest.mark.parametrize("n", [1, 2, 255, 256, 257, 511, 512, 513, 3000,
                               70_000, 400_000])
@pytest.mark.parametrize("mean", [4, 40])
def test_segment_encode_matches_plain(dev, n, mean):
    """Streams of short segments (a lane's and a warp's) of every tile
    edge: K17 equals its plain twin and K10."""
    rng = np.random.default_rng(n + mean)
    lengths = []
    while sum(lengths) < n:
        lengths.append(int(min(rng.geometric(1 / mean), 256)))
    lengths[-1] -= sum(lengths) - n
    _k17_both(dev, *_segments(lengths), _smoke_tables(dev))


@pytest.mark.parametrize("long", [257, 300, 2048, 2049, 5000, 20_000,
                                  70_000])
@pytest.mark.parametrize("at", [0, 100, 255, 256])
def test_segment_encode_long_segments(dev, long, at):
    """A segment past CHUNK_MAX (the block's loop in device memory, one
    tile of 2,048 tokens or more) starting at each place of a block's tile,
    between short ones, twice, and one at the stream's end."""
    rng = np.random.default_rng(long + at)
    head = []
    while sum(head) < at:
        head.append(int(min(rng.integers(1, 6), at - sum(head))))
    lengths = head + [long, 3, 1, 7, long, 2] + [5] * 60 + [long]
    _k17_both(dev, *_segments(lengths), _smoke_tables(dev))


def test_segment_encode_runs_of_one_byte(dev):
    """Runs of "a" of every length 1 .. 600 and one of 100,000, with (a, a)
    and its doublings ranked: the even-offset rule in a lane, a warp and
    the block's loop in device memory, one tile and many; and a table of
    no merge."""
    pairs = [(97, 97), (256, 256), (257, 257), (258, 258), (256, 97),
             (120, 97)]
    tables = _smoke_tables(dev, pairs, 256 + np.arange(len(pairs)))
    lengths = list(range(1, 601)) + [100_000, 1, 2]
    n = sum(lengths)
    ids = np.full(n, 97, np.int32)
    seg = np.repeat(np.arange(len(lengths), dtype=np.int32), lengths)
    assert _k17_both(dev, ids, seg, tables) < n // 2
    empty = _smoke_tables(dev, np.zeros((0, 2), np.int32),
                          np.zeros(0, np.int32))
    assert _k17_both(dev, *_segments([3, 1, 300, 5]), empty) == 309


def test_segment_encode_seg_values_repeat(dev):
    """A segment is a run of equal seg: values spaced apart and repeated
    further on cut the same segments."""
    rng = np.random.default_rng(5)
    lengths = [int(x) for x in rng.integers(1, 40, 2000)]
    ids, seg = _segments(lengths)
    _k17_both(dev, ids, (seg % 3) * 1000 + 7, _smoke_tables(dev))


def _split_stream(tok, text, dev):
    """The device split's stream of text: K15's token ids (the bytes
    through the table's byte ids) and segment ids, as
    encode_text_device_split makes them."""
    from minbpe_tpu_torch.engine import device_table
    from minbpe_tpu_torch.ops import device_presplit

    raw = text.encode("utf-8")
    data = torch.frombuffer(bytearray(raw), dtype=torch.uint8).to(dev)
    _, seg, ids = device_presplit.presplit_seg_ids(
        data, len(raw), 4, device_table(tok).byte_ids)
    return ids, seg


def _k17_equals_k10(tok, text, dev):
    from minbpe_tpu_torch import engine

    table = engine.device_table(tok)
    ids, seg = _split_stream(tok, text, dev)
    gi, gs, gn = kernels.segment_encode(ids, seg, table.cuckoo)
    si, ss, sn = kernels.encode_sweep(ids, seg, table.pairs, table.new_ids)
    k = int(sn)
    assert int(gn) == k
    assert torch.equal(gi[:k], si[:k]) and torch.equal(gs[:k], ss[:k])


def test_segment_encode_device_split_smoke_corpus(dev):
    """Through the device split, the smoke corpus and texts whose GPT-4
    split has chunks past 256 tokens (runs of spaces, of punctuation):
    K17 equals K10 bit for bit, and the tokenizer's encode equals the
    CPU's."""
    from minbpe_tpu_torch.utils import golden

    text = golden.smoke_corpus(ROOT)
    tok = RegexTokenizer(device="cuda")
    tok.load(os.path.join(ROOT, "bpebench", "data",
                          "minbpe-regex-v512.model"))
    tok.device_presplit = True
    cpu = RegexTokenizer(device="cpu")
    cpu.load(os.path.join(ROOT, "bpebench", "data",
                          "minbpe-regex-v512.model"))
    longs = ("x" + " " * 300 + "y" + "!" * 2100 + " and "
             + " " * 20_000 + "z" + "-" * 70_000 + " end")
    for t in (text, longs, text[:5000] + longs + text[:5000]):
        _k17_equals_k10(tok, t, dev)
        kernels.reset_launches()
        assert tok.encode(t) == cpu.encode(t)
        assert kernels.SEGMENT_ENCODE.launches == 1
        assert kernels.ENCODE_SWEEP.launches == 0


def test_segment_encode_cell_documents(dev):
    """The regex512-encode-docs cell's 4,096 document lengths, each from a
    start a seed picks: K17 equals K10 bit for bit through the device
    split, with the cell's table; a warm request passes its four sync
    sites and no more (one upload: the text's bytes), one route count
    each."""
    from bpebench import inputs
    from minbpe_tpu_torch import trace
    import json

    with open(os.path.join(ROOT, "bpebench", "traffic",
                           "encode-docs.json")) as f:
        t = json.load(f)
    data = inputs.corpus_bytes(os.path.join(ROOT, t["corpus"]),
                               t["corpus_sha256"])
    lengths = inputs.document_lengths(
        t["documents"], t["median_bytes"], t["sigma"], t["min_bytes"],
        t["max_bytes"], t["length_seed"])
    starts = inputs.document_starts(data, lengths, 2**31 + 12345)
    tok = RegexTokenizer(device="cuda")
    tok.load(os.path.join(ROOT, "bpebench", "data",
                          "minbpe-regex-v512.model"))
    tok.device_presplit = True
    docs = [data[s:s + n].decode("utf-8")
            for s, n in zip(starts.tolist(), lengths.tolist())]
    for d in docs:
        _k17_equals_k10(tok, d, dev)
    tok.encode(docs[0])
    trace.reset()
    for d in docs[:64]:
        tok.encode(d)
    syncs = sum(v for k, v in trace.COUNTERS.items() if k.startswith("sync."))
    assert syncs == 4 * 64
    assert trace.COUNTERS["sync.engine.upload"] == 64
    assert trace.COUNTERS["encode.route.segments"] == 64
    assert "encode.route.sweep" not in trace.COUNTERS


@pytest.mark.parametrize("case, route", [
    ("basic_short", "segment_encode"), ("basic_64k", "encode_sweep"),
    ("regex_chunk_70000", "encode_sweep"), ("regex_short", "segment_encode")])
def test_host_split_route_by_longest_chunk(dev, case, route):
    """Where the host holds the chunk lengths, a chunk past TILE keeps
    the whole stream on K10 (BasicTokenizer.encode_batch of 64 KB
    documents, a regex text with a 70,000-token chunk), else K17; one
    launch, equal to the CPU's."""
    from minbpe_tpu_torch.utils import golden

    text = golden.smoke_corpus(ROOT)
    data = os.path.join(ROOT, "bpebench", "data")
    kind, _, size = case.partition("_")
    cls, model = ((BasicTokenizer, "minbpe-basic-v512.model")
                  if kind == "basic" else
                  (RegexTokenizer, "minbpe-regex-v512.model"))
    tok, cpu = cls(device="cuda"), cls(device="cpu")
    tok.load(os.path.join(data, model))
    cpu.load(os.path.join(data, model))
    if kind == "basic":
        n = 65_536 if size == "64k" else 2000
        docs = [text[k * 997:k * 997 + n] for k in range(2)]
        fn = (lambda t: t.encode_batch(docs))
    else:
        body = text[:20_000] + ("-" * 70_000 if size == "chunk_70000"
                                else "") + text[:20_000]
        fn = (lambda t: t.encode(body))
    want = fn(cpu)
    kernels.reset_launches()
    assert fn(tok) == want
    other = ({"segment_encode", "encode_sweep"} - {route}).pop()
    assert getattr(kernels, route.upper()).launches == 1
    assert getattr(kernels, other.upper()).launches == 0


def test_device_split_cl100k_cell_documents(dev):
    """The cl100k-encode-docs cell at full width: GPT4Tokenizer on the
    committed 100,256-rank stand-in (a sorted table, the cuckoo table at
    2^18 rows a table), each of the cell's 4,096 documents from starts a
    seed picks, encoded with the device split (K15, then K17) and with the
    host split (K11): equal ids for every one, one K17 launch and one
    device-split count a request, no K11 or K12 launch on that route."""
    import json

    from bpebench import inputs
    from minbpe_tpu_torch import GPT4Tokenizer, trace
    from minbpe_tpu_torch.engine import device_table
    from minbpe_tpu_torch.gpt4 import GPT4_SPECIAL_TOKENS, load_cl100k_ranks

    with open(os.path.join(ROOT, "bpebench", "configs-ranks",
                           "gpt4-cl100k.json")) as f:
        config = json.load(f)
    with open(os.path.join(ROOT, "bpebench", "traffic",
                           "gpt4-encode-docs.json")) as f:
        t = json.load(f)
    data = inputs.corpus_bytes(os.path.join(ROOT, t["corpus"]),
                               t["corpus_sha256"])
    lengths = inputs.document_lengths(
        t["documents"], t["median_bytes"], t["sigma"], t["min_bytes"],
        t["max_bytes"], t["length_seed"])
    starts = inputs.document_starts(data, lengths, 2**31 + 777)
    docs = [data[s:s + n].decode("utf-8")
            for s, n in zip(starts.tolist(), lengths.tolist())]
    ranks = load_cl100k_ranks(os.path.join(ROOT, config["ranks"]))
    split_tok, host_tok = (
        GPT4Tokenizer.from_mergeable_ranks(ranks, GPT4_SPECIAL_TOKENS,
                                           device="cuda") for _ in range(2))
    split_tok.device_presplit = True
    split_tok.encode(docs[0], allowed_special="none")
    table = device_table(split_tok)
    assert table.kind == "sorted" and table.cuckoo.H == 1 << 18
    kernels.reset_launches()
    trace.reset()
    got = [split_tok.encode(d, allowed_special="none") for d in docs]
    assert kernels.SEGMENT_ENCODE.launches == len(docs)
    assert kernels.PRESPLIT_CLUSTER.launches == len(docs)
    assert kernels.PRESPLIT_SUCC.launches == 0
    assert trace.COUNTERS["presplit.route.cluster"] == len(docs)
    assert kernels.CHUNK_ENCODE.launches == 0
    assert kernels.ENCODE_MIN_SWEEP.launches == 0
    assert trace.COUNTERS["encode.route.device_split"] == len(docs)
    assert "encode.route.host_split" not in trace.COUNTERS
    want = [host_tok.encode(d, allowed_special="none") for d in docs]
    differing = [k for k, (a, b) in enumerate(zip(got, want)) if a != b]
    assert not differing, differing[:10]
    assert sum(map(len, got)) * 3 < sum(lengths.tolist())
