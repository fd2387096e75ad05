"""The port's exact multi-merge batching against minbpe_tpu's.

The port's trainer (its plain CPU path: K1, K5, K3, K6-K8, K4 as plain
PyTorch) runs against ``train_merges_fused(..., interpret=True)`` on copies
of the batch corpora of tests/test_fused.py:159-302. Merges, counts and the
fail round must be equal, and so must the rebuild count: a batching rule
that drifted (accepting a candidate it should not, or trimming one too
many) changes no output on many corpora, so the rebuild count is the check
of the rule itself. Then K6's sites and creation histograms (batch_hist,
and the two plain halves it is made of) and K8's trim are held against a
small numpy model of the rule written here, on seeded streams and on the
edges of the rule: short streams, sites at the stream's ends, chunk breaks
around a site, adjacent sites and a hot bucket."""

import random

import numpy as np
import pytest
import torch

# The suite runs in several worker processes at once: one intra-op
# thread each keeps the plain PyTorch paths from contending for cores.
torch.set_num_threads(1)

pytest.importorskip("jax")

import minbpe_tpu.ops.pallas.fused_train as ft  # noqa: E402
from minbpe_tpu.ops import stream as jstream  # noqa: E402

from minbpe_tpu_torch import kernels  # noqa: E402
from minbpe_tpu_torch.ops import train as port_train  # noqa: E402

# one padded size for every corpus: the Pallas kernel then compiles once
CAPACITY = 1 << 15


def _cmp(chunks, num_merges):
    ids, seg, n = jstream.pack_chunks([bytes(c) for c in chunks], CAPACITY)
    p1, c1, f1 = ft.train_merges_fused(ids, seg, n, num_merges,
                                       interpret=True)
    n = int(n)
    p2, c2, f2 = port_train.train_merges(torch.from_numpy(ids[:n].copy()),
                                         torch.from_numpy(seg[:n].copy()),
                                         num_merges)
    assert int(f1) == f2
    assert np.array_equal(np.asarray(p1), p2)
    assert np.array_equal(np.asarray(c1), c2)
    assert port_train.LAST_REBUILDS == ft.LAST_REBUILDS
    return port_train.LAST_REBUILDS


def _disjoint_hot_pairs():
    rng = random.Random(11)
    words = [b"ab", b"cd", b"ef", b"gh", b"ij", b"kl"]
    chunks = []
    for _ in range(800):
        w = []
        for k, word in enumerate(words):
            if rng.random() < 0.9 - 0.12 * k:
                w.append(word)
        w.append(bytes([rng.randint(0, 255)]))
        chunks.append(b"".join(w))
    return chunks, 24


def _creation_bound_edge():
    rng = random.Random(12)
    chunks = []
    for _ in range(600):
        parts = []
        if rng.random() < 0.95:
            parts.append(b"the")
        if rng.random() < 0.6:
            parts.append(b"in")
        if rng.random() < 0.45:
            parts.append(b"er")
        parts.append(bytes([rng.randint(32, 90)]))
        chunks.append(b" ".join(parts))
    return chunks, 32


def _homogeneous_argmax():
    rng = random.Random(13)
    chunks = []
    for _ in range(500):
        parts = [b"a" * rng.randint(2, 6)]
        if rng.random() < 0.7:
            parts.append(b"xy")
        if rng.random() < 0.5:
            parts.append(b"pq")
        chunks.append(b"".join(parts) + bytes([rng.randint(0, 255)]))
    return chunks, 20


def _adjacent_sites():
    rng = random.Random(14)
    chunks = []
    for _ in range(700):
        parts = []
        if rng.random() < 0.9:
            parts.append(b"ingo")
        if rng.random() < 0.55:
            parts.append(b"stat")
        parts.append(bytes([rng.randint(97, 122)]))
        chunks.append(b"".join(parts))
    return chunks, 28


def _random_midsize(seed):
    rng = random.Random(700 + seed)
    chunks = []
    for _ in range(rng.randint(200, 400)):
        n = rng.randint(1, 30)
        chunks.append(bytes(rng.randint(0, 9) for _ in range(n)))
    return chunks, rng.randint(12, 40)


def _tie_cliff():
    pairs = [(a, b) for a in range(3, 23) for b in range(30, 40)]
    return [bytes(p) for p in pairs], 5


def _tie_cliff_mid_training():
    rng = random.Random(21)
    chunks = [b"zz"] * 10 + [bytes((a, b)) for a in range(3, 19)
                             for b in range(30, 38)]
    rng.shuffle(chunks)
    return chunks, 8


def _same_side_shares():
    rng = random.Random(31)
    chunks = []
    for _ in range(700):
        parts = []
        if rng.random() < 0.9:
            parts.append(b"ab")
        if rng.random() < 0.7:
            parts.append(b"ac")
        if rng.random() < 0.5:
            parts.append(b"ad")
        if rng.random() < 0.35:
            parts.append(b"the")
        parts.append(bytes([rng.randint(100, 255)]))
        chunks.append(b"".join(parts))
    return chunks, 30


def _shared_right_tokens():
    rng = random.Random(32)
    chunks = []
    for _ in range(600):
        parts = []
        if rng.random() < 0.85:
            parts.append(b"bx")
        if rng.random() < 0.6:
            parts.append(b"cx")
        if rng.random() < 0.4:
            parts.append(b"dx")
        parts.append(bytes([rng.randint(100, 255)]))
        chunks.append(b"".join(parts))
    return chunks, 24


CORPORA = {
    "disjoint_hot_pairs": _disjoint_hot_pairs,
    "creation_bound_edge": _creation_bound_edge,
    "homogeneous_argmax": _homogeneous_argmax,
    "adjacent_sites": _adjacent_sites,
    "random_midsize_0": lambda: _random_midsize(0),
    "random_midsize_1": lambda: _random_midsize(1),
    "random_midsize_2": lambda: _random_midsize(2),
    "random_midsize_3": lambda: _random_midsize(3),
    "tie_cliff": _tie_cliff,
    "tie_cliff_mid_training": _tie_cliff_mid_training,
    "same_side_shares": _same_side_shares,
    "shared_right_tokens": _shared_right_tokens,
}


@pytest.mark.parametrize("name", list(CORPORA))
def test_batching_matches_fused_trainer(name):
    chunks, M = CORPORA[name]()
    assert _cmp(chunks, M) <= M


@pytest.mark.slow
def test_smoke_corpus_rebuilds_match_fused_trainer():
    """The whole smoke corpus at vocab 1024 (chip_smoke's train path):
    minbpe_tpu's fused trainer in interpret mode takes ~12 minutes on a
    CPU. Its rebuild count is the one the card's run must show."""
    import os

    from minbpe_tpu_torch import RegexTokenizer
    from minbpe_tpu_torch.ops import stream as port_stream
    from minbpe_tpu_torch.utils import golden

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    data, ends = RegexTokenizer(device="cpu")._split_arrays(
        golden.smoke_corpus(root))
    M = golden.VOCAB_SIZE - 256
    p1, c1, f1 = ft.train_merges_fused_bytes(
        data, ends.astype(np.int32), len(data), M, interpret=True)
    ids, seg = port_stream.build_stream(data, ends, "cpu")
    p2, c2, f2 = port_train.train_merges(ids, seg, M)
    assert int(f1) == f2 == M
    assert np.array_equal(p1, p2) and np.array_equal(c1, c2)
    assert np.array_equal(p2, golden.load_golden()["merges"])
    assert port_train.LAST_REBUILDS == ft.LAST_REBUILDS == 110


# ---------------------------------------------------------------------------
# K6's sites and histograms and K8's trim against a numpy model of the rule
# ---------------------------------------------------------------------------

def _model(ids, seg, pairs, zbase):
    """cand, F and the two creation histograms, position by position."""
    n = len(ids)
    cand = np.full(n, -1)
    for p in range(n - 1):
        for j, (a, b) in enumerate(pairs):
            if seg[p] == seg[p + 1] and ids[p] == a and ids[p + 1] == b:
                cand[p] = j
    F = ids.copy()
    for p in range(n):
        if cand[p] >= 0:
            F[p] = zbase + cand[p]
        elif p > 0 and cand[p - 1] >= 0:
            F[p] = zbase + cand[p - 1]
    acc_l = np.zeros((128, kernels.K_CAP), np.int64)
    acc_r = np.zeros((128, kernels.K_CAP), np.int64)

    def add(acc, q, j):
        rows = {F[q] % 128}
        if F[q] >= zbase:
            rows.add(ids[q] % 128)
        for r in rows:
            acc[r, j] += 1

    for p in range(n):
        j = cand[p]
        if j < 0:
            continue
        if p >= 1 and seg[p - 1] == seg[p]:
            add(acc_l, p - 1, j)
        if p + 2 < n and seg[p + 2] == seg[p]:
            add(acc_r, p + 2, j)
    return cand, F, acc_l, acc_r


def _batch_stream(seed):
    """A stream over a small alphabet, with a batch of disjoint candidates:
    left tokens from one half of it, right tokens from the other, so no
    cross-side share (and ids above 127 so buckets wrap)."""
    rng = np.random.default_rng(seed)
    n = 3000
    ids = rng.integers(120, 132, n).astype(np.int32)
    seg = np.cumsum(rng.random(n) < 0.15).astype(np.int32)
    lefts = rng.permutation(np.arange(120, 126))[:4]
    rights = rng.permutation(np.arange(126, 132))[:4]
    pairs = [(int(a), int(b)) for a, b in zip(lefts, rights)]
    return ids, seg, pairs


def _slot(pairs, counts, zbase, i):
    slot = kernels.new_slot("cpu")
    for j, (a, b) in enumerate(pairs):
        slot[2 * j], slot[2 * j + 1] = a, b
        slot[kernels.SLOT_COUNT + j] = counts[j]
    slot[kernels.SLOT_BSEL] = len(pairs)
    slot[kernels.SLOT_ZBASE] = zbase
    slot[kernels.SLOT_I] = i
    return slot


@pytest.mark.parametrize("seed", range(3))
def test_batch_histograms_match_model(seed):
    ids, seg, pairs = _batch_stream(seed)
    zbase = 300
    slot = _slot(pairs, [9] * len(pairs), zbase, zbase - 256)
    acc = kernels.new_hist("cpu")
    n = torch.tensor([len(ids)], dtype=torch.int32)
    t_ids, t_seg = torch.from_numpy(ids), torch.from_numpy(seg)
    cand, F = kernels.batch_mark_plain(t_ids, t_seg, n, slot, acc[0])
    kernels.batch_hist_rev_plain(t_ids, t_seg, n, cand, F, slot, acc[1])
    want_c, want_F, want_l, want_r = _model(ids, seg, pairs, zbase)
    assert (want_c >= 0).sum() > 50
    assert np.array_equal(cand.numpy(), want_c)
    assert np.array_equal(F.numpy(), want_F)
    assert np.array_equal(acc[0].numpy(), want_l)
    assert np.array_equal(acc[1].numpy(), want_r)
    acc1 = kernels.new_hist("cpu")
    cand1 = kernels.batch_hist(t_ids, t_seg, n, slot, acc1,
                               torch.empty_like(t_ids))
    assert torch.equal(cand1, cand) and torch.equal(acc1, acc)


def test_hypotheses_in_one_bucket_count_once():
    """Site (1, 2) of candidate 1 right after site (3, 4) of candidate 0:
    the left partner of the second site is token 4, consumed by the first,
    so its final id is zbase + 0 and its id before is 4. With zbase = 260,
    260 & 127 == 4, so both hypotheses fall in bucket 4: one count."""
    ids = np.array([3, 4, 1, 2, 9], np.int32)
    seg = np.zeros(5, np.int32)
    zbase = 260
    slot = _slot([(3, 4), (1, 2)], [5, 4], zbase, 4)
    acc = kernels.new_hist("cpu")
    n = torch.tensor([5], dtype=torch.int32)
    t_ids, t_seg = torch.from_numpy(ids), torch.from_numpy(seg)
    cand, F = kernels.batch_mark_plain(t_ids, t_seg, n, slot, acc[0])
    assert cand.tolist()[:4] == [0, -1, 1, -1]
    assert F.tolist() == [260, 260, 261, 261, 9]
    assert acc[0][4, 1] == 1 and int(acc[0].sum()) == 1
    acc1 = kernels.new_hist("cpu")
    cand1 = kernels.batch_hist(t_ids, t_seg, n, slot, acc1,
                               torch.empty_like(t_ids))
    assert torch.equal(cand1, cand) and torch.equal(acc1[0], acc[0])


def _hist_all_ways(ids, seg, pairs, zbase, n=None):
    """K6's function on a stream of capacity len(ids) with n live tokens,
    three ways: batch_hist (its plain twin here), batch_mark_plain with
    batch_hist_rev_plain, and the numpy model; all three must agree, and
    cand must keep what it held from n on. Returns (cand[:n], acc_l,
    acc_r) as numpy."""
    ids = np.asarray(ids, np.int32)
    seg = np.asarray(seg, np.int32)
    n = len(ids) if n is None else n
    slot = _slot(pairs, [9] * len(pairs), zbase, zbase - 256)
    t_ids, t_seg = torch.from_numpy(ids), torch.from_numpy(seg)
    nt = torch.tensor([n], dtype=torch.int32)
    acc = kernels.new_hist("cpu")
    cand = torch.full_like(t_ids, 777)
    got = kernels.batch_hist(t_ids, t_seg, nt, slot, acc, cand)
    assert got is cand
    assert cand[n:].eq(777).all()
    acc2 = kernels.new_hist("cpu")
    cand2, F2 = kernels.batch_mark_plain(t_ids, t_seg, nt, slot, acc2[0])
    kernels.batch_hist_rev_plain(t_ids, t_seg, nt, cand2, F2, slot, acc2[1])
    assert torch.equal(cand[:n], cand2[:n]) and torch.equal(acc, acc2)
    want_c, _, want_l, want_r = _model(ids[:n], seg[:n], pairs, zbase)
    assert np.array_equal(cand[:n].numpy(), want_c)
    assert np.array_equal(acc[0].numpy(), want_l)
    assert np.array_equal(acc[1].numpy(), want_r)
    return cand[:n].numpy(), acc[0].numpy(), acc[1].numpy()


@pytest.mark.parametrize("seed", range(6))
def test_batch_hist_matches_model_and_plain_halves(seed):
    """Seeded streams, each live only up to a random n below its
    capacity, some of them short."""
    ids, seg, pairs = _batch_stream(seed)
    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(0, 8)) if seed % 3 == 0 else int(
        rng.integers(len(ids) // 2, len(ids)))
    zbase = 300 + seed
    cand, acc_l, acc_r = _hist_all_ways(ids, seg, pairs, zbase, n)
    if n > 100:
        assert (cand >= 0).sum() > 20 and acc_l.sum() > 0 and acc_r.sum() > 0


# candidates (3, 4) and (1, 2); zbase 260, so 260 & 127 == 4 and
# 261 & 127 == 5: (ids, seg, n or None, [(side, bucket, candidate, count)])
# with every other bin zero, side 0 acc_l and 1 acc_r
_PAIRS = [(3, 4), (1, 2)]
HIST_EDGES = {
    "n0": ([3, 4, 1, 2], [0] * 4, 0, []),
    "n1": ([3, 4, 1, 2], [0] * 4, 1, []),
    # a site at 0 = n - 2: no partner on either side
    "n2": ([3, 4], [0, 0], None, []),
    # a site at 0 = n - 3: its second-next token is the last one
    "n3": ([3, 4, 9], [0] * 3, None, [(1, 9, 0, 1)]),
    "site_at_n_minus_2": ([9, 8, 3, 4], [0] * 4, None, [(0, 8, 0, 1)]),
    "site_at_n_minus_3": ([9, 3, 4, 7], [0] * 4, None,
                          [(0, 9, 0, 1), (1, 7, 0, 1)]),
    # the live length cuts the second-next token off
    "site_at_n_minus_2_of_capacity": ([9, 3, 4, 7, 1], [0] * 5, 3,
                                      [(0, 9, 0, 1)]),
    "break_at_p_minus_1": ([9, 3, 4, 7], [0, 1, 1, 1], None, [(1, 7, 0, 1)]),
    "break_at_p_plus_1": ([9, 3, 4, 7], [0, 0, 1, 1], None, []),
    "break_at_p_plus_2": ([9, 3, 4, 7], [0, 0, 0, 1], None, [(0, 9, 0, 1)]),
    # (1, 2) at p + 2 is split by the break, so F(p + 2) is 1, not 261
    "break_at_p_plus_3": ([3, 4, 1, 2, 9], [0, 0, 0, 1, 1], None,
                          [(1, 1, 0, 1)]),
    "no_break_at_p_plus_3": ([3, 4, 1, 2, 9], [0] * 5, None,
                             [(1, 5, 0, 1), (1, 1, 0, 1), (0, 4, 1, 1),
                              (1, 9, 1, 1)]),
    # adjacent sites of two candidates: each partner lies in the other
    # site, so both hypotheses count where their buckets differ (5, 1) and
    # once where they fall together (260 and 4 in bucket 4)
    "adjacent_sites": ([9, 3, 4, 1, 2, 8], [0] * 6, None,
                       [(0, 9, 0, 1), (1, 5, 0, 1), (1, 1, 0, 1),
                        (0, 4, 1, 1), (1, 8, 1, 1)]),
    "adjacent_sites_each_way": ([1, 2, 3, 4, 1, 2, 3, 4], [0] * 8, None,
                                [(0, 5, 0, 2), (0, 2, 0, 2), (1, 5, 0, 1),
                                 (1, 1, 0, 1), (0, 4, 1, 1), (1, 4, 1, 2),
                                 (1, 3, 1, 2)]),
}


@pytest.mark.parametrize("name", list(HIST_EDGES))
def test_batch_hist_edges(name):
    ids, seg, n, bins = HIST_EDGES[name]
    _, acc_l, acc_r = _hist_all_ways(ids, seg, _PAIRS, 260, n)
    want = np.zeros((2, 128, kernels.K_CAP), np.int64)
    for side, bucket, j, c in bins:
        want[side, bucket, j] = c
    assert np.array_equal(np.stack([acc_l, acc_r]), want)


def test_batch_hist_hot_bucket():
    """Most sites share one partner bucket on each side (a space before,
    'h' after, as " th" on text): the hot bins hold the sums exactly."""
    rng = np.random.default_rng(5)
    words = [[32, 116, 104], [32, 97], [105, 110, 32]]
    ids = []
    for _ in range(1500):
        ids += words[0] if rng.random() < 0.8 else words[int(
            rng.integers(1, 3))]
    ids = np.asarray(ids, np.int32)
    seg = np.zeros(len(ids), np.int32)
    pairs = [(32, 116), (105, 110)]
    cand, acc_l, acc_r = _hist_all_ways(ids, seg, pairs, 300)
    sites = int((cand == 0).sum())
    assert sites > 1000
    assert acc_r[104, 0] == sites == acc_r[:, 0].sum()
    assert acc_l[:, 0].sum() == sites - int(cand[0] == 0)
    assert acc_l[104, 0] > sites // 2


def _trim_model(counts, bsel, cm, room):
    bstar = 1
    bound = cm[0]
    for k in range(1, bsel):
        if counts[k] <= bound:
            break
        bstar = k + 1
        bound = max(bound, cm[k])
    return min(bstar, room)


@pytest.mark.parametrize("seed", range(4))
def test_trim_matches_model(seed):
    rng = np.random.default_rng(seed)
    for _ in range(200):
        bsel = int(rng.integers(2, kernels.K_CAP + 1))
        counts = sorted(rng.integers(1, 60, kernels.K_CAP).tolist(),
                        reverse=True)
        cm = rng.integers(0, 40, kernels.K_CAP).tolist()
        room = int(rng.integers(1, 20))
        assert kernels.trim(counts, bsel, cm, room) == \
            _trim_model(counts, bsel, cm, room)


def test_batch_apply_trims_and_logs():
    """K8 on a two-candidate slot whose second candidate is beaten by a
    creation bound: only candidate 0 applies, one log row, i += 1, and the
    histograms are cleared for the next slot."""
    ids = np.array([3, 4, 7, 1, 2, 3, 4, 8], np.int32)
    seg = np.zeros(8, np.int32)
    zbase = 256
    slot = _slot([(3, 4), (1, 2)], [2, 1], zbase, 0)
    acc = kernels.new_hist("cpu")
    acc[0, 5, 0] = 1  # a creation of candidate 0 as large as count 1
    ctl = kernels.new_ctl(4, "cpu")
    log = torch.zeros((4, 4), dtype=torch.int32)
    t_ids = torch.from_numpy(ids)
    n = torch.tensor([8], dtype=torch.int32)
    cand = kernels.batch_hist(t_ids, torch.from_numpy(seg), n, slot, acc,
                              torch.empty_like(t_ids))
    out = torch.empty_like(t_ids)
    live = torch.empty(8, dtype=torch.bool)
    kernels.batch_apply(t_ids, n, cand, slot, acc, ctl, log, 4, out, live)
    assert int(slot[kernels.SLOT_BSTAR]) == 1
    assert out.tolist() == [256, 4, 7, 1, 2, 256, 4, 8]
    assert live.tolist() == [True, False, True, True, True, True, False,
                             True]
    assert log.tolist() == [[3, 4, 2, 2], [0, 0, 0, 0], [0, 0, 0, 0],
                            [0, 0, 0, 0]]
    assert ctl.tolist()[:2] == [1, 4] and int(acc.abs().sum()) == 0
