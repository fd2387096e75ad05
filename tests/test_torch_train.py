"""The port's trainer (its plain CPU path) against minbpe_tpu's fused Pallas
trainer in interpret mode, on the corpora of tests/test_fused.py, and each
plain kernel against a direct numpy computation.

Outputs are integers: merges, counts and the fail round must be equal."""

import random

import numpy as np
import pytest
import torch

# The suite runs in several worker processes at once: one intra-op
# thread each keeps the plain PyTorch paths from contending for cores.
torch.set_num_threads(1)

pytest.importorskip("jax")

from minbpe_tpu.ops import stream as jstream  # noqa: E402
from minbpe_tpu.ops.pallas.fused_train import train_merges_fused  # noqa: E402

from minbpe_tpu_torch import kernels  # noqa: E402
from minbpe_tpu_torch.ops.train import train_merges  # noqa: E402


# one padded size for every corpus: the Pallas kernel then compiles once
CAPACITY = 1 << 15


def _cmp(chunks, num_merges):
    ids, seg, n = jstream.pack_chunks([bytes(c) for c in chunks], CAPACITY)
    p1, c1, f1 = train_merges_fused(ids, seg, n, num_merges, interpret=True)
    n = int(n)
    p2, c2, f2 = train_merges(torch.from_numpy(ids[:n].copy()),
                              torch.from_numpy(seg[:n].copy()), num_merges)
    assert int(f1) == f2
    assert np.array_equal(np.asarray(p1), p2)
    assert np.array_equal(np.asarray(c1), c2)
    return f2


def _blob(seed, size):
    """Seeded text-like bytes standing in for a corpus slice."""
    rng = random.Random(seed)
    words = [bytes(rng.choice(b"etaoinshrdlu") for _ in range(rng.randint(1, 7)))
             for _ in range(300)]
    out = bytearray()
    while len(out) < size:
        out += rng.choice(words) + rng.choice([b" ", b" ", b", ", b".\n"])
    return bytes(out[:size])


def test_wikipedia_toy():
    _cmp([b"aaabdaaabac"], 3)


def test_overlap_runs():
    _cmp([[7] * 30, [7] * 5, [7, 8] * 9], 6)


@pytest.mark.parametrize("seed", range(6))
def test_random(seed):
    rng = random.Random(300 + seed)
    seqs = [
        [rng.randint(0, 6) for _ in range(rng.randint(0, 50))]
        for _ in range(rng.randint(1, 6))
    ]
    seqs.append([1, 2, 1, 2, 1, 1, 1, 2])
    _cmp(seqs, rng.randint(1, 10))


def test_failure_round():
    assert _cmp([[1, 2]], 4) == 1


def test_exhaustion():
    """Merges run dry mid-plan: the later rounds do nothing, their rows stay
    zero, and the fail round is exact."""
    assert _cmp([[7] * 150], 40) < 40


def test_compaction_crossing():
    """A multi-chunk stream over two Pallas tiles, trained past several of
    its compaction points (the port compacts after every merge)."""
    text = _blob(1, 17000)
    ends = list(range(11, len(text), 13)) + [len(text)]
    chunks = [text[a:b] for a, b in zip([0] + ends, ends) if b > a]
    _cmp(chunks, 11)


def test_overlap_runs_live_tracking():
    """(a, a)-heavy corpus where occurrences exceed kept sites."""
    rng = random.Random(5)
    parts = []
    for _ in range(4000):
        parts.append(bytes([rng.randint(0, 3)]) * rng.randint(1, 9))
    blob = b"".join(parts)
    ends = list(range(500, len(blob), 997)) + [len(blob)]
    chunks = [blob[a:b] for a, b in zip([0] + ends, ends) if b > a]
    _cmp(chunks, 7)


def test_kept_column_counts_consumed_tokens():
    """Log column 3 is the kept count: a run of 9 equal tokens has 8
    occurrences of the pair but 4 kept merges."""
    ids = torch.full((9,), 7, dtype=torch.int32)
    seg = torch.zeros(9, dtype=torch.int32)
    n = torch.tensor([9], dtype=torch.int32)
    log = torch.zeros((1, 4), dtype=torch.int32)
    ctl = kernels.new_ctl(1, "cpu")
    slot = kernels.new_slot("cpu")
    cnt, first = kernels.pair_stats(ids, seg, n, 257, ctl)
    kernels.select_batch(cnt, first, ids, ctl, slot, log)
    kernels.merge_apply(ids, seg, n, slot=slot, log=log)
    assert log[0].tolist() == [7, 7, 8, 4]
    assert ctl.tolist()[:3] == [1, 1, 1]


# ---------------------------------------------------------------------------
# each plain kernel against a direct numpy computation
# ---------------------------------------------------------------------------

def _stream(seed, n, hi):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, hi, n).astype(np.int32)
    ids[n // 3:n // 3 + 25] = 2          # a long run of one id
    seg = np.cumsum(rng.random(n) < 0.2).astype(np.int32)
    seg[n // 3:n // 3 + 25] = seg[n // 3]
    seg[n // 3 + 25:] += 1
    return ids, seg


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("seed", range(3))
def test_pair_stats_plain(seed):
    ids, seg = _stream(seed, 500, 5)
    W = 300
    ids[7] = 299
    cnt, first = kernels.pair_stats(_t(ids), _t(seg),
                                    torch.tensor([450], dtype=torch.int32), W)
    assert cnt.shape == first.shape == (W, W)
    want_c = np.zeros((W, W), np.int64)
    want_f = np.full((W, W), -1, np.int64)
    for i in range(449):
        if seg[i] == seg[i + 1]:
            a, b = ids[i], ids[i + 1]
            want_c[a, b] += 1
            if want_f[a, b] < 0:
                want_f[a, b] = i
    assert np.array_equal(cnt.numpy(), want_c)
    assert np.array_equal(first.numpy(), want_f)


@pytest.mark.parametrize("seed", range(3))
def test_select_best_plain(seed):
    """K5's first candidate is the reference's argmax: the largest count,
    the earliest first occurrence among equal counts; an empty matrix is
    the fail round."""
    rng = np.random.default_rng(seed)
    W = 260
    ids = rng.integers(0, W, 8000).astype(np.int32)
    cnt = rng.integers(0, 4, (W, W)).astype(np.int32)
    cnt[rng.random((W, W)) < 0.9] = 0
    first = np.full((W, W), -1, np.int32)
    nz = np.argwhere(cnt > 0)
    pos = rng.permutation(7999)[:len(nz)]
    first[nz[:, 0], nz[:, 1]] = pos
    # the reference: the max count, the earliest first occurrence among ties
    best = max((int(cnt[a, b]), -int(first[a, b]), a, b) for a, b in nz)
    p = -best[1]
    log = torch.zeros((10, 4), dtype=torch.int32)
    ctl = kernels.new_ctl(10, "cpu")
    ctl[kernels.CTL_I] = 4  # W = 256 + 4
    slot = kernels.new_slot("cpu")
    kernels.select_batch(_t(cnt), _t(first), _t(ids), ctl, slot, log)
    assert slot[:2].tolist() == [int(ids[p]), int(ids[p + 1])]
    assert int(slot[kernels.SLOT_COUNT]) == best[0]
    assert int(slot[kernels.SLOT_BSEL]) >= 1
    assert int(ctl[kernels.CTL_FAIL]) == 10
    ctl[kernels.CTL_I] = 4  # a single merge advanced it
    kernels.select_batch(_t(np.zeros_like(cnt)), _t(np.full_like(first, -1)),
                         _t(ids), ctl, slot, log)
    assert int(ctl[kernels.CTL_FAIL]) == 4
    assert int(slot[kernels.SLOT_BSEL]) == 0


def _walk_model(keys, ids):
    """The Pallas selection walk, candidate by candidate."""
    acc = []
    for key in sorted(keys, reverse=True)[:kernels.K_CAP]:
        pos = 0xFFFFFFFF - (key & 0xFFFFFFFF)
        pa, pb = int(ids[pos]), int(ids[pos + 1])
        if acc:
            if pa == pb or acc[0][0] == acc[0][1]:
                break
            if any(qa == pb or qb == pa for qa, qb, _ in acc):
                break
        acc.append((pa, pb, key >> 32))
    return acc


@pytest.mark.parametrize("seed", range(4))
def test_select_batch_walk_plain(seed):
    """K5's accepted batch on K1's counts of a small-alphabet stream against
    a direct model of the walk: keys in descending order, stopped at the
    first homogeneous or cross-side-sharing candidate."""
    ids, seg = _stream(seed, 3000, 12)
    n = torch.tensor([3000], dtype=torch.int32)
    ctl = kernels.new_ctl(8, "cpu")
    slot = kernels.new_slot("cpu")
    log = torch.zeros((8, 4), dtype=torch.int32)
    cnt, first = kernels.pair_stats(_t(ids), _t(seg), n, 264, ctl)
    kernels.select_batch(cnt, first, _t(ids), ctl, slot, log)
    c, f = cnt.numpy().astype(np.int64), first.numpy().astype(np.int64)
    keys = [int(c[a, b]) << 32 | (0xFFFFFFFF - int(f[a, b]))
            for a, b in np.argwhere(c > 0)]
    want = _walk_model(keys, ids)
    bsel = int(slot[kernels.SLOT_BSEL])
    got = [(int(slot[2 * j]), int(slot[2 * j + 1]),
            int(slot[kernels.SLOT_COUNT + j])) for j in range(bsel)]
    assert got == want and bsel >= 1
    assert int(ctl[kernels.CTL_REBUILDS]) == 1


def _walk(ids, seg, n, pa, pb):
    """The reference's left-to-right merge walk: kept match sites."""
    keep = np.zeros(n, bool)
    i = 0
    while i < n - 1:
        if ids[i] == pa and ids[i + 1] == pb and seg[i] == seg[i + 1]:
            keep[i] = True
            i += 2
        else:
            i += 1
    return keep


@pytest.mark.parametrize("pair", [(2, 2), (0, 1), (3, 3), (4, 0)])
def test_merge_apply_plain(pair):
    ids, seg = _stream(7, 600, 5)
    n = 580
    kept = torch.zeros(1, dtype=torch.int32)
    out, live = kernels.merge_apply(_t(ids), _t(seg),
                                    torch.tensor([n], dtype=torch.int32),
                                    torch.tensor(pair, dtype=torch.int32),
                                    999, kept=kept)
    keep = _walk(ids, seg, n, *pair)
    want_ids = np.where(keep, 999, ids[:n])
    want_live = np.ones(n, bool)
    want_live[1:] = ~keep[:-1]
    assert np.array_equal(out.numpy()[:n], want_ids)
    assert np.array_equal(live.numpy()[:n], want_live)
    assert int(kept) == keep.sum() > 0


def test_compact_plain():
    rng = np.random.default_rng(5)
    ids, seg = _stream(5, 700, 9)
    live = rng.random(700) < 0.6
    n = 650
    out_ids, out_seg, n_out = kernels.compact(
        _t(ids), _t(seg), _t(live), torch.tensor([n], dtype=torch.int32))
    k = int(live[:n].sum())
    assert int(n_out) == k
    assert np.array_equal(out_ids.numpy()[:k], ids[:n][live[:n]])
    assert np.array_equal(out_seg.numpy()[:k], seg[:n][live[:n]])


def test_stopped_round_changes_nothing():
    """After the fail round every kernel of a slot is a no-op."""
    ids, seg = _stream(2, 100, 4)
    n = torch.tensor([100], dtype=torch.int32)
    ctl = kernels.new_ctl(5, "cpu")
    ctl[kernels.CTL_I] = 3
    ctl[kernels.CTL_FAIL] = 3
    cnt, first = kernels.pair_stats(_t(ids), _t(seg), n, 261, ctl)
    assert int(cnt.sum()) == 0 and int(first.max()) == -1
    slot = kernels.new_slot("cpu")
    slot[kernels.SLOT_BSEL] = 1
    log = torch.zeros((5, 4), dtype=torch.int32)
    kernels.select_batch(cnt, first, _t(ids), ctl, slot, log)
    assert int(slot[kernels.SLOT_BSEL]) == 0
    assert ctl.tolist()[:3] == [3, 3, 0] and int(log.abs().sum()) == 0
    out, live = kernels.merge_apply(_t(ids), _t(seg), n, slot=slot, log=log)
    assert np.array_equal(out.numpy(), ids) and bool(live.all())
    ci, cs, cn = kernels.compact(out, _t(seg), live, n, slot)
    assert np.array_equal(ci.numpy(), ids) and int(cn) == 100
