"""The port's sort-round trainer (ops/train_sortloop.py) on the CPU against
minbpe_tpu's (ops/train_sortloop.py), on the same input: pairs, counts and
fail round, exactly, for the whole-run and the stepped loop; the oracle
cases of tests/test_sortloop.py, overlapping runs, ties, fail rounds before
M, a vocab above 2048, the progress calls, checkpoints across the two
packages, and K13's plain versions (its count, pair_table_plain, and its
selection, table_select_plain) against select_max_pair."""

import random

import numpy as np
import pytest
import torch

# The suite runs in several worker processes at once: one intra-op
# thread each keeps the plain PyTorch paths from contending for cores.
torch.set_num_threads(1)

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from minbpe_tpu.ops import stream as jstream  # noqa: E402
from minbpe_tpu.ops import train_sortloop as jsl  # noqa: E402

import minbpe_tpu_torch as port  # noqa: E402
from minbpe_tpu_torch import engine, kernels  # noqa: E402
from minbpe_tpu_torch.ops import train_sortloop as psl  # noqa: E402
from minbpe_tpu_torch.ops.select import select_max_pair  # noqa: E402
from minbpe_tpu_torch.utils import checkpoint as ckpt  # noqa: E402

# one padded size for the small corpora: minbpe_tpu compiles once per
# shape and merge count
CAPACITY = 1024

# tests/test_sortloop.py:30-35
ORACLE_CASES = [
    ([b"aaabdaaabac"], 3),
    ([b"hello world", b" hello", b"wor", b"ld!!"], 12),
    ([b"aaaaaaaa", b"aaaa", b"aa"], 3),
    ([bytes([i % 7, (i * 3) % 11, i % 5]) for i in range(200)], 40),
]


def _random_case(seed):
    """tests/test_train_inc.py's random corpora, with the overlap stress."""
    rng = random.Random(seed * 7 + 1)
    chunks = [bytes(rng.randint(0, rng.choice([2, 4, 8]))
                    for _ in range(rng.randint(0, 40)))
              for _ in range(rng.randint(1, 8))]
    chunks.append(bytes([1, 1, 1, 1, 2, 1, 1, 1]))
    return chunks, rng.randint(1, 12)


CASES = ORACLE_CASES + [_random_case(s) for s in range(4)] + [
    ([bytes([7] * 25), bytes([7] * 6), bytes([7, 8] * 10), bytes([8] * 3)],
     8),                                              # overlapping runs
    ([b"abab", b"cdcd", b"efef"], 8),                 # ties, fails at 6
    ([b"\x01\x02"], 5),                               # fails at round 1
    ([b"ab" * 30, b"cd" * 20, b"ab"], 64),            # fails mid-run
]


def _pack(chunks, capacity=CAPACITY):
    data = np.frombuffer(b"".join(chunks), dtype=np.uint8)
    ends = np.cumsum([len(c) for c in chunks]).astype(np.int64)
    ids, seg, n = jstream.pack_offsets(data, ends, capacity)
    k = int(n)
    dense = (torch.from_numpy(ids[:k].copy()), torch.from_numpy(seg[:k].copy()))
    return (ids, seg, n), dense


def _same(want, got):
    p1, c1, f1 = (np.asarray(x) for x in want)
    p2, c2, f2 = got
    assert int(f1) == f2
    assert np.array_equal(p1, p2) and np.array_equal(c1, c2)
    return f2


def _seeded_chunks(seed, n_bytes, alphabet=8, chunk=4096):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, alphabet, n_bytes).astype(np.uint8).tobytes()
    return [data[i:i + chunk] for i in range(0, n_bytes, chunk)]


@pytest.mark.parametrize("k", range(len(CASES)))
def test_whole_run_matches_minbpe_tpu(k):
    chunks, M = CASES[k]
    (ids, seg, n), p = _pack(chunks)
    want = jsl.train_merges_sortloop(ids, seg, n, M)
    _same(want, psl.train_merges_sortloop(*p, M))


@pytest.mark.parametrize("k", range(len(CASES)))
def test_stepped_matches_minbpe_tpu(k):
    chunks, M = CASES[k]
    (ids, seg, n), p = _pack(chunks)
    want = jsl.train_merges_sortloop_stepped(ids, seg, n, M, unroll=7)
    _same(want, psl.train_merges_sortloop_stepped(*p, M, unroll=7))


def test_fail_rounds_before_m():
    """The cases that exhaust: the fail round is below M, the rows from it
    on are zero, and the round before it found a pair."""
    for chunks, M in CASES[-3:]:
        _, p = _pack(chunks)
        pairs, counts, fail = psl.train_merges_sortloop(*p, M)
        assert 0 < fail < M and counts[fail - 1] > 0
        assert not counts[fail:].any() and not pairs[fail:].any()


def test_ties_break_by_first_occurrence():
    """(a, b), (c, d) and (e, f) each occur twice: the first pair wins."""
    _, p = _pack([b"abab", b"cdcd", b"efef"])
    pairs, counts, fail = psl.train_merges_sortloop(*p, 3)
    assert pairs[0].tolist() == [97, 98] and counts[0] == 2


def test_above_vocab_2048_matches_minbpe_tpu():
    """1,800 merges (vocab 2,056) on 16 KB of seeded bytes, both loops."""
    M = 1800
    (ids, seg, n), p = _pack(_seeded_chunks(0, 16384), 16384)
    want = jsl.train_merges_sortloop_stepped(ids, seg, n, M)
    got = psl.train_merges_sortloop_stepped(*p, M)
    assert _same(want, got) == M
    _same(want, psl.train_merges_sortloop(*p, M))


def test_progress_and_checkpoints_match_minbpe_tpu(tmp_path):
    """The same progress calls, and checkpoints at the same rounds with the
    same contents."""
    chunks = [b"the quick brown fox jumps over the lazy dog " * 8]
    (ids, seg, n), p = _pack(chunks)
    fp = ckpt.corpus_fingerprint(ids, seg, n)
    M = 24
    seen = {"j": [], "p": []}
    saved = {}
    for who in ("j", "p"):
        path = str(tmp_path / f"{who}.ckpt.npz")
        rounds = []

        def progress(done, total, who=who, path=path, rounds=rounds):
            seen[who].append((done, total))
            if done > 10:  # the checkpoint written before this call
                rounds.append(ckpt.load(path)["round_idx"])

        kw = dict(unroll=5, checkpoint_path=path, checkpoint_every=10,
                  progress=progress)
        if who == "j":
            jsl.train_merges_sortloop_stepped(ids, seg, n, M, **kw)
        else:
            psl.train_merges_sortloop_stepped(*p, M, fingerprint=fp, **kw)
        saved[who] = (ckpt.load(path), rounds)
    assert seen["j"] == seen["p"] == [(5, 24), (10, 24), (15, 24), (20, 24),
                                      (24, 24)]
    j, p_ = saved["j"][0], saved["p"][0]
    assert j["round_idx"] == p_["round_idx"] == 20
    assert saved["j"][1] == saved["p"][1]
    assert np.array_equal(j["pairs"], p_["pairs"])
    assert np.array_equal(j["counts"], p_["counts"])
    assert j["fingerprint"] == p_["fingerprint"] == fp


@pytest.mark.parametrize("writer", ["minbpe_tpu", "port"])
def test_checkpoints_resume_across_packages(tmp_path, writer):
    chunks = [b"the quick brown fox jumps over the lazy dog " * 8]
    (ids, seg, n), p = _pack(chunks)
    fp = ckpt.corpus_fingerprint(ids, seg, n)
    M = 24
    ck = str(tmp_path / "sl.ckpt.npz")
    full = jsl.train_merges_sortloop_stepped(ids, seg, n, M, unroll=5)
    kw = dict(unroll=5, checkpoint_path=ck, checkpoint_every=10)
    if writer == "minbpe_tpu":
        jsl.train_merges_sortloop_stepped(ids, seg, n, M, **kw)
        got = psl.train_merges_sortloop_stepped(*p, M, unroll=5,
                                                resume_from=ck,
                                                fingerprint=fp)
    else:
        psl.train_merges_sortloop_stepped(*p, M, fingerprint=fp, **kw)
        got = jsl.train_merges_sortloop_stepped(ids, seg, n, M, unroll=5,
                                                resume_from=ck)
        got = tuple(np.asarray(x) for x in got)
        got = (got[0], got[1], int(got[2]))
    assert ckpt.load(ck)["round_idx"] == 20
    assert _same(full, got) == M


def test_public_api_routes(tmp_path):
    """select_mode "sortloop" and "sortloop_inc" through RegexTokenizer,
    and "auto" above vocab 2048, equal minbpe_tpu's merges."""
    import minbpe_tpu

    rng = np.random.default_rng(3)
    text = " ".join("".join(chr(97 + c) for c in rng.integers(0, 6, w))
                    for w in rng.integers(1, 8, 800))
    want = minbpe_tpu.RegexTokenizer()
    want.train(text, 256 + 40, select_mode="sortloop")
    for mode in ("sortloop", "sortloop_inc"):
        got = port.RegexTokenizer(device="cpu")
        got.train(text, 256 + 40, select_mode=mode)
        assert got.merges == want.merges
    assert engine.train_route("auto", len(text), 1793) == "sortloop"


def _stream(ids, seg):
    ids = torch.from_numpy(np.asarray(ids, np.int32).copy())
    seg = torch.from_numpy(np.asarray(seg, np.int32).copy())
    return ids, seg, torch.full((1,), ids.numel(), dtype=torch.int32)


def _streams():
    rng = np.random.default_rng(5)
    n = 20_000
    return {
        "zipf": (np.minimum(rng.zipf(1.3, n) - 1, 1023),
                 np.cumsum(rng.random(n) < 0.3)),
        "one_hot_pair": (np.full(4096, 97), np.zeros(4096)),
        "all_distinct": (np.arange(5000), np.zeros(5000)),
        "ids_above_2_16": (rng.integers(0, 100_260, n),
                           np.cumsum(rng.random(n) < 0.1)),
        "ties": (np.array([1, 2, 9, 3, 4, 9, 1, 2, 9, 3, 4]),
                 np.zeros(11)),
        "one_token": (np.array([5]), np.array([0])),
        "no_pair": (np.array([5, 6, 7]), np.array([0, 1, 2])),
    }


@pytest.mark.parametrize("name", sorted(_streams()))
def test_table_plain_equals_select_max_pair(name):
    """K13's plain count and selection: the table holds every pair once
    with its count and first position (against numpy), the selection is
    select_max_pair's, the log row and the fail round are written, and the
    table is left empty."""
    a, s = _streams()[name]
    ids, seg, n = _stream(a, s)
    table = kernels.PairTable(ids.numel(), "cpu")
    fail = torch.tensor([9], dtype=torch.int32)
    kernels.pair_table_plain(ids, seg, n, table, fail, 3)
    keys, cnt, first = kernels.table_contents(table)
    a64 = np.asarray(a, np.int64)
    ok = np.asarray(s)[:-1] == np.asarray(s)[1:]
    k = (a64[:-1] << 32 | a64[1:])[ok]
    uk, idx, uc = np.unique(k, return_index=True, return_counts=True)
    assert keys.tolist() == uk.tolist()
    assert cnt.tolist() == uc.tolist()
    assert first.tolist() == np.flatnonzero(ok)[idx].tolist()
    assert table.capacity >= 2 * ids.numel()

    sel = torch.zeros(4, dtype=torch.int32)
    pairs = torch.full((9, 2), 7, dtype=torch.int32)
    counts = torch.full((9,), 7, dtype=torch.int32)
    kernels.table_select_plain(table, sel, pairs, counts, fail, 3)
    pa, pb, c, found = select_max_pair(ids, seg, n)
    if bool(found):
        assert sel.tolist() == [int(pa), int(pb), int(c), 1]
        assert pairs[3].tolist() == [int(pa), int(pb)]
        assert int(counts[3]) == int(c) and int(fail) == 9
    else:
        assert sel.tolist() == [-1, -1, 0, 0]
        assert pairs[3].tolist() == [0, 0] and int(counts[3]) == 0
        assert int(fail) == 3
    assert int(table.used) == 0
    assert (table.key == -1).all() and not table.cnt.any()
    assert (table.first == kernels.EMPTY_FIRST).all()


def test_table_gates_after_a_failed_round():
    """After the fail round neither count nor selection acts: the table
    stays empty and the record says no pair, in the plain count and
    selection and in pair_select."""
    ids, seg, n = _stream([1, 2, 1, 2], [0, 0, 0, 0])
    table = kernels.PairTable(4, "cpu")
    fail = torch.tensor([2], dtype=torch.int32)
    kernels.pair_table_plain(ids, seg, n, table, fail, 3)
    assert int(table.used) == 0
    sel = torch.zeros(4, dtype=torch.int32)
    pairs = torch.full((4, 2), 7, dtype=torch.int32)
    counts = torch.full((4,), 7, dtype=torch.int32)
    kernels.table_select_plain(table, sel, pairs, counts, fail, 3)
    assert sel.tolist() == [-1, -1, 0, 0] and int(fail) == 2
    sel.fill_(5)
    kernels.pair_select(ids, seg, n, table, sel, pairs, counts, fail, 3)
    assert sel.tolist() == [-1, -1, 0, 0] and int(fail) == 2
    assert pairs[3].tolist() == [0, 0] and int(counts[3]) == 0
    assert int(table.used) == 0


def test_two_rounds_share_one_table():
    """The second round's count sees only its own stream."""
    table = kernels.PairTable(8, "cpu")
    fail = torch.tensor([4], dtype=torch.int32)
    sel = torch.zeros(4, dtype=torch.int32)
    pairs = torch.zeros((4, 2), dtype=torch.int32)
    counts = torch.zeros(4, dtype=torch.int32)
    for i, (a, want) in enumerate((([5, 6, 5, 6, 5], [5, 6, 2]),
                                   ([7, 8, 7, 8], [7, 8, 2]))):
        ids, seg, n = _stream(a, [0] * len(a))
        kernels.pair_table_plain(ids, seg, n, table, fail, i)
        assert kernels.table_contents(table)[0].numel() == len(set(
            zip(a, a[1:])))
        kernels.table_select_plain(table, sel, pairs, counts, fail, i)
        assert sel.tolist()[:3] == want


def test_device_bytes():
    """The table: 20 B a slot, a power of two >= 2N slots."""
    assert kernels.PairTable.device_bytes(50_353_352) == 20 << 27
    assert psl.device_bytes(1000) == psl.BYTES_PER_TOKEN * 1000 + 20 * 2048


class _CudaIds:
    """Stands in for a stream on the card: its size, none of its memory."""

    is_cuda = True
    device = torch.device("cuda")

    def __init__(self, n):
        self.n = n

    def numel(self):
        return self.n


def _one_gib_free(monkeypatch):
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (1 << 30, 80 << 30))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda device=None: 0)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda device=None: 0)


def test_too_little_device_memory_raises(monkeypatch):
    """The check the trainer makes on the card before any work: 2^20
    tokens fit in 1 GiB, 48·2^20 do not."""
    _one_gib_free(monkeypatch)
    psl._check(_CudaIds(1 << 20), 7936)
    with pytest.raises(MemoryError, match="B per table slot"):
        psl._check(_CudaIds(48 << 20), 7936)
