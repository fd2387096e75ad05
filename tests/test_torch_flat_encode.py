"""The port's sorted-route encoder (minbpe_tpu_torch/ops/flat_encode.py, its
plain CPU path: K11's and K12's plain versions) against minbpe_tpu's flat
encoder (minbpe_tpu/ops/flat_encode.py encode_offsets_arrays) and the
pure-Python oracle: tokens and per-chunk lengths exactly equal, on the
cases of tests/test_flat_encode.py, at the edges of the kernels' tiers
(K11's lane and warp, K11 and K12, K12's block and cluster), on many long
chunks and on runs of one byte cut across chunks; and K12's launch plan."""

import os

import numpy as np
import pytest
import torch

# The suite runs in several worker processes at once: one intra-op
# thread each keeps the plain PyTorch paths from contending for cores.
torch.set_num_threads(1)

pytest.importorskip("jax")

import oracle  # noqa: E402
from minbpe_tpu.ops import flat_encode as jflat  # noqa: E402
from minbpe_tpu.ops.ranktab import CuckooPairTable as JTable  # noqa: E402

from minbpe_tpu_torch import RegexTokenizer, kernels  # noqa: E402
from minbpe_tpu_torch.ops import flat_encode  # noqa: E402
from minbpe_tpu_torch.ops.ranktab import CuckooPairTable  # noqa: E402
from minbpe_tpu_torch.utils import golden  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPLIT = RegexTokenizer(device="cpu")
EDGE = kernels.CHUNK_WARP_MAX


def _chunks(text):
    data, ends = SPLIT._split_arrays(text)
    return [bytes(data[s:e]) for s, e in zip(np.r_[0, ends[:-1]], ends)]


def _learn(train_text, num_merges):
    """(pairs, new_ids, oracle ranks) of oracle-trained merges (stops early
    if the corpus runs out), as tests/test_flat_encode.py learns them."""
    seqs = [list(c) for c in _chunks(train_text)]
    learned = []
    for r in range(num_merges):
        counts, first = oracle.scan_pairs(seqs)
        if not counts:
            break
        best = max(counts.items(), key=lambda kv: (kv[1], -first[kv[0]]))[0]
        seqs = [oracle.substitute(s, best, 256 + r) for s in seqs]
        learned.append((best, 256 + r))
    pairs = np.array([p for p, _ in learned], np.int32).reshape(-1, 2)
    new_ids = np.array([z for _, z in learned], np.int32)
    return pairs, new_ids, {p: (r, z) for r, (p, z) in enumerate(learned)}


def _check(chunks, pairs, new_ids, ranks=None):
    """Port == minbpe_tpu (== the oracle where ranks are given) on chunks;
    returns the port's tokens."""
    data = np.frombuffer(b"".join(chunks), dtype=np.uint8)
    ends = np.cumsum([len(c) for c in chunks]).astype(np.int64)
    got, lens, seg = flat_encode.encode_offsets_arrays(
        data, ends, CuckooPairTable(pairs, new_ids, "cpu"))
    want, want_lens = jflat.encode_offsets_arrays(data, ends,
                                                  JTable(pairs, new_ids))
    assert got.tolist() == want.tolist()
    assert lens.tolist() == want_lens.tolist()
    assert seg.tolist() == np.repeat(np.arange(len(chunks)), lens).tolist()
    if ranks is not None:
        assert got.tolist() == [t for c in chunks
                                for t in oracle.encode(list(c), ranks)]
    return got


@pytest.mark.parametrize("text", [
    "aaabdaaabac" * 40,
    "hello world!!!? (안녕하세요!) lol123 😉 " * 30,
    "x",
    "  \n\n  mixed   WS\t and 12345 numbers 67890  ",
], ids=["abac", "unicode", "single", "whitespace"])
def test_flat_matches_minbpe_tpu(text):
    pairs, new_ids, ranks = _learn(text + " padding corpus for merge variety",
                                   150)
    _check(_chunks(text), pairs, new_ids, ranks)


def test_long_chunks():
    """Chunks longer than K11's tier (K12's), with the left-first parity of
    (a, a) runs."""
    pairs, new_ids, ranks = _learn(
        "a" * 500 + " aa aaa " + "b" * 300 + " ab" * 50, 60)
    _check([b"a" * 5000, b" " * 3000, b"ab" * 100, b"a" * 7], pairs,
           new_ids, ranks)


def test_empty_and_single():
    pairs, new_ids, _ = _learn("some text to make merges work ok", 40)
    t = CuckooPairTable(pairs, new_ids, "cpu")
    got, lens, seg = flat_encode.encode_offsets_arrays(
        np.zeros(0, np.uint8), np.zeros(0, np.int64), t)
    assert got.tolist() == [] and lens.tolist() == [] and seg.tolist() == []
    assert _check([b"z"], pairs, new_ids).tolist() == [ord("z")]


@pytest.mark.parametrize("trial", range(6))
def test_randomized(trial):
    rng = np.random.default_rng(7 + trial)
    alphabet = list("ab c\nde")
    train = "".join(rng.choice(alphabet, size=800))
    text = "".join(rng.choice(alphabet, size=400))
    pairs, new_ids, ranks = _learn(train, 80)
    _check(_chunks(text), pairs, new_ids, ranks)


# a table of runs: (97, 97) -> 256, its doublings, and (z, 97) tails
RUN_TABLE = [(97, 97), (256, 256), (257, 257), (256, 97), (258, 97),
             (98, 97), (97, 98)]


@pytest.mark.parametrize("sizes", [
    [EDGE - 1, EDGE, EDGE + 1],
    [1, EDGE, 1, EDGE + 1, 2, EDGE - 1],
    [EDGE + 1] * 3,          # all long: K12 alone
    [EDGE] * 3 + [3, 1],     # all short: K11 alone
    [2 * EDGE + 7, 1],
])
@pytest.mark.parametrize("fill", ["run", "mixed"])
def test_tier_edges(sizes, fill):
    """Chunks at both sides of K11's 256-token tier, of one byte (one run of
    (a, a) across the whole chunk) or of seeded a/b text."""
    rng = np.random.default_rng(len(sizes))
    pairs = np.array(RUN_TABLE, np.int32)
    new_ids = 256 + np.arange(len(pairs), dtype=np.int32)
    ranks = {tuple(p): (r, int(z)) for r, (p, z) in
             enumerate(zip(pairs.tolist(), new_ids))}
    chunks = [b"a" * n if fill == "run" else
              bytes(rng.choice([97, 98], n, p=[0.8, 0.2]).tolist())
              for n in sizes]
    _check(chunks, pairs, new_ids, ranks)


def test_ids_above_2_16():
    """New ids above 2^16 (GPT-4's reach 100,260): nothing packs them."""
    pairs = np.array([(97, 98), (70_000, 99), (70_001, 97)], np.int32)
    new_ids = np.array([70_000, 70_001, 100_260], np.int32)
    _check([b"abca", b"ab", b"abcabcab" * 40], pairs, new_ids)


def test_smoke_corpus_sorted_table():
    """The smoke corpus's GPT-4 split with smoke_plus_4353 (a real-text
    table above the dense route's vocab)."""
    pairs, new_ids = golden.smoke_plus_merges(golden.SORTED_VOCAB)
    got = _check(_chunks(golden.smoke_corpus(ROOT)), pairs,
                 new_ids)
    assert len(got) < 0.4 * 397_366


@pytest.mark.parametrize("seed", range(3))
def test_many_long_chunks(seed):
    """Many chunks of seeded lengths past K11's tier (K12's, one launch)
    among short ones."""
    rng = np.random.default_rng(seed)
    text = golden.smoke_corpus(ROOT).encode()
    lengths = rng.integers(EDGE + 1, 3000, 12).tolist() + [3, 40, 1]
    starts = rng.integers(0, len(text) - 3000, len(lengths))
    pairs, new_ids = golden.smoke_plus_merges(golden.SORTED_VOCAB)
    _check([text[o:o + n] for o, n in zip(starts, lengths)], pairs, new_ids)


@pytest.mark.parametrize("sizes", [
    [kernels.K11_LANE_MAX, kernels.K11_LANE_MAX + 1],
    [EDGE, EDGE + 1, EDGE + 2],
    [kernels.K12_BLOCK_CAP, kernels.K12_BLOCK_CAP + 1],
], ids=["lane", "warp", "block"])
@pytest.mark.parametrize("fill", ["run", "mixed"])
def test_k12_tier_edges(sizes, fill):
    """Chunks at both sides of K11's lane tier, of K11's and K12's, and of
    K12's one block and its cluster."""
    rng = np.random.default_rng(len(sizes))
    pairs = np.array(RUN_TABLE, np.int32)
    new_ids = 256 + np.arange(len(pairs), dtype=np.int32)
    chunks = [b"a" * n if fill == "run" else
              bytes(rng.choice([97, 98], n, p=[0.8, 0.2]).tolist())
              for n in sizes]
    _check(chunks, pairs, new_ids)


@pytest.mark.parametrize("runs", [
    [EDGE + 44, EDGE + 45, 1000, 7],
    [3, EDGE + 1, 2 * EDGE, EDGE + 1, 2],
], ids=["long", "mixed"])
def test_runs_cut_across_chunks(runs):
    """One run of "a" cut into chunks of odd and even lengths: each chunk
    takes its own left-first parity from its own start."""
    pairs = np.array(RUN_TABLE, np.int32)
    new_ids = 256 + np.arange(len(pairs), dtype=np.int32)
    ranks = {tuple(p): (r, int(z)) for r, (p, z) in
             enumerate(zip(pairs.tolist(), new_ids))}
    _check([b"a" * n for n in runs], pairs, new_ids, ranks)


def test_k12_plan_tiers():
    """K12's plan: a chunk at one block's capacity in that block's
    registers, one past it in a cluster's, one at the on-chip tier's
    capacity in the largest cluster's, one past that in device memory;
    blocks alone packed a cluster at a time."""
    block, cap = kernels.K12_BLOCK_CAP, kernels.K12_ONCHIP_CAP
    lengths = [block, block + 1, cap, cap + 1, EDGE + 1]
    jobs, cs, ns, base, modes = kernels.k12_plan(lengths)
    assert modes == [kernels.K12_BLOCK, kernels.K12_CLUSTER,
                     kernels.K12_CLUSTER, kernels.K12_DEVICE,
                     kernels.K12_BLOCK]
    assert cs == kernels.K12_CLUSTER_MAX and len(jobs) % cs == 0
    assert ns <= kernels.K12_NS_MAX
    assert [j[0] for j in jobs].count(-1) == cs - 2
    assert base >= 2 * (cap + 1)
    for w, mode_s, P, _ in jobs:
        if w >= 0:
            assert P % max(mode_s >> 4, 1) == 0
            assert P * (1 if mode_s & 15 == 0 else cs) * kernels.K12_TPB \
                >= lengths[w]
    jobs, cs, *_ = kernels.k12_plan([block + 1])  # 16 slots a thread
    assert jobs[0][2] == 16 and cs == 4
    assert kernels.k12_plan([EDGE + 1] * 5)[1] == 1
    assert kernels.k12_plan([3 * cap])[1] == kernels.K12_DEVICE_CLUSTER


@pytest.mark.parametrize("lengths", [
    [kernels.K12_ONCHIP_CAP + 1],
    [kernels.K12_DEVICE_MAX],
    [kernels.K12_DEVICE_MAX, EDGE + 1, kernels.K12_DEVICE_MAX],
], ids=["first", "limit", "two_at_limit"])
def test_k12_plan_device_tier_offsets(lengths):
    """The device tier's chunks up to K12_DEVICE_MAX tokens: every slot a
    thread of the cluster holds stays below 2^31, and each chunk's scratch
    follows the last one's, its offset counted in K12_BASE_UNIT ints, so
    the int32 jobs name it even where the scratch passes 2^31 ints."""
    jobs, cs, ns, base, modes = kernels.k12_plan(lengths)
    assert torch.tensor(jobs, dtype=torch.int32).shape == (len(jobs), 4)
    assert cs == kernels.K12_DEVICE_CLUSTER and ns <= kernels.K12_NS_MAX
    at = 0
    for w, n in enumerate(lengths):
        mine = [j for j in jobs if j[0] == w]
        if modes[w] != kernels.K12_DEVICE:
            continue
        assert len(mine) == cs and len(set(mine)) == 1
        _, mode_s, P, unit = mine[0]
        assert P % (mode_s >> 4) == 0 and P // (mode_s >> 4) <= ns
        assert n <= cs * kernels.K12_TPB * P <= kernels.INT32_MAX
        assert unit * kernels.K12_BASE_UNIT == at
        at += 2 * cs * kernels.K12_TPB * P
    assert base == at
    if len(lengths) > 1:
        assert base > kernels.INT32_MAX


def test_k12_plan_refuses_past_the_device_tier():
    """A chunk one token past K12_DEVICE_MAX would need a slot past 2^31:
    the plan says so, naming the limit."""
    slots = kernels.K12_DEVICE_CLUSTER * kernels.K12_TPB
    assert slots * kernels._k12_device_slots(kernels.K12_DEVICE_MAX)[0] \
        <= kernels.INT32_MAX
    assert slots * kernels._k12_device_slots(
        kernels.K12_DEVICE_MAX + 1)[0] > kernels.INT32_MAX
    with pytest.raises(ValueError, match=str(kernels.K12_DEVICE_MAX)):
        kernels.k12_plan([EDGE + 1, kernels.K12_DEVICE_MAX + 1])


def test_encode_refuses_int32_offsets():
    """A stream past 2^31 - 1 tokens: its chunk offsets do not fit int32
    (a broadcast view, so nothing is allocated)."""
    data = np.broadcast_to(np.uint8(97), (kernels.INT32_MAX + 1,))
    with pytest.raises(ValueError, match="int32"):
        flat_encode.encode_offsets_arrays(
            data, np.array([len(data)], np.int64), None)


@pytest.mark.parametrize("lengths", [
    [EDGE, EDGE + 1, 5],
    [kernels.K12_ONCHIP_CAP + 1, 3],
], ids=["on_chip", "device"])
def test_memory_check_counts_k12_scratch(monkeypatch, lengths):
    """On the card the encode asks for BYTES_PER_TOKEN a token and K12's
    scratch as its plan sizes it (checked before anything is allocated)."""
    need = []

    def check(dev, nbytes, what):
        need.append(nbytes)
        raise MemoryError(what)

    class CardTable:
        device = torch.device("cuda")

    monkeypatch.setattr(flat_encode, "check_device_memory", check)
    data = np.full(sum(lengths), 97, np.uint8)
    with pytest.raises(MemoryError, match="K12 scratch"):
        flat_encode.encode_offsets_arrays(
            data, np.cumsum(lengths).astype(np.int64), CardTable())
    long = [n for n in lengths if n > EDGE]
    assert need == [flat_encode.BYTES_PER_TOKEN * len(data)
                    + 4 * kernels.k12_plan(long)[3]]
    assert (need[0] > flat_encode.BYTES_PER_TOKEN * len(data)) == (
        max(lengths) > kernels.K12_ONCHIP_CAP)


def _own_ranks(chunk, ranks):
    """The ranks one chunk's own lowest-rank sweep applies, one a round."""
    ids, applied = list(chunk), []
    while True:
        hits = [ranks[p] for p in zip(ids, ids[1:]) if p in ranks]
        if not hits:
            return applied
        r, z = min(hits)
        applied.append(r)
        out, k = [], 0
        while k < len(ids):
            if k + 1 < len(ids) and ranks.get((ids[k], ids[k + 1])) == (r, z):
                out.append(z)
                k += 2
            else:
                out.append(ids[k])
                k += 1
        ids = out


@pytest.mark.parametrize("seed", range(2))
def test_sweep_rounds_are_each_chunks_own(seed):
    """kernels.sweep_rounds (what K12's rounds are held to): each chunk's
    rounds are its own sweep's, and the union counts the distinct ranks
    applied anywhere."""
    rng = np.random.default_rng(seed)
    text = golden.smoke_corpus(ROOT).encode()
    lengths = rng.integers(1, 600, 9)
    starts = rng.integers(0, len(text) - 600, len(lengths))
    chunks = [text[o:o + n] for o, n in zip(starts, lengths)] + [b"a" * 99]
    pairs, new_ids = golden.smoke_plus_merges(golden.SORTED_VOCAB)
    ranks = {tuple(p): (r, int(z)) for r, (p, z) in
             enumerate(zip(pairs.tolist(), new_ids))}
    table = CuckooPairTable(pairs, new_ids, "cpu")
    ids = torch.from_numpy(np.frombuffer(b"".join(chunks), np.uint8).astype(
        np.int32))
    seg = torch.from_numpy(np.repeat(np.arange(len(chunks), dtype=np.int32),
                                     [len(c) for c in chunks]))
    rounds, union = kernels.sweep_rounds(ids, seg, table)
    own = [_own_ranks(c, ranks) for c in chunks]
    assert rounds.tolist() == [len(a) for a in own]
    assert union == len(set().union(*own))


def test_k11_order_puts_lane_chunks_first():
    """K11's which: the chunks of at most K11_LANE_MAX tokens in order,
    then the other short ones in order; the long ones left to K12."""
    lane_max = kernels.K11_LANE_MAX
    L = np.array([lane_max + 1, 1, EDGE + 1, lane_max, EDGE, 3, EDGE + 9])
    which, lanes = flat_encode.k11_order(L, L <= EDGE)
    assert which.dtype == np.int32 and lanes == 3
    assert which.tolist() == [1, 3, 5, 0, 4]
