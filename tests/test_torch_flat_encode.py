"""The port's sorted-route encoder (minbpe_tpu_torch/ops/flat_encode.py, its
plain CPU path: K11's and K12's plain versions) against minbpe_tpu's flat
encoder (minbpe_tpu/ops/flat_encode.py encode_offsets_arrays) and the
pure-Python oracle: tokens and per-chunk lengths exactly equal, on the
cases of tests/test_flat_encode.py and at the edge of the two kernels'
tiers (chunks of 255, 256 and 257 tokens)."""

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
