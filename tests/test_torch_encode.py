"""The port's rank-sweep encoder (its plain CPU path) against minbpe_tpu's
fused Pallas encoder in interpret mode and the pure-Python oracle, on the
cases of tests/test_fused_encode.py; and engine.encode_parts' per-part
split. Outputs are token ids: equal or wrong."""

import random

import numpy as np
import pytest
import torch

# The suite runs in several worker processes at once: one intra-op
# thread each keeps the plain PyTorch paths from contending for cores.
torch.set_num_threads(1)

pytest.importorskip("jax")

import oracle  # noqa: E402
from minbpe_tpu.ops import stream as jstream  # noqa: E402
from minbpe_tpu.ops.pallas.fused_encode import encode_fused  # noqa: E402

from minbpe_tpu_torch import BasicTokenizer, RegexTokenizer  # noqa: E402
from minbpe_tpu_torch import engine  # noqa: E402
from minbpe_tpu_torch.convert import tokenizer_from_arrays  # noqa: E402
from minbpe_tpu_torch.ops.encode import encode_stream  # noqa: E402


def _port_encode(ids, seg, n, pairs, nids):
    n = int(n)
    out, _, k = encode_stream(
        torch.from_numpy(ids[:n].copy()), torch.from_numpy(seg[:n].copy()),
        torch.from_numpy(np.asarray(pairs, np.int32).reshape(-1, 2)),
        [int(z) for z in nids])
    return out[:int(k)].tolist()


def _table(rng, n_merges=10):
    train_seqs = [[rng.randint(0, 4) for _ in range(rng.randint(5, 60))]
                  for _ in range(3)]
    merges = oracle.train(train_seqs, n_merges)
    ranks = {p: (r, nid) for r, (p, nid) in enumerate(merges)}
    pairs = np.array([list(p) for p, _ in merges], np.int32)
    nids = np.array([nid for _, nid in merges], np.int32)
    return pairs, nids, ranks


@pytest.mark.parametrize("seed", range(6))
def test_matches_fused_and_oracle(seed):
    rng = random.Random(500 + seed)
    pairs, nids, ranks = _table(rng, rng.randint(1, 12))
    seqs = [[rng.randint(0, 4) for _ in range(rng.randint(0, 40))]
            for _ in range(rng.randint(1, 5))]
    expected = []
    for s in seqs:
        expected.extend(oracle.encode(s, ranks))
    ids, seg, n = jstream.pack_chunks([bytes(s) for s in seqs])
    got = _port_encode(ids, seg, n, pairs, nids)
    assert got == expected
    assert got == encode_fused(ids, seg, n, pairs, nids,
                               interpret=True).tolist()


def test_overlap_runs():
    pairs = np.array([[7, 7], [256, 7]], np.int32)
    nids = np.array([256, 257], np.int32)
    ranks = {(7, 7): (0, 256), (256, 7): (1, 257)}
    for seq in ([7] * 9, [7] * 4, [7, 7, 8, 7, 7, 7], [7] * 1025):
        ids, seg, n = jstream.pack_bytes(bytes(seq))
        assert _port_encode(ids, seg, n, pairs, nids) == \
            oracle.encode(seq, ranks)


def test_empty_and_no_merges():
    empty = np.zeros((0, 2), np.int32)
    ids, seg, n = jstream.pack_bytes(b"abc")
    assert _port_encode(ids, seg, n, empty, []) == [97, 98, 99]
    tok = tokenizer_from_arrays(BasicTokenizer, empty, [], device="cpu")
    assert tok.encode("") == [] and tok.encode("abc") == [97, 98, 99]


def test_multi_chunk_matches_fused():
    chunks = [b"hello", b" world", b"hello", b" there", b"ll", b"o"]
    merges = oracle.train(chunks, 6)
    pairs = np.array([list(p) for p, _ in merges], np.int32)
    nids = np.array([nid for _, nid in merges], np.int32)
    ids, seg, n = jstream.pack_chunks(chunks)
    want = encode_fused(ids, seg, n, pairs, nids, interpret=True).tolist()
    assert _port_encode(ids, seg, n, pairs, nids) == want


def test_encode_parts_splits_by_part():
    """Parts (some empty, some one chunk) ride one stream; each part's
    tokens come back alone and equal its own encode."""
    rng = random.Random(9)
    chunks = [bytes(rng.choice(b"abcab ") for _ in range(rng.randint(1, 8)))
              for _ in range(40)]
    merges = oracle.train(chunks, 12)
    pairs = np.array([list(p) for p, _ in merges], np.int32)
    nids = np.array([nid for _, nid in merges], np.int32)
    ranks = {p: (r, nid) for r, (p, nid) in enumerate(merges)}
    tok = tokenizer_from_arrays(RegexTokenizer, pairs, nids, device="cpu")
    parts, want = [], []
    for k in range(9):
        picked = [] if k % 4 == 1 else rng.sample(chunks, rng.randint(1, 5))
        data = np.frombuffer(b"".join(picked), np.uint8)
        ends = np.cumsum([len(c) for c in picked]).astype(np.int64)
        parts.append((data, ends))
        want.append([t for c in picked for t in oracle.encode(list(c), ranks)])
    got = engine.encode_parts(tok, parts)
    assert [g.tolist() for g in got] == want
    assert [engine.encode_offsets(tok, d, e) for d, e in parts] == want
    assert engine.encode_parts(tok, []) == []
