"""The port's sorted pair table, its sorted-table stream encoder and its
bucketed chunk encoder against minbpe_tpu's, on the CPU.

minbpe_tpu's side runs as its own tests run it (jitted on the CPU); the
port's on ``device="cpu"``. The same inputs, made with numpy from a seed or
cut from the in-repo smoke corpus, go to both; every output is integers and
must be exactly equal. The port's chunk encoder is also held to its flat
encoder (the plain versions of K11 and K12) and to the encode golden on the
smoke corpus.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minbpe_tpu.ops import chunk_encode as jce
from minbpe_tpu.ops import encode as jenc
from minbpe_tpu.ops import ranktab as jrt
from minbpe_tpu.ops import stream as jst
from minbpe_tpu_torch import RegexTokenizer
from minbpe_tpu_torch.convert import tokenizer_from_arrays
from minbpe_tpu_torch.ops import chunk_encode as pce
from minbpe_tpu_torch.ops import encode as penc
from minbpe_tpu_torch.ops import ranktab as prt
from minbpe_tpu_torch.ops import stream as pst
from minbpe_tpu_torch.utils import golden

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def corpus() -> bytes:
    return golden.smoke_corpus(ROOT).encode("utf-8")


def _trained():
    """The 768 merges minbpe_tpu trained on the smoke corpus."""
    m = golden.load_golden()["merges"].astype(np.int32)
    return m, (256 + np.arange(len(m))).astype(np.int32)


def _table(kind):
    rng = np.random.default_rng(5)
    if kind == "trained":
        return _trained()
    if kind == "random":  # arbitrary distinct pairs, ids up to 5000
        keys = rng.choice(5000 * 5000, 3000, replace=False)
        pairs = np.stack([keys // 5000, keys % 5000], 1).astype(np.int32)
        return pairs, rng.permutation(3000).astype(np.int32) + 5000
    if kind == "one":
        return np.array([[7, 7]], np.int32), np.array([300], np.int32)
    return np.zeros((0, 2), np.int32), np.zeros(0, np.int32)


# ---------------------------------------------------------------------------
# SortedPairTable
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["trained", "random", "one", "empty"])
def test_sorted_table_lookup_matches(kind):
    """Present pairs, absent ones (ids of -1 .. 5100) and an invalid mask,
    and the M = 0 stand-in table."""
    pairs, new_ids = _table(kind)
    jt = jrt.SortedPairTable(pairs, new_ids)
    pt = prt.SortedPairTable(pairs, new_ids, device="cpu")
    assert pt.num_merges == jt.num_merges and pt.depth == jt.depth
    for name in ("ka", "kb", "rank", "merge_pairs", "merge_ids"):
        assert np.array_equal(getattr(pt, name).numpy(),
                              np.asarray(getattr(jt, name))), name
    rng = np.random.default_rng(len(pairs))
    n = 4000
    a = rng.integers(-1, 5100, n).astype(np.int32)
    b = rng.integers(-1, 5100, n).astype(np.int32)
    if len(pairs):  # half the queries are pairs of the table
        pick = rng.integers(0, len(pairs), n // 2)
        a[:n // 2], b[:n // 2] = pairs[pick, 0], pairs[pick, 1]
    valid = rng.random(n) < 0.8
    want = np.asarray(jt.lookup(jnp.asarray(a), jnp.asarray(b),
                                jnp.asarray(valid)))
    got = pt.lookup(torch.from_numpy(a), torch.from_numpy(b),
                    torch.from_numpy(valid))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    if len(pairs):
        assert (want[:n // 2][valid[:n // 2]] < jrt.RANK_INF).all()
    assert (want[~valid] == jrt.RANK_INF).all()


def test_sorted_table_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prt.SortedPairTable(*_trained())


# ---------------------------------------------------------------------------
# host packing, encode_stream_sorted
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("capacity", [None, 4096])
def test_pack_matches(corpus, capacity):
    chunks = [corpus[:0], corpus[:17], corpus[100:103], corpus[:0],
              corpus[200:1200]]
    for got, want in ((pst.pack_bytes(corpus[:1000], capacity),
                       jst.pack_bytes(corpus[:1000], capacity)),
                      (pst.pack_chunks(chunks, capacity),
                       jst.pack_chunks(chunks, capacity))):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)


def _seeded_chunks(corpus, seed, total=3000):
    """Slices of the corpus of 1-200 bytes at seeded offsets."""
    rng = np.random.default_rng(seed)
    out, size = [], 0
    while size < total:
        ln = int(rng.integers(1, 201))
        at = int(rng.integers(0, len(corpus) - ln))
        out.append(corpus[at:at + ln])
        size += ln
    return out


@pytest.mark.parametrize("case", ["seed0", "seed1", "seed2", "one_segment",
                                  "empty_table", "single_token"])
def test_encode_stream_sorted_matches(corpus, case):
    pairs, new_ids = _table("empty" if case == "empty_table" else "trained")
    if case == "one_segment":
        ids, seg, n = jst.pack_bytes(corpus[5000:8000], 4096)
    elif case == "single_token":
        ids, seg, n = jst.pack_bytes(corpus[:1], 4096)
    else:
        seed = 0 if case == "empty_table" else int(case[-1])
        ids, seg, n = jst.pack_chunks(_seeded_chunks(corpus, seed), 4096)
    jt = jrt.SortedPairTable(pairs, new_ids)
    w_ids, w_n = jenc.encode_stream_sorted(
        jnp.asarray(ids), jnp.asarray(seg), jnp.asarray(n), jt.ka, jt.kb,
        jt.rank, jt.merge_pairs, jt.merge_ids, jt.depth)
    pt = prt.SortedPairTable(pairs, new_ids, device="cpu")
    g_ids, g_n = penc.encode_stream_sorted(ids, seg, n, pt)
    assert g_n.dtype == torch.int32 and g_n.shape == (1,)
    k = int(w_n)
    assert int(g_n) == k
    assert np.array_equal(g_ids[:k].numpy(), np.asarray(w_ids)[:k])
    if case.startswith("seed"):
        assert k < int(n)  # the table merged something


# ---------------------------------------------------------------------------
# the chunk encoder
# ---------------------------------------------------------------------------

# empty chunks, a length at and past every bucket, and one chunk past the
# largest (the stream encoder's route)
MIXED_LENGTHS = [0, 1, 2, 16, 17, 0, 32, 64, 65, 128, 256, 512, 1024, 2048,
                 4096, 8192, 9000, 3, 0]


@pytest.fixture(scope="module")
def mixed(corpus):
    """(chunks, data, ends, table) and minbpe_tpu's results. The chunks up
    to 512 bytes are corpus slices; the longer ones repeat a 300-byte
    slice (fewer distinct ranks, so fewer rounds)."""
    rng = np.random.default_rng(11)
    chunks = []
    for ln in MIXED_LENGTHS:
        at = int(rng.integers(0, len(corpus) - 9000))
        piece = corpus[at:at + ln] if ln <= 512 else \
            (corpus[at:at + 300] * 31)[:ln]
        chunks.append(piece)
    data = np.frombuffer(b"".join(chunks), np.uint8)
    ends = np.cumsum(MIXED_LENGTHS)
    pairs, new_ids = _trained()
    jt = jrt.SortedPairTable(pairs, new_ids)
    flat, lens = jce.encode_offsets_arrays(data, ends, jt)
    return dict(chunks=chunks, data=data, ends=ends,
                table=prt.SortedPairTable(pairs, new_ids, device="cpu"),
                flat=flat, lens=lens, listed=jce.encode_chunk_list(chunks,
                                                                   jt))


def test_buckets_cover_every_route(mixed):
    got = {pce._bucket_len(len(c)) for c in mixed["chunks"] if c}
    assert got == set(pce._BUCKETS) | {-1}
    assert pce._BUCKETS == jce._BUCKETS and pce.MAX_BUCKET == jce.MAX_BUCKET
    for c in (1, 7, 8, 9, 1000):
        assert pce._pad_rows(c) == jce._pad_rows(c)


def test_encode_offsets_arrays_matches(mixed):
    flat, lens = pce.encode_offsets_arrays(mixed["data"], mixed["ends"],
                                           mixed["table"])
    assert flat.dtype == np.int32 and lens.dtype == np.int64
    assert np.array_equal(flat, mixed["flat"])
    assert np.array_equal(lens, mixed["lens"])


def test_encode_offsets_matches(mixed):
    got = pce.encode_offsets(mixed["data"], mixed["ends"], mixed["table"])
    assert got == mixed["flat"].tolist()


def test_encode_chunk_list_matches(mixed):
    got = pce.encode_chunk_list(mixed["chunks"], mixed["table"])
    assert got == mixed["listed"] == mixed["flat"].tolist()


@pytest.mark.parametrize("chunks", [[], [b""], [b"", b"", b""]])
def test_chunk_encoder_empty(chunks):
    pt = prt.SortedPairTable(*_trained(), device="cpu")
    jt = jrt.SortedPairTable(*_trained())
    assert pce.encode_chunk_list(chunks, pt) == \
        jce.encode_chunk_list(chunks, jt) == []
    ends = np.zeros(len(chunks), np.int64)
    flat, lens = pce.encode_offsets_arrays(np.zeros(0, np.uint8), ends, pt)
    wflat, wlens = jce.encode_offsets_arrays(np.zeros(0, np.uint8), ends, jt)
    assert np.array_equal(flat, wflat) and np.array_equal(lens, wlens)


def test_chunk_encoder_matches_flat_encoder_on_smoke(corpus):
    """The smoke corpus's GPT-4 split with smoke_plus_4353: the chunk
    encoder equals the port's sorted route (the plain K11 and K12) and the
    encode golden minbpe_tpu wrote."""
    pairs, new_ids = golden.smoke_plus_merges(golden.SORTED_VOCAB)
    tok = tokenizer_from_arrays(RegexTokenizer, pairs, new_ids, device="cpu")
    text = corpus.decode("utf-8")
    data, ends = tok._split_arrays(text)
    flat, _ = pce.encode_offsets_arrays(
        data, ends, prt.SortedPairTable(pairs, new_ids, device="cpu"))
    assert flat.tolist() == tok.encode_ordinary(text)
    sha, n = golden.load_encode_golden()["smoke_plus_4353"]
    assert len(flat) == n and golden.ids_digest(flat) == sha
