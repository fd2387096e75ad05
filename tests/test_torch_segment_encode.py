"""K17 segment_encode's plain twin, and the dense route's choice between it
and K10, on the CPU: streams against minbpe_tpu's stream encoder (jitted on
the CPU), K10's plain sweep and the pure-Python oracle; the tokenizers'
encode paths, which take K17 where the stream holds more than one segment
and, where the host knows their lengths, none past TILE (2,048) tokens,
against minbpe_tpu's tokenizers. Outputs are ids: equal or
wrong."""

import os

import numpy as np
import pytest
import torch

# The suite runs in several worker processes at once: one intra-op
# thread each keeps the plain PyTorch paths from contending for cores.
torch.set_num_threads(1)

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import minbpe_tpu  # noqa: E402
import oracle  # noqa: E402
from minbpe_tpu import gpt4 as jgpt4  # noqa: E402
from minbpe_tpu.ops import encode as jencode  # noqa: E402
from minbpe_tpu.ops import stream as jstream  # noqa: E402

import minbpe_tpu_torch as port  # noqa: E402
from minbpe_tpu_torch import engine, kernels, trace  # noqa: E402
from minbpe_tpu_torch.convert import tokenizer_from_arrays  # noqa: E402
from minbpe_tpu_torch.ops import encode as port_encode  # noqa: E402
from minbpe_tpu_torch.ops.ranktab import CuckooPairTable  # noqa: E402
from minbpe_tpu_torch.utils import golden  # noqa: E402
from minbpe_tpu_torch.utils.synthranks import synthetic_ranks  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = golden.smoke_corpus(ROOT)
DATA = CORPUS.encode("utf-8")
# the smoke corpus's trained merges (a dense table: vocab 1024)
MERGES = golden.load_golden()["merges"].astype(np.int32)
NEW_IDS = (256 + np.arange(len(MERGES))).astype(np.int32)
TABLE = CuckooPairTable(MERGES, NEW_IDS, "cpu")
# one capacity for every stream, so minbpe_tpu's encoder compiles once
CAP = 1 << 15


def _jax_encode(ids, seg, n, pairs=MERGES, new_ids=NEW_IDS):
    """minbpe_tpu's stream encoder (ops/encode.py), jitted on the CPU."""
    V = 256 + len(pairs)
    out, k = jencode.encode_stream(
        jnp.asarray(ids), jnp.asarray(seg), jnp.int32(n),
        jnp.asarray(jencode.build_rank_table(np.asarray(pairs), V)),
        jnp.asarray(pairs), jnp.asarray(new_ids))
    return np.asarray(out)[:int(k)].tolist()


def _both_plain(ids, seg, n, table=TABLE, pairs=MERGES, new_ids=NEW_IDS):
    """K17's plain twin, held to K10's plain sweep (ids and seg); its ids."""
    ti = torch.from_numpy(np.ascontiguousarray(ids[:n]))
    ts = torch.from_numpy(np.ascontiguousarray(seg[:n]))
    gi, gs, gn = kernels.segment_encode(ti, ts, table)
    wi, ws, wn = kernels.encode_sweep_plain(
        ti, ts, torch.from_numpy(np.asarray(pairs, np.int32).reshape(-1, 2)),
        torch.from_numpy(np.asarray(new_ids, np.int32)))
    k = int(wn)
    assert int(gn) == k
    assert torch.equal(gi[:k], wi[:k]) and torch.equal(gs[:k], ws[:k])
    return gi[:k].tolist()


@pytest.mark.parametrize("length", [1, 2, 8, 9, 32, 256, 257, 20_000])
def test_segment_of_length(length):
    """A segment of this many tokens among short ones (a lane's up to 8, a
    warp's up to 256, a block's past it on the card): equal to minbpe_tpu's
    stream encoder and K10's plain sweep, each token with its segment's
    seg."""
    at = (7919 * length) % (len(DATA) - length - 20)
    cuts = np.cumsum([at, 3, length, 1, 5, 2])
    chunks = [DATA[a:b] for a, b in zip(cuts[:-1], cuts[1:])]
    ids, seg, n = jstream.pack_chunks(chunks, CAP)
    assert _both_plain(ids, seg, n) == _jax_encode(ids, seg, n)


def test_segments_by_seg_runs_not_values():
    """A segment is a run of equal seg: seg values that only differ from
    their neighbours, spaced apart and repeated further on, cut the same
    segments as chunk indices."""
    chunks = [DATA[k:k + 1 + k % 11] for k in range(0, 3000, 13)]
    ids, seg, n = jstream.pack_chunks(chunks, CAP)
    spaced = (seg[:n] % 3) * 1000 + 5
    got = _both_plain(ids, spaced, n)
    assert got == _jax_encode(ids, seg, n)
    _, gs, k = kernels.segment_encode(torch.from_numpy(ids[:n]),
                                      torch.from_numpy(spaced), TABLE)
    assert set(gs[:int(k)].tolist()) <= set(spaced.tolist())


def test_runs_of_one_token():
    """Runs of one byte inside segments, of every length 1 .. 20, one of 600
    (a block's on the card) and runs cut by segment ends, with (a, a) and
    its doublings ranked: the even offsets from each run's start merge,
    left first."""
    pairs = np.array([[97, 97], [256, 256], [257, 257], [256, 97],
                      [258, 97], [120, 97]], np.int32)
    new_ids = (256 + np.arange(len(pairs))).astype(np.int32)
    ranks = {tuple(p): (r, int(z))
             for r, (p, z) in enumerate(zip(pairs.tolist(), new_ids))}
    chunks = ([b"a" * k for k in range(1, 21)]
              + [b"xa" + b"a" * 600 + b"y", b"aa", b"a" * 7, b"a" * 9])
    ids, seg, n = jstream.pack_chunks(chunks, CAP)
    table = CuckooPairTable(pairs, new_ids, "cpu")
    want = [t for c in chunks for t in oracle.encode(list(c), ranks)]
    assert _both_plain(ids, seg, n, table, pairs, new_ids) == want
    assert want == _jax_encode(ids, seg, n, pairs, new_ids)


def test_no_merges_and_empty_stream():
    """M = 0: every token stays; an empty stream gives n = 0."""
    empty = CuckooPairTable(np.zeros((0, 2), np.int32),
                            np.zeros(0, np.int32), "cpu")
    ids = torch.tensor([1, 2, 2, 3], dtype=torch.int32)
    seg = torch.tensor([0, 0, 1, 1], dtype=torch.int32)
    gi, gs, gn = kernels.segment_encode(ids, seg, empty)
    assert int(gn) == 4 and gi.tolist() == [1, 2, 2, 3]
    assert gs.tolist() == [0, 0, 1, 1]
    gi, gs, gn = kernels.segment_encode(ids[:0], seg[:0], TABLE)
    assert int(gn) == 0 and gi.numel() == 0


def _pair(cls_name):
    """The port's and minbpe_tpu's tokenizers of the smoke merges."""
    p = tokenizer_from_arrays(getattr(port, cls_name), MERGES, NEW_IDS,
                              device="cpu")
    j = getattr(minbpe_tpu, cls_name)()
    j.merges = dict(p.merges)
    j.vocab = j._build_vocab()
    return p, j


@pytest.mark.parametrize("presplit", [False, True])
def test_empty_and_one_byte_texts(presplit):
    """Texts of no byte, of one byte and of one character of several
    bytes, by the host split and the device split."""
    p, j = _pair("RegexTokenizer")
    p.device_presplit = presplit
    for text in ("", "x", " ", "\n", "é", "😉", "ab"):
        assert p.encode(text) == j.encode(text)


@pytest.mark.parametrize("presplit", [False, True])
def test_gpt4_byte_shuffle_dense_table(presplit):
    """GPT4Tokenizer with a table below the dense route's vocab: its byte
    shuffle reaches K17's ids on both splits."""
    ranks, _, specials = synthetic_ranks(1000, seed=3)
    p = port.GPT4Tokenizer.from_mergeable_ranks(ranks, specials,
                                                device="cpu")
    j = jgpt4.GPT4Tokenizer.from_mergeable_ranks(ranks, specials)
    assert engine.device_table(p).kind == "dense"
    p.device_presplit = presplit
    trace.reset()
    for text in (CORPUS[:20_000], "hello world!!!? (안녕하세요!) lol123 😉",
                 "  \n\n  mixed   WS\t and 12345 numbers 67890 it's"):
        assert p.encode(text) == j.encode(text)
    assert trace.COUNTERS["encode.route.segments"] == 3
    assert "encode.route.sweep" not in trace.COUNTERS


def test_host_split_and_encode_parts_many_documents():
    """encode_batch of 64 documents is one stream of many segments: K17's
    route once, each document's ids equal minbpe_tpu's; encode_parts'
    parts come back apart."""
    p, j = _pair("RegexTokenizer")
    docs = [CORPUS[k * 997:k * 997 + (k * 37) % 900] for k in range(64)]
    trace.reset()
    got = p.encode_batch(docs)
    assert trace.COUNTERS["encode.route.segments"] == 1
    assert got == [j.encode(d) for d in docs]
    parts = [p._split_arrays(d) for d in docs[:9]]
    out = engine.encode_parts(p, parts)
    assert [o.tolist() for o in out] == got[:9]


def test_one_segment_takes_the_rank_sweep(monkeypatch):
    """A stream of one segment stays on K10: BasicTokenizer.encode, and a
    RegexTokenizer text of one chunk; encode.route.sweep counts each."""
    calls = []
    for name in ("encode_sweep", "segment_encode"):
        real = getattr(kernels, name)
        monkeypatch.setattr(kernels, name, lambda *a, _r=real, _n=name:
                            calls.append(_n) or _r(*a))
    b, jb = _pair("BasicTokenizer")
    trace.reset()
    assert b.encode(CORPUS[:3000]) == jb.encode(CORPUS[:3000])
    assert calls == ["encode_sweep"]
    assert trace.COUNTERS["encode.route.sweep"] == 1
    assert "encode.route.segments" not in trace.COUNTERS
    r, jr = _pair("RegexTokenizer")
    calls.clear()
    assert r.encode("hello") == jr.encode("hello")
    assert r.encode("hello world") == jr.encode("hello world")
    assert calls == ["encode_sweep", "segment_encode"]


@pytest.mark.parametrize("lengths, route", [
    ([5], "sweep"), ([3000], "sweep"), ([1, 1], "segments"),
    ([3, 257, 1], "segments"), ([3, 2048, 1], "segments"),
    ([3, 2049, 1], "sweep"), ([40] * 50 + [9000], "sweep")])
def test_host_split_routes_by_longest_chunk(lengths, route):
    """A stream whose chunk lengths the host holds takes K17 where it has
    more than one chunk and none past TILE (2,048) tokens, else K10; both
    give minbpe_tpu's ids."""
    p, _ = _pair("RegexTokenizer")
    ends = np.cumsum(lengths)
    data = np.frombuffer(DATA[:int(ends[-1])], np.uint8)
    trace.reset()
    got, _ = engine._encode_arrays(p, data, ends)
    assert {k: v for k, v in trace.COUNTERS.items()
            if k.startswith("encode.route")} == {f"encode.route.{route}": 1}
    chunks = [DATA[a:b] for a, b in zip(np.r_[0, ends[:-1]], ends)]
    ids, seg, n = jstream.pack_chunks(chunks, CAP)
    assert got.tolist() == _jax_encode(ids, seg, n)


@pytest.mark.parametrize("sizes, route", [((100, 256, 7), "segments"),
                                          ((100, 2048), "segments"),
                                          ((100, 2049), "sweep"),
                                          ((5000, 3000), "sweep")])
def test_basic_encode_batch_routes_by_longest_document(sizes, route):
    """BasicTokenizer.encode_batch, a document a segment: K17 where no
    document passes TILE tokens, else K10; equal to minbpe_tpu's."""
    b, jb = _pair("BasicTokenizer")
    ascii_text = DATA.decode("ascii", "ignore")  # a byte a character
    docs = [ascii_text[k * 1000:k * 1000 + n] for k, n in enumerate(sizes)]
    trace.reset()
    assert b.encode_batch(docs) == [jb.encode(d) for d in docs]
    assert {k: v for k, v in trace.COUNTERS.items()
            if k.startswith("encode.route")} == {f"encode.route.{route}": 1}


@pytest.mark.parametrize("lengths, k17", [
    (None, False), ([3000], False), ([3, 2048, 1], True),
    ([3, 2049, 1], False), (port_encode.DEVICE_SPLIT, True)])
def test_memory_check_counts_the_routes_bytes(monkeypatch, lengths, k17):
    """On the card an encode asks for K17's bytes a token and the cuckoo
    rows it has still to build, or K10's bytes a token alone; a table given
    by its merge count counts the rows a built one would hold."""
    need = []
    monkeypatch.setattr(port_encode, "check_device_memory",
                        lambda dev, nbytes, what: need.append(nbytes))
    if isinstance(lengths, list):
        lengths = np.asarray(lengths)
    card = torch.device("cuda")
    dev = engine.DeviceMergeTable(MERGES, NEW_IDS, "cpu")
    port_encode.check_memory(card, 1000, dev, lengths=lengths, split_bytes=7)
    port_encode.check_memory(card, 1000, len(NEW_IDS), lengths=lengths)
    per = (port_encode.SEGMENT_BYTES_PER_TOKEN if k17
           else port_encode.BYTES_PER_TOKEN)
    rows = CuckooPairTable.device_bytes(len(NEW_IDS)) if k17 else 0
    assert need == [(per + 7) * 1000 + rows, per * 1000 + rows]
    assert dev.cuckoo is not None  # built: no rows left to count
    need.clear()
    port_encode.check_memory(card, 1000, dev, lengths=lengths)
    assert need == [per * 1000]
