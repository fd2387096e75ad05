"""The port's GPT4Tokenizer (minbpe_tpu_torch/gpt4.py, its plain CPU path)
against minbpe_tpu's, on synthetic cl100k-shaped ranks at 8,192 ranks
(tests/test_synth_gpt4.py's table): the recovered merge forest, encode,
encode_batch, special tokens, decode and save_vocab's bytes equal; the
dense/sorted route boundary; the hermetic rank loader and its cache."""

import base64
import os

import numpy as np
import pytest
import torch

# The suite runs in several worker processes at once: one intra-op
# thread each keeps the plain PyTorch paths from contending for cores.
torch.set_num_threads(1)

pytest.importorskip("jax")

from minbpe_tpu import engine as jengine  # noqa: E402
from minbpe_tpu import gpt4 as jgpt4  # noqa: E402
from minbpe_tpu.utils.synthranks import synthetic_ranks as jsynth  # noqa: E402

from minbpe_tpu_torch import engine, gpt4  # noqa: E402
from minbpe_tpu_torch.utils import golden  # noqa: E402
from minbpe_tpu_torch.utils.synthranks import synthetic_ranks  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXTS = [
    "hello world!!!? (안녕하세요!) lol123 😉",
    "",
    "x",
    "FILE tail  \n\n spaces   ",
    "  \n\n  mixed   WS\t and 12345 numbers 67890 it's they'll we've",
]


@pytest.fixture(scope="module")
def synth():
    return synthetic_ranks(8192, seed=7)


@pytest.fixture(scope="module")
def toks(synth):
    ranks, _, specials = synth
    return (gpt4.GPT4Tokenizer.from_mergeable_ranks(ranks, specials,
                                                    device="cpu"),
            jgpt4.GPT4Tokenizer.from_mergeable_ranks(ranks, specials))


@pytest.fixture(scope="module")
def corpus():
    return golden.smoke_corpus(ROOT)[:60_000]


def test_synthetic_ranks_equal_minbpe_tpu(synth):
    ranks, intended, specials = synth
    assert (ranks, intended, specials) == jsynth(8192, seed=7)


def test_recovery_equal(synth):
    ranks, intended, _ = synth
    assert gpt4.recover_merge_forest(ranks) == intended == \
        jgpt4.recover_merge_forest(ranks)


def test_tables_equal(toks):
    p, j = toks
    assert p.merges == j.merges and p.vocab == j.vocab
    assert np.array_equal(p.byte_shuffle, j.byte_shuffle)
    assert np.array_equal(p.inverse_byte_shuffle, j.inverse_byte_shuffle)
    assert engine.device_table(p).kind == "sorted"


@pytest.mark.parametrize("k", range(len(TEXTS)))
def test_encode_decode(toks, k):
    p, j = toks
    text = TEXTS[k]
    ids = p.encode(text)
    assert ids == j.encode(text)
    assert p.encode_ordinary(text) == j.encode_ordinary(text) == ids
    assert p.decode(ids) == j.decode(ids) == text


def test_corpus_encode_and_batch(toks, corpus):
    p, j = toks
    ids = p.encode(corpus)
    assert ids == j.encode(corpus)
    assert p.decode(ids) == corpus
    docs = golden.smoke_documents(corpus)
    batch = p.encode_batch(docs)
    assert batch == j.encode_batch(docs)
    assert len(batch) == 256


@pytest.mark.parametrize("allowed", ["all", "none", "set"])
def test_specials(toks, synth, corpus, allowed):
    p, j = toks
    names = list(synth[2])
    text = golden.special_text(golden.smoke_documents(corpus), names[:2])
    allow = set(names[:1]) if allowed == "set" else allowed
    ids = p.encode(text, allowed_special=allow)
    assert ids == j.encode(text, allowed_special=allow)
    assert (synth[2][names[0]] in ids) == (allowed != "none")
    with pytest.raises(AssertionError):
        p.encode(text)  # none_raise


def test_decode_unknown_raises(toks):
    p, j = toks
    for bad in ([8192], [8195], [5, -1]):  # a special id, beyond, negative
        with pytest.raises(KeyError):
            j.decode(bad)
        with pytest.raises(KeyError):
            p.decode(bad)
    assert p.decode(x for x in p.encode("gen")) == "gen"


def test_save_vocab_bytes(toks, tmp_path):
    p, j = toks
    p.save_vocab(str(tmp_path / "port.vocab"))
    j.save_vocab(str(tmp_path / "jax.vocab"))
    assert (tmp_path / "port.vocab").read_bytes() == \
        (tmp_path / "jax.vocab").read_bytes()


def test_train_save_load_raise(toks, tmp_path):
    p, _ = toks
    with pytest.raises(NotImplementedError):
        p.train("some text", 300)
    with pytest.raises(NotImplementedError):
        p.save(str(tmp_path / "x"))
    with pytest.raises(NotImplementedError):
        p.load(str(tmp_path / "x.model"))


@pytest.mark.parametrize("n_ranks", [4096, 4097])
def test_route_boundary(n_ranks):
    """A table of ids below 4096 takes the dense route, one reaching 4096
    the sorted one, in both packages, and both encode alike."""
    ranks, _, _ = synthetic_ranks(n_ranks, seed=3)
    p = gpt4.GPT4Tokenizer.from_mergeable_ranks(ranks, device="cpu")
    j = jgpt4.GPT4Tokenizer.from_mergeable_ranks(ranks)
    kind = engine.device_table(p).kind
    assert kind == jengine.device_table(j).kind
    assert kind == ("dense" if n_ranks <= engine.DENSE_VOCAB_MAX else "sorted")
    text = TEXTS[0] + TEXTS[4]
    assert p.encode(text) == j.encode(text)


def _write_ranks(path, ranks):
    with open(path, "wb") as f:
        for tok, rank in sorted(ranks.items(), key=lambda kv: kv[1]):
            f.write(base64.b64encode(tok) + b" " + str(rank).encode() + b"\n")


@pytest.fixture()
def rank_file(tmp_path, monkeypatch):
    ranks, intended, _ = synthetic_ranks(2000, seed=11)
    p = tmp_path / "synth.tiktoken"
    _write_ranks(p, ranks)
    for var in ("MINBPE_TPU_CL100K", "TIKTOKEN_CACHE_DIR",
                "DATA_GYM_CACHE_DIR"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("TMPDIR", str(tmp_path / "tmp"))
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    return ranks, intended, p


def test_loader_precedence(rank_file, tmp_path, monkeypatch):
    """The env var first, then the vendored file, then tiktoken's cache
    names; with none of them the constructor raises, offline."""
    ranks, intended, p = rank_file
    if not os.path.isfile(gpt4._VENDORED):
        assert gpt4._find_rank_file() is None
        assert not gpt4.cl100k_ranks_available()
        with pytest.raises(RuntimeError, match="MINBPE_TPU_CL100K"):
            gpt4.GPT4Tokenizer(device="cpu")
    cache = tmp_path / "tiktoken"
    cache.mkdir()
    other = dict(ranks)
    other[b"zz"] = max(ranks.values()) + 1
    _write_ranks(cache / gpt4._TIKTOKEN_CACHE_NAME, other)
    monkeypatch.setenv("TIKTOKEN_CACHE_DIR", str(cache))
    if not os.path.isfile(gpt4._VENDORED):
        assert gpt4._find_rank_file() == str(cache /
                                             gpt4._TIKTOKEN_CACHE_NAME)
        assert gpt4.load_cl100k_ranks() == other
    monkeypatch.setenv("MINBPE_TPU_CL100K", str(p))
    assert next(gpt4._candidate_rank_files()) == str(p)
    assert gpt4._find_rank_file() == str(p)
    assert gpt4.load_cl100k_ranks() == ranks
    tok = gpt4.GPT4Tokenizer(device="cpu")
    assert tok.merges == intended
    assert tok.special_tokens == gpt4.GPT4_SPECIAL_TOKENS
    ref = gpt4.GPT4Tokenizer.from_mergeable_ranks(
        ranks, gpt4.GPT4_SPECIAL_TOKENS, device="cpu")
    for s in TEXTS:
        ids = tok.encode(s, allowed_special="none")
        assert ids == ref.encode(s, allowed_special="none")
        assert tok.decode(ids) == s


def test_recovery_cache_hit_and_miss(rank_file, monkeypatch):
    ranks, _, p = rank_file
    monkeypatch.setenv("MINBPE_TPU_CL100K", str(p))
    cache_dir = gpt4._cache_dir()
    assert cache_dir.endswith("minbpe_tpu_torch")
    first = gpt4._load_recovered(str(p))  # miss: recover and write
    files = [f for f in os.listdir(cache_dir)
             if f.startswith("cl100k_merges_")]
    assert len(files) == 1
    second = gpt4._load_recovered(str(p))  # hit
    for a, b in zip(first, second):
        assert np.array_equal(a, b)
    want = np.array([ranks[bytes([i])] for i in range(256)], np.uint8)
    assert np.array_equal(first[2], want)
