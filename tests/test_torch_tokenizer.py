"""The port's tokenizers on the CPU against minbpe_tpu on the CPU: trained
merges, verbose lines, encode under every allowed_special mode,
encode_batch, decode, the error paths, and a merge table carried across with
tokenizer_from_arrays. Every output is ids, bytes or text: exact equality."""

import contextlib
import io
import os
import sys

import numpy as np
import pytest
import torch

# The suite runs in several worker processes at once: one intra-op
# thread each keeps the plain PyTorch paths from contending for cores.
torch.set_num_threads(1)

pytest.importorskip("jax")

import minbpe_tpu  # noqa: E402

import minbpe_tpu_torch as port  # noqa: E402
from minbpe_tpu_torch.convert import tokenizer_from_arrays  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "ARCHITECTURE.md"), encoding="utf-8") as _f:
    TEXT = _f.read()[:9000]
SPECIALS = {"<|endoftext|>": 1100, "<|fim_prefix|>": 1101}
WITH_SPECIALS = ("<|endoftext|>" + TEXT[:700] + "<|fim_prefix|>"
                 + TEXT[700:1500] + "<|endoftext|><|endoftext|>x")
DOCS = ["", TEXT[:50], "hello world!!! 😉", TEXT[2000:2600], " ", TEXT[-300:]]


def _train(tok, vocab):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tok.train(TEXT, vocab, verbose=True)
    return out.getvalue()


@pytest.fixture(scope="module", params=[
    ("BasicTokenizer", 300), ("BasicTokenizer", 512),
    ("RegexTokenizer", 300), ("RegexTokenizer", 512)],
    ids=lambda p: f"{p[0]}-{p[1]}")
def pair(request):
    name, vocab = request.param
    j = getattr(minbpe_tpu, name)()
    p = getattr(port, name)(device="cpu")
    jv, pv = _train(j, vocab), _train(p, vocab)
    if name == "RegexTokenizer":
        j.register_special_tokens(dict(SPECIALS))
        p.register_special_tokens(dict(SPECIALS))
    return name, j, p, jv, pv


def test_merges_and_verbose_lines(pair):
    _, j, p, jv, pv = pair
    assert p.merges == j.merges
    assert p.vocab == j.vocab
    assert pv == jv and pv.count("\n") == len(j.merges)


def test_encode_decode(pair):
    name, j, p, _, _ = pair
    ids = p.encode(TEXT)
    assert ids == j.encode(TEXT)
    assert p.decode(ids) == j.decode(ids) == TEXT
    if name == "RegexTokenizer":
        assert p.encode_ordinary(TEXT) == ids


def test_encode_batch(pair):
    name, j, p, _, _ = pair
    got = p.encode_batch(DOCS)
    assert got == j.encode_batch(DOCS) == [p.encode(d) for d in DOCS]
    if name == "RegexTokenizer":
        docs = DOCS + [WITH_SPECIALS]
        got = p.encode_batch(docs, allowed_special="all")
        assert got == j.encode_batch(docs, allowed_special="all")
        assert got[-1] == p.encode(WITH_SPECIALS, allowed_special="all")


@pytest.mark.parametrize("mode", ["all", "none", "set", "none_raise"])
def test_allowed_special_modes(pair, mode):
    name, j, p, _, _ = pair
    if name != "RegexTokenizer":
        assert p.encode(WITH_SPECIALS) == j.encode(WITH_SPECIALS)
        return
    if mode == "none_raise":
        with pytest.raises(AssertionError):
            p.encode(WITH_SPECIALS)
        with pytest.raises(AssertionError):
            j.encode(WITH_SPECIALS)
        assert p.encode(TEXT) == j.encode(TEXT)
        return
    allowed = {"<|fim_prefix|>"} if mode == "set" else mode
    ids = p.encode(WITH_SPECIALS, allowed_special=allowed)
    assert ids == j.encode(WITH_SPECIALS, allowed_special=allowed)
    assert p.decode(ids) == WITH_SPECIALS
    if mode == "all":
        assert ids.count(1100) == 3 and ids.count(1101) == 1


def test_error_paths(pair):
    name, j, p, _, _ = pair
    unknown = KeyError if name == "BasicTokenizer" else ValueError
    for tok in (p, j):
        with pytest.raises(unknown):
            tok.decode([65, 5000])
    if name == "RegexTokenizer":
        with pytest.raises(ValueError):
            p.encode("x", allowed_special="bogus")
    cls = getattr(port, name)
    with pytest.raises(ValueError, match="no mergeable pair available at "
                                         "merge round 1"):
        cls(device="cpu").train("ab", 256 + 5)
    with pytest.raises(ValueError):
        getattr(minbpe_tpu, name)().train("ab", 256 + 5)


def test_from_arrays_encodes_like_minbpe_tpu(pair):
    name, j, _, _, _ = pair
    pairs, new_ids = j._merge_arrays()
    kw = {"special_tokens": SPECIALS} if name == "RegexTokenizer" else {}
    t = tokenizer_from_arrays(getattr(port, name), pairs, new_ids,
                              device="cpu", **kw)
    assert t.merges == j.merges and t.vocab == j.vocab
    if name == "RegexTokenizer":
        assert (t.encode(WITH_SPECIALS, allowed_special="all")
                == j.encode(WITH_SPECIALS, allowed_special="all"))
    assert t.encode(TEXT) == j.encode(TEXT)


def test_options_outside_the_slice_raise():
    tok = port.BasicTokenizer(device="cpu")
    for mode in ("sortloop", "sortloop_inc", "sparse", "sparse_inc"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md A11"):
            tok.train(TEXT, 260, select_mode=mode)
    with pytest.raises(ValueError, match="unknown select_mode"):
        tok.train(TEXT, 260, select_mode="bogus")
    with pytest.raises(TypeError):
        tok.train(TEXT, 260, bogus=1)
    with pytest.raises(NotImplementedError, match="A11"):
        tok.train(TEXT, 2049)
    # a table deeper than the encoder's 2048 ranks: (97, 97) -> 256, then
    # (z, 97) -> z + 1 for every later rank
    M = 2049
    pairs = np.array([[97, 97]] + [[255 + r, 97] for r in range(1, M)])
    big = tokenizer_from_arrays(port.BasicTokenizer, pairs,
                                256 + np.arange(M), device="cpu")
    with pytest.raises(NotImplementedError, match="A12"):
        big.encode("aaaa")


def test_custom_pattern():
    pattern = r"\w+|\s+|[^\w\s]+"
    j = minbpe_tpu.RegexTokenizer(pattern)
    p = port.RegexTokenizer(pattern, device="cpu")
    j.train(TEXT, 300)
    p.train(TEXT, 300)
    assert p.merges == j.merges
    assert p.encode(TEXT) == j.encode(TEXT)


def test_custom_pattern_needs_regex(monkeypatch):
    monkeypatch.setitem(sys.modules, "regex", None)
    with pytest.raises(ImportError):
        port.RegexTokenizer(r"\w+", device="cpu")
    port.RegexTokenizer(device="cpu")  # the GPT patterns need no regex


@pytest.mark.parametrize("saved, loaded", [("custom", "gpt4"),
                                           ("gpt4", "custom")])
def test_load_keeps_the_constructors_split(tmp_path, saved, loaded):
    """After load(), the port splits with the pattern the tokenizer was
    constructed with, as the reference does (its load() never touches
    compiled_pattern): a custom model loaded into RegexTokenizer() splits
    GPT-4 chunks, and a GPT-4 model loaded into RegexTokenizer(custom)
    splits custom chunks, where minbpe_tpu takes the scanner the loaded
    pattern names. save() writes the loaded pattern back."""
    patterns = {"custom": r"\w+|\s+|[^\w\s]+", "gpt4": None}
    trained = minbpe_tpu.RegexTokenizer(patterns[saved])
    trained.train(TEXT, 300)
    prefix = str(tmp_path / "m")
    trained.save(prefix)
    j = minbpe_tpu.RegexTokenizer(patterns[loaded])
    p = port.RegexTokenizer(patterns[loaded], device="cpu")
    j.load(prefix + ".model")
    p.load(prefix + ".model")
    assert p.pattern == j.pattern == trained.pattern
    p.save(str(tmp_path / "p"))
    with open(prefix + ".model", "rb") as a, open(
            str(tmp_path / "p.model"), "rb") as b:
        assert a.read() == b.read()
    text = TEXT[:4000] + " don't   stop\n\n  123456 "
    if saved == "custom":
        assert p.encode(text) == j.encode(text)
        assert p.encode_batch([text, text[:99]]) == j.encode_batch(
            [text, text[:99]])
        # the loaded pattern's own chunks would give other ids
        assert p.encode(text) != trained.encode(text)
    else:
        # the same merges under the constructor's pattern: the contract
        pairs, new_ids = trained._merge_arrays()
        want = tokenizer_from_arrays(port.RegexTokenizer, pairs, new_ids,
                                     pattern=patterns[loaded], device="cpu")
        assert p.encode(text) == want.encode(text)
        assert p.encode_batch([text, text[:99]]) == want.encode_batch(
            [text, text[:99]])
        # minbpe_tpu departs from the contract here (ROADMAP.md queue C)
        assert p.encode(text) != j.encode(text)


def _bad_id_in(ids, bad):
    yield from ids[:3]
    yield bad
    yield from ids[3:]


@pytest.mark.parametrize("kind", ["list", "tuple", "numpy", "generator",
                                  "iter"])
def test_decode_takes_any_iterable(pair, kind):
    """decode takes any iterable of ints, as the reference's
    b"".join(vocab[idx] for idx in ids) does; an unknown id inside a
    generator raises the reference's error, naming that id."""
    name, _, p, _, _ = pair
    ids = p.encode(TEXT[:3000])
    wrap = {"list": list, "tuple": tuple,
            "numpy": lambda x: np.asarray(x, np.int32),
            "generator": lambda x: (i for i in x), "iter": iter}[kind]
    assert p.decode(wrap(ids)) == TEXT[:3000]
    assert p.decode(wrap([])) == ""
    unknown = KeyError if name == "BasicTokenizer" else ValueError
    with pytest.raises(unknown, match="5000"):
        p.decode(_bad_id_in(ids, 5000))
