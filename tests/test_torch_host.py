"""minbpe_tpu_torch's host layer against minbpe_tpu: saved files, decode
table, token rendering, the pre-split scanners and stream packing.

Inputs are seeded; every output is bytes or integers, so every comparison
is exact."""

import random
import re

import numpy as np
import pytest
import torch

# The suite runs in several worker processes at once: one intra-op
# thread each keeps the plain PyTorch paths from contending for cores.
torch.set_num_threads(1)

pytest.importorskip("jax")

import minbpe_tpu  # noqa: E402
from minbpe_tpu import base as jbase  # noqa: E402
from minbpe_tpu.ops import stream as jstream  # noqa: E402
from minbpe_tpu.ops.pallas.fused_train import _prep_from_bytes  # noqa: E402
from minbpe_tpu.utils import presplit as jpresplit  # noqa: E402

import minbpe_tpu_torch as port  # noqa: E402
from minbpe_tpu_torch import base as pbase  # noqa: E402
from minbpe_tpu_torch import kernels  # noqa: E402
from minbpe_tpu_torch.ops import stream as pstream  # noqa: E402
from minbpe_tpu_torch.utils import native, presplit  # noqa: E402

TRAIN_TEXT = (
    "The llama (/ˈlɑːmə/; Spanish pronunciation: [ˈʎama]) is a domesticated "
    "South American camelid, widely used as a meat and pack animal by "
    "Andean cultures since the pre-Columbian era. Llamas are social animals "
    "and live with others as a herd. 안녕하세요 👋 tab\there\r\nend.\n") * 3
SPECIALS = {"<|endoftext|>": 100257, "<|fim_prefix|>": 100258}


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("cls_name, specials", [
    ("BasicTokenizer", {}), ("RegexTokenizer", {}),
    ("RegexTokenizer", SPECIALS)])
def test_saved_files_identical_and_cross_load(cls_name, specials, tmp_path):
    j = getattr(minbpe_tpu, cls_name)()
    p = getattr(port, cls_name)(device="cpu")
    j.train(TRAIN_TEXT, 300)
    p.train(TRAIN_TEXT, 300)
    if specials:
        j.register_special_tokens(dict(specials))
        p.register_special_tokens(dict(specials))
    j.save(str(tmp_path / "j"))
    p.save(str(tmp_path / "p"))
    for ext in (".model", ".vocab"):
        assert _read(tmp_path / f"j{ext}") == _read(tmp_path / f"p{ext}")

    # each package loads the other's files and saves them back unchanged
    p2 = getattr(port, cls_name)(device="cpu")
    p2.load(str(tmp_path / "j.model"))
    j2 = getattr(minbpe_tpu, cls_name)()
    j2.load(str(tmp_path / "p.model"))
    p2.save(str(tmp_path / "p2"))
    j2.save(str(tmp_path / "j2"))
    for ext in (".model", ".vocab"):
        assert _read(tmp_path / f"p2{ext}") == _read(tmp_path / f"j2{ext}")
    assert p2.merges == j.merges and j2.merges == p.merges
    assert p2.special_tokens == specials
    assert p2.encode(TRAIN_TEXT) == j.encode(TRAIN_TEXT)


def test_render_token_control_characters():
    cases = [bytes([b]) for b in range(0, 0x20)] + [
        b"\x7f", "\u0085".encode(), "​".encode(), " ".encode(),
        "﻿".encode(), b"\xff\xfe", b"plain", "é😉".encode(),
        b"\x1b[31mred\x1b[0m", "\U000e0001".encode(),
    ]
    for t in cases:
        assert pbase.render_token(t) == jbase.render_token(t)
    s = "".join(chr(c) for c in range(0, 0x300)) + "⁦⁩"
    assert (pbase.escape_control_characters(s)
            == jbase.escape_control_characters(s))


def test_decode_table():
    rng = np.random.default_rng(3)
    mapping = {}
    for k in rng.choice(600, size=400, replace=False):
        mapping[int(k)] = bytes(rng.integers(0, 256, rng.integers(1, 6))
                                .astype(np.uint8))
    pt, jt = pbase.DecodeTable(mapping), jbase.DecodeTable(mapping)
    known = sorted(mapping)
    for trial in range(20):
        ids = list(rng.choice(known, size=rng.integers(0, 50)))
        if trial % 4 == 3:
            ids.insert(int(rng.integers(0, len(ids) + 1)),
                       int(rng.choice([-1, 600, 10**6] + [
                           k for k in range(600) if k not in mapping][:1])))
        assert pt.lookup(ids) == jt.lookup(ids)
    assert pt.lookup([]) == jt.lookup([]) == (b"", -1)


ALPHABETS = [
    "abc ABC'.!?\t\n\r 0123",
    "aA'lLvVeErRsSdDmMtT ſK",
    " \t\n\r\x0b\x0c  　",  # whitespace runs
    "你好世界日本語のテキスト한국어 ",           # CJK
    "😉👍🇺🇸‍́ a1!",                  # emoji, joiners, marks
    "".join(chr(c) for c in [0x1F600, 0x10300, 0xFFFD, 0x0301, 39, 32, 97]),
]


def _strings():
    out = ["", " ", "\n\n\n", "don't WE'LL you're", "1234567 89",
           "   trailing   ", "mixed中文and English", "emoji 😉👍 text"]
    rng = random.Random(17)
    for k in range(60):
        alpha = ALPHABETS[k % len(ALPHABETS)]
        out.append("".join(rng.choice(alpha)
                           for _ in range(rng.randint(1, 80))))
    return out


@pytest.mark.parametrize("mode", [4, 2])
def test_scanners_match_minbpe_tpu(mode):
    assert native.available(), "the native scanner did not build"
    j_split = jpresplit.split_gpt4 if mode == 4 else jpresplit.split_gpt2
    p_split = presplit.split_gpt4 if mode == 4 else presplit.split_gpt2
    for s in _strings():
        want = j_split(s)
        assert p_split(s) == want, repr(s)
        ends = np.cumsum([len(c.encode("utf-8")) for c in want],
                         dtype=np.int64)
        assert np.array_equal(presplit.split_offsets(s, mode), ends), repr(s)
        assert np.array_equal(native.split_offsets(s.encode(), mode),
                              ends), repr(s)


def test_split_arrays_pure_python_fallback(monkeypatch):
    """Without the native library the tokenizer splits with the pure-Python
    scanner, to the same offsets."""
    tok = port.RegexTokenizer(device="cpu")
    text = "".join(_strings())
    data, ends = tok._split_arrays(text)
    monkeypatch.setattr(native, "split_offsets", lambda data, mode: None)
    data2, ends2 = tok._split_arrays(text)
    assert np.array_equal(data, data2) and np.array_equal(ends, ends2)


def test_pack_offsets_and_stream_build():
    rng = np.random.default_rng(11)
    for n in (1, 7, 300, 5000):
        data = rng.integers(0, 256, n).astype(np.uint8)
        cuts = np.sort(rng.choice(np.arange(1, n), size=min(n - 1, n // 3),
                                  replace=False)) if n > 1 else []
        ends = np.concatenate([cuts, [n]]).astype(np.int64)
        for cap in (None, 8192):
            pi, ps, pn = pstream.pack_offsets(data, ends, cap)
            ji, js, jn = jstream.pack_offsets(data, ends, cap)
            assert np.array_equal(pi, ji) and np.array_equal(ps, js)
            assert int(pn) == int(jn)
        # device stream == the Pallas plane build's live prefix; the planes'
        # padding past it is id -1 / seg -2, which the port does not build
        ids, seg = pstream.build_stream(data, ends, "cpu")
        jids, jseg, _ = _prep_from_bytes(data, ends.astype(np.int32), n, 128)
        jids = np.asarray(jids).reshape(-1)
        jseg = np.asarray(jseg).reshape(-1)
        assert ids.shape == seg.shape == (n,)
        assert np.array_equal(ids.numpy(), jids[:n])
        assert np.array_equal(seg.numpy(), jseg[:n])
        assert (jids[n:] == -1).all() and (jseg[n:] == -2).all()
        # and it is the packed stream's live prefix
        assert np.array_equal(ids.numpy(), ji[:n])
        assert np.array_equal(seg.numpy(), js[:n])
    assert pstream.unpack_ids(np.arange(5), 3) == [0, 1, 2]
    assert pstream.bucket_capacity(129) == jstream.bucket_capacity(129)


def _c_entry_points():
    """{name: number of parameters} of the extern "C" functions in the
    kernels' source."""
    import re

    src = open(kernels.SOURCE).read()
    body = src[src.index('extern "C" {'):]
    found = {}
    for m in re.finditer(r"\n(?:int|cudaError_t) (bpe_\w+)\(([^)]*)\)", body):
        params = m.group(2).strip()
        found[m.group(1)] = len(params.split(",")) if params else 0
    return found


@pytest.mark.parametrize("name", sorted(kernels.SIGNATURES))
def test_bound_entry_points_exist(name):
    """Every C entry point the ctypes binding names is defined in the
    source with as many parameters as the binding passes: a missing or
    changed one would fail only when the library loads on the card."""
    found = _c_entry_points()
    assert name in found
    assert found[name] == len(kernels.SIGNATURES[name])
