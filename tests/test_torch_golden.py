"""The smoke golden: minbpe_tpu's result on the frozen smoke corpus.

The machine with the card has no JAX, so minbpe_tpu_torch/data/
smoke_golden.npz is chip_smoke.py's only link to the reference there. These
tests hold the port's plain CPU path and minbpe_tpu itself to it. Rewrite
it (only when the corpus or the reference changes) with

    PYTHONPATH= JAX_PLATFORMS=cpu python tests/test_torch_golden.py --write

and the XL golden (minbpe_tpu_torch/data/xl_golden.npz: the 12,588,338-byte
XL corpus at vocab 1024, through minbpe_tpu's stepped route, ~7 minutes on
a CPU) with ``--write-xl``. Both XL tests are marked slow: each trains the
whole XL corpus on the CPU. ``--write-2048`` writes
minbpe_tpu_torch/data/smoke2048_golden.npz: the smoke corpus at vocab 2048,
the default route of both packages there (the stepped trainer).
"""

import contextlib
import io
import os
import re
import sys

import numpy as np
import pytest
import torch

# The suite runs in several worker processes at once: one intra-op
# thread each keeps the plain PyTorch paths from contending for cores.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from minbpe_tpu_torch.utils import golden  # noqa: E402


def _train_verbose(tok, text, vocab_size=golden.VOCAB_SIZE):
    """Train through the public API; the per-merge counts come from the
    verbose lines, whose format both packages share."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tok.train(text, vocab_size, verbose=True)
    counts = [int(c) for c in re.findall(r"had (\d+) occurrences",
                                         out.getvalue())]
    items = sorted(tok.merges.items(), key=lambda kv: kv[1])
    merges = np.array([list(p) for p, _ in items], dtype=np.int32)
    return merges, np.array(counts, dtype=np.int32)


def _reference_result():
    from minbpe_tpu import RegexTokenizer

    text = golden.smoke_corpus(ROOT)
    tok = RegexTokenizer()
    merges, counts = _train_verbose(tok, text)
    return merges, counts, len(merges), tok.encode(text)


def _reference_2048_result():
    from minbpe_tpu import RegexTokenizer

    merges, counts = _train_verbose(RegexTokenizer(), golden.smoke_corpus(
        ROOT), golden.VOCAB_SIZE_2048)
    return merges, counts, len(merges)


def _reference_xl_result():
    from minbpe_tpu import RegexTokenizer

    text = golden.xl_corpus(ROOT)
    tok = RegexTokenizer()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tok.train(text, golden.VOCAB_SIZE, verbose=True,
                  select_mode="stepped")
    counts = [int(c) for c in re.findall(r"had (\d+) occurrences",
                                         out.getvalue())]
    items = sorted(tok.merges.items(), key=lambda kv: kv[1])
    merges = np.array([list(p) for p, _ in items], dtype=np.int32)
    return merges, np.array(counts, dtype=np.int32), len(merges), text


def test_corpus_is_frozen():
    text = golden.smoke_corpus(ROOT)
    assert len(text.encode("utf-8")) == 397366
    assert sum(ord(c) > 127 for c in text) == 456


def test_port_plain_path_matches_golden():
    from minbpe_tpu_torch import RegexTokenizer

    want = golden.load_golden()
    text = golden.smoke_corpus(ROOT)
    tok = RegexTokenizer(device="cpu")
    merges, counts = _train_verbose(tok, text)
    assert np.array_equal(merges, want["merges"])
    assert np.array_equal(counts, want["counts"])
    assert want["fail_round"] == golden.VOCAB_SIZE - 256
    ids = tok.encode(text)
    assert len(ids) == want["n_ids"]
    assert golden.ids_digest(ids) == want["encode_sha256"]


@pytest.mark.slow
def test_minbpe_tpu_reproduces_golden():
    pytest.importorskip("jax")
    want = golden.load_golden()
    merges, counts, fail_round, ids = _reference_result()
    assert np.array_equal(merges, want["merges"])
    assert np.array_equal(counts, want["counts"])
    assert fail_round == want["fail_round"]
    assert golden.ids_digest(ids) == want["encode_sha256"]


def test_minbpe_tpu_reproduces_2048_golden():
    pytest.importorskip("jax")
    want = golden.load_golden_2048()
    merges, counts, fail_round = _reference_2048_result()
    assert np.array_equal(merges, want["merges"])
    assert np.array_equal(counts, want["counts"])
    assert fail_round == want["fail_round"]


@pytest.mark.slow
def test_port_plain_path_matches_2048_golden():
    """The port's default route at vocab 2048 (the stepped trainer), ~140 s
    on a CPU."""
    from minbpe_tpu_torch import RegexTokenizer

    want = golden.load_golden_2048()
    merges, counts = _train_verbose(RegexTokenizer(device="cpu"),
                                    golden.smoke_corpus(ROOT),
                                    golden.VOCAB_SIZE_2048)
    assert np.array_equal(merges, want["merges"])
    assert np.array_equal(counts, want["counts"])


def test_2048_golden_extends_the_1024_golden():
    """Training is greedy, so the first 768 merges at vocab 2048 are those
    at vocab 1024."""
    small, big = golden.load_golden(), golden.load_golden_2048()
    assert big["fail_round"] == golden.VOCAB_SIZE_2048 - 256
    assert np.array_equal(big["merges"][:768], small["merges"])
    assert np.array_equal(big["counts"][:768], small["counts"])


@pytest.mark.slow
def test_minbpe_tpu_reproduces_xl_golden():
    pytest.importorskip("jax")
    want = golden.load_xl_golden()
    merges, counts, fail_round, text = _reference_xl_result()
    assert golden.text_digest(text) == want["corpus_sha256"]
    assert np.array_equal(merges, want["merges"])
    assert np.array_equal(counts, want["counts"])
    assert fail_round == want["fail_round"]


@pytest.mark.slow
def test_port_plain_path_matches_xl_golden():
    from minbpe_tpu_torch import RegexTokenizer

    want = golden.load_xl_golden()
    text = golden.xl_corpus(ROOT)
    assert len(text.encode("utf-8")) == want["corpus_bytes"] == 12588338
    assert golden.text_digest(text) == want["corpus_sha256"]
    merges, counts = _train_verbose(RegexTokenizer(device="cpu"), text)
    assert np.array_equal(merges, want["merges"])
    assert np.array_equal(counts, want["counts"])
    assert want["fail_round"] == golden.VOCAB_SIZE - 256


if __name__ == "__main__":
    if sys.argv[1:] == ["--write"]:
        merges, counts, fail_round, ids = _reference_result()
        golden.save_golden(merges, counts, fail_round, ids)
        print(f"wrote {golden.GOLDEN}: {len(merges)} merges, {len(ids)} ids")
    elif sys.argv[1:] == ["--write-2048"]:
        merges, counts, fail_round = _reference_2048_result()
        golden.save_golden_2048(merges, counts, fail_round)
        print(f"wrote {golden.GOLDEN_2048}: {len(merges)} merges")
    elif sys.argv[1:] == ["--write-xl"]:
        merges, counts, fail_round, text = _reference_xl_result()
        golden.save_xl_golden(merges, counts, fail_round, text)
        print(f"wrote {golden.XL_GOLDEN}: {len(merges)} merges, "
              f"{len(text.encode('utf-8'))} corpus bytes")
    else:
        sys.exit(f"usage: {sys.argv[0]} --write | --write-2048 | --write-xl")
