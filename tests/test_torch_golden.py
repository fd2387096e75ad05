"""The smoke golden: minbpe_tpu's result on the frozen smoke corpus.

The machine with the card has no JAX, so minbpe_tpu_torch/data/
smoke_golden.npz is chip_smoke.py's only link to the reference there. These
tests hold the port's plain CPU path and minbpe_tpu itself to it. Rewrite
it (only when the corpus or the reference changes) with

    PYTHONPATH= JAX_PLATFORMS=cpu python tests/test_torch_golden.py --write
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


def _train_verbose(tok, text):
    """Train through the public API; the per-merge counts come from the
    verbose lines, whose format both packages share."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tok.train(text, golden.VOCAB_SIZE, verbose=True)
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


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit(f"usage: {sys.argv[0]} --write")
    merges, counts, fail_round, ids = _reference_result()
    golden.save_golden(merges, counts, fail_round, ids)
    print(f"wrote {golden.GOLDEN}: {len(merges)} merges, {len(ids)} ids")
