"""No seed changes how much work a cell does."""

import collections
import hashlib
import os

import numpy as np
import pytest

from bpebench import harness, inputs

ROOT = harness.ROOT
SEEDS = (1, 2**31 + 17, -5)


def _corpus(traffic):
    return inputs.corpus_bytes(os.path.join(ROOT, traffic["corpus"]),
                               traffic["corpus_sha256"])


def test_frozen_corpus_is_checked(tmp_path):
    t = harness.load_cell("basic512-train-12m").traffic
    data = _corpus(t)
    assert len(data) == 397_366
    bad = tmp_path / "corpus.txt"
    bad.write_bytes(data[:-1] + b"!")
    with pytest.raises(ValueError, match="sha256"):
        inputs.corpus_bytes(str(bad), t["corpus_sha256"])


def test_training_text_is_the_xl_recipe():
    # the same recipe as the repository's XL corpus, whose sha256 its
    # golden file keeps
    t = harness.load_cell("basic512-train-12m").traffic
    lines = inputs.drawn_lines(_corpus(t).decode("utf-8"),
                               int(t["min_bytes"]), int(t["block_lines"]),
                               int(t["draw_seed"]))
    text = "".join(lines).encode("utf-8")
    assert len(text) == 12_588_338
    golden = np.load(os.path.join(ROOT, "minbpe_tpu_torch", "data",
                                  "xl_golden.npz"))
    assert hashlib.sha256(text).hexdigest() == str(golden["corpus_sha256"])


def test_train_seeds_rotate_the_same_lines():
    t = harness.load_cell("basic512-train-12m").traffic
    lines = inputs.drawn_lines(_corpus(t).decode("utf-8"), 200_000, 256,
                               int(t["draw_seed"]))
    texts = [inputs.rotated(lines, s) for s in SEEDS]
    assert len(set(texts)) == len(SEEDS)
    assert len({len(x.encode()) for x in texts}) == 1
    counts = [collections.Counter(x.splitlines(keepends=True))
              for x in texts]
    assert all(c == counts[0] for c in counts)


def test_encode_seeds_keep_the_lengths():
    t = harness.load_cell("regex512-encode-docs").traffic
    data = _corpus(t)
    lengths = [inputs.document_lengths(
        int(t["documents"]), float(t["median_bytes"]), float(t["sigma"]),
        int(t["min_bytes"]), int(t["max_bytes"]), int(t["length_seed"]))
        for _ in SEEDS]
    np.testing.assert_array_equal(lengths[0], lengths[1])
    n = inputs.stratified(lengths[0], int(t["strata"]), int(t["length_seed"]))
    np.testing.assert_array_equal(
        n, inputs.stratified(lengths[1], int(t["strata"]),
                             int(t["length_seed"])))
    np.testing.assert_array_equal(np.sort(n), np.sort(lengths[0]))
    assert n.min() >= 128 and n.max() <= 32768 and len(n) == 4096
    starts = [inputs.document_starts(data, n, s) for s in SEEDS]
    assert (starts[0] != starts[1]).any() and (starts[0] != starts[2]).any()
    for st in starts:
        for s, k in zip(st.tolist(), n.tolist()):
            doc = data[s:s + k]
            assert len(doc) == k
            doc.decode("utf-8")  # whole characters at both ends


def test_every_block_of_the_order_holds_each_band_once():
    t = harness.load_cell("regex512-encode-docs").traffic
    raw = inputs.document_lengths(
        int(t["documents"]), float(t["median_bytes"]), float(t["sigma"]),
        int(t["min_bytes"]), int(t["max_bytes"]), int(t["length_seed"]))
    k = int(t["strata"])
    n = inputs.stratified(raw, k, int(t["length_seed"]))
    bands = np.sort(raw).reshape(k, -1)
    for block in n.reshape(-1, k):
        # the b-th shortest of each block lies in the b-th band
        for band, v in zip(bands, np.sort(block)):
            assert band[0] <= v <= band[-1]
    # so the mean of a window that stops after any whole number of blocks
    # stays near the sequence's mean, where the drawn order strays
    means = np.cumsum(n) / np.arange(1, len(n) + 1)
    drawn = np.cumsum(raw) / np.arange(1, len(raw) + 1)
    ends = np.arange(len(n) // 4, len(n), k) - 1
    spread = np.abs(means[ends] / raw.mean() - 1).max()
    assert spread < np.abs(drawn[ends] / raw.mean() - 1).max()
    assert spread < 0.03
    with pytest.raises(ValueError):
        inputs.stratified(raw[:-1], k, 0)
