"""The plain reference against minbpe's own loops and published example,
and the GPT-4 split against the ``regex`` module."""

import json
import os
import random

import pytest

from bpebench import harness
from bpebench.reference import bpe, split

ROOT = harness.ROOT


def _stats(ids, counts):
    for pair in zip(ids, ids[1:]):
        counts[pair] = counts.get(pair, 0) + 1


def _merge(ids, pair, idx):
    out, i = [], 0
    while i < len(ids):
        if i < len(ids) - 1 and (ids[i], ids[i + 1]) == pair:
            out.append(idx)
            i += 2
        else:
            out.append(ids[i])
            i += 1
    return out


def minbpe_train(chunks, num_merges):
    """minbpe/regex.py:36-70, over lists of byte lists."""
    ids = [list(c) for c in chunks]
    merges = []
    for r in range(num_merges):
        counts = {}
        for c in ids:
            _stats(c, counts)
        if not counts:
            break
        pair = max(counts, key=counts.get)
        merges.append(pair)
        ids = [_merge(c, pair, 256 + r) for c in ids]
    return merges


def minbpe_encode(chunk, merges):
    """minbpe/basic.py:57-74."""
    rank = {p: 256 + r for r, p in enumerate(merges)}
    ids = list(chunk)
    while len(ids) >= 2:
        counts = {}
        _stats(ids, counts)
        pair = min(counts, key=lambda p: rank.get(p, float("inf")))
        if pair not in rank:
            break
        ids = _merge(ids, pair, rank[pair])
    return ids


def test_wikipedia_example():
    ids, seg = bpe.stream([b"aaabdaaabac"], "cpu")
    merges = bpe.train(ids, seg, 3)
    assert merges == [(97, 97), (256, 97), (257, 98)]
    out, _ = bpe.encode(ids, seg, merges)
    assert out.tolist() == [258, 100, 258, 97, 99]


@pytest.mark.parametrize("seed", range(6))
def test_train_and_encode_match_minbpe(seed):
    rnd = random.Random(seed)
    alphabet = b"aab  \n" if seed % 2 else b"ab c"
    chunks = [bytes(rnd.choice(alphabet) for _ in range(rnd.randint(1, 40)))
              for _ in range(rnd.randint(1, 30))]
    ids, seg = bpe.stream(chunks, "cpu")
    want = minbpe_train(chunks, 20)
    assert bpe.train(ids, seg, 20) == want
    out, oseg = bpe.encode(ids, seg, want)
    got = [out[oseg == k].tolist() for k in range(len(chunks))]
    assert got == [minbpe_encode(c, want) for c in chunks]


def test_control_takes_runs_from_the_right():
    ids, seg = bpe.stream([b"aaaaa", b"aaa"], "cpu")
    left, _ = bpe.merge(ids, seg, 97, 97, 256)
    right, _ = bpe.merge(ids, seg, 97, 97, 256, order="right")
    assert left.tolist() == [256, 256, 97, 256, 97]
    assert right.tolist() == [97, 256, 256, 97, 256]


def test_split_matches_the_regex_module():
    regex = pytest.importorskip("regex")
    pat = regex.compile(split.GPT4_SPLIT_PATTERN)
    with open(os.path.join(ROOT, "bpebench", "data", "smoke_corpus.txt"),
              encoding="utf-8") as f:
        text = f.read()
    assert split.split(text) == pat.findall(text)
    ascii_text = text.encode("ascii", "ignore").decode()
    assert split.split(ascii_text) == pat.findall(ascii_text)
    rnd = random.Random(0)
    alphabet = ([chr(c) for c in range(0x250)]
                + [chr(c) for c in (0x85, 0xA0, 0x1680, 0x2000, 0x2028,
                                    0x3000, 0x17F, 0x212A, 0x130, 0x660,
                                    0x2160, 0xBD, 0x1F609, 0xAC00)]
                + list("  \n\r\t'sdmtSDMTllvere") * 5)
    for _ in range(2000):
        s = "".join(rnd.choice(alphabet) for _ in range(rnd.randint(0, 40)))
        assert split.split(s) == pat.findall(s), repr(s)


def test_tables_are_the_references(tmp_path):
    """make_tables.py makes the stored tables again, byte for byte; the
    GPT-4 table is also the first 256 merges of the repository's smoke
    golden (minbpe_tpu's, vocab 1024, on the same corpus)."""
    import numpy as np

    tool = harness.load_module(os.path.join(
        ROOT, "bpebench", "tools", "make_tables.py"), "make_tables")
    made = tool.tables()
    assert sorted(made) == [f"bpebench/data/minbpe-{k}-v512.model"
                            for k in ("basic", "regex")]
    for path, (pattern, merges) in made.items():
        out = tmp_path / "t.model"
        bpe.write_model(str(out), pattern, merges)
        with open(os.path.join(ROOT, path), "rb") as f:
            assert out.read_bytes() == f.read()
    golden = np.load(os.path.join(ROOT, "minbpe_tpu_torch", "data",
                                  "smoke_golden.npz"))["merges"][:256]
    regex_table = made["bpebench/data/minbpe-regex-v512.model"][1]
    assert regex_table == [tuple(p) for p in golden.tolist()]


def test_configs_name_their_tables():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for entry in bench["configs"]:
        with open(os.path.join(ROOT, entry["file"])) as f:
            config = json.load(f)
        assert config["source"] == entry["source"]
        assert config["reduced"] == entry["reduced"]
        merges = bpe.read_model(os.path.join(ROOT, config["merges"]))
        assert len(merges) == config["vocab_size"] - 256
