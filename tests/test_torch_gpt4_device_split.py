"""GPT4Tokenizer on the device split with a sorted table, on the CPU twins
of K15 and K17, against the host split with the flat encoder and against
the benchmark's plain reference (bpebench/reference/ranks.py).

The table is a small stand-in made by bpebench/tools/make_ranks.py's
generator: 4,000 merges trained on the GPT-4 chunks of the smoke corpus's
first 64 KB, then seeded filler to 5,000 ranks, so its ids pass the dense
route's 4,096. The card runs the same comparison at 100,256
ranks on the cl100k-encode-docs cell's documents (tests/test_torch_cuda.py).
"""

import base64
import hashlib
import json
import os
import random
import re

import pytest
import torch

from bpebench import harness
from bpebench.kinds import encode_ranks
from bpebench.reference import bpe, ranks as rk, split
from bpebench.tools import make_ranks
from minbpe_tpu_torch import GPT4Tokenizer, engine, gpt4, trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "bpebench", "data")
CORPUS = os.path.join(DATA, "smoke_corpus.txt")
CONFIG = os.path.join(ROOT, "bpebench", "configs-ranks", "gpt4-cl100k.json")
SPECIALS = gpt4.GPT4_SPECIAL_TOKENS


def _corpus() -> str:
    with open(CORPUS, encoding="utf-8") as f:
        return f.read()


@pytest.fixture(scope="module")
def standin(tmp_path_factory):
    """(ranks dict, its file in tiktoken's format, trained merges)."""
    text = _corpus().encode("utf-8")[:65536].decode("utf-8", "ignore")
    ranks, trained = make_ranks.standin_ranks(text, 5000, seed=21,
                                              max_trained=4000)
    path = tmp_path_factory.mktemp("ranks") / "standin.tiktoken"
    path.write_text(make_ranks.tiktoken_text(ranks))
    return ranks, str(path), trained


@pytest.fixture(scope="module")
def toks(standin):
    """(device split, host split) GPT4Tokenizers of the stand-in."""
    ranks = standin[0]
    split_tok, host_tok = (GPT4Tokenizer.from_mergeable_ranks(
        ranks, SPECIALS, device="cpu") for _ in range(2))
    split_tok.device_presplit = True
    return split_tok, host_tok


@pytest.fixture(scope="module")
def reference(standin):
    return encode_ranks.Reference(standin[1], "cpu")


def _reference_encode(reference, text: str, special: dict) -> list[int]:
    """The reference's ids with ``special`` tokens cut out first, as
    minbpe/regex.py:145-164 does."""
    if not special:
        return reference.ids([text])[0][0]
    pattern = "(" + "|".join(re.escape(k) for k in special) + ")"
    out: list[int] = []
    for part in re.split(pattern, text):
        if part in special:
            out.append(special[part])
        elif part:
            out.extend(reference.ids([part])[0][0])
    return out


def _documents():
    text = _corpus()
    rnd = random.Random(5)
    docs = {"empty": "", "one_byte": "x", "one_space": " ",
            "non_ascii": "Grüße, naïve café — 東京 🙂 Ωmega\r\n\tdone 123456 "
                         "l'été's ... ",
            "code": text[80_000:84_000]}
    for k in range(6):
        n = rnd.choice([1, 7, 130, 2048, 9000])
        s = rnd.randrange(len(text) - n)
        docs[f"corpus_{k}"] = text[s:s + n]
    return docs


DOCS = _documents()


def test_standin_is_sorted_and_trained(standin, toks):
    ranks, _, trained = standin
    assert len(ranks) == 5000 and sorted(ranks.values()) == list(range(5000))
    assert 3000 < trained <= 4000  # then filler
    assert engine.device_table(toks[0]).kind == "sorted"


@pytest.mark.parametrize("name", sorted(DOCS))
def test_device_split_equals_host_split_and_reference(toks, reference, name):
    split_tok, host_tok = toks
    text = DOCS[name]
    got = split_tok.encode_ordinary(text)
    assert got == host_tok.encode_ordinary(text)
    assert got == _reference_encode(reference, text, {})
    assert split_tok.decode(got) == text


def test_specials_all_keep_the_host_route(toks, reference):
    """Under allowed_special="all" the text between specials is split on
    the host, one count a part, on both tokenizers alike."""
    split_tok, host_tok = toks
    text = ("head <|endoftext|>body " + DOCS["code"][:500]
            + "<|fim_prefix|><|endofprompt|> tail " + DOCS["non_ascii"])
    trace.reset()
    got = split_tok.encode(text, allowed_special="all")
    assert trace.COUNTERS == {"encode.route.host_split": 3}
    assert got == host_tok.encode(text, allowed_special="all")
    assert got == _reference_encode(reference, text, SPECIALS)
    assert SPECIALS["<|endofprompt|>"] in got
    # "none": the specials' text is text, on the device split
    assert split_tok.encode(text, allowed_special="none") == \
        _reference_encode(reference, text, {})


def test_route_counters_count_one_text_each(toks):
    split_tok, host_tok = toks
    trace.reset()
    split_tok.encode_ordinary(DOCS["code"])
    split_tok.encode(DOCS["non_ascii"], allowed_special="none")
    split_tok.encode_ordinary("")
    assert trace.COUNTERS.get("encode.route.device_split") == 3
    assert "encode.route.host_split" not in trace.COUNTERS
    trace.reset()
    host_tok.encode_ordinary(DOCS["code"])
    host_tok.encode_batch([DOCS["code"], DOCS["one_byte"]])
    assert trace.COUNTERS.get("encode.route.host_split") == 3
    assert "encode.route.device_split" not in trace.COUNTERS


def test_cuckoo_bytes_count_the_rows_until_built(standin):
    from minbpe_tpu_torch.ops.ranktab import table_size

    tok = GPT4Tokenizer.from_mergeable_ranks(standin[0], device="cpu")
    dev = engine.device_table(tok)
    assert dev.cuckoo_bytes() == 2 * table_size(5000 - 256) * 16
    assert dev.cuckoo.rows.numel() * 4 >= 2 * table_size(5000 - 256) * 16
    assert dev.cuckoo_bytes() == 0


@pytest.mark.parametrize("kind", ["basic", "regex"])
def test_lowest_rank_loop_equals_rank_sweep(kind):
    """The reference's lowest-rank loop equals bpe.encode's sweep in rank
    order on both vocab-512 tables."""
    merges = bpe.read_model(os.path.join(DATA, f"minbpe-{kind}-v512.model"))
    text = _corpus()[:30_000]
    chunks = ([c.encode("utf-8") for c in split.split(text)]
              if kind == "regex" else
              [text[k:k + 3000].encode("utf-8") for k in range(0, 30_000,
                                                               3000)])
    ids, seg = bpe.stream(chunks, "cpu")
    table = rk.MergeTable.of_merges(merges, "cpu")
    for order in ("left", "right"):
        got = rk.encode(ids, seg, table, order)
        want = bpe.encode(ids, seg, merges, order)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_b64decode_is_base64():
    rnd = random.Random(3)
    for n in range(0, 40):
        b = bytes(rnd.randrange(256) for _ in range(n))
        assert rk.b64decode(base64.b64encode(b).decode()) == b


def test_weighted_training_is_the_reference_training():
    """make_ranks' training over distinct chunks weighted by their counts
    is bpe.train over the whole stream, ties and all."""
    chunks = [c.encode("utf-8") for c in split.split(_corpus()[:20_000])]
    ids, seg = bpe.stream(chunks, "cpu")
    assert make_ranks.train_exhaustive(chunks, 300) == bpe.train(ids, seg,
                                                                 300)


def test_committed_standin_recovers_as_the_port_does():
    """The committed stand-in: 100,256 ranks, its sha256 the
    configuration's, the specials at cl100k's ids; the reference's
    recovered forest equals the port's recover_merge_forest and the minbpe
    model written beside it."""
    with open(CONFIG) as f:
        config = json.load(f)
    path = os.path.join(ROOT, config["ranks"])
    with open(path, "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == config["ranks_sha256"]
    ranks = rk.read_tiktoken(path)
    assert ranks == gpt4.load_cl100k_ranks(path)
    assert sorted(ranks.values()) == list(range(config["vocab_size"]))
    assert config["vocab_size"] == 100_256
    assert config["special_tokens"] == SPECIALS
    forest = rk.recover_forest(ranks)
    assert forest == gpt4.recover_merge_forest(ranks)
    model = bpe.read_model(os.path.join(ROOT, config["merges"]))
    assert model == sorted(forest, key=forest.get)
    assert rk.byte_shuffle(ranks) != list(range(256))


def test_kind_setup_raises_when_the_split_falls_back(monkeypatch):
    """The cell's set-up fails, at its first (empty) request, on a program
    whose device split declines the table."""
    cell = harness.load_cell("cl100k-encode-docs")
    cell.traffic.update(documents=4, strata=4, max_bytes=512)
    monkeypatch.setattr(engine, "encode_text_device_split",
                        lambda tok, text: None)
    ctx = harness.Context(cell, 3, "cpu", False)
    job = cell.kind.Job(ctx)
    with pytest.raises(RuntimeError, match="split on the device"):
        job.setup()
