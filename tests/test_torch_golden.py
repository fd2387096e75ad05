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

``--write-8192`` writes minbpe_tpu_torch/data/smoke8192_golden.npz: the
smoke corpus at vocab 8,192 through minbpe_tpu's ``select_mode="sparse"``
(~2 minutes on a CPU; its default there, the sort-round route, would take
most of an hour); the card's sort-round and sparse routes are held to it.

``--write-encode`` writes minbpe_tpu_torch/data/encode_golden.npz: the sha256
and count of the ids minbpe_tpu's encode produces per table and text
(golden.ENCODE_CASES), and prints each case's time. The card's runs
(chip_smoke.py) are held to it; here minbpe_tpu must still reproduce it
(the XL case, minutes on a CPU, is marked slow) and so must the port's
plain path, for the cases that take it seconds.
"""

import contextlib
import io
import os
import re
import sys
import time

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


def _train_verbose(tok, text, vocab_size=golden.VOCAB_SIZE, **opts):
    """Train through the public API; the per-merge counts come from the
    verbose lines, whose format both packages share."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tok.train(text, vocab_size, verbose=True, **opts)
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


def _reference_8192_result():
    from minbpe_tpu import RegexTokenizer

    merges, counts = _train_verbose(
        RegexTokenizer(), golden.smoke_corpus(ROOT), golden.VOCAB_SIZE_8192,
        select_mode=golden.GOLDEN_8192_ROUTE)
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


def _encode_ids(case, pkg, cache):
    """The ids of one encode golden case with the tokenizers of ``pkg``
    (minbpe_tpu, or minbpe_tpu_torch on the CPU). ``cache`` keeps what the
    cases share: the GPT-4 tokenizer and the corpora."""
    kw = {} if pkg.__name__ == "minbpe_tpu" else {"device": "cpu"}
    if "text" not in cache:
        cache["text"] = golden.smoke_corpus(ROOT)
    text = cache["text"]
    if case.startswith("gpt4"):
        if "gpt4" not in cache:
            from minbpe_tpu_torch.utils.synthranks import synthetic_ranks

            ranks, _, specials = synthetic_ranks(golden.GPT4_RANKS,
                                                 seed=golden.GPT4_SEED)
            cache["gpt4"] = pkg.GPT4Tokenizer.from_mergeable_ranks(
                ranks, specials, **kw)
        tok = cache["gpt4"]
        docs = golden.smoke_documents(text)
        if case == "gpt4_100k_batch":
            return [t for ids in tok.encode_batch(docs) for t in ids]
        if case == "gpt4_100k_specials":
            return tok.encode(golden.special_text(
                docs, list(tok.special_tokens)[:2]), allowed_special="all")
        return tok.encode(text)
    cls = pkg.RegexTokenizer
    if case == "xl_dense_1024":
        pairs = golden.load_golden()["merges"]
        new_ids = 256 + np.arange(len(pairs))
        text = golden.xl_corpus(ROOT)
    else:
        pairs, new_ids = golden.smoke_plus_merges(
            golden.DENSE_VOCAB if case == "smoke_plus_4096"
            else golden.SORTED_VOCAB)
        if case == "basic_plus_4353":
            cls, text = pkg.BasicTokenizer, text[:golden.HEAD_BYTES]
    tok = cls(**kw)
    tok.merges = {(int(a), int(b)): int(z)
                  for (a, b), z in zip(pairs, new_ids)}
    tok.vocab = tok._build_vocab()
    return tok.encode(text)


def _check_encode_golden(case, pkg, cache):
    sha, n = golden.load_encode_golden()[case]
    ids = _encode_ids(case, pkg, cache)
    assert len(ids) == n
    assert golden.ids_digest(ids) == sha


@pytest.fixture(scope="module")
def reference_cache():
    return {}


@pytest.mark.parametrize("case", [
    pytest.param(c, marks=pytest.mark.slow) if c == "xl_dense_1024" else c
    for c in golden.ENCODE_CASES])
def test_minbpe_tpu_reproduces_encode_golden(case, reference_cache):
    pytest.importorskip("jax")
    import minbpe_tpu

    _check_encode_golden(case, minbpe_tpu, reference_cache)


@pytest.mark.parametrize("case", ["gpt4_100k", "gpt4_100k_batch",
                                  "gpt4_100k_specials", "smoke_plus_4353",
                                  "basic_plus_4353"])
def test_port_plain_path_matches_encode_golden(case, reference_cache):
    """The port's sorted route on the CPU: K11's and K12's plain
    versions."""
    import minbpe_tpu_torch

    cache = reference_cache.setdefault("port", {})
    _check_encode_golden(case, minbpe_tpu_torch, cache)


def test_encode_golden_tables():
    """The 4,096 table is a prefix of the 4,353 one, and both begin with the
    2048 golden's merges; the dense table's ids stay within the dense
    route, the sorted one's pass it."""
    small, s_ids = golden.smoke_plus_merges(golden.DENSE_VOCAB)
    big, b_ids = golden.smoke_plus_merges(golden.SORTED_VOCAB)
    assert np.array_equal(big[:len(small)], small)
    assert np.array_equal(small[:1792], golden.load_golden_2048()["merges"])
    assert s_ids[-1] == golden.DENSE_VOCAB - 1
    assert b_ids[-1] == golden.SORTED_VOCAB - 1
    assert (big < b_ids[:, None]).all()
    assert len({tuple(p) for p in big.tolist()}) == len(big)
    assert set(golden.load_encode_golden()) == set(golden.ENCODE_CASES)


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


def test_8192_golden_extends_the_2048_golden():
    """The vocab-8192 golden: 7,936 merges by minbpe_tpu's sparse route,
    whose first 1,792 are the 2048 golden's; its ids pass 2^12."""
    small, big = golden.load_golden_2048(), golden.load_golden_8192()
    M = golden.VOCAB_SIZE_8192 - 256
    assert big["fail_round"] == M and big["route"] == "sparse"
    assert big["merges"].shape == (M, 2) and big["counts"].shape == (M,)
    assert np.array_equal(big["merges"][:1792], small["merges"])
    assert np.array_equal(big["counts"][:1792], small["counts"])
    assert big["merges"].max() > 4096 and (big["counts"] > 0).all()
    assert (np.diff(big["counts"].astype(np.int64)) <= 0).sum() > 0


@pytest.mark.slow
def test_minbpe_tpu_reproduces_8192_golden():
    """minbpe_tpu's sparse route on the smoke corpus at vocab 8192, ~2
    minutes on a CPU."""
    pytest.importorskip("jax")
    want = golden.load_golden_8192()
    merges, counts, fail_round = _reference_8192_result()
    assert np.array_equal(merges, want["merges"])
    assert np.array_equal(counts, want["counts"])
    assert fail_round == want["fail_round"]


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["auto", "sparse"])
def test_port_plain_path_matches_8192_golden(mode):
    """The port's default route at vocab 8192 (the sort-round trainer) and
    its sparse route, on the CPU: minutes each."""
    from minbpe_tpu_torch import RegexTokenizer

    want = golden.load_golden_8192()
    merges, counts = _train_verbose(
        RegexTokenizer(device="cpu"), golden.smoke_corpus(ROOT),
        golden.VOCAB_SIZE_8192, select_mode=mode)
    assert np.array_equal(merges, want["merges"])
    assert np.array_equal(counts, want["counts"])


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
    elif sys.argv[1:] == ["--write-8192"]:
        t0 = time.perf_counter()
        merges, counts, fail_round = _reference_8192_result()
        golden.save_golden_8192(merges, counts, fail_round,
                                golden.GOLDEN_8192_ROUTE)
        print(f"wrote {golden.GOLDEN_8192}: {len(merges)} merges "
              f"({time.perf_counter() - t0:.1f} s)")
    elif sys.argv[1:] == ["--write-encode"]:
        import minbpe_tpu

        cache, ids_by_case = {}, {}
        for case in golden.ENCODE_CASES:
            t0 = time.perf_counter()
            ids_by_case[case] = _encode_ids(case, minbpe_tpu, cache)
            print(f"{case}: {len(ids_by_case[case])} ids "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
        golden.save_encode_golden(ids_by_case)
        print(f"wrote {golden.ENCODE_GOLDEN}")
    elif sys.argv[1:] == ["--write-xl"]:
        merges, counts, fail_round, text = _reference_xl_result()
        golden.save_xl_golden(merges, counts, fail_round, text)
        print(f"wrote {golden.XL_GOLDEN}: {len(merges)} merges, "
              f"{len(text.encode('utf-8'))} corpus bytes")
    else:
        sys.exit(f"usage: {sys.argv[0]} --write | --write-2048 | --write-8192"
                 " | --write-xl | --write-encode")
