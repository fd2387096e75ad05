"""The smoke corpus and its golden: the link to minbpe_tpu where JAX is not.

The corpus is frozen in-repo text: SURVEY.md, ARCHITECTURE.md, VERDICT.md,
STATUS.md and every minbpe_tpu/**/*.py in sorted path order, concatenated
(397,366 bytes, 456 of its characters non-ASCII). ``data/smoke_golden.npz``
holds what minbpe_tpu's RegexTokenizer (GPT-4 pattern) produced on it at
vocab 1024: the merges, their counts, the fail round, and the sha256 of the
encode ids of the whole corpus. tests/test_torch_golden.py writes it
(``--write``) and checks that both packages still produce it.

The XL corpus is the smoke corpus's lines drawn with replacement, blocks of
4096 at a time from ``numpy.random.default_rng(0)``, until it holds at least
12 MiB (12,588,338 bytes: three times the in-VMEM trainer's 4M-token
ceiling). ``data/xl_golden.npz`` holds what minbpe_tpu's RegexTokenizer
(``select_mode="stepped"``) produced on it at vocab 1024: the merges, their
counts, the fail round and the corpus's sha256 (``--write-xl``).
``data/smoke2048_golden.npz`` holds minbpe_tpu's RegexTokenizer on the
smoke corpus at vocab 2048 (its default route there, the stepped trainer):
the merges, their counts and the fail round (``--write-2048``).
``data/smoke8192_golden.npz`` holds the same at vocab 8,192 (7,936
merges), written through minbpe_tpu's ``select_mode="sparse"`` route (its
slot-table trainer: minutes on a CPU, where its sort-round route, which
"auto" takes there, would take most of an hour), with the route's name
(``--write-8192``).

``data/encode_golden.npz`` holds the sha256 and the count of the ids that
minbpe_tpu's encode produced, per table and text (``--write-encode``; the
keys are ``ENCODE_CASES``): the smoke corpus with the GPT-4 tokenizer on
``synthetic_ranks(100_256, seed=7)`` (encode, the 256 documents of
``smoke_documents`` as one batch, and the documents joined by special
tokens), with RegexTokenizer on the ``smoke_plus_merges`` tables of vocab
4,096 (the dense route) and 4,353 (the sorted route), the corpus's first
65,536 bytes with BasicTokenizer on the 4,353 table (one chunk), and the
XL corpus with the 1024 golden's 768 merges (the dense route above
4·2^20 bytes).
"""

from __future__ import annotations

import glob
import hashlib
import os

import numpy as np

DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data")
GOLDEN = os.path.join(DATA, "smoke_golden.npz")
XL_GOLDEN = os.path.join(DATA, "xl_golden.npz")
GOLDEN_2048 = os.path.join(DATA, "smoke2048_golden.npz")
VOCAB_SIZE = 1024
VOCAB_SIZE_2048 = 2048
GOLDEN_8192 = os.path.join(DATA, "smoke8192_golden.npz")
VOCAB_SIZE_8192 = 8192
GOLDEN_8192_ROUTE = "sparse"
ENCODE_GOLDEN = os.path.join(DATA, "encode_golden.npz")
ENCODE_CASES = ("gpt4_100k", "gpt4_100k_batch", "gpt4_100k_specials",
                "smoke_plus_4096", "smoke_plus_4353", "basic_plus_4353",
                "xl_dense_1024")
GPT4_RANKS = 100_256
GPT4_SEED = 7
DENSE_VOCAB = 4096
SORTED_VOCAB = 4353
HEAD_BYTES = 65536
XL_MIN_BYTES = 12 << 20
XL_BLOCK = 4096


def corpus_files(root: str) -> list[str]:
    mds = [os.path.join(root, f)
           for f in ("SURVEY.md", "ARCHITECTURE.md", "VERDICT.md",
                     "STATUS.md")]
    pys = sorted(glob.glob(os.path.join(root, "minbpe_tpu", "**", "*.py"),
                           recursive=True))
    return mds + pys


def smoke_corpus(root: str) -> str:
    """The corpus text, read from the repository at ``root``."""
    parts = []
    for path in corpus_files(root):
        with open(path, encoding="utf-8") as f:
            parts.append(f.read())
    return "".join(parts)


def xl_corpus(root: str) -> str:
    """The XL corpus text, made from the smoke corpus at ``root``."""
    lines = smoke_corpus(root).splitlines(keepends=True)
    sizes = [len(line.encode("utf-8")) for line in lines]
    rng = np.random.default_rng(0)
    picked: list[int] = []
    size = 0
    while size < XL_MIN_BYTES:
        block = rng.integers(0, len(lines), XL_BLOCK)
        picked.extend(block.tolist())
        size += sum(sizes[k] for k in block)
    return "".join(lines[k] for k in picked)


def smoke_plus_merges(vocab_size: int):
    """(pairs int32 (M, 2), new_ids int32 (M,)) of a table of vocab_size
    ids that compresses real text: the smoke corpus's 1,792 merges at vocab
    2048 (``smoke2048_golden.npz``), then seeded filler merges up to
    vocab_size, new id z merging a pair of ids below z drawn from
    ``numpy.random.default_rng(0)`` (drawn again where the pair is taken).
    Every table is a prefix of the larger ones."""
    real = load_golden_2048()["merges"].astype(np.int64)
    z0 = VOCAB_SIZE_2048
    taken = {(int(a), int(b)) for a, b in real}
    rng = np.random.default_rng(0)
    filler = []
    for z in range(z0, vocab_size):
        while True:
            a, b = (int(v) for v in rng.integers(0, z, 2))
            if (a, b) not in taken:
                break
        taken.add((a, b))
        filler.append((a, b))
    pairs = np.concatenate([real[:vocab_size - 256],
                            np.asarray(filler, np.int64).reshape(-1, 2)])
    return (pairs.astype(np.int32),
            (256 + np.arange(len(pairs))).astype(np.int32))


def smoke_documents(text: str) -> list[str]:
    """The text cut into 256 documents of equal length (the last shorter)."""
    step = -(-len(text) // 256)
    return [text[i:i + step] for i in range(0, len(text), step)]


def special_text(docs: list[str], names: list[str]) -> str:
    """The first 8 documents, each followed by a special token's name, the
    names taken in turn."""
    return "".join(docs[k] + names[k % len(names)] for k in range(8))


def text_digest(text: str) -> str:
    """sha256 of the text's UTF-8 bytes."""
    return hashlib.sha256(text.encode("utf-8")).hexdigest()


def ids_digest(ids) -> str:
    """sha256 of the ids as little-endian int32."""
    return hashlib.sha256(
        np.asarray(ids, dtype="<i4").tobytes()).hexdigest()


def load_golden() -> dict:
    z = np.load(GOLDEN)
    return {"merges": z["merges"], "counts": z["counts"],
            "fail_round": int(z["fail_round"]),
            "encode_sha256": str(z["encode_sha256"]),
            "n_ids": int(z["n_ids"])}


def save_golden(merges, counts, fail_round: int, ids):
    np.savez(GOLDEN, merges=np.asarray(merges, np.int32),
             counts=np.asarray(counts, np.int32),
             fail_round=np.int32(fail_round),
             encode_sha256=np.str_(ids_digest(ids)),
             n_ids=np.int64(len(ids)))


def load_xl_golden() -> dict:
    z = np.load(XL_GOLDEN)
    return {"merges": z["merges"], "counts": z["counts"],
            "fail_round": int(z["fail_round"]),
            "corpus_sha256": str(z["corpus_sha256"]),
            "corpus_bytes": int(z["corpus_bytes"])}


def save_xl_golden(merges, counts, fail_round: int, text: str):
    np.savez(XL_GOLDEN, merges=np.asarray(merges, np.int32),
             counts=np.asarray(counts, np.int32),
             fail_round=np.int32(fail_round),
             corpus_sha256=np.str_(text_digest(text)),
             corpus_bytes=np.int64(len(text.encode("utf-8"))))


def load_encode_golden() -> dict:
    """{case: (sha256 of the ids, their count)}."""
    z = np.load(ENCODE_GOLDEN)
    return {k: (str(z[k + "_sha256"]), int(z[k + "_n"]))
            for k in ENCODE_CASES}


def save_encode_golden(ids_by_case: dict):
    np.savez(ENCODE_GOLDEN, **{
        f"{k}_{f}": v for k, ids in ids_by_case.items()
        for f, v in (("sha256", np.str_(ids_digest(ids))),
                     ("n", np.int64(len(ids))))})


def load_golden_2048() -> dict:
    z = np.load(GOLDEN_2048)
    return {"merges": z["merges"], "counts": z["counts"],
            "fail_round": int(z["fail_round"])}


def save_golden_2048(merges, counts, fail_round: int):
    np.savez(GOLDEN_2048, merges=np.asarray(merges, np.int32),
             counts=np.asarray(counts, np.int32),
             fail_round=np.int32(fail_round))


def load_golden_8192() -> dict:
    z = np.load(GOLDEN_8192)
    return {"merges": z["merges"], "counts": z["counts"],
            "fail_round": int(z["fail_round"]), "route": str(z["route"])}


def save_golden_8192(merges, counts, fail_round: int, route: str):
    np.savez(GOLDEN_8192, merges=np.asarray(merges, np.int32),
             counts=np.asarray(counts, np.int32),
             fail_round=np.int32(fail_round), route=np.str_(route))
