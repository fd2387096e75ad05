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


def load_golden_2048() -> dict:
    z = np.load(GOLDEN_2048)
    return {"merges": z["merges"], "counts": z["counts"],
            "fail_round": int(z["fail_round"])}


def save_golden_2048(merges, counts, fail_round: int):
    np.savez(GOLDEN_2048, merges=np.asarray(merges, np.int32),
             counts=np.asarray(counts, np.int32),
             fail_round=np.int32(fail_round))
