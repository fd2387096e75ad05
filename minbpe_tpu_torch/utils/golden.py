"""The smoke corpus and its golden: the link to minbpe_tpu where JAX is not.

The corpus is frozen in-repo text: SURVEY.md, ARCHITECTURE.md, VERDICT.md,
STATUS.md and every minbpe_tpu/**/*.py in sorted path order, concatenated
(397,366 bytes, 456 of its characters non-ASCII). ``data/smoke_golden.npz``
holds what minbpe_tpu's RegexTokenizer (GPT-4 pattern) produced on it at
vocab 1024: the merges, their counts, the fail round, and the sha256 of the
encode ids of the whole corpus. tests/test_torch_golden.py writes it
(``--write``) and checks that both packages still produce it.
"""

from __future__ import annotations

import glob
import hashlib
import os

import numpy as np

GOLDEN = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "smoke_golden.npz")
VOCAB_SIZE = 1024


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
