"""Resumable mid-training checkpoints.

The port's own copy of minbpe_tpu/utils/checkpoint.py, in the same format
(``FORMAT``, the same npz keys), so a checkpoint written by either package
resumes in the other. A checkpoint is the merge prefix learned so far
(pairs and counts of rounds 0 .. round_idx - 1), the run's target merge
count and a fingerprint of the corpus: the sha256 of the padded host
arrays that ``ops/stream.pack_offsets`` builds (power-of-two capacity) and
the live length. Resuming replays the prefix onto the stream and goes on
from round_idx; the reference has no such state (its only persistence is
the final ``.model``, minbpe/base.py:97-165).
"""

from __future__ import annotations

import hashlib

import numpy as np

FORMAT = "minbpe_tpu-ckpt-v1"


def corpus_fingerprint(ids: np.ndarray, seg: np.ndarray, n) -> str:
    h = hashlib.sha256()
    h.update(np.asarray(ids).tobytes())
    h.update(np.asarray(seg).tobytes())
    h.update(str(int(n)).encode())
    return h.hexdigest()[:32]


def save(path: str, pairs: np.ndarray, counts: np.ndarray, round_idx: int,
         num_merges: int, fingerprint: str):
    np.savez(
        path,
        format=FORMAT,
        pairs=np.asarray(pairs[:round_idx]),
        counts=np.asarray(counts[:round_idx]),
        round_idx=round_idx,
        num_merges=num_merges,
        fingerprint=fingerprint,
    )


def load(path: str):
    z = np.load(path, allow_pickle=False)
    if str(z["format"]) != FORMAT:
        raise ValueError(f"bad checkpoint format: {z['format']}")
    return {
        "pairs": z["pairs"],
        "counts": z["counts"],
        "round_idx": int(z["round_idx"]),
        "num_merges": int(z["num_merges"]),
        "fingerprint": str(z["fingerprint"]),
    }


def load_checked(path: str, fingerprint: str, num_merges: int):
    """``load(path)`` for a run that resumes it: raises ValueError where
    the checkpoint is of another corpus or another merge count."""
    c = load(path)
    if c["fingerprint"] != fingerprint:
        raise ValueError("checkpoint does not match this corpus "
                         f"(fingerprint {c['fingerprint']} != {fingerprint})")
    if c["num_merges"] != num_merges:
        raise ValueError("checkpoint trained a different vocab size: toward "
                         f"{c['num_merges']} merges, requested {num_merges}")
    return c
