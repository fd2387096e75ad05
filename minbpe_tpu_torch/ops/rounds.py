"""The driver of the round-by-round trainers (ops/train_inc.py,
train_sortloop.py, train_sparse.py, train_select.py): their run log, the
loop that enqueues their rounds, and resume from a checkpoint.

A round after the fail round merges nothing, so the host reads the fail
round once per group of steps and stops enqueueing after the read that
sees it; a stepped run still calls ``progress`` and writes checkpoints at
the rounds minbpe_tpu's drivers do, which never stop early.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import checkpoint as ckpt
from .merge import apply_merge


class RunLog:
    """A run's log of M merges on the stream's device: pairs[M, 2],
    cnts[M] and the fail round (M until a round finds no pair)."""

    def __init__(self, M: int, device):
        self.M = M
        self.pairs = torch.zeros((M, 2), dtype=torch.int32, device=device)
        self.cnts = torch.zeros((M,), dtype=torch.int32, device=device)
        self.fail = torch.full((1,), M, dtype=torch.int32, device=device)

    def result(self):
        """numpy (pairs[M, 2], counts[M]) and the fail round, in one copy;
        rows from the fail round on are zero."""
        M = self.M
        out = torch.cat([self.pairs.view(-1), self.cnts,
                         self.fail]).cpu().numpy()
        return (out[:2 * M].reshape(M, 2).copy(), out[2 * M:3 * M].copy(),
                min(int(out[-1]), M))


def stream(ids, seg):
    """(ids, seg, n): the stream contiguous, n = its length as int32[1],
    filled on the device (a host tensor copied there would sync)."""
    n = torch.full((1,), ids.numel(), dtype=torch.int32, device=ids.device)
    return ids.contiguous(), seg.contiguous(), n


def resume(ids, seg, num_merges: int, resume_from: str | None = None,
           checkpoint_path: str | None = None,
           fingerprint: str | None = None):
    """The stream to train on, (ids, seg, n) as ``stream`` makes it, and
    the merge prefix to go on from: None, or a checkpoint's (pairs, counts)
    as int32 tensors on the stream's device, replayed onto the stream (K3
    and K4 on the card). A run that checkpoints or resumes must give the
    corpus's ``fingerprint``."""
    if (checkpoint_path is not None or resume_from is not None) \
            and fingerprint is None:
        raise ValueError("checkpoint_path and resume_from need the corpus "
                         "fingerprint")
    ids, seg, n = stream(ids, seg)
    if resume_from is None:
        return ids, seg, n, None
    c = ckpt.load_checked(resume_from, fingerprint, num_merges)
    prefix = [torch.from_numpy(np.ascontiguousarray(c[k], np.int32)).to(
        ids.device) for k in ("pairs", "counts")]
    for i in range(c["round_idx"]):
        ids, seg, n, _ = apply_merge(ids, seg, n, prefix[0][i], 256 + i)
    return ids, seg, n, prefix


def run_rounds(st: RunLog, round_fn, *, unroll: int, steps_per_sync: int,
               prefix=None, progress=None,
               checkpoint_path: str | None = None,
               checkpoint_every: int | None = None,
               fingerprint: str | None = None):
    """Enqueue ``round_fn(st, i)`` for the rounds of st's run, in steps of
    ``unroll`` rounds, from the end of ``prefix`` (``resume``'s, written
    into st's log first). After each step: ``progress(done_rounds, M)``,
    and every ``checkpoint_every`` rounds before the last a checkpoint of
    st's log to ``checkpoint_path``, carrying ``fingerprint``, the
    corpus's (utils/checkpoint.py). The fail round is read once per
    ``steps_per_sync`` steps. Returns ``st.result()``."""
    M = st.M
    start = 0
    if prefix is not None:
        start = prefix[0].shape[0]
        st.pairs[:start] = prefix[0]
        st.cnts[:start] = prefix[1]
    save = checkpoint_path is not None and checkpoint_every
    stopped = False
    for step, i0 in enumerate(range(start, M, unroll)):
        done = min(i0 + unroll, M)
        if not stopped:
            for i in range(i0, done):
                round_fn(st, i)
        if progress is not None:
            progress(done, M)
        if save and done % checkpoint_every == 0 and done < M:
            ckpt.save(checkpoint_path, st.pairs.cpu().numpy(),
                      st.cnts.cpu().numpy(), done, M, fingerprint)
        if not stopped and (step + 1) % steps_per_sync == 0:
            stopped = int(st.fail) < M  # the group's one sync
            if stopped and progress is None and not save:
                break
    return st.result()
