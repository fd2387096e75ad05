"""Whole-run BPE trainer over a dense device stream.

Counterpart of ``train_merges_fused_bytes`` (minbpe_tpu/ops/pallas/
fused_train.py:1359-1390): the same contract, (pairs[M, 2], counts[M],
fail_round), and the same single host sync at the end of the run.

Each round r runs the four kernels of ``kernels``: pair_stats over ids below
W = 256 + r, select_best into merge-log row r, merge_apply of that row's
pair as id 256 + r, and compact. The fail round and every log row stay in
device memory, where the kernels read them, so the host enqueues all M
rounds without waiting. A round after a failed one launches but does
nothing, which leaves its log row zero, as the Pallas kernel does.

Each merge is its own count rebuild. The Pallas kernel accepts up to 16
merges per rebuild (its exact multi-merge batching, ``K_CAP``); that changes
no output, only the number of rebuilds, and is queued in ROADMAP.md.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels

# the slice's limits: those of the fused Pallas trainer (fused_train.py:71-72)
TRAIN_MAX_N = 1 << 22
TRAIN_MAX_V = 1024


def train_merges(ids, seg, num_merges: int):
    """Learn num_merges merges from the stream (ids, seg), int32 tensors of
    equal length on the device the run uses. Returns numpy (pairs[M, 2],
    counts[M]) and the fail round (M when every round found a pair); rows
    from the fail round on are zero."""
    M = num_merges
    if M == 0:
        return np.zeros((0, 2), np.int32), np.zeros((0,), np.int32), 0
    dev = ids.device
    ids = ids.contiguous()
    seg = seg.contiguous()
    # filled on the device: a host tensor copied here would sync
    n = torch.full((1,), ids.numel(), dtype=torch.int32, device=dev)
    # log row r: (pa, pb, count, kept)
    log = torch.zeros((M, 4), dtype=torch.int32, device=dev)
    fail = torch.full((1,), M, dtype=torch.int32, device=dev)
    for r in range(M):
        cnt, first = kernels.pair_stats(ids, seg, n, 256 + r, fail, r)
        kernels.select_best(cnt, first, ids, fail, r, log[r])
        merged, live = kernels.merge_apply(ids, seg, n, log[r], 256 + r,
                                           fail, r, kept=log[r, 3:4])
        ids, seg, n = kernels.compact(merged, seg, live, n, fail, r)
    out = torch.cat([log.view(-1), fail]).cpu().numpy()  # the one sync
    log_h = out[:-1].reshape(M, 4)
    return (log_h[:, 0:2].copy(), log_h[:, 2].copy(), min(int(out[-1]), M))
