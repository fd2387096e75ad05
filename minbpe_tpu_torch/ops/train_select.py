"""Round-by-round training through an explicit selection path: count,
select the reference's pair, apply it, compact, once per merge.

The port's counterpart of minbpe_tpu/ops/train.py::train_merges (:32-88),
behind ``select_mode`` "sort", "dense" and "pallas" (ops/select.py). JAX
runs the loop as one program with ``lax.cond``; here the host enqueues the
rounds, and the fail round, the pairs and the counts stay on the device:
each round's branch is a ``torch.where``, and a round that finds no pair
applies the pair (-1, -1), which merges nothing. The host reads the fail
round once per ROUNDS_PER_SYNC rounds, so a run stops soon after it, and
fetches the log once at the end.
"""

from __future__ import annotations

import numpy as np
import torch

from .merge import apply_merge
from .select import (_ONE_HOT_ENTRIES, select_max_pair,
                     select_max_pair_dense, select_max_pair_pallas)
from .train import check_device_memory

# the vocab bound of minbpe_tpu's dense selection (ops/train.py:29); the
# engine's "auto" takes the stepped route up to it
DENSE_SELECT_MAX = 2048
ROUNDS_PER_SYNC = 16

_SELECT = {
    "sort": lambda ids, seg, n, V: select_max_pair(ids, seg, n),
    "dense": select_max_pair_dense,
    "pallas": select_max_pair_pallas,
}

# device bytes at a round's peak, per stream token and per V x V entry: the
# stream and its compacted copy, the validity pass, and the path's own
# buffers (the sort's 64-bit keys, positions and run scans; the dense
# count's matrices and, for "dense", one block of one-hot operands)
_BYTES_PER_TOKEN = {"sort": 160, "dense": 64, "pallas": 64}
_BYTES_PER_ENTRY = {"sort": 0, "dense": 13, "pallas": 9}


def device_bytes(select_mode: str, n_tokens: int, V: int) -> int:
    need = (_BYTES_PER_TOKEN[select_mode] * n_tokens
            + _BYTES_PER_ENTRY[select_mode] * V * V)
    if select_mode == "dense":
        need += 6 * _ONE_HOT_ENTRIES
    return need


def train_merges_select(ids, seg, num_merges: int, select_mode: str = "sort"):
    """Learn num_merges merges from the stream (ids, seg), int32 tensors of
    equal length on the device the run uses, selecting each round's pair
    by ``select_mode``. Returns numpy (pairs[M, 2], counts[M]) and the fail
    round (M when every round found a pair); rows from the fail round on
    are zero."""
    if select_mode not in _SELECT:
        raise ValueError(f"unknown select_mode {select_mode!r}")
    select = _SELECT[select_mode]
    M = num_merges
    V = 256 + M
    N = ids.numel()
    if M == 0 or N < 2:  # nothing to learn, or no pair at all
        return np.zeros((M, 2), np.int32), np.zeros((M,), np.int32), 0
    dev = ids.device
    if dev.type == "cuda":
        check_device_memory(dev, device_bytes(select_mode, N, V),
                            f"select_mode={select_mode!r} on {N} tokens at "
                            f"vocab {V}")
    ids = ids.contiguous()
    seg = seg.contiguous()
    # filled on the device: a host tensor copied there would sync
    n = torch.full((1,), N, dtype=torch.int32, device=dev)
    fail = torch.full((1,), M, dtype=torch.int32, device=dev)
    pairs = torch.zeros((M, 2), dtype=torch.int32, device=dev)
    counts = torch.zeros((M,), dtype=torch.int32, device=dev)
    for g in range(0, M, ROUNDS_PER_SYNC):
        for i in range(g, min(g + ROUNDS_PER_SYNC, M)):
            pa, pb, cnt, ok = select(ids, seg, n, V)
            ok &= fail >= i
            pair = torch.where(ok, torch.cat([pa, pb]), -1)
            ids, seg, n, _ = apply_merge(ids, seg, n, pair, 256 + i)
            pairs[i] = torch.where(ok, pair, 0)
            counts[i:i + 1] = torch.where(ok, cnt, 0)
            fail = torch.where(ok, fail, fail.clamp(max=i))
        if int(fail) < M:  # the group's one sync
            break
    out = torch.cat([pairs.view(-1), counts, fail]).cpu().numpy()
    return (out[:2 * M].reshape(M, 2).copy(), out[2 * M:3 * M].copy(),
            int(out[-1]))
