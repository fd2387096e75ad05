"""Round-by-round training through an explicit selection path: count,
select the reference's pair, apply it, compact, once per merge.

The port's counterpart of minbpe_tpu/ops/train.py::train_merges (:32-88),
behind ``select_mode`` "sort", "dense" and "pallas" (ops/select.py). JAX
runs the loop as one program with ``lax.cond``; here the host enqueues the
rounds, and the fail round, the pairs and the counts stay on the device:
each round's branch is a ``torch.where``, and a round that finds no pair
applies the pair (-1, -1), which merges nothing. The host reads the fail
round once per ROUNDS_PER_SYNC rounds (ops/rounds.py), so a run stops soon
after it, and fetches the log once at the end.
"""

from __future__ import annotations

import numpy as np
import torch

from .merge import apply_merge
from .rounds import RunLog, run_rounds, stream
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


class _State(RunLog):
    """The compacted stream, the selection path and the run's log."""

    def __init__(self, ids, seg, n, M: int, select):
        super().__init__(M, ids.device)
        self.ids, self.seg, self.n, self.select = ids, seg, n, select


def _round(st: _State, i: int):
    pa, pb, cnt, ok = st.select(st.ids, st.seg, st.n, 256 + st.M)
    ok &= st.fail >= i
    pair = torch.where(ok, torch.cat([pa, pb]), -1)
    st.ids, st.seg, st.n, _ = apply_merge(st.ids, st.seg, st.n, pair,
                                          256 + i)
    st.pairs[i] = torch.where(ok, pair, 0)
    st.cnts[i:i + 1] = torch.where(ok, cnt, 0)
    st.fail = torch.where(ok, st.fail, st.fail.clamp(max=i))


def train_merges_select(ids, seg, num_merges: int, select_mode: str = "sort"):
    """Learn num_merges merges from the stream (ids, seg), int32 tensors of
    equal length on the device the run uses, selecting each round's pair
    by ``select_mode``. Returns numpy (pairs[M, 2], counts[M]) and the fail
    round (M when every round found a pair); rows from the fail round on
    are zero."""
    if select_mode not in _SELECT:
        raise ValueError(f"unknown select_mode {select_mode!r}")
    M = num_merges
    V = 256 + M
    N = ids.numel()
    if M == 0 or N < 2:  # nothing to learn, or no pair at all
        return np.zeros((M, 2), np.int32), np.zeros((M,), np.int32), 0
    if ids.is_cuda:
        check_device_memory(ids.device, device_bytes(select_mode, N, V),
                            f"select_mode={select_mode!r} on {N} tokens at "
                            f"vocab {V}")
    st = _State(*stream(ids, seg), M, _SELECT[select_mode])
    return run_rounds(st, _round, unroll=ROUNDS_PER_SYNC, steps_per_sync=1)
