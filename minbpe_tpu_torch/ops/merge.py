"""One merge applied everywhere, then compaction.

The port's counterpart of minbpe_tpu/ops/merge.py (:29-70): the
reference's ``merge(ids, pair, idx)`` (minbpe/base.py:25-41), every
left-to-right non-overlapping occurrence of the pair replaced by the new
id, and a run of (a, a) matches resolved left first (keep the even offsets
of each run). On the card ``apply_merge`` is K3 ``merge_apply`` (the pair
read from a device tensor, the new id by value or from a device slot
record) and K4 ``compact``; on the
CPU their plain versions.
"""

from __future__ import annotations

import torch

from .. import kernels
from .select import pair_validity


def merge_mask(ids, seg, n, pa: int, pb: int):
    """keep[i] iff the merge of (pa, pb) applies at position i, its left
    token: the matches of each maximal run, every second one from the run's
    start (minbpe/base.py:33-41). K3's keep, in plain PyTorch."""
    valid, nxt_ids = pair_validity(ids, seg, n)
    m = valid & (ids == pa) & (nxt_ids == pb)
    m_prev = torch.zeros_like(m)
    m_prev[1:] = m[:-1]
    idx = torch.arange(ids.shape[0], dtype=torch.int32, device=ids.device)
    start = torch.where(m & ~m_prev, idx, -1)
    run_start = torch.cummax(start, 0).values
    return m & (((idx - run_start) & 1) == 0)


def compact(ids, seg, live, n):
    """(ids, seg, n): the live tokens of ids[:n], seg[:n] moved to the front
    in order, n their count (int32[1]); positions from n on are undefined."""
    return kernels.compact(ids, seg, live, n)


def apply_merge(ids, seg, n, pair, new_id):
    """Apply one merge everywhere and compact. ``pair`` is an int32[2]
    tensor on the stream's device (a pair of ids absent from the stream,
    such as (-1, -1), merges nothing); ``new_id`` an int, or an int32[1]
    tensor on that device, which K3 then reads there from a slot record
    (``kernels.new_slot``: the pair, one candidate, the new id), so that
    nothing waits for the host. Returns (ids, seg, n, n_merged), n_merged
    an int32[1] tensor."""
    if isinstance(new_id, torch.Tensor):
        dev = ids.device
        slot = torch.cat([pair, torch.zeros(kernels.SLOT_BSEL - 2,
                                            dtype=torch.int32, device=dev),
                          torch.ones(1, dtype=torch.int32, device=dev),
                          new_id,
                          torch.zeros(kernels.SLOT_SIZE - kernels.SLOT_ZBASE
                                      - 1, dtype=torch.int32, device=dev)])
        log = torch.zeros((1, 4), dtype=torch.int32, device=dev)
        merged, live = kernels.merge_apply(ids, seg, n, slot=slot, log=log)
        ids, seg, n = kernels.compact(merged, seg, live, n, slot=slot)
        return ids, seg, n, log[0, 3:]
    n_merged = torch.zeros(1, dtype=torch.int32, device=ids.device)
    merged, live = kernels.merge_apply(ids, seg, n, pair, new_id, n_merged)
    ids, seg, n = compact(merged, seg, live, n)
    return ids, seg, n, n_merged
