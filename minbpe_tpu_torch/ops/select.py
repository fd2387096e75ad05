"""Exact pair selection for the explicit selection paths: the sort path, the
dense one-hot count, and the dense count of K9.

The port's counterpart of minbpe_tpu/ops/select.py (:30-146). The rule is
the reference's ``max(get_stats(ids), key=stats.get)`` (minbpe/basic.py:
33-35): the largest count, and among equal counts the pair whose first
occurrence comes first. Every function takes a dense stream (ids, seg)
with its live length n as an int32[1] tensor on the same device, and
returns device tensors of shape (1,) (pa, pb, count, ok), so a training
round reads nothing back to the host. ``ok`` is False when no pair is
countable, the round where the reference's ``max`` over an empty dict
raises; pa and pb are then meaningless.
"""

from __future__ import annotations

import torch

from .. import kernels

INT32_MAX = 2**31 - 1
# the one-hot count's block: positions per product, so that one operand
# holds about 2^26 entries; under 2^24, so every f32 partial sum is exact
_ONE_HOT_ENTRIES = 1 << 26
_ONE_HOT_MAX_BLOCK = 1 << 16


def _arange(ids, dtype=torch.int32):
    return torch.arange(ids.shape[0], dtype=dtype, device=ids.device)


def _at(x, j):
    """x[j] for a one-element index tensor j, as a (1,) tensor (a gather: an
    index given as a 0-d tensor would be read back to the host)."""
    return x.gather(0, j.reshape(1).long())


def pair_validity(ids, seg, n):
    """(valid, nxt_ids): valid[i] iff (ids[i], ids[i + 1]) is a countable
    pair, i + 1 < n in one segment (minbpe/regex.py:44: merges never cross
    chunk ends); nxt_ids is ids rolled left by one."""
    nxt_ids = torch.cat([ids[1:], ids[:1]])
    nxt_seg = torch.cat([seg[1:], seg[:1]])
    return (_arange(ids) + 1 < n) & (seg == nxt_seg), nxt_ids


INF_KEY = INT32_MAX << 32 | INT32_MAX


def pair_runs(ids, seg, n):
    """One stable sort of the 64-bit keys ids[i] << 32 | ids[i + 1]:
    (skey, spos, is_head, cnt, nxt_ids). Equal pairs form runs with their
    positions ascending, so each run's head holds the pair's first
    occurrence; cnt is each run's length at its head (0 elsewhere).
    Invalid slots sort last as INF_KEY."""
    N = ids.shape[0]
    valid, nxt_ids = pair_validity(ids, seg, n)
    ka = torch.where(valid, ids, INT32_MAX).long()
    kb = torch.where(valid, nxt_ids, INT32_MAX).long()
    skey, spos = torch.sort((ka << 32) | kb, stable=True)
    head = torch.ones_like(valid)
    head[1:] = skey[1:] != skey[:-1]
    last = torch.ones_like(valid)
    last[:-1] = head[1:]
    idx = _arange(ids, torch.int64)
    # run lengths without minbpe_tpu's reverse cummin (a single-block scan
    # on the card): runs numbered by a cumsum of their heads, each run's
    # last slot written to the run's entry (other slots to entries of
    # their own past N)
    run = torch.cumsum(head, 0) - 1
    end = torch.empty(2 * N, dtype=torch.int64, device=ids.device).scatter_(
        0, torch.where(last, run, N + idx), idx)
    is_head = head & (skey != INF_KEY)
    cnt = torch.where(is_head, end.gather(0, run) - idx + 1, 0)
    return skey, spos, is_head, cnt, nxt_ids


def select_max_pair(ids, seg, n):
    """(pa, pb, count, ok) by one sort (the sort path, pair_runs): the
    largest run, and among equal ones the earliest head position."""
    N = ids.shape[0]
    _, spos, is_head, cnt, nxt_ids = pair_runs(ids, seg, n)
    maxc = cnt.max().reshape(1)
    tied = is_head & (cnt == maxc)
    best_pos = torch.where(tied, spos, N).min().clamp(max=N - 1)
    return (_at(ids, best_pos), _at(nxt_ids, best_pos),
            maxc.to(torch.int32), maxc > 0)


def count_pairs_dense(ids, seg, n, V: int):
    """Dense int32 (V, V) pair counts as one-hot products: the sum over
    blocks of A^T @ B, A and B the one-hot rows of each valid pair's left
    and right ids (an id outside [0, V) has a zero row). On the card the
    operands are bf16 and the products accumulate in f32; on the CPU both
    are f32. Each block's product is at most the block's length, exact in
    f32, and becomes int32 before it is added, so counts stay exact past
    2^24."""
    valid, nxt_ids = pair_validity(ids, seg, n)
    a = torch.where(valid, ids, -1)
    b = torch.where(valid, nxt_ids, -1)
    vr = torch.arange(V, dtype=torch.int32, device=ids.device)
    cuda = ids.is_cuda
    dt = torch.bfloat16 if cuda else torch.float32
    block = max(1, min(_ONE_HOT_MAX_BLOCK, _ONE_HOT_ENTRIES // V))
    acc = torch.zeros((V, V), dtype=torch.int32, device=ids.device)
    for s in range(0, ids.shape[0], block):
        A = (a[s:s + block, None] == vr).to(dt)
        B = (b[s:s + block, None] == vr).to(dt)
        if cuda:
            prod = torch.mm(A.t(), B, out_dtype=torch.float32)
        else:
            prod = A.t() @ B
        acc += prod.to(torch.int32)
    return acc


def select_from_counts(ids, seg, n, counts, V: int):
    """(pa, pb, count, ok) from a dense (V, V) count matrix: the largest
    count, and the first position whose pair has it (one masked scan, which
    settles ties by first occurrence)."""
    maxc = counts.max().reshape(1)
    tied = (counts == maxc).view(-1)
    valid, nxt_ids = pair_validity(ids, seg, n)
    ia = ids.clamp(0, V - 1).long()
    ib = nxt_ids.clamp(0, V - 1).long()
    hit = valid & tied[ia * V + ib]
    # argmax of the 0/1 ints: the first True, 0 when there is none
    first = torch.argmax(hit.to(torch.int32))
    ok = (maxc > 0) & hit.any()
    return _at(ids, first), _at(nxt_ids, first), maxc, ok


def select_max_pair_dense(ids, seg, n, V: int):
    """Selection through the one-hot count."""
    return select_from_counts(ids, seg, n, count_pairs_dense(ids, seg, n, V),
                              V)


def select_max_pair_pallas(ids, seg, n, V: int):
    """Selection through K9's count (its plain version on the CPU), the
    counterpart of the Pallas pair-count kernel's path."""
    return select_from_counts(ids, seg, n, kernels.pair_count(ids, seg, n, V),
                              V)
