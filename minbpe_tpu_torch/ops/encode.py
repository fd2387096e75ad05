"""Rank-sweep encoder over a dense device stream.

Counterpart of ``encode_fused_bytes`` / ``encode_fused_bytes_vals``
(minbpe_tpu/ops/pallas/fused_encode.py:169-299). For r = 0 .. M-1 the
merge of rank r is applied at every occurrence, left first (kernels K3
merge_apply and K4 compact). minbpe_tpu/ops/encode.py proves this equal to
the reference's lowest-rank-first loop (minbpe/basic.py:61-73), because a
merge table is well-founded: a pair of rank r can only be created by merges
of lower rank.

Each rank reads its pair from the device table row itself, so no rank table
is padded (the Pallas table pads with -2, not -1, so that padding never
matches its -1 "no pair" marks; here there is no padding to match).
"""

from __future__ import annotations

import torch

from .. import kernels

# the slice's limits: those of the fused Pallas encoder (fused_encode.py:41-42)
ENCODE_MAX_N = 1 << 22
ENCODE_MAX_M = 2048


def encode_stream(ids, seg, pairs, new_ids):
    """Apply the merges of ``pairs`` (int32 (M, 2) on the stream's device)
    in rank order, merge r creating ``new_ids[r]`` (host ints). Returns the
    compacted (ids, seg, n) with n an int32[1] tensor; nothing is synced."""
    n = torch.full((1,), ids.numel(), dtype=torch.int32, device=ids.device)
    for r, z in enumerate(new_ids):
        merged, live = kernels.merge_apply(ids, seg, n, pairs[r], int(z))
        ids, seg, n = kernels.compact(merged, seg, live, n)
    return ids, seg, n
