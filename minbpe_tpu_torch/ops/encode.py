"""Rank-sweep encoder over a dense device stream.

Counterpart of ``encode_fused_bytes`` / ``encode_fused_bytes_vals``
(minbpe_tpu/ops/pallas/fused_encode.py:169-299). For r = 0 .. M-1 the
merge of rank r is applied at every occurrence, left first, and the stream
is compacted. minbpe_tpu/ops/encode.py proves this equal to the reference's
lowest-rank-first loop (minbpe/basic.py:61-73), because a merge table is
well-founded: a pair of rank r can only be created by merges of lower rank.

On the card the whole sweep is one launch of K10 ``encode_sweep``, as the
Pallas encoder is one ``pallas_call`` for all M ranks; on the CPU it is the
rank loop of K3's and K4's plain versions. Each rank reads its pair from
the device table row itself, so no rank table is padded (the Pallas table
pads with -2, not -1, so that padding never matches its -1 "no pair" marks;
here there is no padding to match).

This is the dense route (table vocab <= engine.DENSE_VOCAB_MAX, any number
of tokens that fits in device memory); tables above it go to
ops/flat_encode.py. K10's loop has no bound of its own, so the Pallas
encoder's limits (4·2^20 tokens, 2048 ranks: VMEM) do not carry over.
"""

from __future__ import annotations

from .. import kernels
from .train import check_device_memory

# device bytes per token of an encode: the stream's ids and seg (8) and
# K10's four work rows (16)
BYTES_PER_TOKEN = 24


def check_memory(device, n_tokens: int, split_bytes: int = 0):
    """Raise MemoryError, before any work, where an encode of n_tokens does
    not fit in the card's free memory (nothing to check on the CPU);
    ``split_bytes``: the device pre-split's own bytes per token
    (ops/device_presplit.BYTES_PER_BYTE), where the split runs there."""
    if device.type == "cuda":
        per = BYTES_PER_TOKEN + split_bytes
        check_device_memory(device, per * n_tokens,
                            f"encoding {n_tokens} tokens ({per} B/token)")


def encode_stream(ids, seg, pairs, new_ids):
    """Apply the merges of ``pairs`` (int32 (M, 2) on the stream's device)
    in rank order, merge r creating ``new_ids[r]`` (int32 (M,) on that
    device). Returns the compacted (ids, seg, n) with n an int32[1] tensor;
    nothing is synced."""
    return kernels.encode_sweep(ids.contiguous(), seg.contiguous(), pairs,
                                new_ids)
