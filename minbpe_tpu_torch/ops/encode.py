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

``encode_stream_sorted`` (minbpe_tpu/ops/encode.py:140-180) is the other
encoder over a stream: the lowest-rank loop itself, each round's ranks
looked up in a ``SortedPairTable`` (ops/ranktab.py, plain PyTorch), the
round's merge applied by ``ops/merge.apply_merge`` (K3 and K4 on the card),
host-stepped in groups of UNROLL rounds between reads of a done flag.
It serves the bucketed chunk encoder's chunks past its largest bucket
(ops/chunk_encode.py). minbpe_tpu's ``encode_stream`` and
``encode_stream_stepped`` (:43-137), which it reaches only off the TPU,
have no counterpart: K10 is the dense route on every device.

This is the dense route (table vocab <= engine.DENSE_VOCAB_MAX, any number
of tokens that fits in device memory); tables above it go to
ops/flat_encode.py. K10's loop has no bound of its own, so the Pallas
encoder's limits (4·2^20 tokens, 2048 ranks: VMEM) do not carry over.
"""

from __future__ import annotations

import torch

from .. import kernels, trace
from .merge import apply_merge
from .ranktab import RANK_INF
from .select import pair_validity
from .train import check_device_memory

# rounds of encode_stream_sorted (and of the chunk encoder's rows) enqueued
# between reads of the done flag
UNROLL = 8
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
    with trace.span("encode.sweep"):
        return kernels.encode_sweep(ids.contiguous(), seg.contiguous(),
                                    pairs, new_ids)


def encode_stream_sorted(ids, seg, n, table):
    """Encode the stream ids[:n] (segments ``seg``; numpy arrays or int32
    tensors, as ``stream.pack_bytes`` makes them) against ``table``, a
    ``SortedPairTable``, on its device: each round applies the lowest rank
    present, until none is. UNROLL rounds go out between reads of the
    done flag; a round after the last merge applies the absent pair
    (-1, -1), which merges nothing. Returns (ids, n): the tokens are
    ids[:n], n an int32[1] tensor."""
    dev = table.device
    ids = torch.as_tensor(ids, dtype=torch.int32).to(dev).contiguous()
    seg = torch.as_tensor(seg, dtype=torch.int32).to(dev).contiguous()
    n = torch.as_tensor(n, dtype=torch.int32).reshape(1).to(dev)
    if ids.numel() == 0:
        return ids, n
    last = table.merge_ids.shape[0] - 1
    absent = torch.full((2,), -1, dtype=torch.int32, device=dev)
    done = n < 2
    while True:
        for _ in range(UNROLL):
            valid, nxt_ids = pair_validity(ids, seg, n)
            r = table.lookup(ids, nxt_ids, valid).min().reshape(1)
            found = r != RANK_INF
            rr = r.clamp(max=last).long()
            pair = torch.where(found, table.merge_pairs[rr][0], absent)
            ids, seg, n, _ = apply_merge(ids, seg, n, pair,
                                         table.merge_ids[rr])
            done = done | ~found
        trace.count("sync.encode.done")
        if bool(done):
            return ids, n
