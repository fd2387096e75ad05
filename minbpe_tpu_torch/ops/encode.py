"""The dense route's encoders over a device stream.

Counterpart of ``encode_fused_bytes`` / ``encode_fused_bytes_vals``
(minbpe_tpu/ops/pallas/fused_encode.py:169-299). Two kernels compute the
same function; ``encode_stream`` takes the one whose parallel shape fits
what the caller knows of the stream.

The rank sweep, K10 ``encode_sweep``: for r = 0 .. M-1 the merge of rank r
is applied at every occurrence, left first, and the stream is compacted.
minbpe_tpu/ops/encode.py proves this equal to the reference's
lowest-rank-first loop (minbpe/basic.py:61-73), because a merge table is
well-founded: a pair of rank r can only be created by merges of lower rank.
On the card the whole sweep is one launch of K10, as the Pallas encoder is
one ``pallas_call`` for all M ranks; on the CPU it is the rank loop of K3's
and K4's plain versions. Each rank reads its pair from the device table row
itself, so no rank table is padded (the Pallas table pads with -2, not -1,
so that padding never matches its -1 "no pair" marks; here there is no
padding to match). K10 spreads one long segment over the whole card: a
BasicTokenizer's text, a stream of one segment, takes it.

The per-segment loop, K17 ``segment_encode``: each segment runs the
reference's loop itself (minbpe/regex.py:96-108), merging every occurrence
of its own lowest-rank pair until it has none, with pairs looked up in the
table's cuckoo hash (ops/ranktab.py). A segment of L tokens takes at most
L - 1 rounds, where K10 takes all M ranks for every segment; a pre-split
text's chunks are a few bytes. But K17 gives a segment past CHUNK_MAX
(256) tokens to one block, round after round over its tokens in device
memory, where K10 spreads a long segment over the whole card. So the route
goes by what the caller knows of the segments (``short_segments``, the
one place that names either kernel's route): the device pre-split's
stream (``DEVICE_SPLIT``: a GPT split by construction, its chunk ends on
the card) takes K17; a stream whose segment lengths the host holds (the
host split, ``encode_parts``, the distributed encode's shards) takes K17
where they are short, else K10. On the CPU both are plain PyTorch twins.

``encode_stream_sorted`` (minbpe_tpu/ops/encode.py:140-180) is the other
encoder over a stream: the lowest-rank loop itself, each round's ranks
looked up in a ``SortedPairTable`` (ops/ranktab.py, plain PyTorch), the
round's merge applied by ``ops/merge.apply_merge`` (K3 and K4 on the card),
host-stepped in groups of UNROLL rounds between reads of a done flag.
It serves the bucketed chunk encoder's chunks past its largest bucket
(ops/chunk_encode.py). minbpe_tpu's ``encode_stream`` and
``encode_stream_stepped`` (:43-137), which it reaches only off the TPU,
have no counterpart: K10 and K17 are the dense route on every device.

This is the dense route (table vocab <= engine.DENSE_VOCAB_MAX, any number
of tokens that fits in device memory); tables above it go to
ops/flat_encode.py after the host split, and to K17 here after the device
split, whose cuckoo table serves any vocab (2^18 rows a table at
cl100k's 100,000 merges, against 512 at 256). K10's loop has no bound of its own, so the Pallas
encoder's limits (4·2^20 tokens, 2048 ranks: VMEM) do not carry over.
"""

from __future__ import annotations

import torch

from .. import kernels, trace
from .merge import apply_merge
from .ranktab import RANK_INF, CuckooPairTable
from .select import pair_validity
from .train import check_device_memory

# rounds of encode_stream_sorted (and of the chunk encoder's rows) enqueued
# between reads of the done flag
UNROLL = 8
# device bytes per token of an encode: the stream's ids and seg (8), then
# K10's four work rows (16), or K17's output ids and seg and its scratch
# row (12)
BYTES_PER_TOKEN = 24
SEGMENT_BYTES_PER_TOKEN = 20


# what encode_stream and check_memory are told of the device pre-split's
# stream in place of its segment lengths, which stay on the card
DEVICE_SPLIT = "device split"


def short_segments(lengths) -> bool:
    """The route of a stream by what its caller knows of its segments:
    ``DEVICE_SPLIT`` takes K17, and so do segment lengths the host holds
    (numpy) where there is more than one segment and none past
    kernels.TILE (2,048) tokens; anything else (None: one text, say) takes
    K10. Up to one tile K17's block loop over a long segment stays at or
    below K10 (on an H100, one segment of 257-2,048 tokens after 20 KB of
    short ones: 0.23-0.67 ms against 1.57-1.58; 4,096 tokens: 1.50 against
    1.58); past it K10 wins, 3.5x at 16,384 tokens and 127x on two 1 MB
    documents (scripts/time_segment_encode.py)."""
    if lengths is DEVICE_SPLIT:
        return True
    return (lengths is not None and len(lengths) > 1
            and int(lengths.max()) <= kernels.TILE)


def check_memory(device, n_tokens: int, table, *, lengths=None,
                 split_bytes: int = 0):
    """Raise MemoryError, before any work, where an encode of n_tokens does
    not fit in the card's free memory (nothing to check on the CPU).
    ``table``: the engine.DeviceMergeTable, or its merge count where none
    exists yet; where the stream takes K17 (``lengths`` as in
    encode_stream), the cuckoo rows it has still to build count too (8 MB
    at 100,000 merges). ``split_bytes``: the device pre-split's own bytes
    per token (ops/device_presplit.BYTES_PER_BYTE), where the split runs
    there."""
    if device.type == "cuda":
        per, table_bytes = BYTES_PER_TOKEN, 0
        if short_segments(lengths):
            per = SEGMENT_BYTES_PER_TOKEN
            table_bytes = (CuckooPairTable.device_bytes(table)
                           if isinstance(table, int) else table.cuckoo_bytes())
        per += split_bytes
        check_device_memory(device, per * n_tokens + table_bytes,
                            f"encoding {n_tokens} tokens ({per} B/token, "
                            f"{table_bytes} B of table)")


def encode_stream(ids, seg, table, *, lengths=None):
    """Apply the merges of ``table`` (engine.DeviceMergeTable on the
    stream's device: pairs, new_ids and their cuckoo table) as the
    reference's loop does in each segment. ``lengths``: what the caller
    knows of the segments, as ``short_segments`` reads it; K17 takes each
    segment by its own loop through ``table.cuckoo``, K10 sweeps the
    ranks through ``table.pairs`` and ``table.new_ids``. Counts the route
    in ``trace.COUNTERS`` (``encode.route.segments`` or
    ``encode.route.sweep``); the span ``encode.sweep`` holds either
    kernel's enqueue. Returns the compacted (ids, seg, n) with n an
    int32[1] tensor; nothing is synced."""
    k17 = short_segments(lengths)
    cuckoo = table.cuckoo if k17 else None  # built before the span
    with trace.span("encode.sweep"):
        ids, seg = ids.contiguous(), seg.contiguous()
        if k17:
            trace.count("encode.route.segments")
            return kernels.segment_encode(ids, seg, cuckoo)
        trace.count("encode.route.sweep")
        return kernels.encode_sweep(ids, seg, table.pairs, table.new_ids)


def readback(ids, n, seg=None):
    """The encoded tokens ids[:k] (with their segments seg[:k], where
    given) as numpy, k = n, the count encode_stream returns: two syncs."""
    with trace.span("encode.readback"):
        trace.count("sync.encode.count")
        k = int(n.item())
        trace.count("sync.encode.readback")
        if seg is None:
            return ids[:k].cpu().numpy()
        out = torch.stack([ids[:k], seg[:k]]).cpu().numpy()
    return out[0], out[1]


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
