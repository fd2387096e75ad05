"""Encode with a merge table above the dense route's vocab.

The port's counterpart of minbpe_tpu/ops/flat_encode.py
(``encode_offsets_arrays``, :166-181, over ``_encode_flat``, :61-186), the
route of every table whose ids pass ``engine.DENSE_VOCAB_MAX``: GPT-4's
100,256 ranks among them. The rule is the reference's per-chunk loop
(minbpe/regex.py:96-108): in each chunk, merge every occurrence of that
chunk's lowest-rank pair, left first, until the chunk has none. Pairs are
looked up in a cuckoo table (ops/ranktab.py).

Chunks are routed by length on the host, from the chunk ends, with no
sync: those of at most ``CHUNK_WARP_MAX`` tokens (a GPT-4 split's words,
numbers, punctuation) go to K11 ``chunk_encode``, a lane or a warp a
chunk; the longer ones (a BasicTokenizer's single chunk, long runs of
whitespace or punctuation) to K12 ``encode_min_sweep``, a block or a
thread-block cluster a chunk. Both write each chunk's tokens back at its
input offset in one buffer, which comes to the host in one fetch with the
per-chunk lengths. On the CPU, kernels.py runs their plain version
(``chunk_encode_plain``).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from .train import check_device_memory

CHUNK_WARP_MAX = kernels.CHUNK_WARP_MAX
# device bytes per input token at the peak: the output buffer (4) and the
# bytes (1) while they become int32 ids (4), which go before the fetch
# takes their place; K12's scratch for chunks past its on-chip tier comes
# on top, as kernels.k12_plan sizes it
BYTES_PER_TOKEN = 9


def k11_order(lengths, short):
    """(which, lanes): the indices (int32) of the chunks of these lengths
    that ``short`` marks (each at most CHUNK_WARP_MAX tokens), those of at
    most K11_LANE_MAX tokens first (a lane of K11 each), and how many
    those are: K11's ``which`` and ``lanes``. A few passes over the
    lengths: it runs on the host for every encode."""
    lane = lengths <= kernels.K11_LANE_MAX
    first, rest = np.flatnonzero(lane), np.flatnonzero(short ^ lane)
    which = np.empty(first.size + rest.size, np.int32)
    which[:first.size] = first
    which[first.size:] = rest
    return which, first.size


def encode_offsets_arrays(data: np.ndarray, ends: np.ndarray, table):
    """Encode (uint8 bytes, chunk-end offsets) with ``table`` (a
    CuckooPairTable on the device to run on). Returns numpy (tokens int32
    in corpus order, int64 output length per chunk, int32 chunk index per
    token)."""
    N = int(data.shape[0])
    C = len(ends)
    if C == 0 or N == 0:
        return (np.zeros(0, np.int32), np.zeros(C, np.int64),
                np.zeros(0, np.int32))
    if N > kernels.INT32_MAX:
        raise ValueError(f"{N} tokens: the chunk offsets are int32")
    dev = table.device
    data = np.array(data, dtype=np.uint8)  # writable, for torch
    # int32 throughout: half the bytes of each pass over the chunks
    ends32 = np.concatenate([[0], ends]).astype(np.int32)
    L = np.diff(ends32)
    short = L <= CHUNK_WARP_MAX
    long = [] if short.all() else L[~short].tolist()
    if dev.type == "cuda":
        scratch = 4 * kernels.k12_plan(long)[3]
        check_device_memory(dev, BYTES_PER_TOKEN * N + scratch,
                            f"encoding {N} tokens ({BYTES_PER_TOKEN} B/token "
                            f"and {scratch} B of K12 scratch)")
    bounds = torch.from_numpy(ends32).to(dev)
    out = torch.full((N + 1,), -1, dtype=torch.int32, device=dev)
    lens = torch.zeros(C + 1, dtype=torch.int32, device=dev)
    ids = torch.from_numpy(data).to(dev).to(torch.int32)
    if short.any():
        which, lanes = k11_order(L, short)
        kernels.chunk_encode(ids, bounds, torch.from_numpy(which).to(dev),
                             table, out, lens, lanes=lanes)
    if long:
        which = np.flatnonzero(~short).astype(np.int32)
        kernels.encode_min_sweep(ids, bounds, torch.from_numpy(which).to(dev),
                                 table, out, lens, lengths=long)
    del ids
    host = torch.cat([out[:N], lens[:C]]).cpu().numpy()
    flat = host[:N]
    lens = host[N:].astype(np.int64)
    return (flat[flat >= 0], lens,
            np.repeat(np.arange(C, dtype=np.int32), lens))
