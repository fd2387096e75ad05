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
numbers, punctuation) go to K11 ``chunk_encode``, one warp a chunk; the
longer ones (a BasicTokenizer's single chunk, long runs of whitespace or
punctuation) are gathered into a stream of their own for K12
``encode_min_sweep``. Both write each chunk's tokens back at its input
offset in one buffer, which comes to the host in one fetch with the
per-chunk lengths. On the CPU, kernels.py runs their plain version
(``encode_min_sweep_plain``).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from .train import check_device_memory

CHUNK_WARP_MAX = kernels.CHUNK_WARP_MAX
# device bytes per input token at the peak: the bytes as int32 ids (4) and
# the output buffer (4); the long chunks' stream (8) and K12's four work
# rows (16)
BYTES_PER_TOKEN = 32


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
    dev = table.device
    if dev.type == "cuda":
        check_device_memory(dev, BYTES_PER_TOKEN * N,
                            f"encoding {N} tokens ({BYTES_PER_TOKEN} B/token)")
    ends = np.asarray(ends, dtype=np.int64)
    data = np.array(data, dtype=np.uint8)  # writable, for torch
    L = np.diff(ends, prepend=0)
    short = L <= CHUNK_WARP_MAX
    bounds = torch.from_numpy(
        np.concatenate([[0], ends]).astype(np.int32)).to(dev)
    out = torch.full((N + 1,), -1, dtype=torch.int32, device=dev)
    lens = torch.zeros(C + 1, dtype=torch.int32, device=dev)
    if short.any():
        ids = torch.from_numpy(data).to(dev).to(torch.int32)
        which = torch.from_numpy(
            np.flatnonzero(short).astype(np.int32)).to(dev)
        kernels.chunk_encode(ids, bounds, which, table, out, lens)
    if not short.all():
        longs = np.flatnonzero(~short)
        l_ids = torch.from_numpy(data[np.repeat(~short, L)]).to(dev).to(
            torch.int32)
        l_seg = torch.from_numpy(
            np.repeat(longs.astype(np.int32), L[longs])).to(dev)
        kernels.place_chunks(*kernels.encode_min_sweep(l_ids, l_seg, table),
                             bounds, out, lens)
    host = torch.cat([out[:N], lens[:C]]).cpu().numpy()
    flat = host[:N]
    lens = host[N:].astype(np.int64)
    return (flat[flat >= 0], lens,
            np.repeat(np.arange(C, dtype=np.int32), lens))
