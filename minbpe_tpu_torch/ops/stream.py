"""Token streams: host packing and the device stream build.

A stream is ``ids`` (int32 token ids) and ``seg`` (int32 chunk id per token)
in corpus order. A pair (i, i + 1) is countable and mergeable only when
seg[i] == seg[i + 1]: the array form of the reference's per-chunk id lists
(minbpe/regex.py:44), so merges never cross chunk boundaries.
BasicTokenizer's stream is one chunk.

``pack_offsets``/``unpack_ids`` are the host forms of minbpe_tpu's
ops/stream.py:74-96 (same arrays, same padding). ``build_stream`` builds the
device stream from corpus bytes and chunk-end offsets, the counterpart of
the plane build ``_prep_from_bytes``/``_prep_from_bits``
(fused_train.py:1201-1255): seg[i] = the number of chunk ends <= i. The
Pallas planes pad past the live length with id -1 and seg -2; the kernels
here need no padding, so the stream holds exactly n positions and the int32
ends cross to the device as they are (no bitmask).
"""

from __future__ import annotations

import numpy as np
import torch

PAD = -1
PAD_SEG = -1  # host packing (pack_offsets), as in minbpe_tpu

_MIN_CAPACITY = 128


def bucket_capacity(n: int) -> int:
    """Round a length up to a power of two, at least 128."""
    cap = _MIN_CAPACITY
    while cap < n:
        cap *= 2
    return cap


def pack_offsets(data: np.ndarray, ends: np.ndarray,
                 capacity: int | None = None):
    """Pack a byte array + chunk-end offsets into host (ids, seg, n)."""
    n = int(data.shape[0])
    cap = bucket_capacity(n) if capacity is None else capacity
    ids = np.full(cap, PAD, dtype=np.int32)
    ids[:n] = data
    seg = np.full(cap, PAD_SEG, dtype=np.int32)
    if len(ends):
        lengths = np.diff(ends, prepend=0)
        seg[:n] = np.repeat(np.arange(len(ends), dtype=np.int32), lengths)
    return ids, seg, np.int32(n)


def unpack_ids(ids: np.ndarray, n: int) -> list[int]:
    """The live token ids as a Python list (host-side boundary)."""
    return np.asarray(ids[:int(n)]).tolist()


def build_stream(data: np.ndarray, ends: np.ndarray, device):
    """Device (ids, seg) int32 tensors of length len(data) from uint8 corpus
    bytes and int chunk ends (the last equal to len(data)). Only the bytes
    and the ends cross to the device."""
    n = int(data.shape[0])
    d = torch.from_numpy(np.array(data, dtype=np.uint8))
    e = torch.from_numpy(np.array(ends, dtype=np.int32))
    d, e = d.to(device), e.to(device)
    ids = d.to(torch.int32)
    pos = torch.arange(n, dtype=torch.int32, device=device)
    seg = torch.searchsorted(e, pos, right=True, out_int32=True)
    return ids, seg
