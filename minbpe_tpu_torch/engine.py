"""Host <-> device glue: builds device streams from text, runs the trainer
and the encoder, and turns results back into the dict-of-merges API.

The port's counterpart of minbpe_tpu/engine.py, for the slice it covers:
the fused and fused_xl training routes of ``run_train`` (engine.py:97-111,
130-166), one trainer for both,
``train_offsets``/``train_bytes`` (468-484) and
``encode_bytes``/``encode_offsets``/``encode_parts`` (322-423). A kernel that
fails raises: there is no fallback route. Options and sizes outside the
slice raise NotImplementedError naming the ROADMAP.md item that brings them.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops import stream as stream_ops
from .ops.encode import ENCODE_MAX_M, ENCODE_MAX_N, encode_stream
from .ops.train import TRAIN_MAX_N, TRAIN_MAX_V, train_merges

# training options of minbpe_tpu's run_train -> the ROADMAP.md item
_TRAIN_OPTION_ITEMS = {
    "select_mode": "A9 (selection paths)",
    "checkpoint_path": "A10 (checkpoint/resume/progress)",
    "checkpoint_every": "A10 (checkpoint/resume/progress)",
    "resume_from": "A10 (checkpoint/resume/progress)",
    "progress": "A10 (checkpoint/resume/progress)",
    "profile_dir": "A17 (tracing)",
}


class DeviceMergeTable:
    """Frozen merge table: pairs on the tokenizer's device, new ids on the
    host (each rank passes its new id to the kernel by value)."""

    def __init__(self, pairs: np.ndarray, new_ids: np.ndarray, device):
        self.pairs = torch.as_tensor(
            np.ascontiguousarray(pairs, dtype=np.int32)).to(device)
        self.new_ids = [int(z) for z in new_ids]


def device_table(tokenizer) -> DeviceMergeTable:
    if tokenizer._dev is None:
        pairs, new_ids = tokenizer._merge_arrays()
        tokenizer._dev = DeviceMergeTable(pairs, new_ids, tokenizer.device)
    return tokenizer._dev


def _check_train_size(n_tokens: int, num_merges: int):
    """The trainer's bounds: V <= 1024 and N <= XL_MAX_N tokens. Beyond
    either, minbpe_tpu takes its sort-loop route (engine.py:112-120)."""
    V = 256 + num_merges
    if V > TRAIN_MAX_V:
        raise NotImplementedError(
            f"vocab_size {V} > {TRAIN_MAX_V} is not ported yet: ROADMAP.md "
            "A11 (vocab > 1024 training)")
    if n_tokens > TRAIN_MAX_N:
        raise NotImplementedError(
            f"{n_tokens} training tokens > {TRAIN_MAX_N} is not ported yet: "
            "ROADMAP.md A11 (the sort-loop route)")


def run_train(ids, seg, num_merges: int, verbose: bool = False, **opts):
    """Train on the device stream (ids, seg); return the merges dict and the
    vocab dict, as minbpe_tpu's run_train does (minbpe/basic.py:29-45 for
    the bookkeeping: new ids are 256 + round, and verbose prints one line per
    round in the reference's format)."""
    for name in opts:
        item = _TRAIN_OPTION_ITEMS.get(name)
        if item is None:
            raise TypeError(f"unexpected training option {name!r}")
        raise NotImplementedError(
            f"training option {name!r} is not ported yet: ROADMAP.md {item}")
    _check_train_size(ids.numel(), num_merges)
    pairs, counts, fail_round = train_merges(ids, seg, num_merges)
    if fail_round < num_merges:
        raise ValueError(
            f"no mergeable pair available at merge round {fail_round} "
            f"(requested {num_merges} merges); corpus is too small"
        )

    merges: dict[tuple[int, int], int] = {}
    vocab = {idx: bytes([idx]) for idx in range(256)}
    for i in range(num_merges):
        pair = (int(pairs[i, 0]), int(pairs[i, 1]))
        idx = 256 + i
        merges[pair] = idx
        vocab[idx] = vocab[pair[0]] + vocab[pair[1]]
        if verbose:
            print(
                f"merge {i+1}/{num_merges}: {pair} -> {idx} ({vocab[idx]}) "
                f"had {int(counts[i])} occurrences"
            )
    return merges, vocab


def train_offsets(data, ends, num_merges: int, verbose: bool = False, *,
                  device, **opts):
    _check_train_size(int(data.shape[0]), num_merges)
    ids, seg = stream_ops.build_stream(data, ends, device)
    return run_train(ids, seg, num_merges, verbose, **opts)


def train_bytes(data: bytes, num_merges: int, verbose: bool = False, *,
                device, **opts):
    arr = np.frombuffer(data, dtype=np.uint8)
    ends = np.asarray([len(data)], dtype=np.int64) if len(data) else \
        np.zeros(0, dtype=np.int64)
    return train_offsets(arr, ends, num_merges, verbose, device=device,
                         **opts)


def _encode_arrays(tokenizer, data, ends):
    """(ids, seg) numpy int32 arrays of the encoded stream: the output
    tokens in order, each with the chunk id it came from."""
    dev = device_table(tokenizer)
    M = len(dev.new_ids)
    if M > ENCODE_MAX_M:
        raise NotImplementedError(
            f"encode with {M} merges > {ENCODE_MAX_M} is not ported yet: "
            "ROADMAP.md A12 (large-table encode)")
    if data.shape[0] > ENCODE_MAX_N:
        raise NotImplementedError(
            f"encode of {data.shape[0]} bytes > {ENCODE_MAX_N} in one call is "
            "not ported yet: ROADMAP.md A12 (large-table encode)")
    ids, seg = stream_ops.build_stream(data, ends, tokenizer.device)
    ids, seg, n = encode_stream(ids, seg, dev.pairs, dev.new_ids)
    k = int(n.item())
    out = torch.stack([ids[:k], seg[:k]]).cpu().numpy()
    return out[0], out[1]


def encode_bytes(tokenizer, data: bytes) -> list[int]:
    """Encode raw bytes as a single segment (BasicTokenizer path)."""
    if len(data) == 0:
        return []
    arr = np.frombuffer(data, dtype=np.uint8)
    ends = np.array([len(data)], dtype=np.int64)
    return encode_offsets(tokenizer, arr, ends)


def encode_offsets(tokenizer, data, ends) -> list[int]:
    """Encode a (byte array, chunk-end offsets) pair."""
    if data.shape[0] == 0:
        return []
    return _encode_arrays(tokenizer, data, ends)[0].tolist()


def encode_parts(tokenizer, parts: list) -> list:
    """Encode several independent pre-split documents as one device stream.
    ``parts`` is a list of (byte array, chunk-end offsets) pairs; returns one
    numpy int32 token array per part, in order.

    Every chunk keeps its own segment id through the run and compaction keeps
    stream order, so the output tokens of part k are the contiguous run whose
    segment ids lie in part k's chunk range (minbpe_tpu splits by byte
    position instead, which compaction does not keep)."""
    parts = list(parts)
    if not parts:
        return []
    sizes = [int(d.shape[0]) for d, _ in parts]
    if sum(sizes) == 0:
        return [np.zeros(0, np.int32) for _ in parts]
    offs = np.cumsum([0] + sizes)
    data = np.concatenate([np.asarray(d, dtype=np.uint8) for d, _ in parts])
    ends = np.concatenate(
        [np.asarray(e, dtype=np.int64) + offs[k]
         for k, (_, e) in enumerate(parts)]
    )
    ids, seg = _encode_arrays(tokenizer, data, ends)
    chunk_starts = np.cumsum([0] + [len(e) for _, e in parts])
    cuts = np.searchsorted(seg, chunk_starts, side="left")
    return [ids[cuts[k]:cuts[k + 1]] for k in range(len(parts))]
