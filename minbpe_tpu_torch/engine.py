"""Host <-> device glue: builds device streams from text, runs the trainer
and the encoder, and turns results back into the dict-of-merges API.

The port's counterpart of minbpe_tpu/engine.py, for the slices it covers:
``run_train`` (engine.py:57-238) with its route choice, the whole-run,
selection, stepped, sort-round and sparse routes, checkpoints, progress
and ``profile_dir``;
``train_offsets``/``train_bytes`` (468-484) and
``encode_bytes``/``encode_offsets``/``encode_parts`` (322-423) with their
two routes, dense and sorted (``DeviceMergeTable``, 20-47). A kernel that
fails raises: there is no fallback route.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .ops import stream as stream_ops
from .ops import flat_encode
from .ops.encode import check_memory, encode_stream
from .ops.ranktab import CuckooPairTable
from .ops.train import TRAIN_MAX_N, TRAIN_MAX_V, train_merges
from .ops.train_inc import train_merges_incremental, train_merges_stepped
from .ops.train_select import DENSE_SELECT_MAX, train_merges_select
from .ops.train_sortloop import (train_merges_sortloop,
                                 train_merges_sortloop_stepped)
from .ops.train_sparse import (train_merges_sparse,
                               train_merges_sparse_stepped)
from .utils import checkpoint as ckpt

# the token bound of the stepped route under "auto": minbpe_tpu's
# FUSED_MAX_N (ops/pallas/fused_train.py:71, engine.py:112)
STEPPED_AUTO_MAX_N = 1 << 22
# select_mode -> route; "auto" is chosen by train_route
_ROUTES = {
    "fused": "whole", "fused_xl": "whole",
    "sort": "sort", "dense": "dense",
    "pallas": "pallas", "pallas_interpret": "pallas",
    "stepped": "stepped", "incremental": "incremental",
    "sortloop": "sortloop", "sortloop_inc": "sortloop_inc",
    "sparse": "sparse", "sparse_inc": "sparse_inc",
}
# the largest table vocab of the dense route (minbpe_tpu/engine.py:22)
DENSE_VOCAB_MAX = 4096


class DeviceMergeTable:
    """Frozen merge table on the tokenizer's device: pairs (int32 (M, 2))
    and new_ids (int32 (M,)) in rank order. ``vocab_size`` covers every id
    an encode can make; up to DENSE_VOCAB_MAX the table is "dense" (K10
    reads it rank by rank), above it "sorted": a cuckoo pair table for the
    flat encoder (minbpe_tpu/engine.py:20-47)."""

    def __init__(self, pairs: np.ndarray, new_ids: np.ndarray, device):
        self.vocab_size = (256 if len(new_ids) == 0
                           else max(256, int(np.max(new_ids)) + 1))
        self.kind = "dense" if self.vocab_size <= DENSE_VOCAB_MAX else "sorted"
        self.pairs = torch.as_tensor(
            np.ascontiguousarray(pairs, dtype=np.int32)).to(device)
        self.new_ids = torch.as_tensor(
            np.ascontiguousarray(new_ids, dtype=np.int32)).to(device)
        self.cuckoo = (CuckooPairTable(pairs, new_ids, device)
                       if self.kind == "sorted" else None)


def device_table(tokenizer) -> DeviceMergeTable:
    if tokenizer._dev is None:
        pairs, new_ids = tokenizer._merge_arrays()
        tokenizer._dev = DeviceMergeTable(pairs, new_ids, tokenizer.device)
    return tokenizer._dev


def train_route(select_mode: str, n_tokens: int, num_merges: int,
                plain: bool = True) -> str:
    """The route of a training run: "whole" (ops/train.py), "sort",
    "dense" or "pallas" (ops/train_select.py), "stepped" or "incremental"
    (ops/train_inc.py), "sortloop" or "sortloop_inc"
    (ops/train_sortloop.py), "sparse" or "sparse_inc"
    (ops/train_sparse.py). ``plain``: no checkpoint, resume or progress
    option. "auto" mirrors minbpe_tpu/engine.py:87-120 with its TPU test
    read as true, since the whole-run trainer serves both devices here:
    the whole-run trainer for a plain run up to vocab 1024 and 48·2^20
    tokens, else the stepped trainer up to vocab 2048 and 4·2^20 tokens,
    else the sort-round trainer; its "pallas_interpret" is "pallas", as the
    port has no interpret mode. Raises ValueError for an unknown mode or a
    whole-run request beyond its bounds."""
    V = 256 + num_merges
    whole_fits = V <= TRAIN_MAX_V and n_tokens <= TRAIN_MAX_N
    if select_mode == "auto":
        if plain and whole_fits:
            return "whole"
        if V <= DENSE_SELECT_MAX and n_tokens <= STEPPED_AUTO_MAX_N:
            return "stepped"
        return "sortloop"
    route = _ROUTES.get(select_mode)
    if route is None:
        raise ValueError(f"unknown select_mode {select_mode!r}")
    if route == "whole" and not whole_fits:
        raise ValueError(
            f"select_mode={select_mode!r} trains vocab <= {TRAIN_MAX_V} on "
            f"<= {TRAIN_MAX_N} tokens (got {V}, {n_tokens}); use 'auto' or "
            "'stepped'")
    return route


def _trace(profile_dir: str | None, device):
    """torch.profiler over the run, written into profile_dir by
    tensorboard_trace_handler: the counterpart of jax.profiler.trace."""
    if profile_dir is None:
        return contextlib.nullcontext()
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts,
                   on_trace_ready=tensorboard_trace_handler(profile_dir))


def run_train(ids, seg, num_merges: int, verbose: bool = False,
              select_mode: str = "auto", checkpoint_path: str | None = None,
              checkpoint_every: int | None = None,
              resume_from: str | None = None, profile_dir: str | None = None,
              progress=None, fingerprint: str | None = None):
    """Train on the device stream (ids, seg); return the merges dict and the
    vocab dict, as minbpe_tpu's run_train does (minbpe/basic.py:29-45 for
    the bookkeeping: new ids are 256 + round, and verbose prints one line per
    round in the reference's format). The checkpoint and progress options
    act on the stepped, sort-round and sparse routes ("auto" takes one of
    the first two when any is set);
    ``fingerprint`` is the corpus's, for checkpoints (train_offsets makes
    it)."""
    plain = (checkpoint_path is None and resume_from is None
             and progress is None)
    route = train_route(select_mode, ids.numel(), num_merges, plain)
    # the routes that take the checkpoint and progress options, and those
    # that run the whole run with none (train_merges_select takes the rest)
    stepped = {"stepped": train_merges_stepped,
               "sortloop": train_merges_sortloop_stepped,
               "sparse": train_merges_sparse_stepped}.get(route)
    whole = {"whole": train_merges, "incremental": train_merges_incremental,
             "sortloop_inc": train_merges_sortloop,
             "sparse_inc": train_merges_sparse}.get(route)
    with _trace(profile_dir, ids.device):
        if stepped is not None:
            pairs, counts, fail_round = stepped(
                ids, seg, num_merges, checkpoint_path=checkpoint_path,
                checkpoint_every=checkpoint_every, resume_from=resume_from,
                progress=progress, fingerprint=fingerprint)
        elif whole is not None:
            pairs, counts, fail_round = whole(ids, seg, num_merges)
        else:
            pairs, counts, fail_round = train_merges_select(
                ids, seg, num_merges, route)
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
    """Choose the route (raising before any work where none applies), and
    for a run that checkpoints or resumes, fingerprint the corpus as
    minbpe_tpu does: the padded host arrays of ops/stream.pack_offsets,
    so a checkpoint of either package resumes in the other."""
    plain = all(opts.get(k) is None
                for k in ("checkpoint_path", "resume_from", "progress"))
    train_route(opts.get("select_mode", "auto"), int(data.shape[0]),
                num_merges, plain)
    if (opts.get("checkpoint_path") is not None
            or opts.get("resume_from") is not None):
        opts["fingerprint"] = ckpt.corpus_fingerprint(
            *stream_ops.pack_offsets(data, ends))
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
    if dev.kind == "sorted":
        toks, _, seg = flat_encode.encode_offsets_arrays(data, ends,
                                                         dev.cuckoo)
        return toks, seg
    check_memory(tokenizer.device, int(data.shape[0]))
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
