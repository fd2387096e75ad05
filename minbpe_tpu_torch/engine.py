"""Host <-> device glue: builds device streams from text, runs the trainer
and the encoder, and turns results back into the dict-of-merges API.

The port's counterpart of minbpe_tpu/engine.py, for the slices it covers:
``run_train`` (engine.py:57-238) with its route choice, the whole-run,
selection, stepped, sort-round and sparse routes, checkpoints, progress
and ``profile_dir``;
``train_offsets``/``train_bytes`` (468-484),
``encode_bytes``/``encode_offsets``/``encode_parts`` (322-423) with their
two routes, dense and sorted (``DeviceMergeTable``, 20-47), and the opt-in
device pre-split encode ``encode_text_device_split`` (269-319). A kernel
that fails raises: there is no fallback route.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

from . import trace
from .ops import stream as stream_ops
from .ops import device_presplit, flat_encode
from .ops.encode import DEVICE_SPLIT, check_memory, encode_stream, readback
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


def table_vocab(new_ids) -> int:
    """The vocab a merge table covers: every id an encode can make (its
    largest new id + 1, at least 256)."""
    return 256 if len(new_ids) == 0 else max(256, int(np.max(new_ids)) + 1)


class DeviceMergeTable:
    """Frozen merge table on a device: pairs (int32 (M, 2)) and new_ids
    (int32 (M,)) in rank order, and ``cuckoo``, their cuckoo pair table
    (ops/ranktab.py) on the same tensors, built on its first use.
    ``vocab_size`` covers every id an encode can make; up to
    DENSE_VOCAB_MAX the table is "dense" (K10 reads it rank by rank), above
    it "sorted": the flat encoder's (minbpe_tpu/engine.py:20-47); K17, the
    device split's encoder, looks pairs up in the cuckoo table of either.
    ``byte_ids``, the token id of each byte value (the tokenizer's byte
    transform, the identity by default), goes to the device with the table
    as int32[256]; the device split's K15 writes the stream's ids through
    it."""

    def __init__(self, pairs: np.ndarray, new_ids: np.ndarray, device,
                 byte_ids: np.ndarray = np.arange(256)):
        self.vocab_size = table_vocab(new_ids)
        self.kind = "dense" if self.vocab_size <= DENSE_VOCAB_MAX else "sorted"
        trace.count("sync.engine.table", 3)
        self.pairs, self.new_ids, self.byte_ids = (
            torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32)).to(device)
            for a in (pairs, new_ids, byte_ids))
        self._host = (pairs, new_ids)

    def cuckoo_bytes(self) -> int:
        """The device bytes the cuckoo rows will take: 0 once built."""
        if "cuckoo" in self.__dict__:
            return 0
        return CuckooPairTable.device_bytes(len(self._host[1]))

    @functools.cached_property
    def cuckoo(self) -> CuckooPairTable:
        trace.count("sync.engine.table")  # its rows
        return CuckooPairTable(*self._host, self.pairs.device,
                               uploaded=(self.pairs, self.new_ids))


def device_table(tokenizer) -> DeviceMergeTable:
    """The tokenizer's merge table and byte ids on its device, built once
    until its merges, specials or byte transform change
    (``_invalidate_device_state``)."""
    if tokenizer._dev is None:
        pairs, new_ids = tokenizer._merge_arrays()
        byte_ids = tokenizer._transform_bytes_array(
            np.arange(256, dtype=np.uint8))
        tokenizer._dev = DeviceMergeTable(pairs, new_ids, tokenizer.device,
                                          byte_ids)
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


@contextlib.contextmanager
def _trace(profile_dir: str | None, device):
    """torch.profiler over the run, written into profile_dir by
    tensorboard_trace_handler, with the program's spans on: the
    counterpart of jax.profiler.trace."""
    if profile_dir is None:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(profile_dir)), \
            trace.enabled():
        yield


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

    with trace.span("train.merges"):
        merges: dict[tuple[int, int], int] = {}
        vocab = {idx: bytes([idx]) for idx in range(256)}
        for i in range(num_merges):
            pair = (int(pairs[i, 0]), int(pairs[i, 1]))
            idx = 256 + i
            merges[pair] = idx
            vocab[idx] = vocab[pair[0]] + vocab[pair[1]]
            if verbose:
                print(
                    f"merge {i+1}/{num_merges}: {pair} -> {idx} "
                    f"({vocab[idx]}) had {int(counts[i])} occurrences"
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
    lengths = np.diff(ends, prepend=0)
    check_memory(tokenizer.device, int(data.shape[0]), dev, lengths=lengths)
    ids, seg = stream_ops.build_stream(data, ends, tokenizer.device)
    ids, seg, n = encode_stream(ids, seg, dev, lengths=lengths)
    return readback(ids, n, seg)


def _device_split_mode(tokenizer) -> int | None:
    """The device pre-split's mode (4 GPT-4, 2 GPT-2) where the tokenizer
    splits with a GPT pattern: the scanner mode its constructor fixed
    (``_split_mode``), which load() does not change, where minbpe_tpu reads
    ``pattern`` (engine.py:269-275)."""
    return device_presplit.mode_code(getattr(tokenizer, "_split_mode", None))


def encode_text_device_split(tokenizer, text: str) -> list[int] | None:
    """The whole front half on the device: only the text's raw UTF-8 bytes
    cross to it; the pre-split (K15, ops/device_presplit.py), which also
    writes the ids (the bytes through the table's ``byte_ids``), and the
    encode of each chunk (K17, through the table's cuckoo rows, dense or
    sorted alike) run there, and only the output ids come back. None where
    the configuration does not qualify: ``device_presplit`` not set, or a
    split other than GPT-2's or GPT-4's; the caller then splits on the
    host. (minbpe_tpu declines a sorted table too, engine.py:278-319, as
    only its dense encoder ran on the device's split.) Counts
    ``encode.route.device_split``
    for each text it takes. Raises ValueError for a text past the kernels'
    int32 range and MemoryError where the encode does not fit, the cuckoo
    rows of a table's first encode counted, before any work.

    Opt-in (``tokenizer.device_presplit = True``), as in minbpe_tpu. On the
    CPU it runs the kernels' plain twins."""
    if not getattr(tokenizer, "device_presplit", False):
        return None
    mode = _device_split_mode(tokenizer)
    if mode is None:
        return None
    dev = device_table(tokenizer)
    trace.count("encode.route.device_split")
    with trace.span("api.text_encode"):
        raw = text.encode("utf-8")
    n = len(raw)
    if n == 0:
        return []
    if n > device_presplit.MAX_N:
        raise ValueError(f"{n} bytes: the device pre-split takes at most "
                         f"{device_presplit.MAX_N}")
    device = tokenizer.device
    check_memory(device, n, dev, lengths=DEVICE_SPLIT,
                 split_bytes=device_presplit.BYTES_PER_BYTE)
    with trace.span("engine.upload"):
        trace.count("sync.engine.upload")
        data = torch.frombuffer(bytearray(raw), dtype=torch.uint8).to(device)
    with trace.span("presplit.device"):
        _, seg, ids = device_presplit.presplit_seg_ids(data, n, mode,
                                                       dev.byte_ids)
    ids, _, k = encode_stream(ids, seg, dev, lengths=DEVICE_SPLIT)
    out = readback(ids, k)
    with trace.span("api.to_list"):
        return out.tolist()


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
    ids = _encode_arrays(tokenizer, data, ends)[0]
    with trace.span("api.to_list"):
        return ids.tolist()


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
