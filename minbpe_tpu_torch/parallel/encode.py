"""Chunk-sharded encode over torch.distributed.

The port of minbpe_tpu/parallel/encode.py. Regex chunks are independent
(merges never cross chunk ends), so each rank encodes its chunk-aligned
shard of the corpus (``train.shard_offsets``: JAX's layout) with no halo,
in one launch against the replicated dense merge table
(``ops/encode.encode_stream``, which picks the kernel from the shard's
chunk lengths).
The ranks' outputs, gathered in rank order, concatenate to exactly
``tokenizer.encode_ordinary(text)``.

Only the dense table (vocab <= engine.DENSE_VOCAB_MAX) is taken; a larger
one raises, as no V x V table is built here. ``encode_text_distributed``
splits the text with the tokenizer's own ``_split_arrays``, which applies
its byte transform (GPT4Tokenizer's shuffle), so it equals
``encode_ordinary`` for every tokenizer.
"""

from __future__ import annotations

import numpy as np
import torch

from ..engine import DENSE_VOCAB_MAX, DeviceMergeTable, table_vocab
from ..ops.encode import check_memory, encode_stream
from .comm import Comm
from .train import shard_chunks, shard_offsets


def _encode_sharded(comm: Comm, ids, seg, lens, merge_pairs, merge_ids):
    """This rank's shard encoded, the outputs of all ranks gathered in
    rank order (numpy int32)."""
    merge_pairs = np.asarray(merge_pairs, np.int32).reshape(-1, 2)
    merge_ids = np.asarray(merge_ids, np.int32)
    V = table_vocab(merge_ids)
    if V > DENSE_VOCAB_MAX:
        raise ValueError(f"the sharded encode takes a dense table (vocab <= "
                         f"{DENSE_VOCAB_MAX}); this one has vocab {V}")
    D, r = comm.size, comm.rank
    Nl = ids.shape[0] // D
    n = int(lens[r])
    dev = comm.device
    mine = seg[r * Nl:r * Nl + n]
    cuts = np.flatnonzero(mine[1:] != mine[:-1]) + 1
    lengths = np.diff(cuts, prepend=0, append=n)
    check_memory(dev, n, len(merge_ids), lengths=lengths)
    mine_ids = torch.from_numpy(ids[r * Nl:r * Nl + n]).to(dev)
    mine_seg = torch.from_numpy(mine).to(dev)
    if n:
        table = DeviceMergeTable(merge_pairs, merge_ids, dev)
        out, _, k = encode_stream(mine_ids, mine_seg, table,
                                 lengths=lengths)
        out = out[:int(k.item())]
    else:
        out = mine_ids
    return comm.gather_varlen(out).cpu().numpy()


def encode_chunks_distributed(chunks: list[bytes], merge_pairs, merge_ids,
                              group=None, *, device=None) -> np.ndarray:
    """Encode pre-split chunks across the group's ranks; int32 token ids
    equal to the single-device stream encode, on every rank
    (minbpe_tpu/parallel/encode.py:92-122)."""
    comm = Comm(group, device)
    if not chunks:
        return np.zeros(0, np.int32)
    ids, seg, lens = shard_chunks(chunks, comm.size)
    return _encode_sharded(comm, ids, seg, lens, merge_pairs, merge_ids)


def encode_text_distributed(tokenizer, text: str, group=None, *,
                            device=None, comm: Comm | None = None
                            ) -> list[int]:
    """The sharded encode through a tokenizer's split, byte transform and
    merge table (special tokens ignored, as encode_ordinary); equal to
    ``tokenizer.encode_ordinary(text)`` (minbpe_tpu/parallel/encode.py
    :125-137, which skipped the byte transform). ``comm`` as in
    train.train_chunks_distributed."""
    comm = comm if comm is not None else Comm(group, device)
    if not text:
        return []
    data, ends = tokenizer._split_arrays(text)
    ids, seg, lens = shard_offsets(data, ends, comm.size)
    pairs, new_ids = tokenizer._merge_arrays()
    return _encode_sharded(comm, ids, seg, lens, pairs, new_ids).tolist()
