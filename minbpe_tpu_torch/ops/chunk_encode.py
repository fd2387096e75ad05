"""Bucketed chunk encoder: every chunk its own lowest-rank loop, a row each.

The port's counterpart of minbpe_tpu/ops/chunk_encode.py:51-264. Chunks are
independent (minbpe/regex.py:96-121 encodes chunk by chunk), so the chunks
of each length bucket (16 .. 8192 bytes, powers of two) are packed into a
[rows, bucket] matrix, rows padded to a power of two of at least 8, and
every round each unfinished row merges all occurrences of its own
lowest-rank pair, left first on runs, then compacts itself stably. The
number of rounds is the most distinct ranks any row applies, whatever the
vocab. Pair ranks come from a ``SortedPairTable`` (ops/ranktab.py); a
chunk longer than the largest bucket goes to
``ops/encode.encode_stream_sorted``.

The row loop is plain PyTorch on the table's device on purpose. The
encoder exists as an independent oracle for the flat encoder
(ops/flat_encode.py: K11 ``chunk_encode`` and K12 ``encode_min_sweep`` on
the card): two implementations of the same per-chunk loop that share no
code check each other. minbpe_tpu's is jnp, not Pallas, and no route of
either package encodes through it.
"""

from __future__ import annotations

import numpy as np
import torch

from .encode import UNROLL, encode_stream_sorted
from .ranktab import RANK_INF, SortedPairTable
from .stream import PAD, pack_bytes

_BUCKETS = [16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192]
MAX_BUCKET = _BUCKETS[-1]


def _bucket_len(n: int) -> int:
    for b in _BUCKETS:
        if n <= b:
            return b
    return -1  # oversized: the stream encoder takes it


def _pad_rows(c: int) -> int:
    r = 8
    while r < c:
        r *= 2
    return r


def _encode_block(ids, lens, table: SortedPairTable):
    """One bucket: ids (C, L) int32 (PAD past lens), lens (C,) int32, on
    the table's device -> the merged rows and their lengths. UNROLL rounds
    go out between reads of the done flag; a round in which no row
    has a pair changes nothing."""
    C, L = ids.shape
    last = table.merge_ids.shape[0] - 1
    pos = torch.arange(L, device=ids.device).expand(C, L)
    while True:
        done = torch.zeros((), dtype=torch.bool, device=ids.device)
        for _ in range(UNROLL):
            # only a row's pairs are looked up (RANK_INF elsewhere)
            valid = pos + 1 < lens[:, None]
            nxt = torch.roll(ids, -1, dims=1)
            ranks = torch.full_like(ids, RANK_INF)
            ranks[valid] = table.lookup(ids[valid], nxt[valid], True)
            rmin = ranks.min(dim=1).values
            done = done | (rmin.min() == RANK_INF)
            active = (rmin != RANK_INF)[:, None]
            match = (ranks == rmin[:, None]) & active
            m_prev = torch.zeros_like(match)
            m_prev[:, 1:] = match[:, :-1]
            run_start = torch.cummax(
                torch.where(match & ~m_prev, pos, -1), dim=1).values
            keep = match & (((pos - run_start) & 1) == 0)
            nid = table.merge_ids[rmin.clamp(max=last).long()][:, None]
            new_ids = torch.where(keep, nid, ids)
            killed = torch.zeros_like(keep)
            killed[:, 1:] = keep[:, :-1]
            alive = ~killed & (pos < lens[:, None])
            # stable per-row compaction: each live token to its rank among
            # the row's live tokens, the dead ones to a spare column
            dest = torch.where(alive, alive.cumsum(dim=1) - 1, L)
            out = torch.full((C, L + 1), PAD, dtype=ids.dtype,
                             device=ids.device)
            ids = out.scatter_(1, dest, new_ids)[:, :L]
            lens = lens - keep.sum(dim=1, dtype=torch.int32)
        if bool(done):
            return ids, lens


def _encode_oversized(chunk: bytes, table: SortedPairTable) -> np.ndarray:
    ids, seg, n = pack_bytes(chunk)
    out, k = encode_stream_sorted(ids, seg, n, table)
    return out[:int(k)].cpu().numpy()


def encode_offsets_arrays(data: np.ndarray, ends: np.ndarray,
                          table: SortedPairTable):
    """Encode from (byte array, chunk-end offsets). Returns (flat int32
    token array in corpus order, int64 per-chunk output lengths); the
    buckets are built and the result assembled with numpy indexing."""
    n_chunks = len(ends)
    if n_chunks == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int64)
    data = np.ascontiguousarray(data)
    ends = np.asarray(ends, dtype=np.int64)
    starts = np.concatenate([[0], ends[:-1]]).astype(np.int64)
    lengths = ends - starts
    chunk_out_len = np.zeros(n_chunks, np.int64)
    bucket_results = []  # (chunk indices, output rows)
    oversized_results = []  # (chunk index, output)

    barr = np.asarray(_BUCKETS, dtype=np.int64)
    bidx = np.searchsorted(barr, lengths, side="left")
    for i in np.nonzero(bidx >= len(barr))[0].tolist():
        arr = _encode_oversized(
            data[starts[i]:ends[i]].astype(np.uint8).tobytes(), table)
        chunk_out_len[i] = len(arr)
        oversized_results.append((i, arr))

    for b in np.unique(bidx[bidx < len(barr)]).tolist():
        L = int(barr[b])
        idxs = np.nonzero((bidx == b) & (lengths > 0))[0]
        if len(idxs) == 0:
            continue
        C = _pad_rows(len(idxs))
        gather = starts[idxs, None] + np.arange(L)[None, :]
        mask = np.arange(L)[None, :] < lengths[idxs, None]
        mat = np.full((C, L), PAD, dtype=np.int32)
        mat[:len(idxs)] = np.where(
            mask, data[np.minimum(gather, len(data) - 1)].astype(np.int32),
            PAD)
        lens = np.zeros((C,), dtype=np.int32)
        lens[:len(idxs)] = lengths[idxs]
        out_ids, out_lens = _encode_block(
            torch.from_numpy(mat).to(table.device),
            torch.from_numpy(lens).to(table.device), table)
        out_ids = out_ids[:len(idxs)].cpu().numpy()
        chunk_out_len[idxs] = out_lens[:len(idxs)].cpu().numpy()
        bucket_results.append((idxs, out_ids))

    out_starts = np.concatenate([[0], np.cumsum(chunk_out_len)])
    flat = np.empty(int(out_starts[-1]), np.int32)
    for idxs, out_ids in bucket_results:
        L = out_ids.shape[1]
        pos = out_starts[idxs][:, None] + np.arange(L)[None, :]
        mask = np.arange(L)[None, :] < chunk_out_len[idxs][:, None]
        flat[pos[mask]] = out_ids[mask]
    for i, arr in oversized_results:
        flat[out_starts[i]:out_starts[i] + len(arr)] = arr
    return flat, chunk_out_len


def encode_offsets(data: np.ndarray, ends: np.ndarray,
                   table: SortedPairTable) -> list[int]:
    """List-of-ints form of encode_offsets_arrays."""
    flat, _ = encode_offsets_arrays(data, ends, table)
    return flat.tolist()


def encode_chunk_list(chunks: list[bytes],
                      table: SortedPairTable) -> list[int]:
    """Encode byte chunks against the table; the concatenated ids in chunk
    order."""
    if not chunks:
        return []
    buckets: dict[int, list[int]] = {}
    for i, c in enumerate(chunks):
        if len(c):
            buckets.setdefault(_bucket_len(len(c)), []).append(i)
    results = {i: _encode_oversized(chunks[i], table).tolist()
               for i in buckets.pop(-1, [])}
    for L, idxs in sorted(buckets.items()):
        C = _pad_rows(len(idxs))
        mat = np.full((C, L), PAD, dtype=np.int32)
        lens = np.zeros((C,), dtype=np.int32)
        for r, i in enumerate(idxs):
            c = chunks[i]
            mat[r, :len(c)] = np.frombuffer(c, dtype=np.uint8)
            lens[r] = len(c)
        out_ids, out_lens = _encode_block(
            torch.from_numpy(mat).to(table.device),
            torch.from_numpy(lens).to(table.device), table)
        out_ids, out_lens = out_ids.cpu().numpy(), out_lens.cpu().numpy()
        for r, i in enumerate(idxs):
            results[i] = out_ids[r, :out_lens[r]].tolist()
    out: list[int] = []
    for i in range(len(chunks)):
        out.extend(results.get(i, []))
    return out
