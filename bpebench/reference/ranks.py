"""A tiktoken-style ranks table, as minbpe's GPT4Tokenizer reads one, and
minbpe's lowest-rank encode over many chunks at once, in PyTorch.

- The file (tiktoken's format): one line a token, its bytes in base64, a
  space, its rank. Decoded here by hand, so that the reference needs no
  module beyond the standard ones it already uses.
- The merge forest (minbpe/gpt4.py:11-46): each token of two or more bytes
  is the merge of the two parts that minbpe's BPE, replayed on its bytes
  with the ranks below its own, leaves; its rank is its id.
- The byte shuffle (minbpe/gpt4.py:68-71, 81-83): byte b enters the
  encoder as the rank of the one-byte token ``bytes([b])``.
- Encoding (minbpe/regex.py:96-108): each chunk merges every site of its
  present pair of lowest rank, left to right without overlap, until it has
  none. Here every chunk takes its round at once: each round looks every
  adjacent pair's rank up by ``searchsorted`` over the sorted pair keys,
  takes each chunk's least, and merges it. The rounds follow the longest
  chunk, not the table: a sweep in rank order (``bpe.encode``) would make
  100,000 passes.

``order="right"`` takes a run's sites from its right end instead, as in
``bpe.merge_sites``: the benchmark's control.
"""

from __future__ import annotations

import torch

RANK_INF = 2**62
_B64 = {c: i for i, c in enumerate(
    "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/")}


def b64decode(s: str) -> bytes:
    """Standard base64 (RFC 4648, padded or not) to bytes."""
    s = s.rstrip("=")
    v = 0
    for c in s:
        v = (v << 6) | _B64[c]
    n = 6 * len(s) // 8
    return (v >> (6 * len(s) - 8 * n)).to_bytes(n, "big")


def read_tiktoken(path: str) -> dict[bytes, int]:
    """token bytes -> rank, from a file in tiktoken's format."""
    ranks: dict[bytes, int] = {}
    with open(path, encoding="ascii") as f:
        for line in f:
            if line.strip():
                tok, rank = line.split()
                ranks[b64decode(tok)] = int(rank)
    return ranks


def split_token(token: bytes, max_rank: int,
                ranks: dict[bytes, int]) -> tuple[bytes, bytes] | None:
    """The two parts BPE leaves of ``token``, replayed on its bytes with the
    ranks below ``max_rank`` (minbpe/gpt4.py:11-26); None where it does not
    come down to two."""
    parts = [token[i:i + 1] for i in range(len(token))]
    while len(parts) > 2:
        best, at = None, -1
        for i in range(len(parts) - 1):
            r = ranks.get(parts[i] + parts[i + 1])
            if r is not None and r < max_rank and (best is None or r < best):
                best, at = r, i
        if at < 0:
            return None
        parts[at:at + 2] = [parts[at] + parts[at + 1]]
    return (parts[0], parts[1]) if len(parts) == 2 else None


def recover_forest(ranks: dict[bytes, int]) -> dict[tuple[int, int], int]:
    """(rank of the left part, rank of the right part) -> rank, for every
    token of two or more bytes (minbpe/gpt4.py:29-46)."""
    merges: dict[tuple[int, int], int] = {}
    for token, rank in ranks.items():
        if len(token) < 2:
            continue
        parts = split_token(token, rank, ranks)
        if parts is None:
            raise ValueError(f"token {token!r} does not come down to a pair")
        merges[(ranks[parts[0]], ranks[parts[1]])] = rank
    return merges


def byte_shuffle(ranks: dict[bytes, int]) -> list[int]:
    """The id each byte value enters the encoder as."""
    return [ranks[bytes([b])] for b in range(256)]


class MergeTable:
    """Merges (a, b) -> new id, each with its rank (the lower merges
    first), sorted by the key a * base + b for ``searchsorted``."""

    def __init__(self, pairs, new_ids, ranks, device):
        pairs = torch.as_tensor(pairs, dtype=torch.long).reshape(-1, 2)
        new_ids = torch.as_tensor(new_ids, dtype=torch.long).reshape(-1)
        ranks = torch.as_tensor(ranks, dtype=torch.long).reshape(-1)
        top = max([255] + [int(t.max()) for t in (pairs, new_ids)
                           if t.numel()])
        self.base = top + 1
        keys = pairs[:, 0] * self.base + pairs[:, 1]
        keys, order = torch.sort(keys)
        self.keys = keys.to(device)
        self.rank = ranks[order].to(device)
        self.new_id = new_ids[order].to(device)

    @classmethod
    def of_forest(cls, forest: dict[tuple[int, int], int], device):
        """A GPT-4 style forest, whose ranks are its ids."""
        pairs = list(forest)
        ids = [forest[p] for p in pairs]
        return cls(pairs, ids, ids, device)

    @classmethod
    def of_merges(cls, merges, device):
        """minbpe's merges in rank order: the one of rank r makes 256 + r."""
        n = len(merges)
        return cls(list(merges), range(256, 256 + n), range(n), device)


def _sites(site, order: str):
    """The positions of ``site`` (bool, a pair's left token) to merge: in a
    run of sites that follow each other (a run of one token) every other
    one, from the run's left end, or its right end with ``order="right"``."""
    pos = torch.nonzero(site).flatten()
    if pos.numel() < 2:
        return pos
    k = torch.arange(pos.numel(), device=pos.device)
    starts = torch.ones(pos.numel(), dtype=torch.bool, device=pos.device)
    starts[1:] = pos[1:] != pos[:-1] + 1
    first = torch.cummax(torch.where(starts, k, 0), 0).values
    offset = k - first
    if order == "right":
        run = torch.cumsum(starts.long(), 0) - 1
        offset = torch.bincount(run)[run] - 1 - offset
    elif order != "left":
        raise ValueError(f"order {order!r}")
    return pos[offset % 2 == 0]


def encode(ids, seg, table: MergeTable, order: str = "left",
           applied: list | None = None):
    """(ids, seg) after each chunk (a run of equal ``seg``, int64) has
    merged its present pair of lowest rank until it has none; ``applied``,
    where given, gets each round's (seg, rank) of every merge made."""
    ids, seg = ids.long(), seg.long()
    n_seg = int(seg.max()) + 1 if seg.numel() else 0
    last = table.keys.numel() - 1
    while ids.numel() >= 2 and last >= 0:
        key = ids[:-1] * table.base + ids[1:]
        at = torch.searchsorted(table.keys, key).clamp_(max=last)
        hit = (table.keys[at] == key) & (seg[:-1] == seg[1:])
        rank = torch.where(hit, table.rank[at], RANK_INF)
        least = torch.full((n_seg,), RANK_INF, dtype=torch.long,
                           device=ids.device).scatter_reduce_(
            0, seg[:-1], rank, "amin")
        site = hit & (rank == least[seg[:-1]])
        if not bool(site.any()):
            break
        pos = _sites(site, order)
        if applied is not None:
            applied.append((seg[pos], rank[pos]))
        ids = ids.clone()
        ids[pos] = table.new_id[at[pos]]
        keep = torch.ones(ids.numel(), dtype=torch.bool, device=ids.device)
        keep[pos + 1] = False
        ids, seg = ids[keep], seg[keep]
    return ids, seg
