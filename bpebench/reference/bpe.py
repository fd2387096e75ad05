"""Plain byte-level BPE, as minbpe defines it, in PyTorch on any device.

The text is one flat stream of token ids, each with the id of the chunk it
lies in (a BasicTokenizer's text is one chunk; a RegexTokenizer's chunks
are its pre-split). A pair never spans two chunks.

- Training (minbpe/basic.py:20-49, regex.py:36-70): each round counts
  every adjacent pair, overlapping ones included, takes the largest count,
  ties going to the pair that occurs first in the stream (the first
  maximal key of the dict minbpe builds in stream order), and merges it.
- Encoding (minbpe/basic.py:57-74): minbpe merges the present pair of
  lowest rank until none is left. A merge only makes pairs that hold its
  new id, whose ranks are higher, so applying every merge once in rank
  order gives the same ids.
- A merge replaces the pair's sites left to right, without overlap: in a
  run ``x x x`` merging ``(x, x)`` takes the first two.

``order="right"`` takes a run's sites from its right end instead. That
breaks the last guarantee, and serves as the benchmark's control.
"""

from __future__ import annotations

import torch


def stream(chunks: list[bytes], device) -> tuple[torch.Tensor, torch.Tensor]:
    """(ids, seg): the chunks' bytes as int64 ids, and each one's chunk."""
    data = b"".join(chunks)
    ids = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(
        device).long() if data else torch.zeros(0, dtype=torch.long,
                                                device=device)
    lens = torch.tensor([len(c) for c in chunks], dtype=torch.long)
    seg = torch.repeat_interleave(torch.arange(len(chunks)), lens)
    return ids, seg.to(device)


def merge_sites(ids, seg, a: int, b: int, order: str = "left"):
    """The positions of the left token of each site where ``(a, b)`` is
    merged, in order."""
    m = (ids[:-1] == a) & (ids[1:] == b) & (seg[:-1] == seg[1:])
    pos = torch.nonzero(m).flatten()
    if a != b or pos.numel() < 2:
        return pos
    # sites that follow each other overlap: number each run of them
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


def merge(ids, seg, a: int, b: int, new: int, order: str = "left"):
    """(ids, seg) with every site of ``(a, b)`` replaced by ``new``."""
    pos = merge_sites(ids, seg, a, b, order)
    if pos.numel() == 0:
        return ids, seg
    ids = ids.clone()
    ids[pos] = new
    keep = torch.ones(ids.numel(), dtype=torch.bool, device=ids.device)
    keep[pos + 1] = False
    return ids[keep], seg[keep]


def train(ids, seg, num_merges: int, order: str = "left"):
    """The merges, a list of pairs in rank order (new id 256 + rank); fewer
    than ``num_merges`` where the stream runs out of pairs."""
    vocab = 256 + num_merges
    merges: list[tuple[int, int]] = []
    for r in range(num_merges):
        valid = seg[:-1] == seg[1:]
        key = (ids[:-1] * vocab + ids[1:])[valid]
        if key.numel() == 0:
            break
        count = torch.bincount(key, minlength=vocab * vocab)
        best = count.max()
        # the first site in the stream of a pair with the largest count
        first = torch.nonzero(count[key] == best)[0, 0]
        a, b = divmod(int(key[first]), vocab)
        merges.append((a, b))
        ids, seg = merge(ids, seg, a, b, 256 + r, order)
    return merges


def encode(ids, seg, merges, order: str = "left"):
    """(ids, seg) after every merge of ``merges`` (pairs in rank order) is
    applied in rank order."""
    for r, (a, b) in enumerate(merges):
        ids, seg = merge(ids, seg, a, b, 256 + r, order)
    return ids, seg


def read_model(path: str) -> list[tuple[int, int]]:
    """The merges of a ``minbpe v1`` .model file with no special tokens
    (minbpe/base.py:140-165)."""
    with open(path, encoding="utf-8") as f:
        if f.readline().strip() != "minbpe v1":
            raise ValueError(f"{path}: not a minbpe v1 model")
        f.readline()
        if int(f.readline()) != 0:
            raise ValueError(f"{path}: special tokens")
        return [tuple(map(int, line.split())) for line in f]


def write_model(path: str, pattern: str, merges) -> None:
    """A ``minbpe v1`` .model file (minbpe/base.py:97-138), no specials."""
    with open(path, "w", encoding="utf-8") as f:
        f.write(f"minbpe v1\n{pattern}\n0\n")
        for a, b in merges:
            f.write(f"{a} {b}\n")
