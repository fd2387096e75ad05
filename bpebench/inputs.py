"""The benchmark's inputs, made from frozen data and a seed.

Every traffic kind draws its inputs here, so that no seed changes how much
work a run does: a seed only rotates the training text by whole lines, or
moves where each document of a fixed length sequence starts.
"""

from __future__ import annotations

import hashlib

import numpy as np


def rng(seed: int) -> np.random.Generator:
    """The generator of a run's seed: any whole number, negative ones
    taken modulo 2**64 (numpy takes no negative seed)."""
    return np.random.default_rng(seed % 2**64)


def corpus_bytes(path: str, sha256: str) -> bytes:
    """The frozen corpus at ``path``; raises where its sha256 differs."""
    with open(path, "rb") as f:
        data = f.read()
    got = hashlib.sha256(data).hexdigest()
    if got != sha256:
        raise ValueError(f"{path}: sha256 {got}, expected {sha256}")
    return data


def drawn_lines(text: str, min_bytes: int, block: int,
                seed: int) -> list[str]:
    """The corpus's lines drawn with replacement, ``block`` at a time from
    ``numpy.random.default_rng(seed)``, until they hold ``min_bytes``."""
    lines = text.splitlines(keepends=True)
    sizes = np.array([len(line.encode("utf-8")) for line in lines])
    gen = np.random.default_rng(seed)
    picked: list[int] = []
    size = 0
    while size < min_bytes:
        draw = gen.integers(0, len(lines), block)
        picked.extend(draw.tolist())
        size += int(sizes[draw].sum())
    return [lines[k] for k in picked]


def rotated(lines: list[str], seed: int) -> str:
    """The lines joined, starting at a line that ``seed`` picks: the same
    bytes and the same multiset of lines for every seed."""
    k = int(rng(seed).integers(0, len(lines)))
    return "".join(lines[k:] + lines[:k])


def document_lengths(count: int, median: float, sigma: float, low: int,
                     high: int, seed: int) -> np.ndarray:
    """``count`` lognormal byte lengths, clipped to [low, high]: the same
    sequence for every run, as ``seed`` is the traffic's, not the run's."""
    gen = np.random.default_rng(seed)
    raw = gen.lognormal(np.log(median), sigma, count)
    return np.clip(np.rint(raw), low, high).astype(np.int64)


def stratified(lengths: np.ndarray, strata: int, seed: int) -> np.ndarray:
    """The same lengths, in an order in which every block of ``strata``
    consecutive documents holds one from each of ``strata`` equal bands of
    the sorted lengths, in an order ``seed`` (the traffic's) shuffles. So a
    window that stops after any number of blocks has sent about the whole
    sequence's mix, however far a faster or slower run got."""
    n = len(lengths)
    if strata < 1 or n % strata:
        raise ValueError(f"{n} documents do not split into {strata} strata")
    gen = np.random.default_rng(seed)
    bands = np.sort(lengths).reshape(strata, n // strata)
    # each band's documents go to the blocks in an order of its own
    blocks = np.stack([band[gen.permutation(n // strata)] for band in bands],
                      axis=1)
    for block in blocks:
        gen.shuffle(block)
    return blocks.reshape(n)


def document_starts(data: bytes, lengths: np.ndarray, seed: int) -> np.ndarray:
    """A start for each length, uniform over the corpus, such that the
    document begins and ends on a whole UTF-8 character."""
    arr = np.frombuffer(data, dtype=np.uint8)
    # a character starts at every byte that is not 10xxxxxx, and at the end
    boundary = np.append((arr & 0xC0) != 0x80, True)
    gen = rng(seed)
    starts = np.empty(len(lengths), dtype=np.int64)
    for i, n in enumerate(lengths):
        if n > len(data):
            raise ValueError(f"a document of {n} bytes in a corpus of "
                             f"{len(data)}")
        while True:
            s = int(gen.integers(0, len(data) - n + 1))
            if boundary[s] and boundary[s + n]:
                starts[i] = s
                break
    return starts
