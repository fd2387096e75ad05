"""Deterministic synthetic tiktoken-style ranks tables at cl100k scale.

The port's copy of minbpe_tpu/utils/synthranks.py: the same tables from the
same (n_ranks, seed), made without JAX, so the machine with the card builds
them too.

The real external conformance anchor for GPT4Tokenizer is the cl100k_base
ranks file (reference minbpe/gpt4.py:63), which cannot be fetched offline.
This module fabricates a *structurally equivalent* table — a byte-permuted
base vocabulary plus ~100K merged tokens — so the full GPT-4 machinery
(merge-forest recovery at gpt4.py:102-130, byte shuffle, sorted-route
encode, decode un-shuffle) can be exercised and benchmarked end-to-end at
true cl100k scale, hermetically and reproducibly.

Construction: token for rank r is the concatenation of two already-existing
tokens chosen by a seeded PRNG. Each candidate is kept only if BPE replay of
its bytes with ranks < r (the exact recovery procedure of reference
minbpe/gpt4.py:11-26) reduces to precisely the chosen children — the
invariant real BPE-trained tables satisfy by construction. Rejected
candidates are re-drawn, so the table is deterministic given (n_ranks, seed).
"""

from __future__ import annotations

import random

from ..gpt4 import _split_merged_token


def synthetic_ranks(n_ranks: int, seed: int = 0, max_token_len: int = 12,
                    special_tokens: dict[str, int] | None = None):
    """Build a tiktoken-style ``{token_bytes: rank}`` dict with ``n_ranks``
    entries (256 permuted single bytes + n_ranks-256 merged tokens), plus the
    intended merge forest ``{(child_rank, child_rank): rank}`` for equality
    checks against ``recover_merge_forest``."""
    assert n_ranks > 256
    rng = random.Random(seed)
    perm = list(range(256))
    rng.shuffle(perm)  # raw byte value b gets rank perm[b]

    by_rank: list[bytes] = [b""] * 256
    for b, r in enumerate(perm):
        by_rank[r] = bytes([b])
    ranks: dict[bytes, int] = {bytes([b]): perm[b] for b in range(256)}
    intended: dict[tuple[int, int], int] = {}

    for r in range(256, n_ranks):
        while True:
            a = rng.randrange(r)
            b = rng.randrange(r)
            tok = by_rank[a] + by_rank[b]
            if len(tok) > max_token_len or tok in ranks:
                continue
            # keep only replay-consistent candidates: recovery must find the
            # same children the generator intended
            ranks[tok] = r  # tentatively, so _split sees a complete dict
            try:
                left, right = _split_merged_token(tok, r, ranks)
            except AssertionError:
                del ranks[tok]
                continue
            if left != by_rank[a] or right != by_rank[b]:
                del ranks[tok]
                continue
            by_rank.append(tok)
            intended[(a, b)] = r
            break

    if special_tokens is None:
        special_tokens = {f"<|special{k}|>": n_ranks + k for k in range(5)}
    return ranks, intended, special_tokens
