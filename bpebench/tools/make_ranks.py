"""Write the stand-in for cl100k_base's ranks that the gpt4-cl100k
configuration encodes with.

    python3 bpebench/tools/make_ranks.py

The real ``cl100k_base.tiktoken`` is not in the repository. Random merges
at its width (``synthetic_ranks``) would leave the corpus almost unmerged,
where cl100k takes about 4 bytes a token. So the stand-in has cl100k's
widths (100,256 ranks: 256 one-byte tokens in a shuffled order, then
100,000 merges, ids up to 100,255) and a real table's merge depth:

1. The plain reference trains on the frozen corpus's GPT-4 chunks until
   no pair is left (each chunk then one token), capped at 100,000 merges:
   minbpe's training (``bpe.train``'s rules: the largest count, ties to the
   pair that occurs first), counted over the distinct chunks, each
   weighted by how often it occurs, with ``torch.unique``.
2. A merge is kept only where a ranks file can hold it: its bytes are no
   earlier token's, and the forest's recovery (``ranks.split_token``)
   gives its own two parts back.
3. Seeded random merges of two earlier tokens fill the table to 100,256
   ranks, kept under the same test (``synthetic_ranks``' construction).
4. A seeded permutation gives each byte value its one-byte token's rank.

The file is written in tiktoken's format (base64 token, rank), and beside
it the same merges as a ``minbpe v1`` model (the pairs of ranks, in rank
order) with no special tokens. The five specials are the tokenizer's own
(100257-100260, 100276), as tiktoken adds them to cl100k's file. A few
minutes on a CPU.
"""

import base64
import hashlib
import json
import os
import random
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from bpebench import inputs  # noqa: E402
from bpebench.reference import bpe, ranks as rk, split  # noqa: E402

CONFIG = "bpebench/configs-ranks/gpt4-cl100k.json"
N_RANKS = 100_256
SEED = 100_256
# the longest filler token, as synthetic_ranks makes them
FILLER_MAX_BYTES = 12


def train_exhaustive(chunks: list[bytes], max_merges: int):
    """minbpe's merges of ``chunks`` (rank order, new id 256 + rank) until
    no chunk has a pair or ``max_merges`` are made."""
    count: dict[bytes, int] = {}
    for c in chunks:
        count[c] = count.get(c, 0) + 1
    distinct = list(count)  # in the order of first occurrence
    ids, seg = bpe.stream(distinct, "cpu")
    weight = torch.tensor([count[c] for c in distinct], dtype=torch.long)
    base = 256 + max_merges
    merges: list[tuple[int, int]] = []
    for r in range(max_merges):
        if r % 64 == 0:  # drop the chunks that are one token
            size = torch.bincount(seg, minlength=len(distinct))
            keep = size[seg] >= 2
            ids, seg = ids[keep], seg[keep]
        valid = seg[:-1] == seg[1:]
        if not bool(valid.any()):
            break
        pos = torch.nonzero(valid).flatten()
        key = ids[pos] * base + ids[pos + 1]
        uniq, inv = torch.unique(key, return_inverse=True)
        cnt = torch.zeros(uniq.numel(), dtype=torch.long).scatter_add_(
            0, inv, weight[seg[pos]])
        # the stream's order of first sites is the distinct chunks' order
        first = torch.full((uniq.numel(),), pos.numel(),
                           dtype=torch.long).scatter_reduce_(
            0, inv, torch.arange(pos.numel()), "amin")
        best = torch.where(cnt == cnt.max(), first, pos.numel()).argmin()
        a, b = divmod(int(uniq[best]), base)
        merges.append((a, b))
        ids, seg = bpe.merge(ids, seg, a, b, 256 + r)
    return merges


def _admit(ranks: dict, by_rank: list, left: bytes, right: bytes) -> bool:
    """Give left + right the next rank where a ranks file can hold it as
    the merge of those two parts."""
    tok = left + right
    if tok in ranks:
        return False
    rank = len(by_rank)
    ranks[tok] = rank
    if rk.split_token(tok, rank, ranks) != (left, right):
        del ranks[tok]
        return False
    by_rank.append(tok)
    return True


def standin_ranks(text: str, n_ranks: int, seed: int,
                  max_trained: int | None = None):
    """(ranks, trained): a ranks dict (token bytes -> rank) of ``n_ranks``
    entries, the first merges trained on ``text`` under the GPT-4 split
    (at most ``max_trained``), the rest seeded filler; ``trained``, how many
    of its merges were trained."""
    rng = random.Random(seed)
    perm = list(range(256))
    rng.shuffle(perm)
    by_rank = [b""] * 256
    for b, r in enumerate(perm):
        by_rank[r] = bytes([b])
    ranks = {bytes([b]): perm[b] for b in range(256)}
    room = n_ranks - 256 if max_trained is None else min(max_trained,
                                                         n_ranks - 256)
    merges = train_exhaustive([c.encode("utf-8") for c in split.split(text)],
                              room)
    vocab = [bytes([b]) for b in range(256)]
    kept = [True] * 256
    for a, b in merges:
        ok = kept[a] and kept[b] and _admit(ranks, by_rank, vocab[a],
                                            vocab[b])
        vocab.append(vocab[a] + vocab[b])
        kept.append(ok)
    trained = len(by_rank) - 256
    while len(by_rank) < n_ranks:
        left = by_rank[rng.randrange(len(by_rank))]
        right = by_rank[rng.randrange(len(by_rank))]
        if len(left) + len(right) <= FILLER_MAX_BYTES:
            _admit(ranks, by_rank, left, right)
    return ranks, trained


def tiktoken_text(ranks: dict[bytes, int]) -> str:
    return "".join(f"{base64.b64encode(t).decode('ascii')} {r}\n"
                   for t, r in sorted(ranks.items(), key=lambda kv: kv[1]))


def main():
    with open(os.path.join(ROOT, CONFIG)) as f:
        config = json.load(f)
    text = inputs.corpus_bytes(os.path.join(ROOT, config["corpus"]),
                               config["corpus_sha256"]).decode("utf-8")
    ranks, trained = standin_ranks(text, N_RANKS, SEED)
    data = tiktoken_text(ranks).encode("ascii")
    with open(os.path.join(ROOT, config["ranks"]), "wb") as f:
        f.write(data)
    forest = rk.recover_forest(ranks)
    pairs = sorted(forest, key=forest.get)
    bpe.write_model(os.path.join(ROOT, config["merges"]),
                    split.GPT4_SPLIT_PATTERN, pairs)
    print(config["ranks"], len(ranks), "ranks,", trained, "merges trained,",
          N_RANKS - 256 - trained, "filler; sha256",
          hashlib.sha256(data).hexdigest())


if __name__ == "__main__":
    main()
