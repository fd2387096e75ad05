"""GPT4Tokenizer: the cl100k_base tokenizer (tiktoken's ranks) on the port.

The port's counterpart of minbpe_tpu/gpt4.py, behavior-compatible with the
reference GPT4Tokenizer (minbpe/gpt4.py:57-130): the merge forest is
recovered from tiktoken's ``_mergeable_ranks``, which store only merged
byte sequences (minbpe/gpt4.py:11-46); the historical byte shuffle is
applied to a text's bytes after the split and before BPE, and undone after
decode (minbpe/gpt4.py:76-92); the five GPT-4 special tokens are
registered. Ids are tiktoken's ranks, up to 100,276, so the table takes the
sorted route of engine.DeviceMergeTable (ops/flat_encode.py).

The ranks load from a file only: the ``MINBPE_TPU_CL100K`` path, a
vendored ``data/cl100k_base.tiktoken``, or tiktoken's own cache files
(``TIKTOKEN_CACHE_DIR``, ``DATA_GYM_CACHE_DIR``, ``$TMPDIR/data-gym-cache``).
minbpe_tpu falls back to fetching them with tiktoken; the port raises
instead, so no constructor reaches the network. The recovered forest is
cached as an npz under ``$XDG_CACHE_HOME/minbpe_tpu_torch``.
"""

from __future__ import annotations

import base64
import hashlib
import os

import numpy as np

from .base import id_array, render_token
from .regex import GPT4_SPLIT_PATTERN, RegexTokenizer

GPT4_SPECIAL_TOKENS = {
    "<|endoftext|>": 100257,
    "<|fim_prefix|>": 100258,
    "<|fim_middle|>": 100259,
    "<|fim_suffix|>": 100260,
    "<|endofprompt|>": 100276,
}

_VENDORED = os.path.join(os.path.dirname(__file__), "data",
                         "cl100k_base.tiktoken")
# sha1 of the cl100k blob URL: how tiktoken names its cache files
_TIKTOKEN_CACHE_NAME = hashlib.sha1(
    b"https://openaipublic.blob.core.windows.net/encodings/cl100k_base.tiktoken"
).hexdigest()


def _cache_dir() -> str:
    return os.path.join(
        os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache")),
        "minbpe_tpu_torch")


def _candidate_rank_files():
    yield os.environ.get("MINBPE_TPU_CL100K", "")
    yield _VENDORED
    for cache_root in (
        os.environ.get("TIKTOKEN_CACHE_DIR", ""),
        os.environ.get("DATA_GYM_CACHE_DIR", ""),
        os.path.join(os.environ.get("TMPDIR", "/tmp"), "data-gym-cache"),
    ):
        if cache_root:
            yield os.path.join(cache_root, _TIKTOKEN_CACHE_NAME)


def _find_rank_file() -> str | None:
    for p in _candidate_rank_files():
        if p and os.path.isfile(p):
            return p
    return None


def cl100k_ranks_available() -> bool:
    return _find_rank_file() is not None


def _rank_file() -> str:
    """The first rank file found; RuntimeError where there is none."""
    path = _find_rank_file()
    if path is None:
        raise RuntimeError(
            "cl100k_base ranks unavailable: vendor the file at "
            f"{_VENDORED} or set MINBPE_TPU_CL100K / TIKTOKEN_CACHE_DIR")
    return path


def load_cl100k_ranks(path: str | None = None) -> dict[bytes, int]:
    """token bytes -> rank, from ``path`` or else the first rank file
    found."""
    path = path or _rank_file()
    ranks: dict[bytes, int] = {}
    with open(path, "rb") as f:
        for line in f:
            line = line.strip()
            if line:
                tok_b64, rank_s = line.split()
                ranks[base64.b64decode(tok_b64)] = int(rank_s)
    return ranks


# -- merge forest recovery ---------------------------------------------------

def _split_merged_token(token: bytes, max_rank: int,
                        ranks) -> tuple[bytes, bytes]:
    """The final two children of a merged token: BPE replayed on its bytes
    with the merges of rank < max_rank (minbpe/gpt4.py:11-26)."""
    parts = [token[i:i + 1] for i in range(len(token))]
    while len(parts) > 2:
        best_rank = None
        best_at = -1
        for i in range(len(parts) - 1):
            r = ranks.get(parts[i] + parts[i + 1])
            if (r is not None and r < max_rank
                    and (best_rank is None or r < best_rank)):
                best_rank, best_at = r, i
        if best_at < 0:
            break
        parts[best_at:best_at + 2] = [parts[best_at] + parts[best_at + 1]]
    assert len(parts) == 2, f"token {token!r} did not reduce to a pair"
    return parts[0], parts[1]


def recover_merge_forest(ranks: dict[bytes, int]) -> dict[tuple[int, int],
                                                           int]:
    """(child rank, child rank) -> rank for every multi-byte token
    (minbpe/gpt4.py:29-46)."""
    merges: dict[tuple[int, int], int] = {}
    for token, rank in ranks.items():
        if len(token) < 2:
            continue
        left, right = _split_merged_token(token, rank, ranks)
        merges[(ranks[left], ranks[right])] = rank
    return merges


def _forest_arrays(ranks: dict[bytes, int]):
    """(pairs, new_ids, byte_shuffle) of a ranks table, in rank order."""
    items = sorted(recover_merge_forest(ranks).items(), key=lambda kv: kv[1])
    pairs = np.array([[a, b] for (a, b), _ in items],
                     dtype=np.int32).reshape(-1, 2)
    new_ids = np.array([r for _, r in items], dtype=np.int32)
    byte_shuffle = np.array([ranks[bytes([i])] for i in range(256)],
                            dtype=np.uint8)
    return pairs, new_ids, byte_shuffle


def _load_recovered(path: str):
    """(pairs, new_ids, byte_shuffle) of the rank file at ``path``, from
    the npz cache where it holds them (keyed by the path and its mtime)."""
    cache_dir = _cache_dir()
    os.makedirs(cache_dir, exist_ok=True)
    key = f"{path}:{os.path.getmtime(path)}"
    cache = os.path.join(cache_dir, "cl100k_merges_" + hashlib.sha1(
        key.encode()).hexdigest()[:16] + ".npz")
    if os.path.isfile(cache):
        z = np.load(cache)
        return z["pairs"], z["new_ids"], z["byte_shuffle"]
    pairs, new_ids, byte_shuffle = _forest_arrays(load_cl100k_ranks(path))
    try:
        np.savez(cache, pairs=pairs, new_ids=new_ids,
                 byte_shuffle=byte_shuffle)
    except OSError:
        pass
    return pairs, new_ids, byte_shuffle


class GPT4Tokenizer(RegexTokenizer):
    """Pretrained cl100k_base tokenizer; train, save and load raise
    (minbpe/gpt4.py:95-107)."""

    def __init__(self, device=None):
        """The ranks of the first rank file found (raises RuntimeError
        where there is none); device as in RegexTokenizer."""
        super().__init__(pattern=GPT4_SPLIT_PATTERN, device=device)
        self._init_pretrained(*_load_recovered(_rank_file()),
                              GPT4_SPECIAL_TOKENS)

    @classmethod
    def from_mergeable_ranks(cls, mergeable_ranks: dict[bytes, int],
                             special_tokens: dict[str, int] | None = None,
                             device=None):
        """A tokenizer of any tiktoken-style ranks dict (token bytes ->
        rank): its merge forest and byte shuffle recovered, as __init__
        does for cl100k_base."""
        self = cls.__new__(cls)
        RegexTokenizer.__init__(self, pattern=GPT4_SPLIT_PATTERN,
                                device=device)
        self._init_pretrained(*_forest_arrays(mergeable_ranks),
                              special_tokens or {})
        return self

    def _init_pretrained(self, pairs, new_ids, byte_shuffle, special_tokens):
        self.merges = {(int(a), int(b)): int(r)
                       for (a, b), r in zip(pairs, new_ids)}
        # in shuffled-byte space (minbpe/gpt4.py:68-71)
        vocab = {idx: bytes([idx]) for idx in range(256)}
        for (p0, p1), idx in self.merges.items():
            vocab[idx] = vocab[p0] + vocab[p1]
        self.vocab = vocab
        self.byte_shuffle = np.asarray(byte_shuffle, dtype=np.uint8)
        self.inverse_byte_shuffle = np.argsort(self.byte_shuffle).astype(
            np.uint8)
        self.register_special_tokens(dict(special_tokens))
        self._invalidate_device_state()

    def _transform_bytes_array(self, arr):
        """The byte shuffle (minbpe/gpt4.py:81-83)."""
        return self.byte_shuffle[arr]

    def decode(self, ids) -> str:
        """The vocab's bytes with the shuffle undone (minbpe/gpt4.py:87-92);
        unknown ids, special ones among them, raise KeyError like the
        reference's vocab[idx]. ids: any iterable of ints."""
        ids = id_array(ids)
        data, bad = self._decode_table(self.vocab).lookup(ids)
        if bad >= 0:
            raise KeyError(int(ids[bad]))
        arr = np.frombuffer(data, dtype=np.uint8)
        return self.inverse_byte_shuffle[arr].tobytes().decode(
            "utf-8", errors="replace")

    def train(self, text, vocab_size, verbose=False):
        raise NotImplementedError

    def save(self, file_prefix):
        raise NotImplementedError("GPT4Tokenizer cannot be saved.")

    def load(self, model_file):
        raise NotImplementedError("GPT4Tokenizer cannot be loaded.")

    def save_vocab(self, vocab_file):
        """Display-only vocab dump with the shuffle undone
        (minbpe/gpt4.py:109-130)."""
        vocab = {idx: bytes([int(self.inverse_byte_shuffle[idx])])
                 for idx in range(256)}
        for (p0, p1), idx in self.merges.items():
            vocab[idx] = vocab[p0] + vocab[p1]
        inverted = {idx: pair for pair, idx in self.merges.items()}
        with open(vocab_file, "w", encoding="utf-8") as f:
            for idx, token in vocab.items():
                s = render_token(token)
                if idx in inverted:
                    i0, i1 = inverted[idx]
                    f.write(f"[{render_token(vocab[i0])}]"
                            f"[{render_token(vocab[i1])}] -> [{s}] {idx}\n")
                else:
                    f.write(f"[{s}] {idx}\n")
