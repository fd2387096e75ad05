"""RegexTokenizer: BPE with regex pre-splitting and special-token handling.

Behavior-compatible with the reference RegexTokenizer (minbpe/regex.py:22-164)
and with minbpe_tpu's: text is pre-split into chunks by a GPT-style pattern,
merges never cross chunk boundaries, and ``encode`` understands
``allowed_special``. On the device the chunked text is one stream with a
segment id per chunk.

The GPT-2 and GPT-4 patterns split through the port's own scanners (the
native one in csrc/presplit.cpp, else the pure-Python one), so the ``regex``
module is needed only for a custom pattern, and is imported only then. The
special-token split needs only the standard ``re``.
"""

from __future__ import annotations

import re

import numpy as np

from . import engine
from .base import DecodeTable, Tokenizer, id_array
from .utils import native, presplit

# GPT split patterns, as published by tiktoken (minbpe/regex.py:18-19).
GPT2_SPLIT_PATTERN = (
    r"""'(?:[sdmt]|ll|ve|re)| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
)
GPT4_SPLIT_PATTERN = (
    r"""'(?i:[sdmt]|ll|ve|re)|[^\r\n\p{L}\p{N}]?+\p{L}+|\p{N}{1,3}|"""
    r""" ?[^\s\p{L}\p{N}]++[\r\n]*|\s*[\r\n]|\s+(?!\S)|\s+"""
)
_SCANNER_MODES = {GPT4_SPLIT_PATTERN: 4, GPT2_SPLIT_PATTERN: 2}


def _compile_custom(pattern: str):
    """A custom split pattern needs the ``regex`` module (\\p classes,
    possessive quantifiers); raises ImportError where it is missing."""
    import regex

    return regex.compile(pattern)


class RegexTokenizer(Tokenizer):

    def __init__(self, pattern: str | None = None, device=None):
        """pattern overrides the default GPT-4 split pattern
        (minbpe/regex.py:24-34); device as in BasicTokenizer."""
        super().__init__(device)
        self.pattern = GPT4_SPLIT_PATTERN if pattern is None else pattern
        # the split the constructor fixed: a scanner mode, or a compiled
        # custom pattern
        self._split_mode = _SCANNER_MODES.get(self.pattern)
        self.compiled_pattern = (None if self._split_mode is not None
                                 else _compile_custom(self.pattern))
        self.special_tokens: dict[str, int] = {}
        self.inverse_special_tokens: dict[int, str] = {}

    # -- helpers ------------------------------------------------------------
    def _split_arrays(self, text: str):
        """(byte array, chunk-end offsets) for the whole text: the native
        scanner for the two GPT patterns (the pure-Python scanner where no
        C++ compiler exists), else ``regex`` findall.

        The split is the one the constructor fixed, whatever pattern load()
        puts in ``self.pattern`` afterwards: the reference's load() replaces
        ``pattern`` but never ``compiled_pattern`` (minbpe/base.py:140-165),
        so save() writes the loaded pattern back while encode keeps the
        constructor's split. The scanners equal findall with the GPT
        patterns. The chunk ends are found on the raw bytes; the bytes
        then pass through ``_transform_bytes_array``."""
        data = text.encode("utf-8")
        mode = self._split_mode
        if mode is not None:
            ends = native.split_offsets(data, mode)
            if ends is None:
                ends = presplit.split_offsets(text, mode)
        else:
            lengths = [len(c.encode("utf-8"))
                       for c in self.compiled_pattern.findall(text)]
            ends = np.cumsum(np.asarray(lengths, dtype=np.int64))
        return self._transform_bytes_array(
            np.frombuffer(data, dtype=np.uint8)), ends

    def _transform_bytes_array(self, arr):
        """Byte-level preprocessing before BPE, on the uint8 array of a
        text's bytes (minbpe_tpu/regex.py:69-72): the identity here;
        GPT4Tokenizer's byte shuffle."""
        return arr

    # -- training -----------------------------------------------------------
    def train(self, text: str, vocab_size: int, verbose: bool = False,
              **train_opts):
        """Pair counts are summed across chunks each round
        (minbpe/regex.py:36-70); on the device the chunks are one segmented
        stream in corpus order, so counts and tie-breaks match exactly."""
        assert vocab_size >= 256
        num_merges = vocab_size - 256
        data, ends = self._split_arrays(text)
        self.merges, self.vocab = engine.train_offsets(
            data, ends, num_merges, verbose, device=self.device, **train_opts
        )
        self._invalidate_device_state()

    # -- special tokens -----------------------------------------------------
    def register_special_tokens(self, special_tokens: dict[str, int]):
        """str -> int registry (minbpe/regex.py:72-76)."""
        self.special_tokens = special_tokens
        self.inverse_special_tokens = {v: k for k, v in special_tokens.items()}
        self._dtab = None  # decode table includes specials

    # -- decode -------------------------------------------------------------
    def decode(self, ids) -> str:
        """vocab or special lookup per id; unknown ids raise ValueError
        (minbpe/regex.py:78-90); vocab wins over a special on the same id.
        ids: any iterable of ints."""
        if self._dtab is None:
            merged = {
                idx: s.encode("utf-8")
                for idx, s in self.inverse_special_tokens.items()
            }
            merged.update(self.vocab)
            self._dtab = DecodeTable(merged)
        ids = id_array(ids)
        data, bad = self._dtab.lookup(ids)
        if bad >= 0:
            raise ValueError(f"invalid token id: {int(ids[bad])}")
        return data.decode("utf-8", errors="replace")

    # -- encode -------------------------------------------------------------
    def encode_ordinary(self, text: str) -> list[int]:
        """Encode ignoring special tokens (minbpe/regex.py:111-121): the
        whole chunked text is one device stream."""
        data, ends = self._split_arrays(text)
        return engine.encode_offsets(self, data, ends)

    def _resolve_special(self, text: str, allowed_special) -> dict[str, int]:
        """allowed_special semantics per minbpe/regex.py:131-143
        ("all" | "none" | "none_raise" | set)."""
        if allowed_special == "all":
            return self.special_tokens
        if allowed_special == "none":
            return {}
        if allowed_special == "none_raise":
            assert all(token not in text for token in self.special_tokens)
            return {}
        if isinstance(allowed_special, set):
            return {
                k: v for k, v in self.special_tokens.items()
                if k in allowed_special
            }
        raise ValueError(f"allowed_special={allowed_special} not understood")

    def _special_plan(self, text: str, special: dict[str, int], batch: list):
        """Split ``text`` on exact special-token matches; text parts append
        their (byte array, chunk-end offsets) to ``batch``; returns the
        reassembly plan [("s", id) | ("t", batch index)]."""
        plan: list[tuple[str, int]] = []
        if not special:
            data, ends = self._split_arrays(text)
            if len(ends):
                plan.append(("t", len(batch)))
                batch.append((data, ends))
            return plan
        special_pattern = "(" + "|".join(re.escape(k) for k in special) + ")"
        for part in re.split(special_pattern, text):
            if part in special:
                plan.append(("s", special[part]))
            elif part:
                data, ends = self._split_arrays(part)
                if len(ends):
                    plan.append(("t", len(batch)))
                    batch.append((data, ends))
        return plan

    @staticmethod
    def _assemble(plan, encoded) -> list[int]:
        ids: list[int] = []
        for kind, v in plan:
            if kind == "s":
                ids.append(v)
            else:
                ids.extend(encoded[v].tolist())
        return ids

    def encode(self, text: str, allowed_special="none_raise") -> list[int]:
        """Special-token-aware encode; allowed_special semantics per
        minbpe/regex.py:123-164 ("all" | "none" | "none_raise" | set). All
        text parts between specials go through one device stream."""
        special = self._resolve_special(text, allowed_special)
        if not special:
            return self.encode_ordinary(text)
        batch: list = []
        plan = self._special_plan(text, special, batch)
        encoded = engine.encode_parts(self, batch)
        return self._assemble(plan, encoded)

    def encode_batch(self, texts: list[str],
                     allowed_special="none_raise") -> list[list[int]]:
        """Encode many independent documents as one device stream. Result
        ids are exactly ``[self.encode(t, allowed_special) for t in
        texts]``."""
        batch: list = []
        plans = [
            self._special_plan(t, self._resolve_special(t, allowed_special),
                               batch)
            for t in texts
        ]
        encoded = engine.encode_parts(self, batch)
        return [self._assemble(plan, encoded) for plan in plans]
