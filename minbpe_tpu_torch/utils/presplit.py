"""Byte-level pre-split scanners for the GPT-2 / GPT-4 split patterns.

The reference pre-splits with the ``regex`` module (minbpe/regex.py:41,114)
— a general backtracking engine. These scanners are hand-derived recognizers
for the two *fixed* GPT patterns: at each position the pattern alternatives
are tried in order with their exact greedy/possessive/lookahead semantics,
using precomputed Unicode class tables (scripts/gen_unicode_tables.py, with
``regex`` itself as the classification oracle).

Semantics notes (derived from the patterns at minbpe/regex.py:18-19 and
validated by exhaustive differential tests in tests/test_presplit.py):

GPT-4 ``'(?i:[sdmt]|ll|ve|re)|[^\\r\\n\\p{L}\\p{N}]?+\\p{L}+|\\p{N}{1,3}|``
``\\ ?[^\\s\\p{L}\\p{N}]++[\\r\\n]*|\\s*[\\r\\n]|\\s+(?!\\S)|\\s+``
- alternation is ordered (first match wins, not longest);
- the ``?+``/``++`` possessive quantifiers only forbid backtracking, which
  for these patterns means: a consumed optional prefix is never given back;
- ``\\s*[\\r\\n]`` matches the leading whitespace run up to and including its
  LAST CR/LF (backtracking from the right);
- ``\\s+(?!\\S)`` matches a whitespace run minus its final char when a
  non-space follows, or the entire run at end of input.

This is the exactness-critical host fallback; the C++ scanner
(minbpe_tpu_torch/csrc/presplit.cpp) must match it byte for byte. Its
scanners are copies of minbpe_tpu/utils/presplit.py's, which the port may
not import; ``split_offsets`` turns their spans into the byte offsets the
stream build takes.
"""

from __future__ import annotations

import os

import numpy as np

FLAG_L = 1
FLAG_N = 2
FLAG_WS = 4
FLAG_C1 = 8
FLAG_CI_L = 16
FLAG_CI_V = 32
FLAG_CI_E = 64
FLAG_CI_R = 128

_TABLES = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                       "data", "unicode_tables.npz")

_starts: np.ndarray | None = None
_flags: np.ndarray | None = None
_dense: np.ndarray | None = None  # dense flags for the BMP fast path


def _load():
    global _starts, _flags, _dense
    if _starts is None:
        z = np.load(_TABLES)
        _starts = z["starts"]
        _flags = z["flags"]
        ends = np.concatenate([_starts[1:], [0x110000]])
        _dense = np.zeros(0x10000, dtype=np.uint8)
        for s, e, f in zip(_starts, ends, _flags):
            if s >= 0x10000:
                break
            _dense[s:min(e, 0x10000)] = f
    return _starts, _flags, _dense


def flags_array(text: str) -> np.ndarray:
    """Vectorized per-char class flags for a whole string."""
    starts, flags, dense = _load()
    cps = np.frombuffer(text.encode("utf-32-le"), dtype=np.uint32)
    out = np.empty(len(cps), dtype=np.uint8)
    bmp = cps < 0x10000
    out[bmp] = dense[cps[bmp]]
    hi = ~bmp
    if hi.any():
        idx = np.searchsorted(starts, cps[hi], side="right") - 1
        out[hi] = flags[idx]
    return out


def _is(f, bit):
    return (f & bit) != 0


def split_gpt4_spans(text: str) -> list[tuple[int, int]]:
    """Chunk spans (start, end) in codepoint indices for the GPT-4 pattern."""
    n = len(text)
    F = flags_array(text)
    spans = []
    i = 0
    while i < n:
        c = text[i]
        f = F[i]
        j = -1
        # P1: '(?i:[sdmt]|ll|ve|re)
        if c == "'" and i + 1 < n:
            f1 = F[i + 1]
            if _is(f1, FLAG_C1):
                j = i + 2
            elif i + 2 < n:
                f2 = F[i + 2]
                if (_is(f1, FLAG_CI_L) and _is(f2, FLAG_CI_L)) or \
                   (_is(f1, FLAG_CI_V) and _is(f2, FLAG_CI_E)) or \
                   (_is(f1, FLAG_CI_R) and _is(f2, FLAG_CI_E)):
                    j = i + 3
        # P2: [^\r\n\p{L}\p{N}]?+ \p{L}+
        if j < 0:
            if _is(f, FLAG_L):
                k = i + 1
                while k < n and _is(F[k], FLAG_L):
                    k += 1
                j = k
            elif c not in "\r\n" and not _is(f, FLAG_N):
                # optional prefix consumed possessively; letters must follow
                if i + 1 < n and _is(F[i + 1], FLAG_L):
                    k = i + 2
                    while k < n and _is(F[k], FLAG_L):
                        k += 1
                    j = k
        # P3: \p{N}{1,3}
        if j < 0 and _is(f, FLAG_N):
            k = i + 1
            while k < n and k < i + 3 and _is(F[k], FLAG_N):
                k += 1
            j = k
        # P4: " "? [^\s\p{L}\p{N}]++ [\r\n]*
        if j < 0:
            k = i + 1 if (c == " " and i + 1 < n) else i
            if k < n and not _is(F[k], FLAG_WS | FLAG_L | FLAG_N):
                k += 1
                while k < n and not _is(F[k], FLAG_WS | FLAG_L | FLAG_N):
                    k += 1
                while k < n and text[k] in "\r\n":
                    k += 1
                j = k
        # P5/P6/P7: whitespace families
        if j < 0 and _is(f, FLAG_WS):
            k = i + 1
            while k < n and _is(F[k], FLAG_WS):
                k += 1
            # P5: \s*[\r\n] -> run up to & incl. its last CR/LF
            last_nl = -1
            for m in range(k - 1, i - 1, -1):
                if text[m] in "\r\n":
                    last_nl = m
                    break
            if last_nl >= 0:
                j = last_nl + 1
            elif k == n:      # P6 at end of input: whole run
                j = k
            elif k - i >= 2:  # P6: run minus final char
                j = k - 1
            else:             # P7: single whitespace char
                j = k
        if j < 0:
            raise AssertionError(
                f"gpt4 scanner: no alternative matched at {i} ({c!r})"
            )
        spans.append((i, j))
        i = j
    return spans


def split_gpt2_spans(text: str) -> list[tuple[int, int]]:
    """Chunk spans for the GPT-2 pattern
    ``'(?:[sdmt]|ll|ve|re)| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|``
    ``\\s+(?!\\S)|\\s+`` (case-sensitive contractions, unbounded digit runs,
    a plain-space optional prefix, no CR/LF specials)."""
    n = len(text)
    F = flags_array(text)
    spans = []
    i = 0
    while i < n:
        c = text[i]
        f = F[i]
        j = -1
        # Q1: '([sdmt]|ll|ve|re) exact case
        if c == "'" and i + 1 < n:
            nxt2 = text[i + 1:i + 3]
            if text[i + 1] in "sdmt":
                j = i + 2
            elif nxt2 in ("ll", "ve", "re"):
                j = i + 3
        # Q2: " "? \p{L}+
        if j < 0:
            k = i + 1 if c == " " else i
            if k < n and _is(F[k], FLAG_L):
                k += 1
                while k < n and _is(F[k], FLAG_L):
                    k += 1
                j = k
        # Q3: " "? \p{N}+
        if j < 0:
            k = i + 1 if c == " " else i
            if k < n and _is(F[k], FLAG_N):
                k += 1
                while k < n and _is(F[k], FLAG_N):
                    k += 1
                j = k
        # Q4: " "? [^\s\p{L}\p{N}]+
        if j < 0:
            k = i + 1 if c == " " else i
            if k < n and not _is(F[k], FLAG_WS | FLAG_L | FLAG_N):
                k += 1
                while k < n and not _is(F[k], FLAG_WS | FLAG_L | FLAG_N):
                    k += 1
                j = k
        # Q5/Q6: \s+(?!\S) | \s+
        if j < 0 and _is(f, FLAG_WS):
            k = i + 1
            while k < n and _is(F[k], FLAG_WS):
                k += 1
            if k == n:
                j = k
            elif k - i >= 2:
                j = k - 1
            else:
                j = k
        if j < 0:
            raise AssertionError(
                f"gpt2 scanner: no alternative matched at {i} ({c!r})"
            )
        spans.append((i, j))
        i = j
    return spans


def split_gpt4(text: str) -> list[str]:
    return [text[a:b] for a, b in split_gpt4_spans(text)]


def split_gpt2(text: str) -> list[str]:
    return [text[a:b] for a, b in split_gpt2_spans(text)]


def split_offsets(text: str, mode: int) -> np.ndarray:
    """Chunk-end UTF-8 byte offsets (int64) for mode 4 (GPT-4) or 2 (GPT-2):
    the pure-Python form of the native scanner's output."""
    spans = split_gpt4_spans(text) if mode == 4 else split_gpt2_spans(text)
    if not spans:
        return np.zeros(0, dtype=np.int64)
    cps = np.frombuffer(text.encode("utf-32-le"), dtype=np.uint32)
    nbytes = (1 + (cps >= 0x80) + (cps >= 0x800)
              + (cps >= 0x10000)).astype(np.int64)
    byte_end = np.cumsum(nbytes)
    return byte_end[np.asarray([e for _, e in spans], dtype=np.int64) - 1]
