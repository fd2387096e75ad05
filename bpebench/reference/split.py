"""The GPT-4 pre-split in the standard library's ``re``.

minbpe splits with the third-party ``regex`` module and the pattern
``GPT4_SPLIT_PATTERN``. Python 3.11's ``re`` has the possessive quantifiers
that pattern uses, but not the Unicode property classes, so each of
``\\p{L}``, ``\\p{N}``, ``\\s`` and ``\\S`` is written out here as an
explicit class from ``unicodedata``: letters are the categories L*, numbers
N*, and whitespace the Unicode White_Space property, as ``regex`` has it
(``re``'s own ``\\s`` would also take U+001C-U+001F).
"""

from __future__ import annotations

import functools
import re
import sys
import unicodedata

GPT4_SPLIT_PATTERN = (
    r"""'(?i:[sdmt]|ll|ve|re)|[^\r\n\p{L}\p{N}]?+\p{L}+|\p{N}{1,3}|"""
    r""" ?[^\s\p{L}\p{N}]++[\r\n]*|\s*[\r\n]|\s+(?!\S)|\s+"""
)

# the Unicode White_Space property
_WHITE_SPACE = ([(0x09, 0x0D), (0x20, 0x20), (0x85, 0x85), (0xA0, 0xA0),
                 (0x1680, 0x1680), (0x2000, 0x200A), (0x2028, 0x2029),
                 (0x202F, 0x202F), (0x205F, 0x205F), (0x3000, 0x3000)])


def _ranges(prefix: str) -> list[tuple[int, int]]:
    """Code-point ranges whose general category starts with ``prefix``."""
    out: list[tuple[int, int]] = []
    for cp in range(sys.maxunicode + 1):
        if unicodedata.category(chr(cp)).startswith(prefix):
            if out and out[-1][1] == cp - 1:
                out[-1] = (out[-1][0], cp)
            else:
                out.append((cp, cp))
    return out


def _body(ranges, top: int) -> str:
    """The inside of a character class holding the part of ``ranges`` up
    to code point ``top``."""
    ranges = [(a, min(b, top)) for a, b in ranges if a <= top]
    return "".join(
        f"\\U{a:08x}" if a == b else f"\\U{a:08x}-\\U{b:08x}"
        for a, b in ranges)


@functools.lru_cache(maxsize=None)
def compiled(top: int = sys.maxunicode) -> re.Pattern:
    """GPT4_SPLIT_PATTERN with its property classes written out, each up to
    code point ``top``: on a text with no character above ``top`` that
    splits as the whole classes do, and faster (on the smoke corpus some
    eight times with ``top`` 0x7F and twice with 0xFFFF: ``re`` tests a
    class beyond the Basic Multilingual Plane by a search of its
    ranges)."""
    letter = _body(_ranges("L"), top)
    number = _body(_ranges("N"), top)
    space = _body(_WHITE_SPACE, top)
    pattern = GPT4_SPLIT_PATTERN
    for src, dst in ((r"[^\r\n\p{L}\p{N}]", f"[^\\r\\n{letter}{number}]"),
                     (r"[^\s\p{L}\p{N}]", f"[^{space}{letter}{number}]"),
                     (r"\p{L}", f"[{letter}]"), (r"\p{N}", f"[{number}]"),
                     (r"\S", f"[^{space}]"), (r"\s", f"[{space}]")):
        pattern = pattern.replace(src, dst)
    return re.compile(pattern)


def split(text: str) -> list[str]:
    """The chunks of ``text`` under the GPT-4 pattern, in order."""
    if text.isascii():
        top = 0x7F
    elif max(text) <= "\uffff":
        top = 0xFFFF
    else:
        top = sys.maxunicode
    return compiled(top).findall(text)
