"""Carry a merge table across from minbpe_tpu without its files.

``tokenizer_from_arrays`` takes what minbpe_tpu's
``Tokenizer._merge_arrays()`` returns (numpy pairs[M, 2] and new_ids[M], in
rank order) and builds a port tokenizer that encodes and decodes the same
way. The ``minbpe v1`` files (save/load) are the other way across.
"""

from __future__ import annotations

import numpy as np

from .regex import RegexTokenizer


def tokenizer_from_arrays(cls, pairs, new_ids, pattern=None,
                          special_tokens=None, device=None):
    pairs = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
    new_ids = np.asarray(new_ids, dtype=np.int64).reshape(-1)
    if len(pairs) != len(new_ids):
        raise ValueError(f"{len(pairs)} pairs but {len(new_ids)} new ids")
    is_regex = issubclass(cls, RegexTokenizer)
    if not is_regex and (pattern is not None or special_tokens):
        raise ValueError(f"{cls.__name__} takes no pattern or special tokens")
    tok = (cls(pattern=pattern, device=device) if is_regex
           else cls(device=device))
    tok.merges = {(int(a), int(b)): int(z)
                  for (a, b), z in zip(pairs, new_ids)}
    tok.vocab = tok._build_vocab()
    tok._invalidate_device_state()
    if special_tokens:
        tok.register_special_tokens(dict(special_tokens))
    return tok
