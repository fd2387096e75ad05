"""BasicTokenizer: byte-level BPE over the raw UTF-8 stream, no splitting,
no special tokens. Behavior-compatible with the reference BasicTokenizer
(minbpe/basic.py:15-74); training and encode run through the port's CUDA
kernels on the tokenizer's device.
"""

from __future__ import annotations

import numpy as np

from . import engine, trace
from .base import Tokenizer, id_array


class BasicTokenizer(Tokenizer):

    def __init__(self, device=None):
        """device: "cuda" (the default) or "cpu" (the kernels' plain PyTorch
        versions); without CUDA the default raises."""
        super().__init__(device)

    def train(self, text: str, vocab_size: int, verbose: bool = False,
              **train_opts):
        """Learn vocab_size-256 merges from the whole text as one stream
        (minbpe/basic.py:20-49). minbpe_tpu's extra training options
        (select_mode, checkpoint_path, ...) raise NotImplementedError."""
        assert vocab_size >= 256
        num_merges = vocab_size - 256
        with trace.span("api.train"):
            with trace.span("api.text_encode"):
                data = text.encode("utf-8")
            self.merges, self.vocab = engine.train_bytes(
                data, num_merges, verbose, device=self.device, **train_opts
            )
            self._invalidate_device_state()

    def encode(self, text: str) -> list[int]:
        """Greedy lowest-rank-first merging of the whole byte stream
        (minbpe/basic.py:57-74)."""
        with trace.span("api.encode"):
            with trace.span("api.text_encode"):
                data = text.encode("utf-8")
            return engine.encode_bytes(self, data)

    def encode_batch(self, texts: list[str]) -> list[list[int]]:
        """Encode many independent documents as one device stream. Each
        document is its own segment, so the result is exactly
        ``[self.encode(t) for t in texts]``."""
        with trace.span("api.encode_batch"):
            batch = []
            with trace.span("api.text_encode"):
                for t in texts:
                    data = np.frombuffer(t.encode("utf-8"), dtype=np.uint8)
                    ends = (np.array([len(data)], dtype=np.int64) if len(data)
                            else np.zeros(0, dtype=np.int64))
                    batch.append((data, ends))
            encoded = engine.encode_parts(self, batch)
            with trace.span("api.to_list"):
                return [ids.tolist() for ids in encoded]

    def decode(self, ids) -> str:
        """Concatenate vocab bytes; invalid UTF-8 becomes U+FFFD
        (minbpe/basic.py:51-55); unknown ids raise KeyError like the
        reference's vocab[idx]. ids: any iterable of ints."""
        ids = id_array(ids)
        data, bad = self._decode_table(self.vocab).lookup(ids)
        if bad >= 0:
            raise KeyError(int(ids[bad]))
        return data.decode("utf-8", errors="replace")
