"""The control: the plain reference put in the program's place, with one
guarantee of the configurations broken. Each merge replaces the sites of a
run of its pair from the run's right end (``order="right"``), where minbpe
and the configurations take them from the left. A comparison that cannot
tell this tokenizer from the program's decides nothing.
"""

from __future__ import annotations

from bpebench.kinds.encode_requests import chunks_of, reference_ids
from bpebench.reference import bpe

ORDER = "right"


class ControlTokenizer:
    """The tokenizer surface the kinds use: ``train``, ``load``,
    ``encode`` and ``merges``."""

    def __init__(self, config: dict, device):
        self.config = config
        self.device = device
        self.merges: dict[tuple[int, int], int] = {}
        self.model = None
        self.answers: dict[str, list[int]] = {}

    def train(self, text: str, vocab_size: int):
        ids, seg = bpe.stream(chunks_of(self.config, text), self.device)
        pairs = bpe.train(ids, seg, vocab_size - 256, ORDER)
        self.merges = {p: 256 + r for r, p in enumerate(pairs)}

    def load(self, path: str):
        self.model = path
        self.merges = {p: 256 + r
                       for r, p in enumerate(bpe.read_model(path))}

    def prepare(self, docs: list[str]):
        """Encode ``docs`` at once, so that a window of requests reads the
        answers at the cell's own pace."""
        self.answers.update(zip(docs, reference_ids(
            self.config, self.model, docs, self.device, ORDER)))

    def encode(self, text: str) -> list[int]:
        if text not in self.answers:
            self.prepare([text])
        return list(self.answers[text])


def factory(config: dict, device):
    return lambda: ControlTokenizer(config, device)
