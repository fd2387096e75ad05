"""The control of the ranks configurations (``kinds/encode_ranks.py``):
the plain reference put in the program's place, reading the ranks file as
the program does, with one guarantee broken. Each merge replaces the sites
of a run of its pair from the run's right end (``order="right"``), where
minbpe and the configurations take them from the left. A comparison that
cannot tell this tokenizer from the program's decides nothing.
"""

from __future__ import annotations

import os

from bpebench.kinds.encode_ranks import ENV_RANKS, Reference

ORDER = "right"


class RanksControl:
    """The tokenizer surface the kind uses: ``encode(text,
    allowed_special)``, for the ranks file that ``MINBPE_TPU_CL100K`` names
    when it is made."""

    def __init__(self, device):
        self.reference = Reference(os.environ[ENV_RANKS], device)
        self.answers: dict[str, list[int]] = {}

    def prepare(self, docs: list[str]):
        """Encode ``docs`` at once, so that a window of requests reads the
        answers at the cell's own pace."""
        ids, _ = self.reference.ids(docs, ORDER)
        self.answers.update(zip(docs, ids))

    def encode(self, text: str, allowed_special="none") -> list[int]:
        if allowed_special != "none":
            raise ValueError("the control takes special tokens' text as text")
        if text not in self.answers:
            self.prepare([text])
        return list(self.answers[text])


def factory(config: dict, device):
    return lambda: RanksControl(device)
