"""Encode requests with a tiktoken-style ranks table: GPT4Tokenizer.

The loop, the documents and the comparison are ``encode_requests``': one
client sends one document at a time and waits for its ids, through the
same fixed length sequence, the run's seed picking where each document
starts. What differs is the table and the request:

- Set-up builds the tokenizer as a service holding the ranks file would:
  ``ctx.make_tokenizer()`` with ``MINBPE_TPU_CL100K`` naming the
  configuration's ranks (its sha256 checked), and the program's cache of
  recovered forests kept in the checkout (``FOREST_CACHE``, git-ignored),
  as a deployment keeps its own cache and its built kernels: the first run
  of a checkout recovers the merge forest (some seconds of Python), and
  every later one loads it.
- A request is ``tokenizer.encode(doc, allowed_special="none")``: a
  special token's text in a document is text, as a service metering its
  users' prompts takes it (the corpus holds cl100k's five special names).
- Where the tokenizer is the program's, set-up raises unless an empty
  request and then each warm-up request took the device split (counter
  ``encode.route.device_split``): a program that splits on the host fails
  the cell instead of measuring another path. The empty request comes
  first so that such a program fails before its first kernel build.
- The window carries the difference of the program's counters over it
  (``RanksWindow.counters``).
- Compared after the window, exactly, as ``encode_requests``: every
  request against its document's first answer, and each document's first
  answer against the plain reference (``reference/ranks.py``: the forest
  recovered from the ranks file, the byte shuffle, the lowest-rank loop
  over the GPT-4 chunks).
- The roofline's work: each request's bytes read, its ids written, and
  12 B (a pair and its new id) for each distinct merge its encode applies,
  the rows it must read. The reference counts those merges, so ``check``
  adds them to the window's ``work_bytes`` (the harness reads the metrics
  after ``check``).
"""

import os
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from bpebench import inputs
from bpebench.harness import Window
from bpebench.kinds import encode_requests
from bpebench.reference import bpe, ranks as rk, split

ENV_RANKS = "MINBPE_TPU_CL100K"
FOREST_CACHE = os.path.join("bpebench", ".forest-cache")
DEVICE_SPLIT = "encode.route.device_split"
ROW_BYTES = encode_requests.ROW_BYTES


@dataclass
class RanksWindow(Window):
    """A Window with the program's counters' change over it."""
    counters: dict = field(default_factory=dict)


class Requests:
    """The cell's request on a tokenizer: ``encode`` with every special
    token's text taken as text."""

    def __init__(self, tok):
        self.tok = tok

    def encode(self, text: str) -> list[int]:
        return self.tok.encode(text, allowed_special="none")


def _counters() -> dict:
    from minbpe_tpu_torch import trace

    return dict(trace.COUNTERS)


class Job(encode_requests.Job):

    def setup(self):
        ctx, t, config = self.ctx, self.ctx.traffic, self.ctx.config
        if config["pre_split"] != "GPT4_SPLIT_PATTERN":
            raise ValueError(f"the reference splits only with GPT-4's "
                             f"pattern, not {config['pre_split']}")
        with ctx.span("inputs"):
            data = inputs.corpus_bytes(ctx.path(t["corpus"]),
                                       t["corpus_sha256"])
            lengths = inputs.document_lengths(
                int(t["documents"]), float(t["median_bytes"]),
                float(t["sigma"]), int(t["min_bytes"]), int(t["max_bytes"]),
                int(t["length_seed"]))
            lengths = inputs.stratified(lengths, int(t["strata"]),
                                        int(t["length_seed"]))
            starts = inputs.document_starts(data, lengths, ctx.seed)
            self.docs = [data[s:s + n].decode("utf-8")
                         for s, n in zip(starts.tolist(), lengths.tolist())]
            self.nbytes = lengths.tolist()
            self.first = [None] * len(self.docs)
            # the rows are the reference's to count (check)
            self.rows = 0
        with ctx.span("load"):
            path = ctx.path(config["ranks"])
            inputs.corpus_bytes(path, config["ranks_sha256"])
            tok = self._tokenizer(path)
            self.tok = Requests(tok)
        with ctx.span("warmup"):
            from minbpe_tpu_torch import RegexTokenizer

            program = isinstance(tok, RegexTokenizer)
            before = _counters().get(DEVICE_SPLIT, 0)
            self.tok.encode("")
            self._took_device_split(program, before, 1)
            order = np.argsort(lengths, kind="stable")
            warm = {int(order[-1]), int(order[0])}
            warm.update(range(min(int(t["warmup_documents"]),
                                  len(self.docs))))
            for k in sorted(warm):
                self.tok.encode(self.docs[k])
            self._took_device_split(program, before, 1 + len(warm))

    def _tokenizer(self, path: str):
        """ctx.make_tokenizer() with the ranks at ``path`` and the cache of
        recovered forests at FOREST_CACHE; prints the seconds it took."""
        cache = self.ctx.path(FOREST_CACHE)
        os.makedirs(cache, exist_ok=True)
        warm = bool(os.listdir(cache))
        saved = {k: os.environ.get(k) for k in (ENV_RANKS, "XDG_CACHE_HOME")}
        os.environ[ENV_RANKS] = path
        os.environ["XDG_CACHE_HOME"] = cache
        try:
            t0 = time.perf_counter()
            tok = self.ctx.make_tokenizer()
            self.tokenizer_s = time.perf_counter() - t0
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        print(f"tokenizer built in {self.tokenizer_s:.3f} s (the cache of "
              f"recovered forests {'held' if warm else 'was empty'})",
              file=sys.stderr)
        return tok

    @staticmethod
    def _took_device_split(program: bool, before: int, texts: int):
        got = _counters().get(DEVICE_SPLIT, 0) - before
        if program and got != texts:
            raise RuntimeError(
                f"{texts} set-up requests, {got} of them split on the device "
                f"(counter {DEVICE_SPLIT}): the program does not take this "
                "configuration's path")

    def window(self, seconds: float) -> RanksWindow:
        before = _counters()
        win = super().window(seconds)
        after = _counters()
        moved = {k: v - before.get(k, 0) for k, v in after.items()
                 if v != before.get(k, 0)}
        self.win = RanksWindow(**vars(win), counters=moved)
        return self.win

    def check(self) -> dict:
        config, win = self.ctx.config, self.win
        seen = [k for k, f in enumerate(self.first) if f is not None]
        want, rows = Reference(self.ctx.path(config["ranks"]),
                               self.ctx.device).ids(
            [self.docs[k] for k in seen])
        differing = sum(self.first[k] != w for k, w in zip(seen, want))
        # the requests go through the documents in order, from the first
        n = len(self.docs)
        for k, r in zip(seen, rows):
            done = win.attempted // n + (k < win.attempted % n)
            win.work_bytes += ROW_BYTES * r * done
        return {"documents_differing": (differing, 0),
                "requests_differing": (self.differing, 0)}


class Reference:
    """The plain reference of a ranks file on ``device``: the merge forest
    recovered once, then any documents' ids."""

    def __init__(self, ranks_path: str, device):
        ranks = rk.read_tiktoken(ranks_path)
        self.device = device
        self.table = rk.MergeTable.of_forest(rk.recover_forest(ranks), device)
        self.shuffle = torch.tensor(rk.byte_shuffle(ranks), dtype=torch.long,
                                    device=device)

    def ids(self, docs: list[str], order: str = "left"):
        """The ids of each document (lists), and how many distinct merges
        each one's encode applies."""
        device = self.device
        chunks, doc_of_chunk = [], []
        for d, doc in enumerate(docs):
            cs = [c.encode("utf-8") for c in split.split(doc)]
            chunks.extend(cs)
            doc_of_chunk.extend([d] * len(cs))
        ids, seg = bpe.stream(chunks, device)
        applied: list = []
        ids, seg = rk.encode(self.shuffle[ids], seg, self.table, order,
                             applied)
        owner = torch.tensor(doc_of_chunk, dtype=torch.long, device=device)
        counts = torch.bincount(owner[seg], minlength=len(docs)).tolist()
        out = [part.tolist() for part in torch.split(ids.cpu(), counts)]
        rows = torch.zeros(len(docs), dtype=torch.long)
        if applied:
            s = torch.cat([a for a, _ in applied])
            r = torch.cat([b for _, b in applied])
            base = self.table.base + 1
            key = torch.unique(owner[s] * base + r)
            rows = torch.bincount((key // base).cpu(), minlength=len(docs))
        return out, rows.tolist()
