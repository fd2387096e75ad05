"""Encode requests in a closed loop.

One client sends one document at a time to ``tokenizer.encode``, waits for
its list of ids, and sends the next. The documents' byte lengths are a
fixed sequence that the traffic's own seed draws (lognormal, clipped) and
orders; the run's seed only picks where in the frozen corpus each
document starts, on whole characters. The requests go through the sequence in order, from its
start, as often as the window allows.

Traffic keys: ``corpus``, ``corpus_sha256``, ``documents``,
``median_bytes``, ``sigma``, ``min_bytes``, ``max_bytes``,
``length_seed``, ``strata`` (the sequence ordered so that each block of
that many documents holds one of each band of lengths, see
``inputs.stratified``), ``warmup_documents`` (the first ones, beside the
longest and the shortest, encoded in set-up).

Compared after the window: every request's ids against the first answer
for its document (``requests_differing``), and each document's first
answer against the plain reference's ids (``documents_differing``). Both
exact; every document the window reached is compared.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from bpebench import inputs
from bpebench.harness import Window
from bpebench.reference import bpe, split

# bytes a table row holds at the least: its pair and its new id, int32 each
ROW_BYTES = 12
# bytes an output id takes: int32
ID_BYTES = 4


class Job:

    def __init__(self, ctx):
        self.ctx = ctx
        self.differing = 0

    def setup(self):
        ctx, t = self.ctx, self.ctx.traffic
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
        with ctx.span("load"):
            self.tok = ctx.make_tokenizer()
            self.tok.load(ctx.path(ctx.config["merges"]))
            self.rows = len(self.tok.merges)
        with ctx.span("warmup"):
            order = np.argsort(lengths, kind="stable")
            warm = {int(order[-1]), int(order[0])}
            warm.update(range(min(int(t["warmup_documents"]),
                                  len(self.docs))))
            for k in sorted(warm):
                self.tok.encode(self.docs[k])

    def window(self, seconds: float) -> Window:
        ctx, tok, docs = self.ctx, self.tok, self.docs
        n = len(docs)
        attempted = completed = failed = nbytes = out_ids = 0
        latencies = []
        start = time.perf_counter()
        deadline = start + seconds
        end = start
        k = 0
        while end < deadline:
            attempted += 1
            t = time.perf_counter()
            try:
                with ctx.span("encode"):
                    ids = tok.encode(docs[k])
            except Exception as e:  # a request that raises has failed
                failed += 1
                print(f"request {attempted} failed: {e!r}", file=sys.stderr)
                end = time.perf_counter()
                k = (k + 1) % n
                continue
            end = time.perf_counter()
            latencies.append(end - t)
            completed += 1
            nbytes += self.nbytes[k]
            out_ids += len(ids)
            with ctx.span("compare"):
                if self.first[k] is None:
                    self.first[k] = ids
                elif ids != self.first[k]:
                    self.differing += 1
            k = (k + 1) % n
        work = nbytes + ID_BYTES * out_ids + ROW_BYTES * self.rows * completed
        return Window(seconds=end - start, attempted=attempted,
                      completed=completed, failed=failed, nbytes=nbytes,
                      work_bytes=work, latencies=latencies)

    def release(self):
        self.tok = None

    def check(self) -> dict:
        config = self.ctx.config
        seen = [k for k, f in enumerate(self.first) if f is not None]
        want = reference_ids(config, self.ctx.path(config["merges"]),
                             [self.docs[k] for k in seen], self.ctx.device)
        differing = sum(self.first[k] != w for k, w in zip(seen, want))
        return {"documents_differing": (differing, 0),
                "requests_differing": (self.differing, 0)}


def chunks_of(config: dict, doc: str) -> list[bytes]:
    """The chunks the configuration's tokenizer merges within."""
    if config.get("split") is None:
        return [doc.encode("utf-8")]
    if config["split"] != "GPT4_SPLIT_PATTERN":
        raise ValueError(f"the reference splits only with GPT-4's pattern, "
                         f"not {config['split']}")
    return [c.encode("utf-8") for c in split.split(doc)]


def reference_ids(config: dict, model: str, docs: list[str], device,
                  order: str = "left") -> list[list[int]]:
    """The plain reference's ids of each document, as lists."""
    merges = bpe.read_model(model)
    chunks, doc_of_chunk = [], []
    for d, doc in enumerate(docs):
        cs = chunks_of(config, doc)
        chunks.extend(cs)
        doc_of_chunk.extend([d] * len(cs))
    ids, seg = bpe.stream(chunks, device)
    ids, seg = bpe.encode(ids, seg, merges, order)
    owner = torch.tensor(doc_of_chunk, dtype=torch.long, device=device)[seg]
    counts = torch.bincount(owner, minlength=len(docs)).tolist()
    return [part.tolist() for part in torch.split(ids.cpu(), counts)]
