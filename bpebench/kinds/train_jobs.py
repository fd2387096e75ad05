"""Training jobs in a closed loop.

One client trains a fresh tokenizer on the whole training text, waits for
its merges on the host, and starts the next job. The text is the frozen
corpus's lines drawn to ``min_bytes`` by the traffic's own generator, then
rotated by a whole number of lines that the run's seed picks: every seed
trains on the same bytes, and every pair count of the first round is the
same but at the one join.

Traffic keys: ``corpus`` and ``corpus_sha256`` (the frozen text),
``min_bytes``, ``block_lines`` and ``draw_seed`` (the drawing of lines).

Compared after the window: every job's merges against the first job's
(``jobs_differing``), and the first job's against the plain reference's on
the same text, rank by rank (``merges_differing``). Both exact.
"""

from __future__ import annotations

import sys
import time

from bpebench import inputs
from bpebench.harness import Window
from bpebench.reference import bpe

# bytes a merge writes at the least: its pair and its new id, int32 each
MERGE_BYTES = 12


class Job:

    def __init__(self, ctx):
        self.ctx = ctx
        self.vocab_size = int(ctx.config["vocab_size"])
        self.first = None
        self.differing = 0

    def setup(self):
        ctx, t = self.ctx, self.ctx.traffic
        with ctx.span("inputs"):
            text = inputs.corpus_bytes(ctx.path(t["corpus"]),
                                       t["corpus_sha256"]).decode("utf-8")
            lines = inputs.drawn_lines(text, int(t["min_bytes"]),
                                       int(t["block_lines"]),
                                       int(t["draw_seed"]))
            self.text = inputs.rotated(lines, ctx.seed)
            self.nbytes = len(self.text.encode("utf-8"))
        with ctx.span("warmup"):
            self._train()

    def _train(self):
        tok = self.ctx.make_tokenizer()
        tok.train(self.text, self.vocab_size)
        return tok.merges

    def window(self, seconds: float) -> Window:
        ctx = self.ctx
        attempted = completed = failed = 0
        latencies = []
        start = time.perf_counter()
        deadline = start + seconds
        end = start
        while end < deadline:
            attempted += 1
            t = time.perf_counter()
            try:
                with ctx.span("train"):
                    merges = self._train()
            except Exception as e:  # a job that raises has failed
                failed += 1
                print(f"job {attempted} failed: {e!r}", file=sys.stderr)
                end = time.perf_counter()
                continue
            end = time.perf_counter()
            latencies.append(end - t)
            completed += 1
            with ctx.span("compare"):
                if self.first is None:
                    self.first = merges
                elif merges != self.first:
                    self.differing += 1
        num_merges = self.vocab_size - 256
        return Window(seconds=end - start, attempted=attempted,
                      completed=completed, failed=failed,
                      nbytes=completed * self.nbytes,
                      work_bytes=completed * (self.nbytes
                                              + MERGE_BYTES * num_merges),
                      latencies=latencies)

    def release(self):
        pass

    def check(self) -> dict:
        ids, seg = bpe.stream([self.text.encode("utf-8")], self.ctx.device)
        want = bpe.train(ids, seg, self.vocab_size - 256)
        got = sorted((self.first or {}).items(), key=lambda kv: kv[1])
        got_pairs = [p for p, _ in got]
        ranks_ok = all(idx == 256 + r for r, (_, idx) in enumerate(got))
        differing = sum(g != w for g, w in zip(got_pairs, want))
        differing += abs(len(got_pairs) - len(want))
        if not ranks_ok:
            differing = max(differing, 1)
        return {"merges_differing": (differing, 0),
                "jobs_differing": (self.differing, 0)}
