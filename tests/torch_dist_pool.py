"""A fixed pool of gloo ranks for the port's distributed tests, and the
jobs they run.

Four processes (spawned once; torch and the port only, no JAX) join one
gloo group of world size 4 with a timeout, and make the subgroups of
ranks {0} and {0, 1} at once, so a job runs at world size 1, 2 or 4 on
the first ranks of the pool. Each job has its own time limit; a job that
does not finish on every rank in it, or that fails on some ranks only,
has the pool restarted, so a hang fails one test and not the suite.
"""

from __future__ import annotations

import builtins
import datetime
import multiprocessing as mp
import queue
import socket
import time
import traceback

WORLD = 4
GROUP_TIMEOUT = datetime.timedelta(seconds=60)
JOB_TIMEOUT = 120.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker(rank: int, port: int, inbox, outbox):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD,
                            timeout=GROUP_TIMEOUT)
    groups = {1: dist.new_group([0], timeout=GROUP_TIMEOUT),
              2: dist.new_group([0, 1], timeout=GROUP_TIMEOUT),
              4: dist.group.WORLD}
    outbox.put((rank, ("ready", None)))
    while True:
        job = inbox.get()
        if job is None:
            break
        fn, world, args, kwargs = job
        if rank >= world:
            continue
        try:
            res = ("ok", fn(groups[world], *args, **kwargs))
        except Exception as e:  # sent back, raised in the test
            res = ("err", (type(e).__name__, str(e),
                           traceback.format_exc()))
        outbox.put((rank, res))
    dist.destroy_process_group()


class Pool:
    def __init__(self):
        self.procs = []
        self._start()

    def _start(self):
        ctx = mp.get_context("spawn")
        port = _free_port()
        self.inboxes = [ctx.Queue() for _ in range(WORLD)]
        self.outbox = ctx.Queue()
        self.procs = [ctx.Process(target=_worker,
                                  args=(r, port, self.inboxes[r],
                                        self.outbox), daemon=True)
                      for r in range(WORLD)]
        for p in self.procs:
            p.start()
        self._collect(WORLD, JOB_TIMEOUT)

    def _collect(self, n: int, timeout: float) -> dict:
        out = {}
        deadline = time.monotonic() + timeout
        while len(out) < n:
            try:
                rank, res = self.outbox.get(
                    timeout=max(deadline - time.monotonic(), 0.01))
            except queue.Empty:
                self.restart()
                raise TimeoutError(f"ranks {sorted(set(range(n)) - set(out))}"
                                   f" did not answer in {timeout} s")
            out[rank] = res
        return out

    def restart(self):
        self.close()
        self._start()

    def close(self):
        for q in getattr(self, "inboxes", []):
            q.put(None)
        for p in self.procs:
            p.join(5)
            if p.is_alive():
                p.kill()
                p.join()
        self.procs = []

    def run(self, fn, world: int, *args, timeout: float = JOB_TIMEOUT,
            **kwargs) -> list:
        """fn(group, *args, **kwargs) on ranks 0 .. world - 1; their
        results in rank order. An error raised on every rank is raised
        here again (its type where it is a builtin one)."""
        for q in self.inboxes:
            q.put((fn, world, args, kwargs))
        out = self._collect(world, timeout)
        kinds = {out[r][0] for r in out}
        if kinds == {"ok"}:
            return [out[r][1] for r in range(world)]
        if kinds != {"err"}:
            self.restart()
            raise RuntimeError(f"some ranks failed: {out}")
        name, msg, tb = out[0][1]
        cls = getattr(builtins, name, RuntimeError)
        if not (isinstance(cls, type) and issubclass(cls, Exception)):
            cls = RuntimeError
        raise cls(msg) from RuntimeError(tb)


# ---------------------------------------------------------------------------
# jobs: each takes the group first and runs on the CPU
# ---------------------------------------------------------------------------

def train_chunks(group, chunks, num_merges, **kw):
    from minbpe_tpu_torch.parallel import train

    return train.train_chunks_distributed(chunks, num_merges, group,
                                          device="cpu", **kw)[0]


def train_bytes(group, data, num_merges):
    from minbpe_tpu_torch.parallel import train

    return train.train_bytes_distributed(data, num_merges, group,
                                         device="cpu")[0]


def train_arrays(group, ids, seg, lens, num_merges, **kw):
    from minbpe_tpu_torch.parallel import train

    return train.train_distributed(ids, seg, lens, num_merges, group,
                                   device="cpu", **kw)


def train_offsets(group, text, num_merges, **kw):
    from minbpe_tpu_torch import RegexTokenizer
    from minbpe_tpu_torch.parallel import train

    data, ends = RegexTokenizer(device="cpu")._split_arrays(text)
    return train.train_offsets_distributed(data, ends, num_merges, group,
                                           device="cpu", **kw)[0]


def encode_chunks(group, chunks, pairs, new_ids):
    from minbpe_tpu_torch.parallel import encode

    return encode.encode_chunks_distributed(chunks, pairs, new_ids, group,
                                            device="cpu")


def encode_text(group, kind, table, text):
    """The sharded encode of text by a port tokenizer: kind "regex" with
    table (pairs, new_ids), or "gpt4" with table a mergeable-ranks dict;
    returns (sharded, encode_ordinary)."""
    from minbpe_tpu_torch import GPT4Tokenizer, RegexTokenizer
    from minbpe_tpu_torch.convert import tokenizer_from_arrays
    from minbpe_tpu_torch.parallel import encode

    if kind == "gpt4":
        tok = GPT4Tokenizer.from_mergeable_ranks(table, device="cpu")
    else:
        tok = tokenizer_from_arrays(RegexTokenizer, *table, device="cpu")
    return (encode.encode_text_distributed(tok, text, group, device="cpu"),
            tok.encode_ordinary(text))


def train_local(group, chunks, num_merges, selection="dense"):
    """Each rank feeds only its own contiguous slice of the chunks."""
    import torch.distributed as dist

    from minbpe_tpu_torch.parallel import multihost

    D, r = dist.get_world_size(group), dist.get_rank(group)
    lo, hi = r * len(chunks) // D, (r + 1) * len(chunks) // D
    return multihost.train_local_chunks_global(
        chunks[lo:hi], num_merges, group, selection=selection,
        device="cpu")[0]


def train_global(group, chunks, num_merges):
    from minbpe_tpu_torch.parallel import multihost

    return multihost.train_chunks_global(chunks, num_merges, group,
                                         device="cpu")[0]


def collectives(group):
    """Each collective of Comm on small tensors, as seen by this rank, with
    the collectives counted (comm.calls) and their spans as a CPU profiler
    records them."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    from minbpe_tpu_torch import trace
    from minbpe_tpu_torch.parallel.comm import Comm

    c = Comm(group, "cpu")
    r, D = c.rank, c.size
    x = torch.tensor([r + 1, 10 - r], dtype=torch.int32)
    before = trace.COUNTERS.get("comm.calls", 0)
    with profile(activities=[ProfilerActivity.CPU]) as prof, trace.enabled():
        out = {
            "sum": c.sum_(x.clone()).tolist(),
            "min": c.min_(x.clone()).tolist(),
            "max": c.max_(x.clone()).tolist(),
            "gather": c.all_gather(x).tolist(),
            "to_all": c.all_to_all(torch.arange(
                D * 2, dtype=torch.int32).view(D, 2) + 100 * r).tolist(),
            "bcast": c.broadcast_(x.clone(), D - 1).tolist(),
            "varlen": c.gather_varlen(torch.arange(r, dtype=torch.int64)
                                      + 10 * r).tolist(),
        }
    spans = collections.Counter(
        e.name for e in prof.events()
        if e.name.startswith(trace.PREFIX + "comm."))
    return dict(out, calls=trace.COUNTERS["comm.calls"] - before,
                spans=dict(spans))


def dryrun(group):
    """entry_torch's dryrun checks on this rank (the repository's root on
    the path)."""
    import entry_torch

    return entry_torch.dryrun_rank(group, "cpu")
