"""Run a cell with the program's spans on or off, traced, and print where
the device's idle time goes, host step by host step.

    python3 bpebench/tools/spans.py --workload <cell> --seed <n> \\
        [--seconds 10] --spans <0|1>

One run as ``run.py --trace 1`` makes it: the cell's set-up, then the
window under a profiler of the host and the device, with the program's
spans (minbpe_tpu_torch/trace.py) on, or off, around the window alone.
Prints one JSON line: ``correct``; the cell's metrics, end-to-end and per
layer, read by its own readers from a trace in which the spans' copies on
the device's timeline count as no device work; ``busy_s``, ``window_s``;
each program span's calls and seconds in the window (``spans``), its
seconds less those of the spans it holds (``self_s``); the idle seconds
by the innermost span, program or harness, that holds each gap's middle
(``idle``); the window's counters; the host readings the spans give a job
or request (``program``); and the clocks' agreement (``clock``): the share
of device time inside the calls' root spans, whether each encode sweep
starts after the span that launched it, and the least lag from each
launch call to its operation's start, a tenth of the window at a time
(below 0 where the two clocks disagree).

The reduction here is the benchmark's own (bpebench/trace.py) with the
program's spans added; the harness does not turn them on.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from bpebench import harness  # noqa: E402
from bpebench import trace as btrace  # noqa: E402

PROGRAM = "minbpe."
ROOTS = ("api.encode", "api.train", "api.encode_batch")
# each host reading: the spans it sums, over the jobs or requests done
PROGRAM_SPANS = {
    "train_jobs": {
        "text_encode_ms.train": ("api.text_encode",),
        "stream_build_ms.train": ("stream.build",),
        "enqueue_ms.train": ("train.enqueue",),
        "sync_wait_ms.train": ("train.sync", "train.readback"),
    },
    "encode_requests": {
        "check_memory_ms.encode": ("engine.check_memory",),
        "readback_ms.encode": ("encode.readback", "api.to_list"),
    },
}
SYNCS = {"train_jobs": "host_syncs_per_job.train",
         "encode_requests": "host_syncs_per_request.encode"}


def events(prof):
    """(device, harness spans, program spans, links) of a finished profile:
    each (start ns, end ns, name), the spans' names without their prefix;
    links, (launch call's start ns, operation's start ns, name) of each
    device operation whose CUDA API call the profile holds. The
    profiler also draws every span on the device's timeline, from its first
    operation to its last: those copies are not device work."""
    from torch.autograd import DeviceType

    device, bench, program, calls, corr = [], [], [], {}, []
    for e in prof.profiler.kineto_results.events():
        name, cuda = e.name(), e.device_type() == DeviceType.CUDA
        for prefix, out in ((btrace.PREFIX, bench), (PROGRAM, program)):
            if name.startswith(prefix):
                if not cuda:
                    out.append((e.start_ns(), e.end_ns(), name[len(prefix):]))
                break
        else:
            if cuda:
                device.append((e.start_ns(), e.end_ns(), name))
                corr.append((e.correlation_id(), e.start_ns(), name))
            elif name.startswith("cu"):  # a CUDA API call
                calls[e.correlation_id()] = e.start_ns()
    links = [(calls[c], a, name) for c, a, name in corr if c in calls]
    return device, bench, program, links


def _nest(spans):
    """The spans by (start, longest first) and each one's parent index,
    the innermost span that holds it (-1 for none): the spans of one
    thread nest."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    parent, stack = [], []
    for i, (a, _, _) in enumerate(spans):
        while stack and spans[stack[-1]][1] <= a:
            stack.pop()
        parent.append(stack[-1] if stack else -1)
        stack.append(i)
    return spans, parent


def reduce(device, bench, program) -> dict:
    """The benchmark's Trace (bpebench/trace.py reduce, on the device
    operations and harness spans) and, from the program's spans: ``spans``
    name -> [calls, seconds in the window], ``self_s`` name -> seconds less
    those of the spans each holds, and ``idle``: each gap's seconds by the
    innermost span that holds its middle, a program span's name before the
    harness's, "window" where none does."""
    tr = btrace.reduce(device, bench)
    (w0, w1), = [(a, b) for a, b, n in bench if n == "window"]

    def clip(a, b):
        return max(0, min(b, w1) - max(a, w0))

    spans, parent = _nest(program)
    totals: dict[str, list] = {}
    own = [clip(a, b) for a, b, _ in spans]
    for i, (a, b, name) in enumerate(spans):
        if a < w1 and b > w0:
            t = totals.setdefault(name, [0, 0.0])
            t[0] += 1
            t[1] += clip(a, b) * 1e-9
        if parent[i] >= 0:
            own[parent[i]] -= clip(a, b)
    self_s: dict[str, float] = {}
    for (_, _, name), s in zip(spans, own):
        self_s[name] = self_s.get(name, 0.0) + s * 1e-9

    every, up = _nest([s for s in bench if s[2] != "window"] + program)
    starts = [a for a, _, _ in every]
    busy = btrace.union([(max(a, w0), min(b, w1)) for a, b, _ in device
                         if min(b, w1) > max(a, w0)])
    idle: dict[str, float] = {}
    edge = w0
    for a, b in busy + [(w1, w1)]:
        if a > edge:
            mid = (edge + a) // 2
            k = bisect.bisect_right(starts, mid) - 1
            while k >= 0 and every[k][1] < mid:
                k = up[k]
            name = every[k][2] if k >= 0 else "window"
            idle[name] = idle.get(name, 0.0) + (a - edge) * 1e-9
        edge = max(edge, b)
    return {"trace": tr, "spans": totals, "self_s": self_s, "idle": idle,
            "busy": busy, "window": (w0, w1)}


def clock(device, program, busy, links=(), window=None) -> dict:
    """The clocks' agreement: the share of the window's device time inside
    a root span; the encode sweeps that start after the start of their
    ``encode.sweep`` span, paired in order; and over ``links``, the least
    lag (us) from a launch call's start to its operation's start in each
    tenth of the window, and the operations that start before their
    call."""
    roots = btrace.union([(a, b) for a, b, n in program if n in ROOTS])
    inside = 0
    for a, b in busy:
        k = bisect.bisect_right(roots, (a, float("inf"))) - 1
        for ra, rb in roots[max(k, 0):]:
            if ra >= b:
                break
            inside += max(0, min(b, rb) - max(a, ra))
    total = sum(b - a for a, b in busy)
    out = {"device_in_root": inside / total if total else None}
    sweeps = sorted(a for a, _, n in device if "encode_sweep" in n)
    launched = sorted(a for a, _, n in program if n == "encode.sweep")
    if sweeps or launched:
        out["sweeps"] = len(sweeps)
        out["sweep_spans"] = len(launched)
        out["sweeps_after_span"] = sum(
            k >= s for k, s in zip(sweeps, launched))
        out["least_lead_us"] = min(
            ((k - s) * 1e-3 for k, s in zip(sweeps, launched)), default=None)
    if links and window is not None:
        w0, w1 = window
        lags: list = [None] * 10
        for call, start, _ in links:
            k = min(9, max(0, (call - w0) * 10 // max(1, w1 - w0)))
            lag = (start - call) * 1e-3
            lags[k] = lag if lags[k] is None else min(lags[k], lag)
        out["least_lag_us_by_tenth"] = lags
        out["before_call"] = sum(start < call for call, start, _ in links)
        out["links"] = len(links)
    return out


def program_readings(kind: str, red: dict, counters: dict, done: int):
    """The host readings of a job or request: each PROGRAM_SPANS entry's
    ms, and the sync sites passed."""
    if not done:
        return {}
    out = {}
    for name, parts in PROGRAM_SPANS.get(kind, {}).items():
        got = [red["spans"][p][1] for p in parts if p in red["spans"]]
        if got:
            out[name] = 1e3 * sum(got) / done
    syncs = sum(v for k, v in counters.items() if k.startswith("sync."))
    if kind in SYNCS and syncs:
        out[SYNCS[kind]] = syncs / done
    return out


def run(cell, seed: int, seconds: float, spans: bool, device,
        t0: float) -> dict:
    """One traced run of ``cell`` with the program's spans on or off around
    its window; the JSON line's object."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from minbpe_tpu_torch import trace as ptrace

    ctx = harness.Context(cell, seed, device, True)
    job = cell.kind.Job(ctx)
    job.setup()
    ctx.sync()
    setup_s = time.perf_counter() - t0
    before = harness._launches()
    counted = dict(ptrace.COUNTERS)
    acts = [ProfilerActivity.CPU]
    if ctx.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with ptrace.enabled(spans), ctx.span("window"):
            win = job.window(seconds)
            ctx.sync()
    after = harness._launches()
    counters = {k: v - counted.get(k, 0) for k, v in ptrace.COUNTERS.items()
                if v != counted.get(k, 0)}
    job.release()
    compared = dict(job.check())
    compared["failed"] = (win.failed, 0)
    dev, bench, program, links = events(prof)
    red = reduce(dev, bench, program)
    kind = (torch.cuda.get_device_name(ctx.device)
            if ctx.device.type == "cuda" else "cpu")
    r = harness.Readings(setup_s=setup_s, window=win,
                         launches={k: after[k] - before[k] for k in after},
                         device_kind=kind, trace=red["trace"])
    metrics = harness._read(cell, cell.end_to_end + cell.per_layer, r,
                            required=False)
    top = sorted(red["idle"].items(), key=lambda kv: -kv[1])
    return {
        "workload": cell.name, "seed": seed, "spans_on": spans,
        "correct": all(v <= lim for v, lim in compared.values()),
        "completed": win.completed, "device": kind,
        "metrics": {k: v["value"] for k, v in metrics.items()},
        "busy_s": red["trace"].busy_s, "window_s": red["trace"].window_s,
        "harness_idle": red["trace"].idle,
        "idle": dict(top[:harness.BREAKDOWN_TOP]),
        "spans": red["spans"], "self_s": red["self_s"],
        "counters": counters,
        "program": program_readings(cell.traffic["kind"], red, counters,
                                    win.completed),
        "clock": clock(dev, program, red["busy"], links, red["window"]),
    }


def main(argv=None) -> int:
    t0 = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--spans", type=int, choices=(0, 1), required=True)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("CUDA is not available: no result", file=sys.stderr)
        return 3
    out = run(cell, args.seed, args.seconds, bool(args.spans), "cuda", t0)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
