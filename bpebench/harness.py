"""The benchmark's general machinery.

A cell is found by name in ``BENCHMARK.json``. Its configuration is the
file that the configuration's entry names; its traffic is
``bpebench/traffic/<traffic>.json``, which names a kind,
``bpebench/kinds/<kind>.py``; each of its metrics is read by
``bpebench/metrics/<metric>.py``. So a later cell, configuration, traffic
mix or metric is added as files and entries, with no edit here.

A kind's module holds a class ``Job(ctx)`` with ``setup()`` (inputs, the
tokenizer, the warm-up: all of it set-up), ``window(seconds)`` (the closed
loop, returning a ``Window``), ``release()`` (frees the program's state)
and ``check()`` (the plain reference, after the window: the numbers
compared, each with its limit). A metric's module holds ``read(r)``,
which takes the run's ``Readings`` and returns a number, or None where it
finds nothing to read.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field

from bpebench import trace as trace_mod

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = "bpebench"
# top-level modules that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "minbpe_tpu")
# the longest lists of a traced run's breakdown
BREAKDOWN_TOP = 10


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _for_cell(metrics: list[dict], cell: str) -> list[dict]:
    return [m for m in metrics if cell in m.get("workloads", [cell])]


@dataclass
class Cell:
    name: str
    root: str
    chips: int
    config: dict
    traffic: dict
    kind: object
    end_to_end: list
    per_layer: list
    readers: dict


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json and its files; raises
    KeyError for a name that is not there."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(root, entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, BENCH, "traffic",
                           w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    kind = load_module(
        os.path.join(root, BENCH, "kinds", traffic["kind"] + ".py"),
        f"bpebench_kind_{traffic['kind']}")
    e2e = _for_cell(bench["end_to_end"], name)
    per = _for_cell(bench["per_layer"], name)
    readers = {m["name"]: load_module(
        os.path.join(root, BENCH, "metrics", m["name"] + ".py"),
        "bpebench_metric_" + m["name"].replace(".", "_"))
        for m in e2e + per}
    return Cell(name=name, root=root, chips=int(w["chips"]), config=config,
                traffic=traffic, kind=kind, end_to_end=e2e, per_layer=per,
                readers=readers)


def program_tokenizer(config: dict, device):
    """A factory of the program's tokenizer as the configuration states
    it."""
    import minbpe_tpu_torch as program

    cls = getattr(program, config["tokenizer"])
    kwargs = {}
    if config.get("split") is not None:
        kwargs["pattern"] = getattr(program, config["split"])

    def make():
        tok = cls(device=device, **kwargs)
        if config.get("device_presplit"):
            tok.device_presplit = True
        return tok

    return make


class Context:
    """What a kind's job gets: the cell, the seed, the device, the spans
    and the tokenizer factory (the program's, or a stand-in's)."""

    def __init__(self, cell: Cell, seed: int, device, trace: bool,
                 make_tokenizer=None):
        import torch

        device = torch.device(device)
        self.cell = cell
        self.config = cell.config
        self.traffic = cell.traffic
        self.seed = seed
        self.device = device
        self.trace = trace
        self.make_tokenizer = (make_tokenizer if make_tokenizer is not None
                               else program_tokenizer(cell.config, device))

    def path(self, rel: str) -> str:
        return os.path.join(self.cell.root, rel)

    def span(self, name: str):
        """A harness span; recorded in the trace only when tracing."""
        if not self.trace:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(trace_mod.PREFIX + name)

    def sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize()


@dataclass
class Window:
    """What a kind's window did. ``seconds`` is the host wall from the first
    request's start to the last one's end; ``nbytes`` the payload bytes of
    the requests completed; ``work_bytes`` the least bytes a device must
    move for them (the roofline's); ``latencies`` each completed request's
    host seconds."""
    seconds: float
    attempted: int
    completed: int
    failed: int
    nbytes: int
    work_bytes: int
    latencies: list = field(default_factory=list)


@dataclass
class Readings:
    """Everything a metric reader may read. ``launches``: each of the
    program's kernels (by its name in the program) and its launches in the
    window."""
    setup_s: float
    window: Window
    launches: dict
    device_kind: str
    trace: trace_mod.Trace | None


def _launches():
    from minbpe_tpu_torch import kernels

    return {k.name: k.launches for k in kernels.KERNELS}


def forbidden_modules() -> list[str]:
    """The FORBIDDEN top-level names present in sys.modules, each compared
    whole (the part before the first dot)."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def _read(cell: Cell, metrics: list[dict], r: Readings, required: bool):
    """The metrics' readings. A required one that reads nothing raises,
    but for one read from the device's trace in a run without a device
    (the tests' CPU runs), which is left out."""
    out = {}
    for m in metrics:
        v = cell.readers[m["name"]].read(r)
        if v is None:
            if required and not (m["source"] == "device_trace"
                                 and r.trace is None):
                raise RuntimeError(f"end-to-end metric {m['name']} read "
                                   "nothing")
            continue
        out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t0: float, make_tokenizer=None) -> dict:
    """Run the cell once on ``device`` ("cuda" on the card; "cpu" only in
    the tests, which drive the plain versions of the kernels) and return
    the result object. ``t0``: the host clock at the process's start, from
    which set-up counts."""
    import torch

    ctx = Context(cell, seed, device, trace, make_tokenizer)
    device = ctx.device
    job = cell.kind.Job(ctx)
    job.setup()
    ctx.sync()
    setup_s = time.perf_counter() - t0
    before = _launches()
    prof = None
    # an end-to-end metric read from the device's trace has the window
    # profiled in every run: without --trace 1, the device's timeline alone
    device_e2e = (device.type == "cuda" and any(
        m["source"] == "device_trace" for m in cell.end_to_end))
    if trace or device_e2e:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] if trace else []
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    try:
        with ctx.span("window"):
            win = job.window(seconds)
            ctx.sync()
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    after = _launches()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    job.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    compared = dict(job.check())
    compared["failed"] = (win.failed, 0)
    t2 = time.perf_counter()
    tr = trace_mod.from_profiler(prof) if prof is not None else None
    print(f"setup {setup_s:.3f} s, window {win.seconds:.3f} s ("
          f"{win.completed} done, {win.nbytes} B), reference {t2 - t1:.3f} "
          f"s, trace {time.perf_counter() - t2:.3f} s", file=sys.stderr)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    r = Readings(setup_s=setup_s, window=win,
                 launches={k: after[k] - before[k] for k in after},
                 device_kind=kind, trace=tr)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": kind, "count": cell.chips,
           "memory_peak_bytes": int(peak)}
    out = {"correct": all(v <= lim for v, lim in compared.values()),
           "attempted": win.attempted, "failed": win.failed}
    if trace:
        out["metrics"] = _read(cell, cell.per_layer, r, required=False)
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        out["breakdown"] = {
            "device_ops": sorted(tr.ops.items(), key=lambda kv: -kv[1])
            [:BREAKDOWN_TOP],
            "idle_gaps": sorted(tr.idle.items(), key=lambda kv: -kv[1])
            [:BREAKDOWN_TOP]}
    else:
        out["metrics"] = _read(cell, cell.end_to_end, r, required=True)
    out["device"] = dev
    out["compared"] = {k: {"value": v, "limit": lim}
                       for k, (v, lim) in compared.items()}
    return out
