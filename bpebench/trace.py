"""Reduce a torch.profiler trace of the measured window to device numbers.

The harness marks its own spans with ``torch.profiler.record_function``
under names that begin with ``bench.``; the window is ``bench.window``.
Device time is the union of the intervals in which any device operation
ran (kernels, copies, sets), clipped to the window. An idle gap is a span
of the window in which none ran; it is put down to the innermost harness
span that holds its middle, or to ``window`` where the harness was between
its own spans.

A run whose end-to-end metrics read the device's trace profiles its window
in every run; without ``--trace 1`` it records the device's timeline alone,
and no harness span.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

PREFIX = "bench."


@dataclass
class Trace:
    window_s: float
    busy_s: float
    # seconds of device time by operation name, clipped to the window
    ops: dict[str, float] = field(default_factory=dict)
    # idle seconds by the harness span that held them
    idle: dict[str, float] = field(default_factory=dict)

    def op_seconds(self, *parts: str) -> float:
        """Device seconds of the operations whose name holds any of
        ``parts``."""
        return sum(s for name, s in self.ops.items()
                   if any(p in name for p in parts))


def short_name(name: str) -> str:
    """An operation's name without its trailing argument list."""
    if not name.endswith(")"):
        return name
    depth = 0
    for i in range(len(name) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(name[i], 0)
        if depth == 0:
            return name[:i].strip() or name
    return name


def union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """Sorted, merged intervals."""
    out: list[tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def reduce(device: list[tuple[int, int, str]],
           spans: list[tuple[int, int, str]]) -> Trace:
    """``device``: (start ns, end ns, name) of each device operation;
    ``spans``: (start ns, end ns, name) of each harness span, names without
    the prefix; one of them is ``window``. Without any span (a trace of the
    device alone, taken over the window and nothing else), the window is
    the trace's own extent."""
    if not spans:
        if not device:
            return Trace(window_s=0.0, busy_s=0.0)
        spans = [(min(a for a, _, _ in device), max(b for _, b, _ in device),
                  "window")]
    windows = [(a, b) for a, b, n in spans if n == "window"]
    if len(windows) != 1:
        raise ValueError(f"{len(windows)} window spans in the trace")
    w0, w1 = windows[0]
    ops: dict[str, float] = {}
    clipped = []
    for a, b, name in device:
        a, b = max(a, w0), min(b, w1)
        if b > a:
            clipped.append((a, b))
            key = short_name(name)
            ops[key] = ops.get(key, 0.0) + (b - a) * 1e-9
    busy = union(clipped)
    busy_ns = sum(b - a for a, b in busy)
    # leaf spans, by start; the harness's spans inside the window do not
    # overlap one another
    leaves = sorted((a, b, n) for a, b, n in spans
                    if n != "window" and a < w1 and b > w0)
    starts = [a for a, _, _ in leaves]
    idle: dict[str, float] = {}
    edge = w0
    for a, b in busy + [(w1, w1)]:
        if a > edge:
            mid = (edge + a) // 2
            k = bisect.bisect_right(starts, mid) - 1
            name = (leaves[k][2] if k >= 0 and leaves[k][1] >= mid
                    else "window")
            idle[name] = idle.get(name, 0.0) + (a - edge) * 1e-9
        edge = max(edge, b)
    return Trace(window_s=(w1 - w0) * 1e-9, busy_s=busy_ns * 1e-9, ops=ops,
                 idle=idle)


def from_profiler(prof) -> Trace:
    """The Trace of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    device, spans = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name.startswith(PREFIX):
            # the profiler also draws each harness span on the device's
            # timeline, from its first operation to its last: not device work
            if e.device_type() != DeviceType.CUDA:
                spans.append((e.start_ns(), e.end_ns(), name[len(PREFIX):]))
        elif e.device_type() == DeviceType.CUDA:
            device.append((e.start_ns(), e.end_ns(), name))
    return reduce(device, spans)
