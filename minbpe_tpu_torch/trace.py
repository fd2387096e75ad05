"""The port's spans and counters: one system for both.

A span names one host step of a public call (``span("stream.build")``).
Off, which is the default, ``span`` returns one shared null context: a
module attribute read, no allocation and no torch call. On (``enable`` or
``enabled``), it opens a user-scope record function ``"minbpe." + name``,
as ``torch.profiler.record_function`` does, so a profiler that records
the CPU puts the step in its trace on the same clock as the device's
activity, and an idle gap of the device can be put down to the host step
that held it. It opens it through ``_RecordFunctionFast``, a context
made in C++, which costs a span several times less than the Python
wrapper ``record_function`` (PERF.md). Nothing turns the spans on
but ``enable``: ``engine.run_train(profile_dir=...)`` does, and a
measurement that wants them does; a profiler alone does not.

A span's parent is the innermost span that holds it on the same thread.
The program calls into the device from one thread, so every span of one
public call lies inside that call's root span (``api.train``,
``api.encode``, ``api.encode_batch``), which is the request's identity.

Counters are plain ints in ``COUNTERS``, always on, as the kernels'
launch counters are. ``sync.<site>`` counts each pass through a site
where the host waits for the card (a ``.item()``, ``.tolist()`` or
``.cpu()`` of a device tensor, a blocking copy from pageable host memory,
``mem_get_info``); ``train.slots`` the whole-run trainer's rebuild slots;
``comm.calls`` the distributed layer's collectives; ``encode.route.*`` an
encode's routes: ``device_split`` or ``host_split`` a text (or a text part
between special tokens) by where it was split, ``segments`` (K17) or
``sweep`` (K10) an ``encode_stream`` call. Read them as the
difference of two snapshots, or ``reset`` them first.
"""

from __future__ import annotations

import contextlib

import torch

PREFIX = "minbpe."

ENABLED = False
COUNTERS: dict[str, int] = {}

_NULL = contextlib.nullcontext()


def span(name: str):
    """The context of the host step ``name``: recorded as ``minbpe.<name>``
    while the spans are on, the shared null context while they are off."""
    if not ENABLED:
        return _NULL
    return torch._C._profiler._RecordFunctionFast(PREFIX + name)


def enable(on: bool = True) -> bool:
    """Turn the spans on or off; returns whether they were on."""
    global ENABLED
    was, ENABLED = ENABLED, bool(on)
    return was


@contextlib.contextmanager
def enabled(on: bool = True):
    """The spans on (or off) inside the block, as they were after it."""
    was = enable(on)
    try:
        yield
    finally:
        enable(was)


def count(name: str, k: int = 1):
    COUNTERS[name] = COUNTERS.get(name, 0) + k


def reset():
    COUNTERS.clear()
