"""Arithmetic that the metric readers share. Each returns None where the
run gives it nothing to read, never 0 for a share of a peak."""

from __future__ import annotations

import json
import math
import os

_PEAKS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "peaks.json")


def percentile_ms(r, q: float):
    """The ``q``-th percentile (nearest rank) of the latencies of every
    request completed in the window, in ms."""
    lat = sorted(r.window.latencies)
    if not lat:
        return None
    return 1e3 * lat[max(0, math.ceil(q / 100 * len(lat)) - 1)]


def idle_pct(r):
    """The share of the traced window in which no device operation ran."""
    t = r.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def roofline_pct(r):
    """The least bytes the window's work must move, at the card's peak
    bandwidth, over the device's busy time in the window."""
    t = r.trace
    with open(_PEAKS) as f:
        peak = json.load(f).get(r.device_kind)
    if t is None or peak is None or t.busy_s <= 0 or r.window.work_bytes <= 0:
        return None
    return 100.0 * r.window.work_bytes / peak["hbm_bytes_per_s"] / t.busy_s
