"""The 95th percentile latency of every request of the window, ms."""

from bpebench.readers import percentile_ms


def read(r):
    return percentile_ms(r, 95)
