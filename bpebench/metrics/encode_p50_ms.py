"""The median latency of the window's requests, ms."""

from bpebench.readers import percentile_ms


def read(r):
    return percentile_ms(r, 50)
