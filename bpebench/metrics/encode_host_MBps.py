"""Encode throughput by the host's clock: every document byte encoded in the
window, over the window's host seconds, in MB (10^6 bytes) a second."""


def read(r):
    w = r.window
    return w.nbytes / w.seconds / 1e6 if w.seconds > 0 else None
