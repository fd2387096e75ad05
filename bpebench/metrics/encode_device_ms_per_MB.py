"""The device's time to encode a MB: the seconds in which any device
operation ran during the window (the union of their intervals, from the
device's trace), over every document byte encoded in it, in ms a MB
(10^6 bytes). The card's own cost of the traffic, which the host's pace
does not move."""


def read(r):
    t, w = r.trace, r.window
    if t is None or t.busy_s <= 0 or w.nbytes <= 0:
        return None
    return 1e3 * t.busy_s / (w.nbytes / 1e6)
