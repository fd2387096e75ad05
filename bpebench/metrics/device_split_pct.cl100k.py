"""The share of the window's encode texts that the program split on the
device, %: its counter ``encode.route.device_split`` over that and
``encode.route.host_split``, as the window changed them (the kind's
``RanksWindow.counters``). Below 100, some request fell back to the host
split."""


def read(r):
    c = getattr(r.window, "counters", None) or {}
    device = c.get("encode.route.device_split", 0)
    host = c.get("encode.route.host_split", 0)
    return 100.0 * device / (device + host) if device + host else None
