"""K17's share of the device time in the traced window, % (the device
operations whose name holds the program's kernel name
``segment_encode``)."""


def read(r):
    t = r.trace
    total = sum(t.ops.values()) if t is not None else 0.0
    if total <= 0:
        return None
    k17 = t.op_seconds("segment_encode")
    return 100.0 * k17 / total if k17 > 0 else None
