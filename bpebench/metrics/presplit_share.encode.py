"""The device pre-split kernels' share of the device time in the traced
window, % (the program's kernels whose names begin with ``presplit``)."""


def read(r):
    t = r.trace
    names = [k for k in r.launches if k.startswith("presplit")]
    total = sum(t.ops.values()) if t is not None else 0.0
    if not names or total <= 0:
        return None
    split = t.op_seconds(*names)
    return 100.0 * split / total if split > 0 else None
