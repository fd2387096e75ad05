"""The program's kernel launches a training job, from its counters."""


def read(r):
    w = r.window
    return sum(r.launches.values()) / w.completed if w.completed else None
