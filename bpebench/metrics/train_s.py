"""Seconds a training job takes: the window's host seconds over the jobs
completed in it."""


def read(r):
    w = r.window
    return w.seconds / w.completed if w.completed else None
