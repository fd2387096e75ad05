"""Set-up seconds: from the process's start to the window's (imports, the
kernels' build or load, inputs, the tokenizer, the warm-up)."""


def read(r):
    return r.setup_s
