"""Warm start: pay a process's one-time costs before its first request.

The port's counterpart of minbpe_tpu/utils/precompile.py. A fresh process
pays, on its first train or encode on the card: the nvcc build of
csrc/bpe_kernels.cu and the g++ build of csrc/presplit.cpp (each skipped
where ``_build/`` already holds the library for the same source), loading
both libraries, creating the CUDA context, the first launch of each kernel
(CUDA loads a kernel's module at its first launch), and the caching
allocator's first blocks at each size. ``precompile`` pays them at service
start instead: it builds both libraries at once, loads them, and then, per
size bucket, trains a RegexTokenizer and encodes with it, as minbpe_tpu's
does.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor

# stream elements per count tile of minbpe_tpu's fused trainer
# (ops/pallas/fused_train.py:74): the buckets' floor and granule
TILE_ELEMS = 16384


def fused_capacity(n: int) -> int:
    """minbpe_tpu's size bucket of an n-token stream
    (ops/pallas/fused_train.py:77-86): n rounded up to an eighth of its
    power-of-two octave, at least one tile, so that both packages warm the
    same buckets."""
    p = 1 << max(n - 1, 1).bit_length()
    gran = max(TILE_ELEMS, p // 8)
    return max(TILE_ELEMS, -(-n // gran) * gran)


def _fake_text(n_bytes: int) -> str:
    # pseudo-random ASCII words: ~1.4K distinct byte pairs, so training
    # sustains ~1K merge rounds even at small sizes (deterministic seed)
    import random

    rng = random.Random(20260820)
    alphabet = "abcdefghijklmnopqrstuvwxyz0123456789"
    out = []
    size = 0
    while size < n_bytes:
        w = "".join(rng.choice(alphabet) for _ in range(rng.randint(2, 9)))
        w += rng.choice("  ,.")
        out.append(w)
        size += len(w)
    return "".join(out)[:n_bytes]


def _build_libraries(device) -> float:
    """Build the pre-split scanner, and on a CUDA device the kernels, at
    once; load both (the kernels on the device's context). Returns the
    seconds it took. Raises if a build or a load fails."""
    import torch

    from .. import kernels
    from . import native

    t0 = time.perf_counter()
    cuda = device.type == "cuda"
    with ThreadPoolExecutor(max_workers=2) as ex:
        fk = ex.submit(kernels.build) if cuda else None
        fn = ex.submit(native.build)
        if fk is not None:
            fk.result()
        fn.result()
    native.available()
    if cuda:
        kernels._load()
        torch.zeros(1, device=device)
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0


def precompile(sizes, vocab_size: int = 512, tokenizer=None, train=True,
               verbose: bool = False, device=None):
    """Warm every path a deployment will take.

    sizes: corpus byte sizes; each is rounded up to its bucket
    (``fused_capacity``), and each bucket is warmed once.

    tokenizer: a trained tokenizer whose encode paths to warm (its table
    picks the encode route). If None, a RegexTokenizer is trained at
    ``vocab_size`` per bucket (on the bucket's text, or with
    ``train=False`` on its first 16 KiB) and its encode warmed.

    device: where to warm (None: the tokenizer's, else cuda; raises without
    CUDA unless "cpu"). Before the buckets, the libraries are built and
    loaded.

    Returns [(bucket, seconds)] for the buckets warmed.
    """
    from ..base import resolve_device
    from ..regex import RegexTokenizer

    if device is None and tokenizer is not None:
        device = tokenizer.device
    device = resolve_device(device)
    build_s = _build_libraries(device)
    if verbose:
        print(f"precompile: libraries built and loaded in {build_s:.1f}s")
    done = []
    seen = set()
    for n in sorted(set(int(s) for s in sizes)):
        bucket = fused_capacity(n)
        if bucket in seen:
            continue
        seen.add(bucket)
        text = _fake_text(bucket - bucket // 64)  # land inside the bucket
        t0 = time.time()
        if tokenizer is None:
            tok = RegexTokenizer(device=device)
            if train:
                tok.train(text, vocab_size)
            else:
                tok.train(text[: 1 << 14], vocab_size)
        else:
            tok = tokenizer
        tok.encode_ordinary(text)
        tok.encode(text[:512], allowed_special="all")
        tok.encode_ordinary("a" * 64)  # one chunk: the rank sweep
        dt = time.time() - t0
        done.append((bucket, round(dt, 2)))
        if verbose:
            print(f"precompile: bucket {bucket} warmed in {dt:.1f}s")
    return done
