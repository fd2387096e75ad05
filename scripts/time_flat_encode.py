#!/usr/bin/env python3
"""Device time of the sorted route's kernels, K11 ``chunk_encode`` and K12
``encode_min_sweep``, on one NVIDIA GPU.

    python3 scripts/time_flat_encode.py

Times each kernel through its Python wrapper at chip_smoke.py's phase-2
shapes (chip_smoke.flat_shapes: the smoke corpus's GPT-4 split with the
GPT-4 table at 100,256 synthetic ranks and with smoke_plus_4353 for K11;
the first 65,536 bytes as one chunk with both, the whole corpus as one
chunk with the vocab-8192 golden's merges, and the corpus cut into chunks
of 257-4,096 bytes with smoke_plus_4353 for K12), and prints the sha256 of
each output (the tokens in chunk order, then the per-chunk counts) beside
the time. A K12 whose wrapper takes (ids, seg, table) (a stream of the long
chunks) is called so; one that takes (ids, bounds, which, table, out, lens)
so, and then each K12 shape also reports its rounds
(kernels.sweep_rounds): the longest chunk's, their sum, and the distinct
ranks applied anywhere (the rounds of a sweep whose rounds are global).
Then the GPT-4 encode path (ops/flat_encode.encode_offsets_arrays on the
smoke corpus's split at 100,256 synthetic ranks, bytes to ids on the host:
chip_smoke.py phase 4's encode_gpt4), its wall time a call, synchronised,
the median of 30 calls; and K10 ``encode_sweep`` on the smoke corpus's
stream with the golden's 768 merges (chip_smoke.phase_sweep's main case).
It goes through the wrappers alone, so it also times an earlier commit's
package: unpack that commit with git archive into _archive/, copy this
script and chip_smoke.py into it, and run both trees in turns in one call;
equal hashes show equal outputs. It prints one JSON object, {"api",
"root", "shapes": [{"case", "kernel", "n", "chunks", "n_out", "ms" (or
"wall_ms"), "sha256", ...}]}, then the card's name and power limit.
"""

from __future__ import annotations

import hashlib
import inspect
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def shape_fns(torch, np, kernels, data, ends, table, long_only):
    """(api, run, result): run() makes one wrapper call over the shape's
    chunks (K11: those of at most CHUNK_WARP_MAX tokens; K12: all, each
    longer); result() gives (tokens in chunk order, per-chunk counts) of
    the last call as numpy arrays."""
    dev = table.rows.device
    N, C = len(data), len(ends)
    L = np.diff(ends, prepend=0)
    ids = torch.from_numpy(data.astype(np.int32)).to(dev)
    bounds = torch.from_numpy(np.r_[0, ends].astype(np.int32)).to(dev)
    which = torch.from_numpy(np.arange(C, dtype=np.int32)).to(dev)
    out = torch.full((N + 1,), -1, dtype=torch.int32, device=dev)
    lens = torch.zeros(C + 1, dtype=torch.int32, device=dev)

    def placed():
        o, n = out[:N].cpu().numpy(), lens[:C].cpu().numpy()
        starts = np.r_[0, ends[:-1]]
        return (np.concatenate([o[s:s + k] for s, k in zip(starts, n)]),
                n.astype(np.int64))

    fn = kernels.encode_min_sweep if long_only else kernels.chunk_encode
    params = inspect.signature(fn).parameters
    kw = {}
    if "lanes" in params:  # the short chunks first, as ops/flat_encode does
        from minbpe_tpu_torch.ops.flat_encode import k11_order

        order, kw["lanes"] = k11_order(L, L <= kernels.CHUNK_WARP_MAX)
        which = torch.from_numpy(order).to(dev)
    if "lengths" in params:
        kw["lengths"] = L.tolist()
    if sum(p.kind == p.POSITIONAL_OR_KEYWORD for p in params.values()) == 6:
        return ("chunks",
                lambda: fn(ids, bounds, which, table, out, lens, **kw),
                placed)
    seg = torch.from_numpy(np.repeat(np.arange(C, dtype=np.int32), L)).to(
        dev)
    got = []

    def run():
        got[:] = [fn(ids, seg, table)]

    def result():
        i, s, n = got[0]
        k = int(n)
        return (i[:k].cpu().numpy(),
                np.bincount(s[:k].cpu().numpy(), minlength=C).astype(
                    np.int64))

    return "stream", run, result


def digest(np, tokens, counts) -> str:
    h = hashlib.sha256(np.ascontiguousarray(tokens, np.int32).tobytes())
    h.update(np.ascontiguousarray(counts, np.int64).tobytes())
    return h.hexdigest()


def gpt4_wall_record(torch, np, gpt4, golden_mod, reps=30):
    """The GPT-4 encode path over the smoke corpus's split: its wall time a
    call (synchronised; the median and the least of ``reps`` calls after a
    warm one) and its output's sha256."""
    from minbpe_tpu_torch.engine import device_table
    from minbpe_tpu_torch.ops.flat_encode import encode_offsets_arrays

    data, ends = gpt4._split_arrays(golden_mod.smoke_corpus(ROOT))
    table = device_table(gpt4).cuckoo
    walls = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tokens, counts, _ = encode_offsets_arrays(data, ends, table)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    rec = dict(case="encode_gpt4", kernel="flat_encode", n=len(data),
               chunks=len(ends), n_out=len(tokens),
               wall_ms=statistics.median(walls[1:]),
               wall_ms_min=min(walls[1:]),
               sha256=digest(np, tokens, counts))
    print("encode_gpt4: " + ", ".join(f"{key} {v}" for key, v in rec.items()
                                      if key != "case"), file=sys.stderr)
    return rec


def k10_record(torch, np, kernels, golden_mod):
    """K10 over the smoke corpus's device stream with the golden's 768
    merges: its time and its output's sha256."""
    from minbpe_tpu_torch import RegexTokenizer
    from minbpe_tpu_torch.convert import tokenizer_from_arrays
    from minbpe_tpu_torch.ops.stream import build_stream

    golden = golden_mod.load_golden()
    M = len(golden["merges"])
    tok = tokenizer_from_arrays(RegexTokenizer, golden["merges"],
                                256 + np.arange(M), device="cuda")
    ids, seg = build_stream(*tok._split_arrays(
        golden_mod.smoke_corpus(ROOT)), "cuda")
    pt = torch.tensor(golden["merges"], dtype=torch.int32, device="cuda")
    zt = torch.tensor(256 + np.arange(M), dtype=torch.int32, device="cuda")
    got = kernels.encode_sweep(ids, seg, pt, zt)
    k = int(got[2])
    tokens, segs = got[0][:k].cpu().numpy(), got[1][:k].cpu().numpy()
    rec = dict(case="smoke_768", kernel="encode_sweep", n=ids.numel(),
               ranks=M, n_out=k,
               ms=chip_smoke.device_ms(torch, lambda: kernels.encode_sweep(
                   ids, seg, pt, zt), 20),
               sha256=digest(np, tokens, segs))
    print("smoke_768: " + ", ".join(f"{key} {v}" for key, v in rec.items()
                                    if key != "case"), file=sys.stderr)
    return rec


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        return chip_smoke.fail("CUDA is not available")
    from minbpe_tpu_torch import kernels
    from minbpe_tpu_torch.engine import device_table
    from minbpe_tpu_torch.utils import golden as golden_mod

    kernels.build()
    gpt4, plus, _ = chip_smoke.sorted_tables(golden_mod)
    out = []
    api = None
    for name, data, ends, tok, long_only in chip_smoke.flat_shapes(
            np, golden_mod, gpt4, plus):
        table = device_table(tok).cuckoo
        k12_api, run, result = shape_fns(torch, np, kernels, data, ends,
                                         table, long_only)
        if long_only:
            api = k12_api
        run()
        tokens, counts = result()
        reps = 3 if name == "whole_smoke_8192" else 20
        rec = dict(case=name, kernel="encode_min_sweep" if long_only
                   else "chunk_encode", n=len(data), chunks=len(ends),
                   n_out=int(counts.sum()),
                   ms=chip_smoke.device_ms(torch, run, reps),
                   sha256=digest(np, tokens, counts))
        if long_only and k12_api == "chunks":
            dev = table.rows.device
            L = np.diff(ends, prepend=0)
            rounds, union = kernels.sweep_rounds(
                torch.from_numpy(data.astype(np.int32)).to(dev),
                torch.from_numpy(np.repeat(np.arange(len(ends),
                                                     dtype=np.int32),
                                           L)).to(dev), table)
            rec.update(rounds_max=int(rounds.max()),
                       rounds_sum=int(rounds.sum()), rounds_union=union)
        out.append(rec)
        print(f"{name}: " + ", ".join(f"{k} {v}" for k, v in rec.items()
                                      if k != "case"), file=sys.stderr)
        torch.cuda.empty_cache()
    out.append(gpt4_wall_record(torch, np, gpt4, golden_mod))
    out.append(k10_record(torch, np, kernels, golden_mod))
    print(json.dumps({"api": api, "root": ROOT, "shapes": out}))
    print(chip_smoke.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
