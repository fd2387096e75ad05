#!/usr/bin/env python3
"""Device time of the sort-round trainer's count and selection on one
NVIDIA GPU.

    python3 scripts/time_pair_select.py

Times one round's count and selection through the Python wrappers at
chip_smoke.py's phase-2 shapes (chip_smoke.table_cases: 400K Zipf tokens,
the smoke stream after 4,000 merges, 2^20 copies of "a", 2^20 distinct
ids, the XL stream and it four times over). A package with K13
``pair_select`` is timed one launch a round; one with K13 ``pair_table``
and K14 ``table_select`` has each timed alone, with an event between the
two, and their sum beside them. Each round's record is first held against
ops/select.select_max_pair. It goes through the wrappers alone, so it also
times an earlier commit's package: unpack that commit with git archive
into _archive/, copy this script and chip_smoke.py into it, and run both
trees in turns in one call. It prints one JSON object, {"api", "shapes":
[{"case", "n", "distinct", "ms", ...}]}, then the card's name and power
limit.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def round_fns(torch, kernels, ids, seg):
    """(api, fns, sel): the calls of one round on a table made once, and
    the tensor they write the round's (pa, pb, count, ok) to."""
    dev = ids.device
    n = torch.full((1,), ids.numel(), dtype=torch.int32, device=dev)
    fail = torch.ones(1, dtype=torch.int32, device=dev)
    sel = torch.zeros(4, dtype=torch.int32, device=dev)
    pairs = torch.zeros((1, 2), dtype=torch.int32, device=dev)
    counts = torch.zeros(1, dtype=torch.int32, device=dev)
    t = kernels.PairTable(ids.numel(), dev)

    if hasattr(kernels, "pair_select"):
        def k13():
            kernels.pair_select(ids, seg, n, t, sel, pairs, counts, fail, 0)

        return "pair_select", [k13], sel

    def k13():
        kernels.pair_table(ids, seg, n, t, fail, 0)

    def k14():
        kernels.table_select(t, sel, pairs, counts, fail, 0)

    return "pair_table+table_select", [k13, k14], sel


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        return chip_smoke.fail("CUDA is not available")
    from minbpe_tpu_torch import kernels
    from minbpe_tpu_torch.ops.select import select_max_pair
    from minbpe_tpu_torch.utils import golden as golden_mod

    kernels.build()
    texts = chip_smoke.text_streams(torch, np, kernels, golden_mod)
    cases = chip_smoke.table_cases(torch, np, kernels, golden_mod, texts)
    del texts
    out = []
    api = None
    for name, ids, seg in cases:
        api, fns, sel = round_fns(torch, kernels, ids, seg)
        for fn in fns:
            fn()
        pa, pb, c, ok = select_max_pair(
            ids, seg, torch.full((1,), ids.numel(), dtype=torch.int32,
                                 device=ids.device))
        want = [int(pa), int(pb), int(c), 1] if bool(ok) else [-1, -1, 0, 0]
        if sel.tolist() != want:
            raise AssertionError(f"{name}: {sel.tolist()} != {want}")
        a, b = ids[:-1].long(), ids[1:].long()
        D = torch.unique(((a << 32) | b)[seg[:-1] == seg[1:]]).numel()
        del a, b
        reps = 10 if ids.numel() > (1 << 22) else 50
        ms = chip_smoke.split_ms(torch, fns, reps)
        rec = dict(case=name, n=ids.numel(), distinct=D)
        if api == "pair_select":
            rec["ms"] = ms[0]
        else:
            rec.update(ms=ms[0] + ms[1], k13_ms=ms[0], k14_ms=ms[1])
        out.append(rec)
        print(f"{name}: n {rec['n']}, D {D}, "
              + ", ".join(f"{k} {v:.5f}" for k, v in rec.items()
                          if k.endswith("ms")), file=sys.stderr)
        torch.cuda.empty_cache()
    print(json.dumps({"api": api, "root": ROOT, "shapes": out}))
    print(chip_smoke.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
