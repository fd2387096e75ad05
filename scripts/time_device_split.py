#!/usr/bin/env python3
"""The whole encode from the text with the host pre-split against the same
encode with the device pre-split (K15), in turns, on one NVIDIA GPU.

    python3 scripts/time_device_split.py

Both tokenizers are RegexTokenizers with the smoke golden's 768 merges
(GPT-4 split, the dense route); one sets ``device_presplit``. On the smoke
corpus (397,366 bytes) and the XL corpus (12,588,338 bytes) it calls
``encode`` in rounds of host, device, device, host, each call's wall time
synchronised (encode returns a host list), and reports the median and the
least of each; then each encode's device busy time (torch.profiler, as
chip_smoke.py phase 4) and its idle share against the median wall; and
K15's device time on each corpus (presplit_seg_ids through its wrapper,
CUDA events behind a sleeping kernel). Both encodes must give the same
ids. It prints one JSON object, then the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def walls(torch, fns: dict, rounds: int) -> dict:
    """{name: [wall ms]}: the two encodes in turns (a, b, b, a) a round."""
    a, b = list(fns)
    out = {a: [], b: []}
    for _ in range(rounds):
        for name in (a, b, b, a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fns[name]()
            out[name].append((time.perf_counter() - t0) * 1e3)
    return out


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        return chip_smoke.fail("CUDA is not available")
    from minbpe_tpu_torch import RegexTokenizer, kernels
    from minbpe_tpu_torch.convert import tokenizer_from_arrays
    from minbpe_tpu_torch.ops import device_presplit as pdp
    from minbpe_tpu_torch.utils import golden as golden_mod

    kernels.build()
    merges = golden_mod.load_golden()["merges"]
    host, dev = (tokenizer_from_arrays(RegexTokenizer, merges,
                                       256 + np.arange(len(merges)),
                                       device="cuda") for _ in range(2))
    dev.device_presplit = True
    out = []
    for name, text, rounds in (
            ("smoke", golden_mod.smoke_corpus(ROOT), 15),
            ("xl", golden_mod.xl_corpus(ROOT), 3)):
        fns = {"host_split": lambda: host.encode(text),
               "device_split": lambda: dev.encode(text)}
        if fns["host_split"]() != fns["device_split"]():
            raise AssertionError(f"{name}: the two encodes differ")
        w = walls(torch, fns, rounds)
        rec = dict(case=name, bytes=len(text.encode("utf-8")), rounds=rounds)
        for key, fn in fns.items():
            busy = sum(p[0] for p in chip_smoke.profiled_events(torch, fn))
            med = statistics.median(w[key])
            rec[key] = dict(wall_ms_median=med, wall_ms_least=min(w[key]),
                            walls_ms=w[key], device_busy_ms=busy,
                            idle_share=1 - busy / med)
        raw = text.encode("utf-8")
        data = torch.frombuffer(bytearray(raw), dtype=torch.uint8).cuda()
        rec["k15_ms"] = chip_smoke.device_ms(
            torch, lambda: pdp.presplit_seg_ids(data, len(raw), "gpt4"),
            20 if len(raw) < 1 << 22 else 5)
        out.append(rec)
        print(f"{name}: " + ", ".join(
            f"{k} median {rec[k]['wall_ms_median']:.3f} ms, least "
            f"{rec[k]['wall_ms_least']:.3f}, busy "
            f"{rec[k]['device_busy_ms']:.3f}" for k in fns)
            + f"; K15 {rec['k15_ms']:.4f} ms", file=sys.stderr)
    print(json.dumps({"device_split": out}))
    print(chip_smoke.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
