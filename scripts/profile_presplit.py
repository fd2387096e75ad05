#!/usr/bin/env python3
"""Where K15's device time goes on one NVIDIA GPU: each kernel's phases,
from stamps the kernels write when built with -DPRESPLIT_STAMPS.

    python3 scripts/profile_presplit.py [--reps 30]

Builds the kernel library once more with -DPRESPLIT_STAMPS (a library of
its own in the build directory: ``kernels.library_path`` hashes the
flags), so thread 0 of block 0 of each K15 kernel writes the global timer
at the end of each phase (csrc/bpe_kernels.cu, PRESPLIT_STAMP). For each
shape (``chip_smoke.cluster_shapes``: the regex512-encode-docs cell's
median, mean-length and longest documents, and the smoke corpus's first
1, 2, 4 and 8 tiles) and each
kernel (``presplit_succ``, ``presplit_orbit``, and ``presplit_cluster``
where the package has it) it runs ``--reps`` single launches, each alone
on an idle card, and reports the median ns of each phase (from the
kernel's first stamp), and the kernel's device ms a call back to back
(``chip_smoke.device_ms``: CUDA events behind a sleeping kernel). The
difference between the two is the launch and the drain that no stamp
sees. One empty kernel (``torch.cuda._sleep(0)``) gives the card's floor
a launch. It prints one JSON object, then the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

# each kernel's stamp kind and the name of each phase, in stamp order
# (csrc/bpe_kernels.cu: PRESPLIT_STAMP(kind, k) at the end of phase k)
PHASES = {
    "presplit_succ": (0, ["start", "ascii_table", "p1_fetch_stage",
                          "p1_scan", "grid_sync", "p2_lookright",
                          "p3_fetch_stage", "p3_successors", "p3_write"]),
    "presplit_orbit": (1, ["start", "s1_load_f", "s1_doubling",
                           "s1_exits_dedupe", "grid_sync_1", "s2_path",
                           "grid_sync_2_base", "s4_entry_walk",
                           "s4_marks_segments"]),
    "presplit_cluster": (2, ["start", "stage", "scan", "cluster_sync_1",
                             "successors", "walks", "cluster_sync_2",
                             "path", "cluster_sync_3", "entry_marks",
                             "segments"]),
}


def stamped(torch, np, lib, fn, kind, names, reps):
    """Median ns from the first stamp to each phase's, over reps single
    launches of fn."""
    buf = np.zeros((3, 16, 2), np.int64)
    runs = []
    for _ in range(reps):
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
        err = lib.bpe_presplit_stamps(buf.ctypes.data)
        if err:
            raise RuntimeError(f"bpe_presplit_stamps: CUDA error {err}")
        g = buf[kind, :len(names), 1]
        runs.append(g - g[0])
    return {name: float(statistics.median(r[k] for r in runs))
            for k, name in enumerate(names)}


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        return chip_smoke.fail("CUDA is not available")
    from minbpe_tpu_torch import kernels
    from minbpe_tpu_torch.ops import device_presplit as pdp
    from minbpe_tpu_torch.utils import golden as golden_mod

    kernels.NVCC_FLAGS = [*kernels.NVCC_FLAGS, "-DPRESPLIT_STAMPS"]
    lib = kernels._load()
    empty_ms = chip_smoke.device_ms(torch, lambda: torch.cuda._sleep(0), 200)
    out = []
    for name, raw in chip_smoke.cluster_shapes(np, golden_mod):
        n = len(raw)
        data = torch.frombuffer(bytearray(raw), dtype=torch.uint8).cuda()
        f = pdp.presplit_succ(data, n, "gpt4")
        calls = {"presplit_succ": lambda: pdp.presplit_succ(data, n, "gpt4"),
                 "presplit_orbit": lambda: pdp.presplit_orbit(f, n)}
        if hasattr(pdp, "presplit_cluster") and n <= pdp.CLUSTER_MAX_N:
            calls["presplit_cluster"] = lambda: pdp.presplit_cluster(
                data, n, "gpt4")
        rec = {"case": name, "n": n, "tiles": -(-n // kernels.PRESPLIT_TILE)}
        for kname, fn in calls.items():
            kind, names = PHASES[kname]
            rec[kname] = {
                "device_ms": chip_smoke.device_ms(torch, fn, 50),
                "phase_ns": stamped(torch, np, lib, fn, kind, names,
                                    args.reps)}
        out.append(rec)
        print(json.dumps(rec), file=sys.stderr)
    print(json.dumps({"root": ROOT, "empty_kernel_ms": empty_ms,
                      "shapes": out}))
    print(chip_smoke.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
