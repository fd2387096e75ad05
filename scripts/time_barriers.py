#!/usr/bin/env python3
"""What one barrier of a barrier-synchronised sweep costs, on one NVIDIA GPU.

    python3 scripts/time_barriers.py

Times each barrier primitive (scripts/barriers.cu) over 10,000
back-to-back rounds of a trivial min-reduce, one barrier a round:
cg::this_grid().sync() over a cooperative grid of 32, 132 and 396 blocks of
256 threads; cg::this_cluster().sync() over one cluster of 1, 2, 4, 8 and
16 blocks of 256 threads (16 with the non-portable size allowed), with the
clusters of each size that fit on the card at once; __syncthreads() in one
block of 1,024 threads. Each: microseconds per round, the launch's own
time subtracted. Prints one JSON object, {"barriers": [...]}, then the
card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

SOURCE = os.path.join(ROOT, "scripts", "barriers.cu")
ROUNDS = 10_000


def build(nvcc_cmd, out):
    proc = subprocess.run(nvcc_cmd(out)[:-1] + [SOURCE], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc {out}: {proc.stderr}")
    return out


def barriers(lib):
    lib.round_ms.argtypes = [ctypes.c_int] * 3
    lib.round_ms.restype = ctypes.c_double
    lib.max_clusters.argtypes = [ctypes.c_int]
    out = []
    for kind, name, params in ((0, "grid.sync", (32, 132, 396)),
                               (1, "cluster.sync", (1, 2, 4, 8, 16)),
                               (2, "__syncthreads", (1024,))):
        for p in params:
            ms = lib.round_ms(kind, p, ROUNDS)
            rec = {"barrier": name, ("blocks" if kind < 2 else "threads"): p,
                   "us_per_round": ms * 1e3}
            if kind == 1:
                rec["clusters_at_once"] = lib.max_clusters(p)
            if ms < 0:
                rec = {**rec, "us_per_round": None, "cuda_error": -ms}
            out.append(rec)
            print(rec, file=sys.stderr)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        return chip_smoke.fail("CUDA is not available")
    from minbpe_tpu_torch import kernels

    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="barriers-", dir=kernels.BUILD_DIR)
    lib = ctypes.CDLL(build(kernels.build_command,
                            os.path.join(tmp, "libbarriers.so")))
    print(json.dumps({"barriers": barriers(lib)}))
    print(chip_smoke.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
