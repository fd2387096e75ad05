#!/usr/bin/env python3
"""The distributed layer at world size 4 over NCCL, one rank a card.

    python -m torch.distributed.run --nnodes 1 --nproc-per-node 4 \\
        --master-addr 127.0.0.1 --master-port 29533 scripts/dist_nccl_check.py

Each rank runs chip_smoke.py's world-4 paths (chip_smoke.dist_paths) on
its own card: smoke-1024 by the dense selection (768 merges) and by the
sparse and owner selections (the golden's first 256 merges), each
against the golden's merges, counts and fail round; the Basic byte path
on the smoke corpus's first 64 KB; the sharded encode against the
golden's ids; every path's launches held exactly. Rank 0 also holds the
Basic path to the single-device BasicTokenizer and prints one JSON object
{"nccl_world4": {path: {wall_s, collectives, rounds_per_s}},
"devices": [...]}, then the first card's
name and power limit. Exits non-zero on any failure.
"""

from __future__ import annotations

import datetime
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def main() -> int:
    import numpy as np
    import torch
    import torch.distributed as dist

    from minbpe_tpu_torch import BasicTokenizer, kernels
    from minbpe_tpu_torch.parallel import multihost
    from minbpe_tpu_torch.parallel.comm import Comm, default_device
    from minbpe_tpu_torch.utils import golden as golden_mod

    if not torch.cuda.is_available():
        return chip_smoke.fail("CUDA is not available")
    multihost.initialize(backend="nccl",
                         timeout=datetime.timedelta(seconds=300))
    dev = default_device()
    torch.cuda.set_device(dev)
    rank = dist.get_rank()
    if rank == 0:
        kernels.build()  # once, before the other ranks load it
    dist.barrier()
    comm = Comm(device=dev)
    inp = chip_smoke.dist_inputs(np, golden_mod)
    scratch = os.path.join(kernels.BUILD_DIR, f"nccl_check_{rank}")
    os.makedirs(scratch, exist_ok=True)
    launches, timings = {}, {}
    chip_smoke.dist_paths(torch, np, comm, inp, golden_mod, 4, scratch,
                          launches, timings)
    basic = {tuple(p): 256 + i for i, p in
             enumerate(timings["dist4_basic"].pop("merges"))}
    if rank == 0:
        single = BasicTokenizer(device=dev)
        single.train(inp["basic"].decode("utf-8"),
                     256 + chip_smoke.BASIC_MERGES)
        if basic != single.merges:
            raise AssertionError("the Basic path over NCCL differs from the "
                                 "single-device BasicTokenizer")
        print(json.dumps({"nccl_world4": timings, "devices": [
            torch.cuda.get_device_name(i)
            for i in range(torch.cuda.device_count())]}))
        print(chip_smoke.nvidia_smi_line())
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
