#!/usr/bin/env python3
"""Launch geometry of K1 pair_stats and K9 pair_count on one NVIDIA GPU.

    python3 scripts/tune_pair_hist.py [--default-only]

Both kernels count pairs into a block-private hash table of 1 << log2 slots
per block, over one contiguous range of the stream per block of a
persistent grid (minbpe_tpu_torch/csrc/bpe_kernels.cu, count_pairs). This
script times each kernel, into matrices allocated once, at chip_smoke.py's
phase-2 shapes and on four synthetic streams of the XL corpus's length that
take a position's cost apart: at the default geometry through the Python
wrapper, and at every table size and every grid from one block per SM up
to as many as fit through the C entry points, each result held against the
default's (which chip_smoke.py holds against the plain version). It prints
one JSON object per kernel and stream, {"kernel", "case", "n", "W",
"default": [0, grid, ms], "runs": [[log2, grid, ms], ...]}, then the card's
name and power limit, and fails where a geometry disagrees with the
default. With --default-only it times the default alone, through the
wrappers alone, so it also times an earlier build of the package.
"""

from __future__ import annotations

import json
import os
import sys

DEFAULT_ONLY = "--default-only"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

LOG2S = (10, 11, 12, 13, 14)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        return chip_smoke.fail("CUDA is not available")
    from minbpe_tpu_torch import kernels
    from minbpe_tpu_torch.engine import STEPPED_AUTO_MAX_N
    from minbpe_tpu_torch.ops.train import XL_MAX_N
    from minbpe_tpu_torch.utils import golden as golden_mod

    default_only = sys.argv[1:] == [DEFAULT_ONLY]
    lib = kernels._load()
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ids_h, seg_h = chip_smoke.smoke_stream(np, 400_000, 1024)
    ids = torch.from_numpy(ids_h).to(dev)
    seg = torch.from_numpy(seg_h).to(dev)
    ids2k, seg2k = (torch.from_numpy(a).to(dev)
                    for a in chip_smoke.smoke_stream(np, 400_000, 2048))
    texts = chip_smoke.text_streams(torch, np, kernels, golden_mod)
    cases = ([("zipf_400k", ids, seg, 1024, (True, False)),
              ("zipf_400k_v2048", ids2k, seg2k, 2048, (False,)),
              ("zipf_4m", *chip_smoke.xl_stream(torch, ids, seg,
                                                STEPPED_AUTO_MAX_N), 1024,
               (False,))]
             + [(name, t_ids, t_seg, W, (True, False))
                for name, t_ids, t_seg, W in texts]
             + [("zipf_48m", *chip_smoke.xl_stream(torch, ids, seg, XL_MAX_N),
                 1024, (True,))])

    def launcher(c_ids, c_seg, W, stats, log2, grid):
        """A call of K1 (stats) or K9 into matrices allocated once: through
        the wrapper at the default geometry, else through the C entry."""
        n = torch.full((1,), c_ids.numel(), dtype=torch.int32, device=dev)
        cnt = torch.zeros((W, W), dtype=torch.int32, device=dev)
        first = torch.full((W, W), -1, dtype=torch.int32, device=dev)
        if (log2, grid) == (0, 0):
            def call():
                if not stats:
                    return kernels.pair_count(c_ids, c_seg, n, W), first
                return kernels.pair_stats(c_ids, c_seg, n, W,
                                          out=(cnt, first))
            return call
        p = kernels._ptr
        if stats:
            args = (lib.bpe_pair_stats, p(c_ids), p(c_seg), p(n), None,
                    p(cnt), p(first), W, c_ids.numel(), log2, grid)
        else:
            args = (lib.bpe_pair_count, p(c_ids), p(c_seg), p(n), p(cnt), W,
                    c_ids.numel(), log2, grid)

        def run():  # n, cnt and first stay referenced while args point at them
            kernels._run(dev, *args)
            return cnt, first, n
        return run

    # the parts of a position's cost, at the XL corpus's length: loads and
    # the warp's match alone (no countable pair), one table insert per warp
    # step (one pair everywhere), 32 inserts per warp step into 32 keys
    # already held (lane l's 8 positions hold id l), and 32 claims and
    # inserts into a table that overflows (uniform ids, W = 1024)
    n_xl = texts[-1][1].numel()
    pos = torch.arange(n_xl, dtype=torch.int32, device=dev)
    zeros = torch.zeros_like(pos)
    rng = np.random.default_rng(chip_smoke.SEED)
    for name, c_ids, c_seg, W in (
            ("no_pairs", zeros, pos, 1024),
            ("one_pair", torch.full_like(pos, 5), zeros, 1024),
            ("lanes_32_keys", (pos // 8) % 32, zeros, 1024),
            ("uniform_w1024", torch.from_numpy(
                rng.integers(0, 1024, n_xl).astype(np.int32)).to(dev), zeros,
             1024)):
        cases.append((name, c_ids, c_seg, W, (True, False)))

    for name, c_ids, c_seg, W, kinds in cases:
        big = c_ids.numel() > (1 << 22)
        for stats in kinds:
            base = launcher(c_ids, c_seg, W, stats, 0, 0)
            want = [t.clone() for t in base()]
            # None for an earlier commit's build, which lacks it
            grid0 = (lib.bpe_pair_hist_grid(int(stats), c_ids.numel(), 0)
                     if hasattr(lib, "bpe_pair_hist_grid") else None)
            rec = dict(kernel="pair_stats" if stats else "pair_count",
                       case=name, n=c_ids.numel(), W=W,
                       default=[0, grid0, chip_smoke.device_ms(
                           torch, base, 10 if big else 50)],
                       runs=[])
            for log2 in () if default_only else LOG2S:
                most = lib.bpe_pair_hist_grid(int(stats), 1 << 30, log2)
                if most < 1:
                    raise RuntimeError(f"no grid at log2 {log2}: {most}")
                for grid in sorted({sms * b for b in range(1, most // sms + 1)}
                                   | {most}):
                    run = launcher(c_ids, c_seg, W, stats, log2, grid)
                    got = run()
                    if not all(torch.equal(a, b) for a, b in zip(got, want)):
                        raise AssertionError(
                            f"{rec['kernel']} {name}: log2 {log2}, grid "
                            f"{grid} differs from the default geometry")
                    rec["runs"].append([log2, grid, chip_smoke.device_ms(
                        torch, run, 10 if big else 50)])
            print(json.dumps(rec), flush=True)
    print(chip_smoke.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
