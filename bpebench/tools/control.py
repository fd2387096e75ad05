"""Run the control at a cell's own size, on the card, and print what the
comparison reads.

    python3 bpebench/tools/control.py --workload <cell> --seeds 1 2 3 \\
        [--seconds 2]

For each seed: the cell's inputs and set-up as a run makes them, with the
control (bpebench/control.py) in the program's place; a short window at
the cell's own load (an encode cell's answers are computed at once before
it, so the window goes through every document); then the cell's own
comparison. Prints one JSON line a seed with each number and its limit,
and ``correct``, which has to come out false.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from bpebench import control, harness  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    cell = harness.load_cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        ctx = harness.Context(cell, seed, args.device, False,
                              control.factory(cell.config, args.device))
        job = cell.kind.Job(ctx)
        job.setup()
        if hasattr(job, "docs"):
            job.tok.prepare(job.docs)
        win = job.window(args.seconds)
        job.release()
        compared = job.check()
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "attempted": win.attempted,
            "correct": all(v <= lim for v, lim in compared.values()),
            "compared": {k: {"value": v, "limit": lim}
                         for k, (v, lim) in compared.items()},
            "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
