"""Run one cell of the benchmark once, on the card, and print its result.

    python3 bpebench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. The last line of standard output is the
result: one JSON object with ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and last
``compared``: each number that decides ``correct``, beside its limit. The
same numbers are the last lines of standard error.

Exits with another code than 0, and prints no result, where CUDA is not
available or has fewer devices than the cell asks for, where the program
cannot be imported, and where the process holds JAX or minbpe_tpu once the
window has closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from bpebench import harness

    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("CUDA is not available: no result", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"{torch.cuda.device_count()} CUDA devices, the cell asks for "
              f"{cell.chips}: no result", file=sys.stderr)
        return 3
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), "cuda", T0)
    found = harness.forbidden_modules()
    if found:
        print(f"the process holds {', '.join(found)}: no result",
              file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    for name, c in result["compared"].items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
