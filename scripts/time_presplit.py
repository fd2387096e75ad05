#!/usr/bin/env python3
"""Device time of the device pre-split, K15 ``presplit_succ`` and
``presplit_orbit`` (the cooperative pair) and ``presplit_cluster`` (the
tier of streams up to 32 KB), on one NVIDIA GPU.

    python3 scripts/time_presplit.py [--ptxas]

Times the whole split (``presplit_seg_ids``, by its route) and each kernel
alone (``presplit_succ`` on the bytes, ``presplit_orbit`` on its
successors, ``presplit_cluster`` on the bytes where the package has it and
the stream fits it) through the Python wrappers, with CUDA events behind
a sleeping kernel (chip_smoke.device_ms), at chip_smoke.py's phase-2
shapes: the smoke corpus (397,366 bytes) and the XL corpus (12,588,338)
in both modes, the XL corpus four times over (50,353,352; GPT-4) and 2^20
spaces, letters and digits (GPT-4); then at chip_smoke.cluster_shapes
(the regex512-encode-docs cell's median, mean-length and longest
documents, the smoke corpus's first 1, 2, 4 and 8 tiles; GPT-4), where
``pair_ms`` is the pair's time on the same bytes. Each shape also gets the
sha256 of the split (boundaries, then segment ids, below n) and its bytes
bound (n read, 5 n written, the 64 KB class table; 3.35 TB/s). Where the
package's split takes a byte table (``byte_ids``), ``ids_ms`` is the
whole split with a table, writing each byte's token id too, and on the
cluster shapes ``cluster_bare_ms`` and ``cluster_ids_ms`` time
``presplit_cluster`` without and with the table in turns
(chip_smoke.split_ms); None elsewhere. With
``--ptxas`` it first compiles the kernel source once more with ``-Xptxas
-v`` and prints what ptxas reports for the K15 kernels (registers, shared
memory, spills).

It goes through the wrappers alone, so it also times an earlier commit's
package: unpack that commit with git archive into _archive/ (git-ignored),
copy this script and chip_smoke.py into it, and run both trees in turns in
one call (parent, this, this, parent); equal hashes show equal outputs. It
prints one JSON object, {"root", "ptxas", "shapes": [{"case", "n",
"chunks", "ms", "succ_ms", "orbit_ms", "pair_ms", "cluster_ms", "ids_ms",
"cluster_bare_ms", "cluster_ids_ms", "bound_ms", "sha256"}]} (cluster_ms
None where the package has no cluster tier or the stream is past it),
then the card's name and power limit.
"""

from __future__ import annotations

import hashlib
import inspect
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def shapes(np, golden_mod):
    """(name, text bytes, mode) of chip_smoke.py phase 2's K15 shapes."""
    corpus = golden_mod.smoke_corpus(ROOT).encode("utf-8")
    xl = golden_mod.xl_corpus(ROOT).encode("utf-8")
    k = 1 << 20
    return [("smoke", corpus, "gpt4"), ("smoke", corpus, "gpt2"),
            ("xl", xl, "gpt4"), ("xl", xl, "gpt2"), ("xl4", xl * 4, "gpt4"),
            ("spaces_2e20", b" " * k + b"x", "gpt4"),
            ("letters_2e20", b" " + b"a" * k + b"!", "gpt4"),
            ("digits_2e20", b"1" * k + b" 22", "gpt4")] + [
                (name, raw, "gpt4")
                for name, raw in chip_smoke.cluster_shapes(np, golden_mod)]


def ptxas_report(kernels) -> list[str]:
    """ptxas's lines on the K15 kernels from one more build of the source
    with -Xptxas -v (to a scratch file in the build directory)."""
    out = os.path.join(kernels.BUILD_DIR, "ptxas_probe.so")
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    cmd = kernels.build_command(out)
    proc = subprocess.run(cmd[:1] + ["-Xptxas", "-v"] + cmd[1:],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr}")
    lines = proc.stderr.splitlines()
    keep = []
    for i, line in enumerate(lines):
        if "presplit" in line and "Compiling entry function" in line:
            keep += [line.strip()] + [x.strip() for x in lines[i + 1:i + 4]
                                      if "ptxas info" in x or "spill" in x]
    return keep


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        return chip_smoke.fail("CUDA is not available")
    from minbpe_tpu_torch import kernels
    from minbpe_tpu_torch.ops import device_presplit as pdp
    from minbpe_tpu_torch.utils import golden as golden_mod

    kernels.build()
    report = ptxas_report(kernels) if "--ptxas" in sys.argv[1:] else []
    for line in report:
        print(line, file=sys.stderr)
    table = 0x10000 + 5 * pdp._device_tables(torch.device("cuda"))[1].numel()
    out = []
    cluster = getattr(pdp, "presplit_cluster", None)
    byte_ids = None
    if "byte_ids" in inspect.signature(pdp.presplit_seg_ids).parameters:
        byte_ids = torch.from_numpy(np.random.default_rng(0).permutation(
            256).astype(np.int32)).cuda()
    for name, raw, mode in shapes(np, golden_mod):
        n = len(raw)
        data = torch.frombuffer(bytearray(raw), dtype=torch.uint8).cuda()
        del raw
        boundary, seg = pdp.presplit_seg_ids(data, n, mode)
        h = hashlib.sha256(boundary[:n].cpu().numpy().tobytes())
        h.update(seg[:n].cpu().numpy().tobytes())
        f = pdp.presplit_succ(data, n, mode)
        reps = 5 if n > 1 << 22 else 20
        short = cluster is not None and n <= pdp.CLUSTER_MAX_N
        rec = dict(
            case=f"{name}_{mode}", n=n, chunks=int(seg[n - 1]) + 1,
            ms=chip_smoke.device_ms(
                torch, lambda: pdp.presplit_seg_ids(data, n, mode), reps),
            succ_ms=chip_smoke.device_ms(
                torch, lambda: pdp.presplit_succ(data, n, mode), reps),
            orbit_ms=chip_smoke.device_ms(
                torch, lambda: pdp.presplit_orbit(f, n), reps),
            pair_ms=chip_smoke.device_ms(
                torch, lambda: pdp.presplit_orbit(
                    pdp.presplit_succ(data, n, mode), n), reps),
            cluster_ms=chip_smoke.device_ms(
                torch, lambda: cluster(data, n, mode), reps) if short
            else None,
            ids_ms=None if byte_ids is None else chip_smoke.device_ms(
                torch, lambda: pdp.presplit_seg_ids(data, n, mode, byte_ids),
                reps),
            cluster_bare_ms=None, cluster_ids_ms=None,
            bound_ms=(6 * n + table) / chip_smoke.HBM_BYTES_PER_S * 1e3,
            sha256=h.hexdigest())
        if short and byte_ids is not None:
            rec["cluster_bare_ms"], rec["cluster_ids_ms"] = \
                chip_smoke.split_ms(torch, [
                    lambda: cluster(data, n, mode),
                    lambda: cluster(data, n, mode, byte_ids)], 100)
        out.append(rec)
        print(f"{rec['case']}: " + ", ".join(
            f"{k} {v}" for k, v in rec.items() if k != "case"),
            file=sys.stderr)
        del data, boundary, seg, f
        torch.cuda.empty_cache()
    print(json.dumps({"root": ROOT, "ptxas": report, "shapes": out}))
    print(chip_smoke.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
