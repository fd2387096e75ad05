#!/usr/bin/env python3
"""Device time of K5 select_batch, K6 batch_hist and K8 batch_apply on one
NVIDIA GPU.

    python3 scripts/time_select_apply.py

Times each kernel through its Python wrapper at chip_smoke.py's phase-2
shapes: K5 on K1's matrices of the 400K-token Zipf stream at W = 256, 512
and 1024 (ctl's i = W - 256), K6 and K8 on a batch of 16 candidates drawn
from them, over the 400K-token stream and over the same stream repeated
to 48 * 2^20 tokens. A package whose batch pass is two kernels
(batch_mark, then batch_hist_rev) has the pair timed as one call under
"batch_hist", and each alone beside it. Each call is first held against
the kernel's plain version. It prints one JSON object, {"select_batch":
[{"W", "ms"}, ...], "batch_hist": [{"n", "ms", ...}, ...], "batch_apply":
[{"n", "ms"}, ...]}, then the card's name and power limit.
It goes through the wrappers alone (a scratch is passed where the wrapper
takes one), so it also times an earlier commit's package: unpack that
commit with git archive into _archive/, copy this script and chip_smoke.py
into it, and run both trees in turns in one call.
"""

from __future__ import annotations

import inspect
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def batch_pass(torch, kernels, s_ids, s_seg, s_n, slot, reps):
    """(cand, acc, record): the batch pass over the stream, held against its
    plain version, and its device time per call."""
    size = s_ids.numel()
    acc = kernels.new_hist(s_ids.device)
    want = kernels.new_hist(s_ids.device)
    t_acc = kernels.new_hist(s_ids.device)
    if hasattr(kernels, "batch_hist"):
        cand = kernels.batch_hist(s_ids, s_seg, s_n, slot, acc,
                                  torch.empty_like(s_ids))
        ref = kernels.batch_hist_plain(s_ids, s_seg, s_n, slot, want,
                                       torch.empty_like(s_ids))
        t_cand = torch.empty_like(s_ids)
        rec = dict(n=size, ms=chip_smoke.device_ms(
            torch, lambda: kernels.batch_hist(s_ids, s_seg, s_n, slot, t_acc,
                                              t_cand), reps))
    else:
        cand, F = kernels.batch_mark(s_ids, s_seg, s_n, slot, acc[0])
        kernels.batch_hist_rev(s_ids, s_seg, s_n, cand, F, slot, acc[1])
        ref, F_p = kernels.batch_mark_plain(s_ids, s_seg, s_n, slot, want[0])
        kernels.batch_hist_rev_plain(s_ids, s_seg, s_n, ref, F_p, slot,
                                     want[1])
        del F_p

        def both():
            c, f = kernels.batch_mark(s_ids, s_seg, s_n, slot, t_acc[0])
            kernels.batch_hist_rev(s_ids, s_seg, s_n, c, f, slot, t_acc[1])

        rec = dict(
            n=size, ms=chip_smoke.device_ms(torch, both, reps),
            mark_ms=chip_smoke.device_ms(torch, lambda: kernels.batch_mark(
                s_ids, s_seg, s_n, slot, t_acc[0]), reps),
            hist_rev_ms=chip_smoke.device_ms(
                torch, lambda: kernels.batch_hist_rev(
                    s_ids, s_seg, s_n, cand, F, slot, t_acc[1]), reps))
        del F
    if chip_smoke.max_err(torch, [(cand, ref), (acc, want)]):
        raise AssertionError(f"the batch pass differs at n {size}")
    return cand, acc, rec


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        return chip_smoke.fail("CUDA is not available")
    from minbpe_tpu_torch import kernels
    from minbpe_tpu_torch.ops.train import XL_MAX_N

    dev = torch.device("cuda")
    W, n = 1024, 400_000
    M = 2 * W
    ids_h, seg_h = chip_smoke.smoke_stream(np, n, W)
    ids = torch.from_numpy(ids_h).to(dev)
    seg = torch.from_numpy(seg_h).to(dev)
    nt = torch.tensor([n], dtype=torch.int32, device=dev)
    ck, fk = kernels.pair_stats(ids, seg, nt, W)
    scratch = kernels.select_scratch(W, dev)
    out = {"select_batch": [], "batch_hist": [], "batch_apply": []}
    for w in (256, 512, W):
        state = []
        for fn in (kernels.select_batch, kernels.select_batch_plain):
            _, ctl, log = chip_smoke.batch_state(torch, kernels, dev, [],
                                                 w - 256, M)
            slot = kernels.new_slot(dev)
            fn(ck, fk, ids, ctl, slot, log)
            state.append((slot, ctl, log))
        if chip_smoke.max_err(torch, list(zip(*state))):
            return chip_smoke.fail(f"select_batch differs at W {w}")
        _, ctl, log = chip_smoke.batch_state(torch, kernels, dev, [],
                                             w - 256, M)
        slot = kernels.new_slot(dev)
        out["select_batch"].append(dict(W=w, ms=chip_smoke.device_ms(
            torch, lambda: kernels.select_batch(ck, fk, ids, ctl, slot, log,
                                                scratch), 50)))

    pairs = chip_smoke.draw_batch(np, ck.cpu().numpy(), fk.cpu().numpy(),
                                  kernels.K_CAP)
    slot, ctl, log = chip_smoke.batch_state(torch, kernels, dev, pairs,
                                            W - 256, M)
    takes_scratch = "scratch" in inspect.signature(
        kernels.batch_apply).parameters
    extra = [kernels.batch_scratch(dev)] if takes_scratch else []
    big = chip_smoke.xl_stream(torch, ids, seg, XL_MAX_N)
    for s_ids, s_seg, reps in ((ids, seg, 50), (*big, 5)):
        size = s_ids.numel()
        s_n = torch.tensor([size], dtype=torch.int32, device=dev)
        try:
            cand, acc, rec = batch_pass(torch, kernels, s_ids, s_seg, s_n,
                                        slot, reps)
        except AssertionError as e:
            return chip_smoke.fail(str(e))
        out["batch_hist"].append(rec)
        got = []
        for fn in (kernels.batch_apply, kernels.batch_apply_plain):
            s2, c2, l2 = slot.clone(), ctl.clone(), log.clone()
            o2 = torch.empty_like(s_ids)
            v2 = torch.empty(s_ids.shape, dtype=torch.bool, device=dev)
            fn(s_ids, s_n, cand, s2, acc.clone(), c2, l2, M, o2, v2)
            got.append((o2, v2, s2, c2, l2))
        if chip_smoke.max_err(torch, list(zip(*got))):
            return chip_smoke.fail(f"batch_apply differs at n {size}")
        del got
        t_slot, t_ctl, t_log = slot.clone(), ctl.clone(), log.clone()
        t_ctl[kernels.CTL_I] = 0  # the advance per call stays in the log
        t_slot[kernels.SLOT_I] = 0
        o = torch.empty_like(s_ids)
        v = torch.empty(s_ids.shape, dtype=torch.bool, device=dev)
        out["batch_apply"].append(dict(n=size, ms=chip_smoke.device_ms(
            torch, lambda: kernels.batch_apply(
                s_ids, s_n, cand, t_slot, acc, t_ctl, t_log, M, o, v,
                *extra), reps)))
        del cand, o, v
    print(json.dumps(out))
    print(chip_smoke.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
