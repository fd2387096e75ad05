"""Whole-run BPE trainer over a dense device stream, with exact multi-merge
batching.

Counterpart of ``train_merges_fused_bytes`` (minbpe_tpu/ops/pallas/
fused_train.py:1359-1390) and of ``train_merges_fused_xl``
(fused_train_xl.py:800-840): the same contract, (pairs[M, 2], counts[M],
fail_round), and the same rebuild count (``LAST_REBUILDS``, the counterpart
of their ``LAST_REBUILDS``). One trainer serves both routes: the XL trainer
cuts the stream into 2M-token segments because the TPU's VMEM holds ~40 MB,
while here the whole stream sits in HBM (48M tokens of ids and seg are
384 MB of 80 GB), so every kernel sweeps it whole.

The run is a sequence of rebuild slots (kernels.py). A slot rebuilds the
counts (K1), walks the K_CAP best candidates (K5), and applies either one
merge with run parity (K3, when one candidate was accepted) or a batch:
the sites and both creation histograms (K6, one pass), the trim and the
combined apply (K8, one launch). Then it compacts (K4). How many merges a slot applies,
and whether it does anything at all, is known only on the device: the
merges done, the fail round and the rebuild count live in ``ctl``. So the
host enqueues SLOTS_PER_SYNC slots, reads (i, fail) once, and repeats until
every merge is done or a rebuild found no pair; slots past the end return
at once.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels, trace

# the trainer's limits: the XL Pallas trainer's token bound
# (minbpe_tpu/ops/pallas/fused_train_xl.py:51 XL_MAX_N) and the fused
# trainers' vocab bound (fused_train.py:72 FUSED_MAX_V)
XL_MAX_N = 48 * (1 << 20)
TRAIN_MAX_N = XL_MAX_N
TRAIN_MAX_V = 1024

SLOTS_PER_SYNC = 16
# device bytes per stream token at the peak of a slot: ids and seg of the
# current stream (8), K3/K8's merged ids and live mask (5), K6's cand, made
# once per run (4), K4's compacted ids and seg (8); plus the caller's
# stream (8) and the previous slot's merged/live until their replacements
# exist (5)
BYTES_PER_TOKEN = 38

# the most recent run's count rebuilds (every active slot, the one that
# found no pair included)
LAST_REBUILDS = 0


def device_bytes(n_tokens: int, num_merges: int) -> int:
    """Device memory a run holds at its peak: the stream's per-token
    buffers and the two V x V matrices."""
    V = 256 + num_merges
    return BYTES_PER_TOKEN * n_tokens + 8 * V * V


def check_device_memory(device, need: int, what: str):
    """Raise MemoryError, before any work, when ``need`` bytes do not fit in
    the device's free memory."""
    with trace.span("engine.check_memory"):
        trace.count("sync.check_memory")
        free, _ = torch.cuda.mem_get_info(device)
        # blocks the caching allocator holds but no tensor uses are free too
        free += (torch.cuda.memory_reserved(device)
                 - torch.cuda.memory_allocated(device))
    if need > free:
        raise MemoryError(
            f"{what} needs ~{need / 2**30:.2f} GiB of device memory; "
            f"{device} has {free / 2**30:.2f} GiB free")


def _check_memory(device, n_tokens: int, num_merges: int):
    check_device_memory(device, device_bytes(n_tokens, num_merges),
                        f"training {n_tokens} tokens ({BYTES_PER_TOKEN} "
                        "B/token)")


def _slot(ids, seg, n, st):
    """Enqueue one rebuild slot; returns the next (ids, seg, n)."""
    ctl, slot, log = st["ctl"], st["slot"], st["log"]
    kernels.pair_stats(ids, seg, n, st["V"], ctl, out=st["stats"])
    kernels.select_batch(*st["stats"], ids, ctl, slot, log, st["scratch"])
    merged, live = kernels.merge_apply(ids, seg, n, slot=slot, log=log)
    kernels.batch_hist(ids, seg, n, slot, st["acc"], st["cand"])
    kernels.batch_apply(ids, n, st["cand"], slot, st["acc"], ctl, log,
                        st["M"], merged, live, st["apply_scratch"])
    return kernels.compact(merged, seg, live, n, slot)


def train_merges(ids, seg, num_merges: int):
    """Learn num_merges merges from the stream (ids, seg), int32 tensors of
    equal length on the device the run uses. Returns numpy (pairs[M, 2],
    counts[M]) and the fail round (M when every round found a pair); rows
    from the fail round on are zero."""
    global LAST_REBUILDS
    M = num_merges
    LAST_REBUILDS = 0
    if M == 0:
        return np.zeros((0, 2), np.int32), np.zeros((0,), np.int32), 0
    dev = ids.device
    V = 256 + M
    if dev.type == "cuda":
        _check_memory(dev, ids.numel(), M)
    with trace.span("train.setup"):
        ids = ids.contiguous()
        seg = seg.contiguous()
        # filled on the device: a host tensor copied here would sync
        n = torch.full((1,), ids.numel(), dtype=torch.int32, device=dev)
        st = {
            "M": M, "V": V,
            "ctl": kernels.new_ctl(M, dev),
            "slot": kernels.new_slot(dev),
            # log row i: (pa, pb, count, kept)
            "log": torch.zeros((M, 4), dtype=torch.int32, device=dev),
            "stats": (torch.zeros((V, V), dtype=torch.int32, device=dev),
                      torch.full((V, V), -1, dtype=torch.int32, device=dev)),
            "acc": kernels.new_hist(dev),
            # K6's sites, for every position of the stream's capacity
            "cand": torch.empty_like(ids),
            "scratch": kernels.select_scratch(V, dev),
            "apply_scratch": kernels.batch_scratch(dev),
        }
    while True:
        with trace.span("train.enqueue"):
            for _ in range(SLOTS_PER_SYNC):
                ids, seg, n = _slot(ids, seg, n, st)
            trace.count("train.slots", SLOTS_PER_SYNC)
        with trace.span("train.sync"):
            trace.count("sync.train.ctl")
            i, fail = st["ctl"][:2].tolist()  # the group's one sync
        if i >= M or fail < M:
            break
    with trace.span("train.readback"):
        trace.count("sync.train.readback")
        out = torch.cat([st["log"].view(-1), st["ctl"]]).cpu().numpy()
    log_h = out[:4 * M].reshape(M, 4)
    ctl_h = out[4 * M:]
    LAST_REBUILDS = int(ctl_h[kernels.CTL_REBUILDS])
    return (log_h[:, 0:2].copy(), log_h[:, 2].copy(),
            min(int(ctl_h[kernels.CTL_FAIL]), M))
