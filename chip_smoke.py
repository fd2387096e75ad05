#!/usr/bin/env python3
"""Smoke run of minbpe_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (the script exits non-zero otherwise):

1. build the CUDA kernels (nvcc) and the native pre-split scanner (g++)
   from the checkout's sources, both at once;
2. hold each kernel against its plain PyTorch version on the card, on
   numpy-seeded inputs at the main path's shapes (400K tokens, W = 1024,
   the rebuild of merge 768, a batch of 16 candidates drawn from the
   stream), K1 and K6 once more at the XL bound (48M tokens), and K9 also
   at V = 2048 and at the stepped route's bound (4M tokens); the outputs
   are integers and must be exactly equal;
3. drive the main path through the user's entry points, one path at a
   time, with every launch count set to 0 just before each path and read
   just after it: RegexTokenizer (GPT-4 pattern) training at vocab 1024 on
   the frozen in-repo smoke corpus (merges and counts equal to the golden
   that minbpe_tpu produced, in fewer rebuilds than merges), encode (ids'
   sha256 equal to the golden's), decode, encode_batch and the same
   documents encoded one by one, special tokens, save/load, a
   BasicTokenizer at vocab 512 and one on 2^20 copies of "a", both equal to
   the plain path on the CPU, and the large-corpus route: vocab 1024 on the
   12,588,338-byte XL corpus, equal to the XL golden. Then the selection
   and stepped routes on the smoke corpus: select_mode "pallas", "sort",
   "dense" and "stepped" at vocab 1024 (each equal to the golden, with the
   launches of each kernel counted exactly), the default route at vocab
   2048 (the stepped trainer; equal to the 2048 golden and to "sort" at
   2048), a checkpointed run interrupted after round 512 and resumed, and
   a run with a profile_dir, which must leave a trace;
4. the device's busy time in the training runs on both corpora, the
   "pallas" and stepped runs on the smoke corpus and the encode run
   (torch.profiler) against their wall time: the idle share;
5. print the kernels line (launches of each path in phase 3, errors and
   times of phase 2), the main path's timings, the busy times, the card's
   name and power limit, and last the result line.

Without CUDA, or without the package beside it, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
SEED = 1234


def fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    return 1


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------

def phase_build(kernels, native):
    def timed(fn):
        t0 = time.perf_counter()
        path = fn()
        return path, time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=2) as ex:
        fk = ex.submit(timed, kernels.build)
        fn = ex.submit(timed, native.build)
        kpath, ks = fk.result()
        npath, ns = fn.result()
    if npath is None:
        raise RuntimeError("no C++ compiler: the native scanner did not build")
    if not native.available():
        raise RuntimeError("the native scanner did not load")
    print(f"build: kernels {ks:.2f} s ({os.path.basename(kpath)}), "
          f"native scanner {ns:.2f} s ({os.path.basename(npath)})")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def device_ms(torch, fn, reps: int) -> float:
    """Device time per call: the host enqueues every call behind a sleeping
    kernel, so the events time the device work and not the enqueue."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(reps * 400_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profiled_events(torch, fn):
    """(ms, count, name) of each device activity (kernel, memset, copy) that
    torch.profiler records while fn runs and the device drains. Host-side
    ops are left out: their "self device time" repeats that of the kernels
    they launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    parts = [(e.self_device_time_total / 1e3, e.count, e.key)
             for e in prof.key_averages()
             if e.device_type != DeviceType.CPU and e.self_device_time_total]
    return sorted(parts, reverse=True)


def profiled_ms(torch, fn, reps: int) -> float:
    """Device time per call from the profiler's device activity, for calls
    that wait on the device (a library call that reads a size back): CUDA
    events around them would also time the host's round trip."""
    fn()
    torch.cuda.synchronize()

    def loop():
        for _ in range(reps):
            fn()

    busy = sum(p[0] for p in profiled_events(torch, loop))
    if not busy:
        raise RuntimeError("the profiler recorded no device time")
    return busy / reps


def host_ms(torch, fn, reps: int) -> float:
    """Wall time per call, synchronised (for the plain versions, which
    sync on their own)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def max_err(torch, pairs) -> int:
    err = 0
    for a, b in pairs:
        if a.shape != b.shape:
            raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
        if a.numel():
            err = max(err, int((a.long() - b.long()).abs().max()))
    return err


def smoke_stream(np, n: int, W: int):
    """A seeded stream like a pre-split corpus: skewed ids (hot pairs),
    chunks of 1-8 tokens, and long runs of one id inside one chunk, some of
    them crossing the kernels' 1024-position tiles."""
    rng = np.random.default_rng(SEED)
    ids = np.minimum(rng.zipf(1.3, n) - 1, W - 1).astype(np.int32)
    seg = np.cumsum(rng.random(n) < 0.3).astype(np.int32)
    for start, length in ((1000, 5001), (200_000, 4096), (399_000, 777)):
        ids[start:start + length] = 7
        seg[start:start + length] = seg[start]
        seg[start + length:] += 1  # close the run's chunk
    return ids, seg


def draw_batch(np, cnt, first, K):
    """K heterogeneous candidates from the count matrix in descending key
    order, no two sharing a cross-side token (the shape of a real batch)."""
    c = cnt.astype(np.int64)
    key = np.where(c > 0, (c << 32) | (0xFFFFFFFF - (first.astype(np.int64)
                                                      & 0xFFFFFFFF)), 0)
    flat = np.argsort(-key, axis=None, kind="stable")
    W = cnt.shape[1]
    out = []
    for e in flat:
        if key.flat[e] == 0 or len(out) == K:
            break
        a, b = divmod(int(e), W)
        if a != b and all(a != qb and b != qa for qa, qb, _ in out):
            out.append((a, b, int(c.flat[e])))
    return out


def batch_state(torch, kernels, dev, pairs, i, M):
    """(slot, ctl, log) of an M-merge run at merge i with ``pairs`` (pa, pb,
    count) accepted by the walk."""
    slot = kernels.new_slot("cpu")
    for j, (a, b, c) in enumerate(pairs):
        slot[2 * j], slot[2 * j + 1] = a, b
        slot[kernels.SLOT_COUNT + j] = c
    slot[kernels.SLOT_BSEL] = len(pairs)
    slot[kernels.SLOT_ZBASE] = 256 + i
    slot[kernels.SLOT_I] = i
    ctl = kernels.new_ctl(M, "cpu")
    ctl[kernels.CTL_I] = i
    log = torch.zeros((M, 4), dtype=torch.int32)
    return slot.to(dev), ctl.to(dev), log.to(dev)


def xl_stream(torch, ids, seg, n: int):
    """The 400K stream repeated to n tokens on the device, its chunks
    renumbered so that no chunk spans two copies."""
    reps = -(-n // ids.numel())
    span = int(seg[-1]) + 1
    off = torch.arange(reps, dtype=torch.int32, device=ids.device) * span
    big_ids = ids.repeat(reps)[:n].contiguous()
    big_seg = (seg.view(1, -1) + off.view(-1, 1)).view(-1)[:n].contiguous()
    return big_ids, big_seg


def phase_kernels(torch, np, kernels, xl_max_n: int, stepped_max_n: int):
    W = 1024
    n = 400_000
    I = W - 256  # the merge whose rebuild the shapes are those of
    M = 2 * W  # log rows for the timing calls' advances
    dev = torch.device("cuda")
    ids_h, seg_h = smoke_stream(np, n, W)
    ids = torch.from_numpy(ids_h).to(dev)
    seg = torch.from_numpy(seg_h).to(dev)
    nt = torch.tensor([n], dtype=torch.int32, device=dev)
    rows = []

    # K1 pair_stats
    ck, fk = kernels.pair_stats(ids, seg, nt, W)
    cp, fp = kernels.pair_stats_plain(ids, seg, nt, W)
    err1 = max_err(torch, [(ck, cp), (fk, fp)])
    key = (ids[:-1].long() * W + ids[1:].long())[seg[:-1] == seg[1:]]
    rows.append(dict(
        k=kernels.PAIR_STATS, err=err1,
        ms=device_ms(torch, lambda: kernels.pair_stats(ids, seg, nt, W), 50),
        plain_ms=host_ms(torch, lambda: kernels.pair_stats_plain(
            ids, seg, nt, W), 5),
        bytes=8 * n + 8 * W * W,
        library_ms=profiled_ms(torch, lambda: torch.bincount(
            key, minlength=W * W), 50)))

    # K5 select_batch on K1's matrices at merge I, and on empty ones (the
    # fail round); its state is compared whole
    def select(fn, cnt, first):
        _, ctl, log = batch_state(torch, kernels, dev, [], I, M)
        slot = kernels.new_slot(dev)
        fn(cnt, first, ids, ctl, slot, log)
        return slot, ctl, log

    got = select(kernels.select_batch, ck, fk)
    want = select(kernels.select_batch_plain, ck, fk)
    zero = torch.zeros_like(ck)
    none = torch.full_like(fk, -1)
    got0 = select(kernels.select_batch, zero, none)
    want0 = select(kernels.select_batch_plain, zero, none)
    err5 = max_err(torch, list(zip(got, want)) + list(zip(got0, want0)))
    bsel = int(got[0][kernels.SLOT_BSEL])
    if bsel < 1 or int(got0[1][kernels.CTL_FAIL]) != I:
        raise AssertionError(f"select_batch: bsel {bsel}, empty-matrix fail "
                             f"{int(got0[1][kernels.CTL_FAIL])}")
    _, tctl, tlog = batch_state(torch, kernels, dev, [], I, M)
    tslot = kernels.new_slot(dev)
    scratch = kernels.select_scratch(W, dev)
    packed = torch.where(ck > 0, (ck.long() << 32) | (0xFFFFFFFF - (
        fk.long() & 0xFFFFFFFF)), torch.zeros_like(ck, dtype=torch.long))
    flat = packed.view(-1)
    rows.append(dict(
        k=kernels.SELECT_BATCH, err=err5,
        ms=device_ms(torch, lambda: kernels.select_batch(
            ck, fk, ids, tctl, tslot, tlog, scratch), 50),
        plain_ms=host_ms(torch, lambda: kernels.select_batch_plain(
            ck, fk, ids, tctl, tslot, tlog), 5),
        bytes=8 * W * W + 4 * kernels.SLOT_SIZE,
        library_ms=profiled_ms(torch, lambda: torch.topk(
            flat, kernels.K_CAP), 50)))
    print(f"select_batch: {bsel} candidates accepted at merge {I}")

    # K3 merge_apply: the homogeneous run pair and K5's first candidate
    err3 = 0
    for pair in ((7, 7), tuple(got[0][:2].tolist()), (0, 1)):
        pt = torch.tensor(pair, dtype=torch.int32, device=dev)
        kk = torch.zeros(1, dtype=torch.int32, device=dev)
        kp = torch.zeros(1, dtype=torch.int32, device=dev)
        ok_ids, ok_live = kernels.merge_apply(ids, seg, nt, pt, 5000, kk)
        op_ids, op_live = kernels.merge_apply_plain(ids, seg, nt, pt, 5000,
                                                    kp)
        err3 = max(err3, max_err(torch, [(ok_ids[:n], op_ids[:n]),
                                         (ok_live[:n], op_live[:n]),
                                         (kk, kp)]))
        if int(kk) <= 0:
            raise AssertionError(f"merge_apply kept nothing for {pair}")
    pt = torch.tensor((7, 7), dtype=torch.int32, device=dev)
    rows.append(dict(
        k=kernels.MERGE_APPLY, err=err3,
        ms=device_ms(torch, lambda: kernels.merge_apply(ids, seg, nt, pt,
                                                        5000), 50),
        plain_ms=host_ms(torch, lambda: kernels.merge_apply_plain(
            ids, seg, nt, pt, 5000), 5),
        bytes=13 * n, library_ms=None))

    # K6-K8 on a batch of K_CAP candidates drawn from the stream
    pairs = draw_batch(np, ck.cpu().numpy(), fk.cpu().numpy(), kernels.K_CAP)
    if len(pairs) != kernels.K_CAP:
        raise AssertionError(f"drew {len(pairs)} candidates")
    slot, ctl, log = batch_state(torch, kernels, dev, pairs, I, M)
    acc_k, acc_p = kernels.new_hist(dev), kernels.new_hist(dev)
    cand_k, F_k = kernels.batch_mark(ids, seg, nt, slot, acc_k[0])
    cand_p, F_p = kernels.batch_mark_plain(ids, seg, nt, slot, acc_p[0])
    err6 = max_err(torch, [(cand_k[:n], cand_p[:n]), (F_k[:n], F_p[:n]),
                           (acc_k[0], acc_p[0])])
    kernels.batch_hist_rev(ids, seg, nt, cand_k, F_k, slot, acc_k[1])
    kernels.batch_hist_rev_plain(ids, seg, nt, cand_k, F_k, slot, acc_p[1])
    err7 = max_err(torch, [(acc_k[1], acc_p[1])])
    sites = cand_k[:n] >= 0
    nsites = int(sites.sum())
    site_pos = torch.nonzero(sites).flatten()
    zb = 256 + I
    pF = F_k[site_pos - 1].long()
    hist_key = (pF & 127) * kernels.K_CAP + cand_k[site_pos].long()
    acc_t = kernels.new_hist(dev)
    rows.append(dict(
        k=kernels.BATCH_MARK, err=err6,
        ms=device_ms(torch, lambda: kernels.batch_mark(
            ids, seg, nt, slot, acc_t[0]), 50),
        plain_ms=host_ms(torch, lambda: kernels.batch_mark_plain(
            ids, seg, nt, slot, acc_t[0]), 5),
        bytes=16 * n + 4 * kernels.HIST_BUCKETS * kernels.K_CAP,
        library_ms=profiled_ms(torch, lambda: torch.bincount(
            hist_key, minlength=kernels.HIST_BUCKETS * kernels.K_CAP), 50)))
    rows.append(dict(
        k=kernels.BATCH_HIST_REV, err=err7,
        ms=device_ms(torch, lambda: kernels.batch_hist_rev(
            ids, seg, nt, cand_k, F_k, slot, acc_t[1]), 50),
        plain_ms=host_ms(torch, lambda: kernels.batch_hist_rev_plain(
            ids, seg, nt, cand_k, F_k, slot, acc_t[1]), 5),
        bytes=4 * n + 16 * nsites + 4 * kernels.HIST_BUCKETS * kernels.K_CAP,
        library_ms=profiled_ms(torch, lambda: torch.bincount(
            hist_key, minlength=kernels.HIST_BUCKETS * kernels.K_CAP), 50)))
    print(f"batch: {len(pairs)} candidates, {nsites} sites; left partners "
          f"in a site: {int((pF >= zb).sum())}")

    # K8 batch_apply: the trim on these histograms, then the apply
    def apply(fn):
        s2, c2, l2 = slot.clone(), ctl.clone(), log.clone()
        a2 = acc_k.clone()
        out = torch.empty_like(ids)
        live = torch.empty(ids.shape, dtype=torch.bool, device=dev)
        fn(ids, nt, cand_k, s2, a2, c2, l2, M, out, live)
        return out[:n], live[:n], s2, c2, l2, a2

    got8, want8 = apply(kernels.batch_apply), apply(kernels.batch_apply_plain)
    err8 = max_err(torch, list(zip(got8, want8)))
    bstar = int(got8[2][kernels.SLOT_BSTAR])
    t_out = torch.empty_like(ids)
    t_live = torch.empty(ids.shape, dtype=torch.bool, device=dev)
    t_slot, t_ctl, t_log = slot.clone(), ctl.clone(), log.clone()
    # timing: the advance of i per call stays inside the log's M rows
    t_ctl[kernels.CTL_I] = 0
    t_slot[kernels.SLOT_I] = 0
    rows.append(dict(
        k=kernels.BATCH_APPLY, err=err8,
        ms=device_ms(torch, lambda: kernels.batch_apply(
            ids, nt, cand_k, t_slot, acc_t, t_ctl, t_log, M, t_out, t_live),
            50),
        plain_ms=host_ms(torch, lambda: kernels.batch_apply_plain(
            ids, nt, cand_k, t_slot, acc_t, t_ctl, t_log, M, t_out, t_live),
            5),
        bytes=13 * n + 8 * kernels.HIST_BUCKETS * kernels.K_CAP,
        library_ms=None))
    print(f"batch_apply: the trim kept {bstar} of {len(pairs)}")

    # K4 compact, on the homogeneous merge's output
    merged, live = kernels.merge_apply(ids, seg, nt, pt, 5000)
    ik, sk, nk = kernels.compact(merged, seg, live, nt)
    ip, sp, np_ = kernels.compact_plain(merged, seg, live, nt)
    k = int(np_)
    err4 = max_err(torch, [(nk, np_), (ik[:k], ip[:k]), (sk[:k], sp[:k])])
    lv = live[:n]

    def library_compact():  # the new length is the outputs' size
        return merged[:n][lv], seg[:n][lv]

    rows.append(dict(
        k=kernels.COMPACT, err=err4,
        ms=device_ms(torch, lambda: kernels.compact(merged, seg, live, nt),
                     50),
        plain_ms=host_ms(torch, lambda: kernels.compact_plain(
            merged, seg, live, nt), 5),
        bytes=9 * n + 8 * k,
        library_ms=profiled_ms(torch, library_compact, 50)))

    # K9 pair_count at the main path's shape, at V = 2048 (a stream of its
    # own with ids below 2048) and at the stepped route's 4 * 2^20 tokens
    def count_case(c_ids, c_seg, V):
        c_n = torch.full((1,), c_ids.numel(), dtype=torch.int32, device=dev)
        got = kernels.pair_count(c_ids, c_seg, c_n, V)
        err = max_err(torch, [(got, kernels.pair_count_plain(
            c_ids, c_seg, c_n, V))])
        if int(got.sum()) <= 0:
            raise AssertionError(f"pair_count counted nothing at V = {V}")
        same = c_seg[:-1] == c_seg[1:]
        keys = (c_ids[:-1].long() * V + c_ids[1:].long())[same]
        return dict(
            n=c_ids.numel(), V=V, max_abs_err=err,
            ms=device_ms(torch, lambda: kernels.pair_count(
                c_ids, c_seg, c_n, V), 50),
            plain_ms=host_ms(torch, lambda: kernels.pair_count_plain(
                c_ids, c_seg, c_n, V), 5),
            bytes=8 * c_ids.numel() + 4 * V * V,
            bound_ms=(8 * c_ids.numel() + 4 * V * V) / HBM_BYTES_PER_S * 1e3,
            library_ms=profiled_ms(torch, lambda: torch.bincount(
                keys, minlength=V * V), 50))

    main = count_case(ids, seg, W)
    ids2k, seg2k = (torch.from_numpy(a).to(dev)
                    for a in smoke_stream(np, n, 2048))
    big_ids, big_seg = xl_stream(torch, ids, seg, stepped_max_n)
    others = [count_case(ids2k, seg2k, 2048),
              count_case(big_ids, big_seg, W)]
    del ids2k, seg2k, big_ids, big_seg
    rows.append(dict(k=kernels.PAIR_COUNT, err=main["max_abs_err"],
                     ms=main["ms"], plain_ms=main["plain_ms"],
                     bytes=main["bytes"], library_ms=main["library_ms"],
                     shapes=others))
    for c in others:
        print(f"pair_count at n {c['n']}, V {c['V']}: max_abs_err "
              f"{c['max_abs_err']} ({c['ms']:.4f} ms, bound "
              f"{c['bound_ms']:.4f} ms)")

    # K1 and K6 at the XL bound: the same stream repeated to XL_MAX_N tokens
    big_ids, big_seg = xl_stream(torch, ids, seg, xl_max_n)
    big_n = torch.tensor([xl_max_n], dtype=torch.int32, device=dev)
    xk = kernels.pair_stats(big_ids, big_seg, big_n, W)
    xp = kernels.pair_stats_plain(big_ids, big_seg, big_n, W)
    xl1 = max_err(torch, list(zip(xk, xp)))
    xa_k, xa_p = kernels.new_hist(dev), kernels.new_hist(dev)
    mk = kernels.batch_mark(big_ids, big_seg, big_n, slot, xa_k[0])
    mp = kernels.batch_mark_plain(big_ids, big_seg, big_n, slot, xa_p[0])
    xl6 = max_err(torch, list(zip(mk, mp)) + [(xa_k, xa_p)])
    rows[0]["xl"] = dict(
        n=xl_max_n, max_abs_err=xl1,
        ms=device_ms(torch, lambda: kernels.pair_stats(
            big_ids, big_seg, big_n, W), 5))
    rows[3]["xl"] = dict(
        n=xl_max_n, max_abs_err=xl6,
        ms=device_ms(torch, lambda: kernels.batch_mark(
            big_ids, big_seg, big_n, slot, acc_t[0]), 5))
    if int(xk[0].sum()) <= 0:
        raise AssertionError("pair_stats counted nothing at the XL size")
    print(f"xl size {xl_max_n}: pair_stats max_abs_err {xl1} "
          f"({rows[0]['xl']['ms']:.4f} ms), batch_mark max_abs_err {xl6} "
          f"({rows[3]['xl']['ms']:.4f} ms)")
    del big_ids, big_seg, xk, xp, mk, mp

    for r in rows:
        print(f"kernel {r['k'].name}: max_abs_err {r['err']}, "
              f"{r['ms']:.4f} ms (plain {r['plain_ms']:.3f} ms)")
        err = max([r["err"], r.get("xl", {}).get("max_abs_err", 0)]
                  + [c["max_abs_err"] for c in r.get("shapes", ())])
        if err != 0:
            raise AssertionError(f"{r['k'].name} disagrees with its plain "
                                 f"version (max_abs_err {err})")
    return rows


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def merges_in_rank_order(np, merges):
    items = sorted(merges.items(), key=lambda kv: kv[1])
    return np.array([list(p) for p, _ in items], dtype=np.int32)


TRAIN_KERNELS = ("pair_stats", "select_batch", "merge_apply", "batch_mark",
                 "batch_hist_rev", "batch_apply", "compact")
ENCODE_KERNELS = ("merge_apply", "compact")


def phase_main_path(torch, np, kernels, golden_mod, scratch):
    """Returns (timings, launches), launches = {path: {kernel: count}}."""
    from minbpe_tpu_torch import BasicTokenizer, RegexTokenizer
    from minbpe_tpu_torch.ops import train as train_mod

    timings = {}
    launches = {}

    @contextlib.contextmanager
    def path(name, must_launch, exact=None):
        """Count this path's launches alone; each kernel it must run has to
        have launched at least once, and with ``exact`` ({kernel: count})
        every kernel exactly so often (0 where it is not named)."""
        kernels.reset_launches()
        yield
        counts = {k.name: k.launches for k in kernels.KERNELS}
        launches[name] = counts
        missing = [k for k in must_launch if counts[k] == 0]
        if missing:
            raise AssertionError(f"path {name} launched no {missing}: "
                                 f"{counts}")
        if not must_launch and any(counts.values()):
            raise AssertionError(f"path {name} launched kernels: {counts}")
        if exact is not None and any(counts[k] != exact.get(k, 0)
                                     for k in counts):
            raise AssertionError(f"path {name} launched {counts}, expected "
                                 f"{exact}")

    golden = golden_mod.load_golden()
    corpus = golden_mod.smoke_corpus(ROOT)
    nbytes = len(corpus.encode("utf-8"))
    print(f"corpus: {nbytes} bytes")

    # train, through the verbose lines (they carry the per-merge counts)
    tok = RegexTokenizer(device="cuda")
    out = io.StringIO()
    torch.cuda.synchronize()
    with path("train", TRAIN_KERNELS):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            tok.train(corpus, golden_mod.VOCAB_SIZE, verbose=True)
        torch.cuda.synchronize()
        timings["train_s"] = time.perf_counter() - t0
    counts = np.array([int(c) for c in
                       re.findall(r"had (\d+) occurrences", out.getvalue())])
    if not np.array_equal(merges_in_rank_order(np, tok.merges),
                          golden["merges"]):
        raise AssertionError("trained merges differ from the golden")
    if not np.array_equal(counts, golden["counts"]):
        raise AssertionError("merge counts differ from the golden")
    note_batching(train_mod, timings, "train", len(tok.merges))
    print(f"train: {len(tok.merges)} merges equal to the golden "
          f"({timings['train_s']:.3f} s, {timings['train_rebuilds']} "
          f"rebuilds, {timings['train_merges_per_rebuild']:.3f} merges per "
          f"rebuild, {timings['train_slots']} slots, "
          f"{timings['train_syncs']} syncs)")

    # encode / decode
    with path("encode", ENCODE_KERNELS):
        t0 = time.perf_counter()
        ids = tok.encode(corpus)
        timings["encode_s"] = time.perf_counter() - t0
    if golden_mod.ids_digest(ids) != golden["encode_sha256"]:
        raise AssertionError("encode ids differ from the golden")
    with path("decode", ()):
        t0 = time.perf_counter()
        back = tok.decode(ids)
        timings["decode_s"] = time.perf_counter() - t0
    if back != corpus:
        raise AssertionError("decode(encode(corpus)) != corpus")
    timings["encode_MB_per_s"] = nbytes / timings["encode_s"] / 1e6
    timings["decode_MB_per_s"] = nbytes / timings["decode_s"] / 1e6
    print(f"encode: {len(ids)} ids, sha256 equal to the golden; "
          f"decode round trip ok")

    # encode_batch of 256 documents against per-document encode
    step = -(-len(corpus) // 256)
    docs = [corpus[i:i + step] for i in range(0, len(corpus), step)]
    with path("encode_batch", ENCODE_KERNELS):
        t0 = time.perf_counter()
        batch = tok.encode_batch(docs)
        timings["encode_batch_s"] = time.perf_counter() - t0
    with path("encode_per_doc", ENCODE_KERNELS):
        t0 = time.perf_counter()
        single = [tok.encode(d) for d in docs]
        timings["encode_per_doc_s"] = time.perf_counter() - t0
    if batch != single:
        raise AssertionError("encode_batch differs from per-document encode")
    print(f"encode_batch: {len(docs)} documents equal to per-document encode")

    # special tokens
    # names that the corpus does not hold, so only the joins are specials
    specials = {"<|smoke_doc|>": 1024, "<|smoke_end|>": 1025}
    tok.register_special_tokens(specials)
    names = list(specials)
    text = "".join(docs[k] + names[k % 2] for k in range(8))
    want = []
    with path("specials", ENCODE_KERNELS):
        for k in range(8):
            want += tok.encode_ordinary(docs[k]) + [specials[names[k % 2]]]
        got = tok.encode(text, allowed_special="all")
    if got != want or tok.decode(got) != text:
        raise AssertionError("special-token encode or decode is wrong")
    print("specials: encode(allowed_special='all') and decode ok")

    # save / load (a loaded vocab also holds the specials, as in minbpe, so
    # the .vocab bytes are compared from the first load on)
    def read(path):
        with open(path, "rb") as f:
            return f.read()

    prefix = os.path.join(scratch, "smoke")
    tok.save(prefix)
    tok2 = RegexTokenizer(device="cuda")
    tok2.load(prefix + ".model")
    tok2.save(prefix + "2")
    tok3 = RegexTokenizer(device="cuda")
    tok3.load(prefix + "2.model")
    tok3.save(prefix + "3")
    if (read(prefix + ".model") != read(prefix + "2.model")
            or read(prefix + "2.vocab") != read(prefix + "3.vocab")):
        raise AssertionError("save/load changed the saved bytes")
    if tok2.merges != tok.merges or tok2.special_tokens != specials:
        raise AssertionError("save/load changed the merges or specials")
    with path("save_load", ENCODE_KERNELS):
        if tok2.encode(text, allowed_special="all") != got:
            raise AssertionError("the loaded tokenizer encodes differently")
    print("save/load: identical bytes after the round trip")

    # BasicTokenizer at vocab 512 on the first 64 KB, against the CPU
    head = corpus[:65536]
    gb, cb = BasicTokenizer(device="cuda"), BasicTokenizer(device="cpu")
    with path("basic_512", TRAIN_KERNELS):
        t0 = time.perf_counter()
        gb.train(head, 512)
        timings["basic_512_train_s"] = time.perf_counter() - t0
        gb_ids = gb.encode(head)
    cb.train(head, 512)
    if gb.merges != cb.merges or gb_ids != cb.encode(head):
        raise AssertionError("BasicTokenizer on the card differs from CPU")
    print("basic 512: equal to the plain path on the CPU")

    # adversarial: one 1 MiB run of a single byte
    run = "a" * (1 << 20)
    ga, ca = BasicTokenizer(device="cuda"), BasicTokenizer(device="cpu")
    with path("run_264", TRAIN_KERNELS):
        t0 = time.perf_counter()
        ga.train(run, 264)
        timings["run_264_train_s"] = time.perf_counter() - t0
        ga_ids = ga.encode(run)
    ca.train(run, 264)
    if ga.merges != ca.merges or ga_ids != ca.encode(run):
        raise AssertionError("single-byte run differs from the plain path")
    print("run of 2^20 'a': equal to the plain path on the CPU")

    # the large-corpus route: the XL corpus (3x the old 4M-token ceiling)
    xl_golden = golden_mod.load_xl_golden()
    xl_text = golden_mod.xl_corpus(ROOT)
    if golden_mod.text_digest(xl_text) != xl_golden["corpus_sha256"]:
        raise AssertionError("the XL corpus differs from the golden's")
    xl_tok = RegexTokenizer(device="cuda")
    out = io.StringIO()
    torch.cuda.synchronize()
    with path("train_xl", TRAIN_KERNELS):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            xl_tok.train(xl_text, golden_mod.VOCAB_SIZE, verbose=True)
        torch.cuda.synchronize()
        timings["train_xl_s"] = time.perf_counter() - t0
    counts = np.array([int(c) for c in
                       re.findall(r"had (\d+) occurrences", out.getvalue())])
    if not np.array_equal(merges_in_rank_order(np, xl_tok.merges),
                          xl_golden["merges"]):
        raise AssertionError("XL merges differ from the XL golden")
    if not np.array_equal(counts, xl_golden["counts"]):
        raise AssertionError("XL merge counts differ from the XL golden")
    if len(xl_tok.merges) != xl_golden["fail_round"]:
        raise AssertionError("the XL fail round differs from the golden")
    note_batching(train_mod, timings, "train_xl", len(xl_tok.merges))
    print(f"train_xl: {xl_golden['corpus_bytes']} bytes, "
          f"{len(xl_tok.merges)} merges equal to the XL golden "
          f"({timings['train_xl_s']:.3f} s, {timings['train_xl_rebuilds']} "
          f"rebuilds, {timings['train_xl_merges_per_rebuild']:.3f} merges "
          f"per rebuild, {timings['train_xl_slots']} slots, "
          f"{timings['train_xl_syncs']} syncs)")

    selection_paths(torch, np, golden_mod, corpus, path, timings, head, gb,
                    scratch)
    return timings, launches


def selection_paths(torch, np, golden_mod, corpus, path, timings, head, gb,
                    scratch):
    """The selection and stepped routes on the smoke corpus, the default
    route at vocab 2048, checkpoint and resume, and profile_dir."""
    from minbpe_tpu_torch import BasicTokenizer, RegexTokenizer
    from minbpe_tpu_torch.utils import checkpoint as ckpt

    golden = golden_mod.load_golden()
    golden2k = golden_mod.load_golden_2048()
    V, V2k = golden_mod.VOCAB_SIZE, golden_mod.VOCAB_SIZE_2048
    M, M2k = V - 256, V2k - 256

    def train(name, vocab, exact, **opts):
        """(merges, counts) of one training run on the corpus, the path's
        launches counted exactly."""
        tok = RegexTokenizer(device="cuda")
        out = io.StringIO()
        torch.cuda.synchronize()
        with path(name, [k for k, c in exact.items() if c], exact):
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                tok.train(corpus, vocab, verbose=True, **opts)
            torch.cuda.synchronize()
            timings[f"{name}_s"] = time.perf_counter() - t0
        counts = np.array([int(c) for c in re.findall(
            r"had (\d+) occurrences", out.getvalue())])
        return merges_in_rank_order(np, tok.merges), counts

    def check(name, got, want, rows=None):
        merges, counts = got
        if rows is not None:
            merges, counts = merges[:rows], counts[:rows]
        if not (np.array_equal(merges, want["merges"][:len(merges)])
                and np.array_equal(counts, want["counts"][:len(counts)])
                and len(merges) == (rows or want["fail_round"])):
            raise AssertionError(f"{name}: merges or counts differ from the "
                                 "golden")
        print(f"{name}: {len(merges)} merges equal to the golden "
              f"({timings[f'{name}_s']:.3f} s)")

    per_round = {"merge_apply": M, "compact": M}
    check("train_pallas", train("train_pallas", V, {
        "pair_count": M, **per_round}, select_mode="pallas"), golden)
    check("train_sort", train("train_sort", V, per_round,
                              select_mode="sort"), golden)
    check("train_dense", train("train_dense", V, per_round,
                               select_mode="dense"), golden)
    check("train_stepped", train("train_stepped", V, {"pair_count": 1},
                                 select_mode="stepped"), golden)

    # the default route at vocab 2048 is the stepped trainer
    auto2k = train("train_auto_2048", V2k, {"pair_count": 1})
    check("train_auto_2048", auto2k, golden, rows=M)
    check("train_auto_2048", auto2k, golden2k)
    sort2k = train("train_sort_2048", V2k,
                   {"merge_apply": M2k, "compact": M2k}, select_mode="sort")
    if not all(np.array_equal(a, b) for a, b in zip(auto2k, sort2k)):
        raise AssertionError("train_auto_2048 differs from train_sort_2048")
    check("train_sort_2048", sort2k, golden2k)

    # checkpoint every 256 rounds, interrupted after round 512, resumed
    ck = os.path.join(scratch, "smoke.ckpt.npz")
    every = M // 3
    stop_at = 2 * every

    def stop(done, total):
        if done > stop_at:
            raise KeyboardInterrupt

    cut = RegexTokenizer(device="cuda")
    with path("checkpoint_resume", ("pair_count", "merge_apply", "compact"),
              {"pair_count": 2, "merge_apply": stop_at, "compact": stop_at}):
        t0 = time.perf_counter()
        try:
            cut.train(corpus, V, checkpoint_path=ck, checkpoint_every=every,
                      progress=stop)
            raise AssertionError("the progress callback did not interrupt")
        except KeyboardInterrupt:
            pass
        if ckpt.load(ck)["round_idx"] != stop_at:
            raise AssertionError(f"the checkpoint is not at round {stop_at}")
        resumed = RegexTokenizer(device="cuda")
        resumed.train(corpus, V, resume_from=ck)
        torch.cuda.synchronize()
        timings["checkpoint_resume_s"] = time.perf_counter() - t0
    if not np.array_equal(merges_in_rank_order(np, resumed.merges),
                          golden["merges"]):
        raise AssertionError("the resumed run differs from the golden")
    print(f"checkpoint_resume: interrupted after round {stop_at}, resumed "
          "from the checkpoint, equal to the golden")

    # profile_dir: the trace of a training run
    trace_dir = os.path.join(scratch, "trace")
    traced = BasicTokenizer(device="cuda")
    with path("profile_dir", TRAIN_KERNELS):
        traced.train(head, 512, profile_dir=trace_dir)
    traces = [f for f in os.listdir(trace_dir) if f.endswith(".json")]
    if not traces or traced.merges != gb.merges:
        raise AssertionError(f"profile_dir: traces {traces}, merges equal "
                             f"{traced.merges == gb.merges}")
    print(f"profile_dir: {traces[0]} "
          f"({os.path.getsize(os.path.join(trace_dir, traces[0]))} bytes)")


def note_batching(train_mod, timings, name: str, merges: int):
    """Rebuilds, slots and syncs of the run just made; batching must have
    taken fewer rebuilds than merges."""
    timings[f"{name}_rebuilds"] = train_mod.LAST_REBUILDS
    timings[f"{name}_slots"] = train_mod.LAST_SLOTS
    timings[f"{name}_syncs"] = train_mod.LAST_SYNCS
    timings[f"{name}_merges_per_rebuild"] = merges / train_mod.LAST_REBUILDS
    if not 0 < train_mod.LAST_REBUILDS < merges:
        raise AssertionError(f"{name}: {train_mod.LAST_REBUILDS} rebuilds "
                             f"for {merges} merges")


def _kernel_name(key: str) -> str:
    m = re.search(r"::(\w+(?:<[^>]*>)?)\(", key)
    return m.group(1) if m else key[:40]


def phase_device_time(torch, golden_mod):
    """Device busy time against wall time of the training and encode runs on
    the smoke corpus, and of the training run on the XL corpus. The wall
    time is a plain run's; the busy time is the sum of device activity
    (kernels, memsets, copies) that torch.profiler records for the same
    call, which runs on one stream, so nothing overlaps. The idle share is
    1 - busy / wall."""
    from minbpe_tpu_torch import RegexTokenizer
    from minbpe_tpu_torch.engine import device_table
    from minbpe_tpu_torch.ops.encode import encode_stream
    from minbpe_tpu_torch.ops.stream import build_stream
    from minbpe_tpu_torch.ops.train import train_merges
    from minbpe_tpu_torch.ops.train_inc import train_merges_stepped
    from minbpe_tpu_torch.ops.train_select import train_merges_select

    corpus = golden_mod.smoke_corpus(ROOT)
    tok = RegexTokenizer(device="cuda")
    tok.train(corpus, golden_mod.VOCAB_SIZE)
    table = device_table(tok)
    data, ends = tok._split_arrays(corpus)
    ids, seg = build_stream(data, ends, "cuda")
    xl_ids, xl_seg = build_stream(*tok._split_arrays(
        golden_mod.xl_corpus(ROOT)), "cuda")
    M = golden_mod.VOCAB_SIZE - 256
    runs = {
        "train": lambda: train_merges(ids, seg, M),
        "train_xl": lambda: train_merges(xl_ids, xl_seg, M),
        "train_pallas": lambda: train_merges_select(ids, seg, M, "pallas"),
        "train_stepped": lambda: train_merges_stepped(ids, seg, M),
        "encode": lambda: encode_stream(ids, seg, table.pairs,
                                        table.new_ids)[2].item(),
    }
    out = {}
    for name, fn in runs.items():
        fn()  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        parts = profiled_events(torch, fn)
        busy = sum(p[0] for p in parts)
        out[name] = {
            "wall_ms": wall,
            "device_busy_ms": busy if busy else None,
            "idle_share": 1 - busy / wall if busy else None,
            "by_kernel": [[_kernel_name(k), ms, c] for ms, c, k in parts[:9]],
        }
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        return fail("CUDA is not available")
    try:
        import numpy as np

        from minbpe_tpu_torch import kernels
        from minbpe_tpu_torch.engine import STEPPED_AUTO_MAX_N
        from minbpe_tpu_torch.ops.train import XL_MAX_N
        from minbpe_tpu_torch.utils import golden as golden_mod
        from minbpe_tpu_torch.utils import native
    except ImportError as e:
        return fail(f"the package is not beside this script ({e})")

    scratch = os.path.join(kernels.BUILD_DIR, "smoke")
    shutil.rmtree(scratch, ignore_errors=True)
    os.makedirs(scratch)
    try:
        phase_build(kernels, native)
        rows = phase_kernels(torch, np, kernels, XL_MAX_N,
                             STEPPED_AUTO_MAX_N)
        timings, launches = phase_main_path(torch, np, kernels, golden_mod,
                                            scratch)
        device_time = phase_device_time(torch, golden_mod)
    except Exception as e:  # report the failing phase, exit non-zero
        import traceback

        traceback.print_exc()
        return fail(f"{type(e).__name__}: {e}")
    finally:
        shutil.rmtree(scratch, ignore_errors=True)

    def by_path(name):
        return {p: c[name] for p, c in launches.items() if c[name]}

    line = {"kernels": [
        {"name": r["k"].name, "route": "cuda", "source": r["k"].source,
         "replaces": r["k"].replaces,
         "launches": sum(by_path(r["k"].name).values()),
         "launches_by_path": by_path(r["k"].name),
         "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bytes"] / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
         "library_ms": r["library_ms"],
         **{k: r[k] for k in ("xl", "shapes") if k in r}}
        for r in rows]}
    print(json.dumps(line))
    print(json.dumps({"main_path": timings}))
    print(json.dumps({"device_time": device_time}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
