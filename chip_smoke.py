#!/usr/bin/env python3
"""Smoke run of minbpe_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (the script exits non-zero otherwise):

1. build the CUDA kernels (nvcc) and the native pre-split scanner (g++)
   from the checkout's sources, both at once;
2. hold each kernel against its plain PyTorch version on the card, on
   numpy-seeded inputs at the main path's shapes (400K tokens, W = 1024,
   the rebuild of merge 768, a batch of 16 candidates drawn from the
   stream; K3 timed at a homogeneous and at a heterogeneous pair; K5 at
   W = 256, 512 and 1024, each with torch.topk's time), K1, K6 and K8
   once more at the XL bound (48M tokens), K9 also at V = 2048 and at
   the stepped route's bound (4M tokens), K1 and K9 also on real text (the
   smoke corpus's stream as pre-split, W = 256; the same after the
   golden's 768 merges, W = 1024; the XL corpus's stream, W = 256), each
   shape with its bytes bound and torch.bincount's time, and K10 over the
   smoke corpus's stream with the golden's 768 merges, over 2^20 copies of
   "a", over the first of phase 3's 256 documents (one block), over the
   smoke stream with the 3,840 merges of smoke_plus_4096 and over the XL
   corpus's stream; K17 (the dense route's per-segment loop) against its
   plain twin and K10 over the smoke corpus's stream with the golden's 768
   merges, over three of the regex512-encode-docs cell's documents (the
   median, one of the mean length, the longest) as the device split cuts
   them, with the cell's table, and over a text whose split holds chunks
   of 300 to 70,000 tokens (the block's loop in device memory); K11 and
   K12 (the sorted route) over the smoke corpus's
   GPT-4 split with the GPT-4 table at 100,256 ranks and with
   smoke_plus_4353, over its first 65,536 bytes as one chunk with both,
   over the whole corpus as one chunk with the vocab-8192 golden's merges
   and over the corpus cut into chunks of 257-4,096 bytes with
   smoke_plus_4353, K12 also with each chunk's rounds against its own
   sweep's (the longest chunk's, their sum, and the distinct ranks of all
   chunks, the rounds of a sweep whose rounds are global); K13
   pair_select (the sort-round trainer's count and selection, one launch a
   round) against pair_select_plain's record and
   select_max_pair's pair, with the table empty after every launch, over
   the 400K stream, the smoke stream after the vocab-8192 golden's first
   4,000 merges, 2^20 copies of "a", 2^20 distinct ids, the XL corpus's
   stream and that stream four times over (50,353,352 tokens), each with
   its bytes bound and torch.unique's time; K16 pair_summaries' count at
   the same six shapes at K = 2^17 (its rows, the rows written and the
   overflow flag against pair_summaries_plain, the table empty after it)
   and its merge of four ranks' rows of the 400K stream; K3 also from a
   carry-in of 1, with its transfer bits and the gated launch; K15
   presplit_succ and
   presplit_orbit (the device pre-split) against their plain twin, the
   split's boundaries and segment ids and each kernel's own step, on the
   smoke and the XL corpus in both modes, the XL corpus four times over
   and 2^20 spaces, letters and digits, each with its bytes bound (the
   whole split's time at the main shape also from the profiler); K15
   presplit_cluster against the same twin and the pair on the encode
   cell's median, mean-length and longest documents and the smoke
   corpus's first 1, 2, 4 and 8 tiles, in both modes, with the pair's time
   on the same bytes; the outputs are integers and must be exactly equal;
3. drive the main path through the user's entry points, one path at a
   time, with every launch count set to 0 just before each path and read
   just after it: RegexTokenizer (GPT-4 pattern) training at vocab 1024 on
   the frozen in-repo smoke corpus (merges and counts equal to the golden
   that minbpe_tpu produced, in fewer rebuilds than merges), encode (ids'
   sha256 equal to the golden's), the same encode with the device
   pre-split (K15 once each, K17 once, every other kernel and the host
   scanner never), decode, encode_batch and the same
   documents encoded one by one, special tokens, save/load, a
   BasicTokenizer at vocab 512 and one on 2^20 copies of "a", both equal to
   the plain path on the CPU (every encode path launching one kernel per
   device stream, K17 for a split text and K10 for a BasicTokenizer's one
   segment, and K3/K4 never), and the large-corpus route: vocab 1024
   on the 12,588,338-byte XL corpus, equal to the XL golden. Then the selection
   and stepped routes on the smoke corpus: select_mode "pallas", "sort",
   "dense" and "stepped" at vocab 1024 (each equal to the golden, with the
   launches of each kernel counted exactly), the default route at vocab
   2048 (the stepped trainer; equal to the 2048 golden and to "sort" at
   2048), a checkpointed run interrupted after round 512 and resumed, and
   a run with a profile_dir, which must leave a trace. The encode routes
   past the fused Pallas encoder's bounds, each equal to the encode golden
   minbpe_tpu wrote: GPT4Tokenizer at 100,256 synthetic ranks (encode,
   decode, the 256 documents as one batch, special tokens), RegexTokenizer
   on smoke_plus_4096 (dense) and smoke_plus_4353 (sorted), the
   BasicTokenizer on the latter (one chunk), and the XL corpus through the
   dense route, with the host split and with the device split. Then the
   routes past vocab 2048 and 48·2^20 tokens:
   smoke-8192 (vocab 8,192 on the smoke corpus) by the default route (the
   sort-round trainer), "sortloop_inc", "sparse" and "sparse_inc", each
   equal to the vocab-8192 golden; the XL corpus at vocab 1024 with a
   checkpoint every 256 rounds, cut after round 512 and resumed, equal to
   the XL golden; and the XL corpus's split tiled four times (50,353,352
   tokens), equal to the XL golden's merges with four times its counts;
4. in a process of its own, the device's busy time (torch.profiler) in
   the encode runs (the 768-merge table and GPT-4's; the whole smoke
   encode with the host split and with the device split), the training runs
   on both corpora, the "pallas" and stepped runs on the smoke corpus and
   smoke-8192's default route against their wall time: the idle share;
5. the distributed layer (minbpe_tpu_torch.parallel): world 1 over NCCL
   in this process (smoke-1024 by the dense, sparse and owner selections,
   the XL corpus dense, each equal to its golden; a run checkpointed every
   256 rounds, cut at round 512 and resumed; the sharded encode of the
   smoke corpus), then world 4 over gloo as four processes on the one card
   (smoke-1024 by each selection, sparse and owner to the golden's first
   256 merges, the Basic byte path against the single-device
   BasicTokenizer on the same 64 KB, the sharded encode),
   every path's launches held exactly and its wall, rounds a second and
   collectives called printed;
6. the tools around the library, each path's launches held exactly: the
   command line (train_torch.py) at vocab 1024 on the smoke corpus
   in-process (the whole-run trainer's launches, phase 3's "train"), with
   a checkpoint every 256 rounds (the stepped route: K9 once), resumed
   from that checkpoint cut back to round 512 (K9 once, K3 and K4 512
   times: the replay), distributed at world 1 over NCCL (a dense round
   each) and with a profile (a trace left), each model equal to the
   golden and its .model bytes to the first's, then as a script in a
   process of its own (the same bytes); the first request (train
   smoke-1024, encode it) of two fresh processes, cold and after
   precompile (its bucket fused_capacity's), each equal to the goldens;
   entry_torch.entry() (K10 once) against the CPU and
   dryrun_multichip(device count) over NCCL; the bucketed chunk encoder
   (plain PyTorch on the card) on the smoke corpus's GPT-4 split with
   gpt4_100k and with smoke_plus_4353 (no kernel; ids equal to the encode
   golden and to the flat encoder's, K11 once, each timed) and on the
   first 65,536 bytes as one chunk (past its largest bucket:
   encode_stream_sorted, K3 and K4 once a round, phase 2's K12 rounds
   rounded up to a group of 8 past the last; ids equal to K12's);
7. print the kernels line (launches of each path in phases 3, 5 and 6,
   errors and times of phase 2), the main path's timings, the busy times,
   the distributed paths' timings, phase 6's walls with phase 1's build
   times, the card's name and power limit, and last the result line.

Without CUDA, or without the package beside it, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import contextlib
import hashlib
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
    return {"kernels_build_s": ks, "scanner_build_s": ns}


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

# sleep cycles a call, tried in turn, for device_ms and split_ms
SLEEP_CYCLES = (400_000, 3_200_000)
# the readings device_ms and split_ms took again behind a longer sleep
# (the function, the sleep, the reading set aside), and those they took
# from the profiler (the function, the reading, each activity's count over
# the reps): the host outran the sleep
RETAKEN_READINGS: list = []
PROFILED_READINGS: list = []


def device_ms(torch, fn, reps: int) -> float:
    """Device time per call: the host enqueues every call behind a sleeping
    kernel, so the events time the device work and not the enqueue. That
    holds only while the sleep outlasts the enqueue: where the start event
    has already passed when the last call is enqueued, the device may have
    waited on the host, and the reading is taken again behind a longer
    sleep, then from the profiler's device time (a call that syncs
    outruns any sleep)."""
    fn()
    torch.cuda.synchronize()
    for cycles in SLEEP_CYCLES:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(reps * cycles)
        start.record()
        for _ in range(reps):
            fn()
        covered = not start.query()
        end.record()
        torch.cuda.synchronize()
        if covered:
            return start.elapsed_time(end) / reps
        RETAKEN_READINGS.append((getattr(fn, "__qualname__", "?"), cycles,
                                 start.elapsed_time(end) / reps))
    return profiled_call_ms(torch, fn, reps)


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


def profiled_call(torch, fn, reps: int):
    """(ms, counts): device time per call from the profiler, each device
    activity's mean time times its count a call (its count over reps,
    rounded, at least 1), so that records the profiler drops do not lower
    the reading; and each activity's count, as "count/reps"."""
    fn()
    torch.cuda.synchronize()

    def loop():
        for _ in range(reps):
            fn()

    parts = profiled_events(torch, loop)
    if not parts:
        raise RuntimeError("the profiler recorded no device time")
    ms = sum(t / c * max(1, round(c / reps)) for t, c, _ in parts)
    return ms, {name: f"{c}/{reps}" for _, c, name in parts}


def profiled_ms(torch, fn, reps: int) -> float:
    """Device time per call from the profiler (profiled_call), for calls
    that wait on the device (a library call that reads a size back): CUDA
    events around them would also time the host's round trip."""
    return profiled_call(torch, fn, reps)[0]


def profiled_call_ms(torch, fn, reps: int) -> float:
    """profiled_ms, kept in PROFILED_READINGS with the counts."""
    ms, counts = profiled_call(torch, fn, reps)
    PROFILED_READINGS.append((getattr(fn, "__qualname__", "?"), ms, counts))
    return ms


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
    them crossing the kernels' 2048-position tiles."""
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


def text_streams(torch, np, kernels, golden_mod):
    """[(name, ids, seg, W)]: the real-text streams K1 and K9 are timed on,
    on the card: the smoke corpus as pre-split (the first rebuild, W =
    256), the same stream after the golden's 768 merges (K10's plain rank
    loop; W = 1024) and the XL corpus as pre-split (W = 256)."""
    from minbpe_tpu_torch import RegexTokenizer
    from minbpe_tpu_torch.convert import tokenizer_from_arrays
    from minbpe_tpu_torch.ops.stream import build_stream

    golden = golden_mod.load_golden()
    M = len(golden["merges"])
    tok = tokenizer_from_arrays(RegexTokenizer, golden["merges"],
                                256 + np.arange(M), device="cuda")
    ids, seg = build_stream(*tok._split_arrays(golden_mod.smoke_corpus(ROOT)),
                            "cuda")
    pairs = torch.from_numpy(np.asarray(golden["merges"], np.int32)).to(
        ids.device)
    new_ids = torch.arange(256, 256 + M, dtype=torch.int32, device=ids.device)
    m_ids, m_seg, m_n = kernels.encode_sweep_plain(ids, seg, pairs, new_ids)
    k = int(m_n)
    xl_ids, xl_seg = build_stream(*tok._split_arrays(
        golden_mod.xl_corpus(ROOT)), "cuda")
    return [("smoke_w256", ids, seg, 256),
            ("smoke_768_merges_w1024", m_ids[:k].contiguous(),
             m_seg[:k].contiguous(), 256 + M),
            ("xl_w256", xl_ids, xl_seg, 256)]


def hist_case(torch, kernels, name, c_ids, c_seg, W: int, stats: bool):
    """K1 (stats) or K9 over a whole stream at width W, against its plain
    version. Returns (the record, the kernel's outputs). K1 writes into
    matrices allocated once, as the trainer calls it. The bound: each
    token's id and seg read once, each entry of the W x W matrices written
    once (K1 cnt and first, 8 B; K9 cnt, 4 B); the library call:
    torch.bincount over the countable pairs' keys."""
    dev = c_ids.device
    n = c_ids.numel()
    c_n = torch.full((1,), n, dtype=torch.int32, device=dev)
    if stats:
        out = (torch.zeros((W, W), dtype=torch.int32, device=dev),
               torch.full((W, W), -1, dtype=torch.int32, device=dev))

        def run():
            return kernels.pair_stats(c_ids, c_seg, c_n, W, out=out)

        def plain():
            return kernels.pair_stats_plain(c_ids, c_seg, c_n, W)
    else:
        def run():
            return (kernels.pair_count(c_ids, c_seg, c_n, W),)

        def plain():
            return (kernels.pair_count_plain(c_ids, c_seg, c_n, W),)
    got = run()
    err = max_err(torch, list(zip(got, plain())))
    if int(got[0].sum()) <= 0:
        raise AssertionError(f"{'pair_stats' if stats else 'pair_count'} "
                             f"counted nothing on {name}")
    a, b = c_ids[:-1].long(), c_ids[1:].long()
    keys = (a * W + b)[(c_seg[:-1] == c_seg[1:]) & (a >= 0) & (a < W)
                       & (b >= 0) & (b < W)]
    del a, b
    big = n > (1 << 22)
    nbytes = 8 * n + (8 if stats else 4) * W * W
    rec = dict(
        case=name, n=n, W=W, max_abs_err=err,
        grid=kernels._load().bpe_pair_hist_grid(int(stats), n, 0),
        ms=device_ms(torch, run, 10 if big else 50),
        plain_ms=host_ms(torch, plain, 1 if big else 5),
        bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
        library_ms=profiled_ms(torch, lambda: torch.bincount(
            keys, minlength=W * W), 10 if big else 50))
    print(f"{'pair_stats' if stats else 'pair_count'} {name}: n {n}, W {W}, "
          f"grid {rec['grid']}, max_abs_err {err}, {rec['ms']:.5f} ms, bound "
          f"{rec['bound_ms']:.5f} ms, bincount {rec['library_ms']:.5f} ms")
    return rec, got


def hist_row(info, main, shapes):
    return dict(k=info, err=main["max_abs_err"], ms=main["ms"],
                plain_ms=main["plain_ms"], bytes=main["bytes"],
                library_ms=main["library_ms"], shapes=shapes)


def phase_kernels(torch, np, kernels, xl_max_n: int, stepped_max_n: int,
                  texts):
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

    # K1 pair_stats (its other shapes after K9's)
    main1, (ck, fk) = hist_case(torch, kernels, "zipf_400k", ids, seg, W,
                                True)
    rows.append(hist_row(kernels.PAIR_STATS, main1, []))

    # K5 select_batch on K1's matrices at merge I, and on empty ones (the
    # fail round); its state is compared whole. Timed at W = 256, 512 and
    # 1024 (ctl's i = W - 256) on the same matrices: a smoke-1024 run
    # spends most of its slots at the narrower widths
    def select(fn, cnt, first, i=I):
        _, ctl, log = batch_state(torch, kernels, dev, [], i, M)
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
    scratch = kernels.select_scratch(W, dev)
    packed = torch.where(ck > 0, (ck.long() << 32) | (0xFFFFFFFF - (
        fk.long() & 0xFFFFFFFF)), torch.zeros_like(ck, dtype=torch.long))
    shapes5 = []
    for w in (256, 512, W):
        got_w = select(kernels.select_batch, ck, fk, w - 256)
        err = max_err(torch, list(zip(got_w, select(
            kernels.select_batch_plain, ck, fk, w - 256))))
        _, tctl, tlog = batch_state(torch, kernels, dev, [], w - 256, M)
        tslot = kernels.new_slot(dev)
        corner = packed[:w, :w].reshape(-1)
        nbytes = 8 * w * w + 4 * kernels.SLOT_SIZE
        shapes5.append(dict(
            W=w, max_abs_err=err, bsel=int(got_w[0][kernels.SLOT_BSEL]),
            ms=device_ms(torch, lambda: kernels.select_batch(
                ck, fk, ids, tctl, tslot, tlog, scratch), 50),
            bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
            library_ms=profiled_ms(torch, lambda: torch.topk(
                corner, kernels.K_CAP), 50)))
        r = shapes5[-1]
        print(f"select_batch W {w}: bsel {r['bsel']}, max_abs_err {err}, "
              f"{r['ms']:.5f} ms, bound {r['bound_ms']:.5f} ms, topk "
              f"{r['library_ms']:.5f} ms")
    _, tctl, tlog = batch_state(torch, kernels, dev, [], I, M)
    tslot = kernels.new_slot(dev)
    rows.append(dict(
        k=kernels.SELECT_BATCH, err=err5, ms=shapes5[-1]["ms"],
        plain_ms=host_ms(torch, lambda: kernels.select_batch_plain(
            ck, fk, ids, tctl, tslot, tlog), 5),
        bytes=shapes5[-1]["bytes"], library_ms=shapes5[-1]["library_ms"],
        shapes=shapes5))
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
    # the distributed trainer's carry-in: from token 1, with the transfer
    # bits, and the gated launch that redoes carry-in 1 over carry-in 0's
    # output
    one = torch.ones(1, dtype=torch.int32, device=dev)
    for pair in ((7, 7), tuple(got[0][:2].tolist())):
        pt = torch.tensor(pair, dtype=torch.int32, device=dev)
        tk = torch.zeros(2, dtype=torch.int32, device=dev)
        tp = torch.zeros(2, dtype=torch.int32, device=dev)
        ok_ids, ok_live = kernels.merge_apply(ids, seg, nt, pt, 5000,
                                              carry=one, tf=tk)
        op_ids, op_live = kernels.merge_apply_plain(ids, seg, nt, pt, 5000,
                                                    carry=one, tf=tp)
        out = kernels.merge_apply(ids, seg, nt, pt, 5000)
        kernels.merge_apply(ids, seg, nt, pt, 5000, carry=one, gate=True,
                            out=out)
        err3 = max(err3, max_err(torch, [
            (ok_ids[:n], op_ids[:n]), (ok_live[:n], op_live[:n]), (tk, tp),
            (out[0][:n], op_ids[:n]), (out[1][:n], op_live[:n])]))
    # timed at the run pair (homogeneous: the run-start chain) and at the
    # stream's top heterogeneous pair (the common case: no chain), from
    # carry-in 0 and from carry-in 1 (with the transfer bits)
    hetero = draw_batch(np, ck.cpu().numpy(), fk.cpu().numpy(), 1)[0][:2]
    by_pair = []
    tk = torch.zeros(2, dtype=torch.int32, device=dev)
    for pair in ((7, 7), hetero):
        pt = torch.tensor(pair, dtype=torch.int32, device=dev)
        by_pair.append(dict(pair=list(pair), ms=device_ms(
            torch, lambda: kernels.merge_apply(ids, seg, nt, pt, 5000), 50),
            carry1_ms=device_ms(torch, lambda: kernels.merge_apply(
                ids, seg, nt, pt, 5000, carry=one, tf=tk), 50)))
    pt = torch.tensor((7, 7), dtype=torch.int32, device=dev)
    rows.append(dict(
        k=kernels.MERGE_APPLY, err=err3, ms=by_pair[0]["ms"],
        by_pair=by_pair,
        plain_ms=host_ms(torch, lambda: kernels.merge_apply_plain(
            ids, seg, nt, pt, 5000), 5),
        bytes=13 * n, library_ms=None))
    print(f"merge_apply: {by_pair[0]['ms']:.5f} ms at {by_pair[0]['pair']}, "
          f"{by_pair[1]['ms']:.5f} ms at {by_pair[1]['pair']}; carry-in 1: "
          f"{by_pair[0]['carry1_ms']:.5f}, {by_pair[1]['carry1_ms']:.5f}")

    # K6 batch_hist, then K8, on a batch of K_CAP candidates drawn from the
    # stream; K6's library call: bincount over the left partners' keys
    pairs = draw_batch(np, ck.cpu().numpy(), fk.cpu().numpy(), kernels.K_CAP)
    if len(pairs) != kernels.K_CAP:
        raise AssertionError(f"drew {len(pairs)} candidates")
    slot, ctl, log = batch_state(torch, kernels, dev, pairs, I, M)
    acc_k, acc_p = kernels.new_hist(dev), kernels.new_hist(dev)
    cand_k = kernels.batch_hist(ids, seg, nt, slot, acc_k,
                                torch.empty_like(ids))
    cand_p = kernels.batch_hist_plain(ids, seg, nt, slot, acc_p,
                                      torch.empty_like(ids))
    err6 = max_err(torch, [(cand_k[:n], cand_p[:n]), (acc_k, acc_p)])
    sites = cand_k[:n] >= 0
    nsites = int(sites.sum())
    site_pos = torch.nonzero(sites).flatten()
    zb = 256 + I
    _, F_p = kernels.batch_mark_plain(ids, seg, nt, slot,
                                      kernels.new_hist(dev)[0])
    pF = F_p[site_pos - 1].long()
    hist_key = (pF & 127) * kernels.K_CAP + cand_k[site_pos].long()
    del F_p
    acc_t = kernels.new_hist(dev)
    cand_t = torch.empty_like(ids)
    hist_bytes = 2 * 4 * kernels.HIST_BUCKETS * kernels.K_CAP
    row6 = dict(
        k=kernels.BATCH_HIST, err=err6,
        ms=device_ms(torch, lambda: kernels.batch_hist(
            ids, seg, nt, slot, acc_t, cand_t), 50),
        plain_ms=host_ms(torch, lambda: kernels.batch_hist_plain(
            ids, seg, nt, slot, acc_t, cand_t), 5),
        bytes=12 * n + hist_bytes,
        library_ms=profiled_ms(torch, lambda: torch.bincount(
            hist_key, minlength=kernels.HIST_BUCKETS * kernels.K_CAP), 50))
    rows.append(row6)
    print(f"batch: {len(pairs)} candidates, {nsites} sites; left partners "
          f"in a site: {int((pF >= zb).sum())}; batch_hist "
          f"{row6['ms']:.5f} ms")

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
    t_scratch = kernels.batch_scratch(dev)
    # timing: the advance of i per call stays inside the log's M rows
    t_ctl[kernels.CTL_I] = 0
    t_slot[kernels.SLOT_I] = 0
    row8 = dict(
        k=kernels.BATCH_APPLY, err=err8,
        ms=device_ms(torch, lambda: kernels.batch_apply(
            ids, nt, cand_k, t_slot, acc_t, t_ctl, t_log, M, t_out, t_live,
            t_scratch), 50),
        plain_ms=host_ms(torch, lambda: kernels.batch_apply_plain(
            ids, nt, cand_k, t_slot, acc_t, t_ctl, t_log, M, t_out, t_live),
            5),
        bytes=13 * n + 8 * kernels.HIST_BUCKETS * kernels.K_CAP,
        library_ms=None)
    rows.append(row8)
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
    # own with ids below 2048), at the stepped route's 4 * 2^20 tokens and
    # on the real-text streams; K1 on those too
    main9, _ = hist_case(torch, kernels, "zipf_400k", ids, seg, W, False)
    ids2k, seg2k = (torch.from_numpy(a).to(dev)
                    for a in smoke_stream(np, n, 2048))
    shapes9 = [hist_case(torch, kernels, "zipf_400k_v2048", ids2k, seg2k,
                         2048, False)[0]]
    del ids2k, seg2k
    big_ids, big_seg = xl_stream(torch, ids, seg, stepped_max_n)
    shapes9.append(hist_case(torch, kernels, "zipf_4m", big_ids, big_seg, W,
                             False)[0])
    del big_ids, big_seg
    for name, t_ids, t_seg, t_W in texts:
        rows[0]["shapes"].append(hist_case(torch, kernels, name, t_ids, t_seg,
                                           t_W, True)[0])
        shapes9.append(hist_case(torch, kernels, name, t_ids, t_seg, t_W,
                                 False)[0])
    rows.append(hist_row(kernels.PAIR_COUNT, main9, shapes9))

    # K1, K6 and K8 at the XL bound: the same stream repeated to XL_MAX_N
    # tokens
    big_ids, big_seg = xl_stream(torch, ids, seg, xl_max_n)
    big_n = torch.tensor([xl_max_n], dtype=torch.int32, device=dev)
    rows[0]["shapes"].append(hist_case(torch, kernels, "zipf_48m", big_ids,
                                       big_seg, W, True)[0])
    xa_k, xa_p = kernels.new_hist(dev), kernels.new_hist(dev)
    mk = kernels.batch_hist(big_ids, big_seg, big_n, slot, xa_k,
                            torch.empty_like(big_ids))
    mp = kernels.batch_hist_plain(big_ids, big_seg, big_n, slot, xa_p,
                                  torch.empty_like(big_ids))
    xl6 = max_err(torch, [(mk, mp), (xa_k, xa_p)])
    del mp
    x_cand = torch.empty_like(big_ids)
    nbytes = 12 * xl_max_n + hist_bytes
    row6["xl"] = dict(
        n=xl_max_n, max_abs_err=xl6,
        ms=device_ms(torch, lambda: kernels.batch_hist(
            big_ids, big_seg, big_n, slot, acc_t, x_cand), 5),
        bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
    del x_cand
    print(f"xl size {xl_max_n}: batch_hist max_abs_err {xl6} "
          f"({row6['xl']['ms']:.4f} ms, bound "
          f"{row6['xl']['bound_ms']:.4f} ms)")

    # K8 there too, on K6's output: its bound at scale
    def apply_big(fn):
        s2, c2, l2 = slot.clone(), ctl.clone(), log.clone()
        out = torch.empty_like(big_ids)
        live = torch.empty(big_ids.shape, dtype=torch.bool, device=dev)
        fn(big_ids, big_n, mk, s2, xa_k.clone(), c2, l2, M, out, live)
        return out, live, s2, c2, l2

    xl8 = max_err(torch, list(zip(apply_big(kernels.batch_apply),
                                  apply_big(kernels.batch_apply_plain))))
    x_out = torch.empty_like(big_ids)
    x_live = torch.empty(big_ids.shape, dtype=torch.bool, device=dev)
    nbytes = 13 * xl_max_n + 8 * kernels.HIST_BUCKETS * kernels.K_CAP
    row8["xl"] = dict(
        n=xl_max_n, max_abs_err=xl8,
        ms=device_ms(torch, lambda: kernels.batch_apply(
            big_ids, big_n, mk, t_slot, acc_t, t_ctl, t_log, M, x_out,
            x_live, t_scratch), 5),
        bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
    print(f"xl size {xl_max_n}: batch_apply max_abs_err {xl8} "
          f"({row8['xl']['ms']:.4f} ms, bound "
          f"{row8['xl']['bound_ms']:.4f} ms)")
    del big_ids, big_seg, mk, x_out, x_live

    return rows


def phase_sweep(torch, np, kernels, golden_mod):
    """K10 against its plain rank loop on the card: the smoke corpus's
    device stream with the golden's 768 merges, 2^20 copies of "a" (one
    chunk, the pair (97, 97) over every tile) with BasicTokenizer's 8
    merges at vocab 264, one short document with the 768 merges, and the
    dense route past the fused Pallas encoder's bounds: the smoke stream
    with smoke_plus_4096's 3,840 merges and the XL corpus's stream
    (12,588,338 tokens) with the 768 merges. Its
    bound: the function reads the stream's n_0 tokens and the table's M
    rows once and writes the n_M tokens left and n (8 B a token, 12 B a
    row), as B2 keeps the stream in VMEM through every rank."""
    from minbpe_tpu_torch import RegexTokenizer
    from minbpe_tpu_torch.convert import tokenizer_from_arrays
    from minbpe_tpu_torch.ops.stream import build_stream

    dev = torch.device("cuda")
    golden = golden_mod.load_golden()
    M = len(golden["merges"])
    tok = tokenizer_from_arrays(RegexTokenizer, golden["merges"],
                                256 + np.arange(M), device="cuda")
    corpus = golden_mod.smoke_corpus(ROOT)
    ids, seg = build_stream(*tok._split_arrays(corpus), "cuda")
    run = torch.full((1 << 20,), 97, dtype=torch.int32, device=dev)
    run_pairs = [(97, 97)] + [(256 + r, 256 + r) for r in range(7)]
    doc = corpus[:-(-len(corpus) // 256)]  # the first of phase 3's documents
    doc_ids, doc_seg = build_stream(*tok._split_arrays(doc), "cuda")
    xl_ids, xl_seg = build_stream(*tok._split_arrays(
        golden_mod.xl_corpus(ROOT)), "cuda")
    cases = [("smoke", ids, seg, golden["merges"], 256 + np.arange(M)),
             ("run_a", run, torch.zeros_like(run), run_pairs,
              256 + np.arange(8)),
             ("doc", doc_ids, doc_seg, golden["merges"], 256 + np.arange(M)),
             ("smoke_m3840", ids, seg,
              *golden_mod.smoke_plus_merges(golden_mod.DENSE_VOCAB)),
             ("xl", xl_ids, xl_seg, golden["merges"], 256 + np.arange(M))]
    out = []
    for name, c_ids, c_seg, pairs, new_ids in cases:
        pt = torch.tensor(np.asarray(pairs), dtype=torch.int32, device=dev)
        zt = torch.tensor(np.asarray(new_ids), dtype=torch.int32, device=dev)
        want = kernels.encode_sweep_plain(c_ids, c_seg, pt, zt)
        got = kernels.encode_sweep(c_ids, c_seg, pt, zt)
        k = int(want[2])
        err = max_err(torch, [(got[2], want[2]), (got[0][:k], want[0][:k]),
                              (got[1][:k], want[1][:k])])
        nbytes = 8 * c_ids.numel() + 12 * len(pairs) + 8 * k + 4
        out.append(dict(
            case=name, n=c_ids.numel(), ranks=len(pairs), n_out=k,
            max_abs_err=err,
            grid=kernels._load().bpe_encode_grid(c_ids.numel()),
            ms=device_ms(torch, lambda: kernels.encode_sweep(
                c_ids, c_seg, pt, zt), 20),
            plain_ms=host_ms(torch, lambda: kernels.encode_sweep_plain(
                c_ids, c_seg, pt, zt), 1),
            bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3))
        print(f"encode_sweep {name}: {c_ids.numel()} tokens, {len(pairs)} "
              f"ranks -> {k}, grid {out[-1]['grid']}, max_abs_err {err}, "
              f"{out[-1]['ms']:.4f} ms ({out[-1]['ms'] / len(pairs) * 1e3:.3f}"
              f" us a rank), bound {out[-1]['bound_ms']:.4f} ms")
    main = out[0]
    return dict(k=kernels.ENCODE_SWEEP, err=main["max_abs_err"],
                ms=main["ms"], plain_ms=main["plain_ms"], bytes=main["bytes"],
                library_ms=None, shapes=out[1:],
                ms_per_rank=main["ms"] / main["ranks"])


CELL_MODEL = os.path.join("bpebench", "data", "minbpe-regex-v512.model")
CELL_TRAFFIC = os.path.join("bpebench", "traffic", "encode-docs.json")
CELL_SEED = 2**31 + 20  # the documents' starts
# the cl100k-encode-docs cell: its configuration (the 100,256-rank
# stand-in) and its traffic
CL100K_CONFIG = os.path.join("bpebench", "configs-ranks", "gpt4-cl100k.json")
CL100K_TRAFFIC = os.path.join("bpebench", "traffic", "gpt4-encode-docs.json")


def cl100k_standin():
    """(GPT4Tokenizer on the card at the cl100k-encode-docs cell's
    100,256-rank stand-in with cl100k's five specials, seconds its build
    took on the host)."""
    from minbpe_tpu_torch import GPT4Tokenizer
    from minbpe_tpu_torch.gpt4 import GPT4_SPECIAL_TOKENS, load_cl100k_ranks

    with open(os.path.join(ROOT, CL100K_CONFIG)) as f:
        config = json.load(f)
    t0 = time.perf_counter()
    tok = GPT4Tokenizer.from_mergeable_ranks(
        load_cl100k_ranks(os.path.join(ROOT, config["ranks"])),
        GPT4_SPECIAL_TOKENS, device="cuda")
    build_s = time.perf_counter() - t0
    print(f"cl100k stand-in: {len(tok.merges)} merges, built in "
          f"{build_s:.2f} s")
    return tok, build_s


def cell_documents(np, seed: int, traffic: str = CELL_TRAFFIC):
    """An encode cell's documents (regex512-encode-docs' by default):
    (the corpus bytes, the traffic's 4,096 lengths in its order, their
    starts that ``seed`` picks), as the benchmark draws them."""
    from bpebench import inputs

    with open(os.path.join(ROOT, traffic)) as f:
        t = json.load(f)
    data = inputs.corpus_bytes(os.path.join(ROOT, t["corpus"]),
                               t["corpus_sha256"])
    lengths = inputs.document_lengths(
        t["documents"], t["median_bytes"], t["sigma"], t["min_bytes"],
        t["max_bytes"], t["length_seed"])
    lengths = inputs.stratified(lengths, t["strata"], t["length_seed"])
    return data, lengths, inputs.document_starts(data, lengths, seed)


def cell_shapes(np, data, lengths, starts):
    """[(name, document bytes)]: the cell's median document, one of the
    mean length and the longest."""
    order = np.argsort(lengths, kind="stable")
    at_mean = int(np.argmin(np.abs(lengths - float(np.mean(lengths)))))
    return [(name, data[starts[i]:starts[i] + lengths[i]])
            for name, i in (("median", int(order[len(order) // 2])),
                            ("mean", at_mean), ("longest", int(order[-1])))]


# a text whose GPT-4 split holds chunks past CHUNK_MAX: runs of spaces and
# of punctuation, 300 to 70,000 tokens, between words
LONG_CHUNKS = ("x" + " " * 300 + "y" + "!" * 2100 + " and " + " " * 20_000
               + "z" + "-" * 70_000 + " end")


def phase_segment(torch, np, kernels, golden_mod, cl100k):
    """K17 against its plain twin (on the CPU) and K10 on the card: the
    smoke corpus's stream (the host split) with the golden's 768 merges,
    the same stream K10's row times; the regex512-encode-docs cell's
    median, mean-length and longest document, each cut by the device split
    (K15, which writes the ids through the cell's table's byte ids), with
    the cell's 256 merges; the same three of the cl100k-encode-docs cell's
    documents with ``cl100k`` (its 100,256-rank stand-in: 100,000 merges,
    ids up to 100,255, 2^18 cuckoo rows a table), through its byte
    shuffle, against
    the plain twin alone (K10 would sweep all 100,000 ranks); and the first
    5,000 characters of the smoke corpus followed by LONG_CHUNKS, split on
    the host, with the 768 merges. Its bound: it reads the stream's n
    tokens and writes the n_out tokens left (ids and seg, 8 B a token each
    way) and n. The row's time is the regex cell's mean-length document's:
    one request of that cell."""
    from minbpe_tpu_torch import RegexTokenizer
    from minbpe_tpu_torch.convert import tokenizer_from_arrays
    from minbpe_tpu_torch.engine import device_table
    from minbpe_tpu_torch.ops import device_presplit as pdp
    from minbpe_tpu_torch.ops.ranktab import CuckooPairTable
    from minbpe_tpu_torch.ops.stream import build_stream

    golden = golden_mod.load_golden()
    M = len(golden["merges"])
    smoke_tok = tokenizer_from_arrays(RegexTokenizer, golden["merges"],
                                      256 + np.arange(M), device="cuda")
    cell_tok = RegexTokenizer(device="cuda")
    cell_tok.load(os.path.join(ROOT, CELL_MODEL))

    def device_split(raw: bytes, tok=cell_tok):
        d = torch.frombuffer(bytearray(raw), dtype=torch.uint8).cuda()
        _, seg, ids = pdp.presplit_seg_ids(d, len(raw), 4,
                                           device_table(tok).byte_ids)
        return ids, seg

    corpus = golden_mod.smoke_corpus(ROOT)
    cases = [("smoke", smoke_tok, *build_stream(
        *smoke_tok._split_arrays(corpus), "cuda"))]
    cases += [(f"cell_{name}", cell_tok, *device_split(raw)) for name, raw in
              cell_shapes(np, *cell_documents(np, CELL_SEED))]
    cases += [(f"cl100k_{name}", cl100k, *device_split(raw, cl100k))
              for name, raw in cell_shapes(np, *cell_documents(
                  np, CELL_SEED, CL100K_TRAFFIC))]
    cases.append(("long_chunks", smoke_tok, *build_stream(
        *smoke_tok._split_arrays(corpus[:5000] + LONG_CHUNKS), "cuda")))
    out = []
    for name, tok, ids, seg in cases:
        table = device_table(tok)
        cpu = CuckooPairTable(*tok._merge_arrays(), "cpu")
        n = ids.numel()
        firsts = torch.ones(n, dtype=torch.bool, device=ids.device)
        firsts[1:] = seg[1:n] != seg[:n - 1]
        starts = torch.nonzero(firsts).flatten()
        runs = torch.diff(starts, append=torch.tensor([n], device=ids.device))
        want = kernels.segment_encode_plain(ids.cpu(), seg.cpu(), cpu)
        got = kernels.segment_encode(ids, seg, table.cuckoo)
        k = int(want[2])
        err = max_err(torch, [(got[2].cpu(), want[2]),
                              (got[0][:k].cpu(), want[0][:k]),
                              (got[1][:k].cpu(), want[1][:k])])
        err_k10 = k10_ms = None
        if table.kind == "dense":
            sweep = kernels.encode_sweep(ids, seg, table.pairs,
                                         table.new_ids)
            err_k10 = max_err(torch, [(got[2], sweep[2]),
                                      (got[0][:k], sweep[0][:k]),
                                      (got[1][:k], sweep[1][:k])])
            k10_ms = device_ms(torch, lambda: kernels.encode_sweep(
                ids, seg, table.pairs, table.new_ids), 20)
        nbytes = 8 * n + 8 * k + 4
        out.append(dict(
            case=name, n=n, segments=int(starts.numel()),
            longest=int(runs.max()), ranks=int(table.pairs.shape[0]),
            cuckoo_rows=table.cuckoo.H, n_out=k,
            max_abs_err=max(err, err_k10 or 0), max_abs_err_k10=err_k10,
            ms=device_ms(torch, lambda: kernels.segment_encode(
                ids, seg, table.cuckoo), 20),
            k10_ms=k10_ms,
            plain_ms=host_ms(torch, lambda: kernels.segment_encode_plain(
                ids.cpu(), seg.cpu(), cpu), 1),
            bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3))
        r = out[-1]
        k10 = ("" if k10_ms is None
               else f" (K10 {err_k10}, {k10_ms:.4f} ms)")
        print(f"segment_encode {name}: {n} tokens in {r['segments']} "
              f"segments (longest {r['longest']}), {r['ranks']} ranks, "
              f"{r['cuckoo_rows']} cuckoo rows -> {k}, max_abs_err {err}, "
              f"{r['ms']:.4f} ms{k10}, bound {r['bound_ms']:.6f} ms, "
              f"plain {r['plain_ms']:.2f} ms")
    main = next(r for r in out if r["case"] == "cell_mean")
    return dict(k=kernels.SEGMENT_ENCODE, err=main["max_abs_err"],
                ms=main["ms"], plain_ms=main["plain_ms"], bytes=main["bytes"],
                library_ms=None, shapes=[r for r in out if r is not main])


def sorted_tables(golden_mod):
    """The sorted route's tables: GPT-4's width (synthetic_ranks(100_256,
    seed=7), through GPT4Tokenizer.from_mergeable_ranks on the card) and
    smoke_plus_4353 (the 2048 golden's merges and seeded filler). Returns
    (the GPT-4 tokenizer, the 4,353 table's (pairs, new_ids), seconds the
    GPT-4 build took on the host)."""
    from minbpe_tpu_torch import GPT4Tokenizer
    from minbpe_tpu_torch.engine import device_table
    from minbpe_tpu_torch.utils.synthranks import synthetic_ranks

    t0 = time.perf_counter()
    ranks, _, specials = synthetic_ranks(golden_mod.GPT4_RANKS,
                                         seed=golden_mod.GPT4_SEED)
    gpt4 = GPT4Tokenizer.from_mergeable_ranks(ranks, specials, device="cuda")
    table = device_table(gpt4).cuckoo
    build_s = time.perf_counter() - t0
    print(f"gpt4_100k: {len(gpt4.merges)} merges, cuckoo H {table.H} "
          f"({table.rows.numel() * 4} bytes), built in {build_s:.2f} s")
    return gpt4, golden_mod.smoke_plus_merges(golden_mod.SORTED_VOCAB), \
        build_s


def cut_ends(np, n: int, lo: int, hi: int, seed: int = 0):
    """Chunk ends that cut n bytes into chunks of lo..hi bytes, each length
    drawn from numpy.random.default_rng(seed) (shortened where the rest
    would fall below lo)."""
    rng = np.random.default_rng(seed)
    ends, pos = [], 0
    while n - pos > hi:
        pos += min(int(rng.integers(lo, hi + 1)), n - pos - lo)
        ends.append(pos)
    ends.append(n)
    return np.asarray(ends, np.int64)


def flat_shapes(np, golden_mod, gpt4, plus):
    """Phase 2's sorted-route shapes, [(name, data uint8, chunk ends, the
    tokenizer whose cuckoo table encodes it, long_only)]: the smoke corpus's
    GPT-4 split (every chunk short: K11) with the GPT-4 table (bytes
    shuffled) and with smoke_plus_4353 (``plus``: pairs, new_ids), the
    first 65,536 bytes of each as one chunk, the whole corpus as one chunk
    with the vocab-8192 golden's 7,936 merges (a BasicTokenizer's encode),
    and the corpus cut into chunks of 257-4,096 bytes (cut_ends) with
    smoke_plus_4353 (long chunks only: K12)."""
    from minbpe_tpu_torch import BasicTokenizer, RegexTokenizer

    corpus = golden_mod.smoke_corpus(ROOT)
    raw = np.frombuffer(corpus.encode("utf-8"), np.uint8)

    def tok(cls, pairs, new_ids):
        t = cls(device="cuda")
        t.merges = {(int(a), int(b)): int(z)
                    for (a, b), z in zip(pairs, new_ids)}
        return t

    plus_tok = tok(RegexTokenizer, *plus)
    m8192 = golden_mod.load_golden_8192()["merges"]
    t8192 = tok(BasicTokenizer, m8192, 256 + np.arange(len(m8192)))
    out = []
    for tname, t in (("gpt4_100k", gpt4), ("smoke_plus_4353", plus_tok)):
        data, ends = t._split_arrays(corpus)
        head = np.asarray(data[:golden_mod.HEAD_BYTES])
        out += [(f"smoke_{tname}", data, ends, t, False),
                (f"head64k_{tname}", head, np.array([len(head)]), t, True)]
    out += [("whole_smoke_8192", raw, np.array([len(raw)]), t8192, True),
            ("cut_smoke_plus_4353", raw, cut_ends(np, len(raw), 257, 4096),
             plus_tok, True)]
    return out


def flat_case(torch, np, kernels, name, data, ends, table, long_only):
    """K11 over the chunks of (data, ends) of at most CHUNK_WARP_MAX tokens,
    or (long_only: every chunk longer) K12 over all of them, against the
    plain version on the card's tensors; K12 also with each chunk's rounds
    against its own sweep's (kernels.sweep_rounds), with its launch plan.
    The bound: the bytes the function must move: each input token (4 B) and
    each chunk's bounds and index read once, each output token and length
    written once (4 B), and two 16-byte table rows for each distinct pair
    of the input (the rows its first round must probe; later rounds' pairs
    are not counted)."""
    from minbpe_tpu_torch.ops.flat_encode import k11_order

    dev = table.rows.device
    N, C = len(data), len(ends)
    L = np.diff(ends, prepend=0)
    ids = torch.from_numpy(data.astype(np.int32)).to(dev)
    seg = torch.from_numpy(np.repeat(np.arange(C, dtype=np.int32), L)).to(
        dev)
    same = seg[:-1] == seg[1:]
    pair_keys = (ids[:-1].long() << 32 | ids[1:].long())[same]
    distinct = int(torch.unique(pair_keys).numel())
    pick = L > kernels.CHUNK_WARP_MAX if long_only else (
        L <= kernels.CHUNK_WARP_MAX)
    if long_only and not pick.all():
        raise AssertionError(f"{name}: a chunk is short")
    at = np.flatnonzero(pick)
    if long_only:
        info, kw = kernels.ENCODE_MIN_SWEEP, {"lengths": L[at].tolist()}
        kernel = kernels.encode_min_sweep
    else:  # the short chunks first, as ops/flat_encode routes them
        at, lanes = k11_order(L, pick)
        info, kw = kernels.CHUNK_ENCODE, {"lanes": lanes}
        kernel = kernels.chunk_encode
    which = torch.from_numpy(at.astype(np.int32)).to(dev)
    bounds = torch.from_numpy(np.r_[0, ends].astype(np.int32)).to(dev)
    out = torch.full((N + 1,), -1, dtype=torch.int32, device=dev)
    lens = torch.zeros(C + 1, dtype=torch.int32, device=dev)

    def run():
        kernel(ids, bounds, which, table, out, lens, **kw)

    def plain():
        o = torch.full((N + 1,), -1, dtype=torch.int32, device=dev)
        n = torch.zeros(C + 1, dtype=torch.int32, device=dev)
        kernels.chunk_encode_plain(ids, bounds, which, table, o, n)
        return o, n

    run()
    got = (out.clone(), lens.clone())
    want = plain()
    err = max_err(torch, list(zip(got, want)))
    k = int(want[1].sum())
    S = int(pick.sum())
    nbytes = 4 * N + 12 * S + 4 * k + 4 * S + 32 * distinct
    # the output tokens in chunk order: each chunk's first lens[c] slots
    # from its input offset
    pos = torch.arange(N, device=dev)
    kept = pos - bounds[:-1].long()[seg.long()] < got[1][seg.long()]
    toks = got[0][:N][kept].cpu().numpy().astype("<i4")
    rec = dict(case=name, n=N, chunks=C, n_out=k, distinct_pairs=distinct,
               sha256=hashlib.sha256(toks.tobytes()).hexdigest(),
               max_abs_err=err, ms=device_ms(torch, run, 20),
               plain_ms=host_ms(torch, plain, 1), bytes=nbytes,
               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
    if long_only:
        rounds = torch.full((C,), -1, dtype=torch.int32, device=dev)
        kernel(ids, bounds, which, table, out, lens, rounds=rounds, **kw)
        own, union = kernels.sweep_rounds(ids, seg, table)
        if rounds.tolist() != own.tolist():
            raise AssertionError(f"{name}: K12's rounds are not each "
                                 "chunk's own")
        _, cluster, _, _, modes = kernels.k12_plan(L.tolist())
        rec.update(rounds_max=int(own.max()), rounds_sum=int(own.sum()),
                   rounds_union=union, cluster=cluster,
                   tiers={t: modes.count(i) for i, t in enumerate(
                       ("block", "cluster", "device")) if i in modes})
    print(f"{info.name} {name}: {N} tokens, {C} chunks -> {k}, max_abs_err "
          f"{err}, {rec['ms']:.4f} ms, bound {rec['bound_ms']:.5f} ms, plain "
          f"{rec['plain_ms']:.1f} ms"
          + (f", rounds {rec['rounds_max']} (sum {rec['rounds_sum']}, "
             f"union {rec['rounds_union']}), cluster {rec['cluster']}, "
             f"{rec['tiers']}" if long_only else ""))
    return info, rec


def phase_flat(torch, np, kernels, golden_mod, gpt4, plus):
    """K11 and K12 against their plain version on the card at flat_shapes:
    the smoke corpus's GPT-4 split (K11) with the GPT-4 table and with
    smoke_plus_4353, its first 65,536 bytes as one chunk with both, the
    whole corpus as one chunk with the vocab-8192 golden's merges and the
    corpus cut into chunks of 257-4,096 bytes with smoke_plus_4353 (K12)."""
    from minbpe_tpu_torch.engine import device_table

    recs = {"chunk_encode": [], "encode_min_sweep": []}
    for name, data, ends, tok, long_only in flat_shapes(np, golden_mod, gpt4,
                                                        plus):
        info, rec = flat_case(torch, np, kernels, name, data, ends,
                              device_table(tok).cuckoo, long_only)
        recs[info.name].append(rec)
    rows = []
    # the cases of phase 3's paths: GPT-4's encode (K11) and the
    # BasicTokenizer on the 4,353 table (K12)
    mains = {"chunk_encode": "smoke_gpt4_100k",
             "encode_min_sweep": "head64k_smoke_plus_4353"}
    for info in (kernels.CHUNK_ENCODE, kernels.ENCODE_MIN_SWEEP):
        main = next(r for r in recs[info.name]
                    if r["case"] == mains[info.name])
        rows.append(dict(k=info, err=main["max_abs_err"], ms=main["ms"],
                         plain_ms=main["plain_ms"], bytes=main["bytes"],
                         library_ms=None, shapes=recs[info.name]))
    return rows


def presplit_case(torch, pdp, name, text, mode, profiled=False):
    """K15 against its plain twin on the card for one text: the whole split
    (presplit_seg_ids against presplit_plain, boundaries and segment ids
    exact), then each kernel against its own step's plain version on the
    same inputs. Bounds: the bytes of each function, each input read once
    and each output written once. The whole split reads the n bytes and
    the 64 KB class table and writes n boundaries and 4 n of segment ids;
    presplit_succ reads the bytes and the table and writes 4 n of
    successors; presplit_orbit reads the successors and writes the
    boundaries and segment ids. No PyTorch call computes the function, so
    there is no library time. With ``profiled``, the whole split's time
    is also read from the profiler's device activity (None where the
    profiler records none)."""
    raw = text.encode("utf-8")
    n = len(raw)
    data = torch.frombuffer(bytearray(raw), dtype=torch.uint8).to("cuda")
    table = 0x10000 + 5 * pdp._device_tables(data.device)[1].numel()
    got = pdp.presplit_seg_ids(data, n, mode)
    want = pdp.presplit_plain(data, n, mode)
    f = pdp.presplit_succ(data, n, mode)
    f_plain = pdp.successor_plain(data, n, mode)
    orb = pdp.presplit_orbit(f_plain, n)
    orb_plain = pdp.orbit_plain(f_plain, n)
    err = max_err(torch, [(got[0].int(), want[0].int()), (got[1], want[1])])
    err_succ = max_err(torch, [(f, f_plain)])
    err_orbit = max_err(torch, [(orb[0].int(), orb_plain[0].int()),
                               (orb[1], orb_plain[1])])
    big = n > (1 << 22)
    reps = 5 if big else 20
    rec = dict(
        case=f"{name}_{mode}", n=n, chunks=int(got[1][-1]) + 1,
        max_abs_err=max(err, err_succ, err_orbit), max_abs_err_split=err,
        ms=device_ms(torch, lambda: pdp.presplit_seg_ids(data, n, mode),
                     reps),
        plain_ms=host_ms(torch, lambda: pdp.presplit_plain(data, n, mode),
                         1),
        bytes=n + table + 5 * n,
        succ_ms=device_ms(torch, lambda: pdp.presplit_succ(data, n, mode),
                          reps),
        succ_plain_ms=host_ms(
            torch, lambda: pdp.successor_plain(data, n, mode), 1),
        succ_bytes=n + table + 4 * n, succ_max_abs_err=err_succ,
        orbit_ms=device_ms(torch, lambda: pdp.presplit_orbit(f, n), reps),
        orbit_plain_ms=host_ms(torch, lambda: pdp.orbit_plain(f, n), 1),
        orbit_bytes=4 * n + 5 * n, orbit_max_abs_err=err_orbit)
    for key in ("", "succ_", "orbit_"):
        rec[f"{key}bound_ms"] = rec[f"{key}bytes"] / HBM_BYTES_PER_S * 1e3
    rec["profiled_ms"] = None
    if profiled:
        try:
            rec["profiled_ms"] = profiled_ms(
                torch, lambda: pdp.presplit_seg_ids(data, n, mode), reps)
        except RuntimeError:  # the profiler recorded no device time
            pass
    print(f"presplit {rec['case']}: {n} bytes -> {rec['chunks']} chunks, "
          f"max_abs_err {err} / {err_succ} / {err_orbit}, {rec['ms']:.4f} "
          f"ms (profiler {rec['profiled_ms']}; succ "
          f"{rec['succ_ms']:.4f}, orbit {rec['orbit_ms']:.4f}; "
          f"bound {rec['bound_ms']:.6f}), plain {rec['plain_ms']:.2f} ms")
    return rec


def phase_presplit(torch, np, golden_mod):
    """K15 against its plain twin at the device split's shapes: the smoke
    corpus and the XL corpus in both modes, the XL corpus four times over
    (50,353,352 bytes, GPT-4) and 2^20 spaces, letters and digits (GPT-4);
    then its cluster tier at cluster_shapes in both modes, each against
    the plain twin and the cooperative pair, and with a byte table (the
    ids against the gather through it; on the cell's documents the launch
    with the table timed beside the launch without it). Returns the rows of
    presplit_cluster (its time on the cell's mean-length document, GPT-4:
    one request of that cell), presplit_succ and presplit_orbit; the
    pair's main shape is the smoke corpus with GPT-4's split (the
    encode_device_split path)."""
    from minbpe_tpu_torch import kernels
    from minbpe_tpu_torch.ops import device_presplit as pdp

    corpus = golden_mod.smoke_corpus(ROOT)
    xl = golden_mod.xl_corpus(ROOT)
    k = 1 << 20
    cases = [("smoke", corpus, "gpt4"), ("smoke", corpus, "gpt2"),
             ("xl", xl, "gpt4"), ("xl", xl, "gpt2"), ("xl4", xl * 4, "gpt4"),
             ("spaces_2e20", " " * k + "x", "gpt4"),
             ("letters_2e20", " " + "a" * k + "!", "gpt4"),
             ("digits_2e20", "1" * k + " 22", "gpt4")]
    recs = [presplit_case(torch, pdp, *c, profiled=not i)
            for i, c in enumerate(cases)]
    torch.cuda.empty_cache()
    byte_ids = torch.from_numpy(np.random.default_rng(0).permutation(
        256).astype(np.int32)).cuda()
    short = [cluster_case(torch, pdp, name, raw, mode, byte_ids)
             for name, raw in cluster_shapes(np, golden_mod)
             for mode in ("gpt4", "gpt2")]
    mean = next(r for r in short if r["case"] == "cell_mean_gpt4")
    main = recs[0]
    rows = [dict(k=kernels.PRESPLIT_CLUSTER,
                 err=max(r["max_abs_err"] for r in short), ms=mean["ms"],
                 plain_ms=mean["plain_ms"], bytes=mean["bytes"],
                 library_ms=None, pair_ms=mean["pair_ms"],
                 ids_cost_us={r["case"]: r["ids_cost_us"] for r in short
                              if "ids_cost_us" in r},
                 shapes=short)]
    for info, key in ((kernels.PRESPLIT_SUCC, "succ_"),
                      (kernels.PRESPLIT_ORBIT, "orbit_")):
        rows.append(dict(
            k=info, err=max(r["max_abs_err"] for r in recs),
            ms=main[f"{key}ms"], plain_ms=main[f"{key}plain_ms"],
            bytes=main[f"{key}bytes"], library_ms=None,
            k15_ms=main["ms"], k15_profiled_ms=main["profiled_ms"],
            k15_plain_ms=main["plain_ms"],
            k15_bound_ms=main["bound_ms"], shapes=recs))
    return rows


def cluster_shapes(np, golden_mod):
    """[(name, text bytes)] of K15's cluster tier: the regex512-encode-docs
    cell's median, mean-length and longest documents, and the smoke
    corpus's first 1, 2, 4 and 8 tiles (cut back to a char boundary)."""
    docs = cell_shapes(np, *cell_documents(np, CELL_SEED))
    raw = golden_mod.smoke_corpus(ROOT).encode("utf-8")
    out = [(f"cell_{name}", bytes(doc)) for name, doc in docs]
    for tiles in (1, 2, 4, 8):
        cut = raw[:4096 * tiles].decode("utf-8", errors="ignore")
        out.append((f"smoke_{tiles}_tiles", cut.encode("utf-8")))
    return out


def cluster_case(torch, pdp, name, raw: bytes, mode, byte_ids):
    """K15's cluster tier on one text of at most 32 KB: presplit_cluster
    against presplit_plain and against the cooperative pair on the same
    bytes, boundaries and segment ids exact, each one's device time, and
    the bound of the whole split (n bytes and the 64 KB class table read,
    n boundaries and 4 n of segment ids written). With the byte table
    ``byte_ids`` it also writes the ids, equal to the gather through the
    table, its boundaries and segment ids unchanged; on a cell's document
    the two launches are timed in turns (``bare_ms``, ``ids_ms``), and
    ``ids_cost_us`` is what the ids add."""
    n = len(raw)
    data = torch.frombuffer(bytearray(raw), dtype=torch.uint8).to("cuda")
    table = 0x10000 + 5 * pdp._device_tables(data.device)[1].numel()
    got = pdp.presplit_cluster(data, n, mode)
    want = pdp.presplit_plain(data, n, mode)
    with_ids = pdp.presplit_cluster(data, n, mode, byte_ids)

    def pair():
        return pdp.presplit_orbit(pdp.presplit_succ(data, n, mode), n)

    err = max_err(torch, [(got[0].int(), want[0].int()), (got[1], want[1])]
                  + [(a.int(), b.int()) for a, b in zip(pair(), want)]
                  + [(with_ids[0].int(), got[0].int()),
                     (with_ids[1], got[1]),
                     (with_ids[2], byte_ids[data.long()])])
    rec = dict(
        case=f"{name}_{mode}", n=n, tiles=-(-n // 4096),
        chunks=int(got[1][-1]) + 1, max_abs_err=err,
        ms=device_ms(torch, lambda: pdp.presplit_cluster(data, n, mode), 50),
        pair_ms=device_ms(torch, pair, 50),
        plain_ms=host_ms(torch, lambda: pdp.presplit_plain(data, n, mode), 1),
        bytes=n + table + 5 * n)
    rec["bound_ms"] = rec["bytes"] / HBM_BYTES_PER_S * 1e3
    ids = ""
    if name.startswith("cell_"):
        rec["bare_ms"], rec["ids_ms"] = split_ms(torch, [
            lambda: pdp.presplit_cluster(data, n, mode),
            lambda: pdp.presplit_cluster(data, n, mode, byte_ids)], 100)
        rec["ids_cost_us"] = (rec["ids_ms"] - rec["bare_ms"]) * 1e3
        ids = (f"; with the ids {rec['ids_ms']:.4f} ms against "
               f"{rec['bare_ms']:.4f} in turns, {rec['ids_cost_us']:+.3f} us")
    print(f"presplit_cluster {rec['case']}: {n} bytes -> {rec['chunks']} "
          f"chunks, max_abs_err {err}, {rec['ms']:.4f} ms (the pair "
          f"{rec['pair_ms']:.4f}; bound {rec['bound_ms']:.6f}){ids}, plain "
          f"{rec['plain_ms']:.2f} ms")
    return rec


def split_ms(torch, fns, reps: int):
    """Device time per call of each of fns, called in turn reps times behind
    a sleeping kernel, with an event between every two launches; taken
    again behind a longer sleep where the host outran the first, then from
    the profiler, one fn at a time (as device_ms)."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    for cycles in SLEEP_CYCLES:
        ev = [[torch.cuda.Event(enable_timing=True)
               for _ in range(len(fns) + 1)] for _ in range(reps)]
        torch.cuda._sleep(reps * len(fns) * cycles)
        for r in range(reps):
            ev[r][0].record()
            for j, fn in enumerate(fns):
                fn()
                ev[r][j + 1].record()
        covered = not ev[0][0].query()
        torch.cuda.synchronize()
        if covered:
            return [sum(ev[r][j].elapsed_time(ev[r][j + 1])
                        for r in range(reps)) / reps
                    for j in range(len(fns))]
        RETAKEN_READINGS.extend((getattr(fn, "__qualname__", "?"), cycles,
                                 None) for fn in fns)
    return [profiled_call_ms(torch, fn, reps) for fn in fns]


def table_case(torch, kernels, name, ids, seg):
    """K13 pair_select, one round over a whole stream, against its plain
    version on the card (pair_table_plain, a torch.unique of the keys, then
    table_select_plain) and against ops/select.select_max_pair (the
    stable-sort selection): the round's record (sel, log row, count, fail)
    exactly, and the table empty after the first launch and after the
    timed ones. Bound: the function's bytes, 8 N + 40: ids and seg read
    once (8 B a token), n and fail read (8 B) and the record written (sel
    16 B, log row 8, count 4, fail 4). The hash table is scratch, empty
    before and after the launch, so its traffic is the design's and not
    in the bound. Library: torch.unique over the countable pairs' 64-bit
    keys with their counts (no first positions, no selection)."""
    from minbpe_tpu_torch.ops.select import select_max_pair

    dev = ids.device
    N = ids.numel()
    n = torch.full((1,), N, dtype=torch.int32, device=dev)

    def record():
        return (torch.zeros(4, dtype=torch.int32, device=dev),
                torch.zeros((1, 2), dtype=torch.int32, device=dev),
                torch.zeros(1, dtype=torch.int32, device=dev),
                torch.ones(1, dtype=torch.int32, device=dev))

    table = kernels.PairTable(N, dev)
    got = record()

    def k13():
        kernels.pair_select(ids, seg, n, table, *got, 0)

    def empty(t):
        return (int(t.used) == 0 and bool((t.key == -1).all())
                and not bool(t.cnt.any())
                and bool((t.first == kernels.EMPTY_FIRST).all()))

    k13()
    if not empty(table):
        raise AssertionError(f"pair_select left the table of {name} full")
    plain = kernels.PairTable(N, dev)
    want = record()
    kernels.pair_select_plain(ids, seg, n, plain, *want, 0)
    a, b = ids[:-1].long(), ids[1:].long()
    countable = seg[:-1] == seg[1:]
    keys = ((a << 32) | b)[countable]
    del a, b
    D = torch.unique(keys).numel()
    # distinct pairs of each 2048-position chunk, summed: the device-table
    # inserts when each block counts one chunk (fewer where it has more)
    chunk = torch.nonzero(countable).view(-1) // kernels.TILE
    chunk_distinct = torch.unique(torch.stack([chunk, keys]), dim=1).shape[1]
    del chunk, countable
    pa, pb, c, ok = select_max_pair(ids, seg, n)
    ref = torch.tensor([int(pa), int(pb), int(c), 1] if bool(ok)
                       else [-1, -1, 0, 0], dtype=torch.int32)
    err = max_err(torch, list(zip(got, want)) + [(got[0].cpu(), ref)])

    def plain_round():
        kernels.pair_select_plain(ids, seg, n, plain, *want, 0)

    big = N > (1 << 22)
    reps = 10 if big else 50
    k13_ms = split_ms(torch, [k13], reps)[0]
    if not empty(table):
        raise AssertionError(f"pair_select left the table of {name} full "
                             f"after {reps + 2} rounds")
    err = max(err, max_err(torch, list(zip(got, want))))
    lib = profiled_ms(torch, lambda: torch.unique(
        keys, sorted=True, return_counts=True), 5 if big else 20)
    del keys
    plain_ms = host_ms(torch, plain_round, 1 if big else 5)
    del plain
    rec = dict(case=name, n=N, distinct=D, chunk_distinct=chunk_distinct,
               max_abs_err=err, grid=table.grid,
               ms=k13_ms, plain_ms=plain_ms,
               sort_ms=host_ms(torch, lambda: select_max_pair(ids, seg, n),
                               1 if big else 5),
               bytes=8 * N + 40, library_ms=lib,
               selected=got[0].tolist())
    rec["bound_ms"] = rec["bytes"] / HBM_BYTES_PER_S * 1e3
    print(f"pair_select {name}: n {N}, D {D}, grid {rec['grid']}, "
          f"max_abs_err {err}, {k13_ms:.5f} ms (bound "
          f"{rec['bound_ms']:.5f}), unique {lib:.5f} ms, sort selection "
          f"{rec['sort_ms']:.3f} ms, pair {rec['selected']}")
    return rec


def table_cases(torch, np, kernels, golden_mod, texts):
    """[(name, ids, seg)] on the card, the shapes the sort-round route gives
    its count and selection: the 400K seeded Zipf stream, the smoke
    corpus's stream after the vocab-8192 golden's first 4,000 merges (ids
    above 4,096; applied by K10), 2^20 copies of "a" (one hot pair), 2^20
    distinct ids (every pair distinct: the table's load), the XL corpus's
    stream and that stream four times over (50,353,352 tokens, each copy's
    chunks its own)."""
    dev = torch.device("cuda")
    zids, zseg = smoke_stream(np, 400_000, 1024)
    named = {name: (i, s) for name, i, s, _ in texts}
    s_ids, s_seg = named["smoke_w256"]
    x_ids, x_seg = named["xl_w256"]
    g8k = golden_mod.load_golden_8192()
    M = 4000
    pt = torch.from_numpy(np.ascontiguousarray(g8k["merges"][:M])).to(dev)
    zt = torch.arange(256, 256 + M, dtype=torch.int32, device=dev)
    m_ids, m_seg, m_n = kernels.encode_sweep(s_ids, s_seg, pt, zt)
    k = int(m_n)
    if int(m_ids[:k].max()) < 4096:
        raise AssertionError("the smoke stream after 4,000 merges holds no "
                             "id above 4,096")
    run = torch.full((1 << 20,), 97, dtype=torch.int32, device=dev)
    dist = torch.arange(1 << 20, dtype=torch.int32, device=dev)
    return [
        ("zipf_400k", torch.from_numpy(zids).to(dev),
         torch.from_numpy(zseg).to(dev)),
        ("smoke_8192_m4000", m_ids[:k].contiguous(), m_seg[:k].contiguous()),
        ("run_a", run, torch.zeros_like(run)),
        ("all_distinct", dist, torch.zeros_like(dist)),
        ("xl", x_ids, x_seg),
        ("xl4", *xl_stream(torch, x_ids, x_seg, 4 * x_ids.numel())),
    ]


# K16's rows a rank (the trainer's default cap, min(Nl + 1, 2^17))
SUMMARY_CAP = 1 << 17


def _sorted_rows(torch, rows):
    r = rows.long()
    return r[torch.argsort((r[:, 0] << 32) | r[:, 1])]


def summary_case(torch, kernels, name, ids, seg):
    """K16 pair_summaries' count over a whole stream at K = 2^17 against
    pair_summaries_plain on the card: the rows written and the overflow
    flag, and where it does not overflow the rows (in key order), with the
    table empty after the first launch and after the timed ones. Bound: the
    function's bytes, 8 N + 16 rows + 40 (ids and seg read, the rows
    written, n, base, used and overflow); the table is scratch, as K13's.
    Library: torch.unique over the countable pairs' keys with counts (no
    first positions). Returns (record, the rows)."""
    dev = ids.device
    N = ids.numel()
    n = torch.full((1,), N, dtype=torch.int32, device=dev)
    table = kernels.PairTable(N, dev, kernel="pair_summaries")

    def state():
        return (torch.zeros((SUMMARY_CAP, 4), dtype=torch.int32, device=dev),
                torch.zeros(1, dtype=torch.int32, device=dev),
                torch.zeros(1, dtype=torch.int32, device=dev))

    got, want = state(), state()

    def k16():
        kernels.pair_summaries(ids, seg, n, table, 0, *got)

    def empty():
        return (int(table.used) == 0 and bool((table.key == -1).all())
                and not bool(table.cnt.any()))

    k16()
    if not empty():
        raise AssertionError(f"pair_summaries left the table of {name} full")
    kernels.pair_summaries_plain(ids, seg, n, None, 0, *want)
    u, over = int(got[1]), int(got[2])
    err = max_err(torch, [(got[1], want[1]), (got[2], want[2])])
    if not over:
        err = max(err, max_err(torch, [(_sorted_rows(torch, got[0][:u]),
                                        _sorted_rows(torch, want[0][:u]))]))
    a, b = ids[:-1].long(), ids[1:].long()
    keys = ((a << 32) | b)[seg[:-1] == seg[1:]]
    del a, b
    D = torch.unique(keys).numel()
    if over != int(D > SUMMARY_CAP):
        raise AssertionError(f"pair_summaries on {name}: overflow {over} "
                             f"with {D} distinct pairs")
    big = N > (1 << 22)
    ms = split_ms(torch, [k16], 10 if big else 50)[0]
    if not empty():
        raise AssertionError(f"pair_summaries left the table of {name} full "
                             "after the timed launches")
    lib = profiled_ms(torch, lambda: torch.unique(
        keys, sorted=True, return_counts=True), 5 if big else 20)
    del keys
    plain_ms = host_ms(torch, lambda: kernels.pair_summaries_plain(
        ids, seg, n, None, 0, *want), 1 if big else 5)
    rec = dict(case=name, mode="count", n=N, distinct=D, rows=u,
               overflow=over, max_abs_err=err, grid=table.grid, ms=ms,
               plain_ms=plain_ms, bytes=8 * N + 16 * u + 40,
               library_ms=lib)
    rec["bound_ms"] = rec["bytes"] / HBM_BYTES_PER_S * 1e3
    print(f"pair_summaries {name}: n {N}, D {D}, rows {u}, overflow "
          f"{over}, max_abs_err {err}, {ms:.5f} ms (bound "
          f"{rec['bound_ms']:.5f}), unique {lib:.5f} ms")
    return rec, got[0][:u].clone()


def summary_merge_case(torch, kernels, rows, D: int = 4):
    """K16's merge of D blocks of summary rows (one stream's rows, each
    block's first positions shifted as D ranks' would be, so every pair's
    count is D times and its first the first block's) against
    pair_summaries_merge_plain. Bound: 16 B a row read, the champion
    written."""
    dev = rows.device
    u = rows.shape[0]
    blocks = torch.zeros((D, u + 1, 4), dtype=torch.int32, device=dev)
    for d in range(D):
        blocks[d, :u] = rows
        blocks[d, :u, 3] += d * (1 << 24)
        blocks[d, u, 0] = u
    flat = blocks.view(-1, 4)
    lens = blocks[:, u, 0].contiguous()
    table = kernels.PairTable(D * (u + 1), dev, kernel="pair_summaries")
    got = torch.zeros(4, dtype=torch.int32, device=dev)
    want = torch.zeros(4, dtype=torch.int32, device=dev)

    def k16():
        kernels.pair_summaries_merge(flat, lens, table, got)

    k16()
    kernels.pair_summaries_merge_plain(flat, lens, None, want)
    err = max_err(torch, [(got, want)])
    ms = split_ms(torch, [k16], 50)[0]
    rec = dict(case=f"merge_{D}x{u}", mode="merge", n=D * u, max_abs_err=err,
               grid=table.grid, ms=ms,
               plain_ms=host_ms(torch, lambda: kernels.
                                pair_summaries_merge_plain(flat, lens, None,
                                                           want), 5),
               bytes=16 * D * u + 16, library_ms=None,
               champion=got.tolist())
    rec["bound_ms"] = rec["bytes"] / HBM_BYTES_PER_S * 1e3
    print(f"pair_summaries merge of {D} x {u} rows: max_abs_err {err}, "
          f"{ms:.5f} ms (bound {rec['bound_ms']:.5f}), champion "
          f"{rec['champion']}")
    return rec


def phase_table(torch, np, kernels, golden_mod, texts):
    """K13, and K16's count, against their plain versions at table_cases'
    shapes, and K16's merge of four ranks' rows of the Zipf stream.
    Returns their rows; the main shape is the Zipf stream."""
    cases = table_cases(torch, np, kernels, golden_mod, texts)
    recs, sums = [], []
    for name, c_ids, c_seg in cases:
        recs.append(table_case(torch, kernels, name, c_ids, c_seg))
        rec, rows = summary_case(torch, kernels, name, c_ids, c_seg)
        sums.append(rec)
        if name == "zipf_400k":
            sums.append(summary_merge_case(torch, kernels, rows))
        del rows
        torch.cuda.empty_cache()
    out = []
    for k, shapes in ((kernels.PAIR_SELECT, recs),
                      (kernels.PAIR_SUMMARIES, sums)):
        main = shapes[0]
        out.append(dict(k=k, err=max(r["max_abs_err"] for r in shapes),
                        ms=main["ms"], plain_ms=main["plain_ms"],
                        bytes=main["bytes"], library_ms=main["library_ms"],
                        shapes=shapes))
    return out


def check_rows(rows):
    for r in rows:
        print(f"kernel {r['k'].name}: max_abs_err {r['err']}, "
              f"{r['ms']:.4f} ms (plain {r['plain_ms']:.3f} ms)")
        err = max([r["err"], r.get("xl", {}).get("max_abs_err", 0)]
                  + [c["max_abs_err"] for c in r.get("shapes", ())])
        if err != 0:
            raise AssertionError(f"{r['k'].name} disagrees with its plain "
                                 f"version (max_abs_err {err})")


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def merges_in_rank_order(np, merges):
    items = sorted(merges.items(), key=lambda kv: kv[1])
    return np.array([list(p) for p, _ in items], dtype=np.int32)


# the device pre-split encode: K15's two kernels and K17, once each; of a
# text of at most 32 KB (ops/device_presplit.CLUSTER_MAX_N), K15's
# presplit_cluster and K17
DEVICE_SPLIT = {"presplit_succ": 1, "presplit_orbit": 1, "segment_encode": 1}
DEVICE_SPLIT_SHORT = {"presplit_cluster": 1, "segment_encode": 1}


@contextlib.contextmanager
def scanner_calls():
    """The calls of the host pre-split scanner (utils/native.split_offsets)
    while the block runs, as a list with one entry a call."""
    from minbpe_tpu_torch.utils import native

    calls = []
    real = native.split_offsets

    def counted(*args):
        calls.append(1)
        return real(*args)

    native.split_offsets = counted
    try:
        yield calls
    finally:
        native.split_offsets = real


TRAIN_KERNELS = ("pair_stats", "select_batch", "merge_apply", "batch_hist",
                 "batch_apply", "compact")
ENCODE_KERNELS = ("encode_sweep",)


def counted_paths(kernels, launches: dict):
    """A context manager path(name, must_launch, exact=None, some=None)
    that counts one path's launches alone into launches[name]: each kernel
    it must run has to have launched at least once (none at all where
    must_launch is empty), with ``exact`` ({kernel: count}) every kernel
    exactly so often (0 where it is not named), and with ``some`` the
    kernels it names exactly so often."""

    @contextlib.contextmanager
    def path(name, must_launch, exact=None, some=None):
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
        if some is not None and any(counts[k] != c for k, c in some.items()):
            raise AssertionError(f"path {name} launched {counts}, expected "
                                 f"{some} of them")

    return path


def phase_main_path(torch, np, kernels, golden_mod, scratch, gpt4, plus,
                    cl100k):
    """Returns (timings, launches), launches = {path: {kernel: count}}."""
    from minbpe_tpu_torch import BasicTokenizer, RegexTokenizer, trace
    from minbpe_tpu_torch.ops import train as train_mod

    timings = {}
    launches = {}
    path = counted_paths(kernels, launches)

    def sweeps(count):  # a split text's encode: K17 once per device stream
        return dict(must_launch=("segment_encode",),
                    exact={"segment_encode": count})

    golden = golden_mod.load_golden()
    corpus = golden_mod.smoke_corpus(ROOT)
    nbytes = len(corpus.encode("utf-8"))
    print(f"corpus: {nbytes} bytes")

    # train, through the verbose lines (they carry the per-merge counts)
    tok = RegexTokenizer(device="cuda")
    out = io.StringIO()
    torch.cuda.synchronize()
    trace.reset()
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
    with path("encode", **sweeps(1)):
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

    # the same encode with the device pre-split: only the raw bytes cross
    tok.device_presplit = True
    with scanner_calls() as calls, path("encode_device_split",
                                        tuple(DEVICE_SPLIT),
                                        exact=DEVICE_SPLIT):
        t0 = time.perf_counter()
        split_ids = tok.encode(corpus)
        timings["encode_device_split_s"] = time.perf_counter() - t0
    tok.device_presplit = False
    if calls:
        raise AssertionError(f"encode_device_split called the host scanner "
                             f"{len(calls)} times")
    if (golden_mod.ids_digest(split_ids) != golden["encode_sha256"]
            or split_ids != ids):
        raise AssertionError("the device-split encode differs from the "
                             "golden or the host-split encode")
    timings["encode_device_split_MB_per_s"] = (
        nbytes / timings["encode_device_split_s"] / 1e6)
    print(f"encode_device_split: {len(split_ids)} ids equal to the golden "
          f"and the host split ({timings['encode_device_split_s']:.3f} s)")

    # encode_batch of 256 documents against per-document encode
    step = -(-len(corpus) // 256)
    docs = [corpus[i:i + step] for i in range(0, len(corpus), step)]
    with path("encode_batch", **sweeps(1)):
        t0 = time.perf_counter()
        batch = tok.encode_batch(docs)
        timings["encode_batch_s"] = time.perf_counter() - t0
    with path("encode_per_doc", **sweeps(len(docs))):
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
    with path("specials", **sweeps(9)):  # 8 documents, then the joined text
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
    with path("save_load", **sweeps(1)):
        if tok2.encode(text, allowed_special="all") != got:
            raise AssertionError("the loaded tokenizer encodes differently")
    print("save/load: identical bytes after the round trip")

    # BasicTokenizer at vocab 512 on the first 64 KB, against the CPU
    head = corpus[:65536]
    gb, cb = BasicTokenizer(device="cuda"), BasicTokenizer(device="cpu")
    with path("basic_512", TRAIN_KERNELS + ENCODE_KERNELS,
              some={"encode_sweep": 1}):
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
    with path("run_264", TRAIN_KERNELS + ENCODE_KERNELS,
              some={"encode_sweep": 1}):
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
    trace.reset()
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

    encode_paths(np, golden_mod, corpus, path, timings, gpt4, plus)
    cl100k_device_split(np, cl100k, path, timings)
    selection_paths(torch, np, golden_mod, corpus, path, timings, head, gb,
                    scratch)
    large_vocab_paths(torch, np, golden_mod, corpus, path, timings, scratch)
    return timings, launches


def encode_paths(np, golden_mod, corpus, path, timings, gpt4, plus):
    """The two encode routes past the fused Pallas encoder's bounds, each
    held to the encode golden minbpe_tpu wrote (ids' sha256 and count): the
    GPT-4 tokenizer at 100,256 ranks (encode, decode, the 256 documents as
    one batch, specials), smoke_plus_4096 (dense: K17 once), smoke_plus_4353
    (sorted: K11 once; no chunk of the corpus's split passes 256 tokens, so
    no K12) and its BasicTokenizer on the first 64 KB (one chunk: K12
    once), and the XL corpus through the dense route (K17 once)."""
    from minbpe_tpu_torch import BasicTokenizer, RegexTokenizer

    goldens = golden_mod.load_encode_golden()

    def held(case, ids):
        sha, n = goldens[case]
        if len(ids) != n or golden_mod.ids_digest(ids) != sha:
            raise AssertionError(f"{case}: {len(ids)} ids differ from the "
                                 f"encode golden ({n})")

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        timings[f"{name}_s"] = time.perf_counter() - t0
        return out

    def only(kernel, count=1):
        return dict(must_launch=(kernel,), exact={kernel: count})

    docs = golden_mod.smoke_documents(corpus)
    with path("encode_gpt4", **only("chunk_encode")):
        ids = timed("encode_gpt4", lambda: gpt4.encode(corpus))
    held("gpt4_100k", ids)
    with path("decode_gpt4", ()):
        back = timed("decode_gpt4", lambda: gpt4.decode(ids))
    if back != corpus:
        raise AssertionError("GPT-4 decode(encode(corpus)) != corpus")
    with path("encode_batch_gpt4", **only("chunk_encode")):
        batch = timed("encode_batch_gpt4", lambda: gpt4.encode_batch(docs))
    held("gpt4_100k_batch", [t for d in batch for t in d])
    text = golden_mod.special_text(docs, list(gpt4.special_tokens)[:2])
    with path("specials_gpt4", **only("chunk_encode")):
        got = timed("specials_gpt4", lambda: gpt4.encode(
            text, allowed_special="all"))
    held("gpt4_100k_specials", got)
    nbytes = len(corpus.encode("utf-8"))
    timings["encode_gpt4_MB_per_s"] = nbytes / timings["encode_gpt4_s"] / 1e6
    print(f"gpt4_100k: encode {len(ids)} ids ({timings['encode_gpt4_s']:.3f}"
          f" s), decode, encode_batch and specials equal to the goldens")

    def table(cls, vocab):
        pairs, new_ids = (plus if vocab == golden_mod.SORTED_VOCAB
                          else golden_mod.smoke_plus_merges(vocab))
        tok = cls(device="cuda")
        tok.merges = {(int(a), int(b)): int(z)
                      for (a, b), z in zip(pairs, new_ids)}
        tok.vocab = tok._build_vocab()
        return tok

    head = corpus[:golden_mod.HEAD_BYTES]
    for case, tok, text, kernel in (
            ("smoke_plus_4096", table(RegexTokenizer, golden_mod.DENSE_VOCAB),
             corpus, "segment_encode"),
            ("smoke_plus_4353", table(RegexTokenizer,
                                      golden_mod.SORTED_VOCAB),
             corpus, "chunk_encode"),
            ("basic_plus_4353", table(BasicTokenizer,
                                      golden_mod.SORTED_VOCAB),
             head, "encode_min_sweep")):
        with path(case, **only(kernel)):
            ids = timed(case, lambda: tok.encode(text))
        held(case, ids)
        if tok.decode(ids) != text:
            raise AssertionError(f"{case}: decode(encode(text)) != text")
        print(f"{case}: {len(ids)} ids equal to the golden "
              f"({timings[f'{case}_s']:.3f} s, {kernel})")

    xl_text = golden_mod.xl_corpus(ROOT)
    xl_tok = RegexTokenizer(device="cuda")
    xl_tok.merges = {(int(a), int(b)): 256 + r for r, (a, b) in
                     enumerate(golden_mod.load_golden()["merges"])}
    xl_tok.vocab = xl_tok._build_vocab()
    with path("encode_xl_dense", **only("segment_encode")):
        ids = timed("encode_xl_dense", lambda: xl_tok.encode(xl_text))
    held("xl_dense_1024", ids)
    if xl_tok.decode(ids) != xl_text:
        raise AssertionError("XL decode(encode(corpus)) != corpus")
    timings["encode_xl_dense_MB_per_s"] = (
        len(xl_text.encode("utf-8")) / timings["encode_xl_dense_s"] / 1e6)
    print(f"encode_xl_dense: {len(ids)} ids equal to the golden "
          f"({timings['encode_xl_dense_s']:.3f} s)")
    xl_tok.device_presplit = True
    with scanner_calls() as calls, path("encode_device_split_xl",
                                        tuple(DEVICE_SPLIT),
                                        exact=DEVICE_SPLIT):
        split_ids = timed("encode_device_split_xl",
                          lambda: xl_tok.encode(xl_text))
    if calls:
        raise AssertionError("encode_device_split_xl called the host scanner")
    held("xl_dense_1024", split_ids)
    print(f"encode_device_split_xl: {len(split_ids)} ids equal to the golden "
          f"({timings['encode_device_split_xl_s']:.3f} s)")


def cl100k_device_split(np, cl100k, path, timings):
    """The cl100k-encode-docs cell's path: GPT4Tokenizer at its
    100,256-rank stand-in with the device split, the request as the cell
    sends it (``allowed_special="none"``) on the cell's median, mean-length
    and longest documents: K15's presplit_cluster and K17 1 a document
    (each at most 32 KB), no call of the
    host scanner, the counter ``encode.route.device_split`` once a
    document, and ids equal to the host split's (K11/K12)."""
    from minbpe_tpu_torch import trace

    docs = [raw.decode("utf-8") for _, raw in cell_shapes(
        np, *cell_documents(np, CELL_SEED, CL100K_TRAFFIC))]
    want = [cl100k.encode(d, allowed_special="none") for d in docs]
    cl100k.device_presplit = True
    before = trace.COUNTERS.get("encode.route.device_split", 0)
    try:
        with scanner_calls() as calls, path(
                "encode_device_split_cl100k", tuple(DEVICE_SPLIT_SHORT),
                exact={k: c * len(docs)
                       for k, c in DEVICE_SPLIT_SHORT.items()}):
            t0 = time.perf_counter()
            got = [cl100k.encode(d, allowed_special="none") for d in docs]
            timings["encode_device_split_cl100k_s"] = (
                time.perf_counter() - t0)
    finally:
        cl100k.device_presplit = False
    took = trace.COUNTERS.get("encode.route.device_split", 0) - before
    if calls or took != len(docs):
        raise AssertionError(f"encode_device_split_cl100k: {len(calls)} "
                             f"host scanner calls, {took} of {len(docs)} "
                             "texts split on the device")
    if got != want:
        raise AssertionError("encode_device_split_cl100k differs from the "
                             "host split")
    print(f"encode_device_split_cl100k: {sum(map(len, got))} ids of "
          f"{len(docs)} documents equal to the host split's "
          f"({timings['encode_device_split_cl100k_s']:.3f} s)")


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
    with open(os.path.join(trace_dir, traces[0])) as f:
        if '"minbpe.train.enqueue"' not in f.read():
            raise AssertionError("profile_dir: no span of the program's")
    print(f"profile_dir: {traces[0]} "
          f"({os.path.getsize(os.path.join(trace_dir, traces[0]))} bytes)")


ROUND_KERNELS = ("pair_select", "merge_apply", "compact")


def large_vocab_paths(torch, np, golden_mod, corpus, path, timings,
                      scratch):
    """The routes past vocab 2048 and 48·2^20 tokens, each held exactly:
    smoke-8192 (RegexTokenizer, GPT-4 pattern, vocab 8,192 on the smoke
    corpus) by the default route (the sort-round trainer), "sortloop_inc",
    "sparse" and "sparse_inc", each equal to smoke8192_golden.npz; the XL
    corpus at vocab 1024 with a checkpoint every 256 rounds, cut after
    round 512 and resumed (the default route takes the sort-round trainer
    above 4·2^20 tokens with a checkpoint), equal to xl_golden.npz; and the
    XL corpus's bytes and chunk ends tiled four times (50,353,352 tokens,
    above 48·2^20), whose merges are the XL golden's and whose counts are
    four times its counts, as pairs never cross chunk ends and every first
    occurrence lies in the first copy. A sort-round path launches K13, K3
    and K4 once per round enqueued; the sparse routes launch no
    kernel."""
    from minbpe_tpu_torch import RegexTokenizer, engine
    from minbpe_tpu_torch.utils import checkpoint as ckpt

    g8k = golden_mod.load_golden_8192()
    V8k = golden_mod.VOCAB_SIZE_8192
    M8k = V8k - 256

    def verbose_train(name, text, vocab, must, exact, **opts):
        tok = RegexTokenizer(device="cuda")
        out = io.StringIO()
        torch.cuda.synchronize()
        with path(name, must, exact):
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                tok.train(text, vocab, verbose=True, **opts)
            torch.cuda.synchronize()
            timings[f"{name}_s"] = time.perf_counter() - t0
        counts = np.array([int(c) for c in re.findall(
            r"had (\d+) occurrences", out.getvalue())])
        return tok, merges_in_rank_order(np, tok.merges), counts

    def held(name, merges, counts, want, scale=1):
        if not (np.array_equal(merges, want["merges"])
                and np.array_equal(counts, scale * want["counts"])
                and len(merges) == want["fail_round"]):
            raise AssertionError(f"{name}: merges or counts differ from the "
                                 "golden")
        print(f"{name}: {len(merges)} merges equal to the golden "
              f"({timings[f'{name}_s']:.3f} s)")

    rounds = {k: M8k for k in ROUND_KERNELS}
    for name, mode, exact in (
            ("train_8192", "auto", rounds),
            ("train_8192_sortloop_inc", "sortloop_inc", rounds),
            ("train_8192_sparse", "sparse", {}),
            ("train_8192_sparse_inc", "sparse_inc", {})):
        _, merges, counts = verbose_train(
            name, corpus, V8k, ROUND_KERNELS if exact else (), exact,
            select_mode=mode)
        held(name, merges, counts, g8k)
    if engine.train_route("auto", len(corpus.encode("utf-8")), M8k) \
            != "sortloop":
        raise AssertionError("smoke-8192's default route is not sortloop")

    # xl-ckpt-1024: the first run goes three steps of 256 rounds, writing
    # checkpoints after 256 and 512 and stopping in the third step's
    # progress call; the second replays 512 merges (K3, K4) and runs 256
    xl_golden = golden_mod.load_xl_golden()
    xl_text = golden_mod.xl_corpus(ROOT)
    V = golden_mod.VOCAB_SIZE
    M = V - 256
    ck = os.path.join(scratch, "xl.ckpt.npz")
    every = M // 3  # 256
    stop_at = 2 * every

    def stop(done, total):
        if done > stop_at:
            raise KeyboardInterrupt

    cut = RegexTokenizer(device="cuda")
    resumed = RegexTokenizer(device="cuda")
    out = io.StringIO()
    with path("xl_ckpt_1024", ROUND_KERNELS, {
            "pair_select": M + (M - stop_at),
            "merge_apply": M + stop_at + (M - stop_at),
            "compact": M + stop_at + (M - stop_at)}):
        t0 = time.perf_counter()
        try:
            cut.train(xl_text, V, checkpoint_path=ck, checkpoint_every=every,
                      progress=stop)
            raise AssertionError("the progress callback did not interrupt")
        except KeyboardInterrupt:
            pass
        if ckpt.load(ck)["round_idx"] != stop_at:
            raise AssertionError(f"the checkpoint is not at round {stop_at}")
        with contextlib.redirect_stdout(out):
            resumed.train(xl_text, V, verbose=True, resume_from=ck)
        torch.cuda.synchronize()
        timings["xl_ckpt_1024_s"] = time.perf_counter() - t0
    held("xl_ckpt_1024", merges_in_rank_order(np, resumed.merges),
         np.array([int(c) for c in re.findall(r"had (\d+) occurrences",
                                              out.getvalue())]), xl_golden)

    # xl4-1024: the host arrays tiled, so the pre-split has no seam
    data, ends = cut._split_arrays(xl_text)
    data = np.asarray(data)
    ends = np.asarray(ends, np.int64)
    d4 = np.tile(data, 4)
    e4 = np.concatenate([ends + k * len(data) for k in range(4)])
    N4 = len(d4)
    if not N4 > engine.TRAIN_MAX_N or \
            engine.train_route("auto", N4, M) != "sortloop":
        raise AssertionError(f"xl4-1024: {N4} tokens do not take sortloop")
    out = io.StringIO()
    torch.cuda.synchronize()
    with path("xl4_1024", ROUND_KERNELS, {k: M for k in ROUND_KERNELS}):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            merges4, _ = engine.train_offsets(d4, e4, M, verbose=True,
                                              device=cut.device)
        torch.cuda.synchronize()
        timings["xl4_1024_s"] = time.perf_counter() - t0
    timings["xl4_1024_tokens"] = N4
    held("xl4_1024", merges_in_rank_order(np, merges4),
         np.array([int(c) for c in re.findall(r"had (\d+) occurrences",
                                              out.getvalue())]), xl_golden,
         scale=4)


def note_batching(train_mod, timings, name: str, merges: int):
    """Rebuilds, slots and the trainer's syncs of the run just made (the
    counters were reset before it); batching must have taken fewer
    rebuilds than merges."""
    from minbpe_tpu_torch import trace

    c = trace.COUNTERS
    timings[f"{name}_rebuilds"] = train_mod.LAST_REBUILDS
    timings[f"{name}_slots"] = c.get("train.slots", 0)
    timings[f"{name}_syncs"] = (c.get("sync.train.ctl", 0)
                                + c.get("sync.train.readback", 0))
    timings[f"{name}_merges_per_rebuild"] = merges / train_mod.LAST_REBUILDS
    if not 0 < train_mod.LAST_REBUILDS < merges:
        raise AssertionError(f"{name}: {train_mod.LAST_REBUILDS} rebuilds "
                             f"for {merges} merges")


# K1's two kernels and K9's (its memset is not told apart from others)
PAIR_HIST_KERNELS = ("pair_stats_kernel", "clear_stats_kernel",
                     "pair_count_kernel")


def _kernel_name(key: str) -> str:
    m = re.search(r"::(\w+(?:<[^>]*>)?)\(", key)
    return m.group(1) if m else key[:40]


def phase_device_time(torch, golden_mod):
    """Device busy time against wall time of the training and encode runs on
    the smoke corpus (encode also with the GPT-4 tokenizer at 100,256
    ranks, from the split's bytes to the ids on the host, and the whole
    encode from the text with the host split and with the device split),
    and of the training run on the XL corpus. The wall
    time is a plain run's; the busy time is the sum of device activity
    (kernels, memsets, copies) that torch.profiler records for the same
    call, which runs on one stream, so nothing overlaps. The idle share is
    1 - busy / wall."""
    from minbpe_tpu_torch import RegexTokenizer
    from minbpe_tpu_torch.convert import tokenizer_from_arrays
    from minbpe_tpu_torch.engine import device_table
    from minbpe_tpu_torch.ops.encode import encode_stream
    from minbpe_tpu_torch.ops.flat_encode import encode_offsets_arrays
    from minbpe_tpu_torch.ops.stream import build_stream
    from minbpe_tpu_torch.ops.train import train_merges
    from minbpe_tpu_torch.ops.train_inc import train_merges_stepped
    from minbpe_tpu_torch.ops.train_select import train_merges_select
    from minbpe_tpu_torch.ops.train_sortloop import (
        train_merges_sortloop_stepped)

    corpus = golden_mod.smoke_corpus(ROOT)
    tok = RegexTokenizer(device="cuda")
    tok.train(corpus, golden_mod.VOCAB_SIZE)
    split_tok = tokenizer_from_arrays(RegexTokenizer, *tok._merge_arrays(),
                                      device="cuda")
    split_tok.device_presplit = True
    table = device_table(tok)
    data, ends = tok._split_arrays(corpus)
    ids, seg = build_stream(data, ends, "cuda")
    xl_ids, xl_seg = build_stream(*tok._split_arrays(
        golden_mod.xl_corpus(ROOT)), "cuda")
    M = golden_mod.VOCAB_SIZE - 256
    gpt4, _, _ = sorted_tables(golden_mod)
    g_data, g_ends = gpt4._split_arrays(corpus)
    g_table = device_table(gpt4).cuckoo
    # The encode runs go first: once a process has profiled a run of tens
    # of thousands of device activities (train_pallas), the profiler
    # records no device activity for a later run of a few, such as the
    # encode run's one launch and one copy.
    runs = {
        "encode": lambda: encode_stream(ids, seg, table)[2].item(),
        # the whole encode from the text, host split against device split
        "encode_host_split": lambda: tok.encode(corpus),
        "encode_device_split": lambda: split_tok.encode(corpus),
        "encode_gpt4": lambda: encode_offsets_arrays(g_data, g_ends,
                                                     g_table),
        "train": lambda: train_merges(ids, seg, M),
        "train_xl": lambda: train_merges(xl_ids, xl_seg, M),
        "train_pallas": lambda: train_merges_select(ids, seg, M, "pallas"),
        "train_stepped": lambda: train_merges_stepped(ids, seg, M),
        # smoke-8192's default route, last: its ~32,000 launches
        "train_8192": lambda: train_merges_sortloop_stepped(
            ids, seg, golden_mod.VOCAB_SIZE_8192 - 256),
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
        if not busy:
            raise RuntimeError(f"{name}: the profiler recorded no device time")
        out[name] = {
            "wall_ms": wall,
            "device_busy_ms": busy,
            "idle_share": 1 - busy / wall,
            "by_kernel": [[_kernel_name(k), ms, c] for ms, c, k in parts[:9]],
            "pair_hist": [[_kernel_name(k), ms, c] for ms, c, k in parts
                          if _kernel_name(k) in PAIR_HIST_KERNELS],
        }
    # smoke-8192's rounds are K13 pair_select, K3 and K4, one launch each
    rounds = {k: c for k, _, c in out["train_8192"]["by_kernel"]}
    if not rounds.get("pair_select_kernel") or \
            rounds.get("merge_apply_kernel") != rounds["pair_select_kernel"]:
        raise RuntimeError("train_8192: pair_select_kernel did not run once a "
                           f"round: {out['train_8192']['by_kernel']}")
    return out


DEVICE_TIME_ARG = "--device-time"


def phase_device_time_fresh(torch):
    """phase_device_time in a process of its own, which has profiled and
    run nothing before: after phases 2 and 3 in one process the profiler
    recorded no device activity for the encode run, even as the phase's
    first profile (PERF.md §6). The child prints its result as the last
    line."""
    torch.cuda.empty_cache()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           DEVICE_TIME_ARG], capture_output=True, text=True,
                          timeout=600, cwd=ROOT)
    if proc.returncode != 0:
        raise RuntimeError(f"phase 4's process exited {proc.returncode}:\n"
                           f"{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def device_time_main() -> int:
    import torch

    from minbpe_tpu_torch.utils import golden as golden_mod

    print(json.dumps(phase_device_time(torch, golden_mod)))
    return 0


# ---------------------------------------------------------------------------
# phase 5: the distributed layer (minbpe_tpu_torch.parallel)
# ---------------------------------------------------------------------------

# every group the phase makes raises after this long instead of hanging
DIST_TIMEOUT_S = 120
# the kernels of the distributed paths, and a round's launches on one rank
DIST_KERNELS = ("pair_stats", "merge_apply", "compact", "encode_sweep",
                "segment_encode", "pair_summaries")
ROUND_LAUNCHES = {
    "dense": {"pair_stats": 1, "merge_apply": 2, "compact": 1},
    "sparse": {"pair_summaries": 2, "merge_apply": 2, "compact": 1},
    "owner": {"pair_summaries": 2, "merge_apply": 2, "compact": 1},
    "replay": {"merge_apply": 2, "compact": 1},
}
# merges of the world-4 sparse and owner runs on the smoke corpus (the
# golden's prefix): over gloo on one H100 all 768 rounds of both take
# about 50 s, past the phase's budget of 120 s
WORLD4_PREFIX = 256
# the Basic byte path's corpus and vocab
BASIC_BYTES = 65536
BASIC_MERGES = 256


def rounds_of(**kinds) -> dict:
    """The launches of so many rounds of each kind."""
    out = {}
    for kind, rounds in kinds.items():
        for k, c in ROUND_LAUNCHES[kind].items():
            out[k] = out.get(k, 0) + c * rounds
    return out


def mps_status() -> str:
    """Whether the CUDA MPS daemon is running (its pipe directory)."""
    pipe = os.environ.get("CUDA_MPS_PIPE_DIRECTORY", "/tmp/nvidia-mps")
    return (f"MPS running ({pipe})" if os.path.exists(pipe)
            else f"MPS not running (no {pipe})")


def dist_inputs(np, golden_mod):
    """What the distributed paths take: the smoke corpus's split (bytes,
    chunk ends), its first BASIC_BYTES bytes for the Basic path, and the
    golden's 768 merges."""
    from minbpe_tpu_torch import RegexTokenizer

    corpus = golden_mod.smoke_corpus(ROOT)
    data, ends = RegexTokenizer(device="cpu")._split_arrays(corpus)
    # whole characters only, so the text and its bytes are one corpus
    basic = corpus.encode("utf-8")[:BASIC_BYTES].decode("utf-8", "ignore")
    return dict(corpus=corpus, data=np.asarray(data), ends=np.asarray(ends),
                basic=basic.encode("utf-8"),
                merges=golden_mod.load_golden()["merges"])


def dist_paths(torch, np, comm, inp, golden_mod, world: int, scratch,
               launches: dict, timings: dict):
    """The distributed paths on this rank, each checked and timed alone:
    smoke-1024 by each selection (all 768 merges; at world 4 the sparse and
    owner runs stop at the first WORLD4_PREFIX) against the golden's
    merges, counts and fail round; at world 1 also the XL corpus (dense) and a checkpointed run
    cut at round 512 and resumed; at world 4 the Basic byte path; the
    sharded encode of the smoke corpus. launches[path] gets this rank's
    launch counts, timings[path] the wall time, the rounds a second and
    the collectives called (the ``comm.calls`` counter)."""
    from minbpe_tpu_torch import RegexTokenizer, kernels, trace
    from minbpe_tpu_torch.convert import tokenizer_from_arrays
    from minbpe_tpu_torch.parallel import encode as pencode
    from minbpe_tpu_torch.parallel import train as ptrain
    from minbpe_tpu_torch.utils import checkpoint as ckpt

    golden = golden_mod.load_golden()
    tag = f"dist{world}"

    @contextlib.contextmanager
    def path(name, exact, rounds=0):
        kernels.reset_launches()
        calls = trace.COUNTERS.get("comm.calls", 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k.name: k.launches for k in kernels.KERNELS}
        launches[name] = counts
        if any(counts[k] != exact.get(k, 0) for k in counts):
            raise AssertionError(f"path {name} launched {counts}, expected "
                                 f"{exact}")
        calls = trace.COUNTERS.get("comm.calls", 0) - calls
        timings[name] = dict(wall_s=wall, collectives=calls)
        if rounds:
            timings[name]["rounds_per_s"] = rounds / wall
        print(f"{name}: {wall:.3f} s, {calls} collectives"
              + (f", {rounds / wall:.1f} rounds/s" if rounds else ""))

    def held(name, pairs, counts, fail, oflow, M, g=golden):
        if oflow or fail != M:
            raise AssertionError(f"{name}: fail round {fail}, overflow "
                                 f"{oflow}")
        if not (np.array_equal(pairs, g["merges"][:M])
                and np.array_equal(counts, g["counts"][:M])):
            raise AssertionError(f"{name}: merges or counts differ from the "
                                 "golden")

    ids, seg, lens = ptrain.shard_offsets(inp["data"], inp["ends"],
                                          comm.size)
    M = len(golden["merges"])
    for sel in ptrain.SELECTIONS:
        name = f"{tag}_smoke_{sel}"
        Ms = M if world == 1 or sel == "dense" else WORLD4_PREFIX
        with path(name, rounds_of(**{sel: Ms}), Ms):
            out = ptrain.train_distributed(ids, seg, lens, Ms,
                                           selection=sel, comm=comm)
        held(name, *out, Ms)
    if world == 1:
        xl_golden = golden_mod.load_xl_golden()
        xd, xe = RegexTokenizer(device="cpu")._split_arrays(
            golden_mod.xl_corpus(ROOT))
        x_ids, x_seg, x_lens = ptrain.shard_offsets(xd, xe, comm.size)
        del xd, xe
        Mx = len(xl_golden["merges"])
        with path(f"{tag}_xl_dense", rounds_of(dense=Mx), Mx):
            out = ptrain.train_distributed(x_ids, x_seg, x_lens, Mx,
                                           comm=comm)
        held(f"{tag}_xl_dense", *out, Mx, xl_golden)
        del x_ids, x_seg
        ck = os.path.join(scratch, "dist.ckpt.npz")
        every = M // 3
        want = {(int(a), int(b)): 256 + r
                for r, (a, b) in enumerate(golden["merges"])}
        with path(f"{tag}_ckpt_run", rounds_of(dense=M), M):
            got = ptrain.train_offsets_distributed(
                inp["data"], inp["ends"], M, comm=comm, checkpoint_path=ck,
                checkpoint_every=every)[0]
        st = ckpt.load(ck)
        cut = 2 * every
        ckpt.save(ck, st["pairs"][:cut], st["counts"][:cut], cut, M,
                  st["fingerprint"])
        with path(f"{tag}_ckpt_resume",
                  rounds_of(replay=cut, dense=M - cut), M - cut):
            got2 = ptrain.train_offsets_distributed(
                inp["data"], inp["ends"], M, comm=comm, resume_from=ck,
                checkpoint_every=every)[0]
        if got != want or got2 != want:
            raise AssertionError("the checkpointed or the resumed run "
                                 "differs from the golden")
    else:
        with path(f"{tag}_basic", rounds_of(dense=BASIC_MERGES),
                  BASIC_MERGES):
            got = ptrain.train_bytes_distributed(inp["basic"], BASIC_MERGES,
                                                 comm=comm)[0]
        timings[f"{tag}_basic"]["merges"] = [list(p) for p in got]
    tok = tokenizer_from_arrays(RegexTokenizer, inp["merges"],
                                256 + np.arange(len(inp["merges"])),
                                device=comm.device)
    mine = int(lens[comm.rank]) > 0
    with path(f"{tag}_encode", {"segment_encode": int(mine)}):
        enc = pencode.encode_text_distributed(tok, inp["corpus"], comm=comm)
    if golden_mod.ids_digest(enc) != golden["encode_sha256"]:
        raise AssertionError(f"{tag}_encode: ids differ from the golden")


def world4_worker(rank: int, port: int, inp, scratch, out_q):
    """One of the phase's four gloo ranks on the one card."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    from minbpe_tpu_torch.parallel.comm import Comm
    from minbpe_tpu_torch.utils import golden as golden_mod

    try:
        dist.init_process_group(
            "gloo", init_method=f"tcp://localhost:{port}", rank=rank,
            world_size=4,
            timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
        comm = Comm(device="cuda:0")
        launches, timings = {}, {}
        dist_paths(torch, np, comm, inp, golden_mod, 4, scratch, launches,
                   timings)
        out_q.put((rank, "ok", (launches, timings)))
        dist.destroy_process_group()
    except Exception as e:  # reported by the parent, which fails
        import traceback

        out_q.put((rank, "err", f"{type(e).__name__}: {e}\n"
                                f"{traceback.format_exc()}"))


def phase_distributed(torch, np, golden_mod, scratch):
    """World 1 over NCCL in this process (a file store), then world 4 over
    gloo as four processes on the one card. Returns (timings, launches);
    a refused launch, a failed collective or a wrong result raises."""
    import datetime
    import multiprocessing as mp

    import torch.distributed as dist

    from minbpe_tpu_torch import BasicTokenizer
    from minbpe_tpu_torch.parallel.comm import Comm
    from minbpe_tpu_torch.parallel.multihost import free_port

    print(f"phase 5: {mps_status()}")
    t_phase = time.perf_counter()
    inp = dist_inputs(np, golden_mod)
    launches, timings = {}, {}
    store = os.path.join(scratch, "nccl_store")
    dist.init_process_group(
        "nccl", init_method=f"file://{store}", rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S),
        device_id=torch.device("cuda", 0))
    try:
        comm = Comm(device="cuda:0")
        dist_paths(torch, np, comm, inp, golden_mod, 1, scratch, launches,
                   timings)
    finally:
        dist.destroy_process_group()

    # the single-device BasicTokenizer on the Basic path's bytes
    single = BasicTokenizer(device="cuda")
    single.train(inp["basic"].decode("utf-8"), 256 + BASIC_MERGES)
    ctx = mp.get_context("spawn")
    out_q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=world4_worker,
                         args=(r, port, inp, scratch, out_q))
             for r in range(4)]
    for p in procs:
        p.start()
    results = {}
    try:
        deadline = time.monotonic() + 6 * DIST_TIMEOUT_S
        while len(results) < 4:
            left = deadline - time.monotonic()
            rank, status, res = out_q.get(timeout=max(left, 1))
            if status != "ok":
                raise RuntimeError(f"world-4 rank {rank} failed: {res}")
            results[rank] = res
    finally:
        for p in procs:
            p.join(30)
            if p.is_alive():
                p.kill()
                p.join()
    l0, t0 = results[0]
    for r in range(1, 4):
        if results[r][0] != l0:
            raise AssertionError(f"world-4 rank {r} launched "
                                 f"{results[r][0]}, rank 0 {l0}")
    basic = {tuple(p): 256 + i for i, p in
             enumerate(t0["dist4_basic"].pop("merges"))}
    if basic != single.merges:
        raise AssertionError("dist4_basic differs from the single-device "
                             "BasicTokenizer")
    launches.update(l0)
    timings.update({k: dict(v, per_rank_wall_s=[results[r][1][k]["wall_s"]
                                                for r in range(4)])
                    for k, v in t0.items()})
    timings["phase5_s"] = time.perf_counter() - t_phase
    timings["mps"] = mps_status()
    print(f"phase 5: {timings['phase5_s']:.1f} s")
    return timings, launches


# ---------------------------------------------------------------------------
# phase 6: the command line, the warm start, the entry checks and the
# bucketed chunk encoder
# ---------------------------------------------------------------------------

FIRST_REQUEST_ARG = "--first-request"
# the CLI's checkpoint step and the round its checkpoint is cut back to
CLI_EVERY = 256
CLI_CUT = 512


def first_request_main(mode: str) -> int:
    """One fresh process's first request, RegexTokenizer().train(smoke,
    1024) and encode(smoke), timed: "cold" at once, "warm" after
    precompile([len(smoke)], vocab_size=1024); then a second request for
    reference. Prints its result as the last line."""
    t_start = time.perf_counter()
    import numpy as np
    import torch

    from minbpe_tpu_torch import RegexTokenizer, precompile
    from minbpe_tpu_torch.utils import golden as golden_mod
    from minbpe_tpu_torch.utils.precompile import fused_capacity

    corpus = golden_mod.smoke_corpus(ROOT)
    golden = golden_mod.load_golden()
    out = {"mode": mode, "import_s": time.perf_counter() - t_start}
    if mode == "warm":
        n = len(corpus.encode("utf-8"))
        t0 = time.perf_counter()
        done = precompile([n], vocab_size=golden_mod.VOCAB_SIZE)
        out["precompile_s"] = time.perf_counter() - t0
        out["buckets"] = [b for b, _ in done]
        if out["buckets"] != [fused_capacity(n)]:
            raise AssertionError(f"precompile warmed {out['buckets']}, "
                                 f"fused_capacity gives {fused_capacity(n)}")
    for key in ("first_request_s", "second_request_s"):
        t0 = time.perf_counter()
        tok = RegexTokenizer()
        tok.train(corpus, golden_mod.VOCAB_SIZE)
        ids = tok.encode(corpus)
        torch.cuda.synchronize()
        out[key] = time.perf_counter() - t0
        if not np.array_equal(merges_in_rank_order(np, tok.merges),
                              golden["merges"]):
            raise AssertionError(f"{mode}: merges differ from the golden")
        if golden_mod.ids_digest(ids) != golden["encode_sha256"]:
            raise AssertionError(f"{mode}: ids differ from the golden")
    print(json.dumps(out))
    return 0


def first_request(mode: str) -> dict:
    """first_request_main in a fresh process; its result and the process's
    whole wall."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           FIRST_REQUEST_ARG, mode], capture_output=True,
                          text=True, timeout=300, cwd=ROOT)
    if proc.returncode != 0:
        raise RuntimeError(f"the {mode} first-request process exited "
                           f"{proc.returncode}:\n{proc.stderr[-4000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    res["process_s"] = time.perf_counter() - t0
    return res


def phase_tools(torch, np, kernels, golden_mod, scratch, main_launches,
                k12_cases, gpt4, plus):
    """The command line (train_torch.py: in-process, checkpointed and
    resumed, distributed at world 1 over NCCL, with a profile, and as a
    script), the first request of a fresh process cold and after
    precompile, the entry checks (entry_torch.py), and the bucketed chunk
    encoder on the card against the encode golden, the flat encoder and
    K12. main_launches: phase 3's launches; k12_cases: phase 2's K12
    records. Returns (timings, launches)."""
    import entry_torch
    import train_torch
    from minbpe_tpu_torch import RegexTokenizer
    from minbpe_tpu_torch.convert import tokenizer_from_arrays
    from minbpe_tpu_torch.engine import device_table
    from minbpe_tpu_torch.ops import chunk_encode, flat_encode
    from minbpe_tpu_torch.ops.ranktab import SortedPairTable
    from minbpe_tpu_torch.utils import checkpoint as ckpt

    timings, launches = {}, {}
    path = counted_paths(kernels, launches)
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()  # the fresh processes below share the card
    golden = golden_mod.load_golden()
    V, M = golden_mod.VOCAB_SIZE, golden_mod.VOCAB_SIZE - 256
    corpus = golden_mod.smoke_corpus(ROOT)

    def read(path_):
        with open(path_, "rb") as f:
            return f.read()

    # the command line: each run's model equal to the golden, and its
    # .model bytes to the first run's
    base = ["--tokenizers", "regex", "--vocab-size", str(V), "--quiet"]
    model = None

    def cli(name, flags, exact, outdir=None):
        nonlocal model
        outdir = outdir or os.path.join(scratch, name)
        with path(name, [k for k, c in exact.items() if c], exact):
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                train_torch.main([*base, "--outdir", outdir, *flags])
            torch.cuda.synchronize()
            timings[f"{name}_s"] = time.perf_counter() - t0
        tok = RegexTokenizer(device="cuda")
        tok.load(os.path.join(outdir, "regex.model"))
        if not np.array_equal(merges_in_rank_order(np, tok.merges),
                              golden["merges"]):
            raise AssertionError(f"{name}: the model differs from the golden")
        got = read(os.path.join(outdir, "regex.model"))
        model = got if model is None else model
        if got != model:
            raise AssertionError(f"{name}: .model bytes differ")
        print(f"{name}: {M} merges equal to the golden "
              f"({timings[f'{name}_s']:.3f} s)")
        return outdir

    cli("cli_train", [], main_launches["train"])
    ck_dir = cli("cli_checkpoint", ["--checkpoint-every", str(CLI_EVERY)],
                 {"pair_count": 1})
    ck = os.path.join(ck_dir, "regex.ckpt.npz")
    st = ckpt.load(ck)
    ckpt.save(ck, st["pairs"][:CLI_CUT], st["counts"][:CLI_CUT], CLI_CUT, M,
              st["fingerprint"])
    os.remove(os.path.join(ck_dir, "regex.model"))
    cli("cli_resume", ["--resume"], {"pair_count": 1,
                                     "merge_apply": CLI_CUT,
                                     "compact": CLI_CUT}, ck_dir)
    cli("cli_distributed", ["--distributed"], rounds_of(dense=M))
    trace_dir = os.path.join(scratch, "cli_trace")
    cli("cli_profile", ["--profile-dir", trace_dir], main_launches["train"])
    traces = [f for _, _, fs in os.walk(trace_dir) for f in fs
              if f.endswith(".json")]
    if not traces:
        raise AssertionError("cli_profile: no trace")
    outdir = os.path.join(scratch, "cli_script")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "train_torch.py", *base,
                           "--outdir", outdir], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    timings["cli_script_s"] = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"train_torch.py exited {proc.returncode}:\n"
                           f"{proc.stderr[-4000:]}")
    if read(os.path.join(outdir, "regex.model")) != model:
        raise AssertionError("cli_script: .model bytes differ")
    print(f"cli_script: python3 train_torch.py, the same .model bytes "
          f"({timings['cli_script_s']:.3f} s with the process)")

    # the first request of a fresh process, cold and after precompile
    for mode in ("cold", "warm"):
        res = first_request(mode)
        timings[f"first_request_{mode}"] = res
        print(f"first request, {mode}: {res['first_request_s']:.3f} s "
              + (f"after precompile {res['precompile_s']:.3f} s (buckets "
                 f"{res['buckets']}) " if mode == "warm" else "")
              + f"(second request {res['second_request_s']:.3f} s, imports "
              f"{res['import_s']:.3f} s, process {res['process_s']:.3f} s)")

    # the entry checks
    fn, args = entry_torch.entry()
    with path("entry", ENCODE_KERNELS, exact={"encode_sweep": 1}):
        ids, n = fn(*args)
        got = ids[:int(n)].tolist()
    cfn, cargs = entry_torch.entry(device="cpu")
    cids, cn = cfn(*cargs)
    if got != cids[:int(cn)].tolist():
        raise AssertionError("entry() on the card differs from the CPU")
    with path("dryrun_multichip", ()):  # its ranks launch in their own
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as said:
            entry_torch.dryrun_multichip(torch.cuda.device_count())
        timings["dryrun_multichip_s"] = time.perf_counter() - t0
    print(f"entry: {len(got)} tokens equal to the CPU's; "
          f"{said.getvalue().strip()} ({timings['dryrun_multichip_s']:.3f} s)")

    # the bucketed chunk encoder (plain PyTorch on the card) against the
    # encode golden and the flat encoder (K11, K12)
    encode_golden = golden_mod.load_encode_golden()
    plus_tok = tokenizer_from_arrays(RegexTokenizer, *plus, device="cuda")
    for case, tok in (("gpt4_100k", gpt4), ("smoke_plus_4353", plus_tok)):
        data, ends = tok._split_arrays(corpus)
        table = SortedPairTable(*tok._merge_arrays(), device="cuda")
        with path(f"chunk_encoder_{case}", ()):
            t0 = time.perf_counter()
            flat, _ = chunk_encode.encode_offsets_arrays(data, ends, table)
            timings[f"chunk_encoder_{case}_s"] = time.perf_counter() - t0
        if (golden_mod.ids_digest(flat), len(flat)) != encode_golden[case]:
            raise AssertionError(f"chunk_encoder_{case}: ids differ from the "
                                 "encode golden")
        cuckoo = device_table(tok).cuckoo
        walls = []
        for _ in range(3):
            with path(f"flat_encoder_{case}", ("chunk_encode",),
                      exact={"chunk_encode": 1}):
                t0 = time.perf_counter()
                toks = flat_encode.encode_offsets_arrays(data, ends,
                                                         cuckoo)[0]
                walls.append(time.perf_counter() - t0)
        timings[f"flat_encoder_{case}_s"] = sorted(walls)[1]
        if not np.array_equal(toks, flat):
            raise AssertionError(f"chunk_encoder_{case}: differs from the "
                                 "flat encoder")
        print(f"chunk_encoder_{case}: {len(flat)} ids equal to the encode "
              f"golden and the flat encoder; "
              f"{timings[f'chunk_encoder_{case}_s']:.3f} s against the flat "
              f"encoder's {timings[f'flat_encoder_{case}_s']:.4f} s")

    # one chunk past the largest bucket: encode_stream_sorted, K3 and K4
    # once a round (each applied round, then the rest of the last group of
    # 8), the output equal to K12's in phase 2
    k12 = next(r for r in k12_cases
               if r["case"] == "head64k_smoke_plus_4353")
    raw = np.frombuffer(corpus.encode("utf-8")[:golden_mod.HEAD_BYTES],
                        np.uint8)
    table = SortedPairTable(*plus, device="cuda")
    each = 8 * (k12["rounds_max"] // 8 + 1)
    with path("chunk_encoder_head64k", ("merge_apply", "compact"),
              exact={"merge_apply": each, "compact": each}):
        t0 = time.perf_counter()
        flat, _ = chunk_encode.encode_offsets_arrays(
            raw, np.array([len(raw)]), table)
        timings["chunk_encoder_head64k_s"] = time.perf_counter() - t0
    if golden_mod.ids_digest(flat) != k12["sha256"] or \
            len(flat) != k12["n_out"]:
        raise AssertionError("chunk_encoder_head64k: ids differ from K12's")
    timings["chunk_encoder_head64k_rounds"] = k12["rounds_max"]
    timings["k12_head64k_ms"] = k12["ms"]
    print(f"chunk_encoder_head64k: {len(flat)} ids equal to K12's, "
          f"{k12['rounds_max']} rounds, {each} launches of K3 and of K4; "
          f"{timings['chunk_encoder_head64k_s']:.3f} s against K12's "
          f"{k12['ms']:.4f} ms")
    timings["phase6_s"] = time.perf_counter() - t_phase
    print(f"phase 6: {timings['phase6_s']:.1f} s")
    return timings, launches


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
        build_s = phase_build(kernels, native)
        texts = text_streams(torch, np, kernels, golden_mod)
        rows = phase_kernels(torch, np, kernels, XL_MAX_N,
                             STEPPED_AUTO_MAX_N, texts)
        rows.append(phase_sweep(torch, np, kernels, golden_mod))
        cl100k, cl100k_build_s = cl100k_standin()
        rows.append(phase_segment(torch, np, kernels, golden_mod, cl100k))
        rows += phase_table(torch, np, kernels, golden_mod, texts)
        del texts
        torch.cuda.empty_cache()
        gpt4, plus, gpt4_build_s = sorted_tables(golden_mod)
        rows += phase_flat(torch, np, kernels, golden_mod, gpt4, plus)
        rows += phase_presplit(torch, np, golden_mod)
        check_rows(rows)
        print(f"timing: the host outran the sleep {len(RETAKEN_READINGS)} "
              f"time(s) (function, sleep cycles a call, the reading set "
              f"aside): {RETAKEN_READINGS}; {len(PROFILED_READINGS)} "
              f"reading(s) from the profiler (function, ms, counts): "
              f"{PROFILED_READINGS}")
        timings, launches = phase_main_path(torch, np, kernels, golden_mod,
                                            scratch, gpt4, plus, cl100k)
        timings["gpt4_table_build_s"] = gpt4_build_s
        timings["cl100k_standin_build_s"] = cl100k_build_s
        device_time = phase_device_time_fresh(torch)
        dist_timings, dist_launches = phase_distributed(torch, np,
                                                        golden_mod, scratch)
        launches.update(dist_launches)
        k12_cases = next(r for r in rows
                         if r["k"] is kernels.ENCODE_MIN_SWEEP)["shapes"]
        tool_timings, tool_launches = phase_tools(
            torch, np, kernels, golden_mod, scratch, launches, k12_cases,
            gpt4, plus)
        tool_timings.update(build_s)
        launches.update(tool_launches)
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
         **{k: r[k] for k in ("xl", "shapes", "by_pair", "ms_per_rank",
                              "k15_ms", "k15_profiled_ms", "k15_plain_ms",
                              "k15_bound_ms", "ids_cost_us")
            if k in r}}
        for r in rows]}
    print(json.dumps(line))
    print(json.dumps({"main_path": timings}))
    print(json.dumps({"device_time": device_time}))
    print(json.dumps({"distributed": dist_timings}))
    print(json.dumps({"tools": tool_timings}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == [DEVICE_TIME_ARG]:
        sys.exit(device_time_main())
    if sys.argv[1:2] == [FIRST_REQUEST_ARG]:
        sys.exit(first_request_main(sys.argv[2]))
    sys.exit(main())
