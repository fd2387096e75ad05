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
   corpus's stream; K11 and K12 (the sorted route) over the smoke corpus's
   GPT-4 split with the GPT-4 table at 100,256 ranks and with
   smoke_plus_4353, and over its first 65,536 bytes as one chunk with
   both; K13 and K14 (the sort-round trainer's count and selection)
   against pair_table_plain's table and select_max_pair's pair over the
   400K stream, the smoke stream after the vocab-8192 golden's first 4,000
   merges, 2^20 copies of "a", 2^20 distinct ids, the XL corpus's stream
   and that stream four times over (50,353,352 tokens), each with its
   bytes bound and torch.unique's time; the outputs are integers and must
   be exactly equal;
3. drive the main path through the user's entry points, one path at a
   time, with every launch count set to 0 just before each path and read
   just after it: RegexTokenizer (GPT-4 pattern) training at vocab 1024 on
   the frozen in-repo smoke corpus (merges and counts equal to the golden
   that minbpe_tpu produced, in fewer rebuilds than merges), encode (ids'
   sha256 equal to the golden's), decode, encode_batch and the same
   documents encoded one by one, special tokens, save/load, a
   BasicTokenizer at vocab 512 and one on 2^20 copies of "a", both equal to
   the plain path on the CPU (every encode path launching K10 once per
   device stream and K3/K4 never), and the large-corpus route: vocab 1024
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
   dense route. Then the routes past vocab 2048 and 48·2^20 tokens:
   smoke-8192 (vocab 8,192 on the smoke corpus) by the default route (the
   sort-round trainer), "sortloop_inc", "sparse" and "sparse_inc", each
   equal to the vocab-8192 golden; the XL corpus at vocab 1024 with a
   checkpoint every 256 rounds, cut after round 512 and resumed, equal to
   the XL golden; and the XL corpus's split tiled four times (50,353,352
   tokens), equal to the XL golden's merges with four times its counts;
4. in a process of its own, the device's busy time (torch.profiler) in
   the encode runs (the 768-merge table and GPT-4's), the training runs
   on both corpora, the "pallas" and stepped runs on the smoke corpus and
   smoke-8192's default route against their wall time: the idle share;
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
    # timed at the run pair (homogeneous: the run-start chain) and at the
    # stream's top heterogeneous pair (the common case: no chain)
    hetero = draw_batch(np, ck.cpu().numpy(), fk.cpu().numpy(), 1)[0][:2]
    by_pair = []
    for pair in ((7, 7), hetero):
        pt = torch.tensor(pair, dtype=torch.int32, device=dev)
        by_pair.append(dict(pair=list(pair), ms=device_ms(
            torch, lambda: kernels.merge_apply(ids, seg, nt, pt, 5000), 50)))
    pt = torch.tensor((7, 7), dtype=torch.int32, device=dev)
    rows.append(dict(
        k=kernels.MERGE_APPLY, err=err3, ms=by_pair[0]["ms"],
        by_pair=by_pair,
        plain_ms=host_ms(torch, lambda: kernels.merge_apply_plain(
            ids, seg, nt, pt, 5000), 5),
        bytes=13 * n, library_ms=None))
    print(f"merge_apply: {by_pair[0]['ms']:.5f} ms at {by_pair[0]['pair']}, "
          f"{by_pair[1]['ms']:.5f} ms at {by_pair[1]['pair']}")

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
            grid=kernels._load().bpe_encode_grid(c_ids.numel(), 0),
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


def flat_case(torch, np, kernels, name, data, ends, table, long_only):
    """K11 over the chunks of (data, ends) of at most CHUNK_WARP_MAX tokens,
    or (long_only) K12 over the whole as one stream of its chunks, against
    the plain version on the card's tensors. The bound: the bytes the
    function must move: each input token (4 B) and each chunk's bounds (and
    for K11 its index, 4 B) read once, each output token and length written
    once (4 B), and two 16-byte table rows for each distinct pair of the
    input (the rows its first round must probe; later rounds' pairs are
    not counted)."""
    dev = table.rows.device
    N, C = len(data), len(ends)
    L = np.diff(ends, prepend=0)
    ids = torch.from_numpy(data.astype(np.int32)).to(dev)
    seg_h = np.repeat(np.arange(C, dtype=np.int32), L)
    seg = torch.from_numpy(seg_h).to(dev)
    same = seg[:-1] == seg[1:]
    pair_keys = (ids[:-1].long() << 32 | ids[1:].long())[same]
    distinct = int(torch.unique(pair_keys).numel())
    if long_only:
        if (L <= kernels.CHUNK_WARP_MAX).any():
            raise AssertionError(f"{name}: a chunk is short")

        def run():
            return kernels.encode_min_sweep(ids, seg, table)

        def plain():
            return kernels.encode_min_sweep_plain(ids, seg, table)

        got, want = run(), plain()
        k = int(want[2])
        err = max_err(torch, [(got[2], want[2]), (got[0][:k], want[0][:k]),
                              (got[1][:k], want[1][:k])])
        nbytes = 8 * N + 8 * k + 4 + 32 * distinct
        info = kernels.ENCODE_MIN_SWEEP
    else:
        short = L <= kernels.CHUNK_WARP_MAX
        which = torch.from_numpy(np.flatnonzero(short).astype(np.int32)).to(
            dev)
        bounds = torch.from_numpy(np.r_[0, ends].astype(np.int32)).to(dev)
        out = torch.full((N + 1,), -1, dtype=torch.int32, device=dev)
        lens = torch.zeros(C + 1, dtype=torch.int32, device=dev)

        def run():
            kernels.chunk_encode(ids, bounds, which, table, out, lens)
            return out, lens

        def plain():
            o = torch.full((N + 1,), -1, dtype=torch.int32, device=dev)
            n = torch.zeros(C + 1, dtype=torch.int32, device=dev)
            kernels.chunk_encode_plain(ids, bounds, which, table, o, n)
            return o, n

        got = [t.clone() for t in run()]
        want = plain()
        err = max_err(torch, list(zip(got, want)))
        k = int(want[1].sum())
        S = int(short.sum())
        nbytes = 4 * N + 8 * S + 4 * (C + 1) + 4 * k + 4 * S + 32 * distinct
        info = kernels.CHUNK_ENCODE
    rec = dict(case=name, n=N, chunks=C, n_out=k, distinct_pairs=distinct,
               max_abs_err=err, ms=device_ms(torch, run, 20),
               plain_ms=host_ms(torch, plain, 1), bytes=nbytes,
               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
    print(f"{info.name} {name}: {N} tokens, {C} chunks -> {k}, max_abs_err "
          f"{err}, {rec['ms']:.4f} ms, bound {rec['bound_ms']:.5f} ms, plain "
          f"{rec['plain_ms']:.1f} ms")
    return info, rec


def phase_flat(torch, np, kernels, golden_mod, gpt4, plus):
    """K11 and K12 against their plain version on the card, on the smoke
    corpus's GPT-4 split (every chunk short: K11) with the GPT-4 table
    (bytes shuffled) and with smoke_plus_4353, and on its first 65,536
    bytes as one chunk (K12 alone) with both tables."""
    from minbpe_tpu_torch import RegexTokenizer
    from minbpe_tpu_torch.engine import device_table

    corpus = golden_mod.smoke_corpus(ROOT)
    plus_tok = RegexTokenizer(device="cuda")
    plus_tok.merges = {(int(a), int(b)): int(z) for (a, b), z in zip(*plus)}
    recs = {"chunk_encode": [], "encode_min_sweep": []}
    for tname, tok in (("gpt4_100k", gpt4), ("smoke_plus_4353", plus_tok)):
        table = device_table(tok).cuckoo
        data, ends = tok._split_arrays(corpus)
        head = np.asarray(data[:golden_mod.HEAD_BYTES])
        for name, d, e, long_only in (
                (f"smoke_{tname}", data, ends, False),
                (f"head64k_{tname}", head, np.array([len(head)]), True)):
            info, rec = flat_case(torch, np, kernels, name, d, e, table,
                                  long_only)
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


def split_ms(torch, fns, reps: int):
    """Device time per call of each of fns, called in turn reps times behind
    a sleeping kernel, with an event between every two launches."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(len(fns) + 1)]
          for _ in range(reps)]
    torch.cuda._sleep(reps * 400_000)
    for r in range(reps):
        ev[r][0].record()
        for j, fn in enumerate(fns):
            fn()
            ev[r][j + 1].record()
    torch.cuda.synchronize()
    return [sum(ev[r][j].elapsed_time(ev[r][j + 1]) for r in range(reps))
            / reps for j in range(len(fns))]


def table_case(torch, kernels, name, ids, seg):
    """K13 pair_table and K14 table_select over a whole stream, against
    their plain versions on the card: K13's table (key, count, first of
    every claimed slot, sorted by key) against pair_table_plain's (a
    torch.unique of the keys), K14's record (pa, pb, count, ok) against
    ops/select.select_max_pair (the stable-sort selection), and the table
    empty after K14. Bounds: K13 reads 8 B a token and writes 16 B a
    distinct pair D; K14 reads the 16 D B. Library: torch.unique over the
    countable pairs' 64-bit keys with their counts (no first positions)."""
    from minbpe_tpu_torch.ops.select import select_max_pair

    dev = ids.device
    N = ids.numel()
    n = torch.full((1,), N, dtype=torch.int32, device=dev)
    fail = torch.ones(1, dtype=torch.int32, device=dev)
    sel = torch.zeros(4, dtype=torch.int32, device=dev)
    pairs = torch.zeros((1, 2), dtype=torch.int32, device=dev)
    counts = torch.zeros(1, dtype=torch.int32, device=dev)
    table = kernels.PairTable(N, dev)

    def k13():
        kernels.pair_table(ids, seg, n, table, fail, 0)

    def k14():
        kernels.table_select(table, sel, pairs, counts, fail, 0)

    k13()
    got = kernels.table_contents(table)
    plain = kernels.PairTable(N, dev)
    kernels.pair_table_plain(ids, seg, n, plain)
    want = kernels.table_contents(plain)
    D = want[0].numel()
    kernels.table_select_plain(plain, sel.clone(), pairs.clone(),
                               counts.clone(), fail.clone(), 0)
    k14()
    pa, pb, c, ok = select_max_pair(ids, seg, n)
    ref = torch.tensor([int(pa), int(pb), int(c), 1] if bool(ok)
                       else [-1, -1, 0, 0], dtype=torch.int32)
    err = max_err(torch, list(zip(got, want)) + [(sel.cpu(), ref)])
    empty = (int(table.used) == 0 and bool((table.key == -1).all())
             and not bool(table.cnt.any()))
    if not empty:
        raise AssertionError(f"table_select left the table of {name} full")

    def plain_pair():
        kernels.pair_table_plain(ids, seg, n, plain)
        kernels.table_select_plain(plain, sel, pairs, counts, fail, 0)

    big = N > (1 << 22)
    reps = 10 if big else 50
    k13_ms, k14_ms = split_ms(torch, [k13, k14], reps)
    a, b = ids[:-1].long(), ids[1:].long()
    keys = ((a << 32) | b)[seg[:-1] == seg[1:]]
    del a, b
    lib = profiled_ms(torch, lambda: torch.unique(
        keys, sorted=True, return_counts=True), 5 if big else 20)
    del keys
    plain_ms = host_ms(torch, plain_pair, 1 if big else 5)
    del plain
    rec = dict(case=name, n=N, distinct=D, max_abs_err=err,
               grid=kernels._load().bpe_pair_hist_grid(2, N, 0),
               ms=k13_ms, k14_ms=k14_ms, plain_ms=plain_ms,
               sort_ms=host_ms(torch, lambda: select_max_pair(ids, seg, n),
                               1 if big else 5),
               bytes=8 * N + 16 * D, k14_bytes=16 * D, library_ms=lib,
               selected=sel.tolist())
    rec["bound_ms"] = rec["bytes"] / HBM_BYTES_PER_S * 1e3
    rec["k14_bound_ms"] = rec["k14_bytes"] / HBM_BYTES_PER_S * 1e3
    print(f"pair_table {name}: n {N}, D {D}, grid {rec['grid']}, "
          f"max_abs_err {err}, K13 {k13_ms:.5f} ms (bound "
          f"{rec['bound_ms']:.5f}), K14 {k14_ms:.5f} ms (bound "
          f"{rec['k14_bound_ms']:.5f}), unique {lib:.5f} ms, sort selection "
          f"{rec['sort_ms']:.3f} ms, pair {rec['selected']}")
    return rec


def phase_table(torch, np, kernels, golden_mod, texts):
    """K13 and K14 against their plain versions at the shapes the sort-round
    route gives them: the 400K seeded Zipf stream, the smoke corpus's
    stream after the vocab-8192 golden's first 4,000 merges (ids above
    4,096; applied by K10), 2^20 copies of "a" (one hot pair), 2^20
    distinct ids (every pair distinct: the table's load), the XL corpus's
    stream and that stream four times over (50,353,352 tokens, each copy's
    chunks its own). Returns K13's and K14's rows; K13's main shape is the
    Zipf stream."""
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
    run = torch.full((1 << 20,), 97, dtype=torch.int32, device=dev)
    dist = torch.arange(1 << 20, dtype=torch.int32, device=dev)
    cases = [
        ("zipf_400k", torch.from_numpy(zids).to(dev),
         torch.from_numpy(zseg).to(dev)),
        ("smoke_8192_m4000", m_ids[:k].contiguous(), m_seg[:k].contiguous()),
        ("run_a", run, torch.zeros_like(run)),
        ("all_distinct", dist, torch.zeros_like(dist)),
        ("xl", x_ids, x_seg),
        ("xl4", *xl_stream(torch, x_ids, x_seg, 4 * x_ids.numel())),
    ]
    recs = []
    for name, c_ids, c_seg in cases:
        recs.append(table_case(torch, kernels, name, c_ids, c_seg))
        torch.cuda.empty_cache()
    if int(m_ids[:k].max()) < 4096:
        raise AssertionError("the smoke stream after 4,000 merges holds no "
                             "id above 4,096")
    main = recs[0]
    k13 = dict(k=kernels.PAIR_TABLE, err=max(r["max_abs_err"] for r in recs),
               ms=main["ms"], plain_ms=main["plain_ms"], bytes=main["bytes"],
               library_ms=main["library_ms"], shapes=recs)
    k14 = dict(k=kernels.TABLE_SELECT, err=k13["err"], ms=main["k14_ms"],
               plain_ms=main["plain_ms"], bytes=main["k14_bytes"],
               library_ms=None,
               shapes=[dict(case=r["case"], ms=r["k14_ms"],
                            bound_ms=r["k14_bound_ms"], distinct=r["distinct"],
                            max_abs_err=r["max_abs_err"]) for r in recs])
    return [k13, k14]


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


TRAIN_KERNELS = ("pair_stats", "select_batch", "merge_apply", "batch_hist",
                 "batch_apply", "compact")
ENCODE_KERNELS = ("encode_sweep",)


def phase_main_path(torch, np, kernels, golden_mod, scratch, gpt4, plus):
    """Returns (timings, launches), launches = {path: {kernel: count}}."""
    from minbpe_tpu_torch import BasicTokenizer, RegexTokenizer
    from minbpe_tpu_torch.ops import train as train_mod

    timings = {}
    launches = {}

    @contextlib.contextmanager
    def path(name, must_launch, exact=None, some=None):
        """Count this path's launches alone; each kernel it must run has to
        have launched at least once, with ``exact`` ({kernel: count})
        every kernel exactly so often (0 where it is not named), and with
        ``some`` the kernels it names exactly so often."""
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

    def sweeps(count):  # an encode path: K10 once per device stream
        return dict(must_launch=ENCODE_KERNELS,
                    exact={"encode_sweep": count})

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
    selection_paths(torch, np, golden_mod, corpus, path, timings, head, gb,
                    scratch)
    large_vocab_paths(torch, np, golden_mod, corpus, path, timings, scratch)
    return timings, launches


def encode_paths(np, golden_mod, corpus, path, timings, gpt4, plus):
    """The two encode routes past the fused Pallas encoder's bounds, each
    held to the encode golden minbpe_tpu wrote (ids' sha256 and count): the
    GPT-4 tokenizer at 100,256 ranks (encode, decode, the 256 documents as
    one batch, specials), smoke_plus_4096 (dense: K10 once), smoke_plus_4353
    (sorted: K11 once; no chunk of the corpus's split passes 256 tokens, so
    no K12) and its BasicTokenizer on the first 64 KB (one chunk: K12
    once), and the XL corpus through the dense route (K10 once)."""
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
             corpus, "encode_sweep"),
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
    with path("encode_xl_dense", **only("encode_sweep")):
        ids = timed("encode_xl_dense", lambda: xl_tok.encode(xl_text))
    held("xl_dense_1024", ids)
    if xl_tok.decode(ids) != xl_text:
        raise AssertionError("XL decode(encode(corpus)) != corpus")
    timings["encode_xl_dense_MB_per_s"] = (
        len(xl_text.encode("utf-8")) / timings["encode_xl_dense_s"] / 1e6)
    print(f"encode_xl_dense: {len(ids)} ids equal to the golden "
          f"({timings['encode_xl_dense_s']:.3f} s)")


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


ROUND_KERNELS = ("pair_table", "table_select", "merge_apply", "compact")


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
    occurrence lies in the first copy. A sort-round path launches K13, K14,
    K3 and K4 once per round enqueued; the sparse routes launch no
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
            "pair_table": M + (M - stop_at),
            "table_select": M + (M - stop_at),
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
    """Rebuilds, slots and syncs of the run just made; batching must have
    taken fewer rebuilds than merges."""
    timings[f"{name}_rebuilds"] = train_mod.LAST_REBUILDS
    timings[f"{name}_slots"] = train_mod.LAST_SLOTS
    timings[f"{name}_syncs"] = train_mod.LAST_SYNCS
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
    ranks, from the split's bytes to the ids on the host), and of the
    training run on the XL corpus. The wall
    time is a plain run's; the busy time is the sum of device activity
    (kernels, memsets, copies) that torch.profiler records for the same
    call, which runs on one stream, so nothing overlaps. The idle share is
    1 - busy / wall."""
    from minbpe_tpu_torch import RegexTokenizer
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
        "encode": lambda: encode_stream(ids, seg, table.pairs,
                                        table.new_ids)[2].item(),
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
        texts = text_streams(torch, np, kernels, golden_mod)
        rows = phase_kernels(torch, np, kernels, XL_MAX_N,
                             STEPPED_AUTO_MAX_N, texts)
        rows.append(phase_sweep(torch, np, kernels, golden_mod))
        rows += phase_table(torch, np, kernels, golden_mod, texts)
        del texts
        torch.cuda.empty_cache()
        gpt4, plus, gpt4_build_s = sorted_tables(golden_mod)
        rows += phase_flat(torch, np, kernels, golden_mod, gpt4, plus)
        check_rows(rows)
        timings, launches = phase_main_path(torch, np, kernels, golden_mod,
                                            scratch, gpt4, plus)
        timings["gpt4_table_build_s"] = gpt4_build_s
        device_time = phase_device_time_fresh(torch)
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
         **{k: r[k] for k in ("xl", "shapes", "by_pair", "ms_per_rank")
            if k in r}}
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
    sys.exit(device_time_main() if sys.argv[1:] == [DEVICE_TIME_ARG]
             else main())
