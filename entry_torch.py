"""Entry checks of minbpe_tpu_torch: one encode on one device, and the
distributed trainer and encoder across ranks.

entry(device=None)      -> (fn, example_args): ``fn(*example_args)`` is the
                           stream encode of a short text against a frozen
                           three-merge table (K10 ``encode_sweep`` on the
                           card, its plain version on the CPU), returning
                           (ids, n): the tokens are ids[:n].
dryrun_multichip(n)     -> spawns n ranks in one process group and checks
                           on every rank that the distributed trainer's
                           dense, sparse and owner selections learn the
                           same 8 merges with the same counts (no overflow,
                           no early stop), that its stepped trainer (3
                           rounds a step) learns them too, and that the
                           sharded encode equals the single-device encode;
                           raises where one does not.

Both take ``device`` as the tokenizers do: None is cuda (raising without
CUDA), "cpu" runs the kernels' plain versions. The ranks use NCCL with one
card each where n is at most the number of cards, else gloo (also on
"cpu").
"""

from __future__ import annotations

import datetime
import queue
import time

import numpy as np

NUM_MERGES = 8
STEP_ROUNDS = 3
TIMEOUT_S = 120
TEXT = b"the cat and the hat are the best of the rest, clearly the theme"


def _toy_merge_table():
    """Small deterministic merge table (no training needed at import)."""
    # merges over bytes: "e "->256, "th"->257, [257,256]->258 ("the ")
    pairs = np.array([[101, 32], [116, 104], [257, 256]], dtype=np.int32)
    new_ids = np.array([256, 257, 258], dtype=np.int32)
    return pairs, new_ids


def _encode(ids, seg, n, table):
    """The stream encode of ids[:n] (segments seg) by the rank sweep
    through ``table`` (engine.DeviceMergeTable): (ids, n)."""
    from minbpe_tpu_torch.ops.encode import encode_stream

    k = int(n)
    out, _, m = encode_stream(ids[:k], seg[:k], table)
    return out, m


def entry(device=None):
    import torch

    from minbpe_tpu_torch.base import resolve_device
    from minbpe_tpu_torch.engine import DeviceMergeTable
    from minbpe_tpu_torch.ops import stream as st

    dev = resolve_device(device)
    table = DeviceMergeTable(*_toy_merge_table(), dev)

    def fn(ids, seg, n):
        return _encode(ids, seg, n, table)

    ids, seg, n = st.pack_bytes(TEXT)
    example_args = (torch.from_numpy(ids).to(dev),
                    torch.from_numpy(seg).to(dev),
                    torch.tensor(int(n), dtype=torch.int32, device=dev))
    return fn, example_args


def _chunks(n_ranks: int) -> list[bytes]:
    return [b"the cat", b" sat on", b" the mat", b" and that",
            b" was that", b" for the", b" cat and", b" the mat"] * n_ranks


def dryrun_rank(group, device) -> dict:
    """dryrun_multichip's checks on this rank of ``group`` (None: the
    default group), on ``device`` (this rank's card, or "cpu"); returns
    what the rank saw."""
    import torch
    import torch.distributed as dist

    from minbpe_tpu_torch.engine import DeviceMergeTable
    from minbpe_tpu_torch.ops import stream as st
    from minbpe_tpu_torch.parallel import encode as pencode
    from minbpe_tpu_torch.parallel import train as ptrain

    D = dist.get_world_size(group)
    chunks = _chunks(D)
    ids, seg, lens = ptrain.shard_chunks(chunks, D)
    results = {}
    # every exact selection: dense (all-reduced W x W counts), sparse (the
    # all-gathered summaries of the large-vocab path) and owner (the
    # keyspace all-to-all of the large-group path) must agree
    for selection in ptrain.SELECTIONS:
        pairs, counts, fail, oflow = ptrain.train_distributed(
            ids, seg, lens, NUM_MERGES, group, selection=selection,
            device=device)
        assert not oflow, f"{selection}: selection overflow in dryrun"
        assert fail == NUM_MERGES, (
            f"{selection}: training failed at round {fail}")
        assert int(counts[0]) > 0
        results[selection] = (pairs, counts)
    dense_pairs, dense_counts = results["dense"]
    for selection, (p, c) in results.items():
        assert (p == dense_pairs).all() and (c == dense_counts).all(), (
            f"{selection} selection disagrees with dense")
    merges = {(int(a), int(b)): 256 + i
              for i, (a, b) in enumerate(dense_pairs)}

    # the stepped (checkpointable) trainer must agree with the whole run
    stepped, _ = ptrain.train_chunks_distributed(
        chunks, NUM_MERGES, group, checkpoint_every=STEP_ROUNDS,
        device=device)
    assert stepped == merges, "stepped trainer disagrees"

    # the sharded encode must equal the single-device encode of the chunks
    mp = np.asarray(dense_pairs, np.int32)
    mi = (256 + np.arange(NUM_MERGES)).astype(np.int32)
    enc = pencode.encode_chunks_distributed(chunks, mp, mi, group,
                                            device=device)
    dev = torch.device(device)
    eids, eseg, en = st.pack_chunks(chunks)
    ref_ids, ref_n = _encode(torch.from_numpy(eids).to(dev),
                             torch.from_numpy(eseg).to(dev), en,
                             DeviceMergeTable(mp, mi, dev))
    ref = ref_ids[:int(ref_n)].cpu().numpy()
    assert np.array_equal(enc, ref), \
        "sharded encode disagrees with single-device"
    return {"first_merge": tuple(int(v) for v in dense_pairs[0]),
            "first_count": int(dense_counts[0]), "encoded": len(enc)}


def _rank_main(rank: int, n: int, port: int, backend: str, device: str,
               out_q):
    """One spawned rank: join the group, run the checks, report."""
    try:
        import torch
        import torch.distributed as dist

        kw = {}
        dev = torch.device("cpu")
        if device == "cuda":
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
            if backend == "nccl":
                kw["device_id"] = dev
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{port}", rank=rank,
            world_size=n, timeout=datetime.timedelta(seconds=TIMEOUT_S),
            **kw)
        try:
            res = dryrun_rank(None, dev)
        finally:
            dist.destroy_process_group()
        out_q.put((rank, "ok", res))
    except BaseException as e:  # reported by the parent, which raises
        import traceback

        out_q.put((rank, "err", f"{type(e).__name__}: {e}\n"
                                f"{traceback.format_exc()}"))


def dryrun_multichip(n_devices: int, device=None) -> None:
    import multiprocessing as mp

    import torch

    from minbpe_tpu_torch.base import resolve_device
    from minbpe_tpu_torch.parallel.multihost import free_port

    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    backend = ("nccl" if cuda and n_devices <= torch.cuda.device_count()
               else "gloo")
    ctx = mp.get_context("spawn")
    out_q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, n_devices, port, backend, dev.type, out_q))
             for r in range(n_devices)]
    for p in procs:
        p.start()
    results = {}
    try:
        deadline = time.monotonic() + 3 * TIMEOUT_S
        while len(results) < n_devices:
            left = deadline - time.monotonic()
            if left <= 0:
                missing = sorted(set(range(n_devices)) - set(results))
                raise TimeoutError(f"ranks {missing} did not finish in "
                                   f"{3 * TIMEOUT_S} s")
            try:
                rank, status, res = out_q.get(timeout=min(left, 5))
            except queue.Empty:  # see whether a rank died
                dead = [r for r, p in enumerate(procs)
                        if not p.is_alive() and r not in results]
                if dead and out_q.empty():
                    raise RuntimeError(f"ranks {dead} exited without a "
                                       "result")
                continue
            if status != "ok":
                raise RuntimeError(f"dryrun rank {rank} failed: {res}")
            results[rank] = res
    finally:
        for p in procs:
            p.join(30)
            if p.is_alive():
                p.kill()
                p.join()
    r0 = results[0]
    assert all(results[r] == r0 for r in results), "ranks disagree"
    print(f"dryrun_multichip({n_devices}): ok, {NUM_MERGES} merges learned "
          f"over {n_devices} {backend} ranks on {dev.type} (dense/sparse/"
          f"owner selection all agree; stepped trainer and sharded encode "
          f"verified); first merge {r0['first_merge']} x{r0['first_count']}"
          f"; encoded {r0['encoded']} tokens sharded")


if __name__ == "__main__":
    import torch

    fn, args = entry()
    out_ids, out_n = fn(*args)
    print("entry(): ok,", int(out_n), "tokens")
    dryrun_multichip(torch.cuda.device_count())
