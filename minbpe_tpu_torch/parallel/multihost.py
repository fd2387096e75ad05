"""Process-group set-up and per-rank input feeding.

The port of minbpe_tpu/parallel/multihost.py. A multi-node run is the same
program as a single-node one (parallel/train.py) with one rank per GPU;
only the set-up and the input feeding differ:

    # torchrun --nnodes N --nproc-per-node G script.py, on every node
    from minbpe_tpu_torch.parallel import multihost
    multihost.initialize()                 # NCCL, from torchrun's env
    # small corpora: every rank holds all chunks
    merges, vocab = multihost.train_chunks_global(chunks, 100_000 - 256)
    # large corpora: every rank holds only its own slice of the corpus
    merges, vocab = multihost.train_local_chunks_global(
        my_chunks, 100_000 - 256, shard_capacity=cap)

Exactness across ranks holds as in JAX's: selection combines global counts
and first positions ``rank * shard_capacity + local index``, a monotone
relabelling of corpus order, and each rank's segment ids are offset into a
block of its own (``SEG_BLOCK``) so chunks never alias across ranks. Where
a JAX process feeds its ``local_device_count`` devices, a rank here holds
one.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from ..ops.stream import PAD, PAD_SEG, bucket_capacity
from .comm import Comm
from .train import _finish_train, _run_shard, _train, shard_chunks

# per-rank segment-id block: a rank's chunk count stays below this
SEG_BLOCK = 1 << 24
# every group is made with a timeout, so a hung peer raises
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


def initialize(backend: str | None = None,
               timeout: datetime.timedelta = DEFAULT_TIMEOUT, **kwargs):
    """``torch.distributed.init_process_group`` from the environment
    (RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT, which torchrun sets):
    NCCL where CUDA is available, else gloo, with a timeout. Only the
    already-initialised case is let pass; a real failure (an unreachable
    master, a timeout) propagates."""
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kwargs.setdefault("init_method", "env://")
    if backend == "nccl" and "device_id" not in kwargs:
        local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", 0)))
        kwargs["device_id"] = torch.device(
            "cuda", local % torch.cuda.device_count())
    try:
        dist.init_process_group(backend=backend, timeout=timeout, **kwargs)
    except (RuntimeError, ValueError) as e:
        if "already" in str(e).lower():
            return  # initialised meanwhile in this process: benign
        raise


def free_port() -> int:
    """A free TCP port on localhost, for the init_method of a group whose
    ranks all run on this host."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def global_group():
    """The default group, every rank of the job (JAX's global_mesh);
    raises where none is initialised."""
    if not dist.is_initialized():
        raise RuntimeError("no process group is initialised: call "
                           "multihost.initialize() first")
    return dist.group.WORLD


def train_chunks_global(chunks, num_merges, group=None, verbose=False,
                        selection: str = "dense", *, device=None):
    """Distributed training where every rank holds the whole chunk list
    and takes its own shard of it."""
    comm = Comm(group if group is not None else global_group(), device)
    ids, seg, lens = shard_chunks(chunks, comm.size)
    return _train(ids, seg, lens, num_merges, comm, verbose, selection)


def assemble_global_inputs(local_chunks, shard_capacity: int, group=None):
    """This rank's shard from this rank's chunks alone: (ids[Nl], seg[Nl],
    n) in the agreed ``shard_capacity`` Nl, segment ids offset by rank *
    SEG_BLOCK. ``local_chunks`` is the rank's contiguous slice of the
    corpus in corpus order, slices ordered by rank; every rank passes the
    same ``shard_capacity``."""
    rank = dist.get_rank(group)
    ids, seg, lens = shard_chunks(local_chunks, 1)
    if ids.shape[0] > shard_capacity:
        raise ValueError(
            f"the local shard needs capacity {ids.shape[0]} > agreed "
            f"{shard_capacity}; raise shard_capacity (it must match on "
            "every rank)")
    if len(local_chunks) > SEG_BLOCK:
        raise ValueError(f"{len(local_chunks)} chunks on one rank; at most "
                         f"{SEG_BLOCK}")
    n = int(lens[0])
    ids2 = np.full(shard_capacity, PAD, dtype=np.int32)
    seg2 = np.full(shard_capacity, PAD_SEG, dtype=np.int32)
    ids2[:n] = ids[:n]
    seg2[:n] = seg[:n] + rank * SEG_BLOCK
    return ids2, seg2, n


def train_local_chunks_global(local_chunks, num_merges, group=None,
                              verbose=False, selection: str = "dense",
                              shard_capacity: int | None = None, *,
                              device=None):
    """Distributed training from per-rank corpus slices: each rank feeds
    only its own chunks. ``shard_capacity`` defaults to the largest over
    the ranks of a power-of-two bucket of the rank's bytes plus its longest
    chunk (agreed by a max all-reduce)."""
    comm = Comm(group if group is not None else global_group(), device)
    if shard_capacity is None:
        total = sum(len(c) for c in local_chunks)
        longest = max((len(c) for c in local_chunks), default=1)
        cap = torch.tensor([bucket_capacity(total + longest)],
                           dtype=torch.int64, device=comm.device)
        shard_capacity = int(comm.max_(cap).item())
    ids, seg, n = assemble_global_inputs(local_chunks, shard_capacity,
                                         comm.group)
    pairs, counts, fail, oflow = _run_shard(comm, ids, seg, n,
                                            shard_capacity, num_merges,
                                            selection)
    return _finish_train(pairs, counts, fail, num_merges,
                         verbose and comm.rank == 0, oflow)
