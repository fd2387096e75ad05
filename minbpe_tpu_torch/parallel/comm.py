"""The collectives of the distributed layer over one torch.distributed group.

The port's counterpart of the ``shard_map`` collectives that
minbpe_tpu/parallel uses (``jax.lax.psum``, ``pmin``, ``all_gather``,
``all_to_all``, ``axis_index``). A ``Comm`` wraps one process group: its
rank, its world size, its backend and the device of this rank's tensors.
Every collective takes and returns tensors on that device and enqueues on
its stream; with NCCL none of them waits for the host.

The backend is fixed when the wrapper is made, and the wrapper never
switches backend or device when a call fails: the error propagates. NCCL
takes CUDA tensors; gloo takes every collective used here on CUDA tensors
too (PyTorch 2.11 on the H100: all-reduce sum and min, all-gather,
all-to-all, broadcast) and copies them through host memory itself, which
syncs the stream; so the wrapper stages nothing.

The group must have been made with a ``timeout``
(``init_process_group(..., timeout=...)`` or ``multihost.initialize``), so a
peer that hangs raises instead of blocking.

Each collective is a span ``comm.<collective>`` and counts ``comm.calls``
(trace.py).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from .. import trace

def default_device(group=None) -> torch.device:
    """cuda:<local rank % device count> (LOCAL_RANK, as torchrun sets it,
    else the group rank); raises without CUDA."""
    if not torch.cuda.is_available():
        raise RuntimeError("the distributed layer runs on CUDA by default; "
                           "pass device='cpu' for its plain versions")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank(group)))
    return torch.device("cuda", local % torch.cuda.device_count())


class Comm:
    """One process group's collectives on this rank's ``device``."""

    def __init__(self, group=None, device=None):
        if not dist.is_available() or not dist.is_initialized():
            raise RuntimeError("no process group is initialised: call "
                               "torch.distributed.init_process_group (or "
                               "parallel.multihost.initialize) first")
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.backend = dist.get_backend(group)
        self.device = (default_device(group) if device is None
                       else torch.device(device))
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())

    @staticmethod
    def _run(name, fn, *tensors):
        trace.count("comm.calls")
        with trace.span(name):
            fn(*tensors)

    # -- collectives --------------------------------------------------------
    def sum_(self, t):
        """psum, in place."""
        self._run("comm.sum", lambda x: dist.all_reduce(
            x, dist.ReduceOp.SUM, group=self.group), t)
        return t

    def min_(self, t):
        """pmin, in place."""
        self._run("comm.min", lambda x: dist.all_reduce(
            x, dist.ReduceOp.MIN, group=self.group), t)
        return t

    def max_(self, t):
        self._run("comm.max", lambda x: dist.all_reduce(
            x, dist.ReduceOp.MAX, group=self.group), t)
        return t

    def all_gather(self, t):
        """(size, *t.shape): every rank's t in rank order."""
        t = t.contiguous()
        out = torch.empty((self.size, *t.shape), dtype=t.dtype,
                          device=t.device)
        self._run("comm.all_gather", lambda o, x: dist.all_gather(
            list(o.unbind(0)), x, group=self.group), out, t)
        return out

    def all_to_all(self, t):
        """t of shape (size, ...): row j goes to rank j; returns the rows
        received, row j from rank j."""
        t = t.contiguous()
        out = torch.empty_like(t)
        self._run("comm.all_to_all", lambda o, x: dist.all_to_all_single(
            o, x, group=self.group), out, t)
        return out

    def broadcast_(self, t, src: int):
        """t from group rank src, in place."""
        gsrc = src if self.group is None else dist.get_global_rank(
            self.group, src)
        self._run("comm.broadcast", lambda x: dist.broadcast(
            x, gsrc, group=self.group), t)
        return t

    def gather_varlen(self, t):
        """Every rank's 1-D t, of any length, concatenated in rank order
        (on every rank): the lengths are gathered first (read on the host),
        then every t padded to the longest."""
        n = torch.tensor([t.numel()], dtype=torch.int64, device=t.device)
        lens = self.all_gather(n).view(-1).tolist()
        longest = max(lens)
        if longest == 0:
            return t[:0]
        pad = torch.zeros(longest, dtype=t.dtype, device=t.device)
        pad[:t.numel()] = t
        rows = self.all_gather(pad)
        return torch.cat([rows[j, :k] for j, k in enumerate(lens)])
