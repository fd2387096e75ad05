"""Sort-round training: every round counts all pairs of the live stream,
takes the reference's pair, applies it and compacts. No V-dependent memory
or work, so any vocab trains, and no count structure outlives a round.

The port's counterpart of minbpe_tpu/ops/train_sortloop.py (:49-190).
minbpe_tpu groups equal pairs with one stable ``lax.sort`` of (a, b,
position) a round: run lengths are the counts, run heads the first
occurrences, and the reference's pair is the largest count, then the
earliest first occurrence (minbpe/basic.py:35, base.py:20-21). Here a round
is three launches on the card, and nothing is read back to the host:
- K13 ``pair_select`` counts every pair, with its first position, into a
  device hash table (kernels.PairTable, sized once per run), takes the
  pair, writes the round's log row and the fail round under the gate
  fail >= i, and leaves the table empty; a round that finds no pair gives
  (-1, -1), which merges nowhere (ops/train_select.py does the same);
- K3 ``merge_apply`` applies it, left first, and K4 ``compact`` compacts.
On the CPU the three are their plain versions.

minbpe_tpu keeps the stream uncompacted, with tombstones, and finds each
token's next live neighbour and the left-first parity with blocked
select-scans over (R, 128) planes (``_pad_to_planes``, ops/scan2d.py),
because XLA's gathers serialise on the TPU. The port compacts after every
merge instead, as its other routes do, so a token's neighbours are the
adjacent positions: ops/scan2d.py is TPU layout and has no counterpart
here (its other user, the flat encoder, was ported without it too).

Two loops: ``train_merges_sortloop`` (the whole run, select_mode
"sortloop_inc": the host reads the fail round once per ROUNDS_PER_SYNC
rounds) and ``train_merges_sortloop_stepped`` ("sortloop", the route
"auto" takes above vocab 2048, above 4·2^20 tokens with a checkpoint or
progress option, and above 48·2^20 tokens: steps of ``unroll`` rounds,
with progress calls and checkpoints at minbpe_tpu's rounds).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..utils import checkpoint as ckpt
from .merge import apply_merge
from .train import check_device_memory

UNROLL = 256
ROUNDS_PER_SYNC = 64
# device bytes per stream token at a round's peak: ids and seg (8), K3's
# merged ids and live mask (5), K4's compacted ids and seg (8), and the
# caller's stream (8); the table's slots come on top
BYTES_PER_TOKEN = 29


def device_bytes(n_tokens: int) -> int:
    return (BYTES_PER_TOKEN * n_tokens
            + kernels.PairTable.device_bytes(n_tokens))


class _State:
    """The compacted stream, the table and the run's log, on the stream's
    device: sel = (pa, pb, count, ok) of the last round."""

    def __init__(self, ids, seg, n, M: int):
        dev = ids.device
        self.ids, self.seg, self.n, self.M = ids, seg, n, M
        self.table = kernels.PairTable(ids.numel(), dev)
        self.sel = torch.zeros(4, dtype=torch.int32, device=dev)
        self.pairs = torch.zeros((M, 2), dtype=torch.int32, device=dev)
        self.cnts = torch.zeros((M,), dtype=torch.int32, device=dev)
        self.fail = torch.full((1,), M, dtype=torch.int32, device=dev)

    def result(self):
        M = self.M
        out = torch.cat([self.pairs.view(-1), self.cnts,
                         self.fail]).cpu().numpy()
        return (out[:2 * M].reshape(M, 2).copy(), out[2 * M:3 * M].copy(),
                min(int(out[-1]), M))


def _round(st: _State, i: int):
    """Merge round i (minbpe_tpu/ops/train_sortloop.py:49-103)."""
    kernels.pair_select(st.ids, st.seg, st.n, st.table, st.sel, st.pairs,
                        st.cnts, st.fail, i)
    merged, live = kernels.merge_apply(st.ids, st.seg, st.n, st.sel,
                                       256 + i)
    st.ids, st.seg, st.n = kernels.compact(merged, st.seg, live, st.n)


def _check(ids, num_merges: int):
    if ids.is_cuda:
        N = ids.numel()
        check_device_memory(ids.device, device_bytes(N),
                            f"the sort-round trainer on {N} tokens "
                            f"({BYTES_PER_TOKEN} B/token and "
                            f"{kernels.PairTable.BYTES_PER_SLOT} B per "
                            "table slot)")


def _n(ids):
    # filled on the device: a host tensor copied there would sync
    return torch.full((1,), ids.numel(), dtype=torch.int32,
                      device=ids.device)


def train_merges_sortloop(ids, seg, num_merges: int):
    """The whole run. Same contract as ops.train.train_merges: numpy
    (pairs[M, 2], counts[M]) and the fail round (M when every round found
    a pair; rows from it on are zero)."""
    M = num_merges
    if M == 0 or ids.numel() < 2:  # nothing to learn, or no pair at all
        return np.zeros((M, 2), np.int32), np.zeros((M,), np.int32), 0
    _check(ids, M)
    ids, seg = ids.contiguous(), seg.contiguous()
    st = _State(ids, seg, _n(ids), M)
    for g in range(0, M, ROUNDS_PER_SYNC):
        for i in range(g, min(g + ROUNDS_PER_SYNC, M)):
            _round(st, i)
        if int(st.fail) < M:  # the group's one sync
            break
    return st.result()


def train_merges_sortloop_stepped(ids, seg, num_merges: int,
                                  unroll: int = UNROLL,
                                  checkpoint_path: str | None = None,
                                  checkpoint_every: int | None = None,
                                  resume_from: str | None = None,
                                  progress=None,
                                  fingerprint: str | None = None):
    """Steps of ``unroll`` rounds; bit-identical to train_merges_sortloop.
    After each step it calls ``progress(done_rounds, total)`` and, every
    ``checkpoint_every`` rounds before the last, writes a checkpoint to
    ``checkpoint_path`` (minbpe_tpu's rounds and order, :176-190);
    ``resume_from`` replays a checkpoint's merges onto the stream (K3 and
    K4 on the card) and goes on from its round. Checkpoints carry
    ``fingerprint``, the corpus's (utils/checkpoint.py), which a caller
    that checkpoints or resumes must give."""
    if (checkpoint_path is not None or resume_from is not None) \
            and fingerprint is None:
        raise ValueError("checkpoint_path and resume_from need the corpus "
                         "fingerprint")
    M = num_merges
    _check(ids, M)
    dev = ids.device
    ids, seg = ids.contiguous(), seg.contiguous()
    n = _n(ids)

    start = 0
    prefill = None
    if resume_from is not None:
        c = ckpt.load(resume_from)
        if c["fingerprint"] != fingerprint:
            raise ValueError("checkpoint does not match this corpus")
        if c["num_merges"] != M:
            raise ValueError(
                f"checkpoint trained toward {c['num_merges']} merges, "
                f"requested {M}")
        start = c["round_idx"]
        prefill = [torch.from_numpy(np.ascontiguousarray(c[k], np.int32)).to(
            dev) for k in ("pairs", "counts")]
        # deterministic replay of the merge prefix onto the stream
        for i in range(start):
            ids, seg, n, _ = apply_merge(ids, seg, n, prefill[0][i], 256 + i)

    st = _State(ids, seg, n, M)
    if prefill is not None:
        st.pairs[:start] = prefill[0]
        st.cnts[:start] = prefill[1]

    stopped = False
    for i0 in range(start, M, unroll):
        done = i0 + min(unroll, M - i0)
        if not stopped:
            for i in range(i0, done):
                _round(st, i)
        if progress is not None:
            progress(done, M)
        if (checkpoint_path is not None and checkpoint_every
                and (done % checkpoint_every == 0 or done >= M) and done < M):
            ckpt.save(checkpoint_path, st.pairs.cpu().numpy(),
                      st.cnts.cpu().numpy(), done, M, fingerprint)
        if not stopped:
            stopped = int(st.fail) < M  # the step's one sync
    return st.result()
