"""Sparse slot-table training: incremental counts at any vocab, with no
V x V matrix and no sort after the first count.

The port's counterpart of minbpe_tpu/ops/train_sparse.py (:52-310), which
is plain ``jnp`` with no Pallas kernel behind it: here it is plain PyTorch
on either device. Every pair a round creates holds that round's new id c =
256 + i, so a key enters the count structure in one round at most, and the
structure is an append-only slot table:
- ta, tb, tc [P]: pair keys and exact counts in creation order, never
  moved (P = ``table_capacity``: 3N can never overflow);
- p2s [N]: for each live position, the slot of the pair starting there
  (P where none starts);
- a round subtracts the pairs the merge destroys through p2s, dedups the
  pairs it creates with two dense [V] vectors (left keys (x, c) by x, right
  keys (c, y) by y, which owns (c, c)), appends them in one scatter and
  points p2s at them;
- selection is max(tc): the one slot holding it where it is unique, else
  the first live position whose pair holds it (chain order is corpus
  order, so that is the earliest first occurrence). The order of the slots
  never reaches the output.
The first count is one stable torch.sort of the 64-bit pair keys, as
minbpe_tpu's ``_init_state`` (:68-107).

The chain and the merge on it are the stepped trainer's
(ops/train_inc.py ``Chain``, ``chain_merge``), and so is the structure:
JAX's ``lax.cond`` becomes ``torch.where``, a round that finds no pair
works on (-1, -1), which matches nothing, and nothing is read back per
round. The host reads the fail round once per ROUNDS_PER_SYNC rounds (the
whole run, select_mode "sparse_inc") or once per STEPS_PER_SYNC steps of
``unroll`` rounds ("sparse", with progress calls and checkpoints at
minbpe_tpu's rounds). A run whose appends pass ``capacity`` raises at its
end, where minbpe_tpu drops the writes and returns what follows from that.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import checkpoint as ckpt
from .merge import apply_merge
from .select import INF_KEY, pair_runs
from .train import check_device_memory
from .train_inc import Chain, chain_merge

UNROLL = 16
STEPS_PER_SYNC = 8
ROUNDS_PER_SYNC = UNROLL * STEPS_PER_SYNC
# device bytes at a round's peak: the chain and p2s, and a round's ~25
# temporaries of 1-8 bytes per token (as the stepped trainer's); ta, tb
# and tc per slot
BYTES_PER_TOKEN = 132
BYTES_PER_SLOT = 12


def table_capacity(N: int) -> int:
    """Slots for an N-token stream: at most N pairs at the start, and each
    merge site appends at most 2 keys and consumes a token, so 3N never
    overflows; padded to 128 (minbpe_tpu's lane width)."""
    return -(-3 * max(N, 1) // 128) * 128


def device_bytes(n_tokens: int, capacity: int) -> int:
    return BYTES_PER_TOKEN * n_tokens + BYTES_PER_SLOT * capacity


class _State(Chain):
    """The chain, the slot table and p2s. ta, tb, tc hold P + 1 slots: the
    last takes the writes minbpe_tpu drops, and is never read."""

    def __init__(self, ids, seg, n, V: int, M: int, P: int):
        super().__init__(ids, seg, n, M)
        N, dev = self.N, ids.device
        self.V, self.P = V, P
        skey, spos, is_head, cnt, _ = pair_runs(ids, seg, n)
        svalid = skey != INF_KEY
        # slots in key order; every valid sorted element takes its run's
        # slot, which is its rank among the heads (invalid ones sort last)
        rank = torch.cumsum(is_head, 0) - 1
        slot_at = torch.where(is_head, rank, P).clamp(max=P)
        self.ta = torch.zeros(P + 1, dtype=torch.int32, device=dev)
        self.tb = torch.zeros(P + 1, dtype=torch.int32, device=dev)
        self.tc = torch.zeros(P + 1, dtype=torch.int32, device=dev)
        self.ta.scatter_(0, slot_at, (skey >> 32).to(torch.int32))
        self.tb.scatter_(0, slot_at, skey.to(torch.int32))
        self.tc.scatter_(0, slot_at, cnt.to(torch.int32))
        self.tc[P] = 0
        self.size = is_head.sum().reshape(1).to(torch.int32)
        # spos is a permutation: every position gets its pair's slot, or P
        self.p2s = torch.empty(N, dtype=torch.int32, device=dev).scatter_(
            0, spos, torch.where(svalid, rank, P).clamp(max=P).to(
                torch.int32))
        # masked scatter-adds add 0 at an entry of their own
        self.spread = self.idx.long() % P
        self.spread_v = self.idx.long() % V
        self.vr = torch.arange(V, dtype=torch.int32, device=dev)

    def result(self):
        size = int(self.size)
        if size > self.P:
            raise RuntimeError(f"the slot table needs {size} slots, its "
                               f"capacity is {self.P}")
        return super().result()


def _round(st: _State, i: int):
    """Merge round i (minbpe_tpu/ops/train_sparse.py:110-246)."""
    if st.N < 2:  # no pair at all: the round fails
        st.fail = st.fail.clamp(max=i)
        return
    V, P = st.V, st.P
    ids = st.ids
    b_all, valid = st.pair_keys(ids, st.live, st.nxt)

    # selection: the unique argmax of tc, or the first tied position
    tc = st.tc[:P]
    maxc = tc.max().reshape(1)
    unique = (tc == maxc).sum() == 1
    flat = torch.argmax(tc).reshape(1)
    hit = valid & (st.tc.gather(0, st.p2s.long()) == maxc)
    first = torch.argmax(hit.to(torch.int32)).reshape(1)
    pa = torch.where(unique, st.ta.gather(0, flat), ids.gather(0, first))
    pb = torch.where(unique, st.tb.gather(0, flat), b_all.gather(0, first))
    ok = (maxc > 0) & (st.fail >= i)
    pa = torch.where(ok, pa, -1)
    pb = torch.where(ok, pb, -1)

    c_id = 256 + i
    rem, keep, chain, (b_post, valid_post, add) = chain_merge(
        st, valid, b_all, pa, pb, c_id)
    # the destroyed pairs' slots, through p2s (before the merge)
    st.tc.index_add_(0, torch.where(rem, st.p2s.long(), st.spread),
                     -rem.to(torch.int32))

    # the created keys all hold c_id, so all are new: dedup per side
    add_right = add & keep
    add_left = add & ~keep
    yb = b_post.clamp(0, V - 1).long()
    xa = ids.clamp(0, V - 1).long()
    right_cnt = torch.zeros(V, dtype=torch.int32, device=ids.device)
    right_cnt.index_add_(0, torch.where(add_right, yb, st.spread_v),
                         add_right.to(torch.int32))
    left_cnt = torch.zeros(V, dtype=torch.int32, device=ids.device)
    left_cnt.index_add_(0, torch.where(add_left, xa, st.spread_v),
                        add_left.to(torch.int32))
    left_nz, right_nz = left_cnt > 0, right_cnt > 0
    left_rank = torch.cumsum(left_nz, 0, dtype=torch.int32) - 1
    right_rank = torch.cumsum(right_nz, 0, dtype=torch.int32) - 1
    n_left = left_rank[V - 1:] + 1
    n_right = right_rank[V - 1:] + 1
    left_slot = torch.where(left_nz, st.size + left_rank, P).clamp(max=P)
    right_slot = torch.where(right_nz, st.size + n_left + right_rank,
                             P).clamp(max=P)
    ls, rs = left_slot.long(), right_slot.long()
    st.ta.scatter_(0, ls, st.vr).scatter_(0, rs, torch.full_like(
        st.vr, c_id))
    st.tb.scatter_(0, ls, torch.full_like(st.vr, c_id)).scatter_(
        0, rs, st.vr)
    st.tc.scatter_(0, ls, left_cnt).scatter_(0, rs, right_cnt)
    st.tc[P:] = 0

    # p2s: the created pairs' positions take the appended slots
    st.p2s = torch.where(
        ~valid_post, P, torch.where(
            add_right, right_slot.gather(0, yb), torch.where(
                add_left, left_slot.gather(0, xa), st.p2s)))
    st.size = st.size + n_left + n_right

    st.ids, st.live, st.nxt, st.prv = chain
    st.pairs[i] = torch.where(ok, torch.cat([pa, pb]), st.pairs[i])
    st.cnts[i:i + 1] = torch.where(ok, maxc, st.cnts[i:i + 1])
    st.fail = torch.where(maxc > 0, st.fail, st.fail.clamp(max=i))


def _capacity(ids, capacity) -> int:
    """The slot table's size, checked against the device's memory."""
    N = ids.numel()
    P = capacity if capacity is not None else table_capacity(N)
    if P < 1:
        raise ValueError(f"capacity {P}: the slot table needs at least one "
                         "slot")
    if ids.is_cuda:
        check_device_memory(ids.device, device_bytes(N, P),
                            f"the sparse trainer on {N} tokens with {P} "
                            f"slots ({BYTES_PER_TOKEN} B/token, "
                            f"{BYTES_PER_SLOT} B/slot)")
    return P


def _n(ids):
    # filled on the device: a host tensor copied there would sync
    return torch.full((1,), ids.numel(), dtype=torch.int32,
                      device=ids.device)


def train_merges_sparse(ids, seg, num_merges: int,
                        capacity: int | None = None):
    """The whole run. Same contract as ops.train.train_merges: numpy
    (pairs[M, 2], counts[M]) and the fail round. ``capacity``: the slot
    table's size (``table_capacity`` by default)."""
    M = num_merges
    P = _capacity(ids, capacity)
    ids, seg = ids.contiguous(), seg.contiguous()
    st = _State(ids, seg, _n(ids), 256 + M, M, P)
    for g in range(0, M, ROUNDS_PER_SYNC):
        for i in range(g, min(g + ROUNDS_PER_SYNC, M)):
            _round(st, i)
        if int(st.fail) < M:  # the group's one sync
            break
    return st.result()


def train_merges_sparse_stepped(ids, seg, num_merges: int,
                                unroll: int = UNROLL,
                                capacity: int | None = None,
                                checkpoint_path: str | None = None,
                                checkpoint_every: int | None = None,
                                resume_from: str | None = None,
                                progress=None,
                                fingerprint: str | None = None):
    """Steps of ``unroll`` rounds; bit-identical to train_merges_sparse,
    with progress calls, checkpoints and resume as
    ops/train_inc.train_merges_stepped (the same rounds and format as
    minbpe_tpu's, :270-310)."""
    if (checkpoint_path is not None or resume_from is not None) \
            and fingerprint is None:
        raise ValueError("checkpoint_path and resume_from need the corpus "
                         "fingerprint")
    M = num_merges
    P = _capacity(ids, capacity)
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

    st = _State(ids, seg, n, 256 + M, M, P)
    if prefill is not None:
        st.pairs[:start] = prefill[0]
        st.cnts[:start] = prefill[1]

    stopped = False
    for step, i0 in enumerate(range(start, M, unroll)):
        done = min(i0 + unroll, M)
        if not stopped:
            for i in range(i0, done):
                _round(st, i)
        if progress is not None:
            progress(done, M)
        if (checkpoint_path is not None and checkpoint_every
                and (done % checkpoint_every == 0 or done >= M) and done < M):
            ckpt.save(checkpoint_path, st.pairs.cpu().numpy(),
                      st.cnts.cpu().numpy(), done, M, fingerprint)
        if not stopped and (step + 1) % STEPS_PER_SYNC == 0:
            stopped = int(st.fail) < M  # one sync per STEPS_PER_SYNC steps
    return st.result()
