"""Incremental-count training: one dense count matrix, kept up to date round
by round, over a tombstone chain instead of a compacted stream.

The port's counterpart of minbpe_tpu/ops/train_inc.py (:46-231). A merge of
(a, b) changes pair counts only around its sites, so each round:
- selects the pair from the V x V count matrix: the argmax alone when one
  pair holds the largest count, else the first live position whose pair
  holds it (chain order is corpus order, so that is the first occurrence);
- marks the kept sites on the chain, left first within each run of
  matches, by chain positions (one cumsum of the live mask);
- subtracts the pairs the merge destroys and adds the pairs it creates,
  with two scatter-adds into the matrix;
- relabels each kept site and unlinks its partner (live, nxt, prv).
The first count is K9 ``pair_count`` on the card (its plain version on the
CPU), the same function as minbpe_tpu's ``count_pairs_dense``.

JAX runs ``_round`` under ``lax.cond`` inside one program. Here the host
enqueues the rounds and nothing is read back per round: both picks are
computed and ``torch.where`` chooses, a round that finds no pair works on
the pair (-1, -1), which matches nothing, and the fail round, pairs and
counts stay on the device (ops/rounds.py drives the rounds). The count
matrix is updated in place (JAX makes a new one each round); the chain
arrays are replaced.

Two loops share the rounds: ``train_merges_incremental`` (the whole run,
the fail round read once per ROUNDS_PER_SYNC rounds) and
``train_merges_stepped`` (steps of ``unroll`` rounds, the fail round read
once per STEPS_PER_SYNC steps, with progress calls and resumable
checkpoints at the same rounds as minbpe_tpu's).
"""

from __future__ import annotations

import torch

from .. import kernels
from .rounds import RunLog, resume, run_rounds, stream
from .train import check_device_memory

UNROLL = 8
STEPS_PER_SYNC = 8
ROUNDS_PER_SYNC = UNROLL * STEPS_PER_SYNC
# device bytes at a round's peak: the chain (ids, seg, live, nxt, prv) and
# a round's ~25 temporaries of 1-8 bytes per token; the count matrix, its
# tie mask and the reductions over it per entry
BYTES_PER_TOKEN = 128
BYTES_PER_ENTRY = 10


def device_bytes(n_tokens: int, V: int) -> int:
    return BYTES_PER_TOKEN * n_tokens + BYTES_PER_ENTRY * V * V


class Chain(RunLog):
    """A tombstone chain over the stream and a run's log, on the stream's
    device: ids, live, nxt[p] (N past the last live token), prv[p] (-1
    before the first). The stepped trainer's and the sparse trainer's
    (ops/train_sparse.py) state."""

    def __init__(self, ids, seg, n, M: int):
        super().__init__(M, ids.device)
        N = ids.numel()
        self.N = N
        self.idx = torch.arange(N, dtype=torch.int32, device=ids.device)
        self.ids, self.seg = ids, seg
        self.live = self.idx < n
        self.nxt = torch.where(self.idx + 1 < n, self.idx + 1, N)
        self.prv = self.idx - 1

    def next_of(self, x, j, fill):
        """x[j] where j < N, else fill."""
        return torch.where(j < self.N,
                           x.gather(0, j.clamp(max=self.N - 1).long()), fill)

    def pair_keys(self, ids, live, nxt):
        """(b, valid): each live token's right partner on the chain, and
        whether the two form a countable pair (one segment)."""
        b = self.next_of(ids, nxt, -1)
        valid = live & (nxt < self.N) & (self.seg == self.next_of(
            self.seg, nxt, -2))
        return b, valid


class _State(Chain):
    """The chain and the V x V count matrix."""

    def __init__(self, ids, seg, n, V: int, M: int):
        super().__init__(ids, seg, n, M)
        self.V = V
        self.counts = kernels.pair_count(ids, seg, n, V).view(-1)
        # a masked position's scatter-add adds 0 at an entry of its own, so
        # no one address takes them all
        self.spread = self.idx.long() % (V * V)

    def add_counts(self, mask, a, b, sign: int):
        V = self.V
        key = torch.where(mask, a.long() * V + b.long(), self.spread)
        self.counts.index_add_(0, key, mask.to(torch.int32) * sign)


def chain_merge(st, valid, b_all, pa, pb, new_id: int):
    """The merge of (pa, pb) into new_id on the chain st (ids, live, nxt,
    prv), whose pairs are (b_all, valid) (minbpe_tpu/ops/train_inc.py:
    91-127; ops/train_sparse.py's round is the same). Returns rem (the
    positions whose pair the merge destroys), keep (the kept sites), the
    new chain (ids, live, nxt, prv), and its pairs (b_post, valid_post)
    with add, the positions whose pair the merge creates."""
    ids, live, nxt, prv = st.ids, st.live, st.nxt, st.prv
    # match and left-first parity on the chain
    has_prv = prv >= 0
    pc = prv.clamp(min=0).long()
    m = valid & (ids == pa) & (b_all == pb)
    new_run = m & ~(has_prv & m[pc])
    chainpos = torch.cumsum(live, 0, dtype=torch.int32)
    # each match's run start, as minbpe_tpu's cummax of the start indices:
    # runs numbered by a cumsum of their starts, each start's chain
    # position written to its run's slot (other positions to slots of
    # their own past N). A 1-D cumsum is one parallel scan on the card,
    # where cummax runs in a single block.
    run = torch.cumsum(new_run, 0, dtype=torch.int32)
    slot = torch.where(new_run, run, st.N + 1 + st.idx).long()
    cp_start = torch.zeros(2 * st.N + 1, dtype=torch.int32,
                           device=ids.device).scatter_(0, slot, chainpos)
    keep = m & (((chainpos - cp_start.gather(0, run.long())) & 1) == 0)

    # the pair slots the merge relabels or consumes
    keep_at_prv = has_prv & keep[pc]
    changed = keep | keep_at_prv
    rem = valid & (changed | st.next_of(changed, nxt, False))

    # relink. A live token's prv and nxt are its chain neighbours, so the
    # tokens a kept site consumes are exactly the live tokens whose prv is
    # kept, and the token after a consumed one now follows the kept site:
    # elementwise forms of minbpe_tpu's two scatters on the live tokens (a
    # dead token's prv is never read for a live pair)
    new_ids = torch.where(keep, new_id, ids)
    new_live = live & ~keep_at_prv
    new_nxt = torch.where(keep, st.next_of(nxt, nxt, st.N), nxt)
    consumed = live & keep_at_prv
    new_prv = torch.where(has_prv & consumed[pc], prv[pc], prv)

    # the pair slots the merge creates
    b_post, valid_post = st.pair_keys(new_ids, new_live, new_nxt)
    add = valid_post & (keep | st.next_of(keep, new_nxt, False))
    return (rem, keep, (new_ids, new_live, new_nxt, new_prv),
            (b_post, valid_post, add))


def _round(st: _State, i: int):
    """Merge round i (minbpe_tpu/ops/train_inc.py:46-131)."""
    if st.N < 2:  # no pair at all: the round fails
        st.fail = st.fail.clamp(max=i)
        return
    V = st.V
    ids, live, nxt = st.ids, st.live, st.nxt
    maxc = st.counts.max().reshape(1)
    tied = st.counts == maxc
    b_all, valid = st.pair_keys(ids, live, nxt)

    # the unique argmax and the first tied position, both computed
    flat = torch.argmax(st.counts).reshape(1)
    hit = valid & tied[ids.clamp(0, V - 1).long() * V
                       + b_all.clamp(0, V - 1).long()]
    first = torch.argmax(hit.to(torch.int32)).reshape(1)
    unique = tied.sum() == 1
    pa = torch.where(unique, flat // V, ids.gather(0, first))
    pb = torch.where(unique, flat % V, b_all.gather(0, first))
    ok = (maxc > 0) & (st.fail >= i)
    pa = torch.where(ok, pa, -1).to(torch.int32)
    pb = torch.where(ok, pb, -1).to(torch.int32)

    rem, _, chain, (b_post, _, add) = chain_merge(st, valid, b_all, pa, pb,
                                                  256 + i)
    st.add_counts(rem, ids, b_all, -1)
    st.add_counts(add, chain[0], b_post, 1)
    st.ids, st.live, st.nxt, st.prv = chain
    st.pairs[i] = torch.where(ok, torch.cat([pa, pb]), st.pairs[i])
    st.cnts[i:i + 1] = torch.where(ok, maxc, st.cnts[i:i + 1])
    st.fail = torch.where(maxc > 0, st.fail, st.fail.clamp(max=i))


def _check(ids, num_merges: int):
    if ids.is_cuda:
        N, V = ids.numel(), 256 + num_merges
        check_device_memory(ids.device, device_bytes(N, V),
                            f"the stepped trainer on {N} tokens at vocab {V}")


def train_merges_incremental(ids, seg, num_merges: int):
    """The whole run, round after round. Same contract as
    ops.train.train_merges: numpy (pairs[M, 2], counts[M]) and the fail
    round."""
    _check(ids, num_merges)
    st = _State(*stream(ids, seg), 256 + num_merges, num_merges)
    return run_rounds(st, _round, unroll=ROUNDS_PER_SYNC, steps_per_sync=1)


def train_merges_stepped(ids, seg, num_merges: int, unroll: int = UNROLL,
                         checkpoint_path: str | None = None,
                         checkpoint_every: int | None = None,
                         resume_from: str | None = None,
                         progress=None, fingerprint: str | None = None):
    """Steps of ``unroll`` rounds; bit-identical to
    train_merges_incremental, with progress calls, checkpoints and resume
    as ops/rounds.run_rounds and resume make them (minbpe_tpu's rounds and
    format)."""
    _check(ids, num_merges)
    ids, seg, n, prefix = resume(ids, seg, num_merges, resume_from,
                                 checkpoint_path, fingerprint)
    st = _State(ids, seg, n, 256 + num_merges, num_merges)
    return run_rounds(st, _round, unroll=unroll,
                      steps_per_sync=STEPS_PER_SYNC, prefix=prefix,
                      progress=progress, checkpoint_path=checkpoint_path,
                      checkpoint_every=checkpoint_every,
                      fingerprint=fingerprint)
