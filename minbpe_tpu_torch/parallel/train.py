"""Data-parallel distributed BPE training over torch.distributed.

The port of minbpe_tpu/parallel/train.py. Each rank of a process group
holds one shard of the corpus on its own device and runs the port's
kernels on it; the merge table is replicated. Results equal minbpe_tpu's
at the same number of shards, and the single-device trainers': the merges,
their counts, the fail round and the overflow errors.

- The layout (``shard_chunks``, ``shard_bytes``) is JAX's, array for
  array: chunks never straddle shards, so on the Regex path no pair
  crosses a shard; on the Basic path (one segment) the pair across a shard
  boundary is counted by its left rank and merged with the global
  left-first parity through a 2-state carry.
- A shard is compacted after every merge (K4) rather than tombstoned, so
  its first live token is index 0, its last n - 1, and the next token the
  adjacent one. Global positions ``rank * Nl + local index`` stay a
  monotone relabelling of corpus order when a shard is compacted, so the
  first-occurrence tie-break picks the pair JAX's tombstoned positions do.
- The halo: each rank receives the first token, and its segment, of the
  nearest later rank that has one (several hops across empty shards) and
  writes it at index n of a buffer of Nl + 1 slots, the extended stream
  (JAX's ``_pair_arrays`` :89-115 in compacted form). The kernels then
  count and merge the boundary pair (n - 1, n) like any other pair, at the
  left token's position.
- Selection, per round: "dense" is K1 ``pair_stats`` on the extended stream
  and a sum and a min all-reduce of the W x W corner (W = 256 + i: counts,
  and first positions + rank * Nl); "sparse" is K16 ``pair_summaries``'s
  count into at most K rows, an all-gather and K16's merge on every rank;
  "owner" routes each rank's rows to the rank ``(a * 1000003 + b) mod D``
  (int32 arithmetic, as JAX's) over an all-to-all of buckets of Kb rows,
  K16's merge at each owner and an all-gather of the D champions. Overflow
  (more than K distinct pairs on a rank, or more than Kb rows in a bucket)
  raises at the end with JAX's message; nothing is truncated silently.
- The apply: K3 at carry-in 0 also writes the transfer bits of the
  boundary pair, the 2 D bits are gathered and composed left to right on
  every rank, and K3 again, gated on the device, redoes the apply from
  carry-in 1 where the left rank's boundary merge took this rank's first
  token; K4 then compacts the first n tokens (the halo slot is never kept:
  its owner drops its own first token).

With NCCL nothing waits for the host between the run's first and last
round: the fail round and the overflow flag stay on the device, and a run
reads back once at the end, as the JAX program is one ``jit``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..ops.stream import PAD, PAD_SEG, bucket_capacity
from ..utils import checkpoint as ck
from .comm import Comm

INT32_MAX = 2**31 - 1
SELECTIONS = ("dense", "sparse", "owner")
# the default per-rank capacity of summary rows (JAX's K cap)
SPARSE_CAP_MAX = 1 << 17
OWNER_MUL = 1000003


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------

def _shard_starts(ends: np.ndarray, n_shards: int) -> list[int]:
    """The first chunk of every shard, then the chunk count: JAX's greedy
    fill (shard_chunks :62-72), a new shard at the first chunk that would
    take a non-empty shard past ceil(total / D) bytes, found by a search
    over the chunk ends."""
    C = len(ends)
    total = int(ends[-1]) if C else 0
    target = max(1, -(-total // n_shards))
    begins = np.concatenate([[0], ends[:-1]]) if C else ends
    first = [0]
    c = 0
    for _ in range(n_shards - 1):
        if c < C:
            base = int(begins[c])
            c = int(np.searchsorted(ends, base + target, side="right"))
            if c < C and int(begins[c]) == base:
                c += 1  # an empty shard takes its first chunk whatever it is
        first.append(min(c, C))
    first.append(C)
    return first


def shard_offsets(data: np.ndarray, ends: np.ndarray, n_shards: int):
    """``shard_chunks`` over a corpus given as its bytes (or byte ids) and
    its chunk ends (the last equal to len(data)); the same arrays."""
    ends = np.asarray(ends, dtype=np.int64)
    data = np.asarray(data)
    first = _shard_starts(ends, n_shards)
    bounds = np.concatenate([[0], ends])[first]
    lens = np.diff(bounds).astype(np.int32)
    Nl = bucket_capacity(int(lens.max()) if len(ends) else 1)
    ids = np.full((n_shards, Nl), PAD, dtype=np.int32)
    seg = np.full((n_shards, Nl), PAD_SEG, dtype=np.int32)
    # a byte's segment is its chunk's index: the chunk ends at or before it
    chunk = np.searchsorted(ends, np.arange(len(data)), side="right")
    for d in range(n_shards):
        lo, hi = int(bounds[d]), int(bounds[d + 1])
        ids[d, :hi - lo] = data[lo:hi]
        seg[d, :hi - lo] = chunk[lo:hi]
    return ids.reshape(-1), seg.reshape(-1), lens


def shard_chunks(chunks: list[bytes], n_shards: int):
    """Pack chunks into n_shards contiguous, chunk-aligned shards
    (minbpe_tpu/parallel/train.py:56-86). Returns (ids[D*Nl], seg[D*Nl],
    lens[D]), Nl the per-shard capacity; chunks keep corpus order and
    shard boundaries fall between chunks."""
    lengths = np.fromiter((len(c) for c in chunks), dtype=np.int64,
                          count=len(chunks))
    data = np.frombuffer(b"".join(chunks), dtype=np.uint8)
    return shard_offsets(data, np.cumsum(lengths), n_shards)


def shard_bytes(data: bytes, n_shards: int):
    """Even byte-level sharding for an unsegmented (Basic) stream
    (minbpe_tpu/parallel/train.py:689-704); the pairs across shards go
    through the halo and the carry."""
    total = len(data)
    per = -(-total // n_shards) if total else 1
    Nl = bucket_capacity(per)
    ids = np.full((n_shards, Nl), PAD, dtype=np.int32)
    seg = np.full((n_shards, Nl), PAD_SEG, dtype=np.int32)
    lens = np.zeros(n_shards, dtype=np.int32)
    arr = np.frombuffer(data, dtype=np.uint8)
    for d in range(n_shards):
        sl = arr[d * per:(d + 1) * per]
        ids[d, :len(sl)] = sl
        seg[d, :len(sl)] = 0
        lens[d] = len(sl)
    return ids.reshape(-1), seg.reshape(-1), lens


def check_positions(n_shards: int, shard_capacity: int):
    """Global positions rank * Nl + local index are int32."""
    if n_shards * shard_capacity >= 1 << 31:
        raise ValueError(f"{n_shards} shards of {shard_capacity} tokens: "
                         "global positions need D * Nl < 2^31")


def _finish_train(pairs, counts, fail, num_merges, verbose, oflow=False):
    """minbpe_tpu/parallel/train.py:707-730."""
    pairs = np.asarray(pairs)
    counts = np.asarray(counts)
    if int(oflow):
        raise RuntimeError(
            "selection capacity overflow: a shard exceeded its distinct-pair "
            "capacity (raise sparse_cap) or an owner bucket overflowed "
            "(raise owner_cap)"
        )
    if int(fail) < num_merges:
        raise ValueError(
            f"no mergeable pair available at merge round {int(fail)}"
        )
    merges: dict[tuple[int, int], int] = {}
    vocab = {i: bytes([i]) for i in range(256)}
    for i in range(num_merges):
        pair = (int(pairs[i, 0]), int(pairs[i, 1]))
        idx = 256 + i
        merges[pair] = idx
        vocab[idx] = vocab[pair[0]] + vocab[pair[1]]
        if verbose:
            print(f"merge {i+1}/{num_merges}: {pair} -> {idx} "
                  f"({vocab[idx]}) had {int(counts[i])} occurrences")
    return merges, vocab


def transfer_bits(tf, halo_ok, n):
    """A rank's transfer function (co0, co1) as int32[2]: whether its
    boundary pair is kept at carry-in 0 and at carry-in 1 (minbpe_tpu's
    _extended_keep :192-226), from K3's transfer bits at carry-in 0 (tf:
    the last pair kept, and its run began at token 0), whether the shard
    has a halo (halo_ok) and its length n (int32[1]). co1 differs from co0
    only where the run of matches from token 0 reaches the boundary pair;
    an empty shard passes its carry-in on."""
    co0 = tf[0] * halo_ok
    run = tf[1] * halo_ok
    full = n[0] > 0
    co1 = torch.where(full, torch.where(run > 0, 1 - co0, co0), 1)
    return torch.stack([torch.where(full, co0, 0), co1]).int()


# ---------------------------------------------------------------------------
# one rank's rounds
# ---------------------------------------------------------------------------

class _Rank:
    """One rank's shard and the round of the distributed trainer on it.

    ``ids``/``seg`` hold Nl + 1 slots (the last for the halo token) on the
    comm's device, ``n`` the live length (int32[1]); ``fail`` (int32[1])
    and ``overflow`` (int32[1], this rank's own flag) stay on the device."""

    def __init__(self, comm: Comm, ids, seg, n: int, shard_capacity: int,
                 num_merges: int, selection: str = "dense",
                 sparse_cap: int | None = None,
                 owner_cap: int | None = None):
        if selection not in SELECTIONS:
            raise ValueError(f"unknown selection {selection!r}; expected "
                             f"one of {SELECTIONS}")
        D, Nl = comm.size, shard_capacity
        check_positions(D, Nl)
        dev = comm.device
        self.comm, self.selection = comm, selection
        self.V = 256 + num_merges
        self.base = comm.rank * Nl
        i32 = dict(dtype=torch.int32, device=dev)
        self.ids = torch.full((Nl + 1,), PAD, **i32)
        self.seg = torch.full((Nl + 1,), PAD_SEG, **i32)
        self.ids[:Nl] = torch.from_numpy(np.asarray(ids, np.int32))
        self.seg[:Nl] = torch.from_numpy(np.asarray(seg, np.int32))
        self.n = torch.full((1,), int(n), **i32)
        self.fail = torch.full((1,), num_merges, **i32)
        self.overflow = torch.zeros(1, **i32)
        self.tf = torch.zeros(2, **i32)
        self.ranks = torch.arange(D, **i32)
        if selection == "dense":
            V = self.V
            self.ctl = kernels.new_ctl(num_merges, dev)
            self.stats = (torch.zeros((V, V), **i32),
                          torch.full((V, V), -1, **i32))
            return
        K = sparse_cap if sparse_cap is not None else min(Nl + 1,
                                                          SPARSE_CAP_MAX)
        Kb = owner_cap if owner_cap is not None else min(K, 4 * (-(-K // D)))
        self.K, self.Kb = K, Kb
        # the rows, then a row whose first word is the rows written: one
        # gather moves both
        self.sbuf = torch.zeros((K + 1, 4), **i32)
        merged = D * (K + 1) if selection == "sparse" else D * (Kb + 1)
        self.table = kernels.PairTable(max(Nl + 1, merged), dev,
                                       kernel="pair_summaries")
        self.champ = torch.zeros(4, **i32)
        self.slots = torch.arange(K, dtype=torch.int64, device=dev)

    # -- the halo -----------------------------------------------------------
    def halo(self):
        """The first token of the nearest later rank that has one, written
        at index n; ``n_ext`` = n + 1 where there is one and this shard is
        not empty (minbpe_tpu's _halo_exchange :171-189)."""
        D = self.comm.size
        info = torch.cat([self.ids[:1], self.seg[:1], (self.n > 0).int()])
        g = self.comm.all_gather(info)
        later = (g[:, 2] > 0) & (self.ranks > self.comm.rank)
        j = torch.where(later, self.ranks, D).min()
        self.halo_ok = (j < D) & (self.n[0] > 0)
        row = g.index_select(0, j.clamp(max=D - 1).reshape(1))[0]
        at = self.n.long()
        self.ids.index_copy_(0, at, row[0:1])
        self.seg.index_copy_(0, at, row[1:2])
        self.n_ext = self.n + self.halo_ok.int()

    # -- selection ------------------------------------------------------------
    def select(self, i: int):
        """(pair int32[2], count int32[1]): the round's global argmax, the
        largest count and among equal counts the earliest first position."""
        if self.selection == "dense":
            return self._dense(i)
        kernels.pair_summaries(self.ids, self.seg, self.n_ext, self.table,
                               self.base, self.sbuf[:self.K],
                               self.sbuf[self.K, :1], self.overflow)
        if self.selection == "sparse":
            g = self.comm.all_gather(self.sbuf)
            self._merge(g)
            return self.champ[:2], self.champ[2:3]
        return self._owner()

    def _dense(self, i: int):
        W = min(self.V, 256 + i)
        # a fill, not an assignment: that copies i from host memory
        self.ctl[kernels.CTL_I:kernels.CTL_I + 1].fill_(i)
        cnt, first = kernels.pair_stats(self.ids, self.seg, self.n_ext,
                                        self.V, self.ctl, out=self.stats)
        c = cnt[:W, :W].contiguous()
        f = first[:W, :W]
        f = torch.where(f >= 0, f + self.base, INT32_MAX)
        self.comm.sum_(c)
        self.comm.min_(f)
        key = torch.where(c > 0, (c.long() << 32) | (0xFFFFFFFF - f.long()),
                          0).view(-1)
        j = key.argmax().reshape(1)
        pair = torch.cat([j // W, j % W]).int()
        return pair, c.view(-1).gather(0, j)

    def _merge(self, g):
        """K16's merge of D blocks of rows (D, bs + 1, 4), each block's last
        row holding its length, into champ."""
        bs = g.shape[1] - 1
        lens = g[:, bs, 0].contiguous()
        kernels.pair_summaries_merge(g.view(-1, 4), lens, self.table,
                                     self.champ)

    def _owner(self):
        """minbpe_tpu's _owner_global_select (:303-383): buckets of at most
        Kb rows by owner, an all-to-all, each owner's merge (K16), the D
        champions gathered."""
        D, K, Kb = self.comm.size, self.K, self.Kb
        rows = self.sbuf[:K]
        h = rows[:, 0].long() * OWNER_MUL + rows[:, 1].long()
        h = (h + (1 << 31)) % (1 << 32) - (1 << 31)  # int32 wrap-around
        owner = torch.where(self.slots < self.sbuf[K, 0], h % D, D)
        order = torch.argsort(owner, stable=True)
        so = owner[order]
        # a scatter, not bincount: bincount reads its size back to the host
        per = torch.zeros(D + 1, dtype=torch.int64, device=owner.device)
        per.scatter_add_(0, owner, torch.ones_like(owner))
        start = torch.cumsum(per, 0) - per
        rank = self.slots - start[so]
        ok = (so < D) & (rank < Kb)
        self.overflow |= (per[:D] > Kb).any().int()
        dest = torch.where(ok, so * (Kb + 1) + rank, D * (Kb + 1))
        send = torch.zeros((D * (Kb + 1) + 1, 4), dtype=torch.int32,
                           device=rows.device)
        send.index_copy_(0, dest, rows[order])
        send = send[:-1].view(D, Kb + 1, 4)
        send[:, Kb, 0] = per[:D].clamp(max=Kb).int()
        self._merge(self.comm.all_to_all(send))
        champs = self.comm.all_gather(self.champ)
        c, f = champs[:, 2].long(), champs[:, 3].long()
        key = torch.where(c > 0, (c << 32) | (0xFFFFFFFF - f), 0)
        best = champs.index_select(0, key.argmax().reshape(1))[0]
        return best[:2], best[2:3]

    # -- the round's record and the apply -----------------------------------
    def record(self, i: int, pair, count, pairs, counts, row: int):
        """ok = count > 0 and fail >= i; log row ``row`` gets the pair and
        count where ok (zeros else), fail = i where no pair is left. Returns
        the pair to apply, (-1, -1) where not ok (K3 merges it nowhere)."""
        ok = (count > 0) & (self.fail >= i)
        self.fail = torch.where(count == 0, self.fail.clamp(max=i),
                                self.fail)
        pairs[row] = torch.where(ok, pair, 0)
        counts[row:row + 1] = torch.where(ok, count, 0)
        return torch.where(ok, pair, -1).int()

    def apply(self, pair, z: int):
        """pair -> z over the shard with the global left-first parity
        (minbpe_tpu's _apply_round :420-449), then the compaction."""
        out = kernels.merge_apply(self.ids, self.seg, self.n_ext, pair, z,
                                  tf=self.tf)
        g = self.comm.all_gather(transfer_bits(self.tf, self.halo_ok,
                                               self.n))
        carry = torch.zeros(1, dtype=torch.int32, device=pair.device)
        for d in range(self.comm.rank):  # compose ranks 0 .. rank - 1
            carry = g[d].gather(0, carry.long())
        kernels.merge_apply(self.ids, self.seg, self.n_ext, pair, z,
                            carry=carry, gate=True, out=out)
        self.ids, self.seg, self.n = kernels.compact(out[0], self.seg, out[1],
                                                     self.n)

    def round(self, i: int, pairs, counts, row: int):
        self.halo()
        pair, count = self.select(i)
        self.apply(self.record(i, pair, count, pairs, counts, row), 256 + i)

    def replay(self, pair, i: int):
        """Round i of a known merge prefix: the apply alone."""
        self.halo()
        self.apply(pair, 256 + i)

    def global_overflow(self) -> torch.Tensor:
        return self.comm.sum_(self.overflow.clone())


# ---------------------------------------------------------------------------
# the trainers
# ---------------------------------------------------------------------------

def _comm(group, device, comm: Comm | None) -> Comm:
    return comm if comm is not None else Comm(group, device)


def _local(ids, seg, lens, comm: Comm):
    """This rank's slice of the global host arrays."""
    D = comm.size
    Nl = ids.shape[0] // D
    if len(lens) != D or ids.shape[0] != D * Nl:
        raise ValueError(f"arrays for {len(lens)} shards of {Nl}, the group "
                         f"has {D} ranks")
    r = comm.rank
    return (ids[r * Nl:(r + 1) * Nl], seg[r * Nl:(r + 1) * Nl],
            int(lens[r]), Nl)


def _run_shard(comm: Comm, ids, seg, n: int, Nl: int, num_merges: int,
               selection: str, sparse_cap=None, owner_cap=None):
    """The whole run on this rank's shard: (pairs, counts, fail, oflow) as
    numpy, read back once."""
    st = _Rank(comm, ids, seg, n, Nl, num_merges, selection, sparse_cap,
               owner_cap)
    dev = comm.device
    pairs = torch.zeros((num_merges, 2), dtype=torch.int32, device=dev)
    counts = torch.zeros(num_merges, dtype=torch.int32, device=dev)
    for i in range(num_merges):
        st.round(i, pairs, counts, i)
    tail = torch.cat([st.fail, st.global_overflow()]).cpu()
    return pairs.cpu().numpy(), counts.cpu().numpy(), int(tail[0]), \
        int(tail[1] > 0)


def train_distributed(ids, seg, lens, num_merges: int, group=None, *,
                      selection: str = "dense",
                      sparse_cap: int | None = None,
                      owner_cap: int | None = None, device=None,
                      comm: Comm | None = None):
    """build_distributed_train (minbpe_tpu/parallel/train.py:452-551) as a
    function: the global host arrays (ids[D*Nl], seg[D*Nl], lens[D]) of
    ``shard_chunks`` or ``shard_bytes``, of which each rank takes its own
    slice, -> (pairs[M, 2], counts[M], fail_round, overflow), the same on
    every rank. ``group``: the process group (the default one); ``device``:
    this rank's (cuda:<local rank % devices>; "cpu" runs the kernels' plain
    versions). ``sparse_cap`` (K) and ``owner_cap`` (Kb) as JAX's."""
    comm = _comm(group, device, comm)
    li, ls, n, Nl = _local(ids, seg, lens, comm)
    return _run_shard(comm, li, ls, n, Nl, num_merges, selection,
                      sparse_cap, owner_cap)


def _stepped(comm: Comm, ids, seg, lens, num_merges: int, verbose: bool,
             selection: str, checkpoint_path, checkpoint_every, resume_from):
    """Host-driven stepped training with resumable checkpoints
    (minbpe_tpu/parallel/train.py:554-686, :748-804): steps of
    checkpoint_every rounds (32 by default), fail and overflow read after
    each; the checkpoint (rank 0 writes it) holds the merge prefix and the
    fingerprint of the global layout, in utils/checkpoint.py's format, so
    either package resumes the other's. A resume replays the prefix (the
    apply alone) before it goes on."""
    li, ls, n, Nl = _local(ids, seg, lens, comm)
    KR = int(checkpoint_every or 32)
    fp = ck.corpus_fingerprint(ids, seg, int(np.asarray(lens).sum()))
    st = _Rank(comm, li, ls, n, Nl, num_merges, selection)
    dev = comm.device
    pairs_all = np.zeros((num_merges, 2), np.int32)
    counts_all = np.zeros((num_merges,), np.int32)
    start = 0
    if resume_from is not None:
        state = ck.load_checked(resume_from, fp, num_merges)
        start = state["round_idx"]
        pairs_all[:start] = state["pairs"]
        counts_all[:start] = state["counts"]
        prefix = torch.from_numpy(pairs_all[:start]).to(dev)
        for i in range(start):
            st.replay(prefix[i], i)
    fail, oflow = num_merges, 0
    for r0 in range(start, num_merges, KR):
        m_done = min(KR, num_merges - r0)
        pairs = torch.zeros((m_done, 2), dtype=torch.int32, device=dev)
        counts = torch.zeros(m_done, dtype=torch.int32, device=dev)
        for k in range(m_done):
            st.round(r0 + k, pairs, counts, k)
        tail = torch.cat([st.fail, st.global_overflow()]).cpu()
        fail, oflow = int(tail[0]), int(tail[1] > 0)
        pairs_all[r0:r0 + m_done] = pairs.cpu().numpy()
        counts_all[r0:r0 + m_done] = counts.cpu().numpy()
        if oflow or fail < r0 + m_done:
            break
        if checkpoint_path is not None and comm.rank == 0:
            ck.save(checkpoint_path, pairs_all, counts_all,
                    min(r0 + KR, num_merges), num_merges, fp)
    return _finish_train(pairs_all, counts_all, fail, num_merges,
                         verbose and comm.rank == 0, oflow)


def _train(ids, seg, lens, num_merges, comm: Comm, verbose, selection,
           checkpoint_path=None, checkpoint_every=None, resume_from=None):
    if (checkpoint_path is not None or resume_from is not None
            or checkpoint_every is not None):
        return _stepped(comm, ids, seg, lens, num_merges, verbose, selection,
                        checkpoint_path, checkpoint_every, resume_from)
    pairs, counts, fail, oflow = train_distributed(
        ids, seg, lens, num_merges, selection=selection, comm=comm)
    return _finish_train(pairs, counts, fail, num_merges,
                         verbose and comm.rank == 0, oflow)


def train_bytes_distributed(data: bytes, num_merges: int, group=None,
                            verbose: bool = False, *, device=None,
                            selection: str = "dense",
                            comm: Comm | None = None):
    """Distributed training over a raw (unsegmented) byte stream, the
    BasicTokenizer path, with exact cross-shard pairs
    (minbpe_tpu/parallel/train.py:733-745). Returns (merges, vocab) on
    every rank. ``comm``: a Comm to use instead of one over group and
    device (one that times its collectives, say)."""
    comm = _comm(group, device, comm)
    ids, seg, lens = shard_bytes(data, comm.size)
    return _train(ids, seg, lens, num_merges, comm, verbose, selection)


def train_chunks_distributed(chunks: list[bytes], num_merges: int,
                             group=None, verbose: bool = False,
                             selection: str = "dense",
                             checkpoint_path: str | None = None,
                             checkpoint_every: int | None = None,
                             resume_from: str | None = None, *,
                             device=None, comm: Comm | None = None):
    """Shard the chunks over the group's ranks and train
    (minbpe_tpu/parallel/train.py:807-834). Returns (merges, vocab), the
    reference's, on every rank. checkpoint_path / checkpoint_every /
    resume_from switch to the stepped trainer (bit-identical results)."""
    comm = _comm(group, device, comm)
    ids, seg, lens = shard_chunks(chunks, comm.size)
    return _train(ids, seg, lens, num_merges, comm, verbose, selection,
                  checkpoint_path, checkpoint_every, resume_from)


def train_offsets_distributed(data, ends, num_merges: int, group=None,
                              verbose: bool = False,
                              selection: str = "dense", *, device=None,
                              comm: Comm | None = None, **stepped):
    """train_chunks_distributed over a corpus as its bytes and chunk ends
    (a tokenizer's ``_split_arrays``), without a list of chunks."""
    comm = _comm(group, device, comm)
    ids, seg, lens = shard_offsets(data, ends, comm.size)
    return _train(ids, seg, lens, num_merges, comm, verbose, selection,
                  **stepped)
