"""Pair -> rank lookup tables on the device.

``SortedPairTable`` is the counterpart of minbpe_tpu/ops/ranktab.py:30-67:
the merge pairs sorted lexicographically, looked up by a fixed-depth
binary search in plain PyTorch. It serves the bucketed chunk encoder
(ops/chunk_encode.py) and ``ops/encode.encode_stream_sorted``, which keep
an encoder independent of K11 and K12.

``CuckooPairTable`` maps a pair to (rank, new id) for tables above the
dense route's vocab.
The port's counterpart of ``CuckooPairTable`` and ``cuckoo_lookup``
(minbpe_tpu/ops/ranktab.py:74-179). Two hash tables of (H, 4) int32 rows
``[a, b, rank, new_id]`` (a = -1 marks an empty row); every pair lives at
h1(a, b) in the first table or at h2(a, b) in the second, so a lookup is
exactly two row reads, whatever the table's size. The rows of both tables
are one (2, H, 4) tensor on the tokenizer's device; the encoder's kernels
(K11 ``chunk_encode``, K12 ``encode_min_sweep``) read them with one 16-byte
load a probe.

The two hashes are different functions: h1 mixes a * s1 + b * s2 and h2
mixes a * s3 + b * s4. (minbpe_tpu's h2 is h1 with its arguments and seeds
both swapped, b * s2 + a * s1, which is h1 itself: every key then has one
slot index in both tables, and its build doubles H until keys almost never
collide, to 2^24 rows at 100,000 merges.) Here H comes from minbpe_tpu's
sizing loop, the smallest power of two of at least 64 with 2 H >= 3 M
(2^18 at 100,000 merges: 8 MB for both tables, which stay in the H100's
50 MB L2), and doubles only where every seed set meets a cycle.

The hash is uint32 arithmetic that wraps: ``mix`` computes it on int64
numpy arrays, int64 torch tensors and Python ints alike (each product of a
32-bit value and a 32-bit seed fits in 63 bits, and its low 32 bits are
those of the uint32 product), and csrc/bpe_kernels.cu ``ck_hash`` on
uint32_t.
"""

from __future__ import annotations

import numpy as np
import torch

from ..base import resolve_device

RANK_INF = 2**31 - 1
M32 = 0xFFFFFFFF
MIX_MUL = 0x2C1B3C6D
# (s1, s2) for h1 and (s3, s4) for h2, tried in turn; all odd
SEEDS = (
    (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F),
    (0x165667B1, 0xD3A2646D, 0xFD7046C5, 0xB55A4F09),
    (0x27D4EB2F, 0x9E3779B1, 0x85EBCA77, 0x165667B1),
    (0x94D049BB, 0xB2D05E13, 0x1B873593, 0xCC9E2D51),
)


def mix(a, b, s1: int, s2: int, mask: int):
    """The slot index of (a, b) under seeds (s1, s2): u = a * s1 + b * s2
    mod 2^32, then u ^= u >> 15, u *= MIX_MUL, u ^= u >> 12 (each mod
    2^32), and the low bits under ``mask``. a, b: int64 numpy arrays,
    int64 torch tensors or Python ints, with values in the int32 range."""
    u = (((a * s1) & M32) + ((b * s2) & M32)) & M32
    u = u ^ (u >> 15)
    u = (u * MIX_MUL) & M32
    u = u ^ (u >> 12)
    return u & mask


def table_size(num_merges: int) -> int:
    """Rows per table before any cycle: minbpe_tpu's sizing loop
    (ranktab.py:127-129)."""
    H = 64
    while H * 2 < max(num_merges, 1) * 3:
        H *= 2
    return H


class SortedPairTable:
    """The merge pairs (int32 (M, 2), rank order) sorted by (a, b) on
    ``device`` (None: cuda; raises without CUDA unless "cpu"): ``ka``, ``kb``
    and each one's ``rank``, with the rank-order ``merge_pairs`` and
    ``merge_ids`` a found rank is applied with. With M = 0 each array holds
    one stand-in row (rank RANK_INF), as minbpe_tpu's does."""

    def __init__(self, pairs, new_ids, device=None):
        pairs = np.asarray(pairs, dtype=np.int32).reshape(-1, 2)
        new_ids = np.asarray(new_ids, dtype=np.int32).reshape(-1)
        M = len(pairs)
        self.num_merges = M
        self.device = resolve_device(device)
        if M:
            order = np.lexsort((pairs[:, 1], pairs[:, 0]))
            ka, kb = pairs[order, 0], pairs[order, 1]
            rank = order.astype(np.int32)
        else:
            ka = kb = np.zeros(1, np.int32)
            rank = np.full(1, RANK_INF, np.int32)
            pairs = np.zeros((1, 2), np.int32)
            new_ids = np.zeros(1, np.int32)
        self.depth = max(1, int(np.ceil(np.log2(max(M, 2)))))

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        self.ka, self.kb, self.rank = put(ka), put(kb), put(rank)
        self.merge_pairs, self.merge_ids = put(pairs), put(new_ids)
        self.keys = _pair_key(self.ka, self.kb)

    def lookup(self, a, b, valid):
        """The rank of each pair (a, b) (int32 tensors of one shape on the
        table's device), RANK_INF where the pair is absent or ``valid`` is
        False: depth + 1 halvings of [0, M - 1] towards the first key >=
        (a, b), each one gather of the 64-bit keys."""
        keys = self.keys
        last = keys.shape[0] - 1
        q = _pair_key(a, b)
        lo = torch.zeros(q.shape, dtype=torch.int64, device=q.device)
        hi = torch.full_like(lo, last)
        for _ in range(self.depth + 1):
            mid = (lo + hi) >> 1
            less = keys[mid] < q
            lo = torch.where(less, (mid + 1).clamp_(max=last), lo)
            hi = torch.where(less, hi, mid)
        hit = (keys[lo] == q) & valid
        return torch.where(hit, self.rank[lo],
                           torch.full_like(a, RANK_INF, dtype=torch.int32))


def _pair_key(a, b):
    """a * 2^32 + b + 2^31 as int64: ordered as (a, b) lexicographically,
    for any int32 a and b."""
    return (a.long() << 32) + (b.long() + (1 << 31))


def _place(h1: list, h2: list, H: int, max_kicks: int):
    """Cuckoo insertion of keys 0 .. M-1 with slot indices h1[k] and h2[k]:
    the key index held by each slot of both tables (-1: empty), or None
    where an insertion walks max_kicks evictions without finding a slot."""
    slots = ([-1] * H, [-1] * H)
    for i in range(len(h1)):
        k, side = i, 0
        for _ in range(max_kicks):
            tab = slots[side]
            h = h1[k] if side == 0 else h2[k]
            k, tab[h] = tab[h], k
            if k < 0:
                break
            side = 1 - side
        else:
            return None
    return slots


class CuckooPairTable:
    """Pair -> (rank, new id) for merges in rank order (pairs (M, 2), new_ids
    (M,)), built on the host and held on ``device``: ``rows`` (2, H, 4)
    int32, the seeds and H, and the rank-order ``pairs`` and ``new_ids``
    the encoder applies a found rank with. ``uploaded``: those two already
    on ``device``, held in place of a second upload."""

    def __init__(self, pairs, new_ids, device, *, uploaded=None):
        pairs = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
        new_ids = np.asarray(new_ids, dtype=np.int64).reshape(-1)
        M = len(pairs)
        self.num_merges = M
        a, b = pairs[:, 0], pairs[:, 1]
        max_kicks = 32 + 4 * int(np.ceil(np.log2(max(M, 2))))
        H = table_size(M)
        while True:
            for seeds in SEEDS:
                slots = _place(mix(a, b, seeds[0], seeds[1], H - 1).tolist(),
                               mix(a, b, seeds[2], seeds[3], H - 1).tolist(),
                               H, max_kicks)
                if slots is not None:
                    break
            else:
                H *= 2
                continue
            break
        rows = np.full((2, H, 4), -1, dtype=np.int32)
        for t in range(2):
            k = np.asarray(slots[t], dtype=np.int64)
            used = k >= 0
            k = k[used]
            rows[t, used] = np.stack([a[k], b[k], k, new_ids[k]], axis=1)
        self.H = H
        self.seeds = seeds
        self.device = torch.device(device)
        self.rows = torch.from_numpy(rows).to(self.device)
        if uploaded is not None:
            self.pairs, self.new_ids = uploaded
            return
        self.pairs = torch.from_numpy(pairs.astype(np.int32)).to(self.device)
        self.new_ids = torch.from_numpy(new_ids.astype(np.int32)).to(
            self.device)

    @staticmethod
    def device_bytes(num_merges: int) -> int:
        """The rows' bytes of a table of ``num_merges`` merges before any
        cycle doubles it: two tables of table_size rows of 16 B."""
        return 2 * table_size(num_merges) * 16

    def slots(self, a, b):
        """(h1, h2) of int tensors a, b: the rows a pair may occupy."""
        a, b = a.long(), b.long()
        s1, s2, s3, s4 = self.seeds
        return (mix(a, b, s1, s2, self.H - 1), mix(a, b, s3, s4, self.H - 1))

    def lookup(self, a, b):
        """(rank, new_id) int32 tensors of the pairs (a, b), elementwise;
        (RANK_INF, -1) where the pair is absent or b < 0."""
        h1, h2 = self.slots(a, b)
        r1, r2 = self.rows[0][h1], self.rows[1][h2]
        ok = b >= 0
        hit1 = ok & (r1[..., 0] == a) & (r1[..., 1] == b)
        hit2 = ok & (r2[..., 0] == a) & (r2[..., 1] == b)
        rank = torch.where(hit1, r1[..., 2], torch.where(
            hit2, r2[..., 2], torch.full_like(r1[..., 2], RANK_INF)))
        nid = torch.where(hit1, r1[..., 3], torch.where(
            hit2, r2[..., 3], torch.full_like(r1[..., 3], -1)))
        return rank, nid
