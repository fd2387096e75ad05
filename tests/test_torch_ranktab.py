"""The port's cuckoo pair table (minbpe_tpu_torch/ops/ranktab.py) against
minbpe_tpu's CuckooPairTable (minbpe_tpu/ops/ranktab.py): the same (rank,
new id) for every pair, present or not, from two hashes that differ, in
tables sized by the sizing loop alone."""

import numpy as np
import pytest
import torch

# The suite runs in several worker processes at once: one intra-op
# thread each keeps the plain PyTorch paths from contending for cores.
torch.set_num_threads(1)

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from minbpe_tpu.ops import ranktab as jranktab  # noqa: E402

from minbpe_tpu_torch.ops import ranktab  # noqa: E402
from minbpe_tpu_torch.ops.ranktab import RANK_INF, CuckooPairTable  # noqa: E402
from minbpe_tpu_torch.utils.synthranks import synthetic_ranks  # noqa: E402


def _forest(n_ranks):
    """(pairs, new_ids) of synthetic_ranks(n_ranks, seed=7)'s merge forest
    in rank order (ids are ranks, as in GPT-4's tables)."""
    _, intended, _ = synthetic_ranks(n_ranks, seed=7)
    items = sorted(intended.items(), key=lambda kv: kv[1])
    pairs = np.array([p for p, _ in items], dtype=np.int32)
    return pairs, np.array([r for _, r in items], dtype=np.int32)


@pytest.fixture(scope="module")
def forest8k():
    return _forest(8192)


def _lookup(t, a, b):
    r, z = t.lookup(torch.as_tensor(np.asarray(a, np.int32)),
                    torch.as_tensor(np.asarray(b, np.int32)))
    return r.numpy(), z.numpy()


def test_every_pair_found(forest8k):
    pairs, new_ids = forest8k
    t = CuckooPairTable(pairs, new_ids, "cpu")
    r, z = _lookup(t, pairs[:, 0], pairs[:, 1])
    assert np.array_equal(r, np.arange(len(pairs)))
    assert np.array_equal(z, new_ids)
    assert t.H == ranktab.table_size(len(pairs))
    assert t.rows.shape == (2, t.H, 4) and t.rows.dtype == torch.int32
    # each pair is in exactly one row of the two tables
    used = (t.rows[..., 0] >= 0).sum().item()
    assert used == len(pairs)


@pytest.mark.parametrize("case", ["absent", "negative_b", "swapped",
                                  "empty_table"])
def test_misses(forest8k, case):
    pairs, new_ids = forest8k
    keys = {tuple(p) for p in pairs.tolist()}
    t = CuckooPairTable(pairs, new_ids, "cpu")
    a, b = pairs[:, 0].copy(), pairs[:, 1].copy()
    if case == "absent":
        a = a + 100_000
    elif case == "negative_b":
        b = np.full_like(b, -1)
    elif case == "swapped":
        a, b = b, a
        keep = np.array([(x, y) not in keys for x, y in zip(a, b)])
        a, b = a[keep], b[keep]
    else:
        t = CuckooPairTable(np.zeros((0, 2), np.int32),
                            np.zeros(0, np.int32), "cpu")
        assert t.H == 64
    r, z = _lookup(t, a, b)
    assert len(r) and (r == RANK_INF).all() and (z == -1).all()


def test_lookups_equal_minbpe_tpu(forest8k):
    """10^4 seeded queries, half of them pairs of the table."""
    pairs, new_ids = forest8k
    rng = np.random.default_rng(3)
    hit = pairs[rng.integers(0, len(pairs), 5000)]
    miss = rng.integers(-1, 8192, (5000, 2)).astype(np.int32)
    q = np.concatenate([hit, miss])
    port = CuckooPairTable(pairs, new_ids, "cpu")
    ref = jranktab.CuckooPairTable(pairs, new_ids)
    r, z = _lookup(port, q[:, 0], q[:, 1])
    jr, jz = ref.lookup(jnp.asarray(q[:, 0]), jnp.asarray(q[:, 1]))
    assert np.array_equal(r, np.asarray(jr))
    assert np.array_equal(z, np.asarray(jz))
    assert (r[:5000] != RANK_INF).all()


@pytest.mark.parametrize("seeds", ranktab.SEEDS)
def test_host_and_torch_hashes_agree(seeds):
    """mix on int64 numpy arrays, int64 torch tensors and Python ints gives
    the uint32 hash of csrc/bpe_kernels.cu ck_hash, written out here on
    Python ints with explicit wrap-around, for ids across the int32 range
    (ck_hash's (unsigned) casts of negative ids included)."""
    rng = np.random.default_rng(5)
    a = np.concatenate([rng.integers(0, 1 << 31, 500),
                        rng.integers(-(1 << 31), 0, 100),
                        [0, 1, 2**31 - 1, -1]]).astype(np.int64)
    b = rng.permutation(a)
    mask = (1 << 18) - 1

    def uint32_hash(x, y, s, t):
        u = ((x & 0xFFFFFFFF) * s + (y & 0xFFFFFFFF) * t) & 0xFFFFFFFF
        u ^= u >> 15
        u = (u * ranktab.MIX_MUL) & 0xFFFFFFFF
        u ^= u >> 12
        return u & mask

    for s, t in (seeds[:2], seeds[2:]):
        host = ranktab.mix(a, b, s, t, mask)
        dev = ranktab.mix(torch.from_numpy(a), torch.from_numpy(b), s, t,
                          mask).numpy()
        ref = [uint32_hash(int(x), int(y), s, t) for x, y in zip(a, b)]
        assert np.array_equal(host, dev)
        assert host.tolist() == ref
        assert [ranktab.mix(int(x), int(y), s, t, mask)
                for x, y in zip(a, b)] == ref


def test_cl100k_width_table_size():
    """At GPT-4's 100,000 merges the port's tables hold 2^18 rows each (8 MB
    both, in the H100's L2), where minbpe_tpu's, whose h2 is h1 with its
    arguments swapped, grow to 2^24 (512 MB)."""
    pairs, new_ids = _forest(100_256)
    assert len(pairs) == 100_000
    port = CuckooPairTable(pairs, new_ids, "cpu")
    assert port.H <= 1 << 18
    assert port.rows.numel() * 4 <= 16 << 20
    r, z = _lookup(port, pairs[:, 0], pairs[:, 1])
    assert np.array_equal(r, np.arange(len(pairs)))
    assert np.array_equal(z, new_ids)
    h1, h2 = port.slots(torch.from_numpy(pairs[:, 0]),
                        torch.from_numpy(pairs[:, 1]))
    assert (h1 != h2).float().mean() > 0.99
    ref = jranktab.CuckooPairTable(pairs, new_ids)
    assert ref.H == 1 << 24
    s1, s2 = (np.uint64(v) for v in ref.seeds)
    a, b = pairs[:1000, 0].astype(np.int64), pairs[:1000, 1].astype(np.int64)
    assert np.array_equal(jranktab._mix_np(a, b, s1, s2, ref.H - 1),
                          jranktab._mix_np(b, a, s2, s1, ref.H - 1))
