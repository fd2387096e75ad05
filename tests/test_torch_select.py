"""The port's selection module (minbpe_tpu_torch/ops/select.py) and K9's
plain version against minbpe_tpu/ops/select.py and the Pallas pair-count
kernel (interpret mode), on the CPU.

Streams are seeded with numpy: several segments, a small alphabet (many
tied counts), runs of one id (overlapping (a, a) pairs), and empty and
one-token segments. The port gets both the padded arrays minbpe_tpu packs
and their live prefix. Every output is an integer: exact equality."""

import numpy as np
import pytest
import torch

# The suite runs in several worker processes at once: one intra-op
# thread each keeps the plain PyTorch paths from contending for cores.
torch.set_num_threads(1)

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from minbpe_tpu.ops import select as jsel  # noqa: E402
from minbpe_tpu.ops import stream as jstream  # noqa: E402
from minbpe_tpu.ops.pallas.pair_count import count_pairs_pallas  # noqa: E402

from minbpe_tpu_torch import kernels  # noqa: E402
from minbpe_tpu_torch.ops import select as psel  # noqa: E402

# one padded size and one V for every stream: the Pallas kernel compiles once
CAPACITY = 2048
V = 272
SEEDS = range(8)


def _chunks(seed):
    """Seeded chunks: lengths 0-60 (empty and one-token ones included), ids
    from a small alphabet, runs of one id, and an id near V."""
    rng = np.random.default_rng(seed)
    chunks = []
    for _ in range(rng.integers(4, 30)):
        length = int(rng.choice([0, 1, rng.integers(2, 61)]))
        c = rng.integers(0, rng.choice([3, 5, 9]), length)
        if length > 8 and rng.random() < 0.5:
            s = rng.integers(0, length - 4)
            c[s:s + rng.integers(3, length - s + 1)] = 7
        chunks.append(bytes(c.astype(np.uint8).tolist()))
    chunks.append(bytes([7] * 9))
    chunks.append(bytes([1, 2, 1, 2, 1, 2]))
    return chunks


def _streams(seed):
    """(jax args, port padded args, port live-prefix args)."""
    ids, seg, n = jstream.pack_chunks(_chunks(seed), CAPACITY)
    ids[3] = V - 1 if int(n) > 3 else ids[3]
    j = (jnp.asarray(ids), jnp.asarray(seg), jnp.asarray(n))
    nt = torch.tensor([int(n)], dtype=torch.int32)
    padded = (torch.from_numpy(ids.copy()), torch.from_numpy(seg.copy()), nt)
    live = (torch.from_numpy(ids[:int(n)].copy()),
            torch.from_numpy(seg[:int(n)].copy()), nt)
    return j, padded, live


def _np(x):
    return np.asarray(x).reshape(-1)


def _same_selection(j_out, p_out):
    pa, pb, cnt, ok = (_np(x) for x in j_out)
    qa, qb, qcnt, qok = (x.numpy() for x in p_out)
    assert bool(ok[0]) == bool(qok[0])
    assert int(cnt[0]) == int(qcnt[0])
    if ok[0]:
        assert (int(pa[0]), int(pb[0])) == (int(qa[0]), int(qb[0]))


@pytest.mark.parametrize("seed", SEEDS)
def test_pair_validity(seed):
    j, padded, _ = _streams(seed)
    valid, nxt = jsel.pair_validity(*j)
    pvalid, pnxt = psel.pair_validity(*padded)
    assert np.array_equal(np.asarray(valid), pvalid.numpy())
    assert np.array_equal(np.asarray(nxt), pnxt.numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_select_max_pair(seed):
    j, padded, live = _streams(seed)
    want = jsel.select_max_pair(*j)
    _same_selection(want, psel.select_max_pair(*padded))
    _same_selection(want, psel.select_max_pair(*live))


@pytest.mark.parametrize("seed", SEEDS)
def test_dense_counts(seed):
    """count_pairs_dense, K9's plain version, minbpe_tpu's XLA count and
    the Pallas kernel: one matrix."""
    j, padded, live = _streams(seed)
    want = np.asarray(jsel.count_pairs_dense(*j, V))
    assert np.array_equal(want, np.asarray(
        count_pairs_pallas(*j, V, interpret=True)))
    assert int(want.sum()) > 0
    for args in (padded, live):
        assert np.array_equal(want, psel.count_pairs_dense(*args, V).numpy())
        assert np.array_equal(want, kernels.pair_count(*args, V).numpy())


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_ids_outside_v_count_nowhere(seed):
    """At a V below the stream's largest id, pairs with such ids count in
    neither package."""
    j, padded, _ = _streams(seed)
    small = 6
    want = np.asarray(jsel.count_pairs_dense(*j, small))
    assert np.array_equal(want, psel.count_pairs_dense(*padded, small).numpy())
    assert np.array_equal(want, kernels.pair_count(*padded, small).numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_select_from_counts(seed):
    j, padded, live = _streams(seed)
    counts = jsel.count_pairs_dense(*j, V)
    want = jsel.select_from_counts(*j, counts, V)
    pc = torch.from_numpy(np.asarray(counts).copy())
    _same_selection(want, psel.select_from_counts(*padded, pc, V))
    _same_selection(want, psel.select_from_counts(*live, pc, V))
    _same_selection(jsel.select_max_pair_dense(*j, V),
                    psel.select_max_pair_dense(*live, V))
    _same_selection(jsel.select_max_pair_pallas(*j, V, interpret=True),
                    psel.select_max_pair_pallas(*live, V))


def test_no_countable_pair():
    """One-token segments only: no pair, ok is False in both."""
    ids, seg, n = jstream.pack_chunks([b"a", b"b", b"", b"c"], CAPACITY)
    j = (jnp.asarray(ids), jnp.asarray(seg), jnp.asarray(n))
    nt = torch.tensor([int(n)], dtype=torch.int32)
    live = (torch.from_numpy(ids[:3].copy()), torch.from_numpy(seg[:3].copy()),
            nt)
    _same_selection(jsel.select_max_pair(*j), psel.select_max_pair(*live))
    _same_selection(jsel.select_max_pair_dense(*j, V),
                    psel.select_max_pair_dense(*live, V))
    assert not bool(psel.select_max_pair_pallas(*live, V)[3])
