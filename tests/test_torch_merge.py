"""The port's merge module (minbpe_tpu_torch/ops/merge.py) against
minbpe_tpu/ops/merge.py on the CPU: the keep mask, and apply_merge's ids,
live length and merged count, on seeded multi-segment streams and on the
left-first cases of tests/test_ops.py. Exact equality."""

import numpy as np
import pytest
import torch

# The suite runs in several worker processes at once: one intra-op
# thread each keeps the plain PyTorch paths from contending for cores.
torch.set_num_threads(1)

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from minbpe_tpu.ops import merge as jmerge  # noqa: E402
from minbpe_tpu.ops import stream as jstream  # noqa: E402

from minbpe_tpu_torch.ops import merge as pmerge  # noqa: E402


def _both(seqs, capacity=None):
    ids, seg, n = jstream.pack_chunks([bytes(s) for s in seqs], capacity)
    j = (jnp.asarray(ids), jnp.asarray(seg), jnp.asarray(n))
    k = int(n)
    p = (torch.from_numpy(ids[:k].copy()), torch.from_numpy(seg[:k].copy()),
         torch.tensor([k], dtype=torch.int32))
    return j, p


def _apply_both(seqs, pair, new_id):
    j, p = _both(seqs)
    oi, _, on, ok = jmerge.apply_merge(*j, jnp.int32(pair[0]),
                                       jnp.int32(pair[1]), jnp.int32(new_id))
    qi, _, qn, qk = pmerge.apply_merge(
        *p, torch.tensor(pair, dtype=torch.int32), new_id)
    want = jstream.unpack_ids(np.asarray(oi), int(on))
    got = qi[:int(qn)].tolist()
    assert got == want
    assert int(qk) == int(ok)
    keep = jmerge.merge_mask(*j, pair[0], pair[1])
    assert np.array_equal(np.asarray(keep)[:p[0].numel()],
                          pmerge.merge_mask(*p, *pair).numpy())
    return got, int(qk)


@pytest.mark.parametrize("seqs, pair, want", [
    ([[1, 2, 3, 1, 2]], (1, 2), [4, 3, 4]),
    ([[7, 7, 7]], (7, 7), [9, 7]),
    ([[7, 7, 7, 7]], (7, 7), [9, 9]),
    ([[7, 7, 7, 7, 7]], (7, 7), [9, 9, 7]),
    ([[1, 2], [2, 2]], (2, 2), [1, 2, 9]),
    ([[7, 7, 1, 7, 7]], (7, 7), [9, 1, 9]),
])
def test_left_first_cases(seqs, pair, want):
    """tests/test_ops.py:66-86: overlapping (a, a) matches resolve left
    first, and merges never cross a segment end."""
    new_id = 4 if pair == (1, 2) else 9
    got, _ = _apply_both(seqs, pair, new_id)
    assert got == want


@pytest.mark.parametrize("seed", range(8))
def test_random_streams(seed):
    rng = np.random.default_rng(seed)
    seqs = [rng.integers(0, rng.choice([2, 3, 5]),
                         rng.integers(0, 50)).tolist()
            for _ in range(rng.integers(1, 9))]
    seqs.append([3] * int(rng.integers(2, 12)))
    for pair in ((0, 1), (1, 1), (3, 3), tuple(rng.integers(0, 3, 2))):
        _apply_both(seqs, tuple(int(x) for x in pair), 300)


def test_absent_pair_merges_nothing():
    """The pair a failed training round applies, (-1, -1): nothing merges,
    and the stream comes back whole."""
    _, p = _both([[5, 5, 5], [1, 2]])
    ids, seg, n, k = pmerge.apply_merge(
        *p, torch.tensor([-1, -1], dtype=torch.int32), 300)
    assert int(k) == 0 and int(n) == 5
    assert ids[:5].tolist() == [5, 5, 5, 1, 2]
    assert seg[:5].tolist() == p[1].tolist()
