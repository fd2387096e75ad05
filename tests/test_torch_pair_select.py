"""K13 pair_select on the CPU (its plain version, pair_table_plain then
table_select_plain) against minbpe_tpu's sort-round selection: the port's
round (ops/train_sortloop._round: pair_select, merge_apply, compact) and
minbpe_tpu's _round (ops/train_sortloop.py:49-103, jitted on the CPU),
round by round from the same numpy-seeded stream, with the log row, the
count and the fail round compared exactly after every round. Also the gate
after a failed round and 32 rounds through one table, which must be empty
after each."""

import numpy as np
import pytest
import torch

# The suite runs in several worker processes at once: one intra-op
# thread each keeps the plain PyTorch paths from contending for cores.
torch.set_num_threads(1)

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from minbpe_tpu.ops import train_sortloop as jsl  # noqa: E402

from minbpe_tpu_torch import kernels  # noqa: E402
from minbpe_tpu_torch.ops import train_sortloop as psl  # noqa: E402
from minbpe_tpu_torch.ops.select import select_max_pair  # noqa: E402

N = 4000     # one stream length, so minbpe_tpu's round compiles once
ROUNDS = 8

_jround = jax.jit(jsl._round, static_argnums=(1,))


def _streams():
    rng = np.random.default_rng(10)
    pairs = rng.permutation(np.repeat(np.arange(N // 4), 2))
    return {
        "zipf": (np.minimum(rng.zipf(1.3, N) - 1, 1023),
                 np.cumsum(rng.random(N) < 0.3)),
        "all_distinct": (np.arange(N) + 300, np.zeros(N)),
        "one_hot_pair": (np.full(N, 97), np.zeros(N)),
        "ids_above_2_16": (rng.integers(65_536, 100_260, N),
                           np.cumsum(rng.random(N) < 0.1)),
        "many_segments": (rng.integers(0, 40, N),
                          np.cumsum(rng.random(N) < 0.6)),
        # every pair (2k + 1000, 2k + 1001) twice, in its own chunk, in a
        # seeded order: every count ties and the first occurrence decides
        "ties": (np.stack([2 * pairs + 1000, 2 * pairs + 1001], 1)
                 .reshape(-1), np.repeat(np.arange(N // 2), 2)),
        # three pairs, then none: the fail round and the gated rounds
        "exhausts": (np.concatenate([[1, 2, 1, 2, 3, 4], np.arange(N - 6)]),
                     np.concatenate([[0, 0, 0, 0, 1, 1],
                                     2 + np.arange(N - 6)])),
    }


def _minbpe_tpu_rounds(ids, seg, M):
    """(pair, count, fail) after each of minbpe_tpu's rounds 0 .. M - 1."""
    state = jsl._pad_to_planes(jnp.asarray(ids), jnp.asarray(seg),
                               jnp.int32(len(ids)))[:3]
    state = (*state, jnp.zeros((M, 2), jnp.int32), jnp.zeros((M,), jnp.int32),
             jnp.int32(M))
    out = []
    for i in range(M):
        state = _jround(jnp.int32(i), M, state)
        out.append((np.asarray(state[3][i]).tolist(), int(state[4][i]),
                    int(state[5])))
    return out


@pytest.mark.parametrize("name", sorted(_streams()))
def test_rounds_match_minbpe_tpu(name):
    a, s = _streams()[name]
    ids = np.asarray(a, np.int32)
    seg = np.asarray(s, np.int32)
    want = _minbpe_tpu_rounds(ids, seg, ROUNDS)
    st = psl._State(torch.from_numpy(ids), torch.from_numpy(seg),
                    torch.full((1,), N, dtype=torch.int32), ROUNDS)
    for i in range(ROUNDS):
        psl._round(st, i)
        got = (st.pairs[i].tolist(), int(st.cnts[i]), int(st.fail))
        assert got == want[i], f"round {i}"
        assert int(st.table.used) == 0
    if name == "exhausts":
        assert want[-1][2] == 3  # rounds 4 .. 7 were gated


def _record(M):
    return (torch.zeros(4, dtype=torch.int32),
            torch.full((M, 2), 7, dtype=torch.int32),
            torch.full((M,), 7, dtype=torch.int32))


def test_gate_after_a_failed_round():
    """The round that finds no pair sets fail to its index; every later
    round writes (-1, -1, 0, 0) and a zero log row and leaves fail and the
    table as they are, even on a stream that has pairs again."""
    table = kernels.PairTable(8, "cpu")
    fail = torch.tensor([6], dtype=torch.int32)
    sel, pairs, counts = _record(6)
    lone = (torch.tensor([5], dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32),
            torch.ones(1, dtype=torch.int32))
    kernels.pair_select(*lone, table, sel, pairs, counts, fail, 2)
    assert sel.tolist() == [-1, -1, 0, 0] and int(fail) == 2
    ids = torch.tensor([1, 2, 1, 2], dtype=torch.int32)
    seg = torch.zeros(4, dtype=torch.int32)
    n = torch.full((1,), 4, dtype=torch.int32)
    for i in (3, 5):
        sel.fill_(9)
        kernels.pair_select(ids, seg, n, table, sel, pairs, counts, fail, i)
        assert sel.tolist() == [-1, -1, 0, 0] and int(fail) == 2
        assert pairs[i].tolist() == [0, 0] and int(counts[i]) == 0
        assert int(table.used) == 0
    # a round before the fail round still counts
    kernels.pair_select(ids, seg, n, table, sel, pairs, counts, fail, 1)
    assert sel.tolist() == [1, 2, 2, 1] and int(fail) == 2


def test_32_rounds_through_one_table():
    """32 rounds on seeded streams of falling length through one table sized
    for the first: each round's record is select_max_pair's, and the table
    is empty after each."""
    rng = np.random.default_rng(32)
    table = kernels.PairTable(N, "cpu")
    M = 32
    fail = torch.tensor([M], dtype=torch.int32)
    sel, pairs, counts = _record(M)
    for i in range(M):
        k = N - 120 * i
        ids = torch.from_numpy(np.minimum(rng.zipf(1.2, k) - 1, 70_000)
                               .astype(np.int32))
        seg = torch.from_numpy(np.cumsum(rng.random(k) < 0.2)
                               .astype(np.int32))
        n = torch.full((1,), k - i, dtype=torch.int32)  # a live prefix
        kernels.pair_select(ids, seg, n, table, sel, pairs, counts, fail, i)
        pa, pb, c, ok = select_max_pair(ids, seg, n)
        assert bool(ok)
        assert sel.tolist() == [int(pa), int(pb), int(c), 1]
        assert pairs[i].tolist() == [int(pa), int(pb)]
        assert int(counts[i]) == int(c) and int(fail) == M
        assert int(table.used) == 0 and (table.key == -1).all()
        assert not table.cnt.any()
        assert (table.first == kernels.EMPTY_FIRST).all()
