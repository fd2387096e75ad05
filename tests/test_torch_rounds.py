"""The round driver (ops/rounds.py) of the port's three stepped trainers on
a corpus that runs out of pairs before its merge count: the port stops
enqueueing rounds once it has read the fail round, yet its progress calls
and checkpoint files must stay minbpe_tpu's, whose drivers never stop."""

import numpy as np
import pytest
import torch

# The suite runs in several worker processes at once: one intra-op
# thread each keeps the plain PyTorch paths from contending for cores.
torch.set_num_threads(1)

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from minbpe_tpu.ops import stream as jstream  # noqa: E402
from minbpe_tpu.ops import train_inc as jinc  # noqa: E402
from minbpe_tpu.ops import train_sortloop as jsl  # noqa: E402
from minbpe_tpu.ops import train_sparse as jsp  # noqa: E402

from minbpe_tpu_torch.ops import (train_inc, train_sortloop,  # noqa: E402
                                  train_sparse)
from minbpe_tpu_torch.utils import checkpoint as ckpt  # noqa: E402

ROUTES = {
    "stepped": (jinc.train_merges_stepped, train_inc.train_merges_stepped),
    "sortloop": (jsl.train_merges_sortloop_stepped,
                 train_sortloop.train_merges_sortloop_stepped),
    "sparse": (jsp.train_merges_sparse_stepped,
               train_sparse.train_merges_sparse_stepped),
}
# fails at round 14, before the first read of the fail round on the
# stepped and sparse routes (8 steps of UNROLL rounds)
CHUNKS = [b"ab" * 30, b"cd" * 20, b"ab"]
M = 40
UNROLL = 3
EVERY = 6


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_a_failing_run_reports_as_minbpe_tpu(route, tmp_path):
    data = np.frombuffer(b"".join(CHUNKS), dtype=np.uint8)
    ends = np.cumsum([len(c) for c in CHUNKS]).astype(np.int64)
    ids, seg, n = jstream.pack_offsets(data, ends, 1024)
    k = int(n)
    fp = ckpt.corpus_fingerprint(ids, seg, n)
    seen = {}
    for who, train in zip(("j", "p"), ROUTES[route]):
        path = str(tmp_path / f"{who}.ckpt.npz")
        calls = seen[who] = []

        def progress(done, total, path=path, calls=calls):
            # each call with the checkpoint on disk at that point
            c = ckpt.load(path) if done > EVERY else None
            calls.append((done, total) if c is None else (
                done, total, c["round_idx"], c["num_merges"],
                c["fingerprint"], c["pairs"].tolist(), c["counts"].tolist()))

        kw = dict(unroll=UNROLL, checkpoint_path=path, checkpoint_every=EVERY,
                  progress=progress)
        if who == "j":
            got = train(jnp.asarray(ids), jnp.asarray(seg), jnp.asarray(n), M,
                        **kw)
        else:
            got = train(torch.from_numpy(ids[:k].copy()),
                        torch.from_numpy(seg[:k].copy()), M, fingerprint=fp,
                        **kw)
        seen[who + "_out"] = [np.asarray(x) for x in got]
    assert seen["p"] == seen["j"]
    assert [c[0] for c in seen["p"]] == list(range(3, M, 3)) + [M]
    assert seen["p"][-1][2] == 36  # the last checkpoint: round 36 of 40
    (jp, jc, jf), (pp, pc, pf) = seen["j_out"], seen["p_out"]
    assert int(jf) == int(pf) == 14
    assert np.array_equal(jp, pp) and np.array_equal(jc, pc)
