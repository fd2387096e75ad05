"""The port's entry checks (entry_torch.py) against minbpe_tpu's
(__graft_entry__.py), on the CPU."""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import __graft_entry__ as jax_entry  # noqa: E402
import entry_torch  # noqa: E402
import torch_dist_pool as jobs  # noqa: E402

torch.set_num_threads(1)


def test_entry_matches_graft_entry():
    fn, args = jax_entry.entry()
    w_ids, w_n = fn(*args)
    want = np.asarray(w_ids)[:int(w_n)]
    fn, args = entry_torch.entry(device="cpu")
    assert all(t.device.type == "cpu" for t in args)
    g_ids, g_n = fn(*args)
    got = g_ids[:int(g_n)].numpy()
    assert np.array_equal(got, want)
    assert len(got) < int(args[2])  # the table merged something


def test_entry_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry_torch.entry()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry_torch.dryrun_multichip(2)


def test_dryrun_multichip_cpu(capsys):
    """Two spawned gloo ranks."""
    entry_torch.dryrun_multichip(2, device="cpu")
    out = capsys.readouterr().out
    assert "dryrun_multichip(2): ok" in out and "gloo" in out


@pytest.fixture(scope="module")
def pool():
    p = jobs.Pool()
    yield p
    p.close()


@pytest.mark.parametrize("world", [1, 2, 4])
def test_dryrun_rank_matches_across_worlds(pool, world):
    """The same checks on the test pool's ranks at world 1, 2 and 4: every
    rank sees the same first merge; with more ranks the chunks repeat, so
    its count grows with the world."""
    res = pool.run(jobs.dryrun, world)
    assert all(r == res[0] for r in res)
    one = pool.run(jobs.dryrun, 1)[0]
    assert res[0]["first_merge"] == one["first_merge"]
    assert res[0]["first_count"] == world * one["first_count"]
    assert res[0]["encoded"] == world * one["encoded"]
