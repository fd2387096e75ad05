"""The port's warm start (minbpe_tpu_torch.precompile) against minbpe_tpu's,
on the CPU: the same buckets, the same text, and the same forms."""

import numpy as np
import pytest
import torch

import minbpe_tpu_torch
from minbpe_tpu import precompile as jax_precompile
from minbpe_tpu.ops.pallas import fused_train
from minbpe_tpu.utils import precompile as jpre
from minbpe_tpu_torch import RegexTokenizer, precompile
from minbpe_tpu_torch.utils import precompile as ppre

torch.set_num_threads(1)


def _sizes():
    """1 .. 2^26: every size up to 4 tiles, each power of two and its
    neighbours, and 2,000 seeded sizes between."""
    out = set(range(1, 4 * ppre.TILE_ELEMS + 2))
    for k in range(27):
        out |= {(1 << k) - 1, 1 << k, (1 << k) + 1}
    out |= set(np.random.default_rng(0).integers(1, 1 << 26, 2000).tolist())
    return sorted(s for s in out if 1 <= s <= 1 << 26)


def test_fused_capacity_matches():
    assert ppre.TILE_ELEMS == fused_train.TILE_ELEMS
    for n in _sizes():
        assert ppre.fused_capacity(n) == fused_train.fused_capacity(n), n


@pytest.mark.parametrize("n", [0, 1, 100, 16384, 100_000])
def test_fake_text_matches(n):
    assert ppre._fake_text(n) == jpre._fake_text(n)


def test_precompile_bucket_matches_minbpe_tpu():
    got = precompile([5000], vocab_size=300, device="cpu")
    want = jax_precompile([5000], vocab_size=300)
    assert [b for b, _ in got] == [b for b, _ in want] == [16384]
    assert all(isinstance(s, float) and s >= 0 for _, s in got)


def test_precompile_tokenizer_form_warms_a_bucket_once():
    t = RegexTokenizer(device="cpu")
    t.train(ppre._fake_text(20_000), 300)
    done = precompile([2000, 2100], tokenizer=t)  # the tokenizer's device
    assert [b for b, _ in done] == [16384]
    done = precompile([2000, 20_000, 40_000, 16384], tokenizer=t)
    assert [b for b, _ in done] == sorted(
        {ppre.fused_capacity(n) for n in (2000, 20_000, 40_000)})


def test_precompile_train_false_form():
    done = precompile([40_000], vocab_size=270, train=False, device="cpu",
                      verbose=True)
    assert [b for b, _ in done] == [ppre.fused_capacity(40_000)]


def test_precompile_is_exported():
    assert "precompile" in minbpe_tpu_torch.__all__
    assert minbpe_tpu_torch.precompile is ppre.precompile


def test_precompile_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        precompile([1000])
