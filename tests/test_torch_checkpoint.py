"""Checkpoints, resume, progress and tracing in the port, on the CPU: the
cases of tests/test_checkpoint.py against the port, minbpe_tpu's progress
call sequence, checkpoints carried across the two packages in both
directions, and the trace a ``profile_dir`` run leaves."""

import glob
import os

import numpy as np
import pytest
import torch

# The suite runs in several worker processes at once: one intra-op
# thread each keeps the plain PyTorch paths from contending for cores.
torch.set_num_threads(1)

pytest.importorskip("jax")

import minbpe_tpu  # noqa: E402

import minbpe_tpu_torch as port  # noqa: E402
from minbpe_tpu_torch.utils import checkpoint as ckpt  # noqa: E402

TEXT = ("checkpoint resume must reproduce the exact same merges, "
        "ties included, every single time. " * 20)


def _stop_after(rounds):
    """A progress callback that interrupts the run after ``rounds``."""
    def progress(done, total):
        if done > rounds:
            raise KeyboardInterrupt
    return progress


def test_resume_bit_identical(tmp_path):
    ck = str(tmp_path / "train.ckpt.npz")
    full = port.BasicTokenizer(device="cpu")
    full.train(TEXT, 256 + 48)
    partial = port.BasicTokenizer(device="cpu")
    partial.train(TEXT, 256 + 48, checkpoint_path=ck, checkpoint_every=16)
    assert partial.merges == full.merges
    assert ckpt.load(ck)["round_idx"] == 32
    resumed = port.BasicTokenizer(device="cpu")
    resumed.train(TEXT, 256 + 48, resume_from=ck)
    assert resumed.merges == full.merges


def test_resume_after_an_interrupted_run(tmp_path):
    ck = str(tmp_path / "cut.ckpt.npz")
    full = port.RegexTokenizer(device="cpu")
    full.train(TEXT, 256 + 40)
    cut = port.RegexTokenizer(device="cpu")
    with pytest.raises(KeyboardInterrupt):
        cut.train(TEXT, 256 + 40, checkpoint_path=ck, checkpoint_every=8,
                  progress=_stop_after(16))
    assert ckpt.load(ck)["round_idx"] == 16
    resumed = port.RegexTokenizer(device="cpu")
    resumed.train(TEXT, 256 + 40, resume_from=ck)
    assert resumed.merges == full.merges


def test_resume_rejects_wrong_corpus(tmp_path):
    ck = str(tmp_path / "train.ckpt.npz")
    port.BasicTokenizer(device="cpu").train(TEXT, 256 + 32,
                                            checkpoint_path=ck,
                                            checkpoint_every=8)
    with pytest.raises(ValueError, match="corpus"):
        port.BasicTokenizer(device="cpu").train(TEXT + "x", 256 + 32,
                                                resume_from=ck)


def test_resume_rejects_wrong_target(tmp_path):
    ck = str(tmp_path / "train.ckpt.npz")
    port.BasicTokenizer(device="cpu").train(TEXT, 256 + 32,
                                            checkpoint_path=ck,
                                            checkpoint_every=8)
    with pytest.raises(ValueError, match="merges"):
        port.BasicTokenizer(device="cpu").train(TEXT, 256 + 48,
                                                resume_from=ck)


@pytest.mark.parametrize("vocab", [256 + 24, 256 + 29])
def test_progress_calls_match_minbpe_tpu(vocab):
    seen = {"j": [], "p": []}
    minbpe_tpu.RegexTokenizer().train(
        TEXT, vocab, progress=lambda d, t: seen["j"].append((d, t)))
    port.RegexTokenizer(device="cpu").train(
        TEXT, vocab, progress=lambda d, t: seen["p"].append((d, t)))
    assert seen["p"] == seen["j"]
    assert seen["p"][-1] == (vocab - 256, vocab - 256)


@pytest.mark.parametrize("writer", ["minbpe_tpu", "port"])
def test_checkpoints_cross_packages(tmp_path, writer):
    """A checkpoint written by either package resumes in the other, with
    merges equal to an uninterrupted run; the files hold the same arrays."""
    vocab = 256 + 40
    cks = {w: str(tmp_path / f"{w}.ckpt.npz") for w in ("minbpe_tpu", "port")}
    jt = minbpe_tpu.RegexTokenizer()
    jt.train(TEXT, vocab, checkpoint_path=cks["minbpe_tpu"],
             checkpoint_every=16)
    pt = port.RegexTokenizer(device="cpu")
    pt.train(TEXT, vocab, checkpoint_path=cks["port"], checkpoint_every=16)
    assert pt.merges == jt.merges
    a, b = np.load(cks["minbpe_tpu"]), np.load(cks["port"])
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert np.array_equal(a[k], b[k]), k
    reader = (port.RegexTokenizer(device="cpu") if writer == "minbpe_tpu"
              else minbpe_tpu.RegexTokenizer())
    reader.train(TEXT, vocab, resume_from=cks[writer])
    assert reader.merges == jt.merges


def test_profile_dir_leaves_a_trace(tmp_path):
    out = str(tmp_path / "trace")
    tok = port.BasicTokenizer(device="cpu")
    tok.train(TEXT, 256 + 8, profile_dir=out)
    files = glob.glob(os.path.join(out, "*.pt.trace.json"))
    assert len(files) == 1 and os.path.getsize(files[0]) > 0
    ref = port.BasicTokenizer(device="cpu")
    ref.train(TEXT, 256 + 8)
    assert tok.merges == ref.merges
