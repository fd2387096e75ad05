"""The port's command line (train_torch.py) against minbpe_tpu's (train.py),
on the CPU: the same flags on the same small corpus file must write
byte-identical .model and .vocab files."""

import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import train as jax_cli  # noqa: E402
import train_torch  # noqa: E402
from minbpe_tpu_torch.utils import golden  # noqa: E402

torch.set_num_threads(1)
VOCAB = "300"


@pytest.fixture(scope="module")
def corpus_file(tmp_path_factory):
    """The smoke corpus's first 8 KB (whole characters)."""
    text = golden.smoke_corpus(ROOT).encode("utf-8")[:8192].decode(
        "utf-8", "ignore")
    path = tmp_path_factory.mktemp("cli") / "corpus.txt"
    path.write_text(text, encoding="utf-8")
    return str(path)


def _jax(monkeypatch, args):
    monkeypatch.setattr(sys, "argv", ["train.py", *args])
    jax_cli.main()


def _port(args):
    train_torch.main([*args, "--device", "cpu"])


def _files(outdir, names=("basic", "regex")):
    out = {}
    for name in names:
        for ext in ("model", "vocab"):
            with open(os.path.join(outdir, f"{name}.{ext}"), "rb") as f:
                out[f"{name}.{ext}"] = f.read()
    return out


def _common(corpus_file, outdir, *extra):
    return ["--corpus", corpus_file, "--vocab-size", VOCAB, "--outdir",
            str(outdir), "--quiet", *extra]


@pytest.mark.parametrize("flags", [
    ("--pattern", "gpt4"), ("--pattern", "gpt2"),
    ("--select-mode", "sortloop")], ids=["gpt4", "gpt2", "sortloop"])
def test_cli_matches_train_py(monkeypatch, tmp_path, corpus_file, flags):
    _jax(monkeypatch, _common(corpus_file, tmp_path / "jax", *flags))
    _port(_common(corpus_file, tmp_path / "port", *flags))
    want = _files(tmp_path / "jax")
    assert _files(tmp_path / "port") == want
    assert want["regex.model"].startswith(b"minbpe v1\n")


def test_cli_checkpoint_then_resume(monkeypatch, tmp_path, corpus_file):
    """--checkpoint-every writes train.py's checkpoint and model; --resume
    from it (cut back to its first step) gives that model again."""
    import numpy as np

    from minbpe_tpu_torch.utils import checkpoint as ckpt

    flags = ("--tokenizers", "regex", "--checkpoint-every", "16")
    _jax(monkeypatch, _common(corpus_file, tmp_path / "jax", *flags))
    _port(_common(corpus_file, tmp_path / "port", *flags))
    first = _files(tmp_path / "port", ("regex",))
    assert first == _files(tmp_path / "jax", ("regex",))
    ck = str(tmp_path / "port" / "regex.ckpt.npz")
    st = ckpt.load(ck)
    want = ckpt.load(str(tmp_path / "jax" / "regex.ckpt.npz"))
    assert st.keys() == want.keys()
    for k in st:
        assert np.array_equal(st[k], want[k]), k
    assert st["round_idx"] >= 16
    ckpt.save(ck, st["pairs"][:16], st["counts"][:16], 16, st["num_merges"],
              st["fingerprint"])
    os.remove(str(tmp_path / "port" / "regex.model"))
    _port(_common(corpus_file, tmp_path / "port", "--tokenizers", "regex",
                  "--resume"))
    assert _files(tmp_path / "port", ("regex",)) == first


def test_cli_distributed_matches_train_py(monkeypatch, tmp_path,
                                          corpus_file):
    """--distributed at world 1 on gloo against train.py --distributed (its
    mesh of every CPU device: both are exact at any world size)."""
    import torch.distributed as dist

    _jax(monkeypatch, _common(corpus_file, tmp_path / "jax",
                              "--distributed"))
    _port(_common(corpus_file, tmp_path / "port", "--distributed"))
    assert not dist.is_initialized()  # the group it made is gone
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")


def test_cli_profile_dir_leaves_a_trace(tmp_path, corpus_file):
    prof = tmp_path / "prof"
    _port(_common(corpus_file, tmp_path / "port", "--tokenizers", "basic",
                  "--profile-dir", str(prof)))
    assert any(f.endswith(".json") for _, _, fs in os.walk(prof)
               for f in fs)


def test_cli_unknown_tokenizer_exits(monkeypatch, tmp_path, corpus_file):
    args = _common(corpus_file, tmp_path, "--tokenizers", "nope")
    with pytest.raises(SystemExit, match="unknown tokenizer 'nope'"):
        _port(args)
    with pytest.raises(SystemExit, match="unknown tokenizer 'nope'"):
        _jax(monkeypatch, args)


def test_cli_runs_as_a_script(tmp_path, corpus_file):
    """python3 train_torch.py --help names the default corpus; a run as a
    script writes what main() writes."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "train_torch.py", "--help"],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and "smoke corpus" in out.stdout
    args = _common(corpus_file, tmp_path / "script", "--tokenizers", "basic")
    out = subprocess.run([sys.executable, "train_torch.py", *args,
                          "--device", "cpu"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "basic: trained vocab 300" in out.stdout
    _port(_common(corpus_file, tmp_path / "main", "--tokenizers", "basic"))
    assert _files(tmp_path / "script", ("basic",)) == \
        _files(tmp_path / "main", ("basic",))
