"""minbpe_tpu_torch and chip_smoke.py stand alone: no JAX, no minbpe_tpu,
no ``regex`` (that one only lazily, for a custom split pattern), and no
quiet CPU run when CUDA is missing."""

import ast
import os
import subprocess
import sys

import pytest
import torch

# The suite runs in several worker processes at once: one intra-op
# thread each keeps the plain PyTorch paths from contending for cores.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "minbpe_tpu_torch")
FORBIDDEN = ("jax", "minbpe_tpu", "regex")
# the one lazy import allowed: regex, for a custom pattern
ALLOWED = {("regex.py", "_compile_custom", "regex")}


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, dirs, files in os.walk(PKG):
        dirs[:] = [x for x in dirs if x != "_build"]  # build output
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imports(tree):
    """(enclosing function name or None, top-level module) per import."""
    found = []

    def visit(node, fn):
        for child in ast.iter_child_nodes(node):
            name = fn
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                name = child.name
            if isinstance(child, ast.Import):
                found.extend((fn, a.name.split(".")[0]) for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                found.append((fn, child.module.split(".")[0]))
            visit(child, name)

    visit(tree, None)
    return found


def test_ast_scan_finds_no_forbidden_import():
    bad = []
    for path in _sources():
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), path)
        for fn, mod in _imports(tree):
            if mod in FORBIDDEN and \
                    (os.path.basename(path), fn, mod) not in ALLOWED:
                bad.append(f"{os.path.relpath(path, ROOT)}: {mod} in {fn}")
    assert not bad, bad
    assert len(_sources()) > 10


def test_import_leaves_jax_minbpe_tpu_and_regex_out():
    code = (
        "import sys\n"
        "import minbpe_tpu_torch\n"
        "from minbpe_tpu_torch import convert, engine, gpt4, kernels\n"
        "from minbpe_tpu_torch.ops import (encode, flat_encode, merge,\n"
        "    ranktab, select, stream, train, train_inc, train_select,\n"
        "    train_sortloop, train_sparse)\n"
        "from minbpe_tpu_torch.utils import (checkpoint, golden, native,\n"
        "    presplit, synthranks)\n"
        "t = minbpe_tpu_torch.RegexTokenizer(device='cpu')\n"
        "t.train('hello world, hello there', 260)\n"
        "for mode in ('sort', 'dense', 'pallas', 'stepped', 'sortloop',\n"
        "             'sortloop_inc', 'sparse', 'sparse_inc'):\n"
        "    t.train('hello world, hello there', 260, select_mode=mode)\n"
        "assert t.decode(t.encode('hello')) == 'hello'\n"
        "ranks, _, sp = synthranks.synthetic_ranks(4353, seed=1)\n"
        "g = minbpe_tpu_torch.GPT4Tokenizer.from_mergeable_ranks(\n"
        "    ranks, sp, device='cpu')\n"
        "assert engine.device_table(g).kind == 'sorted'\n"
        "assert g.decode(g.encode('hello  world')) == 'hello  world'\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'minbpe_tpu', 'regex')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


@pytest.mark.parametrize("cls", ["BasicTokenizer", "RegexTokenizer"])
def test_default_device_needs_cuda(cls, monkeypatch):
    import minbpe_tpu_torch as port

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(port, cls)()
    with pytest.raises(RuntimeError):
        getattr(port, cls)(device="cuda")
    assert getattr(port, cls)(device="cpu").device.type == "cpu"
    with pytest.raises(ValueError):
        getattr(port, cls)(device="meta")


def test_gpt4_default_device_needs_cuda(monkeypatch):
    from minbpe_tpu_torch import GPT4Tokenizer
    from minbpe_tpu_torch.utils.synthranks import synthetic_ranks

    ranks, _, _ = synthetic_ranks(300, seed=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (GPT4Tokenizer, lambda: GPT4Tokenizer.from_mergeable_ranks(
            ranks)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    tok = GPT4Tokenizer.from_mergeable_ranks(ranks, device="cpu")
    assert tok.device.type == "cpu"
    assert tok.decode(tok.encode("abc")) == "abc"
