"""The harness: found by name, free of JAX, its arithmetic, its refusals."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys
import time

import pytest

from bpebench import harness, trace

ROOT = harness.ROOT
BENCH_DIR = os.path.join(ROOT, "bpebench")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _sources():
    for d, _, files in os.walk(BENCH_DIR):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path):
    """The top-level names a module imports (relative imports aside)."""
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]


def test_nothing_imports_jax_or_the_jax_package():
    for path in _sources():
        found = set(_imports(path)) & set(harness.FORBIDDEN)
        assert not found, (path, found)


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(BENCH_DIR, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            names = set(_imports(os.path.join(ref, f)))
            assert names <= {"__future__", "functools", "re", "sys",
                             "unicodedata", "torch"}, (f, names)


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "minbpe_tpu_torchx", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax"]


def test_benchmark_json_keeps_the_contract():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for w in bench["workloads"]:
        cell = harness.load_cell(w["name"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
        got = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in got and len(got) >= 2 and cell.per_layer
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])
    for d, _, files in os.walk(BENCH_DIR):
        for f in files:
            rel = os.path.relpath(os.path.join(d, f), ROOT)
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_a_new_cell_is_found_by_name(tmp_path):
    """A configuration, a traffic mix, a metric and a cell added as files
    and entries, with no edit to a file that is there."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH_DIR, root / "bpebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    config = json.loads((root / "bpebench/configs/minbpe-basic-v512.json")
                        .read_text())
    (root / "bpebench/configs/tiny.json").write_text(json.dumps(config))
    traffic = json.loads((root / "bpebench/traffic/encode-docs.json")
                         .read_text())
    traffic.update(documents=4, strata=4, max_bytes=512)
    (root / "bpebench/traffic/tiny-docs.json").write_text(json.dumps(traffic))
    (root / "bpebench/metrics/requests_done.py").write_text(
        "def read(r):\n    return r.window.completed\n")
    bench["configs"].append({"name": "tiny", "source": "s",
                             "file": "bpebench/configs/tiny.json",
                             "reduced": [], "why": "w"})
    bench["workloads"].append({"name": "tiny-cell", "config": "tiny",
                               "traffic": "tiny-docs", "chips": 1,
                               "why": "w"})
    bench["end_to_end"].append({"name": "requests_done", "unit": "requests",
                                "better": "higher", "bound": 0.1,
                                "source": "host_clock",
                                "workloads": ["tiny-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.load_cell("tiny-cell", str(root))
    assert cell.traffic["documents"] == 4
    out = harness.run_cell(cell, 5, 0.3, False, "cpu", time.perf_counter())
    assert out["correct"]
    assert out["metrics"]["requests_done"]["value"] == out["attempted"]
    # the metrics that list no workloads, and those that list this cell
    assert set(out["metrics"]) == {"setup_s", "requests_done"}


def _readings(latencies=(), seconds=1.0, nbytes=0, work=0, tr=None,
              kind="NVIDIA H100 80GB HBM3"):
    win = harness.Window(seconds=seconds, attempted=len(latencies),
                         completed=len(latencies), failed=0, nbytes=nbytes,
                         work_bytes=work, latencies=list(latencies))
    return harness.Readings(setup_s=1.0, window=win, launches={},
                            device_kind=kind, trace=tr)


def _metric(name):
    return harness.load_module(os.path.join(BENCH_DIR, "metrics",
                                            name + ".py"), name)


def test_p95_is_over_every_request():
    lat = [0.001] * 95 + [0.010] * 5
    assert _metric("encode_p95_ms").read(_readings(lat)) == pytest.approx(1.0)
    lat = [0.001] * 94 + [0.010] * 6
    assert _metric("encode_p95_ms").read(_readings(lat)) == pytest.approx(10)
    assert _metric("encode_p50_ms").read(_readings([0.003, 0.001, 0.002])) \
        == pytest.approx(2.0)
    assert _metric("encode_p95_ms").read(_readings([])) is None


def test_rates_are_over_the_whole_window():
    r = _readings([0.1] * 4, seconds=2.5, nbytes=10_000_000)
    assert _metric("encode_host_MBps").read(r) == pytest.approx(4.0)
    assert _metric("train_s").read(r) == pytest.approx(2.5 / 4)


def test_device_time_a_MB_is_over_every_byte_of_the_window():
    # a trace of the device alone: its window is the trace's own extent
    device = [(100, 300, "k1(int)"), (200, 350, "k2"), (600, 700, "k1(int)")]
    t = trace.reduce(device, [])
    assert t.window_s == pytest.approx(600e-9)
    assert t.busy_s == pytest.approx(350e-9)
    assert trace.reduce([], []).busy_s == 0.0
    t = trace.Trace(window_s=10.0, busy_s=2.5)
    metric = _metric("encode_device_ms_per_MB")
    assert metric.read(_readings([0.1] * 4, seconds=10.0, nbytes=5_000_000,
                                 tr=t)) == pytest.approx(500.0)
    # no trace (a run on the CPU), or nothing encoded: nothing to read
    assert metric.read(_readings([0.1], nbytes=5_000_000)) is None
    assert metric.read(_readings([], tr=t)) is None


def test_idle_from_overlapping_intervals():
    spans = [(0, 1000, "window"), (0, 400, "encode"), (400, 500, "compare"),
             (500, 1000, "encode")]
    device = [(100, 300, "k1(int)"), (200, 350, "k2"), (600, 700, "k1(int)")]
    t = trace.reduce(device, spans)
    assert t.window_s == pytest.approx(1e-6)
    assert t.busy_s == pytest.approx(350e-9)
    assert t.ops == pytest.approx({"k1": 300e-9, "k2": 150e-9})
    assert t.idle == pytest.approx({"encode": 400e-9, "compare": 250e-9})
    r = _readings(tr=t)
    assert _metric("device_idle_pct.encode").read(r) == pytest.approx(65.0)


def test_roofline_cannot_pass_100():
    peak = 3.35e12
    busy = 1e-3
    t = trace.Trace(window_s=2e-3, busy_s=busy, ops={"k": busy})
    # the least time those bytes take is the busy time itself
    r = _readings(work=int(peak * busy), tr=t)
    assert _metric("device_roofline.train").read(r) == pytest.approx(
        100.0, rel=1e-9)
    assert _metric("device_roofline.encode").read(
        _readings(work=1000, tr=t)) < 1e-3
    assert _metric("device_roofline.encode").read(
        _readings(work=1000, tr=t, kind="cpu")) is None
    assert _metric("device_roofline.encode").read(_readings(work=1000)) \
        is None


def test_presplit_share_reads_the_programs_kernel_names():
    t = trace.Trace(window_s=1.0, busy_s=0.4, ops={
        "(anonymous namespace)::presplit_succ_kernel": 0.1,
        "(anonymous namespace)::encode_sweep_kernel": 0.3})
    r = _readings(tr=t)
    r.launches = {"presplit_succ": 1, "encode_sweep": 1}
    assert _metric("presplit_share.encode").read(r) == pytest.approx(25.0)
    r.trace = trace.Trace(window_s=1.0, busy_s=0.3,
                          ops={"encode_sweep_kernel": 0.3})
    assert _metric("presplit_share.encode").read(r) is None


def test_run_refuses_without_cuda(tmp_path):
    """No result without a card; and none in a directory holding only
    BENCHMARK.json and the benchmark's files."""
    cmd = [sys.executable, "bpebench/run.py", "--workload",
           "regex512-encode-docs", "--seed", "3", "--seconds", "1",
           "--trace", "0"]
    bare = tmp_path / "bare"
    shutil.copytree(BENCH_DIR, bare / "bpebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), bare)
    for cwd in (ROOT, str(bare)):
        p = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True,
                           env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
        assert p.returncode != 0
        assert '"correct"' not in p.stdout
