"""The cl100k-encode-docs cell on the CPU: ``correct`` comes out true on a
sound run, and false for the control (``control_ranks.py``) and for each
fault of an encode, as ``test_bpebench_faults.py`` holds the other cells;
its per-layer readers; its set-up's refusal of a host split.

Each run drives the program's CPU twins at the full 100,256-rank stand-in
on a few short documents (some seconds a run: the forest is recovered in
set-up and again by the reference).
"""

import time

import pytest

from bpebench import control_ranks, harness, trace
from bpebench.kinds.encode_ranks import RanksWindow

CELL = "cl100k-encode-docs"
SMALL = {"documents": 12, "strata": 4, "max_bytes": 2048}
SEEDS = (11, 2**31 + 5)


def _cell():
    cell = harness.load_cell(CELL)
    cell.traffic.update(SMALL)
    return cell


def _run(cell, seed, make_tokenizer=None):
    return harness.run_cell(cell, seed, 0.3, False, "cpu",
                            time.perf_counter(), make_tokenizer)


def _broken(cell, fault):
    """The program's tokenizer with ``encode`` broken by ``fault``."""
    make = harness.program_tokenizer(cell.config, "cpu")

    def build():
        tok = make()
        sound = tok.encode
        tok.encode = lambda text, **kw: fault(sound(text, **kw))
        return tok

    return build


def _half_left_out(ids):
    return ids[:len(ids) // 2]


def _id_altered(ids):
    return ids[:-1] + [ids[-1] ^ 1] if ids else ids


@pytest.mark.parametrize("seed", SEEDS)
def test_sound_run_is_correct(seed):
    out = _run(_cell(), seed)
    assert out["correct"], out["compared"]
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("seed", SEEDS)
def test_control_is_not_correct(seed):
    cell = _cell()
    out = _run(cell, seed, control_ranks.factory(cell.config, "cpu"))
    assert not out["correct"], out["compared"]


@pytest.mark.parametrize("fault", [_half_left_out, _id_altered])
def test_fault_is_not_correct(fault):
    cell = _cell()
    out = _run(cell, SEEDS[0], _broken(cell, fault))
    assert not out["correct"], out["compared"]


def test_window_carries_the_routes_and_the_rows():
    cell = _cell()
    ctx = harness.Context(cell, 7, "cpu", False)
    job = cell.kind.Job(ctx)
    job.setup()
    win = job.window(0.2)
    job.release()
    ids_bytes = win.work_bytes
    job.check()
    assert type(win).__name__ == "RanksWindow"
    assert win.counters["encode.route.device_split"] == win.completed
    assert "encode.route.host_split" not in win.counters
    # 12 B for each distinct merge of each request
    assert win.work_bytes > ids_bytes + 12 * win.completed


def _readings(win, tr=None):
    return harness.Readings(setup_s=1.0, window=win, launches={},
                            device_kind="NVIDIA H100 80GB HBM3", trace=tr)


def test_readers():
    read = {m["name"]: _cell().readers[m["name"]].read
            for m in _cell().per_layer}
    win = RanksWindow(seconds=1.0, attempted=4, completed=4, failed=0,
                      nbytes=4000, work_bytes=8000,
                      counters={"encode.route.device_split": 3,
                                "encode.route.host_split": 1})
    t = trace.Trace(window_s=1.0, busy_s=0.5, ops={
        "(anonymous namespace)::segment_encode_kernel": 0.1,
        "(anonymous namespace)::presplit::presplit_succ_kernel": 0.3})
    r = _readings(win, t)
    assert read["device_split_pct.cl100k"](r) == pytest.approx(75.0)
    assert read["segment_encode_share.cl100k"](r) == pytest.approx(25.0)
    assert read["device_roofline.encode"](r) == pytest.approx(
        100 * 8000 / 3.35e12 / 0.5)
    assert read["device_idle_pct.encode"](r) == pytest.approx(50.0)
    assert read["encode_host_MBps"](r) == pytest.approx(0.004)
    r.launches = {"presplit_succ": 1, "segment_encode": 1}
    assert read["presplit_share.encode"](r) == pytest.approx(75.0)
    win.latencies = [0.001, 0.002, 0.003, 0.004]
    assert read["encode_p50_ms"](r) == pytest.approx(2.0)
    assert read["encode_p95_ms"](r) == pytest.approx(4.0)
    # a window without the counters, a trace without K17: nothing to read
    plain = harness.Window(seconds=1.0, attempted=1, completed=1, failed=0,
                           nbytes=1, work_bytes=1)
    assert read["device_split_pct.cl100k"](_readings(plain, t)) is None
    t.ops = {"presplit_succ_kernel": 0.5}
    assert read["segment_encode_share.cl100k"](r) is None


def test_standin_is_made_again_byte_for_byte(tmp_path):
    """make_ranks.py writes the committed ranks file and model again."""
    import json
    import os

    from bpebench import inputs
    from bpebench.reference import bpe, ranks as rk, split
    from bpebench.tools import make_ranks

    cell = _cell()
    config = cell.config
    text = inputs.corpus_bytes(os.path.join(harness.ROOT, config["corpus"]),
                               config["corpus_sha256"]).decode("utf-8")
    ranks, trained = make_ranks.standin_ranks(text, make_ranks.N_RANKS,
                                              make_ranks.SEED)
    assert trained == 9594
    with open(os.path.join(harness.ROOT, config["ranks"])) as f:
        assert make_ranks.tiktoken_text(ranks) == f.read()
    forest = rk.recover_forest(ranks)
    out = tmp_path / "m.model"
    bpe.write_model(str(out), split.GPT4_SPLIT_PATTERN,
                    sorted(forest, key=forest.get))
    with open(os.path.join(harness.ROOT, config["merges"])) as f:
        assert out.read_text() == f.read()
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        entry = {c["name"]: c for c in json.load(f)["configs"]}[
            "gpt4-cl100k"]
    assert entry["file"] == make_ranks.CONFIG
