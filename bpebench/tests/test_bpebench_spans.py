"""The program-span tool (bpebench/tools/spans.py): its reduction of
nested spans, the spans' copies on the device's timeline, the host
readings, and one run of a small cell on the CPU."""

import json
import os
import shutil
import time

import pytest

from bpebench import harness
from bpebench.tools import spans as tool


class _Event:
    def __init__(self, name, a, b, cuda, corr=0):
        from torch.autograd import DeviceType

        self._v = (name, a, b,
                   DeviceType.CUDA if cuda else DeviceType.CPU)
        self._corr = corr

    def correlation_id(self):
        return self._corr

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]


class _Prof:
    def __init__(self, evs):
        self.profiler = type("P", (), {"kineto_results": type(
            "K", (), {"events": lambda self: evs})()})()


BENCH = [(0, 1000, "window"), (0, 900, "encode"), (900, 980, "compare")]
PROGRAM = [(10, 890, "api.encode"), (20, 100, "engine.upload"),
           (100, 300, "presplit.device"), (300, 600, "encode.sweep"),
           (320, 340, "engine.check_memory"), (600, 880, "encode.readback")]
DEVICE = [(150, 250, "presplit_succ_kernel"),
          (400, 700, "encode_sweep_kernel(int)"), (895, 898, "Memcpy_DtoH"),
          (960, 970, "k")]


def test_each_gap_goes_to_the_innermost_span():
    red = tool.reduce(DEVICE, BENCH, PROGRAM)
    assert red["trace"].busy_s == pytest.approx(413e-9)
    # gaps 0-150, 250-400, 700-895, 898-960, 970-1000 by their middles
    assert red["idle"] == pytest.approx({
        "engine.upload": 150e-9, "engine.check_memory": 150e-9,
        "encode.readback": 195e-9, "compare": 62e-9, "window": 30e-9})
    # the benchmark's own reduction, without the program's spans
    assert red["trace"].idle == pytest.approx(
        {"encode": 495e-9, "compare": 62e-9, "window": 30e-9})


def test_self_time_is_less_the_spans_held():
    red = tool.reduce(DEVICE, BENCH, PROGRAM)
    assert red["spans"]["api.encode"] == [1, pytest.approx(880e-9)]
    assert red["self_s"]["api.encode"] == pytest.approx(20e-9)
    assert red["self_s"]["encode.sweep"] == pytest.approx(280e-9)
    assert red["self_s"]["engine.check_memory"] == pytest.approx(20e-9)
    # clipped to the window
    red = tool.reduce(DEVICE, BENCH, PROGRAM + [(950, 1200, "api.encode")])
    assert red["spans"]["api.encode"] == [2, pytest.approx(930e-9)]
    assert red["self_s"]["api.encode"] == pytest.approx(70e-9)


def test_the_spans_copies_on_the_device_add_no_busy_time():
    evs = [_Event("bench." + n, a, b, False) for a, b, n in BENCH]
    evs += [_Event("minbpe." + n, a, b, False) for a, b, n in PROGRAM]
    evs += [_Event(n, a, b, True) for a, b, n in DEVICE]
    # the profiler's copies of the spans on the device's timeline
    copies = [_Event("minbpe.api.encode", 150, 700, True),
              _Event("bench.encode", 150, 700, True)]
    got = tool.events(_Prof(evs + copies))
    assert got == tool.events(_Prof(evs))
    device, bench, program, links = got
    assert sorted(device) == sorted(DEVICE)
    assert sorted(program) == sorted(PROGRAM)
    assert links == []
    red = tool.reduce(device, bench, program)
    assert red["trace"].busy_s == pytest.approx(413e-9)
    assert red["trace"].ops == pytest.approx(
        {"presplit_succ_kernel": 100e-9, "encode_sweep_kernel": 300e-9,
         "Memcpy_DtoH": 3e-9, "k": 10e-9})


def test_clocks_and_host_readings():
    red = tool.reduce(DEVICE, BENCH, PROGRAM)
    c = tool.clock(DEVICE, PROGRAM, red["busy"])
    assert c["device_in_root"] == pytest.approx(400 / 413)
    assert c["sweeps"] == c["sweep_spans"] == c["sweeps_after_span"] == 1
    assert c["least_lead_us"] == pytest.approx(0.1)
    late = [(150, 250, "k"), (850, 950, "k")]
    red2 = tool.reduce(late, BENCH, PROGRAM)
    c = tool.clock(late, PROGRAM, red2["busy"])
    assert c["device_in_root"] == pytest.approx(0.7)
    assert c["sweeps"] == c["sweeps_after_span"] == 0
    counters = {"sync.engine.upload": 4, "sync.encode.count": 2,
                "comm.calls": 5}
    got = tool.program_readings("encode_requests", red, counters, 2)
    assert got == pytest.approx({"readback_ms.encode": 280e-9 * 1e3 / 2,
                                 "check_memory_ms.encode": 20e-9 * 1e3 / 2,
                                 "host_syncs_per_request.encode": 3.0})
    assert tool.program_readings("encode_requests", red, counters, 0) == {}
    assert tool.program_readings("train_jobs", red, {}, 2) == {}


def test_launch_calls_link_to_their_operations():
    """A launch call and its operation share a correlation id; an
    operation drawn before its call shows the clocks disagreeing."""
    evs = [_Event("cudaLaunchKernel", 310, 320, False, 7),
           _Event("encode_sweep_kernel", 400, 700, True, 7),
           _Event("cuMemcpyDtoHAsync", 880, 885, False, 9),
           _Event("Memcpy_DtoH", 870, 898, True, 9),
           _Event("aten::empty", 300, 301, False, 9)]
    device, _, _, links = tool.events(_Prof(evs))
    assert sorted(links) == [(310, 400, "encode_sweep_kernel"),
                             (880, 870, "Memcpy_DtoH")]
    red = tool.reduce(device, BENCH, PROGRAM)
    c = tool.clock(device, PROGRAM, red["busy"], links, red["window"])
    assert c["links"] == 2 and c["before_call"] == 1
    lags = [None] * 10
    lags[3], lags[8] = 0.09, -0.01
    assert c["least_lag_us_by_tenth"] == pytest.approx(lags)


def test_a_small_cell_on_the_cpu(tmp_path):
    """The tool's run of a small encode cell (test_a_new_cell_is_found_by
    _name's) on the CPU: the spans on, then off."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.ROOT + "/bpebench", root / "bpebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    traffic = json.loads((root / "bpebench/traffic/encode-docs.json")
                         .read_text())
    traffic.update(documents=4, strata=4, max_bytes=512)
    (root / "bpebench/traffic/tiny-docs.json").write_text(json.dumps(traffic))
    bench["workloads"].append({"name": "tiny-cell",
                               "config": "minbpe-regex-v512",
                               "traffic": "tiny-docs", "chips": 1,
                               "why": "w"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.load_cell("tiny-cell", str(root))
    on = tool.run(cell, 5, 0.3, True, "cpu", time.perf_counter())
    assert on["correct"] and on["completed"] > 0
    assert on["spans"]["api.encode"][0] == on["completed"]
    for name in ("presplit.device", "encode.sweep", "encode.readback",
                 "api.to_list"):
        assert on["spans"][name][0] == on["completed"], name
    assert on["counters"]["sync.encode.count"] == on["completed"]
    assert on["program"]["host_syncs_per_request.encode"] == 4.0
    assert on["program"]["readback_ms.encode"] > 0
    off = tool.run(cell, 5, 0.3, False, "cpu", time.perf_counter())
    assert off["correct"] and off["spans"] == {}
    assert off["counters"]["sync.encode.count"] == off["completed"]
