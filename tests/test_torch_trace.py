"""The port's spans and counters (minbpe_tpu_torch/trace.py), on the CPU:
a span that is off costs nothing and records nothing; on, the train and
encode paths' spans nest under their call's root span in a CPU profiler's
trace; the sync counters count the sites the paths pass through; a
``profile_dir`` run's trace carries the spans."""

import glob
import json
import os
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import minbpe_tpu_torch as port
from minbpe_tpu_torch import engine, gpt4, trace
from minbpe_tpu_torch.ops import train as train_ops
from minbpe_tpu_torch.utils import golden
from minbpe_tpu_torch.utils.synthranks import synthetic_ranks

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXT = golden.smoke_corpus(ROOT)[:20_000]


def _spans(prof):
    """(name, parent) of each program span, the prefix taken off; the
    parent is the innermost span that holds it (None for a root)."""
    evs = sorted((e.start_ns(), -e.end_ns(), e.name()[len(trace.PREFIX):])
                 for e in prof.profiler.kineto_results.events()
                 if e.name().startswith(trace.PREFIX))
    out, stack = [], []
    for a, neg_b, name in evs:
        while stack and stack[-1][0] <= a:
            stack.pop()
        out.append((name, stack[-1][1] if stack else None))
        stack.append((-neg_b, name))
    return out


def _traced(fn):
    """fn() under a CPU profiler with the spans on: (result, spans)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof, trace.enabled():
        out = fn()
    return out, _spans(prof)


def test_a_span_that_is_off_records_and_allocates_nothing():
    assert not trace.ENABLED
    assert trace.span("a") is trace.span("b") is trace._NULL
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("a"):
            torch.ones(2)
    assert _spans(prof) == []
    tracemalloc.start()
    try:
        for _ in range(100):  # warm
            with trace.span("a"):
                pass
        before = tracemalloc.take_snapshot()
        for _ in range(1000):
            with trace.span("a"):
                pass
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "filename")
             if d.traceback[0].filename == trace.__file__ and d.size_diff > 0]
    assert grown == []
    with pytest.raises(KeyError):
        with trace.enabled():
            assert trace.span("a") is not trace._NULL
            raise KeyError
    assert not trace.ENABLED


def test_encode_spans_nest_under_the_root():
    tok = port.RegexTokenizer(device="cpu")
    tok.train(TEXT[:5_000], 300)
    tok.device_presplit = True
    doc = TEXT[:3_000]
    want = tok.encode(doc)
    got, spans = _traced(lambda: tok.encode(doc))
    assert got == want
    assert [s for s in spans if s[1] is None] == [("api.encode", None)]
    children = sorted(name for name, parent in spans
                      if parent == "api.encode")
    # one upload, the text's bytes: K15 writes the ids through the table's
    # byte ids, which went to the device with the table
    assert children == sorted([
        "api.text_encode", "engine.upload", "presplit.device",
        "encode.sweep", "encode.readback", "api.to_list"])
    # the host split's path: the split and the stream build have theirs
    tok.device_presplit = False
    got, spans = _traced(lambda: tok.encode(doc))
    assert got == want
    assert ("presplit.host", "api.encode") in spans
    assert ("api.text_encode", "presplit.host") in spans
    assert ("stream.build", "api.encode") in spans


def test_train_spans_nest_under_the_root(monkeypatch):
    ref = port.BasicTokenizer(device="cpu")
    ref.train(TEXT, 300)
    slots = []
    slot = train_ops._slot
    monkeypatch.setattr(train_ops, "_slot",
                        lambda *a: slots.append(1) or slot(*a))
    tok = port.BasicTokenizer(device="cpu")
    trace.reset()
    _, spans = _traced(lambda: tok.train(TEXT, 300))
    assert tok.merges == ref.merges
    assert [s for s in spans if s[1] is None] == [("api.train", None)]
    children = {name for name, parent in spans if parent == "api.train"}
    assert children == {"api.text_encode", "stream.build", "train.setup",
                        "train.enqueue", "train.sync", "train.readback",
                        "train.merges"}
    groups = len(slots) // train_ops.SLOTS_PER_SYNC
    assert groups >= 2 and len(slots) == groups * train_ops.SLOTS_PER_SYNC
    assert spans.count(("train.sync", "api.train")) == groups
    assert spans.count(("train.enqueue", "api.train")) == groups
    # on the CPU nothing checks the device's memory
    assert trace.COUNTERS == {"train.slots": len(slots),
                              "sync.stream.upload": 2,
                              "sync.train.ctl": groups,
                              "sync.train.readback": 1}


def test_encode_counts_its_sync_sites():
    tok = port.RegexTokenizer(device="cpu")
    tok.train(TEXT[:5_000], 300)
    tok.device_presplit = True
    trace.reset()
    first = tok.encode(TEXT[:2_000])
    # the first request sends the merge table too (its cuckoo rows, pairs,
    # new ids and byte ids); each request uploads its text's bytes alone
    # and counts its routes: where the text was split, then the
    # per-segment loop
    assert trace.COUNTERS == {"sync.engine.table": 4, "sync.engine.upload": 1,
                              "encode.route.device_split": 1,
                              "encode.route.segments": 1,
                              "sync.encode.count": 1,
                              "sync.encode.readback": 1}
    trace.reset()
    assert tok.encode(TEXT[:2_000]) == first
    assert trace.COUNTERS == {"sync.engine.upload": 1, "sync.encode.count": 1,
                              "encode.route.device_split": 1,
                              "encode.route.segments": 1,
                              "sync.encode.readback": 1}
    tok.device_presplit = False
    trace.reset()
    assert tok.encode(TEXT[:2_000]) == first
    assert trace.COUNTERS == {"sync.stream.upload": 2, "sync.encode.count": 1,
                              "encode.route.host_split": 1,
                              "encode.route.segments": 1,
                              "sync.encode.readback": 1}


def _device_split_rebuilds(tok, doc):
    """tok's device-split encode of doc after its table was dropped: the
    table (byte ids among it) goes to the device again, and the ids equal
    the host split's."""
    tok.device_presplit = True
    trace.reset()
    got = tok.encode(doc)
    assert trace.COUNTERS["sync.engine.table"] == 4
    assert trace.COUNTERS["sync.engine.upload"] == 1
    assert trace.COUNTERS["encode.route.device_split"] == 1
    tok.device_presplit = False
    assert tok.encode(doc) == got
    return got


def test_new_tables_bring_their_byte_ids(tmp_path):
    """A retrained or reloaded RegexTokenizer, and a GPT4Tokenizer given
    other ranks, split on the device through their new table's byte ids:
    the table is built again, and the ids follow the new byte shuffle."""
    doc = TEXT[:2_000]
    tok = port.RegexTokenizer(device="cpu")
    tok.train(TEXT[:5_000], 300)
    first = _device_split_rebuilds(tok, doc)
    old = engine.device_table(tok)
    tok.train(TEXT[5_000:10_000], 280)
    second = _device_split_rebuilds(tok, doc)
    assert engine.device_table(tok) is not old
    assert second != first
    tok.save(str(tmp_path / "t"))
    tok.train(TEXT[:5_000], 300)
    assert _device_split_rebuilds(tok, doc) == first
    tok.load(str(tmp_path / "t.model"))
    assert _device_split_rebuilds(tok, doc) == second
    g = port.GPT4Tokenizer.from_mergeable_ranks(
        synthetic_ranks(400, seed=1)[0], device="cpu")
    one = _device_split_rebuilds(g, doc)
    ranks = synthetic_ranks(400, seed=2)[0]
    g._init_pretrained(*gpt4._forest_arrays(ranks), {})
    two = _device_split_rebuilds(g, doc)
    assert torch.equal(engine.device_table(g).byte_ids,
                       torch.from_numpy(g.byte_shuffle.astype(np.int32)))
    assert two != one
    assert two == port.GPT4Tokenizer.from_mergeable_ranks(
        ranks, device="cpu").encode(doc)


def test_profile_dir_trace_holds_the_programs_spans(tmp_path):
    out = str(tmp_path / "trace")
    tok = port.BasicTokenizer(device="cpu")
    tok.train(TEXT[:4_000], 270, profile_dir=out)
    assert not trace.ENABLED
    files = glob.glob(os.path.join(out, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"minbpe.train.setup", "minbpe.train.enqueue",
            "minbpe.train.sync", "minbpe.train.readback"} <= names
